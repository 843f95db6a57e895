"""Cross-process shuffle: a TCP block server + fetch client behind the
ShuffleTransport interface.

Counterpart of ``spark_rapids_tpu/shuffle/network.py``, wire for wire:
RapidsShuffleServer.scala:36-71 (serves block transfers),
RapidsShuffleClient.scala:35-98 (fetch orchestration),
BufferSendState.scala:53 + BounceBufferManager.scala:33-80 (sends are
WINDOWED through a fixed pool of staging buffers, so a huge piece never
needs a matching huge contiguous buffer). The mesh stages
(``exec/mesh.py``) cover the devices of one process; this server/client
covers the boundary between worker processes or hosts, where the
reference uses UCX or netty.

Wire protocol (all integers little-endian u64):
  request:  [op, shuffle_id, reduce_id]      op 1 = FETCH
  response: [npieces] then per piece [map_id, nbytes] + nbytes payload,
            streamed in window-sized chunks from the bounce pool
  request:  [op=2, shuffle_id, map_id, reduce_id, nbytes] + payload  PUSH
  response: [0] ack

The payload is the framed host wire format of ``serializer.py``, codec
included. Every socket has a timeout (:data:`SOCKET_TIMEOUT_S`) and the
server thread is joined with one, so a peer that stops answering fails
its request instead of hanging the process.
"""
from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Dict, List, Optional, Tuple

from .transport import SerializingTransportBase

_U64x3 = struct.Struct("<QQQ")
_U64 = struct.Struct("<Q")

OP_FETCH = 1
OP_PUSH = 2

#: seconds any socket of this module waits on a peer before failing
SOCKET_TIMEOUT_S = 30.0
#: seconds ``ShuffleServer.close`` waits for its serving thread
THREAD_JOIN_TIMEOUT_S = 10.0


class BounceBuffers:
    """Fixed pool of staging buffers bounding in-flight send memory
    (reference: BounceBufferManager.scala:33-80). ``acquire`` blocks when
    every buffer is in flight: the window."""

    def __init__(self, count: int = 4, size: int = 1 << 20):
        self.size = size
        self._sem = threading.Semaphore(count)
        self._free: List[bytearray] = [bytearray(size) for _ in range(count)]
        self._lock = threading.Lock()

    def acquire(self, timeout: Optional[float] = None) -> bytearray:
        if not self._sem.acquire(timeout=timeout):
            raise TimeoutError("no bounce buffer came free within "
                               f"{timeout} s")
        with self._lock:
            return self._free.pop()

    def release(self, buf: bytearray) -> None:
        with self._lock:
            self._free.append(buf)
        self._sem.release()


def _send_windowed(sock: socket.socket, data: bytes,
                   pool: BounceBuffers) -> None:
    """Stream ``data`` through the bounce pool in window-sized chunks
    (reference: BufferSendState windows a send over bounce buffers)."""
    view = memoryview(data)
    for off in range(0, len(view), pool.size):
        buf = pool.acquire(timeout=SOCKET_TIMEOUT_S)
        try:
            chunk = view[off: off + pool.size]
            buf[: len(chunk)] = chunk
            sock.sendall(memoryview(buf)[: len(chunk)])
        finally:
            pool.release(buf)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed mid-message")
        got += r
    return bytes(out)


class _BlockStore:
    """Serialized piece bytes keyed (shuffle, reduce) -> [(map_id, bytes)]."""

    def __init__(self):
        self._store: Dict[Tuple[int, int], List[Tuple[int, bytes]]] = {}
        self._lock = threading.Lock()

    def put(self, sid: int, mid: int, rid: int, data: bytes) -> None:
        with self._lock:
            self._store.setdefault((sid, rid), []).append((mid, data))

    def get(self, sid: int, rid: int) -> List[Tuple[int, bytes]]:
        with self._lock:
            return sorted(self._store.get((sid, rid), ()),
                          key=lambda e: e[0])

    def release(self, sid: int) -> None:
        with self._lock:
            for k in [k for k in self._store if k[0] == sid]:
                del self._store[k]


class ShuffleServer:
    """Serves (and accepts pushed) shuffle blocks over TCP
    (reference: RapidsShuffleServer.scala:36 + RapidsShuffleRequestHandler)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 window_bytes: int = 1 << 20, window_count: int = 4):
        self.store = _BlockStore()
        pool = BounceBuffers(window_count, window_bytes)
        store = self.store
        live_conns: List[socket.socket] = []
        conns_lock = threading.Lock()
        self._live_conns, self._conns_lock = live_conns, conns_lock

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                self.request.settimeout(SOCKET_TIMEOUT_S)
                with conns_lock:
                    live_conns.append(self.request)

            def finish(self):
                with conns_lock:
                    if self.request in live_conns:
                        live_conns.remove(self.request)

            def handle(self):
                sock = self.request
                try:
                    while True:
                        try:
                            head = _recv_exact(sock, _U64.size)
                        except (ConnectionError, socket.timeout):
                            return
                        (op,) = _U64.unpack(head)
                        if op == OP_FETCH:
                            sid, rid = struct.unpack(
                                "<QQ", _recv_exact(sock, 16))
                            pieces = store.get(sid, rid)
                            sock.sendall(_U64.pack(len(pieces)))
                            for mid, data in pieces:
                                sock.sendall(
                                    struct.pack("<QQ", mid, len(data)))
                                _send_windowed(sock, data, pool)
                        elif op == OP_PUSH:
                            sid, mid, rid, nbytes = struct.unpack(
                                "<QQQQ", _recv_exact(sock, 32))
                            data = _recv_exact(sock, nbytes)
                            store.put(sid, mid, rid, data)
                            sock.sendall(_U64.pack(0))
                        else:
                            return
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address: Tuple[str, int] = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="srt-shuffle-server")
        self._thread.start()

    def close(self, force: bool = False) -> None:
        """Stop serving. ``force`` also severs in-flight handler
        connections: the hard kill the error-path tests need (clients see
        a reset mid-stream, like a crashed executor)."""
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=THREAD_JOIN_TIMEOUT_S)
        if force:
            with self._conns_lock:
                conns = list(self._live_conns)
            for c in conns:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass


class FetchFailedError(ConnectionError):
    """A reduce-side fetch exhausted its retries (reference analog:
    Spark's FetchFailedException, which triggers a map-stage recompute;
    here the caller gets a clean failure instead of a hang)."""


class ShuffleClient:
    """Fetches blocks from a remote ShuffleServer (reference:
    RapidsShuffleClient.scala:35-98; the response carries metadata and
    data). Transient connection errors reconnect and retry the whole
    request (fetches are idempotent reads) under exponential backoff with
    jitter, capped at ``retry_wait_cap_s``; exhaustion raises
    FetchFailedError. ``retry_count``/``failure_count`` feed the
    transport's stats() and the ``tpu_shuffle_fetch_retries`` twin."""

    def __init__(self, address: Tuple[str, int], retries: int = 3,
                 retry_wait_s: float = 0.2,
                 retry_wait_cap_s: float = 2.0,
                 timeout_s: float = SOCKET_TIMEOUT_S):
        self._addr = tuple(address)
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._retries = retries
        self._retry_wait_s = retry_wait_s
        self._retry_wait_cap_s = retry_wait_cap_s
        self._timeout_s = timeout_s
        #: cumulative transient-failure retries
        self.retry_count = 0
        #: cumulative fetches that exhausted retries (FetchFailedError)
        self.failure_count = 0

    def _backoff(self, attempt: int) -> float:
        """Exponential backoff with full jitter, capped: attempt 0 waits
        up to retry_wait_s, doubling per attempt, never above the cap."""
        import random

        span = min(self._retry_wait_cap_s,
                   self._retry_wait_s * (1 << attempt))
        return span * (0.5 + 0.5 * random.random())

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self._addr,
                                                  timeout=self._timeout_s)
        return self._sock

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def fetch_serialized(self, sid: int, rid: int
                         ) -> List[Tuple[int, bytes]]:
        import time as _time

        from .. import faults as _faults
        from .. import obs as _obs

        with self._lock:
            last: Optional[Exception] = None
            for attempt in range(self._retries):
                try:
                    if _faults.enabled():
                        # an injected transient fetch failure (a
                        # ConnectionError): exercises THIS retry loop
                        _faults.check("fetch", "network_fetch")
                    s = self._conn()
                    s.sendall(_U64x3.pack(OP_FETCH, sid, rid))
                    (n,) = _U64.unpack(_recv_exact(s, 8))
                    out = []
                    for _ in range(n):
                        mid, nbytes = struct.unpack(
                            "<QQ", _recv_exact(s, 16))
                        out.append((mid, _recv_exact(s, nbytes)))
                    return out
                except (ConnectionError, OSError, socket.timeout) as e:
                    last = e
                    self._drop_conn()
                    if attempt + 1 < self._retries:
                        self.retry_count += 1
                        if _obs.enabled():
                            _obs.inc("tpu_shuffle_fetch_retries", 1,
                                     outcome="retry")
                        _time.sleep(self._backoff(attempt))
            self.failure_count += 1
            if _obs.enabled():
                _obs.inc("tpu_shuffle_fetch_retries", 1, outcome="failure")
            raise FetchFailedError(
                f"fetch (shuffle={sid}, reduce={rid}) from {self._addr} "
                f"failed after {self._retries} attempts: {last}")

    def push_serialized(self, sid: int, mid: int, rid: int,
                        data: bytes) -> None:
        with self._lock:
            s = self._conn()
            s.sendall(struct.pack("<QQQQQ", OP_PUSH, sid, mid, rid,
                                  len(data)))
            s.sendall(data)
            _recv_exact(s, 8)  # ack

    def close(self) -> None:
        with self._lock:
            self._drop_conn()


_LOCAL_SERVER: Optional[ShuffleServer] = None
_LOCAL_SERVER_LOCK = threading.Lock()


def local_server(port: int = 0) -> ShuffleServer:
    """This process's shuffle block server, started on first use (the
    executor-lifetime server of RapidsShuffleServer.scala:36). One server
    serves every exchange in the process; conf picks the port."""
    global _LOCAL_SERVER
    with _LOCAL_SERVER_LOCK:
        if _LOCAL_SERVER is None:
            _LOCAL_SERVER = ShuffleServer(port=port)
        return _LOCAL_SERVER


def shutdown_local_server() -> None:
    """Stop this process's shuffle server (a no-op when none started)."""
    global _LOCAL_SERVER
    with _LOCAL_SERVER_LOCK:
        if _LOCAL_SERVER is not None:
            _LOCAL_SERVER.close(force=True)
            _LOCAL_SERVER = None


class NetworkShuffleTransport(SerializingTransportBase):
    """ShuffleTransport over a set of remote block servers.

    ``write`` serializes and stores locally (this process's server owns
    its map output, like RapidsCachingWriter), or pushes to ``push_to``
    when the writer is a separate worker process. ``fetch`` merges local
    pieces with every remote server's (reference: RapidsCachingReader
    splits local catalog hits from transport fetches,
    RapidsCachingReader.scala:60-155) and uploads them to ``device``."""

    def __init__(self, server: Optional[ShuffleServer] = None,
                 remotes: Tuple[Tuple[str, int], ...] = (),
                 codec: str = "none",
                 push_to: Optional[Tuple[str, int]] = None,
                 owns_server: bool = True, device=None):
        super().__init__(codec, device)
        self.server = server
        self._clients = [ShuffleClient(a) for a in remotes]
        self._push = ShuffleClient(push_to) if push_to else None
        # conf-built transports share the process-wide server; closing one
        # exchange must not tear it down for the others
        self._owns_server = owns_server

    def write(self, shuffle_id, map_id, reduce_id, piece, schema):
        data = self._encode_piece(piece, schema, shuffle_id, map_id,
                                  reduce_id)
        if self._push is not None:
            self._push.push_serialized(shuffle_id, map_id, reduce_id, data)
        elif self.server is not None:
            self.server.store.put(shuffle_id, map_id, reduce_id, data)
        else:
            raise RuntimeError("no local server and no push target")

    def _all_clients(self) -> List[ShuffleClient]:
        return self._clients + ([self._push] if self._push else [])

    def fetch(self, shuffle_id, reduce_id):
        raw: List[Tuple[int, bytes]] = []
        before = sum(c.retry_count for c in self._clients)
        if self.server is not None:
            raw.extend(self.server.store.get(shuffle_id, reduce_id))
        for c in self._clients:
            raw.extend(c.fetch_serialized(shuffle_id, reduce_id))
        raw.sort(key=lambda e: e[0])
        retries = sum(c.retry_count for c in self._clients) - before
        return self._decode_entries(raw, shuffle_id, reduce_id,
                                    retries=retries)

    def stats(self):
        """Base wire/codec counters plus the network-only retry story:
        transient-failure retries paid and fetches that exhausted them."""
        st = super().stats()
        st["fetch_retries"] = sum(
            c.retry_count for c in self._all_clients())
        st["fetch_failures"] = sum(
            c.failure_count for c in self._all_clients())
        return st

    def release(self, shuffle_id):
        if self.server is not None:
            self.server.store.release(shuffle_id)

    def close(self):
        for c in self._clients:
            c.close()
        if self._push is not None:
            self._push.close()
        if self.server is not None and self._owns_server:
            self.server.close()
