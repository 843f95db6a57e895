"""Shuffle storage behind a transport interface: device pieces or host
bytes.

Counterpart of ``spark_rapids_tpu/shuffle/transport.py``: map tasks
write pieces through a transport, reduce tasks fetch them by
(shuffle id, reduce id) in map order, and the transport decides where
they live. ``DeviceShuffleTransport`` keeps each piece on the device,
registered spillable with the buffer catalog (``memory/spillable.py``,
at the shuffle-input spill priority), so memory pressure can move it to
the host until its fetch; ``SerializedShuffleTransport`` round-trips
every piece through the host wire format (``serializer.py``). Both emit
the reference's ``shuffle_write`` (one a piece) and ``shuffle_fetch``
(one a reduce partition) events with their ``tpu_shuffle_*`` twins; the
serializing transports (this host one and ``network.py``'s) share
``SerializingTransportBase`` and add their codec's encode and decode
seconds.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import events as _events
from .. import obs as _obs
from .. import types as T
from ..expr.values import Val


def _note_write(shuffle_id, map_id, reduce_id, rows: int, nbytes: int,
                codec: str) -> None:
    if _events.enabled():
        _events.emit("shuffle_write", shuffle_id=shuffle_id, map_id=map_id,
                     reduce_id=reduce_id, rows=rows, bytes=nbytes,
                     codec=codec)
    if _obs.enabled():
        _obs.inc("tpu_shuffle_pieces", 1, direction="write", codec=codec)
        _obs.inc("tpu_shuffle_bytes", nbytes, direction="write",
                 codec=codec)


def _note_fetch(shuffle_id, reduce_id, pieces: List["ShufflePiece"],
                nbytes: int, codec: str, retries=None) -> None:
    if _events.enabled():
        extra = {} if retries is None else {"retries": retries}
        _events.emit("shuffle_fetch", shuffle_id=shuffle_id,
                     reduce_id=reduce_id, pieces=len(pieces),
                     rows=sum(p.n for p in pieces), bytes=nbytes,
                     codec=codec, **extra)
    if _obs.enabled():
        _obs.inc("tpu_shuffle_pieces", len(pieces), direction="fetch",
                 codec=codec)
        _obs.inc("tpu_shuffle_bytes", nbytes, direction="fetch",
                 codec=codec)


@dataclasses.dataclass
class ShufflePiece:
    """One (map, reduce) piece: columns of ``n`` rows and, per string
    column in order, its byte length (host ints synced once per map
    batch, where the reference syncs its contiguousSplit sizes)."""

    vals: List[Val]
    n: int
    byte_lens: Tuple[int, ...] = ()


class ShuffleTransport:
    """Transport interface (reference: RapidsShuffleTransport.scala:328)."""

    #: wire codec of this transport ("none" when pieces never serialize)
    codec = "none"

    def write(self, shuffle_id: int, map_id: int, reduce_id: int,
              piece: ShufflePiece, schema: T.StructType) -> None:
        raise NotImplementedError

    def fetch(self, shuffle_id: int, reduce_id: int) -> List[ShufflePiece]:
        """All pieces of a reduce partition, in map order."""
        raise NotImplementedError

    def bytes_written(self) -> int:
        return 0

    def stats(self) -> Dict[str, int]:
        """Cumulative counters the exchange shows as its metrics: bytes
        each way and codec encode/decode time (zero where a path does not
        apply: the device transport never serializes)."""
        return {"bytes_written": self.bytes_written(), "bytes_fetched": 0,
                "encode_ns": 0, "decode_ns": 0}

    def release(self, shuffle_id: int) -> None:
        pass


class DeviceShuffleTransport(ShuffleTransport):
    """Pieces stay on the device, registered spillable with the buffer
    catalog (reference ``transport.py:71``: the UCX device-cache path
    analog, RapidsShuffleInternalManager.scala:90-150): under memory
    pressure a piece moves to the host or disk and comes back at its
    fetch. A piece is a view of its rows of the partition-ordered batch,
    so its device memory is freed once every piece of that batch is off
    the device."""

    def __init__(self):
        self._catalog: Dict[Tuple[int, int], List[tuple]] = {}
        self._lock = threading.Lock()
        self._bytes = 0
        self._fetched = 0

    def write(self, shuffle_id, map_id, reduce_id, piece, schema):
        from ..memory import INPUT_FROM_SHUFFLE_PRIORITY, SpillableVals

        sv = SpillableVals(piece.vals, INPUT_FROM_SHUFFLE_PRIORITY)
        with self._lock:
            self._catalog.setdefault((shuffle_id, reduce_id), []).append(
                (map_id, (sv, piece.n, piece.byte_lens)))
            self._bytes += sv.size_bytes
        _note_write(shuffle_id, map_id, reduce_id, piece.n, sv.size_bytes,
                    self.codec)

    def fetch(self, shuffle_id, reduce_id):
        with self._lock:
            entries = sorted(self._catalog.get((shuffle_id, reduce_id), ()),
                             key=lambda e: e[0])
            nb = sum(sv.size_bytes for _, (sv, _n, _b) in entries)
            self._fetched += nb
        out = [ShufflePiece(sv.get_vals(), n, bl)
               for _, (sv, n, bl) in entries]
        _note_fetch(shuffle_id, reduce_id, out, nb, self.codec)
        return out

    def bytes_written(self):
        return self._bytes

    def stats(self):
        return {"bytes_written": self._bytes, "bytes_fetched": self._fetched,
                "encode_ns": 0, "decode_ns": 0}

    def release(self, shuffle_id):
        with self._lock:
            victims = [k for k in self._catalog if k[0] == shuffle_id]
            entries = [e for k in victims for e in self._catalog.pop(k)]
        for _, (sv, _n, _bl) in entries:
            sv.close(reason="shuffle_release")

    def held(self, shuffle_id: int) -> int:
        """Pieces still held for ``shuffle_id``."""
        with self._lock:
            return sum(len(v) for k, v in self._catalog.items()
                       if k[0] == shuffle_id)


class SerializingTransportBase(ShuffleTransport):
    """Wire-format accounting shared by the transports whose pieces
    round-trip through the host serializer (the host-bytes fallback and
    the network transport, reference ``transport.py:143``): codec encode
    and decode timing, byte counters both ways and the shuffle events,
    ONE implementation so their metrics cannot drift. Fetched pieces are
    uploaded back to ``device``."""

    def __init__(self, codec: str = "none", device=None):
        self.codec = codec
        self.device = device
        self._bytes = 0
        self._fetched = 0
        self._encode_ns = 0
        self._decode_ns = 0
        self._lock = threading.Lock()

    def _encode_piece(self, piece: ShufflePiece, schema, shuffle_id: int,
                      map_id: int, reduce_id: int) -> bytes:
        """piece -> wire bytes, counting encode time and written bytes."""
        from ..exec.base import batch_from_vals
        from .serializer import serialize_batch

        batch = batch_from_vals(piece.vals, schema, piece.n)
        t0 = time.perf_counter_ns()
        data = serialize_batch(batch, self.codec)
        enc = time.perf_counter_ns() - t0
        with self._lock:
            self._bytes += len(data)
            self._encode_ns += enc
        _note_write(shuffle_id, map_id, reduce_id, piece.n, len(data),
                    self.codec)
        if _obs.enabled():
            _obs.inc("tpu_shuffle_codec_seconds", enc / 1e9, op="encode")
        return data

    def _decode_entries(self, entries: Sequence[Tuple[int, bytes]],
                        shuffle_id: int, reduce_id: int,
                        retries: Optional[int] = None
                        ) -> List[ShufflePiece]:
        """Map-ordered (map_id, wire bytes) -> pieces, counting decode
        time (the upload included) and fetched bytes. ``retries``: the
        transient-failure retries this fetch paid (network transport
        only; the event's optional field)."""
        from ..exec.base import vals_of_batch
        from .serializer import deserialize_with_byte_lens

        out: List[ShufflePiece] = []
        nb = 0
        t0 = time.perf_counter_ns()
        for _, data in entries:
            batch, byte_lens = deserialize_with_byte_lens(data,
                                                          self.device)
            nb += len(data)
            out.append(ShufflePiece(vals_of_batch(batch), batch.num_rows,
                                    byte_lens))
        dec = time.perf_counter_ns() - t0
        with self._lock:
            self._fetched += nb
            self._decode_ns += dec
        _note_fetch(shuffle_id, reduce_id, out, nb, self.codec, retries)
        if _obs.enabled():
            _obs.inc("tpu_shuffle_codec_seconds", dec / 1e9, op="decode")
        return out

    def bytes_written(self):
        return self._bytes

    def stats(self):
        with self._lock:
            return {"bytes_written": self._bytes,
                    "bytes_fetched": self._fetched,
                    "encode_ns": self._encode_ns,
                    "decode_ns": self._decode_ns}


class SerializedShuffleTransport(SerializingTransportBase):
    """Pieces round-trip through the host wire format (the fallback
    serializer path: GpuColumnarBatchSerializer.scala:51), uploaded back
    to ``device`` at fetch."""

    def __init__(self, codec: str = "none", device=None):
        super().__init__(codec, device)
        self._store: Dict[Tuple[int, int], List[Tuple[int, bytes]]] = {}

    def write(self, shuffle_id, map_id, reduce_id, piece, schema):
        data = self._encode_piece(piece, schema, shuffle_id, map_id,
                                  reduce_id)
        with self._lock:
            self._store.setdefault((shuffle_id, reduce_id), []).append(
                (map_id, data))

    def fetch(self, shuffle_id, reduce_id):
        with self._lock:
            entries = sorted(self._store.get((shuffle_id, reduce_id), ()),
                             key=lambda e: e[0])
        return self._decode_entries(entries, shuffle_id, reduce_id)

    def release(self, shuffle_id):
        with self._lock:
            for k in [k for k in self._store if k[0] == shuffle_id]:
                del self._store[k]


_next_shuffle_id = [0]
_id_lock = threading.Lock()


def new_shuffle_id() -> int:
    with _id_lock:
        _next_shuffle_id[0] += 1
        return _next_shuffle_id[0]
