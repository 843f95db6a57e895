"""Shuffle storage behind a transport interface: device pieces or host
bytes.

Counterpart of ``spark_rapids_tpu/shuffle/transport.py``: map tasks
write pieces through a transport, reduce tasks fetch them by
(shuffle id, reduce id) in map order, and the transport decides where
they live. ``DeviceShuffleTransport`` keeps each piece as the plain
tensors of its slice of the partition-sorted batch, as the port keeps a
join build (the reference registers them spillable with its buffer
catalog: ROADMAP.md, queue A item 'The spillable build and OOM retry
around the probe'); ``SerializedShuffleTransport`` round-trips every
piece through the host wire format (``serializer.py``). The shuffle
events and observability counters are items 7 and 26.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Sequence, Tuple

from .. import types as T
from ..expr.values import Val


@dataclasses.dataclass
class ShufflePiece:
    """One (map, reduce) piece: columns of ``n`` rows and, per string
    column in order, its byte length (host ints synced once per map
    batch, where the reference syncs its contiguousSplit sizes)."""

    vals: List[Val]
    n: int
    byte_lens: Tuple[int, ...] = ()


def piece_bytes(vals: Sequence[Val]) -> int:
    """The device bytes of a piece's planes."""
    total = 0
    for v in vals:
        for t in v:
            total += t.numel() * t.element_size()
    return total


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
    """Pieces stay on the device (the UCX device-cache path analog)."""

    def __init__(self):
        self._catalog: Dict[Tuple[int, int], List[Tuple[int, ShufflePiece]]] \
            = {}
        self._lock = threading.Lock()
        self._bytes = 0
        self._fetched = 0

    def write(self, shuffle_id, map_id, reduce_id, piece, schema):
        nb = piece_bytes(piece.vals)
        with self._lock:
            self._catalog.setdefault((shuffle_id, reduce_id), []).append(
                (map_id, piece))
            self._bytes += nb

    def fetch(self, shuffle_id, reduce_id):
        with self._lock:
            entries = sorted(self._catalog.get((shuffle_id, reduce_id), ()),
                             key=lambda e: e[0])
            self._fetched += sum(piece_bytes(p.vals) for _, p in entries)
        return [p for _, p in entries]

    def bytes_written(self):
        return self._bytes

    def stats(self):
        return {"bytes_written": self._bytes, "bytes_fetched": self._fetched,
                "encode_ns": 0, "decode_ns": 0}

    def release(self, shuffle_id):
        with self._lock:
            for k in [k for k in self._catalog if k[0] == shuffle_id]:
                del self._catalog[k]

    def held(self, shuffle_id: int) -> int:
        """Pieces still held for ``shuffle_id``."""
        with self._lock:
            return sum(len(v) for k, v in self._catalog.items()
                       if k[0] == shuffle_id)


class SerializedShuffleTransport(ShuffleTransport):
    """Pieces round-trip through the host wire format (the fallback
    serializer path: GpuColumnarBatchSerializer.scala:51), uploaded back
    to ``device`` at fetch."""

    def __init__(self, codec: str = "none", device=None):
        self.codec = codec
        self.device = device
        self._store: Dict[Tuple[int, int], List[Tuple[int, bytes]]] = {}
        self._bytes = 0
        self._fetched = 0
        self._encode_ns = 0
        self._decode_ns = 0
        self._lock = threading.Lock()

    def write(self, shuffle_id, map_id, reduce_id, piece, schema):
        from ..exec.base import batch_from_vals
        from .serializer import serialize_batch

        batch = batch_from_vals(piece.vals, schema, piece.n)
        t0 = time.perf_counter_ns()
        data = serialize_batch(batch, self.codec)
        enc = time.perf_counter_ns() - t0
        with self._lock:
            self._store.setdefault((shuffle_id, reduce_id), []).append(
                (map_id, data))
            self._bytes += len(data)
            self._encode_ns += enc

    def fetch(self, shuffle_id, reduce_id):
        from ..exec.base import vals_of_batch
        from .serializer import deserialize_with_byte_lens

        with self._lock:
            entries = sorted(self._store.get((shuffle_id, reduce_id), ()),
                             key=lambda e: e[0])
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
        return out

    def bytes_written(self):
        return self._bytes

    def stats(self):
        with self._lock:
            return {"bytes_written": self._bytes,
                    "bytes_fetched": self._fetched,
                    "encode_ns": self._encode_ns,
                    "decode_ns": self._decode_ns}

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
