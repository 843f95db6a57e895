"""Columnar exchange execs: the single-process shuffle, its adaptive
reads, and the broadcast.

Counterpart of ``spark_rapids_tpu/exec/exchange.py``. The map side
partitions each child batch (``shuffle/partition.py``: partition ids, one
stable sort), makes ONE host sync for every partition's row count and
every string column's bytes per partition together (the reference's
offsets and byte offsets), gathers the live rows in partition order
into pools of their exact size, slices the pieces and writes them
through the transport. A batch with dictionary columns expands only its
live rows, which costs one more sync for its row count. The reduce side
fetches a partition's pieces in map order and concatenates them into
one batch (the GpuShuffleCoalesceExec role); after the last reduce
partition the transport is released and the map latch reset, so that a
second ``collect()`` rebuilds.

In eager PyTorch a piece is a view of its rows of the partition-ordered
batch (a string column's offsets re-based), where the reference gathers
each into a power-of-two capacity to reuse its compiled programs; the
reduce side's concat gives every partition its capacity bucket. The
pieces keep the ordered batch alive until ``release()``.

The map side's staging and the reduce side's concat run outside the
per-batch retry harness: a device OOM there surfaces as the named
``TpuOutOfDeviceMemory`` (``memory/retry.named_oom``). The broadcast
batch, like the device transport's pieces, is registered spillable
(``memory/spillable.py``), so memory pressure can move it to the host
between its reads.

The transports emit the shuffle events and counters
(``shuffle/transport.py``); ``shuffle.transport.class=network`` takes the
TCP block server and client of ``shuffle/network.py``.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..columnar import ColumnarBatch, choose_capacity
from ..conf import (AQE_SKEW_FACTOR, AQE_TARGET_ROWS, RapidsConf,
                    SHUFFLE_COMPRESSION_CODEC, SHUFFLE_TRANSPORT_CLASS)
from ..expr.values import ColV, StrV, Val
from ..memory.retry import named_oom
from ..ops import concat as concat_ops
from ..ops import filter_gather
from ..ops.sort import str_max_lens
from ..shuffle.partition import (Partitioning, RangePartitioning,
                                 partition_order)
from ..shuffle.transport import (DeviceShuffleTransport,
                                 SerializedShuffleTransport, ShufflePiece,
                                 ShuffleTransport, new_shuffle_id)
from ..types import StructType
from ..plugin.donation import claim
from .base import (TpuExec, batch_from_vals, concat_all, head_rows,
                   host_ints, in_planning, materialized_batch, site_call,
                   vals_of_batch)

PARTITION_SIZE = "partitionSize"  # reference metric (GpuExec.scala:27-60)
DATA_SIZE = "dataSize"
SHUFFLE_BYTES_WRITTEN = "shuffleBytesWritten"
SHUFFLE_BYTES_FETCHED = "shuffleBytesFetched"
CODEC_ENCODE_TIME = "codecEncodeTime"
CODEC_DECODE_TIME = "codecDecodeTime"

def _network_peers(conf: RapidsConf) -> Tuple[Tuple[str, int], ...]:
    """``shuffle.network.peers`` as (host, port) pairs."""
    from ..conf import SHUFFLE_NETWORK_PEERS

    remotes = []
    for p in conf.get(SHUFFLE_NETWORK_PEERS).split(","):
        p = p.strip()
        if not p:
            continue
        host, sep, port = p.rpartition(":")
        if not sep or not host or not port:
            raise ValueError(
                "spark.rapids.tpu.shuffle.network.peers: invalid peer "
                f"entry {p!r} (expected host:port)")
        try:
            remotes.append((host, int(port)))
        except ValueError:
            raise ValueError(
                "spark.rapids.tpu.shuffle.network.peers: invalid port in "
                f"peer entry {p!r} (expected host:port)") from None
    return tuple(remotes)


def make_transport(conf: RapidsConf, device) -> ShuffleTransport:
    """The transport ``shuffle.transport.class`` names (reference
    ``exchange.py:64``). ``network``: the process-wide block server owns
    this worker's map output and fetches merge every peer's pieces
    (transport selection by conf, RapidsShuffleTransport.scala:328-411)."""
    kind = conf.get(SHUFFLE_TRANSPORT_CLASS)
    if kind == "host":
        return SerializedShuffleTransport(
            conf.get(SHUFFLE_COMPRESSION_CODEC), device)
    if kind == "network":
        from ..conf import SHUFFLE_NETWORK_LISTEN_PORT
        from ..shuffle.network import NetworkShuffleTransport, local_server

        return NetworkShuffleTransport(
            server=local_server(conf.get(SHUFFLE_NETWORK_LISTEN_PORT)),
            remotes=_network_peers(conf),
            codec=conf.get(SHUFFLE_COMPRESSION_CODEC),
            owns_server=False, device=device)
    return DeviceShuffleTransport()


def _prefix(counts: Sequence[int]) -> List[int]:
    out = [0]
    for c in counts:
        out.append(out[-1] + c)
    return out


def _slice_piece(vals: Sequence[Val], a: int, b: int,
                 str_bounds: Sequence[Tuple[int, int]]) -> ShufflePiece:
    """Rows [a, b) of partition-sorted columns as a piece: views of the
    fixed-width planes, and for a string column its re-based offsets and
    a view of its bytes. ``str_bounds[i]`` = (byte start, byte end) of
    the i-th string column (host ints synced at the map boundary)."""
    out: List[Val] = []
    si = 0
    for v in vals:
        if isinstance(v, StrV):
            ba, bb = str_bounds[si]
            si += 1
            out.append(StrV(v.offsets[a:b + 1] - ba, v.chars[ba:bb],
                            v.validity[a:b]))
        else:
            out.append(ColV(v.data[a:b], v.validity[a:b]))
    return ShufflePiece(out, b - a, tuple(bb - ba for ba, bb in str_bounds))


def concat_pieces(pieces: Sequence[ShufflePiece],
                  schema: StructType) -> ColumnarBatch:
    """The pieces' rows in one batch at the capacity bucket of their
    total (reference ``exchange.py:155``); the row and byte counts are
    host ints, so no sync."""
    lengths = [p.n for p in pieces]
    n_str = len(pieces[0].byte_lens)
    out_cap = choose_capacity(max(1, sum(lengths)))
    out_char_caps = [
        choose_capacity(max(1, sum(p.byte_lens[k] for p in pieces)), 128)
        for k in range(n_str)]
    cols, n = concat_ops.concat_batches_cols(
        [p.vals for p in pieces], lengths,
        [list(p.byte_lens) for p in pieces], out_cap, out_char_caps)
    return batch_from_vals(cols, schema, n)


class TpuShuffleExchangeExec(TpuExec):
    """Repartition the child's output by a Partitioning through the
    transport (reference ``exchange.py:192``)."""

    def __init__(self, conf: RapidsConf, child: TpuExec,
                 partitioning: Partitioning,
                 transport: Optional[ShuffleTransport] = None):
        super().__init__(conf, [child])
        self.partitioning = partitioning
        self.transport = transport or make_transport(conf, child.device)
        self.shuffle_id = new_shuffle_id()
        self._map_done = False
        self._consumed: set = set()
        self._map_lock = threading.RLock()
        self.partition_rows: List[int] = []
        self.metrics[PARTITION_SIZE] = self.metric(PARTITION_SIZE)
        self.metrics[DATA_SIZE] = self.metric(DATA_SIZE, "bytes")

    @property
    def output_schema(self) -> StructType:
        return self.children[0].output_schema

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    def describe(self):
        return f"TpuShuffleExchangeExec {self.partitioning.describe()}"

    # -- map side ----------------------------------------------------------
    def _key_vals(self, cols: Sequence[Val]) -> List[Val]:
        return [cols[i] for i in getattr(self.partitioning, "key_indices",
                                         ())]

    def _sample_range_bounds(self, parts: List[List[ColumnarBatch]]) -> None:
        """Sample key values on the device, read back only the sample and
        set the range bounds on the host (reference ``exchange.py:268``,
        GpuRangePartitioner's sketch): up to 128 rows a batch at a stride
        of ``n // take``, sorted by the CPU engine's Spark order, the
        ``P - 1`` bounds at ``j * len // P``."""
        from ..cpu.plan import _SparkOrderKey

        part = self.partitioning
        assert isinstance(part, RangePartitioning)
        if part.bounds is not None:
            return
        samples: List[tuple] = []
        key_schema = T.StructType(tuple(
            self.output_schema.fields[i] for i in part.key_indices))
        for batches in parts:
            for b in batches:
                n = b.num_rows
                if n == 0:
                    continue
                take = min(n, 128)
                step = max(1, n // take)
                cols = vals_of_batch(materialized_batch(b))
                dev = cols[0].validity.device
                idx = torch.arange(0, n, step, dtype=torch.int64,
                                   device=dev)
                m = int(idx.shape[0])
                sampled = filter_gather.gather(
                    self._key_vals(cols), idx,
                    torch.ones(m, dtype=torch.bool, device=dev))
                sb = batch_from_vals(sampled, key_schema, m)
                samples.extend(sb.to_rows())
        P = part.num_partitions
        if not samples:
            part.bounds = [[None] * (P - 1) for _ in part.key_indices]
            return
        samples.sort(key=lambda row: tuple(
            _SparkOrderKey(v, o.ascending, o.nulls_first_resolved)
            for v, o in zip(row, part.orders)))
        bounds_rows = [samples[min(len(samples) - 1, j * len(samples) // P)]
                       for j in range(1, P)]
        part.bounds = [[row[k] for row in bounds_rows]
                       for k in range(len(part.key_indices))]

    def _map_batch(self, map_id: int, batch: ColumnarBatch,
                   schema: StructType) -> None:
        """Partition one child batch and write its pieces. One host sync
        reads each partition's row count and each string column's bytes
        per partition together; then only the live rows are gathered, in
        partition order, into pools of their exact size."""
        P = self.num_partitions
        if any(c.is_dict for c in batch.columns):
            # dictionary columns materialize at the shuffle boundary:
            # pieces slice and serialize the plain layout, and partitions
            # share no dictionary. An aggregate's partial holds a few
            # groups at its input's capacity, so only the live rows
            # expand (one more sync, for the row count)
            batch = materialized_batch(
                head_rows(batch, host_ints([batch.num_rows_lazy])[0]))
        cols = vals_of_batch(batch)
        dev = cols[0].validity.device
        nr = batch.num_rows_lazy
        live = filter_gather.live_of(nr, batch.capacity, dev)
        # the string keys' byte bounds: one more sync when there are any,
        # as the reference's _key_str_lens
        sml = str_max_lens(self._key_vals(cols))
        pids = self.partitioning.partition_ids(cols, schema, live, map_id,
                                               sml)
        word, perm, counts = partition_order(pids, nr, P)
        strs = [c for c in cols if isinstance(c, StrV)]
        byte_counts = [torch.zeros(P + 1, dtype=torch.int64, device=dev)
                       .index_add_(0, word, (c.offsets[1:] - c.offsets[:-1])
                                   .to(torch.int64))[:P] for c in strs]
        host = torch.cat([counts] + byte_counts).tolist()
        off_h = _prefix(host[:P])
        boffs_h = [_prefix(host[(k + 1) * P:(k + 2) * P])
                   for k in range(len(strs))]
        n = off_h[-1]
        if n == 0:
            return
        idx = perm[:n]
        sorted_cols = filter_gather.gather(
            cols, idx, torch.ones(n, dtype=torch.bool, device=dev),
            [max(1, bo[-1]) for bo in boffs_h])
        for j in range(P):
            a, b = off_h[j], off_h[j + 1]
            if a == b:
                continue
            piece = _slice_piece(sorted_cols, a, b,
                                 [(bo[j], bo[j + 1]) for bo in boffs_h])
            self.transport.write(self.shuffle_id, map_id, j, piece, schema)
            self.metrics[PARTITION_SIZE].add(b - a)
            # per-reduce-partition row stats: the AQE reads re-plan from
            # them (reference: MapOutputStats)
            self.partition_rows[j] += b - a

    def _run_map_side(self) -> None:
        with self._map_lock:
            if self._map_done:
                return
            child = self.children[0]
            schema = self.output_schema
            needs_sample = (isinstance(self.partitioning, RangePartitioning)
                            and self.partitioning.bounds is None)
            if needs_sample:
                parts = [list(child.execute_partition(p))
                         for p in range(child.num_partitions)]
                self._sample_range_bounds(parts)
                batch_iter = ((p, b) for p, bs in enumerate(parts)
                              for b in bs)
            else:
                batch_iter = ((p, b) for p in range(child.num_partitions)
                              for b in child.execute_partition(p))
            self.partition_rows = [0] * self.num_partitions
            with self.op_timed(), named_oom(f"{self.node_name}.map"):
                for map_id, batch in batch_iter:
                    if batch.columns:
                        # the transport retains what it is handed
                        claim(batch)
                        site_call(self, "exchange", batch,
                                  lambda: self._map_batch(map_id, batch,
                                                          schema),
                                  key=lambda: (self.num_partitions,))
            self.metrics[DATA_SIZE].set(self.transport.bytes_written())
            self._note_transport_stats()
            self._map_done = True

    def _note_transport_stats(self) -> None:
        """The per-shuffle transport metrics from the transport's running
        totals (set, not add: the AQE reads share this transport)."""
        st = self.transport.stats()
        self.metric(SHUFFLE_BYTES_WRITTEN, "bytes").set(st["bytes_written"])
        self.metric(SHUFFLE_BYTES_FETCHED, "bytes").set(st["bytes_fetched"])
        if st["encode_ns"]:
            self.metric(CODEC_ENCODE_TIME, "ns").set(st["encode_ns"])
        if st["decode_ns"]:
            self.metric(CODEC_DECODE_TIME, "ns").set(st["decode_ns"])

    def release_after(self, consumed: set, index: int, total: int) -> None:
        """Mark reduce read ``index`` of ``total`` done in ``consumed``;
        after the last, drop the pieces and reset the map latch so that a
        re-execution rebuilds them (under the map lock: two readers must
        not both release)."""
        with self._map_lock:
            consumed.add(index)
            if len(consumed) >= total:
                self.transport.release(self.shuffle_id)
                consumed.clear()
                self._map_done = False

    # -- reduce side -------------------------------------------------------
    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        self._run_map_side()
        # the reduce side's fetch and concat: a host-timed section of
        # their own (the reference leaves them untimed)
        with self.op_timed("reduce"):
            pieces = self.transport.fetch(self.shuffle_id, index)
            self._note_transport_stats()
            self.release_after(self._consumed, index, self.num_partitions)
            if not pieces:
                return
            with named_oom(f"{self.node_name}.reduce"):
                out = concat_pieces(pieces, self.output_schema)
        yield self.record_batch(out)


# ---------------------------------------------------------------------------
# AQE: post-exchange stats -> re-planned reads
# ---------------------------------------------------------------------------
class TpuAQEShuffleReadExec(TpuExec):
    """Adaptive shuffle read (reference ``exchange.py:452``): coalesces
    small reduce partitions and splits skewed ones from the exchange's
    per-partition row counts. Specs:

      ("range", lo, hi)     reduce partitions [lo, hi) concatenated
      ("slice", rid, j, k)  slice j of k of reduce partition rid (pieces
                            grouped by cumulative rows: the skewed join
                            probe's split)
    """

    def __init__(self, conf: RapidsConf, exchange: TpuShuffleExchangeExec,
                 specs: List[tuple]):
        super().__init__(conf, [exchange])
        self.specs = specs
        self._consumed: set = set()

    @property
    def output_schema(self) -> StructType:
        return self.children[0].output_schema

    @property
    def num_partitions(self) -> int:
        return len(self.specs)

    def describe(self):
        nr = sum(1 for s in self.specs if s[0] == "range")
        ns = len(self.specs) - nr
        return f"TpuAQEShuffleReadExec({nr} coalesced, {ns} skew slices)"

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        ex: TpuShuffleExchangeExec = self.children[0]  # type: ignore
        ex._run_map_side()
        spec = self.specs[index]
        pieces: List[ShufflePiece] = []
        with self.op_timed("reduce"):
            if spec[0] == "range":
                _, lo, hi = spec
                for rid in range(lo, hi):
                    pieces.extend(ex.transport.fetch(ex.shuffle_id, rid))
            else:
                _, rid, j, k = spec
                pieces = _slice_pieces_by_rows(
                    ex.transport.fetch(ex.shuffle_id, rid), j, k)
            ex._note_transport_stats()
            ex.release_after(self._consumed, index, len(self.specs))
            if not pieces:
                return
            with named_oom(f"{self.node_name}.reduce"):
                out = concat_pieces(pieces, self.output_schema)
        yield self.record_batch(out)


def _slice_pieces_by_rows(pieces: List[ShufflePiece], j: int,
                          k: int) -> List[ShufflePiece]:
    """Split a piece list into k row-balanced groups and return group j
    (reference ``exchange.py:522``: whole pieces, by each one's middle
    row)."""
    total = sum(p.n for p in pieces)
    bounds = [total * i // k for i in range(k + 1)]
    out = []
    acc = 0
    for p in pieces:
        mid = acc + p.n // 2
        if bounds[j] <= mid < bounds[j + 1]:
            out.append(p)
        acc += p.n
    return out


def plan_aqe_coalesce(conf: RapidsConf, exchange: TpuShuffleExchangeExec
                      ) -> TpuAQEShuffleReadExec:
    """Coalesce-only re-plan (reference ``exchange.py:541``; safe for
    FINAL aggregates: whole key-disjoint partitions stay key-disjoint)."""
    exchange._run_map_side()
    rows = exchange.partition_rows
    target = conf.get(AQE_TARGET_ROWS)
    specs: List[tuple] = []
    lo = 0
    acc = 0
    for p, r in enumerate(rows):
        if acc > 0 and acc + r > target:
            specs.append(("range", lo, p))
            lo, acc = p, 0
        acc += r
    if lo < len(rows):
        specs.append(("range", lo, len(rows)))
    return TpuAQEShuffleReadExec(conf, exchange, specs)


def plan_aqe_join_pair(conf: RapidsConf, left_ex: TpuShuffleExchangeExec,
                       right_ex: TpuShuffleExchangeExec,
                       probe_left: bool = True
                       ) -> Tuple[TpuAQEShuffleReadExec,
                                  TpuAQEShuffleReadExec]:
    """Joint re-plan of a co-partitioned join's two exchanges (reference
    ``exchange.py:564``): specs stay index-aligned, skewed probe
    partitions split into row-balanced slices, each paired with the whole
    matching build partition, and small pairs coalesce."""
    left_ex._run_map_side()
    right_ex._run_map_side()
    probe_ex = left_ex if probe_left else right_ex
    build_ex = right_ex if probe_left else left_ex
    prows = probe_ex.partition_rows
    target = conf.get(AQE_TARGET_ROWS)
    factor = conf.get(AQE_SKEW_FACTOR)
    nz = sorted(r for r in prows if r > 0) or [0]
    median = nz[len(nz) // 2]
    skew_at = max(int(median * factor), target)

    probe_specs: List[tuple] = []
    build_specs: List[tuple] = []
    run_lo = None
    run_rows = 0

    def flush_run(hi):
        nonlocal run_lo, run_rows
        if run_lo is not None:
            probe_specs.append(("range", run_lo, hi))
            build_specs.append(("range", run_lo, hi))
            run_lo, run_rows = None, 0

    for p, r in enumerate(prows):
        if r > skew_at:
            flush_run(p)
            k = max(2, -(-r // target))
            for j in range(k):
                probe_specs.append(("slice", p, j, k))
                build_specs.append(("range", p, p + 1))
            continue
        if run_lo is None:
            run_lo = p
        elif run_rows + r > target:
            flush_run(p)
            run_lo = p
        run_rows += r
    flush_run(len(prows))

    probe_read = TpuAQEShuffleReadExec(conf, probe_ex, probe_specs)
    build_read = TpuAQEShuffleReadExec(conf, build_ex, build_specs)
    return ((probe_read, build_read) if probe_left
            else (build_read, probe_read))


class TpuLazyAQEReadExec(TpuExec):
    """Defers the AQE spec planning to first touch, since the stats exist
    only once the exchange's map side has run (reference
    ``exchange.py:617``). Coalesce-only unless a joint join resolver is
    given."""

    def __init__(self, conf: RapidsConf, exchange: TpuShuffleExchangeExec,
                 resolver=None):
        super().__init__(conf, [exchange])
        self._resolver = resolver
        self._inner: Optional[TpuAQEShuffleReadExec] = None

    def _resolve(self) -> TpuAQEShuffleReadExec:
        if self._inner is None:
            if self._resolver is not None:
                self._inner = self._resolver()
            else:
                self._inner = plan_aqe_coalesce(
                    self.conf, self.children[0])  # type: ignore[arg-type]
        return self._inner

    @property
    def output_schema(self) -> StructType:
        return self.children[0].output_schema

    @property
    def num_partitions(self) -> int:
        if self._inner is None and in_planning():
            # plan-time checks must not run the stage
            return self.children[0].num_partitions
        return self._resolve().num_partitions

    def describe(self):
        if self._inner is not None:
            return f"TpuLazyAQEReadExec -> {self._inner.describe()}"
        return "TpuLazyAQEReadExec (unplanned)"

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        yield from self._resolve().execute_partition(index)


def lazy_aqe_join_pair(conf: RapidsConf, left_ex: TpuShuffleExchangeExec,
                       right_ex: TpuShuffleExchangeExec,
                       probe_left: bool = True
                       ) -> Tuple[TpuLazyAQEReadExec, TpuLazyAQEReadExec]:
    """Two lazy reads over a co-partitioned join pair that resolve their
    index-aligned specs jointly on first touch (reference
    ``exchange.py:655``)."""
    state: Dict[str, tuple] = {}

    def resolve_pair():
        if "pair" not in state:
            state["pair"] = plan_aqe_join_pair(conf, left_ex, right_ex,
                                               probe_left)
        return state["pair"]

    return (TpuLazyAQEReadExec(conf, left_ex, lambda: resolve_pair()[0]),
            TpuLazyAQEReadExec(conf, right_ex, lambda: resolve_pair()[1]))


class TpuBroadcastExchangeExec(TpuExec):
    """The child in one batch, materialized once and read by every probe
    partition (reference ``exchange.py:676``). On one process the
    broadcast is the same device batch; under ``transport.class=host`` it
    round-trips through the wire format first, as the reference
    serializes a broadcast before it shares it."""

    def __init__(self, conf: RapidsConf, child: TpuExec):
        super().__init__(conf, [child])
        self._spillable = None
        self._done = False
        self._lock = threading.Lock()

    @property
    def output_schema(self) -> StructType:
        return self.children[0].output_schema

    @property
    def num_partitions(self) -> int:
        return 1

    def describe(self):
        return "TpuBroadcastExchangeExec"

    def materialize(self) -> Optional[ColumnarBatch]:
        """The broadcast batch. The first call drains the child into one
        batch, a drain the child's own execs time. The exchange's host
        section ``read`` (the port's own: the reference leaves the read
        untimed) times only what comes after it: the wire round trip, the
        registration and each read of the spillable."""
        with self._lock:
            built = None
            if not self._done:
                built = concat_all(self.children[0])
            with self.op_timed("read"):
                return self._read(built)

    def _read(self, built: Optional[ColumnarBatch]
              ) -> Optional[ColumnarBatch]:
        if not self._done:
            if built is not None:
                built = materialized_batch(built)
                if self.conf.get(SHUFFLE_TRANSPORT_CLASS) == "host":
                    from ..shuffle.serializer import (deserialize_batch,
                                                      serialize_batch)

                    data = serialize_batch(
                        built, self.conf.get(SHUFFLE_COMPRESSION_CODEC))
                    self.metric(DATA_SIZE, "bytes").set(len(data))
                    built = deserialize_batch(data, self.device)
            if built is not None:
                # registered spillable, as the reference's broadcast
                # batch (exchange.py:725); only the handle keeps it,
                # so a spill frees the device copy between reads
                from ..memory import SpillableColumnarBatch
                from ..memory.ledger import op_scope

                with op_scope(self.node_name):
                    self._spillable = SpillableColumnarBatch(
                        built, ledger_kind="plan_state")
            self._done = True
        if self._spillable is None:
            return None
        return self._spillable.get_batch()

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        b = self.materialize()
        if b is not None:
            yield self.record_batch(b)
