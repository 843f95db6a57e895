"""Exec base class, metrics, and batch <-> value plumbing.

Counterpart of ``spark_rapids_tpu/exec/base.py``. An exec exposes
``num_partitions`` and ``execute_partition(i)``; fusable execs
(project, filter, a join on its fused fast path) implement ``lower_batch``
and run as one eager chain of torch calls per batch
(:func:`run_fused_chain`). PyTorch runs eagerly, so there is no ``jit``, no
``cached_pipeline`` and no buffer donation.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from .. import types as T
from ..columnar import ColumnarBatch, DeviceColumn, choose_capacity
from ..conf import RapidsConf
from ..expr.eval import column_of_val, val_of_column
from ..expr.values import DictV, Val
from ..ops import concat as concat_ops
from ..ops import filter_gather
from ..types import StructType

NUM_OUTPUT_ROWS = "numOutputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"
TOTAL_TIME = "totalTime"


_PLANNING = threading.local()


@contextlib.contextmanager
def planning_mode():
    """Marks plan construction: adaptive reads report their static
    partition count instead of materializing their stage (reference
    ``exec/base.py:242``)."""
    prev = getattr(_PLANNING, "on", False)
    _PLANNING.on = True
    try:
        yield
    finally:
        _PLANNING.on = prev


def in_planning() -> bool:
    return getattr(_PLANNING, "on", False)


class Metric:
    """One named counter; 'ns' metrics render as ms, 'bytes' as MB."""

    __slots__ = ("name", "value", "kind")

    def __init__(self, name: str, kind: Optional[str] = None):
        self.name = name
        self.value = 0
        if kind is None:
            kind = "ns" if ("Time" in name or name == TOTAL_TIME) else "count"
        self.kind = kind

    def add(self, v: int) -> None:
        self.value += v

    def set(self, v: int) -> None:
        self.value = v

    def pretty(self) -> str:
        if self.kind == "ns":
            return f"{self.value / 1e6:.1f}ms"
        if self.kind == "bytes":
            return f"{self.value / 1e6:.1f}MB"
        return str(self.value)

    def __repr__(self):
        return f"{self.name}={self.value}"


class TpuExec:
    """Base physical operator producing columnar batches."""

    #: True when this exec can lower into a shared fused chain
    fusable = False
    #: True when lower_batch may clear liveness bits (filters)
    sparsifies = False

    def __init__(self, conf: RapidsConf, children: Sequence["TpuExec"] = ()):
        self.conf = conf
        self.children: List[TpuExec] = list(children)
        self.metrics: Dict[str, Metric] = {}
        for name in (NUM_OUTPUT_ROWS, NUM_OUTPUT_BATCHES, TOTAL_TIME):
            self.metrics[name] = Metric(name)

    @property
    def output_schema(self) -> StructType:
        raise NotImplementedError(type(self).__name__)

    @property
    def device(self):
        """The plan's device: a leaf's own, inherited by every parent."""
        if not self.children:
            raise NotImplementedError(type(self).__name__)
        return self.children[0].device

    @property
    def num_partitions(self) -> int:
        if self.children:
            return self.children[0].num_partitions
        return 1

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        raise NotImplementedError(type(self).__name__)

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        """All partitions, serially (driver-side collect path). Each
        partition holds the device concurrency semaphore while its work
        runs (reference ``exec/base.py:386``: GpuSemaphore)."""
        from ..memory.semaphore import TpuSemaphore

        sem = TpuSemaphore.initialize(self.conf)
        for p in range(self.num_partitions):
            sem.acquire_if_necessary()
            try:
                yield from self.execute_partition(p)
            finally:
                sem.release_if_necessary()

    # -- fusion --------------------------------------------------------------
    def lower_batch(self, cols, live, cap, side=()):
        """(cols, live_mask) -> (cols, live_mask), eager torch ops.
        ``side``: this exec's :meth:`side_vals` (e.g. a join's build-side
        table)."""
        raise NotImplementedError(type(self).__name__)

    def side_vals(self) -> tuple:
        """Device tensors this exec's ``lower_batch`` needs beyond the
        streamed batch."""
        return ()

    def fusion_stream_child(self) -> Optional["TpuExec"]:
        """The child whose batches stream through this exec's lowering:
        a single-child exec's only child; a fast-path join's probe side
        (its build side enters through :meth:`side_vals`)."""
        return self.children[0] if len(self.children) == 1 else None

    def fused_source_chain(self):
        """(source exec, [fusable execs bottom-up ending at self])."""
        node = self
        chain: List[TpuExec] = []
        while node.fusable:
            nxt = node.fusion_stream_child()
            if nxt is None:
                break
            chain.append(node)
            node = nxt
        return node, list(reversed(chain))

    # -- conveniences --------------------------------------------------------
    def metric(self, name: str, kind: Optional[str] = None) -> Metric:
        if name not in self.metrics:
            self.metrics[name] = Metric(name, kind)
        return self.metrics[name]

    @contextlib.contextmanager
    def op_timed(self, section: str = "", metric_name: str = TOTAL_TIME):
        """Host wall-clock of a hot section into ``metric_name``. Kernel
        launches are asynchronous, so this is enqueue time plus the time
        of the host syncs inside the section, not device time."""
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            self.metric(metric_name).add(time.perf_counter_ns() - start)

    def record_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        nr = batch.num_rows_lazy
        if isinstance(nr, int):
            self.metrics[NUM_OUTPUT_ROWS].add(nr)
        self.metrics[NUM_OUTPUT_BATCHES].add(1)
        return batch

    def collect(self) -> List[tuple]:
        """Columnar-to-row boundary for the whole plan."""
        rows: List[tuple] = []
        for batch in self.execute_columnar():
            rows.extend(batch.to_rows())
        return rows

    @property
    def node_name(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def describe(self) -> str:
        return self.node_name

    def __repr__(self):
        return self.tree_string()


def format_metrics(plan: TpuExec) -> str:
    """One line per exec: its ``describe()`` and its non-zero metrics
    (reference ``exec/base.py:611`` without the device-lane, XLA-cost,
    compile-cache and memory columns, which have no port yet)."""
    lines: List[str] = []

    def walk(node: TpuExec, depth: int) -> None:
        parts = [f"{m.name}={m.pretty()}" for m in node.metrics.values()
                 if m.value]
        lines.append("  " * depth + node.describe()
                     + (": " + ", ".join(parts) if parts else ""))
        for c in node.children:
            if isinstance(c, TpuExec):
                walk(c, depth + 1)

    walk(plan, 0)
    return "\n".join(lines)


def vals_of_batch(batch: ColumnarBatch) -> List[Val]:
    """The batch's columns as lowering values (a dictionary-encoded one
    as its DictV)."""
    return [val_of_column(c) for c in batch.columns]


def materialized_batch(batch: ColumnarBatch) -> ColumnarBatch:
    """The batch with every dictionary-encoded column expanded to the
    plain string layout (reference ``exec/base.py:766``): the boundary of
    the execs with no dictionary path (sort and window keys, a join's
    build and its row-repeating expansion, a concat of batches)."""
    if not any(c.is_dict for c in batch.columns):
        return batch
    return ColumnarBatch([c.materialize() for c in batch.columns],
                         batch.schema, batch.num_rows_lazy)


def batch_from_vals(vals: Sequence[Val], schema: StructType, num_rows,
                    capacity: Optional[int] = None) -> ColumnarBatch:
    cols = [column_of_val(f.dataType, num_rows, v)
            for f, v in zip(schema.fields, vals)]
    return ColumnarBatch(cols, schema, num_rows, capacity=capacity)


def concat_all(exec_: TpuExec) -> Optional[ColumnarBatch]:
    """Every partition of an exec in ONE batch (the build side)."""
    batches: List[ColumnarBatch] = []
    for p in range(exec_.num_partitions):
        for b in exec_.execute_partition(p):
            if b.num_rows > 0:
                batches.append(b)
    return concat_batches(exec_.output_schema, batches)


def host_ints(xs: Sequence) -> List[int]:
    """Host ints and 0-d device tensors as host ints, with one sync for
    all the tensors among them."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    if not ts:
        return [int(x) for x in xs]
    dev = ts[0].device
    return [int(v) for v in torch.stack([
        torch.as_tensor(x, dtype=torch.int64, device=dev).reshape(())
        for x in xs]).tolist()]


def concat_batches(schema: StructType, batches: List[ColumnarBatch],
                    min_bucket: int = 128) -> Optional[ColumnarBatch]:
    """The live rows of ``batches`` in one batch (reference
    ``exec/join.py:213``). String columns splice their byte pools
    (``ops/concat.concat_batches_cols``): one host sync reads every
    batch's row count and string byte counts. Dictionary-encoded columns
    materialize first, since each batch has its own dictionary; a single
    batch passes through as it is."""
    if not batches:
        return None
    if len(batches) == 1:
        return batches[0]
    if any(c.is_dict for b in batches for c in b.columns):
        # expand only each batch's live rows (one more sync, for the row
        # counts): an aggregate's partial holds a few groups at its
        # input's capacity
        rows = host_ints([b.num_rows_lazy for b in batches])
        batches = [materialized_batch(head_rows(b, n))
                   for b, n in zip(batches, rows)]
    str_cols = [j for j, f in enumerate(schema.fields)
                if T.is_string(f.dataType)]
    heads = [b.num_rows_lazy for b in batches]
    for b in batches:
        n = b.num_rows_lazy
        for j in str_cols:
            c = b.columns[j]
            cap = c.offsets.shape[0] - 1
            heads.append(c.offsets[min(n, cap) if isinstance(n, int)
                                   else n.long().clamp(0, cap)])
    pulled = host_ints(heads)
    nb, ns = len(batches), len(str_cols)
    lengths = pulled[:nb]
    byte_lengths = [pulled[nb + i * ns:nb + (i + 1) * ns] for i in range(nb)]
    total = sum(lengths)
    out_cap = choose_capacity(total, min_bucket)
    char_caps = [choose_capacity(max(1, sum(bl[k] for bl in byte_lengths)),
                                 128) for k in range(ns)]
    cols, n = concat_ops.concat_batches_cols(
        [vals_of_batch(b) for b in batches], lengths, byte_lengths, out_cap,
        char_caps)
    return batch_from_vals(cols, schema, n)


def head_rows(batch: ColumnarBatch, n: int) -> ColumnarBatch:
    """The batch's first ``n`` rows (its live ones) at the capacity
    bucket of ``n``, when that is smaller: views of each column's planes,
    a string column's byte pool as it is."""
    cap = choose_capacity(n)
    if cap >= batch.capacity:
        return batch
    cols = []
    for c in batch.columns:
        if c.is_dict:
            d = c.dictv
            cols.append(DeviceColumn.dict_encoded(c.dtype, n, DictV(
                d.codes[:cap], d.dictionary, d.validity[:cap], d.mat_cap,
                d.max_len, d.unique)))
        elif c.is_string:
            cols.append(DeviceColumn(c.dtype, n, None, c.validity[:cap],
                                     c.offsets[:cap + 1], c.chars))
        else:
            cols.append(DeviceColumn(c.dtype, n, c.data[:cap],
                                     c.validity[:cap]))
    return ColumnarBatch(cols, batch.schema, n)


def run_fused_chain(exec_self: TpuExec, index: int) -> Iterator[ColumnarBatch]:
    """Shared execute_partition of fusable execs: the chain below (and
    including) ``exec_self`` runs eagerly per batch, threading a liveness
    mask; if any stage sparsified it, rows compact once at the end (string
    columns through the two-pass string gather), and the row count stays
    a device scalar (no host sync).

    Each batch runs under the OOM retry harness (``memory/retry.py``,
    reference ``exec/base.py:872``): a device OOM spills and re-attempts,
    and when the attempts run out the batch splits in half and the
    pieces' outputs re-join row-wise (exact: the chain is row-local)."""
    from ..memory.retry import with_oom_retry

    source, chain = exec_self.fused_source_chain()
    out_schema = exec_self.output_schema
    needs_compact = any(e.sparsifies for e in chain)
    sides = [e.side_vals() for e in chain]

    def attempt(b: ColumnarBatch) -> ColumnarBatch:
        cols = vals_of_batch(b)
        cap = b.capacity
        nr = b.num_rows_lazy
        dev = cols[0].validity.device if cols else None
        live = filter_gather.live_of(nr, cap, dev)
        for e, side in zip(chain, sides):
            cols, live = e.lower_batch(cols, live, cap, side)
        if needs_compact:
            cols, nr = filter_gather.filter_cols(cols, live)
        return batch_from_vals(cols, out_schema, nr, capacity=cap)

    for b in source.execute_partition(index):
        with exec_self.op_timed():
            out = with_oom_retry(exec_self.node_name, attempt, b,
                                 exec_self.conf)
        yield exec_self.record_batch(out)
