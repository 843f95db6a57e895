"""Basic physical operators: scan-from-memory, project, filter, range,
union, limits, expand and coalesce-batches.

Counterpart of ``spark_rapids_tpu/exec/basic.py``. Project and filter
are fusable: below an aggregate they run inside its per-batch update,
and a filter only clears liveness bits there — rows compact only where a
dense batch is emitted (``base.run_fused_chain``). A limit keeps its
batch's capacity and cuts the row count (``filter_gather.truncate_cols``);
it syncs for the row counts of the batches it takes and no others. The
reference's null elision in the expand (``entry_nonnull_flags``) is not
ported (ROADMAP.md, queue A item 'Null elision').
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from .. import types as T
from ..columnar import ColumnarBatch, DeviceColumn, resolve_device
from ..columnar.column import choose_capacity
from ..conf import MAX_READER_BATCH_SIZE_ROWS, RapidsConf
from ..expr import expressions as E
from ..expr.eval import lower, val_of_column
from ..ops import filter_gather
from ..types import StructField, StructType
from .base import (TpuExec, batch_from_vals, concat_batches, run_fused_chain,
                   vals_of_batch)


def _output_schema_for(exprs: Sequence[E.Expression],
                       child: StructType) -> StructType:
    fields = []
    for i, e in enumerate(exprs):
        name = e.name if isinstance(e, (E.Alias, E.UnresolvedAttribute)) \
            else f"col{i}"
        bound = E.bind_references(e, child)
        fields.append(StructField(name, bound.dtype, bound.nullable))
    return StructType(tuple(fields))


class InMemoryScanExec(TpuExec):
    """Leaf over already device-resident batches; each partition is a list
    of batches. The plan's device is ``device``, or with ``device=None``
    the batches' own; a scan with no batches and ``device=None`` is on the
    CUDA card."""

    def __init__(self, conf: RapidsConf,
                 partitions: Sequence[Sequence[ColumnarBatch]],
                 schema: StructType, device=None):
        super().__init__(conf)
        self._partitions = [list(p) for p in partitions]
        self._schema = schema
        if device is None:
            device = next((c.validity.device for p in self._partitions
                           for b in p for c in b.columns), None)
        self._device = resolve_device(device)

    @property
    def device(self):
        return self._device

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return len(self._partitions)

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        for b in self._partitions[index]:
            yield self.record_batch(b)

    @staticmethod
    def from_pydict(conf: RapidsConf, data, schema: StructType,
                    device=None) -> "InMemoryScanExec":
        """One partition of one uploaded batch; ``device=None`` is the
        CUDA card."""
        batch = ColumnarBatch.from_pydict(data, schema, device=device)
        return InMemoryScanExec(conf, [[batch]], schema, device)


class TpuProjectExec(TpuExec):
    """reference ``exec/basic.py:196`` (GpuProjectExec). Fusable, unless
    it holds partition-context expressions (rand,
    monotonically_increasing_id, spark_partition_id, input_file_name, and
    hash() over strings, which needs a host-synced byte bound): those
    evaluate at the exec boundary as appended input columns, as Spark
    pins nondeterministic expressions in their own Project, and such a
    project does not fuse."""

    def __init__(self, conf: RapidsConf, exprs: Sequence[E.Expression],
                 child: TpuExec):
        super().__init__(conf, [child])
        self.exprs = list(exprs)
        self._schema = _output_schema_for(self.exprs, child.output_schema)
        self._bound = tuple(E.bind_references(e, child.output_schema)
                            for e in self.exprs)
        self._ctx_exprs = self._collect_ctx_exprs()

    def _collect_ctx_exprs(self) -> tuple:
        """Distinct context subexpressions in first-appearance order.
        Equal nodes share one column, so two rand(5) calls draw the same
        sequence (Spark's one seeded generator)."""
        out: list = []

        def walk(e):
            if isinstance(e, E.NONDETERMINISTIC_CONTEXT_EXPRS) or (
                    isinstance(e, E.Murmur3Hash)
                    and any(T.is_string(c.dtype) for c in e.exprs)):
                if e not in out:
                    out.append(e)
                return
            for c in e.children:
                walk(c)

        for b in self._bound:
            walk(b)
        return tuple(out)

    @property
    def fusable(self):  # type: ignore[override]
        return not self._ctx_exprs

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        return f"TpuProjectExec [{', '.join(map(str, self.exprs))}]"

    def lower_batch(self, cols, live, cap, side=()):
        return [lower(e, cols, cap, live.device) for e in self._bound], live

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        if self._ctx_exprs:
            yield from self._execute_with_context(index)
        else:
            yield from run_fused_chain(self, index)

    # -- partition-context evaluation ------------------------------------------
    def _source_file(self, index: int) -> str:
        """The file of input_file_name: single-child row-preserving execs
        are walked down to a file scan (partition indices pass through
        1:1); any other source gives "" (Spark's value)."""
        node: TpuExec = self.children[0]
        while True:
            scanner = getattr(node, "scanner", None)
            if scanner is not None and hasattr(scanner, "splits"):
                splits = scanner.splits()
                return splits[index].path if index < len(splits) else ""
            kids = node.children
            if len(kids) != 1 or not getattr(node, "fusable", False):
                return ""
            node = kids[0]

    def _ctx_columns(self, batch: ColumnarBatch, index: int, row_base,
                     fpath: str) -> List[DeviceColumn]:
        """One column per context expression (reference
        ``exec/basic.py:271``). ``row_base``: the partition's rows before
        this batch (a host int or a 0-d device tensor)."""
        from ..expr.nondet import rand_double_torch
        from ..expr.values import DictV, StrV, as_plain_str
        from ..ops import hashing
        from ..ops.sort import max_string_len
        from .base import host_ints
        from .scan import constant_string_column

        cap = batch.capacity
        n = batch.num_rows_lazy
        dev = self.device
        ones = torch.ones(cap, dtype=torch.bool, device=dev)
        idx = torch.arange(cap, dtype=torch.int64, device=dev)
        base = (row_base.to(torch.int64) if isinstance(row_base, torch.Tensor)
                else row_base)
        cols = []
        for e in self._ctx_exprs:
            if isinstance(e, E.SparkPartitionID):
                c = DeviceColumn(T.INT, n, torch.full(
                    (cap,), index, dtype=torch.int32, device=dev), ones)
            elif isinstance(e, E.MonotonicallyIncreasingID):
                c = DeviceColumn(T.LONG, n, (index << 33) + base + idx, ones)
            elif isinstance(e, E.Rand):
                c = DeviceColumn(T.DOUBLE, n, rand_double_torch(
                    e.seed, index, base + idx), ones)
            elif isinstance(e, E.InputFileName):
                c = constant_string_column(
                    fpath, n if isinstance(n, int) else cap, cap, dev)
            else:  # Murmur3Hash with string children
                vals = [lower(x, vals_of_batch(batch), cap, dev)
                        for x in e.exprs]
                vals = [as_plain_str(v) if isinstance(v, DictV) else v
                        for v in vals]
                smls = [max(4, m) for m in host_ints(
                    [max_string_len(v) for v in vals
                     if isinstance(v, StrV)])]
                c = DeviceColumn(T.INT, n, hashing.murmur3(
                    vals, [x.dtype for x in e.exprs], e.seed, smls), ones)
            cols.append(c)
        return cols

    def _execute_with_context(self, index: int) -> Iterator[ColumnarBatch]:
        child = self.children[0]
        nbase = len(child.output_schema.fields)
        subst = {e: i for i, e in enumerate(self._ctx_exprs)}

        def rewrite(node):
            i = subst.get(node)
            if i is not None:
                return E.BoundReference(nbase + i, node.dtype, node.nullable)
            return node

        rewritten = tuple(b.transform(rewrite) for b in self._bound)
        fpath = self._source_file(index)
        row_base = 0
        for batch in child.execute_partition(index):
            with self.op_timed("ctx"):
                cap = batch.capacity
                extra = self._ctx_columns(batch, index, row_base, fpath)
                cols = vals_of_batch(batch) + [val_of_column(c)
                                               for c in extra]
                nr = batch.num_rows_lazy
                out = batch_from_vals(
                    [lower(e, cols, cap, self.device) for e in rewritten],
                    self._schema, nr, capacity=cap)
            yield self.record_batch(out)
            row_base = row_base + (nr.to(torch.int64)
                                   if isinstance(nr, torch.Tensor) else nr)


class TpuFilterExec(TpuExec):
    fusable = True
    sparsifies = True

    def __init__(self, conf: RapidsConf, condition: E.Expression,
                 child: TpuExec):
        super().__init__(conf, [child])
        self.condition = condition
        self._bound = E.bind_references(condition, child.output_schema)

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def describe(self):
        return f"TpuFilterExec [{self.condition}]"

    def lower_batch(self, cols, live, cap, side=()):
        c = lower(self._bound, cols, cap, live.device)
        return cols, live & c.data & c.validity

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        yield from run_fused_chain(self, index)


class TpuRangeExec(TpuExec):
    """reference: ``exec/basic.py:418`` (GpuRangeExec). A leaf: its
    batches are made on ``device`` (``None``: the CUDA card)."""

    def __init__(self, conf: RapidsConf, start: int, end: int, step: int = 1,
                 num_slices: int = 1, name: str = "id", device=None):
        super().__init__(conf)
        if step == 0:
            raise ValueError("step must not be 0")
        self.start, self.end, self.step = start, end, step
        self.num_slices = num_slices
        self._schema = StructType((StructField(name, T.LONG, False),))
        self._device = resolve_device(device)

    @property
    def device(self):
        return self._device

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return self.num_slices

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        total = max(0, -(-(self.end - self.start) // self.step))
        per = (total + self.num_slices - 1) // self.num_slices if total else 0
        lo = index * per
        hi = min(total, (index + 1) * per)
        max_rows = self.conf.get(MAX_READER_BATCH_SIZE_ROWS)
        pos = lo
        while pos < hi:
            n = min(max_rows, hi - pos)
            cap = choose_capacity(n, self.conf.shape_bucket_min)
            base = self.start + pos * self.step
            iota = torch.arange(cap, dtype=torch.int64, device=self._device)
            live = iota < n
            data = torch.where(live, iota * self.step + base, 0)
            col = DeviceColumn(T.LONG, n, data, live)
            yield self.record_batch(ColumnarBatch([col], self._schema, n))
            pos += n


class TpuUnionExec(TpuExec):
    """reference: ``exec/basic.py:457`` (GpuUnionExec): the children's
    partitions, one after another."""

    def __init__(self, conf: RapidsConf, children: Sequence[TpuExec]):
        super().__init__(conf, children)
        self._schema = children[0].output_schema

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return sum(c.num_partitions for c in self.children)

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        for c in self.children:
            if index < c.num_partitions:
                for b in c.execute_partition(index):
                    yield self.record_batch(b)
                return
            index -= c.num_partitions
        raise IndexError(index)


def _take_rows(exec_: TpuExec, batches: Iterator[ColumnarBatch],
               limit: int) -> Iterator[ColumnarBatch]:
    """The first ``limit`` rows of ``batches``: whole batches while they
    fit, then the last one cut at the same capacity. Stops pulling once
    the limit is reached (no further child batch is computed)."""
    remaining = limit
    for batch in batches:
        if remaining <= 0:
            return
        n = batch.num_rows
        if n <= remaining:
            remaining -= n
            yield exec_.record_batch(batch)
        else:
            cols = filter_gather.truncate_cols(vals_of_batch(batch),
                                               remaining)
            yield exec_.record_batch(batch_from_vals(
                cols, exec_.output_schema, remaining,
                capacity=batch.capacity))
            remaining = 0
        if remaining == 0:
            return


class TpuLocalLimitExec(TpuExec):
    """reference: ``exec/basic.py:482`` (GpuBaseLimitExec): a limit per
    partition."""

    def __init__(self, conf: RapidsConf, limit: int, child: TpuExec):
        super().__init__(conf, [child])
        self.limit = limit

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        yield from _take_rows(self, self.children[0].execute_partition(index),
                              self.limit)


class TpuCollectLimitExec(TpuExec):
    """reference: ``exec/basic.py:514`` (GpuCollectLimitMeta): one output
    partition, the first ``limit`` rows of the child's partitions in
    order."""

    def __init__(self, conf: RapidsConf, limit: int, child: TpuExec):
        super().__init__(conf, [child])
        self.limit = limit

    @property
    def output_schema(self):
        return self.children[0].output_schema

    @property
    def num_partitions(self):
        return 1

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        yield from _take_rows(self, self.children[0].execute_columnar(),
                              self.limit)


class TpuExpandExec(TpuExec):
    """reference: ``exec/basic.py:555`` (GpuExpandExec): each input batch
    projected once per projection (rollup/cube lowering, and the
    ``explode`` of a fixed list through ``CpuGenerateExec``)."""

    def __init__(self, conf: RapidsConf,
                 projections: Sequence[Sequence[E.Expression]],
                 output_names: Sequence[str], child: TpuExec):
        super().__init__(conf, [child])
        self.projections = [list(p) for p in projections]
        child_schema = child.output_schema
        self._bound = [
            tuple(E.bind_references(e, child_schema) for e in p)
            for p in self.projections
        ]
        self._schema = StructType(tuple(
            StructField(n, e.dtype, True)
            for n, e in zip(output_names, self._bound[0])))

    @property
    def output_schema(self):
        return self._schema

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        for batch in self.children[0].execute_partition(index):
            cap = batch.capacity
            cols = vals_of_batch(batch)
            dev = batch.columns[0].validity.device if batch.columns \
                else self.device
            for bound in self._bound:
                with self.op_timed():
                    vals = [lower(e, cols, cap, dev) for e in bound]
                    out = batch_from_vals(vals, self._schema,
                                          batch.num_rows_lazy, capacity=cap)
                yield self.record_batch(out)


class TpuCoalesceBatchesExec(TpuExec):
    """reference: ``exec/basic.py:595`` (GpuCoalesceBatches): concatenate
    small batches up to a target row count; string columns splice their
    byte pools at synced byte counts."""

    def __init__(self, conf: RapidsConf, child: TpuExec,
                 target_rows: Optional[int] = None):
        super().__init__(conf, [child])
        self.target_rows = target_rows or conf.get(MAX_READER_BATCH_SIZE_ROWS)

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def _flush(self, pending: List[ColumnarBatch]) -> Optional[ColumnarBatch]:
        return concat_batches(self.output_schema, pending)

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        pending: List[ColumnarBatch] = []
        rows = 0
        for batch in self.children[0].execute_partition(index):
            if batch.num_rows == 0:
                continue
            pending.append(batch)
            rows += batch.num_rows
            if rows >= self.target_rows:
                with self.op_timed():
                    out = self._flush(pending)
                pending, rows = [], 0
                if out is not None:
                    yield self.record_batch(out)
        with self.op_timed():
            out = self._flush(pending)
        if out is not None:
            yield self.record_batch(out)
