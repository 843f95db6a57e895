"""Window exec.

Counterpart of ``spark_rapids_tpu/exec/window.py`` (``TpuWindowExec``):
one exec per (partition by, order by) spec, computing every window
expression over it. The exec gathers its input into one batch (every
partition of a partitioned child, as the reference's ``_concat_all``,
``exec/window.py:92-114``), sorts it once by (partition keys, order
keys) and derives partition and peer boundaries from the co-sorted radix
keys; each function is then O(n) scan arithmetic (``ops/window.py``). A
string partition or order key sorts by its chunk words, bounded by its
longest row (one host sync for all string keys), and its boundaries come
from the sorted words. The mesh window (``exec/mesh.TpuMeshWindowExec``)
hash-exchanges the rows over the mesh's shards by the partition keys and
runs :meth:`TpuWindowExec.window_fn` on each shard.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import torch

from .. import types as T
from ..columnar import ColumnarBatch
from ..conf import RapidsConf
from ..expr import aggregates as A
from ..expr import expressions as E
from ..expr import windows as W
from ..expr.eval import lower
from ..expr.values import ColV
from ..ops import filter_gather
from ..ops import window as window_ops
from ..ops.sort import SortOrder, sort_with_radix_keys, str_max_lens
from ..types import StructField, StructType
from .base import (TpuExec, batch_from_vals, concat_all, materialized_batch,
                   site_call, vals_of_batch)

_AGG_OPS = {A.Count: "count", A.Sum: "sum", A.Min: "min", A.Max: "max"}


class TpuWindowExec(TpuExec):
    def __init__(self, conf: RapidsConf,
                 window_exprs: Sequence[W.WindowExpression], child: TpuExec):
        super().__init__(conf, [child])
        if not window_exprs:
            raise ValueError("window exec needs at least one window expression")
        self.window_exprs = list(window_exprs)
        spec = window_exprs[0].spec
        for we in window_exprs[1:]:
            if (we.spec.partition_by, we.spec.order_by, we.spec.orders) != (
                    spec.partition_by, spec.order_by, spec.orders):
                raise ValueError(
                    "one TpuWindowExec handles one (partition, order) spec")
        self.spec = spec
        cs = child.output_schema
        self._part_keys = [E.bind_references(k, cs) for k in spec.partition_by]
        self._order_keys = [E.bind_references(k, cs) for k in spec.order_by]
        self._orders = [SortOrder(a, nf) for a, nf in spec.orders] or [
            SortOrder(True, None) for _ in self._order_keys]
        self._bound_funcs: List[E.Expression] = []
        fields = list(cs.fields)
        for we in self.window_exprs:
            f = we.func
            if isinstance(f, (W.Lead, W.Lag, A.AggregateFunction)):
                if getattr(f, "child", None) is not None:
                    f = dataclasses.replace(
                        f, child=E.bind_references(f.child, cs))
            self._bound_funcs.append(f)
            fields.append(StructField(we.resolved_name(), f.dtype, True))
        self._schema = StructType(tuple(fields))

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return 1

    def describe(self):
        names = ", ".join(we.resolved_name() for we in self.window_exprs)
        return f"TpuWindowExec [{names}]"

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        assert index == 0
        batch = concat_all(self.children[0])
        if batch is None:
            return
        # chunk keys want plain bytes, as in the sort
        batch = materialized_batch(batch)
        with self.op_timed():
            vals = site_call(self, "window", batch, lambda: self.window_fn(
                vals_of_batch(batch), batch.capacity, batch.num_rows_lazy))
        yield self.record_batch(
            batch_from_vals(vals, self._schema, batch.num_rows_lazy))

    def window_fn(self, cols, cap: int, num_rows) -> list:
        """One sort by (partition, order) keys plus the scans (reference
        ``exec/window.py:133``): the sorted child columns, then one value
        column per window expression."""
        frame = self.spec.resolved_frame()
        range_frame = frame.frame_type == W.RANGE
        whole = frame.is_whole_partition or not self._order_keys
        bounded = frame.is_bounded_rows and not whole and not frame.is_running
        branged = (frame.is_bounded_range and not whole
                   and bool(self._order_keys))
        blo, bhi = frame.row_bounds() if bounded else (0, 0)
        # DESC RANGE frames negate the key; "preceding" flips with it, so
        # the offsets carry over as they are
        rlo, rhi = frame.range_bounds() if branged else (None, None)

        dev = cols[0].validity.device
        live = filter_gather.live_of(num_rows, cap, dev)
        all_keys = self._part_keys + self._order_keys
        if all_keys:
            keys = [lower(k, cols, cap, dev) for k in all_keys]
            orders = ([SortOrder(True, True)] * len(self._part_keys)
                      + list(self._orders))
            perm, radix = sort_with_radix_keys(
                keys, [k.dtype for k in all_keys], orders, live,
                str_max_lens(keys))
        else:
            # OVER (): the live rows (a prefix) are one partition in their
            # own order; the reference's sort of no keys raises here
            perm, radix = torch.arange(cap, device=dev), []
        live_s = live[perm]
        sorted_cols = filter_gather.gather(cols, perm, live_s)
        npart = len(self._part_keys)
        ps, pe, qs, qe, seg = window_ops.boundaries_from_radix(
            [k for ks in radix[:npart] for k in ks],
            [k for ks in radix[npart:] for k in ks], live_s)

        def ev(e):
            return lower(e, sorted_cols, cap, dev)

        if branged:
            rk = ev(self._order_keys[0])
            if not self._orders[0].ascending:
                rk = ColV(-rk.data, rk.validity)  # ASC-normalize
            nulls_first = self._orders[0].nulls_first_resolved

        def agg(op, v):
            if branged:
                return window_ops.bounded_range_agg(
                    op, v, rk, ps, pe, qs, qe, live_s, rlo, rhi, nulls_first)
            if bounded:
                return window_ops.bounded_row_agg(op, v, ps, pe, live_s,
                                                  blo, bhi)
            return window_ops.running_agg(op, v, seg, ps, qe, live_s,
                                          range_frame, whole, pe)

        out = list(sorted_cols)
        for f in self._bound_funcs:
            if isinstance(f, W.RowNumber):
                out.append(window_ops.row_number(ps, live_s))
            elif isinstance(f, W.Rank):
                out.append(window_ops.rank(ps, qs, live_s))
            elif isinstance(f, W.DenseRank):
                out.append(window_ops.dense_rank(ps, qs, live_s))
            elif isinstance(f, (W.Lead, W.Lag)):
                off = f.offset if isinstance(f, W.Lead) else -f.offset
                dflt = ev(f.default) if f.default is not None else None
                out.append(window_ops.shift_in_partition(
                    ev(f.child), off, ps, pe, live_s, dflt))
            elif isinstance(f, A.Average):
                v = ev(E.Cast(f.child, T.DOUBLE))
                s, c = agg("sum", v), agg("count", v)
                data = s.data / torch.where(c.data == 0, 1, c.data)
                valid = s.validity & (c.data > 0)
                out.append(ColV(torch.where(valid, data, 0.0), valid))
            elif isinstance(f, A.AggregateFunction):
                op = _AGG_OPS[type(f)]
                if isinstance(f, A.Count) and f.input is None:
                    op, v = "count_star", None
                else:
                    e = E.Cast(f.child, f.dtype) if isinstance(f, A.Sum) \
                        else f.child
                    v = ev(e)
                out.append(agg(op, v))
            else:
                raise ValueError(f"unsupported window function {f}")
        return out
