"""Sort exec.

Counterpart of ``spark_rapids_tpu/exec/sort.py`` (``TpuSortExec``): a
global sort concatenates every partition of its child into one batch;
a local sort (``global_sort=False``, the planner's route over a range
or single exchange, whose partitions are already in key order)
concatenates the batches of its own partition only. Then one sort
permutation (``ops/sort.py``) and one gather of every column, string payloads
through the two-pass string gather, under the OOM retry harness
(``memory/retry.py``): split halves sort alone and their concatenation
sorts again. A string key's byte bound is measured on the key (one host
sync for all of them).
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

from ..columnar import ColumnarBatch
from ..conf import RapidsConf
from ..expr import expressions as E
from ..expr.eval import lower
from ..memory.retry import with_oom_retry
from ..ops import filter_gather
from ..ops.sort import SortOrder, sort_permutation, str_max_lens
from ..types import StructType
from .base import (TpuExec, batch_from_vals, concat_all, concat_batches,
                   materialized_batch, site_call, vals_of_batch)


class TpuSortExec(TpuExec):
    def __init__(self, conf: RapidsConf, sort_exprs: Sequence[E.Expression],
                 orders: Sequence[Tuple[bool, object]],
                 child: TpuExec, global_sort: bool = True):
        super().__init__(conf, [child])
        self.sort_exprs = list(sort_exprs)
        self.orders = [SortOrder(a, nf) for a, nf in orders]
        self.global_sort = global_sort
        self._bound = [E.bind_references(e, child.output_schema)
                       for e in self.sort_exprs]

    @property
    def output_schema(self) -> StructType:
        return self.children[0].output_schema

    @property
    def num_partitions(self) -> int:
        return 1 if self.global_sort else self.children[0].num_partitions

    def describe(self):
        ks = ", ".join(f"{e}{'' if o.ascending else ' DESC'}"
                       for e, o in zip(self.sort_exprs, self.orders))
        return f"TpuSortExec [{ks}]" + ("" if self.global_sort
                                        else " (local)")

    def _sort_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        cap = batch.capacity
        cols = vals_of_batch(batch)
        dev = cols[0].validity.device
        nr = batch.num_rows_lazy
        keys = [lower(b, cols, cap, dev) for b in self._bound]
        perm = sort_permutation(keys, [b.dtype for b in self._bound],
                                self.orders, nr, str_max_lens(keys))
        live_sorted = filter_gather.live_of(nr, cap, dev)[perm]
        vals = filter_gather.gather(cols, perm, live_sorted)
        return batch_from_vals(vals, self.output_schema, nr)

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        child = self.children[0]
        if self.global_sort:
            batch = concat_all(child)
        else:
            batch = concat_batches(child.output_schema, [
                b for b in child.execute_partition(index) if b.num_rows > 0])
        if batch is None:
            return
        batch = materialized_batch(batch)  # chunk keys want plain bytes

        def combine(pieces):
            # the halves are each sorted but their stitch is not: the
            # concatenation sorts again (stable, so equal keys keep their
            # piece order; reference exec/sort.py:136)
            return self._sort_batch(concat_batches(
                self.output_schema, pieces, self.conf.shape_bucket_min))

        with self.op_timed():
            out = with_oom_retry(
                self.node_name,
                lambda b: site_call(self, "sort", b,
                                    lambda: self._sort_batch(b)),
                batch, self.conf, combine=combine)
        yield self.record_batch(out)
