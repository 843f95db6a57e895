"""Hash-aggregate exec.

Counterpart of ``spark_rapids_tpu/exec/aggregate.py``: per-batch partial
aggregation (the fusable child chain — filter, project — runs inside the
update, a filter only clearing liveness bits), a merge of the partials
with each function's merge ops, then the result projection. Modes
(``expr/aggregates.py``): COMPLETE, PARTIAL, FINAL.

String columns enter as grouping keys (the sort path, ``ops/groupby.py``),
as min/max inputs (reduced as ranks), as counts and inside expressions
(``sum(length(s))``). A plain string key's or min/max input's byte bound
is measured per batch (one host sync for all of them); a
dictionary-encoded one's is its ``max_len``, with no sync (reference
``aggregate.py:498-518``). A unique dictionary key groups on its codes
(the hash tiers) and stays encoded in a single partial; partials that
hold strings merge at their synced row and byte counts, dictionary keys
materialized first, since each partial has its own dictionary
(reference ``aggregate.py:293-298``). ``first``/``last`` over strings stay
on the CPU, as the type matrix says.
The per-batch update runs under the OOM retry harness with
split-and-retry (one partial per piece), the merge under the retry-only
harness (``memory/retry.py``). The source's statically non-null columns
enter the update with the liveness mask as their validity, as do the
buffers' non-null key columns in the result projection
(``plugin/plananalysis.entry_nonnull_flags``, reference
``aggregate.py:553-555, 712-718, 1000-1002``).

The fused routes (reference ``aggregate.py:260-315, 723-945, 980-1071``)
share one core, :meth:`TpuHashAggregateExec._fused_agg_trace`, built on
the streaming path's own functions (``_run_batch``,
``_merge_fixed_width``, ``_evaluate``) with one strategy resolved at the
largest capacity: the fused STAGE decodes each parquet row group
(``exec/scan.fused_stage_plans``) and updates it, the fused PLAN buffers a
partition's input batches and updates each; both then concatenate the
partials padded at capacity, merge them and (not PARTIAL) apply the
result projection, all in one Python call. They run as eager torch calls
with the same kernels as the streaming path: there is no compiled
program, so the reference's program cache (``cached_pipeline``, its
compile-miss counts) and its buffer donation (``_donation``,
``mark_exclusive``) have no counterpart, and the port syncs inside them
only where its tiers already do (``PERF.md`` §3). The plan analyzer's
``fusedPlan``/``stageFusion`` report lines are not ported (ROADMAP.md
item 26). The strategy pick emits ``agg_strategy`` and its live twin
(:meth:`TpuHashAggregateExec.resolved_strategy`). The route a partition took
shows in the aggregate's ``sections`` (``stage``, ``plan``, or
``update`` and ``merge``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from .. import events as _events
from .. import obs as _obs
from .. import types as T
from ..columnar import ColumnarBatch, choose_capacity
from ..conf import AGG_STRATEGY, IMPROVED_FLOAT_OPS, RapidsConf
from ..expr import aggregates as A
from ..expr import expressions as E
from ..expr.eval import lower
from ..expr.values import ColV, DictV, StrV, Val
from ..ops import concat as concat_ops
from ..ops import groupby as groupby_ops
from ..ops.filter_gather import elide_validity, live_of
from ..ops.sort import str_max_lens
from ..memory.retry import with_oom_retry, with_oom_retry_nosplit
from ..plugin.plananalysis import entry_nonnull_flags
from ..types import StructField, StructType
from .base import (TpuExec, batch_bytes, batch_from_vals, concat_batches,
                   vals_of_batch)

#: the reference's CPU rule: AUTO picks RADIX at or above this capacity
_RADIX_CPU_MIN_CAP = 1 << 21

def choose_agg_strategy(conf: RapidsConf, cap: int,
                        update_ops: Sequence[str],
                        update_exprs: Sequence[Optional[E.Expression]],
                        key_dtypes: Sequence[T.DataType],
                        device) -> Tuple[str, str]:
    """Pick the grouped-aggregation tier for one plan shape from its
    static layout and the device (reference ``aggregate.py:93``). Returns
    ``(strategy, reason)``. A forced tier (MATMUL, SCATTER, SORT, RADIX,
    PALLAS) is taken as it is. AUTO resolves:

      * CUDA device -> PALLAS (the hand-written bucket kernels, with the
        RADIX segment reduction on their sort fallback) when the plan
        has no exact float sum — the reference's ``radix_ok`` rule
        (``aggregate.py:149``): exact float sums must stay
        order-preserving — else SCATTER. The reference's cost model
        prices a TPU's MXU and HBM; the port has none for the card;
      * CPU -> RADIX at or above 2^21 rows with no exact float sum, as
        the reference, else SCATTER.
    """
    mode = conf.get(AGG_STRATEGY)
    if mode != "AUTO":
        return mode, "forced by spark.rapids.tpu.sql.agg.strategy"
    approx = conf.get(IMPROVED_FLOAT_OPS)
    n_fexact = sum(
        1 for op, e in zip(update_ops, update_exprs)
        if op == "sum" and e is not None and e.dtype.is_floating
        and not approx)
    radix_ok = n_fexact == 0
    if torch.device(device).type == "cpu":
        if cap >= _RADIX_CPU_MIN_CAP and radix_ok:
            return ("RADIX",
                    "AUTO: CPU backend at cap>=2^21 — the scatter "
                    "dialect's while-loop accumulator amplifies "
                    "XLA-charged bytes ~25x past the layout bound "
                    "(BENCH_r09); the tiled radix lowering is sized to "
                    "the bound")
        return ("SCATTER", "AUTO: CPU device below 2^21 rows (or with "
                "exact float sums) — torch scatter ops")
    if radix_ok:
        return ("PALLAS", "AUTO: CUDA device, no exact float sum — the "
                "hand-written bucket kernels K1-K3")
    return ("SCATTER", f"AUTO: CUDA device with {n_fexact} exact float "
            "sum(s) — order-preserving segment sums, torch scatter ops")


def _agg_input(op: str, v: Val) -> Val:
    """A counted string enters as its validity, all a count reads; a
    string min/max input stays a string (it reduces as ranks)."""
    if isinstance(v, (StrV, DictV)) and op not in ("min", "max"):
        return ColV(v.validity, v.validity)
    return v


class TpuHashAggregateExec(TpuExec):
    #: the sync-free merge stacks partials at CAPACITY; above this many
    #: stacked rows the merge concatenates at real row counts instead
    #: (one host sync for all counts)
    _SYNC_FREE_MERGE_MAX_ROWS = 1 << 24
    #: fused-plan guard: above this many stacked capacity rows the padded
    #: merge's dead rows outweigh the saved dispatches, so the per-batch
    #: path (and its merge choice) takes over
    _FUSED_PLAN_MAX_ROWS = 1 << 24
    #: fused-plan guard: past this many buffered batches the streaming
    #: path takes over (the reference's compile blowup; here it bounds
    #: the buffered window)
    _FUSED_PLAN_MAX_BATCHES = 16
    #: fused-plan guard: buffered INPUT batches (which may hold wide
    #: string columns even when the buffer schema is fixed-width) may pin
    #: at most this many bytes of device memory
    _FUSED_PLAN_MAX_BYTES = 2 << 30

    def __init__(self, conf: RapidsConf, group_exprs: Sequence[E.Expression],
                 agg_exprs: Sequence[A.AggregateExpression], child: TpuExec,
                 mode: str = A.COMPLETE):
        super().__init__(conf, [child])
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        self.mode = mode
        child_schema = child.output_schema

        # group key output fields; FINAL binds keys positionally against
        # the partial's [keys..., buffers...] output
        self._key_fields: List[StructField] = []
        self._bound_keys: List[E.Expression] = []
        for i, g in enumerate(self.group_exprs):
            name = (g.name if isinstance(g, (E.UnresolvedAttribute, E.Alias))
                    else f"key{i}")
            if self.mode == A.FINAL:
                cf = child_schema.fields[i]
                b: E.Expression = E.BoundReference(i, cf.dataType,
                                                   cf.nullable)
            else:
                b = E.bind_references(g, child_schema)
            self._key_fields.append(StructField(name, b.dtype, b.nullable))
            self._bound_keys.append(b)

        nk = len(self.group_exprs)
        self._bound_funcs: List[A.AggregateFunction] = []
        bufpos = nk
        for ae in self.agg_exprs:
            f = ae.func
            if f.input is not None:
                if self.mode == A.FINAL:
                    bf = child_schema.fields[bufpos]
                    f = dataclasses.replace(f, child=E.BoundReference(
                        bufpos, A.merge_input_type(f, bf.dataType), True))
                else:
                    f = dataclasses.replace(
                        f, child=E.bind_references(f.child, child_schema))
            self._bound_funcs.append(f)
            bufpos += f.num_buffers

        # per-function buffer layout
        self._buf_fields: List[StructField] = []
        self._update_exprs: List[Optional[E.Expression]] = []
        self._update_ops: List[str] = []
        self._merge_ops: List[str] = []
        self._buf_slices: List[Tuple[int, int]] = []
        pos = 0
        for ai, f in enumerate(self._bound_funcs):
            ops = f.update_ops
            self._buf_slices.append((pos, pos + len(ops)))
            for j, ((op, in_expr), bdt) in enumerate(zip(ops,
                                                         f.buffer_schema)):
                self._buf_fields.append(
                    StructField(f"agg{ai}_buf{j}", bdt, True))
                self._update_exprs.append(
                    None if in_expr is None or self.mode == A.FINAL
                    else E.bind_references(in_expr, child_schema))
                self._update_ops.append(op)
                pos += 1
            self._merge_ops.extend(f.merge_ops)

        for op, e in zip(self._update_ops, self._update_exprs):
            if (e is not None and T.is_string(e.dtype)
                    and op not in ("count", "min", "max")):
                raise NotImplementedError(
                    f"{op} over strings runs on the CPU: the type matrix "
                    "(plugin/typechecks.py, First/Last) keeps it off the "
                    "device, as the reference's")

        if self.mode == A.FINAL:
            # child emits [keys..., buffers...]; merge those buffers
            self._update_ops = list(self._merge_ops)
            self._update_exprs = [
                E.BoundReference(nk + j, child_schema.fields[nk + j].dataType,
                                 True)
                for j in range(len(self._buf_fields))]
            self._bound_keys = [E.BoundReference(i, f.dataType, f.nullable)
                                for i, f in enumerate(child_schema.fields[:nk])]
            self._key_fields = [
                StructField(kf.name, cf.dataType, cf.nullable)
                for kf, cf in zip(self._key_fields, child_schema.fields[:nk])]

        if self.mode == A.PARTIAL:
            self._schema = StructType(tuple(self._key_fields
                                            + self._buf_fields))
        else:
            fields = list(self._key_fields)
            for ae, f in zip(self.agg_exprs, self._bound_funcs):
                fields.append(StructField(ae.resolved_name(), f.dtype, True))
            self._schema = StructType(tuple(fields))
        self._buffer_schema = StructType(tuple(self._key_fields
                                               + self._buf_fields))
        # strategy memoized per capacity bucket, so AUTO never flips
        # mid-plan; the last pick shows in describe()
        self._strategy_by_cap: dict = {}
        self._strategy_choice: Optional[Tuple[str, str]] = None
        # the string key routes the updates and the merge took
        self._update_routes: List[str] = []
        self._merge_routes: List[str] = []

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        keys = ", ".join(str(k) for k in self.group_exprs)
        aggs = ", ".join(a.resolved_name() for a in self.agg_exprs)
        strat = (f", strategy={self._strategy_choice[0]}"
                 if self._strategy_choice is not None else "")
        if strat and any(T.is_string(f.dataType) for f in self._key_fields):
            # the routes the string keys took (before a run: the plain
            # string route)
            upd = self._update_routes or [groupby_ops.STRING_KEY_ROUTE]
            strat += f" (update: {'; '.join(upd)}"
            if self._merge_routes:
                strat += f"; merge: {'; '.join(self._merge_routes)}"
            strat += ")"
        return (f"TpuHashAggregateExec(mode={self.mode}, keys=[{keys}], "
                f"aggs=[{aggs}]{strat})")

    def resolved_strategy(self, cap: int, device) -> Optional[str]:
        """Resolve (and memoize per capacity bucket) the aggregation tier.
        The choice lands in describe() and emits ONE ``agg_strategy``
        event and ``tpu_agg_strategy`` count per (exec, capacity)
        (reference ``aggregate.py:459-483``), so tools/tpu_profile.py can
        hold the chooser to the measured op spans of the same log."""
        if not self.group_exprs:
            return None  # grand aggregates use the plain masked reduces
        hit = self._strategy_by_cap.get(cap)
        if hit is not None:
            return hit
        strategy, reason = choose_agg_strategy(
            self.conf, cap, self._update_ops, self._update_exprs,
            self._key_dtypes(), device)
        self._strategy_by_cap[cap] = strategy
        self._strategy_choice = (strategy, reason)
        if _events.enabled():
            _events.emit("agg_strategy", op=self.node_name,
                         strategy=strategy, reason=reason, cap=cap)
        if _obs.enabled():
            _obs.inc("tpu_agg_strategy", 1, strategy=strategy)
        return strategy

    def _key_dtypes(self) -> Tuple[T.DataType, ...]:
        return tuple(f.dataType for f in self._key_fields)

    def _run_batch(self, batch: ColumnarBatch, ops: Sequence[str],
                   value_exprs: Sequence[Optional[E.Expression]],
                   key_exprs: Sequence[E.Expression], chain=(),
                   live: Optional[torch.Tensor] = None,
                   routes: Optional[List[str]] = None,
                   nonnull: Optional[tuple] = None,
                   strategy: Optional[str] = None) -> ColumnarBatch:
        """Aggregate one batch into a [keys..., buffers...] batch, running
        the fusable ``chain`` below first. ``live`` overrides the batch's
        prefix row count (the sync-free merge's mask); ``routes`` receives
        the string key route; ``nonnull``: the source's elision flags
        (None: the batch schema's, reference ``aggregate.py:552-555``);
        ``strategy``: the fused routes' one tier (None: resolved at this
        batch's capacity). The group count stays a device scalar."""
        cap = batch.capacity
        cols = vals_of_batch(batch)
        dev = cols[0].validity.device if cols else None
        if live is None:
            live = live_of(batch.num_rows_lazy, cap, dev)
        if nonnull is None:
            nonnull = entry_nonnull_flags(batch.schema, self.conf)
        cols = elide_validity(cols, live, nonnull)
        # each chain member's side tensors (a fused join's build table)
        # enter with its lowering, as in the reference (aggregate.py:556)
        for e in chain:
            cols, live = e.lower_batch(cols, live, cap, e.side_vals())
        dev = live.device
        keys = [lower(e, cols, cap, dev) for e in key_exprs]
        vals = [None if e is None else _agg_input(op, lower(e, cols, cap, dev))
                for op, e in zip(ops, value_exprs)]
        # byte bounds of the string keys, then of the string min/max
        # inputs (reference aggregate.py:489-524): one host sync for the
        # plain ones, a DictV's max_len for the dictionary-encoded ones
        strs = (StrV, DictV)
        str_keys = [k for k in keys if isinstance(k, strs)]
        bounds = str_max_lens(str_keys + [v for v in vals
                                          if isinstance(v, strs)])
        sml, svml = bounds[:len(str_keys)], bounds[len(str_keys):]
        if self.group_exprs:
            out_keys, out_aggs, nseg = groupby_ops.groupby_agg(
                keys, self._key_dtypes(), vals, list(ops), live,
                approx_float_sum=self.conf.get(IMPROVED_FLOAT_OPS),
                strategy=strategy or self.resolved_strategy(cap, dev),
                str_max_lens=sml, str_val_max_lens=svml, routes=routes)
        else:
            out_keys, nseg = [], 1
            out_aggs = groupby_ops.reduce_no_keys(vals, list(ops), live, dev,
                                                  svml)
        return batch_from_vals(list(out_keys) + list(out_aggs),
                               self._buffer_schema, nseg)

    def _merge_inputs(self):
        nk = len(self._key_fields)
        keys = [E.BoundReference(i, f.dataType, f.nullable)
                for i, f in enumerate(self._key_fields)]
        vals = [E.BoundReference(nk + j, f.dataType, True)
                for j, f in enumerate(self._buf_fields)]
        return keys, vals

    def _merge_fixed_width(self, partials: List[ColumnarBatch],
                           strategy: Optional[str] = None) -> ColumnarBatch:
        """Sync-free merge: partials stack at capacity on the device with
        a live mask, so row counts never leave the device. ``strategy``:
        as in :meth:`_run_batch`."""
        caps = [max(1, b.capacity) for b in partials]
        out_cap = choose_capacity(sum(caps), self.conf.shape_bucket_min)
        cols, mask, total = concat_ops.concat_padded_cols(
            [vals_of_batch(b) for b in partials],
            [b.num_rows_lazy for b in partials], out_cap)
        merged_in = batch_from_vals(cols, self._buffer_schema, total)
        keys, vals = self._merge_inputs()
        return self._run_batch(merged_in, self._merge_ops, vals, keys,
                               live=mask, strategy=strategy)

    def _merge(self, partials: List[ColumnarBatch]) -> ColumnarBatch:
        """Concat the partials and re-aggregate with the merge ops."""
        if len(partials) == 1:
            return partials[0]
        has_strings = any(T.is_string(f.dataType)
                          for f in self._buffer_schema.fields)
        if (not has_strings and sum(max(1, b.capacity) for b in partials)
                <= self._SYNC_FREE_MERGE_MAX_ROWS):
            return self._merge_fixed_width(partials)
        # one host sync for every partial's row count and string byte
        # counts, then a concat of the live rows only (group-count sized,
        # not capacity sized; reference aggregate.py:640-688)
        merged_in = concat_batches(self._buffer_schema, partials,
                                    self.conf.shape_bucket_min)
        keys, vals = self._merge_inputs()
        return self._run_batch(merged_in, self._merge_ops, vals, keys,
                               routes=self._merge_routes)

    def _eval_exprs(self) -> List[E.Expression]:
        """Result projection over [keys..., buffers...]."""
        exprs: List[E.Expression] = [
            E.BoundReference(i, f.dataType, f.nullable)
            for i, f in enumerate(self._key_fields)]
        nk = len(self._key_fields)
        for f, (s, e) in zip(self._bound_funcs, self._buf_slices):
            refs = tuple(E.BoundReference(nk + j,
                                          self._buf_fields[j].dataType, True)
                         for j in range(s, e))
            exprs.append(f.evaluate(refs))
        return exprs

    def _evaluate(self, buffers: ColumnarBatch) -> ColumnarBatch:
        """Final projection from [keys..., buffers...] to results, the
        buffers' non-null key columns elided."""
        cols = vals_of_batch(buffers)
        dev = cols[0].validity.device
        cap, n = buffers.capacity, buffers.num_rows_lazy
        nonnull = entry_nonnull_flags(buffers.schema, self.conf)
        if nonnull:
            cols = elide_validity(cols, live_of(n, cap, dev), nonnull)
        vals = [lower(e, cols, cap, dev) for e in self._eval_exprs()]
        return batch_from_vals(vals, self._schema, n)

    def _result(self, merged: ColumnarBatch) -> ColumnarBatch:
        """The merged buffers as this mode's output: PARTIAL emits them,
        the other modes their result projection."""
        return merged if self.mode == A.PARTIAL else self._evaluate(merged)

    # -- the fused routes ----------------------------------------------------
    def _fixed_width_buffers(self) -> bool:
        return not any(T.is_string(f.dataType)
                       for f in self._buffer_schema.fields)

    def _can_fuse_stage(self) -> bool:
        """A fused scan->agg stage covers fixed-width keys and buffers
        updating straight from a source; FINAL consumes exchanged
        partials, not a scan (reference ``aggregate.py:723``)."""
        return self.mode != A.FINAL and self._fixed_width_buffers()

    def _stage_fusion_on(self) -> bool:
        """``sql.stageFusion``: AUTO fuses except on the CPU, where the
        separate decode and the device scan cache decode once and reuse
        (reference ``aggregate.py:734``, its CPU backend being the plan's
        CPU device here)."""
        from ..conf import STAGE_FUSION

        mode = self.conf.get(STAGE_FUSION)
        if mode != "AUTO":
            return mode == "ON"
        return torch.device(self.device).type != "cpu"

    def _can_fuse_plan(self) -> bool:
        """The fused plan covers fixed-width keys and buffers (the padded
        concat splices no byte pools), FINAL mode included (reference
        ``aggregate.py:824``)."""
        return self._fixed_width_buffers()

    def _fused_plan_on(self, nbatches: int) -> bool:
        """``sql.agg.fusedPlan``: AUTO declines only multi-batch runs on
        the CPU, where the streaming merge works at real row counts
        (reference ``aggregate.py:834``)."""
        from ..conf import AGG_FUSED_PLAN

        mode = self.conf.get(AGG_FUSED_PLAN)
        if mode != "AUTO":
            return mode == "ON"
        return nbatches == 1 or torch.device(self.device).type != "cpu"

    def _fused_agg_trace(self, chain, cap: int, device):
        """The shared core of BOTH fused routes (reference
        ``aggregate.py:260``): returns ``(update_batch, finish)`` over the
        streaming path's own functions, with one strategy resolved at
        ``cap``, the largest input capacity, for the updates and the merge
        alike: a small first batch must not pick the tier for the big
        ones. ``update_batch(batch, nonnull)`` runs one batch's fused
        chain, key and value projection and update; ``finish(partials)``
        concatenates the partials padded at capacity, merges them and
        gives this mode's output. The two routes differ only in what they
        feed it (decoded row groups or input batches)."""
        strategy = self.resolved_strategy(cap, device)

        def update_batch(batch, nonnull):
            return self._run_batch(batch, self._update_ops,
                                   self._update_exprs, self._bound_keys,
                                   chain, nonnull=nonnull, strategy=strategy)

        def finish(partials):
            merged = (partials[0] if len(partials) == 1
                      else self._merge_fixed_width(partials, strategy))
            return self._result(merged)

        return update_batch, finish

    def _run_fused_stage(self, stage, chain, schema) -> ColumnarBatch:
        """The whole stage in one call (reference ``aggregate.py:748``):
        per row group the page decode, the fused chain and the update,
        then the padded merge and the result projection. A row group's
        decoded columns (``schema``, the source's) are dropped once its
        partial exists. A dictionary-retaining string decode enters the
        chain as a ``DictV``."""
        dev = self.device
        update_batch, finish = self._fused_agg_trace(
            chain, max(cap for (_, cap, _) in stage), dev)
        nonnull = entry_nonnull_flags(schema, self.conf)
        partials = []
        for n, cap, entries in stage:
            cols: List[Val] = []
            for args, run, _ in entries:
                out = run(args, dev)
                if isinstance(out, DictV):
                    cols.append(out)
                else:
                    cols.append(ColV(*out) if len(out) == 2 else StrV(*out))
            partials.append(update_batch(
                batch_from_vals(cols, schema, n, capacity=cap), nonnull))
            del cols
        return finish(partials)

    def _run_fused_plan(self, batches: List[ColumnarBatch], chain,
                        nonnull) -> ColumnarBatch:
        """The whole aggregate over its buffered input batches in one call
        (reference ``aggregate.py:848``): each batch's fused chain and
        update, the padded concat of the partials, the merge and (not
        PARTIAL) the result projection. Group counts stay device
        scalars."""
        update_batch, finish = self._fused_agg_trace(
            chain, max(b.capacity for b in batches), self.device)
        return finish([update_batch(b, nonnull) for b in batches])

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        from .. import faults as _faults
        from ..conf import AGG_FUSED_PLAN, OOM_RETRY_ENABLED
        from ..memory.retry import is_device_oom, note_fallback

        child = self.children[0]
        source, chain = (child.fused_source_chain() if child.fusable
                         else (child, []))
        if chain and any(op in ("min", "max") and e is not None
                         and T.is_string(e.dtype)
                         for op, e in zip(self._update_ops,
                                          self._update_exprs)):
            # a string min/max runs its chain as real execs, as the
            # reference does (aggregate.py:955-970, where a fused chain
            # would bound its rank sort by the source batch's strings)
            source, chain = child, []
        fsp = getattr(source, "fused_stage_plans", None)
        if (fsp is not None and self._can_fuse_stage()
                and self._stage_fusion_on()):
            stage = fsp(index)
            if stage:
                with self.op_timed("stage"):
                    out = self._run_fused_stage(stage, chain,
                                                source.output_schema)
                yield self.record_batch(out)
                return
        partials: List[ColumnarBatch] = []
        # the source's elision flags: one schema walk per partition
        src_nonnull = entry_nonnull_flags(source.output_schema, self.conf)

        def update(piece):
            return self._run_batch(
                piece, self._update_ops, self._update_exprs,
                self._bound_keys, chain, routes=self._update_routes,
                nonnull=src_nonnull)

        def update_with_retry(b):
            # the update under the OOM harness (reference
            # ``aggregate.py:1003``): a split gives one partial per half,
            # which the merge consumes as it consumes any
            partials.extend(with_oom_retry(self.node_name, update, b,
                                           self.conf, combine="list"))

        # fused-plan buffering is incremental (reference
        # aggregate.py:980-986): an ineligible plan never buffers, and an
        # eligible one that outgrows a guard flushes its buffer into
        # streaming updates, so the window stays bounded
        batches: List[ColumnarBatch] = []

        def flush_buffered():
            for b in batches:
                with self.op_timed("update"):
                    update_with_retry(b)
            batches.clear()

        use_fused = (self.conf.get(AGG_FUSED_PLAN) != "OFF"
                     and self._can_fuse_plan())
        cap_sum = byte_sum = 0
        for batch in source.execute_partition(index):
            nr = batch.num_rows_lazy
            if isinstance(nr, int) and nr == 0 and self.group_exprs \
                    and not chain:
                continue
            if not use_fused:
                with self.op_timed("update"):
                    update_with_retry(batch)
                continue
            batches.append(batch)
            cap_sum += max(1, batch.capacity)
            byte_sum += batch_bytes(batch)
            if (cap_sum > self._FUSED_PLAN_MAX_ROWS
                    or byte_sum > self._FUSED_PLAN_MAX_BYTES
                    or len(batches) > self._FUSED_PLAN_MAX_BATCHES
                    or not self._fused_plan_on(len(batches))):
                use_fused = False
                flush_buffered()
        if use_fused and batches:
            out = None
            try:
                with self.op_timed("plan"):
                    if _faults.enabled():
                        # the fused plan is the aggregate's dispatch
                        # boundary when it runs: injected OOMs reach it
                        # (reference aggregate.py:1043-1052)
                        _faults.check("oom", self.node_name,
                                      cap=max(b.capacity for b in batches))
                    out = self._run_fused_plan(batches, chain, src_nonnull)
            except Exception as e:  # noqa: BLE001 - filtered below
                if not is_device_oom(e) \
                        or not self.conf.get(OOM_RETRY_ENABLED):
                    raise  # oomRetry off: the raw failure, fallback included
            if out is not None:
                yield self.record_batch(out)
                return
            # the fused plan exhausted device memory: degrade to the
            # streaming path, whose updates run under the retry harness
            # one by one (after the handler, so the failed attempt's
            # tensors are released)
            note_fallback(self.node_name, "fused_plan_fallback")
            flush_buffered()
        if not partials:
            if self.group_exprs:
                return  # grouped aggregate over empty input -> no rows
            # a grand aggregate over empty input still yields one row
            # (count=0, sum=null), reduced on the plan's device
            cs = self.children[0].output_schema
            zb = ColumnarBatch.from_pydict({f.name: [] for f in cs.fields},
                                           cs, device=self.device)
            with self.op_timed("update"):
                partials = [self._run_batch(zb, self._update_ops,
                                            self._update_exprs,
                                            self._bound_keys)]

        with self.op_timed("merge"):
            # the merge reads compacted partials (group-sized): retried,
            # not split (reference ``aggregate.py:1083``)
            out = with_oom_retry_nosplit(self.node_name + ".merge",
                                         lambda: self._result(
                                             self._merge(partials)),
                                         self.conf)
        yield self.record_batch(out)
