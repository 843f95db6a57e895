"""Mesh stages: whole exchange-bounded plan fragments run shard by shard
over the device mesh, fed by a sharded scan.

Counterpart of ``spark_rapids_tpu/exec/mesh.py``. The reference lowers
the stage (partial aggregate -> all_to_all -> final merge -> result
projection; local sort -> sampled range exchange -> merge sort; hash
exchange of both sides -> local join; hash exchange on the partition
keys -> window) into ONE jitted SPMD program over its mesh, child
partition i on mesh shard i % n. The port runs the same steps as an eager
loop over the shards of a single-process mesh of torch devices
(``parallel/mesh.py``), with the collectives of ``parallel/collective.py``
between them; ``parallel/distributed.py`` holds the per-operator steps.
There is no program to compile, so the reference's program cache
(``_cached_program``, its keys, ``_note_program_miss``) and its
compile-count forecast (``mesh_program_bound``) have no counterpart.

Fixed-width columns cross the mesh as data/validity planes; STRING
columns as offsets/bytes/validity, the bytes riding the collective's
byte plane. Staging computes a static byte bound per string column, so
string GROUP KEYS must be direct column references (the planner gates).

Whole-plan staging: a fixed-width filter/project chain between the stage
and its source is ABSORBED and runs per shard through the execs' own
``lower_batch`` hooks (the single-device fused chain's seam), and a
source with ``stage_mesh_planes`` (the sharded scans of
``exec/scan.py``) places its items straight on the shards instead of
the generic staging, which runs the child on the plan's device and
gathers its batches onto the shards (``_stage_host``). The post-PARTIAL
aggregate exchange is sliced to the group cardinality
(``shuffle.mesh.aggExchangeCapacity`` + overflow retry) and the sort,
window and join exchange granules to ~2x the fair share
(``shuffle.mesh.exchangeBucketFactor``), so the exchange surface scales
with what actually crosses.

Tier choice: each shard's aggregate resolves its strategy as the
single-device ``TpuHashAggregateExec`` does on the same device and conf
(PALLAS on the card under AUTO, which puts K1-K3 on the mesh path, or
SCATTER with exact float sums), and the join's probe takes the join
chooser's tier for the post-exchange build capacity
(``exec/join.choose_join_strategy``); the reference's shard bodies take
their backend default (``parallel/distributed.py``).

Host syncs of a stage: the staging's one read of the child's row and
byte counts (the host path; a sharded scan knows its rows from
metadata), the tiers' own decisions inside the per-shard ops, one read
of the ``ok`` flag per attempt where a capacity can overflow, and one
read of every shard's output count at the end (``_emit``). Outputs land
on the plan's device, one partition per shard.
"""
from __future__ import annotations

import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import events as _events
from .. import obs as _obs
from .. import types as T
from ..columnar import ColumnarBatch
from ..columnar.column import choose_capacity
from ..conf import (IMPROVED_FLOAT_OPS, MESH_AGG_EXCHANGE_CAP,
                    MESH_EXCHANGE_BUCKET_FACTOR, MESH_WHOLE_PLAN,
                    SHUFFLE_MODE, RapidsConf)
from ..expr import aggregates as A
from ..expr import expressions as E
from ..expr.eval import lower
from ..expr.values import ColV, StrV, Val
from ..memory.retry import named_oom
from ..ops import concat as concat_ops
from ..ops import filter_gather
from ..ops import hashing
from ..ops.sort import SortOrder, max_string_len
from ..parallel import distributed as D
from ..parallel.collective import all_to_all_exchange
from ..parallel.mesh import device_count, get_mesh
from ..types import StructField, StructType
from . import aggregate as XA
from ..plugin.donation import claim
from .base import (TpuExec, batch_from_vals, host_ints, materialized_batch,
                   site_call, vals_of_batch)
from .join import _null_col, choose_join_strategy

#: the join's output-capacity retry limit (each attempt doubles it)
JOIN_RETRY_LIMIT = 8


def _vals_to(vals: Sequence[Val], device) -> List[Val]:
    """Columns moved to ``device`` (no copy where they already are)."""
    out: List[Val] = []
    for v in vals:
        if isinstance(v, StrV):
            out.append(StrV(v.offsets.to(device), v.chars.to(device),
                            v.validity.to(device)))
        else:
            out.append(ColV(v.data.to(device), v.validity.to(device)))
    return out


class StagedChild:
    """What a mesh stage consumes: per shard its columns on its device,
    the per-shard row counts, the common capacity and layout, the
    absorbed chain steps, and the staging telemetry."""

    __slots__ = ("cols", "counts", "cap", "layout", "smls", "steps",
                 "staged_bytes", "source")

    def __init__(self, cols, counts, cap, layout, smls, steps=(),
                 staged_bytes=(), source="host"):
        self.cols = cols
        self.counts = counts
        self.cap = cap
        self.layout = layout
        self.smls = smls
        self.steps = tuple(steps)
        self.staged_bytes = tuple(staged_bytes)
        self.source = source


class _MeshStage(TpuExec):
    """Base: stage child partitions onto the mesh, run the per-shard
    steps with the collectives between them, emit one output partition
    per shard."""

    def __init__(self, conf: RapidsConf, children: Sequence[TpuExec]):
        super().__init__(conf, children)
        self.mesh = get_mesh(conf=conf, device=children[0].device)
        self.n_shards = self.mesh.size
        self._outputs: Optional[List[Optional[ColumnarBatch]]] = None
        #: staging/execution actuals per materialized child ("cap",
        #: "per_shard_rows", "staged_bytes", "source") + "per_chip_ns"
        #: and "exchange_cap" run-wide
        self.mesh_actuals: dict = {}

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return self.mesh.devices

    @property
    def num_partitions(self) -> int:
        return self.n_shards

    def reset_for_rerun(self) -> None:
        """Drop materialized outputs so the stage re-stages and re-runs."""
        self._outputs = None

    # -- whole-plan absorption --------------------------------------------
    def _absorb_chain(self, child: TpuExec):
        """Peel fixed-width filter/project execs off ``child`` so they run
        per shard (their own ``lower_batch`` hooks, the single-device
        fused chain's seam). Conservative: every schema the chain touches
        must be fixed-width and each exec fusable. Returns (base child,
        steps bottom-up)."""
        from .basic import TpuFilterExec, TpuProjectExec

        if not self.conf.get(MESH_WHOLE_PLAN):
            return child, ()
        steps: List[TpuExec] = []
        node = child
        while isinstance(node, (TpuFilterExec, TpuProjectExec)):
            if not getattr(node, "fusable", False):
                break
            below = node.children[0].output_schema
            if not all(T.is_fixed_width(f.dataType)
                       for f in node.output_schema.fields):
                break
            if not all(T.is_fixed_width(f.dataType) for f in below.fields):
                break
            steps.append(node)
            node = node.children[0]
        steps.reverse()
        return node, tuple(steps)

    @staticmethod
    def _apply_steps(steps, cols, live, cap):
        """Run absorbed chain steps on one shard: filters sparsify the
        live mask, projects rewrite the columns."""
        for st in steps:
            cols, live = st.lower_batch(cols, live, cap)
        return cols, live

    # -- staging -----------------------------------------------------------
    def _on_shard_staged(self, s: int, rows: int, nbytes: int,
                         secs: float, direction: str = "h2d") -> None:
        """Per-shard staging telemetry: the transfer event gains a shard
        lane (Perfetto shows one track per chip) and the live plane
        counts rows per device."""
        if _events.enabled():
            _events.emit("transfer", direction=direction, bytes=nbytes,
                         site="mesh_stage", shard=s)
        if _obs.enabled():
            _obs.inc("tpu_mesh_staged_rows", rows, device=str(s))
            _obs.inc("tpu_transfer_bytes", nbytes, direction=direction)

    def _stage_child(self, child: TpuExec) -> StagedChild:
        """Stage ``child`` onto the mesh: absorb the fixed-width chain,
        then either the child's own sharded-scan path or the generic
        staging."""
        base, steps = self._absorb_chain(child)
        fast = getattr(base, "stage_mesh_planes", None)
        if fast is not None:
            staged = fast(self.mesh, self.n_shards, self.conf,
                          on_shard=self._on_shard_staged)
            if staged is not None:
                return StagedChild(
                    list(staged.cols), staged.counts, staged.cap,
                    staged.layout, staged.smls, steps,
                    staged.staged_bytes, source="sharded_scan")
        cols, counts, cap, layout, smls, staged_bytes = \
            self._stage_host(base)
        return StagedChild(cols, counts, cap, layout, smls, steps,
                           staged_bytes, source="host")

    def _stage_host(self, child: TpuExec):
        """Materialize every child partition on the plan's device and lay
        its rows onto the mesh: child partition p goes to shard p % n.
        Returns (per-shard columns, per-shard counts, common cap, layout,
        str_max_lens, per-shard staged bytes).

        The reference pulls the batches to the host and re-uploads global
        planes; the port's batches are already on a device, so each shard
        concatenates its batches on its own device (a copy only where the
        shard's device differs). One host sync reads every batch's row
        count, string byte count and longest string. layout[i] is ("f",)
        for a fixed column or ("s", char_cap) for a string column;
        str_max_lens[i] is 0 for a fixed column and the bucketed max byte
        length for a string column (the static bound the sort and hash
        steps need)."""
        schema = child.output_schema
        n = self.n_shards
        per_shard: List[List[ColumnarBatch]] = [[] for _ in range(n)]
        for p in range(child.num_partitions):
            for b in child.execute_partition(p):
                # retained until the stage ran: no site may release it
                per_shard[p % n].append(materialized_batch(claim(b)))
        str_cols = [j for j, f in enumerate(schema.fields)
                    if T.is_string(f.dataType)]
        heads = []
        for bs in per_shard:
            for b in bs:
                nr = b.num_rows_lazy
                heads.append(nr)
                for j in str_cols:
                    c = b.columns[j]
                    cap_b = c.offsets.shape[0] - 1
                    at = (min(nr, cap_b) if isinstance(nr, int)
                          else nr.long().clamp(0, cap_b))
                    heads.append(c.offsets[at])
                    heads.append(max_string_len(StrV(
                        c.offsets, c.chars, c.validity)))
        pulled = iter(host_ints(heads))
        rows: List[List[int]] = [[] for _ in range(n)]
        nbytes: List[List[List[int]]] = [[] for _ in range(n)]
        max_len = [1] * len(str_cols)
        for s, bs in enumerate(per_shard):
            for _ in bs:
                rows[s].append(next(pulled))
                bl = []
                for k in range(len(str_cols)):
                    bl.append(next(pulled))
                    max_len[k] = max(max_len[k], next(pulled))
                nbytes[s].append(bl)
        rows_per_shard = [sum(r) for r in rows]
        counts = np.asarray(rows_per_shard, np.int32)
        cap = choose_capacity(max(max(rows_per_shard), 1),
                              self.conf.shape_bucket_min)
        ccaps = [choose_capacity(max(1, max(
            sum(bl[k] for bl in nbytes[s]) for s in range(n))), 128)
            for k in range(len(str_cols))]
        layout: List[tuple] = []
        smls: List[int] = []
        si = 0
        for f in schema.fields:
            if T.is_string(f.dataType):
                layout.append(("s", ccaps[si]))
                smls.append(max(4, choose_capacity(max_len[si], 4)))
                si += 1
            else:
                layout.append(("f",))
                smls.append(0)
        out: List[List[Val]] = []
        staged_bytes = []
        for s, dev in enumerate(self.devices):
            with named_oom(f"mesh_stage[shard {s}]"):
                if per_shard[s]:
                    cols, _ = concat_ops.concat_batches_cols(
                        [_vals_to(vals_of_batch(b), dev)
                         for b in per_shard[s]], rows[s], nbytes[s], cap,
                        ccaps)
                else:  # no partition on this shard: all-null planes
                    cols = [_null_col(f.dataType, cap, dev)
                            for f in schema.fields]
            out.append(cols)
            nb = sum((c.offsets.numel() * 4 + c.chars.numel()
                      + c.validity.numel()) if isinstance(c, StrV)
                     else c.data.numel() * c.data.element_size()
                     + c.validity.numel() for c in cols)
            staged_bytes.append(nb)
            # per-chip staging lane (a skewed shard shows up at once)
            self._on_shard_staged(s, rows_per_shard[s], nb, 0.0,
                                  direction="d2d")
        return (out, counts, cap, tuple(layout), tuple(smls),
                tuple(staged_bytes))

    def _lives(self, staged: StagedChild) -> List[torch.Tensor]:
        """Each shard's (cap,) live mask (its rows are a prefix)."""
        return [torch.arange(staged.cap, dtype=torch.int32, device=dev)
                < int(staged.counts[s])
                for s, dev in enumerate(self.devices)]

    def _staged_inputs(self, staged: StagedChild):
        """Per shard (columns, live mask) after the absorbed steps."""
        out = []
        for cols, live in zip(staged.cols, self._lives(staged)):
            out.append(self._apply_steps(staged.steps, list(cols), live,
                                         staged.cap))
        return out

    def _emit(self, schema: StructType, shard_vals: Sequence[Sequence[Val]],
              shard_counts: Sequence) -> List[Optional[ColumnarBatch]]:
        """Per-shard outputs as one batch each on the plan's device; one
        host sync reads every shard's output count."""
        counts = host_ints(list(shard_counts))
        outs: List[Optional[ColumnarBatch]] = []
        for vals, n in zip(shard_vals, counts):
            outs.append(batch_from_vals(_vals_to(vals, self.device), schema,
                                        n))
        return outs

    def forecast_mesh_staging(self, child: TpuExec) -> Optional[dict]:
        """The per-shard forecast for staging ``child``: cap, per-shard
        rows and staged bytes, from the SAME helpers the staging paths
        use (``io/mesh_stage``) over the same chain absorption and
        item->shard placement. None when the source's row counts are not
        statically known."""
        from ..io import mesh_stage as MS

        base, steps = self._absorb_chain(child)
        fn = getattr(base, "mesh_stage_items", None)
        items = fn() if fn is not None else None
        source = "sharded_scan" if items is not None else "host"
        if items is None:
            pr = getattr(base, "partition_rows", None)
            items = pr() if pr is not None else None
            if items is None:
                return None
        assign = MS.round_robin(len(items), self.n_shards)
        per_shard = [sum(items[i] for i in idxs) for idxs in assign]
        cap = MS.mesh_shard_cap(per_shard, self.conf.shape_bucket_min)
        fields = base.output_schema.fields
        fixed = all(T.is_fixed_width(f.dataType) for f in fields)
        return {
            "source": source,
            "n_shards": self.n_shards,
            "cap": cap,
            "per_shard_rows": per_shard,
            "staged_bytes": ([MS.shard_plane_bytes(cap, fields)]
                             * self.n_shards if fixed else None),
            "absorbed_steps": [s.node_name for s in steps],
            "columns": [(f.name, f.dataType.simpleString) for f in fields],
        }

    def _record_staging(self, staged: StagedChild, which: str = "") -> None:
        key = f"staging{('_' + which) if which else ''}"
        self.mesh_actuals[key] = {
            "cap": staged.cap,
            "per_shard_rows": [int(c) for c in staged.counts],
            "staged_bytes": list(staged.staged_bytes),
            "source": staged.source,
        }

    def _record_run(self, start_ns: int) -> None:
        """Per-chip completion lanes: wait for each shard's device in
        shard order and emit one device-lane ``op_span`` per shard (track
        '<op> [chip k]' in Perfetto). Waits are sequential, so each value
        is an UPPER bound on that shard's completion; shards that share a
        card complete together."""
        per_chip: List[int] = []
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            per_chip.append(time.perf_counter_ns() - start_ns)
        self.mesh_actuals["per_chip_ns"] = per_chip
        if _events.enabled():
            for s, dur in enumerate(per_chip):
                _events.emit("op_span", op=self.node_name, section="spmd",
                             start=start_ns, dur=dur, lane="device",
                             shard=s)
        if _obs.enabled():
            for s, dur in enumerate(per_chip):
                _obs.inc("tpu_mesh_shard_seconds", dur / 1e9,
                         device=str(s))

    def _granule(self, cap: int, layout) -> int:
        """The sort/window/join exchange granule: ~factor x the fair
        per-target share, 0 (always fits) when disabled, on one shard or
        with string columns."""
        factor = self.conf.get(MESH_EXCHANGE_BUCKET_FACTOR)
        if factor <= 0 or self.n_shards <= 1 or any(
                lay[0] != "f" for lay in layout):
            return 0
        return min(choose_capacity(max(int(cap * factor / self.n_shards),
                                       1), self.conf.shape_bucket_min),
                   cap)

    mesh_site = "mesh"

    def _materialize(self) -> None:
        raise NotImplementedError

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        if self._outputs is None:
            with self.op_timed():
                site_call(self, self.mesh_site, [], self._materialize,
                          key=lambda: (self.n_shards,))
        b = self._outputs[index]
        if b is not None and b.num_rows > 0:
            yield self.record_batch(b)

    def describe(self):
        return f"{self.node_name}(mesh={self.n_shards})"


class TpuMeshAggregateExec(_MeshStage):
    """partial-agg -> hash all_to_all -> final merge -> result projection
    over the mesh (reference plan: GpuHashAggregateExec(PARTIAL) ->
    GpuShuffleExchangeExec -> GpuHashAggregateExec(FINAL)).

    The buffer layout, the update/merge op split and the tier come from a
    PARTIAL ``TpuHashAggregateExec`` that is never executed."""

    def __init__(self, conf, group_exprs, agg_exprs, child):
        _MeshStage.__init__(self, conf, [child])
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        plan = XA.TpuHashAggregateExec(conf, group_exprs, agg_exprs, child,
                                       mode=A.PARTIAL)
        self._plan = plan
        self._key_fields = plan._key_fields
        self._bound_keys = plan._bound_keys
        self._bound_funcs = plan._bound_funcs
        self._buf_fields = plan._buf_fields
        self._buf_slices = plan._buf_slices
        self._update_exprs = plan._update_exprs
        self._update_ops = plan._update_ops
        self._merge_ops = plan._merge_ops
        fields = list(self._key_fields)
        for ae, f in zip(self.agg_exprs, self._bound_funcs):
            fields.append(StructField(ae.resolved_name(), f.dtype, True))
        self._schema = StructType(tuple(fields))

    def _key_dtypes(self):
        return tuple(f.dataType for f in self._key_fields)

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        keys = ", ".join(str(k) for k in self.group_exprs)
        strat = self._plan._strategy_choice
        strat = f", strategy={strat[0]}" if strat is not None else ""
        return (f"TpuMeshAggregateExec(mesh={self.n_shards}, "
                f"keys=[{keys}]{strat})")

    mesh_site = "mesh_agg"

    def _result_exprs(self) -> List[E.Expression]:
        """The result projection over [keys..., buffers...]."""
        nk = len(self._key_fields)
        exprs: List[E.Expression] = [
            E.BoundReference(i, f.dataType, f.nullable)
            for i, f in enumerate(self._key_fields)]
        for f, (s, e) in zip(self._bound_funcs, self._buf_slices):
            refs = tuple(E.BoundReference(nk + j,
                                          self._buf_fields[j].dataType, True)
                         for j in range(s, e))
            exprs.append(f.evaluate(refs))
        return exprs

    def _materialize(self) -> None:
        child = self.children[0]
        staged = self._stage_child(child)
        self._record_staging(staged)
        cap, layout, smls, steps = (staged.cap, staged.layout, staged.smls,
                                    staged.steps)
        # static byte bound per STRING group key: the referenced source
        # column's staged max (the planner gates string keys to direct
        # refs; absorbed chains are fixed-width, so smls stay aligned)
        key_smls = tuple(
            smls[b.ordinal] for b in self._bound_keys
            if isinstance(b, E.BoundReference) and T.is_string(b.dtype)
            and not steps and b.ordinal < len(smls))
        t0 = time.perf_counter_ns()
        shard_keys, shard_vals, lives = [], [], []
        for (cols, live), dev in zip(self._staged_inputs(staged),
                                     self.devices):
            shard_keys.append([lower(b, cols, cap, dev)
                               for b in self._bound_keys])
            shard_vals.append([
                None if e is None else XA._agg_input(op, lower(e, cols, cap,
                                                               dev))
                for op, e in zip(self._update_ops, self._update_exprs)])
            lives.append(live)
        strategy = self._plan.resolved_strategy(cap, self.devices[0])
        # post-PARTIAL exchange capacity: slice the partial output to the
        # group cardinality before it crosses (overflow retries with the
        # cap doubled; strings cross at full capacity)
        gcap = min(choose_capacity(self.conf.get(MESH_AGG_EXCHANGE_CAP),
                                   self.conf.shape_bucket_min), cap)
        if key_smls or any(lay[0] != "f" for lay in layout):
            gcap = 0
        while True:
            group_cap = 0 if gcap >= cap else gcap
            fkeys, faggs, fns, ok = D.dist_groupby(
                shard_keys, self._key_dtypes(), shard_vals,
                self._update_ops, self._merge_ops, lives, self.devices,
                str_max_lens=key_smls, group_cap=group_cap,
                strategy=strategy,
                approx_float_sum=self.conf.get(IMPROVED_FLOAT_OPS))
            if group_cap == 0 or bool(ok):
                self.mesh_actuals["exchange_cap"] = group_cap or cap
                break
            # a shard had more groups than the exchange cap: double it
            gcap = min(gcap * 2, cap)
        exprs = self._result_exprs()
        outs = []
        for k, a, dev in zip(fkeys, faggs, self.devices):
            allv = list(k) + list(a)
            rcap = allv[0].validity.shape[0]
            outs.append([lower(x, allv, rcap, dev) for x in exprs])
        self._record_run(t0)
        self._outputs = self._emit(self._schema, outs, fns)


class TpuMeshSortExec(_MeshStage):
    """local sort -> sampled range exchange -> merge sort over the mesh
    (reference plan: GpuRangePartitioning exchange + GpuSortExec); output
    partition i globally precedes partition i+1."""

    def __init__(self, conf, sort_ordinals: Sequence[int],
                 orders: Sequence[Tuple[bool, bool]], child: TpuExec):
        _MeshStage.__init__(self, conf, [child])
        self.key_indices = list(sort_ordinals)
        self.orders = [SortOrder(a, nf) for a, nf in orders]
        self._schema = child.output_schema

    @property
    def output_schema(self):
        return self._schema

    mesh_site = "mesh_sort"

    def _materialize(self) -> None:
        child = self.children[0]
        staged = self._stage_child(child)
        self._record_staging(staged)
        cap, smls, steps = staged.cap, staged.smls, staged.steps
        key_ix = list(self.key_indices)
        key_dtypes = [self._schema.fields[i].dataType for i in key_ix]
        key_smls = tuple(
            smls[i] for i in key_ix
            if T.is_string(self._schema.fields[i].dataType) and not steps
            and i < len(smls))
        t0 = time.perf_counter_ns()
        inputs = self._staged_inputs(staged)
        bcap = self._granule(cap, staged.layout)
        while True:
            bucket_cap = 0 if bcap >= cap else bcap
            out, rn, ok = D.dist_sort(
                [c for c, _ in inputs], key_ix, key_dtypes, self.orders,
                [lv for _, lv in inputs], self.devices,
                str_max_lens=key_smls, bucket_cap=bucket_cap)
            if bucket_cap == 0 or bool(ok):
                self.mesh_actuals["exchange_cap"] = bucket_cap or cap
                break
            bcap = min(bcap * 2, cap)
        self._record_run(t0)
        self._outputs = self._emit(self._schema, out, rn)


class TpuMeshWindowExec(_MeshStage):
    """hash exchange on the PARTITION keys -> per-shard window over the
    mesh (reference plan: GpuShuffleExchangeExec(HashPartitioning)
    feeding GpuWindowExec). Window partitions are independent, so placing
    every row of a partition key on one shard keeps the semantics exact;
    the per-shard body is the single-device exec's own
    ``TpuWindowExec.window_fn`` (one sort + O(n) scans). Fixed-width
    columns with direct partition-key references only (the planner
    gates)."""

    def __init__(self, conf, window_exprs, child):
        _MeshStage.__init__(self, conf, [child])
        from .window import TpuWindowExec

        self._plan = TpuWindowExec(conf, window_exprs, child)
        self._schema = self._plan.output_schema
        self._part_ords = [b.ordinal for b in self._plan._part_keys]
        self._part_dtypes = [b.dtype for b in self._plan._part_keys]

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        names = ", ".join(
            we.resolved_name() for we in self._plan.window_exprs)
        return f"TpuMeshWindowExec(mesh={self.n_shards}, [{names}])"

    mesh_site = "mesh_window"

    def _materialize(self) -> None:
        child = self.children[0]
        staged = self._stage_child(child)
        self._record_staging(staged)
        cap = staged.cap
        t0 = time.perf_counter_ns()
        inputs = self._staged_inputs(staged)
        pids = [hashing.partition_ids(hashing.murmur3(
            [cols[i] for i in self._part_ords], self._part_dtypes),
            self.n_shards) for cols, _ in inputs]
        bcap = self._granule(cap, staged.layout)
        while True:
            bucket_cap = 0 if bcap >= cap else bcap
            recvd, rn, ok = all_to_all_exchange(
                [c for c, _ in inputs], pids, [lv for _, lv in inputs],
                self.devices, bucket_cap=bucket_cap)
            if bucket_cap == 0 or bool(ok):
                self.mesh_actuals["exchange_cap"] = bucket_cap or cap
                break
            bcap = min(bcap * 2, cap)
        out = [self._plan.window_fn(cols, cols[0].validity.shape[0], cnt)
               for cols, cnt in zip(recvd, rn)]
        self._record_run(t0)
        self._outputs = self._emit(self._schema, out, rn)


class TpuMeshHashJoinExec(_MeshStage):
    """hash exchange of both sides -> local join over the mesh (reference
    plan: two GpuShuffleExchangeExecs feeding GpuShuffledHashJoinExec).
    Inner equi-joins, no residual condition."""

    def __init__(self, conf, left: TpuExec, right: TpuExec,
                 left_ordinals: Sequence[int], right_ordinals: Sequence[int]):
        _MeshStage.__init__(self, conf, [left, right])
        self.left_ix = list(left_ordinals)
        self.right_ix = list(right_ordinals)
        lf = left.output_schema.fields
        rf = right.output_schema.fields
        self._schema = StructType(tuple(lf) + tuple(rf))
        self._key_dtypes = [lf[i].dataType for i in self.left_ix]
        #: the probe tier of the last run (describe)
        self._probe_strategy: Optional[str] = None

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        strat = (f", probe={self._probe_strategy}"
                 if self._probe_strategy else "")
        return f"TpuMeshHashJoinExec(mesh={self.n_shards}{strat})"

    mesh_site = "mesh_join"

    def _side(self, staged: StagedChild):
        """Per shard (columns, row count): the absorbed steps run, then
        their survivors compact to the front."""
        out = []
        for cols, live in self._staged_inputs(staged):
            if staged.steps:
                cols, cnt = filter_gather.filter_cols(cols, live)
            else:
                cnt = live
            out.append((cols, cnt))
        return out

    def _materialize(self) -> None:
        left, right = self.children
        lstaged = self._stage_child(left)
        rstaged = self._stage_child(right)
        self._record_staging(lstaged, "left")
        self._record_staging(rstaged, "right")
        lcap, rcap = lstaged.cap, rstaged.cap
        lsml, rsml = lstaged.smls, rstaged.smls
        if lstaged.steps or rstaged.steps:
            lsml = tuple(0 for _ in left.output_schema.fields)
            rsml = tuple(0 for _ in right.output_schema.fields)
        n = self.n_shards
        lf = left.output_schema.fields
        out_cap = choose_capacity(max(lcap, rcap) * 2,
                                  self.conf.shape_bucket_min)
        # string keys compare via chunk words: the byte bound must be
        # SHARED by both sides (same word count per key)
        key_smls = tuple(max(lsml[li], rsml[ri])
                         for li, ri in zip(self.left_ix, self.right_ix)
                         if T.is_string(lf[li].dataType))
        # per-shard byte pools for string outputs: the post-exchange pool
        # is n_shards x the staged local pool; fan-out retries double it
        base_ccaps = tuple(
            [lay[1] * n for lay in lstaged.layout if lay[0] == "s"]
            + [lay[1] * n for lay in rstaged.layout if lay[0] == "s"])
        ccap_scale = 1
        l_bcap = self._granule(lcap, lstaged.layout)
        r_bcap = self._granule(rcap, rstaged.layout)
        t0 = time.perf_counter_ns()
        lsides, rsides = self._side(lstaged), self._side(rstaged)
        for _ in range(JOIN_RETRY_LIMIT):
            xcaps = (0 if l_bcap >= lcap else l_bcap,
                     0 if r_bcap >= rcap else r_bcap)
            out_ccaps = tuple(choose_capacity(c * ccap_scale, 128)
                              for c in base_ccaps)
            strategy, _ = choose_join_strategy(
                self.conf, n * (xcaps[1] or rcap), self._key_dtypes,
                "inner", self.devices[0].type)
            self._probe_strategy = strategy
            out, cnt, ok = D.dist_hash_join(
                [c for c, _ in lsides], self.left_ix,
                [c for c, _ in rsides], self.right_ix, self._key_dtypes,
                [r for _, r in lsides], [r for _, r in rsides],
                self.devices, out_cap, key_str_max_lens=key_smls,
                out_char_caps=out_ccaps, exchange_bucket_caps=xcaps,
                probe_strategy=strategy)
            if bool(ok):
                self._record_run(t0)
                self._outputs = self._emit(self._schema, out, cnt)
                return
            # overflow: double the output capacity AND the exchange
            # granules (the flag does not say which surface overflowed)
            out_cap *= 2
            ccap_scale *= 2
            if l_bcap:
                l_bcap = min(l_bcap * 2, lcap)
            if r_bcap:
                r_bcap = min(r_bcap * 2, rcap)
        raise RuntimeError("mesh join output capacity retry limit exceeded")


# ---------------------------------------------------------------------------
# planner eligibility
# ---------------------------------------------------------------------------
def mesh_mode(conf: RapidsConf) -> str:
    return conf.get(SHUFFLE_MODE)


def mesh_available(conf: RapidsConf, device=None) -> bool:
    """``ici`` always, ``host`` never, ``auto`` when more than one device
    is visible to a plan on ``device`` (reference ``exec/mesh.py:1079``)."""
    mode = mesh_mode(conf)
    if mode == "host":
        return False
    if mode == "ici":
        return True
    return device_count(device) > 1


def fixed_width_schema(schema: StructType) -> bool:
    return all(T.is_fixed_width(f.dataType) for f in schema.fields)
