"""The join execs: the equi-join (hash-join family) with its strategy
chooser, and the nested-loop and cartesian joins.

Counterpart of ``spark_rapids_tpu/exec/join.py``. The build side is
concatenated and sorted once by its radix key words (``ops/join.py``);
each probe batch runs a count phase (match ranges per probe row, by the
tier of ``spark.rapids.tpu.sql.join.strategy``) and an expand phase (the
pair list and two gathers). The host syncs are the build's row count,
the fast paths' one feasibility check per build, DIRECT's ``fits`` check
per probe batch, and one match total per probe batch (it sizes the
output), as in the reference; with string columns also the byte bound of
the string keys (the build once, each probe batch once), the byte counts
of a multi-batch build's string columns, and the byte counts of an
expansion's string payloads (one sync per probe batch).

Dictionary-encoded columns (reference ``join.py:214-220``, ``:704-710``,
``:778-783``): the build side materializes; probe keys enter the radix
words as plain strings; probe payloads materialize before the expansion,
which repeats rows, and stay encoded where the probe only drops rows
(semi and anti joins, the fused fast paths).

Right joins run as left joins with the sides swapped and the output
columns put back in order.

With ``partitioned=True`` (both sides co-partitioned by the join keys
through hash exchanges) the build and probe stay per partition: one
build per reduce partition, and a full outer join emits its unmatched
build rows once per partition (reference ``join.py:262-327``). A build
side read through a broadcast exchange is read once and kept.

The sorted build is registered spillable (:class:`_SpillableBuild`,
reference ``join.py:34``) and each probe batch runs under the OOM retry
harness with split-and-retry, each half's output its own batch. The
strategy pick emits ``join_strategy`` and its live twin
(:meth:`TpuShuffledHashJoinExec.resolved_strategy`). Left out: buffer
donation (eager PyTorch donates nothing).

:class:`TpuBroadcastNestedLoopJoinExec` and
:class:`TpuCartesianProductExec` (reference ``join.py:1009``, ``:1110``)
join without keys, inner only: the build side is concatenated once, held
spillable and pinned while a probe batch uses it, and every probe batch
expands to its ``np x nb`` pairs, filtered by the bound condition.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from .. import events as _events
from .. import obs as _obs
from .. import types as T
from ..columnar import ColumnarBatch, choose_capacity
from ..conf import (JOIN_PALLAS_PROBE, JOIN_STRATEGY, RapidsConf,
                    roofline_peak_bps)
from ..expr import expressions as E
from ..expr.eval import lower
from ..expr.values import ColV, StrV, Val, as_plain_str
from ..memory.ledger import op_scope
from ..memory.retry import with_oom_retry
from ..ops import concat as concat_ops
from ..ops import filter_gather
from ..ops import join as join_ops
from ..ops.sort import SortOrder, sort_permutation, str_max_lens
from ..types import StructField, StructType, torch_dtype
from .base import (TpuExec, batch_from_vals, concat_all, concat_batches,
                   host_ints, materialized_batch, run_fused_chain,
                   vals_of_batch)

_JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti", "cross")


class _SpillableBuild:
    """The join's sorted build side as catalog-registered spillable
    buffers (reference ``join.py:34``): the sorted build columns, the
    radix key words and the liveness move device <-> host under pressure
    and come back at probe time. Declared plan state: the build is kept
    with the exec for a re-execution, so the leak sentinel skips it."""

    def __init__(self, cols, words=(), live=None):
        from ..memory import (ACTIVE_BATCHING_PRIORITY, SpillableHandle,
                              SpillableVals)

        self._cols = SpillableVals(cols, ACTIVE_BATCHING_PRIORITY,
                                   ledger_kind="plan_state")
        aux = {f"w{i}": w for i, w in enumerate(words)}
        if live is not None:
            aux["live"] = live
        # a nested-loop build has no key words and no live mask
        self._aux = (SpillableHandle(aux, ACTIVE_BATCHING_PRIORITY,
                                     ledger_kind="plan_state")
                     if aux else None)
        self._nw = len(words)
        self._pins = 0
        self._pin_lock = threading.Lock()

    def _pin(self, delta: int) -> None:
        with self._pin_lock:
            self._pins += delta
            for h in (self._cols.handle, self._aux):
                if h is not None:
                    h.pinned = self._pins > 0

    @contextmanager
    def pinned(self):
        """(cols, words, live) on the device, out of the catalog's reach
        until the block ends. A spill of tensors the probe still holds
        would copy them to the host and free nothing, and the catalog
        would count them off the device while they are on it; so
        neither bringing the other half back nor an OOM's emergency
        spill may take them. Unlike the reference, which leaves them
        spillable."""
        self._pin(1)
        try:
            cols = self._cols.get_vals()
            a = {} if self._aux is None else self._aux.materialize()
            yield (cols, [a[f"w{i}"] for i in range(self._nw)],
                   a.get("live"))
        finally:
            self._pin(-1)

    @property
    def tiers(self) -> tuple:
        return (self._cols.tier,) + (
            () if self._aux is None else (self._aux.tier,))


#: CPU AUTO: below this build capacity the direct-address tables are
#: cheap and the join fuses into its consumer; at or above it RADIX
#: (the reference's rule, ``exec/join.py:81``)
_RADIX_JOIN_CPU_MIN_BUILD = 1 << 16
#: the reference's cost-model constants (``exec/join.py:83`` and
#: ``exec/aggregate.py:60``): a random gather's price per element and the
#: share of peak bandwidth a sort pass reaches. Not measured on a card.
_GATHER_SEC_PER_ELEM = 15e-9
_HBM_DERATE = 0.6


def _key_word_count(key_dtypes) -> Tuple[int, bool]:
    """(radix key words, fixed-width-only) for the chooser's cost model;
    strings price at their typical chunk surface."""
    words = 0
    fixed = True
    for dt in key_dtypes:
        if isinstance(dt, (T.StringType, T.BinaryType)):
            fixed = False
            words += 4
        else:
            words += 2 if dt.to_numpy().itemsize == 8 else 1
    return words, fixed


def choose_join_strategy(conf: RapidsConf, build_cap: int, key_dtypes,
                         join_type: str, backend: str) -> Tuple[str, str]:
    """Pick the probe lowering for ONE join plan from its static build
    layout (build capacity, key widths) and ``backend``, the build
    batch's device type (reference ``exec/join.py:104``). Returns
    ``(strategy, reason)``. AUTO resolves:

      * the legacy ``sql.join.pallasProbe.enabled`` forces PALLAS;
      * ``cpu`` -> DIRECT below build cap 2^16 for one fixed-width key
        (the probe fuses into its consumer), else RADIX;
      * ``cuda`` -> DIRECT for one fixed-width key at build cap <= 2^20
        and inner/left/semi/anti joins (the fused fast path, as the
        reference's accelerator branch); otherwise the cheaper of RADIX
        (sort passes at the derated peak bandwidth of
        ``spark.rapids.tpu.roofline.peakHbmGBps``, default the H100's)
        and SEARCH (log2(build) gather passes).
    """
    mode = conf.get(JOIN_STRATEGY)
    if mode != "AUTO":
        return mode, "forced by spark.rapids.tpu.sql.join.strategy"
    if conf.get(JOIN_PALLAS_PROBE):
        return ("PALLAS", "AUTO: sql.join.pallasProbe.enabled (legacy "
                "toggle) — the hand-written probe kernel K4")
    words, fixed = _key_word_count(key_dtypes)
    direct_ok = fixed and 0 < words <= 2
    if backend == "cpu":
        if direct_ok and build_cap < _RADIX_JOIN_CPU_MIN_BUILD:
            return ("DIRECT", "AUTO: CPU device, single fixed-width key, "
                    f"build cap {build_cap} < 2^16 — direct-address "
                    "tables, and the probe fuses into its consumer chain")
        return ("RADIX", f"AUTO: CPU device at build cap {build_cap} — "
                "the co-sorted merge (the reference's CPU rule)")
    if (direct_ok and build_cap <= (1 << 20)
            and join_type in ("inner", "left", "semi", "anti")):
        return ("DIRECT", f"AUTO: single fixed-width key, build cap "
                f"{build_cap} <= 2^20 — the direct-address table probes "
                "with two gathers and fuses into its consumer chain")
    hbm_bps = roofline_peak_bps(conf, backend)
    hbm_eff = _HBM_DERATE * hbm_bps
    lg = max(1, math.ceil(math.log2(max(2, build_cap))))
    key_bytes = 4 * max(1, words)
    search_s = 2 * lg * build_cap * max(1, words) * _GATHER_SEC_PER_ELEM
    sort_passes = lg * (lg + 1) / 2
    radix_s = (2 * build_cap * (key_bytes + 12) * sort_passes
               + 4 * build_cap * 8) / hbm_eff
    pick = "RADIX" if radix_s < search_s else "SEARCH"
    return (pick, f"AUTO: est radix {radix_s * 1e3:.1f}ms "
            f"({sort_passes:.0f} passes) vs search {search_s * 1e3:.1f}ms "
            f"({2 * lg} gather passes) at build cap={build_cap}, "
            f"{hbm_bps / 1e9:.0f}GB/s peak")


def _null_col(dt: T.DataType, cap: int, dev) -> Val:
    """An all-null column of ``cap`` rows (an empty byte pool for a
    string)."""
    nulls = torch.zeros(cap, dtype=torch.bool, device=dev)
    if T.is_string(dt):
        return StrV(torch.zeros(cap + 1, dtype=torch.int32, device=dev),
                    torch.zeros(1, dtype=torch.uint8, device=dev), nulls)
    return ColV(torch.zeros(cap, dtype=torch_dtype(dt), device=dev), nulls)


class TpuShuffledHashJoinExec(TpuExec):
    """Build the right side once, stream probe batches from the left.

    inner/left/right/full/semi/anti equi-joins, plus an optional residual
    condition on inner joins (reference ``exec/join.py:246``)."""

    def __init__(self, conf: RapidsConf, left: TpuExec, right: TpuExec,
                 left_keys: Sequence[E.Expression],
                 right_keys: Sequence[E.Expression],
                 join_type: str = "inner",
                 condition: Optional[E.Expression] = None,
                 partitioned: bool = False):
        super().__init__(conf, [left, right])
        if join_type not in _JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type}")
        self.join_type = join_type
        #: both sides co-partitioned by the join keys (the planner put
        #: hash exchanges below): builds and probes stay per partition
        self.partitioned = partitioned
        self.condition = condition
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self._swap = join_type == "right"
        self._probe = right if self._swap else left
        self._build = left if self._swap else right
        self._probe_keys = [
            E.bind_references(k, self._probe.output_schema)
            for k in (right_keys if self._swap else left_keys)]
        self._build_keys = [
            E.bind_references(k, self._build.output_schema)
            for k in (left_keys if self._swap else right_keys)]
        self._jt = "left" if self._swap else join_type

        lf = left.output_schema.fields
        rf = right.output_schema.fields
        if join_type in ("semi", "anti"):
            self._schema = StructType(tuple(lf))
        else:
            nl = join_type in ("right", "full")
            nr = join_type in ("left", "full")
            self._schema = StructType(tuple(
                [StructField(f.name, f.dataType, f.nullable or nl)
                 for f in lf]
                + [StructField(f.name, f.dataType, f.nullable or nr)
                   for f in rf]))
        if condition is not None:
            if join_type != "inner":
                raise ValueError(
                    "residual join conditions only supported for inner "
                    "joins")
            self._cond = E.bind_references(condition,
                                           StructType(tuple(lf) + tuple(rf)))
        else:
            self._cond = None
        self._built: dict = {}  # general path: sorted builds by partition
        self._fast_built = None  # fused fast path state (None = untried)
        self._build_batch = None  # concatenated build input, shared
        # strategy memoized per build capacity so AUTO never flips
        # mid-plan; the last pick (with its reason) shows in describe()
        self._strategy_by_cap: dict = {}
        self._join_strategy_choice: Optional[Tuple[str, str]] = None

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        # full outer needs a global unmatched-build pass: one partition
        # unless the sides are co-partitioned (unmatched rows stay local)
        if self.join_type == "full" and not self.partitioned:
            return 1
        return self._probe.num_partitions

    def describe(self):
        out = f"TpuShuffledHashJoinExec({self.join_type}"
        if self._join_strategy_choice is not None:
            out += f", strategy={self._join_strategy_choice[0]}"
        if isinstance(self._fast_built, dict):
            out += f", fused={self._fast_built['kind']}"
        out += ")"
        if self._join_strategy_choice is not None:
            out += f" [{self._join_strategy_choice[1]}]"
        return out

    def resolved_strategy(self, build_cap: int, device) -> str:
        """Resolve (and memoize per build capacity) the probe lowering;
        the pick and its reason land in describe() and emit ONE
        ``join_strategy`` event and ``tpu_join_strategy`` count per (exec,
        build capacity) (reference ``join.py:334-358``)."""
        hit = self._strategy_by_cap.get(build_cap)
        if hit is not None:
            return hit
        strategy, reason = choose_join_strategy(
            self.conf, build_cap, [k.dtype for k in self._build_keys],
            self._jt, torch.device(device).type)
        self._strategy_by_cap[build_cap] = strategy
        self._join_strategy_choice = (strategy, reason)
        if _events.enabled():
            _events.emit("join_strategy", op=self.node_name,
                         strategy=strategy, reason=reason,
                         build_cap=build_cap)
        if _obs.enabled():
            _obs.inc("tpu_join_strategy", 1, strategy=strategy)
        return strategy

    # -- build side ----------------------------------------------------------
    def _concat_build(self) -> ColumnarBatch:
        """The whole build side in one batch, concatenated ONCE and shared
        by the fast and the general build."""
        if self._build_batch is None:
            batch = concat_all(self._build)
            if batch is None:
                bschema = self._build.output_schema
                batch = ColumnarBatch.from_pydict(
                    {f.name: [] for f in bschema.fields}, bschema,
                    device=self._build.device)
            # the build sorts and repeats rows: dictionaries expand
            self._build_batch = materialized_batch(batch)
        return self._build_batch

    def _build_words(self, cols, cap, dev):
        """(keys, words, any_null, string key bounds) of the build side;
        the string keys' byte bounds cost one host sync (the reference's
        ``_key_str_lens``, measured here on the keys themselves)."""
        keys = [lower(k, cols, cap, dev) for k in self._build_keys]
        sml = str_max_lens(keys)
        words, any_null = join_ops.radix_key_words(
            keys, [k.dtype for k in self._build_keys], sml)
        return keys, words, any_null, sml

    def _sort_build(self, keys, ok, sml):
        return sort_permutation(
            keys, [k.dtype for k in self._build_keys],
            [SortOrder(True, True) for _ in keys], ok, sml)

    def _partition_build(self, index: int) -> ColumnarBatch:
        """One partition of a co-partitioned build side in one batch."""
        batch = concat_batches(self._build.output_schema, [
            b for b in self._build.execute_partition(index)
            if b.num_rows > 0])
        if batch is None:
            bschema = self._build.output_schema
            batch = ColumnarBatch.from_pydict(
                {f.name: [] for f in bschema.fields}, bschema,
                device=self._build.device)
        return materialized_batch(batch)

    def _get_build(self, index: Optional[int] = None):
        """(the spillable sorted cols, sorted words and live mask in
        sorted order, the joinable count, capacity, words per key) —
        reference ``_get_build`` (``join.py:386``); ``index`` keys the
        per-partition builds of a co-partitioned join."""
        if index in self._built:
            return self._built[index]
        batch = (self._concat_build() if index is None
                 else self._partition_build(index))
        cap = batch.capacity
        dev = batch.columns[0].validity.device
        cols = vals_of_batch(batch)
        live = filter_gather.live_of(batch.num_rows_lazy, cap, dev)
        keys, words, any_null, sml = self._build_words(cols, cap, dev)
        self.resolved_strategy(cap, dev)
        ok = live & ~any_null
        # joinable rows first (sorted by key), then live null-key rows
        # (full outer still emits them) among the dead padding
        perm = self._sort_build(keys, ok, sml)
        live_all = live[perm]
        sorted_cols = filter_gather.gather(cols, perm, live_all)
        sorted_words = [w[perm] for w in words]
        count = int(ok.sum())  # host sync: the build's joinable rows
        # builds run lazily on the first probe, outside any op_timed
        # section: the ledger books the plan state to this join
        with op_scope(self.node_name):
            sb = _SpillableBuild(sorted_cols, sorted_words, live_all)
        built = (sb, count, cap, join_ops.key_word_widths(keys, sml))
        self._built[index] = built
        if index is None:
            self._build_batch = None
        return built

    # -- fused fast paths ------------------------------------------------------
    # When the probe is a pure masked transform (each probe row owns at
    # most one output row), the whole join fuses into its consumer chain
    # (scan -> join -> aggregate runs inside the aggregate's update):
    #
    #   * DIRECT: the build keys fit a 4x-capacity direct-address table and
    #     are unique (semi/anti need only membership): one (first, count)
    #     table lookup and one packed build-row gather per probe batch;
    #   * RADIX: unique build keys (semi/anti take any build): the probe
    #     co-sorts against the sorted build words inside the chain.
    #
    # Each syncs one feasibility check per build (fits + unique for
    # DIRECT, unique for RADIX inner/left).
    def _fast_static_ok(self, strategy: str = "DIRECT") -> bool:
        if self.partitioned or self._jt not in ("inner", "left", "semi",
                                                "anti"):
            return False
        if not self._build_keys:
            return False
        if any(T.is_string(k.dtype) for k in self._build_keys):
            return False
        words = sum(2 if k.dtype.to_numpy().itemsize == 8 else 1
                    for k in self._build_keys)
        if strategy == "DIRECT" and words > 2:
            return False  # the packed table key is one u64
        if self._jt in ("inner", "left"):
            # appended build columns gather as one packed matrix
            for f in self._build.output_schema.fields:
                if T.is_string(f.dataType) or not filter_gather.packable_dtype(
                        torch_dtype(f.dataType)):
                    return False
        return True

    def _try_fast_build(self):
        """The fused fast path's state, built once; or False."""
        if self._fast_built is not None:
            return self._fast_built
        if not self._fast_static_ok("ANY"):
            self._fast_built = False
            return False
        batch = self._concat_build()
        dev = batch.columns[0].validity.device
        strategy = self.resolved_strategy(batch.capacity, dev)
        if strategy == "RADIX":
            self._fast_built = self._radix_fast_build(batch)
            return self._fast_built
        legacy_pallas = (strategy == "PALLAS"
                         and self.conf.get(JOIN_STRATEGY) == "AUTO"
                         and self.conf.get(JOIN_PALLAS_PROBE))
        if not ((strategy == "DIRECT" or legacy_pallas)
                and self._fast_static_ok("DIRECT")):
            # SEARCH / forced PALLAS / infeasible shapes: general path
            self._fast_built = False
            return False
        self._fast_built = self._direct_fast_build(batch)
        return self._fast_built

    def _direct_fast_build(self, batch: ColumnarBatch):
        """DIRECT fused-probe state (reference ``_try_fast_build``,
        ``join.py:496``): the packed (first, count) table over the key
        offsets from the smallest key, + the packed build columns for
        inner/left. Syncs ONE (fits, unique) pair."""
        bcap = batch.capacity
        tbl = 4 * bcap
        dev = batch.columns[0].validity.device
        need_mat = self._jt in ("inner", "left")
        cols = vals_of_batch(batch)
        live = filter_gather.live_of(batch.num_rows_lazy, bcap, dev)
        _, words, any_null, _ = self._build_words(cols, bcap, dev)
        ok = live & ~any_null
        key64 = join_ops.pack_key(words)
        kmin, kmax = join_ops.key_span(key64, ok)
        fits = (~ok.any()) | join_ops._ult(kmax - kmin, tbl)
        first, cnt = join_ops.direct_tables(key64, ok, kmin, tbl)
        unique = cnt.amax() <= 1
        fits_h, unique_h = (bool(x) for x in
                            torch.stack([fits, unique]).tolist())
        if not fits_h or (not unique_h and need_mat):
            return False
        state = {"kind": "direct", "has_mat": need_mat,
                 "side": (torch.stack([first, cnt], 1), kmin)}
        if need_mat:
            state["side"] += (filter_gather.pack_fixed_cols(cols),)
            state["dtypes"] = tuple(c.data.dtype for c in cols)
        self._build_batch = None
        return state

    def _radix_fast_build(self, batch: ColumnarBatch):
        """RADIX fused-probe state (reference ``join.py:603``): the sorted
        build key words and count (+ the packed sorted build columns for
        inner/left, which need UNIQUE build keys: one sync)."""
        bcap = batch.capacity
        dev = batch.columns[0].validity.device
        need_mat = self._jt in ("inner", "left")
        cols = vals_of_batch(batch)
        live = filter_gather.live_of(batch.num_rows_lazy, bcap, dev)
        keys, words, any_null, sml = self._build_words(cols, bcap, dev)
        ok = live & ~any_null
        perm = self._sort_build(keys, ok, sml)
        sorted_words = [w[perm] for w in words]
        count = ok.sum(dtype=torch.int32)
        side = tuple(sorted_words) + (count,)
        if need_mat:
            idx = torch.arange(bcap, dtype=torch.int32, device=dev)
            same = (idx >= 1) & (idx < count)
            for w in sorted_words:
                same = same & (w == torch.cat([w[:1], w[:-1]]))
            if bool(same.any()):
                return False  # duplicate build keys: general RADIX path
            sorted_cols = filter_gather.gather(cols, perm, live[perm])
            side += (filter_gather.pack_fixed_cols(sorted_cols),)
        state = {"kind": "radix", "has_mat": need_mat, "side": side,
                 "nwords": len(sorted_words)}
        if need_mat:
            state["dtypes"] = tuple(c.data.dtype for c in cols)
        self._build_batch = None
        return state

    @property
    def fusable(self):
        return bool(self._try_fast_build())

    @property
    def sparsifies(self):
        return self._jt in ("inner", "semi", "anti")

    def fusion_stream_child(self):
        return self._probe

    def side_vals(self) -> tuple:
        st = self._try_fast_build()
        assert isinstance(st, dict)
        return st["side"]

    def lower_batch(self, cols, live, cap, side=()):
        st = self._fast_built
        dev = live.device
        keys = [lower(k, cols, cap, dev) for k in self._probe_keys]
        words, any_null = join_ops.radix_key_words(
            keys, [k.dtype for k in self._probe_keys])
        ok = live & ~any_null
        if st["kind"] == "radix":
            nw = st["nwords"]
            lo, hi, _ = join_ops.radix_probe_ranges(
                list(side[:nw]), side[nw], words, ok, lo_matched_only=True)
            matched = ok & (hi > lo)
            brow = torch.where(matched, lo, 0)
            mat_idx = nw + 1
        else:
            packed_tbl, kmin = side[0], side[1]
            tbl = packed_tbl.shape[0]
            key64 = join_ops.pack_key(words)
            diffu = key64 - kmin
            pin = ok & ~join_ops._ult(key64, kmin) & join_ops._ult(diffu, tbl)
            fc = packed_tbl[torch.where(pin, diffu, 0)]
            matched = pin & (fc[:, 1] > 0)
            brow = torch.where(matched, fc[:, 0], 0)
            mat_idx = 2
        jt = self._jt
        if jt == "semi":
            return list(cols), live & matched
        if jt == "anti":
            return list(cols), live & ~matched
        mat = side[mat_idx]
        bvals = filter_gather.unpack_fixed_cols(
            mat[brow.long().clamp(0, mat.shape[0] - 1)], st["dtypes"],
            matched)
        out = (list(bvals) + list(cols) if self._swap
               else list(cols) + list(bvals))
        live_out = (live & matched) if jt == "inner" else live
        if self._cond is not None:
            c = lower(self._cond, out, cap, dev)
            live_out = live_out & c.data & c.validity
        return out, live_out

    # -- probe ---------------------------------------------------------------
    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        if self._try_fast_build():
            yield from run_fused_chain(self, index)
            return
        sb, build_count, build_cap, build_widths = self._get_build(
            index if self.partitioned else None)
        with sb.pinned() as (build_cols, build_words, build_live_all):
            yield from self._probe_partition(
                index, build_cols, build_words, build_live_all,
                build_count, build_cap, build_widths)

    def _probe_partition(self, index, build_cols, build_words,
                         build_live_all, build_count, build_cap,
                         build_widths) -> Iterator[ColumnarBatch]:
        matched_any = (torch.zeros(build_cap, dtype=torch.bool,
                                   device=build_live_all.device)
                       if self.join_type == "full" else None)
        probe_parts = (range(self._probe.num_partitions)
                       if self.join_type == "full" and not self.partitioned
                       else [index])
        def probe_attempt(b):
            return self._probe_batch(b, build_cols, build_words,
                                     build_count, build_cap, build_widths)

        for pi in probe_parts:
            for pbatch in self._probe.execute_partition(pi):
                # probe rows are row-local against the intact build, so a
                # split streams each half's output as its own batch
                # (reference join.py:775)
                with self.op_timed("probe"):
                    outs = with_oom_retry(self.node_name, probe_attempt,
                                          pbatch, self.conf, combine="list")
                for batch, matched in outs:
                    if matched is not None and matched_any is not None:
                        matched_any = matched_any | matched
                    if batch is not None and batch.num_rows > 0:
                        yield self.record_batch(batch)
        if self.join_type == "full":
            yield from self._unmatched_build(build_cols, build_live_all,
                                             matched_any)

    def _probe_batch(self, pbatch, build_cols, build_words, build_count,
                     build_cap, build_widths):
        """One probe batch: the count phase (ranges per probe row), then
        for inner/left/full the expand phase (reference ``join.py:808``).
        Returns (output batch or None, matched-build mask or None)."""
        cap = pbatch.capacity
        jt = self._jt
        pvals = vals_of_batch(pbatch)
        dev = build_words[0].device
        strategy = self.resolved_strategy(build_cap, dev)
        radix_matched = self.join_type == "full" and strategy == "RADIX"

        # count phase
        live = filter_gather.live_of(pbatch.num_rows_lazy, cap, dev)
        keys = [as_plain_str(lower(k, pvals, cap, dev))
                for k in self._probe_keys]
        # the probe's string keys are bounded on their own (one sync);
        # each key's words on the narrower side are zero-padded
        psml = str_max_lens(keys)
        words, any_null = join_ops.radix_key_words(
            keys, [k.dtype for k in self._probe_keys], psml)
        build_words, words = join_ops.pad_key_words(
            build_words, words, build_widths,
            join_ops.key_word_widths(keys, psml))
        ok = live & ~any_null
        matched = None
        if radix_matched:
            lo, hi, matched = join_ops.radix_probe_ranges(
                build_words, build_count, words, ok, want_matched=True)
        else:
            lo, hi = join_ops.probe_ranges(build_words, build_count, words,
                                           ok, strategy=strategy)
        counts = hi - lo
        if self.join_type == "full" and matched is None:
            matched = join_ops.matched_build_mask(lo, lo + counts, live,
                                                  build_cap)
        if jt in ("semi", "anti"):
            keep = (ok & (counts > 0)) if jt == "semi" else (
                live & (counts == 0))
            vals, count = filter_gather.filter_cols(pvals, keep)
            return batch_from_vals(vals, self._schema, count,
                                   capacity=cap), matched
        if jt in ("left", "full"):
            ex_counts = torch.where(live & (counts == 0), 1, counts)
            ex_counts = torch.where(live, ex_counts, 0)
        else:
            ex_counts = torch.where(live, counts, 0)

        # expand phase: the match total sizes the output (one host sync)
        total = int(ex_counts.sum())
        if total == 0:
            return None, matched
        out_cap = choose_capacity(total, self.conf.shape_bucket_min)
        plan = (join_ops.radix_expansion_plan if strategy == "RADIX"
                else join_ops.expansion_plan)
        p, build_row, slot_live = plan(ex_counts, lo, out_cap)
        pad_slot = slot_live & (counts[p.long()] == 0)
        build_live = slot_live & ~pad_slot
        # the expansion repeats rows: dictionary payloads expand first
        pvals = [as_plain_str(v) for v in pvals]
        pcaps, bcaps = _expanded_pools([(pvals, p, slot_live),
                                        (build_cols, build_row, build_live)])
        probe_side = filter_gather.gather(pvals, p, slot_live, pcaps,
                                          repeats=True)
        build_side = filter_gather.gather(build_cols, build_row, build_live,
                                          bcaps, repeats=True)
        left_side, right_side = ((build_side, probe_side) if self._swap
                                 else (probe_side, build_side))
        vals = list(left_side) + list(right_side)
        out = batch_from_vals(vals, self._schema, total)
        if self._cond is not None:
            ocap = out.capacity
            livec = filter_gather.live_of(total, ocap, dev)
            c = lower(self._cond, vals, ocap, dev)
            vals2, cnt = filter_gather.filter_cols(
                vals, livec & c.data & c.validity)
            out = batch_from_vals(vals2, self._schema, cnt)
        return out, matched

    def _unmatched_build(self, build_cols, build_live_all, matched_any):
        """Full outer: the build rows no probe row matched (live null-key
        rows included), null-padded on the left."""
        vals, count = filter_gather.filter_cols(
            build_cols, build_live_all & ~matched_any)
        n = int(count)
        if n == 0:
            return
        cap_out = vals[0].validity.shape[0]
        dev = vals[0].validity.device
        null_left = [_null_col(f.dataType, cap_out, dev)
                     for f in self.children[0].output_schema.fields]
        yield self.record_batch(
            batch_from_vals(null_left + list(vals), self._schema, n))


def _expanded_pools(sides) -> List[List[int]]:
    """The byte pool of each string column of an expansion, per side of
    (columns, source rows, live slots): the bytes its live slots repeat,
    rounded up to a power of two of at least 128 (reference
    ``exec/join.py:879-903``). A row repeated by many slots outgrows its
    input pool, so the pool comes from this count; one host sync for
    every string column of both sides."""
    needs = []
    for cols, rows, live in sides:
        for c in cols:
            if isinstance(c, StrV):
                lens = c.offsets[1:] - c.offsets[:-1]
                r = rows.long().clamp(0, max(lens.shape[0] - 1, 0))
                needs.append(torch.where(live, lens[r], 0).sum())
    synced = host_ints(needs)
    if any(x > concat_ops.MAX_POOL_BYTES for x in synced):
        raise ValueError(f"an expanded string pool of {max(synced)} bytes "
                         "overflows its int32 offsets")
    got = iter(synced)
    return [[choose_capacity(max(1, next(got)), 128)
             for c in cols if isinstance(c, StrV)] for cols, _, _ in sides]


class TpuBroadcastNestedLoopJoinExec(TpuExec):
    """Cartesian or conditioned nested-loop join, inner only (reference
    ``join.py:1009``): every (probe, build) pair is generated and the
    bound condition filters it.

    The build side is concatenated ONCE (dictionaries expanded), held as
    a spillable buffer and pinned while a probe batch expands against
    it. A probe batch of ``np`` rows against ``nb`` build rows expands to
    ``np x nb`` slots at a power-of-two capacity: probe row ``j // nb``
    beside build row ``j % nb``; a string column's pool is sized from its
    live bytes times the other side's rows (reference ``join.py:1056``),
    and a pool past int32 offsets raises. Each probe batch runs under the
    OOM retry harness with split-and-retry, each piece's output its own
    batch."""

    def __init__(self, conf: RapidsConf, left: TpuExec, right: TpuExec,
                 condition: Optional[E.Expression] = None):
        super().__init__(conf, [left, right])
        lf, rf = left.output_schema.fields, right.output_schema.fields
        self._schema = StructType(tuple(lf) + tuple(rf))
        self.condition = condition
        self._cond = (E.bind_references(condition, self._schema)
                      if condition is not None else None)
        self._build_lock = threading.Lock()
        self._built = None  # (spillable build or None, rows, string bytes)

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return self.children[0].num_partitions

    def describe(self):
        return self.node_name

    def _get_build(self):
        """(the spillable build or None, its rows, each string column's
        live bytes), made once: one host sync for the counts."""
        with self._build_lock:
            if self._built is None:
                batch = concat_all(self.children[1])
                if batch is None:
                    self._built = (None, 0, [])
                else:
                    batch = materialized_batch(batch)
                    cols = vals_of_batch(batch)
                    nb_t = batch.num_rows_lazy
                    counts = host_ints([nb_t] + [
                        c.offsets[nb_t] for c in cols
                        if isinstance(c, StrV)])
                    with op_scope(self.node_name):
                        sb = _SpillableBuild(cols)
                    self._built = (sb, counts[0], counts[1:])
            return self._built

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        sb, nb, bbytes = self._get_build()
        if sb is None:
            return
        with sb.pinned() as (build_cols, _, _):
            for pbatch in self.children[0].execute_partition(index):
                with self.op_timed("probe"):
                    outs = with_oom_retry(
                        self.node_name,
                        lambda b: self._expand(b, build_cols, nb, bbytes),
                        pbatch, self.conf, combine="list")
                for out in outs:
                    if out is not None and out.num_rows > 0:
                        yield self.record_batch(out)

    def _expand(self, pbatch: ColumnarBatch, build_cols, nb: int,
                bbytes: Sequence[int]) -> Optional[ColumnarBatch]:
        """One probe batch's pairs, filtered by the condition (reference
        ``join.py:1042-1070``); None when either side is empty."""
        pbatch = materialized_batch(pbatch)
        pcols = vals_of_batch(pbatch)
        np_t = pbatch.num_rows_lazy
        counts = host_ints([np_t] + [c.offsets[np_t] for c in pcols
                                     if isinstance(c, StrV)])
        np_, pbytes = counts[0], counts[1:]
        if np_ == 0 or nb == 0:
            return None
        pairs = np_ * nb
        need = [b * nb for b in pbytes] + [b * np_ for b in bbytes]
        if any(x > concat_ops.MAX_POOL_BYTES for x in need):
            raise ValueError(
                f"a nested-loop join of {np_} x {nb} rows expands a string "
                f"pool to {max(need)} bytes, past its int32 offsets")
        caps = [choose_capacity(max(1, x), 128) for x in need]
        pcaps, bcaps = caps[:len(pbytes)], caps[len(pbytes):]
        out_cap = choose_capacity(pairs, self.conf.shape_bucket_min)
        dev = build_cols[0].validity.device
        j = torch.arange(out_cap, dtype=torch.int64, device=dev)
        slot_live = j < pairs
        left_side = filter_gather.gather(pcols, j // nb, slot_live, pcaps,
                                         repeats=True)
        right_side = filter_gather.gather(build_cols, j % nb, slot_live,
                                          bcaps, repeats=True)
        vals = list(left_side) + list(right_side)
        if self._cond is None:
            return batch_from_vals(vals, self._schema, pairs)
        c = lower(self._cond, vals, out_cap, dev)
        vals, count = filter_gather.filter_cols(
            vals, slot_live & c.data & c.validity)
        return batch_from_vals(vals, self._schema, count)


class TpuCartesianProductExec(TpuBroadcastNestedLoopJoinExec):
    """Unconditioned cross join (reference ``join.py:1110``): the
    nested-loop expansion with no condition."""

    def __init__(self, conf: RapidsConf, left: TpuExec, right: TpuExec):
        super().__init__(conf, left, right, condition=None)
