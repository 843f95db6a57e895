"""Static plan analyzer: batch layouts, nullability, device-memory
footprint and the compile-signature forecast, all derived from the bound
plan WITHOUT lowering or executing anything.

Counterpart of ``spark_rapids_tpu/plugin/plananalysis.py``, handler for
handler, with the same report text and ``plan_analysis`` payload:

  * **layouts**: every operator's static output batch layout (capacity
    bucket, per-column storage dtype, string byte-pool bounds), derived
    with ``utils/bucketing.bucket_rows``, the rule of
    ``columnar/column.choose_capacity``;
  * **nullability**: the three-point lattice (NON_NULL / MAYBE_NULL /
    ALL_NULL) propagated through every registered expression rule. The
    fused chains consume it through :func:`entry_nonnull_flags` and
    ``ops/filter_gather.elide_validity``: a NON_NULL column's validity at
    a batch boundary is exactly the liveness mask (padding slots are
    always invalid, live rows always valid);
  * **footprint**: a peak device-memory estimate per pipeline stage,
    checked against the ``memory/catalog.py`` budget, so ``explain()``
    can warn "this plan will spill/OOM at capacity N" before anything is
    allocated; the serving scheduler (``serve/scheduler.py``) admits
    plans against it;
  * **signatures**: the reference's forecast of distinct compile-cache
    keys per pipeline cache site (fused_chain / project / agg_update /
    agg_plan / sort / ...), with its recompile-storm warning. Eager
    PyTorch compiles no programs, so nothing in the port measures this
    forecast; it is kept because ``explain()``, the ``plan_analysis``
    event and ``tools/tpu_profile.py`` read it. The fusion and strategy
    notes call the runtime's own choosers and eligibility methods
    (``exec/aggregate.choose_agg_strategy``, ``exec/join.
    choose_join_strategy``, the aggregate's fused-route gates) on the
    plan's device: there is one copy of each rule.

Cross-check mode (``spark.rapids.tpu.sql.analysis.crossCheck.enabled``)
holds two of the reference's three invariants per query:

  2. the analyzer's per-operator byte bound covers the profiler's
     measured ``bytesTouched`` on every operator;
  3. nullability-elided execution is identical to the mask-carrying path
     (a second run with elision disabled).

The reference's invariant 1 (actual compile-cache misses per site are
covered by the forecast) has no counterpart: nothing is compiled.

A plan is ``bounded`` only when EVERY operator is exactly modeled:
in-memory/range sources flowing through project / filter / expand /
union / limit / single-partition aggregate and sort, with no CPU
fallbacks. Anything else (file scans, exchanges, joins, windows) still
gets a structural report, layouts and nullability, and parquet scans a
footer-derived footprint.

Mesh stages (:func:`forecast_mesh`, :func:`cross_check_mesh`) forecast
each stage's per-shard staging through the stage's own sizing helper
(``exec/mesh.py``). The reference's compile-count bound
(``mesh_program_bound``) has no counterpart, so ``programs_bound`` is
None.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .. import types as T
from ..conf import (
    AGG_FUSED_PLAN,
    ANALYSIS_ENABLED,
    ANALYSIS_NULL_ELISION,
    ANALYSIS_STORM_THRESHOLD,
    MAX_READER_BATCH_SIZE_ROWS,
    RapidsConf,
)
from ..cpu import plan as C
from ..expr import aggregates as A
from ..expr import expressions as E
from ..types import StructType

import torch

# ---------------------------------------------------------------------------
# The nullability lattice
# ---------------------------------------------------------------------------
NON_NULL = "NON_NULL"
MAYBE_NULL = "MAYBE_NULL"
ALL_NULL = "ALL_NULL"


def join_null(a: str, b: str) -> str:
    """Lattice join of two states flowing into one slot (e.g. union)."""
    if a == b:
        return a
    return MAYBE_NULL


def _meet_children(states: Sequence[str]) -> str:
    """Result state of an operator that is null iff ANY input is null
    (the standard strict-function rule: valid = AND of validities)."""
    if any(s == ALL_NULL for s in states):
        return ALL_NULL
    if all(s == NON_NULL for s in states):
        return NON_NULL
    return MAYBE_NULL


_CHILD_PASSTHROUGH = (
    E.UnaryMinus, E.UnaryPositive, E.Abs, E.BitwiseNot, E.Not,
    E.Floor, E.Ceil, E.Round, E.Rint, E.Signum,
    E.Sqrt, E.Exp, E.Sin, E.Cos, E.Tan, E.Asin, E.Acos, E.Atan,
    E.Sinh, E.Cosh, E.Tanh, E.Cbrt, E.Expm1, E.ToDegrees, E.ToRadians,
    E.Year, E.Quarter, E.Month, E.DayOfMonth, E.DayOfYear, E.DayOfWeek,
    E.WeekDay, E.Hour, E.Minute, E.Second, E.LastDay, E.UnixTimestamp,
    E.ToUnixTimestamp, E.TimeAdd,
    E.Upper, E.Lower, E.InitCap, E.Length,
    E.StringTrim, E.StringTrimLeft, E.StringTrimRight,
)

_STRICT_BINARY = (
    E.Pow, E.Atan2, E.BitwiseAnd, E.BitwiseOr, E.BitwiseXor,
    E.ShiftLeft, E.ShiftRight, E.ShiftRightUnsigned,
    E.DateAdd, E.DateSub, E.DateDiff, E.NaNvl,
    E.StartsWith, E.EndsWith, E.Contains,
)


def expr_nullability(e: E.Expression, inputs: Sequence[str]) -> str:
    """Output nullability of one BOUND expression given per-ordinal input
    column states. Unknown rules degrade to MAYBE_NULL — always sound."""
    ev = lambda c: expr_nullability(c, inputs)  # noqa: E731

    if isinstance(e, E.Alias):
        return ev(e.child)
    if isinstance(e, E.Literal):
        return ALL_NULL if e.value is None else NON_NULL
    if isinstance(e, E.BoundReference):
        return inputs[e.ordinal] if e.ordinal < len(inputs) else MAYBE_NULL
    if isinstance(e, (E.IsNull, E.IsNotNull, E.IsNan, E.EqualNullSafe,
                      E.Murmur3Hash, E.Rand, E.MonotonicallyIncreasingID,
                      E.SparkPartitionID, E.InputFileName)):
        return NON_NULL
    if isinstance(e, E.Coalesce):
        states = [ev(c) for c in e.exprs]
        if any(s == NON_NULL for s in states):
            return NON_NULL
        if all(s == ALL_NULL for s in states):
            return ALL_NULL
        return MAYBE_NULL
    if isinstance(e, (E.And, E.Or)):
        # 3-valued: two non-null operands give a non-null verdict; a null
        # operand can still be dominated (F AND NULL = F), so never ALL_NULL
        l, r = ev(e.left), ev(e.right)
        return NON_NULL if l == r == NON_NULL else MAYBE_NULL
    if isinstance(e, E.If):
        t, f = ev(e.true_value), ev(e.false_value)
        if t == f and t in (NON_NULL, ALL_NULL):
            return t
        return MAYBE_NULL
    if isinstance(e, E.CaseWhen):
        vals = [ev(v) for _, v in e.branches]
        vals.append(ev(e.else_value) if e.else_value is not None else ALL_NULL)
        if all(v == NON_NULL for v in vals):
            return NON_NULL
        if all(v == ALL_NULL for v in vals):
            return ALL_NULL
        return MAYBE_NULL
    if isinstance(e, E.In):
        has_null = any(v is None for v in e.values)
        c = ev(e.child)
        if c == ALL_NULL:
            return ALL_NULL
        return c if not has_null else MAYBE_NULL
    if isinstance(e, (E.Divide, E.IntegralDivide, E.Remainder, E.Pmod)):
        if isinstance(e.dtype, T.DecimalType):
            return MAYBE_NULL  # overflow nulls the row
        states = [ev(e.left), ev(e.right)]
        # a zero divisor nulls the row for non-float results; a literal
        # non-zero divisor cannot
        floats = e.dtype.is_floating and not isinstance(e, E.IntegralDivide)
        if isinstance(e, E.Divide):
            floats = False  # divide nulls on zero divisor even for floats
        lit_nonzero = (isinstance(e.right, E.Literal)
                       and e.right.value not in (None, 0, 0.0))
        if floats or lit_nonzero:
            return _meet_children(states)
        if any(s == ALL_NULL for s in states):
            return ALL_NULL
        return MAYBE_NULL
    if isinstance(e, (E.Add, E.Subtract, E.Multiply)):
        if isinstance(e.dtype, T.DecimalType):
            return MAYBE_NULL  # overflow nulls the row
        return _meet_children([ev(e.left), ev(e.right)])
    if isinstance(e, (E.Log, E.Log10, E.Log2, E.Log1p)):
        return MAYBE_NULL  # x <= 0 nulls the row
    if isinstance(e, E.Cast):
        frm, to = e.child.dtype, e.to
        risky = (
            isinstance(frm, (T.StringType, T.DecimalType))
            or isinstance(to, T.DecimalType)
            or (frm.is_floating and isinstance(to, T.TimestampType))
        )
        return MAYBE_NULL if risky else ev(e.child)
    if isinstance(e, _CHILD_PASSTHROUGH):
        kids = e.children
        return _meet_children([ev(c) for c in kids]) if kids else MAYBE_NULL
    if isinstance(e, (E._BinaryComparison,)):
        return _meet_children([ev(e.left), ev(e.right)])
    if isinstance(e, _STRICT_BINARY) or isinstance(e, E.Concat):
        kids = e.children
        return _meet_children([ev(c) for c in kids]) if kids else MAYBE_NULL
    return MAYBE_NULL


def agg_nullability(func: A.AggregateFunction, input_state: str,
                    grouped: bool) -> str:
    """Result nullability of one aggregate function. Groups are non-empty
    by construction, so grouped count is NON_NULL and grouped min/max/
    sum over a NON_NULL input stay NON_NULL; a grand aggregate over an
    empty (or all-null) input yields NULL for everything but count."""
    if isinstance(func, A.Count):
        return NON_NULL
    if grouped and input_state == NON_NULL and isinstance(
            func, (A.Sum, A.Min, A.Max, A.Average, A.First, A.Last)):
        return NON_NULL
    return MAYBE_NULL


def schema_nullability(schema: StructType) -> List[str]:
    return [NON_NULL if not f.nullable else MAYBE_NULL
            for f in schema.fields]


def narrow_by_predicate(states: List[str], bound: E.Expression) -> List[str]:
    """Post-filter narrowing: conjuncts that can never hold for a NULL in
    a direct column reference prove that column NON_NULL downstream
    (IsNotNull(c), and col-vs-non-null-literal comparisons, whose 3VL
    result is NULL — filtered — when the column is null)."""
    out = list(states)

    def mark(ref):
        if isinstance(ref, E.BoundReference) and ref.ordinal < len(out):
            out[ref.ordinal] = NON_NULL

    def visit(e):
        if isinstance(e, E.And):
            visit(e.left)
            visit(e.right)
            return
        if isinstance(e, E.IsNotNull):
            mark(e.child)
        elif isinstance(e, E._BinaryComparison) and not isinstance(
                e, E.EqualNullSafe):
            l, r = e.left, e.right
            if isinstance(l, E.BoundReference) and isinstance(r, E.Literal) \
                    and r.value is not None:
                mark(l)
            if isinstance(r, E.BoundReference) and isinstance(l, E.Literal) \
                    and l.value is not None:
                mark(r)

    visit(bound)
    return out


# ---------------------------------------------------------------------------
# Runtime consumption hook: which chain-entry columns may elide their
# validity plane. Sound because of the batch invariant (columnar/column.py):
# padding slots always hold validity=False and a declared-non-null column's
# live rows are all valid — validity IS the liveness mask, bit for bit.
# ---------------------------------------------------------------------------
def entry_nonnull_flags(schema: StructType, conf: RapidsConf) -> tuple:
    """Per-column elision flags for a batch of ``schema`` entering a fused
    pipeline; () when elision is disabled or no column is non-null (the
    mask-carrying path)."""
    if not conf.get(ANALYSIS_NULL_ELISION):
        return ()
    flags = tuple(not f.nullable for f in schema.fields)
    return flags if any(flags) else ()


# ---------------------------------------------------------------------------
# Layout model
# ---------------------------------------------------------------------------
def _storage_bytes(dt: T.DataType) -> int:
    import numpy as np

    if isinstance(dt, T.NullType):
        return 1
    return int(np.dtype(dt.to_numpy()).itemsize)


@dataclasses.dataclass
class ColState:
    """Static layout + nullability of one column inside one batch."""

    name: str
    dtype: T.DataType
    null: str
    char_cap: Optional[int] = None   # strings: byte-pool array length
    max_len: Optional[int] = None    # strings: max single-row byte length

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, (T.StringType, T.BinaryType))

    def bytes_at(self, cap: int) -> Optional[int]:
        """Upper bound of this column's contribution to batch_bytes()
        (exec/base.py) at capacity — covers both the rows-known and the
        capacity-fallback accounting the profiler uses."""
        if self.is_string:
            if self.char_cap is None:
                return None
            return cap * 5 + self.char_cap
        return cap * (_storage_bytes(self.dtype) + 1)

    def describe(self) -> str:
        t = self.dtype.simpleString
        if self.is_string and self.char_cap is not None:
            t += f"(chars<={self.char_cap})"
        return f"{self.name}: {t} {self.null}"


@dataclasses.dataclass
class BatchState:
    rows: Optional[int]  # exact logical rows when statically known
    cap: int
    cols: List[ColState]

    def sig(self) -> Optional[tuple]:
        """Static stand-in for exec/base.py batch_signature + capacity:
        two batches compile the same pipeline iff their sigs are equal.
        None when a string byte-pool bound is unknown."""
        parts: List[tuple] = [("cap", self.cap)]
        for c in self.cols:
            if c.is_string:
                if c.char_cap is None:
                    return None
                parts.append(("s", c.dtype.simpleString, c.char_cap,
                              c.max_len))
            else:
                parts.append(("f", c.dtype.simpleString))
        return tuple(parts)

    def bytes_bound(self) -> Optional[int]:
        total = 0
        for c in self.cols:
            b = c.bytes_at(self.cap)
            if b is None:
                return None
            total += b
        return total


@dataclasses.dataclass
class OpReport:
    name: str          # the TPU exec class name this node converts to
    detail: str
    layout: List[ColState]
    out_bytes: Optional[int]      # bound on this op's total bytesTouched
    sites: Dict[str, int]         # forecast compile signatures by site
    exact: bool
    notes: List[str]
    children: List["OpReport"]
    # the live-progress denominators (obs/progress.py): forecast output
    # rows / batch count when statically known, set centrally by
    # _Analyzer.analyze from the handler's batch states
    out_rows: Optional[int] = None
    out_batches: Optional[int] = None

    def lines(self, indent: int = 0) -> List[str]:
        pad = "  " * indent
        head = f"{pad}@{self.name}"
        if self.detail:
            head += f" {self.detail}"
        if self.out_bytes is not None:
            head += f" bytes<={_pretty_bytes(self.out_bytes)}"
        if self.sites:
            head += " compiles[" + ", ".join(
                f"{k}={v}" for k, v in sorted(self.sites.items())) + "]"
        if not self.exact:
            head += " (shapes not statically bounded)"
        out = [head]
        if self.layout:
            out.append(pad + "    " + "; ".join(
                c.describe() for c in self.layout))
        for n in self.notes:
            out.append(pad + "    note: " + n)
        for c in self.children:
            out.extend(c.lines(indent + 1))
        return out


def _pretty_bytes(n: int) -> str:
    if n >= 1 << 20:
        return f"{n / (1 << 20):.1f}MB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}KB"
    return f"{n}B"


@dataclasses.dataclass
class PlanAnalysis:
    root: OpReport
    bounded: bool
    site_forecast: Dict[str, int]
    bytes_by_op: Dict[str, int]      # exec name -> summed byte bound
    peak_hbm: Optional[int]
    budget: Optional[int]
    warnings: List[str]
    elided_columns: int
    # forecast output rows / batch counts per exec name where statically
    # known — the denominators the live progress plane (/status) divides
    # record_batch's numerators into
    rows_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    batches_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)

    def render_lines(self) -> List[str]:
        lines = ["== Static Plan Analysis =="]
        lines.extend(self.root.lines())
        if self.bounded:
            total = sum(self.site_forecast.values())
            sites = ", ".join(f"{k}={v}" for k, v in
                              sorted(self.site_forecast.items()))
            lines.append(
                f"forecast compile signatures: {total}"
                + (f" ({sites})" if sites else ""))
        else:
            lines.append(
                "forecast compile signatures: not statically bounded "
                "(plan has data-dependent shapes or CPU fallbacks)")
        if self.elided_columns:
            lines.append(
                f"nullability elision: {self.elided_columns} validity "
                "plane(s) elided at pipeline entries")
        if self.peak_hbm is not None:
            b = ("unlimited" if self.budget is None
                 else _pretty_bytes(self.budget))
            lines.append(
                f"predicted peak HBM: {_pretty_bytes(self.peak_hbm)} "
                f"(budget: {b})")
        for w in self.warnings:
            lines.append("warning: " + w)
        return lines

    def render(self) -> str:
        return "\n".join(self.render_lines())

    def event_fields(self) -> Dict[str, object]:
        """The JSON-safe forecast payload for the ``plan_analysis``
        event-log record — tools/tpu_profile.py diffs these bounds against
        the measured compile_miss / op_batch events of the same query (the
        offline twin of the test harness's analysis cross-check)."""
        return {"bounded": self.bounded,
                "site_forecast": dict(self.site_forecast),
                "bytes_by_op": dict(self.bytes_by_op),
                "rows_by_op": dict(self.rows_by_op),
                "batches_by_op": dict(self.batches_by_op),
                "peak_hbm": self.peak_hbm, "budget": self.budget,
                "warnings": list(self.warnings)}


# ---------------------------------------------------------------------------
# The analyzer walk
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Result:
    parts: Optional[List[List[BatchState]]]  # None = shapes unknown
    layout: List[ColState]                   # merged per-column summary
    report: OpReport
    exact: bool
    # a fusable chain below (and including) this node that has not yet
    # been attributed to a consumer: (chain-top report, source sig set)
    pending_chain: Optional[Tuple[OpReport, Optional[Set[tuple]]]] = None
    # the source feeding the pending chain (for aggregates absorbing it)
    chain_source: Optional["_Result"] = None
    chain_len: int = 0


class _Analyzer:
    def __init__(self, conf: RapidsConf, device):
        self.conf = conf
        #: the plan's device: the choosers and fusion gates read its type
        self.device = device
        from ..utils.bucketing import bucket_rows

        self._bucket = bucket_rows
        self.elided = 0
        self.scan_resident = 0
        self.max_working = 0
        self.max_cap = 0  # largest batch capacity seen (OOM diagnostics)
        self.exact_all = True

    # -- shared helpers ----------------------------------------------------
    def _note_working(self, *bounds: Optional[int]) -> None:
        known = [b for b in bounds if b is not None]
        if known:
            self.max_working = max(self.max_working, sum(known))

    def _count_elision(self, schema: StructType) -> None:
        flags = entry_nonnull_flags(schema, self.conf)
        self.elided += sum(1 for f in flags if f)

    def _sigs(self, parts: Optional[List[List[BatchState]]]
              ) -> Optional[Set[tuple]]:
        if parts is None:
            return None
        sigs: Set[tuple] = set()
        for p in parts:
            for b in p:
                s = b.sig()
                if s is None:
                    return None
                sigs.add(s)
        return sigs

    def _total_bytes(self, parts: Optional[List[List[BatchState]]]
                     ) -> Optional[int]:
        if parts is None:
            return None
        total = 0
        for p in parts:
            for b in p:
                self.max_cap = max(self.max_cap, b.cap)
                bb = b.bytes_bound()
                if bb is None:
                    return None
                total += bb
        return total

    def _finalize_chain(self, r: _Result) -> None:
        """The chain top runs run_fused_chain (one 'fused_chain' compile
        per distinct source signature) because no consumer absorbed it."""
        if r.pending_chain is None:
            return
        top_report, source_sigs = r.pending_chain
        if source_sigs is not None:
            top_report.sites["fused_chain"] = (
                top_report.sites.get("fused_chain", 0) + len(source_sigs))
        else:
            top_report.exact = False
        if r.chain_source is not None and r.chain_source.layout:
            self._count_elision(StructType(tuple(
                T.StructField(c.name, c.dtype, c.null != NON_NULL)
                for c in r.chain_source.layout)))
        r.pending_chain = None
        r.chain_source = None

    def _merge_layout(self, parts: Optional[List[List[BatchState]]],
                      schema: StructType) -> List[ColState]:
        """Per-column summary across batches (max char caps, joined
        nullability); falls back to schema-derived states."""
        if parts is None or not any(parts):
            return [
                ColState(f.name, f.dataType,
                         NON_NULL if not f.nullable else MAYBE_NULL)
                for f in schema.fields
            ]
        merged: List[ColState] = []
        batches = [b for p in parts for b in p]
        for i, f in enumerate(schema.fields):
            cols = [b.cols[i] for b in batches]
            null = cols[0].null
            for c in cols[1:]:
                null = join_null(null, c.null)
            ccs = [c.char_cap for c in cols]
            mls = [c.max_len for c in cols]
            merged.append(ColState(
                f.name, f.dataType, null,
                char_cap=(None if any(c is None for c in ccs) or not ccs
                          else max(ccs)) if cols[0].is_string else None,
                max_len=(None if any(m is None for m in mls) or not mls
                         else max(mls)) if cols[0].is_string else None,
            ))
        return merged

    # -- node dispatch -----------------------------------------------------
    def analyze(self, node: C.CpuExec) -> _Result:
        handlers = {
            C.CpuScanExec: self._scan,
            C.CpuFileScanExec: self._file_scan,
            C.CpuRangeExec: self._range,
            C.CpuProjectExec: self._project,
            C.CpuFilterExec: self._filter,
            C.CpuHashAggregateExec: self._aggregate,
            C.CpuSortExec: self._sort,
            C.CpuLocalLimitExec: self._limit,
            C.CpuCollectLimitExec: self._limit,
            C.CpuUnionExec: self._union,
            C.CpuGenerateExec: self._expand,   # subclass before base
            C.CpuExpandExec: self._expand,
        }
        h = handlers.get(type(node))
        r = self._structural(node) if h is None else h(node)
        if not r.exact:
            self.exact_all = False
        if r.parts is not None:
            # progress denominators: batch count is known whenever the
            # shapes are; rows only when every batch's logical count is
            # (a filter's post-predicate rows are not)
            batches = [b for p in r.parts for b in p]
            r.report.out_batches = len(batches)
            if all(b.rows is not None for b in batches):
                r.report.out_rows = sum(b.rows for b in batches)
        return r

    def _structural(self, node: C.CpuExec) -> _Result:
        """Layout/nullability-only report for shapes the analyzer does not
        bound statically (file scans, joins, windows)."""
        kids = [self.analyze(c) for c in node.children]
        for k in kids:
            self._finalize_chain(k)
        schema = node.output_schema
        layout = [
            ColState(f.name, f.dataType,
                     NON_NULL if not f.nullable else MAYBE_NULL)
            for f in schema.fields
        ]
        notes = []
        if isinstance(node, C.CpuJoinExec):
            layout = self._join_layout(node, kids)
            notes.append(
                f"{node.join_type} join: output shapes depend on match "
                "counts (not statically bounded)")
            self._note_join_strategy(node, kids, notes)
        self.exact_all = False
        return _Result(
            parts=None, layout=layout,
            report=OpReport(node.node_name, "", layout, None, {}, False,
                            notes, [k.report for k in kids]),
            exact=False)

    def _note_join_strategy(self, node: C.CpuJoinExec,
                            kids: List["_Result"],
                            notes: List[str]) -> None:
        """Forecast the join probe lowering by calling the RUNTIME's own
        chooser (exec/join.choose_join_strategy) over the statically
        known build capacity — the agg-strategy-note contract: a wrong
        forecast surfaces as a mismatch against the 'join_strategy'
        event, never as silent drift. AUTO with no static build shape
        (file scans, exchanges below the build side) must not guess."""
        from ..conf import JOIN_STRATEGY
        from ..exec.join import choose_join_strategy

        swap = node.join_type == "right"
        build_kid = kids[0] if swap else kids[1]
        build_keys = node._bl if swap else node._br
        jt = "left" if swap else node.join_type
        build_cap = None
        if build_kid.parts is not None:
            rows = sum(b.rows or 0 for p in build_kid.parts for b in p)
            build_cap = self._bucket(max(1, rows))
        if build_cap is None and self.conf.get(JOIN_STRATEGY) == "AUTO":
            notes.append(
                "join strategy: AUTO — resolved per build capacity at "
                "run time (build side not statically bounded); see the "
                "'join_strategy' event for the actual choice")
            return
        strat, reason = choose_join_strategy(
            self.conf, build_cap if build_cap is not None else 128,
            [k.dtype for k in build_keys], jt,
            torch.device(self.device).type)
        notes.append(f"join strategy: {strat} — {reason}")

    def _join_layout(self, node: C.CpuJoinExec,
                     kids: List[_Result]) -> List[ColState]:
        """Join output nullability: an outer join reintroduces NULLs on
        the non-preserved side regardless of input nullability."""
        schema = node.output_schema
        nl = len(node.children[0].output_schema.fields)
        base: List[str] = []
        for side, kid in ((0, kids[0]), (1, kids[1])):
            states = [c.null for c in kid.layout]
            base.extend(states)
        out: List[ColState] = []
        how = node.join_type
        for i, f in enumerate(schema.fields):
            if i < len(base):
                s = base[i]
            else:
                s = MAYBE_NULL
            from_right = i >= nl
            if how == "full":
                s = MAYBE_NULL
            elif how == "left" and from_right:
                s = MAYBE_NULL
            elif how == "right" and not from_right:
                s = MAYBE_NULL
            out.append(ColState(f.name, f.dataType, s))
        return out

    # -- sources -----------------------------------------------------------
    def _scan(self, node: C.CpuScanExec) -> _Result:
        schema = node.output_schema
        base_null = schema_nullability(schema)
        parts: List[List[BatchState]] = []
        exact = True
        total_rows = sum(len(p) for p in node._partitions)
        inspect_bytes = total_rows <= 1_000_000
        for prt in node._partitions:
            n = len(prt)
            if n == 0:
                parts.append([])  # _convert_scan emits no batch
                continue
            cap = self._bucket(n)  # batch_from_rows capacity rule
            cols: List[ColState] = []
            for i, f in enumerate(schema.fields):
                cs = ColState(f.name, f.dataType, base_null[i])
                if cs.is_string:
                    if inspect_bytes:
                        total = 0
                        mx = 0
                        for row in prt:
                            v = row[i]
                            if v is None:
                                continue
                            b = v if isinstance(v, bytes) else str(v).encode(
                                "utf-8")
                            total += len(b)
                            mx = max(mx, len(b))
                        cs.char_cap = self._bucket(max(total, 1), 128)
                        cs.max_len = mx
                    else:
                        exact = False
                cols.append(cs)
            parts.append([BatchState(n, cap, cols)])
        out_bytes = self._total_bytes(parts)
        if out_bytes is not None:
            self.scan_resident += out_bytes  # batches live for the plan
        layout = self._merge_layout(parts, schema)
        nparts = len(node._partitions)
        return _Result(
            parts, layout,
            OpReport("InMemoryScanExec",
                     f"[{nparts} partition(s), rows={total_rows}]",
                     layout, out_bytes, {}, exact, [], []),
            exact)

    def _file_scan(self, node: C.CpuFileScanExec) -> _Result:
        """File scans stay structurally unbounded (row counts and string
        pools are data, not schema) — but their HBM FOOTPRINT is readable
        from the file footers alone, and round 6's forecast ignored it
        entirely (file-scan plans reported no peak at all, so the
        plan-time "will spill" warning could never fire for exactly the
        scans most likely to spill). Parquet footers give per-row-group
        row counts and chunk byte sizes, so the analyzer now charges:

          * decoded batches — every selected row group's capacity bucket
            x schema row width (+ string chunk pools at their
            uncompressed size) stays RESIDENT for the plan (the scan
            cache pins it, exactly like in-memory scan batches);
          * the pipelined reader's device window — TWO staged uploads in
            flight (double-buffered staging), each bounded by the largest
            row group's selected-chunk uncompressed bytes;
          * host staging — maxInFlight row groups of decoded payloads
            (reported in the notes; host memory is not HBM, so it rides
            outside the peak figure).
        """
        schema = node.output_schema
        layout = [
            ColState(f.name, f.dataType,
                     NON_NULL if not f.nullable else MAYBE_NULL)
            for f in schema.fields
        ]
        notes = ["file scan batch shapes come from file metadata"]
        if getattr(node, "fmt", None) == "parquet":
            try:
                self._model_parquet_scan(node, schema, notes)
            except Exception:  # missing files, exotic footers: stay quiet
                pass
        self.exact_all = False
        return _Result(
            parts=None, layout=layout,
            report=OpReport(node.node_name, "", layout, None, {}, False,
                            notes, []),
            exact=False)

    def _model_parquet_scan(self, node, schema: StructType,
                            notes: List[str]) -> None:
        from ..conf import PARQUET_PIPELINE_MAX_IN_FLIGHT

        fp = parquet_scan_footprint(node.scanner, schema)
        if fp is None:
            return
        for cap in fp["caps"]:
            self.max_cap = max(self.max_cap, cap)
        decoded, max_upload = fp["decoded"], fp["max_upload"]
        window = 2 * max_upload  # double-buffered staged transfers
        mif = self.conf.get(PARQUET_PIPELINE_MAX_IN_FLIGHT)
        self.scan_resident += decoded
        self._note_working(window)
        notes.append(
            f"pipelined device decode: {fp['nrg']} row group(s), decoded "
            f"batches ~{_pretty_bytes(decoded)} resident (scan cache), "
            f"double-buffered upload window <= {_pretty_bytes(window)} "
            f"device, host staging <= "
            f"{_pretty_bytes(mif * max_upload)} (maxInFlight={mif})")
        notes.append(
            "unpack layout bound: uploaded payloads "
            f"<= {_pretty_bytes(fp['upload_total'])} + decoded planes "
            f"{_pretty_bytes(decoded)} — the denominator of the parquet "
            "shape's byte_amplification (bench.py)")

    def _range(self, node: C.CpuRangeExec) -> _Result:
        schema = node.output_schema
        max_rows = self.conf.get(MAX_READER_BATCH_SIZE_ROWS)
        total = max(0, -(-(node.end - node.start) // node.step))
        slices = node.num_slices
        per = (total + slices - 1) // slices if total else 0
        parts: List[List[BatchState]] = []
        name = schema.fields[0].name
        for idx in range(slices):
            lo, hi = idx * per, min(total, (idx + 1) * per)
            batches: List[BatchState] = []
            pos = lo
            while pos < hi:
                n = min(max_rows, hi - pos)
                cap = self._bucket(n, self.conf.shape_bucket_min)
                batches.append(BatchState(
                    n, cap, [ColState(name, T.LONG, NON_NULL)]))
                pos += n
            parts.append(batches)
        out_bytes = self._total_bytes(parts)
        layout = self._merge_layout(parts, schema)
        return _Result(
            parts, layout,
            OpReport("TpuRangeExec", f"[rows={total}]", layout, out_bytes,
                     {}, True, [], []),
            True)

    # -- fusable row ops ---------------------------------------------------
    def _expr_col_state(self, bound: E.Expression, name: str,
                        in_cols: List[ColState], cap: int) -> ColState:
        dt = bound.dtype
        null = expr_nullability(
            bound, [c.null for c in in_cols])
        cs = ColState(name, dt, null)
        if not cs.is_string:
            return cs
        ref = bound
        while isinstance(ref, E.Alias):
            ref = ref.child
        if isinstance(ref, E.BoundReference) and ref.ordinal < len(in_cols):
            src = in_cols[ref.ordinal]
            cs.char_cap, cs.max_len = src.char_cap, src.max_len
        elif isinstance(ref, E.Literal):
            raw = (ref.value.encode("utf-8")
                   if isinstance(ref.value, str) else (ref.value or b""))
            cs.char_cap = max(cap * len(raw), 1)
            cs.max_len = len(raw)
        # other string-producing expressions: byte pool is kernel-specific
        # (char_cap stays None -> downstream shapes not bounded)
        return cs

    def _output_names(self, exprs, schema: StructType) -> List[str]:
        names = []
        for i, e in enumerate(exprs):
            if isinstance(e, (E.Alias, E.UnresolvedAttribute)):
                names.append(e.name)
            else:
                names.append(f"col{i}")
        return names

    def _project(self, node: C.CpuProjectExec) -> _Result:
        from .overrides import _has_string_hash

        kid = self.analyze(node.children[0])
        child_schema = node.children[0].output_schema
        fusable = not any(
            E.has_context_expr(e) or _has_string_hash(e, child_schema)
            for e in node.exprs
        )
        bound = [E.bind_references(e, child_schema) for e in node.exprs]
        names = self._output_names(node.exprs, child_schema)
        exact = kid.exact

        parts: Optional[List[List[BatchState]]] = None
        if kid.parts is not None:
            parts = []
            for p in kid.parts:
                nb = []
                for b in p:
                    cols = [
                        self._expr_col_state(be, nm, b.cols, b.cap)
                        for be, nm in zip(bound, names)
                    ]
                    nb.append(BatchState(b.rows, b.cap, cols))
                parts.append(nb)
        layout = self._merge_layout(parts, node.output_schema)
        report = OpReport("TpuProjectExec",
                          "" if fusable else "(context exprs)",
                          layout, self._total_bytes(parts), {}, exact,
                          [], [kid.report])
        self._note_working(self._total_bytes(kid.parts),
                           self._total_bytes(parts))
        if not fusable:
            # context projects run standalone: one 'project' compile per
            # distinct extended input signature. rand/id/partition-id
            # columns are cap-shaped (deterministic per input signature);
            # input_file_name and hash()-over-strings size their byte
            # pools from run-time values, so those stay unbounded.
            self._finalize_chain(kid)

            def _shape_dependent(e):
                if isinstance(e, (E.InputFileName, E.Murmur3Hash)):
                    return True
                return any(_shape_dependent(c) for c in e.children)

            sigs = self._sigs(kid.parts)
            if sigs is not None and not any(
                    _shape_dependent(b) for b in bound):
                report.sites["project"] = len(sigs)
            else:
                exact = False
                report.exact = False
            return _Result(parts, layout, report, exact)
        # fusable: extend (or start) the pending chain
        if kid.pending_chain is not None:
            source_sigs = kid.pending_chain[1]
            source = kid.chain_source
            kid.pending_chain = None
        else:
            source_sigs = self._sigs(kid.parts)
            source = kid
        return _Result(parts, layout, report, exact,
                       pending_chain=(report, source_sigs),
                       chain_source=source,
                       chain_len=kid.chain_len + 1)

    def _filter(self, node: C.CpuFilterExec) -> _Result:
        kid = self.analyze(node.children[0])
        child_schema = node.children[0].output_schema
        bound = E.bind_references(node.condition, child_schema)
        exact = kid.exact
        parts: Optional[List[List[BatchState]]] = None
        if kid.parts is not None:
            parts = []
            for p in kid.parts:
                nb = []
                for b in p:
                    states = narrow_by_predicate(
                        [c.null for c in b.cols], bound)
                    cols = [dataclasses.replace(c, null=s)
                            for c, s in zip(b.cols, states)]
                    nb.append(BatchState(None, b.cap, cols))  # rows unknown
                parts.append(nb)
        layout = self._merge_layout(parts, node.output_schema)
        report = OpReport("TpuFilterExec", "", layout,
                          self._total_bytes(parts), {}, exact, [],
                          [kid.report])
        self._note_working(self._total_bytes(kid.parts),
                           self._total_bytes(parts))
        if kid.pending_chain is not None:
            source_sigs = kid.pending_chain[1]
            source = kid.chain_source
            kid.pending_chain = None
        else:
            source_sigs = self._sigs(kid.parts)
            source = kid
        return _Result(parts, layout, report, exact,
                       pending_chain=(report, source_sigs),
                       chain_source=source,
                       chain_len=kid.chain_len + 1)

    # -- aggregate ---------------------------------------------------------
    def _aggregate(self, node: C.CpuHashAggregateExec) -> _Result:
        kid = self.analyze(node.children[0])
        child_schema = node.children[0].output_schema
        if node.children[0].num_partitions != 1:
            # partial -> exchange -> final (or mesh): shapes cross an
            # exchange whose batch sizes are data-dependent
            self._finalize_chain(kid)
            self._count_elision(child_schema)
            layout = self._agg_result_layout(node, kid, None)
            self.exact_all = False
            return _Result(
                None, layout,
                OpReport("TpuHashAggregateExec", "(partial+exchange+final)",
                         layout, None, {}, False,
                         ["multi-partition aggregate: exchange batch "
                          "shapes are data-dependent"], [kid.report]),
                False)

        from ..exec import aggregate as XA

        agg = XA.TpuHashAggregateExec(
            self.conf, node.group_exprs, node.agg_exprs,
            _SchemaOnlyExec(self.conf, child_schema, self.device),
            A.COMPLETE)

        report = OpReport("TpuHashAggregateExec", "", [], None, {},
                          kid.exact, [], [kid.report])

        # chain absorption mirrors execute_partition: fusable children fold
        # into the update program UNLESS a string min/max value needs an
        # exact byte bound measured on the aggregate's direct input
        string_minmax = any(
            op in ("min", "max") and e is not None
            and isinstance(e.dtype, (T.StringType, T.BinaryType))
            for op, e in zip(agg._update_ops, agg._update_exprs)
        )
        absorbed = kid.pending_chain is not None and not string_minmax
        if absorbed:
            source = kid.chain_source
            source_sigs = kid.pending_chain[1]
            kid.pending_chain = None
            in_parts = source.parts if source is not None else None
            in_sigs = source_sigs
            if source is not None:
                self._count_elision(StructType(tuple(
                    T.StructField(c.name, c.dtype, c.null != NON_NULL)
                    for c in source.layout)))
        else:
            self._finalize_chain(kid)
            in_parts = kid.parts
            in_sigs = self._sigs(kid.parts)
            self._count_elision(child_schema)  # per-batch update entries

        exact = kid.exact and in_sigs is not None
        if string_minmax:
            exact = False
            report.notes.append(
                "string min/max byte bounds are measured at run time")

        grouped = bool(node.group_exprs)
        string_buffers = any(
            isinstance(f.dataType, (T.StringType, T.BinaryType))
            for f in agg._buffer_schema.fields
        )
        sites: Dict[str, int] = {}
        in_batches = ([b for p in in_parts for b in p]
                      if in_parts is not None else None)
        nbatches = len(in_batches) if in_batches is not None else None
        can_fuse = (self.conf.get(AGG_FUSED_PLAN) != "OFF"
                    and agg._can_fuse_plan())
        cap_sum = (sum(max(1, b.cap) for b in in_batches)
                   if in_batches else 0)
        byte_sum = self._total_bytes(in_parts) or 0
        fused = (can_fuse and nbatches is not None and 0 < nbatches
                 and agg._fused_plan_fits(nbatches, cap_sum, byte_sum))
        report.notes.append(
            "fusedPlan: " + ("ON (one agg_plan program)" if fused else
                             "per-batch updates"
                             + ("" if can_fuse else
                                " (string keys/buffers are ineligible)")))
        # stage fusion (scan→agg as one program) needs a device-decoded
        # file scan source; the statically-bounded paths are in-memory,
        # so the verified expectation here is always "no stage fusion" —
        # a wrong expectation would surface as an unforecast agg_stage
        # cache miss in the cross-check
        if agg._can_fuse_stage() and agg._stage_fusion_on():
            report.notes.append(
                "stageFusion: eligible but source is not a device-decoded "
                "file scan — not applied")
        if nbatches is None:
            exact = False
        elif nbatches == 0:
            if not grouped:
                # grand aggregate over empty input: one zero-row update
                # batch + the result projection
                sites["agg_update"] = 1
                sites["project"] = 1
        elif fused:
            sites["agg_plan"] = 1
            if nbatches > 1:
                # the in-trace padded merge concatenates partials; its
                # output capacity is modeled only for the 1-batch case
                exact = False
        else:
            if in_sigs is not None:
                # one update program per distinct input signature
                sites["agg_update"] = len(in_sigs)
            if nbatches > 1:
                # the merge re-aggregates a concatenated batch whose
                # capacity depends on runtime group counts
                exact = False
                report.notes.append(
                    "multi-batch merge shapes depend on group counts")
            else:
                sites["project"] = sites.get("project", 0) + 1  # _evaluate

        # output layout
        in_cols = (in_batches[0].cols if in_batches else
                   [ColState(f.name, f.dataType,
                             NON_NULL if not f.nullable else MAYBE_NULL)
                    for f in child_schema.fields])
        in_cap = in_batches[0].cap if in_batches else 128
        if node.group_exprs:
            # strategy forecast: call the RUNTIME's own chooser over the
            # statically-known capacity — the same "derive the decision
            # from the engine's own eligibility code" rule the fusion
            # notes follow, so a wrong forecast surfaces as a strategy
            # mismatch between this note and the 'agg_strategy' event.
            # AUTO's cost model is capacity-dependent, so with NO static
            # capacity (file scans, exchanges) the note must not guess
            # from the placeholder cap — that would manufacture exactly
            # the spurious mismatch the note exists to expose. A forced
            # conf value is capacity-independent and always forecastable.
            from ..conf import AGG_STRATEGY
            from ..exec.aggregate import choose_agg_strategy

            if in_batches or self.conf.get(AGG_STRATEGY) != "AUTO":
                cap_for_choice = (max(b.cap for b in in_batches)
                                  if in_batches else in_cap)
                strat, sreason = choose_agg_strategy(
                    self.conf, cap_for_choice, agg._update_ops,
                    agg._update_exprs, agg._key_dtypes(), self.device)
                report.notes.append(f"agg strategy: {strat} — {sreason}")
            else:
                report.notes.append(
                    "agg strategy: AUTO — resolved per batch capacity at "
                    "run time (input shapes not statically bounded); see "
                    "the 'agg_strategy' event for the actual choice")
        layout = self._agg_result_layout(node, kid, in_cols)
        out_cap = in_cap if grouped else 1
        out_parts: Optional[List[List[BatchState]]] = None
        if exact:
            if nbatches == 0 and grouped:
                out_parts = [[]]
            else:
                out_cols = [
                    dataclasses.replace(cs, name=f.name)
                    for f, cs in zip(node.output_schema.fields, layout)
                ]
                if any(c.is_string and c.char_cap is None
                       for c in out_cols):
                    exact = False
                else:
                    out_parts = [[BatchState(
                        None if grouped else 1, out_cap, out_cols)]]
        report.layout = layout
        report.sites = sites
        report.exact = exact
        report.out_bytes = self._total_bytes(out_parts)
        report.detail = f"(mode=COMPLETE, keys={len(node.group_exprs)})"
        self._note_working(self._total_bytes(in_parts),
                           self._total_bytes(out_parts))
        return _Result(out_parts, layout, report, exact)

    def _agg_result_layout(self, node: C.CpuHashAggregateExec,
                           kid: _Result,
                           in_cols: Optional[List[ColState]]
                           ) -> List[ColState]:
        child_schema = node.children[0].output_schema
        if in_cols is None:
            in_cols = kid.layout
        states = [c.null for c in in_cols]
        grouped = bool(node.group_exprs)
        out: List[ColState] = []
        schema = node.output_schema
        i = 0
        for g in node.group_exprs:
            f = schema.fields[i]
            try:
                b = E.bind_references(g, child_schema)
                cs = self._expr_col_state(b, f.name, in_cols, 0)
                cs.null = expr_nullability(b, states)
            except (ValueError, KeyError):
                cs = ColState(f.name, f.dataType, MAYBE_NULL)
            out.append(cs)
            i += 1
        for ae in node.agg_exprs:
            f = schema.fields[i]
            func = ae.func
            in_state = MAYBE_NULL
            if func.input is not None:
                try:
                    bf = E.bind_references(func.child, child_schema)
                    in_state = expr_nullability(bf, states)
                except (ValueError, KeyError):
                    in_state = MAYBE_NULL
            out.append(ColState(
                f.name, f.dataType,
                agg_nullability(func, in_state, grouped)))
            i += 1
        return out

    # -- sort / limit / union / expand -------------------------------------
    def _sort(self, node: C.CpuSortExec) -> _Result:
        kid = self.analyze(node.children[0])
        self._finalize_chain(kid)
        schema = node.output_schema
        exact = kid.exact
        parts = None
        sites: Dict[str, int] = {}
        notes: List[str] = []
        if node.children[0].num_partitions != 1:
            exact = False
            notes.append("partitioned sort exchanges by range first")
        elif kid.parts is not None:
            batches = [b for p in kid.parts for b in p]
            if len(batches) == 1:
                b = batches[0]
                # string sort keys need the run-time max row length;
                # statically known only when the scan measured it
                ok = True
                try:
                    bound = [E.bind_references(e, schema)
                             for e in node.sort_exprs]
                except (ValueError, KeyError):
                    bound = []
                    ok = False
                for be in bound:
                    if isinstance(be.dtype, (T.StringType, T.BinaryType)):
                        if not (isinstance(be, E.BoundReference)
                                and b.cols[be.ordinal].max_len is not None):
                            ok = False
                if ok and b.sig() is not None:
                    sites["sort"] = 1
                    parts = [[BatchState(b.rows, b.cap, list(b.cols))]]
                else:
                    exact = False
            elif len(batches) == 0:
                parts = [[]]
            else:
                exact = False
                notes.append("multi-batch sort concatenates first")
        layout = self._merge_layout(parts, schema)
        report = OpReport("TpuSortExec", "", layout,
                          self._total_bytes(parts), sites, exact, notes,
                          [kid.report])
        self._note_working(self._total_bytes(kid.parts),
                           self._total_bytes(parts))
        return _Result(parts, layout, report, exact)

    def _limit(self, node) -> _Result:
        kid = self.analyze(node.children[0])
        self._finalize_chain(kid)
        limit = node.limit
        exact = kid.exact
        parts: Optional[List[List[BatchState]]] = None
        is_collect = isinstance(node, C.CpuCollectLimitExec)
        if kid.parts is not None:
            remaining = limit
            out_parts: List[List[BatchState]] = []
            flat = ([b for p in kid.parts for b in p]
                    if is_collect else None)
            groups = [flat] if is_collect else kid.parts
            for p in groups:
                remaining_p = remaining if is_collect else limit
                nb: List[BatchState] = []
                for b in p:
                    if remaining_p <= 0:
                        break
                    if b.rows is None:
                        exact = False
                        break
                    if b.rows <= remaining_p:
                        nb.append(b)
                        remaining_p -= b.rows
                    else:
                        cap = self._bucket(
                            remaining_p, self.conf.shape_bucket_min)
                        nb.append(BatchState(remaining_p, cap,
                                             list(b.cols)))
                        remaining_p = 0
                out_parts.append(nb)
                if is_collect:
                    remaining = remaining_p
            if exact:
                parts = out_parts
        name = ("TpuCollectLimitExec" if is_collect else "TpuLocalLimitExec")
        layout = self._merge_layout(parts, node.output_schema)
        report = OpReport(name, f"[limit={limit}]", layout,
                          self._total_bytes(parts), {}, exact, [],
                          [kid.report])
        return _Result(parts, layout, report, exact)

    def _union(self, node: C.CpuUnionExec) -> _Result:
        kids = [self.analyze(c) for c in node.children]
        for k in kids:
            self._finalize_chain(k)
        exact = all(k.exact for k in kids)
        parts: Optional[List[List[BatchState]]] = []
        for k in kids:
            if k.parts is None:
                parts = None
                exact = False
                break
            parts.extend(k.parts)
        layout = self._merge_layout(parts, node.output_schema)
        report = OpReport("TpuUnionExec", "", layout,
                          self._total_bytes(parts), {}, exact, [],
                          [k.report for k in kids])
        return _Result(parts, layout, report, exact)

    def _expand(self, node: C.CpuExpandExec) -> _Result:
        kid = self.analyze(node.children[0])
        self._finalize_chain(kid)
        child_schema = node.children[0].output_schema
        nproj = len(node.projections)
        exact = kid.exact
        sites: Dict[str, int] = {}
        parts: Optional[List[List[BatchState]]] = None
        names = [f.name for f in node.output_schema.fields]
        try:
            bounds = [
                [E.bind_references(e, child_schema) for e in p]
                for p in node.projections
            ]
        except (ValueError, KeyError):
            bounds = None
            exact = False
        if kid.parts is not None and bounds is not None:
            sigs = self._sigs(kid.parts)
            if sigs is not None:
                sites["project"] = nproj * len(sigs)
            else:
                exact = False
            parts = []
            for p in kid.parts:
                nb = []
                for b in p:
                    for pb in bounds:
                        cols = [
                            self._expr_col_state(be, nm, b.cols, b.cap)
                            for be, nm in zip(pb, names)
                        ]
                        nb.append(BatchState(b.rows, b.cap, cols))
                parts.append(nb)
            self._count_elision(child_schema)
        else:
            exact = False
        layout = self._merge_layout(parts, node.output_schema)
        report = OpReport("TpuExpandExec", f"[{nproj} projections]", layout,
                          self._total_bytes(parts), sites, exact, [],
                          [kid.report])
        return _Result(parts, layout, report, exact)


class _SchemaOnlyExec:
    """Planning stand-in handed to runtime exec constructors so the
    analyzer resolves buffer schemas and fusion eligibility through the
    EXACT code paths the execution engine uses (nothing is executed —
    constructors only bind expressions)."""

    fusable = False

    def __init__(self, conf: RapidsConf, schema: StructType, device):
        self.conf = conf
        self._schema = schema
        self._device = device
        self.children: List = []
        self.metrics: Dict = {}
        self.sections: Dict = {}

    @property
    def device(self):
        return self._device

    @property
    def output_schema(self) -> StructType:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return 1


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def analyze_plan(cpu_plan: C.CpuExec, conf: RapidsConf,
                 meta=None, device=None) -> PlanAnalysis:
    """Analyze a bound CPU physical plan WITHOUT lowering or executing
    anything: tag it (typechecks fallbacks make the plan unbounded), then
    derive layouts, nullability, footprint, and the compile-signature
    forecast. ``meta``: an already-tagged PlanMeta for this plan, when the
    caller ran the tagging pass itself (explain) — saves a second full
    matrix walk. ``device``: the plan's device (``None``: the CUDA card),
    whose type the strategy choosers and fusion gates read and whose
    memory the budget is derived from."""
    from ..columnar import resolve_device

    device = resolve_device(device)
    if meta is None:
        from .overrides import PlanMeta

        meta = PlanMeta(cpu_plan, conf, device=device)
        meta.tag_for_tpu()
    fallbacks = meta.fallback_nodes()

    an = _Analyzer(conf, device)
    root = an.analyze(cpu_plan)
    an._finalize_chain(root)

    bounded = an.exact_all and root.exact and not fallbacks
    warnings: List[str] = []
    if fallbacks:
        warnings.append(
            "plan has CPU fallbacks (%s): analysis is structural only"
            % ", ".join(sorted(set(fallbacks))))

        def clear_sites(r: OpReport):
            # fallen-back subtrees never reach the TPU pipeline caches;
            # rendering their would-be compile counts would be fiction
            r.sites = {}
            for c in r.children:
                clear_sites(c)

        clear_sites(root.report)

    # aggregate per-site and per-exec-name forecasts over the report tree
    site_forecast: Dict[str, int] = {}
    bytes_by_op: Dict[str, int] = {}
    rows_by_op: Dict[str, int] = {}
    batches_by_op: Dict[str, int] = {}

    def walk(r: OpReport):
        for k, v in r.sites.items():
            site_forecast[k] = site_forecast.get(k, 0) + v
        if r.out_bytes is not None:
            bytes_by_op[r.name] = bytes_by_op.get(r.name, 0) + r.out_bytes
        if r.out_rows is not None:
            rows_by_op[r.name] = rows_by_op.get(r.name, 0) + r.out_rows
        if r.out_batches is not None:
            batches_by_op[r.name] = (
                batches_by_op.get(r.name, 0) + r.out_batches)
        for c in r.children:
            walk(c)

    walk(root.report)

    threshold = conf.get(ANALYSIS_STORM_THRESHOLD)
    if bounded:
        for site, count in sorted(site_forecast.items()):
            if count >= threshold:
                warnings.append(
                    f"recompile storm: site {site} expects {count} distinct "
                    f"compile signatures (threshold {threshold}) — the plan "
                    "is shape-polymorphic; align batch capacities or raise "
                    "spark.rapids.tpu.sql.analysis.recompileStorm.threshold")

    peak = None
    if an.scan_resident or an.max_working:
        peak = an.scan_resident + an.max_working
    from ..memory.catalog import derive_hbm_budget

    budget = derive_hbm_budget(conf, device)
    if peak is not None and budget is not None and peak > budget:
        # name the LARGEST capacity in the plan — that is what the peak
        # is made of, not the root's (often tiny) output batch
        cap = an.max_cap
        warnings.append(
            f"predicted peak HBM {_pretty_bytes(peak)} exceeds the "
            f"device budget {_pretty_bytes(budget)} — this plan will "
            f"spill/OOM at capacity {cap}; reduce batch sizes "
            "(sql.reader.batchSizeRows) or raise the budget")

    return PlanAnalysis(
        root=root.report,
        bounded=bounded,
        site_forecast=site_forecast if bounded else {},
        bytes_by_op=bytes_by_op,
        peak_hbm=peak,
        budget=budget,
        warnings=warnings,
        elided_columns=an.elided,
        rows_by_op=rows_by_op,
        batches_by_op=batches_by_op,
    )


def analysis_enabled(conf: RapidsConf) -> bool:
    return conf.get(ANALYSIS_ENABLED)


def parquet_scan_footprint(scanner, schema: StructType) -> Optional[dict]:
    """Footer-derived layout bound of a parquet scan's device-decode
    (unpack) site, shared by the analyzer's ``_model_parquet_scan`` and
    :func:`predict_exec_hbm` (one implementation, so the explain() note
    and the bench denominator can never drift):

      * ``decoded``      — every selected row group's capacity bucket x
        schema row width (+ string chunk pools at uncompressed size),
        the planes the unpack programs must WRITE (and the scan cache
        pins resident);
      * ``upload_total`` — the encoded payloads the unpack programs must
        READ (sum of selected chunks' uncompressed bytes);
      * ``max_upload``/``nrg``/``caps`` — the pipelined reader's
        double-buffer sizing inputs.

    Returns None when the footers are unreadable (missing files, exotic
    formats) — consumers degrade to "no bound" rather than fake one; a
    genuine programming error still raises (the analyzer's call site
    keeps its own never-fail-a-query blanket, bench's does not)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ..utils.bucketing import bucket_rows

    try:
        file_cols = set(getattr(scanner, "columns", ()) or ())
        pcols = set(getattr(scanner, "partition_cols", ()) or ())
        wanted = file_cols - pcols
        fixed_row = 0
        has_strings = False
        for f in schema.fields:
            if f.name in pcols or (wanted and f.name not in wanted):
                continue
            if isinstance(f.dataType, (T.StringType, T.BinaryType)):
                fixed_row += 5  # offsets+validity; chars pool added below
                has_strings = True
            else:
                fixed_row += _storage_bytes(f.dataType) + 1
        decoded = 0
        upload_total = 0
        max_upload = 0
        nrg = 0
        caps: List[int] = []
        pfs: Dict[str, object] = {}
        for s in scanner.splits():
            pf = pfs.get(s.path)
            if pf is None:
                pf = pfs[s.path] = pq.ParquetFile(s.path)
            md = pf.metadata
            for rg in s.row_groups:
                rgmd = md.row_group(rg)
                nrg += 1
                upload = 0
                chars = 0
                for ci in range(rgmd.num_columns):
                    col = rgmd.column(ci)
                    if wanted and col.path_in_schema not in wanted:
                        continue
                    upload += int(col.total_uncompressed_size)
                    if has_strings and col.physical_type == "BYTE_ARRAY":
                        chars += int(col.total_uncompressed_size)
                cap = bucket_rows(max(1, rgmd.num_rows))
                caps.append(cap)
                decoded += cap * fixed_row + chars
                upload_total += upload
                max_upload = max(max_upload, upload)
    except (OSError, ValueError, KeyError, pa.lib.ArrowException):
        return None  # missing files, exotic footers: no bound
    if not nrg:
        return None
    return {"decoded": decoded, "upload_total": upload_total,
            "max_upload": max_upload, "nrg": nrg, "caps": caps}


def predict_exec_hbm(exec_) -> Optional[int]:
    """Forecast the device bytes a LIVE TpuExec tree will touch: resident
    source batches plus each operator's output-layout bound (twice the
    sources). Parquet file scans bound through
    :func:`parquet_scan_footprint` (uploaded payloads + decoded planes,
    the unpack site's layout bound). None when a source is not
    bounded."""
    from ..exec.base import TpuExec, batch_bytes
    from ..exec.scan import TpuFileSourceScanExec

    if not isinstance(exec_, TpuExec):
        return None
    total = 0

    def walk(node) -> bool:
        nonlocal total
        parts = getattr(node, "_partitions", None)
        if parts is not None:  # in-memory source: batches are resident
            for p in parts:
                for b in p:
                    total += batch_bytes(b)
            return True
        if isinstance(node, TpuFileSourceScanExec):
            if getattr(node, "fmt", None) != "parquet":
                return False
            fp = parquet_scan_footprint(node.scanner, node.output_schema)
            if fp is None:
                return False
            total += fp["upload_total"] + fp["decoded"]
            return True
        ok = True
        for c in node.children:
            ok = walk(c) and ok
        # each operator streams roughly its input once more as output;
        # without static layouts here, reuse the child bound
        return ok

    ok = walk(exec_)
    return total * 2 if ok and total else None


# ---------------------------------------------------------------------------
# Per-shard mesh forecasts: what a mesh stage will stage, per shard,
# BEFORE it runs — derived by calling the runtime exec's OWN sizing
# helpers (exec/mesh.forecast_mesh_staging wraps io/mesh_stage.
# mesh_shard_cap / shard_plane_bytes, the exact code the staging paths
# execute), so forecast and actual share one implementation and the
# cross-check below can demand EQUALITY, not just bounds.
# ---------------------------------------------------------------------------
def _mesh_stages_of(exec_) -> List:
    """Mesh stages in a live plan, traversing both TpuExec ``children``
    and the row-boundary ``tpu_child`` link (session roots are
    ColumnarToRowExec)."""
    from ..exec.mesh import _MeshStage

    stages: List = []

    def walk(node) -> None:
        if isinstance(node, _MeshStage):
            stages.append(node)
        tc = getattr(node, "tpu_child", None)
        if tc is not None:
            walk(tc)
        for c in getattr(node, "children", ()):
            walk(c)

    walk(exec_)
    return stages


def forecast_mesh(exec_) -> Optional[dict]:
    """Per-shard forecast for every mesh stage in a LIVE TpuExec tree:
    staging layout (common per-shard capacity, per-shard rows after the
    round-robin placement, staged plane bytes), the stage's site with
    ``programs_bound`` None (nothing is compiled), and a static per-shard
    device-memory lower bound (staged planes + output surface).
    None when the plan has no mesh stages. Sources whose row counts are
    not statically known (csv scans) yield ``staging: None`` — reported,
    not cross-checked."""
    stages = _mesh_stages_of(exec_)
    if not stages:
        return None
    out = []
    for st in stages:
        entry: Dict[str, Any] = {
            "op": st.node_name,
            "site": st.mesh_site,
            "n_shards": st.n_shards,
        }
        caps = []
        if len(st.children) == 1:
            s = st.forecast_mesh_staging(st.children[0])
            entry["staging"] = s
            if s:
                caps.append(s["cap"])
        else:
            for which, child in zip(("left", "right"), st.children):
                s = st.forecast_mesh_staging(child)
                entry[f"staging_{which}"] = s
                if s:
                    caps.append(s["cap"])
        # the reference bounds the compiled programs (1 + the capacity
        # overflow retries); eager PyTorch compiles none
        entry["programs_bound"] = None
        # static per-shard HBM lower bound: the staged input planes must
        # be resident while the program runs; outputs add one more
        # surface of the same shape (XLA temporaries are the compiler's
        # business and not bounded here)
        staged = [
            v for k, v in entry.items()
            if k.startswith("staging") and v and v.get("staged_bytes")
        ]
        if staged:
            entry["peak_hbm_per_shard_lower"] = sum(
                s["staged_bytes"][0] for s in staged) * 2
        out.append(entry)
    return {"n_stages": len(out), "stages": out}


def cross_check_mesh(exec_) -> List[str]:
    """Diff every mesh stage's recorded actuals (exec/mesh
    ``mesh_actuals``: staging cap/rows/bytes/source, compiled program
    count) against :func:`forecast_mesh`. Returns violation strings —
    empty means the per-shard forecast held exactly. Staging entries the
    forecast could not bound (``staging: None``) are skipped; a stage
    that never materialized has no actuals and is skipped too."""
    fc = forecast_mesh(exec_)
    if fc is None:
        return []
    stages = _mesh_stages_of(exec_)
    bad: List[str] = []
    for st, entry in zip(stages, fc["stages"]):
        actual = st.mesh_actuals
        if not actual:
            continue
        pairs = []
        if "staging" in entry:
            pairs.append((entry["staging"], actual.get("staging"), ""))
        else:
            pairs.append((entry.get("staging_left"),
                          actual.get("staging_left"), "left"))
            pairs.append((entry.get("staging_right"),
                          actual.get("staging_right"), "right"))
        name = entry["op"]
        for fcast, act, which in pairs:
            if fcast is None or act is None:
                continue
            tag = f"{name}{('.' + which) if which else ''}"
            if fcast["cap"] != act["cap"]:
                bad.append(f"{tag}: staged cap {act['cap']} != "
                           f"forecast {fcast['cap']}")
            if list(fcast["per_shard_rows"]) != list(act["per_shard_rows"]):
                bad.append(f"{tag}: per-shard rows {act['per_shard_rows']}"
                           f" != forecast {fcast['per_shard_rows']}")
            if fcast.get("staged_bytes") is not None and \
                    list(fcast["staged_bytes"]) != list(act["staged_bytes"]):
                bad.append(f"{tag}: staged bytes {act['staged_bytes']} != "
                           f"forecast {fcast['staged_bytes']}")
            if fcast["source"] != act.get("source"):
                bad.append(f"{tag}: staging source {act.get('source')} != "
                           f"forecast {fcast['source']}")
        bound = entry.get("programs_bound")
        progs = actual.get("programs", 0)
        if bound is not None and progs > bound:
            bad.append(f"{name}: {progs} compiled program(s) > "
                       f"forecast bound {bound}")
    return bad
