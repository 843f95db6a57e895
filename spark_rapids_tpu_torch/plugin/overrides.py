"""The override/tagging pass: CPU physical plan -> mixed CPU/device plan.

Own copy of ``spark_rapids_tpu/plugin/overrides.py``: the same expression
and exec rules, ``PlanMeta`` tagging, ``explain_plan`` and
``TpuOverrides.apply``, so the port falls back for the reference's
reasons, word for word. Expression support comes from the static type
matrix (``plugin/typechecks.py``); the lowering probe
(``expr/eval.tpu_supports``) runs wherever the matrix accepts an
expression, so that a node, type or layer the port has not ported raises
``NotImplementedError`` while the plan is tagged (never a fallback the
reference would not make).

Converted on the device: the in-memory scan, the file scan, range,
project, filter, union, both limits, expand (and explode through it),
the aggregate, the sort, the window and the equi-join. Over a child of
more than one partition they take the reference's single-process
routes (``exec/exchange.py``): partial -> hash (or single) exchange ->
adaptive read -> final aggregate; range (or single) exchange -> local
sort; a broadcast hash join under ``autoBroadcastJoinThreshold``, else
co-partitioning hash exchanges with the adaptive join pair; a window
over every partition gathered. Under ``spark.rapids.tpu.shuffle.mode=
ici``, or ``auto`` with more than one device visible, they take the
reference's mesh routes instead (``exec/mesh.py``): the mesh aggregate,
sort, inner equi-join and window, each at the reference's place and
with its fallbacks. A join without keys reads its build side through a
broadcast exchange into the nested-loop join, or the cartesian product
when it has no condition.

Device rule: the plan's device (``None``: the CUDA card) is threaded to
every leaf the pass builds: the in-memory scan, the file scan and the
``RowToColumnarExec`` boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

from .. import types as T
from ..conf import (
    EXPLAIN,
    MATRIX_PROBE_CROSS_CHECK,
    RapidsConf,
    SQL_ENABLED,
    TEST_ALLOWED_NONTPU,
    TEST_CONF,
)
from ..columnar import resolve_device
from ..cpu import plan as C
from ..exec import aggregate as XA
from ..exec import basic as XB
from ..exec.base import TpuExec
from ..exec.transitions import (
    ColumnarToRowExec,
    RowToColumnarExec,
)
from ..expr import aggregates as A
from ..expr import expressions as E
from ..expr.eval import tpu_supports
from ..types import StructType


# ---------------------------------------------------------------------------
# Expression rules (reference: GpuOverrides.scala:661-2124, 144 rules)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ExprRule:
    name: str
    description: str


EXPRESSION_RULES: Dict[Type[E.Expression], ExprRule] = {}


def _expr_rule(cls: Type[E.Expression], name: str, desc: str) -> None:
    EXPRESSION_RULES[cls] = ExprRule(name, desc)


for _cls, _name, _desc in [
    (E.Literal, "Literal", "holds a static value"),
    (E.UnresolvedAttribute, "AttributeReference", "references an input column"),
    (E.BoundReference, "BoundReference", "bound input column"),
    (E.Alias, "Alias", "gives a column a name"),
    (E.Add, "Add", "addition"),
    (E.Subtract, "Subtract", "subtraction"),
    (E.Multiply, "Multiply", "multiplication"),
    (E.Divide, "Divide", "division"),
    (E.IntegralDivide, "IntegralDivide", "division with integer result"),
    (E.Remainder, "Remainder", "remainder (%)"),
    (E.Pmod, "Pmod", "positive modulo"),
    (E.UnaryMinus, "UnaryMinus", "negation"),
    (E.UnaryPositive, "UnaryPositive", "identity +"),
    (E.Abs, "Abs", "absolute value"),
    (E.EqualTo, "EqualTo", "equality"),
    (E.EqualNullSafe, "EqualNullSafe", "null-safe equality (<=>)"),
    (E.LessThan, "LessThan", "< comparison"),
    (E.LessThanOrEqual, "LessThanOrEqual", "<= comparison"),
    (E.GreaterThan, "GreaterThan", "> comparison"),
    (E.GreaterThanOrEqual, "GreaterThanOrEqual", ">= comparison"),
    (E.In, "In", "IN list membership"),
    (E.And, "And", "logical AND (3-valued)"),
    (E.Or, "Or", "logical OR (3-valued)"),
    (E.Not, "Not", "logical NOT"),
    (E.IsNull, "IsNull", "null check"),
    (E.IsNotNull, "IsNotNull", "non-null check"),
    (E.IsNan, "IsNan", "NaN check"),
    (E.Coalesce, "Coalesce", "first non-null"),
    (E.NaNvl, "NaNvl", "NaN replacement"),
    (E.If, "If", "if/then/else"),
    (E.CaseWhen, "CaseWhen", "CASE WHEN"),
    (E.Cast, "Cast", "type cast"),
    (E.Sqrt, "Sqrt", "square root"),
    (E.Exp, "Exp", "e^x"),
    (E.Log, "Log", "natural log"),
    (E.Log10, "Log10", "log base 10"),
    (E.Log2, "Log2", "log base 2"),
    (E.Log1p, "Log1p", "log(1+x)"),
    (E.Expm1, "Expm1", "e^x - 1"),
    (E.Sin, "Sin", "sine"),
    (E.Cos, "Cos", "cosine"),
    (E.Tan, "Tan", "tangent"),
    (E.Asin, "Asin", "arcsine"),
    (E.Acos, "Acos", "arccosine"),
    (E.Atan, "Atan", "arctangent"),
    (E.Sinh, "Sinh", "hyperbolic sine"),
    (E.Cosh, "Cosh", "hyperbolic cosine"),
    (E.Tanh, "Tanh", "hyperbolic tangent"),
    (E.Cbrt, "Cbrt", "cube root"),
    (E.ToDegrees, "ToDegrees", "radians to degrees"),
    (E.ToRadians, "ToRadians", "degrees to radians"),
    (E.Floor, "Floor", "floor"),
    (E.Ceil, "Ceil", "ceiling"),
    (E.Round, "Round", "HALF_UP rounding"),
    (E.Rint, "Rint", "round to even"),
    (E.Pow, "Pow", "power"),
    (E.Atan2, "Atan2", "two-argument arctangent"),
    (E.Signum, "Signum", "sign"),
    (E.BitwiseAnd, "BitwiseAnd", "bitwise AND"),
    (E.BitwiseOr, "BitwiseOr", "bitwise OR"),
    (E.BitwiseXor, "BitwiseXor", "bitwise XOR"),
    (E.BitwiseNot, "BitwiseNot", "bitwise NOT"),
    (E.ShiftLeft, "ShiftLeft", "shift left"),
    (E.ShiftRight, "ShiftRight", "shift right"),
    (E.ShiftRightUnsigned, "ShiftRightUnsigned", "unsigned shift right"),
    (E.Length, "Length", "string character length"),
    (E.Upper, "Upper", "uppercase conversion"),
    (E.Lower, "Lower", "lowercase conversion"),
    (E.InitCap, "InitCap", "capitalize each word"),
    (E.Substring, "Substring", "substring by character position"),
    (E.Concat, "Concat", "string concatenation"),
    (E.StringTrim, "StringTrim", "trim both ends"),
    (E.StringTrimLeft, "StringTrimLeft", "trim leading chars"),
    (E.StringTrimRight, "StringTrimRight", "trim trailing chars"),
    (E.StartsWith, "StartsWith", "prefix test"),
    (E.EndsWith, "EndsWith", "suffix test"),
    (E.Contains, "Contains", "substring containment test"),
    (E.Like, "Like", "SQL LIKE pattern match"),
    (E.RLike, "RLike", "regex match via compiled byte DFA"),
    (E.RegExpReplace, "RegExpReplace",
     "regex replace (literal-equivalent patterns)"),
    (E.StringLocate, "StringLocate", "substring position (1-based)"),
    (E.StringReplace, "StringReplace", "replace all occurrences"),
    (E.StringLPad, "StringLPad", "left-pad to length"),
    (E.StringRPad, "StringRPad", "right-pad to length"),
    (E.SubstringIndex, "SubstringIndex", "substring before/after delimiter"),
    (E.StringSplitPart, "StringSplit", "split on delimiter + index"),
    (E.Year, "Year", "year of date/timestamp"),
    (E.Quarter, "Quarter", "quarter of year"),
    (E.Month, "Month", "month of date/timestamp"),
    (E.DayOfMonth, "DayOfMonth", "day of month"),
    (E.DayOfYear, "DayOfYear", "day of year"),
    (E.DayOfWeek, "DayOfWeek", "day of week (1=Sunday)"),
    (E.WeekDay, "WeekDay", "day of week (0=Monday)"),
    (E.Hour, "Hour", "hour of timestamp (UTC)"),
    (E.Minute, "Minute", "minute of timestamp (UTC)"),
    (E.Second, "Second", "second of timestamp (UTC)"),
    (E.DateAdd, "DateAdd", "add days to date"),
    (E.DateSub, "DateSub", "subtract days from date"),
    (E.DateDiff, "DateDiff", "days between dates"),
    (E.LastDay, "LastDay", "last day of month"),
    (E.UnixTimestamp, "UnixTimestamp", "seconds since epoch"),
    (E.ToUnixTimestamp, "ToUnixTimestamp", "seconds since epoch"),
    (E.FromUnixTime, "FromUnixTime", "format seconds since epoch"),
    (E.TimeAdd, "TimeAdd", "timestamp + interval"),
    (E.TruncDate, "TruncDate", "truncate date to unit"),
    (A.AggregateExpression, "AggregateExpression", "aggregate holder"),
    (A.Count, "Count", "count aggregate"),
    (A.Sum, "Sum", "sum aggregate"),
    (A.Min, "Min", "min aggregate"),
    (A.Max, "Max", "max aggregate"),
    (A.Average, "Average", "average aggregate"),
    (A.First, "First", "first value aggregate"),
    (A.Last, "Last", "last value aggregate"),
]:
    _expr_rule(_cls, _name, _desc)

from ..expr import windows as _W  # noqa: E402

for _cls, _name, _desc in [
    (_W.WindowExpression, "WindowExpression", "function over a window spec"),
    (_W.RowNumber, "RowNumber", "row number within partition"),
    (_W.Rank, "Rank", "rank with gaps"),
    (_W.DenseRank, "DenseRank", "rank without gaps"),
    (_W.Lead, "Lead", "value of a following row"),
    (_W.Lag, "Lag", "value of a preceding row"),
]:
    _expr_rule(_cls, _name, _desc)

# nondeterministic / metadata family (reference:
# GpuRandomExpressions.scala:31, GpuMonotonicallyIncreasingID.scala,
# GpuSparkPartitionID.scala, GpuInputFileBlock.scala, HashFunctions.scala:43)
for _cls, _name, _desc in [
    (E.Rand, "Rand", "uniform random in [0,1), deterministic per seed"),
    (E.MonotonicallyIncreasingID, "MonotonicallyIncreasingID",
     "unique id: (partition << 33) + row"),
    (E.SparkPartitionID, "SparkPartitionID", "current partition index"),
    (E.InputFileName, "InputFileName", "path of the file being scanned"),
    (E.Murmur3Hash, "Murmur3Hash", "Spark murmur3_32 hash of columns"),
    # reference: RapidsUDF.java — a user columnar function traced into
    # the fused projection; supportability is value-level (the trace),
    # so its matrix tag hook IS the probe
    (E.NativeUDF, "NativeUDF", "user columnar UDF"),
]:
    _expr_rule(_cls, _name, _desc)


def _check_type(dt: T.DataType, conf: RapidsConf) -> Optional[str]:
    """Allowed-type matrix (reference: isSupportedType GpuOverrides.scala:531)."""
    from .typechecks import decimal_reason

    if isinstance(dt, (T.ArrayType, T.StructType)):
        return f"type {dt.simpleString} is not supported on TPU"
    if isinstance(dt, T.DecimalType):
        return decimal_reason(dt, conf)
    return None


_CONTEXT_EXPR_REASON = (
    "nondeterministic/metadata expressions (rand, "
    "monotonically_increasing_id, spark_partition_id, "
    "input_file_name, hash over strings) only run on TPU "
    "inside a projection"
)


def check_expression(
    expr: E.Expression, schema: StructType, conf: RapidsConf,
    allow_context: bool = False, context: Optional[str] = None,
) -> List[str]:
    """All the reasons this expression can't lower; empty = supported.

    The verdict comes from the STATIC type matrix (plugin/typechecks.py):
    nothing is traced. ``allow_context``: True only where the exec
    evaluates partition-context expressions at its boundary (the project;
    reference: Spark pins nondeterministic expressions into their own
    Project) — anywhere else rand()/ids/input_file_name must tag the
    plan off. ``context`` defaults to the project context."""
    from . import typechecks as TC

    if context is None:
        context = TC.PROJECT
    reasons: List[str] = []
    if (E.has_context_expr(expr) or _has_string_hash(expr, schema)) \
            and not allow_context:
        reasons.append(_CONTEXT_EXPR_REASON)
    if not reasons:
        try:
            bound = E.bind_references(expr, schema)
        except (ValueError, KeyError) as e:
            reasons.append(str(e))
        else:
            reasons.extend(TC.check_expr(bound, conf, context))
            try:
                err = _check_type(bound.dtype, conf)
                if err:
                    reasons.append(err)
            except Exception:  # noqa: BLE001
                pass  # already reported by the matrix walk
    if conf.get(MATRIX_PROBE_CROSS_CHECK):
        # the debug cross-check (reference ``overrides.py:271-291``): the
        # lowering probe's verdict beside the matrix's; a probe that
        # raised is a probe fallback
        unported = False
        try:
            legacy = _probe_check_expression(
                expr, schema, conf, allow_context)
        except Exception as e:  # noqa: BLE001 — probe crash = fallback
            legacy = [f"lowering probe raised: {e}"]
            unported = isinstance(e, NotImplementedError)
        if bool(legacy) != bool(reasons):
            TC.note_cross_check_disagreement(
                f"{type(expr).__name__}: matrix="
                f"{'FALLBACK' if reasons else 'ON_TPU'}"
                f"({'; '.join(reasons) or '-'}) probe="
                f"{'FALLBACK' if legacy else 'ON_TPU'}"
                f"({'; '.join(legacy) or '-'})")
            if legacy and not reasons and not unported:
                # conservative: a probe-detected lowering gap falls back
                # even where the matrix accepts (then fix the matrix); a
                # node the port has not ported is no fallback: the probe
                # below raises it
                reasons.extend(legacy)
    if not reasons and not isinstance(
            expr, (A.AggregateExpression, A.AggregateFunction)):
        # the matrix accepts it, so the reference lowers it on its
        # device: the port must lower it too. A node, type or layer the
        # port lacks raises NotImplementedError here (tpu_supports lets
        # it through), never a fallback. Context expressions evaluate at
        # the project's boundary, not in eval.py: they are probed as
        # typed placeholders (reference ``overrides.py:321-333``).
        tpu_supports(_context_placeholders(expr, schema), schema)
    return reasons


def _probe_check_expression(
    expr: E.Expression, schema: StructType, conf: RapidsConf,
    allow_context: bool = False,
) -> List[str]:
    """The lowering probe's verdict (reference ``overrides.py:294``): every
    node has a rule, and the port's lowering (``expr/eval.tpu_supports``)
    takes the expression, context nodes probed as typed placeholders.
    Only the ``probeCrossCheck`` debug path runs it; the type matrix is
    the tagging mechanism."""
    reasons: List[str] = []

    def visit(node: E.Expression):
        if type(node) not in EXPRESSION_RULES:
            reasons.append(
                f"expression {type(node).__name__} is not supported on TPU"
            )
        for c in node.children:
            visit(c)

    visit(expr)
    if reasons:
        return reasons
    if (E.has_context_expr(expr) or _has_string_hash(expr, schema)) \
            and not allow_context:
        return [_CONTEXT_EXPR_REASON]
    if not isinstance(expr, (A.AggregateExpression, A.AggregateFunction)):
        ok, why = tpu_supports(_context_placeholders(expr, schema), schema)
        if not ok:
            reasons.append(why or "lowering probe failed")
        else:
            try:
                bound = E.bind_references(expr, schema)
                err = _check_type(bound.dtype, conf)
                if err:
                    reasons.append(err)
                reasons.extend(_gated_cast_reasons(bound, conf))
            except (TypeError, ValueError, KeyError) as e:
                reasons.append(str(e))
    return reasons


def _gated_cast_reasons(bound: E.Expression, conf: RapidsConf) -> List[str]:
    """The conf gates of the casts in ``bound``, as the cast matrix
    (``typechecks.CastChecks``) holds them."""
    from .typechecks import CAST_CHECKS

    reasons: List[str] = []

    def visit(node: E.Expression):
        if isinstance(node, E.Cast):
            r = CAST_CHECKS.gate_reason(node.child.dtype, node.to, conf)
            if r:
                reasons.append(r)
        for c in node.children:
            visit(c)

    visit(bound)
    return reasons


def _context_placeholders(expr: E.Expression,
                          schema: StructType) -> E.Expression:
    """``expr`` with each partition-context node (and each hash over
    strings) replaced by a literal of its type."""
    if not (E.has_context_expr(expr) or _has_string_hash(expr, schema)):
        return expr

    def placeholder(node):
        if isinstance(node, E.NONDETERMINISTIC_CONTEXT_EXPRS) or (
                isinstance(node, E.Murmur3Hash)
                and _has_string_hash(node, schema)):
            zero = {T.DOUBLE: 0.0, T.LONG: 0, T.INT: 0,
                    T.STRING: ""}.get(node.dtype, 0)
            return E.Literal(zero, node.dtype)
        return node

    return expr.transform(placeholder)


def check_aggregate(
    ae: A.AggregateExpression, schema: StructType, conf: RapidsConf,
    context: Optional[str] = None,
) -> List[str]:
    """Matrix verdict for one aggregate: the function's own cell in the
    aggregation (or window) context, plus its input expression checked as
    the projection it evaluates in."""
    from . import typechecks as TC

    context = context or TC.AGGREGATION
    reasons: List[str] = []
    f = ae.func
    if type(f) not in EXPRESSION_RULES:
        reasons.append(f"aggregate {type(f).__name__} is not supported on TPU")
        return reasons
    if f.input is not None:
        try:
            bound_f = E.bind_references(f, schema)
        except (ValueError, KeyError) as e:
            return [str(e)]
        reasons.extend(TC.check_node(bound_f, conf, context))
        if not reasons:
            reasons.extend(check_expression(f.child, schema, conf))
    else:
        reasons.extend(TC.check_node(f, conf, context))
    return reasons


# ---------------------------------------------------------------------------
# Exec rules (reference: commonExecs GpuOverrides.scala:2243-2492)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ExecRule:
    name: str
    description: str
    tag: Callable[["PlanMeta"], None]
    #: (cpu exec, conf, converted children, device) -> device exec
    convert: Callable[..., TpuExec]


EXEC_RULES: Dict[Type[C.CpuExec], ExecRule] = {}


def _exec_rule(cls, name, desc, tag, convert):
    EXEC_RULES[cls] = ExecRule(name, desc, tag, convert)


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error of a conversion the reference makes and the port cannot
    yet, naming the ROADMAP.md item that brings it."""
    return NotImplementedError(
        f"{what} is not ported yet: see ROADMAP.md, queue A item '{item}'")


def _tag_output_types(meta: "PlanMeta") -> None:
    for f in meta.wrapped.output_schema.fields:
        err = _check_type(f.dataType, meta.conf)
        if err:
            meta.will_not_work(f"column {f.name}: {err}")


def _tag_scan(meta: "PlanMeta") -> None:
    _tag_output_types(meta)


def _convert_scan(cpu: C.CpuScanExec, conf, children, device):
    """In-memory rows -> one uploaded batch per non-empty partition
    (reference ``overrides.py:439-451``)."""
    from ..columnar.batch import batch_from_rows

    parts = []
    for i in range(cpu.num_partitions):
        rows = list(cpu.execute_rows_partition(i))
        parts.append([batch_from_rows(rows, cpu.output_schema, device)]
                     if rows else [])
    return XB.InMemoryScanExec(conf, parts, cpu.output_schema, device)


def _tag_file_scan(meta: "PlanMeta") -> None:
    cpu: C.CpuFileScanExec = meta.wrapped  # type: ignore[assignment]
    from ..conf import CSV_ENABLED, ORC_ENABLED, PARQUET_ENABLED

    gate = {
        "parquet": (PARQUET_ENABLED, "spark.rapids.tpu.sql.format.parquet.enabled"),
        "csv": (CSV_ENABLED, "spark.rapids.tpu.sql.format.csv.enabled"),
        "orc": (ORC_ENABLED, "spark.rapids.tpu.sql.format.orc.enabled"),
    }.get(cpu.fmt)
    if gate is not None and not meta.conf.get(gate[0]):
        meta.will_not_work(
            f"{cpu.fmt} scan is disabled by {gate[1]}")
    _tag_output_types(meta)


def _convert_file_scan(cpu: "C.CpuFileScanExec", conf, children, device):
    from ..exec.scan import TpuFileSourceScanExec

    return TpuFileSourceScanExec(conf, cpu.scanner, cpu.fmt, device)


def _has_string_hash(e: E.Expression, schema: StructType) -> bool:
    """hash() with a string input (expr may be unbound: bind to type)."""
    if isinstance(e, E.Murmur3Hash):
        for c in e.exprs:
            try:
                b = E.bind_references(c, schema)
            except (ValueError, KeyError):
                return True  # unresolvable: treat as context, tag later
            if isinstance(b.dtype, T.StringType):
                return True
    return any(_has_string_hash(c, schema) for c in e.children)


def _tag_project(meta: "PlanMeta") -> None:
    cpu: C.CpuProjectExec = meta.wrapped  # type: ignore[assignment]
    schema = cpu.children[0].output_schema
    for e in cpu.exprs:
        for r in check_expression(e, schema, meta.conf, allow_context=True):
            meta.will_not_work(r)
    _tag_output_types(meta)


def _convert_project(cpu: C.CpuProjectExec, conf, children, device):
    return XB.TpuProjectExec(conf, cpu.exprs, children[0])


def _tag_filter(meta: "PlanMeta") -> None:
    cpu: C.CpuFilterExec = meta.wrapped  # type: ignore[assignment]
    schema = cpu.children[0].output_schema
    for r in check_expression(cpu.condition, schema, meta.conf):
        meta.will_not_work(r)


def _convert_filter(cpu: C.CpuFilterExec, conf, children, device):
    return XB.TpuFilterExec(conf, cpu.condition, children[0])


def _tag_range(meta: "PlanMeta") -> None:
    pass


def _convert_range(cpu: C.CpuRangeExec, conf, children, device):
    return XB.TpuRangeExec(conf, cpu.start, cpu.end, cpu.step, cpu.num_slices,
                           cpu.output_schema.fields[0].name, device)


def _tag_union(meta: "PlanMeta") -> None:
    _tag_output_types(meta)


def _convert_union(cpu: C.CpuUnionExec, conf, children, device):
    return XB.TpuUnionExec(conf, children)


def _tag_limit(meta: "PlanMeta") -> None:
    pass


def _convert_limit(cpu: C.CpuLocalLimitExec, conf, children, device):
    return XB.TpuLocalLimitExec(conf, cpu.limit, children[0])


def _convert_collect_limit(cpu: "C.CpuCollectLimitExec", conf, children,
                           device):
    return XB.TpuCollectLimitExec(conf, cpu.limit, children[0])


def _tag_expand(meta: "PlanMeta") -> None:
    cpu: C.CpuExpandExec = meta.wrapped  # type: ignore[assignment]
    schema = cpu.children[0].output_schema
    for p in cpu.projections:
        for e in p:
            for r in check_expression(e, schema, meta.conf):
                meta.will_not_work(r)


def _convert_expand(cpu: C.CpuExpandExec, conf, children, device):
    return XB.TpuExpandExec(
        conf, cpu.projections, [f.name for f in cpu.output_schema.fields],
        children[0],
    )


def _tag_aggregate(meta: "PlanMeta") -> None:
    cpu: C.CpuHashAggregateExec = meta.wrapped  # type: ignore[assignment]
    schema = cpu.children[0].output_schema
    for g in cpu.group_exprs:
        for r in check_expression(g, schema, meta.conf):
            meta.will_not_work(r)
    for ae in cpu.agg_exprs:
        for r in check_aggregate(ae, schema, meta.conf):
            meta.will_not_work(r)
    _tag_output_types(meta)


def _shuffle_partitions(conf, child) -> int:
    from ..conf import SHUFFLE_PARTITIONS

    n = conf.get(SHUFFLE_PARTITIONS)
    return n if n > 0 else child.num_partitions


def _mesh_eligible(conf, device, *schemas) -> bool:
    """True when the exchange-bounded stage lowers to the mesh stages
    (``exec/mesh.py``; reference ``overrides.py:575``): the mesh is
    available to a plan on ``device`` and every column is fixed-width or
    a string (strings cross the collective as a second byte plane;
    binary stays on the single-process exchange)."""
    from ..exec.mesh import mesh_available

    return mesh_available(conf, device) and all(
        T.is_fixed_width(f.dataType) or isinstance(f.dataType, T.StringType)
        for s in schemas for f in s.fields)


def _convert_aggregate(cpu: C.CpuHashAggregateExec, conf, children, device):
    child = children[0]
    if child.num_partitions == 1:
        return XA.TpuHashAggregateExec(
            conf, cpu.group_exprs, cpu.agg_exprs, child, A.COMPLETE)

    def _string_agg_input() -> bool:
        for ae in cpu.agg_exprs:
            f = ae.func
            if f.input is None:
                continue
            try:
                b = E.bind_references(f.child, child.output_schema)
            except (ValueError, KeyError):
                return True
            if isinstance(b.dtype, (T.StringType, T.BinaryType)):
                return True
        return False

    # the mesh route: partial -> exchange -> final over the shards. String
    # AGGREGATE inputs (min/max over strings) stay on the exchange path
    if cpu.group_exprs and _mesh_eligible(conf, device, child.output_schema) \
            and not _string_agg_input():
        try:
            bound_keys = [E.bind_references(g, child.output_schema)
                          for g in cpu.group_exprs]
        except (ValueError, KeyError):
            bound_keys = None
        # string group keys need the staged source column's byte bound,
        # so they must be DIRECT column references; computed string keys
        # stay on the single-process exchange
        if bound_keys is not None and all(
                T.is_fixed_width(b.dtype)
                or (T.is_string(b.dtype) and isinstance(b, E.BoundReference))
                for b in bound_keys):
            from ..exec.mesh import TpuMeshAggregateExec

            return TpuMeshAggregateExec(conf, cpu.group_exprs,
                                        cpu.agg_exprs, child)
    # partial per partition -> key-hash exchange -> final merge per reduce
    # partition (reference overrides.py:631-659): group keys are
    # partition-disjoint after the hash exchange
    from ..exec.exchange import TpuLazyAQEReadExec, TpuShuffleExchangeExec
    from ..shuffle.partition import HashPartitioning, SinglePartitioning
    from ..conf import AQE_ENABLED

    partial = XA.TpuHashAggregateExec(
        conf, cpu.group_exprs, cpu.agg_exprs, child, A.PARTIAL)
    nk = len(cpu.group_exprs)
    if nk == 0:
        part = SinglePartitioning()
    else:
        part = HashPartitioning(list(range(nk)),
                                _shuffle_partitions(conf, child))
    exchanged = TpuShuffleExchangeExec(conf, partial, part)
    final_child: TpuExec = exchanged
    if conf.get(AQE_ENABLED) and nk > 0:
        # the coalesce plan needs the map side's stats: planned on first
        # touch
        final_child = TpuLazyAQEReadExec(conf, exchanged)
    return XA.TpuHashAggregateExec(
        conf, cpu.group_exprs, cpu.agg_exprs, final_child, A.FINAL)


def _sortable(dt: T.DataType) -> bool:
    """The reference's sortable types: fixed width (dates, timestamps
    and decimals included), strings and binary."""
    return not isinstance(dt, (T.ArrayType, T.StructType, T.NullType))


def _tag_sort(meta: "PlanMeta") -> None:
    cpu: C.CpuSortExec = meta.wrapped  # type: ignore[assignment]
    schema = cpu.children[0].output_schema
    for e in cpu.sort_exprs:
        for r in check_expression(e, schema, meta.conf):
            meta.will_not_work(r)
        try:
            b = E.bind_references(e, schema)
            if not _sortable(b.dtype):
                meta.will_not_work(
                    f"sort key type {b.dtype.simpleString} is not sortable on TPU")
        except (ValueError, KeyError) as ex:
            meta.will_not_work(str(ex))
    _tag_output_types(meta)


def _convert_sort(cpu: C.CpuSortExec, conf, children, device):
    from ..exec.exchange import TpuShuffleExchangeExec
    from ..exec.sort import TpuSortExec
    from ..ops.sort import SortOrder
    from ..shuffle.partition import RangePartitioning, SinglePartitioning

    child = children[0]
    if child.num_partitions == 1:
        return TpuSortExec(conf, cpu.sort_exprs, cpu.orders, child)
    # a global sort over a partitioned child: range-exchange so that the
    # partitions are in key order, then sort each locally (reference
    # overrides.py:676-722)
    schema = child.output_schema
    try:
        bound = [E.bind_references(e, schema) for e in cpu.sort_exprs]
    except (ValueError, KeyError):
        bound = []
    refs = bool(bound) and all(isinstance(b, E.BoundReference)
                               for b in bound)
    P = _shuffle_partitions(conf, child)
    if refs and _mesh_eligible(conf, device, schema):
        # local sort -> sampled range exchange -> merge sort over the mesh
        from ..exec.mesh import TpuMeshSortExec

        return TpuMeshSortExec(conf, [b.ordinal for b in bound], cpu.orders,
                               child)
    if refs and P > 1:
        part = RangePartitioning([b.ordinal for b in bound],
                                 [SortOrder(a, nf) for a, nf in cpu.orders],
                                 P)
    else:
        part = SinglePartitioning()
    exchanged = TpuShuffleExchangeExec(conf, child, part)
    return TpuSortExec(conf, cpu.sort_exprs, cpu.orders, exchanged,
                       global_sort=False)


def _tag_join(meta: "PlanMeta") -> None:
    cpu: C.CpuJoinExec = meta.wrapped  # type: ignore[assignment]
    ls = cpu.children[0].output_schema
    rs = cpu.children[1].output_schema
    if not cpu.left_keys:
        if cpu.join_type != "inner":
            meta.will_not_work(
                f"non-equi {cpu.join_type} joins are not supported on TPU")
    for k, schema in [(k, ls) for k in cpu.left_keys] + [
        (k, rs) for k in cpu.right_keys
    ]:
        for r in check_expression(k, schema, meta.conf):
            meta.will_not_work(r)
        try:
            b = E.bind_references(k, schema)
            if not _sortable(b.dtype):
                meta.will_not_work(
                    f"join key type {b.dtype.simpleString} not supported on TPU")
        except (ValueError, KeyError) as ex:
            meta.will_not_work(str(ex))
    if cpu.condition is not None:
        if cpu.join_type != "inner":
            meta.will_not_work(
                "residual join conditions only run on TPU for inner joins")
        comb = StructType(tuple(ls.fields) + tuple(rs.fields))
        for r in check_expression(cpu.condition, comb, meta.conf):
            meta.will_not_work(r)
    _tag_output_types(meta)


def _convert_join(cpu: C.CpuJoinExec, conf, children, device):
    from ..conf import AQE_ENABLED, AUTO_BROADCAST_JOIN_THRESHOLD
    from ..exec.exchange import (TpuBroadcastExchangeExec,
                                 TpuShuffleExchangeExec, lazy_aqe_join_pair)
    from ..exec.join import (TpuBroadcastNestedLoopJoinExec,
                             TpuCartesianProductExec,
                             TpuShuffledHashJoinExec)
    from ..shuffle.partition import HashPartitioning, SinglePartitioning

    if not cpu.left_keys:
        # the build side flows through a broadcast exchange; no condition
        # is the cartesian product (reference overrides.py:755-773)
        bcast = TpuBroadcastExchangeExec(conf, children[1])
        if cpu.condition is None:
            return TpuCartesianProductExec(conf, children[0], bcast)
        return TpuBroadcastNestedLoopJoinExec(conf, children[0], bcast,
                                              cpu.condition)
    left, right = children
    # the size-thresholded broadcast hash join (reference
    # overrides.py:776-799): the small side broadcasts and the other
    # side's partitions probe in place, with no exchange
    thresh = conf.get(AUTO_BROADCAST_JOIN_THRESHOLD)
    if (thresh >= 0 and cpu.condition is None
            and (left.num_partitions > 1 or right.num_partitions > 1)):
        lsz = cpu.children[0].estimated_size_bytes()
        rsz = cpu.children[1].estimated_size_bytes()
        # the exec builds from the right side (the left for right joins)
        if cpu.join_type in ("inner", "left", "semi", "anti") \
                and rsz is not None and rsz <= thresh:
            return TpuShuffledHashJoinExec(
                conf, left, TpuBroadcastExchangeExec(conf, right),
                cpu.left_keys, cpu.right_keys, cpu.join_type, None)
        if cpu.join_type == "right" and lsz is not None and lsz <= thresh:
            return TpuShuffledHashJoinExec(
                conf, TpuBroadcastExchangeExec(conf, left), right,
                cpu.left_keys, cpu.right_keys, cpu.join_type, None)
    if left.num_partitions > 1 or right.num_partitions > 1:
        # co-partition both sides by the join keys through hash exchanges
        # (reference overrides.py:800-864); computed keys and keys of
        # different dtypes fall back to a single partition
        lb = rb = None
        try:
            lb = [E.bind_references(k, left.output_schema)
                  for k in cpu.left_keys]
            rb = [E.bind_references(k, right.output_schema)
                  for k in cpu.right_keys]
        except (ValueError, KeyError):
            pass
        P = max(_shuffle_partitions(conf, left),
                _shuffle_partitions(conf, right))
        plain = (lb is not None and rb is not None
                 and all(isinstance(b, E.BoundReference) for b in lb)
                 and all(isinstance(b, E.BoundReference) for b in rb)
                 and all(lt.dtype == rt.dtype for lt, rt in zip(lb, rb)))
        if (plain and cpu.join_type == "inner" and cpu.condition is None
                and _mesh_eligible(conf, device, left.output_schema,
                                   right.output_schema)):
            # hash exchange of both sides + local join over the mesh
            from ..exec.mesh import TpuMeshHashJoinExec

            return TpuMeshHashJoinExec(conf, left, right,
                                       [b.ordinal for b in lb],
                                       [b.ordinal for b in rb])
        partitioned = plain and P > 1
        if partitioned:
            lpart = HashPartitioning([b.ordinal for b in lb], P)
            rpart = HashPartitioning([b.ordinal for b in rb], P)
        else:
            lpart, rpart = SinglePartitioning(), SinglePartitioning()
        left = TpuShuffleExchangeExec(conf, left, lpart)
        right = TpuShuffleExchangeExec(conf, right, rpart)
        if partitioned and conf.get(AQE_ENABLED) \
                and cpu.join_type != "full":
            # skew-split the probe side and coalesce small pairs; full
            # outer is left out: its unmatched-build pass would run once
            # per probe slice
            left, right = lazy_aqe_join_pair(
                conf, left, right, probe_left=cpu.join_type != "right")
        return TpuShuffledHashJoinExec(
            conf, left, right, cpu.left_keys, cpu.right_keys,
            cpu.join_type, cpu.condition, partitioned=partitioned)
    return TpuShuffledHashJoinExec(
        conf, left, right, cpu.left_keys, cpu.right_keys,
        cpu.join_type, cpu.condition,
    )


def _tag_window(meta: "PlanMeta") -> None:
    from ..expr import windows as W

    cpu: C.CpuWindowExec = meta.wrapped  # type: ignore[assignment]
    schema = cpu.children[0].output_schema
    spec = cpu.spec
    for k in list(spec.partition_by) + list(spec.order_by):
        for r in check_expression(k, schema, meta.conf):
            meta.will_not_work(r)
        try:
            b = E.bind_references(k, schema)
            if not _sortable(b.dtype):
                meta.will_not_work(
                    f"window key type {b.dtype.simpleString} not supported on TPU")
        except (ValueError, KeyError) as ex:
            meta.will_not_work(str(ex))
    frame = spec.resolved_frame()
    branged = False
    if not (frame.is_running or frame.is_whole_partition
            or frame.is_bounded_rows):
        if frame.is_bounded_range:
            # literal RANGE frames need ONE numeric/date/timestamp ORDER
            # BY key for the value search (GpuWindowExpression.scala:168
            # imposes the same single-orderable-key shape)
            branged = True
            if len(spec.order_by) != 1:
                meta.will_not_work(
                    "literal RANGE frames need exactly one ORDER BY key")
            else:
                try:
                    b = E.bind_references(spec.order_by[0], schema)
                    if not (b.dtype.is_numeric or isinstance(
                            b.dtype, (T.DateType, T.TimestampType))):
                        meta.will_not_work(
                            f"RANGE frame order key type "
                            f"{b.dtype.simpleString} not supported on TPU")
                except (ValueError, KeyError) as ex:
                    meta.will_not_work(str(ex))
        else:
            meta.will_not_work(
                "only UNBOUNDED PRECEDING..CURRENT ROW, whole-partition, "
                "literal ROWS, or literal RANGE window frames run on TPU")
    from . import typechecks as TC

    for we in cpu.window_exprs:
        f = we.func
        if branged and isinstance(f, (A.Min, A.Max)):
            # arbitrary-range min/max needs a log2(cap)-level sparse
            # table (HBM-heavy); not lowered yet
            meta.will_not_work(
                "min/max over a literal RANGE frame not supported on TPU")
        if isinstance(f, (W.RowNumber, W.Rank, W.DenseRank)):
            continue
        if isinstance(f, (W.Lead, W.Lag)):
            for r in check_expression(f.child, schema, meta.conf):
                meta.will_not_work(r)
            continue
        if isinstance(f, (A.Count, A.Sum, A.Min, A.Max, A.Average)):
            # the function's WINDOW-context matrix cell (reference: the
            # window column of TypeChecks; float agg gated per
            # GpuOverrides.scala:1725, strings off — the window kernels
            # have no string frame path)
            if f.input is not None:
                try:
                    bound_f = E.bind_references(f, schema)
                except (ValueError, KeyError) as ex:
                    meta.will_not_work(str(ex))
                    continue
                for r in TC.check_node(bound_f, meta.conf, TC.WINDOW):
                    meta.will_not_work(r)
                for r in check_expression(f.child, schema, meta.conf):
                    meta.will_not_work(r)
            continue
        meta.will_not_work(
            f"window function {type(f).__name__} is not supported on TPU")
    _tag_output_types(meta)


def _convert_window(cpu: C.CpuWindowExec, conf, children, device):
    from ..exec.window import TpuWindowExec

    child = children[0]
    spec = cpu.window_exprs[0].spec if cpu.window_exprs else None
    if (spec is not None and spec.partition_by
            and child.num_partitions > 1
            and _mesh_eligible(conf, device, child.output_schema)
            and all(T.is_fixed_width(f.dataType)
                    for f in child.output_schema.fields)):
        try:
            bound = [E.bind_references(k, child.output_schema)
                     for k in spec.partition_by]
        except (ValueError, KeyError):
            bound = None
        # hash exchange on the partition keys, then the per-shard window:
        # direct fixed-width partition keys over a fixed-width child
        # (strings keep the single-partition gather)
        if bound is not None and all(
                isinstance(b, E.BoundReference) and T.is_fixed_width(b.dtype)
                for b in bound):
            from ..exec.mesh import TpuMeshWindowExec

            return TpuMeshWindowExec(conf, cpu.window_exprs, child)
    # the window gathers every partition of its child into one batch
    # (reference overrides.py:973)
    return TpuWindowExec(conf, cpu.window_exprs, child)


_exec_rule(C.CpuScanExec, "ScanExec", "in-memory data source", _tag_scan, _convert_scan)
_exec_rule(C.CpuFileScanExec, "FileSourceScanExec", "parquet/csv/orc file scan",
           _tag_file_scan, _convert_file_scan)
_exec_rule(C.CpuRangeExec, "RangeExec", "range of longs", _tag_range, _convert_range)
_exec_rule(C.CpuProjectExec, "ProjectExec", "column projection", _tag_project, _convert_project)
_exec_rule(C.CpuFilterExec, "FilterExec", "row filter", _tag_filter, _convert_filter)
_exec_rule(C.CpuUnionExec, "UnionExec", "union all", _tag_union, _convert_union)
_exec_rule(C.CpuLocalLimitExec, "LocalLimitExec", "row limit", _tag_limit, _convert_limit)
_exec_rule(C.CpuCollectLimitExec, "CollectLimitExec", "global row limit",
           _tag_limit, _convert_collect_limit)
_exec_rule(C.CpuExpandExec, "ExpandExec", "expand projections", _tag_expand, _convert_expand)
_exec_rule(C.CpuGenerateExec, "GenerateExec", "explode generator rows",
           _tag_expand, _convert_expand)
_exec_rule(C.CpuHashAggregateExec, "HashAggregateExec", "hash aggregation",
           _tag_aggregate, _convert_aggregate)
_exec_rule(C.CpuSortExec, "SortExec", "sort", _tag_sort, _convert_sort)
_exec_rule(C.CpuJoinExec, "JoinExec", "equi/nested-loop join",
           _tag_join, _convert_join)
_exec_rule(C.CpuWindowExec, "WindowExec", "window functions",
           _tag_window, _convert_window)


# ---------------------------------------------------------------------------
# Meta / tagging (reference: RapidsMeta.scala)
# ---------------------------------------------------------------------------
class PlanMeta:
    def __init__(self, cpu_exec: C.CpuExec, conf: RapidsConf,
                 parent: Optional["PlanMeta"] = None, device=None):
        self.wrapped = cpu_exec
        self.conf = conf
        self.parent = parent
        #: where converted leaves and row->columnar boundaries upload
        self.device = device
        self.child_metas = [PlanMeta(c, conf, self, device)
                            for c in cpu_exec.children]
        self.reasons: List[str] = []
        self.rule = EXEC_RULES.get(type(cpu_exec))

    def will_not_work(self, reason: str) -> None:
        if reason not in self.reasons:
            self.reasons.append(reason)

    def tag_for_tpu(self) -> None:
        if self.rule is None:
            self.will_not_work(
                f"no TPU replacement rule for {self.wrapped.node_name}"
            )
        else:
            self.rule.tag(self)
        for c in self.child_metas:
            c.tag_for_tpu()

    @property
    def can_replace(self) -> bool:
        return not self.reasons

    def convert_if_needed(self):
        """Returns (exec, is_tpu) inserting transitions at boundaries
        (reference: RapidsMeta.convertIfNeeded :623)."""
        converted = [c.convert_if_needed() for c in self.child_metas]
        if self.can_replace and self.rule is not None:
            tpu_children = [
                ex if is_tpu else RowToColumnarExec(self.conf, ex,
                                                    self.device)
                for ex, is_tpu in converted
            ]
            return self.rule.convert(self.wrapped, self.conf, tpu_children,
                                     self.device), True
        cpu_children = [
            ColumnarToRowExec(self.conf, ex) if is_tpu else ex
            for ex, is_tpu in converted
        ]
        self.wrapped.children = cpu_children
        return self.wrapped, False

    # -- reporting ---------------------------------------------------------
    def explain_lines(self, indent: int = 0) -> List[str]:
        """The willNotWorkOnTpu report (reference: RapidsMeta.explain):
        one line per exec, plus — for fallen-back execs — one nested
        ``!Expression`` line per expression-level matrix reason, so the
        operator AND the offending expression/parameter/type are both
        named without reading code."""
        name = self.rule.name if self.rule else self.wrapped.node_name
        pad = "  " * indent
        if self.can_replace:
            lines = [f"{pad}*Exec <{name}> will run on TPU"]
        else:
            why = "; ".join(self.reasons)
            lines = [f"{pad}!Exec <{name}> cannot run on TPU because {why}"]
            known = {r.name for r in EXPRESSION_RULES.values()}
            for r in self.reasons:
                rule, sep, rest = r.partition(": ")
                if sep and rule in known:
                    lines.append(
                        f"{pad}  !Expression <{rule}> cannot run on TPU "
                        f"because {rest}")
        for c in self.child_metas:
            lines.extend(c.explain_lines(indent + 1))
        return lines

    def fallback_name_sets(self) -> List[Tuple[str, ...]]:
        """Per fallen-back node, every name it answers to: the wrapped CPU
        class name and the Spark-style rule name (reference:
        assert_gpu_fallback_collect matches Spark class names)."""
        out: List[Tuple[str, ...]] = []
        if not self.can_replace:
            names = [self.wrapped.node_name]
            if self.rule is not None and self.rule.name not in names:
                names.append(self.rule.name)
            out.append(tuple(names))
        for c in self.child_metas:
            out.extend(c.fallback_name_sets())
        return out

    def fallback_nodes(self) -> List[str]:
        return [n for names in self.fallback_name_sets() for n in names]


def explain_plan(meta: PlanMeta, conf: RapidsConf) -> str:
    mode = conf.get(EXPLAIN)
    if mode == "NONE":
        return ""
    lines = meta.explain_lines()
    if mode == "NOT_ON_TPU":
        lines = [l for l in lines if "!Exec" in l]
    return "\n".join(lines)


class TpuOverrides:
    """The ColumnarRule analog (reference: Plugin.scala:40-47 +
    GpuOverrides.apply)."""

    def __init__(self, conf: RapidsConf, device=None):
        self.conf = conf
        #: the plan's device; ``None`` is the CUDA card (resolved by
        #: ``apply``, which raises without one)
        self.device = device
        self.last_explain = ""
        self.last_meta: Optional[PlanMeta] = None

    def apply(self, plan: C.CpuExec):
        """CPU plan -> (executable plan, is_tpu_topmost)."""
        if not self.conf.get(SQL_ENABLED):
            return plan, False
        device = resolve_device(self.device)
        meta = PlanMeta(plan, self.conf, device=device)
        meta.tag_for_tpu()
        self.last_meta = meta
        self.last_explain = explain_plan(meta, self.conf)
        if self.conf.get(TEST_CONF):
            allowed = {
                s.strip()
                for s in self.conf.get(TEST_ALLOWED_NONTPU).split(",")
                if s.strip()
            }
            bad = [names[0] for names in meta.fallback_name_sets()
                   if not any(n in allowed for n in names)]
            if bad:
                raise AssertionError(
                    "Part of the plan is not columnar "
                    f"(fell back to CPU): {bad}\n"
                    + "\n".join(meta.explain_lines())
                )
        from ..exec.base import planning_mode

        with planning_mode():  # adaptive reads must not run stages here
            return meta.convert_if_needed()
