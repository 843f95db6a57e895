"""Static per-operator type-support matrices.

Own copy of ``spark_rapids_tpu/plugin/typechecks.py``: the same TypeSig,
ExprChecks and CastChecks tables and value tags, so the port's planner
gives the reference's fallback reasons word for word. Where the port
differs: a ``NotImplementedError`` from a node's result type propagates
instead of reading as a fallback reason.

Reference analog: TypeChecks.scala — every rule declares, per parameter
and per expression context, which input types it accepts, and ONE checker
walks the plan producing reasoned verdicts (``willNotWorkOnGpu``):

  * :class:`TypeSig` — a set of supported type tags, plus conditional
    support (conf gates, literal-only parameters, footnotes).
  * :class:`ExprChecks` — per-context (project / aggregation / window)
    parameter and output signatures for one expression rule, with an
    optional value-level ``tag`` hook for the few rules whose
    supportability depends on literal VALUES (regex patterns, trunc
    units, UDF trace) rather than types.
  * :class:`CastChecks` — the full from-type x to-type cast matrix with
    its conf-gated pairs.
  * :func:`check_expr` — the single checker the override pass calls:
    walks a bound expression tree without lowering anything and returns
    every reason the tree cannot run on the device, each naming the
    rule, the parameter and the offending type (e.g. ``Min: input
    string is not supported in the window context``).

The same tables generate ``docs/torch/supported_ops.md``
(``plugin/docgen.py``, through :meth:`TypeSig.cell` and
:meth:`TypeSig.cell_note`), so the document cannot drift from the
tagging. Under ``sql.matrix.probeCrossCheck.enabled`` the planner also
runs the lowering probe and keeps each disagreement in
:func:`cross_check_log`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .. import types as T
from ..conf import (
    DECIMAL_ENABLED,
    ENABLE_CAST_FLOAT_TO_TIMESTAMP,
    ENABLE_CAST_STRING_TO_FLOAT,
    ENABLE_CAST_STRING_TO_INTEGER,
    ENABLE_CAST_STRING_TO_TIMESTAMP,
    IMPROVED_FLOAT_OPS,
    RapidsConf,
)
from ..expr import aggregates as A
from ..expr import expressions as E
from ..expr import windows as W

# ---------------------------------------------------------------------------
# Expression contexts (reference: the ExprContext column of TypeChecks —
# project / aggregation / window / lambda cells can differ per rule)
# ---------------------------------------------------------------------------
PROJECT = "project"
AGGREGATION = "aggregation"
WINDOW = "window"
LAMBDA = "lambda"

CONTEXTS = (PROJECT, AGGREGATION, WINDOW, LAMBDA)

# Canonical type-tag order (doc columns). ``decimal`` covers every
# DecimalType(p<=18); array/struct are not representable on the engine at
# all and never appear as tags.
TYPE_TAGS = (
    "boolean", "tinyint", "smallint", "int", "bigint", "float", "double",
    "decimal", "string", "binary", "date", "timestamp", "null",
)


def tag_of(dt: T.DataType) -> str:
    """Doc/matrix tag of a concrete type ('array<...>' etc. for the
    unrepresentable ones, which never match any TypeSig)."""
    if isinstance(dt, T.DecimalType):
        return "decimal"
    return dt.simpleString


class TypeSig:
    """An immutable set of supported type tags with conditional support.

    ``lit_only``  tags supported only when the argument is a literal.
    ``notes``     tag -> footnote rendered as PS (partial support) in docs.
    ``gates``     tag -> (ConfEntry, message): supported only when the
                  boolean conf is enabled; the message is the fallback
                  reason (and the doc footnote) while it is off.
    """

    __slots__ = ("tags", "lit_only", "notes", "gates")

    def __init__(self, tags, lit_only=(), notes=None, gates=None):
        self.tags = frozenset(tags)
        self.lit_only = frozenset(lit_only)
        self.notes: Dict[str, str] = dict(notes or {})
        self.gates: Dict[str, tuple] = dict(gates or {})

    # -- construction -----------------------------------------------------
    @staticmethod
    def of(*tags: str) -> "TypeSig":
        return TypeSig(tags)

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(
            self.tags | other.tags,
            self.lit_only | other.lit_only,
            {**self.notes, **other.notes},
            {**self.gates, **other.gates},
        )

    def with_note(self, tags, note: str) -> "TypeSig":
        tags = (tags,) if isinstance(tags, str) else tags
        notes = dict(self.notes)
        for t in tags:
            notes[t] = note
        return TypeSig(self.tags, self.lit_only, notes, self.gates)

    def with_lit_only(self, *tags: str) -> "TypeSig":
        add = tags or tuple(self.tags)
        return TypeSig(self.tags | set(add), self.lit_only | set(add),
                       self.notes, self.gates)

    def with_gate(self, tags, entry, message: str) -> "TypeSig":
        tags = (tags,) if isinstance(tags, str) else tags
        gates = dict(self.gates)
        for t in tags:
            gates[t] = (entry, message)
        return TypeSig(self.tags, self.lit_only, gates=gates,
                       notes=self.notes)

    # -- doc cells --------------------------------------------------------
    def cell(self, tag: str) -> str:
        """'S' full support, 'PS' partial (noted/gated/lit-only), '' none."""
        if tag not in self.tags:
            return ""
        if tag in self.notes or tag in self.gates or tag in self.lit_only:
            return "PS"
        return "S"

    def cell_note(self, tag: str) -> Optional[str]:
        if tag not in self.tags:
            return None
        parts = []
        if tag in self.lit_only:
            parts.append("literal only")
        if tag in self.notes:
            parts.append(self.notes[tag])
        if tag in self.gates:
            entry, _ = self.gates[tag]
            parts.append(f"requires {entry.key}=true")
        return "; ".join(parts) if parts else None

    # -- checking ---------------------------------------------------------
    def check(self, dt: T.DataType, conf: RapidsConf,
              is_literal: bool = False) -> Optional[str]:
        """None when ``dt`` is supported here; otherwise the detail text
        the caller prefixes with rule/parameter/context."""
        if isinstance(dt, T.NullType) and is_literal:
            return None  # a null literal is valid anywhere a value is
        t = tag_of(dt)
        if t not in self.tags:
            return f"{dt.simpleString} is not supported"
        if t in self.lit_only and not is_literal:
            return f"{dt.simpleString} is only supported as a literal"
        if t == "decimal":
            err = decimal_reason(dt, conf)
            if err:
                return err
        gate = self.gates.get(t)
        if gate is not None and not conf.get(gate[0]):
            return gate[1]
        return None


def decimal_reason(dt: T.DecimalType, conf: RapidsConf) -> Optional[str]:
    """The engine-wide DECIMAL64 gate (reference: isSupportedType
    GpuOverrides.scala:531 + the decimalType.enabled conf)."""
    if not conf.get(DECIMAL_ENABLED):
        return ("decimal support is disabled "
                "(spark.rapids.tpu.sql.decimalType.enabled)")
    if dt.precision > T.DecimalType.MAX_PRECISION:
        return f"decimal precision {dt.precision} > 18 not supported"
    return None


# Shared signatures (reference: the TypeSig companions in TypeChecks.scala)
none = TypeSig.of()
BOOLEAN = TypeSig.of("boolean")
integral = TypeSig.of("tinyint", "smallint", "int", "bigint")
fp = TypeSig.of("float", "double")
decimal128 = TypeSig.of("decimal")  # DECIMAL64 really; tag name is 'decimal'
numeric = integral + fp + decimal128
datetime = TypeSig.of("date", "timestamp")
STRING = TypeSig.of("string")
BINARY = TypeSig.of("binary")
NULL = TypeSig.of("null")
orderable = numeric + BOOLEAN + datetime + STRING
commonTypes = numeric + BOOLEAN + datetime + STRING
allTypes = commonTypes + BINARY + NULL

_FLOAT_AGG_MSG = (
    "floating-point sum/average can differ from CPU results; set "
    "spark.rapids.tpu.sql.variableFloatAgg.enabled=true to enable"
)
_FLOAT_WINDOW_AGG_MSG = (
    "floating-point window sum/average can differ from CPU results; set "
    "spark.rapids.tpu.sql.variableFloatAgg.enabled=true to enable"
)


# ---------------------------------------------------------------------------
# Per-rule checks
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamCheck:
    name: str
    sig: TypeSig
    lit_required: bool = False


@dataclasses.dataclass(frozen=True)
class ContextCheck:
    """Signatures of one rule in one expression context."""

    params: Tuple[ParamCheck, ...]
    output: TypeSig
    #: variadic tail: children beyond ``params`` check against this
    repeat: Optional[ParamCheck] = None


class ExprChecks:
    """All declared contexts of one expression rule + the optional
    value-level tag hook (reference: tagExprForGpu)."""

    __slots__ = ("contexts", "tag")

    def __init__(self, contexts: Dict[str, ContextCheck],
                 tag: Optional[Callable] = None):
        self.contexts = contexts
        self.tag = tag

    # -- constructors ------------------------------------------------------
    @staticmethod
    def project_only(output: TypeSig, params: Sequence[Tuple] = (),
                     repeat: Optional[Tuple] = None,
                     tag: Optional[Callable] = None) -> "ExprChecks":
        pcs = tuple(ParamCheck(*p) for p in params)
        rep = ParamCheck(*repeat) if repeat is not None else None
        return ExprChecks(
            {PROJECT: ContextCheck(pcs, output, rep)}, tag=tag)

    @staticmethod
    def unary(output: TypeSig, input_sig: TypeSig, name: str = "input",
              tag: Optional[Callable] = None) -> "ExprChecks":
        return ExprChecks.project_only(output, [(name, input_sig)], tag=tag)

    @staticmethod
    def binary(output: TypeSig, lhs: TypeSig, rhs: TypeSig,
               names: Tuple[str, str] = ("lhs", "rhs"),
               tag: Optional[Callable] = None) -> "ExprChecks":
        return ExprChecks.project_only(
            output, [(names[0], lhs), (names[1], rhs)], tag=tag)

    @staticmethod
    def math_unary() -> "ExprChecks":
        return ExprChecks.unary(fp + NULL, numeric + BOOLEAN)

    @staticmethod
    def aggregate(input_sig: TypeSig, output: TypeSig,
                  window_input: Optional[TypeSig] = None,
                  tag: Optional[Callable] = None) -> "ExprChecks":
        """An aggregate function: aggregation context always, window
        context when ``window_input`` is given (its own, usually
        narrower, input sig — e.g. Min/Max support strings in
        aggregation but not over window frames)."""
        ctxs = {
            AGGREGATION: ContextCheck(
                (ParamCheck("input", input_sig),), output),
        }
        if window_input is not None:
            ctxs[WINDOW] = ContextCheck(
                (ParamCheck("input", window_input),), output)
        return ExprChecks(ctxs, tag=tag)

    @staticmethod
    def window_only(output: TypeSig, params: Sequence[Tuple] = ()) -> "ExprChecks":
        pcs = tuple(ParamCheck(*p) for p in params)
        return ExprChecks({WINDOW: ContextCheck(pcs, output)})

    @staticmethod
    def passthrough() -> "ExprChecks":
        """Structural nodes (Alias, references, holders): every engine
        type, no checks of their own. One shared ContextCheck so docgen
        collapses the contexts into a single 'all' row."""
        cc = ContextCheck((), allTypes)
        return ExprChecks(
            {c: cc for c in (PROJECT, AGGREGATION, WINDOW)})


# ---------------------------------------------------------------------------
# Cast matrix (reference: CastChecks in TypeChecks.scala — a full
# from-type x to-type grid with the conf-gated pairs)
# ---------------------------------------------------------------------------
_CAST_STRING_TO_INT_MSG = (
    "casting string to integral types is disabled; set "
    "spark.rapids.tpu.sql.castStringToInteger.enabled=true")
_CAST_STRING_TO_FLOAT_MSG = (
    "casting string to float is disabled; set "
    "spark.rapids.tpu.sql.castStringToFloat.enabled=true")
_CAST_STRING_TO_TS_MSG = (
    "casting string to timestamp is disabled; set "
    "spark.rapids.tpu.sql.castStringToTimestamp.enabled=true")
_CAST_FLOAT_TO_TS_MSG = (
    "casting float to timestamp is disabled; set "
    "spark.rapids.tpu.sql.castFloatToTimestamp.enabled=true")


class CastChecks:
    """from-tag -> TypeSig of castable to-types. Derived from the actual
    device kernels (eval.py _cast_data/_decimal_cast, eval_strings
    lower_string_cast/lower_cast_to_string) so the matrix states exactly
    what lowers."""

    def __init__(self):
        b = "boolean"
        ints = ("tinyint", "smallint", "int", "bigint")
        m: Dict[str, TypeSig] = {}
        m["boolean"] = (TypeSig.of(b, *ints) + fp + STRING
                        + TypeSig.of("timestamp") + decimal128)
        for i in ints:
            m[i] = (TypeSig.of(b, *ints) + fp + STRING
                    + TypeSig.of("timestamp")
                    + decimal128.with_note(
                        "decimal",
                        "values beyond the target precision null out"))
        f = (TypeSig.of(b, *ints) + fp
             + TypeSig.of("timestamp").with_gate(
                 "timestamp", ENABLE_CAST_FLOAT_TO_TIMESTAMP,
                 _CAST_FLOAT_TO_TS_MSG))
        m["float"] = f
        m["double"] = f
        m["decimal"] = (TypeSig.of(b, *ints) + fp
                        + decimal128.with_note(
                            "decimal",
                            "rescale must fit DECIMAL64 headroom"))
        m["string"] = (STRING + TypeSig.of("date")
                       + TypeSig.of(b)
                       + TypeSig.of(*ints).with_gate(
                           ints, ENABLE_CAST_STRING_TO_INTEGER,
                           _CAST_STRING_TO_INT_MSG)
                       + fp.with_gate(
                           ("float", "double"), ENABLE_CAST_STRING_TO_FLOAT,
                           _CAST_STRING_TO_FLOAT_MSG)
                       + TypeSig.of("timestamp").with_gate(
                           "timestamp", ENABLE_CAST_STRING_TO_TIMESTAMP,
                           _CAST_STRING_TO_TS_MSG))
        m["date"] = TypeSig.of("date", "timestamp") + STRING
        m["timestamp"] = (TypeSig.of(b, *ints) + fp
                          + TypeSig.of("date", "timestamp") + STRING)
        m["binary"] = none
        m["null"] = allTypes
        self.matrix = m

    def reason(self, frm: T.DataType, to: T.DataType,
               conf: RapidsConf) -> Optional[str]:
        for dt in (frm, to):
            if isinstance(dt, T.DecimalType):
                err = decimal_reason(dt, conf)
                if err:
                    return err
        sig = self.matrix.get(tag_of(frm))
        if sig is None:
            return (f"cast from {frm.simpleString} is not supported on TPU")
        if tag_of(to) not in sig.tags:
            return (f"cast {frm.simpleString} -> {to.simpleString} "
                    "is not supported on TPU")
        return self.gate_reason(frm, to, conf)

    def gate_reason(self, frm: T.DataType, to: T.DataType,
                    conf: RapidsConf) -> Optional[str]:
        """The conf gate's message where the pair is gated and its conf
        is off (reference: RapidsConf.scala:487-533, risky cast kernels
        that tag the plan for fallback unless enabled), else None."""
        sig = self.matrix.get(tag_of(frm))
        gate = sig.gates.get(tag_of(to)) if sig is not None else None
        if gate is not None and not conf.get(gate[0]):
            return gate[1]
        return None


CAST_CHECKS = CastChecks()


def _tag_cast(node: E.Cast, conf: RapidsConf) -> List[str]:
    r = CAST_CHECKS.reason(node.child.dtype, node.to, conf)
    return [f"Cast: {r}"] if r else []


# ---------------------------------------------------------------------------
# Value-level tag hooks (reference: tagExprForGpu overrides — the few
# rules whose support depends on literal VALUES, not types)
# ---------------------------------------------------------------------------
def _lit_value(e: E.Expression):
    return e.value if isinstance(e, E.Literal) else None


def _tag_comparable(node, conf) -> List[str]:
    """Binary comparison operands must promote to one comparison type
    (string-vs-string or one numeric/datetime lattice point)."""
    l, r = node.left.dtype, node.right.dtype
    if isinstance(l, T.NullType) or isinstance(r, T.NullType):
        return []
    ls, rs = (isinstance(x, T.StringType) for x in (l, r))
    if ls != rs:
        return [f"{type(node).__name__}: comparison between "
                f"{l.simpleString} and {r.simpleString} is not supported"]
    if not ls and l != r:
        try:
            T.promote(l, r)
        except TypeError as e:
            return [f"{type(node).__name__}: {e}"]
    return []


def _tag_binary_arith(node, conf) -> List[str]:
    """+,-,*,%,pmod operand pair must promote (decimal results must also
    fit DECIMAL64 — surfaced by the dtype computation itself)."""
    l, r = node.left.dtype, node.right.dtype
    if isinstance(l, T.NullType) or isinstance(r, T.NullType):
        return []
    if l != r:
        try:
            T.promote(l, r)
        except TypeError as e:
            return [f"{type(node).__name__}: {e}"]
    return []


def _tag_like(node: E.Like, conf) -> List[str]:
    pat = _lit_value(node.pattern)
    if pat is None:
        return []
    from ..expr.eval_strings import _parse_like

    try:
        toks = _parse_like(pat, node.escape)
    except ValueError as e:
        return [f"Like: {e}"]
    if "%" in toks and "_" in toks:
        return ["Like: patterns mixing % and _ are not supported on TPU"]
    return []


def _tag_rlike(node: E.RLike, conf) -> List[str]:
    pat = _lit_value(node.pattern)
    if pat is None:
        return []
    from ..ops import regex as RX

    try:
        RX.compile_search_dfa(pat)
    except Exception as e:  # noqa: BLE001 — any compile failure = fallback
        return [f"RLike: pattern not supported by the byte DFA: {e}"]
    return []


def _tag_regexp_replace(node: E.RegExpReplace, conf) -> List[str]:
    pat = _lit_value(node.pattern)
    repl = _lit_value(node.replacement)
    reasons = []
    if pat is not None:
        from ..ops import regex as RX

        literal = RX.regex_as_literal(pat)
        if literal is None or literal == "":
            reasons.append(
                "RegExpReplace: pattern is not literal-equivalent")
    if repl is not None and ("$" in repl or "\\" in repl):
        reasons.append(
            "RegExpReplace: replacement with group references")
    return reasons


def _tag_split_part(node: E.StringSplitPart, conf) -> List[str]:
    reasons = []
    d = _lit_value(node.delim)
    if d == "":
        reasons.append("StringSplit: split with empty delimiter")
    idx = _lit_value(node.index)
    if isinstance(idx, int) and idx < 0:
        reasons.append("StringSplit: split index must be >= 0")
    return reasons


def _tag_trunc_date(node: E.TruncDate, conf) -> List[str]:
    fmt = _lit_value(node.fmt)
    if fmt is None:
        return []
    if fmt.lower() not in (
            "year", "yyyy", "yy", "quarter", "month", "mon", "mm", "week"):
        return [f"TruncDate: unit {fmt!r} is not supported on TPU"]
    return []


def _tag_from_unixtime(node: E.FromUnixTime, conf) -> List[str]:
    fmt = _lit_value(node.format)
    if fmt is not None and fmt != "yyyy-MM-dd HH:mm:ss":
        return ["FromUnixTime: only the default 'yyyy-MM-dd HH:mm:ss' "
                "format is supported on TPU"]
    return []


def _tag_in_values(node: E.In, conf) -> List[str]:
    ok = (type(None), bool, int, float, str)
    bad = [v for v in node.values if not isinstance(v, ok)]
    if bad:
        return [f"In: value {bad[0]!r} is not a supported literal"]
    return []


def _tag_native_udf(node: E.NativeUDF, conf) -> List[str]:
    """A native UDF's columnar function is arbitrary user code: the only
    sound static check is the abstract trace itself (reference: a
    RapidsUDF throwing in evaluateColumnar falls back to the row path).
    This is the ONE rule where the lowering probe is the matrix."""
    from .. import types as TT
    from ..expr.eval import tpu_supports

    dts = [c.dtype for c in node.children_]
    schema = TT.StructType(tuple(
        TT.StructField(f"c{i}", dt, True) for i, dt in enumerate(dts)))
    probe = E.NativeUDF(
        node.columnar_fn, node.row_fn,
        tuple(E.BoundReference(i, dt, True) for i, dt in enumerate(dts)),
        node.return_type)
    ok, why = tpu_supports(probe, schema)
    if not ok:
        return [f"NativeUDF: {why or 'columnar trace failed'}"]
    return []


# ---------------------------------------------------------------------------
# The declarations: one ExprChecks per registered expression rule
# ---------------------------------------------------------------------------
_PROJECTION_ONLY_NOTE = "only inside a projection"

CHECKS: Dict[type, ExprChecks] = {}


def _c(cls, checks: ExprChecks) -> None:
    CHECKS[cls] = checks


# structural / leaves -------------------------------------------------------
_c(E.Literal, ExprChecks.passthrough())
_c(E.UnresolvedAttribute, ExprChecks.passthrough())
_c(E.BoundReference, ExprChecks.passthrough())
_c(E.Alias, ExprChecks.passthrough())

# arithmetic ----------------------------------------------------------------
_arith_out = numeric.with_note(
    "decimal", "result precision must fit DECIMAL64 (18 digits)")
for _cls in (E.Add, E.Subtract, E.Multiply):
    _c(_cls, ExprChecks.binary(_arith_out, numeric, numeric,
                               tag=_tag_binary_arith))
_c(E.Divide, ExprChecks.binary(
    fp + decimal128.with_note(
        "decimal", "quotient digits must fit DECIMAL64"),
    numeric, numeric, tag=_tag_binary_arith))
_c(E.IntegralDivide, ExprChecks.binary(
    TypeSig.of("bigint"), integral + fp, integral + fp,
    tag=_tag_binary_arith))
_no_dec_mod = integral + fp
_c(E.Remainder, ExprChecks.binary(_no_dec_mod, _no_dec_mod, _no_dec_mod,
                                  tag=_tag_binary_arith))
_c(E.Pmod, ExprChecks.binary(_no_dec_mod, _no_dec_mod, _no_dec_mod,
                             tag=_tag_binary_arith))
_c(E.UnaryMinus, ExprChecks.unary(numeric, numeric))
_c(E.UnaryPositive, ExprChecks.unary(numeric, numeric))
_c(E.Abs, ExprChecks.unary(numeric, numeric))

# comparisons ---------------------------------------------------------------
for _cls in (E.EqualTo, E.EqualNullSafe, E.LessThan, E.LessThanOrEqual,
             E.GreaterThan, E.GreaterThanOrEqual):
    _c(_cls, ExprChecks.binary(BOOLEAN, orderable, orderable,
                               tag=_tag_comparable))
_c(E.In, ExprChecks.unary(BOOLEAN, orderable, name="value",
                          tag=_tag_in_values))

# boolean logic -------------------------------------------------------------
_c(E.And, ExprChecks.binary(BOOLEAN, BOOLEAN, BOOLEAN))
_c(E.Or, ExprChecks.binary(BOOLEAN, BOOLEAN, BOOLEAN))
_c(E.Not, ExprChecks.unary(BOOLEAN, BOOLEAN))

# null / NaN ----------------------------------------------------------------
_c(E.IsNull, ExprChecks.unary(BOOLEAN, allTypes))
_c(E.IsNotNull, ExprChecks.unary(BOOLEAN, allTypes))
_c(E.IsNan, ExprChecks.unary(BOOLEAN, numeric + BOOLEAN))
_c(E.Coalesce, ExprChecks.project_only(
    commonTypes, repeat=("param", commonTypes)))
_c(E.NaNvl, ExprChecks.binary(fp, fp, fp))

# conditionals --------------------------------------------------------------
_cond_val = commonTypes
_c(E.If, ExprChecks.project_only(
    _cond_val, [("predicate", BOOLEAN), ("trueValue", _cond_val),
                ("falseValue", _cond_val)]))
_c(E.CaseWhen, ExprChecks.project_only(
    _cond_val, repeat=("branch", _cond_val + BOOLEAN)))

# cast ----------------------------------------------------------------------
_c(E.Cast, ExprChecks.unary(
    allTypes, commonTypes + NULL, tag=_tag_cast))

# math ----------------------------------------------------------------------
for _cls in (E.Sqrt, E.Exp, E.Log, E.Log10, E.Log2, E.Log1p, E.Expm1,
             E.Sin, E.Cos, E.Tan, E.Asin, E.Acos, E.Atan, E.Sinh, E.Cosh,
             E.Tanh, E.Cbrt, E.ToDegrees, E.ToRadians):
    _c(_cls, ExprChecks.math_unary())
_c(E.Floor, ExprChecks.unary(numeric, numeric))
_c(E.Ceil, ExprChecks.unary(numeric, numeric))
_c(E.Round, ExprChecks.unary(numeric, numeric))
_c(E.Rint, ExprChecks.unary(fp, numeric + BOOLEAN))
_c(E.Pow, ExprChecks.binary(fp, numeric + BOOLEAN, numeric + BOOLEAN))
_c(E.Atan2, ExprChecks.binary(fp, numeric + BOOLEAN, numeric + BOOLEAN))
_c(E.Signum, ExprChecks.unary(fp, numeric))

# bitwise -------------------------------------------------------------------
for _cls in (E.BitwiseAnd, E.BitwiseOr, E.BitwiseXor):
    _c(_cls, ExprChecks.binary(integral, integral, integral,
                               tag=_tag_binary_arith))
_c(E.BitwiseNot, ExprChecks.unary(integral, integral))
for _cls in (E.ShiftLeft, E.ShiftRight, E.ShiftRightUnsigned):
    _c(_cls, ExprChecks.binary(
        TypeSig.of("int", "bigint"), TypeSig.of("int", "bigint"),
        TypeSig.of("int"), names=("value", "amount")))

# strings -------------------------------------------------------------------
_c(E.Length, ExprChecks.unary(TypeSig.of("int"), STRING))
for _cls in (E.Upper, E.Lower, E.InitCap):
    _c(_cls, ExprChecks.unary(STRING, STRING))
_c(E.Substring, ExprChecks.project_only(
    STRING, [("str", STRING), ("pos", TypeSig.of("int"), True),
             ("len", TypeSig.of("int"), True)]))
_c(E.Concat, ExprChecks.project_only(STRING, repeat=("input", STRING)))
for _cls in (E.StringTrim, E.StringTrimLeft, E.StringTrimRight):
    _c(_cls, ExprChecks.unary(STRING, STRING, name="src"))
for _cls in (E.StartsWith, E.EndsWith, E.Contains):
    _c(_cls, ExprChecks.project_only(
        BOOLEAN, [("src", STRING), ("search", STRING, True)]))
_c(E.Like, ExprChecks.project_only(
    BOOLEAN, [("src", STRING), ("search", STRING, True)], tag=_tag_like))
_c(E.RLike, ExprChecks.project_only(
    BOOLEAN, [("str", STRING), ("regexp", STRING, True)], tag=_tag_rlike))
_c(E.RegExpReplace, ExprChecks.project_only(
    STRING, [("str", STRING), ("regex", STRING, True),
             ("rep", STRING, True)], tag=_tag_regexp_replace))
_c(E.StringLocate, ExprChecks.project_only(
    TypeSig.of("int"), [("substr", STRING, True), ("str", STRING),
                        ("start", TypeSig.of("int"), True)]))
_c(E.StringReplace, ExprChecks.project_only(
    STRING, [("src", STRING), ("search", STRING, True),
             ("replace", STRING, True)]))
for _cls in (E.StringLPad, E.StringRPad):
    _c(_cls, ExprChecks.project_only(
        STRING, [("str", STRING), ("len", TypeSig.of("int"), True),
                 ("pad", STRING, True)]))
_c(E.SubstringIndex, ExprChecks.project_only(
    STRING, [("str", STRING), ("delim", STRING, True),
             ("count", TypeSig.of("int"), True)]))
_c(E.StringSplitPart, ExprChecks.project_only(
    STRING, [("str", STRING), ("delimiter", STRING, True),
             ("index", TypeSig.of("int"), True)], tag=_tag_split_part))

# datetime ------------------------------------------------------------------
for _cls in (E.Year, E.Quarter, E.Month, E.DayOfMonth, E.DayOfYear,
             E.DayOfWeek, E.WeekDay):
    _c(_cls, ExprChecks.unary(TypeSig.of("int"), datetime))
for _cls in (E.Hour, E.Minute, E.Second):
    _c(_cls, ExprChecks.unary(TypeSig.of("int"), TypeSig.of("timestamp")))
_c(E.DateAdd, ExprChecks.project_only(
    TypeSig.of("date"),
    [("startDate", TypeSig.of("date")),
     ("days", TypeSig.of("tinyint", "smallint", "int"))]))
_c(E.DateSub, ExprChecks.project_only(
    TypeSig.of("date"),
    [("startDate", TypeSig.of("date")),
     ("days", TypeSig.of("tinyint", "smallint", "int"))]))
_c(E.DateDiff, ExprChecks.project_only(
    TypeSig.of("int"),
    [("lhs", TypeSig.of("date")), ("rhs", TypeSig.of("date"))]))
_c(E.LastDay, ExprChecks.unary(TypeSig.of("date"), TypeSig.of("date")))
_c(E.UnixTimestamp, ExprChecks.unary(TypeSig.of("bigint"), datetime))
_c(E.ToUnixTimestamp, ExprChecks.unary(TypeSig.of("bigint"), datetime))
_c(E.FromUnixTime, ExprChecks.project_only(
    STRING,
    [("sec", TypeSig.of("bigint")),
     ("format", STRING.with_note(
         "string", "only the default 'yyyy-MM-dd HH:mm:ss' format"), True)],
    tag=_tag_from_unixtime))
_c(E.TimeAdd, ExprChecks.unary(
    TypeSig.of("timestamp"), TypeSig.of("timestamp"), name="start"))
_c(E.TruncDate, ExprChecks.project_only(
    TypeSig.of("date"),
    [("date", TypeSig.of("date")),
     ("format", STRING.with_note(
         "string", "units: year/yyyy/yy/quarter/month/mon/mm/week"), True)],
    tag=_tag_trunc_date))

# nondeterministic / metadata (projection-context only — enforced by the
# override pass, which rejects them anywhere but a project boundary)
_c(E.Rand, ExprChecks.project_only(
    fp.with_note(("float", "double"), _PROJECTION_ONLY_NOTE)))
_c(E.MonotonicallyIncreasingID, ExprChecks.project_only(
    TypeSig.of("bigint").with_note("bigint", _PROJECTION_ONLY_NOTE)))
_c(E.SparkPartitionID, ExprChecks.project_only(
    TypeSig.of("int").with_note("int", _PROJECTION_ONLY_NOTE)))
_c(E.InputFileName, ExprChecks.project_only(
    STRING.with_note("string", _PROJECTION_ONLY_NOTE)))
# decimal excluded: Spark hashes decimals via their BigDecimal layout,
# which neither the TPU kernel nor the row oracle implements yet
_c(E.Murmur3Hash, ExprChecks.project_only(
    TypeSig.of("int"),
    repeat=("input", (integral + fp + BOOLEAN + datetime
                      + STRING.with_note(
                          "string",
                          "hash over strings only inside a projection")))))

# aggregates ----------------------------------------------------------------
_c(A.AggregateExpression, ExprChecks.passthrough())
_c(A.Count, ExprChecks.aggregate(
    numeric + BOOLEAN + datetime, TypeSig.of("bigint"),
    window_input=numeric + BOOLEAN + datetime))
_sum_in = (integral + BOOLEAN
           + fp.with_gate(("float", "double"), IMPROVED_FLOAT_OPS,
                          _FLOAT_AGG_MSG)
           + decimal128.with_note(
               "decimal", "sum buffer needs precision+10 <= 18"))
_sum_in_w = (integral + BOOLEAN
             + fp.with_gate(("float", "double"), IMPROVED_FLOAT_OPS,
                            _FLOAT_WINDOW_AGG_MSG)
             + decimal128.with_note(
                 "decimal", "sum buffer needs precision+10 <= 18"))
_c(A.Sum, ExprChecks.aggregate(
    _sum_in, numeric, window_input=_sum_in_w))
_c(A.Average, ExprChecks.aggregate(
    (integral + BOOLEAN
     + fp.with_gate(("float", "double"), IMPROVED_FLOAT_OPS, _FLOAT_AGG_MSG)
     + decimal128.with_note("decimal", "result needs precision+4 <= 18")),
    fp + decimal128,
    window_input=(integral + BOOLEAN
                  + fp.with_gate(("float", "double"), IMPROVED_FLOAT_OPS,
                                 _FLOAT_WINDOW_AGG_MSG)
                  + decimal128.with_note(
                      "decimal", "result needs precision+4 <= 18"))))
# Min/Max: STRING inputs lower in the AGGREGATION context (dictionary
# sorted-code order, or a rank-by-sort for plain columns) — the window
# kernels have no string frame path yet, so the window cell stays off.
# DIRECT column references only: the rank sort needs a static byte
# bound, which is exact for a column (synced max, or dict metadata) but
# unboundable for length-growing expressions (concat, pads) — a short
# bound would silently compare only a prefix.
def _tag_string_minmax(node, conf) -> List[str]:
    child = getattr(node, "child", None)
    if child is None or not isinstance(child.dtype,
                                       (T.StringType, T.BinaryType)):
        return []
    while isinstance(child, E.Alias):
        child = child.child
    if not isinstance(child, (E.BoundReference, E.UnresolvedAttribute)):
        return [f"{type(node).__name__}: string min/max supports only "
                "direct column references (a computed string has no "
                "static byte bound for the rank sort)"]
    return []


_minmax_in = (numeric + BOOLEAN + datetime
              + STRING.with_note(
                  "string",
                  "direct column references only; lexicographic; "
                  "dictionary-encoded columns reduce in sorted-code "
                  "order"))
_c(A.Min, ExprChecks.aggregate(
    _minmax_in, orderable, window_input=numeric + BOOLEAN + datetime,
    tag=_tag_string_minmax))
_c(A.Max, ExprChecks.aggregate(
    _minmax_in, orderable, window_input=numeric + BOOLEAN + datetime,
    tag=_tag_string_minmax))
_c(A.First, ExprChecks.aggregate(
    numeric + BOOLEAN + datetime, numeric + BOOLEAN + datetime))
_c(A.Last, ExprChecks.aggregate(
    numeric + BOOLEAN + datetime, numeric + BOOLEAN + datetime))

# window functions ----------------------------------------------------------
_c(W.WindowExpression, ExprChecks.passthrough())
_c(W.RowNumber, ExprChecks.window_only(TypeSig.of("int")))
_c(W.Rank, ExprChecks.window_only(TypeSig.of("int")))
_c(W.DenseRank, ExprChecks.window_only(TypeSig.of("int")))
_c(W.Lead, ExprChecks.window_only(
    commonTypes, [("input", commonTypes)]))
_c(W.Lag, ExprChecks.window_only(
    commonTypes, [("input", commonTypes)]))

# native UDFs: type-open, value-checked by tracing the user's columnar fn
_c(E.NativeUDF, ExprChecks.project_only(
    allTypes,
    repeat=("input", commonTypes.with_note(
        tuple(commonTypes.tags),
        "the registered columnar function must trace for these inputs")),
    tag=_tag_native_udf))


# ---------------------------------------------------------------------------
# The checker
# ---------------------------------------------------------------------------
def rule_name(cls: type) -> str:
    """Spark-style rule name (falls back to the class name for internal
    nodes that have no registered rule)."""
    from .overrides import EXPRESSION_RULES

    r = EXPRESSION_RULES.get(cls)
    return r.name if r is not None else cls.__name__


def _node_dtype(node: E.Expression) -> Tuple[Optional[T.DataType],
                                             Optional[str]]:
    try:
        return node.dtype, None
    except NotImplementedError:
        raise  # a type the port has not ported: raise, never fall back
    except Exception as e:  # noqa: BLE001 — any dtype failure = fallback
        return None, str(e) or type(e).__name__


def check_node(node: E.Expression, conf: RapidsConf,
               context: str) -> List[str]:
    """All the reasons ONE bound node cannot run on TPU in ``context``
    (children are checked by their own calls)."""
    from .overrides import EXPRESSION_RULES

    name = rule_name(type(node))
    if type(node) not in EXPRESSION_RULES:
        return [f"expression {type(node).__name__} is not supported on TPU"]
    checks = CHECKS.get(type(node))
    if checks is None:
        return [f"{name} has no type matrix declared"]
    ctx = checks.contexts.get(context)
    if ctx is None and context in (AGGREGATION, WINDOW):
        # inside an aggregation/window the non-aggregate input expressions
        # evaluate in the surrounding projection pass, so rules without a
        # dedicated cell inherit their project declarations
        if isinstance(node, (A.AggregateFunction, W.WindowFunction)):
            return [f"{name}: is not supported in the {context} context"]
        ctx = checks.contexts.get(PROJECT)
    if ctx is None:
        return [f"{name}: is not supported in the {context} context"]

    reasons: List[str] = []
    children = node.children
    for i, child in enumerate(children):
        if i < len(ctx.params):
            pc = ctx.params[i]
        elif ctx.repeat is not None:
            pc = ctx.repeat
        else:
            continue
        cdt, err = _node_dtype(child)
        if err is not None:
            continue  # the child's own check reports it
        is_lit = isinstance(child, E.Literal)
        if pc.lit_required and not is_lit:
            reasons.append(
                f"{name}: {pc.name} must be a literal value")
            continue
        detail = pc.sig.check(cdt, conf, is_literal=is_lit)
        if detail is not None:
            reasons.append(
                f"{name}: {pc.name} {detail} in the {context} context")
    odt, err = _node_dtype(node)
    if err is not None:
        reasons.append(f"{name}: {err}")
    elif not reasons and not isinstance(node, E.Cast):
        # output cell (skipped when an input already failed — the result
        # type follows from the inputs; cast outputs are the cast grid's)
        detail = ctx.output.check(odt, conf,
                                  is_literal=isinstance(node, E.Literal))
        if detail is not None:
            reasons.append(
                f"{name}: produces {detail} in the {context} context")
    if checks.tag is not None:
        try:
            reasons.extend(checks.tag(node, conf))
        except (TypeError, ValueError) as e:
            reasons.append(f"{name}: {e}")
    return reasons


def check_expr(bound: E.Expression, conf: RapidsConf,
               context: str = PROJECT) -> List[str]:
    """Walk a BOUND expression tree; every reason it cannot lower, each
    naming the rule, parameter, and offending type. Empty = ON_TPU."""
    reasons: List[str] = []
    seen = set()

    def visit(node: E.Expression, ctx: str):
        if isinstance(node, (A.AggregateExpression,)):
            # the holder's function/inputs are checked by check_aggregate
            # in the aggregation context; seeing one anywhere else is a
            # planner bug surfaced as a reason, not a crash
            if ctx != AGGREGATION:
                reasons.append(
                    "AggregateExpression: aggregates are only supported "
                    "in the aggregation context")
            node_ctx = AGGREGATION
        else:
            node_ctx = ctx
        for r in check_node(node, conf, node_ctx):
            if r not in seen:
                seen.add(r)
                reasons.append(r)
        for c in node.children:
            visit(c, node_ctx)

    visit(bound, context)
    return reasons


# ---------------------------------------------------------------------------
# Cross-check bookkeeping (the matrix verdict against the lowering probe,
# behind spark.rapids.tpu.sql.matrix.probeCrossCheck.enabled; reference
# ``typechecks.py:915-940``)
# ---------------------------------------------------------------------------
_CROSS_CHECK_LOG: List[str] = []
_CROSS_CHECK_MAX = 256


def note_cross_check_disagreement(msg: str) -> None:
    if len(_CROSS_CHECK_LOG) < _CROSS_CHECK_MAX:
        _CROSS_CHECK_LOG.append(msg)


def cross_check_log() -> List[str]:
    return list(_CROSS_CHECK_LOG)


def clear_cross_check_log() -> None:
    _CROSS_CHECK_LOG.clear()
