"""Expression trees, the ported subset of the reference.

Counterpart of ``spark_rapids_tpu/expr/expressions.py``: the same frozen
dataclasses, names and result-type rules (the decimal ones included) for
the nodes the port lowers (``expr/eval.py``, ``expr/eval_strings.py``,
``expr/eval_datetime.py``), plus the nondeterministic and metadata nodes,
which exist so plans and the CPU engine can name them and raise
``NotImplementedError`` when lowered to the device. Structural equality
and hashing come from the dataclasses, as in the reference.
"""
from __future__ import annotations

import dataclasses
import decimal as _dec
from typing import Any, Optional, Tuple

from .. import types as T
from ..types import DataType


class Expression:
    """Base node. Subclasses are frozen dataclasses; `children` is derived."""

    @property
    def children(self) -> Tuple["Expression", ...]:
        return tuple(
            v
            for f in dataclasses.fields(self)  # type: ignore[arg-type]
            for v in _as_children(getattr(self, f.name))
        )

    @property
    def dtype(self) -> DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return True

    @property
    def pretty_name(self) -> str:
        return type(self).__name__

    def transform(self, fn):
        """Bottom-up rewrite: rebuild this node with transformed children."""
        if not dataclasses.is_dataclass(self):
            return fn(self)
        changes = {}
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            v = getattr(self, f.name)
            nv = _transform_value(v, fn)
            if nv is not v:
                changes[f.name] = nv
        node = dataclasses.replace(self, **changes) if changes else self
        return fn(node)

    def __str__(self):
        return repr(self)


def _as_children(v):
    if isinstance(v, Expression):
        yield v
    elif isinstance(v, tuple):
        for x in v:
            if isinstance(x, Expression):
                yield x
            elif isinstance(x, tuple):
                yield from _as_children(x)


def _transform_value(v, fn):
    if isinstance(v, Expression):
        return v.transform(fn)
    if isinstance(v, tuple):
        new = tuple(_transform_value(x, fn) for x in v)
        return new if any(n is not o for n, o in zip(new, v)) else v
    return v


@dataclasses.dataclass(frozen=True)
class Literal(Expression):
    value: Any
    data_type: DataType

    @property
    def dtype(self):
        return self.data_type

    @property
    def nullable(self):
        return self.value is None

    @staticmethod
    def of(value: Any) -> "Literal":
        if value is None:
            return Literal(None, T.NULL)
        if isinstance(value, bool):
            return Literal(value, T.BOOLEAN)
        if isinstance(value, int):
            return Literal(value,
                           T.INT if -(2**31) <= value < 2**31 else T.LONG)
        if isinstance(value, float):
            return Literal(value, T.DOUBLE)
        if isinstance(value, str):
            return Literal(value, T.STRING)
        if isinstance(value, bytes):
            return Literal(value, T.BINARY)
        if isinstance(value, _dec.Decimal):
            # Spark literal decimals take their written precision/scale
            t = value.as_tuple()
            scale = max(0, -t.exponent)
            digits = max(len(t.digits) + max(0, t.exponent), scale + 1)
            return Literal(value, T.DecimalType(min(digits, 18), scale))
        raise TypeError(f"cannot make literal from {type(value)}")


@dataclasses.dataclass(frozen=True)
class UnresolvedAttribute(Expression):
    name: str

    @property
    def dtype(self):
        raise ValueError(f"unresolved attribute {self.name}")


@dataclasses.dataclass(frozen=True)
class BoundReference(Expression):
    ordinal: int
    data_type: DataType
    is_nullable: bool = True

    @property
    def dtype(self):
        return self.data_type

    @property
    def nullable(self):
        return self.is_nullable


@dataclasses.dataclass(frozen=True)
class Alias(Expression):
    child: Expression
    name: str

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return self.child.nullable


@dataclasses.dataclass(frozen=True)
class _BinaryNumeric(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self):
        lt, rt = self.left.dtype, self.right.dtype
        if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
            op = {"+": "add", "-": "sub", "*": "mul"}[self.symbol]
            return T.decimal_binary_result(op, lt, rt)
        return T.promote(lt, rt)


class Add(_BinaryNumeric):
    symbol = "+"


class Subtract(_BinaryNumeric):
    symbol = "-"


class Multiply(_BinaryNumeric):
    symbol = "*"


@dataclasses.dataclass(frozen=True)
class Divide(Expression):
    """Spark `/`: floating point, except decimal/decimal which follows
    DecimalPrecision division rules; x/0 -> NULL (non-ANSI)."""

    left: Expression
    right: Expression

    @property
    def dtype(self):
        lt, rt = self.left.dtype, self.right.dtype
        if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
            return T.decimal_binary_result("div", lt, rt)
        return T.DOUBLE


@dataclasses.dataclass(frozen=True)
class IntegralDivide(Expression):
    """Spark `div`: long division, x div 0 -> NULL."""

    left: Expression
    right: Expression

    @property
    def dtype(self):
        return T.LONG


class Remainder(_BinaryNumeric):
    """Spark %: sign follows dividend (Java), x % 0 -> NULL."""

    symbol = "%"


@dataclasses.dataclass(frozen=True)
class _BinaryComparison(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self):
        return T.BOOLEAN


class EqualTo(_BinaryComparison):
    symbol = "="


class EqualNullSafe(_BinaryComparison):
    """<=>: nulls compare equal, never returns null."""

    symbol = "<=>"

    @property
    def nullable(self):
        return False


class LessThan(_BinaryComparison):
    symbol = "<"


class LessThanOrEqual(_BinaryComparison):
    symbol = "<="


class GreaterThan(_BinaryComparison):
    symbol = ">"


class GreaterThanOrEqual(_BinaryComparison):
    symbol = ">="


@dataclasses.dataclass(frozen=True)
class And(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class Or(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class Not(Expression):
    child: Expression

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class IsNull(Expression):
    child: Expression

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False


@dataclasses.dataclass(frozen=True)
class IsNotNull(Expression):
    child: Expression

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False


@dataclasses.dataclass(frozen=True)
class Coalesce(Expression):
    exprs: Tuple[Expression, ...]

    @property
    def dtype(self):
        dt = self.exprs[0].dtype
        for e in self.exprs[1:]:
            if e.dtype != T.NULL:
                if dt == T.NULL:
                    dt = e.dtype
                elif e.dtype != dt and dt.is_numeric and e.dtype.is_numeric:
                    dt = T.promote(dt, e.dtype)
        return dt


@dataclasses.dataclass(frozen=True)
class If(Expression):
    predicate: Expression
    true_value: Expression
    false_value: Expression

    @property
    def dtype(self):
        dt = self.true_value.dtype
        if dt == T.NULL:
            return self.false_value.dtype
        o = self.false_value.dtype
        if o != T.NULL and o != dt:
            return T.promote(dt, o)
        return dt


@dataclasses.dataclass(frozen=True)
class CaseWhen(Expression):
    branches: Tuple[Tuple[Expression, Expression], ...]
    else_value: Optional[Expression] = None

    @property
    def dtype(self):
        dt = T.NULL
        vals = [v for _, v in self.branches]
        if self.else_value is not None:
            vals.append(self.else_value)
        for v in vals:
            if v.dtype != T.NULL:
                dt = v.dtype if dt == T.NULL else (
                    T.promote(dt, v.dtype) if v.dtype != dt else dt)
        return dt


@dataclasses.dataclass(frozen=True)
class Cast(Expression):
    child: Expression
    to: DataType
    ansi: bool = False

    @property
    def dtype(self):
        return self.to


# ---------------------------------------------------------------------------
# Strings (reference: expressions.py:782-1051)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Length(Expression):
    """Character length (UTF-8 code points, not bytes)."""

    child: Expression

    @property
    def dtype(self):
        return T.INT


@dataclasses.dataclass(frozen=True)
class _UnaryString(Expression):
    child: Expression

    @property
    def dtype(self):
        return T.STRING


class Upper(_UnaryString):
    pass


class Lower(_UnaryString):
    pass


class InitCap(_UnaryString):
    pass


@dataclasses.dataclass(frozen=True)
class Substring(Expression):
    """1-based, character-indexed, with UTF8String.substringSQL's rules
    for position 0 and negative positions; pos and len are literals."""

    str: Expression
    pos: Expression
    len: Expression

    @property
    def dtype(self):
        return T.STRING


@dataclasses.dataclass(frozen=True)
class Concat(Expression):
    """Null if any input is null."""

    children_: Tuple[Expression, ...]

    @property
    def dtype(self):
        return T.STRING


@dataclasses.dataclass(frozen=True)
class _TrimBase(Expression):
    column: Expression
    trim_str: Optional[str] = None  # None = trim ASCII space (Spark default)

    @property
    def dtype(self):
        return T.STRING


class StringTrim(_TrimBase):
    pass


class StringTrimLeft(_TrimBase):
    pass


class StringTrimRight(_TrimBase):
    pass


@dataclasses.dataclass(frozen=True)
class _BinaryStringPredicate(Expression):
    """left: a string column; right: a string literal."""

    left: Expression
    right: Expression

    @property
    def dtype(self):
        return T.BOOLEAN


class StartsWith(_BinaryStringPredicate):
    pass


class EndsWith(_BinaryStringPredicate):
    pass


class Contains(_BinaryStringPredicate):
    pass


@dataclasses.dataclass(frozen=True)
class Like(Expression):
    left: Expression
    pattern: Expression
    escape: str = "\\"

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class RLike(Expression):
    left: Expression
    pattern: Expression

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class StringLocate(Expression):
    substr: Expression
    str: Expression
    start: Expression

    @property
    def dtype(self):
        return T.INT


@dataclasses.dataclass(frozen=True)
class _ThreeArgString(Expression):
    str: Expression

    @property
    def dtype(self):
        return T.STRING


@dataclasses.dataclass(frozen=True)
class StringReplace(_ThreeArgString):
    search: Expression
    replacement: Expression


@dataclasses.dataclass(frozen=True)
class RegExpReplace(_ThreeArgString):
    pattern: Expression
    replacement: Expression


@dataclasses.dataclass(frozen=True)
class StringLPad(_ThreeArgString):
    len: Expression
    pad: Expression


@dataclasses.dataclass(frozen=True)
class StringRPad(_ThreeArgString):
    len: Expression
    pad: Expression


@dataclasses.dataclass(frozen=True)
class SubstringIndex(_ThreeArgString):
    delim: Expression
    count: Expression


@dataclasses.dataclass(frozen=True)
class StringSplitPart(_ThreeArgString):
    delim: Expression
    index: Expression


@dataclasses.dataclass(frozen=True)
class NativeUDF(Expression):
    """A native UDF (reference: RapidsUDF.java:22): a COLUMNAR function
    over the engine's column values (ColV / StrV), run inside the
    projection, plus the row function of the CPU fallback."""

    columnar_fn: Any
    row_fn: Any
    children_: Tuple[Expression, ...]
    return_type: DataType

    @property
    def dtype(self):
        return self.return_type


# ---------------------------------------------------------------------------
# Nodes copied from the reference for the session planner and the CPU
# engine: the math, bitwise and predicate families (lowered in
# expr/eval.py), date/time and nondeterministic nodes (the CPU engine
# evaluates them; device lowering raises naming their ROADMAP items),
# the decimal evaluation helpers of the aggregates, and PythonUDF.
# ---------------------------------------------------------------------------
class Pmod(_BinaryNumeric):
    """Positive modulo."""


@dataclasses.dataclass(frozen=True)
class UnaryMinus(Expression):
    child: Expression

    @property
    def dtype(self):
        return self.child.dtype


@dataclasses.dataclass(frozen=True)
class UnaryPositive(Expression):
    child: Expression

    @property
    def dtype(self):
        return self.child.dtype


@dataclasses.dataclass(frozen=True)
class Abs(Expression):
    child: Expression

    @property
    def dtype(self):
        return self.child.dtype


@dataclasses.dataclass(frozen=True)
class In(Expression):
    child: Expression
    values: Tuple[Any, ...]  # python scalar values (may include None)

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class IsNan(Expression):
    child: Expression

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False


@dataclasses.dataclass(frozen=True)
class NaNvl(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self):
        return self.left.dtype


@dataclasses.dataclass(frozen=True)
class _UnaryMathDouble(Expression):
    child: Expression

    @property
    def dtype(self):
        return T.DOUBLE


class Sqrt(_UnaryMathDouble):
    pass


class Exp(_UnaryMathDouble):
    pass


class Log(_UnaryMathDouble):
    """Natural log; log(x<=0) -> NULL (Spark)."""


class Log10(_UnaryMathDouble):
    pass


class Log2(_UnaryMathDouble):
    pass


class Log1p(_UnaryMathDouble):
    pass


class Sin(_UnaryMathDouble):
    pass


class Cos(_UnaryMathDouble):
    pass


class Tan(_UnaryMathDouble):
    pass


class Asin(_UnaryMathDouble):
    pass


class Acos(_UnaryMathDouble):
    pass


class Atan(_UnaryMathDouble):
    pass


class Sinh(_UnaryMathDouble):
    pass


class Cosh(_UnaryMathDouble):
    pass


class Tanh(_UnaryMathDouble):
    pass


class Cbrt(_UnaryMathDouble):
    pass


class Expm1(_UnaryMathDouble):
    pass


class ToDegrees(_UnaryMathDouble):
    pass


class ToRadians(_UnaryMathDouble):
    pass


@dataclasses.dataclass(frozen=True)
class Floor(Expression):
    child: Expression

    @property
    def dtype(self):
        return T.LONG if self.child.dtype.is_floating else self.child.dtype


@dataclasses.dataclass(frozen=True)
class Ceil(Expression):
    child: Expression

    @property
    def dtype(self):
        return T.LONG if self.child.dtype.is_floating else self.child.dtype


@dataclasses.dataclass(frozen=True)
class Round(Expression):
    """HALF_UP rounding, matching Spark's BigDecimal semantics on doubles."""

    child: Expression
    scale: int = 0

    @property
    def dtype(self):
        return self.child.dtype


@dataclasses.dataclass(frozen=True)
class Pow(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self):
        return T.DOUBLE


@dataclasses.dataclass(frozen=True)
class Atan2(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self):
        return T.DOUBLE


@dataclasses.dataclass(frozen=True)
class Signum(Expression):
    child: Expression

    @property
    def dtype(self):
        return T.DOUBLE


@dataclasses.dataclass(frozen=True)
class Rint(Expression):
    child: Expression

    @property
    def dtype(self):
        return T.DOUBLE


class BitwiseAnd(_BinaryNumeric):
    symbol = "&"


class BitwiseOr(_BinaryNumeric):
    symbol = "|"


class BitwiseXor(_BinaryNumeric):
    symbol = "^"


@dataclasses.dataclass(frozen=True)
class BitwiseNot(Expression):
    child: Expression

    @property
    def dtype(self):
        return self.child.dtype


@dataclasses.dataclass(frozen=True)
class ShiftLeft(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self):
        return self.left.dtype


@dataclasses.dataclass(frozen=True)
class ShiftRight(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self):
        return self.left.dtype


@dataclasses.dataclass(frozen=True)
class ShiftRightUnsigned(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self):
        return self.left.dtype


@dataclasses.dataclass(frozen=True)
class Rand(Expression):
    """rand(seed): uniform [0, 1) doubles, deterministic per
    (seed, partition, row) — a counter-based generator rather than the
    JVM's sequential XORShift (the TPU-native design, same guarantee
    Spark documents: reproducible given the seed and partitioning;
    reference: GpuRandomExpressions.scala:31)."""

    seed: int = 0

    @property
    def dtype(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return False


@dataclasses.dataclass(frozen=True)
class MonotonicallyIncreasingID(Expression):
    """(partition_id << 33) + row_index_in_partition — Spark's exact
    layout (reference: GpuMonotonicallyIncreasingID.scala)."""

    @property
    def dtype(self):
        return T.LONG

    @property
    def nullable(self):
        return False


@dataclasses.dataclass(frozen=True)
class SparkPartitionID(Expression):
    """Current partition index (reference: GpuSparkPartitionID.scala)."""

    @property
    def dtype(self):
        return T.INT

    @property
    def nullable(self):
        return False


@dataclasses.dataclass(frozen=True)
class InputFileName(Expression):
    """Path of the file being scanned, or '' when the source is not a
    file scan (reference: GpuInputFileBlock.scala — same empty-string
    contract as Spark's InputFileName)."""

    @property
    def dtype(self):
        return T.STRING

    @property
    def nullable(self):
        return False


@dataclasses.dataclass(frozen=True)
class Murmur3Hash(Expression):
    """hash(cols...): Spark's murmur3_32 with seed 42, int32 result
    (reference: HashFunctions.scala:43 GpuMurmur3Hash; kernel:
    ops/hashing.py murmur3)."""

    exprs: Tuple[Expression, ...]
    seed: int = 42

    @property
    def dtype(self):
        return T.INT

    @property
    def nullable(self):
        return False


NONDETERMINISTIC_CONTEXT_EXPRS = (
    Rand, MonotonicallyIncreasingID, SparkPartitionID, InputFileName)


def has_context_expr(e: Expression) -> bool:
    """True when the tree contains a partition-context expression (these
    evaluate at the exec boundary, like Spark pulling nondeterministic
    expressions into their own Project)."""
    if isinstance(e, NONDETERMINISTIC_CONTEXT_EXPRS):
        return True
    return any(has_context_expr(c) for c in e.children)


@dataclasses.dataclass(frozen=True)
class _DecimalSumCheck(Expression):
    """Internal: nullOnOverflow for decimal SUM results — validity clears
    when the accumulated unscaled value needs more digits than the result
    precision (Spark's CheckOverflow around Sum, decimalExpressions.scala)."""

    child: Expression
    result: "T.DecimalType" = None  # type: ignore[assignment]

    @property
    def dtype(self):
        return self.result


@dataclasses.dataclass(frozen=True)
class _DecimalAvgEval(Expression):
    """Internal: decimal AVERAGE finalization — sum/count rounded HALF_UP
    at the Spark result scale (s+4), computed exactly in int64 by long
    division + scaled-remainder division (no 128-bit intermediate)."""

    sum: Expression
    count: Expression
    result: "T.DecimalType" = None  # type: ignore[assignment]

    @property
    def dtype(self):
        return self.result


@dataclasses.dataclass(frozen=True)
class _DateUnary(Expression):
    child: Expression

    @property
    def dtype(self):
        return T.INT


class Year(_DateUnary):
    """reference: GpuYear (datetimeExpressions.scala:112)"""


class Quarter(_DateUnary):
    """reference: GpuQuarter (datetimeExpressions.scala:254)"""


class Month(_DateUnary):
    """reference: GpuMonth (datetimeExpressions.scala:269)"""


class DayOfMonth(_DateUnary):
    """reference: GpuDayOfMonth (datetimeExpressions.scala:274)"""


class DayOfYear(_DateUnary):
    """reference: GpuDayOfYear (datetimeExpressions.scala:279)"""


class DayOfWeek(_DateUnary):
    """1 = Sunday .. 7 = Saturday (reference: GpuDayOfWeek
    datetimeExpressions.scala:63)."""


class WeekDay(_DateUnary):
    """0 = Monday .. 6 = Sunday (reference: GpuWeekDay
    datetimeExpressions.scala:51)."""


class Hour(_DateUnary):
    """reference: GpuHour (datetimeExpressions.scala:102), UTC only"""


class Minute(_DateUnary):
    """reference: GpuMinute (datetimeExpressions.scala:82), UTC only"""


class Second(_DateUnary):
    """reference: GpuSecond (datetimeExpressions.scala:92), UTC only"""


@dataclasses.dataclass(frozen=True)
class DateAdd(Expression):
    """reference: GpuDateAdd (datetimeExpressions.scala:701)"""

    start_date: Expression
    days: Expression

    @property
    def dtype(self):
        return T.DATE


@dataclasses.dataclass(frozen=True)
class DateSub(Expression):
    """reference: GpuDateSub (datetimeExpressions.scala:690)"""

    start_date: Expression
    days: Expression

    @property
    def dtype(self):
        return T.DATE


@dataclasses.dataclass(frozen=True)
class DateDiff(Expression):
    """end - start in days (reference: GpuDateDiff
    datetimeExpressions.scala:206)."""

    end_date: Expression
    start_date: Expression

    @property
    def dtype(self):
        return T.INT


@dataclasses.dataclass(frozen=True)
class LastDay(Expression):
    """Last day of the month (reference: GpuLastDay
    datetimeExpressions.scala:711)."""

    start_date: Expression

    @property
    def dtype(self):
        return T.DATE


@dataclasses.dataclass(frozen=True)
class UnixTimestamp(Expression):
    """Seconds since epoch of a DATE/TIMESTAMP column (reference:
    GpuUnixTimestamp datetimeExpressions.scala:543; string parsing is the
    gated GpuToTimestamp path, not supported here)."""

    child: Expression

    @property
    def dtype(self):
        return T.LONG


class ToUnixTimestamp(UnixTimestamp):
    """reference: GpuToUnixTimestamp (datetimeExpressions.scala:558)"""


@dataclasses.dataclass(frozen=True)
class FromUnixTime(Expression):
    """Format seconds-since-epoch as a string; only the default
    'yyyy-MM-dd HH:mm:ss' format (reference: GpuFromUnixTime
    datetimeExpressions.scala:603 has the same literal-format restriction)."""

    sec: Expression
    format: Expression

    @property
    def dtype(self):
        return T.STRING


@dataclasses.dataclass(frozen=True)
class TimeAdd(Expression):
    """timestamp + literal interval with zero months (reference: GpuTimeAdd
    datetimeExpressions.scala:178 — same months==0 restriction).
    ``days``/``microseconds`` are the interval payload."""

    start: Expression
    days: int
    microseconds: int

    @property
    def dtype(self):
        return T.TIMESTAMP


@dataclasses.dataclass(frozen=True)
class TruncDate(Expression):
    """trunc(date, fmt) for fmt in year/yyyy/yy/quarter/month/mon/mm/week."""

    date: Expression
    fmt: Expression

    @property
    def dtype(self):
        return T.DATE


@dataclasses.dataclass(frozen=True)
class PythonUDF(Expression):
    """A user Python function over scalar args. The planner's resolution
    pass (sql/session.py) replaces it with bytecode-compiled engine
    expressions when spark.rapids.tpu.sql.udfCompiler.enabled; otherwise it
    evaluates row-by-row in the CPU interpreter (fallback)."""

    func: Any
    children_: Tuple[Expression, ...]
    return_type: Optional[DataType] = None

    @property
    def dtype(self):
        if self.return_type is not None:
            return self.return_type
        # infer from a best-effort: assume numeric double unless annotated
        import typing

        try:
            hints = typing.get_type_hints(self.func) if callable(
                self.func) else {}
        except Exception:  # unresolvable forward refs etc.
            hints = {}
        r = hints.get("return")
        m = {int: T.LONG, float: T.DOUBLE, bool: T.BOOLEAN, str: T.STRING}
        return m.get(r, T.DOUBLE)

    @property
    def pretty_name(self):
        return f"pythonUDF({getattr(self.func, '__name__', '?')})"



def bind_references(expr: Expression, schema: T.StructType) -> Expression:
    """Replace UnresolvedAttribute with BoundReference by schema position."""

    def rewrite(node):
        if isinstance(node, UnresolvedAttribute):
            i = schema.field_index(node.name)
            f = schema.fields[i]
            return BoundReference(i, f.dataType, f.nullable)
        return node

    return expr.transform(rewrite)


def col(name: str) -> UnresolvedAttribute:
    return UnresolvedAttribute(name)


def lit(value: Any) -> Literal:
    return Literal.of(value)
