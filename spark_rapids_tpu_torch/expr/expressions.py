"""Expression trees, the ported subset of the reference.

Counterpart of ``spark_rapids_tpu/expr/expressions.py``: the same frozen
dataclasses, names and result-type rules for the nodes the port lowers
(``expr/eval.py``, ``expr/eval_strings.py``), plus the reference's other
string nodes, which exist so plans can name them and raise
``NotImplementedError`` when lowered. Structural equality and hashing
come from the dataclasses, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from .. import types as T
from ..types import DataType


class Expression:
    """Base node. Subclasses are frozen dataclasses; `children` is derived."""

    @property
    def dtype(self) -> DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return True

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
        raise NotImplementedError(
            f"literal of {type(value).__name__} is {T.NOT_PORTED_TYPES}")


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
        return T.promote(self.left.dtype, self.right.dtype)


class Add(_BinaryNumeric):
    symbol = "+"


class Subtract(_BinaryNumeric):
    symbol = "-"


class Multiply(_BinaryNumeric):
    symbol = "*"


@dataclasses.dataclass(frozen=True)
class Divide(Expression):
    """Spark `/`: floating point; x/0 -> NULL (non-ANSI)."""

    left: Expression
    right: Expression

    @property
    def dtype(self):
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


#: string nodes the port does not lower yet (ROADMAP.md, queue A item
#: 'Other string expressions')
NOT_PORTED_STRING_NODES = (InitCap, Like, RLike, StringLocate, StringReplace,
                           RegExpReplace, StringLPad, StringRPad,
                           SubstringIndex, StringSplitPart)


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
