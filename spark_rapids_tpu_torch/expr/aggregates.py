"""Declarative aggregate functions.

Counterpart of ``spark_rapids_tpu/expr/aggregates.py``: Count, Sum,
Average, Min, Max, First and Last with the same ``update_ops``,
``merge_ops``, buffer schemas and ``evaluate`` projections, and the
PARTIAL/FINAL/COMPLETE modes. The kernel op names are the ones
``ops/groupby.segment_reduce`` understands. A decimal ``sum`` buffers in
``decimal(p+10, s)`` (int64 unscaled, so the integer sum tiers take it)
and finishes through ``_DecimalSumCheck``; a decimal ``avg`` finishes as
``decimal(p+4, s+4)`` through ``_DecimalAvgEval``. Past DECIMAL64 either
raises ``TypeError``, which the planner reads as a fallback reason.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .. import types as T
from ..types import DataType
from . import expressions as E

PARTIAL = "partial"
FINAL = "final"
COMPLETE = "complete"


class AggregateFunction(E.Expression):
    """Base class; subclasses are frozen dataclasses with a child expr."""

    #: number of buffer columns (static per class so FINAL-mode execs can
    #: recover the layout from a partial exec's output schema positionally)
    num_buffers: int = 1

    @property
    def input(self) -> Optional[E.Expression]:
        return getattr(self, "child", None)

    @property
    def buffer_schema(self) -> Tuple[DataType, ...]:
        raise NotImplementedError

    @property
    def update_ops(self) -> Tuple[Tuple[str, Optional[E.Expression]], ...]:
        raise NotImplementedError

    @property
    def merge_ops(self) -> Tuple[str, ...]:
        raise NotImplementedError

    def evaluate(self, buffer_refs: Tuple[E.Expression, ...]) -> E.Expression:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Count(AggregateFunction):
    """count(expr) / count(*) -> bigint, never null."""

    child: Optional[E.Expression] = None  # None = count(*)

    @property
    def dtype(self):
        return T.LONG

    @property
    def nullable(self):
        return False

    @property
    def buffer_schema(self):
        return (T.LONG,)

    @property
    def update_ops(self):
        if self.child is None:
            return (("count_star", None),)
        return (("count", self.child),)

    @property
    def merge_ops(self):
        return ("sum",)

    def evaluate(self, refs):
        return E.Coalesce((refs[0], E.Literal(0, T.LONG)))


def _sum_result_type(dt: DataType) -> DataType:
    if isinstance(dt, T.DecimalType):
        # Spark: sum(decimal(p,s)) = decimal(p+10, s). Past DECIMAL64 the
        # aggregate tags unsupported and falls back (an int64 buffer
        # could wrap into a wrong non-null answer), as in the reference
        if dt.precision + 10 > T.DecimalType.MAX_PRECISION:
            raise TypeError(
                f"sum({dt}) buffer needs precision {dt.precision + 10} > "
                f"DECIMAL64 cap {T.DecimalType.MAX_PRECISION}")
        return T.DecimalType(dt.precision + 10, dt.scale)
    if dt.is_integral or isinstance(dt, T.BooleanType):
        return T.LONG
    return T.DOUBLE


def merge_input_type(f: "AggregateFunction", buffer_dtype: DataType
                     ) -> DataType:
    """The input type a FINAL aggregate binds its function to, given its
    first buffer column's type: that type itself, except that a decimal
    sum or average buffers ``decimal(p+10, s)`` for an input
    ``decimal(p, s)``, which it stands for here. Bound to the buffer
    type, the merge would widen it by 10 digits again and pass DECIMAL64;
    the reference does, so its partitioned decimal sums raise
    (ROADMAP.md §C)."""
    if isinstance(f, (Sum, Average)) and isinstance(buffer_dtype,
                                                    T.DecimalType):
        return T.DecimalType(buffer_dtype.precision - 10, buffer_dtype.scale)
    return buffer_dtype


@dataclasses.dataclass(frozen=True)
class Sum(AggregateFunction):
    """sum(expr): long for integral input, double for floating (Spark)."""

    child: E.Expression = None  # type: ignore[assignment]

    @property
    def dtype(self):
        return _sum_result_type(self.child.dtype)

    @property
    def buffer_schema(self):
        return (self.dtype,)

    @property
    def update_ops(self):
        return (("sum", E.Cast(self.child, self.dtype)),)

    @property
    def merge_ops(self):
        return ("sum",)

    def evaluate(self, refs):
        if isinstance(self.dtype, T.DecimalType):
            # Spark wraps decimal sums in CheckOverflow (nullOnOverflow)
            return E._DecimalSumCheck(refs[0], self.dtype)
        return refs[0]


@dataclasses.dataclass(frozen=True)
class Min(AggregateFunction):
    child: E.Expression = None  # type: ignore[assignment]

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def buffer_schema(self):
        return (self.dtype,)

    @property
    def update_ops(self):
        return (("min", self.child),)

    @property
    def merge_ops(self):
        return ("min",)

    def evaluate(self, refs):
        return refs[0]


@dataclasses.dataclass(frozen=True)
class Max(AggregateFunction):
    child: E.Expression = None  # type: ignore[assignment]

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def buffer_schema(self):
        return (self.dtype,)

    @property
    def update_ops(self):
        return (("max", self.child),)

    @property
    def merge_ops(self):
        return ("max",)

    def evaluate(self, refs):
        return refs[0]


@dataclasses.dataclass(frozen=True)
class Average(AggregateFunction):
    """avg(expr) -> double (decimal(p+4, s+4) for decimal input, Spark's
    rule); buffer = (sum, count: long) like Spark."""

    child: E.Expression = None  # type: ignore[assignment]
    num_buffers = 2

    def _decimal_in(self):
        dt = self.child.dtype
        return dt if isinstance(dt, T.DecimalType) else None

    @property
    def dtype(self):
        d = self._decimal_in()
        if d is not None:
            if d.precision + 4 > T.DecimalType.MAX_PRECISION:
                raise TypeError(
                    f"avg({d}) result precision {d.precision + 4} > "
                    f"DECIMAL64 cap")
            return T.DecimalType(d.precision + 4, d.scale + 4)
        return T.DOUBLE

    def _sum_type(self):
        d = self._decimal_in()
        if d is not None:
            return _sum_result_type(d)  # raises past DECIMAL64: fallback
        return T.DOUBLE

    @property
    def buffer_schema(self):
        return (self._sum_type(), T.LONG)

    @property
    def update_ops(self):
        return (("sum", E.Cast(self.child, self._sum_type())),
                ("count", self.child))

    @property
    def merge_ops(self):
        return ("sum", "sum")

    def evaluate(self, refs):
        if self._decimal_in() is not None:
            return E._DecimalAvgEval(refs[0], refs[1], self.dtype)
        # sum/count with count==0 -> null (Divide already nulls on 0)
        return E.Divide(refs[0], refs[1])


@dataclasses.dataclass(frozen=True)
class First(AggregateFunction):
    child: E.Expression = None  # type: ignore[assignment]
    ignore_nulls: bool = False

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def buffer_schema(self):
        return (self.dtype,)

    @property
    def update_ops(self):
        op = "first_ignorenulls" if self.ignore_nulls else "first"
        return ((op, self.child),)

    @property
    def merge_ops(self):
        return ("first_ignorenulls" if self.ignore_nulls else "first",)

    def evaluate(self, refs):
        return refs[0]


@dataclasses.dataclass(frozen=True)
class Last(AggregateFunction):
    child: E.Expression = None  # type: ignore[assignment]
    ignore_nulls: bool = False

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def buffer_schema(self):
        return (self.dtype,)

    @property
    def update_ops(self):
        op = "last_ignorenulls" if self.ignore_nulls else "last"
        return ((op, self.child),)

    @property
    def merge_ops(self):
        return ("last_ignorenulls" if self.ignore_nulls else "last",)

    def evaluate(self, refs):
        return refs[0]


@dataclasses.dataclass(frozen=True)
class AggregateExpression(E.Expression):
    """An aggregate function + mode + output name (Spark AggregateExpression)."""

    func: AggregateFunction
    mode: str = COMPLETE
    name: str = ""

    @property
    def dtype(self):
        return self.func.dtype

    def resolved_name(self) -> str:
        if self.name:
            return self.name
        fn = type(self.func).__name__.lower()
        c = self.func.input
        return f"{fn}({getattr(c, 'name', '*') if c is not None else '*'})"


def agg(func: AggregateFunction, name: str = "") -> AggregateExpression:
    return AggregateExpression(func, COMPLETE, name)
