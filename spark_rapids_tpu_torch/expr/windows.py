"""Window expressions (own copy of ``spark_rapids_tpu/expr/windows.py``).

The classes serve the session planner, the CPU engine and the device
window exec (``exec/window.py``).

Reference analog: GpuWindowExpression.scala:784 — window function + spec
(partition/order/frame) with frame validation; GpuRowNumber (:712),
GpuLead/GpuLag (:758,:772), and aggregate-over-window lowering (:709).

Frames supported (same initial set the reference validates for):
  * ROWS/RANGE UNBOUNDED PRECEDING .. CURRENT ROW  ("running"; RANGE
    includes the full peer group, Spark's default when ORDER BY is set)
  * UNBOUNDED PRECEDING .. UNBOUNDED FOLLOWING     (whole partition,
    Spark's default without ORDER BY)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .. import types as T
from ..types import DataType
from . import expressions as E
from .aggregates import AggregateFunction

ROWS = "rows"
RANGE = "range"

UNBOUNDED_PRECEDING = "unbounded_preceding"
CURRENT_ROW = "current_row"
UNBOUNDED_FOLLOWING = "unbounded_following"


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """Frame bounds. ``lower``/``upper`` are the sentinels above, or — for
    ROWS frames — int offsets from the current row (negative = preceding,
    e.g. ROWS BETWEEN 2 PRECEDING AND CURRENT ROW -> lower=-2, upper=0),
    matching the reference's literal row-frame bounds requirement
    (GpuWindowExpression.scala:451)."""

    frame_type: str = RANGE
    lower: object = UNBOUNDED_PRECEDING
    upper: object = CURRENT_ROW

    @property
    def is_running(self) -> bool:
        return (
            self.lower == UNBOUNDED_PRECEDING and self.upper == CURRENT_ROW
        )

    @property
    def is_whole_partition(self) -> bool:
        return (
            self.lower == UNBOUNDED_PRECEDING
            and self.upper == UNBOUNDED_FOLLOWING
        )

    @property
    def is_bounded_rows(self) -> bool:
        """Literal ROWS frame (current row = offset 0)."""
        lo = 0 if self.lower == CURRENT_ROW else self.lower
        hi = 0 if self.upper == CURRENT_ROW else self.upper
        return (
            self.frame_type == ROWS
            and isinstance(lo, int) and isinstance(hi, int) and lo <= hi
        )

    def row_bounds(self):
        lo = 0 if self.lower == CURRENT_ROW else self.lower
        hi = 0 if self.upper == CURRENT_ROW else self.upper
        return int(lo), int(hi)

    @property
    def is_bounded_range(self) -> bool:
        """Literal RANGE frame over the ORDER BY key VALUE: lower/upper
        are numeric offsets (preceding = negative, like row_bounds) or
        one-sided sentinels. Reference: RangeFrame handling in
        GpuWindowExpression.scala:88,168."""
        if self.frame_type != RANGE:
            return False
        if self.is_running or self.is_whole_partition:
            return False  # cheaper dedicated kernels handle these
        lo_ok = self.lower in (UNBOUNDED_PRECEDING, CURRENT_ROW) or \
            isinstance(self.lower, (int, float))
        hi_ok = self.upper in (UNBOUNDED_FOLLOWING, CURRENT_ROW) or \
            isinstance(self.upper, (int, float))
        return lo_ok and hi_ok

    def range_bounds(self):
        """(lo, hi) numeric key-value offsets; None = unbounded side;
        CURRENT ROW = offset 0 (the frame then starts/ends at the peer
        boundary, which the value search finds naturally)."""
        lo = (None if self.lower == UNBOUNDED_PRECEDING
              else 0 if self.lower == CURRENT_ROW else self.lower)
        hi = (None if self.upper == UNBOUNDED_FOLLOWING
              else 0 if self.upper == CURRENT_ROW else self.upper)
        return lo, hi


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """PARTITION BY / ORDER BY / frame."""

    partition_by: Tuple[E.Expression, ...] = ()
    order_by: Tuple[E.Expression, ...] = ()
    #: (ascending, nulls_first|None) per order key
    orders: Tuple[Tuple[bool, Optional[bool]], ...] = ()
    frame: Optional[WindowFrame] = None

    def resolved_frame(self) -> WindowFrame:
        if self.frame is not None:
            return self.frame
        # Spark defaults: with ORDER BY -> RANGE UNBOUNDED..CURRENT;
        # without -> whole partition
        if self.order_by:
            return WindowFrame(RANGE, UNBOUNDED_PRECEDING, CURRENT_ROW)
        return WindowFrame(RANGE, UNBOUNDED_PRECEDING, UNBOUNDED_FOLLOWING)


class WindowFunction(E.Expression):
    """Marker base for ranking/offset window functions."""


@dataclasses.dataclass(frozen=True)
class RowNumber(WindowFunction):
    @property
    def dtype(self):
        return T.INT

    @property
    def nullable(self):
        return False


@dataclasses.dataclass(frozen=True)
class Rank(WindowFunction):
    @property
    def dtype(self):
        return T.INT

    @property
    def nullable(self):
        return False


@dataclasses.dataclass(frozen=True)
class DenseRank(WindowFunction):
    @property
    def dtype(self):
        return T.INT

    @property
    def nullable(self):
        return False


@dataclasses.dataclass(frozen=True)
class Lead(WindowFunction):
    child: E.Expression = None  # type: ignore[assignment]
    offset: int = 1
    default: Optional[E.Expression] = None

    @property
    def dtype(self):
        return self.child.dtype


@dataclasses.dataclass(frozen=True)
class Lag(WindowFunction):
    child: E.Expression = None  # type: ignore[assignment]
    offset: int = 1
    default: Optional[E.Expression] = None

    @property
    def dtype(self):
        return self.child.dtype


@dataclasses.dataclass(frozen=True)
class WindowExpression(E.Expression):
    """function OVER spec (reference: GpuWindowExpression)."""

    func: E.Expression = None  # type: ignore[assignment]  # WindowFunction | AggregateFunction
    spec: WindowSpec = WindowSpec()
    name: str = ""

    @property
    def dtype(self):
        return self.func.dtype

    def resolved_name(self) -> str:
        return self.name or f"{type(self.func).__name__.lower()}_over"
