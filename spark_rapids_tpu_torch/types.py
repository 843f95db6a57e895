"""SQL type system.

Counterpart of ``spark_rapids_tpu/types.py`` (same names, equality and
promotion rules), kept as an own copy: the port imports nothing of the
JAX package. Each fixed-width type maps onto one torch dtype
(:func:`torch_dtype`); string and binary columns are stored in the Arrow
layout (int32 offsets + uint8 chars + validity, :func:`is_string`).
Storage follows the reference exactly:

  * ``DecimalType(p <= 18, s)`` -> int64 unscaled values (DECIMAL64);
  * ``DateType``                -> int32 days since the unix epoch;
  * ``TimestampType``           -> int64 microseconds since the epoch, UTC.

Array and struct types exist so plans can name them; no column holds
them, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

class DataType:
    """Base of all SQL types. Instances are value objects."""

    name: str = "data"

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return self.name

    @property
    def simpleString(self) -> str:
        return self.name

    def to_numpy(self) -> np.dtype:
        raise NotImplementedError(self.name)

    @property
    def is_numeric(self) -> bool:
        return isinstance(self, (ByteType, ShortType, IntegerType, LongType,
                                 FloatType, DoubleType, DecimalType))

    @property
    def is_integral(self) -> bool:
        return isinstance(self, (ByteType, ShortType, IntegerType, LongType))

    @property
    def is_floating(self) -> bool:
        return isinstance(self, (FloatType, DoubleType))


class NullType(DataType):
    name = "null"

    def to_numpy(self):
        return np.dtype(np.bool_)


class BooleanType(DataType):
    name = "boolean"

    def to_numpy(self):
        return np.dtype(np.bool_)


class ByteType(DataType):
    name = "tinyint"

    def to_numpy(self):
        return np.dtype(np.int8)


class ShortType(DataType):
    name = "smallint"

    def to_numpy(self):
        return np.dtype(np.int16)


class IntegerType(DataType):
    name = "int"

    def to_numpy(self):
        return np.dtype(np.int32)


class LongType(DataType):
    name = "bigint"

    def to_numpy(self):
        return np.dtype(np.int64)


class FloatType(DataType):
    name = "float"

    def to_numpy(self):
        return np.dtype(np.float32)


class DoubleType(DataType):
    name = "double"

    def to_numpy(self):
        return np.dtype(np.float64)


class StringType(DataType):
    name = "string"

    def to_numpy(self):
        return np.dtype(object)


class BinaryType(DataType):
    name = "binary"

    def to_numpy(self):
        return np.dtype(object)


class DateType(DataType):
    """Days since unix epoch, int32 (Spark semantics)."""

    name = "date"

    def to_numpy(self):
        return np.dtype(np.int32)


class TimestampType(DataType):
    """Microseconds since unix epoch, int64, UTC only."""

    name = "timestamp"

    def to_numpy(self):
        return np.dtype(np.int64)


@dataclasses.dataclass(frozen=True)
class DecimalType(DataType):
    """DECIMAL64: precision <= 18 stored as int64 unscaled values, as in
    the reference."""

    precision: int = 10
    scale: int = 0

    MAX_PRECISION = 18

    def __post_init__(self):
        if not (0 < self.precision <= self.MAX_PRECISION):
            raise ValueError(f"precision {self.precision} outside (0, 18]")
        if not (0 <= self.scale <= self.precision):
            raise ValueError(f"scale {self.scale} outside [0, precision]")

    def to_numpy(self):
        return np.dtype(np.int64)

    @property
    def name(self):  # type: ignore[override]
        return f"decimal({self.precision},{self.scale})"

    def __repr__(self):
        return self.name

    def __eq__(self, other):
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self):
        return hash((DecimalType, self.precision, self.scale))


@dataclasses.dataclass(frozen=True)
class ArrayType(DataType):
    """Array columns are not representable on the engine (as in the
    reference); the type exists so plans can name it."""

    element_type: DataType = dataclasses.field(default_factory=IntegerType)
    contains_null: bool = True

    @property
    def name(self):  # type: ignore[override]
        return f"array<{self.element_type.simpleString}>"

    def __repr__(self):
        return self.name

    def to_numpy(self):
        return np.dtype(object)

    def __eq__(self, other):
        return (isinstance(other, ArrayType)
                and other.element_type == self.element_type
                and other.contains_null == self.contains_null)

    def __hash__(self):
        return hash((ArrayType, self.element_type, self.contains_null))


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    dataType: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class StructType(DataType):
    fields: tuple = ()

    def __post_init__(self):
        if not isinstance(self.fields, tuple):
            object.__setattr__(self, "fields", tuple(self.fields))

    @property
    def name(self):  # type: ignore[override]
        inner = ",".join(f"{f.name}:{f.dataType.simpleString}"
                         for f in self.fields)
        return f"struct<{inner}>"

    def __repr__(self):
        return self.name

    def __eq__(self, other):
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self):
        return hash((StructType, self.fields))

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def to_numpy(self):
        return np.dtype(object)

    @property
    def names(self):
        return [f.name for f in self.fields]

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)


NULL = NullType()
BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
STRING = StringType()
BINARY = BinaryType()
DATE = DateType()
TIMESTAMP = TimestampType()

_BY_NAME = {t.name: t for t in (NULL, BOOLEAN, BYTE, SHORT, INT, LONG,
                                FLOAT, DOUBLE, STRING, BINARY, DATE,
                                TIMESTAMP)}

_TORCH = {
    "null": torch.bool, "boolean": torch.bool, "tinyint": torch.int8,
    "smallint": torch.int16, "int": torch.int32, "bigint": torch.int64,
    "float": torch.float32, "double": torch.float64, "date": torch.int32,
    "timestamp": torch.int64,
}


def as_decimal(dt: DataType) -> DecimalType:
    """The decimal a numeric type widens to for mixed decimal arithmetic
    (Spark DecimalPrecision). LONG needs decimal(20,0) > DECIMAL64, so
    mixed long/decimal arithmetic is rejected, as in the reference."""
    if isinstance(dt, DecimalType):
        return dt
    widths = {"tinyint": 3, "smallint": 5, "int": 10}
    if dt.name in widths:
        return DecimalType(widths[dt.name], 0)
    raise TypeError(f"{dt} does not widen to a DECIMAL64 decimal")


def decimal_binary_result(op: str, a: DataType, b: DataType) -> DecimalType:
    """Spark's decimal result types for +,-,*,/ (DecimalPrecision), with
    the reference's DECIMAL64 rejection when the precision exceeds 18:
    the planner reads the TypeError as a fallback reason."""
    da, db = as_decimal(a), as_decimal(b)
    if op in ("add", "sub"):
        s = max(da.scale, db.scale)
        p = max(da.precision - da.scale, db.precision - db.scale) + s + 1
    elif op == "mul":
        p, s = da.precision + db.precision + 1, da.scale + db.scale
    elif op == "div":
        s = max(6, da.scale + db.precision + 1)
        p = da.precision - da.scale + db.scale + s
    else:
        raise ValueError(op)
    if p > DecimalType.MAX_PRECISION:
        raise TypeError(
            f"decimal result {op}({da},{db}) needs precision {p} > "
            f"DECIMAL64 cap {DecimalType.MAX_PRECISION}")
    return DecimalType(p, min(s, p))


def is_fixed_width(dt: DataType) -> bool:
    """True for the types stored as one torch tensor. Unlike the
    reference's (``types.py:397``), NullType counts: the port stores a
    NULL column as an all-invalid bool tensor, so every path that takes
    a fixed-width column takes it."""
    return not isinstance(dt, (StringType, BinaryType, ArrayType,
                               StructType))


def is_string(dt: DataType) -> bool:
    """True for the types stored as Arrow offsets + chars."""
    return isinstance(dt, (StringType, BinaryType))


def check_storable(dt: DataType) -> None:
    """Raise for a type no column can hold (arrays and structs, as in the
    reference)."""
    if not (is_fixed_width(dt) or is_string(dt)):
        raise TypeError(f"{dt.simpleString} columns are not representable "
                        "on the engine")


def torch_dtype(dt: DataType) -> torch.dtype:
    """Storage dtype of a fixed-width type; others raise."""
    check_storable(dt)
    if is_string(dt):
        raise TypeError(f"{dt.simpleString} columns are offsets + chars, "
                        "not one tensor")
    if isinstance(dt, DecimalType):
        return torch.int64
    return _TORCH[dt.name]


_PROMOTION_ORDER = ["tinyint", "smallint", "int", "bigint", "float", "double"]


def promote(a: DataType, b: DataType) -> DataType:
    """Smallest common numeric type (Spark's findTightestCommonType,
    simplified), as in the reference: a decimal against a float compares
    as double; two decimals widen per DecimalPrecision, shedding
    fractional digits (down to 6) rather than integer digits when the
    result would pass DECIMAL64."""
    if a == b:
        return a
    if isinstance(a, DecimalType) != isinstance(b, DecimalType):
        other = b if isinstance(a, DecimalType) else a
        if other.is_floating:
            return DOUBLE
        a, b = as_decimal(a), as_decimal(b)  # raises for bigint
    if isinstance(a, DecimalType) and isinstance(b, DecimalType):
        scale = max(a.scale, b.scale)
        intd = max(a.precision - a.scale, b.precision - b.scale)
        if intd + scale > DecimalType.MAX_PRECISION:
            min_scale = min(scale, 6)
            scale = max(DecimalType.MAX_PRECISION - intd, min_scale)
            if intd + scale > DecimalType.MAX_PRECISION:
                raise TypeError(
                    f"decimal promotion of {a} and {b} needs {intd} integer "
                    f"digits + {scale} fractional > DECIMAL64 capacity 18")
        return DecimalType(intd + scale, scale)
    if a.is_numeric and b.is_numeric:
        ia, ib = _PROMOTION_ORDER.index(a.name), _PROMOTION_ORDER.index(b.name)
        return _BY_NAME[_PROMOTION_ORDER[max(ia, ib)]]
    raise TypeError(f"cannot promote {a} with {b}")
