"""Row-at-a-time CPU interpreter for expression trees.

Own copy of ``spark_rapids_tpu/cpu/interpreter.py`` over the port's
``types`` and ``expr/expressions`` (the same class names), so the port's
session falls back exactly as the reference does.

Dual role, mirroring the reference architecture:
 1. the CPU *fallback* execution path — operators the planner can't place on
    TPU run here (the reference falls back to stock Spark per operator:
    docs/index.md:23-30);
 2. the *differential-test oracle* — the reference's core correctness idea is
    running every query on CPU and GPU and diffing results
    (tests/.../SparkQueryCompareTestSuite.scala:731, integration_tests
    asserts.py:330). This interpreter is deliberately implemented
    independently (pure Python over rows, no JAX/numpy vectorization) so a
    shared bug can't hide in both engines.

Semantics implemented to match Spark/Java: 3-valued logic, null on
divide-by-zero, Java wrapping/saturating casts, HALF_UP rounding.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

from .. import types as T
from ..expr import expressions as E

_INT_RANGES = {
    "tinyint": (-(2**7), 2**7 - 1, 2**8),
    "smallint": (-(2**15), 2**15 - 1, 2**16),
    "int": (-(2**31), 2**31 - 1, 2**32),
    "bigint": (-(2**63), 2**63 - 1, 2**64),
}


def _wrap_int(v: int, name: str) -> int:
    lo, hi, mod = _INT_RANGES[name]
    v = v % mod
    return v - mod if v > hi else v


_JAVA_WS = "\t\n\x0b\x0c\r "
_EPOCH_ORD = 719163  # datetime.date(1970, 1, 1).toordinal()


def _cast_from_string(s: str, to: T.DataType) -> Any:
    """Spark non-ANSI cast from string (GpuCast.scala string rows)."""
    import re

    t = s.strip(_JAVA_WS)
    if isinstance(to, T.BooleanType):
        tl = t.lower()
        if tl in ("t", "true", "y", "yes", "1"):
            return True
        if tl in ("f", "false", "n", "no", "0"):
            return False
        return None
    if to.name in _INT_RANGES:
        if not re.fullmatch(r"[+-]?\d+", t):
            return None
        v = int(t)
        lo, hi, _ = _INT_RANGES[to.name]
        return v if lo <= v <= hi else None
    if to.is_floating:
        tl = t.lower()
        specials = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf,
                    "infinity": math.inf, "+infinity": math.inf,
                    "-infinity": -math.inf, "nan": math.nan}
        if tl in specials:
            v = specials[tl]
        elif re.fullmatch(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", t):
            v = float(t)
        else:
            return None
        return _f32(v) if isinstance(to, T.FloatType) else v
    if isinstance(to, T.DateType):
        m = re.fullmatch(r"(\d{4})(?:-(\d{1,2})(?:-(\d{1,2}))?)?", t)
        if not m:
            return None
        import datetime as _dt

        try:
            d = _dt.date(int(m.group(1)), int(m.group(2) or 1),
                         int(m.group(3) or 1))
        except ValueError:
            return None
        return d.toordinal() - _EPOCH_ORD
    if isinstance(to, T.TimestampType):
        m = re.fullmatch(
            r"(\d{4})(?:-(\d{1,2})(?:-(\d{1,2})"
            r"(?:[ tT](\d{1,2}):(\d{1,2}):(\d{1,2})(?:\.(\d{1,6}))?)?)?)?", t)
        if not m:
            return None
        import datetime as _dt

        try:
            d = _dt.date(int(m.group(1)), int(m.group(2) or 1),
                         int(m.group(3) or 1))
        except ValueError:
            return None
        days = d.toordinal() - _EPOCH_ORD
        h = int(m.group(4) or 0)
        mi = int(m.group(5) or 0)
        s = int(m.group(6) or 0)
        if h > 23 or mi > 59 or s > 59:
            return None
        frac = (m.group(7) or "").ljust(6, "0")
        return (days * 86400 + h * 3600 + mi * 60 + s) * 1_000_000 + int(
            frac or 0)
    raise NotImplementedError(f"cpu cast string -> {to}")


def _java_double_str(v: float, single: bool) -> str:
    """Java Double.toString/Float.toString: shortest round-trip decimal,
    positional for 1e-3 <= |v| < 1e7, else d.dddEn scientific."""
    import numpy as np

    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    f = np.float32(v) if single else np.float64(v)
    a = abs(float(f))
    if a == 0:
        return "-0.0" if math.copysign(1, v) < 0 else "0.0"
    if 1e-3 <= a < 1e7:
        r = np.format_float_positional(f, unique=True)
        if r.endswith("."):
            r += "0"
        return r
    m, e = np.format_float_scientific(f, unique=True).split("e")
    if m.endswith("."):
        m += "0"
    if "." not in m:
        m += ".0"
    return f"{m}E{int(e)}"


def _cast_to_string(v: Any, frm: T.DataType) -> str:
    if isinstance(frm, T.BooleanType):
        return "true" if v else "false"
    if isinstance(frm, T.DateType):
        import datetime as _dt

        d = _dt.date.fromordinal(_EPOCH_ORD + v)
        return f"{d.year:04d}-{d.month:02d}-{d.day:02d}"
    if isinstance(frm, T.TimestampType):
        import datetime as _dt

        ts = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=v)
        base = (f"{ts.year:04d}-{ts.month:02d}-{ts.day:02d} "
                f"{ts.hour:02d}:{ts.minute:02d}:{ts.second:02d}")
        if ts.microsecond:
            return base + f".{ts.microsecond:06d}".rstrip("0")
        return base
    if frm.name in _INT_RANGES:
        return str(v)
    if frm.is_floating:
        return _java_double_str(float(v), isinstance(frm, T.FloatType))
    raise NotImplementedError(f"cpu cast {frm} -> string")


def _dec_quantize(v, out: "T.DecimalType"):
    """Quantize to the result type's scale (HALF_UP) with Spark's
    nullOnOverflow: None when the value needs more than ``precision``
    digits."""
    import decimal as _dec

    q = v.quantize(_dec.Decimal(1).scaleb(-out.scale),
                   rounding=_dec.ROUND_HALF_UP)
    if abs(int(q.scaleb(out.scale))) >= 10 ** out.precision:
        return None
    return q


def _java_cast(v: Any, frm: T.DataType, to: T.DataType) -> Any:
    if v is None:
        return None
    if frm == to:
        return v
    if isinstance(frm, T.StringType):
        return _cast_from_string(v, to)
    if isinstance(to, T.StringType):
        return _cast_to_string(v, frm)
    if isinstance(to, T.DecimalType):
        import decimal as _dec

        if frm.is_floating:
            raise ValueError("float->decimal cast not supported")
        return _dec_quantize(_dec.Decimal(str(v)), to)
    if isinstance(frm, T.DecimalType):
        import decimal as _dec

        if to.is_floating:
            f = float(v)
            return _f32(f) if isinstance(to, T.FloatType) else f
        if isinstance(to, T.BooleanType):
            return v != 0
        # truncate toward zero then wrap-narrow (Scala BigDecimal.toLong)
        return _wrap_int(int(v.to_integral_value(
            rounding=_dec.ROUND_DOWN)), to.name)
    if isinstance(frm, T.DateType) and isinstance(to, T.TimestampType):
        return v * 86_400_000_000
    if isinstance(frm, T.TimestampType) and isinstance(to, T.DateType):
        return v // 86_400_000_000
    if isinstance(frm, T.TimestampType):
        if isinstance(to, T.BooleanType):
            return v != 0  # micros != 0 (Spark timestampToBoolean)
        if to.is_floating:
            f = v / 1e6
            return _f32(f) if isinstance(to, T.FloatType) else f
        return _wrap_int(v // 1_000_000, to.name)
    if isinstance(to, T.TimestampType):
        if frm.is_floating:
            if math.isnan(v) or math.isinf(v):
                return None  # Spark doubleToTimestamp nulls non-finite
            x = v * 1e6
            # Scala Double.toLong saturates
            if x >= 2**63 - 1:
                return 2**63 - 1
            if x <= -(2**63):
                return -(2**63)
            return int(x)
        if isinstance(frm, T.BooleanType):
            return 1 if v else 0  # Spark: true -> 1 MICROsecond
        return v * 1_000_000
    if isinstance(to, T.BooleanType):
        return v != 0
    if isinstance(frm, T.BooleanType):
        v = 1 if v else 0
        frm = T.INT
    if to.name in _INT_RANGES:
        if frm.is_floating:
            # Java: NaN -> 0; saturate at int32 (int64 for bigint); byte/short
            # wrap-narrow from the saturated int32 value.
            if math.isnan(v):
                return 0
            wide = "bigint" if to.name == "bigint" else "int"
            lo, hi, _ = _INT_RANGES[wide]
            w = hi if v >= hi else (lo if v <= lo else int(v))
            return _wrap_int(w, to.name)
        return _wrap_int(int(v), to.name)
    if to.is_floating:
        f = float(v)
        if isinstance(to, T.FloatType):
            import struct

            f = struct.unpack("f", struct.pack("f", f))[0]
        return f
    raise NotImplementedError(f"cpu cast {frm} -> {to}")


def _f32(v: float) -> float:
    import struct

    return struct.unpack("f", struct.pack("f", v))[0]


def _narrow(v, out: T.DataType):
    """Post-arithmetic narrowing: int wraparound / float32 rounding."""
    if out.name in _INT_RANGES:
        return _wrap_int(v, out.name)
    if isinstance(out, T.FloatType):
        return _f32(v)
    return v


def _trunc_div(l: int, r: int) -> int:
    q = abs(l) // abs(r)
    return q if (l < 0) == (r < 0) else -q


def _java_rem(l, r):
    if isinstance(l, float) or isinstance(r, float):
        # Java %: NaN if divisor is 0 or dividend is infinite; x % inf == x
        if math.isnan(l) or math.isnan(r) or r == 0 or math.isinf(l):
            return float("nan")
        if math.isinf(r):
            return float(l)
        return math.fmod(l, r)
    return l - _trunc_div(l, r) * r


def _spark_compare(expr: E.Expression, l, r):
    """Spark SQL ordering: NaN == NaN is true, NaN sorts largest."""
    ln = isinstance(l, float) and math.isnan(l)
    rn = isinstance(r, float) and math.isnan(r)
    if ln or rn:
        eq = ln and rn
        lt = (not ln) and rn
        gt = ln and (not rn)
        if isinstance(expr, (E.EqualTo, E.EqualNullSafe)):
            return eq
        if isinstance(expr, E.LessThan):
            return lt
        if isinstance(expr, E.LessThanOrEqual):
            return lt or eq
        if isinstance(expr, E.GreaterThan):
            return gt
        return gt or eq
    if isinstance(expr, (E.EqualTo, E.EqualNullSafe)):
        return l == r
    if isinstance(expr, E.LessThan):
        return l < r
    if isinstance(expr, E.LessThanOrEqual):
        return l <= r
    if isinstance(expr, E.GreaterThan):
        return l > r
    return l >= r


#: partition context for nondeterministic/metadata expressions, set by
#: CpuProjectExec around each row (pid, row index in partition, file path)
ROW_CTX: dict = {"pid": 0, "row": 0, "file": ""}


def eval_row(expr: E.Expression, row: Sequence[Any]) -> Any:
    """Evaluate one bound expression against one row (values may be None)."""
    ev = lambda e: eval_row(e, row)  # noqa: E731

    if isinstance(expr, E.Alias):
        return ev(expr.child)
    if isinstance(expr, E.Literal):
        return expr.value
    if isinstance(expr, E.BoundReference):
        return row[expr.ordinal]

    if isinstance(expr, E.SparkPartitionID):
        return ROW_CTX["pid"]
    if isinstance(expr, E.MonotonicallyIncreasingID):
        return (ROW_CTX["pid"] << 33) + ROW_CTX["row"]
    if isinstance(expr, E.InputFileName):
        return ROW_CTX["file"]
    if isinstance(expr, E.Rand):
        from ..expr.nondet import rand_double_scalar

        return rand_double_scalar(expr.seed, ROW_CTX["pid"], ROW_CTX["row"])
    if isinstance(expr, E.Murmur3Hash):
        from ..expr.nondet import murmur3_scalar

        h = expr.seed
        for c in expr.exprs:
            h = murmur3_scalar(ev(c), c.dtype, h)
        return h

    if isinstance(expr, E._DecimalSumCheck):
        v = ev(expr.child)
        if v is None:
            return None
        import decimal as _dec

        return _dec_quantize(_dec.Decimal(str(v)), expr.dtype)

    if isinstance(expr, E._DecimalAvgEval):
        s, c = ev(expr.sum), ev(expr.count)
        if s is None or c is None or c == 0:
            return None
        import decimal as _dec

        with _dec.localcontext() as ctx:
            ctx.prec = 50
            v = _dec.Decimal(str(s)) / _dec.Decimal(c)
        return _dec_quantize(v, expr.dtype)

    if isinstance(expr, (E.Add, E.Subtract, E.Multiply)):
        l, r = ev(expr.left), ev(expr.right)
        if l is None or r is None:
            return None
        out = expr.dtype
        if isinstance(out, T.DecimalType):
            import decimal as _dec

            v = _dec.Decimal(str(l))
            w = _dec.Decimal(str(r))
            v = (v + w if isinstance(expr, E.Add)
                 else v - w if isinstance(expr, E.Subtract) else v * w)
            return _dec_quantize(v, out)
        l = _java_cast(l, expr.left.dtype, out)
        r = _java_cast(r, expr.right.dtype, out)
        v = l + r if isinstance(expr, E.Add) else (l - r if isinstance(expr, E.Subtract) else l * r)
        return _narrow(v, out)

    if isinstance(expr, E.Divide):
        l, r = ev(expr.left), ev(expr.right)
        if l is None or r is None:
            return None
        out = expr.dtype
        if isinstance(out, T.DecimalType):
            import decimal as _dec

            w = _dec.Decimal(str(r))
            if w == 0:
                return None
            with _dec.localcontext() as ctx:
                ctx.prec = 50
                v = _dec.Decimal(str(l)) / w
            return _dec_quantize(v, out)
        l, r = _java_cast(l, expr.left.dtype, T.DOUBLE), _java_cast(r, expr.right.dtype, T.DOUBLE)
        if r == 0:
            return None
        return l / r

    if isinstance(expr, E.IntegralDivide):
        l, r = ev(expr.left), ev(expr.right)
        if l is None or r is None:
            return None
        l, r = _java_cast(l, expr.left.dtype, T.LONG), _java_cast(r, expr.right.dtype, T.LONG)
        if r == 0:
            return None
        return _wrap_int(_trunc_div(l, r), "bigint")

    if isinstance(expr, E.Remainder):
        l, r = ev(expr.left), ev(expr.right)
        if l is None or r is None:
            return None
        out = expr.dtype
        l, r = _java_cast(l, expr.left.dtype, out), _java_cast(r, expr.right.dtype, out)
        if not out.is_floating and r == 0:
            return None
        return _narrow(_java_rem(l, r), out)

    if isinstance(expr, E.Pmod):
        l, r = ev(expr.left), ev(expr.right)
        if l is None or r is None:
            return None
        out = expr.dtype
        l, r = _java_cast(l, expr.left.dtype, out), _java_cast(r, expr.right.dtype, out)
        if not out.is_floating and r == 0:
            return None
        m = _java_rem(l, r)
        if (isinstance(m, float) and m != 0 and m < 0) or (not isinstance(m, float) and m < 0):
            m = _java_rem(m + r, r)
        return _narrow(m, out)

    if isinstance(expr, E.UnaryMinus):
        v = ev(expr.child)
        if v is None:
            return None
        dt = expr.child.dtype
        return _wrap_int(-v, dt.name) if dt.name in _INT_RANGES else -v

    if isinstance(expr, E.UnaryPositive):
        return ev(expr.child)

    if isinstance(expr, E.Abs):
        v = ev(expr.child)
        if v is None:
            return None
        dt = expr.child.dtype
        return _wrap_int(abs(v), dt.name) if dt.name in _INT_RANGES else abs(v)

    if isinstance(expr, E.EqualNullSafe):
        l, r = ev(expr.left), ev(expr.right)
        if l is None and r is None:
            return True
        if l is None or r is None:
            return False
        return _spark_compare(expr, l, r)

    if isinstance(expr, E._BinaryComparison):
        l, r = ev(expr.left), ev(expr.right)
        if l is None or r is None:
            return None
        return _spark_compare(expr, l, r)

    if isinstance(expr, E.In):
        v = ev(expr.child)
        if v is None:
            return None
        non_null = [x for x in expr.values if x is not None]
        if v in non_null:
            return True
        return None if len(non_null) != len(expr.values) else False

    if isinstance(expr, E.And):
        l, r = ev(expr.left), ev(expr.right)
        if l is False or r is False:
            return False
        if l is None or r is None:
            return None
        return l and r

    if isinstance(expr, E.Or):
        l, r = ev(expr.left), ev(expr.right)
        if l is True or r is True:
            return True
        if l is None or r is None:
            return None
        return l or r

    if isinstance(expr, E.Not):
        v = ev(expr.child)
        return None if v is None else not v

    if isinstance(expr, E.IsNull):
        return ev(expr.child) is None

    if isinstance(expr, E.IsNotNull):
        return ev(expr.child) is not None

    if isinstance(expr, E.IsNan):
        v = ev(expr.child)
        return v is not None and isinstance(v, float) and math.isnan(v)

    if isinstance(expr, E.Coalesce):
        out = expr.dtype
        for e in expr.exprs:
            v = ev(e)
            if v is not None:
                return _java_cast(v, e.dtype, out) if e.dtype != out and out.is_numeric else v
        return None

    if isinstance(expr, E.NaNvl):
        l = ev(expr.left)
        out = expr.dtype
        if l is not None and isinstance(l, float) and math.isnan(l):
            r = ev(expr.right)
            return None if r is None else _java_cast(r, expr.right.dtype, out)
        return None if l is None else _java_cast(l, expr.left.dtype, out)

    if isinstance(expr, E.If):
        p = ev(expr.predicate)
        out = expr.dtype
        if p is True:
            v = ev(expr.true_value)
            src = expr.true_value.dtype
        else:
            v = ev(expr.false_value)
            src = expr.false_value.dtype
        if v is None:
            return None
        return _java_cast(v, src, out) if src != out and out.is_numeric and src != T.NULL else v

    if isinstance(expr, E.CaseWhen):
        out = expr.dtype
        for cond, val in expr.branches:
            if ev(cond) is True:
                v = ev(val)
                if v is None:
                    return None
                src = val.dtype
                return _java_cast(v, src, out) if src != out and out.is_numeric and src != T.NULL else v
        if expr.else_value is not None:
            v = ev(expr.else_value)
            if v is None:
                return None
            src = expr.else_value.dtype
            return _java_cast(v, src, out) if src != out and out.is_numeric and src != T.NULL else v
        return None

    if isinstance(expr, E.Cast):
        return _java_cast(ev(expr.child), expr.child.dtype, expr.to)

    if isinstance(expr, E._UnaryMathDouble):
        v = ev(expr.child)
        if v is None:
            return None
        x = _java_cast(v, expr.child.dtype, T.DOUBLE)
        kind = type(expr)
        if kind in (E.Log, E.Log10, E.Log2, E.Log1p):
            t = -1.0 if kind is E.Log1p else 0.0
            if x <= t:  # NaN fails this comparison, like Java
                return None
            return {E.Log: math.log, E.Log10: math.log10, E.Log2: math.log2,
                    E.Log1p: math.log1p}[kind](x)
        try:
            return {
                E.Sqrt: lambda v: math.sqrt(v) if v >= 0 else float("nan"),
                E.Exp: math.exp,
                E.Sin: math.sin, E.Cos: math.cos, E.Tan: math.tan,
                E.Asin: lambda v: math.asin(v) if -1 <= v <= 1 else float("nan"),
                E.Acos: lambda v: math.acos(v) if -1 <= v <= 1 else float("nan"),
                E.Atan: math.atan,
                E.Sinh: math.sinh, E.Cosh: math.cosh, E.Tanh: math.tanh,
                E.Cbrt: lambda v: math.copysign(abs(v) ** (1 / 3), v),
                E.Expm1: math.expm1, E.Log1p: math.log1p,
                E.ToDegrees: math.degrees, E.ToRadians: math.radians,
            }[kind](x)
        except OverflowError:
            # Java overflows to infinity (math.exp(1e6) == inf, not error)
            if kind is E.Sinh:
                return math.copysign(float("inf"), x)
            return float("inf")
        except ValueError:
            return float("nan")

    if isinstance(expr, (E.Floor, E.Ceil)):
        v = ev(expr.child)
        if v is None:
            return None
        if not expr.child.dtype.is_floating:
            return v
        if math.isinf(v) or math.isnan(v):
            return _java_cast(v, T.DOUBLE, T.LONG)
        return int(math.floor(v) if isinstance(expr, E.Floor) else math.ceil(v))

    if isinstance(expr, E.Round):
        v = ev(expr.child)
        if v is None:
            return None
        dt = expr.child.dtype
        s = expr.scale
        if dt.is_floating:
            if math.isnan(v) or math.isinf(v):
                return v  # Spark returns NaN/inf unchanged from round()
            f = 10.0 ** s
            return math.copysign(math.floor(abs(v) * f + 0.5) / f, v)
        if s >= 0:
            return v
        f = int(10 ** (-s))
        sign = -1 if v < 0 else 1
        # Scala BigDecimal.toInt/toLong wrap on overflow
        return _wrap_int(sign * ((abs(v) + f // 2) // f) * f, dt.name)

    if isinstance(expr, E.Rint):
        v = ev(expr.child)
        if v is None:
            return None
        x = float(v)
        if math.isnan(x) or math.isinf(x):
            return x
        # Java Math.rint: round half to even
        fl = math.floor(x)
        diff = x - fl
        if diff < 0.5:
            return float(fl)
        if diff > 0.5:
            return float(fl + 1)
        return float(fl if fl % 2 == 0 else fl + 1)

    if isinstance(expr, E.Pow):
        l, r = ev(expr.left), ev(expr.right)
        if l is None or r is None:
            return None
        try:
            return float(
                math.pow(
                    _java_cast(l, expr.left.dtype, T.DOUBLE),
                    _java_cast(r, expr.right.dtype, T.DOUBLE),
                )
            )
        except (ValueError, OverflowError):
            return float("nan")

    if isinstance(expr, E.Atan2):
        l, r = ev(expr.left), ev(expr.right)
        if l is None or r is None:
            return None
        return math.atan2(
            _java_cast(l, expr.left.dtype, T.DOUBLE),
            _java_cast(r, expr.right.dtype, T.DOUBLE),
        )

    if isinstance(expr, E.Signum):
        v = ev(expr.child)
        if v is None:
            return None
        x = _java_cast(v, expr.child.dtype, T.DOUBLE)
        if math.isnan(x):
            return x
        return 0.0 if x == 0 else math.copysign(1.0, x)

    if isinstance(expr, (E.BitwiseAnd, E.BitwiseOr, E.BitwiseXor)):
        l, r = ev(expr.left), ev(expr.right)
        if l is None or r is None:
            return None
        out = expr.dtype
        l = _java_cast(l, expr.left.dtype, out)
        r = _java_cast(r, expr.right.dtype, out)
        v = l & r if isinstance(expr, E.BitwiseAnd) else (l | r if isinstance(expr, E.BitwiseOr) else l ^ r)
        return _wrap_int(v, out.name)

    if isinstance(expr, E.BitwiseNot):
        v = ev(expr.child)
        if v is None:
            return None
        return _wrap_int(~v, expr.dtype.name)

    if isinstance(expr, (E.ShiftLeft, E.ShiftRight, E.ShiftRightUnsigned)):
        l, r = ev(expr.left), ev(expr.right)
        if l is None or r is None:
            return None
        name = expr.left.dtype.name
        bits = 64 if name == "bigint" else 32
        sh = r & (bits - 1)
        if isinstance(expr, E.ShiftLeft):
            return _wrap_int(l << sh, name)
        if isinstance(expr, E.ShiftRight):
            return l >> sh  # python >> is arithmetic for negative ints
        u = l & ((1 << bits) - 1)
        return _wrap_int(u >> sh, name)

    if isinstance(expr, E.Length):
        v = ev(expr.child)
        if v is None:
            return None
        return len(v)

    # ----- strings (Spark/UTF8String semantics, implemented over Python str
    # independently of the TPU kernels) ------------------------------------
    if isinstance(expr, E.Upper):
        v = ev(expr.child)
        return None if v is None else v.upper()

    if isinstance(expr, E.Lower):
        v = ev(expr.child)
        return None if v is None else v.lower()

    if isinstance(expr, E.InitCap):
        v = ev(expr.child)
        if v is None:
            return None
        # Spark: lowercase everything, uppercase the char after each space
        out = []
        prev_space = True
        for ch in v.lower():
            out.append(ch.upper() if prev_space else ch)
            prev_space = ch == " "
        return "".join(out)

    if isinstance(expr, E.Substring):
        v, pos, ln = ev(expr.str), ev(expr.pos), ev(expr.len)
        if v is None or pos is None or ln is None:
            return None
        n = len(v)
        start = (pos - 1) if pos > 0 else ((n + pos) if pos < 0 else 0)
        end = start + ln
        s0 = max(min(start, n), 0)
        e0 = max(min(end, n), 0)
        return v[s0:e0] if e0 > s0 else ""

    if isinstance(expr, E.Concat):
        parts = [ev(e) for e in expr.children_]
        if any(p is None for p in parts):
            return None
        return "".join(parts)

    if isinstance(expr, (E.StringTrim, E.StringTrimLeft, E.StringTrimRight)):
        v = ev(expr.column)
        if v is None:
            return None
        tset = expr.trim_str if expr.trim_str is not None else " "
        if isinstance(expr, E.StringTrimLeft):
            return v.lstrip(tset)
        if isinstance(expr, E.StringTrimRight):
            return v.rstrip(tset)
        return v.strip(tset)

    if isinstance(expr, (E.StartsWith, E.EndsWith, E.Contains)):
        l, r = ev(expr.left), ev(expr.right)
        if l is None or r is None:
            return None
        if isinstance(expr, E.StartsWith):
            return l.startswith(r)
        if isinstance(expr, E.EndsWith):
            return l.endswith(r)
        return r in l

    if isinstance(expr, E.Like):
        v, p = ev(expr.left), ev(expr.pattern)
        if v is None or p is None:
            return None
        import re as _re

        esc = expr.escape
        out = []
        i = 0
        while i < len(p):
            ch = p[i]
            if ch == esc:
                if i + 1 >= len(p):
                    raise ValueError(f"invalid LIKE pattern {p!r}")
                nxt = p[i + 1]
                if nxt not in ("_", "%", esc):
                    raise ValueError(f"invalid LIKE pattern {p!r}")
                out.append(_re.escape(nxt))
                i += 2
                continue
            if ch == "%":
                out.append("(.|\\n)*")
            elif ch == "_":
                out.append("(.|\\n)")
            else:
                out.append(_re.escape(ch))
            i += 1
        return _re.match("(?:" + "".join(out) + r")\Z", v) is not None

    if isinstance(expr, E.RLike):
        v, p = ev(expr.left), ev(expr.pattern)
        if v is None or p is None:
            return None
        import re as _re

        # ASCII flag: Java's \w \d \s are ASCII-only (Spark semantics);
        # Python's default is Unicode. This CPU stand-in approximates Java
        # regex with Python re: Java-only constructs (possessive
        # quantifiers etc.) fail EXPLICITLY rather than silently diverge.
        try:
            rx = _re.compile(p, _re.ASCII)
        except _re.error as e:
            raise ValueError(
                f"pattern {p!r} is outside the python-re-compatible "
                f"subset of Java regex: {e}")
        return rx.search(v) is not None

    if isinstance(expr, E.RegExpReplace):
        v = ev(expr.str)
        p, r = ev(expr.pattern), ev(expr.replacement)
        if v is None or p is None or r is None:
            return None
        import re as _re

        # Java Matcher.replaceAll replacement semantics: $n = group ref,
        # \$ and \\ = literal; this path also serves patterns the TPU
        # guard rejected, so group references must work here
        def java_repl(m):
            out = []
            i = 0
            while i < len(r):
                ch = r[i]
                if ch == "\\" and i + 1 < len(r):
                    out.append(r[i + 1])
                    i += 2
                elif ch == "$" and i + 1 < len(r) and r[i + 1].isdigit():
                    j = i + 1
                    while j < len(r) and r[j].isdigit():
                        j += 1
                    # Java takes the longest valid group number
                    for k in range(j, i + 1, -1):
                        gn = int(r[i + 1 : k])
                        if gn <= m.re.groups:
                            out.append(m.group(gn) or "")
                            i = k
                            break
                    else:
                        raise ValueError(f"no group for {r[i:]}")
                else:
                    out.append(ch)
                    i += 1
            return "".join(out)

        return _re.sub(p, java_repl, v, flags=_re.ASCII)

    if isinstance(expr, E.StringLocate):
        start = ev(expr.start)
        if start is None:
            return 0  # reference: null start -> 0 for every row
        sub = ev(expr.substr)
        if sub is None:
            return None
        v = ev(expr.str)
        if v is None:
            return None
        if start < 1:
            return 0
        if sub == "":
            return 1
        i = v.find(sub, start - 1)
        return i + 1

    if isinstance(expr, E.StringReplace):
        v, s, r = ev(expr.str), ev(expr.search), ev(expr.replacement)
        if v is None or s is None or r is None:
            return None
        if s == "":
            return v
        return v.replace(s, r)

    if isinstance(expr, (E.StringLPad, E.StringRPad)):
        v, ln, pad = ev(expr.str), ev(expr.len), ev(expr.pad)
        if v is None or ln is None or pad is None:
            return None
        if ln <= 0:
            return ""
        if len(v) >= ln:
            return v[:ln]
        if not pad:
            return v
        need = ln - len(v)
        reps = (pad * (need // len(pad) + 1))[:need]
        return (reps + v) if isinstance(expr, E.StringLPad) else (v + reps)

    if isinstance(expr, E.SubstringIndex):
        v, d, cnt = ev(expr.str), ev(expr.delim), ev(expr.count)
        if v is None or d is None or cnt is None:
            return None
        if cnt == 0 or d == "":
            return ""
        parts = v.split(d)
        if cnt > 0:
            return d.join(parts[:cnt])
        return d.join(parts[cnt:])

    if isinstance(expr, E.StringSplitPart):
        v, d, i = ev(expr.str), ev(expr.delim), ev(expr.index)
        if v is None or d is None or i is None:
            return None
        parts = v.split(d)
        return parts[i] if 0 <= i < len(parts) else None

    # ----- date/time (python datetime as the independent oracle; TPU side
    # uses civil-calendar integer math) ------------------------------------
    if isinstance(expr, E._DateUnary):
        v = ev(expr.child)
        if v is None:
            return None
        import datetime as _dt

        if isinstance(expr, (E.Hour, E.Minute, E.Second)):
            ts = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=v)
            return {E.Hour: ts.hour, E.Minute: ts.minute,
                    E.Second: ts.second}[type(expr)]
        days = v if isinstance(expr.child.dtype, T.DateType) else (
            v // 86_400_000_000)
        d = _dt.date.fromordinal(_EPOCH_ORD + days)
        if isinstance(expr, E.Year):
            return d.year
        if isinstance(expr, E.Quarter):
            return (d.month - 1) // 3 + 1
        if isinstance(expr, E.Month):
            return d.month
        if isinstance(expr, E.DayOfMonth):
            return d.day
        if isinstance(expr, E.DayOfYear):
            return d.timetuple().tm_yday
        if isinstance(expr, E.DayOfWeek):
            return d.isoweekday() % 7 + 1  # 1 = Sunday
        if isinstance(expr, E.WeekDay):
            return d.weekday()  # 0 = Monday

    if isinstance(expr, (E.DateAdd, E.DateSub)):
        s, n = ev(expr.start_date), ev(expr.days)
        if s is None or n is None:
            return None
        return _wrap_int(s + (n if isinstance(expr, E.DateAdd) else -n), "int")

    if isinstance(expr, E.DateDiff):
        e_, s_ = ev(expr.end_date), ev(expr.start_date)
        if e_ is None or s_ is None:
            return None

        def _days(v, dt):
            return v // 86_400_000_000 if isinstance(dt, T.TimestampType) else v

        return _days(e_, expr.end_date.dtype) - _days(s_, expr.start_date.dtype)

    if isinstance(expr, E.LastDay):
        v = ev(expr.start_date)
        if v is None:
            return None
        import calendar
        import datetime as _dt

        d = _dt.date.fromordinal(_EPOCH_ORD + v)
        last = calendar.monthrange(d.year, d.month)[1]
        return d.replace(day=last).toordinal() - _EPOCH_ORD

    if isinstance(expr, E.UnixTimestamp):
        v = ev(expr.child)
        if v is None:
            return None
        if isinstance(expr.child.dtype, T.TimestampType):
            return v // 1_000_000
        if isinstance(expr.child.dtype, T.DateType):
            return v * 86400
        raise NotImplementedError(
            "unix_timestamp over non-date/timestamp inputs")

    if isinstance(expr, E.FromUnixTime):
        v, fmt = ev(expr.sec), ev(expr.format)
        if v is None or fmt is None:
            return None
        if fmt != "yyyy-MM-dd HH:mm:ss":
            raise NotImplementedError(f"from_unixtime format {fmt!r}")
        import datetime as _dt

        ts = _dt.datetime(1970, 1, 1) + _dt.timedelta(seconds=v)
        return (f"{ts.year:04d}-{ts.month:02d}-{ts.day:02d} "
                f"{ts.hour:02d}:{ts.minute:02d}:{ts.second:02d}")

    if isinstance(expr, E.TimeAdd):
        v = ev(expr.start)
        if v is None:
            return None
        return v + expr.days * 86_400_000_000 + expr.microseconds

    if isinstance(expr, E.TruncDate):
        v, fmt = ev(expr.date), ev(expr.fmt)
        if v is None or fmt is None:
            return None
        import datetime as _dt

        f = fmt.lower()
        d = _dt.date.fromordinal(_EPOCH_ORD + v)
        if f in ("year", "yyyy", "yy"):
            d = d.replace(month=1, day=1)
        elif f == "quarter":
            d = d.replace(month=((d.month - 1) // 3) * 3 + 1, day=1)
        elif f in ("month", "mon", "mm"):
            d = d.replace(day=1)
        elif f == "week":
            d = d - _dt.timedelta(days=d.weekday())
        else:
            return None
        return d.toordinal() - _EPOCH_ORD

    if isinstance(expr, E.NativeUDF):
        # CPU fallback = the UDF's row function (reference: a RapidsUDF
        # still has its ordinary row-based evaluate)
        return expr.row_fn(*[ev(c) for c in expr.children_])

    if isinstance(expr, E.PythonUDF):
        # row-by-row python execution — the fallback path for UDFs the
        # bytecode compiler can't lower (reference: ScalaUDF staying on the
        # JVM / the python-worker path)
        vals = [ev(c) for c in expr.children_]
        return expr.func(*vals)

    raise NotImplementedError(f"cpu interpreter: {type(expr).__name__}")


def eval_expression_rows(
    bound: E.Expression, rows: Sequence[Sequence[Any]]
) -> List[Any]:
    return [eval_row(bound, row) for row in rows]
