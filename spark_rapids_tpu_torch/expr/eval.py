"""Lowering bound expression trees to torch ops.

Counterpart of ``spark_rapids_tpu/expr/eval.py`` ``lower``
(``eval.py:275``) for fixed-width and string values; the string family
lowers in ``expr/eval_strings.py``, native UDFs call their columnar
function. Where the reference traces one XLA program, the port runs the
same ops eagerly on the device of the input tensors. Spark semantics are
kept exactly:

  * integer arithmetic wraps like Java (two's complement);
  * division and remainder by zero give NULL: the divisor is masked BEFORE
    dividing, since torch raises on the CPU and returns garbage on CUDA
    for an integer division by zero, and ``MIN / -1`` traps on the CPU —
    it is computed by negation, which wraps to ``MIN`` as in Java;
  * three-valued (Kleene) And/Or;
  * float comparisons treat NaN as equal to NaN and larger than anything;
  * float -> integral casts saturate, NaN -> 0 (Java narrowing);
  * strings compare as unsigned bytes, and length() counts characters;
  * the math family reads a subnormal operand as the zero of its sign,
    as the compares do (ROADMAP.md §C, C2);
  * ``Round`` is HALF_UP (away from zero at .5), ``Pmod``'s result takes
    the divisor's sign, shift counts are masked to the value's width,
    and ``Abs``/``UnaryMinus`` of MIN wrap to MIN, as in Java;
  * DECIMAL64 (int64 unscaled): rescales round HALF_UP (away from zero at
    .5, ``java.math.RoundingMode.HALF_UP``), a decimal -> integral cast
    truncates toward zero, and a result past its precision is NULL
    (Spark's non-ANSI nullOnOverflow); the plan-time precision checks
    (``types.decimal_binary_result``) keep every intermediate in int64.
    Decimal -> double (and timestamp -> double) divides by an exact power
    of ten in f64, correctly rounded (:func:`_f64_div`; the reference
    blocks XLA's reciprocal rewrite for its decimals);
  * DATE is int32 days and TIMESTAMP int64 microseconds, UTC; the date
    and time family lowers in ``expr/eval_datetime.py``.

The nondeterministic and metadata nodes are not lowered yet and raise
``NotImplementedError`` naming their ROADMAP.md item; a node the
reference itself cannot lower (``PythonUDF``) raises
``UnsupportedExpressionError``, which the planner reads as a fallback
(:func:`tpu_supports`).
"""
from __future__ import annotations

import decimal as _dec
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..columnar import ColumnarBatch, DeviceColumn
from ..columnar import column as _colmod
from ..ops import strings as S
from ..ops.hashing import flush_subnormals
from ..types import DataType, torch_dtype
from . import expressions as E
from .eval_datetime import lower_datetime
from .eval_strings import (as_strv, compare_strings, dict_compare_literal,
                           lower_cast_to_string, lower_string_cast,
                           lower_strings, select_strings, string_in)
from .values import (ColV, DictV, StrV, UnsupportedExpressionError, Val,
                     as_plain_str, dict_gather_col)

_INT_INFO = {
    "tinyint": (torch.int8, -(2**7), 2**7 - 1),
    "smallint": (torch.int16, -(2**15), 2**15 - 1),
    "int": (torch.int32, -(2**31), 2**31 - 1),
    "bigint": (torch.int64, -(2**63), 2**63 - 1),
}


#: the unary double functions of ``E._UnaryMathDouble`` (Log* are guarded
#: separately)
_MATH_FNS = {
    E.Sqrt: torch.sqrt, E.Exp: torch.exp, E.Sin: torch.sin,
    E.Cos: torch.cos, E.Tan: torch.tan, E.Asin: torch.asin,
    E.Acos: torch.acos, E.Atan: torch.atan, E.Sinh: torch.sinh,
    E.Cosh: torch.cosh, E.Tanh: torch.tanh, E.Expm1: torch.expm1,
    E.ToDegrees: torch.rad2deg, E.ToRadians: torch.deg2rad,
    E.Cbrt: lambda x: torch.copysign(torch.pow(torch.abs(x), 1.0 / 3.0),
                                     x),
}
_LOG_FNS = {E.Log: torch.log, E.Log10: torch.log10, E.Log2: torch.log2,
            E.Log1p: torch.log1p}


def _check_fixed(dt: DataType) -> None:
    """Raise for a type the fixed-width lowering cannot take (strings
    take their own routes before it is called)."""
    if not T.is_fixed_width(dt):
        raise UnsupportedExpressionError(
            f"{dt.simpleString} expressions are not supported")


def _cast_data(data: torch.Tensor, frm: DataType, to: DataType) -> torch.Tensor:
    """Value cast with Java/Spark numeric semantics (reference
    ``eval.py:60-120``, its date/time and decimal rows included)."""
    if frm == to:
        return data
    _check_fixed(frm)
    _check_fixed(to)
    if isinstance(frm, T.NullType):
        return torch.zeros_like(data, dtype=torch_dtype(to))
    # date/timestamp pairs: DATE = int32 days, TIMESTAMP = int64 µs, UTC
    if isinstance(frm, T.DateType) and isinstance(to, T.TimestampType):
        return data.to(torch.int64) * 86_400_000_000
    if isinstance(frm, T.TimestampType) and isinstance(to, T.DateType):
        return torch.div(data, 86_400_000_000,
                         rounding_mode="floor").to(torch.int32)
    if isinstance(frm, T.TimestampType):
        if isinstance(to, T.BooleanType):
            return data != 0  # µs != 0 (Spark timestampToBoolean)
        if to.is_floating:
            return _f64_div(data, 1e6).to(torch_dtype(to))
        return torch.div(data, 1_000_000,
                         rounding_mode="floor").to(torch_dtype(to))
    if isinstance(to, T.TimestampType):
        if frm.is_floating:
            # Scala (d * 1e6).toLong saturates; the Cast lowering nulls
            # the non-finite rows
            x = data.to(torch.float64) * 1e6
            in_range = torch.isfinite(x) & (torch.abs(x) < float(2**63))
            i = torch.where(in_range, x, 0.0).to(torch.int64)
            i = torch.where(x >= float(2**63), 2**63 - 1, i)
            return torch.where(torch.isfinite(x) & (x <= float(-(2**63))),
                               -(2**63), i)
        if isinstance(frm, T.BooleanType):
            return data.to(torch.int64)  # Spark: true -> 1 microsecond
        return data.to(torch.int64) * 1_000_000  # integral seconds
    if isinstance(frm, T.DateType) or isinstance(to, T.DateType):
        raise UnsupportedExpressionError(
            f"cast {frm.simpleString} -> {to.simpleString} is not supported")
    if isinstance(to, T.BooleanType):
        # a subnormal reads as zero, as on the reference's backends
        return flush_subnormals(data) != 0
    if isinstance(frm, T.BooleanType):
        return data.to(torch_dtype(to))
    if to.name in _INT_INFO and frm.is_floating:
        # Java narrowing: NaN -> 0; saturate at int32 (or int64 for
        # bigint) range; byte/short then wrap-narrow from int32
        wide = "bigint" if to.name == "bigint" else "int"
        wdt, lo, hi = _INT_INFO[wide]
        d = torch.where(torch.isnan(data), 0.0, data)
        fin = torch.isfinite(d)
        t = torch.trunc(torch.where(fin, d, 0.0))
        sat = torch.where(torch.isposinf(d) | (fin & (t >= float(hi))),
                          hi, 0).to(wdt)
        mid = torch.where(fin & (t > float(lo)) & (t < float(hi)),
                          t, 0.0).to(wdt)
        low = torch.where(torch.isneginf(d) | (fin & (t <= float(lo))),
                          lo, 0).to(wdt)
        return (sat + mid + low).to(torch_dtype(to))
    if isinstance(to, T.DecimalType):
        # comparison / promote coercion: upscale to the common (max)
        # scale, exact by promote()'s precision check
        fs = frm.scale if isinstance(frm, T.DecimalType) else 0
        return _dec_upscale(data.to(torch.int64), max(0, to.scale - fs))
    if isinstance(frm, T.DecimalType):
        if to.is_floating:
            return _f64_div(data, float(_pow10(frm.scale))).to(
                torch_dtype(to))
        return data.to(torch_dtype(to))  # unscaled passthrough
    # int->int wraps (Java), int/float->float round to nearest
    return data.to(torch_dtype(to))


# ---------------------------------------------------------------------------
# DECIMAL64: int64 unscaled values (reference eval.py:141-255). The
# plan-time precision checks keep every intermediate in int64; a result
# past its precision nulls the row (Spark's non-ANSI nullOnOverflow).
# ---------------------------------------------------------------------------
def _pow10(k: int) -> int:
    return 10 ** k


def _dec_upscale(data: torch.Tensor, delta: int) -> torch.Tensor:
    """unscaled * 10^delta (delta >= 0; plan-time bounds keep it exact)."""
    if delta == 0:
        return data
    return data * _pow10(delta)


def _div_half_up(num: torch.Tensor, den) -> torch.Tensor:
    """round_half_up(num / den) on int64, den > 0, sign-correct (HALF_UP:
    away from zero at .5, ``java.math.RoundingMode.HALF_UP``)."""
    den = torch.as_tensor(den, dtype=torch.int64, device=num.device)
    q = _trunc_div(num, den)
    rem = num - q * den
    bump = (torch.abs(rem) * 2) >= den
    return torch.where(bump, q + torch.sign(num), q)


def _dec_rescale(data: torch.Tensor, frm_scale: int,
                 to_scale: int) -> torch.Tensor:
    if to_scale >= frm_scale:
        return _dec_upscale(data, to_scale - frm_scale)
    return _div_half_up(data, _pow10(frm_scale - to_scale))


def _dec_fits(data: torch.Tensor, precision: int) -> torch.Tensor:
    if precision >= 19:
        return torch.ones_like(data, dtype=torch.bool)
    bound = _pow10(precision)
    return (data < bound) & (data > -bound)


def _overflow_null(res: torch.Tensor, valid: torch.Tensor,
                   precision: int) -> ColV:
    ok = _dec_fits(res, precision)
    return ColV(torch.where(ok, res, 0), valid & ok)


def _decimal_arith(expr, l: ColV, r: ColV, out: T.DecimalType) -> ColV:
    lt, rt = T.as_decimal(expr.left.dtype), T.as_decimal(expr.right.dtype)
    ld = l.data.to(torch.int64)
    rd = r.data.to(torch.int64)
    if isinstance(expr, E.Multiply):
        res = ld * rd  # scale s1 + s2 == out.scale by construction
    else:
        ld = _dec_upscale(ld, out.scale - lt.scale)
        rd = _dec_upscale(rd, out.scale - rt.scale)
        res = ld + rd if isinstance(expr, E.Add) else ld - rd
    return _overflow_null(res, l.validity & r.validity, out.precision)


def _decimal_divide(expr, l: ColV, r: ColV, out: T.DecimalType) -> ColV:
    lt, rt = T.as_decimal(expr.left.dtype), T.as_decimal(expr.right.dtype)
    # result = round(l_unscaled * 10^(out.scale - s1 + s2) / r_unscaled)
    shift = out.scale - lt.scale + rt.scale
    # |l_unscaled| < 10^p1: the shifted numerator is exact in int64 only
    # while p1 + shift <= 18
    if lt.precision + shift > 18:
        raise UnsupportedExpressionError(
            f"decimal divide needs {lt.precision + shift} digits > DECIMAL64")
    ld = _dec_upscale(l.data.to(torch.int64), shift)
    rd = r.data.to(torch.int64)
    valid = l.validity & r.validity & (rd != 0)
    safe_r = torch.where(rd == 0, 1, rd)
    num = torch.where(rd < 0, -ld, ld)  # a positive denominator
    return _overflow_null(_div_half_up(num, torch.abs(safe_r)), valid,
                          out.precision)


def _decimal_cast(c: ColV, frm: DataType, to: DataType) -> ColV:
    data = c.data
    valid = c.validity
    if isinstance(frm, T.DecimalType) and isinstance(to, T.DecimalType):
        delta = to.scale - frm.scale
        if delta > 0 and frm.precision + delta > 18:
            raise UnsupportedExpressionError(
                "decimal rescale exceeds DECIMAL64 headroom")
        res = _dec_rescale(data.to(torch.int64), frm.scale, to.scale)
        return _overflow_null(res, valid, to.precision)
    if isinstance(to, T.DecimalType):
        if frm.is_floating:
            raise UnsupportedExpressionError(
                "float->decimal cast not supported (string-mediated in "
                "Spark; falls back like the reference's gated casts)")
        d = data.to(torch.int64)
        if to.scale > 0:
            # values needing more than 18 - scale integer digits are
            # NULL: tested BEFORE multiplying
            limit = _pow10(18 - to.scale)
            pre_ok = (d < limit) & (d > -limit)
            res = torch.where(pre_ok, d, 0) * _pow10(to.scale)
        else:
            pre_ok = torch.ones_like(d, dtype=torch.bool)
            res = d
        return _overflow_null(res, valid & pre_ok, to.precision)
    if to.is_floating:
        f = _f64_div(data, float(_pow10(frm.scale)))
        return ColV(f.to(torch_dtype(to)), valid)
    if isinstance(to, T.BooleanType):
        return ColV(data != 0, valid)
    # integral: truncate toward zero on the scaled value, then
    # wrap-narrow (Scala BigDecimal.toLong)
    whole = _trunc_div(data.to(torch.int64),
                       torch.as_tensor(_pow10(frm.scale), device=data.device))
    return ColV(whole.to(torch_dtype(to)), valid)


def _f64_div(data: torch.Tensor, d: float) -> torch.Tensor:
    """``data`` in f64 divided by the constant ``d``, correctly rounded
    on every device (Java's ``/``): the divisor rides as a device tensor,
    because CUDA turns a division by a host scalar into a multiply by
    its reciprocal, one ulp off on some values."""
    return data.to(torch.float64) / torch.tensor(d, dtype=torch.float64,
                                                 device=data.device)


def _trunc_div(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Java integer division: truncation toward zero. Zero divisors are
    masked to 1 (callers null those rows); a divisor of -1 is a negation,
    so ``MIN / -1`` wraps to ``MIN`` instead of trapping."""
    one = torch.ones_like(r)
    rs = torch.where(r == 0, one, r)
    neg = rs == -1
    q = torch.div(l, torch.where(neg, one, rs), rounding_mode="trunc")
    return torch.where(neg, -q, q)


def _java_rem(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    if l.is_floating_point():
        # C fmod == Java %: NaN for a zero divisor or inf dividend,
        # x % inf == x
        m = torch.fmod(l, r)
        return torch.where(torch.isinf(r) & torch.isfinite(l), l, m)
    rs = torch.where(r == 0, torch.ones_like(r), r)
    return l - _trunc_div(l, rs) * rs


def _logical_shift_right(x: torch.Tensor, sh: torch.Tensor,
                         bits: int) -> torch.Tensor:
    """``x >>> sh`` for a signed dtype of ``bits`` bits, 0 <= sh < bits:
    the arithmetic shift with the sign copies masked off."""
    width = torch.clamp(bits - sh, max=bits - 1)
    mask = (torch.ones_like(x) << width) - 1  # wraps to MAX at 2^(bits-1)
    return torch.where(sh == 0, x, (x >> sh) & mask)


def _lower_in(expr: E.In, c: Val, cap: int, device) -> ColV:
    """Fixed-width IN: the comparison dtype is picked on the host so
    out-of-range literals widen instead of truncating (reference
    ``eval.py:469-506``); a string column takes :func:`string_in`, over
    the dictionary for a DictV."""
    if isinstance(c, DictV):
        return dict_gather_col(c, string_in(c.dictionary, expr.values,
                                            c.dict_size))
    if isinstance(c, StrV):
        return string_in(c, expr.values, cap)
    child_dt = expr.child.dtype
    _check_fixed(child_dt)
    non_null = [v for v in expr.values if v is not None]
    has_null_value = len(non_null) != len(expr.values)
    cmp_dt = child_dt
    if child_dt.is_floating or any(isinstance(v, float) for v in non_null):
        cmp_dt = T.DOUBLE if child_dt != T.FLOAT or any(
            isinstance(v, float) for v in non_null) else T.FLOAT
    elif isinstance(child_dt, T.DecimalType):
        # the column holds UNSCALED values: each literal scales to match;
        # one with more fractional digits than the scale never matches
        conv = []
        for v in non_null:
            d = _dec.Decimal(str(v)).scaleb(child_dt.scale)
            if d == d.to_integral_value() and abs(int(d)) < 10 ** 18:
                conv.append(int(d))
        non_null = conv
    elif child_dt.name in _INT_INFO:
        _, lo, hi = _INT_INFO[child_dt.name]
        if any(not (lo <= v <= hi) for v in non_null):
            cmp_dt = T.LONG
            # literals beyond int64 can never match an integral column
            non_null = [v for v in non_null if -(2**63) <= v < 2**63]
    cd = _cast_data(flush_subnormals(c.data), child_dt, cmp_dt)
    match = torch.zeros(cap, dtype=torch.bool, device=device)
    for v in non_null:
        match = match | (cd == torch.tensor(v, dtype=cd.dtype,
                                            device=device))
    valid = c.validity & (match | (not has_null_value))
    return ColV(match, valid)


def _lower_math(expr: E.Expression, ev, cap: int, device) -> Optional[ColV]:
    """The math, sign and bitwise families (ROADMAP.md item 21), with the
    reference's Java semantics; None for any other node."""
    if isinstance(expr, E.Pmod):
        out = expr.dtype
        l, r = ev(expr.left), ev(expr.right)
        ld, rd = _promote2(l, expr.left.dtype, r, expr.right.dtype, out)
        valid = l.validity & r.validity
        if not out.is_floating:
            valid = valid & (rd != 0)
        m = _java_rem(ld, rd)
        m = torch.where(m < 0, _java_rem(m + rd, rd), m)
        return ColV(m, valid)

    if isinstance(expr, E.UnaryMinus):
        c = ev(expr.child)
        return ColV(-c.data, c.validity)  # MIN wraps to MIN

    if isinstance(expr, E.UnaryPositive):
        return ev(expr.child)

    if isinstance(expr, E.Abs):
        c = ev(expr.child)
        return ColV(torch.abs(c.data), c.validity)  # abs(MIN) == MIN

    if isinstance(expr, E.In):
        return _lower_in(expr, ev(expr.child), cap, device)

    if isinstance(expr, E.IsNan):
        c = ev(expr.child)
        isnan = (torch.isnan(c.data) if c.data.is_floating_point()
                 else torch.zeros(cap, dtype=torch.bool, device=device))
        return ColV(isnan & c.validity,
                    torch.ones(cap, dtype=torch.bool, device=device))

    if isinstance(expr, E.NaNvl):
        l, r = ev(expr.left), ev(expr.right)
        out = expr.dtype
        ld = _cast_data(l.data, expr.left.dtype, out)
        rd = _cast_data(r.data, expr.right.dtype, out)
        use_r = l.validity & torch.isnan(ld)
        return ColV(torch.where(use_r, rd, ld),
                    torch.where(use_r, r.validity, l.validity))

    if isinstance(expr, E._UnaryMathDouble):
        c = ev(expr.child)
        kind = type(expr)
        # cbrt reads a subnormal as it is on the reference's backends
        x = _cast_data(c.data if kind is E.Cbrt
                       else flush_subnormals(c.data),
                       expr.child.dtype, T.DOUBLE)
        if kind in _LOG_FNS:
            # Spark: null when x <= 0 (or <= -1 for log1p); NaN passes
            # the guard and yields NaN
            t = -1.0 if kind is E.Log1p else 0.0
            bad = x <= t
            r = _LOG_FNS[kind](torch.where(bad, 1.0 - t, x))
            return ColV(r, c.validity & ~bad)
        return ColV(_MATH_FNS[kind](x), c.validity)

    if isinstance(expr, (E.Floor, E.Ceil)):
        c = ev(expr.child)
        if not expr.child.dtype.is_floating:
            return c
        fn = torch.floor if isinstance(expr, E.Floor) else torch.ceil
        x = flush_subnormals(c.data).to(torch.float64)
        return ColV(_cast_data(fn(x), T.DOUBLE, T.LONG), c.validity)

    if isinstance(expr, E.Round):
        c = ev(expr.child)
        dt = expr.child.dtype
        s = expr.scale
        if dt.is_floating:
            f = 10.0 ** s
            x = flush_subnormals(c.data).to(torch.float64)
            # a device-tensor divisor: CUDA's division by a host scalar
            # is a multiply by its reciprocal (:func:`_f64_div`)
            r = _f64_div(torch.sign(x) * torch.floor(torch.abs(x) * f + 0.5),
                         f)
            return ColV(r.to(torch_dtype(dt)), c.validity)
        if s >= 0:
            return c
        f = int(10 ** (-s))
        x = c.data.to(torch.int64)
        q = torch.div(torch.abs(x) + f // 2, f, rounding_mode="floor")
        return ColV((torch.sign(x) * q * f).to(torch_dtype(dt)), c.validity)

    if isinstance(expr, E.Rint):
        # Math.rint: round half to even
        c = ev(expr.child)
        x = _cast_data(flush_subnormals(c.data), expr.child.dtype, T.DOUBLE)
        fin = torch.isfinite(x)
        xs = torch.where(fin, x, 0.0)
        f = torch.floor(xs)
        d = xs - f
        even_down = torch.remainder(f, 2.0) == 0.0
        r = torch.where(d > 0.5, f + 1.0,
                        torch.where(d < 0.5, f,
                                    torch.where(even_down, f, f + 1.0)))
        return ColV(torch.where(fin, r, x), c.validity)

    if isinstance(expr, (E.Pow, E.Atan2)):
        l, r = ev(expr.left), ev(expr.right)
        ld = _cast_data(flush_subnormals(l.data), expr.left.dtype, T.DOUBLE)
        rd = _cast_data(flush_subnormals(r.data), expr.right.dtype, T.DOUBLE)
        fn = torch.pow if isinstance(expr, E.Pow) else torch.atan2
        return ColV(fn(ld, rd), l.validity & r.validity)

    if isinstance(expr, E.Signum):
        c = ev(expr.child)
        x = _cast_data(flush_subnormals(c.data), expr.child.dtype, T.DOUBLE)
        return ColV(torch.where(torch.isnan(x), x, torch.sign(x)),
                    c.validity)

    if isinstance(expr, (E.BitwiseAnd, E.BitwiseOr, E.BitwiseXor)):
        out = expr.dtype
        l, r = ev(expr.left), ev(expr.right)
        ld, rd = _promote2(l, expr.left.dtype, r, expr.right.dtype, out)
        op = {E.BitwiseAnd: torch.bitwise_and, E.BitwiseOr: torch.bitwise_or,
              E.BitwiseXor: torch.bitwise_xor}[type(expr)]
        return ColV(op(ld, rd), l.validity & r.validity)

    if isinstance(expr, E.BitwiseNot):
        c = ev(expr.child)
        return ColV(torch.bitwise_not(c.data), c.validity)

    if isinstance(expr, (E.ShiftLeft, E.ShiftRight, E.ShiftRightUnsigned)):
        l, r = ev(expr.left), ev(expr.right)
        bits = l.data.element_size() * 8
        sh = (r.data & (bits - 1)).to(l.data.dtype)  # Java masks the count
        if isinstance(expr, E.ShiftLeft):
            res = l.data << sh
        elif isinstance(expr, E.ShiftRight):
            res = l.data >> sh
        else:
            res = _logical_shift_right(l.data, sh, bits)
        return ColV(res, l.validity & r.validity)
    return None


def _promote2(l: ColV, ldt, r: ColV, rdt, target: DataType):
    return _cast_data(l.data, ldt, target), _cast_data(r.data, rdt, target)


def _cmp(expr, ld: torch.Tensor, rd: torch.Tensor, floating: bool):
    if floating:
        # Spark SQL ordering: NaN == NaN is TRUE and NaN sorts largest
        nl, nr = torch.isnan(ld), torch.isnan(rd)
        eq = (ld == rd) | (nl & nr)
        lt = (ld < rd) | (nr & ~nl)
        gt = (rd < ld) | (nl & ~nr)
    else:
        eq, lt, gt = ld == rd, ld < rd, ld > rd
    return {
        E.EqualTo: eq, E.EqualNullSafe: eq,
        E.LessThan: lt, E.LessThanOrEqual: lt | eq,
        E.GreaterThan: gt, E.GreaterThanOrEqual: gt | eq,
    }[type(expr)]


def _string_literal(value, cap: int, device) -> StrV:
    """A string literal as a column: its bytes tiled once per row (Arrow
    offsets must not fall)."""
    raw = value.encode("utf-8") if isinstance(value, str) else (value or b"")
    nb = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy())
    chars = (nb.to(device).repeat(cap) if len(raw)
             else torch.zeros(1, dtype=torch.uint8, device=device))
    offsets = torch.arange(cap + 1, dtype=torch.int32,
                           device=device) * len(raw)
    return StrV(offsets, chars, torch.full((cap,), value is not None,
                                           dtype=torch.bool, device=device))


def lower(expr: E.Expression, cols: Sequence[Val], cap: int,
          device: Optional[torch.device] = None) -> Val:
    """Recursively lower a bound expression to torch ops over ``cols``
    (each a (cap,) ColV or StrV). Literals are built on ``device``, by
    default the device of the first input column."""
    if device is None:
        if not cols:
            raise ValueError("lower() needs a device when there are no "
                             "input columns")
        device = cols[0].validity.device

    def ev(e):
        return lower(e, cols, cap, device)

    def full(value, dtype):
        return torch.full((cap,), value, dtype=dtype, device=device)

    if isinstance(expr, E.Alias):
        return ev(expr.child)

    if isinstance(expr, E.BoundReference):
        return cols[expr.ordinal]

    if isinstance(expr, E.Literal):
        dt = expr.data_type
        if T.is_string(dt):
            return _string_literal(expr.value, cap, device)
        _check_fixed(dt)
        if isinstance(dt, T.NullType):
            return ColV(full(False, torch.bool), full(False, torch.bool))
        v = expr.value
        if v is not None and isinstance(dt, T.DecimalType):
            v = int(_dec.Decimal(str(v)).scaleb(dt.scale).to_integral_value(
                rounding=_dec.ROUND_HALF_UP))
        return ColV(full(v if v is not None else 0, torch_dtype(dt)),
                    full(v is not None, torch.bool))

    if isinstance(expr, E.Murmur3Hash):
        # fixed-width children lower inline; string children take the
        # project exec's context path, which syncs their byte bound
        # (reference ``eval.py:316``)
        from ..ops import hashing

        h = hashing.murmur3([ev(c) for c in expr.exprs],
                            [c.dtype for c in expr.exprs], expr.seed)
        return ColV(h, full(True, torch.bool))

    if isinstance(expr, E._DecimalSumCheck):
        c = ev(expr.child)
        return _overflow_null(c.data.to(torch.int64), c.validity,
                              expr.result.precision)

    if isinstance(expr, E._DecimalAvgEval):
        s, cnt = ev(expr.sum), ev(expr.count)
        out = expr.result
        sd = s.data.to(torch.int64)
        cd = cnt.data.to(torch.int64)
        valid = s.validity & cnt.validity & (cd > 0)
        safe_c = torch.where(cd <= 0, 1, cd)
        shift = _pow10(out.scale - expr.sum.dtype.scale)
        # avg = round(sum * 10^shift / count) without overflow:
        # q * 10^shift + round(rem * 10^shift / count), |rem| < count
        q = _trunc_div(sd, safe_c)
        rem = sd - q * safe_c
        res = q * shift + _div_half_up(rem * shift, safe_c)
        return _overflow_null(res, valid, out.precision)

    if isinstance(expr, E.NativeUDF):
        # the UDF's columnar function runs inside the projection
        # (reference: RapidsUDF.evaluateColumnar); a dictionary-encoded
        # input reaches it expanded, as the reference's do under
        # DICT_MATERIALIZE_EAGERLY (its word count asserts a StrV)
        return expr.columnar_fn(cap, *[as_plain_str(ev(c))
                                       for c in expr.children_])

    if isinstance(expr, (E.Add, E.Subtract, E.Multiply)):
        out = expr.dtype
        l, r = ev(expr.left), ev(expr.right)
        if isinstance(out, T.DecimalType):
            return _decimal_arith(expr, l, r, out)
        ld, rd = _promote2(l, expr.left.dtype, r, expr.right.dtype, out)
        op = {E.Add: torch.add, E.Subtract: torch.sub,
              E.Multiply: torch.mul}[type(expr)]
        return ColV(op(ld, rd), l.validity & r.validity)

    if isinstance(expr, E.Divide):
        # subnormal operands read as zero, as on the reference's backends:
        # x / 5e-324 is NULL there
        l, r = ev(expr.left), ev(expr.right)
        if isinstance(expr.dtype, T.DecimalType):
            return _decimal_divide(expr, l, r, expr.dtype)
        ld = flush_subnormals(_cast_data(l.data, expr.left.dtype, T.DOUBLE))
        rd = flush_subnormals(_cast_data(r.data, expr.right.dtype, T.DOUBLE))
        valid = l.validity & r.validity & (rd != 0)
        return ColV(ld / torch.where(rd == 0, 1.0, rd), valid)

    if isinstance(expr, E.IntegralDivide):
        l, r = ev(expr.left), ev(expr.right)
        ld = _cast_data(l.data, expr.left.dtype, T.LONG)
        rd = _cast_data(r.data, expr.right.dtype, T.LONG)
        valid = l.validity & r.validity & (rd != 0)
        return ColV(_trunc_div(ld, rd), valid)

    if isinstance(expr, E.Remainder):
        out = expr.dtype
        l, r = ev(expr.left), ev(expr.right)
        ld, rd = _promote2(l, expr.left.dtype, r, expr.right.dtype, out)
        valid = l.validity & r.validity
        if not out.is_floating:
            valid = valid & (rd != 0)
        return ColV(_java_rem(ld, rd), valid)

    if isinstance(expr, E._BinaryComparison):
        l, r = ev(expr.left), ev(expr.right)
        strs = (StrV, DictV)
        if isinstance(l, strs) or isinstance(r, strs):
            if not (isinstance(l, strs) and isinstance(r, strs)):
                raise UnsupportedExpressionError(
                    "comparison between string and non-string")
            # a dictionary against a literal: one compare over the
            # entries, then an int32 gather (reference eval.py:425-434)
            if isinstance(l, DictV) and isinstance(expr.right, E.Literal):
                return dict_compare_literal(expr, l, expr.right.value, cap)
            if isinstance(r, DictV) and isinstance(expr.left, E.Literal):
                return dict_compare_literal(expr, r, expr.left.value, cap,
                                            flipped=True)
            return compare_strings(expr, as_plain_str(l), as_plain_str(r),
                                   cap)
        tgt = (T.promote(expr.left.dtype, expr.right.dtype)
               if expr.left.dtype != expr.right.dtype else expr.left.dtype)
        ld, rd = _promote2(l, expr.left.dtype, r, expr.right.dtype, tgt)
        # subnormals compare as zero, as on the reference's backends (and
        # as a subnormal key groups with 0.0, ops/hashing.canonical_float)
        res = _cmp(expr, flush_subnormals(ld), flush_subnormals(rd),
                   tgt.is_floating)
        if isinstance(expr, E.EqualNullSafe):
            both_null = ~l.validity & ~r.validity
            val = (l.validity & r.validity & res) | both_null
            return ColV(val, full(True, torch.bool))
        return ColV(res, l.validity & r.validity)

    if isinstance(expr, E.And):
        # Kleene AND: false dominates null
        l, r = ev(expr.left), ev(expr.right)
        valid = ((l.validity & r.validity) | (l.validity & ~l.data)
                 | (r.validity & ~r.data))
        data = (torch.where(l.validity, l.data, True)
                & torch.where(r.validity, r.data, True))
        return ColV(torch.where(valid, data, False), valid)

    if isinstance(expr, E.Or):
        # Kleene OR: true dominates null
        l, r = ev(expr.left), ev(expr.right)
        valid = ((l.validity & r.validity) | (l.validity & l.data)
                 | (r.validity & r.data))
        data = (torch.where(l.validity, l.data, False)
                | torch.where(r.validity, r.data, False))
        return ColV(torch.where(valid, data, False), valid)

    if isinstance(expr, E.Not):
        c = ev(expr.child)
        return ColV(~c.data, c.validity)

    if isinstance(expr, E.IsNull):
        c = ev(expr.child)
        return ColV(~c.validity, full(True, torch.bool))

    if isinstance(expr, E.IsNotNull):
        c = ev(expr.child)
        return ColV(c.validity.clone(), full(True, torch.bool))

    if isinstance(expr, E.Coalesce):
        out = expr.dtype
        if T.is_string(out):
            vals = [as_strv(ev(e), cap) for e in expr.exprs]
            valid = vals[0].validity
            for v in vals[1:]:
                valid = valid | v.validity
            sel = full(len(vals) - 1, torch.int32)
            for k in reversed(range(len(vals))):
                sel = torch.where(vals[k].validity, k, sel)
            return select_strings(vals, sel, valid, cap)
        _check_fixed(out)
        acc = None
        for e in expr.exprs:
            v = ev(e)
            d = _cast_data(v.data, e.dtype, out)
            if acc is None:
                acc = ColV(d, v.validity)
            else:
                take_new = ~acc.validity & v.validity
                acc = ColV(torch.where(take_new, d, acc.data),
                           acc.validity | v.validity)
        return acc

    if isinstance(expr, E.If):
        out = expr.dtype
        p = ev(expr.predicate)
        if T.is_string(out):
            t = as_strv(ev(expr.true_value), cap)
            f = as_strv(ev(expr.false_value), cap)
            cond = p.validity & p.data
            sel = torch.where(cond, 0, 1).to(torch.int32)
            return select_strings([t, f], sel, torch.where(
                cond, t.validity, f.validity), cap)
        _check_fixed(out)
        t, f = ev(expr.true_value), ev(expr.false_value)
        td = _cast_data(t.data, expr.true_value.dtype, out)
        fd = _cast_data(f.data, expr.false_value.dtype, out)
        cond = p.validity & p.data
        return ColV(torch.where(cond, td, fd),
                    torch.where(cond, t.validity, f.validity))

    if isinstance(expr, E.CaseWhen):
        out = expr.dtype
        if T.is_string(out):
            vals = [as_strv(ev(v), cap) for _, v in expr.branches]
            vals.append(as_strv(ev(expr.else_value)
                                if expr.else_value is not None else None,
                                cap, device))
            k_else = len(expr.branches)
            sel = full(k_else, torch.int32)
            valid = vals[k_else].validity
            taken = full(False, torch.bool)
            for k, (cond_e, _) in enumerate(expr.branches):
                c = ev(cond_e)
                fire = ~taken & c.validity & c.data
                sel = torch.where(fire, k, sel)
                valid = torch.where(fire, vals[k].validity, valid)
                taken = taken | fire
            return select_strings(vals, sel, valid, cap)
        _check_fixed(out)
        if expr.else_value is not None:
            e = ev(expr.else_value)
            data = _cast_data(e.data, expr.else_value.dtype, out)
            valid = e.validity
        else:
            data = full(0, torch_dtype(out))
            valid = full(False, torch.bool)
        taken = full(False, torch.bool)
        for cond_e, val_e in expr.branches:
            c = ev(cond_e)
            v = ev(val_e)
            vd = _cast_data(v.data, val_e.dtype, out)
            fire = ~taken & c.validity & c.data
            data = torch.where(fire, vd, data)
            valid = torch.where(fire, v.validity, valid)
            taken = taken | fire
        return ColV(data, valid)

    if isinstance(expr, E.Cast):
        frm, to = expr.child.dtype, expr.to
        if frm == to:
            return ev(expr.child)
        c = ev(expr.child)
        if isinstance(c, DictV):
            if T.is_string(to):
                return c
            # cast the dictionary once, gather the per-row result
            # (reference eval.py:648-660)
            return dict_gather_col(c, lower_string_cast(c.dictionary, to,
                                                        c.dict_size))
        if isinstance(c, StrV):
            return lower_string_cast(c, to, cap)
        if T.is_string(to):
            _check_fixed(frm)
            return lower_cast_to_string(c, frm, cap)
        _check_fixed(frm)
        _check_fixed(to)
        if isinstance(frm, T.DecimalType) or isinstance(to, T.DecimalType):
            return _decimal_cast(c, frm, to)
        valid = c.validity
        if frm.is_floating and isinstance(to, T.TimestampType):
            valid = valid & torch.isfinite(c.data)  # Spark: NaN/inf -> null
        return ColV(_cast_data(c.data, frm, to), valid)

    mv = _lower_math(expr, ev, cap, device)
    if mv is not None:
        return mv

    if isinstance(expr, E.Length):
        c = ev(expr.child)
        if isinstance(c, DictV):
            # count the entries' characters, gather through the codes
            d = c.dictionary
            return dict_gather_col(c, ColV(S.char_counts(d), d.validity))
        if not isinstance(c, StrV):
            raise UnsupportedExpressionError("length() on non-string")
        return ColV(S.char_counts(c), c.validity)

    sv = lower_strings(expr, ev, cap)
    if sv is not None:
        return sv

    dv = lower_datetime(expr, ev, cap)
    if dv is not None:
        return dv

    raise UnsupportedExpressionError(
        f"no lowering for {type(expr).__name__}")


def tpu_supports(expr: E.Expression, schema: T.StructType
                 ) -> Tuple[bool, str]:
    """Supportability probe of the planner (reference ``eval.py:886``,
    which traces abstractly): bind ``expr`` and lower it over capacity-8
    CPU tensors. ``UnsupportedExpressionError`` and ``TypeError`` mean
    the plan falls back, as any error of a native UDF's columnar function
    does. ``NotImplementedError`` (a node, type or layer the port has not
    ported) propagates: the planner must raise it, never fall back."""
    try:
        bound = E.bind_references(expr, schema)
        cap = 8
        cpu = torch.device("cpu")
        cols: List[Val] = []
        for f in schema.fields:
            valid = torch.zeros(cap, dtype=torch.bool)
            if T.is_string(f.dataType):
                cols.append(StrV(torch.zeros(cap + 1, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.uint8), valid))
            else:
                cols.append(ColV(torch.zeros(cap,
                                             dtype=torch_dtype(f.dataType)),
                                 valid))
        lower(bound, cols, cap, cpu)
        return True, ""
    except NotImplementedError:
        raise
    except (UnsupportedExpressionError, TypeError) as e:
        return False, str(e)
    except Exception as e:  # noqa: BLE001
        if any(isinstance(n, E.NativeUDF) for n in _walk_expressions(expr)):
            return False, f"native UDF columnar trace failed: {e}"
        raise


def _walk_expressions(expr: E.Expression):
    yield expr
    for c in expr.children:
        yield from _walk_expressions(c)


def val_of_column(c: DeviceColumn) -> Val:
    """A column's planes as a lowering value: a dictionary-encoded column
    enters as its DictV, or expanded under the
    ``column.DICT_MATERIALIZE_EAGERLY`` test seam."""
    if c.is_dict:
        if not _colmod.DICT_MATERIALIZE_EAGERLY:
            return c.dictv
        c = c.materialize()
    if c.is_string:
        return StrV(c.offsets, c.chars, c.validity)
    return ColV(c.data, c.validity)


def column_of_val(dtype: DataType, num_rows, v: Val) -> DeviceColumn:
    """A lowering value as a column of ``num_rows`` rows."""
    if isinstance(v, DictV):
        return DeviceColumn.dict_encoded(dtype, num_rows, v)
    if isinstance(v, StrV):
        return DeviceColumn(dtype, num_rows, None, v.validity, v.offsets,
                            v.chars)
    return DeviceColumn(dtype, num_rows, v.data, v.validity)


def evaluate_projection(bound_exprs: Sequence[E.Expression],
                        batch: ColumnarBatch) -> List[DeviceColumn]:
    """Evaluate bound expressions against a batch (reference:
    ``eval.evaluate_projection``), eagerly on the batch's device."""
    cols = [val_of_column(c) for c in batch.columns]
    dev = cols[0].validity.device if cols else None
    n = batch.num_rows_lazy
    return [column_of_val(e.dtype, n, lower(e, cols, batch.capacity, dev))
            for e in bound_exprs]
