"""The math, sign, bitwise and predicate families (ROADMAP.md item 21)
of the port against the reference.

Each case builds one tree from both packages' own expression classes and
lowers the same seeded numpy inputs through the reference's
``expr/eval.lower`` and the port's. The port's own copy of the CPU
interpreter is held against the reference's interpreter on the same rows.
Validity must match exactly; integer data bit for bit, float data within
rtol 1e-12 (NaN where the reference has NaN, the sign of a zero kept),
on every valid row. A subnormal result compares as the zero of its sign:
the reference's backends flush subnormal results (ROADMAP.md §C, C2),
IEEE arithmetic in the port keeps them.
"""
import math

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.cpu import interpreter as JI
from spark_rapids_tpu.expr import eval as JEV
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.cpu import interpreter as PI
from spark_rapids_tpu_torch.expr import eval as EV
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.values import ColV

CAP = 128
_TYPES = ["INT", "INT", "LONG", "LONG", "DOUBLE", "DOUBLE", "FLOAT", "SHORT"]
I32, J32, I64, J64, F64, G64, F32, I16 = range(8)


def _inputs():
    """Seeded columns with the edge values in front: MIN/MAX ints, shift
    counts at and past the width, negative Pmod operands, ±0.0, NaN,
    ±inf, subnormals and HALF_UP ties."""
    rng = np.random.default_rng(23)
    i32 = rng.integers(-(2**31), 2**31 - 1, CAP).astype(np.int32)
    i32[:12] = [2**31 - 1, -(2**31), -7, 7, -7, 0, 1, -1, 5, -5, 15, -25]
    j32 = rng.integers(-70, 70, CAP).astype(np.int32)
    j32[:12] = [3, 3, 3, -3, -3, 0, 31, 32, 33, 64, -1, 100]
    i64 = rng.integers(-(2**63), 2**63 - 1, CAP, dtype=np.int64)
    i64[:10] = [2**63 - 1, -(2**63), -9, 9, 0, 1, -1, 150, -250, 2**40]
    j64 = rng.integers(-70, 70, CAP).astype(np.int64)
    j64[:10] = [4, 4, -4, 4, 0, 63, 64, 65, 127, -1]
    f64 = rng.normal(size=CAP) * 10.0 ** rng.integers(-3, 6, CAP)
    f64[:20] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, -1e-310, 2.5,
                -2.5, 0.5, -0.5, 1.005, 1e300, -1e300, 3.14159, -2.675,
                1.0, -1.0, 0.25, 12345.5]
    g64 = rng.normal(size=CAP) * 3
    g64[:20] = [1.0, np.nan, 0.0, -0.0, np.inf, -np.inf, 2.0, -3.0, 0.5,
                7.0, -0.0, 1e-320, 2.0, 0.0, -1.0, 3.0, np.nan, -2.0, 4.0,
                0.0]
    f32 = (rng.normal(size=CAP) * 100).astype(np.float32)
    f32[:8] = [np.nan, np.inf, -0.0, 2.5, -2.5, 1e-40, 3e9, -0.5]
    i16 = rng.integers(-(2**15), 2**15 - 1, CAP).astype(np.int16)
    i16[:4] = [2**15 - 1, -(2**15), -3, 3]
    cols = [i32, j32, i64, j64, f64, g64, f32, i16]
    valids = [rng.random(CAP) < 0.85 for _ in cols]
    for v in valids:
        v[:20] = True
    return cols, valids


def _ref(M, TT, i):
    return M.BoundReference(i, getattr(TT, _TYPES[i]))


def _lit(M, TT, v, t):
    return M.Literal(v, getattr(TT, t))


_UNARY_DOUBLE = ["Sqrt", "Cbrt", "Exp", "Expm1", "Log", "Log10", "Log2",
                 "Log1p", "Sin", "Cos", "Tan", "Asin", "Acos", "Atan",
                 "Sinh", "Cosh", "Tanh", "Rint", "ToDegrees", "ToRadians"]

CASES = {
    "unary_minus_int_min_wraps": lambda M, TT: M.UnaryMinus(_ref(M, TT, I32)),
    "unary_minus_long": lambda M, TT: M.UnaryMinus(_ref(M, TT, I64)),
    "unary_minus_double": lambda M, TT: M.UnaryMinus(_ref(M, TT, F64)),
    "unary_positive": lambda M, TT: M.UnaryPositive(_ref(M, TT, I16)),
    "abs_int_min_wraps": lambda M, TT: M.Abs(_ref(M, TT, I32)),
    "abs_long": lambda M, TT: M.Abs(_ref(M, TT, I64)),
    "abs_double": lambda M, TT: M.Abs(_ref(M, TT, F64)),
    "abs_float": lambda M, TT: M.Abs(_ref(M, TT, F32)),
    "pmod_int": lambda M, TT: M.Pmod(_ref(M, TT, I32), _ref(M, TT, J32)),
    "pmod_long": lambda M, TT: M.Pmod(_ref(M, TT, I64), _ref(M, TT, J64)),
    "pmod_int_long": lambda M, TT: M.Pmod(_ref(M, TT, I32),
                                          _ref(M, TT, J64)),
    "pmod_double": lambda M, TT: M.Pmod(_ref(M, TT, F64), _ref(M, TT, G64)),
    "signum_int": lambda M, TT: M.Signum(_ref(M, TT, I32)),
    "signum_double": lambda M, TT: M.Signum(_ref(M, TT, F64)),
    "bitand_int": lambda M, TT: M.BitwiseAnd(_ref(M, TT, I32),
                                             _ref(M, TT, J32)),
    "bitor_long": lambda M, TT: M.BitwiseOr(_ref(M, TT, I64),
                                            _ref(M, TT, J64)),
    "bitxor_int_long": lambda M, TT: M.BitwiseXor(_ref(M, TT, I32),
                                                  _ref(M, TT, I64)),
    "bitnot_short": lambda M, TT: M.BitwiseNot(_ref(M, TT, I16)),
    "bitnot_long": lambda M, TT: M.BitwiseNot(_ref(M, TT, I64)),
    "shl_int": lambda M, TT: M.ShiftLeft(_ref(M, TT, I32), _ref(M, TT, J32)),
    "shr_int": lambda M, TT: M.ShiftRight(_ref(M, TT, I32),
                                          _ref(M, TT, J32)),
    "shru_int": lambda M, TT: M.ShiftRightUnsigned(_ref(M, TT, I32),
                                                   _ref(M, TT, J32)),
    "shl_long": lambda M, TT: M.ShiftLeft(
        _ref(M, TT, I64), M.Cast(_ref(M, TT, J64), TT.INT)),
    "shr_long": lambda M, TT: M.ShiftRight(
        _ref(M, TT, I64), M.Cast(_ref(M, TT, J64), TT.INT)),
    "shru_long": lambda M, TT: M.ShiftRightUnsigned(
        _ref(M, TT, I64), M.Cast(_ref(M, TT, J64), TT.INT)),
    "floor_double": lambda M, TT: M.Floor(_ref(M, TT, F64)),
    "ceil_double": lambda M, TT: M.Ceil(_ref(M, TT, F64)),
    "floor_float": lambda M, TT: M.Floor(_ref(M, TT, F32)),
    "ceil_int": lambda M, TT: M.Ceil(_ref(M, TT, I32)),
    "round_double_0": lambda M, TT: M.Round(_ref(M, TT, F64), 0),
    "round_double_2": lambda M, TT: M.Round(_ref(M, TT, F64), 2),
    "round_double_neg1": lambda M, TT: M.Round(_ref(M, TT, F64), -1),
    "round_float_1": lambda M, TT: M.Round(_ref(M, TT, F32), 1),
    "round_int_neg1": lambda M, TT: M.Round(_ref(M, TT, I32), -1),
    "round_long_neg2": lambda M, TT: M.Round(_ref(M, TT, I64), -2),
    "round_int_pos": lambda M, TT: M.Round(_ref(M, TT, I32), 2),
    "pow_double": lambda M, TT: M.Pow(_ref(M, TT, F64), _ref(M, TT, G64)),
    "pow_int": lambda M, TT: M.Pow(_ref(M, TT, J32), _lit(M, TT, 3, "INT")),
    "atan2_double": lambda M, TT: M.Atan2(_ref(M, TT, F64),
                                          _ref(M, TT, G64)),
    "in_int": lambda M, TT: M.In(_ref(M, TT, I32),
                                 (7, -7, 2**31 - 1, 2**40)),
    "in_int_with_null": lambda M, TT: M.In(_ref(M, TT, I32), (1, None)),
    "in_long": lambda M, TT: M.In(_ref(M, TT, I64), (0, -(2**63), 150)),
    "in_double": lambda M, TT: M.In(_ref(M, TT, F64),
                                    (2.5, -0.0, float("inf"))),
    "in_float_int_literal": lambda M, TT: M.In(_ref(M, TT, F32), (3, 2.5)),
    "isnan_double": lambda M, TT: M.IsNan(_ref(M, TT, F64)),
    "isnan_float": lambda M, TT: M.IsNan(_ref(M, TT, F32)),
    "isnan_int": lambda M, TT: M.IsNan(_ref(M, TT, I32)),
    "nanvl_double": lambda M, TT: M.NaNvl(_ref(M, TT, F64),
                                          _ref(M, TT, G64)),
    "nanvl_float_double": lambda M, TT: M.NaNvl(_ref(M, TT, F32),
                                                _ref(M, TT, G64)),
}
for _name in _UNARY_DOUBLE:
    CASES[f"{_name.lower()}_double"] = (
        lambda M, TT, n=_name: getattr(M, n)(_ref(M, TT, F64)))
CASES["sqrt_int"] = lambda M, TT: M.Sqrt(_ref(M, TT, J32))
CASES["log_float"] = lambda M, TT: M.Log(_ref(M, TT, F32))


def _lower_both(build):
    cols, valids = _inputs()
    jcols = [JEV.ColV(jnp.asarray(d), jnp.asarray(v))
             for d, v in zip(cols, valids)]
    tcols = [ColV(torch.from_numpy(d.copy()), torch.from_numpy(v.copy()))
             for d, v in zip(cols, valids)]
    return (JEV.lower(build(JE, JT), jcols, CAP),
            EV.lower(build(E, T), tcols, CAP))


def _flush(x):
    tiny = np.finfo(x.dtype).tiny
    return np.where(np.abs(x) < tiny, np.copysign(np.zeros_like(x), x), x)


def _assert_close(ref_data, got_data, valid):
    rd = np.asarray(ref_data)[valid]
    gd = np.asarray(got_data)[valid]
    assert gd.dtype == rd.dtype, (gd.dtype, rd.dtype)
    if rd.dtype.kind != "f":
        np.testing.assert_array_equal(gd, rd)
        return
    rd, gd = _flush(rd), _flush(gd)
    np.testing.assert_array_equal(np.isnan(gd), np.isnan(rd))
    ok = ~np.isnan(rd)
    np.testing.assert_allclose(gd[ok], rd[ok], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(np.signbit(gd[ok] == 0) & np.signbit(gd[ok]),
                                  np.signbit(rd[ok] == 0) & np.signbit(rd[ok]))


#: cases where the reference is wrong on some rows, with the column and
#: the exact oracle those rows are held to instead: the reference's cbrt
#: of a subnormal is not the cube root (1.35e-108 for both 5e-324 and
#: -1e-310; ROADMAP.md §C)
_ORACLE_ON_SUBNORMALS = {"cbrt_double": (F64, np.cbrt)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lower_matches_reference(case):
    ref, got = _lower_both(CASES[case])
    rv = np.asarray(ref.validity)
    np.testing.assert_array_equal(got.validity.numpy(), rv)
    rd = np.array(ref.data)
    if case in _ORACLE_ON_SUBNORMALS:
        col, fn = _ORACLE_ON_SUBNORMALS[case]
        x = _inputs()[0][col]
        sub = (x != 0) & (np.abs(x) < np.finfo(x.dtype).tiny)
        assert sub.any()
        rd[sub] = fn(x[sub])
    _assert_close(rd, got.data.numpy(), rv)


def _rows():
    cols, valids = _inputs()
    return [tuple(c[i].item() if v[i] else None for c, v in zip(cols, valids))
            for i in range(CAP)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_interpreter_matches_reference(case):
    """The port's own copy of the CPU interpreter (the session's fallback
    engine) gives the reference interpreter's value on every row."""
    rows = _rows()
    ref = JI.eval_expression_rows(CASES[case](JE, JT), rows)
    got = PI.eval_expression_rows(CASES[case](E, T), rows)
    for r, g in zip(ref, got):
        if isinstance(r, float) and math.isnan(r):
            assert isinstance(g, float) and math.isnan(g)
        else:
            assert type(g) is type(r) and g == r, (r, g)
            if isinstance(r, float):
                assert math.copysign(1, g) == math.copysign(1, r)


def test_not_ported_nodes_raise_naming_their_items():
    """Nondeterministic nodes lower on the reference's device; the port
    raises NotImplementedError naming the ROADMAP item, and tpu_supports
    lets it propagate instead of reporting a fallback. The date/time
    nodes are ported (item 6): DateAdd is supported, and a cast the
    reference refuses falls back with the reference's reason."""
    schema = T.StructType((T.StructField("x", T.LONG),))
    with pytest.raises(NotImplementedError, match="Nondeterministic"):
        EV.tpu_supports(E.Rand(3), schema)
    dschema = T.StructType((T.StructField("d", T.DATE),
                            T.StructField("x", T.LONG)))
    jschema = JT.StructType((JT.StructField("d", JT.DATE),
                             JT.StructField("x", JT.LONG)))
    for M, TT, sch, ev in ((E, T, dschema, EV), (JE, JT, jschema, JEV)):
        assert ev.tpu_supports(M.DateAdd(M.col("d"), M.Literal(1, TT.INT)),
                               sch) == (True, "")
    cast = EV.tpu_supports(E.DateAdd(E.Cast(E.col("x"), T.DATE),
                                     E.Literal(1, T.INT)), schema)
    assert cast == JEV.tpu_supports(
        JE.DateAdd(JE.Cast(JE.col("x"), JT.DATE), JE.Literal(1, JT.INT)),
        JT.StructType((JT.StructField("x", JT.LONG),)))
    assert cast == (False, "cast bigint -> date is not supported")
    ok, why = EV.tpu_supports(E.PythonUDF(lambda v: v, (E.col("x"),)),
                              schema)
    assert not ok and "PythonUDF" in why
    assert EV.tpu_supports(E.Pmod(E.col("x"), E.Literal(3, T.INT)),
                           schema) == (True, "")
