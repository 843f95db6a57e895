"""The port's fixed-width expression lowering against the reference's
``expr/eval.lower``, bit for bit.

Both packages build the same tree from their own expression classes (same
names and fields); the same numpy inputs go through both lowerings.
Validity must match exactly and data must match bit for bit on every
valid row (the data under a null is unspecified in both engines).
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import eval as JEV
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import eval as EV
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.values import ColV

CAP = 256


def _inputs():
    rng = np.random.default_rng(17)
    i32 = rng.integers(-(2**31), 2**31 - 1, CAP).astype(np.int32)
    i32[:8] = [2**31 - 1, -(2**31), -(2**31), 7, -7, 0, 1, -1]
    j32 = rng.integers(-50, 50, CAP).astype(np.int32)
    j32[:8] = [1, -1, 1, 0, 2, 3, 0, 2**31 - 1]
    i64 = rng.integers(-(2**63), 2**63 - 1, CAP, dtype=np.int64)
    i64[:6] = [2**63 - 1, -(2**63), -(2**63), 9, -9, 0]
    j64 = rng.integers(-5, 5, CAP).astype(np.int64)
    j64[:6] = [2, -1, 1, 0, 4, -3]
    f64 = rng.normal(size=CAP) * 10.0 ** rng.integers(-3, 12, CAP)
    f64[:12] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300, -1e300, 2.5,
                -2.5, 3e9, -3e9, 9.3e18]
    g64 = rng.normal(size=CAP)
    g64[:12] = [1.0, np.nan, 0.0, -0.0, np.inf, 0.0, 2.0, np.nan, -np.inf,
                7.0, 0.0, 1.5]
    f32 = rng.normal(size=CAP).astype(np.float32) * 100
    f32[:4] = [np.nan, np.inf, -0.0, 3e9]
    i16 = rng.integers(-(2**15), 2**15 - 1, CAP).astype(np.int16)
    b1 = rng.random(CAP) < 0.5
    b2 = rng.random(CAP) < 0.5
    cols = [i32, j32, i64, j64, f64, g64, f32, i16, b1, b2]
    valids = [rng.random(CAP) < 0.8 for _ in cols]
    for v in valids:
        v[:12] = True
    # 3VL needs every (true, false, null) x (true, false, null) pair
    b1[:9] = [True, True, True, False, False, False, True, False, True]
    b2[:9] = [True, False, True, True, False, False, True, False, True]
    valids[8][:9] = [True, True, True, True, True, True, False, False, False]
    valids[9][:9] = [True, True, False, True, True, False, True, True, False]
    return cols, valids


_TYPES = ["INT", "INT", "LONG", "LONG", "DOUBLE", "DOUBLE", "FLOAT", "SHORT",
          "BOOLEAN", "BOOLEAN"]
I32, J32, I64, J64, F64, G64, F32, I16, B1, B2 = range(10)


def _ref(M, TT, i):
    return M.BoundReference(i, getattr(TT, _TYPES[i]))


# each case builds one tree from (expressions module, types module)
CASES = {
    "add_int_wrap": lambda M, TT: M.Add(_ref(M, TT, I32), _ref(M, TT, J32)),
    "sub_long_wrap": lambda M, TT: M.Subtract(_ref(M, TT, I64),
                                              _ref(M, TT, J64)),
    "mul_int_wrap": lambda M, TT: M.Multiply(_ref(M, TT, I32),
                                             _ref(M, TT, J32)),
    "mul_long_wrap": lambda M, TT: M.Multiply(_ref(M, TT, I64),
                                              M.Literal(3, TT.INT)),
    "mul_int_long_promote": lambda M, TT: M.Multiply(_ref(M, TT, I32),
                                                     _ref(M, TT, I64)),
    "add_short_int": lambda M, TT: M.Add(_ref(M, TT, I16), _ref(M, TT, J32)),
    "add_double_nan": lambda M, TT: M.Add(_ref(M, TT, F64), _ref(M, TT, G64)),
    "add_float_double": lambda M, TT: M.Add(_ref(M, TT, F32),
                                            _ref(M, TT, F64)),
    "divide_by_zero": lambda M, TT: M.Divide(_ref(M, TT, I32),
                                             _ref(M, TT, J32)),
    "divide_double": lambda M, TT: M.Divide(_ref(M, TT, F64),
                                            _ref(M, TT, G64)),
    "int_div_min_neg1": lambda M, TT: M.IntegralDivide(_ref(M, TT, I64),
                                                       _ref(M, TT, J64)),
    "int_div_int": lambda M, TT: M.IntegralDivide(_ref(M, TT, I32),
                                                  _ref(M, TT, J32)),
    "rem_long": lambda M, TT: M.Remainder(_ref(M, TT, I64), _ref(M, TT, J64)),
    "rem_int": lambda M, TT: M.Remainder(_ref(M, TT, I32), _ref(M, TT, J32)),
    "rem_double": lambda M, TT: M.Remainder(_ref(M, TT, F64),
                                            _ref(M, TT, G64)),
    "lt_int_long": lambda M, TT: M.LessThan(_ref(M, TT, I32),
                                            _ref(M, TT, I64)),
    "eq_double_nan": lambda M, TT: M.EqualTo(_ref(M, TT, F64),
                                             _ref(M, TT, G64)),
    "ge_double_nan": lambda M, TT: M.GreaterThanOrEqual(_ref(M, TT, F64),
                                                        _ref(M, TT, G64)),
    "le_float_lit": lambda M, TT: M.LessThanOrEqual(_ref(M, TT, F32),
                                                    M.Literal(0.5, TT.DOUBLE)),
    "gt_long": lambda M, TT: M.GreaterThan(_ref(M, TT, I64), _ref(M, TT, J64)),
    "eq_null_safe": lambda M, TT: M.EqualNullSafe(_ref(M, TT, B1),
                                                  _ref(M, TT, B2)),
    "and_3vl": lambda M, TT: M.And(_ref(M, TT, B1), _ref(M, TT, B2)),
    "or_3vl": lambda M, TT: M.Or(_ref(M, TT, B1), _ref(M, TT, B2)),
    "not": lambda M, TT: M.Not(_ref(M, TT, B1)),
    "is_null": lambda M, TT: M.IsNull(_ref(M, TT, F64)),
    "is_not_null": lambda M, TT: M.IsNotNull(_ref(M, TT, I32)),
    "coalesce": lambda M, TT: M.Coalesce((
        M.Literal(None, TT.NULL), _ref(M, TT, I32), _ref(M, TT, I64),
        M.Literal(-1, TT.LONG))),
    "if": lambda M, TT: M.If(M.GreaterThan(_ref(M, TT, F64),
                                           M.Literal(0.0, TT.DOUBLE)),
                             _ref(M, TT, I32), _ref(M, TT, I64)),
    "case_when": lambda M, TT: M.CaseWhen(
        ((_ref(M, TT, B1), _ref(M, TT, F64)),
         (M.LessThan(_ref(M, TT, I32), M.Literal(0, TT.INT)),
          M.Literal(1.5, TT.DOUBLE))),
        _ref(M, TT, G64)),
    "case_when_no_else": lambda M, TT: M.CaseWhen(
        ((_ref(M, TT, B2), _ref(M, TT, I16)),)),
    "nested_arith_filter": lambda M, TT: M.And(
        M.GreaterThanOrEqual(_ref(M, TT, I64), M.Literal(0, TT.INT)),
        M.LessThan(M.Multiply(_ref(M, TT, I32), M.Literal(2, TT.INT)),
                   M.Literal(10**6, TT.INT))),
}

CASTS = [("DOUBLE", "INT", F64), ("DOUBLE", "LONG", F64),
         ("DOUBLE", "BYTE", F64), ("DOUBLE", "SHORT", F64),
         ("FLOAT", "INT", F32), ("FLOAT", "LONG", F32),
         ("LONG", "INT", I64), ("LONG", "SHORT", I64), ("INT", "BYTE", I32),
         ("INT", "DOUBLE", I32), ("LONG", "DOUBLE", I64),
         ("LONG", "FLOAT", I64), ("DOUBLE", "FLOAT", F64),
         ("FLOAT", "DOUBLE", F32), ("BOOLEAN", "INT", B1),
         ("INT", "BOOLEAN", I32), ("DOUBLE", "BOOLEAN", F64),
         ("SHORT", "LONG", I16)]


def _lower_both(build):
    cols, valids = _inputs()
    jcols = [JEV.ColV(jnp.asarray(d), jnp.asarray(v))
             for d, v in zip(cols, valids)]
    tcols = [ColV(torch.from_numpy(d.copy()), torch.from_numpy(v.copy()))
             for d, v in zip(cols, valids)]
    ref = JEV.lower(build(JE, JT), jcols, CAP)
    got = EV.lower(build(E, T), tcols, CAP)
    return ref, got


def _assert_same(ref, got):
    rv = np.asarray(ref.validity)
    np.testing.assert_array_equal(got.validity.numpy(), rv)
    rd = np.asarray(ref.data)
    gd = got.data.numpy()
    assert gd.dtype == rd.dtype, (gd.dtype, rd.dtype)
    if rd.dtype.kind == "f":
        rd = rd.view(np.int64 if rd.itemsize == 8 else np.int32)
        gd = gd.view(rd.dtype)
        # NaN payloads may differ between backends; compare NaN-ness there
        nan = np.isnan(np.asarray(ref.data))
        np.testing.assert_array_equal(np.isnan(got.data.numpy())[rv],
                                      nan[rv])
        rv = rv & ~nan
    np.testing.assert_array_equal(gd[rv], rd[rv])


@pytest.mark.parametrize("case", sorted(CASES))
def test_lower_matches_reference(case):
    ref, got = _lower_both(CASES[case])
    _assert_same(ref, got)


@pytest.mark.parametrize("frm,to,idx", CASTS)
def test_cast_matches_reference(frm, to, idx):
    def build(M, TT):
        return M.Cast(M.BoundReference(idx, getattr(TT, frm)),
                      getattr(TT, to))
    ref, got = _lower_both(build)
    _assert_same(ref, got)


def test_types_not_ported_raise():
    """Dates, timestamps and decimals are storable (ROADMAP item 6 is
    ported); what the reference cannot hold or cast still raises: an
    array column, and int -> date, which the reference's lowering refuses
    with the same reason."""
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
    from spark_rapids_tpu_torch.expr.values import UnsupportedExpressionError

    b = ColumnarBatch.from_pydict({"d": [1, None]}, schema_of(d=T.DATE),
                                  device="cpu")
    assert b.to_rows() == [(1,), (None,)]
    with pytest.raises(TypeError, match="not representable"):
        ColumnarBatch.from_pydict({"a": [[1]]},
                                  schema_of(a=T.ArrayType(T.INT)),
                                  device="cpu")
    with pytest.raises(UnsupportedExpressionError,
                       match="cast int -> date is not supported"):
        EV.lower(E.Cast(E.BoundReference(0, T.INT), T.DATE),
                 [ColV(torch.zeros(4, dtype=torch.int32),
                       torch.ones(4, dtype=torch.bool))], 4)


def test_evaluate_projection_matches_reference():
    """The batch-level entry (reference ``eval.evaluate_projection``) over
    a padded batch: every column at capacity, padding included."""
    from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
    from spark_rapids_tpu.columnar.batch import schema_of as jschema_of
    from spark_rapids_tpu.columnar.column import DeviceColumn as JColumn
    from spark_rapids_tpu_torch.columnar import (batch_from_host_arrays,
                                                 schema_of)

    cols, valids = _inputs()
    n = CAP - 56  # padding rows at the tail
    for v in valids:
        v[n:] = False
    picks = (I32, I64, F64, B1)
    names = ("i", "l", "d", "b")
    jschema = jschema_of(**{nm: getattr(JT, _TYPES[i])
                            for nm, i in zip(names, picks)})
    jb = JBatch([JColumn(f.dataType, n, jnp.asarray(cols[i]),
                         jnp.asarray(valids[i]))
                 for f, i in zip(jschema.fields, picks)], jschema, n)
    tb = batch_from_host_arrays(
        schema_of(**{nm: getattr(T, _TYPES[i])
                     for nm, i in zip(names, picks)}),
        [cols[i] for i in picks], [valids[i] for i in picks], n, CAP,
        device="cpu")

    def exprs(M, TT):
        return [M.Multiply(M.BoundReference(0, TT.INT),
                           M.Literal(3, TT.INT)),
                M.Divide(M.BoundReference(2, TT.DOUBLE),
                         M.BoundReference(1, TT.LONG)),
                M.Or(M.BoundReference(3, TT.BOOLEAN),
                     M.IsNull(M.BoundReference(2, TT.DOUBLE)))]

    ref = JEV.evaluate_projection(exprs(JE, JT), jb)
    got = EV.evaluate_projection(exprs(E, T), tb)
    for r, g in zip(ref, got):
        _assert_same(JEV.ColV(r.data, r.validity), ColV(g.data, g.validity))


#: ROADMAP §C's C2 input: two subnormals beside 0.0 and 1.0
SUBNORMALS = [5e-324, 0.0, -1e-310, 1.0]


def _exec_rows(engine, query):
    """One query over d = SUBNORMALS through each engine's scan, filter and
    project execs; the collected rows."""
    if engine == "jax":
        from spark_rapids_tpu import exec as M
        from spark_rapids_tpu.columnar.batch import ColumnarBatch as B
        from spark_rapids_tpu.columnar.batch import schema_of as sch
        from spark_rapids_tpu.conf import RapidsConf
        X, TT = JE, JT
        batch = lambda d, s: B.from_pydict(d, s)  # noqa: E731
    else:
        from spark_rapids_tpu_torch import exec as M
        from spark_rapids_tpu_torch.columnar import ColumnarBatch as B
        from spark_rapids_tpu_torch.columnar import schema_of as sch
        from spark_rapids_tpu_torch.conf import RapidsConf
        X, TT = E, T
        batch = lambda d, s: B.from_pydict(d, s, device="cpu")  # noqa: E731
    conf = RapidsConf({})
    schema = sch(d=TT.DOUBLE)
    plan = M.InMemoryScanExec(conf, [[batch({"d": SUBNORMALS}, schema)]],
                              schema)
    d, zero = X.col("d"), X.Literal(0.0, TT.DOUBLE)
    if query == "d = 0.0":
        plan = M.TpuFilterExec(conf, X.EqualTo(d, zero), plan)
    elif query == "d > 0.0":
        plan = M.TpuFilterExec(conf, X.GreaterThan(d, zero), plan)
    elif query == "cast(d as boolean)":
        plan = M.TpuProjectExec(conf, [X.Alias(X.Cast(d, TT.BOOLEAN), "b")],
                                plan)
    else:  # 1.0 / d
        plan = M.TpuProjectExec(conf, [X.Alias(X.Divide(
            X.Literal(1.0, TT.DOUBLE), d), "q")], plan)
    return plan.collect()


@pytest.mark.parametrize("query", ["d = 0.0", "d > 0.0", "cast(d as boolean)",
                                   "1.0 / d"])
def test_subnormal_operands_read_as_zero_as_the_reference(query):
    """Compares, the divide's zero check and boolean casts read a
    subnormal operand as zero, as the reference's backends do: the same
    rows, the same nulls and the same values."""
    ref = _exec_rows("jax", query)
    got = _exec_rows("torch", query)
    assert len(got) == len(ref)
    assert [[v is None for v in r] for r in got] == [
        [v is None for v in r] for r in ref]
    assert got == ref
