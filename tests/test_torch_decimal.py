"""DECIMAL64 (ROADMAP item 6) against the reference, on the CPU.

Every case of the reference's ``tests/test_decimal.py`` runs here through
both packages: the same numpy-seeded rows (the reference's edge unscaled
values among them) go through the reference's ``evaluate_projection``
and the port's (``device="cpu"``), and the unscaled int64 values,
validity over the whole capacity and row order must be equal bit for
bit; a decimal -> double result too (tolerance 0), and every row must
equal the port's CPU engine. The planner's probes (``tpu_supports``), the
result types, Spark's aggregate buffers and their DECIMAL64 refusals
must give the reference's answers and reasons.
"""
from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.batch import schema_of as jschema_of
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import bind_references as jbind
from spark_rapids_tpu.expr import evaluate_projection as jevaluate
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr.eval import tpu_supports as jsupports
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
from spark_rapids_tpu_torch.cpu import eval_expression_rows
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.eval import (evaluate_projection,
                                              tpu_supports)

N = 128


def gen_decimals(rng, n, p, s, null_prob=0.15, edge_prob=0.2):
    """The reference's generator on a numpy stream: NULLs, its edge
    unscaled values (0, +-(10^p - 1), +-10^(p-1), +-1, ...) and uniform
    ones, scaled by 10^-s."""
    lim = 10 ** p - 1
    edges = [0, lim, -lim, 10 ** (p - 1), -(10 ** (p - 1)), 1, -1,
             lim - 1, -(lim - 1)]
    r = rng.random(n)
    pick = rng.integers(0, len(edges), n)
    uni = rng.integers(-lim, lim, n, endpoint=True)
    return [None if r[i] < null_prob else Decimal(int(
        edges[pick[i]] if r[i] < null_prob + edge_prob else uni[i])
    ).scaleb(-s) for i in range(n)]


def gen_ints(rng, n, lo=-1000, hi=1000, null_prob=0.1):
    r = rng.random(n)
    v = rng.integers(lo, hi, n, endpoint=True)
    return [None if r[i] < null_prob else int(v[i]) for i in range(n)]


def _schemas(types):
    return (jschema_of(**{k: f(JT) for k, f in types.items()}),
            schema_of(**{k: f(T) for k, f in types.items()}))


def run_both(build, data, types):
    """``build(M, TT)`` over ``data`` (columns typed by ``types``: name ->
    ``lambda TT: type``) through both packages. Returns (reference
    column, port column, port bound expression, rows)."""
    js, ps = _schemas(types)
    jb = JBatch.from_pydict(data, js)
    pb = ColumnarBatch.from_pydict(data, ps, device="cpu")
    [ref] = jevaluate([jbind(build(JE, JT), js)], jb)
    bound = E.bind_references(build(E, T), ps)
    [got] = evaluate_projection([bound], pb)
    return ref, got, bound, list(zip(*[data[k] for k in types]))


def assert_same(ref, got):
    """Validity over the whole capacity and the valid values equal bit
    for bit (a float by its bits), then the Python rows."""
    rv = np.asarray(ref.validity)
    gv = got.validity.numpy()
    assert np.array_equal(rv, gv)
    rd = np.asarray(ref.data)
    gd = got.data.numpy()
    assert rd.dtype == gd.dtype
    if rd.dtype.kind == "f":
        rd, gd = rd.view(np.int64 if rd.itemsize == 8 else np.int32), \
            gd.view(np.int64 if gd.itemsize == 8 else np.int32)
    assert np.array_equal(np.where(rv, rd, 0), np.where(gv, gd, 0))
    assert got.to_host().to_pylist() == ref.to_pylist()


def check(build, pa=7, sa=2, pb=7, sb=2, seed=0):
    """The reference's ``check``: two decimal columns a, b; the port
    against the reference and against its CPU engine."""
    rng = np.random.default_rng(seed)
    data = {"a": gen_decimals(rng, N, pa, sa),
            "b": gen_decimals(rng, N, pb, sb)}
    types = {"a": lambda TT: TT.DecimalType(pa, sa),
             "b": lambda TT: TT.DecimalType(pb, sb)}
    ref, got, bound, rows = run_both(build, data, types)
    assert_same(ref, got)
    assert got.to_host().to_pylist() == eval_expression_rows(bound, rows)


def supports_both(build, types):
    js, ps = _schemas(types)
    got = tpu_supports(build(E, T), ps)
    assert got == jsupports(build(JE, JT), js)
    return got


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["Add", "Subtract"])
def test_add_sub_same_scale(op):
    check(lambda M, TT: getattr(M, op)(M.col("a"), M.col("b")), seed=1)


@pytest.mark.parametrize("op", ["Add", "Subtract"])
def test_add_sub_mixed_scale(op):
    check(lambda M, TT: getattr(M, op)(M.col("a"), M.col("b")),
          pa=9, sa=4, pb=6, sb=1, seed=2)


def test_add_overflow_edges():
    """(18,0) + (18,0) needs precision 19: both planners refuse it with
    the same reason."""
    ok, why = supports_both(
        lambda M, TT: M.Add(M.col("a"), M.col("b")),
        {"a": lambda TT: TT.DecimalType(18, 0),
         "b": lambda TT: TT.DecimalType(18, 0)})
    assert not ok and "DECIMAL64" in why


def test_multiply():
    check(lambda M, TT: M.Multiply(M.col("a"), M.col("b")),
          pa=7, sa=2, pb=8, sb=3, seed=3)


def test_multiply_precision_cap_falls_back():
    ok, _ = supports_both(
        lambda M, TT: M.Multiply(M.col("a"), M.col("b")),
        {"a": lambda TT: TT.DecimalType(10, 2),
         "b": lambda TT: TT.DecimalType(10, 2)})
    assert not ok


@pytest.mark.parametrize("shape", [(5, 2, 4, 1), (7, 2, 7, 2), (3, 0, 9, 4)])
def test_divide(shape):
    pa, sa, pb, sb = shape
    check(lambda M, TT: M.Divide(M.col("a"), M.col("b")),
          pa=pa, sa=sa, pb=pb, sb=sb, seed=4)


def test_divide_too_wide_falls_back():
    """A quotient whose shifted numerator passes 18 digits: both lowerings
    refuse it with the same reason."""
    ok, why = supports_both(
        lambda M, TT: M.Divide(M.col("a"), M.col("b")),
        {"a": lambda TT: TT.DecimalType(9, 0),
         "b": lambda TT: TT.DecimalType(7, 2)})
    assert not ok and "DECIMAL64" in why


def test_divide_by_zero_is_null():
    data = {"a": [Decimal("1.25"), Decimal("-3.50"), None],
            "b": [Decimal("0.0"), Decimal("0.0"), Decimal("1.0")]}
    ref, got, _, _ = run_both(
        lambda M, TT: M.Divide(M.col("a"), M.col("b")), data,
        {"a": lambda TT: TT.DecimalType(5, 2),
         "b": lambda TT: TT.DecimalType(4, 1)})
    assert_same(ref, got)
    assert got.to_host().to_pylist() == [None, None, None]


@pytest.mark.parametrize("op", ["Add", "Subtract", "Multiply"])
def test_decimal_int_mixed(op):
    rng = np.random.default_rng(5)
    data = {"a": gen_decimals(rng, N, 7, 2), "b": gen_ints(rng, N)}
    types = {"a": lambda TT: TT.DecimalType(7, 2), "b": lambda TT: TT.INT}
    ref, got, bound, rows = run_both(
        lambda M, TT: getattr(M, op)(M.col("a"), M.col("b")), data, types)
    assert_same(ref, got)
    assert got.to_host().to_pylist() == eval_expression_rows(bound, rows)


@pytest.mark.parametrize("op", ["UnaryMinus", "Abs", "UnaryPositive"])
def test_unary_minus_abs(op):
    check(lambda M, TT: getattr(M, op)(M.col("a")), seed=6)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["EqualTo", "LessThan", "GreaterThan",
                                "LessThanOrEqual", "GreaterThanOrEqual",
                                "EqualNullSafe"])
def test_comparisons_mixed_scale(op):
    check(lambda M, TT: getattr(M, op)(M.col("a"), M.col("b")),
          pa=9, sa=4, pb=7, sb=1, seed=8)


@pytest.mark.parametrize("lit", ["12.34", "-0.5", "99999.99", "0"])
def test_compare_with_literal(lit):
    check(lambda M, TT: M.GreaterThan(M.col("a"), M.lit(Decimal(lit))),
          seed=9)


def test_compare_with_double_is_double():
    """Decimal against a double compares as double (Spark's rule)."""
    rng = np.random.default_rng(10)
    data = {"a": gen_decimals(rng, N, 7, 2),
            "b": [None if v is None else float(v) * 1.5
                  for v in gen_decimals(rng, N, 7, 2)]}
    ref, got, bound, rows = run_both(
        lambda M, TT: M.LessThan(M.col("a"), M.col("b")), data,
        {"a": lambda TT: TT.DecimalType(7, 2), "b": lambda TT: TT.DOUBLE})
    assert_same(ref, got)


def test_in_with_decimal_literals():
    """IN over a decimal column scales each literal; one with more
    fractional digits than the scale never matches."""
    check(lambda M, TT: M.In(M.col("a"), (Decimal("99999.99"), Decimal("0"),
                                          Decimal("0.001"), None)),
          seed=11)


# ---------------------------------------------------------------------------
# casts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("to", [(9, 4), (7, 2), (5, 0), (4, 2), (6, 1)])
def test_cast_decimal_to_decimal(to):
    check(lambda M, TT: M.Cast(M.col("a"), TT.DecimalType(*to)),
          pa=7, sa=2, seed=10)


@pytest.mark.parametrize("to", ["INT", "LONG", "DOUBLE", "FLOAT", "BOOLEAN",
                                "SHORT", "BYTE"])
def test_cast_decimal_to_numeric(to):
    check(lambda M, TT: M.Cast(M.col("a"), getattr(TT, to)),
          pa=9, sa=3, seed=11)


@pytest.mark.parametrize("p", [15, 18])
def test_cast_decimal_to_double_is_exact(p):
    """Decimal -> double divides the unscaled value by an exact power of
    ten, correctly rounded, bit for bit with the reference. Below 2^53
    (precision <= 15) the unscaled value is exact in f64, so the result
    is Python's correctly rounded float of the Decimal; at 18 digits the
    int64 -> f64 step rounds first, in both packages."""
    rng = np.random.default_rng(12)
    vals = gen_decimals(rng, 4 * N, p, 9, null_prob=0.0)
    ref, got, _, _ = run_both(
        lambda M, TT: M.Cast(M.col("a"), TT.DOUBLE), {"a": vals},
        {"a": lambda TT: TT.DecimalType(p, 9)})
    assert_same(ref, got)
    if p <= 15:
        assert got.to_host().to_pylist() == [float(v) for v in vals]


@pytest.mark.parametrize("to", [(12, 2), (10, 0), (18, 8)])
def test_cast_int_to_decimal(to):
    rng = np.random.default_rng(12)
    edge = [0, 1, -1, 2**31 - 1, -(2**31), 4242]
    data = {"a": [None if rng.random() < 0.1
                  else edge[int(rng.integers(0, len(edge)))]
                  for _ in range(N)], "b": [0] * N}
    types = {"a": lambda TT: TT.INT, "b": lambda TT: TT.INT}
    ref, got, bound, rows = run_both(
        lambda M, TT: M.Cast(M.col("a"), TT.DecimalType(*to)), data, types)
    assert_same(ref, got)
    assert got.to_host().to_pylist() == eval_expression_rows(bound, rows)


def test_cast_int_to_small_decimal_overflows_null():
    data = {"a": [12345, 12, -99999], "b": [0, 0, 0]}
    ref, got, _, _ = run_both(
        lambda M, TT: M.Cast(M.col("a"), TT.DecimalType(4, 2)), data,
        {"a": lambda TT: TT.INT, "b": lambda TT: TT.INT})
    assert_same(ref, got)
    assert got.to_host().to_pylist() == [None, Decimal("12.00"), None]


def test_float_to_decimal_falls_back():
    ok, why = supports_both(
        lambda M, TT: M.Cast(M.col("a"), TT.DecimalType(9, 2)),
        {"a": lambda TT: TT.DOUBLE, "b": lambda TT: TT.INT})
    assert not ok and "float->decimal" in why


# ---------------------------------------------------------------------------
# types, literals, aggregates
# ---------------------------------------------------------------------------
PAIRS = [((7, 2), (7, 2)), ((9, 4), (6, 1)), ((18, 0), (18, 0)),
         ((18, 2), (3, 0)), ((15, 10), (10, 0)), ((5, 5), (1, 0)),
         ((7, 2), "INT"), ((7, 2), "LONG"), ((7, 2), "DOUBLE"),
         ((7, 2), "SHORT")]


def _typ(TT, t):
    return TT.DecimalType(*t) if isinstance(t, tuple) else getattr(TT, t)


def _outcome(fn):
    try:
        return repr(fn())
    except (TypeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("op", ["promote", "add", "sub", "mul", "div"])
def test_result_types_match_reference(pair, op):
    """T.promote and decimal_binary_result: the same types, or the same
    DECIMAL64 errors word for word."""
    def res(TT):
        a, b = _typ(TT, pair[0]), _typ(TT, pair[1])
        if op == "promote":
            return _outcome(lambda: TT.promote(a, b))
        return _outcome(lambda: TT.decimal_binary_result(op, a, b))
    assert res(T) == res(JT)


@pytest.mark.parametrize("value", ["12.34", "-0.5", "100", "1E+3", "0.000",
                                   "123456789012345678901"])
def test_decimal_literal_types(value):
    got = E.Literal.of(Decimal(value))
    ref = JE.Literal.of(Decimal(value))
    assert repr(got.data_type) == repr(ref.data_type)


def _agg_both(data, types, keys, aggs):
    """The exec layer of both packages over one batch: the port's
    TpuHashAggregateExec against the reference's, and against the port's
    CPU engine. ``aggs(M, AA)`` -> aggregate expressions."""
    from spark_rapids_tpu.conf import RapidsConf as JConf
    from spark_rapids_tpu.exec import InMemoryScanExec as JScan
    from spark_rapids_tpu.exec import TpuHashAggregateExec as JAgg
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.cpu.plan import (CpuHashAggregateExec,
                                                 CpuScanExec)
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuHashAggregateExec)

    js, ps = _schemas(types)
    jb = JBatch.from_pydict(data, js)
    pb = ColumnarBatch.from_pydict(data, ps, device="cpu")
    jrows = [r for b in JAgg(JConf({}), [JE.col(k) for k in keys],
                             aggs(JE, JA), JScan(JConf({}), [[jb]], js)
                             ).execute_columnar() for r in b.to_rows()]
    conf = RapidsConf({})
    prows = TpuHashAggregateExec(conf, [E.col(k) for k in keys],
                                 aggs(E, A),
                                 InMemoryScanExec(conf, [[pb]], ps)).collect()
    rows = list(zip(*[data[k] for k in types]))
    crows = CpuHashAggregateExec(conf, [E.col(k) for k in keys], aggs(E, A),
                                 CpuScanExec(conf, [rows], ps)).collect()
    return prows, jrows, crows


@pytest.mark.parametrize("shape", [(7, 2), (8, 0), (3, 3)])
def test_sum_avg_group_by(shape):
    rng = np.random.default_rng(13)
    data = {"k": [int(v) for v in rng.integers(0, 6, N)],
            "d": gen_decimals(rng, N, *shape)}
    types = {"k": lambda TT: TT.INT, "d": lambda TT: TT.DecimalType(*shape)}
    prows, jrows, crows = _agg_both(
        data, types, ["k"],
        lambda M, AA: [AA.agg(AA.Sum(M.col("d")), "s"),
                       AA.agg(AA.Average(M.col("d")), "m"),
                       AA.agg(AA.Min(M.col("d")), "lo"),
                       AA.agg(AA.Max(M.col("d")), "hi"),
                       AA.agg(AA.Count(M.col("d")), "c")])
    assert prows == jrows
    assert sorted(prows, key=repr) == sorted(crows, key=repr)


def test_sum_overflow_is_null():
    """A decimal(8,0) sum past decimal(18,0) nulls (Spark's
    CheckOverflow), as the reference's does."""
    big = Decimal(10 ** 8 - 1)
    data = {"k": [1] * 64 + [2], "d": [big] * 64 + [big]}
    types = {"k": lambda TT: TT.INT, "d": lambda TT: TT.DecimalType(8, 0)}
    prows, jrows, _ = _agg_both(
        data, types, ["k"], lambda M, AA: [AA.agg(AA.Sum(M.col("d")), "s")])
    assert prows == jrows
    assert sorted(prows) == [(1, big * 64), (2, big)]


def test_sum_beyond_decimal64_falls_back():
    """sum(decimal(p,s)) is decimal(p+10,s): past DECIMAL64 the aggregate
    refuses with the reference's words (an int64 buffer could wrap into a
    wrong non-null answer); p <= 8 stays on the device."""
    with pytest.raises(TypeError, match="DECIMAL64") as e:
        _ = A.Sum(E.BoundReference(0, T.DecimalType(18, 0), True)).dtype
    with pytest.raises(TypeError) as je:
        _ = JA.Sum(JE.BoundReference(0, JT.DecimalType(18, 0), True)).dtype
    assert str(e.value) == str(je.value)
    assert repr(A.Sum(E.BoundReference(0, T.DecimalType(8, 2),
                                       True)).dtype) == "decimal(18,2)"


def test_avg_precision_cap_falls_back():
    with pytest.raises(TypeError) as e:
        _ = A.Average(E.BoundReference(0, T.DecimalType(17, 2), True)).dtype
    with pytest.raises(TypeError) as je:
        _ = JA.Average(JE.BoundReference(0, JT.DecimalType(17, 2),
                                         True)).dtype
    assert str(e.value) == str(je.value)
    assert repr(A.Average(E.BoundReference(
        0, T.DecimalType(14, 2), True)).dtype) == "decimal(18,6)"


def test_merge_binds_the_input_type():
    """A FINAL aggregate binds a decimal sum's and average's function to
    the input type its buffer stands for, so the merge does not widen
    decimal(p+10, s) again (the reference's FINAL does, and raises)."""
    buf = T.DecimalType(17, 2)
    for f in (A.Sum(E.col("d")), A.Average(E.col("d"))):
        assert A.merge_input_type(f, buf) == T.DecimalType(7, 2)
    assert A.merge_input_type(A.Min(E.col("d")), buf) == buf
    assert A.merge_input_type(A.Sum(E.col("d")), T.LONG) == T.LONG


def test_roundtrip_pydict():
    schema = schema_of(a=T.DecimalType(6, 3), b=T.INT)
    vals = [Decimal("1.234"), None, Decimal("-999.999"), Decimal("0.000"),
            "12.5", 7]
    b = ColumnarBatch.from_pydict({"a": vals, "b": list(range(6))}, schema,
                                  device="cpu")
    jb = JBatch.from_pydict({"a": vals, "b": list(range(6))},
                            jschema_of(a=JT.DecimalType(6, 3), b=JT.INT))
    assert b.to_rows() == jb.to_rows()
    assert [r[0] for r in b.to_rows()] == [
        Decimal("1.234"), None, Decimal("-999.999"), Decimal("0"),
        Decimal("12.5"), Decimal(7)]
    assert b.columns[0].data[:6].tolist() == [1234, 0, -999999, 0, 12500,
                                              7000]
