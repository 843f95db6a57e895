"""The port's session (``sql/session.py``, ``plugin/overrides.py``,
``plugin/typechecks.py``) against the reference's, query for query.

Both sessions run the same DataFrame queries over the same seeded rows
(``from_rows``). The collected rows must be equal: exactly, or within
rtol 1e-4 / atol 1e-6 for float sums of the PALLAS tier under
``variableFloatAgg`` (the tolerance of ``tests/test_radix_agg.py``; the
data has no heavy cancellation, ROADMAP.md §C). The tagging lines of
``explain()`` must be equal too: the tagging lines and the static plan
analysis block, with the reasons of AUTO strategy notes cut
(``test_torch_plananalysis.comparable_explain``). What the reference runs on its device and the port has not
ported raises ``NotImplementedError`` naming the ROADMAP.md item.
"""
import math

import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr import windows as JW
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.cpu import plan as PP
from spark_rapids_tpu_torch.exec import (
    InMemoryScanExec,
    RowToColumnarExec,
    TpuFilterExec,
    TpuHashAggregateExec,
)
from spark_rapids_tpu_torch.exec.transitions import ColumnarToRowExec
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.expr import windows as PW
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession
from test_torch_plananalysis import comparable_explain

REF = dict(T=JT, E=JE, A=JA, W=JW)
PORT = dict(T=T, E=PE, A=PA, W=PW)

VFA = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}


def _rows(n=240, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 9)) if rng.random() > 0.05 else None
        x = int(rng.integers(-10**6, 10**6)) if rng.random() > 0.1 else None
        q = int(rng.integers(1, 101))
        d = round(float(rng.uniform(1, 100)), 2) if rng.random() > 0.1 \
            else None
        s = ["ab", "c", "", "xyz", None][i % 5]
        out.append((k, x, q, d, s))
    return out


def _schema(m):
    T_ = m["T"]
    return T_.StructType((T_.StructField("k", T_.INT),
                          T_.StructField("x", T_.LONG),
                          T_.StructField("q", T_.INT),
                          T_.StructField("d", T_.DOUBLE),
                          T_.StructField("s", T_.STRING)))


def _df(m, sess, parts=1):
    return sess.from_rows(_rows(), _schema(m), num_partitions=parts)


def udf_times_three(v) -> int:
    return None if v is None else v * 3


def _udf(m):
    return m["E"].PythonUDF(udf_times_three, (m["E"].col("x"),))


def _q_filter_agg(m, sess):
    E, A = m["E"], m["A"]
    return (_df(m, sess).where(E.GreaterThanOrEqual(E.col("q"),
                                                    E.Literal.of(40)))
            .group_by("k").agg(A.agg(A.Sum(E.col("x")), "sx"),
                               A.agg(A.Count(E.col("d")), "c"),
                               A.agg(A.Min(E.col("q")), "mn"),
                               A.agg(A.Max(E.col("x")), "mx")))


def _q_float_sum(m, sess):
    """The bench parquet query's shape: a filter, then a float sum and a
    count grouped by an int key."""
    E, A = m["E"], m["A"]
    return (_df(m, sess).where(E.GreaterThanOrEqual(E.col("q"),
                                                    E.Literal.of(20)))
            .group_by("q").agg(A.agg(A.Sum(E.col("d")), "s"),
                               A.agg(A.Count(E.col("k")), "c"),
                               A.agg(A.Average(E.col("d")), "a")))


def _q_project_math(m, sess):
    E = m["E"]
    return _df(m, sess).select(
        E.col("k"),
        E.Alias(E.Pmod(E.col("x"), E.Literal.of(7)), "pm"),
        E.Alias(E.Round(E.col("d"), 1), "r"),
        E.Alias(E.ShiftRightUnsigned(E.col("x"), E.Literal.of(3)), "sh"),
        E.Alias(E.BitwiseAnd(E.col("q"), E.Literal.of(6)), "ba"),
        E.Alias(E.Abs(E.UnaryMinus(E.col("q"))), "aq"),
        E.Alias(E.In(E.col("k"), (1, 3, None)), "isin"),
        E.Alias(E.Length(E.col("s")), "len"))


def _q_udf(m, sess):
    """Q12's shape: a PythonUDF projection between a device scan and a
    device aggregate."""
    E, A = m["E"], m["A"]
    return (_df(m, sess).select(E.col("k"), E.Alias(_udf(m), "u"))
            .group_by("k").agg(A.agg(A.Sum(E.col("u")), "su"),
                               A.agg(A.Count(E.col("u")), "cu")))


def _q_join(m, sess):
    E, A = m["E"], m["A"]
    T_ = m["T"]
    dim = sess.from_rows([(k, k * 10) for k in range(0, 12, 2)],
                         T_.StructType((T_.StructField("dk", T_.INT),
                                        T_.StructField("w", T_.INT))))
    return (_df(m, sess).select("k", "x").join(dim, [("k", "dk")], "left")
            .group_by("w").agg(A.agg(A.Sum(E.col("x")), "sx"),
                               A.agg(A.Count(), "n")))


def _q_grand(m, sess):
    E, A = m["E"], m["A"]
    return _df(m, sess).agg(A.agg(A.Sum(E.col("x")), "sx"),
                            A.agg(A.Average(E.col("q")), "aq"))


def _q_string_minmax_computed(m, sess):
    """A string min over a computed string: the reference falls back
    (no static byte bound)."""
    E, A = m["E"], m["A"]
    return _df(m, sess).group_by("k").agg(
        A.agg(A.Min(E.Concat((E.col("s"), E.col("s")))), "m"))


def _q_cast_string_to_int(m, sess):
    E, T_ = m["E"], m["T"]
    return _df(m, sess).select(E.Alias(E.Cast(E.col("s"), T_.INT), "i"))


def _order_by(m, sess):
    return _df(m, sess).order_by("k")


def _window(m, sess):
    W, E = m["W"], m["E"]
    spec = W.WindowSpec((E.col("k"),), (E.col("x"),), ((True, None),))
    return _df(m, sess).with_windows(
        W.WindowExpression(W.RowNumber(), spec, "rn"))


def _order_by_string(m, sess):
    return _df(m, sess).order_by("s", "k", ascending=[False, True])


def _group_by_string(m, sess):
    E, A = m["E"], m["A"]
    return _df(m, sess).group_by("s").agg(A.agg(A.Count(None), "n"),
                                          A.agg(A.Sum(E.col("x")), "sx"),
                                          A.agg(A.Max(E.col("k")), "mk"))


def _string_min_max(m, sess):
    E, A = m["E"], m["A"]
    return _df(m, sess).group_by("k").agg(A.agg(A.Min(E.col("s")), "mn"),
                                          A.agg(A.Max(E.col("s")), "mx"))


def _join_string_payload(m, sess):
    T_ = m["T"]
    dim = sess.from_rows([("c", "one"), ("ab", "two"), ("", "three"),
                          ("zz", "four")],
                         T_.StructType((T_.StructField("ds", T_.STRING),
                                        T_.StructField("name", T_.STRING))))
    return _df(m, sess).join(dim, [("s", "ds")], "left")


def _window_string_key(m, sess):
    W, E = m["W"], m["E"]
    spec = W.WindowSpec((E.col("s"),), (E.col("x"),), ((True, None),))
    return _df(m, sess).with_windows(
        W.WindowExpression(W.RowNumber(), spec, "rn"))


def _partitioned_agg(m, sess):
    E, A = m["E"], m["A"]
    return _df(m, sess, parts=3).group_by("k").agg(
        A.agg(A.Sum(E.col("x")), "s"))


def _limit(m, sess):
    return _df(m, sess).limit(5)


def _union(m, sess):
    return _df(m, sess).union(_df(m, sess))


def _cross(m, sess):
    return _df(m, sess).cross_join(_df(m, sess))


QUERIES = {
    "filter_agg": (_q_filter_agg, {}),
    "filter_agg_pallas": (_q_filter_agg,
                          {"spark.rapids.tpu.sql.agg.strategy": "PALLAS"}),
    "float_sum_scatter": (_q_float_sum, VFA),
    "float_sum_pallas": (_q_float_sum, {
        **VFA, "spark.rapids.tpu.sql.agg.strategy": "PALLAS"}),
    "float_sum_without_variable_float_agg": (_q_float_sum, {}),
    "project_math": (_q_project_math, {}),
    "python_udf_fallback": (_q_udf, {}),
    "join_left": (_q_join, {}),
    "grand_aggregate": (_q_grand, {}),
    "string_min_of_concat_falls_back": (_q_string_minmax_computed, {}),
    "cast_string_to_int_falls_back": (_q_cast_string_to_int, {}),
    "sql_disabled": (_q_filter_agg, {"spark.rapids.tpu.sql.enabled": False}),
    "order_by": (_order_by, {}),
    "window": (_window, {}),
    "limit": (_limit, {}),
    "union": (_union, {}),
    "order_by_string": (_order_by_string, {}),
    "group_by_string": (_group_by_string, {}),
    "string_min_max": (_string_min_max, {}),
    "join_string_payload": (_join_string_payload, {}),
    "window_string_key": (_window_string_key, {}),
    "udf_compiler": (_q_udf, {"spark.rapids.tpu.sql.udfCompiler.enabled":
                              True}),
    "cross_join": (_cross, {}),
}
#: cases whose row order is the query's result (compared unsorted too)
ORDERED = ("order_by", "window", "limit", "union", "order_by_string",
           "window_string_key")

#: float tolerance per case (exact elsewhere): the PALLAS tier's float
#: sums (hi/lo planes in the reference), and Round, whose reference
#: program divides by 10^scale as a multiplication by its reciprocal (one
#: ulp off HALF_UP; see test_round_is_the_cpu_engines_value)
_FLOAT_RTOL = {"float_sum_pallas": (1e-4, 1e-6), "project_math": (1e-12, 0)}


def _close(a, b, tol):
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a):
            return math.isnan(b)
        if tol is not None:
            return math.isclose(b, a, rel_tol=tol[0], abs_tol=tol[1])
        return a == b
    return type(a) is type(b) and a == b


def _key(row):
    return tuple((v is None, v if v is not None else 0) for v in row)


def _tagging_lines(text):
    return text.split("== Static Plan Analysis ==")[0].rstrip("\n")


def _same_explain(got, want):
    assert comparable_explain(got) == comparable_explain(want)
    block = "== Static Plan Analysis =="
    assert (block in got) == (block in want)


_REF_CACHE = {}


def _ref_result(case):
    if case not in _REF_CACHE:
        q, settings = QUERIES[case]
        sess = JSession(settings)
        df = q(REF, sess)
        _REF_CACHE[case] = (sorted(df.collect(), key=_key), df.explain())
    return _REF_CACHE[case]


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_session_rows_match_reference(case):
    q, settings = QUERIES[case]
    ref_rows, _ = _ref_result(case)
    got = sorted(q(PORT, PSession(settings, device="cpu")).collect(),
                 key=_key)
    assert len(got) == len(ref_rows) > 0
    tol = _FLOAT_RTOL.get(case)
    for r, g in zip(ref_rows, got):
        assert all(_close(a, b, tol) for a, b in zip(r, g)), (r, g)


@pytest.mark.parametrize("case", ORDERED)
def test_ordered_queries_keep_the_reference_order(case):
    """Sort, window, limit and union rows come out in the reference's
    order (floats by ``repr``)."""
    q, settings = QUERIES[case]
    ref = q(REF, JSession(settings)).collect()
    got = q(PORT, PSession(settings, device="cpu")).collect()
    assert [tuple(map(repr, r)) for r in got] == [
        tuple(map(repr, r)) for r in ref]


def test_round_is_the_cpu_engines_value():
    """The projection's device rows equal the CPU engine's (the reference
    interpreter's HALF_UP Round) bit for bit."""
    dev = _q_project_math(PORT, PSession({}, device="cpu")).collect()
    cpu = _q_project_math(PORT, PSession(
        {"spark.rapids.tpu.sql.enabled": False}, device="cpu")).collect()
    assert len(dev) == len(cpu)
    for r, g in zip(cpu, dev):
        assert all(_close(a, b, None) for a, b in zip(r, g)), (r, g)


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_explain_tagging_matches_reference(case):
    q, settings = QUERIES[case]
    _, ref_text = _ref_result(case)
    got = q(PORT, PSession(settings, device="cpu")).explain()
    _same_explain(got, ref_text)


def test_q12_fallback_reason_and_boundaries():
    """The PythonUDF project falls back with the reference's reason (the
    lines chip_smoke.py's Q12 asserts on the card); the executed plan
    puts it between a RowToColumnarExec under the device aggregate and
    the device scan's ColumnarToRowExec."""
    from chip_smoke import Q12_EXPLAIN

    sess = PSession({}, device="cpu")
    df = _q_udf(PORT, sess)
    text = df.explain()
    assert _tagging_lines(text) == Q12_EXPLAIN == _tagging_lines(
        _ref_result("python_udf_fallback")[1])
    _same_explain(text, _ref_result("python_udf_fallback")[1])
    df.collect()
    top = sess.last_executed_plan
    assert isinstance(top, ColumnarToRowExec)
    agg = top.tpu_child
    assert isinstance(agg, TpuHashAggregateExec)
    r2c = agg.children[0]
    assert isinstance(r2c, RowToColumnarExec)
    proj = r2c.cpu_child
    assert isinstance(proj, PP.CpuProjectExec)
    c2r = proj.children[0]
    assert isinstance(c2r, ColumnarToRowExec)
    assert isinstance(c2r.tpu_child, InMemoryScanExec)


def test_float_sum_reason_without_variable_float_agg():
    text = _ref_result("float_sum_without_variable_float_agg")[1]
    assert ("!Exec <HashAggregateExec> cannot run on TPU because Sum: input "
            "floating-point sum/average can differ from CPU results; set "
            "spark.rapids.tpu.sql.variableFloatAgg.enabled=true to enable"
            ) in text
    _same_explain(_q_float_sum(PORT, PSession({}, device="cpu")).explain(),
                  text)


def test_device_plan_has_no_cpu_exec():
    sess = PSession(VFA, device="cpu")
    _q_float_sum(PORT, sess).collect()
    top = sess.last_executed_plan
    agg = top.tpu_child
    assert isinstance(agg, TpuHashAggregateExec)
    assert isinstance(agg.children[0], TpuFilterExec)
    assert isinstance(agg.children[0].children[0], InMemoryScanExec)


def _order_by_partitioned(m, sess):
    return _df(m, sess, parts=3).order_by("k")


def test_session_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSession({})
    PSession({}, device="cpu")


#: the reference's keys of its program plane (ROADMAP.md item 26.2: the
#: AOT program cache, HLO summaries, buffer donation, their tools and
#: fault channels), which the port registers for its kernel-library
#: cache, cost plane and donation, with a value a session takes
ITEM_26_2_KEYS = (
    ("spark.rapids.tpu.aotCache.dir", "aot"),  # under tmp_path
    ("spark.rapids.tpu.aotCache.enabled", False),
    ("spark.rapids.tpu.aotCache.maxBytes", 1 << 20),
    ("spark.rapids.tpu.hlo.topK", 3),
    ("spark.rapids.tpu.sql.donation.enabled", False),
    ("spark.rapids.tpu.sql.donation.retrySnapshot.enabled", False),
    ("spark.rapids.tpu.sql.inMemoryScan.hostResident", True),
    ("spark.rapids.tpu.test.faults.aotcache", "read:nothing"),
    ("spark.rapids.tpu.test.faults.compile", "nothing"),
    ("spark.rapids.tpu.tools.donate.allowlistPath", "allow.txt"),
    ("spark.rapids.tpu.tools.donation.witness.enabled", False),
)
ANALYSIS_KEYS = (
    "spark.rapids.tpu.sql.analysis.enabled",
    "spark.rapids.tpu.sql.analysis.crossCheck.enabled",
)


@pytest.mark.parametrize("key,value", ITEM_26_2_KEYS)
def test_item_26_2_keys_are_registered(key, value, tmp_path):
    """Each key is registered with the reference's default and internal
    flag, and a session takes a value for it."""
    if key.endswith("aotCache.dir"):
        value = str(tmp_path / value)
    from spark_rapids_tpu import conf as JC
    from spark_rapids_tpu import faults as _jf  # noqa: F401 - registers
    from spark_rapids_tpu import hlo as _jh  # noqa: F401 - registers
    from spark_rapids_tpu.serve import program_cache as _jp  # noqa: F401
    from spark_rapids_tpu_torch import conf as PC
    from spark_rapids_tpu_torch import faults

    entry = PC._REGISTRY[key]
    ref = JC._REGISTRY[key]
    assert (entry.default, entry.internal) == (ref.default, ref.internal)
    try:
        sess = PSession({key: value}, device="cpu")
        assert sess.conf.get(entry) == value
    finally:
        faults.uninstall()
        from spark_rapids_tpu_torch.serve import program_cache
        program_cache.uninstall()


@pytest.mark.parametrize("key", ANALYSIS_KEYS)
def test_analysis_keys_are_registered(key):
    """The analyzer's keys are registered (``conf.py``) with the
    reference's defaults, and a session takes both values."""
    from spark_rapids_tpu import conf as JC
    from spark_rapids_tpu_torch import conf as PC

    entry = PC._REGISTRY[key]
    assert entry.default == JC._REGISTRY[key].default
    for v in (True, False):
        assert PSession({key: v}, device="cpu").conf.get(entry) is v
        assert PSession({key: v}, device="cpu").conf._values[key] is v