"""The port's exchanges (``exec/exchange.py``) through its session against
the reference's, over children of 2-3 partitions.

Every query runs through both packages' ``TpuSession`` on the same
seeded rows; the reference runs under ``spark.rapids.tpu.shuffle.mode=
host``: its tests see 8 virtual devices, where ``auto`` would take its
mesh routes, and ``host`` makes both packages run the same exchange. A
few cases also hold the row sets to the reference's default (mesh)
route. Integers, strings, nulls, row counts and group sets must be
equal, and so must the row order under ORDER BY; float sums must agree
within rtol 1e-12 on exact f64 paths (partials regrouped by the
exchange) and within rtol 1e-4 / atol 1e-6 on the PALLAS tier's f32
hi/lo sums under ``variableFloatAgg`` (ROADMAP.md's tolerances).

Also the AQE reads against ``tests/test_aqe.py``'s oracles and specs.
The joins, a two-file parquet directory, the host transport and a
repeated ``collect()`` are in ``test_torch_exchange_join.py``, which
shares this file's helpers.
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
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.expr import windows as PW
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

REF = dict(T=JT, E=JE, A=JA, W=JW, S=JSession)
PORT = dict(T=T, E=PE, A=PA, W=PW, S=PSession)
HOST = {"spark.rapids.tpu.shuffle.mode": "host"}
VFA = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
STRS = ["ab", "", "héllo", "zz", "日本", "a", "ab\x00", "x" * 40]
DBL = [0.0, -0.0, math.nan, math.inf, 1.5, -2.25]


def _rows(n, seed, nkeys=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, nkeys)) if rng.random() > 0.05 else None
        x = int(rng.integers(-10**6, 10**6)) if rng.random() > 0.1 else None
        if rng.random() < 0.1:
            d = None
        elif rng.random() < 0.2:
            d = DBL[int(rng.integers(0, len(DBL)))]
        else:
            d = round(float(rng.uniform(-100, 100)), 2)
        s = STRS[int(rng.integers(0, len(STRS)))] if rng.random() > 0.1 \
            else None
        out.append((k, x, d, s))
    return out


def _schema(m, p=""):
    T_ = m["T"]
    return T_.StructType((T_.StructField(p + "k", T_.INT),
                          T_.StructField(p + "x", T_.LONG),
                          T_.StructField(p + "d", T_.DOUBLE),
                          T_.StructField(p + "s", T_.STRING)))


def session(m, settings):
    if m is REF:
        return JSession({**HOST, **settings})
    return PSession(settings, device="cpu")


def left(m, sess, parts=3, n=240, seed=11):
    return sess.from_rows(_rows(n, seed), _schema(m), num_partitions=parts)


def right(m, sess, parts=2, n=60, seed=12):
    return sess.from_rows(_rows(n, seed, nkeys=12), _schema(m, "r"),
                          num_partitions=parts)


def _key(row):
    return tuple((v is None, repr(v)) for v in row)


def _close(a, b, rtol, atol=0.0):
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= atol + rtol * abs(a)
    return repr(a) == repr(b)


def check(ref, got, ordered=False, rtol=1e-12, atol=0.0):
    assert len(got) == len(ref)
    if not ordered:
        ref, got = sorted(ref, key=_key), sorted(got, key=_key)
    for r, g in zip(ref, got):
        assert len(r) == len(g)
        assert all(_close(a, b, rtol, atol) for a, b in zip(r, g)), (r, g)


def both(q, settings=None, **kw):
    """(reference rows, port rows, port session) of ``q(m, sess)``."""
    settings = settings or {}
    ref = q(REF, session(REF, settings)).collect()
    ps = session(PORT, settings)
    got = q(PORT, ps).collect()
    return ref, got, ps


def plan_text(sess):
    return sess.explain_metrics()


# ---------------------------------------------------------------------------
# aggregates: partial -> exchange -> AQE read -> final
# ---------------------------------------------------------------------------
def q_group(m, sess):
    E, A = m["E"], m["A"]
    return left(m, sess).group_by("k").agg(
        A.agg(A.Sum(E.col("x")), "sx"), A.agg(A.Count(E.col("d")), "cd"),
        A.agg(A.Sum(E.col("d")), "sd"), A.agg(A.Average(E.col("d")), "ad"),
        A.agg(A.Min(E.col("d")), "mn"), A.agg(A.Max(E.col("x")), "mx"),
        A.agg(A.Count(None), "c"))


def q_group_strings(m, sess):
    E, A = m["E"], m["A"]
    return left(m, sess).group_by("s", "k").agg(
        A.agg(A.Sum(E.col("x")), "sx"), A.agg(A.Min(E.col("s")), "ms"),
        A.agg(A.Count(None), "c"))


def q_grand(m, sess):
    E, A = m["E"], m["A"]
    return left(m, sess).agg(A.agg(A.Sum(E.col("x")), "sx"),
                             A.agg(A.Count(None), "c"),
                             A.agg(A.Max(E.col("s")), "ms"),
                             A.agg(A.Min(E.col("x")), "mn"))


@pytest.mark.parametrize("strategy", ["AUTO", "SCATTER", "PALLAS"])
@pytest.mark.parametrize("q", [q_group, q_group_strings, q_grand])
def test_partitioned_aggregate(q, strategy):
    settings = {**VFA, "spark.rapids.tpu.sql.agg.strategy": strategy}
    ref, got, ps = both(q, settings)
    tol = (1e-4, 1e-6) if strategy == "PALLAS" else (1e-12, 0.0)
    check(ref, got, rtol=tol[0], atol=tol[1])
    text = plan_text(ps)
    assert "TpuShuffleExchangeExec" in text
    if q is q_grand:
        assert "SinglePartitioning" in text and "AQE" not in text
    else:
        assert "HashPartitioning" in text and "TpuLazyAQEReadExec" in text
        assert "mode=partial" in text and "mode=final" in text


def test_partitioned_aggregate_shuffle_partitions():
    """``sql.shuffle.partitions`` sets the reduce side's partition count;
    the AQE read coalesces them, and without AQE they stay."""
    for aqe in (True, False):
        settings = {"spark.rapids.tpu.sql.shuffle.partitions": 7,
                    "spark.rapids.tpu.sql.adaptive.enabled": aqe}
        ref, got, ps = both(q_group_strings, settings)
        check(ref, got)
        assert "n=7" in plan_text(ps)
        assert ("AQE" in plan_text(ps)) == aqe


# ---------------------------------------------------------------------------
# sorts: range (or single) exchange -> local sort
# ---------------------------------------------------------------------------
def q_sort_int(m, sess):
    return left(m, sess).order_by("k", "x", ascending=[False, True])


def q_sort_string_limit(m, sess):
    return left(m, sess).order_by("s", "d", "x").limit(25)


def q_sort_double_nulls_last(m, sess):
    return left(m, sess).order_by("d", "x", nulls_first=[False, True])


def q_sort_computed(m, sess):
    E = m["E"]
    return left(m, sess).order_by(E.Add(E.col("x"), E.col("k")), "x",
                                  "d", "s")


@pytest.mark.parametrize("q", [q_sort_int, q_sort_string_limit,
                               q_sort_double_nulls_last, q_sort_computed])
def test_range_exchanged_sort(q):
    ref, got, ps = both(q)
    check(ref, got, ordered=True)
    text = plan_text(ps)
    part = ("SinglePartitioning" if q is q_sort_computed
            else "RangePartitioning")
    assert f"TpuShuffleExchangeExec {part}" in text
    assert "(local)" in text


# ---------------------------------------------------------------------------
# windows over partitions
# ---------------------------------------------------------------------------
def q_window(m, sess):
    W, E, A = m["W"], m["E"], m["A"]
    spec = W.WindowSpec((E.col("k"),), (E.col("x"), E.col("d")),
                        ((True, None), (False, None)))
    df = left(m, sess).select("k", "x", "d")
    return df.with_windows(W.WindowExpression(W.RowNumber(), spec, "rn"),
                           W.WindowExpression(A.Sum(E.col("x")), spec, "sx"),
                           W.WindowExpression(A.Min(E.col("d")), spec, "md"))


def test_window_over_partitions():
    ref, got, ps = both(q_window)
    check(ref, got)
    assert "TpuWindowExec" in plan_text(ps)


# ---------------------------------------------------------------------------
# AQE, mirroring tests/test_aqe.py
# ---------------------------------------------------------------------------
def _skewed(m, n, skew_frac, seed, nkeys=50, skew_key=7):
    import random

    rng = random.Random(seed)
    ks, vs = [], []
    for _ in range(n):
        ks.append(skew_key if rng.random() < skew_frac
                  else rng.randrange(nkeys))
        vs.append(rng.randrange(-100, 100))
    T_ = m["T"]
    schema = T_.StructType((T_.StructField("k", T_.INT),
                            T_.StructField("v", T_.LONG)))
    return ks, vs, schema


def _aqe_conf(m):
    settings = {**HOST,
                "spark.rapids.tpu.sql.adaptive.targetPartitionRows": 64}
    if m is REF:
        from spark_rapids_tpu.conf import RapidsConf
    else:
        from spark_rapids_tpu_torch.conf import RapidsConf
    return RapidsConf(settings)


def _scan(m, conf, data, schema):
    if m is REF:
        from spark_rapids_tpu.columnar import ColumnarBatch
        from spark_rapids_tpu.exec import InMemoryScanExec

        return InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
            data, schema)]], schema)
    from spark_rapids_tpu_torch.columnar import ColumnarBatch
    from spark_rapids_tpu_torch.exec import InMemoryScanExec

    return InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
        data, schema, device="cpu")]], schema, "cpu")


def _modules(m):
    if m is REF:
        from spark_rapids_tpu.exec import exchange as X
        from spark_rapids_tpu.exec.join import TpuShuffledHashJoinExec
        from spark_rapids_tpu.shuffle.partition import HashPartitioning
    else:
        from spark_rapids_tpu_torch.exec import exchange as X
        from spark_rapids_tpu_torch.exec.join import TpuShuffledHashJoinExec
        from spark_rapids_tpu_torch.shuffle.partition import HashPartitioning
    return X, TpuShuffledHashJoinExec, HashPartitioning


def _rows_of(exec_):
    rows = []
    for p in range(exec_.num_partitions):
        for b in exec_.execute_partition(p):
            rows.extend(b.to_rows())
    return rows


def test_aqe_coalesces_small_partitions():
    specs = {}
    for m in (REF, PORT):
        ks, vs, schema = _skewed(m, 300, 0.0, 3)
        conf = _aqe_conf(m)
        X, _, HP = _modules(m)
        ex = X.TpuShuffleExchangeExec(conf, _scan(m, conf, {"k": ks,
                                                            "v": vs},
                                                  schema), HP([0], 16))
        read = X.plan_aqe_coalesce(conf, ex)
        assert read.num_partitions < 16
        assert sorted(_rows_of(read)) == sorted(zip(ks, vs))
        specs[id(m)] = (read.specs, ex.partition_rows)
    assert specs[id(REF)] == specs[id(PORT)]


@pytest.mark.parametrize("jt", ["inner", "left", "semi", "anti", "right"])
def test_aqe_splits_a_skewed_join_probe(jt):
    specs = {}
    for m in (REF, PORT):
        ks, vs, schema = _skewed(m, 1200, 0.7, 11)
        T_ = m["T"]
        dschema = T_.StructType((T_.StructField("dk", T_.INT),
                                 T_.StructField("dv", T_.LONG)))
        dkeys = [i for i in range(50) if i % 2 == 0]
        conf = _aqe_conf(m)
        X, J, HP = _modules(m)
        lex = X.TpuShuffleExchangeExec(
            conf, _scan(m, conf, {"k": ks, "v": vs}, schema), HP([0], 4))
        rex = X.TpuShuffleExchangeExec(
            conf, _scan(m, conf, {"dk": dkeys, "dv": [k * 10 for k in dkeys]},
                        dschema), HP([0], 4))
        lread, rread = X.plan_aqe_join_pair(conf, lex, rex,
                                            probe_left=jt != "right")
        probe = lread if jt != "right" else rread
        assert any(s[0] == "slice" for s in probe.specs) == (jt != "right")
        join = J(conf, lread, rread, [m["E"].col("k")], [m["E"].col("dk")],
                 jt, partitioned=True)
        rows = sorted(_rows_of(join), key=_key)
        specs[id(m)] = (lread.specs, rread.specs, rows)
    assert specs[id(REF)] == specs[id(PORT)]
    dv = {k: k * 10 for k in range(0, 50, 2)}
    rows = specs[id(PORT)][2]
    if jt == "inner":
        assert rows == sorted(((k, v, k, dv[k]) for k, v in zip(ks, vs)
                               if k in dv), key=_key)
    if jt == "anti":
        assert rows == sorted(((k, v) for k, v in zip(ks, vs)
                               if k not in dv), key=_key)


def test_planner_inserts_aqe_for_the_aggregate():
    import random

    rng = random.Random(21)
    rows = [(rng.randrange(20), rng.randrange(1000)) for _ in range(500)]

    def run(aqe):
        ps = PSession({"spark.rapids.tpu.sql.adaptive.enabled": aqe,
                       "spark.rapids.tpu.sql.shuffle.partitions": 8},
                      device="cpu")
        sch = T.StructType((T.StructField("k", T.INT),
                            T.StructField("v", T.LONG)))
        df = ps.from_rows(rows, sch, num_partitions=4)
        out = df.group_by("k").agg(PA.agg(PA.Sum(PE.col("v")), "s"),
                                   PA.agg(PA.Count(None), "c")).collect()
        return ps, sorted(out)

    s1, with_aqe = run(True)
    s2, without = run(False)
    assert with_aqe == without
    assert "AQE" in s1.last_executed_plan.tree_string()
    assert "AQE" not in s2.last_executed_plan.tree_string()
    assert "TpuAQEShuffleReadExec(1 coalesced, 0 skew slices)" in \
        s1.explain_metrics()
