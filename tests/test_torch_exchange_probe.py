"""A seeded run of random partitioned session queries through both
packages, the reference under ``spark.rapids.tpu.shuffle.mode=host``.

Each case draws one query from its seed: a group-by (keys, aggregates
and tier drawn), a sort with an optional limit, a join (type, key and
broadcast or co-partitioned route drawn) or a window, over 2-3
partitions of rows with NULLs, NaN, ±inf, ±0.0, int64 extremes and UTF-8
strings, as ROADMAP.md §C's probe drew them. The rows must equal the
reference's at ``tests/test_torch_exchange.py``'s tolerances, in order
under ORDER BY, with the port's pieces on the device and again through
the host wire format (``shuffle.transport.class=host``): 50 queries, 100
port runs, one reference run each (its compiles take nearly all of the
time). The cases are split over this file and
``test_torch_exchange_probe_b.py`` so that parallel test workers share
them.
"""
import math

import numpy as np
import pytest

from test_torch_exchange import PORT, REF, VFA, check, session

STRS = ["", "a", "ab", "héllo", "zz", "日本語", "Z" * 20]
DBL = [0.0, -0.0, math.nan, math.inf, -math.inf, 1.5, -3.25, 1e300]
LONGS = [0, -1, 2**63 - 1, -2**63, 7]
AGGS = ("sum_x", "count_d", "min_d", "max_d", "max_s", "min_x", "count",
        "avg_x", "sum_d")
#: the cases of this file; ``test_torch_exchange_probe_b.py`` runs as
#: many more
N_CASES = 25


def _table(seed, n, nkeys):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        k = None if rng.random() < 0.06 else int(rng.integers(-3, nkeys))
        r = rng.random()
        x = (None if r < 0.08 else LONGS[int(rng.integers(0, len(LONGS)))]
             if r < 0.15 else int(rng.integers(-10**9, 10**9)))
        r = rng.random()
        d = (None if r < 0.08 else DBL[int(rng.integers(0, len(DBL)))]
             if r < 0.3 else round(float(rng.normal() * 50), 3))
        s = None if rng.random() < 0.08 else STRS[int(rng.integers(
            0, len(STRS)))]
        rows.append((k, x, d, s))
    return rows


LEFT = _table(101, 200, 8)
RIGHT = _table(202, 48, 10)


def _df(m, sess, rows, prefix, parts):
    T_ = m["T"]
    sch = T_.StructType((T_.StructField(prefix + "k", T_.INT),
                         T_.StructField(prefix + "x", T_.LONG),
                         T_.StructField(prefix + "d", T_.DOUBLE),
                         T_.StructField(prefix + "s", T_.STRING)))
    return sess.from_rows(rows, sch, num_partitions=parts)


def _agg(m, name, i):
    E, A = m["E"], m["A"]
    if name == "count":
        return A.agg(A.Count(None), f"a{i}")
    fn, c = name.split("_")
    f = {"sum": A.Sum, "count": A.Count, "min": A.Min, "max": A.Max,
         "avg": A.Average}[fn]
    return A.agg(f(E.col(c)), f"a{i}")


def draw(seed):
    """(kind, query function, settings, ordered, tolerance) of one case."""
    rng = np.random.default_rng(seed)
    kind = ("group", "sort", "join", "window")[int(rng.integers(0, 4))]
    parts = int(rng.integers(2, 4))
    settings = dict(VFA)
    ordered = False
    tol = (1e-12, 0.0)
    if kind == "group":
        keys = [("k",), ("s",), ("s", "k"), ("k", "d")][int(rng.integers(0,
                                                                         4))]
        names = list(rng.choice(AGGS, int(rng.integers(1, 4)), replace=False))
        tier = ("AUTO", "SCATTER", "PALLAS")[int(rng.integers(0, 3))]
        settings["spark.rapids.tpu.sql.agg.strategy"] = tier
        if tier == "PALLAS":
            tol = (1e-4, 1e-6)

        def q(m, sess):
            return _df(m, sess, LEFT, "", parts).group_by(*keys).agg(
                *[_agg(m, nm, i) for i, nm in enumerate(names)])
    elif kind == "sort":
        cols = list(rng.permutation(["k", "x", "d", "s"]))
        asc = [bool(a) for a in rng.random(4) < 0.5]
        nf = [None if r < 0.4 else bool(r < 0.7) for r in rng.random(4)]
        limit = int(rng.integers(1, 60)) if rng.random() < 0.5 else None
        ordered = True

        def q(m, sess):
            df = _df(m, sess, LEFT, "", parts).order_by(
                *cols, ascending=asc, nulls_first=nf)
            return df.limit(limit) if limit else df
    elif kind == "join":
        how = ("inner", "left", "right", "full", "semi", "anti")[
            int(rng.integers(0, 6))]
        on = [[("k", "rk")], [("s", "rs")], [("k", "rk"), ("s", "rs")]][
            int(rng.integers(0, 3))]
        settings["spark.rapids.tpu.sql.autoBroadcastJoinThreshold"] = (
            -1 if rng.random() < 0.5 else 1 << 30)
        settings["spark.rapids.tpu.sql.join.strategy"] = (
            "AUTO", "SEARCH", "RADIX", "PALLAS")[int(rng.integers(0, 4))]
        rparts = int(rng.integers(1, 3))

        def q(m, sess):
            return _df(m, sess, LEFT, "", parts).join(
                _df(m, sess, RIGHT, "r", rparts), on, how)
    else:
        order = ("x", "d")[int(rng.integers(0, 2))]
        fn = ("row_number", "sum", "min", "rank")[int(rng.integers(0, 4))]

        def q(m, sess):
            W, E, A = m["W"], m["E"], m["A"]
            spec = W.WindowSpec((E.col("k"),), (E.col(order), E.col("x")),
                                ((True, None), (True, None)))
            f = {"row_number": W.RowNumber(), "rank": W.Rank(),
                 "sum": A.Sum(E.col("x")), "min": A.Min(E.col("d"))}[fn]
            return _df(m, sess, LEFT, "", parts).select("k", "x", "d") \
                .with_windows(W.WindowExpression(f, spec, "w"))
    return kind, q, settings, ordered, tol


def run_case(seed):
    kind, q, settings, ordered, tol = draw(seed)
    ref = q(REF, session(REF, settings)).collect()
    for transport in ("device", "host"):
        got = q(PORT, session(PORT, {
            **settings, "spark.rapids.tpu.shuffle.transport.class":
            transport})).collect()
        check(ref, got, ordered=ordered, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("seed", range(N_CASES))
def test_random_partitioned_query(seed):
    run_case(seed)
