"""The port's window (``ops/window.py``, ``exec/window.py``) against the
reference's, on the CPU.

Every ``window_fn`` branch the reference's own window tests drive
(``tests/test_sort_join_window.py`` ``TestWindow``,
``TestBoundedRangeFrames``, ``TestRangeFrameNullKeyCollision``;
``tests/test_operators.py``'s bounded ROWS frames) runs as the same
session query through both engines: rows must be equal IN ORDER
(integers, nulls and strings exactly; doubles within 1e-12 of the
input column's sum of |x|, the magnitude the running prefix reaches),
and so must ``explain()`` (the tagging lines and the plan analysis,
AUTO strategy reasons cut). The null-key RANGE case
(a key one above int64's minimum, RANGE 5 PRECEDING, a nulls-first null
key) is also held to the port's CPU engine, Spark's answer. The scan
helpers (``_seg_scan``, ``boundaries_from_radix``) are held to the
reference's on random segments.
"""
import math

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr import windows as JW
from spark_rapids_tpu.ops import window as JWO
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.expr import windows as PW
from spark_rapids_tpu_torch.ops import window as WO
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession
from test_torch_plananalysis import comparable_explain

REF = dict(T=JT, E=JE, A=JA, W=JW)
PORT = dict(T=T, E=PE, A=PA, W=PW)
VFA = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}


# ---------------------------------------------------------------------------
# data (the reference tests' own)
# ---------------------------------------------------------------------------
def _left(m, sess, n=120):
    """``test_sort_join_window.left_df``, one partition."""
    T_ = m["T"]
    data = {
        "k": [i % 9 if i % 11 else None for i in range(n)],
        "a": [(i * 7) % 50 - 25 for i in range(n)],
        "s": [None if i % 13 == 0 else f"v{i % 5}" for i in range(n)],
    }
    sch = T_.StructType((T_.StructField("k", T_.INT),
                         T_.StructField("a", T_.LONG),
                         T_.StructField("s", T_.STRING)))
    return sess.create_dataframe(data, sch)


def _ranged(m, sess, n=180):
    """``TestBoundedRangeFrames._df``."""
    T_ = m["T"]
    data = {
        "g": [i % 4 for i in range(n)],
        "o": [None if i % 19 == 0 else (i * 7) % 50 for i in range(n)],
        "v": [None if i % 13 == 0 else i - n // 2 for i in range(n)],
    }
    sch = T_.StructType((T_.StructField("g", T_.INT),
                         T_.StructField("o", T_.INT),
                         T_.StructField("v", T_.LONG)))
    return sess.create_dataframe(data, sch)


def _ops_df(m, sess, n):
    """``test_operators.make_df``, one partition."""
    T_ = m["T"]
    data = {
        "k": [i % 7 if i % 13 else None for i in range(n)],
        "a": [i * 3 - n if i % 11 else None for i in range(n)],
        "b": [i / 7.0 if i % 5 else None for i in range(n)],
    }
    sch = T_.StructType((T_.StructField("k", T_.INT),
                         T_.StructField("a", T_.LONG),
                         T_.StructField("b", T_.DOUBLE)))
    return sess.create_dataframe(data, sch)


def _small(m, sess, data, o_type="INT"):
    T_ = m["T"]
    sch = T_.StructType((T_.StructField("g", T_.INT),
                         T_.StructField("o", getattr(T_, o_type)),
                         T_.StructField("v", T_.INT)))
    return sess.create_dataframe(data, sch)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------
def _spec(m, part="k", order="a", orders=((True, None),), frame=None):
    W, E = m["W"], m["E"]
    kw = {} if frame is None else {"frame": frame}
    return W.WindowSpec((E.col(part),) if part else (),
                        (E.col(order),) if order else (),
                        orders if order else (), **kw)


def _win(m, df, spec, *funcs):
    W = m["W"]
    return df.with_windows(*[W.WindowExpression(f, spec, n)
                             for n, f in funcs])


def q_ranks(m, s):
    W = m["W"]
    df = _left(m, s).select("k", "a")
    return _win(m, df, _spec(m), ("rn", W.RowNumber()), ("rk", W.Rank()),
                ("dr", W.DenseRank()))


def q_lead_lag(m, s):
    W, E = m["W"], m["E"]
    return _win(m, _left(m, s).select("k", "a"), _spec(m),
                ("ld", W.Lead(E.col("a"), 1)), ("lg", W.Lag(E.col("a"), 2)),
                ("ldd", W.Lead(E.col("a"), 3, E.Literal.of(-1))))


def q_running(m, s):
    A, E = m["A"], m["E"]
    a = E.col("a")
    return _win(m, _left(m, s).select("k", "a"), _spec(m),
                ("rs", A.Sum(a)), ("rc", A.Count(a)), ("rmn", A.Min(a)),
                ("rmx", A.Max(a)))


def q_whole_partition(m, s):
    A, E = m["A"], m["E"]
    return _win(m, _left(m, s).select("k", "a"), _spec(m, order=None),
                ("ps", A.Sum(E.col("a"))), ("pc", A.Count()))


def q_avg(m, s):
    A, E = m["A"], m["E"]
    return _win(m, _left(m, s).select("k", "a"), _spec(m),
                ("ra", A.Average(E.col("a"))))


def q_string_payload(m, s):
    """The string column rides through the sort's string gather."""
    W = m["W"]
    return _win(m, _left(m, s), _spec(m, orders=((False, None),)),
                ("rn", W.RowNumber()))


def q_peers(m, s):
    A, E = m["A"], m["E"]
    df = _small(m, s, {"g": [1, 1, 1, 1], "o": [1, 1, 2, 2],
                       "v": [1, 2, 3, 4]})
    return _win(m, df, _spec(m, "g", "o"), ("rs", A.Sum(E.col("v"))))


def _range_q(lo, hi, asc=True, nulls_first=None):
    def q(m, s):
        A, E, W = m["A"], m["E"], m["W"]
        spec = _spec(m, "g", "o", ((asc, nulls_first),),
                     W.WindowFrame(W.RANGE, lo(W) if callable(lo) else lo,
                                   hi(W) if callable(hi) else hi))
        v = E.col("v")
        return _win(m, _ranged(m, s), spec, ("rs", A.Sum(v)),
                    ("rc", A.Count(v)), ("ra", A.Average(v)))
    return q


def q_range_ties(m, s):
    A, E, W = m["A"], m["E"], m["W"]
    df = _small(m, s, {"g": [1] * 6, "o": [1, 1, 3, 3, 8, 9],
                       "v": [1, 2, 4, 8, 16, 32]})
    spec = _spec(m, "g", "o", frame=W.WindowFrame(W.RANGE, -2,
                                                  W.CURRENT_ROW))
    return _win(m, df, spec, ("rs", A.Sum(E.col("v"))))


def q_range_min_falls_back(m, s):
    A, E, W = m["A"], m["E"], m["W"]
    spec = _spec(m, "g", "o", frame=W.WindowFrame(W.RANGE, -5, 5))
    return _win(m, _ranged(m, s), spec, ("mn", A.Min(E.col("v"))))


def q_default_order_by(m, s):
    A, E = m["A"], m["E"]
    return _win(m, _ranged(m, s), _spec(m, None, "o"),
                ("rs", A.Sum(E.col("v"))))


def _null_edge_q(nulls_first):
    def q(m, s):
        A, E, W = m["A"], m["E"], m["W"]
        if nulls_first:
            imin = -(2 ** 63)
            data = {"g": [1, 1, 1, 1], "o": [None, imin + 1, imin + 3, 10],
                    "v": [100, 1, 2, 4]}
            frame = W.WindowFrame(W.RANGE, -5, W.CURRENT_ROW)
        else:
            imax = 2 ** 63 - 1
            data = {"g": [1, 1, 1, 1], "o": [5, imax - 3, imax - 1, None],
                    "v": [8, 2, 1, 100]}
            frame = W.WindowFrame(W.RANGE, W.CURRENT_ROW, 5)
        spec = _spec(m, "g", "o", ((True, nulls_first),), frame)
        return _win(m, _small(m, s, data, "LONG"), spec,
                    ("rs", A.Sum(E.col("v"))))
    return q


def _rows_frame_q(lo, hi, n=200):
    def q(m, s):
        A, E, W = m["A"], m["E"], m["W"]
        spec = _spec(m, orders=((True, True),),
                     frame=W.WindowFrame(W.ROWS, lo(W) if callable(lo)
                                         else lo, hi))
        a = E.col("a")
        return _win(m, _ops_df(m, s, n), spec, ("rs", A.Sum(a)),
                    ("mn", A.Min(a)), ("mx", A.Max(a)), ("cn", A.Count(a)))
    return q


def q_rows_average(m, s):
    A, E, W = m["A"], m["E"], m["W"]
    spec = _spec(m, orders=((True, True),),
                 frame=W.WindowFrame(W.ROWS, -3, 3))
    return _win(m, _ops_df(m, s, 150), spec, ("av", A.Average(E.col("b"))))


def q_rows_current_sentinel(m, s):
    A, E, W = m["A"], m["E"], m["W"]
    spec = _spec(m, orders=((True, True),),
                 frame=W.WindowFrame(W.ROWS, -2, W.CURRENT_ROW))
    return _win(m, _ops_df(m, s, 120), spec, ("rs", A.Sum(E.col("a"))))


def q_double_minmax(m, s):
    """Running min/max of a double with NaN: the NaN-skipping min."""
    A, E, T_ = m["A"], m["E"], m["T"]
    vals = [1.5, math.nan, -2.0, None, math.nan, 0.0, -0.0, 3.0] * 8
    df = s.create_dataframe(
        {"k": [i % 3 for i in range(64)], "o": list(range(64)),
         "d": vals},
        T_.StructType((T_.StructField("k", T_.INT),
                       T_.StructField("o", T_.INT),
                       T_.StructField("d", T_.DOUBLE))))
    d = E.col("d")
    return _win(m, df, _spec(m, "k", "o"), ("mn", A.Min(d)),
                ("mx", A.Max(d)))


CUR, UNB_P, UNB_F = (lambda W: W.CURRENT_ROW,
                     lambda W: W.UNBOUNDED_PRECEDING,
                     lambda W: W.UNBOUNDED_FOLLOWING)
#: case -> (query, settings, float scale): None compares doubles bit for
#: bit; a scale > 0 within 1e-12 of it (the input's sum of |x|); 0 by
#: value, where the reference's running min loses the sign of a zero
#: (ROADMAP.md §C; the port keeps it, as the CPU engine does)
CASES = {
    "row_number_rank_dense_rank": (q_ranks, {}, None),
    "lead_lag": (q_lead_lag, {}, None),
    "running_aggregates": (q_running, {}, None),
    "whole_partition": (q_whole_partition, {}, None),
    "avg_running": (q_avg, {}, 3000),
    "string_payload_desc": (q_string_payload, {}, None),
    "range_peers_share_value": (q_peers, {}, None),
    "range_preceding_current": (_range_q(-10, CUR), {}, 8100),
    "range_preceding_following": (_range_q(-5, 7), {}, 8100),
    "range_unbounded_to_following": (_range_q(UNB_P, 3), {}, 8100),
    "range_current_to_unbounded": (_range_q(CUR, UNB_F), {}, 8100),
    "range_descending": (_range_q(-8, 2, asc=False), {}, 8100),
    "range_nulls_last": (_range_q(-10, CUR, nulls_first=False), {}, 8100),
    "range_ties": (q_range_ties, {}, None),
    "range_min_falls_back": (q_range_min_falls_back, {}, None),
    "default_order_by_no_partition": (q_default_order_by, {}, None),
    "null_key_nulls_first_min_edge": (_null_edge_q(True), {}, None),
    "null_key_nulls_last_max_edge": (_null_edge_q(False), {}, None),
    "rows_-2_0": (_rows_frame_q(-2, 0), {}, None),
    "rows_-1_1": (_rows_frame_q(-1, 1), {}, None),
    "rows_0_2": (_rows_frame_q(0, 2), {}, None),
    "rows_-3_-1": (_rows_frame_q(-3, -1), {}, None),
    "rows_1_3": (_rows_frame_q(1, 3), {}, None),
    "rows_average": (q_rows_average, VFA, 1100),
    "rows_current_row_sentinel": (q_rows_current_sentinel, {}, None),
    "double_min_max_nan": (q_double_minmax, {}, 0),
}


def _same(a, b, scale):
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a):
            return math.isnan(b)
        if scale is None:
            return repr(a) == repr(b)
        return abs(a - b) <= 1e-12 * scale
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_matches_reference(case):
    q, settings, scale = CASES[case]
    jdf = q(REF, JSession(settings))
    ref_rows = jdf.collect()
    sess = PSession(settings, device="cpu")
    df = q(PORT, sess)
    assert comparable_explain(df.explain()) == comparable_explain(
        jdf.explain())
    got = df.collect()
    assert len(got) == len(ref_rows) > 0
    for r, g in zip(ref_rows, got):
        assert len(r) == len(g)
        assert all(_same(a, b, scale) for a, b in zip(r, g)), (r, g)
    on_device = "TpuWindowExec" in sess.last_executed_plan.tree_string()
    assert on_device == (case != "range_min_falls_back")


@pytest.mark.parametrize("nulls_first", [True, False])
def test_null_key_range_frame_is_the_cpu_engines(nulls_first):
    """A saturating RANGE bound at the dtype's edge leaves the null-key
    peer block out of non-null frames (Spark's answer, the CPU engine's
    ``_frame_rows``): 1, not 101."""
    q = _null_edge_q(nulls_first)
    got = q(PORT, PSession({}, device="cpu")).collect()
    cpu = q(PORT, PSession({"spark.rapids.tpu.sql.enabled": False},
                           device="cpu")).collect()
    assert sorted(got, key=repr) == sorted(cpu, key=repr)
    by_o = {r[1]: r[-1] for r in got}
    edge = -(2 ** 63) + 1 if nulls_first else 2 ** 63 - 2
    assert by_o[edge] == 1
    assert by_o[None] == 100


def test_running_min_keeps_the_sign_of_zero_as_the_cpu_engine():
    """min over a frame whose least value is -0.0 gives -0.0, as the CPU
    engine does (the reference's segmented scan gives 0.0 there)."""
    got = q_double_minmax(PORT, PSession({}, device="cpu")).collect()
    cpu = q_double_minmax(PORT, PSession(
        {"spark.rapids.tpu.sql.enabled": False}, device="cpu")).collect()
    key = lambda r: (r[0], r[1])  # noqa: E731
    assert [tuple(map(repr, r)) for r in sorted(got, key=key)] == [
        tuple(map(repr, r)) for r in sorted(cpu, key=key)]
    assert repr({r[1]: r[3] for r in got}[6]) == "-0.0"


CPU_ONLY = {"spark.rapids.tpu.sql.enabled": False}


def _zeros_df(m, sess, d):
    T_ = m["T"]
    n = len(d)
    return sess.create_dataframe(
        {"k": [0] * n, "o": list(range(n)), "d": d},
        T_.StructType((T_.StructField("k", T_.INT),
                       T_.StructField("o", T_.INT),
                       T_.StructField("d", T_.DOUBLE))))


#: frame -> window frame builder (None: the default running RANGE frame)
C3_FRAMES = {
    "running": None,
    "rows_2_preceding_1_following": lambda W: W.WindowFrame(W.ROWS, -2, 1),
    "whole": lambda W: W.WindowFrame(W.ROWS, W.UNBOUNDED_PRECEDING,
                                     W.UNBOUNDED_FOLLOWING),
}


@pytest.mark.parametrize("zeros", [(0.0, -0.0), (-0.0, 0.0)],
                         ids=["pos_first", "neg_first"])
@pytest.mark.parametrize("op", ["Min", "Max"])
@pytest.mark.parametrize("frame", sorted(C3_FRAMES))
def test_min_max_ties_keep_the_earlier_row_as_the_cpu_engine(frame, op,
                                                            zeros):
    """ROADMAP.md §C, C3: on a tie (0.0 against -0.0) window min and max
    keep the value of the earlier row in frame order, as the CPU engine's
    strict compare does: running, bounded ROWS and whole frames."""
    d = [zeros[0], zeros[1], 1.5, zeros[1], -2.0, zeros[0]]
    if op == "Min":
        d = [zeros[0], zeros[1], 3.0, zeros[1], zeros[0], 2.5]

    def q(m, sess):
        W, E, A = m["W"], m["E"], m["A"]
        fb = C3_FRAMES[frame]
        spec = _spec(m, "k", "o", frame=None if fb is None else fb(W))
        return _win(m, _zeros_df(m, sess, d), spec,
                    ("r", getattr(A, op)(E.col("d"))))

    got = q(PORT, PSession({}, device="cpu")).collect()
    cpu = q(PORT, PSession(CPU_ONLY, device="cpu")).collect()
    assert [repr(r[3]) for r in got] == [repr(r[3]) for r in cpu]


def _empty_spec_df(m, sess):
    T_ = m["T"]
    return sess.create_dataframe(
        {"k": [1, 2, None, 4], "x": [5, None, -3, 8]},
        T_.StructType((T_.StructField("k", T_.INT),
                       T_.StructField("x", T_.LONG))))


#: C5: functions over an empty window spec
C5_FUNCS = {
    "count": lambda W, E, A: A.Count(E.col("x")),
    "sum": lambda W, E, A: A.Sum(E.col("x")),
    "min": lambda W, E, A: A.Min(E.col("x")),
    "row_number": lambda W, E, A: W.RowNumber(),
    "rank": lambda W, E, A: W.Rank(),
    "lag": lambda W, E, A: W.Lag(E.col("x"), 1),
    "lead": lambda W, E, A: W.Lead(E.col("x"), 1),
}


def _q_over_empty(m, sess, fn):
    W, E, A = m["W"], m["E"], m["A"]
    return _win(m, _empty_spec_df(m, sess), W.WindowSpec(),
                ("w", C5_FUNCS[fn](W, E, A)))


@pytest.mark.parametrize("fn", sorted(C5_FUNCS))
def test_window_over_an_empty_spec_is_the_cpu_engines(fn):
    """ROADMAP.md §C, C5: ``f() OVER ()`` runs on the device as one
    partition of the live rows in their own order (no sort), and gives
    the CPU engine's rows; the reference's device window raises
    ``IndexError`` on its sort of no keys."""
    sess = PSession({}, device="cpu")
    got = _q_over_empty(PORT, sess, fn).collect()
    assert "TpuWindowExec" in sess.last_executed_plan.tree_string()
    cpu = _q_over_empty(PORT, PSession(CPU_ONLY, device="cpu"),
                        fn).collect()
    assert got == cpu
    with pytest.raises(IndexError):
        _q_over_empty(REF, JSession({}), fn).collect()


# ---------------------------------------------------------------------------
# the scan helpers
# ---------------------------------------------------------------------------
def _segments(rng, cap, live_rows):
    starts = np.sort(rng.choice(np.arange(1, live_rows), 11, replace=False))
    seg = np.zeros(cap, np.int32)
    seg[starts] = 1
    seg = np.cumsum(seg).astype(np.int32)
    seg[live_rows:] = cap
    return seg


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_seg_scan_matches_reference(op, dtype):
    rng = np.random.default_rng(7)
    cap = 300
    seg = _segments(rng, cap, 271)
    x = rng.integers(-1000, 1000, cap).astype(dtype)
    ref = jax.jit(lambda v, g: JWO._seg_scan(
        v, g, jnp.minimum if op == "min" else jnp.maximum))(
            jnp.asarray(x), jnp.asarray(seg))
    got = WO._seg_scan(torch.from_numpy(x), torch.from_numpy(seg),
                       torch.minimum if op == "min" else torch.maximum)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_boundaries_match_reference():
    rng = np.random.default_rng(8)
    cap, n = 256, 200
    part = np.sort(rng.integers(0, 9, cap)).astype(np.int64)
    order = rng.integers(0, 4, cap).astype(np.int64)
    for p in np.unique(part):
        order[part == p] = np.sort(order[part == p])
    live = np.arange(cap) < n
    ref = JWO.boundaries_from_radix((jnp.asarray(part),),
                                    (jnp.asarray(order),), jnp.asarray(live))
    got = WO.boundaries_from_radix((torch.from_numpy(part),),
                                   (torch.from_numpy(order),),
                                   torch.from_numpy(live))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
