"""The port's ``groupby_agg`` against the reference's, under forced PALLAS
(the kernel tier: plain versions here, Pallas interpret mode in the
reference) and forced SCATTER.

Covered: the direct-range tier (one and two keys, null keys), the murmur3
hash tier (int64 keys spread over the whole range, double keys), and the
sort fallback (a hash collision, and more than 8192 groups). Group sets,
integer sums, counts and winners must match exactly; float sums within
rtol 1e-4 / atol 1e-6 under PALLAS (the reference's f32 hi/lo kernel
sums) and rtol 1e-12 under SCATTER. Min/max compare as values, so -0.0
equals 0.0 (Spark semantics; the order-word tiers fold it).
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr.eval import ColV as JColV
from spark_rapids_tpu.ops import groupby as JG
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.values import ColV
from spark_rapids_tpu_torch.ops import groupby as G

OPS = ["sum", "sum", "count", "count_star", "min", "max", "min", "max",
       "first", "last", "first_ignorenulls", "last_ignorenulls"]
#: value column per op (index into the value arrays; None for count_star)
VAL_OF = [0, 1, 1, None, 1, 1, 2, 0, 0, 1, 1, 0]
FLOAT_SUMS = {1}


def _values(rng, cap):
    i64 = rng.integers(-(2**62), 2**62, cap, dtype=np.int64)
    i64[: cap // 4] = rng.integers(2**62, 2**63 - 1, cap // 4,
                                   dtype=np.int64)  # sums wrap
    # offset so group sums do not cancel: the reference's f32 hi/lo kernel
    # sums carry an absolute error near 1e-7 of a group's sum of |x|,
    # which a cancelling sum would turn into a large relative error
    f64 = rng.normal(size=cap) * 100 + 400
    f64[rng.integers(0, cap, 6)] = np.nan
    f64[rng.integers(0, cap, 4)] = -0.0
    f64[rng.integers(0, cap, 3)] = np.inf
    i32 = rng.integers(-(2**31), 2**31 - 1, cap).astype(np.int32)
    valids = [rng.random(cap) < p for p in (0.9, 0.8, 0.85)]
    return [(i64, valids[0]), (f64, valids[1]), (i32, valids[2])]


def _run(engine, strategy, keys, key_types, vals, n, approx):
    if engine == "jax":
        kc = [JColV(jnp.asarray(d), jnp.asarray(v)) for d, v in keys]
        vc = [None if i is None else JColV(jnp.asarray(vals[i][0]),
                                           jnp.asarray(vals[i][1]))
              for i in VAL_OF]
        return JG.groupby_agg(kc, [getattr(JT, t) for t in key_types], vc,
                              OPS, n, approx_float_sum=approx,
                              strategy=strategy)
    kc = [ColV(torch.from_numpy(d.copy()), torch.from_numpy(v.copy()))
          for d, v in keys]
    vc = [None if i is None else ColV(torch.from_numpy(vals[i][0].copy()),
                                      torch.from_numpy(vals[i][1].copy()))
          for i in VAL_OF]
    return G.groupby_agg(kc, [getattr(T, t) for t in key_types], vc, OPS, n,
                         approx_float_sum=approx, strategy=strategy)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _key(x):
    x = np.asarray(x)
    return (x.dtype.str, x.view(np.int64 if x.itemsize == 8 else
                                np.int32 if x.itemsize == 4 else
                                np.int8).item()) if x.dtype.kind == "f" \
        else x.item()


def _groups(out):
    keys, aggs, nseg = out
    n = int(_np(nseg))
    kcols = [(_np(k.data)[:n], _np(k.validity)[:n]) for k in keys]
    acols = [(_np(a.data)[:n], _np(a.validity)[:n]) for a in aggs]
    res = {}
    for i in range(n):
        key = tuple(_key(d[i]) if v[i] else None for d, v in kcols)
        assert key not in res, f"group {key} emitted twice"
        res[key] = tuple((d[i], bool(v[i])) for d, v in acols)
    return res


def _assert_agree(strategy, keys, key_types, vals, n, approx=False):
    ref = _groups(_run("jax", strategy, keys, key_types, vals, n, approx))
    got = _groups(_run("torch", strategy, keys, key_types, vals, n, approx))
    assert set(got) == set(ref)
    float_tol = (dict(rtol=1e-4, atol=1e-6)
                 if strategy == "PALLAS" or approx
                 else dict(rtol=1e-12, atol=0.0))
    for k in ref:
        for ai, ((rv, rok), (gv, gok)) in enumerate(zip(ref[k], got[k])):
            assert rok == gok, (k, ai, OPS[ai])
            if not rok:
                continue
            if ai in FLOAT_SUMS:
                np.testing.assert_allclose(gv, rv, **float_tol,
                                           err_msg=str((k, ai)))
            elif isinstance(rv, np.floating) and np.isnan(rv):
                assert np.isnan(gv), (k, ai, OPS[ai], gv)
            else:
                assert gv == rv, (k, ai, OPS[ai], gv, rv)
    return len(ref)


@pytest.mark.parametrize("strategy", ["PALLAS", "SCATTER"])
def test_direct_tier_single_key(strategy):
    rng = np.random.default_rng(1)
    cap, n = 512, 400
    key = rng.integers(-20, 20, cap).astype(np.int32)
    kv = rng.random(cap) < 0.95  # null keys form their own group
    vals = _values(rng, cap)
    assert _assert_agree(strategy, [(key, kv)], ["INT"], vals, n) > 20


@pytest.mark.parametrize("strategy", ["PALLAS", "SCATTER"])
def test_direct_tier_two_keys_approx_float(strategy):
    rng = np.random.default_rng(2)
    cap, n = 512, 500
    k1 = rng.integers(100, 110, cap).astype(np.int64)
    k2 = rng.random(cap) < 0.5
    vals = _values(rng, cap)
    _assert_agree(strategy, [(k1, np.ones(cap, bool)),
                             (k2, rng.random(cap) < 0.9)],
                  ["LONG", "BOOLEAN"], vals, n, approx=True)


@pytest.mark.parametrize("strategy", ["PALLAS", "SCATTER"])
def test_hash_tier_long_keys_across_range(strategy):
    rng = np.random.default_rng(3)
    cap, n = 512, 450
    # 12 keys spread over the whole int64 range: not direct; seed picked
    # so that a hash tier answers (no bucket collision at B=128)
    keyset = np.random.default_rng(29).integers(-(2**63), 2**63 - 1, 12,
                                                dtype=np.int64)
    key = keyset[rng.integers(0, 12, cap)]
    vals = _values(rng, cap)
    assert _assert_agree(strategy, [(key, np.ones(cap, bool))], ["LONG"],
                         vals, n) == 12


@pytest.mark.parametrize("strategy", ["PALLAS", "SCATTER"])
def test_hash_tier_double_keys(strategy):
    rng = np.random.default_rng(4)
    cap, n = 256, 250
    keyset = np.array([1.5, -2.0, 0.0, -0.0, np.nan, np.inf, 3.25])
    key = keyset[rng.integers(0, len(keyset), cap)]
    vals = _values(rng, cap)
    _assert_agree(strategy, [(key, rng.random(cap) < 0.9)], ["DOUBLE"],
                  vals, n)


@pytest.mark.parametrize("strategy", ["PALLAS", "SCATTER"])
def test_sort_fallback_after_collision(strategy):
    rng = np.random.default_rng(5)
    cap, n = 512, 500
    # 150 keys over the int64 range into at most 512 buckets: a
    # collision is certain, so every hash tier declines
    keyset = rng.integers(-(2**63), 2**63 - 1, 150, dtype=np.int64)
    key = keyset[rng.integers(0, 150, cap)]
    vals = _values(rng, cap)
    assert _assert_agree(strategy, [(key, rng.random(cap) < 0.97)],
                         ["LONG"], vals, n) > 100


def test_sort_fallback_more_than_8192_groups():
    rng = np.random.default_rng(6)
    cap, n = 16384, 15000
    key = rng.integers(0, 12000, cap).astype(np.int32) * 7
    vals = _values(rng, cap)
    assert _assert_agree("SCATTER", [(key, np.ones(cap, bool))], ["INT"],
                         vals, n) > 8192


def test_reduce_no_keys_matches_reference():
    rng = np.random.default_rng(8)
    cap, n = 512, 300
    vals = _values(rng, cap)
    jv = [None if i is None else JColV(jnp.asarray(vals[i][0]),
                                       jnp.asarray(vals[i][1]))
          for i in VAL_OF]
    tv = [None if i is None else ColV(torch.from_numpy(vals[i][0].copy()),
                                      torch.from_numpy(vals[i][1].copy()))
          for i in VAL_OF]
    ref = JG.reduce_no_keys(jv, OPS, n)
    got = G.reduce_no_keys(tv, OPS, n)
    for ai, (r, g) in enumerate(zip(ref, got)):
        rv, gv = np.asarray(r.data)[0], g.data.numpy()[0]
        assert bool(np.asarray(r.validity)[0]) == bool(g.validity[0])
        if ai in FLOAT_SUMS or (isinstance(rv, np.floating)
                                and np.isnan(rv)):
            np.testing.assert_allclose(gv, rv, rtol=1e-12)
        else:
            assert gv == rv, (ai, OPS[ai], gv, rv)


def _agg_rows(engine, data, keys, op, strategy):
    """``op``(d) grouped by ``keys`` (or a grand aggregate) through each
    engine's scan and hash-aggregate execs; collected rows."""
    if engine == "jax":
        from spark_rapids_tpu import exec as M
        from spark_rapids_tpu.columnar.batch import ColumnarBatch as B
        from spark_rapids_tpu.columnar.batch import schema_of
        from spark_rapids_tpu.conf import RapidsConf
        from spark_rapids_tpu.expr import aggregates as A_
        from spark_rapids_tpu.expr import expressions as E_
        types = JT
        batch = lambda d, s: B.from_pydict(d, s)  # noqa: E731
    else:
        from spark_rapids_tpu_torch import exec as M
        from spark_rapids_tpu_torch.columnar import ColumnarBatch as B
        from spark_rapids_tpu_torch.columnar import schema_of
        from spark_rapids_tpu_torch.conf import RapidsConf
        from spark_rapids_tpu_torch.expr import aggregates as A_
        from spark_rapids_tpu_torch.expr import expressions as E_
        types = T
        batch = lambda d, s: B.from_pydict(d, s, device="cpu")  # noqa: E731
    conf = RapidsConf({} if strategy == "AUTO" else
                      {"spark.rapids.tpu.sql.agg.strategy": strategy})
    schema = schema_of(k=types.INT, d=types.DOUBLE)
    scan = M.InMemoryScanExec(conf, [[batch(data, schema)]], schema)
    fn = A_.Max if op == "max" else A_.Min
    agg = M.TpuHashAggregateExec(conf, [E_.col("k")] if keys else [],
                                 [A_.agg(fn(E_.col("d")), "m")], scan)
    return sorted(agg.collect())


#: ROADMAP §C's C1 inputs, then ties across rows and tiers: (d, grouped,
#: op); grouped rows all have k = 1
SIGNED_ZERO_CASES = [
    ([-0.0], True, "max"), ([0.0, -0.0], False, "min"),
    ([-0.0, 0.0], False, "max"), ([-0.0, -0.0, 0.0], True, "min"),
    ([0.0, -0.0], True, "max"), ([-0.0, float("nan")], True, "min"),
    ([-0.0, None], False, "max"), ([-0.0], False, "min"),
]


@pytest.mark.parametrize("strategy", ["AUTO", "SCATTER", "PALLAS"])
@pytest.mark.parametrize("d,grouped,op", SIGNED_ZERO_CASES)
def test_min_max_keep_the_sign_of_zero_as_the_reference(d, grouped, op,
                                                        strategy):
    """The port's float min/max against the reference's on signed zeros:
    value and sign (``np.signbit``) per group. SCATTER (AUTO's choice on
    the CPU) and the grand aggregate keep -0.0 below 0.0 as the
    reference's raw-value reductions do; the PALLAS tier folds -0.0 into
    0.0 in both engines."""
    data = {"k": [1] * len(d), "d": d}
    ref = _agg_rows("jax", data, grouped, op, strategy)
    got = _agg_rows("torch", data, grouped, op, strategy)
    assert len(got) == len(ref) == 1
    rv, gv = ref[0][-1], got[0][-1]
    assert (rv is None) == (gv is None)
    if rv is not None:
        assert gv == rv or (np.isnan(gv) and np.isnan(rv))
        assert np.signbit(gv) == np.signbit(rv), (rv, gv)


def _c4_rows(kind, data, keys, tier, aggs=("max", "min")):
    """(rows by repr) of a PALLAS/SCATTER group-by with max(d)/min(d)
    through ``kind``'s session, over (k int, g string, d double) rows."""
    if kind == "jax":
        from spark_rapids_tpu import types as TT
        from spark_rapids_tpu.expr import aggregates as AA
        from spark_rapids_tpu.expr import expressions as EE
        from spark_rapids_tpu.sql.session import TpuSession as S

        sess = S({"spark.rapids.tpu.sql.agg.strategy": tier})
    else:
        from spark_rapids_tpu_torch import types as TT
        from spark_rapids_tpu_torch.expr import aggregates as AA
        from spark_rapids_tpu_torch.expr import expressions as EE
        from spark_rapids_tpu_torch.sql.session import TpuSession as S

        sess = S({"spark.rapids.tpu.sql.agg.strategy": tier}, device="cpu")
    sch = TT.StructType((TT.StructField("k", TT.INT),
                         TT.StructField("g", TT.STRING),
                         TT.StructField("d", TT.DOUBLE)))
    fns = {"max": AA.Max, "min": AA.Min}
    df = sess.create_dataframe(data, sch).group_by(*keys).agg(
        *[AA.agg(fns[a](EE.col("d")), a) for a in aggs])
    return sorted(tuple(map(repr, r)) for r in df.collect())


def test_c4_pallas_min_max_zero_differs_after_the_sort_fallback():
    """ROADMAP.md §C, C4 (closed; the name is the fault's): under PALLAS
    with a NULL row the hash tiers fail their check and both packages
    fall back to the sort path, which the reference reduces on its RADIX
    tiles: max -0.0 and min 0.0 for the group (5, 0.0). The port now
    gives the same (``ops/groupby._radix_groupby``, the RADIX segment
    reduction), with and without the
    NULL row; SCATTER keeps the signed zero in both packages (C1)."""
    def data(with_null):
        return {"k": [0, 5, 5] + ([-3] if with_null else []),
                "g": ["x"] * (4 if with_null else 3),
                "d": [3.0, 0.0, -0.0] + ([None] if with_null else [])}

    for with_null in (True, False):
        for tier in ("PALLAS", "SCATTER"):
            ref = _c4_rows("jax", data(with_null), ("k", "d"), tier)
            got = _c4_rows("torch", data(with_null), ("k", "d"), tier)
            assert got == ref, (with_null, tier)
    zero = [r for r in _c4_rows("torch", data(True), ("k", "d"), "PALLAS")
            if r[0] == "5"]
    assert zero == [("5", "0.0", "-0.0", "0.0")]
    zero = [r for r in _c4_rows("torch", data(True), ("k", "d"), "SCATTER")
            if r[0] == "5"]
    assert zero == [("5", "0.0", "0.0", "-0.0")]


#: string-keyed groups (the sort path under PALLAS): (d values of group
#: "a", forced tile rows or 0 for the reference's own)
C4_CASES = {
    "nan_beside_zeros": ([0.0, -0.0, float("nan"), -0.0, 0.0], 0),
    "zeros_then_negative_zero": ([-0.0, 0.0, -0.0], 0),
    # tile 0's last tie (row 6, 0.0) is neither the first tie (row 5)
    # nor the last (row 12), both -0.0
    "max_ties_across_tiles": (
        [-1.0] * 5 + [-0.0, 0.0] + [-1.0] * 4 + [0.0, -0.0], 8),
    "min_ties_across_tiles": (
        [1.0] * 6 + [0.0] * 1 + [1.0] * 5 + [-0.0, 0.0], 8),
    "nulls_and_ties_across_tiles": (
        [None] * 7 + [-0.0] + [None] * 7 + [0.0, -0.0], 8),
}


@pytest.mark.parametrize("case", sorted(C4_CASES))
def test_c4_pallas_sort_fallback_min_max_are_the_references(case):
    """C4's tie rule beyond its first input: NaN beside ±0.0, and tied
    zeros in different tiles of the reference's tiled reduction (its
    ``radix_bin.FORCE_TILE_ROWS`` hook and the port's copy both set to
    8), where max keeps the last tie of the first tile that holds one.
    A second group "b" follows in sorted order."""
    from spark_rapids_tpu.exec import base as JB
    from spark_rapids_tpu.ops import radix_bin as JR
    from spark_rapids_tpu_torch.ops import radix_bin as PR

    d, tile = C4_CASES[case]
    n = len(d)
    data = {"k": [1] * (n + 2), "g": ["a"] * n + ["b", "b"],
            "d": d + [2.0, -0.0]}
    JB.clear_pipeline_caches()
    JR.FORCE_TILE_ROWS, PR.FORCE_TILE_ROWS = tile, tile
    try:
        for aggs in (("max",), ("min",), ("max", "min")):
            ref = _c4_rows("jax", data, ("g",), "PALLAS", aggs)
            got = _c4_rows("torch", data, ("g",), "PALLAS", aggs)
            assert got == ref, aggs
    finally:
        JR.FORCE_TILE_ROWS, PR.FORCE_TILE_ROWS = 0, 0
        JB.clear_pipeline_caches()


def test_c4_max_tie_across_the_references_own_tiles():
    """One max over 40 000 rows of one string group: the reference's tile
    is 2^15 rows there (three streams over a 2^16 capacity). The tied
    zeros at rows 30 000 and 32 767 lie in the first tile, the 0.0 at row
    33 000 in the second: the answer is row 32 767's -0.0."""
    d = [-1.0] * 40000
    d[30000], d[32767], d[33000] = -0.0, -0.0, 0.0
    data = {"k": [1] * 40000, "g": ["a"] * 40000, "d": d}
    ref = _c4_rows("jax", data, ("g",), "PALLAS", ("max",))
    got = _c4_rows("torch", data, ("g",), "PALLAS", ("max",))
    assert got == ref == [("'a'", "-0.0")]
