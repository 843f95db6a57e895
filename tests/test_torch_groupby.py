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


def test_c4_pallas_min_max_zero_differs_after_the_sort_fallback():
    """ROADMAP.md §C, C4 (open, pinned until item 1 closes it): under
    PALLAS with a NULL row the hash tiers fail their check and both
    packages fall back to the sort path. The reference reduces it on its
    RADIX tier, whose ties give max -0.0 and min 0.0 for the group
    (5, 0.0); the port reduces it as SCATTER does and gives max 0.0 and
    min -0.0, the SCATTER answer of both packages."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.expr import aggregates as JA
    from spark_rapids_tpu.expr import expressions as JE
    from spark_rapids_tpu.sql.session import TpuSession as JSession
    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.expr import aggregates as PA
    from spark_rapids_tpu_torch.expr import expressions as PE
    from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

    def q(TT, EE, AA, sess):
        sch = TT.StructType((TT.StructField("k", TT.INT),
                             TT.StructField("d", TT.DOUBLE)))
        df = sess.create_dataframe(
            {"k": [0, 5, 5, -3], "d": [3.0, 0.0, -0.0, None]}, sch)
        return df.group_by("k", "d").agg(AA.agg(AA.Max(EE.col("d")), "mx"),
                                         AA.agg(AA.Min(EE.col("d")), "mn"))

    def zero_group(rows):
        [r] = [r for r in rows if r[0] == 5]
        return repr(r[2]), repr(r[3])

    def conf(tier):
        return {"spark.rapids.tpu.sql.agg.strategy": tier}

    assert zero_group(q(JT, JE, JA, JSession(conf("PALLAS"))).collect()) \
        == ("-0.0", "0.0")
    assert zero_group(q(JT, JE, JA, JSession(conf("SCATTER"))).collect()) \
        == ("0.0", "-0.0")
    for tier in ("PALLAS", "SCATTER"):
        got = q(PT, PE, PA, PSession(conf(tier), device="cpu")).collect()
        assert zero_group(got) == ("0.0", "-0.0")
