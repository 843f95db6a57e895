"""The port's SORT and MATMUL tiers (``ops/bucket_reduce.py``) and the
forced tiers through the aggregate exec, against the reference's.

``bucket_reduce`` runs over the same seeded inputs in both packages under
SORT and under MATMUL (the reference's ``FORCE_MATMUL`` hook and the
port's both set, as its own differential tests do on the CPU), fused and
with ``FORCE_PER_COLUMN``. Integers and counts must be equal; MATMUL
float sums within rtol 1e-4 / atol 1e-6 (the f32 hi/lo contract), SORT
float sums within rtol 1e-12. The exec matrix of the reference's
``tests/test_radix_agg.py:390-435`` then runs forced RADIX, MATMUL and
SORT through both packages' sessions (``TpuHashAggregateExec``), and
PALLAS over string keys, whose sort path reduces on the RADIX tiles.
"""
import math

import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.ops import bucket_reduce as JB
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.ops import bucket_reduce as PB
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession


@pytest.fixture
def hooks():
    """Set a hook in both packages' bucket_reduce; restored after."""
    saved = {m: (m.FORCE_MATMUL, m.FORCE_PER_COLUMN) for m in (JB, PB)}

    def set_hooks(matmul=False, per_column=False):
        for m in (JB, PB):
            m.FORCE_MATMUL, m.FORCE_PER_COLUMN = matmul, per_column

    try:
        yield set_hooks
    finally:
        for m, (a, b) in saved.items():
            m.FORCE_MATMUL, m.FORCE_PER_COLUMN = a, b


def _inputs(seed, n=1500, B=48, special=False):
    rng = np.random.default_rng(seed)
    seg = rng.integers(-3, B + 4, n).astype(np.int32)  # both tails drop
    ival = rng.integers(-(2 ** 63), 2 ** 63 - 1, n, dtype=np.int64)
    i32 = rng.integers(-(2 ** 31), 2 ** 31 - 1, n).astype(np.int32)
    fval = rng.uniform(-1e6, 1e6, n)
    if special:
        # the detours: past f32 (MATMUL), huge or non-finite (SORT)
        fval[rng.random(n) < 0.01] = 1e300
        fval[rng.random(n) < 0.005] = -np.inf
        fval[rng.random(n) < 0.003] = np.nan
        fval[rng.random(n) < 0.01] = 3e38 * 4
    f32 = rng.normal(size=n).astype(np.float32)
    valid = rng.random(n) < 0.8
    valid2 = rng.random(n) < 0.5
    return (seg, B, [(ival, valid), (i32, valid2)], [valid, valid2],
            [(fval, valid), (f32, valid2)])


def _reduce(pkg, strategy, seg, B, ints, counts, floats):
    if pkg == "jax":
        j = jnp.asarray
        out = JB.bucket_reduce(j(seg), B, [(j(d), j(v)) for d, v in ints],
                               [j(v) for v in counts],
                               [(j(d), j(v)) for d, v in floats],
                               strategy=strategy)
    else:
        t = torch.from_numpy
        out = PB.bucket_reduce(t(seg), B, [(t(d), t(v)) for d, v in ints],
                               [t(v) for v in counts],
                               [(t(d), t(v)) for d, v in floats],
                               strategy=strategy)
    return [[np.asarray(x) for x in fam] for fam in out]


def _assert_reduce_agrees(ref, got, rtol, atol):
    for r, g in zip(ref[0] + ref[1], got[0] + got[1]):
        np.testing.assert_array_equal(g, r)
    for r, g in zip(ref[2], got[2]):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        ok = ~np.isnan(r)
        np.testing.assert_allclose(g[ok], r[ok], rtol=rtol, atol=atol)


TIER_CASES = {
    "sort": ("SORT", False, False),
    "sort_per_column": ("SORT", False, True),
    "matmul": ("MATMUL", True, False),
    "matmul_per_column": ("MATMUL", True, True),
}


@pytest.mark.parametrize("special", [False, True],
                         ids=["plain", "detours"])
@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_bucket_reduce_matches_reference(hooks, case, special):
    strategy, matmul, per_column = TIER_CASES[case]
    hooks(matmul, per_column)
    args = _inputs(len(case) + special, special=special)
    ref = _reduce("jax", strategy, *args)
    got = _reduce("torch", strategy, *args)
    tol = (1e-4, 1e-6) if strategy == "MATMUL" else (1e-12, 0.0)
    _assert_reduce_agrees(ref, got, *tol)


def test_fused_matmul_is_the_per_column_baseline(hooks):
    """The fused limb product against one pass per column, in the port:
    integers bit for bit; float sums within the f32 hi/lo contract (the
    product's summation order follows its width)."""
    args = _inputs(21)
    hooks(matmul=True)
    fused = _reduce("torch", "MATMUL", *args)
    hooks(matmul=True, per_column=True)
    per = _reduce("torch", "MATMUL", *args)
    _assert_reduce_agrees(per, fused, 1e-4, 1e-6)


def test_matmul_blocks_stay_exact_past_one_block(hooks):
    """More rows than one 65 536-row block, all in one bucket, every limb
    at 255: each block's f32 sums stay below 2^24, and the int64 total
    wraps exactly."""
    n = (1 << 16) + 77
    seg = np.zeros(n, np.int32)
    ival = np.full(n, -1, np.int64)  # every limb 0xFF
    valid = np.ones(n, bool)
    hooks(matmul=True)
    got = _reduce("torch", "MATMUL", seg, 4, [(ival, valid)], [valid], [])
    assert got[0][0].tolist() == [-n, 0, 0, 0]
    assert got[1][0].tolist() == [n, 0, 0, 0]


@pytest.mark.parametrize("strategy", ["SORT", "MATMUL"])
def test_bucket_min_max_matches_reference(strategy):
    rng = np.random.default_rng(31)
    n, B = 700, 40
    seg = rng.integers(-2, B + 2, n).astype(np.int32)
    # the columns as the hash tier fills them: min reads NaN as inf
    ints = rng.integers(-(2 ** 62), 2 ** 62, n)
    floats = rng.choice([0.0, -0.0, 1.5, np.nan, -np.inf], n)
    have = np.bincount(seg[(seg >= 0) & (seg < B)], minlength=B) > 0
    for op, data in (("min", ints), ("max", ints),
                     ("min", np.where(np.isnan(floats), np.inf, floats)),
                     ("max", floats)):
        ref = np.asarray(JB.bucket_min_max(
            jnp.asarray(seg), B, op, [jnp.asarray(data)],
            strategy=strategy)[0])[have]
        got = PB.bucket_min_max(torch.from_numpy(seg), B, op,
                                [torch.from_numpy(data)],
                                strategy=strategy)[0].numpy()[have]
        # empty buckets hold each reduction's identity; callers overwrite
        # them by their count. NaN by value, zeros by their sign
        if data.dtype.kind == "f":
            nan = np.isnan(ref)
            np.testing.assert_array_equal(np.isnan(got), nan)
            got, ref = got[~nan], ref[~nan]
        np.testing.assert_array_equal(got.view(np.int64),
                                      ref.view(np.int64))


def test_matmul_refuses_tf32():
    """With TF32 on, a f32 product keeps 10 mantissa bits and the limb
    sums would not be exact: the tier raises, naming the flag, and leaves
    the flag as it is."""
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            PB.check_full_f32(torch.device("cuda"))
        assert torch.backends.cuda.matmul.allow_tf32
        PB.check_full_f32(torch.device("cpu"))  # the CPU has no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        PB.check_full_f32(torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# exec-level: the forced tiers through both packages' aggregate exec
# ---------------------------------------------------------------------------
def _data(n=160):
    return {
        "k": [i % 7 if i % 11 else None for i in range(n)],
        "a": [(i * 13) % 400 - 200 for i in range(n)],
        "b": [None if i % 9 == 0 else (i / 7.0 - 10.0) for i in range(n)],
        "s": [None if i % 13 == 0 else ["x", "yy", "", "zzz"][i % 4]
              for i in range(n)],
    }


def _query(m, sess):
    T_, E, A = m
    schema = T_.StructType((T_.StructField("k", T_.INT),
                            T_.StructField("a", T_.LONG),
                            T_.StructField("b", T_.DOUBLE),
                            T_.StructField("s", T_.STRING)))
    return (sess.create_dataframe(_data(), schema).group_by("k")
            .agg(A.agg(A.Sum(E.col("a")), "sa"),
                 A.agg(A.Sum(E.col("b")), "sb"),
                 A.agg(A.Min(E.col("a")), "mn"),
                 A.agg(A.Max(E.col("b")), "mx"),
                 A.agg(A.Count(E.col("b")), "cb"),
                 A.agg(A.Count(None), "cs"),
                 A.agg(A.First(E.col("a")), "fa"),
                 A.agg(A.Min(E.col("s")), "ms")))


def _string_query(m, sess):
    T_, E, A = m
    schema = T_.StructType((T_.StructField("k", T_.INT),
                            T_.StructField("a", T_.LONG),
                            T_.StructField("b", T_.DOUBLE),
                            T_.StructField("s", T_.STRING)))
    return (sess.create_dataframe(_data(), schema).group_by("s")
            .agg(A.agg(A.Sum(E.col("a")), "sa"),
                 A.agg(A.Sum(E.col("b")), "sb"),
                 A.agg(A.Max(E.col("b")), "mx"),
                 A.agg(A.Last(E.col("k")), "lk"),
                 A.agg(A.Count(None), "cs")))


REF = (JT, JE, JA)
PORT = (T, PE, PA)
EXEC_CASES = {"RADIX": _query, "MATMUL": _query, "SORT": _query,
              "PALLAS_string_keys": _string_query}


def _key(row):
    return tuple((v is None, repr(v)) for v in row)


@pytest.mark.parametrize("case", sorted(EXEC_CASES))
def test_forced_tier_exec_matches_reference(case):
    tier = case.split("_")[0]
    conf = {"spark.rapids.tpu.sql.agg.strategy": tier,
            "spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    q = EXEC_CASES[case]
    ref = sorted(q(REF, JSession(conf)).collect(), key=_key)
    sess = PSession(conf, device="cpu")
    got = sorted(q(PORT, sess).collect(), key=_key)
    assert len(got) == len(ref) > 0
    assert f"strategy={tier}" in sess.last_executed_plan.tree_string()
    rtol, atol = (1e-4, 1e-6) if tier in ("MATMUL", "PALLAS") else (1e-12, 0)
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            if isinstance(a, float) and isinstance(b, float):
                assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                    b, a, rel_tol=rtol, abs_tol=atol), (r, g)
            else:
                assert type(a) is type(b) and a == b, (r, g)
