"""K1's pass planner, K2's table replicas, K3's table placement and the
ordered segment sum's serial contract, on the CPU.

``plan_bucket_sum`` decides, for one launch of K1, which columns share a
shared-memory table (one pass per grid row of the launch): every column is
covered once, in order, and every shared table fits what one H100 block
may hold. The ordered segment sum's plain version must be the serial
row-order sum, which a tree-shaped or chunked reduction is not; the card
tests (``tests/test_torch_cuda_kernels.py``) hold the kernel to it.
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.ops import groupby_kernels as K

BUCKETS = (0, 1, 8, 128, 1024, 8192, 16384, 29056, 29057, 32768, 58112,
           58113, 131072)
MIXES = ((1, 4), (1, 0), (0, 1), (16, 0), (0, 16), (3, 13), (8, 8), (2, 3))


@pytest.mark.parametrize("nint,ncnt", MIXES)
@pytest.mark.parametrize("B", BUCKETS)
def test_plan_covers_every_column_once_and_fits(B, nint, ncnt):
    passes = K.plan_bucket_sum(B, nint, ncnt)
    L = nint + ncnt
    assert [p[0] for p in passes] + [L] == [0] + [p[1] for p in passes]
    assert all(lo < hi for lo, hi, _ in passes)
    for lo, hi, shared in passes:
        if shared:
            assert K.table_bytes(B, nint, lo, hi) <= K.BLOCK_SMEM
        else:  # device memory only for columns no shared table can hold
            assert all(K.table_bytes(B, nint, c, c + 1) > K.BLOCK_SMEM
                       for c in range(lo, hi))
    for (lo, hi, sh), (_, hi2, sh2) in zip(passes, passes[1:]):
        # as few passes as contiguous ranges allow: no two neighbours merge
        assert sh != sh2 or (sh and K.table_bytes(B, nint, lo, hi2)
                             > K.BLOCK_SMEM)
    assert len(passes) <= K.MAX_COLS


def test_plan_of_the_main_path_shapes():
    # Q1's direct tier and Q4's B = 8192 hash tier: one sum and four
    # counts, one shared table each (Q4's: 8192 x (8 + 4 x 4) = 192 KB)
    assert K.plan_bucket_sum(128, 1, 4) == [(0, 5, True)]
    assert K.plan_bucket_sum(8192, 1, 4) == [(0, 5, True)]
    assert K.table_bytes(8192, 1, 0, 5) == 196_608
    # one u64 column fits up to 29 056 buckets, one u32 count to 58 112
    assert K.plan_bucket_sum(29056, 1, 0) == [(0, 1, True)]
    assert K.plan_bucket_sum(29057, 1, 1) == [(0, 1, False), (1, 2, True)]
    assert K.plan_bucket_sum(58113, 2, 2) == [(0, 4, False)]


@pytest.mark.parametrize("budget", [1 << 10, 3 << 10, 100_000])
def test_plan_respects_a_smaller_budget(budget):
    for B in (8, 64, 128, 1000):
        for nint, ncnt in MIXES:
            for lo, hi, shared in K.plan_bucket_sum(B, nint, ncnt, budget):
                assert (K.table_bytes(B, nint, lo, hi) <= budget
                        if shared else K.table_bytes(B, nint, lo, lo + 1)
                        > budget)


@pytest.mark.parametrize("B", BUCKETS)
def test_winner_table_fits_or_goes_to_device_memory(B):
    """K3 keeps one u64 per bucket in shared memory exactly while that
    fits one block (29 056 buckets), else accumulates in device memory."""
    shared = K.plan_bucket_winner(B)
    assert shared == (B * 8 <= K.BLOCK_SMEM)
    assert shared == (B <= 29056)


def test_winner_table_of_the_main_path_shapes():
    # Q2's direct tier (B = 128), Q3's hash tier and Q4's B = 8192
    assert all(K.plan_bucket_winner(B) for B in (128, 1024, 8192))
    assert K.plan_bucket_winner(29056) and not K.plan_bucket_winner(29057)
    assert not K.plan_bucket_winner(128, budget=1000)


@pytest.mark.parametrize("F", [1, 2, 5, 16])
@pytest.mark.parametrize("B", BUCKETS)
def test_fsum_replicas_fit_or_go_to_device_memory(B, F):
    """K2 keeps as many table replicas as one block's shared memory holds,
    at most one per warp, and at least one while a table fits; past that,
    global atomics (0)."""
    reps = K.plan_bucket_fsum(B, F)
    table = B * F * 8
    if table > K.BLOCK_SMEM:
        assert reps == 0
        return
    assert 1 <= reps <= K.MAX_FSUM_REPLICAS
    assert reps * table <= K.BLOCK_SMEM
    # as many as fit: one more would leave the budget or the warps
    assert (reps == K.MAX_FSUM_REPLICAS
            or (reps + 1) * table > K.BLOCK_SMEM)


def test_fsum_replicas_of_the_main_path_shapes():
    # Q1's avg(b): one f64 column at B = 128, a 1 KB table per warp
    assert K.plan_bucket_fsum(128, 1) == 32
    # the other kernel-phase tiers: 28 tables of 8 KB, 3 of 64 KB
    assert K.plan_bucket_fsum(1024, 1) == 28
    assert K.plan_bucket_fsum(8192, 1) == 3
    # the largest shared table, and one bucket more
    assert K.plan_bucket_fsum(29056, 1) == 1
    assert K.plan_bucket_fsum(29057, 1) == 0
    assert K.plan_bucket_fsum(1816, 16) == 1
    assert K.plan_bucket_fsum(1817, 16) == 0
    assert K.plan_bucket_fsum(128, 1, budget=1000) == 0
    assert K.plan_bucket_fsum(8, 1, budget=1000) == 15


def _serial(seg, x, nseg):
    out = [0.0] * nseg
    for s, v in zip(seg.tolist(), x.tolist()):
        if 0 <= s < nseg:
            out[s] += v
    return np.array(out)


@pytest.mark.parametrize("nseg", [1, 64, 8192])
def test_ordered_segment_sum_plain_is_the_serial_loop(nseg):
    """[1e16, 1, -1e16, 1, ...] per segment: serially each group of four
    leaves 1.0, pairwise it leaves 2.0."""
    per = 400 if nseg < 8192 else 8
    seg = np.concatenate([[-1, -1, -1], np.repeat(np.arange(nseg), per),
                          [nseg, nseg]]).astype(np.int32)
    x = np.zeros(seg.size)
    x[3:3 + per * nseg] = np.tile([1e16, 1.0, -1e16, 1.0], per * nseg // 4)
    got = K.ordered_segment_sum(torch.from_numpy(x), torch.from_numpy(seg),
                                nseg).numpy()
    exp = _serial(seg, x, nseg)
    np.testing.assert_array_equal(got, exp)
    pairwise = x[3:3 + per * nseg].reshape(nseg, per).sum(1)
    assert not np.array_equal(exp, pairwise)


@pytest.mark.parametrize("special", [np.nan, np.inf, -np.inf])
def test_ordered_segment_sum_plain_keeps_nan_and_inf(special):
    rng = np.random.default_rng(3)
    seg = np.sort(rng.integers(-1, 9, 500)).astype(np.int32)
    x = rng.normal(size=500)
    x[rng.integers(0, 500, 4)] = special
    got = K.ordered_segment_sum(torch.from_numpy(x), torch.from_numpy(seg),
                                8).numpy()
    np.testing.assert_array_equal(got, _serial(seg, x, 8))
