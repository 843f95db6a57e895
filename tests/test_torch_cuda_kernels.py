"""The CUDA kernels against their plain versions on the edge cases the
reference pins, on a card.

Needs a CUDA card and ``nvcc``; without them every test here skips. The
plain versions (CPU) are held against the reference's Pallas kernels in
``tests/test_torch_groupby_kernels.py`` and ``test_torch_join_kernels.py``,
so agreeing with them here holds the kernels to the reference. The join
exec runs here on the card and on the CPU under every strategy and must
give the same rows in the same order; so do the string expressions and
the word-count query (K5, whose plain version is held against the
reference's kernel in ``tests/test_torch_udf.py``), and the regex row
matcher (whose plain version ``tests/test_torch_regex.py`` holds to the
reference's scan). Run on a card, without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.ops import groupby_kernels as K
from spark_rapids_tpu_torch.ops.radix_kernels import TILE_ROWS as _RT

pytestmark = pytest.mark.cuda

BUCKETS = (8, 128, 300, 1024, 8192)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _seg(rng, n, B):
    seg = rng.integers(0, max(2, B // 2), n).astype(np.int32)
    r = rng.random(n)
    seg[r < 0.05] = -rng.integers(1, 4, int((r < 0.05).sum()))
    seg[(r >= 0.05) & (r < 0.1)] = B
    seg[(r >= 0.1) & (r < 0.12)] = B + 7
    return seg


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.parametrize("B", BUCKETS)
def test_bucket_sum_wraps_and_drops_like_plain(dev, B):
    rng = np.random.default_rng(B)
    n = 50_000
    seg = _seg(rng, n, B)
    big = rng.integers(2**62, 2**63 - 1, n, dtype=np.int64)
    neg = rng.integers(-(2**63), -(2**62), n, dtype=np.int64)
    small = rng.integers(-1000, 1000, n).astype(np.int32)
    v1, v2 = rng.random(n) < 0.8, rng.random(n) < 0.5
    ints = [(big, v1), (neg, v2), (small, v1)]
    # 17 count columns: more than one launch's 16
    counts = [rng.random(n) < p for p in np.linspace(0.1, 0.9, 17)]
    exp_i, exp_c = K.bucket_sum_plain(
        torch.from_numpy(seg), B,
        [(torch.from_numpy(d), torch.from_numpy(v)) for d, v in ints],
        [torch.from_numpy(c) for c in counts])
    before = K.LAUNCHES["bucket_sum"]
    got_i, got_c = K.bucket_sum(
        _on(dev, seg)[0], B, [tuple(_on(dev, d, v)) for d, v in ints],
        _on(dev, *counts))
    assert K.LAUNCHES["bucket_sum"] - before == 2
    for g, e in zip(got_i + got_c, exp_i + exp_c):
        assert torch.equal(g.cpu(), e)


@pytest.mark.parametrize("B", BUCKETS)
def test_bucket_float_sum_confines_nan_and_inf(dev, B):
    rng = np.random.default_rng(100 + B)
    n = 50_000
    seg = _seg(rng, n, B)
    x = rng.normal(size=n) * 1e3
    special = rng.integers(0, n, 12)
    x[special[:3]] = np.nan
    x[special[3:6]] = np.inf
    x[special[6:8]] = -np.inf
    x[special[8:]] = 1e300
    valid = rng.random(n) < 0.9
    exp = K.bucket_float_sum_plain(torch.from_numpy(seg), B,
                                   [(torch.from_numpy(x),
                                     torch.from_numpy(valid))])[0]
    absx = K.bucket_float_sum_plain(torch.from_numpy(seg), B,
                                    [(torch.from_numpy(np.abs(x)),
                                      torch.from_numpy(valid))])[0]
    s, xs, vs = _on(dev, seg, x, valid)
    got = K.bucket_float_sum(s, B, [(xs, vs)])[0].cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(exp))
    fin = torch.isfinite(exp)
    assert torch.equal(got[~fin & ~torch.isnan(exp)],
                       exp[~fin & ~torch.isnan(exp)])
    assert bool(((got[fin] - exp[fin]).abs()
                 <= 1e-9 * absx[fin] + 1e-300).all())


def _k2_check(dev, seg, B, cols, views=slice(None)):
    """K2 on the card against its plain version: within 1e-9 of each
    bucket's sum of |x| (the atomics' order), NaN and +-inf where it has
    them; one launch per 16 columns."""
    sv = torch.from_numpy(seg[views])
    hc = [(torch.from_numpy(d[views]), torch.from_numpy(v[views]))
          for d, v in cols]
    exp = K.bucket_float_sum_plain(sv, B, hc)
    absx = K.bucket_float_sum_plain(sv, B, [(d.abs(), v) for d, v in hc])
    before = K.LAUNCHES["bucket_float_sum"]
    got = K.bucket_float_sum(_on(dev, seg)[0][views], B,
                             [tuple(t[views] for t in _on(dev, d, v))
                              for d, v in cols])
    assert K.LAUNCHES["bucket_float_sum"] - before == -(-len(cols)
                                                        // K.MAX_COLS)
    for g, e, ax in zip(got, exp, absx):
        g = g.cpu()
        assert torch.equal(torch.isnan(g), torch.isnan(e))
        fin = torch.isfinite(e)
        inf = ~fin & ~torch.isnan(e)
        assert torch.equal(g[inf], e[inf])
        assert bool(((g[fin] - e[fin]).abs()
                     <= 1e-9 * ax[fin] + 1e-300).all())


def _k2_cols(rng, n, F):
    cols = []
    for i in range(F):
        x = rng.normal(size=n) * 10.0 ** (i % 4)
        x[rng.integers(0, n, 2)] = np.inf if i % 2 else np.nan
        cols.append((x, rng.random(n) < 0.9))
    return cols


#: K2's table sizes: one replica of the largest table a block holds
#: ("max") and one bucket more, which goes to global atomics ("max+1")
K2_BUCKETS = (1, 64, 128, 1024, 8192, "max", "max+1")


@pytest.mark.parametrize("F", [1, 2, 5, 16])
@pytest.mark.parametrize("B", K2_BUCKETS)
def test_bucket_float_sum_every_table_placement(dev, B, F):
    """Every replica count plan_bucket_fsum picks, the largest shared
    table and the global branch past it, over 40 003 rows (not a
    multiple of 4)."""
    if isinstance(B, str):
        B = K.BLOCK_SMEM // (8 * F) + (B == "max+1")
    assert (K.plan_bucket_fsum(B, F) > 0) == (B * F * 8 <= K.BLOCK_SMEM)
    rng = np.random.default_rng(B + 7 * F)
    n = 40_003
    _k2_check(dev, _seg(rng, n, B), B, _k2_cols(rng, n, F))


@pytest.mark.parametrize("F", [1, 5, 17])
@pytest.mark.parametrize("B", [1, 128, 8192])
def test_bucket_float_sum_every_row_in_one_bucket(dev, B, F):
    """Maximum contention: every live row of every warp in one bucket."""
    rng = np.random.default_rng(B + F)
    n = 100_001
    seg = np.full(n, B - 1, np.int32)
    seg[rng.random(n) < 0.01] = B  # a few dead rows
    _k2_check(dev, seg, B, _k2_cols(rng, n, F))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 4097, 65_539])
def test_bucket_float_sum_ragged_and_unaligned_rows(dev, n):
    """Columns one row into their storage (not 16-byte aligned: the
    one-row path) and row counts off the four-row step."""
    rng = np.random.default_rng(n)
    seg = _seg(rng, n + 1, 128)
    cols = _k2_cols(rng, n + 1, 2)
    _k2_check(dev, seg, 128, cols, views=slice(1, None))
    _k2_check(dev, seg, 128, cols, views=slice(None, n))


def test_bucket_float_sum_refused_shared_memory_raises(dev, monkeypatch):
    """Replicas past what a block may hold, forced by the planner,
    surface the card's refusal as an error."""
    monkeypatch.setattr(K, "plan_bucket_fsum", lambda B, F: 32)
    seg = torch.zeros(64, dtype=torch.int32, device=dev)
    x = torch.ones(64, dtype=torch.float64, device=dev)
    v = torch.ones(64, dtype=torch.bool, device=dev)
    with pytest.raises(RuntimeError, match="bucket_float_sum kernel launch"):
        K.bucket_float_sum(seg, 8192, [(x, v)])


@pytest.mark.parametrize("B", BUCKETS)
@pytest.mark.parametrize("op", ["min", "max"])
def test_bucket_winner_matches_plain(dev, B, op):
    rng = np.random.default_rng(7 * B + (op == "max"))
    n = 50_000
    seg = _seg(rng, n, B)
    w = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    w[rng.random(n) < 0.3] &= 0xFFFFFFFF
    w[rng.random(n) < 0.1] = K.IDENT_MIN if op == "min" else K.IDENT_MAX
    exp = K.bucket_winner_plain(torch.from_numpy(seg), B, op,
                                torch.from_numpy(w))
    got = K.bucket_winner(*_on(dev, seg), B, op, *_on(dev, w)).cpu()
    assert torch.equal(got, exp)


def _k3_check(dev, seg, B, op, w, seg_offset=0, word_offset=0):
    """K3 on the card (on views that start ``*_offset`` elements into
    their storage) against its plain version, bit for bit."""
    exp = K.bucket_winner_plain(torch.from_numpy(seg), B, op,
                                torch.from_numpy(w))
    sd = _on(dev, np.concatenate([np.zeros(seg_offset, np.int32), seg]))[0]
    wd = _on(dev, np.concatenate([np.zeros(word_offset, np.int64), w]))[0]
    before = K.LAUNCHES["bucket_winner"]
    got = K.bucket_winner(sd[seg_offset:], B, op, wd[word_offset:])
    assert K.LAUNCHES["bucket_winner"] - before == 1
    assert torch.equal(got.cpu(), exp)
    return got


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("B", [1, 128, 8192, 29056, 29057, 32768])
def test_bucket_winner_shared_and_device_tables(dev, B, op):
    """Every table size up to the 227 KB a block may hold (29 056 words)
    and past it (global atomics), every bucket hit."""
    rng = np.random.default_rng(B + (op == "max"))
    n = 200_003
    seg = rng.integers(0, B, n).astype(np.int32)
    seg[rng.random(n) < 0.05] = B
    seg[rng.random(n) < 0.01] = -1
    w = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    w[rng.random(n) < 0.05] = K.IDENT_MIN if op == "min" else K.IDENT_MAX
    _k3_check(dev, seg, B, op, w)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 4097])
def test_bucket_winner_ragged_rows(dev, n, op):
    rng = np.random.default_rng(n)
    seg = rng.integers(-1, 9, n).astype(np.int32)
    w = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    _k3_check(dev, seg, 8, op, w)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("case", ["identity", "one_bucket", "descending",
                                  "top_bit", "misaligned"])
def test_bucket_winner_edge_inputs(dev, case, op):
    """Every row on the identity; every row in one bucket; words in
    descending order for min and ascending for max (every row improves
    its bucket's winner); only top-bit words; and seg and word views that
    start one element off a 16-byte boundary."""
    rng = np.random.default_rng(5)
    n, B = 100_001, 128
    seg = rng.integers(0, B, n).astype(np.int32)
    w = rng.integers(0, 2**62, n, dtype=np.int64)
    ident = K.IDENT_MIN if op == "min" else K.IDENT_MAX
    offsets = (0, 0)
    if case == "identity":
        w[:] = ident
    elif case == "one_bucket":
        seg[:] = B - 1
    elif case == "descending":
        w = np.arange(n, dtype=np.int64)
        w = w[::-1].copy() if op == "min" else w
        seg[:] = np.arange(n) % 3
    elif case == "top_bit":
        w |= np.int64(-(2**63))
    else:
        offsets = (1, 1)
    got = _k3_check(dev, seg, B, op, w, *offsets)
    if case == "identity":
        assert bool((got == ident).all())


@pytest.mark.parametrize("B", (1, 37, 8192))
def test_ordered_segment_sum_is_serial(dev, B):
    rng = np.random.default_rng(B)
    n = 30_000
    seg = np.sort(rng.integers(-2, B + 2, n)).astype(np.int32)
    x = rng.normal(size=n) * 10.0 ** rng.integers(-8, 8, n)
    keep = (seg >= 0) & (seg < B)
    exp = np.bincount(seg[keep], weights=x[keep], minlength=B)
    got = K.ordered_segment_sum(*_on(dev, x, seg), B).cpu().numpy()
    np.testing.assert_array_equal(got, exp)


# ---------------------------------------------------------------------------
# K1's table layouts and the ordered sum's edge cases
# ---------------------------------------------------------------------------
#: B = 32768: one int column's u64 table (256 KB) exceeds what a block may
#: hold, so that column's pass accumulates in device memory
K1_BUCKETS = (8, 128, 8192, 16384, 32768)


def _k1_inputs(rng, n, nint, ncnt):
    ints = [(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
             rng.random(n) < 0.7) for _ in range(nint)]
    return ints, [rng.random(n) < 0.6 for _ in range(ncnt)]


def _k1_check(dev, seg, B, ints, counts, views=slice(None)):
    exp_i, exp_c = K.bucket_sum_plain(
        torch.from_numpy(seg[views]), B,
        [(torch.from_numpy(d[views]), torch.from_numpy(v[views]))
         for d, v in ints], [torch.from_numpy(c[views]) for c in counts])
    before = K.LAUNCHES["bucket_sum"]
    got_i, got_c = K.bucket_sum(
        _on(dev, seg)[0][views], B,
        [tuple(t[views] for t in _on(dev, d, v)) for d, v in ints],
        [t[views] for t in _on(dev, *counts)])
    ncols = len(ints) + len(counts)
    assert K.LAUNCHES["bucket_sum"] - before == -(-ncols // K.MAX_COLS)
    for g, e in zip(got_i + got_c, exp_i + exp_c):
        assert torch.equal(g.cpu(), e)


@pytest.mark.parametrize("mix", ["ints", "counts", "mixed"])
@pytest.mark.parametrize("ncols", [1, 5, 6, 16, 17])
@pytest.mark.parametrize("B", K1_BUCKETS)
def test_bucket_sum_every_pass_layout_matches_plain(dev, B, ncols, mix):
    """Every pass split plan_bucket_sum picks (one shared pass, several,
    a device-memory pass) over 40 003 rows: not a multiple of 4."""
    rng = np.random.default_rng(B + 31 * ncols + len(mix))
    n = 40_003
    nint = {"ints": ncols, "counts": 0, "mixed": (ncols + 1) // 2}[mix]
    ints, counts = _k1_inputs(rng, n, nint, ncols - nint)
    _k1_check(dev, _seg(rng, n, B), B, ints, counts)


@pytest.mark.parametrize("B", [8, 8192, 32768])
def test_bucket_sum_every_row_in_one_bucket(dev, B):
    """Maximum contention: every live row of every warp in one bucket."""
    rng = np.random.default_rng(B)
    n = 100_001
    seg = np.full(n, B - 1, np.int32)
    seg[rng.random(n) < 0.01] = B  # a few dead rows
    ints, counts = _k1_inputs(rng, n, 2, 4)
    _k1_check(dev, seg, B, ints, counts)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 4097, 65_539])
def test_bucket_sum_ragged_and_unaligned_rows(dev, n):
    """Columns one row into their storage (not 16-byte aligned: the
    scalar loads) and row counts off the four-row step."""
    rng = np.random.default_rng(n)
    seg = _seg(rng, n + 1, 128)
    ints, counts = _k1_inputs(rng, n + 1, 1, 4)
    _k1_check(dev, seg, 128, ints, counts, views=slice(1, None))
    _k1_check(dev, seg, 128, ints, counts, views=slice(None, n))


def _segments(lengths, lead=3):
    """Sorted seg ids with the given segment lengths, after ``lead`` dead
    rows (-1) so segments start off the 16-byte pair grid, and two dead
    rows past the last segment."""
    nseg = len(lengths)
    return np.concatenate([np.full(lead, -1), np.repeat(np.arange(nseg),
                                                         lengths),
                           np.full(2, nseg)]).astype(np.int32)


def _oss_check(dev, seg, x, nseg, views=slice(None)):
    seg, x = seg[views], x[views]
    keep = (seg >= 0) & (seg < nseg)
    exp = np.bincount(seg[keep], weights=x[keep], minlength=nseg)
    plain = K.ordered_segment_sum_plain(torch.from_numpy(x),
                                        torch.from_numpy(seg), nseg).numpy()
    sd, xd = _on(dev, seg, x)
    before = K.LAUNCHES["ordered_segment_sum"]
    got = K.ordered_segment_sum(xd, sd, nseg).cpu().numpy()
    assert K.LAUNCHES["ordered_segment_sum"] - before == 1
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("lengths", [
    (0, 1, 31, 32, 33, 4097), (4097, 0, 1), (0,), (1,), (33, 0, 0, 31),
    (255, 256, 257, 767, 768, 769)])
def test_ordered_segment_sum_segment_lengths(dev, lengths):
    rng = np.random.default_rng(sum(lengths))
    seg = _segments(lengths)
    x = rng.normal(size=seg.size) * 10.0 ** rng.integers(-8, 8, seg.size)
    _oss_check(dev, seg, x, len(lengths))
    # the values one element into their storage: not 16-byte aligned
    _oss_check(dev, seg, x, len(lengths), views=slice(1, None))


def test_ordered_segment_sum_one_segment_holds_most_rows(dev):
    rng = np.random.default_rng(99)
    lengths = [1000, 5, 990_000, 3000, 0, 6000]  # segment 2: 99% of rows
    seg = _segments(lengths)
    x = rng.normal(size=seg.size) * 10.0 ** rng.integers(-6, 6, seg.size)
    _oss_check(dev, seg, x, len(lengths))


def test_ordered_segment_sum_nan_and_inf(dev):
    rng = np.random.default_rng(5)
    lengths = [300, 300, 300, 300, 300, 2000]
    seg = _segments(lengths)
    x = rng.normal(size=seg.size)
    start = 3 + np.cumsum([0] + lengths[:-1])
    x[start[0] + 17] = np.nan                       # NaN
    x[start[1] + 5] = np.inf                        # +inf
    x[start[2] + 250] = -np.inf                     # -inf
    x[start[3] + 1], x[start[3] + 299] = np.inf, -np.inf  # inf - inf
    x[start[5] + 1999] = np.nan                     # NaN last
    _oss_check(dev, seg, x, len(lengths))


@pytest.mark.parametrize("nseg", [1, 64, 8192])
def test_ordered_segment_sum_is_not_a_tree(dev, nseg):
    """[1e16, 1, -1e16, 1, ...] per segment: the serial row-order sum
    differs from any pairwise or chunked reduction of the same rows."""
    per = 1200 if nseg < 8192 else 40
    seg = _segments([per] * nseg)
    x = np.zeros(seg.size)
    x[3:3 + per * nseg] = np.tile([1e16, 1.0, -1e16, 1.0], per * nseg // 4)
    keep = (seg >= 0) & (seg < nseg)
    serial = np.bincount(seg[keep], weights=x[keep], minlength=nseg)
    pairwise = x[3:3 + per * nseg].reshape(nseg, per).sum(1)
    assert not np.array_equal(serial, pairwise)
    _oss_check(dev, seg, x, nseg)


def test_bucket_sum_refused_shared_memory_raises(dev):
    """A table past what a block may hold, forced into shared memory by a
    plan with a larger budget, surfaces the card's refusal as an error."""
    seg = torch.zeros(64, dtype=torch.int32, device=dev)
    v = torch.ones(64, dtype=torch.bool, device=dev)
    orig = K.plan_bucket_sum
    try:
        K.plan_bucket_sum = lambda B, ni, nc: orig(B, ni, nc, budget=1 << 30)
        with pytest.raises(RuntimeError, match="bucket_sum kernel launch"):
            K.bucket_sum(seg, 65536, count_cols=[v])
    finally:
        K.plan_bucket_sum = orig


def test_bucket_winner_refused_shared_memory_raises(dev, monkeypatch):
    """A table past what a block may hold, forced into shared memory by
    the planner, surfaces the card's refusal as an error."""
    monkeypatch.setattr(K, "plan_bucket_winner", lambda B: True)
    seg = torch.zeros(64, dtype=torch.int32, device=dev)
    w = torch.ones(64, dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError, match="bucket_winner kernel launch"):
        K.bucket_winner(seg, 65536, "min", w)


def test_probe_ranges_refused_shared_memory_raises(dev, monkeypatch):
    """K4's bucket index past what a block may hold (a planner forced to
    2^17 buckets: 512 KB) surfaces as an error."""
    from spark_rapids_tpu_torch.ops import join_kernels as JK

    monkeypatch.setattr(JK, "plan_probe", lambda nb: 17)
    w = torch.zeros(1 << 18, dtype=torch.int64, device=dev)
    live = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(RuntimeError, match="probe_ranges kernel launch"):
        JK.probe_ranges([w], 1 << 18, [w[:8]], live)


def test_dadd_chain_probe_adds_serially(dev):
    x = torch.tensor([0.5, 1.0, -0.25], dtype=torch.float64, device=dev)
    assert float(K.dadd_chain(x, 1 << 12)) == 0.5 + 0.75 * (1 << 11)


def test_mixed_devices_and_short_columns_raise(dev):
    seg = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        K.bucket_winner(seg, 8, "min", torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        K.bucket_winner(seg, 8, "min",
                        torch.zeros(3, dtype=torch.int64, device=dev))


def test_grand_count_over_empty_input_stays_on_the_card(dev):
    """count(*) over a scan with no batches: the one output row is built
    on the scan's device, the card."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import schema_of
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (ColumnarToRowExec,
                                             InMemoryScanExec,
                                             TpuHashAggregateExec)
    from spark_rapids_tpu_torch.expr import aggregates as A

    conf = RapidsConf({})
    plan = TpuHashAggregateExec(conf, [], [A.agg(A.Count(None), "n")],
                                InMemoryScanExec(conf, [[]],
                                                 schema_of(k=T.INT)))
    out = list(plan.execute_partition(0))
    assert out[0].columns[0].data.device.type == "cuda"
    assert ColumnarToRowExec(conf, plan).collect() == [(0,)]


# ---------------------------------------------------------------------------
# K4: the join probe kernel
# ---------------------------------------------------------------------------
def _probe_inputs(rng, m, nb, bcount, nwords, dead=0.1):
    bws = [rng.integers(0, 1000, nb).astype(np.int64)]
    pws = [rng.integers(0, 1200, m).astype(np.int64)]
    if nwords == 2:
        bws.append(rng.integers(0, 2**32, nb, dtype=np.int64))
        bws[1][rng.random(nb) < 0.5] = 7  # duplicates on both words
        pws.append(np.where(rng.random(m) < 0.5, 7,
                            rng.integers(0, 2**32, m, dtype=np.int64)))
    order = np.lexsort(tuple(w[:bcount] for w in reversed(bws)))
    for w in bws:
        w[:bcount] = w[:bcount][order]
    live = rng.random(m) >= dead
    return bws, bcount, pws, live


@pytest.mark.parametrize("shape", [
    (1, 50_000, 4096, 4096, 0.1), (2, 50_000, 4096, 3000, 0.1),
    (1, 777, 333, 0, 0.1), (2, 70_001, 5_003, 4_999, 1.0),
    (2, 1, 1, 1, 0.0), (1, 131_071, 65_537, 60_000, 0.05)])
def test_probe_ranges_matches_plain(dev, shape):
    nwords, m, nb, bcount, dead = shape
    from spark_rapids_tpu_torch.ops import join_kernels as JK

    rng = np.random.default_rng(m + nb)
    bws, bc, pws, live = _probe_inputs(rng, m, nb, bcount, nwords, dead)
    args = (_on(dev, *bws), bc, _on(dev, *pws), *_on(dev, live))
    exp = JK.probe_ranges_plain(*args)  # the plain version, on the card
    before = JK.LAUNCHES["probe_ranges"]
    got = JK.probe_ranges(*args)
    assert JK.LAUNCHES["probe_ranges"] - before == 1
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    if dead == 1.0 or bcount == 0:
        assert not bool(got[1].any())


def test_probe_ranges_rejects_cpu_tensor_on_the_card_path(dev):
    from spark_rapids_tpu_torch.ops import join_kernels as JK

    w = torch.zeros(8, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="probe_live on"):
        JK.probe_ranges([w], 8, [w.cpu()], torch.ones(8, dtype=torch.bool,
                                                     device=dev))
    with pytest.raises(ValueError, match="probe_live on"):
        JK.probe_ranges([w], 8, [w], torch.ones(8, dtype=torch.bool))


@pytest.mark.parametrize("strategy", ["PALLAS", "SEARCH", "DIRECT", "RADIX",
                                      "AUTO"])
@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_join_on_the_card_matches_the_cpu(dev, how, strategy):
    """The same join on the card and on the CPU, per strategy (PALLAS: K4
    on the card, its plain version on the CPU): the same rows in the same
    order."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuShuffledHashJoinExec)
    from spark_rapids_tpu_torch.expr.expressions import col
    from spark_rapids_tpu_torch.ops import join_kernels as JK

    rng = np.random.default_rng(3)
    n, d = 5000, 700
    ld = {"k": [None if x < 0 else int(x)
                for x in rng.integers(-50, 1000, n)],
          "a": rng.integers(0, 100, n).tolist()}
    rd = {"k2": [None if x < 0 else int(x)
                 for x in rng.integers(-20, 600, d)],
          "b": rng.integers(0, 10**6, d).tolist()}
    ls, rs = schema_of(k=T.LONG, a=T.LONG), schema_of(k2=T.LONG, b=T.LONG)
    conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": strategy})

    def run(device):
        j = TpuShuffledHashJoinExec(
            conf, InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
                ld, ls, device=device)]], ls),
            InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
                rd, rs, device=device)]], rs), [col("k")], [col("k2")], how)
        return j.collect()

    before = JK.LAUNCHES["probe_ranges"]
    got = run(dev)
    assert JK.LAUNCHES["probe_ranges"] - before == (strategy == "PALLAS")
    assert got == run("cpu")


# K4's bucket index: build sizes around its bucket counts (2^r >= nb up
# to 2^15) and its fast path's 8 rows a bucket
K4_BUILDS = (0, 1, 2, 3, 4, 5, 7, 8, 9, 17, 32_767, 32_768, 32_769,
             1 << 17, (1 << 17) + 3, 232_449)
K4_FAST_ROWS = 8
_M32 = 0xFFFFFFFF


def _k4_keys(rng, nb, nwords, stride):
    """``nb`` sorted u64 keys (as Python ints) in runs: mostly short, some
    longer than ``stride``, a few over several times it; for two words a
    third of the keys with the top bit set (far outliers: most rows then
    share few buckets)."""
    keys, k = [], int(rng.integers(1, 1 << 20))
    while len(keys) < nb:
        r = rng.random()
        run = (1 if r < 0.5 else int(rng.integers(2, stride + 2)) if r < 0.95
               else int(rng.integers(2 * stride, 5 * stride)))
        keys += [k] * run
        k += int(rng.integers(1, 3 << 28 if nwords == 2 else 3 << 12))
        if nwords == 1:
            k &= _M32
    keys = sorted(keys[:nb])
    if nwords == 2:  # split so the top bit shows in the hi word
        keys = sorted(x | (1 << 63) if i % 3 == 0 else x
                      for i, x in enumerate(keys))
    return keys


def _k4_words(keys, nwords):
    a = np.array(keys, dtype=np.uint64)
    if nwords == 1:
        return [(a & np.uint64(_M32)).astype(np.int64)]
    return [(a >> np.uint64(32)).astype(np.int64),
            (a & np.uint64(_M32)).astype(np.int64)]


def _k4_check(dev, bkeys, bc, pkeys, live, nwords, device_count=False):
    from spark_rapids_tpu_torch.ops import join_kernels as JK

    bws = _on(dev, *_k4_words(bkeys, nwords))
    pws = _on(dev, *_k4_words(pkeys, nwords))
    (lv,) = _on(dev, live)
    exp = JK.probe_ranges_plain(bws, bc, pws, lv)
    count = (torch.tensor(bc, dtype=torch.int32, device=dev)
             if device_count else bc)
    before = JK.LAUNCHES["probe_ranges"]
    got = JK.probe_ranges(bws, count, pws, lv)
    assert JK.LAUNCHES["probe_ranges"] - before == 1
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    return got


@pytest.mark.parametrize("device_count", [False, True])
@pytest.mark.parametrize("nwords", [1, 2])
@pytest.mark.parametrize("nb", K4_BUILDS)
def test_probe_ranges_bucket_index_edges(dev, nb, nwords, device_count):
    """Build sizes at the planner's edges, runs longer than the fast
    path's bucket (the search path), keys with the top bit set, probes
    below the minimum and above the maximum, a build count below nb whose
    garbage tail holds probe keys, and m not a multiple of four."""
    rng = np.random.default_rng(nb * 4 + nwords * 2 + device_count)
    keys = _k4_keys(rng, nb, nwords, K4_FAST_ROWS)
    bc = nb - min(nb // 3, 1000) if nb % 2 else nb
    tail = sorted(keys[bc:], reverse=True)  # garbage: unsorted past bc
    bkeys = keys[:bc] + tail
    top = (1 << 64) - 1 if nwords == 2 else _M32
    m = 4099 + nb % 3
    pool = keys + [0, top, keys[0] - 1 if keys else 5, keys[-1] + 1 if keys
                   else 6]
    pkeys = [int(x) & top for x in rng.choice(np.array(pool, dtype=object),
                                              m)]
    live = rng.random(m) >= 0.05
    got = _k4_check(dev, bkeys, bc, pkeys, live, nwords, device_count)
    if bc == 0:
        assert not bool(got[1].any())


@pytest.mark.parametrize("nwords", [1, 2])
@pytest.mark.parametrize("nb", [1, 5, 4096, (1 << 17) + 3])
def test_probe_ranges_every_build_row_one_key(dev, nb, nwords):
    k = (1 << 63) + 12345 if nwords == 2 else 0x80000007
    pkeys = [k, k - 1, k + 1, 0] * 1025 + [k]
    live = np.ones(len(pkeys), bool)
    lo, hi = _k4_check(dev, [k] * nb, nb, pkeys, live, nwords)
    assert int(hi[0]) == nb and int(lo[0]) == 0


# ---------------------------------------------------------------------------
# K5: word counts per row
# ---------------------------------------------------------------------------
#: the word-count cases the CPU suite also holds against the reference
#: (``tests/test_torch_udf.py``)
WORD_COUNT_CASES = ("mid_pool", "garbage_tail", "empty_and_space_rows",
                    "long_row", "capacity_rows", "utf8")


def word_count_case(name, seed=0):
    """(offsets int32, chars uint8) of one word-count edge case, made from
    the chip check's Q10 text generator (``chip_smoke.word_count_text``)."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    off, chars, _, _ = chip_smoke.word_count_text(np, rng, 1500)
    off = off.astype(np.int64)
    if name == "mid_pool":
        # rows [301, 1200): offsets start mid-pool, some right after a
        # non-space byte of a skipped row
        off = off[301:1201]
    elif name == "garbage_tail":
        # the last rows cut off; non-space bytes where they were
        off = off[:1001]
        chars = chars.copy()
        chars[off[-1]:] = rng.choice(np.frombuffer(b"ab\xc3x", np.uint8),
                                     chars.size - off[-1])
    elif name == "empty_and_space_rows":
        lens = np.diff(off)
        kind = rng.integers(0, 3, lens.size)  # as made, empty, all space
        pieces = [bytes(chars[a:b]) if k == 0 else b"" if k == 1 else
                  bytes(rng.choice(np.frombuffer(b" \t\n\x0b\x0c\r",
                                                 np.uint8),
                                   int(rng.integers(1, 40))))
                  for a, b, k in zip(off[:-1], off[1:], kind)]
        chars = np.frombuffer(b"".join(pieces), np.uint8).copy()
        off = np.concatenate([[0], np.cumsum([len(x) for x in pieces])])
    elif name == "long_row":
        # one row of 70 000 bytes of words among short rows
        words = b" ".join(b"w%d" % i for i in range(12_000))[:70_000]
        pieces = [bytes(chars[a:b]) for a, b in zip(off[:-1], off[1:])]
        pieces[700] = words
        chars = np.frombuffer(b"".join(pieces), np.uint8).copy()
        off = np.concatenate([[0], np.cumsum([len(x) for x in pieces])])
    elif name == "capacity_rows":
        # a batch of 1500 rows at capacity 2048: flat offsets past the live
        # rows, the pool padded with zeros (non-space) to 2^17 bytes
        off = np.concatenate([off, np.full(548, off[-1])])
        chars = np.concatenate([chars, np.zeros((1 << 17) - chars.size,
                                                np.uint8)])
    elif name == "utf8":
        # every third letter a 2-byte UTF-8 letter
        chars = chars.copy()
        letters = np.flatnonzero((chars >= ord("a")) & (chars <= ord("z")))
        lead = letters[:-1][(np.diff(letters) == 1)][::3]
        chars[lead] = 0xC3
        chars[lead + 1] = 0xA0 + rng.integers(0, 32, lead.size)
    else:
        raise ValueError(name)
    return off.astype(np.int32), chars


def _wc_check(dev, off, chars, char_offset=0):
    """K5 on the card against its plain version, row for row: one launch
    per call. ``char_offset`` puts the pool that many bytes into its
    storage (a view not 16-byte aligned when it is not 0)."""
    from spark_rapids_tpu_torch.ops import udf_kernels as UK

    exp = UK.word_counts_plain(torch.from_numpy(off),
                               torch.from_numpy(chars))
    od = _on(dev, off)[0]
    cd = _on(dev, np.concatenate([np.zeros(char_offset, np.uint8),
                                  chars]))[0][char_offset:]
    before = UK.LAUNCHES["word_counts"]
    got = UK.word_counts(od, cd)
    assert UK.LAUNCHES["word_counts"] - before == 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), exp)
    return got


@pytest.mark.parametrize("char_offset", [0, 1])
@pytest.mark.parametrize("name", WORD_COUNT_CASES)
def test_word_counts_matches_plain(dev, name, char_offset):
    off, chars = word_count_case(name)
    _wc_check(dev, off, chars, char_offset)


@pytest.mark.parametrize("rows", [1, 2, 511, 512, 513, 1024, 5000])
@pytest.mark.parametrize("row_bytes", [0, 3, 16, 17, 700])
def test_word_counts_rows_straddling_runs_and_chunks(dev, rows, row_bytes):
    """Rows of one length, so row and 16-byte chunk boundaries fall at
    every offset against the kernel's runs of rows; a byte alphabet with
    whitespace, letters and the bytes next to the whitespace range."""
    rng = np.random.default_rng(rows * 1000 + row_bytes)
    alphabet = np.array([0x20, 0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x61, 0x62,
                         0xC3, 0x00, 0x08, 0x0E, 0x1F, 0x21], np.uint8)
    chars = rng.choice(alphabet, rows * row_bytes + 5)
    off = np.arange(rows + 1, dtype=np.int32) * row_bytes + 5
    _wc_check(dev, off, chars)


@pytest.mark.parametrize("max_bytes", [0, 12, 40])
def test_word_counts_more_runs_than_the_card_holds(dev, max_bytes):
    """2^21 + 3 short rows: more runs of rows than blocks resident on the
    card, so every block takes several runs of the grid-stride loop (the
    next run's offsets loaded while one counts) and a ragged last run."""
    rows = (1 << 21) + 3
    rng = np.random.default_rng(max_bytes)
    alphabet = np.array([0x20, 0x09, 0x0A, 0x0D, 0x61, 0x62, 0xC3, 0x00],
                        np.uint8)
    lens = rng.integers(0, max_bytes + 1, rows)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    chars = rng.choice(alphabet, int(off[-1]) + 16)
    chars[off[-1]:] = 0x61  # non-space bytes past the last row
    _wc_check(dev, off, chars)


@pytest.mark.parametrize("fill", [0x20, 0x0D, 0x61, 0xC3])
def test_word_counts_one_row_pool(dev, fill):
    chars = np.full((1 << 16) + 5, fill, np.uint8)
    chars[::7] = 0x20
    got = _wc_check(dev, np.array([0, chars.size], np.int32), chars)
    assert got.shape == (1,)


def test_word_counts_empty_pool_launches_nothing(dev):
    from spark_rapids_tpu_torch.ops import udf_kernels as UK

    before = UK.LAUNCHES["word_counts"]
    empty = torch.zeros(0, dtype=torch.uint8, device=dev)
    out = UK.word_counts(torch.zeros(4, dtype=torch.int32, device=dev),
                         empty)
    assert out.tolist() == [0, 0, 0] and out.device.type == "cuda"
    out = UK.word_counts(torch.zeros(1, dtype=torch.int32, device=dev),
                         empty)
    assert out.shape == (0,) and UK.LAUNCHES["word_counts"] == before


def _string_batch(device, n, seed):
    import chip_smoke
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import (DeviceColumn,
                                                 choose_capacity)
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, schema_of

    rng = np.random.default_rng(seed)
    off, chars, valid, _ = chip_smoke.word_count_text(np, rng, n)
    cap = choose_capacity(n)
    offsets = np.full(cap + 1, off[-1])
    offsets[:n + 1] = off
    v = np.zeros(cap, bool)
    v[:n] = valid
    k = np.zeros(cap, np.int32)
    k[:n] = rng.integers(0, 64, n)
    scol = DeviceColumn.from_string_arrays(T.STRING, n, offsets, chars, v,
                                           device)
    kcol = DeviceColumn(T.INT, n, torch.from_numpy(k).to(device),
                        torch.from_numpy(np.arange(cap) < n).to(device))
    return ColumnarBatch([kcol, scol], schema_of(k=T.INT, s=T.STRING), n)


def test_word_count_query_on_the_card_matches_the_cpu(dev):
    """Q10's plan at 3 x 5000 rows: K5 once per batch, same rows as the
    CPU."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuHashAggregateExec,
                                             TpuProjectExec)
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr.expressions import Alias, col
    from spark_rapids_tpu_torch.ops import udf_kernels as UK
    from spark_rapids_tpu_torch.udf import string_word_count

    conf = RapidsConf({})

    def run(device):
        bs = [_string_batch(device, 5000, s) for s in range(3)]
        proj = TpuProjectExec(conf, [col("k"), Alias(string_word_count(
            col("s")), "wc")], InMemoryScanExec(conf, [bs], bs[0].schema))
        agg = TpuHashAggregateExec(conf, [col("k")], [
            A.agg(A.Sum(col("wc")), "sw"), A.agg(A.Count(col("wc")), "cw"),
            A.agg(A.Count(None), "c")], proj)
        return sorted(agg.collect())

    before = UK.LAUNCHES["word_counts"]
    got = run(dev)
    assert UK.LAUNCHES["word_counts"] - before == 3
    assert got == run("cpu")


def test_string_expressions_on_the_card_match_the_cpu(dev):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.eval import evaluate_projection

    s = E.BoundReference(1, T.STRING)
    exprs = [E.Substring(E.Upper(s), E.lit(1), E.lit(6)), E.Length(s),
             E.Contains(s, E.lit("é")), E.StringTrim(s), E.Lower(s),
             E.Concat((s, E.lit("-"), s)), E.LessThan(s, E.lit("m")),
             E.StartsWith(s, E.lit("a")), E.EndsWith(s, E.lit("z"))]
    rows = {}
    for device in (dev, "cpu"):
        b = _string_batch(device, 3000, 7)
        rows[str(device)] = [c.to_host().to_pylist()
                             for c in evaluate_projection(exprs, b)]
    assert rows[str(dev)] == rows["cpu"]


def _key_column(device, keys):
    """A string column of ``keys`` (None for null) on ``device``."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
    from spark_rapids_tpu_torch.exec.base import vals_of_batch

    b = ColumnarBatch.from_pydict({"s": keys}, schema_of(s=T.STRING),
                                  device=device)
    return vals_of_batch(b)[0], b.capacity


@pytest.mark.parametrize("width", [3, 5, 8])
def test_probe_ranges_on_string_chunk_words(dev, width):
    """K4 on the chunk words of string keys of 1 and 2 words (as the
    string join hands them over), against its plain version on the same
    card tensors."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.ops import join_kernels as JK
    from spark_rapids_tpu_torch.ops.filter_gather import live_of
    from spark_rapids_tpu_torch.ops.sort import (SortOrder, sort_permutation,
                                                 str_max_lens)

    rng = np.random.default_rng(width)
    pool = ["%0*d" % (width, i) for i in range(3000)]
    build = [pool[i] for i in rng.integers(0, 3000, 5000)]
    probe = [None if rng.random() < 0.05 else pool[i] if rng.random() < 0.9
             else "X" * width for i in rng.integers(0, 3000, 40_000)]
    bcol, bcap = _key_column(dev, build)
    pcol, pcap = _key_column(dev, probe)
    bml = str_max_lens([bcol])
    bw, _ = J.radix_key_words([bcol], [T.STRING], bml)
    perm = sort_permutation([bcol], [T.STRING], [SortOrder(True, True)],
                            live_of(5000, bcap, dev), bml)
    bw = [w[perm] for w in bw]
    pw, pnull = J.radix_key_words([pcol], [T.STRING], str_max_lens([pcol]))
    live = live_of(40_000, pcap, dev) & ~pnull
    assert len(bw) == len(pw) == (1 if width <= 4 else 2)
    exp = JK.probe_ranges_plain(bw, 5000, pw, live)
    before = JK.LAUNCHES["probe_ranges"]
    got = JK.probe_ranges(bw, 5000, pw, live)
    assert JK.LAUNCHES["probe_ranges"] - before == 1
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


@pytest.mark.parametrize("op", ["min", "max"])
def test_bucket_winner_on_string_ranks(dev, op):
    """K3 on the order words of a string column's rank column (string
    min/max on the hash tiers), against its plain version."""
    from spark_rapids_tpu_torch.ops import groupby as G

    rng = np.random.default_rng(5)
    keys = ["AAAAAAAA" + "".join(chr(65 + c) for c in rng.integers(0, 16, 8))
            if rng.random() > 0.05 else None for _ in range(60_000)]
    col, cap = _key_column(dev, keys)
    _, rank = G._plain_rank(col, 60_000, 16)
    seg = torch.from_numpy(rng.integers(0, 1024, cap).astype(
        np.int32)).to(dev)
    word = K._order_words(rank.data, ~rank.validity, op)
    exp = K.bucket_winner_plain(seg, 1024, op, word)
    before = K.LAUNCHES["bucket_winner"]
    got = K.bucket_winner(seg, 1024, op, word)
    assert K.LAUNCHES["bucket_winner"] - before == 1
    assert torch.equal(got, exp)


@pytest.mark.parametrize("strategy", ["PALLAS", "SEARCH", "RADIX", "AUTO"])
@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_string_key_join_on_the_card_matches_the_cpu(dev, how, strategy):
    """A join on 6-byte string keys with string payloads, then a
    string-keyed aggregate of its output, on the card and on the CPU:
    the same rows in the same order (PALLAS: K4 on the card)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuHashAggregateExec,
                                             TpuShuffledHashJoinExec)
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr.expressions import col

    rng = np.random.default_rng(9)
    n, d = 5000, 700
    ld = {"k": [None if x < 0 else "k%05d" % x
                for x in rng.integers(-50, 1000, n)],
          "p": ["p" * int(x) for x in rng.integers(0, 12, n)]}
    rd = {"k2": [None if x < 0 else "k%05d" % x
                 for x in rng.integers(-20, 800, d)],
          "q": ["city%d" % x for x in rng.integers(0, 40, d)]}
    ls, rs = schema_of(k=T.STRING, p=T.STRING), schema_of(k2=T.STRING,
                                                          q=T.STRING)

    def run(device):
        conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": strategy})
        join = TpuShuffledHashJoinExec(
            conf, InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
                ld, ls, device=device)]], ls),
            InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
                rd, rs, device=device)]], rs),
            [col("k")], [col("k2")], how)
        rows = join.collect()
        if how in ("semi", "anti"):
            return rows, None
        agg = TpuHashAggregateExec(conf, [col("q")], [
            A.agg(A.Count(None), "n"), A.agg(A.Min(col("p")), "mn"),
            A.agg(A.Max(col("k")), "mx")], join)
        return rows, sorted(agg.collect(), key=repr)

    assert run(dev) == run("cpu")


def _dict_batch(device, n, seed):
    """A batch of a dictionary-encoded key ``s`` (12 entries, 10% null),
    a dictionary-encoded ``m`` (300 names), a long and a double."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import (ColumnarBatch,
                                                 column_from_pylist,
                                                 dict_column_from_pylist,
                                                 schema_of)

    rng = np.random.default_rng(seed)
    pool = ["alpha", "", "beta-X", "ü-mixed", "gamma", "X", "tail-9", "42",
            "  pad ", "delta-long-value", "zeta", "a.b"]
    s = [None if r < 0.1 else pool[i] for r, i in
         zip(rng.random(n), rng.integers(0, len(pool), n))]
    m = ["name-%03d" % i for i in rng.integers(0, 300, n)]
    v = [int(x) for x in rng.integers(-10**6, 10**6, n)]
    f = [float(x) for x in rng.normal(size=n)]
    return ColumnarBatch(
        [dict_column_from_pylist(s, device=device),
         dict_column_from_pylist(m, device=device),
         column_from_pylist(v, T.LONG, device=device),
         column_from_pylist(f, T.DOUBLE, device=device)],
        schema_of(s=T.STRING, m=T.STRING, v=T.LONG, f=T.DOUBLE), n)


def test_dict_key_aggregate_on_the_card_matches_the_cpu(dev):
    """Dictionary keys on their codes under PALLAS on the card (K1, K2
    and K3 on the direct tier, the merge of three batches' partials on
    the string sort path) give the CPU's rows, and filter -> project
    over the dictionary the CPU's strings."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec, TpuFilterExec,
                                             TpuHashAggregateExec,
                                             TpuProjectExec)
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit

    conf = RapidsConf({"spark.rapids.tpu.sql.agg.strategy": "PALLAS",
                       "spark.rapids.tpu.sql.variableFloatAgg.enabled":
                       True})

    def run(device):
        bs = [_dict_batch(device, 4000, s) for s in range(3)]
        scan = InMemoryScanExec(conf, [bs], bs[0].schema)
        agg = TpuHashAggregateExec(conf, [col("s")], [
            A.agg(A.Count(None), "n"), A.agg(A.Sum(col("v")), "sv"),
            A.agg(A.Sum(col("f")), "sf"), A.agg(A.Min(col("m")), "mn"),
            A.agg(A.Max(col("m")), "mx")], scan)
        rows = sorted(agg.collect(), key=repr)
        proj = TpuProjectExec(conf, [
            E.Alias(E.Substring(E.Upper(col("s")), lit(1), lit(4)), "u"),
            E.Alias(E.Length(col("s")), "ln"), col("m")],
            TpuFilterExec(conf, E.Contains(col("s"), lit("a")),
                          InMemoryScanExec(conf, [bs], bs[0].schema)))
        return rows, proj.collect()

    before = dict(K.LAUNCHES)
    (got, got_p), (want, want_p) = run(dev), run("cpu")
    assert all(K.LAUNCHES[k] > before[k] for k in
               ("bucket_sum", "bucket_float_sum", "bucket_winner"))
    assert got_p == want_p
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3] and g[4:] == w[4:]
        assert abs(g[3] - w[3]) <= 1e-9 * 4000 * 5


#: DFA patterns on the card: absorbing, anchored, Java '$' (non-absorbing)
#: and a class that takes multi-byte UTF-8
DFA_PATTERNS = ("^[a-z]+ (sly|furious)", "ts$", "s\\.$", "[^ -~]", "é.",
                "(ab|c)+x?", "^$")


@pytest.mark.parametrize("pat", DFA_PATTERNS)
def test_dfa_accept_rows_matches_its_plain_version(dev, pat):
    """The regex row matcher's kernel against its plain version (held to
    the reference's scan in ``tests/test_torch_regex.py``), on random
    UTF-8 rows with '\\n' endings, empty and null rows, on the whole
    column, on a slice whose offsets start mid-pool and with garbage past
    the last offset."""
    from spark_rapids_tpu_torch.ops import regex as RX
    from spark_rapids_tpu_torch.ops import regex_kernels as RK

    rng = np.random.default_rng(len(pat))
    alphabet = ["a", "b", "c", "s", "t", "x", ".", " ", "\n", "é", "日",
                "sly", "furious", "ab"]
    rows = ["".join(rng.choice(alphabet, int(rng.integers(0, 9))))
            for _ in range(5000)]
    bs = [r.encode() for r in rows]
    off = (3 + np.concatenate([[0], np.cumsum([len(b) for b in bs])])
           ).astype(np.int32)
    pool = np.frombuffer(b"xs\n" + b"".join(bs) + b"ts\nsly" * 5,
                         np.uint8).copy()
    valid = rng.random(len(rows)) > 0.1
    d = RX.compile_search_dfa(pat)
    for a, b in ((0, len(rows)), (1234, 3999)):
        o, v = off[a:b + 1], valid[a:b]
        want = RK.dfa_accept_rows_plain(*_on("cpu", o, pool, v), d)
        before = RK.LAUNCHES["dfa_accept_rows"]
        got = RX.dfa_accept_rows(*_on(dev, o, pool, v), d)
        torch.cuda.synchronize()
        assert RK.LAUNCHES["dfa_accept_rows"] == before + 1
        assert torch.equal(got.cpu(), want)


#: anchored patterns with a dead state, and two that walk every byte
DFA_EDGE_PATTERNS = ("^[a-z]+ (sly|furious)", "^$", "^ab$", "s$", "[^ -~]")
#: row starts written over the random bytes, one row in three
DFA_EDGE_HEADS = (b"ab", b"ab sly", b"xy furious", b"\n", b"ab\n", b"s\n")
DFA_EDGE_BYTES = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyz     sly\n.\xc3\xa9", np.uint8)


def _dfa_column(rng, lens, nl_rows=()):
    """Offsets and a pool of random bytes for rows of ``lens`` bytes, one
    row in three starting with one of ``DFA_EDGE_HEADS`` and the rows
    ``nl_rows`` ending in '\n'."""
    lens = np.asarray(lens, np.int64)
    off = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    pool = rng.choice(DFA_EDGE_BYTES, int(off[-1]) + 1)
    for i in range(0, lens.size, 3):
        head = DFA_EDGE_HEADS[(i // 3) % len(DFA_EDGE_HEADS)][:lens[i]]
        pool[off[i]:off[i] + len(head)] = np.frombuffer(head, np.uint8)
    for i in nl_rows:
        if lens[i]:
            pool[off[i + 1] - 1] = 0x0A
    return off.astype(np.int32), pool


def _dfa_edge_case(case):
    """(offsets, pool, validity, pool start in the view, rows the plain
    version leaves to :func:`_dfa_walk_maps`) for one edge case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "lengths_0_5000":
        lens = rng.integers(0, 5001, 3000)
    elif case == "long_rows":
        lens = rng.integers(0, 80, 2000)
        lens[700], lens[1500] = 1 << 16, 1 << 20
        off, pool = _dfa_column(rng, lens)
        return off, pool, rng.random(lens.size) > 0.1, 0, (700, 1500)
    elif case == "unaligned_view":
        lens = rng.integers(0, 90, 5000)
        off, pool = _dfa_column(rng, lens)
        return off, np.concatenate([pool[:3], pool]), np.ones(
            lens.size, bool), 3, ()
    elif case == "cap_odd":
        lens = rng.integers(0, 70, 3 * 1024 + 17)
    elif case == "cap_255":
        lens = rng.integers(0, 70, 255)
    elif case == "all_null":
        lens = rng.integers(0, 70, 4000)
        off, pool = _dfa_column(rng, lens)
        return off, pool, np.zeros(lens.size, bool), 0, ()
    elif case == "all_empty":
        return (np.full(3000, 5, np.int32), rng.choice(DFA_EDGE_BYTES, 9),
                np.ones(2999, bool), 0, ())
    else:  # "newline_at_warp_edges": 2^20 + 5 rows
        n = (1 << 20) + 5
        lens = rng.integers(1, 40, n)
        edge = np.flatnonzero(np.isin(np.arange(n) % 32, (0, 31)))
        off, pool = _dfa_column(rng, lens, edge)
        return off, pool, rng.random(n) > 0.05, 0, ()
    off, pool = _dfa_column(rng, lens)
    return off, pool, rng.random(lens.size) > 0.1, 0, ()


def _dfa_walk_maps(table, row: np.ndarray) -> int:
    """The DFA's state after ``row`` from state 0, by composing the bytes'
    16-state maps pairwise (the reference's method; a step a byte would
    take a million torch calls on a 1 MB row)."""
    maps = table[row] if row.size else np.arange(16)[None]
    while len(maps) > 1:
        if len(maps) % 2:
            maps = np.concatenate([maps, np.arange(16)[None]])
        maps = np.take_along_axis(maps[1::2], maps[0::2].astype(np.int64),
                                  axis=1)
    return int(maps[0][0])


DFA_EDGE_CASES = ("lengths_0_5000", "long_rows", "unaligned_view", "cap_odd",
                  "cap_255", "all_null", "all_empty", "newline_at_warp_edges")


@pytest.mark.parametrize("pat", DFA_EDGE_PATTERNS)
@pytest.mark.parametrize("case", DFA_EDGE_CASES)
def test_dfa_accept_rows_edge_columns_match_the_plain_version(dev, case,
                                                              pat):
    """The regex row matcher's kernel against its plain version, bit for
    bit, one launch each: row lengths 0-5000; a 64 KB and a 1 MB row
    among short ones (those two held to a composition of the same table);
    a pool view whose pointer is 3 bytes past 16-byte alignment; columns
    of 3 x 1024 + 17 and 255 rows (neither a multiple of the kernel's
    256-thread block); all null; all empty; '\n'-ended rows on both sides
    of every 32-row boundary (a warp's rows; the blocks and the grid
    stride are multiples of 32) over 2^20 + 5 rows. Anchored patterns die
    in a dead state, where the walk stops."""
    from spark_rapids_tpu_torch.ops import regex as RX
    from spark_rapids_tpu_torch.ops import regex_kernels as RK

    off, pool, valid, at, long_rows = _dfa_edge_case(case)
    d = RX.compile_search_dfa(pat)
    o_d, v_d, whole = _on(dev, off, valid, pool)
    pool_d = whole[at:]
    assert pool_d.data_ptr() % 16 == at
    before = RK.LAUNCHES["dfa_accept_rows"]
    got = RK.dfa_accept_rows(o_d, pool_d, v_d, d).cpu()
    torch.cuda.synchronize()
    assert RK.LAUNCHES["dfa_accept_rows"] == before + 1
    o_p, p_p = off, pool[at:]
    if long_rows:  # the plain version walks the short rows only
        lens = np.diff(off.astype(np.int64))
        cut = np.ones(p_p.size, bool)
        for i in long_rows:
            cut[off[i]:off[i + 1]] = False
            lens[i] = 0
        o_p = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        p_p = p_p[cut]
    want = RK.dfa_accept_rows_plain(*_on(dev, o_p, p_p, valid), d).cpu()
    keep = np.ones(valid.size, bool)
    keep[list(long_rows)] = False
    assert torch.equal(got[keep], want[keep])
    tbl = RK.transition_table(d)
    for i in long_rows:
        row = pool[at + off[i]:at + off[i + 1]]
        acc = bool((d.accept_mask >> _dfa_walk_maps(tbl, row)) & 1)
        if not d.absorbing and row[-1] == 0x0A:
            acc |= bool((d.accept_mask >> _dfa_walk_maps(tbl, row[:-1])) & 1)
        assert bool(got[i]) == (acc and bool(valid[i]))


def test_date_keyed_decimal_aggregate_on_the_card_matches_the_cpu(
        dev, tmp_path):
    """The chip check's Q27 at 2^16 rows (TPC-DS store_sales with INT32
    decimals in 4 files): group by a DATE, count, a decimal sum (K1), a
    decimal avg (HALF_UP at scale 6), a decimal min and a timestamp max
    (K3) through the session on the card give the CPU's rows and the
    oracle's."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    import chip_smoke as CS
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.sql.session import TpuSession

    t = CS.store_sales_table(np, 1 << 16)
    path = str(tmp_path / "store_sales")
    CS._write_files(pa, pq, path,
                    CS.tpcds_sales_tables(pa, np, t)["store_sales"], 4,
                    store_decimal_as_integer=True)
    before = dict(K.LAUNCHES)
    got = CS.q27_df(TpuSession({}, device=dev), path, E, A).collect()
    assert all(K.LAUNCHES[k] > before[k]
               for k in ("bucket_sum", "bucket_winner"))
    want = CS.q27_df(TpuSession({}, device="cpu"), path, E, A).collect()
    assert got == want == CS.q27_oracle(np, t)


def test_decimal_and_timestamp_to_double_on_the_card_are_exact(dev):
    """decimal -> double and timestamp -> double divide by a power of ten
    correctly rounded on the card too (CUDA makes a division by a host
    scalar a reciprocal multiply, one ulp off on some values): the card's
    bits equal the CPU's and Python's ``/``."""
    from decimal import Decimal

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.eval import evaluate_projection

    rng = np.random.default_rng(3)
    cents = rng.integers(-10**9, 10**9, 1 << 14)
    us = rng.integers(-4 * 10**15, 4 * 10**15, 1 << 14)
    data = {"m": [Decimal(int(c)).scaleb(-2) for c in cents],
            "t": [int(u) for u in us]}
    schema = schema_of(m=T.DecimalType(11, 2), t=T.TIMESTAMP)
    exprs = [E.Cast(E.col("m"), T.DOUBLE), E.Cast(E.col("t"), T.DOUBLE)]

    def run(device):
        b = ColumnarBatch.from_pydict(data, schema, device=device)
        return [c.data.cpu().view(torch.int64) for c in evaluate_projection(
            [E.bind_references(e, schema) for e in exprs], b)]

    got, want = run(dev), run("cpu")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0][: cents.size].view(torch.float64).tolist() == [
        int(c) / 100 for c in cents]
    assert got[1][: us.size].view(torch.float64).tolist() == [
        int(u) / 1e6 for u in us]


@pytest.mark.parametrize("scale", list(range(-2, 7)))
def test_round_of_doubles_on_the_card_is_the_cpus(dev, scale):
    """round(x, s) over doubles divides by 10^s as a device tensor, so the
    card's bits equal the CPU's (a host-scalar divisor would be a
    reciprocal multiply on CUDA): random doubles over many magnitudes,
    exact halves, +-0.0, NaN and +-inf."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.eval import evaluate_projection

    rng = np.random.default_rng(100 + scale)
    x = (rng.standard_normal(1 << 14)
         * 10.0 ** rng.integers(-8, 12, 1 << 14)).tolist()
    halves = [(k + 0.5) / 10.0 ** scale for k in range(-50, 50)]
    x += halves + [0.0, -0.0, float("nan"), float("inf"), -float("inf"),
                   5e-324, -1.7976931348623157e308]
    schema = schema_of(x=T.DOUBLE)
    expr = E.bind_references(E.Round(E.col("x"), scale), schema)

    def run(device):
        b = ColumnarBatch.from_pydict({"x": x}, schema, device=device)
        (c,) = evaluate_projection([expr], b)
        return c.data.cpu().view(torch.int64)[: len(x)]

    assert torch.equal(run(dev), run("cpu"))


@pytest.mark.parametrize("scale", list(range(1, 7)))
def test_round_with_a_host_scalar_divisor_differs_on_the_card(dev, scale):
    """Why Round divides by a device tensor: the same rounding with a
    host-scalar divisor (a reciprocal multiply on CUDA) gives other bits
    on the card than on the CPU for these doubles."""
    rng = np.random.default_rng(100 + scale)
    x = torch.tensor((rng.standard_normal(1 << 14)
                      * 10.0 ** rng.integers(-8, 12, 1 << 14)).tolist(),
                     dtype=torch.float64)
    f = 10.0 ** scale

    def host_scalar(t):
        return torch.sign(t) * torch.floor(torch.abs(t) * f + 0.5) / f

    assert not torch.equal(host_scalar(x.to(dev)).cpu(), host_scalar(x))


def _radix_case(rng, n, nseg, ndead, tie_words, lengths=None):
    """A sorted order of ``n`` rows: ``nseg`` segments (or the given
    ``lengths``), then ``ndead`` dead rows (id n), a random permutation,
    and columns for every stream kind."""
    live = n - ndead
    if lengths is None:
        seg = np.sort(rng.integers(0, nseg, live))
        _, seg = np.unique(seg, return_inverse=True)
    else:
        seg = np.repeat(np.arange(len(lengths)), lengths)
    seg = np.concatenate([seg, np.full(ndead, n)]).astype(np.int32)
    perm = rng.permutation(n).astype(np.int64)
    fl = rng.normal(size=n) * 1e6
    for val, p in ((1e300, 0.002), (np.inf, 0.001), (-np.inf, 0.001),
                   (np.nan, 0.001)):
        fl[rng.random(n) < p] = val
    return dict(seg=seg, perm=perm,
                ints=rng.integers(-(2 ** 63), 2 ** 63 - 1, n,
                                  dtype=np.int64),
                i32=rng.integers(-(2 ** 31), 2 ** 31 - 1, n).astype(np.int32),
                fl=fl, f32=rng.normal(size=n).astype(np.float32),
                words=rng.integers(0, 3 if tie_words else 1 << 62, n),
                valid=rng.random(n) > 0.1)


#: (rows, segments, dead rows, tied words, reference tile, lengths)
RADIX_CASES = {
    "ties_ref_tile_8": (5000, 37, 300, True, 8, None),
    "ties_ref_tile_1000": (70_000, 3, 10, True, 1000, None),
    "one_segment_many_warp_tiles": (300_000, 1, 0, True, 4096, None),
    "segments_on_warp_tile_edges": (8192, 0, 0, True, 64,
                                    [1024, 1, 1023, 2048, 1, 4095]),
    "all_dead": (3000, 1, 3000, False, 256, None),
    "one_row_segments": (4096, 4096, 0, False, 4096, None),
    # a segment on the last row of one kernel tile and the first of the
    # next, a one-row segment on a tile's last row, one exactly a tile
    "segment_across_one_tile_edge": (
        _RT * 3 + 5, 0, 5, True, 100,
        [_RT - 1, 2, _RT - 2, 1, _RT]),
}


@pytest.mark.parametrize("case", sorted(RADIX_CASES))
def test_radix_segment_reduce_matches_its_plain_version(dev, case):
    """The RADIX segment kernel against its plain version (the reference's
    tile loop) on the card: counts, integer sums, positions and winner
    rows exactly (max ties broken by the reference's tiles); float NORMAL
    and BIG sums within 1e-12 of each segment's sum of |x|; the presence
    flags exactly; all over the segments the ids reach (the kernel leaves
    the outputs past them unwritten). One counted call of the wrapper."""
    n, nseg, ndead, ties, ref_tile, lengths = RADIX_CASES[case]
    c = _radix_case(np.random.default_rng(n + ndead), n, nseg, ndead, ties,
                    lengths)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in c.items()}
    _assert_radix_matches_plain(t, _radix_streams(t), ref_tile)


def _radix_streams(t):
    """Every stream kind over the columns of :func:`_radix_case`."""
    from spark_rapids_tpu_torch.ops import radix_kernels as RK

    vd = t["valid"]
    return [RK.Stream("pos", op="min"), RK.Stream("count"),
            RK.Stream("count", valid=vd),
            RK.Stream("isum", t["ints"], vd),
            RK.Stream("isum", t["i32"], vd),
            RK.Stream("pos", None, vd, "max"),
            RK.Stream("win", t["words"], vd, "max"),
            RK.Stream("win", t["words"], vd, "min"),
            RK.Stream("fsum", t["fl"], vd),
            RK.Stream("fsum", t["f32"], vd)]


def _assert_radix_matches_plain(t, streams, ref_tile):
    """One counted kernel call against the plain version: exact but for
    the float sums (1e-12 of each segment's sum of |x|), over the
    segments the live ids reach. Returns the kernel's outputs there."""
    from spark_rapids_tpu_torch.ops import radix_kernels as RK

    n = t["perm"].shape[0]
    before = RK.LAUNCHES["radix_segment_reduce"]
    got = RK.segment_reduce(t["perm"], t["seg"], streams, ref_tile)
    assert RK.LAUNCHES["radix_segment_reduce"] - before == 1
    want = RK.segment_reduce_plain(t["perm"], t["seg"], streams, ref_tile)
    live = t["seg"][(t["seg"] >= 0) & (t["seg"] < n)]
    k = int(live.max()) + 1 if live.numel() else 0
    got = [tuple(x[:k] for x in g) for g in got]
    want = [tuple(x[:k] for x in w) for w in want]
    for s, g, w in zip(streams, got, want):
        if s.kind != "fsum":
            assert torch.equal(g[0].to(torch.int64), w[0].to(torch.int64)), s
            continue
        absum = [x[:k] for x in RK.segment_reduce_plain(
            t["perm"], t["seg"], [RK.Stream("fsum", s.data.abs(), s.valid)],
            ref_tile)[0]]
        for j in range(2):
            tol = 1e-12 * absum[j]
            assert bool((((g[j] - w[j]).abs() <= tol)
                         | (g[j] == w[j])).all()), (s.kind, j)
        assert torch.equal(g[2], w[2])
    return got


def test_radix_segment_reduce_q17v_like_order(dev):
    """Q17v's order: a stable sort of 4 interleaved, skewed group keys
    over 2^21 rows (the permutation rises within each segment, and each
    segment spans hundreds of kernel tiles), 2% of rows filtered out (dead,
    last)."""
    rng = np.random.default_rng(17)
    n = (1 << 21) + 37
    key = rng.choice(4, n, p=[0.25, 0.25, 0.49, 0.01])
    key[rng.random(n) < 0.02] = 4
    perm = np.argsort(key, kind="stable").astype(np.int64)
    skey = key[perm]
    seg = np.where(skey == 4, n, skey).astype(np.int32)
    c = _radix_case(rng, n, 1, 0, True)
    c.update(seg=seg, perm=perm)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in c.items()}
    _assert_radix_matches_plain(t, _radix_streams(t), 4096)


def test_radix_segment_reduce_more_than_32_streams(dev):
    """40 streams in one call (the kernel takes them in groups of at most
    32): every group against the plain version."""
    from spark_rapids_tpu_torch.ops import radix_kernels as RK

    c = _radix_case(np.random.default_rng(40), 60_000, 300, 77, True)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in c.items()}
    streams = _radix_streams(t) * 4
    assert len(streams) == 40
    streams += [RK.Stream("count", valid=t["valid"].clone())]
    _assert_radix_matches_plain(t, streams, 256)


def test_radix_segment_reduce_shared_inputs_match_copies(dev):
    """A count and a sum that share a validity and a sum and an avg that
    share a column (one input each in the kernel's table) give what the
    same call gives with a copy of every tensor, bit for bit."""
    from spark_rapids_tpu_torch.ops import radix_kernels as RK

    c = _radix_case(np.random.default_rng(5), 100_000, 1000, 100, True)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in c.items()}
    vd, fl = t["valid"], t["fl"]

    def streams(v1, v2, v3, f1, f2):
        return [RK.Stream("count", valid=v1), RK.Stream("fsum", f1, v2),
                RK.Stream("count", valid=v3), RK.Stream("fsum", f2, v3),
                RK.Stream("win", t["words"], v1, "max")]

    shared = streams(vd, vd, vd, fl, fl)
    assert len(RK.pack_arguments(shared, fl.shape[0], fl.device).inputs) == 3
    copies = streams(vd.clone(), vd.clone(), vd.clone(), fl.clone(),
                     fl.clone())
    assert len(RK.pack_arguments(copies, fl.shape[0], fl.device).inputs) == 6
    a = _assert_radix_matches_plain(t, shared, 512)
    b = _assert_radix_matches_plain(t, copies, 512)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert torch.equal(u, v)


@pytest.mark.parametrize("tier", ["RADIX", "SORT", "MATMUL", "PALLAS"])
def test_forced_tier_aggregate_on_the_card_matches_the_cpu(dev, tier):
    """Each forced tier on the card gives the CPU's rows: RADIX (and
    PALLAS's string sort path in the merge) on the RADIX kernel, SORT's
    prefix differences and MATMUL's limb products; float sums within
    1e-12 of each group's sum of |x| (f64 on RADIX, SORT and PALLAS),
    1e-4 of it on MATMUL (its f32 hi/lo split)."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuHashAggregateExec)
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col
    from spark_rapids_tpu_torch.ops import radix_kernels as RK

    conf = RapidsConf({"spark.rapids.tpu.sql.agg.strategy": tier,
                       "spark.rapids.tpu.sql.variableFloatAgg.enabled":
                       True})
    # PALLAS: the three partials merge on the string sort path; the
    # others group the 300 dictionary codes of m
    key = "s" if tier == "PALLAS" else "m"

    def run(device):
        bs = [_dict_batch(device, 4000, s) for s in range(3)]
        scan = InMemoryScanExec(conf, [bs], bs[0].schema)
        agg = TpuHashAggregateExec(conf, [col(key)], [
            A.agg(A.Count(None), "n"), A.agg(A.Sum(col("v")), "sv"),
            A.agg(A.Min(col("m")), "mn"), A.agg(A.Max(col("m")), "mx"),
            A.agg(A.Sum(col("f")), "sf"),
            A.agg(A.Sum(E.Abs(col("f"))), "sa")], scan)
        return sorted(agg.collect(), key=repr)

    before = RK.LAUNCHES["radix_segment_reduce"]
    got, want = run(dev), run("cpu")
    launched = RK.LAUNCHES["radix_segment_reduce"] - before
    assert (launched > 0) == (tier in ("RADIX", "PALLAS")), launched
    assert len(got) == len(want)
    rtol = 1e-4 if tier == "MATMUL" else 1e-12
    for g, w in zip(got, want):
        assert g[:5] == w[:5]
        assert abs(g[5] - w[5]) <= rtol * w[6], (g, w)


def test_matmul_tier_refuses_tf32_on_the_card(dev):
    """The MATMUL tier's limb sums are exact only in full f32: with TF32
    on it raises, naming the flag, and leaves the flag set."""
    from spark_rapids_tpu_torch.ops import bucket_reduce as BR

    seg = torch.zeros(8, dtype=torch.int32, device=dev)
    valid = torch.ones(8, dtype=torch.bool, device=dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            BR.bucket_reduce(seg, 4, (), [valid], (), strategy="MATMUL")
        assert torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        _, cnt, _ = BR.bucket_reduce(seg, 4, (), [valid], (),
                                     strategy="MATMUL")
        assert cnt[0].tolist() == [8, 0, 0, 0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
