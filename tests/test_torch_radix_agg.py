"""The port's RADIX tier (``ops/radix_bin.py``, ``ops/radix_kernels.py``,
``ops/groupby._radix_groupby``) against the reference's, on the same
inputs.

The matrix of ``tests/test_radix_agg.py:119-317`` (int64 wraparound,
all-null columns, inf/NaN/huge float streams, magnitude disparity across
groups, dead rows, an empty batch, multi-tile and flush tiles, one group
spanning every tile) runs through both packages' ``groupby_agg`` under
RADIX, with ``FORCE_TILE_ROWS`` set in both where a case forces tiles.
Integers, counts, positions and winner rows (min/max values, compared by
their bits) must be bit for bit the reference's; f64 sums within rtol
1e-12 (the reference's ``_TIGHT_FLOAT``), and the disparity case exact.
The plain tile loop (the kernel's plain version) is also held to the
reference's ``tiled_segment_groupby`` stream for stream, winner and
position rows included. The kernel itself is held to the plain version on
the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr.eval import ColV as JColV
from spark_rapids_tpu.ops import groupby as JG
from spark_rapids_tpu.ops import radix_bin as JR
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.values import ColV
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import radix_bin as PR
from spark_rapids_tpu_torch.ops import radix_kernels as RK


@pytest.fixture
def force_tile():
    """Set both packages' FORCE_TILE_ROWS; restored after the test."""
    prev = JR.FORCE_TILE_ROWS, PR.FORCE_TILE_ROWS

    def set_tile(t):
        JR.FORCE_TILE_ROWS = PR.FORCE_TILE_ROWS = t

    try:
        yield set_tile
    finally:
        JR.FORCE_TILE_ROWS, PR.FORCE_TILE_ROWS = prev


def _run(pkg, strategy, key, vals, num_rows, ops):
    """(keys, per aggregate (data, valid)) of the live groups, in the
    package's output order (sorted key order under RADIX)."""
    if pkg == "jax":
        keys = [JColV(jnp.asarray(key), jnp.ones(key.shape[0], jnp.bool_))]
        cols = [None if v is None else JColV(jnp.asarray(v[0]),
                                             jnp.asarray(v[1]))
                for v in vals]
        k, a, n = JG.groupby_agg(keys, [JT.LONG], cols, list(ops), num_rows,
                                 strategy=strategy)
    else:
        keys = [ColV(torch.from_numpy(key),
                     torch.ones(key.shape[0], dtype=torch.bool))]
        cols = [None if v is None else ColV(torch.from_numpy(v[0]),
                                            torch.from_numpy(v[1]))
                for v in vals]
        k, a, n = G.groupby_agg(keys, [T.LONG], cols, list(ops), num_rows,
                                strategy=strategy)
    n = int(n)
    return (np.asarray(k[0].data)[:n],
            [(np.asarray(c.data)[:n], np.asarray(c.validity)[:n])
             for c in a])


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int64) if x.dtype == np.float64 else x.astype(np.int64)


def _assert_same(ref, got, ops, vals, exact_floats=False):
    rk, ra = ref
    gk, ga = got
    np.testing.assert_array_equal(gk, rk)
    for op, v, (rd, rv), (gd, gv) in zip(ops, vals, ra, ga):
        np.testing.assert_array_equal(gv, rv, err_msg=op)
        if op == "sum" and v[0].dtype.kind == "f" and not exact_floats:
            rd, gd = rd[rv], gd[rv]
            nan = np.isnan(rd)
            np.testing.assert_array_equal(np.isnan(gd), nan, err_msg=op)
            np.testing.assert_allclose(gd[~nan], rd[~nan], rtol=1e-12,
                                       atol=0, err_msg=op)
        else:
            # ints, counts and the winner rows' values, bit for bit
            np.testing.assert_array_equal(_bits(gd[gv]), _bits(rd[rv]),
                                          err_msg=op)


def _wraparound():
    n, cap = 700, 1024
    rng = np.random.default_rng(5)
    key = np.zeros(cap, np.int64)
    key[:n] = rng.integers(0, 23, n)
    big = np.zeros(cap, np.int64)
    big[:n] = (1 << 62) + rng.integers(0, 1 << 40, n)
    valid = np.zeros(cap, bool)
    valid[:n] = rng.random(n) > 0.15
    return key, [(big, valid), (big, valid), None], n, [
        "sum", "count", "count_star"]


def _all_null_minmax_first_last():
    n, cap = 500, 1024
    rng = np.random.default_rng(6)
    key = np.zeros(cap, np.int64)
    key[:n] = rng.integers(0, 11, n)
    data = np.zeros(cap, np.int64)
    data[:n] = rng.integers(-(2 ** 62), 2 ** 62, n)
    none = np.zeros(cap, bool)
    some = np.zeros(cap, bool)
    some[:n] = rng.random(n) > 0.5
    return key, [(data, none), (data, some), (data, some), (data, some),
                 (data, none), (data, some), (data, some)], n, [
        "sum", "min", "max", "first", "count", "last_ignorenulls",
        "first_ignorenulls"]


def _float_streams():
    cases = {0: [1.5, -2.25, 3e8], 1: [1e300, 1e300, -2.5e299],
             2: [np.inf, 1.0, 2.0], 3: [-np.inf, -1.0],
             4: [np.inf, -np.inf, 5.0], 5: [np.nan, 1.0],
             6: [1e308, 1e308], 7: [2.0 ** 501, -(2.0 ** 501), 7.0]}
    rows = [(k, v) for k, vs in cases.items() for v in vs]
    n, cap = len(rows), 256
    key = np.zeros(cap, np.int64)
    fval = np.zeros(cap)
    key[:n] = [k for k, _ in rows]
    fval[:n] = [v for _, v in rows]
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return key, [(fval, valid), (fval, valid), (fval, valid),
                 (fval, valid)], n, ["sum", "count", "min", "max"]


def _signed_zeros_and_nan():
    """min/max winners among tied zeros and NaN: the order word folds
    -0.0 into 0.0, so the winner ROW decides the sign."""
    vals = [0.0, -0.0, np.nan, -0.0, 0.0, 3.0, -0.0, -1.0, np.nan, 0.0]
    n, cap = len(vals), 64
    key = np.zeros(cap, np.int64)
    key[:n] = [0, 0, 0, 1, 1, 1, 2, 2, 2, 2]
    fval = np.zeros(cap)
    fval[:n] = vals
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return key, [(fval, valid), (fval, valid), (fval, valid),
                 (fval, valid)], n, ["min", "max", "first", "last"]


def _dead_rows():
    n, cap = 100, 512
    rng = np.random.default_rng(8)
    key = rng.integers(0, 7, cap)
    data = rng.integers(-(2 ** 62), 2 ** 62, cap)
    data[n:] = np.int64(-(2 ** 63))  # would win every min
    valid = np.ones(cap, bool)
    return key, [(data, valid), (data, valid), (data, valid), None], n, [
        "sum", "min", "max", "count_star"]


def _int32_sums():
    """int32 sums wrap mod 2^32 of their mod-2^64 sum, in both."""
    n, cap = 300, 512
    rng = np.random.default_rng(10)
    key = np.zeros(cap, np.int64)
    key[:n] = rng.integers(0, 5, n)
    data = np.zeros(cap, np.int32)
    data[:n] = rng.integers(2 ** 30, 2 ** 31 - 1, n)
    valid = np.zeros(cap, bool)
    valid[:n] = rng.random(n) > 0.1
    return key, [(data, valid), (data, valid), (data, valid)], n, [
        "sum", "min", "max"]


MATRIX = {"int64_wraparound": _wraparound,
          "all_null_minmax_first_last": _all_null_minmax_first_last,
          "float_streams_inf_nan_huge": _float_streams,
          "signed_zeros_and_nan": _signed_zeros_and_nan,
          "dead_rows": _dead_rows,
          "int32_sums": _int32_sums}


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_radix_matrix_matches_reference(case):
    key, vals, n, ops = MATRIX[case]()
    ref = _run("jax", "RADIX", key, vals, n, ops)
    got = _run("torch", "RADIX", key, vals, n, ops)
    _assert_same(ref, got, ops, vals)


def test_radix_magnitude_disparity_is_exact():
    """Reference ``test_radix_agg.py:177-204``: group 0's 1e30 never
    absorbs group 1's 1+2+3, in both packages."""
    cap = 256
    key = np.zeros(cap, np.int64)
    fval = np.zeros(cap)
    rows = [(0, 1e30), (1, 1.0), (1, 2.0), (1, 3.0), (2, -4.5),
            (0, 2.5e30), (3, 1e-20), (3, 2e-20)]
    n = len(rows)
    key[:n] = [k for k, _ in rows]
    fval[:n] = [v for _, v in rows]
    valid = np.zeros(cap, bool)
    valid[:n] = True
    vals = [(fval, valid), (fval, valid)]
    ref = _run("jax", "RADIX", key, vals, n, ["sum", "count"])
    got = _run("torch", "RADIX", key, vals, n, ["sum", "count"])
    _assert_same(ref, got, ["sum", "count"], vals, exact_floats=True)
    sums = dict(zip(got[0].tolist(), got[1][0][0].tolist()))
    assert sums[1] == 6.0 and sums[2] == -4.5
    np.testing.assert_allclose(sums[0], 3.5e30, rtol=1e-12)
    np.testing.assert_allclose(sums[3], 3e-20, rtol=1e-12)


def test_radix_empty_batch():
    cap = 256
    key = np.zeros(cap, np.int64)
    data = np.zeros(cap, np.int64)
    valid = np.zeros(cap, bool)
    for pkg in ("jax", "torch"):
        k, aggs = _run(pkg, "RADIX", key, [(data, valid), None], 0,
                       ["sum", "count_star"])
        assert k.shape[0] == 0, pkg


@pytest.mark.parametrize("tile", [32, 48, 100])
def test_radix_tiling_multi_tile_and_flush(force_tile, tile):
    """Forced tiles put segments across tile boundaries (the carries) and
    run the flush trip; 48 and 100 do not divide the capacity. Max ties
    fall across tiles (a few distinct values per group)."""
    n, cap = 900, 1024
    rng = np.random.default_rng(tile)
    key = np.zeros(cap, np.int64)
    key[:n] = np.sort(rng.integers(0, 9, n))
    data = np.zeros(cap, np.int64)
    data[:n] = rng.integers(-(2 ** 62), 2 ** 62, n)
    ties = np.zeros(cap)
    ties[:n] = rng.choice([0.0, -0.0, 1.0, -1.0], n)
    fval = np.zeros(cap)
    fval[:n] = rng.normal(size=n) * 1e6
    valid = np.zeros(cap, bool)
    valid[:n] = rng.random(n) > 0.2
    vals = [(data, valid), (fval, valid), (data, valid), None,
            (ties, valid), (ties, valid), (data, valid)]
    ops = ["sum", "sum", "min", "count_star", "max", "min", "last"]
    force_tile(tile)
    ref = _run("jax", "RADIX", key, vals, n, ops)
    got = _run("torch", "RADIX", key, vals, n, ops)
    _assert_same(ref, got, ops, vals)


def test_radix_single_group_spanning_every_tile(force_tile):
    n, cap = 1000, 1024
    force_tile(64)
    key = np.zeros(cap, np.int64)
    data = np.ones(cap, np.int64)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    vals = [(data, valid), None]
    ref = _run("jax", "RADIX", key, vals, n, ["sum", "count_star"])
    got = _run("torch", "RADIX", key, vals, n, ["sum", "count_star"])
    _assert_same(ref, got, ["sum", "count_star"], vals)
    assert got[1][0][0].tolist() == [n] and got[1][1][0].tolist() == [n]


def _loop_inputs(n, cap, nseg, seed, pad=0):
    """One sorted order of ``cap`` rows (``n`` live) and its streams'
    columns, followed by ``pad`` more dead rows."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, nseg, n))
    _, seg = np.unique(seg, return_inverse=True)
    dead = 1 << 30  # outside [0, cap) at any capacity here
    seg = np.concatenate([seg, np.full(cap - n + pad, dead)]).astype(np.int32)
    perm = np.concatenate([rng.permutation(cap),
                           np.arange(cap, cap + pad)]).astype(np.int64)
    live = np.zeros(cap + pad, bool)
    live[perm[:n]] = True

    def cols(a):
        return np.concatenate([a, np.zeros(pad, a.dtype)])

    ints = cols(rng.integers(-(2 ** 63), 2 ** 63 - 1, cap, dtype=np.int64))
    words = cols(rng.integers(0, 3, cap).astype(np.int64))  # ties
    fl = rng.normal(size=cap) * 1e3
    fl[rng.random(cap) < 0.05] = 1e301
    fl[rng.random(cap) < 0.02] = -np.inf
    valid = cols(rng.random(cap) > 0.2)
    return seg, perm, live, ints, words, cols(fl), valid


def _loops(n, cap, tile, pad=0):
    """(port's plain streams, the reference's SegmentedOutputs, live
    segments) over one seeded input."""
    seg, perm, live, ints, words, fl, valid = _loop_inputs(n, cap, 11, 3,
                                                           pad)
    t = torch.from_numpy
    streams = [RK.Stream("pos", op="min"), RK.Stream("count"),
               RK.Stream("count", valid=t(valid)),
               RK.Stream("isum", t(ints), t(valid)),
               RK.Stream("fsum", t(fl), t(valid)),
               RK.Stream("pos", None, t(valid), "max"),
               RK.Stream("win", t(words), t(valid), "max"),
               RK.Stream("win", t(words), t(valid), "min")]
    got = RK.segment_reduce_plain(t(perm), t(seg), streams, tile)

    j = jnp.asarray
    jv = j(valid)

    def take(a):
        return lambda tk: tk.take(a)

    adds = [JR.AddSpec(lambda tk: jnp.ones(tk.p_t.shape[0], jnp.uint32),
                       jnp.uint32),
            JR.AddSpec(lambda tk: tk.take(jv).astype(jnp.uint32),
                       jnp.uint32),
            JR.AddSpec(lambda tk: jnp.where(tk.take(jv), tk.take(j(ints)),
                                            0).astype(jnp.uint64),
                       jnp.uint64)]
    for i in range(3):
        adds.append(JR.AddSpec(
            lambda tk, i=i: JR.float_sum_streams(tk.take(j(fl)),
                                                 tk.take(jv))[i],
            jnp.float64 if i < 2 else jnp.uint64, is_or=i == 2))
    pos = [JR.PosSpec(lambda tk: jnp.ones(tk.p_t.shape[0], jnp.bool_),
                      "min"), JR.PosSpec(take(jv), "max")]
    wins = [JR.MinMaxSpec(take(j(words.astype(np.uint64))), take(jv), op)
            for op in ("max", "min")]
    ref = JR.tiled_segment_groupby(j(perm.astype(np.int32)), [j(seg)],
                                   j(live), adds, pos, wins, tile_rows=tile)
    return got, ref, int(seg[:n].max()) + 1


@pytest.mark.parametrize("n,tile", [(180, 8), (176, 24)])
def test_plain_tile_loop_matches_the_references_loop(n, tile):
    """The kernel's plain version (``radix_kernels.segment_reduce_plain``)
    against the reference's ``tiled_segment_groupby`` over the same order
    and segments: every stream of every kind, row for row. Tile 24 does
    not divide the 200 rows; the live rows end before its last tile."""
    got, ref, nseg = _loops(n, 200, tile)
    assert int(ref.nseg) == nseg

    def a(x):
        return np.asarray(x)[:nseg]

    np.testing.assert_array_equal(a(got[0][0]), a(ref.pos_rows[0]))
    np.testing.assert_array_equal(a(got[1][0]), a(ref.u32[0]))
    np.testing.assert_array_equal(a(got[2][0]), a(ref.u32[1]))
    np.testing.assert_array_equal(a(got[3][0]),
                                  a(ref.u64[0]).view(np.int64))
    np.testing.assert_allclose(a(got[4][0]), a(ref.f64[0]), rtol=1e-12)
    np.testing.assert_allclose(a(got[4][1]), a(ref.f64[1]), rtol=1e-12)
    np.testing.assert_array_equal(a(got[4][2]), a(ref.flags[0]))
    np.testing.assert_array_equal(a(got[5][0]), a(ref.pos_rows[1]))
    np.testing.assert_array_equal(a(got[6][0]), a(ref.winner_rows[0]))
    np.testing.assert_array_equal(a(got[7][0]), a(ref.winner_rows[1]))
    # past the segments every output holds its empty value
    assert (np.asarray(got[6][0])[nseg:] == -1).all()
    assert (np.asarray(got[3][0])[nseg:] == 0).all()


def test_combine_float_sum_is_the_references():
    normal = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 1e-300])
    big = np.array([0.0, 1.0, 0.0, 0.0, 1e300, 0.0])
    flags = np.array([0, 0, 1, 3, 2, 4], np.uint8)
    ref = np.asarray(JR.combine_float_sum(jnp.asarray(normal),
                                          jnp.asarray(big),
                                          jnp.asarray(flags)))
    got = PR.combine_float_sum(torch.from_numpy(normal),
                               torch.from_numpy(big),
                               torch.from_numpy(flags)).numpy()
    np.testing.assert_array_equal(got.view(np.int64), ref.view(np.int64))


def test_radix_reduction_on_a_cpu_tensor_launches_nothing():
    """The wrapper takes the plain version for CPU tensors only, and
    counts no launch for it."""
    before = RK.LAUNCHES["radix_segment_reduce"]
    key, vals, n, ops = _wraparound()
    _run("torch", "RADIX", key, vals, n, ops)
    assert RK.LAUNCHES["radix_segment_reduce"] == before


def test_reference_clamps_a_ragged_last_tile():
    """ROADMAP.md §C: the reference slices a tile with
    ``lax.dynamic_slice``, which clamps a ragged last tile back into the
    array, so live rows there are read twice when the tile does not
    divide the capacity (180 live of 200 rows, 24-row tiles: 12 segments
    for 11). The port pads the order: it gives what the reference gives
    for the same rows padded to 216, a capacity the tiles divide."""
    got, ref, nseg = _loops(180, 200, 24)
    assert nseg == 11 and int(ref.nseg) == 12
    _, ref216, _ = _loops(180, 200, 24, pad=16)
    assert int(ref216.nseg) == nseg
    want = [ref216.pos_rows[0], ref216.u32[0], ref216.u32[1],
            np.asarray(ref216.u64[0]).view(np.int64),
            ref216.f64[0], ref216.pos_rows[1], ref216.winner_rows[0],
            ref216.winner_rows[1]]
    for g, w in zip([o[0] for o in got], want):
        np.testing.assert_allclose(np.asarray(g)[:nseg],
                                   np.asarray(w)[:nseg], rtol=1e-12)


def test_bytes_bound_counts_each_shared_input_once():
    """The kernel's bytes bound reads each distinct column and validity
    once, at the live rows only: an aggregate's count and its sum share
    a validity, and two sums of one column share it."""
    n, nlive = 1000, 900
    perm = torch.arange(n, dtype=torch.int64)
    valid = torch.ones(n, dtype=torch.bool)
    x = torch.zeros(n, dtype=torch.float64)
    streams = [RK.Stream("count", valid=valid), RK.Stream("fsum", x, valid),
               RK.Stream("fsum", x, valid),
               RK.Stream("fsum", x.clone(), valid)]
    assert len(RK.distinct_inputs(streams)) == 3
    outs = 2 * (8 + 3 * 17)  # two segments: a count and three sums
    assert RK.bound_bytes(perm, streams, nlive, 2) == (
        nlive * (8 + 4) + nlive * (1 + 8 + 8) + outs)


def test_packed_arguments_hold_each_shared_input_once():
    """The kernel's argument packing, without a card: the distinct-input
    table holds each shared tensor once (a count and a sum read one
    validity, a sum and an avg one column), each stream's indices point
    at its own data and validity, streams without either get the 'none'
    index, and a dtype the kernel does not read is converted once."""
    n = 64
    rng = np.random.default_rng(3)
    valid = torch.from_numpy(rng.random(n) > 0.2)
    other = torch.from_numpy(rng.random(n) > 0.5)
    x = torch.from_numpy(rng.normal(size=n))
    i16 = torch.from_numpy(rng.integers(-9, 9, n).astype(np.int16))
    words = torch.from_numpy(rng.integers(0, 1 << 40, n))
    streams = [RK.Stream("pos", op="min"),
               RK.Stream("count", valid=valid), RK.Stream("fsum", x, valid),
               RK.Stream("count", valid=other), RK.Stream("fsum", x, other),
               RK.Stream("isum", i16, valid), RK.Stream("isum", i16, other),
               RK.Stream("win", words, valid, "max"),
               RK.Stream("pos", None, other, "max"), RK.Stream("count")]
    packed = RK.pack_arguments(streams, n, torch.device("cpu"))
    assert len(packed.sargs) == 4 * len(streams)
    ptrs = [t.data_ptr() for t in packed.inputs]
    assert len(set(ptrs)) == len(ptrs) == 5
    kinds = {"count": 0, "isum": 1, "fsum": 2, "pos": 3, "win": 4}
    for i, s in enumerate(streams):
        kind, is_min, di, vi = packed.sargs[4 * i:4 * i + 4]
        assert kind == kinds[s.kind] and is_min == int(s.op == "min")
        for t, j in ((s.data, di), (s.valid, vi)):
            if t is None:
                assert j == RK.NONE
            else:
                got = packed.inputs[j]
                assert torch.equal(got, t.to(got.dtype))
                if t.dtype == got.dtype:
                    assert got.data_ptr() == t.data_ptr()
    # the int16 column is converted once, to int64, for both of its sums
    assert packed.sargs[4 * 5 + 2] == packed.sargs[4 * 6 + 2]
    assert packed.inputs[packed.sargs[4 * 5 + 2]].dtype == torch.int64
    with pytest.raises(ValueError, match="for 64 rows"):
        RK.pack_arguments([RK.Stream("count", valid=valid[:10])], n,
                          torch.device("cpu"))


def test_output_rows_are_where_the_kernel_writes():
    """The wrapper's outputs, without a card: each stream's tensors are
    rows of one allocation, of its kind's dtypes, and the addresses the
    kernel is handed are those rows' (three a stream, 0 where a kind
    has fewer), so the kernel's writes land in the tensors returned."""
    cap = 37
    kinds = ["pos", "count", "fsum", "isum", "fsum", "win", "count", "pos"]
    streams = [RK.Stream(k) for k in kinds]
    outs, addrs = RK._outputs(streams, cap, torch.device("cpu"))
    dtypes = {"count": [torch.int64], "isum": [torch.int64],
              "fsum": [torch.float64, torch.float64, torch.uint8],
              "pos": [torch.int32], "win": [torch.int32]}
    assert len(addrs) == 3 * len(kinds)
    seen = set()
    for i, (k, out) in enumerate(zip(kinds, outs)):
        assert [t.dtype for t in out] == dtypes[k]
        assert all(t.shape == (cap,) and t.is_contiguous() for t in out)
        want = [t.data_ptr() for t in out] + [0] * (3 - len(out))
        assert addrs[3 * i:3 * i + 3] == want
        for t in out:
            assert t.data_ptr() % t.element_size() == 0
            seen.update(range(t.data_ptr(), t.data_ptr() + t.nbytes))
    # the rows do not overlap and fill the allocation
    assert len(seen) == sum(t.nbytes for out in outs for t in out)
