"""The port's join ops (``spark_rapids_tpu_torch/ops/join.py``) against the
reference's ``spark_rapids_tpu/ops/join.py``, tier by tier, on the CPU.

Inputs are made by numpy from a seed and handed to both engines: the
reference's u32 key words as uint32 arrays, the port's as int64 tensors
holding the same values. Every range, plan slot, mask and word must match
bit for bit — each tier against the reference's SAME tier, since the
tiers differ on unmatched rows (SEARCH and RADIX report the insertion
point, DIRECT and PALLAS (0, 0)). Builds are sorted over their joinable
prefix with garbage past the count, as the join exec sorts them.
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr.eval import ColV as JColV
from spark_rapids_tpu.ops import join as RJ
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.values import ColV
from spark_rapids_tpu_torch.ops import join as J


def _sorted_build(rng, nb, bcount, nwords, lo_card=50):
    """Build words with a lexicographically sorted joinable prefix and
    garbage beyond it (tests/test_join_strategies.py ``_sorted_build``)."""
    ws = [rng.integers(0, lo_card, nb).astype(np.uint32)]
    for _ in range(nwords - 1):
        ws.append(rng.integers(0, 3, nb).astype(np.uint32))
    order = np.lexsort(tuple(w[:bcount] for w in reversed(ws)))
    for w in ws:
        w[:bcount] = w[:bcount][order]
    return ws


#: ragged sizes, fixed so the reference's eager ops compile once
NB, M = 200, 300


def _case(seed, nwords, lo_card=50, bcount=None):
    rng = np.random.default_rng(seed)
    nb, m = NB, M
    if bcount is None:
        bcount = int(rng.integers(1, nb + 1))
    bws = _sorted_build(rng, nb, bcount, nwords, lo_card)
    pws = [rng.integers(0, lo_card + 20, m).astype(np.uint32)] + [
        rng.integers(0, 3, m).astype(np.uint32) for _ in range(nwords - 1)]
    live = rng.random(m) < 0.8
    return bws, bcount, pws, live


def _ref_args(bws, bcount, pws, live):
    return ([jnp.asarray(w) for w in bws], jnp.int32(bcount),
            [jnp.asarray(w) for w in pws], jnp.asarray(live))


def _port_args(bws, bcount, pws, live):
    return ([torch.from_numpy(w.astype(np.int64)) for w in bws], bcount,
            [torch.from_numpy(w.astype(np.int64)) for w in pws],
            torch.from_numpy(live))


def _eq(ref, got, what):
    np.testing.assert_array_equal(np.asarray(ref), got.numpy(),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# key words
# ---------------------------------------------------------------------------
def _key_columns():
    rng = np.random.default_rng(5)
    n = 200
    i32 = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    i64 = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    f64 = rng.normal(size=n) * 1e6
    f64[::7] = np.nan
    f64[1::7] = -0.0
    f64[2::7] = 0.0
    f64[3::11] = np.inf
    f64[4::11] = -np.inf
    valid = [rng.random(n) < 0.85 for _ in range(3)]
    return [("int", JT.INT, T.INT, i32, valid[0]),
            ("long", JT.LONG, T.LONG, i64, valid[1]),
            ("double", JT.DOUBLE, T.DOUBLE, f64, valid[2])]


@pytest.mark.parametrize("combo", ["int", "long", "double",
                                   "int+double+long"])
def test_radix_key_words_match_reference(combo):
    cols = {c[0]: c for c in _key_columns()}
    chosen = [cols[name] for name in combo.split("+")]
    ref_words, ref_null = RJ.radix_key_words(
        [JColV(jnp.asarray(d), jnp.asarray(v)) for _, _, _, d, v in chosen],
        [jt for _, jt, _, _, _ in chosen])
    words, any_null = J.radix_key_words(
        [ColV(torch.from_numpy(d), torch.from_numpy(v))
         for _, _, _, d, v in chosen], [pt for _, _, pt, _, _ in chosen])
    assert len(words) == len(ref_words)
    for i, (rw, w) in enumerate(zip(ref_words, words)):
        assert w.dtype == torch.int64
        _eq(np.asarray(rw).astype(np.int64), w, f"word {i}")
    _eq(ref_null, any_null, "any_null")


def test_nan_and_signed_zero_keys_share_words():
    d = np.array([np.nan, -np.nan, 0.0, -0.0, 1.5], np.float64)
    words, _ = J.radix_key_words(
        [ColV(torch.from_numpy(d), torch.ones(5, dtype=torch.bool))],
        [T.DOUBLE])
    packed = J.pack_key(words).tolist()
    assert packed[0] == packed[1] and packed[2] == packed[3]
    assert len(set(packed)) == 3


# ---------------------------------------------------------------------------
# probe ranges, tier by tier
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tier", ["SEARCH", "DIRECT", "RADIX"])
@pytest.mark.parametrize("nwords", [1, 2, 3])
def test_probe_ranges_match_reference_tier(tier, nwords):
    for seed, bcount in ((0, None), (1, 0)):
        args = _case(100 * nwords + seed, nwords, bcount=bcount)
        rlo, rhi = RJ.probe_ranges(*_ref_args(*args), strategy=tier)
        lo, hi = J.probe_ranges(*_port_args(*args), strategy=tier)
        _eq(rlo, lo, f"{tier} seed {seed} lo")
        _eq(rhi, hi, f"{tier} seed {seed} hi")


def test_direct_tier_wide_key_range_takes_the_search():
    """Keys spread over the whole u32 range do not fit 4x the build: the
    reference's lax.cond (here a host decision) takes the binary search,
    whose unmatched rows report insertion points."""
    args = _case(7, 1, lo_card=2**32 - 1)
    rlo, rhi = RJ.probe_ranges(*_ref_args(*args), strategy="DIRECT")
    lo, hi = J.probe_ranges(*_port_args(*args), strategy="DIRECT")
    _eq(rlo, lo, "lo")
    _eq(rhi, hi, "hi")
    slo, _ = J.probe_ranges(*_port_args(*args), strategy="SEARCH")
    assert torch.equal(lo, slo)


@pytest.mark.parametrize("nwords", [1, 2, 3])
def test_radix_probe_ranges_variants_match_reference(nwords):
    for seed in range(1):
        args = _case(300 + 10 * nwords + seed, nwords)
        for kw in ({}, {"want_matched": True}, {"lo_matched_only": True}):
            ref = RJ.radix_probe_ranges(*_ref_args(*args), **kw)
            got = J.radix_probe_ranges(*_port_args(*args), **kw)
            for i, (r, g) in enumerate(zip(ref, got)):
                if r is None:
                    assert g is None
                else:
                    _eq(r, g, f"seed {seed} {kw} output {i}")


def test_search_radix_insertion_points_vs_direct_zeros():
    """The tiers' conventions differ on unmatched live rows only."""
    args = _case(11, 1)
    live = args[3]
    out = {t: J.probe_ranges(*_port_args(*args), strategy=t)
           for t in ("SEARCH", "DIRECT", "RADIX", "PALLAS")}
    cnt = out["SEARCH"][1] - out["SEARCH"][0]
    for t, (lo, hi) in out.items():
        assert torch.equal(hi - lo, cnt), t
        assert torch.equal(lo[cnt > 0], out["SEARCH"][0][cnt > 0]), t
    unmatched = torch.from_numpy(live) & (cnt == 0)
    assert bool(unmatched.any())
    assert torch.equal(out["SEARCH"][0], out["RADIX"][0])
    assert bool((out["DIRECT"][0][unmatched] == 0).all())
    assert bool((out["PALLAS"][0][unmatched] == 0).all())


# ---------------------------------------------------------------------------
# expansion plans and the matched-build mask
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plan", ["expansion_plan", "radix_expansion_plan"])
def test_expansion_plans_match_reference_on_every_slot(plan):
    rng = np.random.default_rng(9)
    for trial in range(2):
        m = M
        counts = rng.integers(0, 4, m).astype(np.int32)
        if trial % 2:
            counts[-5:] = 0  # trailing rows without matches
        lo = np.cumsum(rng.integers(0, 3, m)).astype(np.int32)
        out_cap = 1024
        ref = getattr(RJ, plan)(jnp.asarray(counts), jnp.asarray(lo),
                                out_cap)
        got = getattr(J, plan)(torch.from_numpy(counts),
                               torch.from_numpy(lo), out_cap)
        for i, (r, g) in enumerate(zip(ref, got)):
            _eq(r, g, f"trial {trial} output {i}")


def test_matched_build_mask_matches_reference():
    for seed in range(2):
        bws, bcount, pws, live = _case(500 + seed, 2)
        rlo, rhi = RJ._probe_binary_search(*_ref_args(bws, bcount, pws,
                                                      live))
        nb = bws[0].shape[0]
        ref = RJ.matched_build_mask(rlo, rhi, jnp.asarray(live), nb)
        got = J.matched_build_mask(
            torch.from_numpy(np.array(rlo)), torch.from_numpy(np.array(rhi)),
            torch.from_numpy(live), nb)
        _eq(ref, got, f"seed {seed}")


def test_string_keys_raise_naming_the_roadmap_item():
    """String join keys are ported: with its byte bound a string key
    gives the reference's chunk words and raises nothing naming a roadmap
    item; without one it raises, naming the bound it needs (the wider
    string cases are in ``test_torch_string_join.py``)."""
    from spark_rapids_tpu.expr.eval import StrV as JStrV
    from spark_rapids_tpu_torch.expr.values import StrV

    strs = [b"", b"a", b"a\x00", b"abcde", b"\xc3\xa9t\xc3\xa9"]
    off = np.concatenate([[0], np.cumsum([len(s) for s in strs])]).astype(
        np.int32)
    chars = np.frombuffer(b"".join(strs), np.uint8).copy()
    valid = np.array([True, True, False, True, True])
    ref, rnull = RJ.radix_key_words(
        [JStrV(jnp.asarray(off), jnp.asarray(chars), jnp.asarray(valid))],
        [JT.STRING], (8,))
    col = StrV(torch.from_numpy(off), torch.from_numpy(chars),
               torch.from_numpy(valid))
    words, any_null = J.radix_key_words([col], [T.STRING], (8,))
    assert len(words) == len(ref) == 2
    for i, (rw, w) in enumerate(zip(ref, words)):
        _eq(np.asarray(rw).astype(np.int64), w, f"word {i}")
    _eq(rnull, any_null, "any_null")
    with pytest.raises(ValueError, match="str_max_lens") as err:
        J.radix_key_words([col], [T.STRING])
    assert "queue A" not in str(err.value)


def test_packed_columns_match_reference_and_round_trip():
    """The fused fast paths' packed build rows (``ops/filter_gather``):
    the same int32 matrix as the reference's, and back."""
    from spark_rapids_tpu.ops import filter_gather as RFG
    from spark_rapids_tpu_torch.ops import filter_gather as FG

    rng = np.random.default_rng(13)
    n = 300
    datas = [rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
             rng.normal(size=n).astype(np.float32),
             rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
             rng.integers(-100, 100, n).astype(np.int16),
             rng.random(n) < 0.5]
    valids = [rng.random(n) < 0.8 for _ in datas]
    datas = [np.where(v, d, np.zeros(1, d.dtype)) for d, v in zip(datas,
                                                                  valids)]
    ref = RFG.pack_fixed_cols([JColV(jnp.asarray(d), jnp.asarray(v))
                               for d, v in zip(datas, valids)])
    cols = [ColV(torch.from_numpy(d), torch.from_numpy(v))
            for d, v in zip(datas, valids)]
    mat = FG.pack_fixed_cols(cols)
    _eq(ref, mat, "packed matrix")
    assert not FG.packable_dtype(torch.float64)
    back = FG.unpack_fixed_cols(mat, [c.data.dtype for c in cols],
                                torch.ones(n, dtype=torch.bool))
    for c, b in zip(cols, back):
        assert torch.equal(c.data, b.data) and torch.equal(c.validity,
                                                           b.validity)
