"""The probe kernel K4's plain version against the reference's Pallas
kernel, on the CPU.

On CPU tensors ``spark_rapids_tpu_torch.ops.join_kernels.probe_ranges``
runs its plain PyTorch version; the reference runs
``pallas_probe_ranges`` in interpret mode. The (lo, hi) ranges must match
bit for bit, unmatched and dead rows (0, 0) included. The CUDA kernel
itself runs only on a card (``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py`` hold it against this plain version there). Shapes stay
near 300 x 200: interpret mode costs about 3 s at 1000 x 600 here.
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu.ops.pallas_join import pallas_probe_ranges
from spark_rapids_tpu_torch.ops import join_kernels as K


def _inputs(seed, m, nb, bcount, nwords, dead=0.1, card=40):
    """Sorted packed-key build prefix [0, bcount) with duplicates and
    garbage past it; probe keys partly absent; ``dead`` probe rows dead."""
    rng = np.random.default_rng(seed)
    bws = [rng.integers(0, card, nb).astype(np.uint32)]
    pws = [rng.integers(0, card + 15, m).astype(np.uint32)]
    if nwords == 2:
        bws.append(rng.integers(0, 3, nb).astype(np.uint32))
        pws.append(rng.integers(0, 3, m).astype(np.uint32))
    order = np.lexsort(tuple(w[:bcount] for w in reversed(bws)))
    for w in bws:
        w[:bcount] = w[:bcount][order]
    live = rng.random(m) >= dead
    return bws, bcount, pws, live


def _run_inputs(seed, m, nb, bcount, nwords, top_bit, dead=0.1):
    """A build whose sorted prefix holds runs of duplicates that straddle
    the power-of-two row boundaries (4, 8, 16, ...), some as long as 40
    rows; with ``top_bit`` the keys' high word has its top bit set
    (unsigned order above 2^31)."""
    rng = np.random.default_rng(seed)
    runs, k = [], 0
    while len(runs) < bcount:
        start = len(runs)
        nxt = 1 << max(2, start.bit_length())  # the next power of two
        run = max(1, nxt - start + int(rng.integers(0, 3))) if (
            rng.random() < 0.3) else int(rng.integers(1, 4))
        runs += [k] * min(run, 40)
        k += int(rng.integers(1, 3))
    hi = np.array(runs[:bcount], dtype=np.int64)
    bws = [np.concatenate([hi, rng.integers(0, k + 5, nb - bcount)])]
    pws = [rng.integers(-1, k + 3, m)]
    if top_bit:
        bws[0] = bws[0] + 2**31
        pws[0] = pws[0] + 2**31
    if nwords == 2:  # a low word constant within a run keeps the order
        bws.append(np.where(np.arange(nb) < bcount, 7, 3))
        pws.append(np.where(rng.random(m) < 0.8, 7, 3))
    bws = [w.astype(np.uint32) for w in bws]
    pws = [w.astype(np.uint32) for w in pws]
    live = rng.random(m) >= dead
    return bws, bcount, pws, live


CASES = {
    # name: (seed, m, nb, bcount, words, dead probe share)
    "one_word_dups": (1, 300, 200, 200, 1, 0.1),
    "two_words_dups": (2, 300, 200, 150, 2, 0.1),
    "ragged": (3, 257, 131, 97, 2, 0.2),
    "build_count_0": (4, 300, 200, 0, 1, 0.1),
    "all_dead": (5, 300, 200, 180, 2, 1.0),
    "one_build_row": (6, 9, 1, 1, 1, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_probe_matches_pallas_interpret(case):
    seed, m, nb, bcount, nwords, dead = CASES[case]
    bws, bc, pws, live = _inputs(seed, m, nb, bcount, nwords, dead)
    rlo, rhi = pallas_probe_ranges(
        [jnp.asarray(w) for w in bws], jnp.int32(bc),
        [jnp.asarray(w) for w in pws], jnp.asarray(live))
    before = K.LAUNCHES["probe_ranges"]
    lo, hi = K.probe_ranges(
        [torch.from_numpy(w.astype(np.int64)) for w in bws], bc,
        [torch.from_numpy(w.astype(np.int64)) for w in pws],
        torch.from_numpy(live))
    assert K.LAUNCHES["probe_ranges"] == before  # CPU: no kernel launch
    np.testing.assert_array_equal(np.asarray(rlo), lo.numpy())
    np.testing.assert_array_equal(np.asarray(rhi), hi.numpy())
    assert lo.dtype == hi.dtype == torch.int32
    if dead == 1.0 or bcount == 0:
        assert not bool(hi.any())


@pytest.mark.parametrize("top_bit", [False, True])
@pytest.mark.parametrize("nwords", [1, 2])
@pytest.mark.parametrize("bcount", [3, 4, 5, 17, 64, 129])
def test_plain_probe_runs_across_power_of_two_boundaries(bcount, nwords,
                                                         top_bit):
    bws, bc, pws, live = _run_inputs(bcount, 211, 150, bcount, nwords,
                                     top_bit)
    rlo, rhi = pallas_probe_ranges(
        [jnp.asarray(w) for w in bws], jnp.int32(bc),
        [jnp.asarray(w) for w in pws], jnp.asarray(live))
    lo, hi = K.probe_ranges(
        [torch.from_numpy(w.astype(np.int64)) for w in bws], bc,
        [torch.from_numpy(w.astype(np.int64)) for w in pws],
        torch.from_numpy(live))
    np.testing.assert_array_equal(np.asarray(rlo), lo.numpy())
    np.testing.assert_array_equal(np.asarray(rhi), hi.numpy())
    assert bool((hi - lo > 1).any())  # some probe meets a run


NBS = (0, 1, 2, 3, 4, 5, 8, 9, 1000, 32_767, 32_768, 32_769, 65536,
       100_000, 131_072, 232_449, 1 << 20, (1 << 22) + 7)


@pytest.mark.parametrize("nb", NBS)
def test_probe_plan_fits_one_block(nb):
    """K4's bucket index: 2^r buckets, r in [1, 15], as many as there are
    build rows (next power of two) up to 2^15, and 2^r + 1 u32 bounds
    within what one H100 block may hold."""
    r = K.plan_probe(nb)
    assert 1 <= r <= K.MAX_LOG2_BUCKETS
    assert K.probe_index_bytes(r) <= K.BLOCK_SMEM
    assert (1 << r) >= nb or r == K.MAX_LOG2_BUCKETS
    assert r == 1 or (1 << (r - 1)) < nb


def test_probe_plan_of_the_main_path_shapes():
    # the bench join's build (cap 2^17) and Q8's (2^16): 2^15 buckets, a
    # 128 KB index, about three rows of dense keys a bucket
    assert K.plan_probe(1 << 17) == K.plan_probe(1 << 16) == 15
    assert K.probe_index_bytes(15) == 131_076
    # a smaller budget takes fewer buckets
    assert K.plan_probe(1 << 17, budget=1 << 12) == 9


def test_plain_probe_chunks_agree_with_one_pass(monkeypatch):
    bws, bc, pws, live = _inputs(7, 300, 200, 170, 2)
    args = ([torch.from_numpy(w.astype(np.int64)) for w in bws], bc,
            [torch.from_numpy(w.astype(np.int64)) for w in pws],
            torch.from_numpy(live))
    whole = K.probe_ranges_plain(*args)
    monkeypatch.setattr(K, "PLAIN_CHUNK_ELEMS", 7 * 200)  # 7-row chunks
    chunked = K.probe_ranges_plain(*args)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_wrapper_rejects_mismatched_word_counts():
    w = torch.zeros(4, dtype=torch.int64)
    live = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="1 or 2 key words"):
        K.probe_ranges([w, w, w], 4, [w, w, w], live)
    with pytest.raises(ValueError, match="1 or 2 key words"):
        K.probe_ranges([w], 4, [w, w], live)
