"""The port's regex engine against the reference's ``ops/regex.py``.

The host compiler is the reference's, copied: the same patterns give the
same packed DFA tables, and the same patterns are refused. The row
matcher's plain version (what the CUDA kernel is held to on the card)
must equal the reference's associative scan bit for bit over random
UTF-8 rows with ``'\\n'`` endings, empty and null rows, offsets that
start mid-pool and pools padded past their last offset. The kernel
itself runs only on a card: ``tests/test_torch_cuda_kernels.py`` holds
it to this plain version there.
"""
import re

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu.ops import regex as JRX
from spark_rapids_tpu_torch.ops import regex as RX
from spark_rapids_tpu_torch.ops import regex_kernels as K

#: compiled by both, plus patterns both refuse
PATTERNS = [
    "^[a-z]+ [0-9]", "^[a-z]+ (sly|furious)", "ts$", "s\\.$", "a$", "^$",
    "[^ -~]", "é.", "(ab|c)+x?", "x{2,3}", "\\s\\S", ".$", "b\\d+$",
    "[^a-z]", "colou?r", "^a.c$", "\\w+@", "[0-9]{2}-", "日本",
]
REFUSED = [
    "special.*requests", "a.*b.*c.*d", "(?i)abc", "a*?", "a\\bb",
    "[é]", "x{9}", "a^b", "a$b", "(?=a)", "[", "a{2", "\\",
]


@pytest.mark.parametrize("pat", PATTERNS + REFUSED)
def test_compile_search_dfa_matches_the_reference(pat):
    try:
        ref = JRX.compile_search_dfa(pat)
    except JRX.RegexUnsupported:
        with pytest.raises(RX.RegexUnsupported):
            RX.compile_search_dfa(pat)
        assert pat in REFUSED
        return
    assert pat in PATTERNS
    got = RX.compile_search_dfa(pat)
    np.testing.assert_array_equal(got.lut_lo, ref.lut_lo)
    np.testing.assert_array_equal(got.lut_hi, ref.lut_hi)
    assert (got.nstates, got.accept_mask, got.start_accept,
            got.absorbing) == (ref.nstates, ref.accept_mask,
                               ref.start_accept, ref.absorbing)


@pytest.mark.parametrize("pat", ["abc", "a\\.b", "a.b", "x+", "\\d", "",
                                 "\\$5", "[a]", "a\\"])
def test_regex_as_literal_matches_the_reference(pat):
    assert RX.regex_as_literal(pat) == JRX.regex_as_literal(pat)


ALPHABET = ["a", "b", "c", "s", "t", "x", "1", "9", " ", "\n", ".", "-",
            "é", "日", "sly", "furious", "ab", "colour"]


def _rows(seed: int, n: int):
    rng = np.random.default_rng(seed)
    rows = ["".join(rng.choice(ALPHABET, int(rng.integers(0, 7))))
            for _ in range(n)]
    for i in range(0, n, 9):
        rows[i] = rows[i] + "\n"
    rows[1] = "\n"
    valid = rng.random(n) > 0.15
    return rows, valid


def _planes(rows, valid, head: bytes = b"", tail: bytes = b""):
    bs = [r.encode("utf-8") for r in rows]
    lens = np.array([len(b) for b in bs], np.int64)
    off = (len(head) + np.concatenate([[0], np.cumsum(lens)])).astype(
        np.int32)
    pool = np.frombuffer(head + b"".join(bs) + tail, np.uint8).copy()
    if pool.size == 0:
        pool = np.zeros(1, np.uint8)
    return off, pool, np.asarray(valid)


#: (head, tail) around the rows' bytes: none, or a sliced column's earlier
#: bytes and garbage past its last offset. Every case uses the same rows,
#: so the reference's eager scan compiles once per layout.
LAYOUTS = {"exact": (b"", b""),
           "mid_pool_padded": (b"xs\nts", b"ts\nzz sly" * 3)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("pat", PATTERNS)
def test_plain_row_matcher_matches_the_reference(pat, layout):
    rows, valid = _rows(7, 120)
    off, pool, val = _planes(rows, valid, *LAYOUTS[layout])
    ref_dfa = JRX.compile_search_dfa(pat)
    ref = np.asarray(JRX.dfa_accept_rows(jnp.asarray(off), jnp.asarray(pool),
                                         jnp.asarray(val), ref_dfa))
    got = RX.dfa_accept_rows(torch.from_numpy(off), torch.from_numpy(pool),
                             torch.from_numpy(val),
                             RX.compile_search_dfa(pat))
    np.testing.assert_array_equal(got.numpy(), ref)
    # and Java's find semantics for the subset, which ``re`` shares
    # ('.' excludes only '\n' and '\r' in both)
    oracle = [bool(v) and re.search(pat, r) is not None
              for r, v in zip(rows, valid)]
    assert got.tolist() == oracle


def test_sliced_offsets_read_only_their_rows():
    """A slice of a column (its offsets start mid-pool) gives the rows of
    the whole column's answer."""
    rows, valid = _rows(3, 200)
    off, pool, val = _planes(rows, valid, b"ts", b"sly ts")
    d = RX.compile_search_dfa("ts$")
    whole = RX.dfa_accept_rows(torch.from_numpy(off), torch.from_numpy(pool),
                               torch.from_numpy(val), d)
    part = RX.dfa_accept_rows(torch.from_numpy(off[57:]),
                              torch.from_numpy(pool),
                              torch.from_numpy(val[57:]), d)
    assert torch.equal(part, whole[57:])


def test_empty_column_and_checks():
    d = RX.compile_search_dfa("a$")
    out = RX.dfa_accept_rows(torch.zeros(1, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.uint8),
                             torch.zeros(0, dtype=torch.bool), d)
    assert out.shape == (0,)
    with pytest.raises(ValueError, match="int32 offsets"):
        RX.dfa_accept_rows(torch.zeros(2, dtype=torch.int64),
                           torch.zeros(1, dtype=torch.uint8),
                           torch.zeros(1, dtype=torch.bool), d)


def test_transition_table_unpacks_the_packed_luts():
    d = RX.compile_search_dfa("^[a-z]+ (sly|furious)")
    tbl = K.transition_table(d)
    for b in (0, ord("a"), ord(" "), 0xC3, 255):
        for s in range(16):
            word = d.lut_lo[b] if s < 8 else d.lut_hi[b]
            assert tbl[b, s] == (int(word) >> (4 * (s % 8))) & 15


def test_regex_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from spark_rapids_tpu_torch.ops import _cuda_build

    monkeypatch.setattr(K, "_LIB", None)
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build_kernels()
