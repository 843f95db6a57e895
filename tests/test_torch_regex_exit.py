"""Where the regex row matcher's walk may stop, against the reference.

The kernel stops a row's walk once its state is a stop state
(``regex_kernels.stop_states``): a dead state (no accept, every byte leads
back to it) or, in an absorbing DFA, an accepting state. These tests hold
the dead-state mask to the transition table for every pattern the tests
and ``chip_smoke.py`` use, and the plain exit helper (``dfa_exit_plain``,
which counts the bytes a walk must read for the kernel's walked-bytes
bound) to the full walk and to the reference's ``dfa_accept_rows``.
"""
import re

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

import chip_smoke
from spark_rapids_tpu.ops import regex as JRX
from spark_rapids_tpu_torch.ops import regex as RX
from spark_rapids_tpu_torch.ops import regex_kernels as K
from test_torch_cuda_kernels import DFA_EDGE_PATTERNS, DFA_PATTERNS
from test_torch_regex import LAYOUTS, PATTERNS, _planes, _rows

ALL_PATTERNS = sorted(set(PATTERNS) | set(DFA_PATTERNS)
                      | set(DFA_EDGE_PATTERNS) | {chip_smoke.Q22D_REGEX}
                      | set(chip_smoke.DFA_PATTERNS))


def _stops_by_walk(d, rows, valid):
    """Per row, a byte at a time in Python: the bytes stepped up to the
    first stop state (the length if none), and the full walk's verdict."""
    tbl = K.transition_table(d)
    stop = K.stop_states(d)
    steps, verdicts = [], []
    for r, v in zip(rows, valid):
        bs = r.encode("utf-8")
        st, prev, n = 0, 0, len(bs)
        for j, b in enumerate(bs):
            prev, st = st, int(tbl[b, st])
            if (stop >> st) & 1 and n == len(bs):
                n = j + 1
        acc = bool((d.accept_mask >> st) & 1)
        if not d.absorbing and bs.endswith(b"\n"):
            acc |= bool((d.accept_mask >> prev) & 1)
        steps.append(n if v else 0)
        verdicts.append(bool(v) and (acc if bs else d.start_accept))
    return steps, verdicts


@pytest.mark.parametrize("pat", ALL_PATTERNS)
def test_dead_states_match_the_transition_table(pat):
    d = RX.compile_search_dfa(pat)
    tbl = K.transition_table(d)
    want = 0
    for s in range(d.nstates):
        if not (d.accept_mask >> s) & 1 and (tbl[:, s] == s).all():
            want |= 1 << s
    assert K.dead_states(d) == want
    stop = K.stop_states(d)
    assert stop == want | (d.accept_mask if d.absorbing else 0)
    # no byte leads out of the stop states, so a walk may stop in one
    for s in range(d.nstates):
        if (stop >> s) & 1:
            assert all((stop >> int(t)) & 1 for t in tbl[:, s])
    if pat.startswith("^"):
        assert want, f"{pat!r}: an anchored pattern has a dead state"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("pat", ALL_PATTERNS)
def test_exit_verdict_equals_the_full_walk_and_the_reference(pat, layout):
    """Seeded UTF-8 rows with '\\n' endings, empty and null rows: the exit
    helper's verdict equals the full walk's (the plain version's) and the
    reference's, and its steps a byte-at-a-time walk's."""
    rows, valid = _rows(7, 120)
    off, pool, val = _planes(rows, valid, *LAYOUTS[layout])
    d = RX.compile_search_dfa(pat)
    ref = np.asarray(JRX.dfa_accept_rows(
        jnp.asarray(off), jnp.asarray(pool), jnp.asarray(val),
        JRX.compile_search_dfa(pat)))
    t = [torch.from_numpy(a) for a in (off, pool, val)]
    steps, verdict = K.dfa_exit_plain(*t, d)
    np.testing.assert_array_equal(verdict.numpy(), ref)
    np.testing.assert_array_equal(K.dfa_accept_rows_plain(*t, d).numpy(),
                                  ref)
    want_steps, want_verdicts = _stops_by_walk(d, rows, valid)
    assert steps.tolist() == want_steps
    assert verdict.tolist() == want_verdicts


@pytest.mark.parametrize("pat,row,stop_at,accepts", [
    ("^ab$", "abx\n", 3, False),   # dead at 'x': '$' cannot revive it
    ("^ab$", "ab\n", 3, True),     # dead on the final '\n', after an accept
    ("^a$", "a\n", 2, True),
    ("^$", "\n", 1, True),
    ("^$", "x\n", 1, False),
    ("^ab$", "ba", 1, False),
    ("^[a-z]+ (sly|furious)", "ab sly x", 6, True),
    ("^[a-z]+ (sly|furious)", "ab slow x", 6, False),
    ("s$", "ss\n", 3, True),       # no stop state: the whole row
])
def test_a_dead_state_before_the_last_byte_rejects(pat, row, stop_at,
                                                   accepts):
    """A non-absorbing DFA's dead state reached before the last byte
    rejects, as the full walk does ('$' cannot leave it); reached on a
    final '\\n', the state before that byte decides (Java's '$')."""
    d = RX.compile_search_dfa(pat)
    bs = row.encode()
    t = (torch.tensor([0, len(bs)], dtype=torch.int32),
         torch.frombuffer(bytearray(bs), dtype=torch.uint8),
         torch.ones(1, dtype=torch.bool))
    steps, verdict = K.dfa_exit_plain(*t, d)
    assert (int(steps[0]), bool(verdict[0])) == (stop_at, accepts)
    assert bool(K.dfa_accept_rows_plain(*t, d)[0]) == accepts
    assert (re.search(pat, row) is not None) == accepts


def test_exit_steps_on_tpch_comments():
    """Q22d's pattern over dbgen-like comments stops most rows after their
    first word; the walked bytes equal a byte-at-a-time walk's."""
    tt = chip_smoke.tpch_orders_customers(np, 1 << 11)
    chars = chip_smoke.comment_chars(torch, tt, torch.device("cpu"))
    off = torch.from_numpy(tt["offsets"].astype(np.int32))
    n = tt["n"]
    valid = torch.ones(n, dtype=torch.bool)
    d = RX.compile_search_dfa(chip_smoke.Q22D_REGEX)
    steps, verdict = K.dfa_exit_plain(off, chars, valid, d)
    rows = [bytes(chars[int(off[i]):int(off[i + 1])].tolist()).decode()
            for i in range(n)]
    want_steps, want_verdicts = _stops_by_walk(d, rows, [True] * n)
    assert steps.tolist() == want_steps
    assert verdict.tolist() == want_verdicts
    assert verdict.numpy().tolist() == chip_smoke.anchored_oracle(
        np, tt).tolist()
    assert int(steps.sum()) < int(off[-1]) // 3
