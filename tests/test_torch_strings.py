"""The port's string layer against the reference, exactly.

``ops/strings.py`` function by function, the string gather of
``ops/filter_gather.py`` and the column upload / decode: the same string
columns (seeded; with nulls, empty strings, 2-, 3- and 4-byte UTF-8, code
points on both sides of U+0250 and runs of ASCII whitespace) go into
both engines as identical planes (offsets, chars pool, validity). Every
output plane must be equal, padding included. Each column comes in an
ASCII-only and a mixed variant, so both sides of each ASCII fast-path
decision run.
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.column import DeviceColumn as JColumn
from spark_rapids_tpu.columnar.column import HostColumn as JHost
from spark_rapids_tpu.expr.values import StrV as JStrV
from spark_rapids_tpu.ops import filter_gather as RF
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (ColumnarBatch, DeviceColumn,
                                             batch_from_host_arrays,
                                             column_from_pylist, schema_of)
from spark_rapids_tpu_torch.expr.values import StrV
from spark_rapids_tpu_torch.ops import filter_gather as F
from spark_rapids_tpu_torch.ops import strings as S

TOKENS = ["a", "bc", "Hello", "X", "xyz", "QRS", "é", "Ä", "ñandú", "ß",
          "€", "中文", "😀", "𝄞", "Ǆ", "ǅ", "ȿ", "ɐ", "İ", "ı", "ſ",
          "µ", "ÿ", "Ω"]
ASCII_TOKENS = [t for t in TOKENS if t.isascii()]
WS = [" ", "  ", "\t", "\n", " \t ", "\x0b", "\x0c", "\r", "   "]


def sample_strings(seed: int, n: int, ascii_only: bool = False,
                   null_p: float = 0.1):
    """Rows of 1-5 tokens joined by whitespace runs; a quarter start or
    end with a run; some empty strings and nulls."""
    rng = np.random.default_rng(seed)
    toks = ASCII_TOKENS if ascii_only else TOKENS
    out = []
    for _ in range(n):
        r = rng.random()
        if r < null_p:
            out.append(None)
            continue
        if r < null_p + 0.08:
            out.append("")
            continue
        parts = []
        if rng.random() < 0.25:
            parts.append(WS[rng.integers(len(WS))])
        for j in range(int(rng.integers(1, 6))):
            if j:
                parts.append(WS[rng.integers(len(WS))])
            parts.append(toks[rng.integers(len(toks))])
        if rng.random() < 0.25:
            parts.append(WS[rng.integers(len(WS))])
        out.append("".join(parts))
    return out


def columns(values, dtype_name="STRING"):
    """The reference's uploaded column and the port's column over the
    same planes."""
    jc = JColumn.from_host(JHost.from_pylist(values, getattr(JT,
                                                             dtype_name)))
    off, ch, va = (np.asarray(jc.offsets), np.asarray(jc.chars),
                   np.asarray(jc.validity))
    pc = DeviceColumn.from_string_arrays(getattr(T, dtype_name),
                                         len(values), off, ch, va, "cpu",
                                         char_cap=ch.shape[0])
    return jc, pc


def strvs(values):
    jc, pc = columns(values)
    return (JStrV(jc.offsets, jc.chars, jc.validity),
            StrV(pc.offsets, pc.chars, pc.validity))


def eq(ref, got, what=""):
    r = np.asarray(ref)
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert r.shape == g.shape, (what, r.shape, g.shape)
    np.testing.assert_array_equal(g, r, err_msg=what)


def eq_str(ref, got, what=""):
    for part in ("offsets", "chars", "validity"):
        eq(getattr(ref, part), getattr(got, part), f"{what} {part}")


VARIANTS = [("ascii", 1, True), ("mixed", 2, False), ("mixed_wide", 3, False)]


@pytest.fixture(params=VARIANTS, ids=[v[0] for v in VARIANTS])
def col(request):
    _, seed, ascii_only = request.param
    return strvs(sample_strings(seed, 300, ascii_only))


# ---------------------------------------------------------------------------
# layout primitives
# ---------------------------------------------------------------------------
def test_layout_primitives(col):
    j, p = col
    total_j, total_p = j.offsets[-1], p.offsets[-1]
    n = int(j.chars.shape[0])
    eq(RS.byte_lens(j.offsets), S.byte_lens(p.offsets), "byte_lens")
    eq(RS.row_ids(j.offsets, n), S.row_ids(p.offsets, n), "row_ids")
    eq(RS.char_starts(j.chars, total_j), S.char_starts(p.chars, total_p))
    eq(RS.char_prefix(j.chars, total_j), S.char_prefix(p.chars, total_p))
    eq(RS.char_positions(j.chars, total_j),
       S.char_positions(p.chars, total_p), "char_positions")
    assert bool(RS.all_ascii(j.chars, total_j)) == S.is_ascii(p.chars,
                                                              total_p)
    eq(RS.char_counts(j), S.char_counts(p), "char_counts")


@pytest.mark.parametrize("total", [0, 5, 6, 12])
def test_is_ascii_reads_only_live_bytes(total):
    """Bytes past the live count (here a 2-byte letter, then 0xFF) do not
    count, as the reference's position mask leaves them out."""
    pool = np.frombuffer(b"abcde\xc3\xa9fg\xff\x00\x00", np.uint8)
    ref = bool(RS.all_ascii(jnp.asarray(pool), jnp.int32(total)))
    assert S.is_ascii(torch.from_numpy(pool.copy()),
                      torch.tensor(total, dtype=torch.int32)) == ref
    assert ref == (total <= 5)


def test_char_to_byte(col):
    j, p = col
    cap = int(j.validity.shape[0])
    for seed in range(3):
        idx = np.random.default_rng(seed).integers(-3, 30, cap).astype(
            np.int32)
        eq(RS.char_to_byte(j, jnp.asarray(idx)),
           S.char_to_byte(p, torch.from_numpy(idx)), f"seed {seed}")


def test_compare_and_equals_literal(col):
    j, p = col
    cap = int(j.validity.shape[0])
    # against a shuffled copy (same pool) and against another column
    perm = np.random.default_rng(5).permutation(cap).astype(np.int32)
    vs = np.ones(cap, bool)
    jb = RF.gather_string(j, jnp.asarray(perm), jnp.asarray(vs),
                          int(j.chars.shape[0]))
    pb = F.gather_string(p, torch.from_numpy(perm), torch.from_numpy(vs),
                         int(p.chars.shape[0]))
    other = strvs(sample_strings(9, cap, False))
    for (ja, pa), (jo, po) in (((j, p), (jb, pb)), ((j, p), other),
                               (other, (j, p))):
        for r, g in zip(RS.compare(ja, jo), S.compare(pa, po)):
            eq(r, g, "compare")
    for lit in ("", "X", "bc", "Hello", "中文", "é a"):
        raw = lit.encode("utf-8")
        eq(RS.equals_literal(j, raw), S.equals_literal(p, raw), lit)


def test_pattern_search(col):
    j, p = col
    for lit in ("a", "X", " ", "bc", "\t", "中", "é", "Hello xyz"):
        raw = lit.encode("utf-8")
        mj, mp = RS.find_matches(j.chars, raw), S.find_matches(p.chars, raw)
        eq(mj, mp, lit)
        eq(RS.prefix_counts(mj), S.prefix_counts(mp), lit)
        eq(RS.next_match(mj), S.next_match(mp), lit)
    for pat in (b"aa", b"abab", b"abc", b"a", b"aba"):
        assert RS.has_border(pat) == S.has_border(pat)


def test_take_slices_and_concat(col):
    j, p = col
    cap = int(j.validity.shape[0])
    rng = np.random.default_rng(11)
    off = np.asarray(j.offsets)
    lens = off[1:] - off[:-1]
    start = (off[:-1] + rng.integers(0, 4, cap)).astype(np.int32)
    start = np.minimum(start, off[1:])
    new_lens = np.minimum(rng.integers(0, 9, cap), off[1:] - start).astype(
        np.int32)
    out_cap = int(j.chars.shape[0])
    for r, g in zip(RS.take_slices(j, jnp.asarray(start),
                                   jnp.asarray(new_lens), out_cap),
                    S.take_slices(p, torch.from_numpy(start),
                                  torch.from_numpy(new_lens), out_cap)):
        eq(r, g, "take_slices")
    eq(RS.offsets_of_lens(jnp.asarray(lens)),
       S.offsets_of_lens(torch.from_numpy(lens)))
    jo, po = strvs(sample_strings(21, cap, False))
    ocap = int(j.chars.shape[0] + jo.chars.shape[0])
    for r, g in zip(RS.concat([j, jo, j], ocap), S.concat([p, po, p], ocap)):
        eq(r, g, "concat")


@pytest.mark.parametrize("upper", [True, False])
def test_map_case(col, upper):
    j, p = col
    eq(RS.map_case(j.chars, j.offsets[-1], upper),
       S.map_case(p.chars, p.offsets[-1], upper), "map_case")


@pytest.mark.parametrize("upper", [True, False])
def test_case_tables_are_the_references(upper):
    np.testing.assert_array_equal(S._case_luts(upper),
                                  np.asarray(RS._case_luts(upper)))


def test_map_case_over_every_two_byte_code_point():
    """Every code point U+0080..U+07FF, one per row: the table's whole
    range, its edges and the pass-through beyond U+0250."""
    vals = [chr(c) + "aZ" for c in range(0x80, 0x800)]
    j, p = strvs(vals)
    for upper in (True, False):
        eq(RS.map_case(j.chars, j.offsets[-1], upper),
           S.map_case(p.chars, p.offsets[-1], upper), str(upper))


# ---------------------------------------------------------------------------
# ragged row maps and the string gather
# ---------------------------------------------------------------------------
def test_rows_of_positions_and_piecewise(col):
    j, p = col
    n = int(j.chars.shape[0])
    eq(RF.rows_of_positions(j.offsets, n), F.rows_of_positions(p.offsets, n))
    cap = int(j.validity.shape[0])
    vals = np.random.default_rng(3).integers(-(2**31), 2**31 - 1,
                                             cap).astype(np.int32)
    eq(RF.piecewise_by_row(jnp.asarray(vals), j.offsets, n),
       F.piecewise_by_row(torch.from_numpy(vals), p.offsets, n),
       "piecewise_by_row (wrapping)")


@pytest.mark.parametrize("mode", ["subset", "repeat", "clip"])
def test_gather_string(col, mode):
    j, p = col
    cap = int(j.validity.shape[0])
    rng = np.random.default_rng(len(mode))
    if mode == "subset":
        idx = np.sort(rng.choice(cap, cap // 2, replace=False))
        idx = np.concatenate([idx, np.zeros(cap - idx.size, np.int64)])
        slot = np.arange(cap) < cap // 2
        out_cap = int(j.chars.shape[0])
    elif mode == "repeat":
        idx = rng.integers(0, cap, 3 * cap)
        slot = rng.random(3 * cap) < 0.9
        out_cap = 4 * int(j.chars.shape[0])
    else:  # indices past either end clip, as the reference's takes
        idx = rng.integers(-5, cap + 5, cap)
        slot = np.ones(cap, bool)
        out_cap = 2 * int(j.chars.shape[0])
    idx = idx.astype(np.int32)
    eq_str(RF.gather_string(j, jnp.asarray(idx), jnp.asarray(slot), out_cap),
           F.gather_string(p, torch.from_numpy(idx), torch.from_numpy(slot),
                           out_cap), mode)


def test_filter_cols_compacts_strings_and_fixed(col):
    from spark_rapids_tpu.expr.values import ColV as JColV
    from spark_rapids_tpu_torch.expr.values import ColV

    j, p = col
    cap = int(j.validity.shape[0])
    rng = np.random.default_rng(4)
    mask = rng.random(cap) < 0.4
    v = rng.integers(0, 100, cap)
    jout, jn = RF.filter_cols([j, JColV(jnp.asarray(v), jnp.ones(cap, bool))],
                              jnp.asarray(mask), cap)
    pout, pn = F.filter_cols([p, ColV(torch.from_numpy(v),
                                      torch.ones(cap, dtype=torch.bool))],
                             torch.from_numpy(mask))
    assert int(jn) == int(pn)
    eq_str(jout[0], pout[0], "strings")
    eq(jout[1].data, pout[1].data)
    eq(jout[1].validity, pout[1].validity)


# ---------------------------------------------------------------------------
# upload and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["ascii", "mixed", "empty", "all_null"])
def test_upload_matches_reference_planes_and_round_trips(variant):
    vals = {"ascii": sample_strings(1, 200, True),
            "mixed": sample_strings(2, 300, False),
            "empty": [],
            "all_null": [None] * 5}[variant]
    jc = JColumn.from_host(JHost.from_pylist(vals, JT.STRING))
    pc = column_from_pylist(vals, T.STRING, device="cpu")
    for part in ("offsets", "chars", "validity"):
        eq(getattr(jc, part), getattr(pc, part), part)
    assert pc.capacity == jc.capacity
    assert pc.to_host().to_pylist() == vals == jc.to_pylist()


def test_binary_round_trip_and_batch_rows():
    vals = [b"\x00\xff", None, b"", "text".encode(), bytes(range(256))]
    schema = schema_of(b=T.BINARY, k=T.INT)
    b = ColumnarBatch.from_pydict({"b": vals, "k": [1, 2, 3, 4, 5]}, schema,
                                  device="cpu")
    assert b.to_rows() == list(zip(vals, [1, 2, 3, 4, 5]))
    jc = JColumn.from_host(JHost.from_pylist(vals, JT.BINARY))
    eq(jc.chars, b.columns[0].chars)
    eq(jc.offsets, b.columns[0].offsets)


def test_batch_from_host_arrays_carries_string_planes():
    vals = sample_strings(7, 100, False)
    jc, _ = columns(vals)
    off, ch, va = (np.asarray(jc.offsets), np.asarray(jc.chars),
                   np.asarray(jc.validity))
    v = np.arange(jc.capacity, dtype=np.int64)
    b = batch_from_host_arrays(schema_of(s=T.STRING, v=T.LONG),
                               [(off, ch), v],
                               [va, np.arange(jc.capacity) < len(vals)],
                               len(vals), jc.capacity, device="cpu")
    eq(ch, b.columns[0].chars)
    assert [r[0] for r in b.to_rows()] == vals


def test_bad_string_planes_raise():
    va = np.ones(2, bool)
    with pytest.raises(ValueError, match="shape"):
        DeviceColumn.from_string_arrays(T.STRING, 2, np.zeros(2, np.int32),
                                        np.zeros(4, np.uint8), va, "cpu")
    with pytest.raises(ValueError, match="never fall"):
        DeviceColumn.from_string_arrays(T.STRING, 2, np.array([0, 3, 1]),
                                        np.zeros(4, np.uint8), va, "cpu")
    with pytest.raises(ValueError, match="chars for"):
        DeviceColumn.from_string_arrays(T.STRING, 2, np.array([0, 3, 9]),
                                        np.zeros(4, np.uint8), va, "cpu")
