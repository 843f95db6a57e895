"""String kernels over Arrow offsets + chars columns, as torch ops.

Counterpart of ``spark_rapids_tpu/ops/strings.py`` (same functions, same
results): every operation works on the whole column at once —

  * per-byte row ids by a boundary scatter + cumsum over the offsets
    (``filter_gather.rows_of_positions``);
  * per-row reductions (first mismatch, match counts) by ``scatter_reduce``
    over the row ids or by prefix-sum differences at the row offsets;
  * literal pattern search as one shifted compare per pattern byte;
  * ragged outputs by one gather over the output byte space (output
    position -> source position), never a per-row Python loop.

UTF-8: strings compare as unsigned bytes (Spark's UTF8String.compareTo)
and index by character, through a cumsum over the bytes that start a
code point. Case mapping covers code points below U+0250 (the range where
it keeps byte lengths), through the reference's lookup tables; other
bytes pass through.

Each of the reference's ``lax.cond`` ASCII fast paths is a host decision
here (:func:`is_ascii`, read on the host): only the taken branch runs, and
both branches give the same result on an all-ASCII column.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..expr.values import StrV
from .filter_gather import piecewise_by_row, rows_of_positions  # noqa: F401

BIG = 2**31 - 1


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def _at(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` with int32 (or any integer) indices."""
    return t[idx.long()]


def _zeros(n: int, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(n, dtype=dtype, device=like.device)


def _iota(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _segment_reduce(values: torch.Tensor, rid: torch.Tensor, cap: int,
                    op: str, identity: int) -> torch.Tensor:
    """Per-row min or max of per-byte ``values`` (the reference's
    ``segment_min`` / ``segment_max``): rows with no byte get
    ``identity``."""
    out = torch.full((cap,), identity, dtype=torch.int32,
                     device=values.device)
    return out.scatter_reduce_(0, rid.long(), _i32(values), op,
                               include_self=True)


# ---------------------------------------------------------------------------
# layout primitives
# ---------------------------------------------------------------------------
def byte_lens(offsets: torch.Tensor) -> torch.Tensor:
    return offsets[1:] - offsets[:-1]


def row_ids(offsets: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Row id per byte position of the chars buffer (padding bytes clamp to
    the last row; callers mask with the live byte count)."""
    return rows_of_positions(offsets, nbytes)


def char_starts(chars: torch.Tensor, total) -> torch.Tensor:
    """True at bytes that begin a UTF-8 code point, False past ``total``."""
    return ((chars & 0xC0) != 0x80) & (_iota(chars.shape[0], chars) < total)


def char_prefix(chars: torch.Tensor, total) -> torch.Tensor:
    """(nbytes+1,) exclusive prefix count of char-start bytes: the number
    of characters strictly before byte p is ``char_prefix[p]``."""
    starts = char_starts(chars, total)
    return torch.cat([_zeros(1, torch.int32, chars),
                      torch.cumsum(starts, 0, dtype=torch.int32)])


def char_positions(chars: torch.Tensor, total) -> torch.Tensor:
    """(nbytes,) map char ordinal -> byte position of that char's first
    byte; ordinals past the data hold ``total``."""
    n = chars.shape[0]
    starts = char_starts(chars, total)
    cp = char_prefix(chars, total)
    tgt = torch.where(starts, cp[:-1], n)  # n: the spare slot, cut off
    out = torch.as_tensor(total, dtype=torch.int32,
                          device=chars.device).repeat(n + 1)
    out.scatter_(0, tgt.long(), _iota(n, chars))
    return out[:n]


def all_ascii(chars: torch.Tensor, total) -> torch.Tensor:
    """0-d bool: no byte in [0, total) has the high bit set."""
    hi = (chars >= 0x80) & (_iota(chars.shape[0], chars) < total)
    return ~torch.any(hi)


def is_ascii(chars: torch.Tensor, total) -> bool:
    """:func:`all_ascii` on the host: the reference's ``lax.cond``
    predicate for the ASCII fast paths. It reads the live byte count
    first (one device sync) and then scans only the live bytes (a
    second), so no position mask over the padded pool is built."""
    live = min(int(total), chars.shape[0])
    return not bool(torch.any(chars[:live] >= 0x80))


def char_counts(s: StrV) -> torch.Tensor:
    """Per-row character counts (Spark length())."""
    total = s.offsets[-1]
    lens = byte_lens(s.offsets)
    if is_ascii(s.chars, total):
        return lens
    cp = char_prefix(s.chars, total)
    return _at(cp, s.offsets[1:]) - _at(cp, s.offsets[:-1])


def char_to_byte(s: StrV, char_idx: torch.Tensor) -> torch.Tensor:
    """Per-row: byte position of character ``char_idx`` (0-based within
    the row), clamped to the row end for out-of-range ordinals."""
    total = s.offsets[-1]
    lens = byte_lens(s.offsets)
    zero = torch.zeros((), dtype=torch.int32, device=lens.device)
    if is_ascii(s.chars, total):
        k = torch.minimum(torch.maximum(_i32(char_idx), zero), lens)
        return _i32(s.offsets[:-1] + k)
    cp = char_prefix(s.chars, total)
    pos = char_positions(s.chars, total)
    nchars = _at(cp, s.offsets[1:]) - _at(cp, s.offsets[:-1])
    first = _at(cp, s.offsets[:-1])
    k = torch.minimum(torch.maximum(_i32(char_idx), zero), nchars)
    n = s.chars.shape[0]
    raw = _at(pos, (first + k).clamp(0, n - 1))
    return _i32(torch.where(k >= nchars, s.offsets[1:], raw))


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------
def compare(a: StrV, b: StrV) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lt, eq) per row — unsigned byte-wise, Spark UTF8String.compareTo:
    byte j of a row of ``a`` meets the byte at the same within-row
    position of ``b``, the first mismatch per row is a segment min, then
    one byte compare decides."""
    cap = a.offsets.shape[0] - 1
    na, nb = a.chars.shape[0], b.chars.shape[0]
    la, lb = byte_lens(a.offsets), byte_lens(b.offsets)
    rid = row_ids(a.offsets, na)
    pos = _iota(na, a.chars)
    within = pos - _at(a.offsets, rid)
    common = _at(torch.minimum(la, lb), rid)
    in_cmp = (within < common) & (pos < a.offsets[-1])
    bb = _at(b.chars, (_at(b.offsets, rid) + within).clamp(0, nb - 1))
    mism = in_cmp & (a.chars != bb)
    first = _segment_reduce(torch.where(mism, within, BIG), rid, cap,
                            "amin", BIG)
    has = first < BIG
    # in int64: offsets + BIG would wrap (the value is unused where !has)
    f64 = first.long()
    av = a.chars[(a.offsets[:-1].long() + f64).clamp(0, na - 1)]
    bv = b.chars[(b.offsets[:-1].long() + f64).clamp(0, nb - 1)]
    lt = torch.where(has, av < bv, la < lb)
    eq = ~has & (la == lb)
    return lt, eq


def equals_literal(s: StrV, lit: bytes) -> torch.Tensor:
    """Per-row equality against a host-side literal."""
    lens = byte_lens(s.offsets)
    if len(lit) == 0:
        return lens == 0
    m = find_matches(s.chars, lit)
    n = s.chars.shape[0]
    at = _at(m, s.offsets[:-1].clamp(0, n - 1))
    return (lens == len(lit)) & at


# ---------------------------------------------------------------------------
# literal pattern search
# ---------------------------------------------------------------------------
def find_matches(chars: torch.Tensor, pat: bytes) -> torch.Tensor:
    """match[p] = chars[p:p+len(pat)] == pat, one shifted compare per
    pattern byte; windows that run past the buffer are False."""
    n = chars.shape[0]
    m = len(pat)
    assert m >= 1
    padded = torch.cat([chars, _zeros(m, torch.uint8, chars)])
    out = torch.ones(n, dtype=torch.bool, device=chars.device)
    for k, byte in enumerate(pat):
        out = out & (padded[k:k + n] == byte)
    return out & (_iota(n, chars) <= n - m)


def prefix_counts(mask: torch.Tensor) -> torch.Tensor:
    """(n+1,) exclusive prefix sums of a bool mask."""
    return torch.cat([_zeros(1, torch.int32, mask),
                      torch.cumsum(mask, 0, dtype=torch.int32)])


def next_match(match: torch.Tensor) -> torch.Tensor:
    """(n+1,) nm[p] = smallest q >= p with match[q], else BIG: the
    reference's reverse running minimum, as one cumsum, one scatter and
    one gather (``ops/window.next_flag_after``'s form; ``torch.cummin``
    took 22 ms a call at 2^23 rows on the H100)."""
    n = match.shape[0]
    before = prefix_counts(match)  # matches strictly before each p
    pos = torch.full((n + 2,), BIG, dtype=torch.int32, device=match.device)
    # the (k+1)-th match's position at pos[k]; others to the dump slot
    pos.scatter_(0, torch.where(match, before[1:] - 1, n + 1).long(),
                 _iota(n, match))
    return pos[before.long()]


def has_border(pat: bytes) -> bool:
    """True if the pattern has a proper border (can overlap itself)."""
    m = len(pat)
    return any(pat[: m - d] == pat[d:] for d in range(1, m))


# ---------------------------------------------------------------------------
# ragged output builders
# ---------------------------------------------------------------------------
def _out_rows(new_offsets: torch.Tensor, out_cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    pos = _iota(out_cap, new_offsets)
    rid = rows_of_positions(new_offsets, out_cap)
    return rid, pos - _at(new_offsets, rid)


def offsets_of_lens(new_lens: torch.Tensor) -> torch.Tensor:
    return torch.cat([_zeros(1, torch.int32, new_lens),
                      torch.cumsum(new_lens, 0, dtype=torch.int32)])


def take_slices(s: StrV, start_bytes: torch.Tensor, new_lens: torch.Tensor,
                out_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new_offsets, out_chars) where output row i is the byte slice
    [start_bytes[i], start_bytes[i] + new_lens[i]) of the source pool
    (substring, trim): ``src[pos] = start[row] + (pos - new_offsets[row])``,
    whose bracketed delta expands with one scatter + cumsum."""
    new_offsets = offsets_of_lens(new_lens)
    delta = _i32(start_bytes) - new_offsets[:-1]
    pos = _iota(out_cap, s.chars)
    src = (pos + piecewise_by_row(delta, new_offsets, out_cap)).clamp(
        0, s.chars.shape[0] - 1)
    out = torch.where(pos < new_offsets[-1], _at(s.chars, src),
                      torch.zeros((), dtype=torch.uint8, device=pos.device))
    return new_offsets, out


def concat(pieces: Sequence[StrV], out_cap: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spark concat(): per-row byte concatenation; null if ANY input is
    null. Returns (new_offsets, out_chars, validity)."""
    valid = functools.reduce(torch.logical_and, [p.validity for p in pieces])
    lens = [byte_lens(p.offsets) for p in pieces]
    total = torch.where(valid, functools.reduce(torch.add, lens), 0)
    new_offsets = offsets_of_lens(total)
    rid, within = _out_rows(new_offsets, out_cap)
    out = _zeros(out_cap, torch.uint8, total)
    cum = torch.zeros_like(rid)
    for p, ln in zip(pieces, lens):
        w = within - cum
        lr = _at(ln, rid)
        sel = (w >= 0) & (w < lr)
        src = (_at(p.offsets[:-1], rid) + w).clamp(0, p.chars.shape[0] - 1)
        out = torch.where(sel, _at(p.chars, src), out)
        cum = cum + lr
    out = torch.where(_iota(out_cap, out) < new_offsets[-1], out,
                      torch.zeros((), dtype=torch.uint8, device=out.device))
    return new_offsets, out, valid


# ---------------------------------------------------------------------------
# case mapping (code points < 0x250 — the byte-length preserving range)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _case_luts(upper: bool) -> np.ndarray:
    """The reference's table (``ops/strings.py:292``): code point ->
    simple case mapping, kept only where the mapping is one code point
    below 0x250 of the same UTF-8 length."""
    lut = np.arange(0x250, dtype=np.int32)
    for cp in range(0x250):
        c = chr(cp)
        m = c.upper() if upper else c.lower()
        if len(m) == 1 and ord(m) < 0x250 and (
                len(m.encode("utf-8")) == len(c.encode("utf-8"))):
            lut[cp] = ord(m)
    return lut


def _ascii_case(chars: torch.Tensor, upper: bool) -> torch.Tensor:
    """Pure-arithmetic ASCII case map (no table gathers)."""
    lo, hi = (ord("a"), ord("z")) if upper else (ord("A"), ord("Z"))
    in_rng = (chars >= lo) & (chars <= hi)
    return torch.where(in_rng, chars - 32 if upper else chars + 32, chars)


def map_case(chars: torch.Tensor, total, upper: bool) -> torch.Tensor:
    """Byte-length-preserving simple case mapping. ASCII and 2-byte
    sequences below U+0250 are mapped; everything else passes through.
    All-ASCII pools take the gather-free arithmetic path."""
    n = chars.shape[0]
    in_data = _iota(n, chars) < total
    if is_ascii(chars, total):
        return torch.where(in_data, _ascii_case(chars, upper), chars)
    lut = torch.from_numpy(_case_luts(upper)).to(chars.device)
    c32 = chars.to(torch.int32)
    is2 = (chars & 0xE0) == 0xC0
    nxt = torch.cat([c32[1:], _zeros(1, torch.int32, chars)])
    prv = torch.cat([_zeros(1, torch.int32, chars), c32[:-1]])
    cp2 = ((c32 & 0x1F) << 6) | (nxt & 0x3F)
    mapped2 = _at(lut, cp2.clamp(0, 0x24F))
    in_range2 = is2 & (cp2 < 0x250)
    # continuation byte of a mapped 2-byte char: recompute from prev
    prev_cp2 = ((prv & 0x1F) << 6) | (c32 & 0x3F)
    prev_is2 = (prv & 0xE0) == 0xC0
    prev_mapped = _at(lut, prev_cp2.clamp(0, 0x24F))
    prev_in = prev_is2 & (prev_cp2 < 0x250) & ((chars & 0xC0) == 0x80)
    out = torch.where(chars < 0x80, _ascii_case(chars, upper), chars)
    out = torch.where(in_range2, (0xC0 | (mapped2 >> 6)).to(torch.uint8),
                      out)
    out = torch.where(prev_in, (0x80 | (prev_mapped & 0x3F)).to(torch.uint8),
                      out)
    return torch.where(in_data, out, chars)

