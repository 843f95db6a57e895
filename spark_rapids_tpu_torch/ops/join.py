"""Equi-join ops: key words, the tiered probe lowerings, the pair
expansion and the matched-build mask.

Counterpart of ``spark_rapids_tpu/ops/join.py``. The build side is sorted
once by its key words (joinable rows first, ``[0, build_count)``) and
every probe batch finds each row's match range [lo, hi) through one of
the tiers of ``spark.rapids.tpu.sql.join.strategy``:

  * SEARCH — vectorized lexicographic binary search over the sorted build
    words;
  * DIRECT — direct-address (first, count) tables when the build keys'
    value range fits 4x the build capacity (one host decision, the
    reference's ``lax.cond``), else SEARCH;
  * RADIX — :func:`radix_probe_ranges`, a co-sort of build and probe rows
    by the same words and prefix sums over that order;
  * PALLAS — the hand-written kernel K4 (``ops/join_kernels.py``) for
    keys of at most two words, else SEARCH.

The tiers agree on match counts and on ``lo`` wherever a row matched. An
unmatched live row reports its insertion point (lo == hi) under SEARCH
and RADIX and (0, 0) under DIRECT and PALLAS; dead rows are (0, 0)
everywhere. Callers only read ``hi - lo``, and ``lo`` where it is > 0.

Key words are the order-preserving u32 radix words of ``ops/sort.py``,
each in an int64 tensor (torch has no unsigned 64-bit type); u64 values
(packed keys) ride in int64 bit patterns, compared unsigned through
``^ SIGN64``. Null join keys never match; NaN matches NaN and -0.0 matches
0.0, properties of the shared radix words.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..expr.values import StrV, Val
from . import join_kernels
from .join_kernels import pack_key
from .radix_bin import segment_start_broadcast
from .sort import (SIGN64, SortOrder, chunk_count, fixed_radix_keys,
                   next_bound, string_chunk_keys)

_M32 = 0xFFFFFFFF
_I64_MAX = 2**63 - 1


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b over int64 bit patterns of u64 values (``b`` a
    tensor or a host int below 2^63)."""
    return (a ^ SIGN64) < (b ^ SIGN64)


def _fixed_key_words(c: Val) -> int:
    """Words a fixed-width key gives: (hi, lo) for a 64-bit one."""
    return 2 if (c.data.dtype != torch.bool
                 and c.data.element_size() == 8) else 1


def radix_key_words(cols: Sequence[Val], dtypes: Sequence[T.DataType],
                    str_max_lens: Sequence[int] = ()
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(key word tensors, any_null) for join-key comparison (reference
    ``join.py:51``). Words are the sort's order-preserving u32 radix
    words, so equality over words is Spark's join-key equality (NaN ==
    NaN, -0.0 == 0.0) and the build side can be ordered by them; a 64-bit
    key splits into (hi, lo) words, a string key gives its chunk words
    (``str_max_lens`` bounds the string keys in turn; each must have
    one)."""
    order = SortOrder(True, True)
    cap = cols[0].validity.shape[0]
    words: List[torch.Tensor] = []
    any_null = torch.zeros(cap, dtype=torch.bool,
                           device=cols[0].validity.device)
    lens = iter(str_max_lens)
    for c, dt in zip(cols, dtypes):
        any_null = any_null | ~c.validity
        if isinstance(c, StrV):
            # null_rank skipped: null keys never match
            words.extend(string_chunk_keys(c, order, next_bound(lens))[1:])
            continue
        k = fixed_radix_keys(c, dt, order)[1]  # null_rank skipped
        if _fixed_key_words(c) == 2:
            words.append((k >> 32) & _M32)
            words.append(k & _M32)
        else:
            words.append(k)
    return words, any_null


def key_word_widths(cols: Sequence[Val], str_max_lens: Sequence[int]
                    ) -> Tuple[int, ...]:
    """How many words each key gives in :func:`radix_key_words` under
    the same bounds."""
    lens = iter(str_max_lens)
    return tuple(chunk_count(next_bound(lens)) if isinstance(c, StrV)
                 else _fixed_key_words(c) for c in cols)


def pad_key_words(build_words: Sequence[torch.Tensor],
                  probe_words: Sequence[torch.Tensor],
                  build_widths: Sequence[int], probe_widths: Sequence[int]
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Both sides' words with each key zero-padded to the wider side's
    word count, the zero words right after that key's own.

    A string key's word count comes from each side's own length bucket
    (exec/join bounds the build once and each probe batch on its own).
    Every string of the narrower side fits its bucket, so its chunks past
    it are zero: the inserted zero words give its encoding at the wider
    bound. Padding at the end of the whole list instead (the reference's
    ``pad_key_words``) shifts every key after a string key against the
    other side's (ROADMAP.md §C); comparing only a shared prefix would
    match keys that differ past it."""
    if len(build_widths) != len(probe_widths):
        raise ValueError(f"{len(build_widths)} build keys against "
                         f"{len(probe_widths)} probe keys")
    bw: List[torch.Tensor] = []
    pw: List[torch.Tensor] = []
    bi = pi = 0
    for nb, npr in zip(build_widths, probe_widths):
        n = max(nb, npr)
        bw.extend(build_words[bi:bi + nb])
        bw.extend(torch.zeros_like(build_words[bi]) for _ in range(n - nb))
        pw.extend(probe_words[pi:pi + npr])
        pw.extend(torch.zeros_like(probe_words[pi]) for _ in range(n - npr))
        bi += nb
        pi += npr
    if bi != len(build_words) or pi != len(probe_words):
        raise ValueError("key word widths do not add up to the words")
    return bw, pw


def _check_aligned(build_words: Sequence[torch.Tensor],
                   probe_words: Sequence[torch.Tensor]) -> None:
    if len(build_words) != len(probe_words):
        raise ValueError(
            f"{len(build_words)} build key words against "
            f"{len(probe_words)} probe words: align them per key with "
            "pad_key_words")


def key_span(key64: torch.Tensor, ok: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kmin, kmax): the unsigned min and max of the u64 keys where
    ``ok``, as 0-d int64 bit patterns (all ones and 0 when none is)."""
    s = key64 ^ SIGN64  # unsigned order as signed order
    return (torch.where(ok, s, _I64_MAX).amin() ^ SIGN64,
            torch.where(ok, s, -_I64_MAX - 1).amax() ^ SIGN64)


def direct_tables(key64: torch.Tensor, ok: torch.Tensor,
                  kmin: torch.Tensor, tbl: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The direct-address (first, count) int32 tables over the key
    offsets from ``kmin``: per offset the first build row holding it and
    how many do. Rows not ``ok`` or off the table go to a spare slot that
    is cut off (the reference's ``mode="drop"`` scatters)."""
    nb = key64.shape[0]
    dev = key64.device
    diffu = key64 - kmin
    off = torch.where(ok & _ult(diffu, tbl), diffu, tbl)
    first = torch.full((tbl + 1,), nb, dtype=torch.int32, device=dev)
    first.scatter_reduce_(0, off, torch.arange(nb, dtype=torch.int32,
                                               device=dev), "amin")
    cnt = torch.zeros(tbl + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, off, torch.ones(nb, dtype=torch.int32, device=dev))
    return first[:tbl], cnt[:tbl]


def _count_tensor(build_count, device) -> torch.Tensor:
    """The build count (host int or 0-d tensor) as a 0-d int32 on
    ``device``; a host int is filled in on the device, never copied up
    (a pageable upload waits for the stream)."""
    if isinstance(build_count, torch.Tensor):
        return build_count.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), build_count, dtype=torch.int32, device=device)


def probe_ranges(build_words: Sequence[torch.Tensor], build_count,
                 probe_words: Sequence[torch.Tensor],
                 probe_live: torch.Tensor, strategy: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int32 match range per probe row, per the lowering tier
    (reference ``join.py:129``): SEARCH / DIRECT / RADIX / PALLAS.
    Both sides give the same number of words (:func:`pad_key_words`).
    DIRECT's runtime ``fits`` decision is one host sync."""
    _check_aligned(build_words, probe_words)
    if strategy == "RADIX":
        lo, hi, _ = radix_probe_ranges(build_words, build_count,
                                       probe_words, probe_live)
        return lo, hi
    if strategy not in ("PALLAS", "DIRECT") or len(build_words) > 2:
        return _probe_binary_search(build_words, build_count, probe_words,
                                    probe_live)
    if strategy == "PALLAS":
        return join_kernels.probe_ranges(build_words, build_count,
                                         probe_words, probe_live)
    dev = probe_live.device
    nb = build_words[0].shape[0]
    tbl = 4 * nb
    bkey = pack_key(build_words)
    pkey = pack_key(probe_words)
    live_b = (torch.arange(nb, dtype=torch.int32, device=dev)
              < _count_tensor(build_count, dev))
    kmin, kmax = key_span(bkey, live_b)
    fits = live_b.any() & _ult(kmax - kmin, tbl)
    if not bool(fits):  # the reference's lax.cond, decided on the host
        return _probe_binary_search(build_words, build_count, probe_words,
                                    probe_live)
    first, cnt = direct_tables(bkey, live_b, kmin, tbl)
    poff = pkey - kmin
    pin = probe_live & (poff >= 0) & (poff < tbl)
    pc = poff.clamp(0, tbl - 1)
    c = torch.where(pin, cnt[pc], 0)
    lo = torch.where(c > 0, first[pc], 0)
    return lo, lo + c


def _lex_less(a_vals: Sequence[torch.Tensor],
              b_vals: Sequence[torch.Tensor]) -> torch.Tensor:
    """a < b lexicographically over gathered word values."""
    lt = torch.zeros_like(a_vals[0], dtype=torch.bool)
    eq = torch.ones_like(lt)
    for av, bv in zip(a_vals, b_vals):
        lt = lt | (eq & (av < bv))
        eq = eq & (av == bv)
    return lt


def _probe_binary_search(build_words: Sequence[torch.Tensor], build_count,
                         probe_words: Sequence[torch.Tensor],
                         probe_live: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """General path (reference ``join.py:206``): vectorized lexicographic
    binary search over the sorted build words (build rows sorted
    joinable-first). Unmatched live rows report their insertion point."""
    dev = probe_live.device
    m = probe_words[0].shape[0]
    nb = build_words[0].shape[0]
    steps = max(1, nb.bit_length())
    bc = _count_tensor(build_count, dev)

    def gather(mid):
        idx = mid.long().clamp(0, max(nb - 1, 0))
        return [w[idx] for w in build_words]

    lo = torch.zeros(m, dtype=torch.int32, device=dev)
    hi = bc.expand(m).clone()
    for _ in range(steps):
        mid = (lo + hi) // 2
        open_ = lo < hi
        lt = _lex_less(gather(mid), probe_words)  # build[mid] < probe
        lo = torch.where(open_ & lt, mid + 1, lo)
        hi = torch.where(open_ & ~lt, mid, hi)
    first = lo

    lo2 = torch.zeros(m, dtype=torch.int32, device=dev)
    hi2 = bc.expand(m).clone()
    for _ in range(steps):
        mid = (lo2 + hi2) // 2
        open_ = lo2 < hi2
        lt = _lex_less(probe_words, gather(mid))  # probe < build[mid]
        lo2 = torch.where(open_ & ~lt, mid + 1, lo2)
        hi2 = torch.where(open_ & lt, mid, hi2)
    last = lo2

    first = torch.where(probe_live, first, 0)
    last = torch.where(probe_live, last, 0)
    return first, torch.maximum(first, last)


def _stable_sort_perm(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows lexicographically by the u64 ``keys``
    (int64 bit patterns, compared unsigned), ties in row order: one
    stable argsort per key, least significant first."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.argsort(k[perm] ^ SIGN64, stable=True)]
    return perm


def _unsort(s_slot: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Values in sorted order back at their original slots (the
    reference's second sort by slot; slots are a permutation)."""
    out = torch.empty_like(vals)
    out[s_slot.long()] = vals
    return out


def radix_probe_ranges(build_words: Sequence[torch.Tensor], build_count,
                       probe_words: Sequence[torch.Tensor],
                       probe_live: torch.Tensor, want_matched: bool = False,
                       lo_matched_only: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """[lo, hi) per probe row by one merge over the co-sorted build +
    probe order — the RADIX tier (reference ``join.py:250``).

    Build rows (already sorted, joinable first) and probe rows are
    concatenated and stably sorted by their u64-packed word pairs, so
    within an equal-key run every build row precedes every probe row;
    ``hi`` is the running count of joinable build rows at the probe's
    position, ``lo`` that count at its run's start. ``want_matched``
    (full outer) also returns which build rows a live probe row matched;
    ``lo_matched_only`` (the fused fast path) returns lo and
    ``lo + matched bit`` — the true run end is not computed there."""
    _check_aligned(build_words, probe_words)
    dev = probe_live.device
    nb = build_words[0].shape[0]
    m = probe_words[0].shape[0]
    n = nb + m
    bc = _count_tensor(build_count, dev)
    packed: List[torch.Tensor] = []
    for i in range(0, len(build_words), 2):
        hi_w = torch.cat([build_words[i], probe_words[i]]).to(
            torch.int64) << 32
        if i + 1 < len(build_words):
            hi_w = hi_w | torch.cat([build_words[i + 1],
                                     probe_words[i + 1]]).to(torch.int64)
        packed.append(hi_w)
    # original slot: build rows keep their index, probe rows park after
    # them — the is-build discriminator and the unsort key at once
    slot = torch.arange(n, dtype=torch.int32, device=dev)
    perm = _stable_sort_perm(packed)
    s_words = [k[perm] for k in packed]
    s_slot = slot[perm]
    is_build = s_slot < bc
    f = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        f[0] = True
    for w in s_words:
        f[1:] |= w[1:] != w[:-1]
    ib = is_build.to(torch.int32)
    c_incl = torch.cumsum(ib, 0, dtype=torch.int32)
    c_excl = c_incl - ib
    lo_s = segment_start_broadcast(f, c_excl)
    hi_s = c_incl
    matched_s = None
    if want_matched:
        # reverse segmented OR of live-probe presence: one cumulative max
        # over the reversed (run id from the end, probe flag) pairs
        seg = torch.cumsum(f.to(torch.int32), 0, dtype=torch.int32)
        h = (seg[-1] - seg).to(torch.int64)
        pidx = (s_slot.long() - nb).clamp(0, max(m - 1, 0))
        is_probe_live = (s_slot >= nb) & (probe_live[pidx] if m else False)
        packed_m = h * 2 + is_probe_live.to(torch.int64)
        rmax = torch.flip(torch.cummax(torch.flip(packed_m, (0,)), 0).values,
                          (0,))
        matched_s = is_build & ((rmax & 1) == 1) & (rmax // 2 == h)
    if lo_matched_only:
        packed_lm = (lo_s << 1) | (hi_s > lo_s).to(torch.int32)
        plm = _unsort(s_slot, packed_lm)[nb:]
        lo = torch.where(probe_live, plm >> 1, 0)
        matched = probe_live & ((plm & 1) == 1)
        return lo, torch.where(matched, lo + 1, lo), None
    lo = torch.where(probe_live, _unsort(s_slot, lo_s)[nb:], 0)
    hi = torch.where(probe_live, _unsort(s_slot, hi_s)[nb:], 0)
    matched = (_unsort(s_slot, matched_s)[:nb] if want_matched else None)
    return lo, torch.maximum(lo, hi), matched


def radix_expansion_plan(counts: torch.Tensor, lo: torch.Tensor,
                         out_cap: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """:func:`expansion_plan` of the RADIX tier (reference ``join.py:383``):
    the probe row of output slot j is a searchsorted over the count
    prefix sums. Same contract and output order."""
    counts = counts.to(torch.int64)
    m = counts.shape[0]
    csum = torch.cumsum(counts, 0)
    total = csum[-1]
    starts = csum - counts
    j = torch.arange(out_cap, dtype=torch.int64, device=counts.device)
    p = torch.searchsorted(csum, j, right=True)
    pc = p.clamp(0, m - 1)
    ordinal = j - starts[pc]
    build_row = (lo[pc].to(torch.int64) + ordinal).to(torch.int32)
    slot_live = j < total
    return (pc.to(torch.int32), torch.where(slot_live, build_row, 0),
            slot_live)


def expansion_plan(counts: torch.Tensor, lo: torch.Tensor, out_cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probe_row, build_row, slot_live) for each output slot j
    (reference ``join.py:406``): probe rows ascending, match ordinals
    ascending within a row. ``out_cap`` >= the total (the caller synced
    it).

    The reference's ``jnp.repeat(..., total_repeat_length=out_cap)`` is
    reproduced by its own algorithm — a count of row starts at or before
    each slot — so slots past the total repeat the last row exactly as
    there, and no second host sync sizes a ``repeat_interleave``. The
    packing stays ``(start << 31) | lo``."""
    counts = counts.to(torch.int64)
    m = counts.shape[0]
    dev = counts.device
    csum = torch.cumsum(counts, 0)
    total = csum[-1]
    starts = csum - counts  # output offset of each probe row
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    ind = torch.zeros(out_cap + 1, dtype=torch.int64, device=dev)
    ind.index_add_(0, starts.clamp(max=out_cap),
                   torch.ones(m, dtype=torch.int64, device=dev))
    rep_idx = torch.cumsum(ind[:out_cap], 0) - 1
    packed = (starts << 31) | lo.to(torch.int64)
    rep = packed[rep_idx]
    ordinal = j - (rep >> 31)
    build_row = ((rep & ((1 << 31) - 1)) + ordinal).to(torch.int32)
    slot_live = j < total
    return rep_idx.to(torch.int32), build_row, slot_live


def matched_build_mask(lo: torch.Tensor, hi: torch.Tensor,
                       probe_live: torch.Tensor,
                       build_cap: int) -> torch.Tensor:
    """Which build rows matched at least one probe row (full outer;
    reference ``join.py:435``): +1/-1 at each range's ends, then a prefix
    sum. Unmatched rows add at the spare slot ``build_cap``, cut off."""
    dev = lo.device
    hit = probe_live & (hi > lo)
    lo_m = torch.where(hit, lo, build_cap).long()
    hi_m = torch.where(hit, hi, build_cap).long()
    ones = torch.ones(lo.shape[0], dtype=torch.int32, device=dev)
    delta = torch.zeros(build_cap + 1, dtype=torch.int32, device=dev)
    delta.index_add_(0, lo_m, ones)
    delta.index_add_(0, hi_m, -ones)
    return torch.cumsum(delta[:-1], 0) > 0
