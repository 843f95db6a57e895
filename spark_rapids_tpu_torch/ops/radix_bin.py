"""Radix-binned tiled group-by reduction: the RADIX aggregation lowering.

Counterpart of ``spark_rapids_tpu/ops/radix_bin.py``. Rows are ordered
once by their radix key words (``ops/sort.sort_with_radix_keys``), then
every aggregate reduces per segment of that order:

  * sums and counts (:class:`AddSpec`): prefix-sum differences per tile
    (integer sums wrap mod 2^64, bit for bit the other tiers' sums);
  * float sums: split per row into a NORMAL stream summed by a segmented
    scan that restarts at every segment, a BIG stream (|x| > 2^500,
    scaled by 2^-600) and +inf/-inf/NaN presence flags, recombined with
    IEEE semantics (:func:`combine_float_sum`);
  * min/max (:class:`MinMaxSpec`): the winning ROW by the sort's
    total-order word (NaN largest, -0.0 == 0.0);
  * first/last and the group's representative row (:class:`PosSpec`):
    the first or last considered position of the segment.

:func:`tiled_segment_groupby` is the reference's ``lax.fori_loop`` over
tiles written as a Python loop of torch ops, with the same tiles, carries
and flush trip. It is the PLAIN version of the hand-written Hopper kernel
in ``ops/radix_kernels.py`` (``csrc/radix_kernels.cu``), whose wrapper
runs it for CPU tensors; the tile length fixes how max breaks ties across
tiles (:func:`default_tile_rows`). The reference clamps a ragged last
tile's slice back into the array (``lax.dynamic_slice``), which reads
earlier rows there; the port pads the order instead, which agrees with it
whenever the live rows end before that tile, as they do at every
capacity its tiles divide.

:func:`segment_start_broadcast` is the segmented-scan helper of the RADIX
join tier's co-sorted merge (``ops/join.radix_probe_ranges``).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import torch

from .sort import SIGN64

#: test hook, as the reference's: force the tile row count (0 = derive it
#: from the layout); must stay <= 2^20 so the flag lanes cannot overflow
FORCE_TILE_ROWS = 0

#: |x| above this routes a float row through the scaled BIG stream
F64_BIG = 2.0 ** 500
#: exact power-of-two scaling of the BIG stream
BIG_SCALE_DOWN = 2.0 ** -600
BIG_SCALE_UP = 2.0 ** 600

#: OR-stream field layout: three 21-bit per-tile count lanes (+inf, -inf,
#: NaN); a tile holds < 2^20 rows, so a lane never carries into the next
_FLAG_LANE = 21
_FLAG_MASK = (1 << _FLAG_LANE) - 1

#: the u64 identities of the winner words, as int64 bit patterns
_U64_MAX = -1
_U64_MIN = 0


def default_tile_rows(cap: int, n_streams: int) -> int:
    """The reference's tile rows for a reduction of ``n_streams`` streams
    over ``cap`` rows (reference ``radix_bin.py:92``): about 1 MiB of
    working set, clamped to [2^12, 2^16] and never above the capacity."""
    if FORCE_TILE_ROWS:
        return min(FORCE_TILE_ROWS, 1 << 20)
    per_row = max(16, 8 * max(1, n_streams))
    t = max(2, (1 << 20) // per_row)
    t = 1 << max(12, min(16, t.bit_length() - 1))
    while t > cap and t > 8:
        t >>= 1
    return max(8, t)


class TileCtx:
    """Per-tile gather context handed to every stream's build function:
    ``take`` gathers an ORIGINAL-row-order tensor at this tile's sorted
    rows."""

    __slots__ = ("p_t",)

    def __init__(self, p_t: torch.Tensor):
        self.p_t = p_t

    def take(self, arr: torch.Tensor) -> torch.Tensor:
        return arr[self.p_t]


class AddSpec(NamedTuple):
    """One additive stream: ``build(ctx)`` returns the (tile,) values,
    already zero at rows that must not contribute; ``family`` is 'u64'
    (wrapping int64 bit patterns), 'u32' (counts), 'f64' or 'or' (a
    21-bit-lane flag stream that saturates per tile to 3 presence bits)."""

    build: Callable[[TileCtx], torch.Tensor]
    family: str


class MinMaxSpec(NamedTuple):
    """One winner-row reduction ordered by a total-order word:
    ``word(ctx)`` is the (tile,) u64 word as an int64 bit pattern,
    ``cons(ctx)`` the considered mask, carried explicitly because a
    considered word can equal the identity (int64.max under min)."""

    word: Callable[[TileCtx], torch.Tensor]
    cons: Callable[[TileCtx], torch.Tensor]
    op: str


class PosSpec(NamedTuple):
    """First ('min') / last ('max') considered row per segment; the
    stable sort keeps original row order within a segment."""

    cons: Callable[[TileCtx], torch.Tensor]
    op: str


class SegmentedOutputs(NamedTuple):
    u64: List[torch.Tensor]          # per 'u64' AddSpec, (cap,) int64 bits
    u32: List[torch.Tensor]          # per 'u32' AddSpec, (cap,) int64
    f64: List[torch.Tensor]          # per 'f64' AddSpec, (cap,) float64
    flags: List[torch.Tensor]        # per 'or' AddSpec, (cap,) uint8
    pos_rows: List[torch.Tensor]     # per PosSpec, (cap,) int32 (-1 empty)
    winner_rows: List[torch.Tensor]  # per MinMaxSpec, (cap,) int32
    nseg: torch.Tensor               # int32 device scalar


def _tile_diffs(stacked: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    """Per-local-segment sums of a (K, tile) int64 stack, one stream a
    row, as prefix differences at [lo, hi): exact for the wrapping
    integer families. (K, B) out."""
    c = torch.cumsum(stacked, 1)
    padded = torch.cat([torch.zeros_like(c[:, :1]), c], 1)
    return padded[:, hi] - padded[:, lo]


def _tile_segment_sums(stacked: torch.Tensor, starts: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Per-local-segment FLOAT sums of a (K, tile) stack: a segmented
    scan that restarts at every segment start (``starts``), read at each
    segment's last row, so one group's magnitude never absorbs its
    neighbours' sums (reference ``radix_bin.py:187``, whose scan is a
    tree; this one is a doubling scan, the same rounding class)."""
    v = stacked.clone()
    f = starts.clone()
    n = v.shape[1]
    d = 1
    while d < n:
        add = torch.where(f[d:], torch.zeros_like(v[:, d:]), v[:, :-d])
        v = torch.cat([v[:, :d], v[:, d:] + add], 1)
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d <<= 1
    out = v[:, (hi - 1).clamp(min=0)]
    return torch.where(hi > lo, out, torch.zeros_like(out))


def _saturate_flags(x: torch.Tensor) -> torch.Tensor:
    """The three 21-bit per-tile count lanes of an OR stream as presence
    bits 0/1/2 (a uint8)."""
    p = (x & _FLAG_MASK) > 0
    m = ((x >> _FLAG_LANE) & _FLAG_MASK) > 0
    q = (x >> (2 * _FLAG_LANE)) > 0
    return (p.to(torch.uint8) | (m.to(torch.uint8) << 1)
            | (q.to(torch.uint8) << 2))


def _stable_lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts by ``keys`` (most significant first),
    stably: one stable argsort per key, least significant first."""
    perm = None
    for k in reversed(keys):
        kp = k if perm is None else k[perm]
        p = torch.argsort(kp, stable=True)
        perm = p if perm is None else perm[p]
    return perm


def tiled_segment_groupby(perm: torch.Tensor,
                          sorted_words: Sequence[torch.Tensor],
                          live_in: torch.Tensor,
                          adds: Sequence[AddSpec] = (),
                          pos: Sequence[PosSpec] = (),
                          winners: Sequence[MinMaxSpec] = (),
                          tile_rows: int = 0) -> SegmentedOutputs:
    """Reduce every stream per segment of the radix-sorted order, one tile
    at a time (reference ``radix_bin.py:221``).

    ``perm``/``sorted_words``: the sort's permutation and co-sorted key
    words (dead rows sort LAST); ``live_in`` is the liveness mask in
    ORIGINAL row order. Additive build functions hold their identity (0)
    at rows that must not contribute; dead rows drop structurally.
    Outputs are segment-compacted to the front at the input capacity, in
    sorted key order."""
    cap = perm.shape[0]
    dev = perm.device
    fams = {"u64": [], "u32": [], "f64": [], "or": []}
    for s in adds:
        fams[s.family].append(s)
    n_streams = len(adds) + len(pos) + 2 * len(winners)
    tile = min(tile_rows or default_tile_rows(cap, n_streams), max(8, cap))
    BL = tile + 1
    trips = -(-cap // tile) + 1  # +1 flush trip writes the last open seg
    # the order and words padded to whole tiles (see the module doc)
    pad = trips * tile - cap
    perm_p = torch.cat([perm, torch.zeros(pad, dtype=perm.dtype,
                                          device=dev)])
    words_p = [torch.cat([w, torch.zeros(pad, dtype=w.dtype, device=dev)])
               for w in sorted_words]
    row_ids = torch.arange(tile, dtype=torch.int64, device=dev)
    iota_bl = torch.arange(BL + 1, dtype=torch.int64, device=dev)
    bl_ids = torch.arange(BL, dtype=torch.int64, device=dev)
    slots = torch.arange(BL, dtype=torch.int64, device=dev)
    PACK = BL + 1
    fdtype = {"u64": torch.int64, "u32": torch.int64, "f64": torch.float64,
              "or": torch.int64}

    S = torch.zeros((), dtype=torch.int64, device=dev)
    prev_w = [torch.zeros((), dtype=w.dtype, device=dev) for w in words_p]
    carry = {f: torch.zeros(max(1, len(sp)), dtype=(
        torch.uint8 if f == "or" else fdtype[f]), device=dev)
        for f, sp in fams.items()}
    bufs = {f: torch.zeros((cap + BL, max(1, len(sp))), dtype=(
        torch.uint8 if f == "or" else fdtype[f]), device=dev)
        for f, sp in fams.items()}
    cpr = torch.full((max(1, len(pos)),), -1, dtype=torch.int64, device=dev)
    b_pos = torch.full((cap + BL, max(1, len(pos))), -1, dtype=torch.int32,
                       device=dev)
    w_is_min = [w.op == "min" for w in winners]
    cww = torch.tensor([_U64_MAX if m else _U64_MIN for m in w_is_min]
                       or [0], dtype=torch.int64, device=dev)
    cwr = torch.full((max(1, len(winners)),), -1, dtype=torch.int64,
                     device=dev)
    b_wrow = torch.full((cap + BL, max(1, len(winners))), -1,
                        dtype=torch.int32, device=dev)

    for t in range(trips):
        start = t * tile
        pos_ok = (start + row_ids) < cap
        p_t = perm_p[start:start + tile]
        ctx = TileCtx(p_t)
        lv_t = ctx.take(live_in) & pos_ok
        # boundary flags IN the tile: a live row starts a segment when any
        # sorted word differs from the previous row's (trip 0's first row
        # always does)
        w_ts = [torch.where(pos_ok, w[start:start + tile], 0)
                for w in words_p]
        diff = torch.zeros(tile, dtype=torch.bool, device=dev)
        for w_t, pw in zip(w_ts, prev_w):
            prev_col = torch.cat([pw.reshape(1), w_t[:-1]])
            diff = diff | (w_t != prev_col)
        if t == 0:
            diff[0] = True
        f_t = lv_t & diff
        csum = torch.cumsum(f_t.to(torch.int64), 0)
        s_open = (S > 0).to(torch.int64)
        seg_local = torch.where(lv_t, csum - 1 + s_open, BL)
        n_new = csum[-1]
        last_local = torch.where(lv_t, seg_local, 0).max()
        w_base = (S - 1).clamp(min=0)
        bounds = torch.searchsorted(seg_local, iota_bl, side="left")
        lo, hi = bounds[:-1], bounds[1:]
        present = hi > lo
        # the last local segment stays open and rides the carry, except
        # on the flush trip, which exists to write it
        keep1 = (bl_ids != last_local) | (t == trips - 1)
        at = w_base + slots

        for fam, specs in fams.items():
            if not specs:
                continue
            dt = fdtype[fam]
            cols = [torch.where(lv_t, s.build(ctx).to(dt),
                                torch.zeros((), dtype=dt, device=dev))
                    for s in specs]
            stacked = torch.stack(cols)  # (K, tile): one stream a row
            if fam == "f64":
                part = _tile_segment_sums(stacked, f_t, lo, hi).T
            else:
                part = _tile_diffs(stacked, lo, hi).T
            if fam == "or":
                part = _saturate_flags(part)
                comb = carry[fam] | part[0]
            else:
                comb = carry[fam] + part[0]
            part = torch.cat([comb[None], part[1:]])
            carry[fam] = part.index_select(0, last_local.reshape(1))[0]
            part = torch.where(keep1[:, None], part, torch.zeros_like(part))
            bufs[fam].index_copy_(0, at, part)

        if pos:
            npr = []
            for i, spec in enumerate(pos):
                cons_t = spec.cons(ctx) & lv_t
                is_min = spec.op == "min"
                # first = smallest position, packed as BL - position so one
                # cumulative MAX finds it (later segments dominate)
                pay = torch.where(cons_t, (BL - row_ids) if is_min
                                  else row_ids + 1, 0)
                enc = seg_local.clamp(max=BL) * PACK + pay
                cmax = torch.cummax(enc, 0).values
                pay_end = cmax[(hi - 1).clamp(min=0)] % PACK
                found = present & (pay_end > 0)
                ppos = ((BL - pay_end.clamp(min=1)) if is_min
                        else (pay_end.clamp(min=1) - 1))
                rw = torch.where(found, p_t[ppos.clamp(0, tile - 1)], -1)
                # the open segment (local 0) against the carry: for first
                # an earlier tile's row always wins; for last the current
                cr = cpr[i]
                take_c = (cr >= 0) & (is_min | (rw[0] < 0))
                rw = torch.cat([torch.where(take_c, cr, rw[0]).reshape(1),
                                rw[1:]])
                npr.append(rw.index_select(0, last_local.reshape(1))[0])
                rw = torch.where(keep1, rw, -1)
                b_pos[:, i].index_copy_(0, at, rw.to(torch.int32))
            cpr = torch.stack(npr)

        if winners:
            nww, nwr = [], []
            for i, spec in enumerate(winners):
                cons_t = spec.cons(ctx) & lv_t
                is_min = w_is_min[i]
                ident = _U64_MAX if is_min else _U64_MIN
                word_t = torch.where(cons_t, spec.word(ctx), ident)
                # one tile-local stable sort by (segment, crank, word):
                # considered rows sort toward the winner position, so an
                # identity-word collision never shadows a real winner
                crank = (~cons_t if is_min else cons_t).to(torch.int64)
                order = _stable_lexsort([seg_local, crank, word_t ^ SIGN64])
                sword, sperm = word_t[order], p_t[order]
                scons = cons_t[order]
                wpos = lo if is_min else (hi - 1).clamp(min=0)
                wpos = wpos.clamp(max=tile - 1)
                wd = torch.where(present, sword[wpos], ident)
                won = present & scons[wpos]
                rw = torch.where(won, sperm[wpos], -1)
                cw, cr = cww[i], cwr[i]
                if is_min:
                    better = (cw ^ SIGN64) <= (wd[0] ^ SIGN64)
                else:
                    better = (cw ^ SIGN64) >= (wd[0] ^ SIGN64)
                take_c = (cr >= 0) & (better | (rw[0] < 0))
                wd = torch.cat([torch.where(take_c, cw, wd[0]).reshape(1),
                                wd[1:]])
                rw = torch.cat([torch.where(take_c, cr, rw[0]).reshape(1),
                                rw[1:]])
                sel = last_local.reshape(1)
                nww.append(wd.index_select(0, sel)[0])
                nwr.append(rw.index_select(0, sel)[0])
                rw = torch.where(keep1, rw, -1)
                b_wrow[:, i].index_copy_(0, at, rw.to(torch.int32))
            cww, cwr = torch.stack(nww), torch.stack(nwr)

        prev_w = [w_t[-1] for w_t in w_ts]
        S = S + n_new

    def cols(fam):
        return [bufs[fam][:cap, i] for i in range(len(fams[fam]))]

    return SegmentedOutputs(
        u64=cols("u64"), u32=cols("u32"), f64=cols("f64"),
        flags=cols("or"),
        pos_rows=[b_pos[:cap, i] for i in range(len(pos))],
        winner_rows=[b_wrow[:cap, i] for i in range(len(winners))],
        nseg=S.to(torch.int32))


def segment_start_broadcast(flags: torch.Tensor,
                            values: torch.Tensor) -> torch.Tensor:
    """Broadcast ``values`` at segment-start positions (``flags``) to
    every later row of the segment; rows before the first flag report
    -1. Reference ``radix_bin.py:472``, a ``lax.cummax`` of the flagged
    values, which equals this whenever they are NONDECREASING across
    segment starts (true for any prefix-sum-derived stream over a sorted
    order, e.g. the join merge's running build counts). One cumsum, one
    scatter and one gather, as ``ops/window.last_flag_at_or_before``:
    ``torch.cummax`` of an int32 column took 22 ms at 2^23 rows on the
    H100 (PERF.md)."""
    n = flags.shape[0]
    count = torch.cumsum(flags.to(torch.int32), 0, dtype=torch.int32)
    # at[k] = the value at the k-th flag (k from 1); at[0] = -1 for the
    # rows before the first flag; unflagged rows write a dump slot
    at = torch.full((n + 2,), -1, dtype=torch.int32, device=flags.device)
    at.scatter_(0, torch.where(flags, count, n + 1).long(),
                values.to(torch.int32))
    return at[count.long()]


# ---------------------------------------------------------------------------
# tile-local stream pieces (the group-by plan's build functions call them)
# ---------------------------------------------------------------------------
def float_sum_streams(data: torch.Tensor, consider: torch.Tensor):
    """(normal, big, flag_fields) streams for one float column (reference
    ``radix_bin.py:487``): normal holds finite |x| <= 2^500, big the
    larger finite values scaled by 2^-600 (exact), flag_fields 21-bit-lane
    counts (+inf at bit 0, -inf at bit 21, NaN at bit 42)."""
    d = torch.where(consider, data.to(torch.float64), 0.0)
    isnan = d != d
    finite = torch.isfinite(d)
    big = finite & (d.abs() > F64_BIG)
    normal = torch.where(finite & ~big, d, 0.0)
    bigs = torch.where(big, d * BIG_SCALE_DOWN, 0.0)
    fields = ((d == float("inf")).to(torch.int64)
              | ((d == float("-inf")).to(torch.int64) << _FLAG_LANE)
              | (isnan.to(torch.int64) << (2 * _FLAG_LANE)))
    return normal, bigs, fields


def combine_float_sum(normal: torch.Tensor, big: torch.Tensor,
                      flags: torch.Tensor) -> torch.Tensor:
    """One float column's per-segment streams recombined with IEEE
    semantics (reference ``radix_bin.py:511``): NaN (or mixed infinities)
    dominates, then the surviving infinity, else normal + big * 2^600
    (which may itself overflow to the correct infinity)."""
    p = (flags & 1) != 0
    m = (flags & 2) != 0
    q = (flags & 4) != 0
    s = normal + big * BIG_SCALE_UP
    r = torch.where(p, float("inf"), torch.where(m, float("-inf"), s))
    return torch.where(q | (p & m), float("nan"), r)


def order_word(col_data: torch.Tensor, consider: torch.Tensor, dtype,
               op: str) -> torch.Tensor:
    """Total-order u64 word (int64 bits) of a min/max winner stream
    (reference ``radix_bin.py:526``): the sort's radix encoding (Spark
    NaN-largest, -0.0 == 0.0), the op's identity at non-considered
    rows."""
    from ..expr.values import ColV
    from .sort import SortOrder, fixed_radix_keys

    _, vk = fixed_radix_keys(ColV(col_data, consider), dtype,
                             SortOrder(True, True))
    return torch.where(consider, vk, _U64_MAX if op == "min" else _U64_MIN)
