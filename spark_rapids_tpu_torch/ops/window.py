"""Window functions over partition-sorted rows: segmented scans and
boundary arithmetic.

Counterpart of ``spark_rapids_tpu/ops/window.py``. After one sort by
(partition keys, order keys), every window function is O(n) scan
arithmetic (cumsums, a segmented scan for min/max) plus gathers at frame
boundaries. The reference's ``lax.cummax``/``lax.cummin`` of flagged row
indices become one cumsum, one scatter and one gather each
(:func:`last_flag_at_or_before`, :func:`next_flag_after`). The reference's
``lax.associative_scan`` with a segment-reset combiner has no torch
counterpart: :func:`_seg_scan` is a log-step doubling scan (shift by 1,
2, 4, …; combine where the segment ids match), ceil(log2(cap)) passes.

Row indexing convention: arrays are partition-sorted, padding rows last;
``part_start[i]``/``part_end[i]`` give the first/last row index of row
i's partition; ``peer_start``/``peer_end`` the same for its ORDER BY
peer group. Index arrays are int32, as in the reference.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from ..expr.values import ColV


def _iota(cap: int, device) -> torch.Tensor:
    return torch.arange(cap, dtype=torch.int32, device=device)


def _at(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` with indices clipped into range (the reference's
    ``jnp.take(..., mode="clip")``)."""
    return t[idx.long().clamp(0, max(t.shape[0] - 1, 0))]


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _prefix0(x: torch.Tensor) -> torch.Tensor:
    """[0, cumsum(x)...] (length cap + 1)."""
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      torch.cumsum(x, 0, dtype=x.dtype)])


def boundaries_from_radix(part_radix: Sequence[torch.Tensor],
                          order_radix: Sequence[torch.Tensor],
                          live: torch.Tensor):
    """(part_start, part_end, peer_start, peer_end, seg) per row
    (reference ``window.py:28``), from the co-sorted radix key arrays and
    the sorted liveness mask."""
    cap = live.shape[0]
    dev = live.device

    def change(arrs):
        ch = torch.zeros(cap, dtype=torch.bool, device=dev)
        for a in arrs:
            ch = ch | (a != torch.roll(a, 1))
        if cap:
            ch[0] = True
        return ch

    part_change = change(part_radix) & live
    peer_change = (part_change | (change(order_radix) if order_radix
                                  else torch.zeros_like(part_change))) & live
    if cap:
        part_change[0] = live[0]
        peer_change[0] = live[0]

    seg = torch.cumsum(part_change.to(torch.int32), 0, dtype=torch.int32) - 1
    seg = torch.where(live, seg, cap)
    part_start = last_flag_at_or_before(part_change)
    peer_start = last_flag_at_or_before(peer_change)
    part_end = next_flag_after(part_change | ~live) - 1
    peer_end = next_flag_after(peer_change | ~live) - 1
    return part_start, part_end, peer_start, peer_end, seg


def _flag_positions(flags: torch.Tensor, fill: int):
    """(count, pos): ``count[i]`` the flags at or before row i (int32),
    ``pos[k]`` the row of the (k+1)-th flag, ``fill`` past the last (two
    spare slots: ``pos[cap]`` and a dump slot)."""
    cap = flags.shape[0]
    count = torch.cumsum(flags.to(torch.int32), 0, dtype=torch.int32)
    pos = torch.full((cap + 2,), fill, dtype=torch.int32,
                     device=flags.device)
    pos.scatter_(0, torch.where(flags, count - 1, cap + 1).long(),
                 _iota(cap, flags.device))
    return count, pos


def last_flag_at_or_before(flags: torch.Tensor) -> torch.Tensor:
    """The row of the last flag at or before each row, 0 before the first
    flag: the reference's ``lax.cummax(where(flags, iota, 0))``
    (``window.py:56``). One cumsum, one scatter and one gather:
    ``torch.cummax`` of an int32 column took 22 ms at 2^23 rows on the
    H100 (PERF.md §6)."""
    count, pos = _flag_positions(flags, 0)
    prev = torch.cat([torch.zeros(1, dtype=torch.int32, device=pos.device),
                      pos[:-1]])  # prev[k] = the k-th flag's row
    return prev[count.long()]


def next_flag_after(flags: torch.Tensor) -> torch.Tensor:
    """The row of the first flag after each row, or the capacity if none:
    one more than the reference's right-to-left ``lax.cummin``
    (``window.py:60-64``), without torch's slow ``cummin``."""
    count, pos = _flag_positions(flags, flags.shape[0])
    return pos[count.long()]


def row_number(part_start: torch.Tensor, live: torch.Tensor) -> ColV:
    idx = _iota(live.shape[0], live.device)
    return ColV(torch.where(live, idx - part_start + 1, 0), live)


def rank(part_start: torch.Tensor, peer_start: torch.Tensor,
         live: torch.Tensor) -> ColV:
    return ColV(torch.where(live, peer_start - part_start + 1, 0), live)


def dense_rank(part_start: torch.Tensor, peer_start: torch.Tensor,
               live: torch.Tensor) -> ColV:
    cap = live.shape[0]
    idx = _iota(cap, live.device)
    new_peer = (peer_start == idx) & live
    pre = torch.cumsum(new_peer.to(torch.int32), 0, dtype=torch.int32)
    # the prefix at the partition's start row (the reference's cummax of
    # the prefix marked at partition starts)
    base = _at(pre, part_start)
    return ColV(torch.where(live, pre - base + 1, 0), live)


def shift_in_partition(col: ColV, offset: int, part_start: torch.Tensor,
                       part_end: torch.Tensor, live: torch.Tensor,
                       default: Optional[ColV] = None) -> ColV:
    """lead (offset > 0) / lag (offset < 0) within the partition."""
    cap = live.shape[0]
    target = _iota(cap, live.device) + offset
    in_part = (target >= part_start) & (target <= part_end) & live
    data = _at(col.data, target)
    valid = _at(col.validity, target) & in_part
    if default is not None:
        data = torch.where(in_part, data, default.data.to(data.dtype))
        valid = valid | (~in_part & live & default.validity)
    data = torch.where(valid, data, _zero(data))
    return ColV(data, valid & live)


def _seg_scan(values: torch.Tensor, seg: torch.Tensor,
              combine: Callable) -> torch.Tensor:
    """Segmented inclusive scan: ``out[i]`` combines ``values`` over the
    rows j <= i with ``seg[j] == seg[i]`` (segments are contiguous). The
    reference's ``lax.associative_scan`` with a reset-on-new-segment
    combiner (``window.py:113``), as a doubling scan: after the pass with
    shift d, each row holds the combination over its last 2d rows of the
    same segment."""
    out = values
    n = values.shape[0]
    d = 1
    while d < n:
        same = torch.zeros(n, dtype=torch.bool, device=values.device)
        same[d:] = seg[d:] == seg[:-d]
        prev = torch.cat([out[:d], out[:-d]])
        out = torch.where(same, combine(prev, out), out)
        d *= 2
    return out


def _first_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max of an earlier ``a`` and a later ``b`` that keeps ``a`` on a tie
    (0.0 against -0.0), as the CPU engine's strict compare does; NaN is
    the largest value."""
    if not a.is_floating_point():
        return torch.maximum(a, b)
    return torch.where((b > a) | (torch.isnan(b) & ~torch.isnan(a)), b, a)


def _first_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min keeping the earlier ``a`` on a tie (NaN is +inf by then)."""
    if not a.is_floating_point():
        return torch.minimum(a, b)
    return torch.where(b < a, b, a)


def _fills(dtype: torch.dtype):
    """(lowest, highest) of a dtype: -inf/inf, False/True or the integer
    range."""
    if dtype.is_floating_point:
        return -math.inf, math.inf
    if dtype == torch.bool:
        return False, True
    info = torch.iinfo(dtype)
    return info.min, info.max


def bounded_row_agg(op: str, col: Optional[ColV], part_start: torch.Tensor,
                    part_end: torch.Tensor, live: torch.Tensor,
                    lower: int, upper: int) -> ColV:
    """sum/count/min/max over a literal ROWS frame [i+lower, i+upper],
    clamped to the partition (reference ``window.py:125``): prefix sums
    for sum and count, a sparse table of log2(width) static levels for
    min and max."""
    cap = live.shape[0]
    idx = _iota(cap, live.device)
    lo = torch.maximum(idx + lower, part_start)
    hi = torch.minimum(idx + upper, part_end)  # part_end inclusive
    empty = (hi < lo) | ~live
    lo_c = lo.clamp(0, max(cap - 1, 0)).long()
    hi_c = hi.clamp(0, max(cap - 1, 0)).long()

    if op == "count_star":
        cnt = torch.where(empty, 0, hi_c - lo_c + 1)
        return ColV(cnt.to(torch.int64), live)

    valid = live & col.validity

    def window_count():
        pre = _prefix0(valid.to(torch.int64))
        return torch.where(empty, 0, pre[hi_c + 1] - pre[lo_c])

    if op == "count":
        return ColV(window_count(), live)
    if op == "sum":
        x = torch.where(valid, col.data, _zero(col.data))
        pre = _prefix0(x)
        s = torch.where(empty, _zero(x), pre[hi_c + 1] - pre[lo_c])
        has = (window_count() > 0) & ~empty
        return ColV(torch.where(has, s, _zero(s)), has)
    if op in ("min", "max"):
        isfloat = col.data.dtype.is_floating_point
        lowest, highest = _fills(col.data.dtype)
        if op == "max":
            fill = lowest
            combine = _first_max
            x = torch.where(valid, col.data, fill)
        else:
            fill = highest
            combine = _first_min
            x = col.data
            if isfloat:
                # Spark min skips NaN unless the frame is all NaN
                x = torch.where(torch.isnan(x), math.inf, x)
            x = torch.where(valid, x, fill)
        # sparse table: level k answers any range of length in [2^k, 2^(k+1))
        width = upper - lower + 1
        levels = [x]
        k = 1
        while k < width:
            t = levels[-1]
            shifted = torch.cat([t[k:], torch.full((min(k, cap),), fill,
                                                   dtype=t.dtype,
                                                   device=t.device)])[:cap]
            levels.append(combine(t, shifted))
            k *= 2
        table = torch.stack(levels)  # (L, cap): agg over [i, i + 2^k)
        ln = (hi_c - lo_c + 1).to(torch.float64)
        kq = torch.floor(torch.log2(torch.clamp(ln, min=1))).long()
        kq = kq.clamp(0, len(levels) - 1)
        p2 = torch.ones_like(kq) << kq
        a = table[kq, lo_c]
        b = table[kq, (hi_c - p2 + 1).clamp(0, max(cap - 1, 0))]
        r = combine(a, b)
        has = (window_count() > 0) & ~empty
        if op == "min" and isfloat:
            nn = valid & ~torch.isnan(col.data)
            npre = _prefix0(nn.to(torch.int64))
            n_nonnan = torch.where(empty, 0, npre[hi_c + 1] - npre[lo_c])
            r = torch.where((n_nonnan == 0) & has, math.nan, r)
        return ColV(torch.where(has, r, _zero(r)), has)
    raise ValueError(f"unsupported bounded window aggregation {op!r}")


def _search_sorted_in_partition(keys: torch.Tensor, lo0: torch.Tensor,
                                hi0: torch.Tensor, target: torch.Tensor,
                                side: str) -> torch.Tensor:
    """Per-row binary search over [lo0, hi0) of a key array that is
    non-decreasing within each row's slice (reference ``window.py:223``):
    'left' gives the first index with key >= target, 'right' the first
    with key > target. log2(cap) + 1 gather passes."""
    cap = keys.shape[0]
    iters = max(int(math.ceil(math.log2(max(cap, 2)))) + 1, 1)
    lo, hi = lo0, hi0
    for _ in range(iters):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = _at(keys, mid)
        go_right = (v < target) if side == "left" else (v <= target)
        valid = lo < hi
        lo = torch.where(valid & go_right, mid + 1, lo)
        hi = torch.where(valid & ~go_right, mid, hi)
    return lo


def _saturating_offset(kd: torch.Tensor, off) -> torch.Tensor:
    """kd + off with integer saturation (offsets are host literals)."""
    if kd.dtype.is_floating_point:
        return kd + float(off)
    info = torch.iinfo(kd.dtype)
    o = int(off)
    if o >= 0:
        return torch.where(kd > info.max - o, info.max, kd + o)
    return torch.where(kd < info.min - o, info.min, kd + o)


def bounded_range_agg(op: str, col: Optional[ColV], order_key: ColV,
                      part_start: torch.Tensor, part_end: torch.Tensor,
                      peer_start: torch.Tensor, peer_end: torch.Tensor,
                      live: torch.Tensor, lower, upper,
                      nulls_first: bool) -> ColV:
    """sum/count over a literal RANGE frame (reference ``window.py:249``):
    the rows j of the partition with key[j] in [key[i]+lower,
    key[i]+upper]. ``order_key`` is the single numeric ORDER BY key,
    ASC-normalized. A null-key row's frame is its peer group (all nulls)
    on a bounded side. Null keys park at the end they sort to, and the
    searched frame of a non-null row is clamped to the partition's
    non-null span, so a saturated bound at the dtype's edge cannot reach
    the parked nulls (the reference's clamp, ``window.py:266-285``;
    Spark's answer, as the CPU engine's ``_frame_rows``)."""
    cap = live.shape[0]
    kd = order_key.data
    kv = order_key.validity & live
    lowest, highest = _fills(kd.dtype)
    keys = torch.where(kv, kd, lowest if nulls_first else highest)

    nulls = live & ~order_key.validity
    pre_nulls = _prefix0(nulls.to(torch.int32))
    n_nulls = _at(pre_nulls, part_end + 1) - _at(pre_nulls, part_start)
    nn_start = part_start + n_nulls if nulls_first else part_start
    nn_end = part_end if nulls_first else part_end - n_nulls

    if lower is None:
        lo = part_start
    else:
        lo = _search_sorted_in_partition(
            keys, nn_start, nn_end + 1, _saturating_offset(keys, lower),
            "left")
    if upper is None:
        hi = part_end
    else:
        hi = _search_sorted_in_partition(
            keys, nn_start, nn_end + 1, _saturating_offset(keys, upper),
            "right") - 1
    # null current rows: a bounded side lands on the null peer block
    # (nulls are mutual peers); an unbounded side keeps the partition edge
    if lower is not None:
        lo = torch.where(kv, lo, peer_start)
    if upper is not None:
        hi = torch.where(kv, hi, peer_end)
    empty = (hi < lo) | ~live
    lo_c = lo.clamp(0, max(cap - 1, 0)).long()
    hi_c = hi.clamp(0, max(cap - 1, 0)).long()

    if op == "count_star":
        cnt = torch.where(empty, 0, hi_c - lo_c + 1)
        return ColV(cnt.to(torch.int64), live)
    valid = live & col.validity

    def window_count():
        pre = _prefix0(valid.to(torch.int64))
        return torch.where(empty, 0, pre[hi_c + 1] - pre[lo_c])

    if op == "count":
        return ColV(window_count(), live)
    if op == "sum":
        x = torch.where(valid, col.data, _zero(col.data))
        pre = _prefix0(x)
        s = torch.where(empty, _zero(x), pre[hi_c + 1] - pre[lo_c])
        has = (window_count() > 0) & ~empty
        return ColV(torch.where(has, s, _zero(s)), has)
    raise ValueError(f"unsupported bounded-range window aggregation {op!r}")


def running_agg(op: str, col: Optional[ColV], seg: torch.Tensor,
                part_start: torch.Tensor, peer_end: torch.Tensor,
                live: torch.Tensor, range_frame: bool,
                whole_partition: bool, part_end: torch.Tensor) -> ColV:
    """sum/count/min/max over a running or whole-partition frame
    (reference ``window.py:335``). ``range_frame`` takes in the whole
    ORDER BY peer group (RANGE UNBOUNDED..CURRENT); ``whole_partition``
    the full partition. A sum is the global prefix at the frame's end
    minus the prefix before the partition start, as in the reference (so
    an f64 sum carries the rounding of the global prefix)."""
    at = part_end if whole_partition else (peer_end if range_frame else None)

    def frame_value(prefix):
        return prefix if at is None else _at(prefix, at)

    def frame_count(valid):
        v = valid.to(torch.int64)
        pre = torch.cumsum(v, 0)
        return frame_value(pre) - _at(pre - v, part_start)

    if op in ("count", "count_star"):
        valid = live if op == "count_star" else (live & col.validity)
        return ColV(torch.where(live, frame_count(valid), 0), live)
    valid = live & col.validity
    if op == "sum":
        x = torch.where(valid, col.data, _zero(col.data))
        pre = torch.cumsum(x, 0, dtype=x.dtype)
        s = frame_value(pre) - _at(pre - x, part_start)
        has = frame_count(valid) > 0
        return ColV(torch.where(has, s, _zero(s)), has & live)
    if op in ("min", "max"):
        isfloat = col.data.dtype.is_floating_point
        lowest, highest = _fills(col.data.dtype)
        if op == "max":
            x = torch.where(valid, col.data, torch.tensor(
                lowest, dtype=col.data.dtype, device=col.data.device))
            scan = _seg_scan(x, seg, _first_max)
        else:
            x = col.data
            if isfloat:
                # Spark min skips NaN unless all NaN: NaN -> +inf, fixed later
                x = torch.where(torch.isnan(x), math.inf, x)
            x = torch.where(valid, x, torch.tensor(
                highest, dtype=col.data.dtype, device=col.data.device))
            scan = _seg_scan(x, seg, _first_min)
        r = frame_value(scan)
        has = (frame_count(valid) > 0) & live
        if op == "min" and isfloat:
            n_nonnan = frame_count(valid & ~torch.isnan(col.data))
            r = torch.where((n_nonnan == 0) & has, math.nan, r)
        r = torch.where(has, r, _zero(r))
        return ColV(r, has)
    raise ValueError(f"unsupported window aggregation {op!r}")

