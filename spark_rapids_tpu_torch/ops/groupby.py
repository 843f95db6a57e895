"""Group-by aggregation: the hash-bucket tiers and the sort path.

Counterpart of ``spark_rapids_tpu/ops/groupby.py`` for fixed-width and
plain string keys and values:

  * :func:`hash_groupby` — tier 1 (direct range: buckets injective by
    construction, keys rebuilt from the bucket id) and tier 2 (murmur3
    buckets + an exact collision check against each bucket's
    representative row), reducing through ``ops/bucket_reduce.py``;
  * :func:`groupby_agg` — the tier dispatch (``groupby.py:1021-1035``):
    RADIX and SORT skip the hash tiers and take :func:`sort_groupby`;
    the others try the B0/B1/B2 escalation (128, 1024, 8192 buckets)
    and then the sort path;
  * :func:`sort_groupby` — sort by keys, segment, reduce: under RADIX
    and PALLAS every aggregate reduces on the RADIX segment reduction
    (:func:`_radix_groupby`: ``ops/radix_kernels.py``, a hand-written
    kernel on the card, the reference's tile loop in
    ``ops/radix_bin.py`` on the CPU); under SORT sums and counts reduce
    as prefix differences (:func:`_sorted_segment_aggs`); otherwise with
    torch segment ops;
  * :func:`reduce_no_keys` — the grand aggregate;
  * :func:`string_minmax_ranks` — string min/max reduce over int32 rank
    columns (one rank sort per column, shared by its min and max), and
    the winning rows' strings are gathered back.

String keys take :func:`sort_groupby` under every tier, so under PALLAS
and RADIX they reduce on the RADIX segment reduction, as the
reference's do. A
dictionary-encoded key (``DictV``) whose dictionary is unique groups on
its int32 codes through the hash tiers instead, and its output codes are
wrapped back into a DictV; a non-unique one (after a transforming
kernel) materializes and takes the sort path (``groupby.py:983-1017``).
A DictV min/max input ranks by a sort of its dictionary alone
(:func:`_dict_rank`).

Each ``lax.cond`` of the reference becomes a host decision: a ``.item()``
sync on the 0-d result, after which only the taken branch runs, as under
XLA — ``direct_ok`` (``groupby.py:715`` and ``:858``, one sync) and the
collision check per tier (``:1072``, one sync per tier tried).

Exact float sums (no variableFloatAgg) under SCATTER, MATMUL and SORT
stay order-preserving and deterministic on the card: rows are stably
sorted by bucket and each segment is summed serially in row order
(``ordered_segment_sum``), since ``index_add_`` runs on atomics there.
Under RADIX and PALLAS the sort path's float sums take the NORMAL/BIG
streams, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..columnar.column import choose_capacity
from ..expr.values import (ColV, DictV, StrV, Val, dict_gather_col,
                           materialize_dict, val_capacity)
from . import groupby_kernels as K
from . import radix_bin as RB
from . import radix_kernels as RK
from .bucket_reduce import (bucket_equal_check, bucket_min_max,
                            bucket_reduce, contiguous_segment_reduce)
from .filter_gather import gather, gather_string, live_of
from .hashing import murmur3
from .sort import (SIGN64, SortOrder, fixed_radix_keys, next_bound,
                   sort_permutation, sort_with_radix_keys)

#: the describe() reason of a string-keyed aggregate's route
STRING_KEY_ROUTE = "string keys: sort path"
#: the describe() reason of a route on unique dictionary keys
DICT_CODE_ROUTE = "dictionary keys: int32 codes on the hash tiers"


def _seg_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Integer segment sums (int64 ``index_add_``; exact in any order)."""
    acc = torch.zeros(n + 1, dtype=torch.int64, device=vals.device)
    return acc.index_add_(0, K.drop_index(seg, n), vals.to(torch.int64))[:n]


def _seg_extreme(vals: torch.Tensor, seg: torch.Tensor, n: int, op: str,
                 init: int) -> torch.Tensor:
    """int64 segment min/max (``scatter_reduce_``), ``init`` in empty
    segments."""
    acc = torch.full((n + 1,), init, dtype=torch.int64, device=vals.device)
    acc.scatter_reduce_(0, K.drop_index(seg, n), vals.to(torch.int64),
                        "amin" if op == "min" else "amax")
    return acc[:n]


def _ordered_fsum(vals: torch.Tensor, seg: torch.Tensor, n: int,
                  seg_sorted: bool) -> torch.Tensor:
    """Exact-mode float segment sums in row order (see module doc)."""
    if seg.is_cuda and not seg_sorted:
        order = torch.argsort(seg, stable=True)
        seg, vals = seg[order], vals[order]
    return K.ordered_segment_sum(vals, seg, n)


def _winner_words(op: str, data: torch.Tensor, valid: torch.Tensor,
                  seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment min/max of the valid rows' order words (NaN largest,
    -0.0 below 0.0 as the reference's ``segment_min``/``segment_max``
    order raw values: Spark's float min skips NaN unless the group is all
    NaN, max returns NaN when present), decoded to ``data``'s dtype."""
    w = K.bucket_winner_plain(seg, n, op, K._order_words(
        data, ~valid, op, keep_zero_sign=True))
    return K._decode_word(w, data.dtype)


def _plain_rank(v: StrV, num_rows, max_len: int
                ) -> Tuple[torch.Tensor, ColV]:
    """(perm, per-row rank) of a plain string column by one chunk-key
    sort (reference ``groupby.py:181``): ``perm[p]`` is the row holding
    the p-th smallest string, and row ``perm[p]`` has rank p."""
    cap = val_capacity(v)
    perm = sort_permutation([v], [T.STRING], [SortOrder(True, True)],
                            num_rows, [max_len])
    rank = torch.empty(cap, dtype=torch.int32, device=perm.device)
    rank[perm] = torch.arange(cap, dtype=torch.int32, device=perm.device)
    return perm, ColV(rank, v.validity)


def _dict_rank(v: DictV) -> Tuple[torch.Tensor, ColV]:
    """(order, per-row rank) of a DictV (reference ``groupby.py:160``):
    one chunk-key sort of the dictionary alone, bounded by ``max_len``
    (no host sync); ``order[p]`` is the entry holding the p-th smallest
    string, and each row's rank rides its code through one gather."""
    d = v.dictionary
    D = v.dict_size
    order = sort_permutation([d], [T.STRING], [SortOrder(True, True)], D,
                             [max(1, v.max_len)])
    rank = torch.empty(D, dtype=torch.int32, device=order.device)
    rank[order] = torch.arange(D, dtype=torch.int32, device=order.device)
    return order, dict_gather_col(v, ColV(rank, d.validity))


def string_minmax_ranks(value_cols: List[Optional[Val]],
                        agg_ops: Sequence[str], num_rows,
                        str_val_max_lens: Sequence[int] = ()
                        ) -> Dict[int, Callable[[ColV], Val]]:
    """Replace each string min/max input in ``value_cols`` (in place) by
    its rank column (reference ``groupby.py:192``); ``min(s)`` and
    ``max(s)`` over one column share one rank sort. Returns ``recover``:
    aggregate index -> a function from the reduced rank column to the
    winning strings (a row gather; for a DictV, the winning entries'
    codes over its dictionary). ``str_val_max_lens`` bounds each string
    min/max input in turn (each must have one; a DictV's goes unused)."""
    recover: Dict[int, Callable[[ColV], Val]] = {}
    ranks: Dict[int, Tuple[torch.Tensor, ColV]] = {}
    lens = iter(str_val_max_lens)
    for ai, (op, v) in enumerate(zip(agg_ops, value_cols)):
        if op not in ("min", "max") or not isinstance(v, (StrV, DictV)):
            continue
        ml = next_bound(lens)
        if id(v) not in ranks:
            ranks[id(v)] = (_dict_rank(v) if isinstance(v, DictV)
                            else _plain_rank(v, num_rows, ml))
        perm, rank_rows = ranks[id(v)]

        def rec(r: ColV, perm=perm, src=v) -> Val:
            if isinstance(src, DictV):
                codes = perm[r.data.long().clamp(0, max(src.dict_size - 1,
                                                        0))]
                return DictV(codes.to(torch.int32), src.dictionary,
                             r.validity, src.mat_cap, src.max_len,
                             src.unique)
            rows = perm[r.data.long().clamp(0, val_capacity(src) - 1)]
            # winners are distinct source rows: the source pool holds them
            return gather_string(src, rows, r.validity,
                                 int(src.chars.shape[0]))

        value_cols[ai] = rank_rows
        recover[ai] = rec
    return recover


def _recovered(aggs: Sequence[Val], recover) -> List[Val]:
    aggs = list(aggs)
    for ai, rec in recover.items():
        aggs[ai] = rec(aggs[ai])
    return aggs


def segment_ids_from_radix_keys(sorted_radix_keys: Sequence[torch.Tensor],
                                num_rows) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(segment_ids, num_segments) from the co-sorted radix key arrays:
    adjacent rows share a group iff every radix key matches. Padding rows
    get the out-of-range id ``cap``."""
    cap = sorted_radix_keys[0].shape[0]
    dev = sorted_radix_keys[0].device
    eq = torch.ones(cap, dtype=torch.bool, device=dev)
    for k in sorted_radix_keys:
        eq = eq & (k == torch.roll(k, 1))
    live = live_of(num_rows, cap, dev)
    first = torch.arange(cap, device=dev) == 0
    new_seg = live & (~eq | first)
    seg = torch.cumsum(new_seg.to(torch.int32), 0, dtype=torch.int32) - 1
    num_segments = (torch.max(torch.where(live, seg, -1)) + 1).to(torch.int32)
    return torch.where(live, seg, cap), num_segments


def segment_reduce(op: str, col: Optional[ColV], seg: torch.Tensor,
                   ncap: int, live: torch.Tensor,
                   seg_sorted: bool = False) -> ColV:
    """One aggregation over segments. Returns an (ncap,)-shaped ColV."""
    ones = torch.ones(ncap, dtype=torch.bool, device=seg.device)
    if op == "count_star":
        return ColV(_seg_sum(live, seg, ncap), ones)
    valid = col.validity & live
    data = col.data
    cnt = _seg_sum(valid, seg, ncap)
    if op == "count":
        return ColV(cnt, ones)
    has = cnt > 0
    if op == "sum":
        z = torch.where(valid, data, torch.zeros_like(data))
        if data.is_floating_point():
            s = _ordered_fsum(z, seg, ncap, seg_sorted).to(data.dtype)
        else:
            s = _seg_sum(z, seg, ncap).to(data.dtype)  # wraps like the dtype
        return ColV(s, has)
    if op in ("min", "max"):
        r = _winner_words(op, data, valid, seg, ncap)
        return ColV(torch.where(has, r, torch.zeros_like(r)), has)
    if op in ("first", "last", "first_ignorenulls", "last_ignorenulls"):
        cap = data.shape[0]
        idx = torch.arange(cap, dtype=torch.int64, device=data.device)
        consider = valid if op.endswith("ignorenulls") else live
        if op.startswith("first"):
            pos = _seg_extreme(torch.where(consider, idx, cap), seg, ncap,
                               "min", cap)
        else:
            pos = _seg_extreme(torch.where(consider, idx, -1), seg, ncap,
                               "max", -1)
        found = (pos >= 0) & (pos < cap)
        safe = pos.clamp(0, cap - 1)
        vals = data[safe]
        val_valid = col.validity[safe] & found
        return ColV(torch.where(val_valid, vals, torch.zeros_like(vals)),
                    val_valid)
    raise ValueError(f"unknown aggregation op {op!r}")


def _radix_reduce_dtype(dtype: torch.dtype) -> T.DataType:
    """The engine type standing in for a value dtype when only the radix
    encoding family matters (reference ``groupby.py:298``)."""
    if dtype.is_floating_point:
        return T.DOUBLE
    if dtype == torch.bool:
        return T.BOOLEAN
    return T.LONG


def _radix_groupby(key_cols: Sequence[Val],
                   value_cols: Sequence[Optional[ColV]],
                   agg_ops: Sequence[str], perm: torch.Tensor,
                   seg: torch.Tensor, nseg: torch.Tensor, cap: int
                   ) -> Tuple[List[Val], List[ColV], torch.Tensor]:
    """RADIX reduction of the sorted segments (reference
    ``groupby.py:310``): every aggregate is a stream of one
    :func:`radix_kernels.segment_reduce` call over the sort's order, the
    columns staying in ORIGINAL row order. Integer sums and counts are
    bit for bit the other tiers'; float sums take the NORMAL/BIG/flag
    split; min/max/first/last reduce as winner rows by the sort's order
    words; the group keys are gathered at each segment's first row.
    The streams are those of the reference's plan, in its order, so the
    reference's tile length (:func:`radix_bin.default_tile_rows`), which
    decides max's ties across tiles, is computed from the same count."""
    streams: List[RK.Stream] = []
    plan: List[tuple] = []
    cnt_idx: dict = {}
    n_ref = 0  # the reference's stream count (radix_bin.py:249)

    def stream(s: RK.Stream, ref_streams: int) -> int:
        nonlocal n_ref
        streams.append(s)
        n_ref += ref_streams
        return len(streams) - 1

    def want_count(valid, key):
        if key not in cnt_idx:
            cnt_idx[key] = stream(RK.Stream("count", valid=valid), 1)
        return cnt_idx[key]

    # the group-representative (first live) row, for key output
    stream(RK.Stream("pos", op="min"), 1)
    for ai, (op, v) in enumerate(zip(agg_ops, value_cols)):
        if op == "count_star":
            plan.append(("cnt", want_count(None, ("star",))))
        elif op == "count":
            plan.append(("cnt", want_count(v.validity, ("c", ai))))
        elif op == "sum" and not v.data.is_floating_point():
            ci = want_count(v.validity, ("c", ai))
            si = stream(RK.Stream("isum", v.data, v.validity), 1)
            plan.append(("isum", (si, ci, v.data.dtype)))
        elif op == "sum":
            ci = want_count(v.validity, ("c", ai))
            # normal, big and the flag stream: three of the reference's
            fi = stream(RK.Stream("fsum", v.data, v.validity), 3)
            plan.append(("fsum", (fi, ci, v.data.dtype)))
        elif op in ("min", "max"):
            word = RB.order_word(v.data, v.validity,
                                 _radix_reduce_dtype(v.data.dtype), op)
            wi = stream(RK.Stream("win", word, v.validity, op), 2)
            plan.append(("row", (wi, v)))
        elif op in ("first", "last", "first_ignorenulls",
                    "last_ignorenulls"):
            cons = v.validity if op.endswith("ignorenulls") else None
            pi = stream(RK.Stream("pos", None, cons, "min" if
                                  op.startswith("first") else "max"), 1)
            plan.append(("row", (pi, v)))
        else:
            raise ValueError(f"unknown aggregation op {op!r}")

    tile = min(RB.default_tile_rows(cap, n_ref), max(8, cap))
    out = RK.segment_reduce(perm, seg, streams, tile)
    dev = perm.device
    out_live = torch.arange(cap, dtype=torch.int32, device=dev) < nseg
    ones = torch.ones(cap, dtype=torch.bool, device=dev)

    def row_col(rw: torch.Tensor, v: ColV) -> ColV:
        safe = rw.to(torch.int64).clamp(0, max(cap - 1, 0))
        vv = v.validity[safe] & (rw >= 0)
        vals = v.data[safe]
        return ColV(torch.where(vv, vals, torch.zeros_like(vals)), vv)

    out_aggs: List[ColV] = []
    for kind, payload in plan:
        if kind == "cnt":
            out_aggs.append(ColV(out[payload][0], ones))
        elif kind == "isum":
            si, ci, dt = payload
            has = out[ci][0] > 0
            data = out[si][0].to(dt)  # mod 2^32 of a mod 2^64 sum: exact
            out_aggs.append(ColV(torch.where(has, data,
                                             torch.zeros_like(data)), has))
        elif kind == "fsum":
            fi, ci, dt = payload
            has = out[ci][0] > 0
            sm = RB.combine_float_sum(*out[fi]).to(dt)
            out_aggs.append(ColV(torch.where(has, sm, torch.zeros_like(sm)),
                                 has))
        else:
            ri, v = payload
            out_aggs.append(row_col(out[ri][0], v))
    rep = out[0][0].to(torch.int64).clamp(0, max(cap - 1, 0))
    out_keys = gather(key_cols, rep, out_live)
    out_aggs = [ColV(torch.where(out_live, a.data, torch.zeros_like(a.data)),
                     a.validity & out_live) for a in out_aggs]
    return out_keys, out_aggs, nseg


def _sorted_segment_aggs(agg_ops: Sequence[str],
                         sorted_vals: Sequence[Optional[ColV]],
                         seg: torch.Tensor, ncap: int,
                         live: torch.Tensor) -> List[ColV]:
    """The SORT tier's reduction over already-sorted segment ids
    (reference ``groupby.py:242``): integer sums, counts and count(*)
    in one prefix-difference pass (``bucket_reduce.
    contiguous_segment_reduce``), bit for bit :func:`segment_reduce`'s;
    float sums and min/max/first/last keep the segment path."""
    int_specs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    cnt_specs: List[torch.Tensor] = []
    plan: List[tuple] = []
    for op, v in zip(agg_ops, sorted_vals):
        if op == "count_star":
            plan.append(("cnt", len(cnt_specs)))
            cnt_specs.append(live)
        elif op == "count":
            plan.append(("cnt", len(cnt_specs)))
            cnt_specs.append(v.validity & live)
        elif op == "sum" and not v.data.is_floating_point():
            ci = len(cnt_specs)
            cnt_specs.append(v.validity & live)
            plan.append(("isum", (len(int_specs), ci, v.data.dtype)))
            int_specs.append((v.data, v.validity & live))
        else:
            plan.append(("seg", (op, v)))
    isums, counts, _ = contiguous_segment_reduce(seg, ncap, int_specs,
                                                 cnt_specs, ())
    ones = torch.ones(ncap, dtype=torch.bool, device=seg.device)
    out: List[ColV] = []
    for kind, payload in plan:
        if kind == "cnt":
            out.append(ColV(counts[payload], ones))
        elif kind == "isum":
            si, ci, dt = payload
            has = counts[ci] > 0
            data = isums[si].to(dt)
            out.append(ColV(torch.where(has, data, torch.zeros_like(data)),
                            has))
        else:
            op, v = payload
            out.append(segment_reduce(op, v, seg, ncap, live,
                                      seg_sorted=True))
    return out


def sort_groupby(key_cols: Sequence[Val], key_dtypes: Sequence[T.DataType],
                 value_cols: Sequence[Optional[ColV]],
                 agg_ops: Sequence[str], num_rows,
                 str_max_lens: Sequence[int] = (),
                 prefix_reduce: bool = False,
                 radix_reduce: bool = False
                 ) -> Tuple[List[Val], List[ColV], torch.Tensor]:
    """Group-by via sort: sort by keys (``str_max_lens`` bounds the
    string keys in turn), segment, reduce (reference ``groupby.py:466``).
    Outputs are compacted to the front at the input capacity.
    ``prefix_reduce`` (SORT) reduces sums and counts as prefix
    differences (:func:`_sorted_segment_aggs`); ``radix_reduce`` (RADIX,
    and PALLAS's fallback) reduces every aggregate on the RADIX segment
    reduction (:func:`_radix_groupby`)."""
    cap = key_cols[0].validity.shape[0]
    dev = key_cols[0].validity.device
    orders = [SortOrder(True, True) for _ in key_cols]
    perm, radix = sort_with_radix_keys(key_cols, key_dtypes, orders, num_rows,
                                       str_max_lens)
    live = live_of(num_rows, cap, dev)[perm]
    seg, nseg = segment_ids_from_radix_keys(
        [k for ks in radix for k in ks], live)
    if radix_reduce:
        return _radix_groupby(key_cols, value_cols, agg_ops, perm, seg,
                              nseg, cap)
    sorted_keys = gather(key_cols, perm, live)
    sorted_vals = [None if v is None else gather([v], perm, live)[0]
                   for v in value_cols]
    # representative (first) row of each segment, for key output
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    first_row = _seg_extreme(torch.where(live, idx, cap), seg, cap, "min",
                             cap).clamp(0, cap - 1)
    out_live = torch.arange(cap, dtype=torch.int32, device=dev) < nseg
    out_keys = gather(sorted_keys, first_row, out_live)
    if prefix_reduce:
        out_aggs = _sorted_segment_aggs(agg_ops, sorted_vals, seg, cap, live)
    else:
        out_aggs = [segment_reduce(op, v, seg, cap, live, seg_sorted=True)
                    for op, v in zip(agg_ops, sorted_vals)]
    out_aggs = [ColV(torch.where(out_live, a.data, torch.zeros_like(a.data)),
                     a.validity & out_live) for a in out_aggs]
    return out_keys, out_aggs, nseg


def _int_bounds(dtype: torch.dtype) -> Tuple[int, int]:
    info = torch.iinfo(dtype)
    return info.min, info.max


def reduce_no_keys(value_cols: Sequence[Optional[Val]],
                   agg_ops: Sequence[str], num_rows,
                   device=None, str_val_max_lens: Sequence[int] = ()
                   ) -> List[Val]:
    """Grand aggregate (no grouping keys): one output row. String
    min/max reduce through their ranks (:func:`string_minmax_ranks`)."""
    if not value_cols:
        return []
    value_cols = list(value_cols)
    recover = string_minmax_ranks(value_cols, agg_ops, num_rows,
                                  str_val_max_lens)
    present = [v for v in value_cols if v is not None]
    if not present:
        # only count(*) over an implicit capacity
        if isinstance(num_rows, torch.Tensor) and num_rows.dtype == torch.bool:
            cnt = num_rows.to(torch.int64).sum().reshape(1)
        else:
            cnt = torch.as_tensor(num_rows, dtype=torch.int64,
                                  device=device).reshape(1)
        return [ColV(cnt, torch.ones(1, dtype=torch.bool, device=cnt.device))
                for _ in agg_ops]
    cap = present[0].validity.shape[0]
    live = live_of(num_rows, cap, present[0].validity.device)
    outs: List[ColV] = []
    for op, v in zip(agg_ops, value_cols):
        r = _reduce_one(op, v, live)
        if r is None:
            r = segment_reduce(op, v, torch.where(live, 0, 1), 1, live)
        outs.append(r)
    return _recovered(outs, recover)


def _reduce_one(op: str, col: Optional[ColV],
                live: torch.Tensor) -> Optional[ColV]:
    """Grand-aggregate reduction as a plain masked reduce; None for the
    ops that need the segment path (first/last)."""
    one = torch.ones(1, dtype=torch.bool, device=live.device)
    if op == "count_star":
        return ColV(live.to(torch.int64).sum().reshape(1), one)
    valid = col.validity & live
    data = col.data
    if op == "count":
        return ColV(valid.to(torch.int64).sum().reshape(1), one)
    has = torch.any(valid).reshape(1)
    if op == "sum":
        s = torch.where(valid, data, torch.zeros_like(data)).sum()
        return ColV(s.to(data.dtype).reshape(1), has)
    if op in ("min", "max"):
        if data.is_floating_point():
            # order words: NaN largest, -0.0 below 0.0 (the reference's
            # jnp.min/jnp.max on raw values)
            w = K._order_words(data, ~valid, op, keep_zero_sign=True) ^ SIGN64
            r = K._decode_word((w.amax() if op == "max" else w.amin())
                               ^ SIGN64, data.dtype)
        elif data.dtype == torch.bool:
            d = torch.where(valid, data, op == "min").to(torch.uint8)
            r = (d.amax() if op == "max" else d.amin()).to(torch.bool)
        else:
            lo, hi = _int_bounds(data.dtype)
            d = torch.where(valid, data, lo if op == "max" else hi)
            r = d.amax() if op == "max" else d.amin()
        r = r.reshape(1)
        return ColV(torch.where(has, r, torch.zeros_like(r)), has)
    return None


def hash_groupby(key_cols: Sequence[ColV], key_dtypes: Sequence[T.DataType],
                 value_cols: Sequence[Optional[ColV]],
                 agg_ops: Sequence[str], num_rows, num_buckets: int,
                 approx_float_sum: bool = False,
                 reduce_strategy: Optional[str] = None
                 ) -> Tuple[List[ColV], List[ColV], torch.Tensor,
                            torch.Tensor]:
    """O(n) group-by over ``num_buckets`` buckets (see module doc).

    Returns (out_keys, out_aggs, num_groups, collision_free); outputs are
    bucket-compacted to the front at the input capacity."""
    cap = key_cols[0].validity.shape[0]
    dev = key_cols[0].validity.device
    B = num_buckets
    live = live_of(num_rows, cap, dev)
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    kernels = reduce_strategy == "PALLAS"

    # --- tier 1: direct-range binning -------------------------------------
    direct_capable = all(not dt.is_floating for dt in key_dtypes)
    direct = False
    mns, spans, strides = [], [], []
    if direct_capable:
        direct_ok = torch.any(live)
        stride = torch.ones((), dtype=torch.int64, device=dev)
        bucket_direct = torch.zeros(cap, dtype=torch.int64, device=dev)
        for c in key_cols:
            d = c.data.to(torch.int64)
            lv = live & c.validity
            has_val = torch.any(lv)
            mn = torch.where(has_val, torch.where(lv, d, 2**62).min(), 0)
            mx = torch.where(has_val, torch.where(lv, d, -(2**62)).max(), -1)
            # exact unsigned range: mx - mn wraps into the u64 pattern
            ru = mx - mn
            span = torch.where((ru >= 0) & (ru < B), ru + 2, B + 1)
            kidx = torch.where(c.validity, (d - mn) + 1, 0)
            bucket_direct = bucket_direct + kidx * stride
            mns.append(mn)
            spans.append(span)
            strides.append(stride)
            stride = stride * span
            direct_ok = direct_ok & (stride <= B)
        bucket_direct = bucket_direct.clamp(0, B - 1).to(torch.int32)
        direct = bool(direct_ok.item())  # host sync: groupby.py:715/:858
    if direct:
        bucket = bucket_direct
    else:
        h = murmur3(list(key_cols), list(key_dtypes))
        bucket = (h.to(torch.int64) & (B - 1)).to(torch.int32)
    seg = torch.where(live, bucket, B)  # out-of-range ids drop everywhere

    # --- reductions: every sum/count in one pass per family; min/max
    # batched per (op, dtype) family ---------------------------------------
    int_specs, cnt_specs, flt_specs = [], [], []
    plan = []
    cnt_index: dict = {}
    mm_fam: dict = {}

    def want_count(valid, key):
        if key not in cnt_index:
            cnt_index[key] = len(cnt_specs)
            cnt_specs.append(valid)
        return cnt_index[key]

    live_count_i = want_count(live, ("star",))  # also drives `occupied`
    for ai, (op, v) in enumerate(zip(agg_ops, value_cols)):
        if op == "count_star":
            plan.append(("count", live_count_i))
        elif op == "count":
            plan.append(("count", want_count(v.validity & live, ("c", ai))))
        elif op == "sum" and not v.data.is_floating_point():
            ci = want_count(v.validity & live, ("c", ai))
            int_specs.append((v.data, v.validity & live))
            plan.append(("isum", (len(int_specs) - 1, ci)))
        elif op == "sum" and (approx_float_sum or kernels):
            # PALLAS forces the order-insensitive kernel path even for
            # exact float sums, as in the reference (groupby.py:745-753)
            ci = want_count(v.validity & live, ("c", ai))
            flt_specs.append((v.data, v.validity & live))
            plan.append(("fsum", (len(flt_specs) - 1, ci)))
        elif op == "sum":
            ci = want_count(v.validity & live, ("c", ai))
            plan.append(("fsum_exact", (v, ci)))
        elif op in ("min", "max"):
            valid = v.validity & live
            data = v.data
            ci = want_count(valid, ("c", ai))
            nn_ci = None
            if data.is_floating_point():
                if op == "max":
                    d = torch.where(valid, data, float("-inf"))
                else:
                    nn_ci = want_count(valid & ~torch.isnan(data), ("nn", ai))
                    nan_as_inf = torch.where(torch.isnan(data), float("inf"),
                                             data)
                    d = torch.where(valid, nan_as_inf, float("inf"))
            elif data.dtype == torch.bool:
                d = torch.where(valid, data, op == "min")
            else:
                lo, hi = _int_bounds(data.dtype)
                d = torch.where(valid, data, lo if op == "max" else hi)
            fam = mm_fam.setdefault((op, d.dtype), [])
            plan.append(("minmax", (op, d.dtype, len(fam), ci, nn_ci)))
            fam.append(d)
        elif kernels:
            plan.append(("kernel_pos", (op, v)))  # first/last on K3
        else:
            plan.append(("scatter", (op, v)))  # first/last

    isums, counts, fsums = bucket_reduce(seg, B, int_specs, cnt_specs,
                                         flt_specs, strategy=reduce_strategy)
    mm_results = {k: bucket_min_max(seg, B, k[0], cols_,
                                    strategy=reduce_strategy)
                  for k, cols_ in mm_fam.items()}
    occupied = counts[live_count_i] > 0
    ngroups = occupied.to(torch.int32).sum().to(torch.int32)

    # --- group keys + collision status (the taken tier only) --------------
    if direct:
        bucket_ids = torch.arange(B, dtype=torch.int64, device=dev)
        key_tables = []
        for c, mn, span, stride in zip(key_cols, mns, spans, strides):
            kidx = torch.div(bucket_ids, stride,
                             rounding_mode="floor") % span  # 0 = null slot
            val = (mn + kidx - 1).to(c.data.dtype)
            valid = (kidx > 0) & occupied
            key_tables.append((torch.where(valid, val, torch.zeros_like(val)),
                               valid))
        collision_free = torch.ones((), dtype=torch.bool, device=dev)
    else:
        if kernels:
            rep0, _ = K.kernel_bucket_position(seg, B, "min", live)
            rep_row = rep0.to(torch.int64).clamp(0, cap - 1)
        else:
            rep_row = _seg_extreme(torch.where(live, idx, cap), seg, B,
                                   "min", cap).clamp(0, cap - 1)
        order = SortOrder(True, True)
        words: List[torch.Tensor] = []
        # one nullpack word per 16 keys: 2-bit null ranks must not alias
        nullpacks = [torch.zeros(cap, dtype=torch.int64, device=dev)
                     for _ in range((len(key_cols) + 15) // 16)]
        for i, (c, dt) in enumerate(zip(key_cols, key_dtypes)):
            null_rank, vk = fixed_radix_keys(c, dt, order)
            nullpacks[i // 16] = nullpacks[i // 16] | (null_rank
                                                       << (2 * (i % 16)))
            words.append(vk)  # the whole radix word: equal iff both halves
        words.extend(nullpacks)
        collision_free = torch.ones((), dtype=torch.bool, device=dev)
        for w in words:
            rep_table = torch.where(occupied, w[rep_row], 0)
            collision_free = collision_free & bucket_equal_check(
                seg, B, w, rep_table, live)
        key_tables = []
        for c in key_cols:
            kd = c.data[rep_row]
            kv = c.validity[rep_row] & occupied
            key_tables.append((torch.where(kv, kd, torch.zeros_like(kd)), kv))

    # --- bucket compaction: present buckets to the front, padded up to the
    # input capacity (reference groupby.py:883) ---------------------------
    bucket_of_slot = torch.argsort((~occupied).to(torch.int32), stable=True)
    slot_live = torch.arange(B, dtype=torch.int32, device=dev) < ngroups
    pad = cap - B

    def to_slots(arr, valid):
        d = arr[bucket_of_slot]
        vv = valid[bucket_of_slot] & slot_live
        d = torch.where(vv, d, torch.zeros_like(d))
        if pad > 0:
            d = torch.cat([d, torch.zeros(pad, dtype=d.dtype, device=dev)])
            vv = torch.cat([vv, torch.zeros(pad, dtype=torch.bool,
                                            device=dev)])
        return ColV(d, vv)

    out_keys = [to_slots(kd, kv) for kd, kv in key_tables]
    ones_b = torch.ones(B, dtype=torch.bool, device=dev)
    out_aggs: List[ColV] = []
    for (kind, payload), v in zip(plan, value_cols):
        if kind == "count":
            out_aggs.append(to_slots(counts[payload], ones_b))
        elif kind == "isum":
            si, ci = payload
            out_aggs.append(to_slots(isums[si].to(v.data.dtype),
                                     counts[ci] > 0))
        elif kind == "fsum":
            si, ci = payload
            out_aggs.append(to_slots(fsums[si].to(v.data.dtype),
                                     counts[ci] > 0))
        elif kind == "fsum_exact":
            sv, ci = payload
            z = torch.where(sv.validity & live, sv.data,
                            torch.zeros_like(sv.data))
            sm = _ordered_fsum(z, seg, B, seg_sorted=False)
            out_aggs.append(to_slots(sm.to(sv.data.dtype), counts[ci] > 0))
        elif kind == "minmax":
            mop, mdt, fi, ci, nn_ci = payload
            r = mm_results[(mop, mdt)][fi]
            has = counts[ci] > 0
            if nn_ci is not None:
                # all-NaN group: min skips NaN unless nothing else exists
                r = torch.where((counts[nn_ci] == 0) & has, float("nan"), r)
            out_aggs.append(to_slots(torch.where(has, r, torch.zeros_like(r)),
                                     has))
        elif kind == "kernel_pos":
            sop, sv = payload
            consider = (sv.validity & live if sop.endswith("ignorenulls")
                        else live)
            wop = "min" if sop.startswith("first") else "max"
            row, found = K.kernel_bucket_position(seg, B, wop, consider)
            safe = row.to(torch.int64).clamp(0, cap - 1)
            vals = sv.data[safe]
            vv = sv.validity[safe] & found
            out_aggs.append(to_slots(
                torch.where(vv, vals, torch.zeros_like(vals)), vv))
        else:
            sop, sv = payload
            r = segment_reduce(sop, sv, seg, B, live)
            out_aggs.append(to_slots(r.data, r.validity))
    return out_keys, out_aggs, ngroups, collision_free


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1) if x & (x - 1) else x


def groupby_agg(key_cols: Sequence[Val], key_dtypes: Sequence[T.DataType],
                value_cols: Sequence[Optional[Val]], agg_ops: Sequence[str],
                num_rows, approx_float_sum: bool = False,
                num_buckets: int = 8192, strategy: Optional[str] = None,
                str_max_lens: Sequence[int] = (),
                str_val_max_lens: Sequence[int] = (),
                routes: Optional[List[str]] = None
                ) -> Tuple[List[Val], List[Val], torch.Tensor]:
    """Adaptive group-by: narrow hash tiers first, escalating to wider
    ones and then the sort fallback only when the keys do not fit
    (``groupby.py:1040-1080``). Each tier's collision check is a host
    decision; only the taken path runs. RADIX and SORT skip the hash
    tiers (``groupby.py:1021-1035``). Plain string keys take the sort
    path (``str_max_lens`` bounds every string key in turn, dictionary
    ones included); a unique DictV key groups on its codes and comes back
    a DictV, a non-unique one materializes (``groupby.py:983-1017``).
    String min/max inputs reduce as rank columns (``str_val_max_lens``)
    on whichever path runs. ``routes``, when given, receives the string
    key route taken (:data:`DICT_CODE_ROUTE`, :data:`STRING_KEY_ROUTE`)."""
    for dt in key_dtypes:
        T.check_storable(dt)
    if not key_cols:
        raise ValueError("groupby_agg needs keys; use reduce_no_keys")
    value_cols = list(value_cols)
    recover = string_minmax_ranks(value_cols, agg_ops, num_rows,
                                  str_val_max_lens)
    key_cols, key_dtypes, code_keys, str_max_lens = _dict_keys(
        key_cols, key_dtypes, str_max_lens)
    cap = key_cols[0].validity.shape[0]
    B2 = _pow2_floor(min(cap, num_buckets))
    B1 = min(1024, B2)
    B0 = min(128, B1)
    tiers = [B0] + [b for b, below in ((B1, B0), (B2, B1)) if b > below]
    str_keys = any(isinstance(c, StrV) for c in key_cols)
    if str_keys or strategy in ("RADIX", "SORT"):
        tiers = []  # string keys, RADIX and SORT: the sort path
    if routes is not None:
        for route, taken in ((DICT_CODE_ROUTE, code_keys),
                             (STRING_KEY_ROUTE, str_keys)):
            if taken and route not in routes:
                routes.append(route)
    for B in tiers:
        hk, ha, hn, ok = hash_groupby(
            list(key_cols), key_dtypes, value_cols, agg_ops, num_rows, B,
            approx_float_sum=approx_float_sum, reduce_strategy=strategy)
        if bool(ok.item()):  # host sync: groupby.py:1072
            return _rewrapped(hk, code_keys), _recovered(ha, recover), hn
    # PALLAS's string and fallback path reduces on the RADIX tiles, so the
    # plan stays scatter-free (groupby.py:1023-1026)
    keys, aggs, n = sort_groupby(key_cols, key_dtypes, value_cols, agg_ops,
                                 num_rows, str_max_lens,
                                 prefix_reduce=strategy == "SORT",
                                 radix_reduce=strategy in ("RADIX",
                                                           "PALLAS"))
    return _rewrapped(keys, code_keys), _recovered(aggs, recover), n


def _dict_keys(key_cols: Sequence[Val], key_dtypes: Sequence[T.DataType],
               str_max_lens: Sequence[int]):
    """The DictV keys made groupable (reference ``groupby.py:983-1001``):
    a unique one becomes an INT key of its codes (null slots zeroed), a
    non-unique one materializes. Returns the keys, their dtypes, the
    code keys (key index -> DictV) and the byte bounds of the string
    keys left."""
    key_cols, key_dtypes = list(key_cols), list(key_dtypes)
    code_keys: Dict[int, DictV] = {}
    lens = iter(str_max_lens)
    left: List[int] = []
    for i, c in enumerate(key_cols):
        if isinstance(c, DictV):
            bound = next_bound(lens)
            if c.unique:
                key_cols[i] = ColV(torch.where(c.validity, c.codes, 0).to(
                    torch.int32), c.validity)
                key_dtypes[i] = T.INT
                code_keys[i] = c
            else:
                key_cols[i] = materialize_dict(c)
                left.append(bound)
        elif isinstance(c, StrV):
            left.append(next_bound(lens))
    return key_cols, key_dtypes, code_keys, left


def _rewrapped(keys: Sequence[Val], code_keys: Dict[int, DictV]
               ) -> List[Val]:
    """Code key outputs back as DictVs over their dictionaries
    (reference ``groupby.py:1003``). The groups are a subset of the input
    rows, so the input's ``mat_cap`` bounds the materialized pool; a sole
    key holds each entry once, so the dictionary's bytes bound it too.
    (The reference takes the dictionary's bytes beside other keys as
    well, where one entry can head many groups: ROADMAP.md §C.)"""
    keys = list(keys)
    for i, t in code_keys.items():
        k = keys[i]
        mat_cap = t.mat_cap
        if len(keys) == 1:
            mat_cap = min(mat_cap, choose_capacity(
                max(1, int(t.dictionary.chars.shape[0])), 128))
        keys[i] = DictV(k.data.to(torch.int32), t.dictionary, k.validity,
                        mat_cap, t.max_len, True)
    return keys
