"""Distributed SQL operators over the mesh: group-by, sort and join.

Counterpart of ``spark_rapids_tpu/parallel/distributed.py``: each
composes the single-device ops (``ops/groupby.py``, ``ops/sort.py``,
``ops/join.py``) with the exchange of ``collective.py``, the reference's
"PARTIAL aggregate -> shuffle -> FINAL aggregate", "range partition ->
local sort" and "hash partition both sides -> local join" plans. The
reference traces each into one SPMD program; here each is a loop over
the shards around the collectives, and every per-shard list holds shard
``s``'s values on ``devices[s]``.

Tier choice. Inside ``shard_map`` the reference passes no strategy, so
its per-shard aggregates take its backend default (MATMUL on an
accelerator, SCATTER on the CPU) and its probe DIRECT. The port's callers
resolve the tier the way its single-device execs do on the same device
and conf (``exec/mesh.py``) and pass it in: on the card under
``sql.agg.strategy=AUTO`` an aggregate takes PALLAS (the hand kernels
K1-K3, RADIX on the sort fallback) or SCATTER where exact float sums are
asked for, and the probe takes the join chooser's tier. The tiers agree
bit for bit on integers and within the suite's float tolerance.

Host syncs: none of their own; the per-shard ops keep theirs (the
group-by tiers' collision checks, the sort's skip of a constant rank
word, DIRECT's range check), once per shard.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..expr.values import ColV, StrV, Val
from ..ops import groupby as groupby_ops
from ..ops import hashing
from ..ops import join as join_ops
from ..ops.filter_gather import gather, live_of
from ..ops.sort import SortOrder, sort_permutation
from ..shuffle.partition import count_bounds_le, range_key_words
from .collective import all_to_all_exchange


def dist_groupby(
    shard_keys: Sequence[Sequence[Val]],
    key_dtypes: Sequence[T.DataType],
    shard_vals: Sequence[Sequence[Optional[Val]]],
    update_ops: Sequence[str],
    merge_ops: Sequence[str],
    shard_rows: Sequence,
    devices: Sequence[torch.device],
    str_max_lens: Sequence[int] = (),
    group_cap: int = 0,
    strategy: Optional[str] = None,
    approx_float_sum: bool = False,
) -> Tuple[List[List[Val]], List[List[Val]], List[torch.Tensor],
           torch.Tensor]:
    """PARTIAL local aggregate -> key-hash exchange -> FINAL merge.

    ``update_ops`` aggregate raw inputs into per-shard partials;
    ``merge_ops`` combine partial buffers after the exchange. Group keys
    end up shard-disjoint, so the result is the concatenation of every
    shard's output.

    ``group_cap`` sizes the exchange to the GROUP cardinality: each
    shard's PARTIAL output (groups compacted to the front) is sliced to
    ``group_cap`` rows before it crosses, so the receive surface is
    n_shards x group_cap. A shard whose partial made more groups reports
    ``ok`` = False (the results are then truncated; callers retry with a
    doubled cap). 0 disables slicing. Fixed-width columns only: string
    group keys keep the full-capacity exchange.

    Returns (keys, aggs, count) per shard and the global ``ok``."""
    n = len(devices)
    parts = []
    oks = []
    for keys, vals, rows in zip(shard_keys, shard_vals, shard_rows):
        # PARTIAL: the local group-by shrinks rows before they cross
        pkeys, paggs, pn = groupby_ops.groupby_agg(
            list(keys), key_dtypes, list(vals), list(update_ops), rows,
            approx_float_sum=approx_float_sum, strategy=strategy,
            str_max_lens=str_max_lens)
        all_cols = list(pkeys) + list(paggs)
        pn = torch.as_tensor(pn, dtype=torch.int32,
                             device=all_cols[0].validity.device)
        cap = all_cols[0].validity.shape[0]
        if 0 < group_cap < cap and all(type(c) is ColV for c in all_cols):
            oks.append(pn <= group_cap)
            all_cols = [ColV(c.data[:group_cap], c.validity[:group_cap])
                        for c in all_cols]
            pn = pn.clamp(max=group_cap)
        parts.append((all_cols, pn))
    nk = len(key_dtypes)

    # exchange by key hash (the murmur3 + pmod of the single-process
    # exchange); string keys cross on the collective's byte plane
    pids = [hashing.partition_ids(
        hashing.murmur3(cols[:nk], list(key_dtypes),
                        str_max_lens=str_max_lens), n)
        for cols, _ in parts]
    recvd, rn, ok = all_to_all_exchange(
        [cols for cols, _ in parts], pids, [pn for _, pn in parts],
        devices)
    if oks:
        ok = ok & torch.stack([o.to(ok.device) for o in oks]).all()

    # FINAL: merge the partial buffers locally (keys now shard-disjoint)
    fkeys, faggs, fns = [], [], []
    for cols, cnt in zip(recvd, rn):
        k, a, fn = groupby_ops.groupby_agg(
            cols[:nk], key_dtypes, cols[nk:], list(merge_ops), cnt,
            approx_float_sum=approx_float_sum, strategy=strategy,
            str_max_lens=str_max_lens)
        fkeys.append(k)
        faggs.append(a)
        fns.append(fn)
    return fkeys, faggs, fns, ok


def _lex_sort_perm(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic order over parallel signed-ordered words,
    most significant first (one stable ``argsort`` a word, least
    significant first)."""
    perm = torch.arange(words[0].shape[0], device=words[0].device)
    for w in reversed(list(words)):
        perm = perm[torch.argsort(w[perm], stable=True)]
    return perm


def _sample_bounds(
    shard_words: Sequence[Sequence[torch.Tensor]],
    shard_live: Sequence[torch.Tensor],
    n_shards: int,
    samples_per_shard: int = 64,
) -> List[torch.Tensor]:
    """Device-side bound sampling: each shard contributes an evenly
    spaced sample of its SORTED keys, the samples gather on the first
    shard's device, and the (n_shards - 1) quantiles of their sorted
    union become the range bounds (reference: GpuRangePartitioner's
    sketch, with no round trip through the host). Returns the bound
    words there."""
    dev = shard_live[0].device
    samples, has = [], []
    for words, live in zip(shard_words, shard_live):
        cap = words[0].shape[0]
        n = live.sum(dtype=torch.int64)
        # int64: position x live rows passes 2^31 at 2^25 rows a shard
        pos = (torch.arange(samples_per_shard, dtype=torch.int64,
                            device=live.device)
               * n.clamp(min=1) // samples_per_shard).clamp(0, cap - 1)
        has.append((torch.arange(samples_per_shard, dtype=torch.int32,
                                 device=live.device)
                    < n.clamp(max=samples_per_shard)).to(dev))
        samples.append([w[pos].to(dev) for w in words])
    g_words = [torch.cat(ws) for ws in zip(*samples)]
    g_has = torch.cat(has)
    total = samples_per_shard * n_shards
    # dead samples last: the has-rank is the most significant key
    perm = _lex_sort_perm([(~g_has).to(torch.int64)] + g_words)
    g_n = g_has.sum(dtype=torch.int32)
    bpos = (torch.arange(1, n_shards, dtype=torch.int32, device=dev)
            * g_n.clamp(min=1) // n_shards).clamp(0, total - 1)
    return [w[perm][bpos.long()] for w in g_words]


def dist_sort(
    shard_cols: Sequence[Sequence[Val]],
    key_indices: Sequence[int],
    key_dtypes: Sequence[T.DataType],
    orders: Sequence[SortOrder],
    shard_rows: Sequence,
    devices: Sequence[torch.device],
    str_max_lens: Sequence[int] = (),
    bucket_cap: int = 0,
) -> Tuple[List[List[Val]], List[torch.Tensor], torch.Tensor]:
    """Sample-range exchange + local sort: shard i's rows all precede
    shard i+1's in the requested order (the global sort contract).

    ``bucket_cap`` is the per-target exchange granule (the receive
    surface is n_shards x bucket_cap per shard): the sampled bounds
    spread rows roughly evenly, so ~2x the fair share keeps the exchange
    O(cap); a skewed key distribution overflows a block and reports
    ``ok`` = False (callers retry with a bigger granule); 0 keeps the
    always-fits default. Returns (cols, count) per shard and ``ok``."""
    n = len(devices)
    sorted_all, live_all, words_all = [], [], []
    for cols, rows in zip(shard_cols, shard_rows):
        cap = cols[0].validity.shape[0]
        live = live_of(rows, cap, cols[0].validity.device)
        key_cols = [cols[i] for i in key_indices]
        # local sort FIRST: evenly spaced positions then sample true
        # quantiles, and the post-exchange sort meets sorted runs
        perm = sort_permutation(key_cols, key_dtypes, orders, live,
                                str_max_lens)
        live_sorted = live[perm]
        sorted_cols = gather(cols, perm, live_sorted)
        sorted_all.append(sorted_cols)
        live_all.append(live_sorted)
        words_all.append(range_key_words(
            [sorted_cols[i] for i in key_indices], key_dtypes, orders,
            str_max_lens))

    bounds = _sample_bounds(words_all, live_all, n)
    # pid = number of bounds <= row (lexicographic over the words)
    pids = [count_bounds_le(words, [b.to(dev) for b in bounds], n - 1)
            for words, dev in zip(words_all, devices)]
    recvd, rn, ok = all_to_all_exchange(sorted_all, pids, live_all,
                                        devices, bucket_cap=bucket_cap)
    out = []
    for cols, cnt in zip(recvd, rn):
        rcap = cols[0].validity.shape[0]
        perm2 = sort_permutation([cols[i] for i in key_indices],
                                 key_dtypes, orders, cnt, str_max_lens)
        live2 = live_of(cnt, rcap, cnt.device)
        out.append(gather(cols, perm2, live2[perm2]))
    return out, rn, ok


def dist_hash_join(
    shard_left: Sequence[Sequence[Val]],
    left_keys: Sequence[int],
    shard_right: Sequence[Sequence[Val]],
    right_keys: Sequence[int],
    key_dtypes: Sequence[T.DataType],
    left_rows: Sequence,
    right_rows: Sequence,
    devices: Sequence[torch.device],
    out_cap: int,
    key_str_max_lens: Sequence[int] = (),
    out_char_caps: Sequence[int] = (),
    exchange_bucket_caps: Tuple[int, int] = (0, 0),
    probe_strategy: str = "DIRECT",
) -> Tuple[List[List[Val]], List[torch.Tensor], torch.Tensor]:
    """Inner equi-join: hash-exchange both sides, join locally.

    ``out_cap`` is the static per-shard output capacity (overflow reports
    ok=False). String key columns compare through the same chunk words on
    both sides, so ``key_str_max_lens`` is the SHARED byte bound per
    string key. ``out_char_caps`` sizes the output byte pools per string
    column of the combined (left..right) output; byte overflow also
    reports ok=False. ``exchange_bucket_caps`` are the per-side exchange
    granules (left, right); 0 = the always-fits full granule.
    ``probe_strategy`` is the probe's tier (``ops/join.probe_ranges``).
    Returns (left..right cols, match count) per shard and ``ok``."""
    n = len(devices)

    def exchange_side(shard_cols, key_ix, rows, bucket_cap):
        pids = [hashing.partition_ids(hashing.murmur3(
            [cols[i] for i in key_ix], list(key_dtypes),
            str_max_lens=list(key_str_max_lens)), n)
            for cols in shard_cols]
        return all_to_all_exchange(shard_cols, pids, rows, devices,
                                   bucket_cap=bucket_cap)

    l_all, ln_all, ok1 = exchange_side(shard_left, left_keys, left_rows,
                                       exchange_bucket_caps[0])
    r_all, rn_all, ok2 = exchange_side(shard_right, right_keys, right_rows,
                                       exchange_bucket_caps[1])
    oks = [ok1 & ok2.to(ok1.device)]
    outs, totals = [], []
    for l_cols, ln, r_cols, rn in zip(l_all, ln_all, r_all, rn_all):
        dev = ln.device
        # build = right side: sort by key words, joinable rows first
        rwords, r_null = join_ops.radix_key_words(
            [r_cols[i] for i in right_keys], key_dtypes, key_str_max_lens)
        rcap = r_cols[0].validity.shape[0]
        r_live = live_of(rn, rcap, dev)
        ok_rows = r_live & ~r_null
        perm = _lex_sort_perm([(~ok_rows).to(torch.int64)] + rwords)
        sorted_rwords = [w[perm] for w in rwords]
        sorted_build = gather(r_cols, perm, r_live[perm])
        build_count = ok_rows.sum(dtype=torch.int32)

        lwords, l_null = join_ops.radix_key_words(
            [l_cols[i] for i in left_keys], key_dtypes, key_str_max_lens)
        lcap = l_cols[0].validity.shape[0]
        l_live = live_of(ln, lcap, dev) & ~l_null
        lo, hi = join_ops.probe_ranges(sorted_rwords, build_count, lwords,
                                       l_live, probe_strategy)
        counts = torch.where(l_live, hi - lo, 0)
        total = counts.sum(dtype=torch.int64)
        ok = total <= out_cap

        p, build_row, slot_live = join_ops.expansion_plan(counts, lo,
                                                          out_cap)
        nstr_left = sum(1 for c in l_cols if isinstance(c, StrV))
        lcc = list(out_char_caps[:nstr_left])
        rcc = list(out_char_caps[nstr_left:])
        left_out = gather(l_cols, p, slot_live, char_caps=lcc or None,
                          repeats=True)
        right_out = gather(sorted_build, build_row, slot_live,
                           char_caps=rcc or None, repeats=True)
        out = list(left_out) + list(right_out)
        # byte-pool overflow: the string gather truncates the bytes but
        # keeps the true cumsum in the offsets, so the last one tells
        for o in out:
            if isinstance(o, StrV):
                ok = ok & (o.offsets[-1] <= o.chars.shape[0])
        outs.append(out)
        totals.append(total.to(torch.int32))
        oks.append(ok)
    all_ok = torch.stack([o.to(oks[0].device) for o in oks]).all()
    return outs, totals, all_ok
