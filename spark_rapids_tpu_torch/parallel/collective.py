"""Shard-to-shard row exchange over the mesh's devices.

Counterpart of ``spark_rapids_tpu/parallel/collective.py``, step for step:
each shard stable-sorts its rows by target shard
(``shuffle/partition.partition_cols``), lays the per-target runs into
blocks of ``bucket_cap`` rows (the exchange granule, with the ``ok``
overflow flag), swaps blocks, and compacts what arrived. String columns
cross as a second BYTE plane: rows are partition-sorted, so each target's
bytes are one contiguous slice of the sorted byte pool; lengths ride
with the rows as an int32 column, the byte slices land in per-target
byte blocks that cross alongside the row blocks, and the receiving shard
rebuilds offsets with a cumsum.

The reference's ``lax.all_to_all`` becomes explicit per-(source,
target) tensor copies: block ``t`` of source ``s`` is copied to shard
``t``'s device (no copy at all where both shards share a device, as
virtual shards on one card do), and each target concatenates its blocks
in source order. Every shard's work is an eager loop over the shards.

Row counts stay on the device, as in the reference: the received counts
and the ``ok`` flag are device tensors, and the block shapes are host
ints fixed up front (the granule, the shards' capacities). The functions
here make no host sync; the mesh stages sync the ``ok`` flag and the
output counts (``exec/mesh.py``).

Each function takes per-shard lists: ``shard_cols[s]`` are shard ``s``'s
columns on ``devices[s]``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..expr.values import ColV, DictV, StrV, Val
from ..ops.filter_gather import (compaction_indices, filter_cols, live_of,
                                 rows_of_positions)
from ..shuffle.partition import partition_cols


def _scatter_block(data: torch.Tensor, dest: torch.Tensor,
                   size: int) -> torch.Tensor:
    """(size,) zeros with ``data[i]`` at ``dest[i]``; destinations at
    ``size`` (the reference's ``mode="drop"``) land in a spare slot that
    is cut off."""
    z = torch.zeros(size + 1, dtype=data.dtype, device=data.device)
    z[dest.long()] = data
    return z[:size]


def _all_ok(oks: Sequence[torch.Tensor]) -> torch.Tensor:
    """The reference's ``psum(ok) == n_shards``: one 0-d bool on the
    first shard's device."""
    dev = oks[0].device
    return torch.stack([o.to(dev) for o in oks]).all()


def _cap_of(cols: Sequence[Val]) -> int:
    c0 = cols[0]
    return (c0.offsets.shape[0] - 1 if isinstance(c0, StrV)
            else c0.validity.shape[0])


def all_to_all_exchange(
    shard_cols: Sequence[Sequence[Val]],
    shard_pids: Sequence[torch.Tensor],
    shard_rows: Sequence,
    devices: Sequence[torch.device],
    bucket_cap: int = 0,
) -> Tuple[List[List[Val]], List[torch.Tensor], torch.Tensor]:
    """Route each live row of every shard to the shard named by its pid.

    ``shard_rows[s]`` is shard ``s``'s row count (host int or 0-d
    tensor) or its (cap,) live mask. ``bucket_cap`` is the per-target
    block size (the exchange granule); 0 means the largest shard
    capacity, always enough, at the cost of an n_shards x cap receive
    surface. Returns (received cols per shard, received count per shard,
    ok) where ``ok`` is False iff some block overflowed ``bucket_cap``
    (callers pick a bigger granule and retry)."""
    n = len(devices)
    caps = [_cap_of(cols) for cols in shard_cols]
    B = bucket_cap or max(caps)
    ncols = len(shard_cols[0])
    is_str = [isinstance(c, StrV) for c in shard_cols[0]]
    for cols in shard_cols:
        if any(isinstance(c, DictV) for c in cols):
            raise ValueError("the mesh exchange takes plain columns: "
                             "materialize dictionary-encoded ones first")
    # the byte granule of each string column: the largest local pool
    BBs = [max(int(cols[j].chars.shape[0]) for cols in shard_cols)
           if is_str[j] else 0 for j in range(ncols)]

    # 1-2) per source: partition-sort by target, scatter the per-target
    # runs into (n * B,) send blocks
    send = []  # per source: per column a tuple of (n * granule,) planes
    counts_of = []
    oks = []
    for s, (cols, pids, rows) in enumerate(zip(shard_cols, shard_pids,
                                               shard_rows)):
        cap = caps[s]
        dev = pids.device
        sorted_cols, offsets = partition_cols(cols, pids, rows, n)
        counts = offsets[1:] - offsets[:-1]
        ok = ~torch.any(counts > B)
        idx = torch.arange(cap, dtype=torch.int32, device=dev)
        live_sorted = idx < offsets[n]
        tgt = rows_of_positions(offsets, cap)
        slot = idx - offsets[tgt.long()]
        dest = torch.where(live_sorted & (slot < B), tgt * B + slot, n * B)
        planes = []
        for j, c in enumerate(sorted_cols):
            if not is_str[j]:
                planes.append((_scatter_block(c.data, dest, n * B),
                               _scatter_block(c.validity, dest, n * B)))
                continue
            BB = BBs[j]
            lens = torch.where(live_sorted, c.offsets[1:] - c.offsets[:-1],
                               0).to(torch.int32)
            # rows are sorted by target, so target t's bytes are the
            # contiguous slice [byte_off[t], byte_off[t+1])
            nchar = int(c.chars.shape[0])
            byte_off = c.offsets[offsets.long().clamp(0, cap)].to(
                torch.int32)
            bcounts = byte_off[1:] - byte_off[:-1]
            ok = ok & ~torch.any(bcounts > BB)
            bpos = torch.arange(nchar, dtype=torch.int32, device=dev)
            btgt = rows_of_positions(byte_off, nchar)
            bslot = bpos - byte_off[btgt.long()]
            in_data = bpos < byte_off[n]
            bdest = torch.where(in_data & (bslot < BB), btgt * BB + bslot,
                                n * BB)
            planes.append((_scatter_block(lens, dest, n * B),
                           _scatter_block(c.validity, dest, n * B),
                           _scatter_block(c.chars, bdest, n * BB),
                           bcounts.clamp(max=BB)))
        send.append(planes)
        counts_of.append(counts.clamp(max=B))
        oks.append(ok)

    # 3) swap block t of source s to shard t; 4) compact what arrived;
    # 5) rebuild string columns from the exchanged lengths and bytes
    out_cols: List[List[Val]] = []
    out_counts: List[torch.Tensor] = []
    for t, dev in enumerate(devices):
        recv_counts = torch.stack([counts_of[s][t].to(dev)
                                   for s in range(n)])
        j_all = torch.arange(n * B, dtype=torch.int32, device=dev)
        live_recv = (j_all % B) < recv_counts[(j_all // B).long()]
        pair_cols: List[ColV] = []
        for j in range(ncols):
            data = torch.cat([send[s][j][0][t * B:(t + 1) * B].to(dev)
                              for s in range(n)])
            valid = torch.cat([send[s][j][1][t * B:(t + 1) * B].to(dev)
                               for s in range(n)])
            pair_cols.append(ColV(data, valid))
        compacted, total = filter_cols(pair_cols, live_recv)
        cols_t: List[Val] = []
        for j, cc in enumerate(compacted):
            if not is_str[j]:
                cols_t.append(cc)
                continue
            BB = BBs[j]
            rb = torch.cat([send[s][j][2][t * BB:(t + 1) * BB].to(dev)
                            for s in range(n)])
            rbc = torch.stack([send[s][j][3][t].to(dev) for s in range(n)])
            rcap = cc.data.shape[0]
            lens = torch.where(
                torch.arange(rcap, dtype=torch.int32, device=dev) < total,
                cc.data.to(torch.int32), 0)
            new_offsets = torch.cat([
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.cumsum(lens, 0, dtype=torch.int32)])
            bj = torch.arange(n * BB, dtype=torch.int32, device=dev)
            blive = (bj % BB) < rbc[(bj // BB).long()]
            bidx, btotal = compaction_indices(blive)
            chars = torch.where(bj < btotal, rb[bidx.long()],
                                torch.zeros((), dtype=torch.uint8,
                                            device=dev))
            cols_t.append(StrV(new_offsets, chars, cc.validity))
        out_cols.append(cols_t)
        out_counts.append(total)
    return out_cols, out_counts, _all_ok(oks)


def gather_all(
    shard_cols: Sequence[Sequence[ColV]],
    shard_rows: Sequence,
    device: torch.device,
) -> Tuple[List[ColV], torch.Tensor]:
    """Every shard's rows on ``device`` (the single-partition merge
    path): the shards' planes concatenate in shard order and the padding
    slots are compacted out, so the result is dense. Fixed-width columns,
    as the reference's. Returns (cols, count)."""
    lives = [live_of(rows, _cap_of(cols), cols[0].validity.device)
             for cols, rows in zip(shard_cols, shard_rows)]
    g_cols = [
        ColV(torch.cat([cols[j].data.to(device) for cols in shard_cols]),
             torch.cat([cols[j].validity.to(device) for cols in shard_cols]))
        for j in range(len(shard_cols[0]))]
    g_live = torch.cat([lv.to(device) for lv in lives])
    return filter_cols(g_cols, g_live)
