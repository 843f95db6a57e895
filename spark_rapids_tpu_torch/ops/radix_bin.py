"""Segmented-scan helper of the RADIX tiers and the tile length of the
reference's tiled reduction.

Counterpart of ``spark_rapids_tpu/ops/radix_bin.py``, only the pieces
the port uses: the RADIX join tier's co-sorted merge
(``ops/join.radix_probe_ranges``) and :func:`default_tile_rows`, which
fixes how the reference's tiled min/max breaks ties across tiles (the
PALLAS sort fallback, ``ops/groupby.radix_winner``). The RADIX
aggregation tier itself is not ported yet (ROADMAP.md, queue A item 1).
"""
from __future__ import annotations

import torch

#: test hook, as the reference's: force the tile row count (0 = derive it
#: from the layout); must stay <= 2^20
FORCE_TILE_ROWS = 0


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
