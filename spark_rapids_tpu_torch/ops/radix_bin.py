"""Segmented-scan helper of the RADIX tiers.

Counterpart of ``spark_rapids_tpu/ops/radix_bin.py``, only the piece the
RADIX join tier's co-sorted merge (``ops/join.radix_probe_ranges``)
uses. The RADIX aggregation tier itself is not ported yet (ROADMAP.md,
queue A item 1).
"""
from __future__ import annotations

import torch


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
