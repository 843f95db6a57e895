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
    every later row of the segment, via one cumulative max — valid
    whenever the flagged values are NONDECREASING across segment starts
    (true for any prefix-sum-derived stream over a sorted order, e.g.
    the join merge's running build counts). Rows before the first flag
    report -1. Reference ``radix_bin.py:472`` (``lax.cummax``)."""
    marked = torch.where(flags, values.to(torch.int32), -1)
    if marked.numel() == 0:
        return marked
    return torch.cummax(marked, 0).values
