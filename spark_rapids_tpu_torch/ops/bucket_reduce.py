"""Bucket reductions under two tiers.

Counterpart of ``spark_rapids_tpu/ops/bucket_reduce.py``:

  * **PALLAS** — the hand-written bucket kernels K1-K3
    (``ops/groupby_kernels.py``) on the card, their plain versions on
    the CPU;
  * **SCATTER** — torch ``index_add_`` / ``scatter_reduce_``, the way the
    reference's SCATTER tier uses XLA segment ops. These are the kernels'
    plain versions themselves (one copy of each reduction), so the
    SCATTER tier on the card is the same code that the kernels are held
    against.

MATMUL (the TPU's one-hot limb matmul), SORT and RADIX are not ported.
Rows whose bucket id lies outside [0, B) drop out of every reduction.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import groupby_kernels as K

#: tiers the port does not have yet, and the ROADMAP item that brings each
NOT_PORTED_TIERS = {
    "MATMUL": "The MATMUL and SORT tiers",
    "SORT": "The MATMUL and SORT tiers",
    "RADIX": "The RADIX tier and the PALLAS sort-fallback reduction",
}


def not_ported_tier(strategy: str) -> NotImplementedError:
    return NotImplementedError(
        f"agg strategy {strategy} is not ported yet: see ROADMAP.md, "
        f"queue A item '{NOT_PORTED_TIERS[strategy]}'")


def _resolve_strategy(strategy: Optional[str] = None) -> str:
    """The lowering for one reduction: an already-chosen SCATTER/PALLAS
    from the aggregate exec's chooser; None/AUTO is SCATTER, the plain
    torch tier."""
    if strategy in NOT_PORTED_TIERS:
        raise not_ported_tier(strategy)
    if strategy in ("SCATTER", "PALLAS"):
        return strategy
    return "SCATTER"


def bucket_reduce(
    seg: torch.Tensor,
    B: int,
    int_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
    count_cols: Sequence[torch.Tensor] = (),
    float_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
    strategy: Optional[str] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Every requested reduction across every column in one pass per
    family.

    seg: (n,) int32 bucket ids; ids outside [0, B) are dropped.
    int_cols:   [(data int64/int32, valid bool)] -> exact int64 sums (B,)
    count_cols: [valid bool] -> int64 counts (B,)
    float_cols: [(data f64/f32, valid bool)] -> f64 sums (B,)
    """
    if _resolve_strategy(strategy) == "PALLAS":
        return K.kernel_bucket_reduce(seg, B, int_cols, count_cols,
                                      float_cols)
    isums, counts = K.bucket_sum_plain(seg, B, int_cols, count_cols)
    return isums, counts, K.bucket_float_sum_plain(seg, B, float_cols)


def bucket_min_max(seg: torch.Tensor, B: int, op: str,
                   cols: Sequence[torch.Tensor],
                   strategy: Optional[str] = None) -> List[torch.Tensor]:
    """Per-bucket min/max of identity-prefilled columns (callers overwrite
    empty buckets via their count mask). Both tiers reduce the columns'
    order words, NaN largest: PALLAS on K3, folding -0.0 into 0.0 as the
    reference's PALLAS tier does; SCATTER on K3's plain version
    (``scatter_reduce_``) with -0.0 below 0.0, as the reference's
    ``segment_min``/``segment_max`` order the raw values."""
    if _resolve_strategy(strategy) == "PALLAS":
        return K.min_max_by_words(K.bucket_winner, seg, B, op, cols)
    return K.min_max_by_words(K.bucket_winner_plain, seg, B, op, cols,
                              keep_zero_sign=True)


def bucket_lookup_u32(seg: torch.Tensor, B: int,
                      table: torch.Tensor) -> torch.Tensor:
    """Per-row lookup of a bucket table value (a plain clipped gather);
    rows with seg outside [0, B) read 0."""
    s = seg.to(torch.int64)
    t = table[s.clamp(0, B - 1)]
    return torch.where((s >= 0) & (s < B), t, torch.zeros_like(t))


def bucket_equal_check(seg: torch.Tensor, B: int, word: torch.Tensor,
                       rep_table: torch.Tensor,
                       live: torch.Tensor) -> torch.Tensor:
    """0-d bool: every live row's ``word`` equals its bucket's
    representative (exact collision detection for the hash tier)."""
    mismatch = live & (bucket_lookup_u32(seg, B, rep_table) != word)
    return ~torch.any(mismatch)
