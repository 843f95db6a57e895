"""Batch concatenation, fixed-width columns.

Counterpart of ``spark_rapids_tpu/ops/concat.py``: the sync-free padded
concat the aggregate's merge uses, and the plain concat at known row
counts. String columns raise (ROADMAP.md, queue A item 'Strings in
joins, grouping keys, min/max and concat').
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import types as T
from ..expr.values import ColV, StrV


def _check_fixed(parts) -> None:
    if any(isinstance(p, StrV) for p in parts):
        raise NotImplementedError(
            f"concatenating string columns is {T.NOT_PORTED_STRING_LAYERS}")


def _fit(t: torch.Tensor, out_cap: int) -> torch.Tensor:
    if t.shape[0] >= out_cap:
        return t[:out_cap]
    return torch.cat([t, torch.zeros(out_cap - t.shape[0], dtype=t.dtype,
                                     device=t.device)])


def concat_padded_cols(col_parts: Sequence[Sequence[ColV]],
                       counts: Sequence, out_cap: int
                       ) -> Tuple[List[ColV], torch.Tensor, torch.Tensor]:
    """Sync-free concat: parts stack at their full capacities (no
    compaction) and the returned (out_cap,) live MASK marks the real rows;
    row counts stay device scalars. Returns (columns, mask, total)."""
    for cp in col_parts:
        _check_fixed(cp)
    dev = col_parts[0][0].validity.device
    masks = [torch.arange(cp[0].validity.shape[0], dtype=torch.int32,
                          device=dev) < cnt
             for cp, cnt in zip(col_parts, counts)]
    mask = _fit(torch.cat(masks), out_cap)
    out: List[ColV] = []
    for j in range(len(col_parts[0])):
        data = _fit(torch.cat([cp[j].data for cp in col_parts]), out_cap)
        valid = _fit(torch.cat([cp[j].validity for cp in col_parts]), out_cap)
        out.append(ColV(data, valid & mask))
    total = sum(torch.as_tensor(c, dtype=torch.int32, device=dev)
                for c in counts)
    return out, mask, total


def concat_fixed(parts: Sequence[ColV], lengths: Sequence[int],
                 out_cap: int) -> ColV:
    """Live rows of each part back to back (host row counts), padded to
    ``out_cap``."""
    _check_fixed(parts)
    data = _fit(torch.cat([p.data[:n] for p, n in zip(parts, lengths)]),
                out_cap)
    valid = _fit(torch.cat([p.validity[:n] for p, n in zip(parts, lengths)]),
                 out_cap)
    return ColV(data, valid)
