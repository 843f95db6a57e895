"""Batch concatenation.

Counterpart of ``spark_rapids_tpu/ops/concat.py``: the sync-free padded
concat the aggregate's merge uses (fixed-width columns only, as there),
and the concat at host row and byte counts, string columns included.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..expr.values import ColV, DictV, StrV, Val

#: string offsets are int32: a concatenated byte pool stays below this
MAX_POOL_BYTES = 2**31 - 1


def _fit(t: torch.Tensor, out_cap: int) -> torch.Tensor:
    if t.shape[0] >= out_cap:
        return t[:out_cap]
    return torch.cat([t, torch.zeros(out_cap - t.shape[0], dtype=t.dtype,
                                     device=t.device)])


def concat_padded_cols(col_parts: Sequence[Sequence[ColV]],
                       counts: Sequence, out_cap: int
                       ) -> Tuple[List[ColV], torch.Tensor, torch.Tensor]:
    """Sync-free concat for fixed-width columns: parts stack at their full
    capacities (no compaction) and the returned (out_cap,) live MASK marks
    the real rows; row counts stay device scalars. Returns (columns, mask,
    total). String columns need their byte counts on the host, as in the
    reference, so they take :func:`concat_batches_cols`."""
    for cp in col_parts:
        if any(isinstance(p, (StrV, DictV)) for p in cp):
            raise NotImplementedError(
                "the sync-free padded concat takes fixed-width columns "
                "only, as the reference's; string columns concatenate "
                "through concat_batches_cols")
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
    data = _fit(torch.cat([p.data[:n] for p, n in zip(parts, lengths)]),
                out_cap)
    valid = _fit(torch.cat([p.validity[:n] for p, n in zip(parts, lengths)]),
                 out_cap)
    return ColV(data, valid)


def concat_string(parts: Sequence[StrV], lengths: Sequence[int],
                  byte_lengths: Sequence[int], out_cap: int,
                  out_char_cap: int) -> StrV:
    """Live rows of each string part back to back (reference
    ``concat.py:74``): host row counts ``lengths`` and byte counts
    ``byte_lengths`` (each part's ``offsets[n]``). Offsets past the last
    row stay at the total, so they are monotonic through the padded
    tail."""
    total_bytes = sum(byte_lengths)
    if total_bytes > MAX_POOL_BYTES:
        raise ValueError(
            f"a concatenated string pool of {total_bytes} bytes overflows "
            "its int32 offsets")
    dev = parts[0].offsets.device
    offs = [torch.zeros(1, dtype=torch.int32, device=dev)]
    base = 0
    for p, n, nb in zip(parts, lengths, byte_lengths):
        offs.append(p.offsets[1:n + 1] + base)
        base += nb
    offsets = _fit(torch.cat(offs), out_cap + 1)
    rows = torch.arange(out_cap + 1, dtype=torch.int32, device=dev)
    offsets = torch.where(rows <= sum(lengths), offsets, total_bytes)
    chars = _fit(torch.cat([p.chars[:nb] for p, nb in zip(parts,
                                                          byte_lengths)]),
                 out_char_cap)
    validity = _fit(torch.cat([p.validity[:n] for p, n in zip(parts,
                                                             lengths)]),
                    out_cap)
    return StrV(offsets, chars, validity)


def concat_batches_cols(col_parts: Sequence[Sequence[Val]],
                        lengths: Sequence[int],
                        byte_lengths_per_col: Sequence[Sequence[int]],
                        out_cap: int, out_char_caps: Sequence[int]
                        ) -> Tuple[List[Val], int]:
    """Concatenate N batches column-wise (reference ``concat.py:180``).
    ``byte_lengths_per_col[i][j]`` is the byte count of string column j
    of batch i and ``out_char_caps[j]`` its output pool, host ints the
    caller synced once per batch. Dictionary-encoded columns must be
    materialized first: each batch's dictionary is its own."""
    out: List[Val] = []
    si = 0
    for j in range(len(col_parts[0])):
        parts = [cp[j] for cp in col_parts]
        if any(isinstance(p, DictV) for p in parts):
            raise ValueError("concat_batches_cols takes dictionary-encoded "
                             "columns materialized")
        if isinstance(parts[0], StrV):
            bl = [byte_lengths_per_col[i][si] for i in range(len(col_parts))]
            out.append(concat_string(parts, lengths, bl, out_cap,
                                     out_char_caps[si]))
            si += 1
        else:
            out.append(concat_fixed(parts, lengths, out_cap))
    return out, sum(lengths)
