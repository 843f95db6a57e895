"""Row selection: liveness masks, mask compaction and row gather.

Counterpart of ``spark_rapids_tpu/ops/filter_gather.py``. Outputs keep
the input capacity: selected rows are compacted to the front, tail slots
zeroed with validity False, and the surviving row count stays a 0-d
device tensor. String columns gather in two passes (new offsets, then
the bytes) into a byte pool of a size fixed up front, as in the
reference. A dictionary-encoded column (``DictV``) moves only its int32
codes, like a fixed-width column; its dictionary passes through as it
is.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..expr.values import ColV, DictV, StrV, Val


def live_of(num_rows_or_mask, cap: int, device=None) -> torch.Tensor:
    """A (cap,) liveness mask from a row count (host int or 0-d tensor) or
    an existing bool mask."""
    x = num_rows_or_mask
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bool and x.dim() == 1:
            return x
        device = x.device
    return torch.arange(cap, dtype=torch.int32, device=device) < x


def elide_validity(cols: Sequence[Val], live: torch.Tensor,
                   nonnull: Sequence[bool]) -> List[Val]:
    """Validity-plane elision for statically NON_NULL columns (reference
    ``filter_gather.py:33``; ``plugin/plananalysis.entry_nonnull_flags``
    gives ``nonnull``): at a pipeline entry a non-null column's stored
    validity is exactly the liveness mask (padding slots are always
    invalid, live rows always valid), so ``live`` replaces it bit for
    bit and the stored plane is never read."""
    if not nonnull or not any(nonnull):
        return list(cols)
    out: List[Val] = []
    for c, nn in zip(cols, nonnull):
        if not nn:
            out.append(c)
        elif isinstance(c, DictV):
            out.append(DictV(c.codes, c.dictionary, live, c.mat_cap,
                             c.max_len, c.unique))
        elif isinstance(c, StrV):
            out.append(StrV(c.offsets, c.chars, live))
        else:
            out.append(ColV(c.data, live))
    out.extend(cols[len(out):])  # flags never exceed the columns
    return out


def _drop_add(npos: int, at: torch.Tensor, values: torch.Tensor
              ) -> torch.Tensor:
    """(npos,) int32 zeros with ``values`` added at positions ``at``;
    positions at or past ``npos`` are dropped (the reference's
    ``.at[].add(mode="drop")``: they land in a spare slot that is cut
    off)."""
    arr = torch.zeros(npos + 1, dtype=torch.int32, device=values.device)
    arr.index_add_(0, at.long().clamp(0, npos), values.to(torch.int32))
    return arr[:npos]


def rows_of_positions(offsets: torch.Tensor, npos: int) -> torch.Tensor:
    """Row id per position given row-boundary offsets (cap+1,): one
    boundary scatter + one cumsum (reference ``filter_gather.py:55``).
    Empty rows put several marks on one position, so the ids still skip
    them; positions past the last row clamp to the last row."""
    cap = offsets.shape[0] - 1
    ones = torch.ones(max(cap - 1, 0), dtype=torch.int32,
                      device=offsets.device)
    return torch.cumsum(_drop_add(npos, offsets[1:cap], ones), 0,
                        dtype=torch.int32)


def piecewise_by_row(values: torch.Tensor, new_offsets: torch.Tensor,
                     npos: int) -> torch.Tensor:
    """Expand per-row ``values`` to per-position, constant over each row's
    [new_offsets[i], new_offsets[i+1]) range: one scatter-add of boundary
    deltas + a cumsum (reference ``filter_gather.py:76``). Deltas of
    empty rows collide at one position and add up, so the net is still
    right. int32 arithmetic, wrapping as the reference's."""
    cap = new_offsets.shape[0] - 1
    v = values.to(torch.int32)
    inc = v[1:] - v[:-1]
    arr = _drop_add(npos, new_offsets[1:cap], inc[:cap - 1])
    return torch.cumsum(arr, 0, dtype=torch.int32) + v[0]


def compaction_indices(mask: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(indices, count): ``indices[j]`` is the row of the j-th selected row
    for j < count; tail entries point at row 0 (callers mask them out)."""
    cap = mask.shape[0]
    csum = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    count = csum[cap - 1] if cap else torch.zeros((), dtype=torch.int32,
                                                  device=mask.device)
    # scatter of row ids to their destinations; unselected rows land in
    # the extra slot ``cap``, which is cut off (no host sync for the size)
    dest = torch.where(mask, csum - 1, cap).long()
    indices = torch.zeros(cap + 1, dtype=torch.int32, device=mask.device)
    indices.scatter_(0, dest, torch.arange(cap, dtype=torch.int32,
                                           device=mask.device))
    indices = indices[:cap]
    return indices, count


def gather_fixed(col: ColV, indices: torch.Tensor,
                 valid_slot: torch.Tensor) -> ColV:
    """Gather rows of a fixed-width column; ``valid_slot`` marks live
    outputs. Indices are clipped into range, as the reference's
    ``mode="clip"`` takes do."""
    idx = indices.long().clamp(0, max(col.data.shape[0] - 1, 0))
    data = col.data[idx]
    validity = col.validity[idx] & valid_slot
    return ColV(torch.where(validity, data, torch.zeros_like(data)),
                validity)


def gather_string(col: StrV, indices: torch.Tensor,
                  valid_slot: torch.Tensor, out_char_cap: int) -> StrV:
    """Gather rows of a string column into a pool of ``out_char_cap``
    bytes (reference ``filter_gather.py:214``): sizes first (new offsets
    by prefix sum), then each output byte's source byte, whose
    per-row delta expands with :func:`piecewise_by_row`. Indices clip
    into range as the reference's ``mode="clip"`` takes do."""
    m = indices.shape[0]
    cap = col.offsets.shape[0] - 1
    dev = col.offsets.device
    idx = indices.long().clamp(0, max(cap - 1, 0))
    lens = col.offsets[1:] - col.offsets[:-1]
    validity = col.validity[idx] & valid_slot
    sel_lens = torch.where(validity, lens[idx], 0)
    new_offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                             torch.cumsum(sel_lens, 0, dtype=torch.int32)])
    total = new_offsets[m]
    j = torch.arange(out_char_cap, dtype=torch.int32, device=dev)
    delta = col.offsets[indices.long().clamp(0, cap)] - new_offsets[:-1]
    src = j + piecewise_by_row(delta, new_offsets, out_char_cap)
    nchars = col.chars.shape[0]
    chars = torch.where(j < total,
                        col.chars[src.long().clamp(0, nchars - 1)],
                        torch.zeros((), dtype=torch.uint8, device=dev))
    return StrV(new_offsets, chars, validity)


def gather(cols: Sequence[Val], indices: torch.Tensor,
           valid_slot: torch.Tensor,
           char_caps: Optional[Sequence[int]] = None,
           repeats: bool = False) -> List[Val]:
    """Gather each column by row ``indices`` (same output rows for all).
    ``char_caps`` sets the output byte pool per plain string column, in
    order (default: the input pool's size, enough for a row subset).

    A DictV gathers its codes and keeps its dictionary (reference
    ``filter_gather.py:255-310``). Its ``mat_cap`` bounds the bytes of a
    row SUBSET only, so a caller whose indices repeat rows (a join's
    expansion) passes ``repeats=True`` and must materialize its DictVs
    first: a DictV raises there."""
    out: List[Val] = []
    si = 0
    for c in cols:
        if isinstance(c, DictV):
            if repeats:
                raise ValueError("a gather that repeats rows needs "
                                 "dictionary-encoded columns materialized "
                                 "first (their mat_cap bounds row subsets "
                                 "only)")
            g = gather_fixed(ColV(c.codes, c.validity), indices, valid_slot)
            out.append(DictV(g.data, c.dictionary, g.validity, c.mat_cap,
                             c.max_len, c.unique))
        elif isinstance(c, StrV):
            cc = (char_caps[si] if char_caps is not None
                  and si < len(char_caps) else int(c.chars.shape[0]))
            si += 1
            out.append(gather_string(c, indices, valid_slot, cc))
        else:
            out.append(gather_fixed(c, indices, valid_slot))
    return out


def packable_dtype(dt: torch.dtype) -> bool:
    """True when :func:`pack_fixed_cols` carries this dtype. f64 is
    excluded, as in the reference (``filter_gather.py:125``), whose TPU
    rewriter has no 64-bit bitcast: the port could carry it, but keeping
    the rule keeps both engines' fusion decisions the same."""
    return dt != torch.float64


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its unsigned value in an int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def pack_fixed_cols(cols: Sequence[ColV]) -> torch.Tensor:
    """Pack fixed-width columns (+ their validity bits) into ONE (cap, W)
    int32 matrix, so a multi-column row gather is one 2-D gather
    (reference ``filter_gather.py:152``): 64-bit columns as (lo, hi)
    int32 words, 32-bit ones by bit pattern, bool and narrower integers
    widened; then the validity bits, 32 columns per word. Callers exclude
    non-:func:`packable_dtype` columns."""
    parts: List[torch.Tensor] = []
    for c in cols:
        d = c.data
        if d.dtype == torch.bool or d.element_size() < 4:
            parts.append(d.to(torch.int32)[:, None])
        elif d.element_size() == 8:  # int64 (f64 is not packable)
            lo = ((d & 0xFFFFFFFF) ^ (1 << 31)) - (1 << 31)
            parts.append(torch.stack([lo.to(torch.int32),
                                      (d >> 32).to(torch.int32)], 1))
        else:
            parts.append(d.view(torch.int32)[:, None])
    for i in range(0, len(cols), 32):
        w = torch.zeros(cols[0].validity.shape[0], dtype=torch.int64,
                        device=cols[0].validity.device)
        for j, c in enumerate(cols[i:i + 32]):
            w = w | (c.validity.to(torch.int64) << j)
        parts.append((((w ^ (1 << 31)) - (1 << 31)).to(torch.int32))[:, None])
    return torch.cat(parts, 1)


def unpack_fixed_cols(mat: torch.Tensor, dtypes: Sequence[torch.dtype],
                      valid_slot: torch.Tensor) -> List[ColV]:
    """Inverse of :func:`pack_fixed_cols` over a gathered matrix
    (reference ``filter_gather.py:183``); ``dtypes`` are the packed
    columns' torch dtypes, in pack order."""
    widths = [2 if (dt != torch.bool and dt.itemsize == 8) else 1
              for dt in dtypes]
    vbase = sum(widths)
    out: List[ColV] = []
    w = 0
    for ci, (dt, nw) in enumerate(zip(dtypes, widths)):
        vword = mat[:, vbase + ci // 32]
        validity = (((vword >> (ci % 32)) & 1) == 1) & valid_slot
        if dt == torch.bool:
            data = mat[:, w] != 0
        elif nw == 2:
            data = (_u32(mat[:, w]) | (mat[:, w + 1].to(torch.int64) << 32)
                    ).to(dt)
        elif dt.itemsize == 4:
            data = mat[:, w].contiguous().view(dt)
        else:
            data = mat[:, w].to(dt)
        data = torch.where(validity, data, torch.zeros((), dtype=dt,
                                                       device=data.device))
        out.append(ColV(data, validity))
        w += nw
    return out


def filter_cols(cols: Sequence[Val], mask: torch.Tensor
                ) -> Tuple[List[Val], torch.Tensor]:
    """Compact rows where ``mask`` holds to the front of each column.
    ``mask`` must already be False in padding slots. Returns the new
    columns and the new row count as a 0-d device tensor."""
    indices, count = compaction_indices(mask)
    cap = mask.shape[0]
    valid_slot = torch.arange(cap, dtype=torch.int32,
                              device=mask.device) < count
    return gather(cols, indices, valid_slot), count


def truncate_cols(cols: Sequence[Val], count) -> List[Val]:
    """Keep the first ``count`` rows (host int or 0-d tensor) at the same
    capacity: later slots become zero and invalid, and a string column's
    later offsets stay at its last kept row's end with the bytes past it
    zeroed, the layout every filter output has. No gather, no sync."""
    out: List[Val] = []
    for c in cols:
        dev = c.validity.device
        keep = torch.arange(c.validity.shape[0], dtype=torch.int32,
                            device=dev) < count
        validity = c.validity & keep
        if isinstance(c, DictV):
            out.append(DictV(torch.where(keep, c.codes,
                                         torch.zeros_like(c.codes)),
                             c.dictionary, validity, c.mat_cap, c.max_len,
                             c.unique))
        elif isinstance(c, StrV):
            cap = c.offsets.shape[0] - 1
            at = torch.as_tensor(count, device=dev).clamp(0, cap).long()
            end = c.offsets[at]
            rows = torch.arange(cap + 1, dtype=torch.int32, device=dev)
            offsets = torch.where(rows <= at, c.offsets, end)
            pos = torch.arange(c.chars.shape[0], dtype=torch.int32,
                               device=dev)
            chars = torch.where(pos < end, c.chars,
                                torch.zeros((), dtype=torch.uint8,
                                            device=dev))
            out.append(StrV(offsets, chars, validity))
        else:
            out.append(ColV(torch.where(keep, c.data,
                                        torch.zeros_like(c.data)),
                            validity))
    return out
