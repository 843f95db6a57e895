"""Row-wise batch splitting for split-and-retry (``memory/retry.py``).

Counterpart of ``spark_rapids_tpu/columnar/split.py``: when retries under
memory pressure run out, the operator re-attempts on half of its input.
Each column's planes are re-packed into fresh capacity-bucketed tensors:

  * fixed width: data and validity copied into ``choose_capacity(piece)``
    slots, padding zeroed and invalid (the engine-wide invariant), data
    zeroed under invalid rows;
  * string: offsets rebased to the piece's first byte, chars copied to
    the piece's byte range, the byte pool re-bucketed;
  * dictionary-encoded: codes and validity split like fixed width, the
    dictionary's planes and ``mat_cap``/``max_len``/``unique`` shared by
    both pieces, so they stay encoded;
  * zero-column batches split by row count alone.

The split syncs the row count, and each string column's byte bounds, to
the host: it runs on the recovery path.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .batch import ColumnarBatch
from .column import DeviceColumn, choose_capacity


def _split_fixed(data: torch.Tensor, validity: torch.Tensor, start: int,
                 rows: int, cap: int):
    out_v = torch.zeros(cap, dtype=torch.bool, device=validity.device)
    out_v[:rows] = validity[start:start + rows]
    out_d = torch.zeros(cap, dtype=data.dtype, device=data.device)
    out_d[:rows] = data[start:start + rows]
    # zero the data under invalid rows, so masked reductions stay defined
    # even where the source held values under an invalid live slot
    return torch.where(out_v, out_d, torch.zeros((), dtype=data.dtype,
                                                 device=data.device)), out_v


def _split_string_col(col: DeviceColumn, start: int, rows: int,
                      cap: int) -> DeviceColumn:
    b0, b1 = (int(v) for v in col.offsets[[start, start + rows]].tolist())
    nbytes = b1 - b0
    dev = col.offsets.device
    offsets = torch.full((cap + 1,), nbytes, dtype=torch.int32, device=dev)
    offsets[: rows + 1] = col.offsets[start: start + rows + 1] - b0
    chars = torch.zeros(choose_capacity(max(1, nbytes), 128),
                        dtype=torch.uint8, device=dev)
    chars[:nbytes] = col.chars[b0:b1]
    validity = torch.zeros(cap, dtype=torch.bool, device=dev)
    validity[:rows] = col.validity[start:start + rows]
    return DeviceColumn(col.dtype, rows, None, validity, offsets=offsets,
                        chars=chars)


def _split_dict_col(col: DeviceColumn, start: int, rows: int,
                    cap: int) -> DeviceColumn:
    from ..expr.values import DictV

    d = col.dictv
    codes, validity = _split_fixed(d.codes, d.validity, start, rows, cap)
    return DeviceColumn.dict_encoded(col.dtype, rows, DictV(
        codes, d.dictionary, validity, d.mat_cap, d.max_len, d.unique))


def _slice_piece(batch: ColumnarBatch, start: int, rows: int
                 ) -> ColumnarBatch:
    cap = choose_capacity(max(1, rows))
    cols: List[DeviceColumn] = []
    for c in batch.columns:
        if c.is_dict:
            cols.append(_split_dict_col(c, start, rows, cap))
        elif c.is_string:
            cols.append(_split_string_col(c, start, rows, cap))
        else:
            d, v = _split_fixed(c.data, c.validity, start, rows, cap)
            cols.append(DeviceColumn(c.dtype, rows, d, v))
    return ColumnarBatch(cols, batch.schema, rows, capacity=cap)


def split_batch(batch: ColumnarBatch
                ) -> Tuple[ColumnarBatch, ColumnarBatch]:
    """``batch`` split row-wise into two halves (the first one the larger),
    each in its own capacity bucket with every plane invariant kept.
    Raises ValueError below 2 rows: the split-and-retry recursion's
    floor."""
    n = batch.num_rows  # syncs a lazy count: this is the recovery path
    if n < 2:
        raise ValueError(f"cannot split a {n}-row batch")
    lo_rows = (n + 1) // 2
    return (_slice_piece(batch, 0, lo_rows),
            _slice_piece(batch, lo_rows, n - lo_rows))
