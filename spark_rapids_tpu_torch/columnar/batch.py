"""ColumnarBatch: device columns sharing a row count.

Counterpart of ``spark_rapids_tpu/columnar/batch.py``. ``num_rows`` may be
a 0-d device tensor (a lazy length produced by a filter or an aggregate);
the ``num_rows`` property syncs once and caches, ``num_rows_lazy`` never
syncs. :func:`batch_from_host_arrays` carries a reference batch's planes
across unchanged, padding included, so both engines see identical
inputs. Row decoding (``to_rows``) turns string columns, plain or
dictionary-encoded, back into ``str`` (``bytes`` for binary).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..types import DataType, StructField, StructType, is_string, \
    torch_dtype
from .column import (
    DeviceColumn,
    HostColumn,
    choose_capacity,
    column_from_pylist,
    resolve_device,
)


class ColumnarBatch:
    __slots__ = ("columns", "schema", "_num_rows", "_capacity", "exclusive")

    def __init__(self, columns: Sequence[DeviceColumn], schema: StructType,
                 num_rows=None, capacity: Optional[int] = None):
        self.columns: List[DeviceColumn] = list(columns)
        self.schema = schema
        #: set by a producer whose planes nobody else holds
        #: (``plugin/donation.mark_exclusive``), cleared by a retainer
        self.exclusive = False
        if num_rows is None:
            num_rows = int(columns[0].length) if columns else 0
        self._num_rows = num_rows
        if self.columns:
            self._capacity = self.columns[0].capacity
        elif capacity is not None:
            self._capacity = capacity
        else:
            self._capacity = choose_capacity(
                num_rows if isinstance(num_rows, int) else 0)
        if isinstance(num_rows, int):
            for c in self.columns:
                if isinstance(c.length, int) and c.length != num_rows:
                    raise ValueError(f"column row count {c.length} != batch "
                                     f"rows {num_rows}")

    @property
    def num_rows(self) -> int:
        if not isinstance(self._num_rows, int):
            self._num_rows = int(self._num_rows.item())  # one device sync
            for c in self.columns:
                c.length = self._num_rows
        return self._num_rows

    @property
    def num_rows_lazy(self):
        """Row count as-is: host int or 0-d device tensor, never syncs."""
        return self._num_rows

    @property
    def capacity(self) -> int:
        return self._capacity

    @staticmethod
    def from_pydict(data: Dict[str, Sequence[Any]], schema: StructType,
                    num_rows: Optional[int] = None,
                    device=None) -> "ColumnarBatch":
        dev = resolve_device(device)
        cols = []
        n = num_rows
        for f in schema.fields:
            values = data[f.name]
            if n is None:
                n = len(values)
            cols.append(column_from_pylist(values, f.dataType, f.name, dev))
        return ColumnarBatch(cols, schema, n if n is not None else 0)

    def host_columns(self) -> List[HostColumn]:
        """Every column's live rows on the host (one row-count sync; a
        dictionary-encoded column copies its codes, validity and whole
        dictionary and decodes each entry once)."""
        n = self.num_rows
        return [c.to_host(n) for c in self.columns]

    def to_pydict(self) -> Dict[str, List[Any]]:
        return {f.name: h.to_pylist()
                for f, h in zip(self.schema.fields, self.host_columns())}

    def to_rows(self) -> List[tuple]:
        cols = [h.to_pylist() for h in self.host_columns()]
        return list(zip(*cols)) if cols else [() for _ in
                                              range(self.num_rows)]

    def __repr__(self):
        names = ",".join(f.name for f in self.schema.fields)
        return f"ColumnarBatch(rows={self.num_rows_lazy}, cols=[{names}])"


def batch_from_host_arrays(schema: StructType,
                           datas: Sequence[np.ndarray],
                           validities: Sequence[np.ndarray],
                           num_rows: int, capacity: int,
                           device=None) -> ColumnarBatch:
    """A batch built from the numpy planes of a reference batch: per column
    its (capacity,) data and validity arrays, padding included, plus the
    row count. A string column's data is an ``(offsets, chars)`` pair:
    offsets (capacity+1,), the byte pool as it is (its padding kept). The
    tests feed both engines identical batches through it."""
    dev = resolve_device(device)
    cols = []
    for f, d, v in zip(schema.fields, datas, validities):
        if is_string(f.dataType):
            offsets, chars = d
            chars = np.asarray(chars, dtype=np.uint8)
            cols.append(DeviceColumn.from_string_arrays(
                f.dataType, num_rows, offsets, chars, v, dev,
                char_cap=chars.shape[0]))
            continue
        st = torch_dtype(f.dataType)
        d = np.asarray(d)
        v = np.asarray(v, dtype=bool)
        if d.shape != (capacity,) or v.shape != (capacity,):
            raise ValueError(f"column {f.name!r}: planes must have shape "
                             f"({capacity},), got {d.shape} and {v.shape}")
        # copies: the batch never aliases the caller's (maybe read-only)
        # numpy planes, on the CPU either
        data = torch.tensor(d, dtype=st, device=dev)
        cols.append(DeviceColumn(f.dataType, num_rows, data,
                                 torch.tensor(v, device=dev)))
    return ColumnarBatch(cols, schema, num_rows, capacity=capacity)


def batch_from_rows(rows: Sequence[Sequence[Any]], schema: StructType,
                    device=None) -> ColumnarBatch:
    """Row-to-columnar transition (reference ``batch.batch_from_rows``):
    Python rows -> one uploaded batch on ``device`` (``None``: the CUDA
    card). The row count is passed explicitly: a fully-pruned (zero-column)
    schema has no column to recover it from."""
    data: Dict[str, List[Any]] = {f.name: [] for f in schema.fields}
    width = len(schema.fields)
    for i, row in enumerate(rows):
        if len(row) != width:
            raise ValueError(f"row {i} has {len(row)} values, schema has "
                             f"{width}")
        for f, v in zip(schema.fields, row):
            data[f.name].append(v)
    return ColumnarBatch.from_pydict(data, schema, num_rows=len(rows),
                                     device=device)


def schema_of(**kwargs: DataType) -> StructType:
    return StructType(tuple(StructField(k, v) for k, v in kwargs.items()))

