"""Spillable values and batches: handles that survive device pressure.

Counterpart of ``spark_rapids_tpu/memory/spillable.py`` (reference
analog: SpillableColumnarBatch.scala:28-118): each wraps its tensors in
one catalog-registered :class:`~.catalog.SpillableHandle` and gives them
back from whatever tier they are on. The join's build side and the
broadcast batch use them. A dictionary-encoded value keeps its codes,
its dictionary's planes and its ``mat_cap``/``max_len``/``unique``
through a spill.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..columnar import ColumnarBatch, DeviceColumn
from ..expr.eval import column_of_val, val_of_column
from ..expr.values import ColV, DictV, StrV
from .catalog import ACTIVE_BATCHING_PRIORITY, BufferCatalog, SpillableHandle


def _flatten(vals) -> Tuple[Dict[str, torch.Tensor], List[tuple]]:
    """The tensors of ``vals`` by name, and each value's kind with its
    host metadata."""
    arrays: Dict[str, torch.Tensor] = {}
    layout: List[tuple] = []
    for i, v in enumerate(vals):
        if isinstance(v, DictV):
            arrays[f"c{i}_codes"] = v.codes
            arrays[f"c{i}_validity"] = v.validity
            arrays[f"c{i}_doffsets"] = v.dictionary.offsets
            arrays[f"c{i}_dchars"] = v.dictionary.chars
            arrays[f"c{i}_dvalidity"] = v.dictionary.validity
            layout.append(("d", v.mat_cap, v.max_len, v.unique))
        elif isinstance(v, StrV):
            arrays[f"c{i}_offsets"] = v.offsets
            arrays[f"c{i}_chars"] = v.chars
            arrays[f"c{i}_validity"] = v.validity
            layout.append(("s",))
        else:
            arrays[f"c{i}_data"] = v.data
            arrays[f"c{i}_validity"] = v.validity
            layout.append(("f",))
    return arrays, layout


def _unflatten(arrs: Dict[str, torch.Tensor], layout: List[tuple]) -> list:
    out = []
    for i, kind in enumerate(layout):
        if kind[0] == "d":
            out.append(DictV(arrs[f"c{i}_codes"], StrV(
                arrs[f"c{i}_doffsets"], arrs[f"c{i}_dchars"],
                arrs[f"c{i}_dvalidity"]), arrs[f"c{i}_validity"], *kind[1:]))
        elif kind[0] == "s":
            out.append(StrV(arrs[f"c{i}_offsets"], arrs[f"c{i}_chars"],
                            arrs[f"c{i}_validity"]))
        else:
            out.append(ColV(arrs[f"c{i}_data"], arrs[f"c{i}_validity"]))
    return out


class SpillableVals:
    """Spillable handle over a list of lowering values (ColV, StrV,
    DictV): the working-set form of a join's build side, where no schema
    is attached."""

    def __init__(self, vals, priority: int = ACTIVE_BATCHING_PRIORITY,
                 catalog: Optional[BufferCatalog] = None,
                 ledger_kind: str = "spillable"):
        arrays, self._layout = _flatten(vals)
        self._handle = SpillableHandle(arrays, priority, catalog,
                                       ledger_kind=ledger_kind)

    @property
    def size_bytes(self) -> int:
        return self._handle.size

    @property
    def handle(self) -> SpillableHandle:
        return self._handle

    @property
    def tier(self) -> int:
        return self._handle.tier

    def get_vals(self) -> list:
        return _unflatten(self._handle.materialize(), self._layout)

    def close(self, reason: str = "close") -> None:
        self._handle.close(reason=reason)


class SpillableColumnarBatch:
    """A batch in the catalog; :meth:`get_batch` gives it back on its
    device from whatever tier it is on."""

    def __init__(self, batch: ColumnarBatch,
                 priority: int = ACTIVE_BATCHING_PRIORITY,
                 catalog: Optional[BufferCatalog] = None,
                 ledger_kind: str = "spillable"):
        self.schema = batch.schema
        self.num_rows = batch.num_rows
        self._capacity = batch.capacity
        arrays, self._layout = _flatten(
            [val_of_column(c) if not c.is_dict else c.dictv
             for c in batch.columns])
        self._handle = SpillableHandle(arrays, priority, catalog,
                                       ledger_kind=ledger_kind)

    @property
    def size_bytes(self) -> int:
        return self._handle.size

    @property
    def tier(self) -> int:
        return self._handle.tier

    def get_batch(self) -> ColumnarBatch:
        vals = _unflatten(self._handle.materialize(), self._layout)
        cols: List[DeviceColumn] = [
            column_of_val(f.dataType, self.num_rows, v)
            for f, v in zip(self.schema.fields, vals)]
        return ColumnarBatch(cols, self.schema, self.num_rows,
                             capacity=self._capacity)

    def close(self, reason: str = "close") -> None:
        self._handle.close(reason=reason)
