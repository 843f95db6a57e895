"""The row <-> columnar boundaries of a mixed CPU/device plan.

Counterpart of ``spark_rapids_tpu/exec/transitions.py``:
``RowToColumnarExec`` uploads a CPU exec's rows as device batches of at
most ``sql.reader.batchSizeRows`` rows (on the device it is given: an
entry point, so ``None`` is the CUDA card); ``ColumnarToRowExec`` turns
device batches back into host rows, string columns decoding to ``str``
(``bytes`` for binary) through ``columnar.column.decode_string_rows``,
with a d2h ``transfer`` event a batch while logging is on.
"""
from __future__ import annotations

from typing import Iterator, List

from .. import events as _events
from .. import obs as _obs
from ..columnar import ColumnarBatch, resolve_device
from ..columnar.batch import batch_from_rows
from ..conf import MAX_READER_BATCH_SIZE_ROWS, RapidsConf
from ..cpu.plan import CpuExec
from ..types import StructType
from .base import TpuExec, batch_bytes


class RowToColumnarExec(TpuExec):
    """CPU rows -> device batches (host build + single upload per batch)."""

    def __init__(self, conf: RapidsConf, cpu_child: CpuExec, device=None):
        super().__init__(conf)
        self.cpu_child = cpu_child
        self._batch_rows = conf.get(MAX_READER_BATCH_SIZE_ROWS)
        self._device = resolve_device(device)

    @property
    def device(self):
        return self._device

    @property
    def output_schema(self) -> StructType:
        return self.cpu_child.output_schema

    @property
    def num_partitions(self) -> int:
        return self.cpu_child.num_partitions

    def describe(self):
        return "RowToColumnarExec"

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        lines.append(self.cpu_child.tree_string(indent + 1))
        return "\n".join(lines)

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        buf: List[tuple] = []
        for row in self.cpu_child.execute_rows_partition(index):
            buf.append(row)
            if len(buf) >= self._batch_rows:
                yield self.record_batch(batch_from_rows(
                    buf, self.output_schema, self._device))
                buf = []
        if buf:
            yield self.record_batch(batch_from_rows(
                buf, self.output_schema, self._device))


class ColumnarToRowExec(CpuExec):
    """Device batches -> host rows (the collect boundary), through
    ``ColumnarBatch.host_columns``: a dictionary-encoded column copies
    its codes, validity and whole dictionary, with no byte-count sync,
    and decodes each entry once."""

    def __init__(self, conf: RapidsConf, tpu_child: TpuExec):
        super().__init__(conf)
        self.tpu_child = tpu_child

    @property
    def output_schema(self) -> StructType:
        return self.tpu_child.output_schema

    @property
    def num_partitions(self) -> int:
        return self.tpu_child.num_partitions

    def describe(self):
        return "ColumnarToRowExec"

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        lines.append(self.tpu_child.tree_string(indent + 1))
        return "\n".join(lines)

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        for batch in self.tpu_child.execute_partition(index):
            rows = batch.to_rows()
            if _events.enabled() or _obs.enabled():
                # the device->host read of the collect boundary (the
                # reference's host_pull): one transfer a batch, its bytes
                # at the batch's live rows
                nb = batch_bytes(batch, batch.num_rows)
                _events.emit("transfer", direction="d2h", bytes=nb,
                             site="collect")
                _obs.inc("tpu_transfers", 1, direction="d2h")
                _obs.inc("tpu_transfer_bytes", nb, direction="d2h")
            yield from rows
