"""The columnar -> row boundary.

Counterpart of ``ColumnarToRowExec`` in
``spark_rapids_tpu/exec/transitions.py``: device batches -> host rows;
string columns decode to ``str`` (``bytes`` for binary) through
``columnar.column.decode_string_rows``.
"""
from __future__ import annotations

from typing import Iterator, List

from ..conf import RapidsConf
from ..types import StructType
from .base import TpuExec


class ColumnarToRowExec:
    """Device batches -> host rows (the collect boundary)."""

    def __init__(self, conf: RapidsConf, tpu_child: TpuExec):
        self.conf = conf
        self.tpu_child = tpu_child

    @property
    def output_schema(self) -> StructType:
        return self.tpu_child.output_schema

    @property
    def num_partitions(self) -> int:
        return self.tpu_child.num_partitions

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        for batch in self.tpu_child.execute_partition(index):
            yield from batch.to_rows()

    def collect(self) -> List[tuple]:
        return [row for p in range(self.num_partitions)
                for row in self.execute_rows_partition(p)]
