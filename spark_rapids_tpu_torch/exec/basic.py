"""Basic physical operators: scan-from-memory, project, filter.

Counterpart of ``spark_rapids_tpu/exec/basic.py`` (``InMemoryScanExec``,
``TpuProjectExec``, ``TpuFilterExec``). Project and filter are fusable:
below an aggregate they run inside its per-batch update, and a filter
only clears liveness bits there — rows compact only where a dense batch
is emitted (``base.run_fused_chain``).
"""
from __future__ import annotations

from typing import Iterator, Sequence

from ..columnar import ColumnarBatch, resolve_device
from ..conf import RapidsConf
from ..expr import expressions as E
from ..expr.eval import lower
from ..types import StructField, StructType
from .base import TpuExec, run_fused_chain


def _output_schema_for(exprs: Sequence[E.Expression],
                       child: StructType) -> StructType:
    fields = []
    for i, e in enumerate(exprs):
        name = e.name if isinstance(e, (E.Alias, E.UnresolvedAttribute)) \
            else f"col{i}"
        bound = E.bind_references(e, child)
        fields.append(StructField(name, bound.dtype, bound.nullable))
    return StructType(tuple(fields))


class InMemoryScanExec(TpuExec):
    """Leaf over already device-resident batches; each partition is a list
    of batches. The plan's device is ``device``, or with ``device=None``
    the batches' own; a scan with no batches and ``device=None`` is on the
    CUDA card."""

    def __init__(self, conf: RapidsConf,
                 partitions: Sequence[Sequence[ColumnarBatch]],
                 schema: StructType, device=None):
        super().__init__(conf)
        self._partitions = [list(p) for p in partitions]
        self._schema = schema
        if device is None:
            device = next((c.validity.device for p in self._partitions
                           for b in p for c in b.columns), None)
        self._device = resolve_device(device)

    @property
    def device(self):
        return self._device

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return len(self._partitions)

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        for b in self._partitions[index]:
            yield self.record_batch(b)

    @staticmethod
    def from_pydict(conf: RapidsConf, data, schema: StructType,
                    device=None) -> "InMemoryScanExec":
        """One partition of one uploaded batch; ``device=None`` is the
        CUDA card."""
        batch = ColumnarBatch.from_pydict(data, schema, device=device)
        return InMemoryScanExec(conf, [[batch]], schema, device)


class TpuProjectExec(TpuExec):
    fusable = True

    def __init__(self, conf: RapidsConf, exprs: Sequence[E.Expression],
                 child: TpuExec):
        super().__init__(conf, [child])
        self.exprs = list(exprs)
        self._schema = _output_schema_for(self.exprs, child.output_schema)
        self._bound = tuple(E.bind_references(e, child.output_schema)
                            for e in self.exprs)

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        return f"TpuProjectExec [{', '.join(map(str, self.exprs))}]"

    def lower_batch(self, cols, live, cap, side=()):
        return [lower(e, cols, cap, live.device) for e in self._bound], live

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        yield from run_fused_chain(self, index)


class TpuFilterExec(TpuExec):
    fusable = True
    sparsifies = True

    def __init__(self, conf: RapidsConf, condition: E.Expression,
                 child: TpuExec):
        super().__init__(conf, [child])
        self.condition = condition
        self._bound = E.bind_references(condition, child.output_schema)

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def describe(self):
        return f"TpuFilterExec [{self.condition}]"

    def lower_batch(self, cols, live, cap, side=()):
        c = lower(self._bound, cols, cap, live.device)
        return cols, live & c.data & c.validity

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        yield from run_fused_chain(self, index)
