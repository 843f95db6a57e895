"""File-source scan exec: splits -> device batches.

Counterpart of the non-mesh ``TpuFileSourceScanExec`` of
``spark_rapids_tpu/exec/scan.py``: one split is one partition. A scanner
with a device decoder (parquet) takes the device-decode route, one batch
per row group (``io/parquet.read_split_device``, through the device scan
cache); otherwise, or when no column of a split takes the device path,
the split is read as a pyarrow table and uploaded buffer by buffer
(``io/arrow_convert.arrow_to_batch``). Hive partition values append as
constant string columns. The MULTITHREADED reader reads every split on a
thread pool at first touch. A fused scan->aggregate stage takes each
split's staged row-group decodes instead (:meth:`fused_stage_plans`). A
directory of several files is several splits, so several partitions, and
the planner puts exchanges above it where an aggregate, sort, join or
window needs them
(``exec/exchange.py``). The reference's mesh staging
(``MeshShardedScanExec``, the sharded row-group staging) and its serving
prefetch are not ported (ROADMAP.md, queue A items 'Multi-device
execution' and 'The remaining modules').

Metrics: ``scanTime`` (host read of the plain route), ``tpuDecodeTime``
(the device-decode route's wall: planning, uploads and the decode ops
enqueued; host time, not device time), ``hostDecodeTime`` (the host
chunk decode, summed over the decode pool's threads), ``uploadBytes`` and
``hostFallbackChunks`` (column chunks of the device-decode route that the
device decoder did not take, decoded by pyarrow on the host instead).
"""
from __future__ import annotations

from typing import Iterator

import torch

from .. import types as T
from ..columnar import ColumnarBatch, resolve_device
from ..columnar.column import DeviceColumn, choose_capacity
from ..conf import RapidsConf
from ..io.parquet_device import (HOST_DECODE_TIME, HOST_FALLBACK_CHUNKS,
                                 UPLOAD_BYTES)
from ..memory.retry import named_oom
from ..types import StructType
from .base import TpuExec

SCAN_TIME = "scanTime"  # reference metric name (GpuMetricNames)
DECODE_TIME = "tpuDecodeTime"


def constant_string_column(value, n: int, cap: int, device) -> DeviceColumn:
    """One value repeated n times (a partition-value column, a file
    name), built on ``device``: the value's bytes cross once."""
    valid = torch.arange(cap, device=device) < n
    if value is None:
        return DeviceColumn(
            T.STRING, n, None, torch.zeros(cap, dtype=torch.bool,
                                           device=device),
            offsets=torch.zeros(cap + 1, dtype=torch.int32, device=device),
            chars=torch.zeros(1, dtype=torch.uint8, device=device))
    b = str(value).encode("utf-8")
    L = len(b)
    offsets = (torch.arange(cap + 1, dtype=torch.int64, device=device) * L
               ).clamp_(max=L * n).to(torch.int32)
    chars = torch.zeros(choose_capacity(max(1, L * n), 128),
                        dtype=torch.uint8, device=device)
    if L and n:
        one = torch.frombuffer(bytearray(b), dtype=torch.uint8).to(device)
        chars[: L * n] = one.repeat(n)
    return DeviceColumn(T.STRING, n, None, valid, offsets=offsets,
                        chars=chars)


class TpuFileSourceScanExec(TpuExec):
    """Columnar scan over a file scanner's splits (one split = one
    partition) on ``device`` (``None``: the CUDA card)."""

    def __init__(self, conf: RapidsConf, scanner, fmt: str, device=None):
        super().__init__(conf)
        self.scanner = scanner
        self.fmt = fmt
        self._device = resolve_device(device)
        self._prefetch = None  # MULTITHREADED reader futures
        #: splits already drained: a prefetch table built later must not
        #: resubmit them
        self._consumed_splits: set = set()
        for name in (SCAN_TIME, DECODE_TIME, HOST_DECODE_TIME):
            self.metric(name, "ns")
        for name in (UPLOAD_BYTES, HOST_FALLBACK_CHUNKS):
            self.metric(name, "count")

    @property
    def device(self):
        return self._device

    @property
    def output_schema(self) -> StructType:
        return self.scanner.schema

    @property
    def num_partitions(self) -> int:
        return max(1, self.scanner.num_splits())

    def describe(self):
        return (f"TpuFileSourceScanExec {self.fmt} "
                f"{getattr(self.scanner, 'path', '')}")

    def _read_split(self, index: int):
        """Split read, through the MULTITHREADED prefetcher for cloud
        paths: every split is read on a thread pool at first touch, so
        later partitions find their tables already fetched."""
        rt = getattr(self.scanner, "reader_type", lambda: "PERFILE")()
        self._consumed_splits.add(index)
        if rt != "MULTITHREADED" and self._prefetch is None:
            return self.scanner.read_split_i(index)
        if self._prefetch is None:
            from concurrent.futures import ThreadPoolExecutor

            from ..conf import PARQUET_MULTITHREAD_READ_NUM_THREADS

            pool = ThreadPoolExecutor(
                max_workers=self.conf.get(
                    PARQUET_MULTITHREAD_READ_NUM_THREADS),
                thread_name_prefix="srt-scan")
            self._prefetch = [
                pool.submit(self.scanner.read_split_i, i)
                if i not in self._consumed_splits else None
                for i in range(self.scanner.num_splits())
            ]
            pool.shutdown(wait=False)
        fut = self._prefetch[index]
        self._prefetch[index] = None  # free the table once consumed
        if fut is None:
            return self.scanner.read_split_i(index)
        return fut.result()

    def _attach_partition_cols(self, batch: ColumnarBatch, pvals):
        schema = self.output_schema
        pkeys = list(getattr(self.scanner, "partition_cols", ()))
        if not pkeys:
            return batch
        pmap = dict(pvals)
        n, cap = batch.num_rows, max(batch.capacity, 1)
        cols = list(batch.columns)
        for k in pkeys:
            cols.append(constant_string_column(pmap.get(k), n, cap,
                                               self._device))
        return ColumnarBatch(cols, schema, n)

    def fused_stage_plans(self, index: int):
        """Stage fusion (reference ``exec/scan.py:357-368``): the consumer
        exec gets split ``index``'s per-row-group staged decodes and runs
        them inside its fused scan->aggregate stage. None: use
        :meth:`execute_partition`. The host planning and the uploads
        count in ``tpuDecodeTime`` (the reference bills them to its
        ``scanTime``, which here is the plain route's host read), with
        ``hostDecodeTime`` and ``uploadBytes``."""
        if index >= self.scanner.num_splits():
            return None
        fn = getattr(self.scanner, "device_stage_plans", None)
        if fn is None:
            return None
        with self.op_timed("plan", DECODE_TIME), \
                named_oom(f"{self.node_name}.decode"):
            self._consumed_splits.add(index)
            return fn(index, self._device, self.metrics)

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        from ..io.arrow_convert import arrow_to_batch

        if index >= self.scanner.num_splits():
            return
        # the scan's uploads and decodes sit outside the per-batch retry
        # harness (no input batch to split yet): a device OOM there is the
        # named TpuOutOfDeviceMemory (reference exec/scan.py:433)
        if hasattr(self.scanner, "read_split_device"):
            with self.op_timed("decode", DECODE_TIME), \
                    named_oom(f"{self.node_name}.decode"):
                self._consumed_splits.add(index)
                dev, pvals = self.scanner.read_split_device(
                    index, self._device, self.metrics)
            if dev is not None:
                with named_oom(f"{self.node_name}.decode"):
                    for b in dev:
                        yield self.record_batch(
                            self._attach_partition_cols(b, pvals))
                return
        with self.op_timed("read", SCAN_TIME):
            table, pvals = self._read_split(index)
        with self.op_timed("decode", DECODE_TIME), \
                named_oom(f"{self.node_name}.decode"):
            schema = self.output_schema
            pkeys = list(getattr(self.scanner, "partition_cols", ()))
            file_fields = schema.fields[: len(schema.fields) - len(pkeys)]
            batch = arrow_to_batch(table, T.StructType(tuple(file_fields)),
                                   device=self._device)
            batch = self._attach_partition_cols(batch, pvals)
        yield self.record_batch(batch)
