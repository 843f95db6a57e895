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
(``exec/exchange.py``), or a mesh stage (``exec/mesh.py``) stages it onto
its shards. The mesh halves: :class:`MeshShardedScanExec` (per-shard host
columns, placed straight on their shards) and the parquet scan's
``mesh_stage_items`` / ``stage_mesh_planes`` (row groups round-robined
over the shards, each shard's row groups decoded through the device
decode onto its own device: ``io/mesh_stage.py``). The serving path's
:meth:`TpuFileSourceScanExec.host_prefetch` (reference
``exec/scan.py:370``) starts every split's read, or its device decode,
on a two-worker prefetch pool once the query is admitted; the drain
consumes those futures, and :meth:`invalidate_prefetch` drops them under
OOM pressure.

Metrics: ``scanTime`` (host read of the plain route), ``tpuDecodeTime``
(the device-decode route's wall: planning, uploads and the decode ops
enqueued; host time, not device time), ``hostDecodeTime`` (the host
chunk decode, summed over the decode pool's threads), ``uploadBytes`` and
``hostFallbackChunks`` (column chunks of the device-decode route that the
device decoder did not take, decoded by pyarrow on the host instead).
"""
from __future__ import annotations

import threading
from typing import Iterator

import numpy as np
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

# Serving-path prefetch pool (reference ``exec/scan.py:27-45``):
# host_prefetch() submits whole-split reads here. DISTINCT from the
# chunk-decode pool on purpose — a split read fans out chunk decodes onto
# that pool, so running the outer task on the same bounded pool could
# occupy every worker with waiters (nested-pool deadlock). Two workers
# are enough: the point is overlap with the device phase, not parallel
# split storms.
_PREFETCH_POOL = None
_PREFETCH_POOL_LOCK = threading.Lock()


def _prefetch_pool():
    global _PREFETCH_POOL
    if _PREFETCH_POOL is None:
        with _PREFETCH_POOL_LOCK:
            if _PREFETCH_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _PREFETCH_POOL = ThreadPoolExecutor(
                    max_workers=2, thread_name_prefix="srt-prefetch")
    return _PREFETCH_POOL


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


class MeshShardedScanExec(TpuExec):
    """Leaf over PER-PARTITION host column arrays: the decoded form a
    data-parallel scan hands the mesh (reference ``exec/scan.py:73``).
    Under a mesh stage, ``stage_mesh_planes`` places partition ``i`` on
    mesh shard ``i % n`` straight from the host
    (``io/mesh_stage.stage_sharded``: no gather, the host copy of shard
    k+1 overlapping the upload of shard k). Off the mesh it emits
    ordinary device batches on ``device`` (``None``: the CUDA card), so
    the same exec drives the host-exchange plan of a mesh query.

    ``parts``: one entry per partition, a list of (data, validity) numpy
    pairs (schema order) plus the live row count."""

    def __init__(self, conf: RapidsConf, parts, schema: StructType,
                 device=None):
        super().__init__(conf)
        self._parts = [(list(arrays), int(rows)) for arrays, rows in parts]
        self._schema = schema
        self._device = resolve_device(device)

    @property
    def device(self):
        return self._device

    @property
    def output_schema(self) -> StructType:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return max(1, len(self._parts))

    def describe(self):
        return f"MeshShardedScanExec({len(self._parts)} shard parts)"

    def partition_rows(self):
        """Static per-partition row counts."""
        return [rows for _, rows in self._parts]

    def mesh_stage_items(self):
        """Per-item row counts the sharded-scan staging round-robins
        (None: the fast path declines)."""
        from ..io import mesh_stage as MS

        if not MS.stageable_schema(self._schema):
            return None
        return self.partition_rows()

    def stage_mesh_planes(self, mesh, n_shards: int, conf, on_shard=None):
        from ..io import mesh_stage as MS

        if not MS.stageable_schema(self._schema):
            return None
        assign = MS.round_robin(len(self._parts), n_shards)
        rows_per_shard = [sum(self._parts[i][1] for i in idxs)
                          for idxs in assign]

        def decode_shard(s: int) -> "MS.ShardPayload":
            arrays = []
            for j, f in enumerate(self._schema.fields):
                pieces = [self._parts[i][0][j] for i in assign[s]]
                rows = [self._parts[i][1] for i in assign[s]]
                arrays.append((
                    np.concatenate([d[:r] for (d, _), r in zip(pieces, rows)]
                                   or [np.zeros(0, f.dataType.to_numpy())]),
                    np.concatenate([v[:r] for (_, v), r in zip(pieces, rows)]
                                   or [np.zeros(0, bool)])))
            return MS.ShardPayload(arrays, rows_per_shard[s])

        return MS.stage_sharded(
            mesh, n_shards, self._schema, decode_shard, rows_per_shard,
            self.conf.shape_bucket_min, on_shard=on_shard)

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        from ..io.arrow_convert import packed_upload

        if index >= len(self._parts):
            return
        arrays, n = self._parts[index]
        if n == 0:
            return
        cap = choose_capacity(max(1, n))
        planes = []
        for f, (data, valid) in zip(self._schema.fields, arrays):
            d = np.zeros(cap, f.dataType.to_numpy())
            v = np.zeros(cap, bool)
            d[:n] = data[:n]
            v[:n] = valid[:n]
            planes.extend([d, v])
        with named_oom(f"{self.node_name}.upload"):
            up = packed_upload(planes, self._device)
        cols = [DeviceColumn(f.dataType, n, up[2 * j], up[2 * j + 1])
                for j, f in enumerate(self._schema.fields)]
        yield self.record_batch(ColumnarBatch(cols, self._schema, n))


class TpuFileSourceScanExec(TpuExec):
    """Columnar scan over a file scanner's splits (one split = one
    partition) on ``device`` (``None``: the CUDA card)."""

    def __init__(self, conf: RapidsConf, scanner, fmt: str, device=None):
        super().__init__(conf)
        self.scanner = scanner
        self.fmt = fmt
        self._device = resolve_device(device)
        self._prefetch = None  # MULTITHREADED reader futures
        self._prefetch_dev = None  # host_prefetch device-path futures
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

    def _mesh_row_groups(self):
        """Flat (path, row_group, rows) list for the mesh round-robin:
        row group i goes to shard i % n. None when the scanner's splits
        do not expose row groups or a footer is unreadable."""
        splits = getattr(self.scanner, "splits", None)
        if splits is None:
            return None
        try:
            import pyarrow.parquet as pq

            out = []
            mds = {}
            for sp in splits():
                rgs = getattr(sp, "row_groups", None)
                if rgs is None:
                    return None
                md = mds.get(sp.path)
                if md is None:
                    md = mds[sp.path] = pq.ParquetFile(sp.path).metadata
                for rg in rgs:
                    out.append((sp.path, rg, md.row_group(rg).num_rows))
            return out
        except Exception:
            return None

    def mesh_stage_items(self):
        """Per-ROW-GROUP rows the sharded scan round-robins (None: the
        fast path declines)."""
        from ..io import mesh_stage as MS

        if getattr(self.scanner, "partition_cols", None):
            return None
        if not MS.stageable_schema(self.output_schema):
            return None
        rgs = self._mesh_row_groups()
        return None if rgs is None else [r for _, _, r in rgs]

    def partition_rows(self):
        """Static per-split row counts from the parquet footers (None when
        unknowable)."""
        rgs = self._mesh_row_groups()
        if rgs is None:
            return None
        return [sum(r for p, rg, r in rgs
                    if p == sp.path and rg in sp.row_groups)
                for sp in self.scanner.splits()]

    def stage_mesh_planes(self, mesh, n_shards: int, conf, on_shard=None):
        """Data-parallel parquet ingestion (reference
        ``exec/scan.py:271``): row groups round-robined over the mesh
        shards; each shard's row groups are decoded through the device
        decode (``io/parquet_device.read_row_groups_pipelined``) onto that
        shard's device on a worker thread, while the previous shard's
        planes are padded to the common capacity
        (``io/mesh_stage.stage_sharded``). A row group no column of which
        takes the device path decodes through pyarrow on the host.
        Fixed-width file columns only; partition-value columns are
        strings and keep the generic path. Reads bypass the device scan
        cache, which holds the plan device's batches."""
        from ..io import mesh_stage as MS

        if getattr(self.scanner, "partition_cols", None):
            return None
        schema = self.output_schema
        if not MS.stageable_schema(schema):
            return None
        rgs = self._mesh_row_groups()
        if rgs is None:
            return None
        assign = MS.round_robin(len(rgs), n_shards)
        rows_per_shard = [sum(rgs[i][2] for i in idxs) for idxs in assign]
        columns = [f.name for f in schema.fields]
        devices = list(mesh.devices)

        def decode_shard(s: int) -> "MS.ShardPayload":
            import pyarrow.parquet as pq

            from ..conf import (PARQUET_DEVICE_DECODE,
                                PARQUET_PIPELINE_MAX_IN_FLIGHT)
            from ..io.arrow_convert import _np_from_arrow_array
            from ..io.parquet_device import read_row_groups_pipelined

            dev = devices[s]
            by_path = {}
            for i in assign[s]:
                path, rg, _ = rgs[i]
                by_path.setdefault(path, []).append(rg)
            with self.op_timed("mesh_decode", DECODE_TIME):
                pieces = []  # per row group: [(data, valid) per column]
                for path, groups in by_path.items():
                    pf = pq.ParquetFile(path)
                    got = ([None] * len(groups)
                           if not self.conf.get(PARQUET_DEVICE_DECODE)
                           else [b for _, b in read_row_groups_pipelined(
                               path, pf, groups, columns, schema.fields,
                               max_in_flight=self.conf.get(
                                   PARQUET_PIPELINE_MAX_IN_FLIGHT),
                               device=dev, metrics=self.metrics)])
                    for rg, b in zip(groups, got):
                        n = pf.metadata.row_group(rg).num_rows
                        if b is not None:
                            pieces.append([(c.data[:n], c.validity[:n])
                                           for c in b.columns])
                            continue
                        t = pf.read_row_groups([rg], columns=columns)
                        host = [_np_from_arrow_array(
                            t.column(j).combine_chunks(), f.dataType)
                            for j, f in enumerate(schema.fields)]
                        pieces.append([
                            (torch.from_numpy(np.ascontiguousarray(
                                d[:n])).to(dev),
                             torch.from_numpy(np.ascontiguousarray(
                                 v[:n])).to(dev)) for d, v in host])
                arrays = []
                for j, f in enumerate(schema.fields):
                    if pieces:
                        arrays.append((torch.cat([p[j][0] for p in pieces]),
                                       torch.cat([p[j][1] for p in pieces])))
                    else:
                        arrays.append((np.zeros(0, f.dataType.to_numpy()),
                                       np.zeros(0, bool)))
            return MS.ShardPayload(arrays, rows_per_shard[s])

        return MS.stage_sharded(
            mesh, n_shards, schema, decode_shard, rows_per_shard,
            self.conf.shape_bucket_min, on_shard=on_shard)

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

    def host_prefetch(self) -> None:
        """Serving-path phase split (reference ``exec/scan.py:370``):
        start every split's device decode (or, for a scanner without
        one, its host read) on the prefetch pool NOW, before the caller
        takes the device semaphore — the host work of an admitted query
        overlaps the running query's device work. The drain consumes the
        futures instead of reading again."""
        n = self.scanner.num_splits()
        if n == 0:
            return
        if hasattr(self.scanner, "read_split_device"):
            if self._prefetch_dev is None:
                self._prefetch_dev = [
                    _prefetch_pool().submit(
                        self.scanner.read_split_device, i, self._device,
                        self.metrics)
                    if i not in self._consumed_splits else None
                    for i in range(n)
                ]
        elif self._prefetch is None:
            self._prefetch = [
                _prefetch_pool().submit(self.scanner.read_split_i, i)
                if i not in self._consumed_splits else None
                for i in range(n)
            ]

    def invalidate_prefetch(self) -> None:
        """OOM-pressure hook (``memory/retry.py``'s ``on_pressure``):
        cancel pending prefetch futures and drop the tables — the device
        path's futures hold decoded device batches, exactly the residency
        an OOM recovery wants back. Futures already running finish and
        are collected; the drain reads those splits again, so the results
        are the same either way."""
        for futs in (self._prefetch_dev, self._prefetch):
            if futs:
                for f in futs:
                    if f is not None:
                        f.cancel()
        self._prefetch_dev = None
        self._prefetch = None

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
                fut = None
                if self._prefetch_dev is not None:
                    fut = self._prefetch_dev[index]
                    self._prefetch_dev[index] = None
                if fut is not None:
                    dev, pvals = fut.result()
                else:
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
