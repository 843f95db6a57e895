"""Sharded ingestion: place scan partitions directly on mesh shards.

Counterpart of ``spark_rapids_tpu/io/mesh_stage.py``. The generic mesh
staging path (``exec/mesh._MeshStage._stage_child``) executes every child
partition on the plan's device and gathers its batches onto the shards.
This module is the data-parallel alternative for sources whose
partitions are host-decodable: shard ``s``'s items are decoded on the
host and uploaded STRAIGHT to mesh shard ``s``'s device, with the host
decode of shard s+1 overlapping the upload of shard s on a worker thread
(the cross-device extension of the parquet scan's decode -> upload
pipeline).

Fixed-width columns only: a string column's byte pool needs a global
re-bucketing decision that defeats per-shard streaming; scans with string
output keep the generic staging path.

Reference analog: the multi-threaded cloud reader feeding the shuffle
transport directly (MultiFileCloudParquetPartitionReader,
GpuParquetScan.scala:1299).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..columnar.column import choose_capacity
from ..expr.values import ColV
from ..types import StructType


class ShardPayload(NamedTuple):
    """One shard's decoded columns: ``arrays[j]`` = (data, validity) for
    column j (numpy arrays, or tensors already on the shard's device),
    ``rows`` = live row count."""

    arrays: List[Tuple[object, object]]
    rows: int


class StagedPlanes(NamedTuple):
    """What ``exec/mesh._MeshStage`` consumes: per shard its columns on
    its device (``cols[s]``), the per-shard live row counts, the common
    per-shard capacity, the column layout/smls tuples of the generic
    staging path, and per-shard staged byte counts for the transfer
    events."""

    cols: List[List[object]]
    counts: np.ndarray
    cap: int
    layout: tuple
    smls: tuple
    staged_bytes: tuple


def mesh_shard_cap(rows_per_shard: Sequence[int], bucket_min: int) -> int:
    """The common per-shard row capacity: the bucketed max shard row
    count. ONE home for this rule: every staging path calls it."""
    return choose_capacity(max(max(rows_per_shard, default=0), 1),
                           bucket_min)


def shard_plane_bytes(cap: int, fields) -> int:
    """Per-shard staged bytes for a fixed-width schema at capacity
    ``cap``: data plane + 1-byte validity plane per column (the exact
    bytes the staging paths place)."""
    total = 0
    for f in fields:
        total += cap * (np.dtype(f.dataType.to_numpy()).itemsize + 1)
    return total


def stageable_schema(schema: StructType) -> bool:
    return all(T.is_fixed_width(f.dataType) for f in schema.fields)


def _padded(x, n: int, cap: int, dtype, device) -> torch.Tensor:
    """``x[:n]`` in a zeroed (cap,) plane on ``device``; a host array is
    padded on the host and crosses once."""
    if isinstance(x, torch.Tensor):
        out = torch.zeros(cap, dtype=x.dtype, device=device)
        out[:n] = x[:n].to(device)
        return out
    host = np.zeros(cap, dtype)
    host[:n] = x[:n]
    return torch.from_numpy(host).to(device)


def stage_sharded(
    mesh,
    n_shards: int,
    schema: StructType,
    decode_shard: Callable[[int], ShardPayload],
    rows_per_shard: Sequence[int],
    bucket_min: int,
    on_shard: Optional[Callable[[int, int, int, float], None]] = None,
) -> StagedPlanes:
    """Decode + place each shard's rows on its own mesh device.

    ``decode_shard(s)`` runs on a worker thread; the caller thread pads
    the decoded columns into planes on shard ``s``'s device while the
    worker decodes shard ``s+1``. ``rows_per_shard`` must be known up
    front (parquet metadata, partition row counts) because the common
    capacity is a global max. ``on_shard(s, rows, bytes, seconds)`` fires
    after each shard is placed (the per-shard transfer lane). A device
    allocation failure names the shard (``TpuOutOfDeviceMemory`` with the
    catalog's watermark), never a raw allocator error mid-pipeline."""
    from ..memory.retry import named_oom

    fields = schema.fields
    if not stageable_schema(schema):
        raise ValueError("stage_sharded is fixed-width only")
    cap = mesh_shard_cap(rows_per_shard, bucket_min)
    devices = list(mesh.devices)
    cols: List[List[object]] = [[] for _ in range(n_shards)]
    counts = np.zeros(n_shards, np.int32)
    staged_bytes = [0] * n_shards

    def upload_shard(s: int, payload: ShardPayload) -> None:
        t0 = time.perf_counter()
        n = int(payload.rows)
        counts[s] = n
        with named_oom(f"mesh_stage[shard {s}]"):
            for j, f in enumerate(fields):
                dt = f.dataType.to_numpy()
                data, valid = payload.arrays[j] if n else (
                    np.zeros(0, dt), np.zeros(0, bool))
                cols[s].append(ColV(_padded(data, n, cap, dt, devices[s]),
                                    _padded(valid, n, cap, bool,
                                            devices[s])))
        staged_bytes[s] = shard_plane_bytes(cap, fields)
        if on_shard is not None:
            on_shard(s, n, staged_bytes[s], time.perf_counter() - t0)

    # the 1-deep pipeline: the worker decodes shard k+1 while this thread
    # pads + places shard k
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="srt-meshdec") as pool:
        nxt = pool.submit(decode_shard, 0) if n_shards else None
        for s in range(n_shards):
            payload = nxt.result()
            nxt = (pool.submit(decode_shard, s + 1)
                   if s + 1 < n_shards else None)
            upload_shard(s, payload)
    layout = tuple(("f",) for _ in fields)
    smls = tuple(0 for _ in fields)
    return StagedPlanes(cols, counts, cap, layout, smls, tuple(staged_bytes))


def round_robin(num_items: int, n_shards: int) -> List[List[int]]:
    """Item index lists per shard: item i -> shard i % n (the placement
    contract of the sharded scan)."""
    out: List[List[int]] = [[] for _ in range(n_shards)]
    for i in range(num_items):
        out[i % n_shards].append(i)
    return out
