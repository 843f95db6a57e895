"""Parquet scan: footer parse, row-group pruning, three reader strategies.

Own copy of ``spark_rapids_tpu/io/parquet.py``: ``discover_files``,
``PushedFilter``, row-group pruning by min/max/null statistics,
``ParquetScanner``'s split planning (PERFILE / COALESCING / AUTO, and
MULTITHREADED through the scan exec's thread pool) and
``read_split_device``, which decodes on the device the caller names. As
in the reference, pyarrow does the host half (footers, the host decode of
the columns the device decoder cannot take). The writer
(``write_parquet``) is not ported yet (ROADMAP.md, queue A item 'The
remaining modules'). The stage-fusion entry, :meth:`ParquetScanner.
device_stage_plans`, hands the fused scan->aggregate stage each row
group's staged decode (``exec/aggregate.py``).
"""
from __future__ import annotations

import dataclasses
import glob as _glob
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from .. import types as T
from ..conf import (
    CLOUD_SCHEMES,
    MAX_READER_BATCH_SIZE_BYTES,
    PARQUET_READER_TYPE,
    RapidsConf,
)
from .arrow_convert import arrow_schema_to_tpu


@dataclasses.dataclass(frozen=True)
class PushedFilter:
    """A col-vs-literal conjunct usable for row-group stat pruning
    (reference: the parquet filter pushdown in filterBlocks)."""

    column: str
    op: str  # one of < <= > >= = != isnull notnull
    value: Any = None


@dataclasses.dataclass
class FileSplit:
    """One scan partition: runs of row groups, plus partition values."""

    path: str
    row_groups: Tuple[int, ...]
    partition_values: Tuple[Tuple[str, Any], ...] = ()


def _is_cloud_path(path: str, conf: RapidsConf) -> bool:
    scheme = path.split("://", 1)[0] if "://" in path else ""
    return scheme in conf.get(CLOUD_SCHEMES).split(",")


def discover_files(path: str) -> List[Tuple[str, Tuple[Tuple[str, Any], ...]]]:
    """Expand a file/directory/glob into (file, hive partition values).

    Directory layouts with key=value components attach partition values
    (reference: partition-value columns in the V1 read bridges).
    """
    paths: List[str]
    if os.path.isdir(path):
        paths = sorted(
            p for p in _glob.glob(os.path.join(path, "**", "*"),
                                  recursive=True)
            if os.path.isfile(p) and not os.path.basename(p).startswith(
                ("_", "."))
        )
    elif any(c in path for c in "*?["):
        paths = sorted(p for p in _glob.glob(path) if os.path.isfile(p))
    else:
        paths = [path]
    out = []
    base = path.rstrip("/")
    for p in paths:
        pvals: List[Tuple[str, Any]] = []
        rel = os.path.relpath(p, base) if os.path.isdir(base) else ""
        for comp in rel.split(os.sep)[:-1]:
            if "=" in comp:
                k, v = comp.split("=", 1)
                pvals.append((k, None if v == "__HIVE_DEFAULT_PARTITION__"
                              else v))
        out.append((p, tuple(pvals)))
    return out


def _stats_allow(stats, f: PushedFilter) -> bool:
    """Can this row group contain rows passing the filter? Conservative:
    True when unknown (reference: filterBlocks keeps unprunable blocks)."""
    if stats is None or not stats.has_min_max:
        return f.op not in ("isnull",) or stats is None or (
            stats.null_count is None or stats.null_count > 0)
    mn, mx = stats.min, stats.max
    v = f.value
    try:
        if f.op == "=":
            return mn <= v <= mx
        if f.op == "<":
            return mn < v
        if f.op == "<=":
            return mn <= v
        if f.op == ">":
            return mx > v
        if f.op == ">=":
            return mx >= v
        if f.op == "isnull":
            return stats.null_count is None or stats.null_count > 0
        if f.op == "notnull":
            return stats.num_values is None or stats.num_values > 0
    except TypeError:
        return True
    return True


def prune_row_groups(pf, filters: Sequence[PushedFilter]) -> List[int]:
    """Row groups that may contain matching rows (min/max/null stats)."""
    md = pf.metadata
    name_to_idx = {md.schema.column(i).path: i
                   for i in range(md.num_columns)}
    keep = []
    for rg in range(md.num_row_groups):
        rgmd = md.row_group(rg)
        ok = True
        for f in filters:
            ci = name_to_idx.get(f.column)
            if ci is None:
                continue
            stats = rgmd.column(ci).statistics
            if not _stats_allow(stats, f):
                ok = False
                break
        if ok:
            keep.append(rg)
    return keep


class ParquetScanner:
    """Plans splits and reads them as pyarrow tables."""

    def __init__(self, path: str, conf: RapidsConf,
                 columns: Optional[Sequence[str]] = None,
                 filters: Sequence[PushedFilter] = ()):
        import pyarrow.parquet as pq

        self.path = path
        self.conf = conf
        self.filters = list(filters)
        self.files = discover_files(path)
        if not self.files:
            raise FileNotFoundError(path)
        first = pq.ParquetFile(self.files[0][0])
        self.file_schema = first.schema_arrow
        self.columns = list(columns) if columns is not None else [
            f.name for f in self.file_schema
        ]
        # partition columns come from directory names (string-typed);
        # only keys present on EVERY file become schema columns (ragged
        # layouts keep the common prefix)
        if self.files[0][1]:
            common = [k for k, _ in self.files[0][1]]
            for _, pv in self.files[1:]:
                keys = {k for k, _ in pv}
                common = [k for k in common if k in keys]
            self.partition_cols = common
        else:
            self.partition_cols = []
        base = arrow_schema_to_tpu(
            self.file_schema.empty_table().select(self.columns).schema)
        fields = list(base.fields)
        for k in self.partition_cols:
            fields.append(T.StructField(k, T.STRING, True))
        self.schema = T.StructType(tuple(fields))
        self._splits: Optional[List[FileSplit]] = None

    # -- planning ----------------------------------------------------------
    def reader_type(self) -> str:
        rt = self.conf.get(PARQUET_READER_TYPE)
        if rt != "AUTO":
            return rt
        return (
            "MULTITHREADED"
            if _is_cloud_path(self.path, self.conf) else "COALESCING"
        )

    def splits(self) -> List[FileSplit]:
        """Partition the scan: row-group pruning + file coalescing.

        PERFILE: one split per file. COALESCING: files/row-groups packed
        into splits up to the reader batch byte target. MULTITHREADED:
        per-file splits read with a thread pool at execute time.
        """
        if self._splits is not None:
            return self._splits
        import pyarrow.parquet as pq

        target = self.conf.get(MAX_READER_BATCH_SIZE_BYTES)
        rt = self.reader_type()
        splits: List[FileSplit] = []
        pending: List[FileSplit] = []
        pending_bytes = 0
        for fpath, pvals in self.files:
            pf = pq.ParquetFile(fpath)
            keep = prune_row_groups(pf, self.filters)
            if not keep:
                continue
            if rt in ("PERFILE", "MULTITHREADED"):
                splits.append(FileSplit(fpath, tuple(keep), pvals))
                continue
            # COALESCING: pack row-group runs up to the byte target
            md = pf.metadata
            for rg in keep:
                sz = md.row_group(rg).total_byte_size
                if pending and pending_bytes + sz > target:
                    splits.extend(_merge_pending(pending))
                    pending, pending_bytes = [], 0
                pending.append(FileSplit(fpath, (rg,), pvals))
                pending_bytes += sz
        if pending:
            splits.extend(_merge_pending(pending))
        if not splits:
            # fully pruned: one empty split keeps the schema flowing
            splits = [FileSplit(self.files[0][0], (), self.files[0][1])]
        self._splits = splits
        return splits

    # -- reading -----------------------------------------------------------
    def read_split(self, split: FileSplit):
        """One split -> pyarrow Table (file columns only)."""
        import pyarrow.parquet as pq

        pf = pq.ParquetFile(split.path)
        file_cols = [c for c in self.columns if c not in split_pcols(split)]
        if not split.row_groups:
            return pf.schema_arrow.empty_table().select(file_cols)
        t = pf.read_row_groups(list(split.row_groups), columns=file_cols)
        return t

    # unified scanner protocol (shared with CsvScanner/OrcScanner)
    def num_splits(self) -> int:
        return len(self.splits())

    def read_split_i(self, i: int):
        """(pyarrow table, partition values) for split i."""
        s = self.splits()[i]
        return self.read_split(s), s.partition_values

    def read_split_device(self, i: int, device=None, metrics=None):
        """Device-decode split i on ``device``: (list of ColumnarBatch —
        one per row group — or None when no column takes the device path,
        partition values). Cache-missing row groups go through the
        pipelined decode→upload reader
        (``io/parquet_device.read_row_groups_pipelined``): row group N+1
        host-decodes on the shared decode pool while N's staged transfer
        and device unpack run, bounded by
        ``...format.parquet.pipeline.maxInFlight``. ``metrics``: the
        exec's counters the reader adds its host decode time and uploaded
        bytes to."""
        import pyarrow.parquet as pq

        from ..conf import (
            PARQUET_DEVICE_DECODE,
            PARQUET_DICT_STRINGS,
            PARQUET_PIPELINE_MAX_IN_FLIGHT,
        )
        from .parquet_device import read_row_groups_pipelined

        if not self.conf.get(PARQUET_DEVICE_DECODE):
            return None, ()
        dict_strings = bool(self.conf.get(PARQUET_DICT_STRINGS))
        s = self.splits()[i]
        if not s.row_groups:
            return None, s.partition_values
        from .scan_cache import DeviceScanCache, file_key

        from ..columnar import resolve_device

        dev = resolve_device(device)
        cache = DeviceScanCache.get_instance(self.conf)
        file_cols = [c for c in self.columns if c not in split_pcols(s)]
        nfields = [
            f for f in self.schema.fields if f.name in file_cols
        ]
        # probe the cache BEFORE opening the file: a fully-hot file must
        # not re-pay the footer parse / mmap it is cached to avoid
        # (the dict-strings flag is part of the key: the two layouts must
        # never serve each other's cached batches)
        kind = ("batch-dict" if dict_strings else "batch", str(dev))
        keys = ([file_key(s.path, rg, file_cols, kind)
                 for rg in s.row_groups] if cache is not None else None)
        batches = [cache.get(k) for k in keys] if cache is not None else [
            None] * len(s.row_groups)
        if all(b is not None for b in batches):
            return batches, s.partition_values
        pf = pq.ParquetFile(s.path)
        # mmap: plan_chunk touches only the selected chunks' byte ranges,
        # so the OS pages in just those — no O(splits x file) reads
        import mmap

        f = open(s.path, "rb")
        try:
            file_bytes = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            file_bytes = b""
        finally:
            f.close()
        missing = [j for j, b in enumerate(batches) if b is None]
        gen = read_row_groups_pipelined(
            s.path, pf, [s.row_groups[j] for j in missing], file_cols,
            nfields, file_bytes, dict_strings=dict_strings,
            max_in_flight=self.conf.get(PARQUET_PIPELINE_MAX_IN_FLIGHT),
            device=dev, metrics=metrics)
        for j, (rg, b) in zip(missing, gen):
            if b is None:
                # no device-decodable column in this row group: the whole
                # split uses the plain reader (generator abandonment is
                # safe — outstanding decode tasks drop their results)
                return None, s.partition_values
            if cache is not None:
                cache.put(keys[j], b, batch_device_bytes(b))
            batches[j] = b
        return batches, s.partition_values


    def device_stage_plans(self, i: int, device=None, metrics=None):
        """The stage-fusion entry (reference ``io/parquet.py:321-380``):
        split i's per-row-group decode plans, their arguments uploaded
        but nothing decoded, so a consumer exec runs the decode inside
        its own fused stage. A list per row group of ``(num_rows, cap,
        entries)``, ``entries`` = ``[(device args, run, field), ...]``
        (``io/parquet_device.row_group_device_plans``); None for a
        partitioned scan, a split with no row groups, ``deviceDecode``
        off, or when any column needs the host decoder (the caller then
        uses ``execute_partition``). Entries are cached in the device
        scan cache under the ``"stage"`` / ``"stage-dict"`` keys, sized
        by the bytes of their arguments: a warm stage skips the host
        decode and the upload but decodes the pages again. A split is
        cached only when every row group has its plan; when one declines,
        every row group of the split is cached as declined (0 bytes), so
        a later call on the same file returns None without planning it again
        (the reference plans it again on every execution). ``metrics``:
        the exec's counters, as in :meth:`read_split_device`."""
        import pyarrow.parquet as pq

        from ..columnar import resolve_device
        from ..conf import PARQUET_DEVICE_DECODE, PARQUET_DICT_STRINGS
        from .parquet_device import row_group_device_plans
        from .scan_cache import DeviceScanCache, file_key

        if not self.conf.get(PARQUET_DEVICE_DECODE):
            return None
        dict_strings = bool(self.conf.get(PARQUET_DICT_STRINGS))
        s = self.splits()[i]
        if not s.row_groups or self.partition_cols:
            return None
        dev = resolve_device(device)
        cache = DeviceScanCache.get_instance(self.conf)
        file_cols = [c for c in self.columns if c not in split_pcols(s)]
        nfields = [f for f in self.schema.fields if f.name in file_cols]
        # probe the cache before opening the file (see read_split_device)
        kind = ("stage-dict" if dict_strings else "stage", str(dev))
        keys = ([file_key(s.path, rg, file_cols, kind)
                 for rg in s.row_groups] if cache is not None else None)
        out = ([cache.get(k) for k in keys] if cache is not None
               else [None] * len(s.row_groups))
        if any(x is STAGE_DECLINED for x in out):
            return None
        if all(x is not None for x in out):
            return out
        pf = pq.ParquetFile(s.path)
        import mmap

        f = open(s.path, "rb")
        try:
            file_bytes = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            file_bytes = b""
        finally:
            f.close()
        planned = []
        for j, rg in enumerate(s.row_groups):
            if out[j] is not None:
                continue
            stage = row_group_device_plans(
                s.path, pf, rg, file_cols, nfields, file_bytes,
                dict_strings=dict_strings, device=dev, metrics=metrics)
            if stage is None:
                # the whole split declines: every row group's entry
                # becomes the marker, so no staged arguments of it stay
                # cached where nothing can read them
                if cache is not None:
                    for k in keys:
                        cache.put(k, STAGE_DECLINED, 0)
                return None
            out[j] = stage
            planned.append(j)
        if cache is not None:
            # cached only once every row group of the split has its plan
            for j in planned:
                nbytes = sum(a.numel() * a.element_size()
                             for (args, _, _) in out[j][2] for a in args)
                cache.put(keys[j], out[j], nbytes)
        return out


#: the stage cache's entry for a row group the fused stage cannot take
STAGE_DECLINED = "declined"


def split_pcols(split: FileSplit) -> List[str]:
    return [k for k, _ in split.partition_values]


def _merge_pending(pending: List[FileSplit]) -> List[FileSplit]:
    """Merge same-file consecutive row-group splits; distinct files stay
    separate splits but the exec treats a pending group as one partition.
    """
    out: List[FileSplit] = []
    for s in pending:
        if (out and out[-1].path == s.path
                and out[-1].partition_values == s.partition_values):
            out[-1] = FileSplit(
                s.path, out[-1].row_groups + s.row_groups,
                s.partition_values)
        else:
            out.append(s)
    return out


def batch_device_bytes(batch) -> int:
    """Bytes a batch's tensors hold on the device (the cache's budget)."""
    n = 0
    for c in batch.columns:
        ts = [c.data, c.validity, c.offsets, c.chars]
        if c.is_dict:  # codes plus the dictionary (validity counted)
            d = c.dictv
            ts += [d.codes, d.dictionary.offsets, d.dictionary.chars]
        for t in ts:
            if t is not None:
                n += t.numel() * t.element_size()
    return n
