"""ORC scan and writer (reference: GpuOrcScan.scala:924, the cudf chunked
ORC writer).

Own copy of ``spark_rapids_tpu/io/orc.py``: ``pyarrow.orc`` reads one
stripe a split on the host, then the scan exec uploads it buffer by
buffer. Pushed filters (reference: OrcFilters.scala SearchArguments)
apply on the host right after the stripe's read and before the upload
(:func:`apply_filters_host`): pyarrow exposes no stripe statistics to
prune with, so the pushdown keeps filtered rows off the host-to-device
link instead. The filter exec above still applies the whole predicate.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from .. import types as T
from ..conf import RapidsConf
from .arrow_convert import arrow_schema_to_tpu
from .parquet import PushedFilter, discover_files, is_nan


def apply_filters_host(table, filters: Sequence[PushedFilter]):
    """Apply pushed column-vs-literal conjuncts to a host Arrow table.
    Advisory, as all pushdown: it may keep rows the predicate rejects
    (the filter exec drops them), never drop one it keeps. pyarrow
    compares by IEEE rules, where NaN fails every comparison; Spark
    orders NaN above every other value and equal to itself
    (``expr/eval.py``). So a NaN literal is left to the filter exec, and
    ``>``/``>=`` on a floating column keep the NaN rows. A comparison
    pyarrow cannot make is left to the filter exec."""
    import pyarrow.compute as pc
    import pyarrow.types as pat

    for f in filters:
        if f.column not in table.column_names:
            continue
        c = table[f.column]
        try:
            if f.op == "isnull":
                mask = pc.is_null(c)
            elif f.op == "notnull":
                mask = pc.is_valid(c)
            else:
                op = {"<": pc.less, "<=": pc.less_equal, ">": pc.greater,
                      ">=": pc.greater_equal, "=": pc.equal,
                      "!=": pc.not_equal}.get(f.op)
                if op is None or is_nan(f.value):
                    continue
                mask = op(c, f.value)
                if f.op in (">", ">=") and pat.is_floating(c.type):
                    mask = pc.or_(mask, pc.is_nan(c))
        except Exception:  # noqa: BLE001 — unpushable: the exec filters
            continue
        table = table.filter(mask.combine_chunks())
    return table


class OrcScanner:
    """One split per (file, stripe); a file set with no stripes is one
    empty split."""

    def __init__(self, path: str, conf: RapidsConf,
                 columns: Optional[Sequence[str]] = None,
                 filters: Optional[Sequence[PushedFilter]] = None):
        from pyarrow import orc

        self.conf = conf
        self.files = discover_files(path)
        self.filters = list(filters or ())
        if not self.files:
            raise FileNotFoundError(path)
        f0 = orc.ORCFile(self.files[0][0])
        self.file_schema = f0.schema
        self.columns = list(columns) if columns is not None else [
            self.file_schema.field(i).name
            for i in range(len(self.file_schema.names))
        ]
        self.schema = arrow_schema_to_tpu(
            self.file_schema.empty_table().select(self.columns).schema)
        self._splits = [
            (fp, s)
            for fp, _ in self.files
            for s in range(orc.ORCFile(fp).nstripes)
        ] or [(self.files[0][0], None)]

    def num_splits(self) -> int:
        return len(self._splits)

    def read_split(self, i: int):
        import pyarrow as pa
        from pyarrow import orc

        fp, stripe = self._splits[i]
        f = orc.ORCFile(fp)
        if stripe is None:
            return f.schema.empty_table().select(self.columns)
        # pyarrow returns a stripe's columns in file order: select puts
        # them in the schema's (the reference does not, ROADMAP.md §C)
        t = pa.table(f.read_stripe(stripe, columns=self.columns)).select(
            self.columns)
        if self.filters:
            t = apply_filters_host(t, self.filters)
        return t

    def read_split_i(self, i: int):
        """(pyarrow table, partition values): the scanners' protocol."""
        return self.read_split(i), ()


def write_orc(batches, path: str, schema: T.StructType,
              compression: str = "zstd") -> Dict[str, int]:
    """Chunked ORC write with the temp-file commit protocol: one stripe
    group a batch, an empty file with the schema for an empty result.
    Returns ``rows``, ``batches`` (at least 1) and ``files``."""
    from pyarrow import orc

    from .commit import write_batches

    rows, nbatches = write_batches(
        batches, path, schema,
        lambda tmp, s: orc.ORCWriter(tmp, compression=compression),
        lambda w, t: w.write(t))
    return {"rows": rows, "batches": max(nbatches, 1), "files": 1}
