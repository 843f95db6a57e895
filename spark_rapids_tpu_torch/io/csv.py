"""CSV scan and writer (reference: GpuBatchScanExec.scala:511 CSVScan and
cudf readCSV; the CSV leg of ColumnarOutputWriter).

Own copy of ``spark_rapids_tpu/io/csv.py``: ``pyarrow.csv`` parses each
file on the host (the reference keeps the parse on the host too), then
the table crosses to the device through the scan exec's buffer-level
upload (``io/arrow_convert.arrow_to_batch``). One split per file; the
schema is given or inferred from the first file. A decimal column of a
given schema is parsed as ``decimal128(p, s)``: the reference leaves
decimals to pyarrow's inference, which reads them as doubles whose bits
then pass for the unscaled value (ROADMAP.md §C).
"""
from __future__ import annotations

from typing import Dict, Optional

from .. import types as T
from ..conf import RapidsConf
from .arrow_convert import arrow_schema_to_tpu
from .parquet import discover_files


def _arrow_type(dt: T.DataType):
    import pyarrow as pa

    if isinstance(dt, T.DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    m = {
        T.BOOLEAN: pa.bool_(), T.BYTE: pa.int8(), T.SHORT: pa.int16(),
        T.INT: pa.int32(), T.LONG: pa.int64(), T.FLOAT: pa.float32(),
        T.DOUBLE: pa.float64(), T.STRING: pa.string(),
        T.BINARY: pa.binary(), T.DATE: pa.date32(),
        T.TIMESTAMP: pa.timestamp("us", tz="UTC"),
    }
    return m[dt]


class CsvScanner:
    """One split per file; schema given or inferred from the first file."""

    def __init__(self, path: str, conf: RapidsConf,
                 schema: Optional[T.StructType] = None,
                 header: bool = True, sep: str = ","):
        self.conf = conf
        self.header = header
        self.sep = sep
        self.files = discover_files(path)
        if not self.files:
            raise FileNotFoundError(path)
        self.user_schema = schema
        if schema is None:
            t = self._read(self.files[0][0])
            self.schema = arrow_schema_to_tpu(t.schema)
        else:
            self.schema = schema

    def _read(self, fpath: str):
        import pyarrow.csv as pacsv

        ropts = pacsv.ReadOptions(autogenerate_column_names=not self.header)
        popts = pacsv.ParseOptions(delimiter=self.sep)
        copts = None
        if self.user_schema is not None:
            names = [f.name for f in self.user_schema.fields]
            if not self.header:
                ropts = pacsv.ReadOptions(column_names=names)
            copts = pacsv.ConvertOptions(column_types={
                f.name: _arrow_type(f.dataType)
                for f in self.user_schema.fields})
        return pacsv.read_csv(
            fpath, read_options=ropts, parse_options=popts,
            convert_options=copts)

    def num_splits(self) -> int:
        return len(self.files)

    def read_split(self, i: int):
        return self._read(self.files[i][0])

    def read_split_i(self, i: int):
        """(pyarrow table, partition values): the scanners' protocol."""
        return self._read(self.files[i][0]), ()


def write_csv(batches, path: str, schema: T.StructType) -> Dict[str, int]:
    """Chunked CSV write with the temp-file commit protocol: the header
    once, then each batch appended; a header-only file for an empty
    result. Returns ``rows``, ``batches`` (at least 1) and ``files``."""
    import pyarrow.csv as pacsv

    from .commit import write_batches

    rows, nbatches = write_batches(
        batches, path, schema, pacsv.CSVWriter,
        lambda w, t: w.write_table(t))
    return {"rows": rows, "batches": max(nbatches, 1), "files": 1}
