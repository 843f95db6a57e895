"""pandas and Arrow mapPartitions operators.

Own copy of ``spark_rapids_tpu/ml/pandas_udf.py``. Reference analog: the
Python execs (GpuMapInPandasExec, GpuArrowEvalPythonExec:
GpuArrowEvalPythonExec.scala:58-465): device batches stream to the
Python function as Arrow data and its results come back as Arrow. No
worker process sits between them (the engine is Python); the data plane
is kept: device batch -> one Arrow conversion -> the user function ->
the rows of a new DataFrame, whose operators run on the device again.
"""
from __future__ import annotations

from typing import Callable, Iterator

from .. import types as T


def _arrow_batches(df) -> Iterator[object]:
    """One Arrow table a batch of the DataFrame's output (a CPU plan's
    rows as one table)."""
    from ..exec.transitions import ColumnarToRowExec
    from ..io.arrow_convert import batch_to_arrow

    final = df.session._execute(df.node)
    if isinstance(final, ColumnarToRowExec):
        for b in final.tpu_child.execute_columnar():
            yield batch_to_arrow(b)
    else:
        from ..columnar.batch import batch_from_rows

        schema = final.output_schema
        rows = [
            r for p in range(final.num_partitions)
            for r in final.execute_rows_partition(p)
        ]
        yield batch_to_arrow(batch_from_rows(rows, schema,
                                             df.session.device))


def map_in_arrow(df, fn: Callable, schema: T.StructType):
    """``fn(pyarrow.Table) -> pyarrow.Table`` over each batch; the results
    come back as a DataFrame of ``schema`` (GpuMapInPandasExec's Arrow
    leg)."""
    out_data = {f.name: [] for f in schema.fields}
    for t in _arrow_batches(df):
        r = fn(t)
        for f in schema.fields:
            out_data[f.name].extend(r.column(f.name).to_pylist())
    return df.session.create_dataframe(out_data, schema)


def map_in_pandas(df, fn: Callable, schema: T.StructType):
    """``fn(pandas.DataFrame) -> pandas.DataFrame`` over each batch (the
    ``df.mapInPandas`` analog, GpuMapInPandasExec)."""
    import pyarrow as pa

    def arrow_fn(t):
        return pa.Table.from_pandas(
            fn(t.to_pandas()), preserve_index=False)

    return map_in_arrow(df, arrow_fn, schema)
