"""Python and ML integration (SURVEY.md L9 / §2.10).

Own copy of ``spark_rapids_tpu/ml``. Reference analog:
ColumnarRdd.scala:41-47 with InternalColumnarRddConverter (the device
table export for XGBoost, with no host round trip, behind
spark.rapids.sql.exportColumnarRdd) and the pandas UDF execs
(GpuArrowEvalPythonExec, GpuMapInPandasExec: an Arrow hand-off to the
Python workers). Here the device table is the port's ``ColumnarBatch``
of torch tensors on the card: :func:`columnar_rdd` hands those over as
they are, and :func:`to_dlpack_batches` gives their columns, which any
DLPack consumer (``torch.from_dlpack``, XGBoost's DMatrix) takes without
a copy.
"""
from .columnar_rdd import columnar_rdd, to_dlpack_batches, to_numpy_batches
from .pandas_udf import map_in_arrow, map_in_pandas

__all__ = [
    "columnar_rdd",
    "to_dlpack_batches",
    "to_numpy_batches",
    "map_in_arrow",
    "map_in_pandas",
]
