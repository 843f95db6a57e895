"""Device-batch export for ML frameworks.

Own copy of ``spark_rapids_tpu/ml/columnar_rdd.py``. Reference analog:
ColumnarRdd(df): RDD[Table] (ColumnarRdd.scala:41-47), the zero-copy
hand-off that lets XGBoost build a DMatrix from the plugin's device
tables, behind spark.rapids.sql.exportColumnarRdd (RapidsConf.scala:406).
The port exports the plan's stream of device ``ColumnarBatch``es: their
columns are torch tensors on the card, which a consumer takes through
DLPack (``to_dlpack_batches``) or as numpy arrays (``to_numpy_batches``).
"""
from __future__ import annotations

from typing import Iterator, List

from ..columnar import ColumnarBatch
from ..conf import conf

EXPORT_COLUMNAR_RDD = conf(
    "spark.rapids.tpu.sql.exportColumnarRdd", False,
    "Enable exporting the device ColumnarBatch stream to ML consumers "
    "(reference: spark.rapids.sql.exportColumnarRdd).")


def _tpu_plan(df):
    """The device plan of a DataFrame, below the row boundary (None when
    the plan runs on the CPU engine)."""
    from ..exec.transitions import ColumnarToRowExec

    final = df.session._execute(df.node)
    if isinstance(final, ColumnarToRowExec):
        return final.tpu_child
    return None


def columnar_rdd(df) -> Iterator[ColumnarBatch]:
    """The device batches of a DataFrame, with no host round trip.

    Raises unless spark.rapids.tpu.sql.exportColumnarRdd is set (the
    reference's opt-in), and when the plan has CPU fallbacks (no device
    batches exist to export: InternalColumnarRddConverter's failure)."""
    if not df.session.conf.get(EXPORT_COLUMNAR_RDD):
        raise ValueError(
            "set spark.rapids.tpu.sql.exportColumnarRdd=true to export "
            "device batches")
    plan = _tpu_plan(df)
    if plan is None:
        raise ValueError(
            "plan has CPU fallbacks; no device batches to export "
            "(check df.explain())")
    return plan.execute_columnar()


def to_dlpack_batches(df) -> Iterator[List[object]]:
    """Per batch: the fixed-width columns' data tensors, sliced to the live
    rows. They stay on the batch's device and implement ``__dlpack__``;
    ``torch.from_dlpack`` of one shares its storage."""
    for batch in columnar_rdd(df):
        cols = []
        for c in batch.columns:
            if c.is_string:
                raise ValueError("string columns cannot export via DLPack")
            cols.append(c.data[: batch.num_rows])
        yield cols


def to_numpy_batches(df) -> Iterator[List[object]]:
    """Per batch: one float64 numpy array a column, NaN for nulls (the
    DMatrix-building convenience): one device-to-host copy a plane."""
    import numpy as np

    for batch in columnar_rdd(df):
        n = batch.num_rows
        out = []
        for c in batch.columns:
            if c.is_string:
                raise ValueError("string columns cannot export to DMatrix")
            d = c.data[:n].cpu().numpy().astype(np.float64)
            v = c.validity[:n].cpu().numpy()
            out.append(np.where(v, d, np.nan))
        yield out
