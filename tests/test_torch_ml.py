"""The port's ML hand-off (``ml/``) against the reference's
``tests/test_ml.py``, case by case, with torch tensors where the
reference has jax arrays: the opt-in, the device batches of
``columnar_rdd``, the DLPack and numpy exports, the refusal of a plan
with CPU fallbacks, ``map_in_pandas`` and ``map_in_arrow`` (each result
equal to the reference's on the same rows), and the DMatrix-shaped
matrix. The port runs on ``device="cpu"``.
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu import ml as JML
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.sql import TpuSession as JSession
from spark_rapids_tpu_torch import ml as PML
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.sql import TpuSession as PSession

PORT = {"T": PT, "E": PE, "A": PA, "ml": PML,
        "session": lambda s=None: PSession(s or {}, device="cpu")}
REF = {"T": JT, "E": JE, "A": JA, "ml": JML,
       "session": lambda s=None: JSession(s or {})}
ON = {"spark.rapids.tpu.sql.exportColumnarRdd": True}


def _df(m, sess, n=500, parts=2):
    T = m["T"]
    schema = T.StructType([T.StructField("x", T.DOUBLE),
                           T.StructField("y", T.LONG)])
    return sess.create_dataframe(
        {"x": [i / 3.0 if i % 7 else None for i in range(n)],
         "y": [i for i in range(n)]},
        schema, num_partitions=parts)


def test_columnar_rdd_requires_opt_in():
    for m in (PORT, REF):
        with pytest.raises(ValueError, match="exportColumnarRdd"):
            next(iter(m["ml"].columnar_rdd(_df(m, m["session"]()))))


def test_columnar_rdd_exports_device_batches():
    sess = PORT["session"](ON)
    E = PE
    total = 0
    xs = []
    for batch in PML.columnar_rdd(
            _df(PORT, sess).where(E.GreaterThan(E.col("y"), E.lit(9)))):
        assert isinstance(batch.columns[0].data, torch.Tensor)
        assert batch.columns[0].data.device == sess.device
        total += batch.num_rows
        xs.extend(batch.columns[1].data[:batch.num_rows].tolist())
    assert total == 490
    ref = [b.num_rows for b in JML.columnar_rdd(
        _df(REF, JSession(ON)).where(JE.GreaterThan(JE.col("y"),
                                                    JE.lit(9))))]
    assert sum(ref) == total
    assert sorted(xs) == list(range(10, 500))


def test_dlpack_and_numpy_export():
    sess = PORT["session"](ON)
    df = _df(PORT, sess, 100, 1)
    [cols] = list(PML.to_dlpack_batches(df))
    assert hasattr(cols[0], "__dlpack__")
    for c in cols:
        assert torch.from_dlpack(c).data_ptr() == c.data_ptr()
    [mats] = list(PML.to_numpy_batches(df))
    x = mats[0]
    assert np.isnan(x[0])  # null -> NaN (DMatrix convention)
    assert x[1] == pytest.approx(1 / 3.0)
    [want] = list(JML.to_numpy_batches(_df(REF, JSession(ON), 100, 1)))
    for got, exp in zip(mats, want):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, exp)
    [jcols] = list(JML.to_dlpack_batches(_df(REF, JSession(ON), 100, 1)))
    for c, jc in zip(cols, jcols):
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_dlpack_refuses_string_columns():
    for m in (PORT, REF):
        T = m["T"]
        df = m["session"](ON).create_dataframe(
            {"s": ["a", "b"]}, T.StructType([T.StructField("s", T.STRING)]))
        with pytest.raises(ValueError, match="string columns"):
            next(iter(m["ml"].to_dlpack_batches(df)))
        with pytest.raises(ValueError, match="string columns"):
            next(iter(m["ml"].to_numpy_batches(df)))


def test_columnar_rdd_rejects_fallback_plans():
    for m in (PORT, REF):
        T, A, E = m["T"], m["A"], m["E"]
        sess = m["session"](ON)
        schema = T.StructType([T.StructField("s", T.STRING)])
        df = sess.create_dataframe({"s": ["a", "b"]}, schema)
        bad = df.agg(A.agg(A.First(E.col("s")), "m"))
        with pytest.raises(ValueError, match="CPU fallback"):
            next(iter(m["ml"].columnar_rdd(bad)))


def test_map_in_pandas():
    pytest.importorskip("pandas")

    def f(pdf):
        import pandas as pd

        return pd.DataFrame({"z": pdf["x"].fillna(0.0) * 2 + pdf["y"]})

    out = []
    for m in (PORT, REF):
        T = m["T"]
        schema = T.StructType([T.StructField("z", T.DOUBLE)])
        rows = m["ml"].map_in_pandas(_df(m, m["session"](), 50, 2), f,
                                     schema).collect()
        out.append(rows)
    assert len(out[0]) == 50
    assert out[0][1][0] == pytest.approx(2 / 3.0 + 1)
    assert sorted(out[0]) == sorted(out[1])


def test_map_in_arrow_then_device_ops():
    def f(t):
        import pyarrow as pa
        import pyarrow.compute as pc

        return pa.table({"y2": pc.multiply(t.column("y"), 3)})

    out = []
    for m in (PORT, REF):
        T, E = m["T"], m["E"]
        schema = T.StructType([T.StructField("y2", T.LONG)])
        res = m["ml"].map_in_arrow(_df(m, m["session"](), 40, 1), f, schema)
        # the result is a first-class DataFrame: device ops continue on it
        out.append(res.where(
            E.GreaterThanOrEqual(E.col("y2"), E.lit(60))).collect())
    assert len(out[0]) == 20
    assert sorted(out[0]) == sorted(out[1])


def test_map_in_arrow_then_group_by():
    """A pyarrow.compute function per batch, then an aggregate over its
    rows (the chip smoke's W-ml shape)."""
    def f(t):
        import pyarrow as pa
        import pyarrow.compute as pc

        return pa.table({"g": pc.bit_wise_and(t.column("y"), 3),
                         "x2": pc.multiply(t.column("x"), 2.0)})

    out = []
    for m in (PORT, REF):
        T, A, E = m["T"], m["A"], m["E"]
        schema = T.StructType([T.StructField("g", T.LONG),
                               T.StructField("x2", T.DOUBLE)])
        res = m["ml"].map_in_arrow(_df(m, m["session"](), 200, 2), f,
                                   schema)
        out.append(res.group_by("g").agg(
            A.agg(A.Count(E.col("x2")), "c"),
            A.agg(A.Max(E.col("x2")), "mx")).collect())
    assert sorted(out[0]) == sorted(out[1])
    assert len(out[0]) == 4


def test_xgboost_style_dmatrix_build():
    """BASELINE config #5's shape: device batches -> a DMatrix-ready
    matrix, equal to the reference's."""
    got = []
    for m in (PORT, REF):
        E = m["E"]
        df = _df(m, m["session"](ON), 200, 2).where(E.IsNotNull(E.col("x")))
        mats = [np.column_stack(b) for b in m["ml"].to_numpy_batches(df)]
        got.append(np.vstack(mats))
    X = got[0]
    assert X.shape[1] == 2 and not np.isnan(X).any()
    np.testing.assert_array_equal(X[np.argsort(X[:, 1])],
                                  got[1][np.argsort(got[1][:, 1])])
