"""The whole slice: the bench query's exec tree (bench.py ``shape_agg``:
in-memory scan -> filter a >= 0 -> project a2 = a*2 -> hash aggregate by k:
sum(a2), avg(b), count(b)) in the port and in the reference, on identical
batches.

The reference batches are built first; the port's come from their numpy
planes through ``batch_from_host_arrays`` (data, validity, row count and
capacity, padding included). ``collect()`` rows are compared after sorting
by key: sums and counts exactly, averages within rtol 1e-12 under SCATTER
and rtol 1e-4 / atol 1e-6 under PALLAS (the reference's f32 hi/lo kernel
sums).
"""
import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import exec as JX
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.batch import schema_of as jschema_of
from spark_rapids_tpu.columnar.column import DeviceColumn as JColumn
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu_torch import exec as X
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import batch_from_host_arrays, schema_of
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E

#: two batches of 4096 rows in all, the second one ragged (padding rows)
SIZES = ((2048, 2048), (2048, 4096))
NGROUPS = 64


def _reference_batches():
    rng = np.random.default_rng(42)
    n = sum(s for s, _ in SIZES)
    k = rng.integers(0, NGROUPS, n).astype(np.int32)
    a = rng.integers(-(10**6), 10**6, n).astype(np.int64)
    b = rng.normal(size=n) + 3.0
    b_null = rng.random(n) < 0.05
    schema = jschema_of(k=JT.INT, a=JT.LONG, b=JT.DOUBLE)
    batches, lo = [], 0
    for rows, cap in SIZES:
        cols = []
        for f, arr, valid in ((schema.fields[0], k, None),
                              (schema.fields[1], a, None),
                              (schema.fields[2], b, ~b_null)):
            data = np.zeros(cap, arr.dtype)
            v = np.zeros(cap, bool)
            data[:rows] = arr[lo:lo + rows]
            v[:rows] = True if valid is None else valid[lo:lo + rows]
            data[:rows][~v[:rows]] = 0
            cols.append(JColumn(f.dataType, rows, jnp.asarray(data),
                                jnp.asarray(v)))
        batches.append(JBatch(cols, schema, rows))
        lo += rows
    return batches, schema


def _port_batches(jbatches):
    schema = schema_of(k=T.INT, a=T.LONG, b=T.DOUBLE)
    return [batch_from_host_arrays(
        schema, [np.asarray(c.data) for c in jb.columns],
        [np.asarray(c.validity) for c in jb.columns], jb.num_rows,
        jb.capacity, device="cpu") for jb in jbatches], schema


def _plan(M, E_, A_, conf, batches, schema, mode_partial=False):
    scan = M.InMemoryScanExec(conf, [batches], schema)
    filt = M.TpuFilterExec(conf, E_.GreaterThanOrEqual(E_.col("a"),
                                                      E_.lit(0)), scan)
    proj = M.TpuProjectExec(conf, [E_.col("k"), E_.Alias(
        E_.Multiply(E_.col("a"), E_.lit(2)), "a2"), E_.col("b")], filt)
    aggs = [A_.agg(A_.Sum(E_.col("a2")), "s"),
            A_.agg(A_.Average(E_.col("b")), "m"),
            A_.agg(A_.Count(E_.col("b")), "c")]
    if not mode_partial:
        return M.TpuHashAggregateExec(conf, [E_.col("k")], aggs, proj)
    partial = M.TpuHashAggregateExec(conf, [E_.col("k")], aggs, proj,
                                     mode=A_.PARTIAL)
    parts = list(partial.execute_partition(0))
    rescan = M.InMemoryScanExec(conf, [parts], partial.output_schema)
    return M.TpuHashAggregateExec(conf, [E_.col("k")], aggs, rescan,
                                  mode=A_.FINAL)


def _assert_rows_agree(ref_rows, got_rows, tight):
    ref_rows, got_rows = sorted(ref_rows), sorted(got_rows)
    assert [r[0] for r in got_rows] == [r[0] for r in ref_rows]
    assert len(ref_rows) == NGROUPS
    tol = dict(rtol=1e-12, atol=0) if tight else dict(rtol=1e-4, atol=1e-6)
    for (k, s, m, c), (rk, rs, rm, rc) in zip(got_rows, ref_rows):
        assert (s, c) == (rs, rc), k
        np.testing.assert_allclose(m, rm, **tol, err_msg=str(k))


CASES = {
    "auto_variable_float": ({"spark.rapids.tpu.sql.variableFloatAgg.enabled":
                             True}, "SCATTER", True),
    "forced_pallas": ({"spark.rapids.tpu.sql.agg.strategy": "PALLAS"},
                      "PALLAS", False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_exec_tree_matches_reference(case):
    settings, strategy, tight = CASES[case]
    jbatches, jschema = _reference_batches()
    ref_plan = _plan(JX, JE, JA, JConf(settings), jbatches, jschema)
    ref_rows = ref_plan.collect()
    pbatches, pschema = _port_batches(jbatches)
    plan = _plan(X, E, A, RapidsConf(settings), pbatches, pschema)
    got_rows = X.ColumnarToRowExec(plan.conf, plan).collect()
    # AUTO on the CPU resolves SCATTER, as in the reference; on a CUDA
    # device it would resolve the kernel tier (see choose_agg_strategy)
    assert f"strategy={strategy}" in plan.describe()
    _assert_rows_agree(ref_rows, got_rows, tight)


def test_partial_then_final_matches_reference():
    settings = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    jbatches, jschema = _reference_batches()
    ref_rows = _plan(JX, JE, JA, JConf(settings), jbatches, jschema,
                     mode_partial=True).collect()
    pbatches, pschema = _port_batches(jbatches)
    got_rows = _plan(X, E, A, RapidsConf(settings), pbatches, pschema,
                     mode_partial=True).collect()
    _assert_rows_agree(ref_rows, got_rows, tight=True)


def test_chooser_picks_kernel_tier_on_cuda_without_exact_float_sums():
    """The CUDA branch of choose_agg_strategy, decided from the static
    plan shape (no card needed to evaluate it)."""
    import torch

    pb, ps = _port_batches(_reference_batches()[0])
    plan = _plan(X, E, A, RapidsConf(
        {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}), pb, ps)
    cuda = torch.device("cuda")
    ops, exprs = plan._update_ops, plan._update_exprs
    assert X.choose_agg_strategy(plan.conf, 4096, ops, exprs, (T.INT,),
                                 cuda)[0] == "PALLAS"
    exact = _plan(X, E, A, RapidsConf({}), pb, ps)
    assert X.choose_agg_strategy(exact.conf, 4096, exact._update_ops,
                                 exact._update_exprs, (T.INT,),
                                 cuda)[0] == "SCATTER"
    # the CPU at 2^21 rows picks RADIX with the reference's reason; with
    # an exact float sum it stays on SCATTER
    jbatches, jschema = _reference_batches()
    ref = _plan(JX, JE, JA, JConf(
        {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}), jbatches,
        jschema)
    got = X.choose_agg_strategy(plan.conf, 1 << 21, ops, exprs, (T.INT,),
                                torch.device("cpu"))
    assert got == JX.aggregate.choose_agg_strategy(
        ref.conf, 1 << 21, ref._update_ops, ref._update_exprs, (JT.INT,),
        backend="cpu")
    assert got[0] == "RADIX"
    assert X.choose_agg_strategy(exact.conf, 1 << 21, exact._update_ops,
                                 exact._update_exprs, (T.INT,),
                                 torch.device("cpu"))[0] == "SCATTER"
    for tier in ("MATMUL", "SORT", "RADIX"):
        assert X.choose_agg_strategy(RapidsConf(
            {"spark.rapids.tpu.sql.agg.strategy": tier}), 4096, ops, exprs,
            (T.INT,), cuda) == (tier, "forced by "
                                "spark.rapids.tpu.sql.agg.strategy")


def test_grand_aggregate_over_empty_input_matches_reference():
    """No batches at all: a grand aggregate still yields its one row
    (count 0, null sum/avg/min), reduced on the scan's device."""
    jschema = jschema_of(a=JT.LONG, b=JT.DOUBLE)
    schema = schema_of(a=T.LONG, b=T.DOUBLE)

    def aggs(A_, E_):
        return [A_.agg(A_.Count(None), "n"), A_.agg(A_.Sum(E_.col("a")), "s"),
                A_.agg(A_.Average(E_.col("b")), "m"),
                A_.agg(A_.Min(E_.col("b")), "mn")]

    ref = JX.TpuHashAggregateExec(JConf({}), [], aggs(JA, JE),
                                  JX.InMemoryScanExec(JConf({}), [[]],
                                                      jschema))
    plan = X.TpuHashAggregateExec(RapidsConf({}), [], aggs(A, E),
                                  X.InMemoryScanExec(RapidsConf({}), [[]],
                                                     schema, device="cpu"))
    out = list(plan.execute_partition(0))
    assert [c.data.device.type for c in out[0].columns] == ["cpu"] * 4
    assert X.ColumnarToRowExec(plan.conf, plan).collect() == ref.collect()
    assert ref.collect() == [(0, None, None, None)]
