"""The port's nested-loop and cartesian joins (``exec/join.py``
``TpuBroadcastNestedLoopJoinExec``, ``TpuCartesianProductExec``; the
planner's no-key route in ``plugin/overrides.py``) against the
reference's and the port's CPU engine.

The same rows go through both packages' sessions and through the port's
CPU engine (``spark.rapids.tpu.sql.enabled=false``): cartesian products
and conditioned joins (the reference's ``tests/test_operators.py:58-90``
and ``tests/test_sort_join_window.py:122``), with nulls, strings, empty
sides and more than one probe partition. The rows must be equal; the
plan must hold the exec the reference plans, with the build side read
through a broadcast exchange; ``explain()`` (tagging lines and plan
analysis, AUTO strategy reasons cut) must be the reference's, and a non-inner join with a residual condition or
without keys falls back with the reference's reasons.
"""
import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                         TpuBroadcastNestedLoopJoinExec,
                                         TpuCartesianProductExec)
from spark_rapids_tpu_torch.exec.join import _SpillableBuild
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession
from test_torch_plananalysis import comparable_explain

REF = (JT, JE, JSession)
PORT = (T, PE, PSession)
CPU_ONLY = {"spark.rapids.tpu.sql.enabled": False}


def _left(m, sess, n=12, parts=2):
    T_ = m[0]
    rows = [(i % 5 if i % 4 else None, f"s{i % 3}" if i % 5 else None,
             i * 1.5 - 4.0) for i in range(n)]
    return sess.from_rows(rows, T_.StructType((
        T_.StructField("k", T_.INT), T_.StructField("s", T_.STRING),
        T_.StructField("d", T_.DOUBLE))), num_partitions=parts)


def _right(m, sess, n=7):
    T_ = m[0]
    rows = [(i if i % 3 else None, ["x", "", "yz", None][i % 4])
            for i in range(n)]
    return sess.from_rows(rows, T_.StructType((
        T_.StructField("k2", T_.INT), T_.StructField("t", T_.STRING))))


def _cartesian(m, sess):
    return _left(m, sess).cross_join(_right(m, sess))


def _conditioned(m, sess):
    E = m[1]
    return _left(m, sess, parts=3).cross_join(
        _right(m, sess), E.LessThan(E.col("k2"), E.col("k")))


def _string_condition(m, sess):
    E = m[1]
    return _left(m, sess).join(
        _right(m, sess), on=[], how="inner",
        condition=E.Or(E.EqualTo(E.col("t"), E.Literal.of("x")),
                       E.IsNull(E.col("s"))))


def _empty_build(m, sess):
    E = m[1]
    return _left(m, sess).cross_join(
        _right(m, sess).where(E.GreaterThan(E.col("k2"), E.Literal.of(99))))


def _empty_probe(m, sess):
    E = m[1]
    return _left(m, sess).where(E.IsNull(E.col("d"))).cross_join(
        _right(m, sess))


def _single_partition(m, sess):
    E = m[1]
    return _left(m, sess, n=30, parts=1).cross_join(
        _right(m, sess), E.GreaterThanOrEqual(E.col("d"),
                                              E.Cast(E.col("k2"),
                                                     m[0].DOUBLE)))


QUERIES = {"cartesian": (_cartesian, "TpuCartesianProductExec"),
           "conditioned": (_conditioned, "TpuBroadcastNestedLoopJoinExec"),
           "string_condition": (_string_condition,
                                "TpuBroadcastNestedLoopJoinExec"),
           "empty_build": (_empty_build, "TpuCartesianProductExec"),
           "empty_probe": (_empty_probe, "TpuCartesianProductExec"),
           "single_partition": (_single_partition,
                                "TpuBroadcastNestedLoopJoinExec")}


def _key(row):
    return tuple((v is None, repr(v)) for v in row)


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_nested_loop_rows_match_reference_and_cpu_engine(case):
    q, exec_name = QUERIES[case]
    ref_df = q(REF, JSession({}))
    ref = sorted(ref_df.collect(), key=_key)
    sess = PSession({}, device="cpu")
    df = q(PORT, sess)
    got = sorted(df.collect(), key=_key)
    cpu = sorted(q(PORT, PSession(CPU_ONLY, device="cpu")).collect(),
                 key=_key)
    assert got == ref == cpu
    tree = sess.last_executed_plan.tree_string()
    assert exec_name in tree and "TpuBroadcastExchangeExec" in tree, tree
    assert comparable_explain(df.explain()) == comparable_explain(
        ref_df.explain())


def _fallback_left_condition(m, sess):
    E = m[1]
    return _left(m, sess).join(_right(m, sess), on=[("k", "k2")],
                               how="left",
                               condition=E.GreaterThan(E.col("d"),
                                                       E.Literal.of(1.0)))


def _fallback_no_keys_left(m, sess):
    return _left(m, sess).join(_right(m, sess), on=[], how="left")


@pytest.mark.parametrize("q", [_fallback_left_condition,
                               _fallback_no_keys_left],
                         ids=["residual_condition", "no_keys"])
def test_non_inner_nested_loop_falls_back_as_the_reference(q):
    """A residual condition on a non-inner join, and a non-inner join
    without keys, stay on the CPU with the reference's reasons."""
    ref_df = q(REF, JSession({}))
    sess = PSession({}, device="cpu")
    df = q(PORT, sess)
    assert sorted(df.collect(), key=_key) == sorted(ref_df.collect(),
                                                    key=_key)
    assert "CpuJoinExec" in sess.last_executed_plan.tree_string()
    assert comparable_explain(df.explain()) == comparable_explain(
        ref_df.explain())


def _scan(conf, data, schema, parts=1):
    batches = [[ColumnarBatch.from_pydict(
        {k: v[i::parts] for k, v in data.items()}, schema, device="cpu")]
        for i in range(parts)]
    return InMemoryScanExec(conf, batches, schema)


def test_the_build_is_held_spillable_and_read_once():
    """The build side is concatenated once for every probe partition,
    held as a spillable buffer, and not pinned once the probes are
    done."""
    conf = RapidsConf({})
    ls = T.StructType((T.StructField("a", T.LONG),))
    rs = T.StructType((T.StructField("b", T.STRING),))
    left = _scan(conf, {"a": list(range(9))}, ls, parts=3)
    right = _scan(conf, {"b": ["p", None, "qq"]}, rs)
    ex = TpuCartesianProductExec(conf, left, right)
    rows = []
    for p in range(ex.num_partitions):
        for b in ex.execute_partition(p):
            rows += b.to_rows()
    assert sorted(rows, key=_key) == sorted(
        [(a, b) for a in range(9) for b in ("p", None, "qq")], key=_key)
    sb = ex._built[0]
    assert isinstance(sb, _SpillableBuild) and sb._pins == 0
    assert ex._built[1] == 3


def test_an_expanded_string_pool_past_int32_offsets_raises():
    """One probe row of 64 KiB against 2^15 build rows would repeat into
    a 2 GiB pool, past int32 offsets: the join refuses it rather than
    wrap."""
    conf = RapidsConf({})
    ls = T.StructType((T.StructField("s", T.STRING),))
    rs = T.StructType((T.StructField("b", T.INT),))
    left = _scan(conf, {"s": ["x" * (1 << 16)]}, ls)
    right = _scan(conf, {"b": list(range(1 << 15))}, rs)
    ex = TpuBroadcastNestedLoopJoinExec(
        conf, left, right, PE.GreaterThan(PE.col("b"), PE.Literal.of(3)))
    with pytest.raises(ValueError, match="int32 offsets"):
        list(ex.execute_partition(0))
