"""The rest of the port's ``exec/basic.py`` against the reference's, on
the CPU: ``TpuRangeExec``, ``TpuUnionExec``, ``TpuLocalLimitExec``,
``TpuCollectLimitExec``, ``TpuExpandExec`` (and explode / posexplode
through the session) and ``TpuCoalesceBatchesExec``.

Each plan is built twice, from the reference's classes and from the
port's, over the same batches; rows must be equal IN ORDER (floats by
``repr``), and so must the batch boundaries and capacities where the
operator sets them. A limit keeps its last batch's capacity and cuts its
row count: the tail planes are zero and invalid.
"""
import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.exec import basic as JB
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.transitions import ColumnarToRowExec
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession
from test_torch_plananalysis import comparable_explain

REF = dict(T=JT, E=JE, B=JB, Batch=JBatch, dev={})
PORT = dict(T=T, E=E, B=B, Batch=ColumnarBatch, dev={"device": "cpu"})

#: rows per batch of the multi-batch scans (an empty batch included)
SIZES = (50, 0, 200, 7)


def _data(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "k": [None if rng.random() < 0.1 else int(rng.integers(0, 9))
              for _ in range(n)],
        "x": [None if rng.random() < 0.1 else int(rng.integers(-99, 99))
              for _ in range(n)],
        "d": [float(rng.normal()) for _ in range(n)],
    }


def _schema(m):
    T_ = m["T"]
    return T_.StructType((T_.StructField("k", T_.INT),
                          T_.StructField("x", T_.LONG),
                          T_.StructField("d", T_.DOUBLE)))


def _scan(m, conf, seeds=(1, 2, 3, 4), parts=1):
    sch = _schema(m)
    batches = [m["Batch"].from_pydict(_data(s, n), sch, **m["dev"])
               for s, n in zip(seeds, SIZES)]
    per = -(-len(batches) // parts)
    return m["B"].InMemoryScanExec(
        conf, [batches[i * per:(i + 1) * per] for i in range(parts)], sch)


def _range(m, conf):
    return m["B"].TpuRangeExec(conf, -7, 1000, 3, 3, "id", **m["dev"])


def _range_desc(m, conf):
    return m["B"].TpuRangeExec(conf, 50, -60, -7, 2, "r", **m["dev"])


def _union(m, conf):
    return m["B"].TpuUnionExec(conf, [_scan(m, conf, parts=2),
                                      _scan(m, conf, (5, 6, 7, 8))])


def _local_limit(m, conf):
    return m["B"].TpuLocalLimitExec(conf, 60, _scan(m, conf, parts=2))


def _local_limit_exact(m, conf):
    return m["B"].TpuLocalLimitExec(conf, 50, _scan(m, conf))


def _collect_limit(m, conf):
    return m["B"].TpuCollectLimitExec(conf, 140, _scan(m, conf, parts=3))


def _collect_limit_zero(m, conf):
    return m["B"].TpuCollectLimitExec(conf, 0, _scan(m, conf))


def _expand(m, conf):
    E_ = m["E"]
    projections = [
        [E_.col("k"), E_.Literal.of(None), E_.Literal.of(0)],
        [E_.Literal.of(None), E_.col("x"), E_.Literal.of(1)],
        [E_.col("k"), E_.Add(E_.col("x"), E_.Literal.of(1)),
         E_.Literal.of(2)],
    ]
    return m["B"].TpuExpandExec(conf, projections, ["k", "x", "gid"],
                                _scan(m, conf))


def _coalesce(m, conf):
    return m["B"].TpuCoalesceBatchesExec(conf, _scan(m, conf), 60)


PLANS = {
    "range": _range, "range_negative_step": _range_desc, "union": _union,
    "local_limit": _local_limit, "local_limit_exact": _local_limit_exact,
    "collect_limit": _collect_limit, "collect_limit_zero":
        _collect_limit_zero, "expand": _expand, "coalesce": _coalesce,
}
#: a small batch size for the range, so it splits into several batches
CONF = {"spark.rapids.tpu.sql.reader.batchSizeRows": 100}


def _norm(rows):
    return [tuple(repr(v) if isinstance(v, float) else v for v in r)
            for r in rows]


def _batches(plan):
    out = []
    for p in range(plan.num_partitions):
        for b in plan.execute_partition(p):
            out.append((p, b.num_rows, b.capacity, _norm(b.to_rows())))
    return out


@pytest.mark.parametrize("case", sorted(PLANS))
def test_exec_matches_reference(case):
    ref_plan = PLANS[case](REF, JConf(CONF))
    plan = PLANS[case](PORT, RapidsConf(CONF))
    assert plan.num_partitions == ref_plan.num_partitions
    assert plan.output_schema.names == ref_plan.output_schema.names
    got, ref = _batches(plan), _batches(ref_plan)
    # the reference's limit slices its last batch to a smaller capacity;
    # the port keeps the capacity and cuts the row count
    assert [g[:2] + g[3:] for g in got] == [r[:2] + r[3:] for r in ref]
    if "limit" not in case:
        assert [g[2] for g in got] == [r[2] for r in ref]


def test_limit_keeps_capacity_and_clears_the_tail():
    conf = RapidsConf({})
    sch = T.StructType((T.StructField("x", T.LONG),
                        T.StructField("s", T.STRING)))
    b = ColumnarBatch.from_pydict(
        {"x": list(range(10)), "s": [f"r{i}" for i in range(10)]}, sch,
        device="cpu")
    scan = B.InMemoryScanExec(conf, [[b]], sch)
    (out,) = list(B.TpuLocalLimitExec(conf, 4, scan).execute_partition(0))
    assert out.num_rows == 4 and out.capacity == b.capacity
    x, s = out.columns
    assert x.data[4:].eq(0).all() and not x.validity[4:].any()
    assert not s.validity[4:].any()
    assert s.offsets[5:].eq(s.offsets[4]).all()
    assert s.chars[int(s.offsets[4]):].eq(0).all()
    assert out.to_rows() == [(i, f"r{i}") for i in range(4)]
    assert ColumnarToRowExec(conf, B.TpuLocalLimitExec(
        conf, 4, scan)).collect() == out.to_rows()


def test_limit_stops_pulling_batches():
    """Once the limit is reached, no further child batch is computed."""
    pulled = []
    conf = RapidsConf({})
    scan = _scan(PORT, conf)
    inner = scan.execute_partition

    def spy(i):
        for b in inner(i):
            pulled.append(b.num_rows)
            yield b

    scan.execute_partition = spy
    list(B.TpuLocalLimitExec(conf, 50, scan).execute_partition(0))
    assert pulled == [50]


def _explode_query(m, sess, pos):
    E_ = m["E"]
    df = sess.create_dataframe(_data(9, 40), _schema(m))
    return df.explode([E_.col("x"), E_.Literal.of(7),
                       E_.Multiply(E_.col("k"), E_.Literal.of(2))],
                      name="v", pos=pos)


@pytest.mark.parametrize("pos", [False, True], ids=["explode", "posexplode"])
def test_explode_through_the_session_matches_reference(pos):
    """``CpuGenerateExec`` converts to ``TpuExpandExec``: the same rows in
    the same order and the same ``explain()`` lines as the reference."""
    jdf = _explode_query(REF, JSession({}), pos)
    ref = _norm(jdf.collect())
    sess = PSession({}, device="cpu")
    df = _explode_query(PORT, sess, pos)
    assert _norm(df.collect()) == ref
    assert comparable_explain(df.explain()) == comparable_explain(
        jdf.explain())
    assert "TpuExpandExec" in sess.last_executed_plan.tree_string()


def test_limit_over_explode_keeps_the_references_row_set():
    """The device expand emits one batch per projection, the CPU engine
    interleaves each row's projections: a limit that cuts inside a
    partition keeps the reference's rows, in its order, and a different
    row set than the CPU engine's (ROADMAP.md section C)."""
    jdf = _explode_query(REF, JSession({}), False).limit(10)
    ref = _norm(jdf.collect())
    got = _norm(_explode_query(PORT, PSession({}, device="cpu"),
                               False).limit(10).collect())
    cpu = _norm(_explode_query(
        PORT, PSession({"spark.rapids.tpu.sql.enabled": False},
                       device="cpu"), False).limit(10).collect())
    assert got == ref
    assert len(cpu) == len(got) == 10
    assert sorted(map(repr, cpu)) != sorted(map(repr, got))
