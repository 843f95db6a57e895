"""The sharded scans under the port's mesh stages, and their telemetry.

``MeshShardedScanExec`` (per-partition host columns placed straight on
their shards) and the parquet scan's sharded row-group staging, with the
whole-plan absorption of a filter/project chain on and off
(``shuffle.mesh.wholePlan.enabled``). The exec-level plans are held to
Python oracles (integers exactly); the parquet query runs through both
packages' sessions on the same file and must give the same rows (sums of
doubles within rtol 1e-12). The mesh runs on 8 virtual CPU shards
(``SRTPU_TORCH_VIRTUAL_DEVICES``, set by a fixture).
"""
import numpy as np
import pytest
import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu_torch import events as EV
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import schema_of
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import TpuFilterExec, TpuProjectExec
from spark_rapids_tpu_torch.exec.mesh import TpuMeshAggregateExec
from spark_rapids_tpu_torch.exec.scan import MeshShardedScanExec
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.expressions import col, lit
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

from test_torch_exchange import check
from test_torch_mesh import virtual_devices  # noqa: F401 (autouse)

N_DEV = 8
ICI = {"spark.rapids.tpu.shuffle.mode": "ici"}
WHOLE_PLAN = "spark.rapids.tpu.shuffle.mesh.wholePlan.enabled"




def _conf(extra=None):
    return RapidsConf({**ICI, **(extra or {})})


def _agg_data(n=4000, n_parts=N_DEV + 3, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 23, n).astype(np.int32)
    a = rng.integers(-100, 100, n).astype(np.int64)
    per = (n + n_parts - 1) // n_parts
    parts = []
    for p in range(n_parts):
        lo, hi = p * per, min((p + 1) * per, n)
        parts.append(([(k[lo:hi], np.ones(hi - lo, bool)),
                       (a[lo:hi], a[lo:hi] % 7 != 0)], hi - lo))
    return parts, schema_of(k=T.INT, a=T.LONG), k, a


def _agg_plan(conf, parts, schema):
    scan = MeshShardedScanExec(conf, parts, schema, device="cpu")
    filt = TpuFilterExec(conf, E.GreaterThanOrEqual(col("a"), lit(0)), scan)
    proj = TpuProjectExec(
        conf, [col("k"), E.Alias(E.Multiply(col("a"), lit(2)), "a2")], filt)
    return TpuMeshAggregateExec(
        conf, [col("k")],
        [A.agg(A.Sum(col("a2")), "s"), A.agg(A.Count(None), "c")], proj)


def _agg_oracle(k, a):
    want = {}
    for kk, aa in zip(k, a):
        if aa < 0 or aa % 7 == 0:  # a % 7 == 0 rows are null
            continue
        s, c = want.get(int(kk), (0, 0))
        want[int(kk)] = (s + 2 * int(aa), c + 1)
    return sorted((kk, s, c) for kk, (s, c) in want.items())


def _rows(root):
    return [r for p in range(root.num_partitions)
            for b in root.execute_partition(p) for r in b.to_rows()]


@pytest.mark.parametrize("whole_plan", [True, False])
def test_sharded_scan_agg_whole_plan_on_and_off(whole_plan):
    parts, schema, k, a = _agg_data(seed=1 + whole_plan)
    plan = _agg_plan(_conf({WHOLE_PLAN: whole_plan}), parts, schema)
    assert sorted(_rows(plan)) == _agg_oracle(k, a)
    act = plan.mesh_actuals["staging"]
    fc = plan.forecast_mesh_staging(plan.children[0])
    if whole_plan:
        # the chain ran per shard, fed straight from the host columns
        assert act["source"] == "sharded_scan"
        assert fc["absorbed_steps"] == ["TpuFilterExec", "TpuProjectExec"]
        # partition i on shard i % 8: 11 partitions, shards 0-2 get two
        assert act["per_shard_rows"] == fc["per_shard_rows"]
        assert act["staged_bytes"] == fc["staged_bytes"]
        assert act["cap"] == fc["cap"]
    else:
        # the chain runs on the plan's device; its row counts are known
        # only once it has run, so there is no forecast
        assert act["source"] == "host"
        assert fc is None
    assert sum(act["per_shard_rows"]) == (
        len(k) if whole_plan else int(((a >= 0) & (a % 7 != 0)).sum()))


def test_sharded_scan_off_mesh_batches():
    """Off the mesh the scan emits ordinary batches, one a partition."""
    parts, schema, k, a = _agg_data(n=300, n_parts=3)
    scan = MeshShardedScanExec(_conf(), parts, schema, device="cpu")
    rows = _rows(scan)
    assert rows == [(int(x), int(y) if y % 7 else None)
                    for x, y in zip(k, a)]


def _write_parquet(tmp_path, n=4000, seed=11):
    """A file of 16 row groups."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 11, n).astype(np.int32)
    c = rng.integers(0, 50, n).astype(np.int64)
    d = rng.integers(0, 100, n).astype(np.int32)
    w = np.round(rng.uniform(1, 100, n), 2)
    t = pa.table({"q": pa.array(q), "c": pa.array(c), "d": pa.array(d),
                  "w": pa.array(w)})
    pq.write_table(t, str(tmp_path / "t.parquet"), row_group_size=n // 16)
    return str(tmp_path)


def _parquet_query(sess, path, E_, A_):
    col_ = E_.UnresolvedAttribute
    return (sess.read.parquet(path)
            .where(E_.GreaterThanOrEqual(col_("d"), E_.Literal.of(50)))
            .group_by("q")
            .agg(A_.agg(A_.Sum(col_("c")), "s"),
                 A_.agg(A_.Sum(col_("w")), "sw"),
                 A_.agg(A_.Count(None), "n")))


#: one split per row group: the default 2 GB coalescing target would pack
#: the file into one partition, and one partition plans no mesh
PARQUET = {**ICI, "spark.rapids.tpu.sql.reader.batchSizeBytes": 2048,
           "spark.rapids.tpu.sql.variableFloatAgg.enabled": True}


@pytest.fixture(scope="module")
def parquet_case(tmp_path_factory):
    """(path, the reference's rows): its sharded scan, run once."""
    path = _write_parquet(tmp_path_factory.mktemp("mesh_pq"))
    return path, _parquet_query(JSession(PARQUET), path, JE, JA).collect()


@pytest.mark.parametrize("whole_plan", [True, False])
def test_parquet_sharded_scan_through_session(parquet_case, whole_plan):
    path, ref = parquet_case
    ps = PSession({**PARQUET, WHOLE_PLAN: whole_plan}, device="cpu")
    got = _parquet_query(ps, path, E, A).collect()
    root = ps.last_executed_plan.tpu_child
    assert root.node_name == "TpuMeshAggregateExec", root.tree_string()
    assert root.mesh_actuals["staging"]["source"] == (
        "sharded_scan" if whole_plan else "host")
    check(ref, got, rtol=1e-12)
    assert len(got) == 10


def test_per_shard_spans_and_transfers_in_event_log():
    logger = EV.EventLogger(RapidsConf(
        {"spark.rapids.tpu.eventLog.enabled": True}))
    EV.install(logger)
    try:
        parts, schema, k, a = _agg_data(n=800, seed=21)
        _rows(_agg_plan(_conf(), parts, schema))
    finally:
        EV.uninstall()
    recs = logger.records()
    for r in recs:
        et = r.get("event")
        declared = set(EV.EVENT_TYPES[et]) | set(
            EV.EVENT_OPTIONAL_FIELDS.get(et, ())) | {"ts", "event", "tid"}
        assert set(r) <= declared, (et, sorted(set(r) - declared))
    spans = [r for r in recs if r.get("event") == "op_span"
             and r.get("shard") is not None]
    assert sorted({r["shard"] for r in spans}) == list(range(N_DEV))
    xfers = [r for r in recs if r.get("event") == "transfer"
             and r.get("shard") is not None]
    assert sorted({r["shard"] for r in xfers}) == list(range(N_DEV))
    trace = EV.chrome_trace(recs)
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M"}
    for sh in range(N_DEV):
        assert any(f"[chip {sh}]" in n for n in names), names


def test_staged_rows_counter_counts_every_shard():
    from spark_rapids_tpu_torch import obs

    plane = obs.ensure_started(RapidsConf(
        {"spark.rapids.tpu.metrics.live.enabled": True}))
    try:
        parts, schema, k, a = _agg_data(n=800, seed=4)
        _rows(_agg_plan(_conf(), parts, schema))
        staged = plane.registry.snapshot()["tpu_mesh_staged_rows"]
        secs = plane.registry.snapshot()["tpu_mesh_shard_seconds"]
    finally:
        obs.shutdown()
    # partition i on shard i % 8: 11 partitions, shards 0-2 get two
    want = [0] * N_DEV
    for i, (_, rows) in enumerate(parts):
        want[i % N_DEV] += rows
    assert staged == {f"device={s}": r for s, r in enumerate(want)}
    assert sorted(secs) == [f"device={s}" for s in range(N_DEV)]
