"""The port's live observability plane (``spark_rapids_tpu_torch/obs/``)
against the reference's.

* the metric catalog is the reference's, and the same call sequence into
  both registries gives the same ``snapshot()`` and the same Prometheus
  text;
* the same registry states, catalogs and ledgers give the same
  ``Watchdog.check_now`` alerts, and the same event lists the same
  ``replay_alerts``;
* ``build_status`` has the reference's keys and serializes to JSON; the
  exporter serves ``/metrics`` and ``/status`` on an ephemeral port;
* the flight recorder dumps the ring once per alert episode, and the
  watchdog's own thread raises a stall;
* a port query under ``metrics.live.enabled`` feeds the per-op counters,
  the strategy counters and the progress tracker, and
  ``tools/tpu_top.py`` renders its ``/status``; with the defaults,
  nothing is started.
"""
import json
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import events as JEv
from spark_rapids_tpu import obs as JObs
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.memory import catalog as JC
from spark_rapids_tpu.memory import ledger as JL
from spark_rapids_tpu.obs import server as JServer
from spark_rapids_tpu_torch import events as PEv
from spark_rapids_tpu_torch import obs as PObs
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.conf import RapidsConf as PConf
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr.expressions import col
from spark_rapids_tpu_torch.memory import catalog as PC
from spark_rapids_tpu_torch.memory import ledger as PL
from spark_rapids_tpu_torch.obs import server as PServer
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

BUDGET = "spark.rapids.tpu.memory.hbm.budgetBytes"


@pytest.fixture(autouse=True)
def _fresh_planes():
    yield
    PObs.shutdown()
    JObs.shutdown()
    PEv.uninstall()
    JEv.uninstall()
    PL.force_arm(False)
    JL.force_arm(False)
    PC.BufferCatalog.reset()
    JC.BufferCatalog.reset()


def test_metric_catalog_is_the_references():
    assert PObs.METRICS == JObs.METRICS
    assert PObs.EVENT_BACKED_METRICS == JObs.EVENT_BACKED_METRICS
    assert set(PObs.EVENT_BACKED_METRICS) == set(PEv.EVENT_TYPES)


def _drive(mod) -> object:
    """One seeded sequence of registry calls."""
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(3)
    ops = ("TpuHashAggregateExec", "TpuFilterExec", 'odd "op"\\x\n')
    for i in range(200):
        op = ops[int(rng.integers(0, 3))]
        reg.inc("tpu_op_time_seconds", float(rng.uniform(0, 0.2)), op=op,
                lane=("host", "device")[i % 2])
        reg.inc("tpu_op_rows", int(rng.integers(0, 5000)), op=op)
        reg.observe("tpu_op_batch_seconds",
                    float(rng.choice([0.0005, 0.003, 0.05, 0.5, 4, 40])),
                    op=op)
        reg.set_gauge("tpu_hbm_device_bytes", int(rng.integers(0, 1e9)))
        reg.set_gauge_max("tpu_program_temp_bytes",
                          int(rng.integers(0, 1e6)), site="agg")
        reg.inc("tpu_agg_strategy", 1, strategy=("PALLAS", "SCATTER")[i % 2])
        reg.inc("tpu_shuffle_bytes", 1e15 + i, direction="write",
                codec="none")
    reg.note_compile_miss("agg", ts_ns=5)
    reg.note_oom_retry("TpuHashAggregateExec", "split", ts_ns=7)
    reg.observe("tpu_serve_queue_wait_seconds", 0.02)
    t = reg.span_open("TpuFilterExec", "probe", start_ns=11)
    reg.span_close(t)
    reg.span_open("TpuFilterExec", "", start_ns=13)
    return reg


def test_registry_snapshot_and_prometheus_are_the_references():
    p, j = _drive(PObs), _drive(JObs)
    assert p.snapshot() == j.snapshot()
    assert p.render_prometheus() == j.render_prometheus()
    assert p.open_spans() == j.open_spans() == [("TpuFilterExec", "", 13)]
    assert p.recent_compile_misses() == j.recent_compile_misses()
    assert p.recent_oom_retries() == j.recent_oom_retries()
    assert p.value("tpu_op_rows", op="TpuFilterExec") == j.value(
        "tpu_op_rows", op="TpuFilterExec")
    with pytest.raises(ValueError, match="undeclared label"):
        p.inc("tpu_op_rows", 1, opp="x")
    # the module helpers are no-ops with nothing installed
    PObs.uninstall()
    PObs.inc("tpu_op_rows", 1, opp="never validated")


def _catalogs(budget: int):
    """Both catalogs with the same budget, the ledger force-armed, one
    query's two buffers of two ops, both flagged by its sweep: pressure
    (under a budget of 2200 B), leaks and the top owners all show."""
    PL.force_arm(True)
    JL.force_arm(True)
    pc = PC.BufferCatalog.reset(PConf({BUDGET: budget}), "cpu")
    jc = JC.BufferCatalog.reset(JConf({BUDGET: budget}))
    keep = []
    for n, op in ((300, "TpuHashAggregateExec"),
                  (200, "TpuShuffledHashJoinExec")):
        with PL.query_scope(9), PL.op_scope(op):
            keep.append(PC.SpillableHandle(
                {"a": torch.zeros(n, dtype=torch.float32)}, 0, pc))
        from spark_rapids_tpu import xla_cost

        with JL.query_scope(9), xla_cost.op_scope(op):
            keep.append(JC.SpillableHandle(
                {"a": jnp.zeros(n, dtype=jnp.float32)}, 0, jc))
    pc.ledger.sweep_query(9)
    jc.ledger.sweep_query(9)
    return keep


def _alerts(alerts):
    return [(a.kind, a.detail, a.value, a.threshold, a.ts) for a in alerts]


def test_watchdog_check_now_is_the_references():
    keep = _catalogs(2200)
    out = []
    for mod in (PObs, JObs):
        reg = mod.MetricsRegistry()
        reg.span_open("TpuHashAggregateExec", "update", start_ns=1_000)
        reg.span_open("TpuFilterExec", "", start_ns=9_000_000_000)
        for i in range(9):
            reg.note_compile_miss("agg", ts_ns=5_000_000_000 + i)
            reg.note_oom_retry("TpuShuffledHashJoinExec", ts_ns=6_000 + i)
        dog = mod.Watchdog(reg, mod.WatchdogRules(
            stall_ns=1_000_000_000, storm_threshold=8,
            storm_window_ns=10_000_000_000, retry_storm_threshold=8))
        first = dog.check_now(now_ns=9_500_000_000)
        again = dog.check_now(now_ns=9_600_000_000)
        out.append((_alerts(first), again, _alerts(dog.alerts()),
                    reg.snapshot()))
    p, j = out
    assert p == j
    kinds = {a[0] for a in p[0]}
    assert kinds == {"stall", "hbm_pressure", "buffer_leak",
                     "recompile_storm", "retry_storm"}
    assert p[1] == []  # one alert per episode
    del keep


def _replay_events():
    ev = [
        {"event": "plan_analysis", "budget": 1000, "ts": 1},
        {"event": "buffer_alloc", "bid": 1, "kind": "spillable",
         "bytes": 600, "op": "TpuHashAggregateExec", "ts": 2},
        {"event": "buffer_alloc", "bid": 2, "kind": "reservation",
         "bytes": 50, "op": None, "ts": 3},
        {"event": "spill", "kind": "unspill", "bytes": 600,
         "device_bytes": 900, "bid": 1, "ts": 4},
        {"event": "spill", "kind": "device_to_host", "bytes": 600,
         "device_bytes": 300, "bid": 1, "ts": 5},
        {"event": "spill", "kind": "unspill", "bytes": 600,
         "device_bytes": 950, "bid": 1, "ts": 6},
        {"event": "op_span", "op": "TpuSortExec", "section": "",
         "lane": "host", "dur": 5_000_000_000, "ts": 7},
        {"event": "op_span", "op": "TpuSortExec", "section": "device_wait",
         "lane": "device", "dur": 5_000_000_000, "ts": 8},
        {"event": "heap_snapshot", "query_id": 3, "leaked": 2, "ts": 9},
        {"event": "heap_snapshot", "query_id": 4, "leaked": 2, "ts": 10},
        {"event": "heap_snapshot", "query_id": 5, "leaked": 0, "ts": 11},
        {"event": "heap_snapshot", "query_id": 6, "leaked": 1, "ts": 12},
        {"event": "buffer_free", "bid": 1, "ts": 13},
    ]
    ev += [{"event": "compile_miss", "site": "agg", "ts": 20 + i}
           for i in range(10)]
    ev += [{"event": "oom_retry", "op": "TpuHashAggregateExec",
            "kind": "retry", "ts": 40 + i} for i in range(9)]
    return ev


@pytest.mark.parametrize("budget", (None, 1100))
def test_replay_alerts_is_the_references(budget):
    ev = _replay_events()
    p = PObs.replay_alerts(ev, PObs.WatchdogRules(stall_ns=1_000_000_000),
                           budget)
    j = JObs.replay_alerts(ev, JObs.WatchdogRules(stall_ns=1_000_000_000),
                           budget)
    assert _alerts(p) == _alerts(j)
    assert {a.kind for a in p} == {"stall", "hbm_pressure", "buffer_leak",
                                   "recompile_storm", "retry_storm"}
    assert [a.describe() for a in p] == [a.describe() for a in j]


def _status_keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k in ("hbm", "heap"):
            out |= _status_keys(v, prefix + k + ".")
    return out


def test_build_status_has_the_references_keys():
    keep = _catalogs(1 << 20)
    p = PServer.build_status(PObs.MetricsRegistry(), PObs.ProgressTracker(),
                             None)
    j = JServer.build_status(JObs.MetricsRegistry(), JObs.ProgressTracker(),
                             None)
    assert _status_keys(p) == _status_keys(j)
    assert p["serve"] is None and p["program_cache"] is None
    assert p["heap"]["leaked"] == 2 and p["hbm"]["reserved_bytes"] == 0
    assert p["heap"] == {**j["heap"], "spill_churn_bytes":
                         p["heap"]["spill_churn_bytes"]}
    assert json.loads(json.dumps(p))["env"]["backend"] in ("cpu", "gpu")
    del keep


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def test_exporter_serves_metrics_and_status():
    reg = PObs.MetricsRegistry()
    reg.inc("tpu_join_strategy", 2, strategy="PALLAS")
    srv = PServer.MetricsServer(reg, PObs.ProgressTracker(), None,
                                port=0).start()
    try:
        assert srv.port > 0 and srv.address.startswith("http://127.0.0.1:")
        code, ctype, body = _get(srv.address + "/metrics")
        assert code == 200 and ctype == PServer.PROM_CONTENT_TYPE
        assert 'tpu_join_strategy_total{strategy="PALLAS"} 2' in body
        assert body == reg.render_prometheus()
        code, ctype, body = _get(srv.address + "/status")
        assert code == 200 and ctype == "application/json"
        assert json.loads(body)["metrics"]["tpu_join_strategy"] == {
            "strategy=PALLAS": 2.0}
        assert _get(srv.address + "/healthz")[2] == "ok\n"
        with pytest.raises(urllib.error.HTTPError):
            _get(srv.address + "/nope")
    finally:
        srv.stop()


def test_flight_recorder_dumps_once_per_episode(tmp_path):
    logger = PEv.EventLogger(PConf({
        "spark.rapids.tpu.eventLog.dir": str(tmp_path),
        "spark.rapids.tpu.eventLog.flightRecorder.enabled": True}))
    assert logger.enabled and logger.path is None
    PEv.install(logger)
    PEv.emit("query_start", query_id=1, plan_digest="d", sql_hash="h")
    reg = PObs.MetricsRegistry()
    dog = PObs.Watchdog(reg, PObs.WatchdogRules(stall_ns=1000), budget=0)
    tok = reg.span_open("TpuSortExec", "", start_ns=1)
    assert [a.kind for a in dog.check_now(now_ns=5000)] == ["stall"]
    assert dog.check_now(now_ns=6000) == []
    reg.span_close(tok)
    assert dog.check_now(now_ns=7000) == []
    reg.span_open("TpuSortExec", "", start_ns=8000)
    assert [a.kind for a in dog.check_now(now_ns=10_000)] == ["stall"]
    dumps = sorted(tmp_path.glob("tpu-flightrec-*.jsonl"))
    assert [p.name.rsplit("-", 1)[1] for p in dumps] == ["1.jsonl",
                                                        "2.jsonl"]
    first = [json.loads(ln) for ln in dumps[0].read_text().splitlines()]
    assert [r["event"] for r in first] == ["query_start", "alert"]
    assert not list(tmp_path.glob("tpu-events-*"))


def _our_threads():
    return {t.name for t in threading.enumerate()
            if t.name in ("srtpu-metrics-http", "srtpu-watchdog")}


def test_watchdog_thread_raises_a_stall():
    plane = PObs.ensure_started(PConf({
        "spark.rapids.tpu.watchdog.enabled": True,
        "spark.rapids.tpu.watchdog.intervalMs": 20,
        "spark.rapids.tpu.watchdog.stallThresholdMs": 30}))
    assert plane.watchdog is not None and plane.server is None
    assert _our_threads() == {"srtpu-watchdog"}
    PObs.span_open("TpuHashAggregateExec", "update")
    deadline = time.time() + 10
    while not plane.watchdog.alerts() and time.time() < deadline:
        time.sleep(0.02)
    (alert,) = plane.watchdog.alerts()
    assert (alert.kind, alert.detail) == ("stall",
                                          "TpuHashAggregateExec.update")
    PObs.shutdown()
    assert PObs.plane() is None and not _our_threads()


def test_live_metrics_follow_a_port_query():
    sess = PSession({"spark.rapids.tpu.metrics.http.enabled": True,
                     "spark.rapids.tpu.sql.join.strategy": "SEARCH",
                     "spark.rapids.tpu.metrics.deviceSync.enabled": True},
                    device="cpu")
    rows = [(i % 11, i) for i in range(2000)]
    schema = T.StructType((T.StructField("k", T.INT),
                           T.StructField("v", T.LONG)))
    dim = sess.from_rows([(k, 7 * k) for k in range(11)], T.StructType(
        (T.StructField("dk", T.INT), T.StructField("w", T.LONG))))
    got = (sess.from_rows(rows, schema).join(dim, [("k", "dk")])
           .group_by("k").agg(PA.agg(PA.Sum(col("w")), "s")).collect())
    assert len(got) == 11
    _, _, text = _get(sess.obs_address + "/metrics")
    assert 'tpu_join_strategy_total{strategy="SEARCH"} 1' in text
    assert 'tpu_agg_strategy_total{strategy="SCATTER"}' in text
    status = json.loads(_get(sess.obs_address + "/status")[2])
    (q,) = status["queries"]
    assert q["state"] == "finished" and q["rows_out"] == 11
    by_op = {o["op"]: o for o in q["ops"]}
    assert by_op["InMemoryScanExec"]["rows"] == 2011
    assert all(o["rows_forecast"] is None and o["progress"] is None
               for o in q["ops"])
    reg = PObs.active()
    assert reg.value("tpu_queries", state="finished") == 1
    assert reg.value("tpu_op_time_seconds", op="TpuShuffledHashJoinExec",
                     lane="host") > 0
    assert reg.value("tpu_transfers", direction="fence") > 0
    assert status["heap"]["allocs"] >= 1


def test_defaults_start_nothing():
    PObs.shutdown()
    sess = PSession({}, device="cpu")
    assert sess.obs_address is None and PObs.plane() is None
    assert not PObs.enabled() and not _our_threads()
    assert PObs.ensure_started(PConf({})) is None
    with pytest.raises(RuntimeError, match="event logging is off"):
        sess.export_trace("/nonexistent/t.json")


def test_plane_budget_gauge_is_the_derived_budget():
    plane = PObs.ensure_started(PConf({
        "spark.rapids.tpu.metrics.live.enabled": True, BUDGET: 12345}))
    assert plane.server is None and plane.watchdog is None
    assert plane.registry.value("tpu_hbm_budget_bytes") == 12345
    assert PObs.ensure_started(PConf({
        "spark.rapids.tpu.metrics.live.enabled": True})) is plane


def test_tpu_top_reads_the_port_status():
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    sess = PSession({"spark.rapids.tpu.metrics.http.enabled": True},
                    device="cpu")
    schema = T.StructType((T.StructField("k", T.INT),
                           T.StructField("v", T.LONG)))
    sess.from_rows([(i % 3, i) for i in range(100)], schema).group_by(
        "k").agg(PA.agg(PA.Count(None), "c")).collect()
    res = subprocess.run(
        [sys.executable, str(root / "tools" / "tpu_top.py"), "--url",
         sess.obs_address, "--once"], capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "TpuHashAggregateExec" in res.stdout
    assert "backend=cpu" in res.stdout


def _armed_catalog_with_a_cyclic_buffer():
    """A CPU catalog whose ledger is armed by a ring-only event log and
    the live plane, and one spillable buffer that only the cyclic
    collector frees."""
    cat = PC.BufferCatalog.reset(PConf({}), "cpu")
    # the ring alone: no file, so nothing waits on the lock at exit
    logger = PEv.EventLogger(PConf({"spark.rapids.tpu.eventLog.enabled":
                                    True}))
    PEv.install(logger)
    PObs.ensure_started(PConf({"spark.rapids.tpu.metrics.live.enabled":
                               True}))

    class Box:
        pass

    box = Box()
    box.handle = PC.SpillableHandle({"a": torch.zeros(10)}, 0, cat)
    box.me = box  # only the cyclic collector frees it
    return cat, logger


def test_a_collected_buffer_frees_outside_the_leaf_locks():
    """The port's catalog holds buffers weakly, and a garbage collection
    can run while a thread holds the event logger's and the registry's
    locks. The buffer's finalizer only queues its id; its ``buffer_free``
    and gauges come at the catalog's next entry, from a normal call path.
    The lock-order witness sees no inversion."""
    import gc

    from spark_rapids_tpu_torch.utils import locks

    cat, logger = _armed_catalog_with_a_cyclic_buffer()
    locks.install_witness()
    try:
        with logger._lock:
            with PObs.active()._lock:
                gc.collect()
        assert [r["event"] for r in logger.records()] == ["buffer_alloc"]
        assert cat.device_bytes == 0  # the read drains the queue
        assert locks.observed_inversions() == []
    finally:
        locks.uninstall_witness()
    assert [r["event"] for r in logger.records()] == ["buffer_alloc",
                                                      "buffer_free"]
    assert logger.records()[1]["reason"] == "gc"
    assert PObs.active().value("tpu_hbm_device_bytes") == 0
    assert not cat._buffers


def test_a_collection_under_the_log_lock_does_not_wait_for_the_catalog():
    """Two threads: one holds the event logger's lock while a collection
    frees a buffer, the other holds the catalog's lock and registers a
    buffer, which emits ``buffer_alloc``. A finalizer that took the
    catalog's lock would deadlock the pair."""
    import gc

    cat, logger = _armed_catalog_with_a_cyclic_buffer()
    log_held, cat_held = threading.Event(), threading.Event()
    kept = []

    def collect_under_the_log_lock():
        with logger._lock:
            log_held.set()
            cat_held.wait(10)
            gc.collect()

    def register_under_the_catalog_lock():
        with cat._lock:
            cat_held.set()
            log_held.wait(10)
            kept.append(PC.SpillableHandle({"b": torch.zeros(4)}, 0, cat))

    threads = [threading.Thread(target=f, daemon=True)
               for f in (collect_under_the_log_lock,
                         register_under_the_catalog_lock)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not any(t.is_alive() for t in threads), "deadlocked"
    assert cat.device_bytes == 16
    assert sorted(r["event"] for r in logger.records()) == [
        "buffer_alloc", "buffer_alloc", "buffer_free"]
    kept[0].close()
