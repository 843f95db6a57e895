"""The port's event log (``spark_rapids_tpu_torch/events.py``) and the
emitters at its ported sites, against the reference's.

* the schema (``EVENT_TYPES``, ``EVENT_OPTIONAL_FIELDS``) and the
  observability conf keys are the reference's;
* every event type round-trips through both packages' JSONL sinks to the
  same record, and the same records give the same Chrome trace;
* the same query through both packages' sessions (the event log and
  ``metrics.deviceSync.enabled`` on; the reference with
  ``sql.analysis.enabled=false`` and ``shuffle.mode=host``) emits the
  same (event, op) multiset in every family both emit, the same
  ``agg_strategy``/``join_strategy`` (strategy, reason, capacity), the
  same ``op_batch`` rows and bytes per op, ``plan_tagged`` fallbacks,
  ``query_end`` rows and ``bytesTouched`` per exec. Three differences
  are by design and excluded: ``transfer`` (the port's d2h is one record
  a collected batch and its device lane adds a ``fence`` a batch; the
  reference reads through ``host_pull`` inside its execs), the port's
  host-lane spans of the exchange reads (sections ``reduce`` and
  ``read``, which the reference leaves untimed), and the counts of the
  cost plane's ``program_cost``/``hlo_summary`` (the reference harvests
  each XLA program it compiles, a join's build, count and expand
  programs apart; the port one eager dispatch per site and signature):
  the port's harvested sites must be sites the reference harvested, each
  with its ``hlo_summary`` twin;
* with every observability key at its default, a whole port query never
  reaches an emitter, never arms the ledger and never synchronizes;
* the ledger arms with the event log, and its records balance at the
  query's heap snapshot;
* with the analyzer on in both, the ``plan_analysis`` record is the
  reference's; the serving scheduler's ``admission``, ``queue`` and
  serve-lane ``op_span`` records are the reference's on one scenario
  (queue, admit, reject, requeue);
* ``tools/tpu_profile.py`` reads a port log, unchanged;
* ``sql.trace.enabled`` names each hot section's profiler range.
"""
import json
import os
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import conf as JConf
from spark_rapids_tpu import events as JEv
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.memory import catalog as JC
from spark_rapids_tpu.memory import ledger as JL  # noqa: F401 (its confs)
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import conf as PConf
from spark_rapids_tpu_torch import events as PEv
from spark_rapids_tpu_torch import obs as PObs
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import base as PB
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.memory import catalog as PC
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

ROOT = Path(__file__).resolve().parent.parent
REF = dict(T=JT, E=JE, A=JA)
PORT = dict(T=T, E=PE, A=PA)
EVENTS_ON = {"spark.rapids.tpu.eventLog.enabled": True,
             "spark.rapids.tpu.metrics.deviceSync.enabled": True}
REF_ONLY = {"spark.rapids.tpu.sql.analysis.enabled": False,
            "spark.rapids.tpu.shuffle.mode": "host"}


@pytest.fixture(autouse=True)
def _fresh_planes():
    yield
    PEv.uninstall()
    JEv.uninstall()
    PObs.shutdown()
    PC.BufferCatalog.reset()
    JC.BufferCatalog.reset()


# ---------------------------------------------------------------------------
# Schema and confs
# ---------------------------------------------------------------------------
def test_event_schema_is_the_references():
    assert PEv.EVENT_TYPES == JEv.EVENT_TYPES
    assert PEv.EVENT_OPTIONAL_FIELDS == JEv.EVENT_OPTIONAL_FIELDS


OBS_KEYS = (
    "spark.rapids.tpu.eventLog.enabled", "spark.rapids.tpu.eventLog.dir",
    "spark.rapids.tpu.eventLog.ringBuffer.size",
    "spark.rapids.tpu.eventLog.flightRecorder.enabled",
    "spark.rapids.tpu.metrics.live.enabled",
    "spark.rapids.tpu.metrics.http.enabled",
    "spark.rapids.tpu.metrics.http.port",
    "spark.rapids.tpu.metrics.http.host",
    "spark.rapids.tpu.metrics.deviceSync.enabled",
    "spark.rapids.tpu.sql.trace.enabled",
    "spark.rapids.tpu.watchdog.enabled",
    "spark.rapids.tpu.watchdog.intervalMs",
    "spark.rapids.tpu.watchdog.stallThresholdMs",
    "spark.rapids.tpu.watchdog.hbmPressureFraction",
    "spark.rapids.tpu.watchdog.recompileStorm.windowMs",
    "spark.rapids.tpu.watchdog.retryStorm.threshold",
    "spark.rapids.tpu.sql.analysis.recompileStorm.threshold",
    "spark.rapids.tpu.memory.ledger.enabled",
    "spark.rapids.tpu.memory.ledger.leakSentinel.enabled")


@pytest.mark.parametrize("key", OBS_KEYS)
def test_observability_conf_defaults_are_the_references(key):
    j, p = JConf._REGISTRY[key], PConf._REGISTRY[key]
    assert (p.default, p.conf_type) == (j.default, j.conf_type)


def _sample(field: str, i: int):
    """A plausible JSON value for an event field."""
    if field in ("op", "site", "kind", "strategy", "reason", "codec",
                 "direction", "stage", "section", "lane", "digest", "key",
                 "backend", "verdict", "session", "origin", "detail",
                 "plan_digest", "sql_hash", "forecast_source"):
        return f"{field}-{i}"
    if field in ("fallbacks", "warnings", "top", "top_fusions"):
        return [{"op": "x", "reasons": ["r"]}] if field == "fallbacks" \
            else [["TpuHashAggregateExec", 128]]
    if field in ("site_forecast", "bytes_by_op", "rows_by_op",
                 "batches_by_op", "by_op", "env", "out_bytes",
                 "largest_output"):
        return {"TpuHashAggregateExec": 7 + i}
    if field in ("bounded", "on_tpu", "from_cache"):
        return True
    if field in ("coverage", "accounted_frac", "value", "threshold",
                 "trace_ms", "compile_ms"):
        return 0.25 + i
    return 1000 + i


@pytest.mark.parametrize("etype", sorted(JEv.EVENT_TYPES))
def test_jsonl_round_trip_is_the_references(tmp_path, etype):
    fields = {f: _sample(f, i) for i, f in enumerate(
        JEv.EVENT_TYPES[etype] + JEv.EVENT_OPTIONAL_FIELDS.get(etype, ()))}
    out = []
    for mod in (PEv, JEv):
        path = tmp_path / f"{mod.__name__}.jsonl"
        logger = mod.EventLogger(path=str(path))
        logger.emit(etype, **fields)
        logger.close()
        (rec,) = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert rec == logger.records()[0]
        out.append(rec)
    p, j = out
    assert set(p) == set(j) == {"ts", "event", "tid", *fields}
    drop = ("ts", "tid")
    assert ({k: v for k, v in p.items() if k not in drop}
            == {k: v for k, v in j.items() if k not in drop}
            == {"event": etype, **fields})


def _trace_records():
    """One record of every family chrome_trace draws, on one clock."""
    t = 10_000_000
    recs = [
        {"event": "query_start", "query_id": 1},
        {"event": "op_span", "op": "TpuHashAggregateExec",
         "section": "update", "start": t - 500, "dur": 400, "lane": "host"},
        {"event": "op_span", "op": "TpuHashAggregateExec",
         "section": "device_wait", "start": t - 90, "dur": 60,
         "lane": "device"},
        {"event": "op_span", "op": "TpuFilterExec", "section": "",
         "start": t - 50, "dur": 20, "lane": "host", "shard": 3},
        {"event": "compile_miss", "site": "agg", "total": 2},
        {"event": "program_cost", "site": "agg", "digest": "d",
         "trace_ms": 1.5, "compile_ms": 2.0, "flops": 5, "op": "X"},
        {"event": "buffer_alloc", "bid": 1, "kind": "spillable",
         "bytes": 800, "op": "TpuShuffledHashJoinExec"},
        {"event": "spill", "kind": "device_to_host", "bytes": 800,
         "device_bytes": 0, "bid": 1},
        {"event": "spill", "kind": "unspill", "bytes": 800,
         "device_bytes": 800, "bid": 1},
        {"event": "buffer_free", "bid": 1, "bytes": 800},
        {"event": "heap_snapshot", "live_bytes": 0, "leaked": 0},
        {"event": "oom_retry", "op": "TpuHashAggregateExec", "kind": "retry",
         "attempt": 1, "depth": 0, "watermark": 5, "budget": 9},
        {"event": "batch_split", "op": "TpuHashAggregateExec", "depth": 1,
         "rows": 9, "rows_left": 5, "rows_right": 4},
        {"event": "transfer", "direction": "h2d", "bytes": 64,
         "site": "packed_upload"},
        {"event": "transfer", "direction": "h2d", "bytes": 64,
         "site": "packed_upload", "shard": 1},
        {"event": "shuffle_write", "bytes": 32},
        {"event": "shuffle_fetch", "bytes": 32},
        {"event": "scan_cache", "op": "hit"},
        {"event": "program_cache", "op": "hit", "site": "agg"},
        {"event": "alert", "kind": "stall", "detail": "x"},
        {"event": "pq_pipeline", "stage": "decode", "rg": 0, "bytes": 9,
         "dur": 30},
        {"event": "admission", "verdict": "admit", "session": "s-1"},
        {"event": "queue", "session": "s-1", "depth": 2},
        {"event": "agg_strategy", "op": "TpuHashAggregateExec"},
        {"event": "query_end", "query_id": 1, "dur": 900, "rows": 3},
    ]
    for i, r in enumerate(recs):
        r["ts"] = t - 1000 + 20 * i
    return recs


def test_chrome_trace_is_the_references(tmp_path):
    recs = _trace_records()
    assert PEv.chrome_trace(recs) == JEv.chrome_trace(recs)
    assert PEv.chrome_trace([]) == JEv.chrome_trace([])
    path = PEv.export_chrome_trace(recs, str(tmp_path / "t.json"))
    assert json.loads(Path(path).read_text()) == JEv.chrome_trace(recs)


# ---------------------------------------------------------------------------
# The same queries through both sessions
# ---------------------------------------------------------------------------
def _rows(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 40)) if rng.random() > 0.03 else None,
             int(rng.integers(-1000, 1000)), float(rng.uniform(0, 10)))
            for _ in range(n)]


def _schema(m):
    T_ = m["T"]
    return T_.StructType((T_.StructField("k", T_.INT),
                          T_.StructField("v", T_.LONG),
                          T_.StructField("d", T_.DOUBLE)))


def _query(m, sess, q, parts):
    T_, E, A = m["T"], m["E"], m["A"]
    df = sess.from_rows(_rows(), _schema(m), num_partitions=parts)
    if q == "agg":
        return df.group_by("k").agg(A.agg(A.Sum(E.col("v")), "s"),
                                    A.agg(A.Min(E.col("d")), "m"),
                                    A.agg(A.Count(None), "c"))
    dim = sess.from_rows(
        [(k, k * 3) for k in range(0, 40, 2)],
        T_.StructType((T_.StructField("dk", T_.INT),
                       T_.StructField("w", T_.LONG))),
        num_partitions=parts)
    return df.join(dim, [("k", "dk")]).select("k", "v", "w")


CASES = [
    ("agg", {"spark.rapids.tpu.sql.agg.strategy": "SCATTER"}, 1),
    ("agg", {"spark.rapids.tpu.sql.agg.strategy": "PALLAS"}, 1),
    ("join", {"spark.rapids.tpu.sql.join.strategy": "SEARCH"}, 1),
    ("join", {"spark.rapids.tpu.sql.join.strategy": "DIRECT"}, 1),
    ("agg", {"spark.rapids.tpu.sql.agg.strategy": "SCATTER"}, 2),
    ("join", {"spark.rapids.tpu.sql.join.strategy": "SEARCH",
              "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}, 2),
]


def _tree_bytes(plan) -> Counter:
    """bytesTouched summed by exec class over a device plan tree."""
    out: Counter = Counter()

    def walk(n):
        m = getattr(n, "metrics", {}).get(PB.BYTES_TOUCHED)
        if m is not None:
            out[n.node_name] += m.value
        for c in getattr(n, "children", ()):
            walk(c)

    walk(getattr(plan, "tpu_child", plan))
    return out


def _run(q, settings, parts, port: bool):
    if port:
        sess = PSession({**EVENTS_ON, **settings}, device="cpu")
        m = PORT
    else:
        sess = JSession({**EVENTS_ON, **REF_ONLY, **settings})
        m = REF
    try:
        rows = sorted(_query(m, sess, q, parts).collect(),
                      key=lambda r: tuple((x is None, x) for x in r))
        return rows, sess.events.records(), _tree_bytes(
            sess.last_executed_plan)
    finally:
        sess.close()


#: the port's exchange-read sections the reference leaves untimed
PORT_READ_SECTIONS = {"reduce", "read"}


#: families whose counts differ by design (the module docstring)
BY_DESIGN = {"transfer", "program_cost", "hlo_summary"}


def _families(recs, both):
    out = Counter()
    for r in recs:
        ev = r["event"]
        if ev not in both or ev in BY_DESIGN:
            continue
        if (ev == "op_span" and r["lane"] == "host"
                and r["section"] in PORT_READ_SECTIONS):
            continue
        out[(ev, r.get("op"), r.get("lane"))] += 1
    return out


@pytest.mark.parametrize("q,settings,parts", CASES)
def test_session_events_are_the_references(q, settings, parts):
    jrows, jrec, jbytes = _run(q, settings, parts, port=False)
    prows, prec, pbytes = _run(q, settings, parts, port=True)
    assert prows == jrows
    both = {r["event"] for r in jrec} & {r["event"] for r in prec}
    assert {"query_start", "plan_tagged", "op_span", "op_batch",
            "query_end", "heap_snapshot"} <= both
    assert _families(prec, both) == _families(jrec, both)

    def harvested(recs, ev):
        return sorted((r["site"], r["digest"]) for r in recs
                      if r["event"] == ev)

    assert harvested(prec, "program_cost") == harvested(prec, "hlo_summary")
    assert {s for s, _ in harvested(prec, "program_cost")} <= {
        s for s, _ in harvested(jrec, "program_cost")}
    strat = "agg_strategy" if q == "agg" else "join_strategy"

    def picks(recs):
        return [(r["strategy"], r["reason"], r.get("cap", r.get(
            "build_cap"))) for r in recs if r["event"] == strat]

    assert picks(prec) == picks(jrec) and picks(prec)

    def pick(recs, ev, *keys):
        return sorted(tuple(r[k] for k in keys) for r in recs
                      if r["event"] == ev)

    assert pick(prec, "op_batch", "op", "rows", "bytes") == pick(
        jrec, "op_batch", "op", "rows", "bytes")
    assert all(r["rows"] is not None for r in prec
               if r["event"] == "op_batch")
    assert pick(prec, "plan_tagged", "on_tpu", "fallbacks") == pick(
        jrec, "plan_tagged", "on_tpu", "fallbacks")
    assert pick(prec, "query_end", "rows", "error") == pick(
        jrec, "query_end", "rows", "error") == [(len(prows), False)]
    # bytesTouched per exec class of the executed trees
    assert pbytes == jbytes and sum(pbytes.values()) > 0
    # every port exec that recorded a batch has device-lane spans
    ops = {r["op"] for r in prec if r["event"] == "op_batch"}
    dev = {r["op"] for r in prec if r["event"] == "op_span"
           and r["lane"] == "device"}
    assert ops == dev
    (qs,) = [r for r in prec if r["event"] == "query_start"]
    assert qs["env"]["backend"] == "cpu"
    assert set(qs["env"]) == {"backend", "device_kind", "device_count",
                              "torch_version", "host_cores"}


def _plan_analysis(recs):
    (r,) = [r for r in recs if r["event"] == "plan_analysis"]
    return {k: v for k, v in r.items() if k not in ("ts", "tid",
                                                    "query_id")}


@pytest.mark.parametrize("q,settings,parts", CASES)
def test_plan_analysis_event_is_the_references(q, settings, parts):
    """With the analyzer on in both packages, the ``plan_analysis``
    record of a query is the reference's, field for field."""
    host = {"spark.rapids.tpu.shuffle.mode": "host"}
    sessions = (JSession({**EVENTS_ON, **host, **settings}),
                PSession({**EVENTS_ON, **settings}, device="cpu"))
    got = []
    for m, sess in zip((REF, PORT), sessions):
        try:
            _query(m, sess, q, parts).collect()
            got.append(_plan_analysis(sess.events.records()))
        finally:
            sess.close()
    assert got[1] == got[0]
    assert got[1]["rows_by_op"] and got[1]["batches_by_op"]


def _serve_trace(serve, events, catalog, conf_cls):
    """Admission and queue records of one scheduler scenario: a blocker
    holds most of the budget, a second ticket queues until it releases,
    a third can never fit."""
    catalog.BufferCatalog.reset(conf_cls(
        {"spark.rapids.tpu.memory.hbm.budgetBytes": 1 << 20}))
    sched = serve.QueryScheduler.reset(conf_cls({}))
    logger = events.EventLogger(conf_cls(
        {"spark.rapids.tpu.eventLog.enabled": True}))
    events.install(logger)
    try:
        t1 = sched.acquire("session-a", 0, 900_000, "d1")
        got = []
        th = threading.Thread(
            target=lambda: got.append(sched.acquire("session-b", 0,
                                                    600_000, "d2")))
        th.start()
        for _ in range(200):
            if sched.stats()["waiting"]:
                break
            time.sleep(0.01)
        sched.release(t1)
        th.join(10)
        assert not th.is_alive()
        sched.release(got[0])
        with pytest.raises(serve.ServeAdmissionRejected):
            sched.acquire("session-c", 0, 2 << 20, "d3")
        sched.note_oom_requeue("session-b", "d2", 700_000)
    finally:
        events.uninstall()
    out = []
    for r in logger.records():
        if r["event"] == "admission":
            out.append(("admission", r["session"], r["digest"],
                        r["verdict"], r["forecast_bytes"], r["free_bytes"],
                        r["reason"], r["forecast_source"]))
        elif r["event"] == "queue":
            out.append(("queue", r["session"], r["op"], r["depth"]))
        elif r["event"] == "op_span":
            out.append(("op_span", r["op"], r["section"], r["lane"]))
        elif r["event"] == "oom_retry":
            out.append(("oom_retry", r["op"], r["kind"], r["watermark"]))
    return out


def test_serve_admission_and_queue_events_are_the_references():
    from spark_rapids_tpu import serve as JServe
    from spark_rapids_tpu_torch import serve as PServe

    want = _serve_trace(JServe, JEv, JC, JConf.RapidsConf)
    got = _serve_trace(PServe, PEv, PC, PConf.RapidsConf)
    assert got == want
    verdicts = [r[3] for r in got if r[0] == "admission"]
    assert verdicts == ["admit", "queue", "admit", "reject", "requeue"]
    assert [r[2] for r in got if r[0] == "queue"] == ["enqueue", "dequeue"]
    JServe.QueryScheduler.reset()
    PServe.QueryScheduler.reset()


def test_shuffle_events_balance():
    _, prec, _ = _run("agg", {"spark.rapids.tpu.sql.agg.strategy":
                              "SCATTER"}, 2, port=True)
    writes, fetches = Counter(), Counter()
    for r in prec:
        if r["event"] == "shuffle_write":
            writes[(r["shuffle_id"], r["reduce_id"])] += r["rows"]
        elif r["event"] == "shuffle_fetch":
            fetches[(r["shuffle_id"], r["reduce_id"])] += r["rows"]
    assert writes and +writes == +fetches
    # the partial aggregates' groups: each partition's distinct keys
    rows = _rows()
    halves = (rows[:1500], rows[1500:])
    assert sum(writes.values()) == sum(len({r[0] for r in h})
                                       for h in halves)


def test_trace_ranges_name_the_execs():
    """``sql.trace.enabled``: each hot section is a profiler range named
    ``<exec>.<section>``."""
    sess = PSession({"spark.rapids.tpu.sql.trace.enabled": True,
                     "spark.rapids.tpu.sql.join.strategy": "SEARCH"},
                    device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _query(PORT, sess, "join", 1).collect()
    names = {e.key for e in prof.key_averages()}
    assert "TpuShuffledHashJoinExec.probe" in names


# ---------------------------------------------------------------------------
# The off path
# ---------------------------------------------------------------------------
def _raise(*a, **k):
    raise AssertionError("reached an emitter with observability off")


def test_defaults_never_emit_arm_or_synchronize(monkeypatch):
    PEv.uninstall()
    PObs.shutdown()
    monkeypatch.setattr(PEv, "emit", _raise)
    monkeypatch.setattr(PEv.EventLogger, "emit", _raise)
    monkeypatch.setattr(PObs.MetricsRegistry, "inc", _raise)
    monkeypatch.setattr(PObs.MetricsRegistry, "set_gauge", _raise)
    monkeypatch.setattr(PB, "_obs_timed", _raise)
    monkeypatch.setattr(PB, "_op_scoped", _raise)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    from spark_rapids_tpu_torch.memory import ledger as PL

    monkeypatch.setattr(PL.Ledger, "note_alloc", _raise)
    for q, settings, parts in CASES:
        sess = PSession(settings, device="cpu")
        assert not sess.events.enabled and sess.obs_address is None
        assert _query(PORT, sess, q, parts).collect()
        assert sess.explain_metrics().splitlines()[-1].startswith("memory:")
    assert PObs.plane() is None and not PObs.enabled()
    assert not PC.BufferCatalog.get().ledger.armed()
    # op_timed is the plain timed context
    exec_ = PB.TpuExec(PConf.RapidsConf({}))
    ctx = exec_.op_timed("x")
    assert ctx.gen.gi_code is PB.timed.__wrapped__.__code__


def test_ledger_arms_with_events_and_balances():
    sess = PSession({**EVENTS_ON, "spark.rapids.tpu.sql.join.strategy":
                     "SEARCH"}, device="cpu")
    try:
        # the session installs its logger when it plans a query
        assert not PC.BufferCatalog.get().ledger.armed()
        _query(PORT, sess, "join", 1).collect()
        assert PC.BufferCatalog.get().ledger.armed()
        recs = sess.events.records()
    finally:
        sess.close()
    assert not PC.BufferCatalog.get().ledger.armed()
    live = {}
    for r in recs:
        if r["event"] == "buffer_alloc":
            live[r["bid"]] = r["bytes"]
            assert r["query_id"] is not None and r["site"]
        elif r["event"] == "buffer_free":
            live.pop(r["bid"])
    (snap,) = [r for r in recs if r["event"] == "heap_snapshot"]
    assert live and snap["live_bytes"] == sum(live.values())
    assert snap["leaked"] == 0
    assert set(snap["by_op"]) == {"TpuShuffledHashJoinExec"}
    assert sess.last_leaks == []


# ---------------------------------------------------------------------------
# The repo's profiler reads a port log
# ---------------------------------------------------------------------------
def test_tpu_profile_reads_a_port_log(tmp_path):
    log_dir = tmp_path / "events"
    sess = PSession({"spark.rapids.tpu.eventLog.dir": str(log_dir),
                     "spark.rapids.tpu.metrics.deviceSync.enabled": True},
                    device="cpu")
    try:
        _query(PORT, sess, "agg", 2).collect()
        _query(PORT, sess, "join", 1).collect()
    finally:
        sess.close()
    assert len(list(log_dir.glob("tpu-events-*.jsonl"))) == 1
    tool = ROOT / "tools" / "tpu_profile.py"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for args in ([], ["--alerts", "--stall-ms", "1"]):
        res = subprocess.run([sys.executable, str(tool), str(log_dir),
                              *args], capture_output=True, text=True,
                             timeout=120, env=env, cwd=str(ROOT))
        assert res.returncode == 0, res.stdout + res.stderr
        if not args:
            for op in ("TpuHashAggregateExec", "TpuShuffledHashJoinExec",
                       "TpuShuffleExchangeExec"):
                assert op in res.stdout
        else:
            assert "stall" in res.stdout
