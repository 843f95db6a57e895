"""The port's serving path (``serve/scheduler.py``, ``serve/plan_cache.py``,
the catalog's reservations, the scan's host prefetch and the session's
serve route) against the reference's, scenario for scenario
(``tests/test_serve.py:83-737``).

Each scheduler scenario runs on BOTH packages' ``QueryScheduler`` with
the same budget, forecasts and submit order: the verdicts (admit, queue,
reject, bypass, timeout), the admit order and ``stats()`` must be equal.
The session-level tests hold the port's rows to the reference's session
(the concurrent stress runs several port sessions on threads against the
reference's rows of the same queries). Every threaded test joins its
threads with a timeout and fails, rather than hangs, when one is still
alive.

Not carried over: the reference's two compile-cache race tests
(``test_serve.py:587``, ``:613``): eager PyTorch compiles no programs, so
the port has no pipeline cache or compile counter to race. Also here: the
kernel modules' launch counters stay exact when 8 threads add to them at
once.
"""
import importlib.util
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest

import spark_rapids_tpu.conf as JC
import spark_rapids_tpu.events as JEV
import spark_rapids_tpu.obs as JObs
import spark_rapids_tpu.serve as JServe
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.memory.catalog import BufferCatalog as JCatalog
from spark_rapids_tpu.memory.semaphore import TpuSemaphore as JSem
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import conf as PC
from spark_rapids_tpu_torch import events as PEV
from spark_rapids_tpu_torch import obs as PObs
from spark_rapids_tpu_torch import serve as PServe
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.memory.catalog import BufferCatalog as PCatalog
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore as PSem
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = types.SimpleNamespace(
    Conf=JC.RapidsConf, Catalog=JCatalog, Sched=JServe.QueryScheduler,
    Cache=JServe.SharedPlanCache, Rejected=JServe.ServeAdmissionRejected,
    Timeout=JServe.ServeQueueTimeout, E=JE, A=JA,
    session=lambda settings: JSession(settings))
PORT = types.SimpleNamespace(
    Conf=PC.RapidsConf, Catalog=PCatalog, Sched=PServe.QueryScheduler,
    Cache=PServe.SharedPlanCache, Rejected=PServe.ServeAdmissionRejected,
    Timeout=PServe.ServeQueueTimeout, E=PE, A=PA,
    session=lambda settings: PSession(settings, device="cpu"))
BUDGET = {"spark.rapids.tpu.memory.hbm.budgetBytes": 1 << 20}


def _reset_all():
    for P, sem, ev, ob in ((REF, JSem, JEV, JObs), (PORT, PSem, PEV, PObs)):
        P.Sched.reset()
        P.Cache.reset()
        P.Catalog.reset()
        sem.reset()
        ev.uninstall()
        ob.shutdown()


@pytest.fixture(autouse=True)
def clean_serving_state():
    """Every test starts and ends with fresh process-global serving state
    in both packages."""
    _reset_all()
    yield
    _reset_all()


def _join(threads, timeout=60):
    for t in threads:
        t.join(timeout)
    alive = [t.name for t in threads if t.is_alive()]
    assert not alive, f"threads still running: {alive}"


def _until_waiting(sched, n: int, timeout: float = 10.0) -> None:
    """Block until ``n`` tickets wait in ``sched`` (a thread's submit has
    reached the queue), failing past ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while sched.stats()["waiting"] < n:
        assert time.monotonic() < deadline, sched.stats()
        time.sleep(0.005)


def _sched(P, settings=None, catalog=BUDGET):
    P.Catalog.reset(P.Conf(catalog))
    return P.Sched.reset(P.Conf(settings or {}))


def both(scenario):
    """(reference outcome, port outcome) of ``scenario(P)``."""
    return scenario(REF), scenario(PORT)


def _query_df(P, sess, mult: int, n: int = 2048):
    """A statically bounded plan (range -> filter -> project -> COMPLETE
    aggregate) whose result depends on ``mult``."""
    E, A = P.E, P.A
    return (sess.range(0, n)
            .where(E.GreaterThanOrEqual(E.col("id"), E.lit(100)))
            .select(E.col("id"),
                    E.Alias(E.Multiply(E.col("id"), E.lit(mult)), "v"))
            .agg(A.agg(A.Sum(E.col("v")), "s"), A.agg(A.Count(None), "c")))


def _forecast_of(P, settings=None) -> int:
    sess = P.session(dict(settings or {},
                          **{"spark.rapids.tpu.serve.enabled": True}))
    _query_df(P, sess, 2).collect()
    an = sess.last_analysis
    assert an is not None and an.bounded and an.peak_hbm
    return an.peak_hbm


# ---------------------------------------------------------------------------
# admission verdicts
# ---------------------------------------------------------------------------
def test_admission_rejects_plan_that_can_never_fit():
    def scenario(P):
        sched = _sched(P)
        with pytest.raises(P.Rejected) as ei:
            sched.acquire("session-a", 0, 10 << 20, "d1")
        assert "exceeds the total HBM budget" in str(ei.value)
        assert P.Catalog.get().reserved_bytes == 0
        return str(ei.value), sched.stats()

    ref, port = both(scenario)
    assert port == ref and port[1]["rejected"] == 1


def test_admission_reserves_and_queues_until_release():
    def scenario(P):
        sched = _sched(P)
        t1 = sched.acquire("session-a", 0, 700_000, "d1")
        assert P.Catalog.get().reserved_bytes == 700_000
        got = []
        th = threading.Thread(target=lambda: got.append(
            sched.acquire("session-b", 0, 700_000, "d2")))
        th.start()
        _until_waiting(sched, 1)
        waiting = (list(got), sched.stats()["waiting"],
                   [q["reason"] for q in sched.queue_status()])
        sched.release(t1)
        _join([th], 5)
        out = (t1.verdict, waiting, got[0].verdict,
               P.Catalog.get().reserved_bytes)
        sched.release(got[0])
        return out, P.Catalog.get().reserved_bytes, sched.stats()

    ref, port = both(scenario)
    assert port == ref
    (v1, (got, waiting, _), v2, reserved), after, st = port
    assert (v1, got, waiting, v2, reserved, after) == (
        "admit", [], 1, "admit", 700_000, 0)
    assert st["peak_inflight_forecast"] <= 1 << 20


def test_bypass_admission_when_nothing_running():
    def scenario(P):
        sched = _sched(P)
        P.Catalog.get()._device_bytes = 2 << 20  # resident cache pressure
        t = sched.acquire("session-a", 0, 500_000, "d1")
        out = (t.verdict, t.bypass, t.reason, sched.stats())
        sched.release(t)
        P.Catalog.get()._device_bytes = 0
        return out

    ref, port = both(scenario)
    assert port == ref and port[1] and port[3]["bypass_admissions"] == 1


def test_unbounded_plan_admits_with_zero_reservation():
    def scenario(P):
        sched = _sched(P)
        t = sched.acquire("session-a", 0, None, "d1")
        out = (t.verdict, P.Catalog.get().reserved_bytes, t.reason)
        sched.release(t)
        return out

    ref, port = both(scenario)
    assert port == ref and port[:2] == ("admit", 0)


def test_max_queue_depth_rejects_with_named_error():
    def scenario(P):
        sched = _sched(P, {"spark.rapids.tpu.serve.maxQueueDepth": 1})
        t1 = sched.acquire("session-a", 0, 900_000, "d1")
        waiter = threading.Thread(target=lambda: sched.release(
            sched.acquire("session-a", 0, 900_000, "d2")))
        waiter.start()
        _until_waiting(sched, 1)  # d2 is now queued at depth 1
        with pytest.raises(P.Rejected) as ei:
            sched.acquire("session-a", 0, 900_000, "d3")
        sched.release(t1)
        _join([waiter], 5)
        return str(ei.value), sched.stats()

    ref, port = both(scenario)
    assert port == ref and "maxQueueDepth" in port[0]


def test_queue_timeout_raises_named_error():
    def scenario(P):
        sched = _sched(P, {"spark.rapids.tpu.serve.queueTimeoutMs": 200})
        t1 = sched.acquire("session-a", 0, 900_000, "d1")
        with pytest.raises(P.Timeout) as ei:
            sched.acquire("session-b", 0, 900_000, "d2")
        sched.release(t1)
        return str(ei.value), sched.stats(), P.Catalog.get().reserved_bytes

    ref, port = both(scenario)
    assert port == ref and "queueTimeoutMs" in port[0]
    assert port[1]["timeouts"] == 1 and port[2] == 0


def test_timeout_pumps_the_successor_head():
    """queue [big, small] in one session while another holds the budget:
    big's timeout PUMPS the queue so small, which fits, admits at once —
    not at the next unrelated release."""
    def scenario(P):
        sched = _sched(P)
        t1 = sched.acquire("sess-a", 0, 900_000, "hold")
        events = []

        def big():
            try:
                sched.acquire("sess-b", 0, 800_000, "big", conf_=P.Conf(
                    {"spark.rapids.tpu.serve.queueTimeoutMs": 300}))
            except P.Timeout:
                events.append("big-timeout")

        def small():
            t = sched.acquire("sess-b", 0, 50_000, "small")
            events.append("small-admitted")
            sched.release(t)

        tb = threading.Thread(target=big)
        tb.start()
        _until_waiting(sched, 1)
        ts = threading.Thread(target=small)
        ts.start()
        _join([tb], 5)
        _join([ts], 2)  # must NOT need t1's release to proceed
        sched.release(t1)
        return events, sched.stats()

    ref, port = both(scenario)
    assert port == ref and port[0] == ["big-timeout", "small-admitted"]


def test_large_head_is_not_starved_by_later_small_queries():
    """The anti-starvation barrier: a later small query of the same
    priority does not backfill past a blocked large head; on release the
    large head admits FIRST."""
    def scenario(P):
        sched = _sched(P)
        t1 = sched.acquire("sess-a", 0, 900_000, "hold")
        tickets = {}
        lock = threading.Lock()

        def run(sess, forecast, tag):
            t = sched.acquire(sess, 0, forecast, tag)
            with lock:
                tickets[tag] = t
            time.sleep(0.01)
            sched.release(t)

        tb = threading.Thread(target=run, args=("sess-b", 800_000, "big"))
        tb.start()
        _until_waiting(sched, 1)
        tsm = threading.Thread(target=run,
                               args=("sess-c", 50_000, "small"))
        tsm.start()
        _until_waiting(sched, 2)  # small fits, but queues behind big
        held_back = dict(tickets)
        sched.release(t1)
        _join([tb, tsm], 5)
        order = sorted(tickets, key=lambda k: tickets[k].admit_ns)
        return held_back, order, sched.stats()

    ref, port = both(scenario)
    assert port == ref and port[0] == {} and port[1] == ["big", "small"]


def test_rejected_query_closes_its_event_window():
    def scenario(P):
        settings = {"spark.rapids.tpu.serve.enabled": True,
                    "spark.rapids.tpu.memory.hbm.budgetBytes": 60_000,
                    "spark.rapids.tpu.eventLog.enabled": True}
        P.Catalog.reset(P.Conf(settings))
        P.Sched.reset(P.Conf(settings))
        sess = P.session(settings)
        try:
            with pytest.raises(P.Rejected):
                _query_df(P, sess, 2, n=1 << 16).collect()
            recs = sess.events.records()
        finally:
            sess.close()
        starts = [r for r in recs if r["event"] == "query_start"]
        ends = [r for r in recs if r["event"] == "query_end"]
        adm = [(r["verdict"], r["forecast_bytes"], r["reason"],
                r["forecast_source"])
               for r in recs if r["event"] == "admission"]
        return (len(starts), len(ends), ends[0]["error"], adm,
                P.Sched.instance().stats(), P.Catalog.get().reserved_bytes)

    ref, port = both(scenario)
    assert port == ref
    assert port[:3] == (1, 1, True) and port[3][-1][0] == "reject"
    assert port[5] == 0 and port[4]["active"] == port[4]["waiting"] == 0


# ---------------------------------------------------------------------------
# fairness: round-robin across sessions, priority tiers
# ---------------------------------------------------------------------------
def _drain_order(P, submits):
    """Submit (session, priority, tag) tickets from threads while a
    blocker holds the whole budget; release it and record admit order."""
    sched = _sched(P)
    order = []
    lock = threading.Lock()

    def run(sess, prio, tag):
        t = sched.acquire(sess, prio, 900_000, tag)
        with lock:
            order.append(tag)
        time.sleep(0.01)
        sched.release(t)

    blocker = sched.acquire("blocker", 0, 900_000, "b0")
    threads = []
    for sess, prio, tag in submits:
        th = threading.Thread(target=run, args=(sess, prio, tag))
        th.start()
        threads.append(th)
        _until_waiting(sched, len(threads))  # deterministic enqueue order
    queue = [(q["session"], q["position"], q["priority"])
             for q in sched.queue_status()]
    sched.release(blocker)
    _join(threads, 10)
    return order, queue


def test_round_robin_alternates_sessions():
    subs = [("sess-a", 0, "a1"), ("sess-a", 0, "a2"),
            ("sess-b", 0, "b1"), ("sess-b", 0, "b2")]
    ref, port = both(lambda P: _drain_order(P, subs))
    assert port == ref
    order = port[0]
    assert order.index("a1") < order.index("a2")
    assert order.index("b1") < order.index("b2")
    assert order != ["a1", "a2", "b1", "b2"]


def test_priority_session_drains_first():
    subs = [("sess-lo", 0, "lo1"), ("sess-lo", 0, "lo2"),
            ("sess-hi", 5, "hi1"), ("sess-hi", 5, "hi2")]
    ref, port = both(lambda P: _drain_order(P, subs))
    assert port == ref
    order = port[0]
    assert max(order.index("hi1"), order.index("hi2")) < order.index("lo2")


# ---------------------------------------------------------------------------
# the shared plan cache
# ---------------------------------------------------------------------------
def test_plan_cache_shares_analysis_across_sessions():
    settings = {"spark.rapids.tpu.serve.enabled": True}
    s1, s2 = PORT.session(settings), PORT.session(settings)
    r1 = _query_df(PORT, s1, 3).collect()
    r2 = _query_df(PORT, s2, 3).collect()
    assert r1 == r2 == _query_df(REF, REF.session({}), 3).collect()
    assert s1.last_analysis is s2.last_analysis  # one analysis, shared
    st = PORT.Cache.get().stats()
    assert st["misses"] == 1 and st["hits"] >= 1 and st["warm"] == 1


def test_plan_cache_keys_on_conf_fingerprint():
    s1 = PORT.session({"spark.rapids.tpu.serve.enabled": True})
    s2 = PORT.session({"spark.rapids.tpu.serve.enabled": True,
                       "spark.rapids.tpu.sql.shapeBucket.minRows": 256})
    _query_df(PORT, s1, 3).collect()
    _query_df(PORT, s2, 3).collect()
    assert PORT.Cache.get().stats()["misses"] == 2
    assert PServe.conf_fingerprint(s1.conf) != PServe.conf_fingerprint(
        s2.conf)


def test_plan_cache_single_flight_under_race():
    cache = PORT.Cache.get()
    computes = []

    def compute():
        computes.append(1)
        time.sleep(0.1)
        return "analysis"

    results = []
    ths = [threading.Thread(
        target=lambda: results.append(cache.analysis_for(("k",), compute)))
        for _ in range(8)]
    for t in ths:
        t.start()
    _join(ths, 10)
    assert len(computes) == 1  # one flight, seven waiters
    assert all(r[0] == "analysis" for r in results)
    assert sum(1 for r in results if not r[1]) == 1


def test_plan_cache_failed_flight_does_not_wedge_waiters():
    cache = PORT.Cache.get()
    with pytest.raises(ValueError):
        cache.analysis_for(("bad",), lambda: (_ for _ in ()).throw(
            ValueError("boom")))
    assert cache.analysis_for(("bad",), lambda: 7) == (7, False)


# ---------------------------------------------------------------------------
# several sessions on threads under a tiny budget
# ---------------------------------------------------------------------------
def test_stress_concurrent_sessions_tiny_budget(tmp_path):
    n_threads, n_queries = 4, 6
    forecast = _forecast_of(PORT)
    assert forecast == _forecast_of(REF)
    # room for about two admitted forecasts: real queueing under four
    # threads, but every plan fits (no bypass, no rejects)
    budget = int(2.5 * forecast)
    settings = {"spark.rapids.tpu.serve.enabled": True,
                "spark.rapids.tpu.memory.hbm.budgetBytes": budget,
                "spark.rapids.tpu.eventLog.dir": str(tmp_path)}
    PORT.Catalog.reset(PORT.Conf(settings), "cpu")
    PORT.Sched.reset(PORT.Conf(settings))

    def mult(ti, qi):
        return 2 + (ti * n_queries + qi) % 5

    rsess = REF.session({})
    want = {m: _query_df(REF, rsess, m).collect() for m in range(2, 7)}
    results, errors = {}, []
    lock = threading.Lock()
    # closed once every thread is done: a session's close() detaches the
    # process-wide event sink, and the scheduler emits other sessions'
    # admissions into whichever session's log is active
    sessions = [PORT.session(settings) for _ in range(n_threads)]

    def worker(ti):
        try:
            for qi in range(n_queries):
                rows = _query_df(PORT, sessions[ti], mult(ti, qi)).collect()
                with lock:
                    results[(ti, qi)] = rows
        except Exception as e:  # the failure mode, reported below
            with lock:
                errors.append((ti, repr(e)))

    threads = [threading.Thread(target=worker, args=(ti,),
                                name=f"stress-{ti}")
               for ti in range(n_threads)]
    try:
        for t in threads:
            t.start()
        _join(threads, 120)
    finally:
        for sess in sessions:
            sess.close()
    assert not errors, errors
    assert len(results) == n_threads * n_queries
    for (ti, qi), rows in results.items():
        assert rows == want[mult(ti, qi)], (ti, qi)

    st = PORT.Sched.instance().stats()
    assert st["admitted"] == n_threads * n_queries
    assert st["rejected"] == st["timeouts"] == st["bypass_admissions"] == 0
    assert st["active"] == st["waiting"] == 0
    assert st["peak_inflight_forecast"] <= budget
    assert st["queued"] > 0
    assert PORT.Catalog.get().reserved_bytes == 0

    tpu_profile = _tool("tpu_profile")
    events = tpu_profile.load_events([str(tmp_path)])
    adm = [r for r in events if r.get("event") == "admission"]
    assert sum(r["verdict"] == "admit" for r in adm) == n_threads * n_queries
    assert not any(r["verdict"] == "reject" for r in adm)
    # the first run of the digest forecasts from the analyzer; once the
    # ledger has seen it complete, later admissions charge its peak
    assert {r["forecast_source"] for r in adm} <= {"analyzer", "ledger"}
    enq = sum(1 for r in events if r.get("event") == "queue"
              and r["op"] == "enqueue")
    deq = sum(1 for r in events if r.get("event") == "queue"
              and r["op"] == "dequeue")
    assert enq == deq == st["queued"]
    report, violations = tpu_profile.build_report(events)
    assert violations == 0, report
    assert "== serving ==" in report and "admit=" in report
    trace = PEV.chrome_trace(events)
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e.get("ph") == "M"}
    assert any(t.startswith("serve session-") for t in tracks), tracks


def test_concurrent_execution_overlaps():
    """With headroom for several forecasts, admitted queries run side by
    side: every session's queries run to the end while another ticket
    (held here, so the overlap does not hang on thread timing) stays
    admitted, and each result is right."""
    forecast = _forecast_of(PORT)
    settings = {"spark.rapids.tpu.serve.enabled": True,
                "spark.rapids.tpu.memory.hbm.budgetBytes": 8 * forecast}
    PORT.Catalog.reset(PORT.Conf(settings), "cpu")
    sched = PORT.Sched.reset(PORT.Conf(settings))
    hold = sched.acquire("holder", 0, forecast, "hold")
    errors = []

    def worker(ti):
        try:
            s = PORT.session(settings)
            for qi in range(3):
                rows = _query_df(PORT, s, 2 + (ti * 3 + qi) % 5,
                                 n=4096).collect()
                assert rows[0][1] == 3996
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(ti,))
               for ti in range(4)]
    try:
        for t in threads:
            t.start()
        _join(threads, 120)
    finally:
        sched.release(hold)
    assert not errors, errors
    st = sched.stats()
    assert st["admitted"] == 13 and st["peak_active"] >= 2
    assert st["rejected"] == st["bypass_admissions"] == 0


def test_ledger_peak_replaces_the_forecast_after_a_run():
    """The measured-stats loop: with the ledger armed, the first run of a
    digest is admitted on the analyzer's forecast and a repeat on the
    observed peak the sweep folded in."""
    from spark_rapids_tpu_torch.memory import ledger

    settings = {"spark.rapids.tpu.serve.enabled": True,
                "spark.rapids.tpu.eventLog.enabled": True,
                "spark.rapids.tpu.sql.join.strategy": "SEARCH"}
    PORT.Catalog.reset(PORT.Conf(settings), "cpu")
    sess = PORT.session(settings)
    E, A = PE, PA
    dim = sess.range(0, 50).select(E.Alias(E.col("id"), "dk"))
    df = (sess.range(0, 3000).join(dim, [("id", "dk")])
          .agg(A.agg(A.Count(None), "c")))
    try:
        ledger.force_arm(True)
        assert df.collect() == df.collect() == [(50,)]
        recs = [r for r in sess.events.records()
                if r["event"] == "admission"]
    finally:
        ledger.force_arm(False)
        sess.close()
    digest = recs[0]["digest"]
    peak = PORT.Catalog.get().ledger.observed_peak(digest)
    assert peak  # the join's build planes, registered in the catalog
    assert [r["forecast_source"] for r in recs] == ["analyzer", "ledger"]
    assert recs[1]["forecast_bytes"] == peak


def test_catalog_is_not_replaced_under_live_tickets():
    """A session with other memory confs cannot replace the process's
    catalog while a ticket is admitted or waiting: the new catalog would
    drop the running queries' reservations and the next admission would
    see the whole budget as free. The admissions stay within the budget,
    and once every ticket is gone the session gets its own catalog."""
    from spark_rapids_tpu_torch.memory.catalog import CatalogInUseError

    other = {"spark.rapids.tpu.memory.hbm.budgetBytes": 8 << 20}
    sched = _sched(PORT)
    cat = PORT.Catalog.get()
    t0 = sched.acquire("session-c", 0, None, "d0")  # reserves nothing
    with pytest.raises(CatalogInUseError):
        PORT.session(other)
    sched.release(t0)
    t1 = sched.acquire("session-a", 0, 700_000, "d1")
    with pytest.raises(CatalogInUseError) as ei:
        PORT.session(other)
    assert "700000 bytes are reserved" in str(ei.value)
    assert PORT.Catalog.get() is cat and cat.reserved_bytes == 700_000
    got = []
    th = threading.Thread(target=lambda: got.append(
        sched.acquire("session-b", 0, 700_000, "d2")))
    th.start()
    _until_waiting(sched, 1)
    assert [q["digest"] for q in sched.queue_status()] == ["d2"]
    sched.release(t1)
    _join([th], 5)
    sched.release(got[0])
    st = sched.stats()
    assert (st["admitted"], st["queued"], st["bypass_admissions"]) == (
        3, 1, 0)
    assert st["peak_inflight_forecast"] <= 1 << 20
    assert cat.reserved_bytes == 0
    PORT.session(other).close()
    assert PORT.Catalog.get() is not cat
    assert PORT.Catalog.get().budget == 8 << 20


# ---------------------------------------------------------------------------
# /status + tools/tpu_top.py surface the queue
# ---------------------------------------------------------------------------
def test_status_and_tpu_top_show_queue():
    from spark_rapids_tpu_torch.obs.progress import ProgressTracker
    from spark_rapids_tpu_torch.obs.registry import MetricsRegistry
    from spark_rapids_tpu_torch.obs.server import build_status

    PORT.Sched._instance = None  # a process that never served
    assert build_status(MetricsRegistry(), ProgressTracker(),
                        None)["serve"] is None
    assert PORT.Sched.instance() is None  # peeked, never conjured
    sched = _sched(PORT)
    t1 = sched.acquire("session-9", 0, 900_000, "dead99beef99")
    waiter = threading.Thread(target=lambda: sched.release(
        sched.acquire("session-7", 1, 800_000, "feed77face77")))
    waiter.start()
    _until_waiting(sched, 1)
    try:
        status = build_status(MetricsRegistry(), ProgressTracker(), None)
        json.dumps(status)
        serve = status["serve"]
        assert serve["stats"]["active"] == 1
        assert serve["stats"]["waiting"] == 1
        q = serve["queue"][0]
        assert q["session"] == "session-7" and q["position"] == 0
        assert "queued" in q["reason"]
        assert serve["active"][0]["session"] == "session-9"
        assert status["hbm"]["reserved_bytes"] == 900_000
        assert status["program_cache"] is None
        frame = _tool("tpu_top").render_status(status)
        assert "session-7" in frame and "session-9" in frame
        assert "queued" in frame
    finally:
        sched.release(t1)
        _join([waiter], 5)


# ---------------------------------------------------------------------------
# the scan caches under races
# ---------------------------------------------------------------------------
def test_scanner_cache_single_instance_under_race(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.sql import session as S

    path = os.path.join(str(tmp_path), "t.parquet")
    pq.write_table(pa.table({"k": pa.array(np.arange(64, dtype="int64"))}),
                   path)
    conf = PC.RapidsConf({})
    S._SCANNER_CACHE.clear()
    got = []
    barrier = threading.Barrier(8)

    def race():
        barrier.wait()
        got.append(S._make_scanner("parquet", path, (("columns", None),),
                                   conf))

    ths = [threading.Thread(target=race) for _ in range(8)]
    for t in ths:
        t.start()
    _join(ths, 10)
    assert len(got) == 8 and all(sc is got[0] for sc in got)


def test_scan_cache_accounting_consistent_under_race():
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache

    cache = DeviceScanCache(max_bytes=10_000)
    barrier = threading.Barrier(8)

    def race(i):
        barrier.wait()
        for j in range(50):
            key = ("p", i, j % 7)
            cache.get(key)
            cache.put(key, object(), 100 * (1 + j % 3))

    ths = [threading.Thread(target=race, args=(i,)) for i in range(8)]
    for t in ths:
        t.start()
    _join(ths, 10)
    st = cache.stats()
    with cache._lock:
        real = sum(sz for (_, sz) in cache._entries.values())
    assert st["bytes"] == real and st["bytes"] <= st["max_bytes"]


# ---------------------------------------------------------------------------
# pipelined execution: host prefetch before the drain
# ---------------------------------------------------------------------------
def _write_kv(tmp_path, n=20_000, rg=4096):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(7)
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 16, n).astype("int32")),
        "v": pa.array(rng.integers(0, 1000, n).astype("int64"))}),
        os.path.join(str(tmp_path), "t.parquet"), row_group_size=rg)
    return str(tmp_path)


def test_serve_parquet_prefetch_matches_oracle(tmp_path):
    path = _write_kv(tmp_path)

    def q(P, sess):
        return sorted(sess.read.parquet(path).group_by("k").agg(
            P.A.agg(P.A.Sum(P.E.col("v")), "sv")).collect())

    want = q(REF, REF.session({}))
    served = PORT.session({"spark.rapids.tpu.serve.enabled": True,
                           "spark.rapids.tpu.sql.stageFusion": "OFF"})
    assert q(PORT, served) == want
    assert q(PORT, PORT.session({"spark.rapids.tpu.serve.enabled": True,
                                 "spark.rapids.tpu.sql.stageFusion": "ON"})
             ) == want


def test_host_prefetch_runs_on_prefetch_pool(tmp_path):
    from spark_rapids_tpu_torch.exec.scan import TpuFileSourceScanExec
    from spark_rapids_tpu_torch.sql.session import _make_scanner

    path = _write_kv(tmp_path, n=4096, rg=1024)
    conf = PC.RapidsConf({})
    scan = TpuFileSourceScanExec(
        conf, _make_scanner("parquet", path, (("columns", None),), conf),
        "parquet", device="cpu")
    names = []
    real = scan.scanner.read_split_device

    def spy(*a, **k):
        names.append(threading.current_thread().name)
        return real(*a, **k)

    scan.scanner.read_split_device = spy
    scan.host_prefetch()
    assert scan._prefetch_dev is not None
    rows = sum(b.num_rows for b in scan.execute_columnar())
    assert rows == 4096
    assert names and all(n.startswith("srt-prefetch") for n in names)
    assert all(f is None for f in scan._prefetch_dev)  # consumed once
    scan.invalidate_prefetch()
    assert scan._prefetch_dev is None and scan._prefetch is None


def test_fused_stage_aggregate_skips_the_prefetch(tmp_path):
    """A fused scan->aggregate stage reads staged decodes, never the
    scan's batches: its prefetch starts nothing."""
    from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec

    path = _write_kv(tmp_path, n=4096, rg=1024)
    sess = PORT.session({"spark.rapids.tpu.sql.stageFusion": "ON"})
    df = sess.read.parquet(path).group_by("k").agg(
        PA.agg(PA.Sum(PE.col("v")), "sv"))
    df.collect()
    agg = sess.last_executed_plan.tpu_child
    assert isinstance(agg, TpuHashAggregateExec)
    scan = agg.children[0]
    scan._consumed_splits.clear()
    agg.host_prefetch()
    assert scan._prefetch_dev is None and scan._prefetch is None


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("module", ("groupby_kernels", "join_kernels",
                                    "radix_kernels", "regex_kernels",
                                    "udf_kernels"))
def test_launch_counters_exact_under_threads(module):
    import importlib

    mod = importlib.import_module(f"spark_rapids_tpu_torch.ops.{module}")
    name = next(iter(mod.LAUNCHES))
    saved = dict(mod.LAUNCHES)
    mod.reset_launches()
    barrier = threading.Barrier(8)

    def bump():
        barrier.wait()
        for _ in range(10_000):
            mod.count_launch(name)

    ths = [threading.Thread(target=bump) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as it can
    try:
        for t in ths:
            t.start()
        _join(ths, 60)
        assert mod.LAUNCHES[name] == 80_000
    finally:
        sys.setswitchinterval(interval)
        mod.LAUNCHES.update(saved)
