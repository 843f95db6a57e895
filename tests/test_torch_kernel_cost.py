"""The port's cost plane (``kernel_cost.py``) and per-kernel attribution
(``kernel_summary.py``) against the reference's ``xla_cost.py`` and
``hlo.py``.

The same queries through both packages' sessions (the event log on):
each harvests its first call per (site, signature) once — one
``program_cost`` with the reference's fields and its ``hlo_summary``
twin — and a warm rerun harvests nothing in the port. With everything off
no CUDA event is made, no profiler started and nothing synchronized
(spies). Rows of known torch ops take the reference's class names, a
hand kernel's row its byte model, and ``tools/tpu_profile.py`` renders
both its ``== roofline ==`` and ``== hlo ==`` sections from a port log.
"""
import os
import subprocess
import sys

import pytest
import torch

from spark_rapids_tpu import events as JEv
from spark_rapids_tpu import types as JT
from spark_rapids_tpu import xla_cost as JX
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import conf as PConfMod
from spark_rapids_tpu_torch import events as PEv
from spark_rapids_tpu_torch import kernel_cost as KC
from spark_rapids_tpu_torch import kernel_summary as KS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = dict(T=JT, E=JE, A=JA)
PORT = dict(T=T, E=PE, A=PA)
EVENTS_ON = {"spark.rapids.tpu.eventLog.enabled": True}
REF_ONLY = {"spark.rapids.tpu.sql.analysis.enabled": False,
            "spark.rapids.tpu.shuffle.mode": "host"}


@pytest.fixture(autouse=True)
def _fresh():
    KC.reset_seen()
    yield
    KC.FORCE_HARVEST = False
    PEv.uninstall()
    JEv.uninstall()


def _agg(m, sess, seed=0):
    E, A, T_ = m["E"], m["A"], m["T"]
    sch = T_.StructType((T_.StructField("k", T_.INT),
                         T_.StructField("a", T_.LONG)))
    data = {"k": [(i * 7 + seed) % 13 for i in range(500)],
            "a": [None if i % 11 == 0 else i for i in range(500)]}
    return (sess.create_dataframe(data, sch)
            .where(E.GreaterThanOrEqual(E.col("a"), E.Literal.of(3)))
            .group_by("k")
            .agg(A.agg(A.Sum(E.col("a")), "s"),
                 A.agg(A.Count(E.col("a")), "c")))


def _join(m, sess):
    T_ = m["T"]
    ls = T_.StructType((T_.StructField("k", T_.INT),
                        T_.StructField("a", T_.LONG)))
    rs = T_.StructType((T_.StructField("k2", T_.INT),
                        T_.StructField("b", T_.LONG)))
    return sess.create_dataframe(
        {"k": [i % 19 for i in range(300)], "a": list(range(300))}, ls).join(
        sess.create_dataframe({"k2": list(range(10)),
                               "b": [i * 3 for i in range(10)]}, rs),
        on=[("k", "k2")], how="inner")


def _harvests(recs):
    return [r for r in recs if r["event"] == "program_cost"]


@pytest.mark.parametrize("query", [_agg, _join])
@pytest.mark.parametrize("strategy", [{}, {
    "spark.rapids.tpu.sql.agg.strategy": "SORT",
    "spark.rapids.tpu.sql.join.strategy": "SEARCH"}])
def test_one_harvest_per_site_and_none_when_warm(query, strategy):
    """The port harvests each (site, digest) once and nothing on a warm
    rerun; every port harvest has the reference's fields, its
    ``hlo_summary`` twin, its exec as ``op``, and a site the reference
    harvested too."""
    got = {}
    for name, m, sess in (
            ("ref", REF, JSession({**EVENTS_ON, **REF_ONLY, **strategy})),
            ("port", PORT, PSession({**EVENTS_ON, **strategy},
                                    device="cpu"))):
        try:
            first = sorted(query(m, sess).collect(), key=repr)
            n1 = len(sess.events.records())
            second = sorted(query(m, sess).collect(), key=repr)
            recs = sess.events.records()
            assert first == second
            got[name] = (first, recs[:n1], recs[n1:])
        finally:
            sess.close()
    assert got["port"][0] == got["ref"][0]
    # warm: nothing (the reference's session rebuilds some programs for
    # each plan's execs, so only its cold run is compared)
    assert not _harvests(got["port"][2])
    cold = got["port"][1]
    pcs = _harvests(cold)
    assert pcs
    keys = [(r["site"], r["digest"]) for r in pcs]
    assert len(keys) == len(set(keys))
    sums = [(r["site"], r["digest"]) for r in cold
            if r["event"] == "hlo_summary"]
    assert sorted(sums) == sorted(keys)
    need = set(PEv.EVENT_TYPES["program_cost"])
    for r in pcs:
        assert need <= set(r)
        assert set(r) - need - {"ts", "event", "tid"} <= set(
            JEv.EVENT_OPTIONAL_FIELDS["program_cost"])
        assert r["op"] and r["op"].startswith("Tpu")
        assert r["backend"] == "cpu"
        assert r["argument_bytes"] > 0 and r["bytes_accessed"] > 0
    ref_sites = {r["site"] for r in _harvests(got["ref"][1])}
    assert {s for s, _ in keys} <= ref_sites


def test_everything_off_touches_no_event_profiler_or_sync(monkeypatch):
    calls = []

    def spy(name):
        def f(*a, **k):
            calls.append(name)
            raise AssertionError(f"{name} touched with everything off")
        return f

    monkeypatch.setattr(torch.cuda, "Event", spy("cuda.Event"))
    monkeypatch.setattr(torch.cuda, "synchronize", spy("synchronize"))
    monkeypatch.setattr(torch.profiler, "profile", spy("profile"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        spy("record_function"))
    monkeypatch.setattr(KS, "summarize_profile", spy("summarize_profile"))
    sess = PSession({}, device="cpu")
    assert not KC.harvesting()
    seq = KC.snapshot()
    rows = _agg(PORT, sess).collect()
    assert rows and not calls
    assert KC.records_since(seq) == []
    assert KC.kernel_launch("bucket_sum", lambda: 1) is KC._NULL


def _harvest_of(work, site="agg_update"):
    KC.FORCE_HARVEST = True
    h = KC.begin(site, lambda: ("sig", site), [], "TestExec")
    with KC.harvested():
        out = h.run(work)
    rec = h.emit(out)
    return h.summary, rec


def test_row_classes_of_known_ops():
    x = torch.arange(4096, dtype=torch.int64)
    idx = torch.randint(0, 64, (4096,))

    def work():
        acc = torch.zeros(65, dtype=torch.int64).index_add_(0, idx, x)
        s, _ = torch.sort(x.flip(0))
        g = x.index_select(0, idx)
        v = x.view(64, 64)  # a view: no bytes
        acc2 = torch.zeros(65, dtype=torch.int64).scatter_reduce_(
            0, idx, x, "amax")
        c = torch.cumsum(x, 0)
        r = x.sum()
        with KC.kernel_launch("bucket_sum", lambda: 123_456):
            k = x + 1
        with KC.kernel_launch("ordered_segment_sum", lambda: 99):
            k2 = x * 2
        return acc, s, g, v, acc2, c, r, k, k2

    summary, rec = _harvest_of(work)
    classes = {}
    for row in summary["top_fusions"]:
        classes.setdefault(row["op"], row["class"])
    assert classes.get("aten::index_add_") == "scatter-add"
    assert classes.get("aten::sort") == "sort"
    assert classes.get("srt::bucket_sum") == "pallas"
    assert classes.get("srt::ordered_segment_sum") == "scatter-add"
    rows = {r["op"]: r for r in summary["top_fusions"]}
    assert rows["srt::bucket_sum"]["bytes"] == 123_456
    # the hand kernels keep their rows below the top-K
    assert "srt::ordered_segment_sum" in rows
    everything = {r["op"]: r for r in summary["kernel_rows"]}
    assert set(everything) == {"srt::bucket_sum", "srt::ordered_segment_sum"}
    assert summary["scatter_count"] >= 2
    assert KS.classify("aten::index_select") == "gather"
    assert KS.classify("aten::scatter_reduce_", (None, 0, None, "amax")) \
        == "scatter"
    assert KS.classify("aten::index_put_", (None, None, None, True)) \
        == "scatter-add"
    assert KS.classify("aten::cumsum") == "reduce-window"
    assert KS.classify("aten::sum") == "reduce"
    assert KS.classify("aten::mm") == "dot"
    assert KS.classify("aten::copy_") == "transpose/copy"
    assert rec["bytes_accessed"] == summary["total_bytes"]
    assert KS.op_cost("aten::view", [[4096], []], ["long int", "Scalar"]
                      )[:2] == (0, 0)
    b, out_b, _, ok = KS.op_cost("aten::index_select",
                                 [[4096], [], [100]],
                                 ["long int", "Scalar", "long int"])
    assert ok and out_b == 800 and b == 4096 * 8 + 800 + 800
    b, out_b, _, _ = KS.op_cost("aten::eq", [[10], [10]],
                                ["long int", "long int"])
    assert (b, out_b) == (170, 10)
    # a trace without dtypes: 8 bytes an element, counted as unparsed
    assert KS.op_cost("aten::mul", [[10], []], []) == (160, 80, 10.0, False)
    assert KS.op_cost("aten::mul", [[10], []], ["Int", "Scalar"])[:2] == (
        80, 40)


def test_a_running_profiler_never_fails_the_query():
    """A caller's own profiler session (chip_smoke's profile_plan): the
    harvest cannot start its own, records what it can, and the query
    gives its rows."""
    want = sorted(_agg(PORT, PSession({}, device="cpu")).collect())
    sess = PSession(EVENTS_ON, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rows = sorted(_agg(PORT, sess).collect())
    sess.close()
    assert rows == want
    assert _harvests(sess.events.records())


def test_peaks_have_one_source():
    assert KC.BACKEND_PEAKS["gpu"] == (
        PConfMod.DEVICE_PEAKS["cuda"], PConfMod.DEVICE_PEAK_TFLOPS["cuda"])
    assert KC.BACKEND_PEAKS["cpu"] == JX.BACKEND_PEAKS["cpu"]
    KC.set_conf_peaks(PConfMod.RapidsConf(
        {"spark.rapids.tpu.roofline.peakHbmGBps": 2000.0}))
    try:
        assert KC.peaks("gpu") == (2000.0,
                                   PConfMod.DEVICE_PEAK_TFLOPS["cuda"])
    finally:
        KC.set_conf_peaks(PConfMod.RapidsConf({}))
    assert KC.peaks("gpu") == KC.BACKEND_PEAKS["gpu"]


def test_tpu_profile_renders_a_port_log(tmp_path):
    logs = tmp_path / "logs"
    sess = PSession({"spark.rapids.tpu.eventLog.dir": str(logs),
                     "spark.rapids.tpu.metrics.deviceSync.enabled": True},
                    device="cpu")
    try:
        _agg(PORT, sess).collect()
        _join(PORT, sess).collect()
    finally:
        sess.close()
    res = subprocess.run([sys.executable,
                          os.path.join(ROOT, "tools", "tpu_profile.py"),
                          str(logs)], capture_output=True, text=True,
                         timeout=120)
    text = res.stdout
    roof = text.split("== roofline ==", 1)[1].split("\n==", 1)[0]
    hlo = text.split("== hlo ==", 1)[1].split("\n==", 1)[0]
    assert "no program_cost events" not in roof
    assert "no hlo_summary events" not in hlo
    for site in ("agg_update", "join"):
        assert f"site={site} " in roof or f"site=agg_plan " in roof
        assert f"site={site} " in hlo or f"site=agg_plan " in hlo
    assert "achieved[" in roof
    assert "accounts for" in hlo
