"""The port's static plan analyzer (``plugin/plananalysis.py``) against
the reference's, plan for plan.

Both packages lower the same DataFrame queries over the same seeded rows
(``from_rows``, ``range``, a parquet file written with pyarrow) to their
CPU physical plans, and both analyzers run over them: the report text
(``render()``), the ``plan_analysis`` payload (``event_fields()``), the
peak, the per-op bytes, rows and batches, and every operator's
per-column nullability must be equal. The port analyzes for the CPU
device, where its strategy choosers and fusion gates resolve as the
reference's CPU backend does; AUTO's reason texts differ between the
packages, so the grouped plans force their strategy.

Also here: ``utils/bucketing.bucket_rows`` (the runtime's
``columnar/column.choose_capacity``) against the reference's; the mesh forecast
(``forecast_mesh``) of a 4-shard aggregate against the reference's, and
``cross_check_mesh`` after the run; and the cross-check invariants that
port (the reference's harness, ``tests/harness.py:131``): 2. every
operator's measured ``bytesTouched`` is within the analyzer's byte bound
on a bounded plan, and 3. a run with validity planes elided equals the
mask-carrying run.
"""
import os

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr import windows as JW
from spark_rapids_tpu.plugin import plananalysis as JPA
from spark_rapids_tpu.sql import session as JS
from spark_rapids_tpu.utils.bucketing import bucket_rows as ref_bucket_rows
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import choose_capacity
from spark_rapids_tpu_torch.exec.base import BYTES_TOUCHED, TpuExec
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.expr import windows as PW
from spark_rapids_tpu_torch.parallel import mesh as PM
from spark_rapids_tpu_torch.plugin import plananalysis as PPA
from spark_rapids_tpu_torch.sql import session as PS
from spark_rapids_tpu_torch.utils import bucket_rows

REF = dict(T=JT, E=JE, A=JA, W=JW, S=JS, PA=JPA)
PORT = dict(T=T, E=PE, A=PA, W=PW, S=PS, PA=PPA)

SCATTER = {"spark.rapids.tpu.sql.agg.strategy": "SCATTER"}


def _rows(n=300, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 7))
        x = int(rng.integers(-1000, 1000)) if rng.random() > 0.1 else None
        d = round(float(rng.uniform(0, 50)), 3) if rng.random() > 0.2 \
            else None
        s = ["ab", "", "xyz", None, "hello"][i % 5]
        out.append((k, x, d, s))
    return out


def _schema(m):
    T_ = m["T"]
    return T_.StructType((T_.StructField("k", T_.INT, False),
                          T_.StructField("x", T_.LONG),
                          T_.StructField("d", T_.DOUBLE),
                          T_.StructField("s", T_.STRING)))


def _df(m, sess, parts=1, n=300):
    return sess.from_rows(_rows(n), _schema(m), num_partitions=parts)


def _col(m, name):
    return m["E"].col(name)


def comparable_explain(text: str) -> str:
    """``explain()`` text with the reason of each AUTO strategy note cut
    after the chosen strategy: the port's choosers resolve AUTO by their
    own rules for the card and give their own reasons (a forced strategy's
    reason is compared whole). The session tests compare the port's whole
    ``explain()`` to the reference's through this."""
    out = []
    for ln in text.splitlines():
        cut = ln.find(" — AUTO")
        if "strategy: " in ln and cut >= 0:
            ln = ln[:cut]
        out.append(ln)
    return "\n".join(out)


# -- the plans ----------------------------------------------------------------
def q_scan_filter_project_agg(m, sess, pdir):
    E, A = m["E"], m["A"]
    return (_df(m, sess)
            .where(E.GreaterThan(_col(m, "x"), E.lit(-500)))
            .select(_col(m, "k"), E.Alias(E.Multiply(_col(m, "x"),
                                                     E.lit(2)), "x2"),
                    _col(m, "d"))
            .group_by("k")
            .agg(A.agg(A.Sum(_col(m, "x2")), "sx"),
                 A.agg(A.Count(_col(m, "d")), "cd"),
                 A.agg(A.Max(_col(m, "d")), "md")))


def q_range_grand_agg(m, sess, pdir):
    E, A = m["E"], m["A"]
    return (sess.range(0, 70_000)
            .where(E.IsNotNull(_col(m, "id")))
            .agg(A.agg(A.Sum(_col(m, "id")), "s"),
                 A.agg(A.Count(None), "c")))


def q_union_project(m, sess, pdir):
    E = m["E"]
    a = sess.range(0, 100)
    b = sess.range(0, 1000)
    c = sess.range(0, 5000)
    return a.union(b).union(c).select(
        E.Alias(E.Add(_col(m, "id"), E.lit(1)), "id1"))


def q_expand_limit(m, sess, pdir):
    E = m["E"]
    return (_df(m, sess)
            .explode([_col(m, "x"), E.Multiply(_col(m, "x"), E.lit(3))],
                     "e")
            .limit(250))


def q_local_limit_sort(m, sess, pdir):
    return (_df(m, sess).select(_col(m, "k"), _col(m, "x"))
            .local_limit(120).order_by("x"))


def q_sort_strings(m, sess, pdir):
    return _df(m, sess).order_by("s", "k")


def q_multi_partition_agg(m, sess, pdir):
    A = m["A"]
    return (_df(m, sess, parts=3).group_by("k")
            .agg(A.agg(A.Sum(_col(m, "x")), "sx")))


def q_parquet(m, sess, pdir):
    E, A = m["E"], m["A"]
    return (sess.read.parquet(pdir)
            .where(E.GreaterThanOrEqual(_col(m, "q"), E.lit(10)))
            .group_by("q")
            .agg(A.agg(A.Sum(_col(m, "c")), "s"),
                 A.agg(A.Count(None), "n")))


def q_join(m, sess, pdir):
    A = m["A"]
    T_ = m["T"]
    dim = sess.from_rows([(i, i * 10) for i in range(7)], T_.StructType((
        T_.StructField("dk", T_.INT, False),
        T_.StructField("dv", T_.LONG, False))))
    return (_df(m, sess).join(dim, [("k", "dk")], "left")
            .group_by("k").agg(A.agg(A.Sum(_col(m, "dv")), "s")))


def q_window(m, sess, pdir):
    W = m["W"]
    spec = W.WindowSpec((_col(m, "k"),), (_col(m, "x"),), ((True, None),))
    return _df(m, sess).with_windows(
        W.WindowExpression(W.RowNumber(), spec, "rn"))


def q_partitioned_sort(m, sess, pdir):
    return _df(m, sess, parts=2).order_by("x")


def q_cpu_fallback(m, sess, pdir):
    E = m["E"]
    return _df(m, sess).select(
        _col(m, "k"), E.Alias(E.PythonUDF(udf_plus_one, (_col(m, "x"),)),
                              "u"))


def q_context_project(m, sess, pdir):
    E = m["E"]
    return _df(m, sess).select(
        _col(m, "k"), E.Alias(E.MonotonicallyIncreasingID(), "mid"))


def udf_plus_one(v) -> int:
    return None if v is None else v + 1


#: (plan, extra settings)
PLANS = {
    "scan_filter_project_agg": (q_scan_filter_project_agg, SCATTER),
    "range_grand_agg": (q_range_grand_agg, {}),
    "union_project_storm": (
        q_union_project,
        {"spark.rapids.tpu.sql.analysis.recompileStorm.threshold": 2}),
    "expand_limit": (q_expand_limit, {}),
    "local_limit_sort": (q_local_limit_sort, {}),
    "sort_strings": (q_sort_strings, {}),
    "multi_partition_agg": (q_multi_partition_agg, SCATTER),
    "parquet_footprint": (q_parquet, {
        **SCATTER, "spark.rapids.tpu.memory.hbm.budgetBytes": 4096}),
    "join": (q_join, {**SCATTER,
                      "spark.rapids.tpu.sql.join.strategy": "SEARCH"}),
    "window": (q_window, {}),
    "partitioned_sort": (q_partitioned_sort, {}),
    "cpu_fallback": (q_cpu_fallback, {}),
    "context_project": (q_context_project, {}),
    "budget_warning": (q_scan_filter_project_agg, {
        **SCATTER, "spark.rapids.tpu.memory.hbm.budgetBytes": 2048}),
}


@pytest.fixture(scope="module")
def parquet_dir(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path_factory.mktemp("pa_parquet")
    rng = np.random.default_rng(3)
    n = 5000
    pq.write_table(pa.table({
        "q": rng.integers(0, 40, n).astype(np.int32),
        "c": rng.integers(-100, 100, n).astype(np.int64)}),
        str(d / "t.parquet"), row_group_size=1500)
    return str(d)


def _analyze(m, q, settings, pdir):
    """(analysis, cpu plan, session) of ``q`` in package ``m``."""
    S = m["S"]
    if m is PORT:
        sess = S.TpuSession(settings, device="cpu")
        cpu = S._lower(q(m, sess, pdir).node, sess.conf)
        return m["PA"].analyze_plan(cpu, sess.conf, device="cpu"), cpu
    sess = S.TpuSession(settings)
    cpu = S._lower(q(m, sess, pdir).node, sess.conf)
    return m["PA"].analyze_plan(cpu, sess.conf), cpu


def _nullability(report):
    out = [(report.name, [(c.name, c.dtype.simpleString, c.null, c.char_cap,
                          c.max_len) for c in report.layout])]
    for c in report.children:
        out.extend(_nullability(c))
    return out


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_analysis_is_the_references(plan, parquet_dir):
    q, settings = PLANS[plan]
    got, _ = _analyze(PORT, q, settings, parquet_dir)
    want, _ = _analyze(REF, q, settings, parquet_dir)
    assert got.render() == want.render()
    assert got.event_fields() == want.event_fields()
    assert got.peak_hbm == want.peak_hbm
    assert got.bytes_by_op == want.bytes_by_op
    assert got.rows_by_op == want.rows_by_op
    assert got.batches_by_op == want.batches_by_op
    assert got.elided_columns == want.elided_columns
    assert _nullability(got.root) == _nullability(want.root)


def test_plans_cover_the_report_features(parquet_dir):
    """The plan set reaches what it claims: bounded and structural plans,
    the footer footprint, the storm and budget warnings, a fallback."""
    seen = {}
    for name, (q, settings) in PLANS.items():
        seen[name], _ = _analyze(PORT, q, settings, parquet_dir)
    assert seen["scan_filter_project_agg"].bounded
    assert seen["range_grand_agg"].bounded
    assert not seen["join"].bounded and not seen["window"].bounded
    assert "pipelined device decode" in seen["parquet_footprint"].render()
    assert seen["parquet_footprint"].peak_hbm
    assert any("recompile storm" in w
               for w in seen["union_project_storm"].warnings)
    assert any("will spill/OOM" in w for w in seen["budget_warning"].warnings)
    assert any("CPU fallbacks" in w for w in seen["cpu_fallback"].warnings)
    assert "join strategy: SEARCH" in seen["join"].render()


@pytest.mark.parametrize("n", sorted({0, 1} | {(1 << k) + d for k in range(28)
                                              for d in (0, 1)}))
def test_bucket_rows_is_the_runtime_capacity_rule(n):
    assert bucket_rows is choose_capacity
    assert bucket_rows(n) == ref_bucket_rows(n)
    assert bucket_rows(n, 8) == ref_bucket_rows(n, 8)


def test_analyze_plan_never_touches_the_device(monkeypatch):
    """The analyzer builds no tensor: it runs before any device work."""
    made = []
    from spark_rapids_tpu_torch.plugin.overrides import PlanMeta

    sess = PS.TpuSession(SCATTER, device="cpu")
    cpu = PS._lower(q_scan_filter_project_agg(PORT, sess, None).node,
                    sess.conf)
    meta = PlanMeta(cpu, sess.conf, device="cpu")
    meta.tag_for_tpu()  # the tagging probe lowers tiny expressions
    for name in ("zeros", "empty", "tensor", "arange", "ones", "full"):
        monkeypatch.setattr(torch, name, lambda *a, _r=getattr(torch, name),
                            **k: made.append(a) or _r(*a, **k))
    an = PPA.analyze_plan(cpu, sess.conf, meta=meta, device="cpu")
    assert made == [] and an.bounded


# -- mesh forecasts ---------------------------------------------------------------
def _mesh_agg(m, sess):
    A = m["A"]
    return (_df(m, sess, parts=4, n=400).group_by("k")
            .agg(A.agg(A.Sum(_col(m, "x")), "sx")))


def test_mesh_forecast_is_the_references(monkeypatch):
    monkeypatch.setenv(PM.VIRTUAL_DEVICES_ENV, "4")
    settings = {"spark.rapids.tpu.shuffle.mode": "ici",
                "spark.rapids.tpu.mesh.devices": 4, **SCATTER}
    js = JS.TpuSession(settings)
    jdf = _mesh_agg(REF, js)
    jrows = jdf.collect()
    ps = PS.TpuSession(settings, device="cpu")
    prows = _mesh_agg(PORT, ps).collect()
    assert sorted(jrows) == sorted(prows)
    want = JPA.forecast_mesh(js.last_executed_plan)
    got = PPA.forecast_mesh(ps.last_executed_plan)
    assert got is not None and got["n_stages"] == want["n_stages"] == 1
    for g, w in zip(got["stages"], want["stages"]):
        assert g["programs_bound"] is None
        assert {k: v for k, v in g.items() if k != "programs_bound"} == {
            k: v for k, v in w.items() if k != "programs_bound"}
    assert got["stages"][0]["staging"]["source"] == "host"
    assert PPA.cross_check_mesh(ps.last_executed_plan) == []


def test_no_mesh_stage_no_forecast():
    ps = PS.TpuSession(SCATTER, device="cpu")
    q_scan_filter_project_agg(PORT, ps, None).collect()
    assert PPA.forecast_mesh(ps.last_executed_plan) is None
    assert PPA.cross_check_mesh(ps.last_executed_plan) == []


# -- the cross-check invariants that port ----------------------------------------
CROSS = {"spark.rapids.tpu.sql.analysis.crossCheck.enabled": True}


def _measured_bytes(plan):
    node = getattr(plan, "tpu_child", plan)
    out = {}

    def walk(n):
        m = n.metrics.get(BYTES_TOUCHED)
        if m is not None and m.value:
            out[n.node_name] = out.get(n.node_name, 0) + m.value
        for c in n.children:
            walk(c)

    assert isinstance(node, TpuExec)
    walk(node)
    return out


BOUNDED = ("scan_filter_project_agg", "range_grand_agg",
           "union_project_storm", "expand_limit", "local_limit_sort")


@pytest.mark.parametrize("plan", BOUNDED)
def test_cross_check_bytes_within_bound(plan):
    """Invariant 2: on a bounded plan every operator's measured
    bytesTouched is within the analyzer's byte bound."""
    q, settings = PLANS[plan]
    sess = PS.TpuSession({**settings, **CROSS}, device="cpu")
    q(PORT, sess, None).collect()
    an = sess.last_analysis
    assert an is not None and an.bounded
    measured = _measured_bytes(sess.last_executed_plan)
    assert measured
    for name, got in measured.items():
        bound = an.bytes_by_op.get(name)
        assert bound is not None and got <= bound, (name, got, an.render())


@pytest.mark.parametrize("plan", ("scan_filter_project_agg",
                                  "range_grand_agg", "expand_limit"))
def test_cross_check_elided_run_equals_mask_carrying(plan):
    """Invariant 3: with validity planes elided the rows equal the run
    with elision off."""
    q, settings = PLANS[plan]
    sess = PS.TpuSession({**settings, **CROSS}, device="cpu")
    rows = q(PORT, sess, None).collect()
    assert sess.last_analysis.elided_columns > 0
    off = PS.TpuSession({
        **settings,
        "spark.rapids.tpu.sql.analysis.nullElision.enabled": False},
        device="cpu")
    assert q(PORT, off, None).collect() == rows


def test_collect_runs_the_analyzer_only_when_asked():
    """Off by default on the collect path; crossCheck, or events on with
    analysis.enabled, runs it; analysis.enabled=false keeps it off."""
    q = q_range_grand_agg
    plain = PS.TpuSession({}, device="cpu")
    q(PORT, plain, None).collect()
    assert plain.last_analysis is None
    ev = PS.TpuSession({"spark.rapids.tpu.eventLog.enabled": True},
                       device="cpu")
    try:
        q(PORT, ev, None).collect()
        assert ev.last_analysis is not None
        recs = [r for r in ev.events.records()
                if r["event"] == "plan_analysis"]
        assert len(recs) == 1
        assert recs[0]["peak_hbm"] == ev.last_analysis.peak_hbm
    finally:
        ev.close()
    off = PS.TpuSession({"spark.rapids.tpu.eventLog.enabled": True,
                         "spark.rapids.tpu.sql.analysis.enabled": False},
                        device="cpu")
    try:
        q(PORT, off, None).collect()
        assert off.last_analysis is None
        assert not any(r["event"] == "plan_analysis"
                       for r in off.events.records())
    finally:
        off.close()


def test_predict_exec_hbm_over_live_plans(parquet_dir):
    sess = PS.TpuSession(SCATTER, device="cpu")
    q_scan_filter_project_agg(PORT, sess, None).collect()
    assert PPA.predict_exec_hbm(sess.last_executed_plan.tpu_child) > 0
    q_parquet(PORT, sess, parquet_dir).collect()
    assert PPA.predict_exec_hbm(sess.last_executed_plan.tpu_child) > 0
    assert PPA.predict_exec_hbm(object()) is None
