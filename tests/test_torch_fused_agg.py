"""The port's fused aggregate routes (``exec/aggregate.py``: the fused
plan and the fused scan->aggregate stage, both on ``_fused_agg_trace``)
against the reference's, on the same numpy-seeded inputs.

Both packages run with ``spark.rapids.tpu.sql.agg.fusedPlan=ON`` (or
``stageFusion=ON``), so each side merges its partials padded at capacity
with the one strategy resolved at the largest capacity. Integers, groups,
nulls and row counts must be equal; float sums within rtol 1e-12, except
under the MATMUL and PALLAS tiers (the reference's f32 hi/lo sums): rtol
1e-4 / atol 1e-6. The port's route is read from the aggregate's
``sections`` (the named ``op_timed`` sections it entered).
"""
import math
import os
import types

import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)
from spark_rapids_tpu import exec as JM
from spark_rapids_tpu import faults as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JB
from spark_rapids_tpu.conf import RapidsConf as JC
from spark_rapids_tpu.exec.aggregate import TpuHashAggregateExec as JAgg
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.io.scan_cache import DeviceScanCache as JDC
from spark_rapids_tpu.memory import retry as JR
from spark_rapids_tpu.sql import session as JSM
from spark_rapids_tpu_torch import exec as PM
from spark_rapids_tpu_torch import faults as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch as PB
from spark_rapids_tpu_torch.conf import RapidsConf as PC
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec as PAgg
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache as PDC
from spark_rapids_tpu_torch.memory import retry as PR
from spark_rapids_tpu_torch.sql import session as PSM

REF = types.SimpleNamespace(
    T=JT, E=JE, A=JA, M=JM, C=JC, F=JF, R=JR, Agg=JAgg,
    batch=lambda d, s: JB.from_pydict(d, s),
    session=lambda st: JSM.TpuSession(st))
PORT = types.SimpleNamespace(
    T=T, E=PE, A=PA, M=PM, C=PC, F=PF, R=PR, Agg=PAgg,
    batch=lambda d, s: PB.from_pydict(d, s, device="cpu"),
    session=lambda st: PSM.TpuSession(st, device="cpu"))

FUSED = {"spark.rapids.tpu.sql.agg.fusedPlan": "ON",
         "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
         "spark.rapids.tpu.memory.oomRetry.backoffMs": 0}
#: rows per input batch: three batches, one of them full (capacity 256)
ROWS = (200, 150, 256)


@pytest.fixture(autouse=True)
def _clean():
    PF.uninstall()
    JF.uninstall()
    yield
    PF.uninstall()
    JF.uninstall()


def _data(seed, n):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 9, n)
    a = rng.integers(-1000, 1000, n)
    b = rng.normal(0.0, 100.0, n)
    kn, an, bn = (rng.random(n) < 0.1 for _ in range(3))
    return {"k": [None if kn[i] else int(k[i]) for i in range(n)],
            "a": [None if an[i] else int(a[i]) for i in range(n)],
            "b": [None if bn[i] else float(b[i]) for i in range(n)]}


def _schema(m):
    return m.T.StructType((m.T.StructField("k", m.T.INT),
                           m.T.StructField("a", m.T.LONG),
                           m.T.StructField("b", m.T.DOUBLE)))


def _batches(m, rows=ROWS, seed=3):
    return [m.batch(_data(seed + i, n), _schema(m))
            for i, n in enumerate(rows)]


def _aggs(m):
    E, A = m.E, m.A
    return [A.agg(A.Sum(E.col("a")), "sa"), A.agg(A.Sum(E.col("b")), "sb"),
            A.agg(A.Count(E.col("b")), "cb"), A.agg(A.Count(None), "cs"),
            A.agg(A.Min(E.col("a")), "mn"), A.agg(A.Max(E.col("b")), "mx"),
            A.agg(A.Average(E.col("a")), "av")]


def _scan(m, conf, batches, schema=None):
    return m.M.InMemoryScanExec(conf, [list(batches)],
                                schema if schema is not None
                                else batches[0].schema)


def _plan(m, conf, mode, keyed=True, batches=None, child=None):
    """The aggregate of ``mode`` over three input batches. FINAL runs
    over each batch's own PARTIAL output, three batches in one
    partition."""
    keys = [m.E.col("k")] if keyed else []
    batches = _batches(m) if batches is None else batches
    if mode == "final":
        parts = []
        for b in batches:
            p = m.Agg(conf, keys, _aggs(m), _scan(m, conf, [b]),
                      mode=m.A.PARTIAL)
            parts.extend(p.execute_partition(0))
        return m.Agg(conf, keys, _aggs(m),
                     _scan(m, conf, parts, p.output_schema), mode=m.A.FINAL)
    mode_ = {"complete": m.A.COMPLETE, "partial": m.A.PARTIAL}[mode]
    return m.Agg(conf, keys, _aggs(m),
                 child if child is not None else _scan(m, conf, batches),
                 mode=mode_)


def _key(row):
    return tuple((v is None, repr(v)) for v in row)


def _same(ref, got, approx=False):
    ref, got = sorted(ref, key=_key), sorted(got, key=_key)
    assert len(got) == len(ref), (len(got), len(ref))
    rtol, atol = (1e-4, 1e-6) if approx else (1e-12, 0.0)
    for r, g in zip(ref, got):
        assert len(r) == len(g)
        for a, b in zip(r, g):
            if isinstance(a, float) and isinstance(b, float):
                assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                    b, a, rel_tol=rtol, abs_tol=atol), (r, g)
            else:
                assert type(a) is type(b) and a == b, (r, g)


def _conf(m, extra=None):
    return m.C({**FUSED, **(extra or {})})


def _tier(tier):
    return {"spark.rapids.tpu.sql.agg.strategy": tier}


def _both(build, extra=None, approx=False):
    """Run ``build(m, conf)`` in both packages; the port's plan root."""
    ref = build(REF, _conf(REF, extra))
    want = ref.collect()
    got_plan = build(PORT, _conf(PORT, extra))
    got = got_plan.collect()
    _same(want, got, approx)
    return got_plan, got


@pytest.mark.parametrize("mode", ["complete", "partial", "final"])
def test_fused_plan_modes_match_the_reference(mode):
    plan, rows = _both(lambda m, c: _plan(m, c, mode), _tier("SCATTER"))
    assert plan.sections.get("plan") == 1 and "update" not in plan.sections
    assert len(rows) == 10  # nine keys and the null key


@pytest.mark.parametrize("tier", ["SCATTER", "SORT", "RADIX", "MATMUL",
                                  "PALLAS"])
def test_fused_plan_each_tier_matches_the_reference(tier):
    plan, _ = _both(lambda m, c: _plan(m, c, "complete"), _tier(tier),
                    approx=tier in ("MATMUL", "PALLAS"))
    assert plan.sections == {"plan": 1}
    assert f"strategy={tier}" in plan.describe()


class _Stop(Exception):
    pass


def test_fused_plan_resolves_one_strategy_at_the_largest_capacity(
        monkeypatch):
    """One strategy for the updates and the merge, resolved at the
    largest input capacity: a small first batch must not choose the tier
    for a large one (AUTO on the CPU picks RADIX at or above 2^21)."""
    seen = []

    def spy(self, chain, cap, device):
        seen.append(cap)
        raise _Stop

    monkeypatch.setattr(PAgg, "_fused_agg_trace", spy)
    conf = _conf(PORT, {"spark.rapids.tpu.sql.agg.fusedPlan": "ON"})
    batches = _batches(PORT, (10, 600, 20))
    assert [b.capacity for b in batches] == [128, 1024, 128]
    with pytest.raises(_Stop):
        _plan(PORT, conf, "complete", batches=batches).collect()
    assert seen == [1024]
    agg = _plan(PORT, _conf(PORT), "complete")
    assert agg.resolved_strategy(1 << 21, "cpu") == "RADIX"
    assert agg.resolved_strategy(1 << 20, "cpu") == "SCATTER"


@pytest.mark.parametrize("keyed", [True, False])
def test_fused_plan_grand_and_empty(keyed):
    _both(lambda m, c: _plan(m, c, "complete", keyed=keyed))
    empty = lambda m: [m.batch({"k": [], "a": [], "b": []},  # noqa: E731
                               _schema(m))]
    plan, rows = _both(lambda m, c: _plan(m, c, "complete", keyed=keyed,
                                          batches=empty(m)))
    assert len(rows) == (0 if keyed else 1)


def _chain(m, conf):
    E = m.E
    scan = _scan(m, conf, _batches(m))
    filt = m.M.TpuFilterExec(conf, E.GreaterThan(E.col("a"),
                                                 E.Literal.of(-200)), scan)
    proj = m.M.TpuProjectExec(conf, [
        E.col("k"), E.Alias(E.Multiply(E.col("a"), E.Literal.of(2)), "a"),
        E.col("b")], filt)
    return _plan(m, conf, "complete", child=proj)


def test_fused_plan_over_a_filter_project_chain():
    plan, _ = _both(_chain, _tier("SCATTER"))
    assert plan.sections == {"plan": 1}


def _join_query(m, st):
    T_, E, A = m.T, m.E, m.A
    sess = m.session({**FUSED, **st})
    rng = np.random.default_rng(11)
    n = 600
    fact = sess.create_dataframe(
        {"fk": [int(x) for x in rng.integers(0, 40, n)],
         "fv": [int(x) for x in rng.integers(0, 5, n)]},
        T_.StructType((T_.StructField("fk", T_.LONG),
                       T_.StructField("fv", T_.INT))))
    dim = sess.create_dataframe(
        {"dk": list(range(0, 40, 2)), "dv": [i * 7 for i in range(20)]},
        T_.StructType((T_.StructField("dk", T_.LONG),
                       T_.StructField("dv", T_.LONG))))
    df = fact.join(dim, [("fk", "dk")]).group_by(
        "fv").agg(A.agg(A.Sum(E.col("dv")), "s"), A.agg(A.Count(None), "c"))
    return sess, df


def test_fused_plan_over_a_fused_join_chain():
    """A join on its fused fast path enters the fused plan's chain with
    its build table as side tensors."""
    _, want = _join_query(REF, {})
    sess, got = _join_query(PORT, {})
    _same(want.collect(), got.collect())
    plan = sess.last_executed_plan
    aggs = [n for n in _walk(plan) if isinstance(n, PAgg)]
    assert aggs and all(a.sections == {"plan": 1} for a in aggs)
    chain = aggs[0].children[0].fused_source_chain()[1]
    assert any(type(e).__name__.endswith("JoinExec") for e in chain)


def _walk(node):
    yield node
    kids = list(getattr(node, "children", []))
    if getattr(node, "tpu_child", None) is not None:
        kids.append(node.tpu_child)
    for c in kids:
        yield from _walk(c)


GUARDS = {"_FUSED_PLAN_MAX_ROWS": 600, "_FUSED_PLAN_MAX_BATCHES": 2,
          "_FUSED_PLAN_MAX_BYTES": 4000}


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_each_guard_flushes_to_the_streaming_path(guard, monkeypatch):
    for cls in (JAgg, PAgg):
        monkeypatch.setattr(cls, guard, GUARDS[guard])
    plan, _ = _both(lambda m, c: _plan(m, c, "complete"), _tier("SCATTER"))
    assert "plan" not in plan.sections
    assert plan.sections["update"] == 3 and plan.sections["merge"] == 1


def test_batch_bytes_is_the_references():
    """The byte guard's count, a fixed-width, a string and a dictionary
    column at capacity, as the reference counts them."""
    from spark_rapids_tpu.columnar.column import \
        dict_column_from_pylist as j_dict
    from spark_rapids_tpu.exec.base import batch_bytes as j_bytes
    from spark_rapids_tpu_torch.columnar.column import \
        dict_column_from_pylist as p_dict
    from spark_rapids_tpu_torch.exec.base import batch_bytes as p_bytes

    strs = [None if i % 7 == 0 else "ab" * (i % 5) for i in range(300)]
    got, want = [], []
    for m, d, out in ((PORT, p_dict, got), (REF, j_dict, want)):
        sch = m.T.StructType((m.T.StructField("a", m.T.LONG),
                              m.T.StructField("s", m.T.STRING)))
        b = m.batch({"a": list(range(300)), "s": strs}, sch)
        dc = d(strs, device="cpu") if m is PORT else d(strs)
        full = m.T.StructType(sch.fields + (m.T.StructField("d",
                                                            m.T.STRING),))
        out.append(type(b)(list(b.columns) + [dc], full, 300))
    assert p_bytes(got[0]) == j_bytes(want[0]) > 0


def test_auto_on_the_cpu_fuses_one_batch_and_streams_two():
    auto = {"spark.rapids.tpu.sql.agg.fusedPlan": "AUTO"}
    one, _ = _both(lambda m, c: _plan(m, c, "complete",
                                      batches=_batches(m, (200,))), auto)
    assert one.sections == {"plan": 1}
    two, _ = _both(lambda m, c: _plan(m, c, "complete",
                                      batches=_batches(m, (200, 150))), auto)
    assert "plan" not in two.sections and two.sections["update"] == 2


def test_an_injected_oom_at_the_plan_site_falls_back():
    spec = {"spark.rapids.tpu.test.faults.oom": "TpuHashAggregateExec@1"}
    PR.reset_stats()
    ref = _plan(REF, _conf(REF, spec), "complete")
    JF.install(_conf(REF, spec))
    want = ref.collect()
    jfired = JF.active().fired()
    got_plan = _plan(PORT, _conf(PORT, spec), "complete")
    PF.install(_conf(PORT, spec))
    got = got_plan.collect()
    assert PF.active().fired() == jfired == [
        ("oom", "TpuHashAggregateExec", 1)]
    _same(want, got)
    st = PR.stats()["TpuHashAggregateExec"]
    assert st["fused_plan_fallback"] == 1 and st["retries"] == 0
    assert got_plan.sections["plan"] == 1
    assert got_plan.sections["update"] == 3


def test_with_oom_retry_off_the_plan_site_oom_is_raised():
    spec = {"spark.rapids.tpu.test.faults.oom": "TpuHashAggregateExec@1",
            "spark.rapids.tpu.memory.oomRetry.enabled": False}
    for m in (REF, PORT):
        plan = _plan(m, _conf(m, spec), "complete")
        m.F.install(_conf(m, spec))
        with pytest.raises(m.F.InjectedOOM):
            plan.collect()
        m.F.uninstall()


# ---------------------------------------------------------------------------
# the fused stage over parquet files
# ---------------------------------------------------------------------------
STAGE = {"spark.rapids.tpu.sql.stageFusion": "ON",
         "spark.rapids.tpu.sql.variableFloatAgg.enabled": True}


def _fresh_caches():
    for mod in (JSM, PSM):
        mod._SCANNER_CACHE.clear()
    JDC.reset()
    PDC.reset()


def _write_store(tmp, name="t.parquet", plain_strings=False, parts=False):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(21)
    n = 900
    valid = rng.random(n) > 0.1
    day = rng.integers(10_000, 10_040, n).astype(np.int32)
    cents = rng.integers(-50_000, 50_000, n)
    t = pa.table({
        "k": pa.array(rng.integers(0, 12, n).astype(np.int32)),
        "v": pa.array(rng.integers(-100, 100, n), mask=~valid),
        "f": pa.array(rng.normal(0, 10, n)),
        "s": pa.array([["red", "green", "blue", "teal"][i % 4]
                       for i in rng.integers(0, 4, n)]),
        "d": pa.array(day, pa.date32()),
        "m": pa.array([None if not ok else __import__("decimal").Decimal(
            int(c)).scaleb(-2) for c, ok in zip(cents, valid)],
            pa.decimal128(7, 2)),
    })
    os.makedirs(tmp, exist_ok=True)
    kw = dict(row_group_size=300, store_decimal_as_integer=True)
    if plain_strings:
        kw["use_dictionary"] = ["k", "v", "f", "d", "m"]
    if parts:
        for p in ("a", "b"):
            sub = os.path.join(tmp, f"part={p}")
            os.makedirs(sub, exist_ok=True)
            pq.write_table(t, os.path.join(sub, name), **kw)
    else:
        pq.write_table(t, os.path.join(tmp, name), **kw)
    return tmp


def _stage_query(m, sess, path, kind):
    E, A = m.E, m.A
    df = sess.read.parquet(path)
    if kind == "ints":
        return df.group_by("k").agg(A.agg(A.Sum(E.col("v")), "sv"),
                                    A.agg(A.Count(None), "c"),
                                    A.agg(A.Sum(E.col("f")), "sf"))
    if kind == "strings":
        return df.filter(E.EqualTo(E.col("s"), E.Literal.of("blue"))) \
            .group_by("k").agg(A.agg(A.Sum(E.col("v")), "sv"),
                               A.agg(A.Count(None), "c"))
    if kind == "dates":
        return df.group_by("d").agg(A.agg(A.Sum(E.col("m")), "sm"),
                                    A.agg(A.Max(E.col("m")), "mm"),
                                    A.agg(A.Count(None), "c"))
    raise ValueError(kind)


def _stage_rows(m, st, path, kind):
    _fresh_caches()
    sess = m.session({**STAGE, **st})
    rows = _stage_query(m, sess, path, kind).collect()
    return sess, rows


def _port_agg(sess):
    return next(n for n in _walk(sess.last_executed_plan)
                if isinstance(n, PAgg))


DICT_ON = {"spark.rapids.tpu.sql.format.parquet.dictStrings.enabled": True}
DICT_OFF = {"spark.rapids.tpu.sql.format.parquet.dictStrings.enabled": False}


@pytest.mark.parametrize("kind,st", [
    ("ints", {}), ("strings", DICT_ON), ("strings", DICT_OFF),
    ("dates", {})], ids=["ints", "strings-dict", "strings-plain", "dates"])
def test_fused_stage_matches_the_reference(tmp_path, kind, st):
    path = _write_store(str(tmp_path))
    # the reference's dictionary strings raise in its string kernels'
    # hash; its side reads the expanded layout (the results are equal)
    _, want = _stage_rows(REF, DICT_OFF if kind == "strings" else st,
                          path, kind)
    sess, got = _stage_rows(PORT, st, path, kind)
    _same(want, got)
    assert _port_agg(sess).sections == {"stage": 1}


def test_fused_stage_entries_keep_dictionary_strings(tmp_path):
    from spark_rapids_tpu_torch.expr.values import DictV
    from spark_rapids_tpu_torch.io.parquet import ParquetScanner

    path = _write_store(str(tmp_path))
    _fresh_caches()
    for st, want in ((DICT_ON, DictV), (DICT_OFF, tuple)):
        PDC.reset()
        sc = ParquetScanner(path, PC(st), columns=["k", "s"])
        stage = sc.device_stage_plans(0, "cpu")
        assert [n for n, _, _ in stage] == [300, 300, 300]
        assert {c for _, c, _ in stage} == {512}
        out = stage[0][2][1][1](stage[0][2][1][0], "cpu")
        assert isinstance(out, want)


def test_fused_stage_declines_plain_strings_and_partitions(tmp_path):
    from spark_rapids_tpu_torch.io.parquet import ParquetScanner

    plain = _write_store(str(tmp_path / "plain"), plain_strings=True)
    parts = _write_store(str(tmp_path / "parts"), parts=True)
    _fresh_caches()
    conf = PC(DICT_OFF)
    assert ParquetScanner(plain, conf).device_stage_plans(0, "cpu") is None
    assert ParquetScanner(plain, conf, columns=["k", "v"]) \
        .device_stage_plans(0, "cpu") is not None
    assert ParquetScanner(parts, conf).device_stage_plans(0, "cpu") is None
    off = PC({"spark.rapids.tpu.sql.format.parquet.deviceDecode.enabled":
              False})
    assert ParquetScanner(plain, off, columns=["k"]) \
        .device_stage_plans(0, "cpu") is None
    for path in (plain, parts):
        _, want = _stage_rows(REF, DICT_OFF, path, "strings")
        sess, got = _stage_rows(PORT, DICT_OFF, path, "strings")
        _same(want, got)
        assert "stage" not in _port_agg(sess).sections


def test_a_declined_split_is_not_planned_again(tmp_path, monkeypatch):
    """A split the fused stage declines is cached as declined: the next
    execution reads its decoded batches from the scan cache without
    planning the split's chunks again."""
    from spark_rapids_tpu_torch.io import parquet_device as PD

    path = _write_store(str(tmp_path), plain_strings=True)
    calls = []
    real = PD.row_group_device_plans

    def spy(*a, **k):
        calls.append(a[2])
        return real(*a, **k)

    monkeypatch.setattr(PD, "row_group_device_plans", spy)
    sess, first = _stage_rows(PORT, DICT_OFF, path, "strings")
    assert calls == [0]
    again = _stage_query(PORT, sess, path, "strings").collect()
    assert calls == [0]
    assert sorted(again, key=_key) == sorted(first, key=_key)
    assert "stage" not in _port_agg(sess).sections


def test_a_split_declined_late_caches_no_staged_arguments(tmp_path,
                                                          monkeypatch):
    """When a later row group of a split declines, the row groups planned
    before it leave no staged arguments in the scan cache: every row
    group of the split is cached as declined, at 0 bytes."""
    from spark_rapids_tpu_torch.io import parquet_device as PD
    from spark_rapids_tpu_torch.io.parquet import (STAGE_DECLINED,
                                                   ParquetScanner)

    path = _write_store(str(tmp_path))
    real = PD.row_group_device_plans
    monkeypatch.setattr(PD, "row_group_device_plans",
                        lambda *a, **k: None if a[2] == 2 else real(*a, **k))
    _fresh_caches()
    PDC.reset()
    sc = ParquetScanner(path, PC({}), columns=["k", "v"])
    assert sc.device_stage_plans(0, "cpu") is None
    cache = PDC.get_instance(PC({}))
    assert cache.stats()["entries"] == 3 and cache.stats()["bytes"] == 0
    assert all(v is STAGE_DECLINED for v, _ in cache._entries.values())
    assert sc.device_stage_plans(0, "cpu") is None


def test_a_second_stage_run_hits_the_stage_cache(tmp_path):
    path = _write_store(str(tmp_path))
    sess, first = _stage_rows(PORT, {}, path, "ints")
    cache = PDC.get_instance(PC({}))
    before = cache.stats()
    again = _stage_query(PORT, sess, path, "ints").collect()
    after = cache.stats()
    assert sorted(again, key=_key) == sorted(first, key=_key)
    assert after["hits"] - before["hits"] == 3  # three row groups
    assert after["misses"] == before["misses"]
    assert before["entries"] == 3 and before["bytes"] > 0
    assert _port_agg(sess).sections == {"stage": 1}
