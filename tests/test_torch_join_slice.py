"""The join slice end to end, the join strategy chooser and the fused
fast paths, port against reference, on the CPU.

* The bench join query (``bench.py`` ``shape_join``: scan(fact) and
  scan(dim) -> inner join fk = dk -> group by fv: sum(dv), count(*)) at
  2^12 fact x 2^9 dim rows, under every port strategy, against the
  reference exec tree on the same data and a numpy oracle; integers must
  match exactly.
* ``choose_join_strategy``: the CPU branch pick for pick against the
  reference's; the CUDA branch's picks for the bench shape and a full
  join.
* The fused DIRECT and RADIX fast paths are taken (or declined) exactly
  where the reference takes them, and a fused join runs inside its
  consumer's chain.
"""
import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)

from spark_rapids_tpu import exec as JX
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.batch import schema_of as jschema_of
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.exec.join import TpuShuffledHashJoinExec as JJoin
from spark_rapids_tpu.exec.join import choose_join_strategy as jchoose
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu_torch import exec as X
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import choose_join_strategy
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.ops import join_kernels as JK

N_FACT, N_DIM = 1 << 12, 1 << 9


def _bench_data():
    rng = np.random.default_rng(11)
    fk = rng.integers(0, N_DIM, N_FACT).astype(np.int64)
    fv = rng.integers(0, 100, N_FACT).astype(np.int64)
    dk = np.arange(N_DIM, dtype=np.int64)
    dv = rng.integers(0, 10**6, N_DIM).astype(np.int64)
    return fk, fv, dk, dv


def _bench_plan(M, E_, A_, conf, fact, dim, fs, ds):
    join = M.TpuShuffledHashJoinExec(
        conf, M.InMemoryScanExec(conf, [[fact]], fs),
        M.InMemoryScanExec(conf, [[dim]], ds),
        [E_.col("fk")], [E_.col("dk")], "inner")
    return join, M.TpuHashAggregateExec(
        conf, [E_.col("fv")],
        [A_.agg(A_.Sum(E_.col("dv")), "s"), A_.agg(A_.Count(None), "c")],
        join)


@pytest.fixture(scope="module")
def bench_reference():
    fk, fv, dk, dv = _bench_data()
    fs = jschema_of(fk=JT.LONG, fv=JT.LONG)
    ds = jschema_of(dk=JT.LONG, dv=JT.LONG)
    conf = JConf({})
    _, agg = _bench_plan(
        JX, JE, JA, conf,
        JBatch.from_pydict({"fk": fk.tolist(), "fv": fv.tolist()}, fs),
        JBatch.from_pydict({"dk": dk.tolist(), "dv": dv.tolist()}, ds),
        fs, ds)
    return sorted(agg.collect())


@pytest.mark.parametrize("strategy",
                         ["AUTO", "PALLAS", "SEARCH", "DIRECT", "RADIX"])
def test_bench_join_query_matches_reference(bench_reference, strategy):
    fk, fv, dk, dv = _bench_data()
    fs = schema_of(fk=T.LONG, fv=T.LONG)
    ds = schema_of(dk=T.LONG, dv=T.LONG)
    conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": strategy})
    fact = ColumnarBatch.from_pydict({"fk": fk.tolist(), "fv": fv.tolist()},
                                     fs, device="cpu")
    dim = ColumnarBatch.from_pydict({"dk": dk.tolist(), "dv": dv.tolist()},
                                    ds, device="cpu")
    join, agg = _bench_plan(X, E, A, conf, fact, dim, fs, ds)
    rows = sorted(X.ColumnarToRowExec(conf, agg).collect())
    assert rows == bench_reference
    # numpy oracle: every fact row meets its one dim row
    s = np.bincount(fv, weights=dv[fk].astype(np.float64), minlength=100)
    c = np.bincount(fv, minlength=100)
    assert rows == [(g, int(s[g]), int(c[g])) for g in range(100) if c[g]]
    # AUTO on the CPU at build cap 2^9 is DIRECT, fused into the
    # aggregate's update
    fused = strategy in ("AUTO", "DIRECT", "RADIX")
    assert ("fused=" in join.describe()) == fused, join.describe()


def test_forced_pallas_probe_runs_the_kernel_wrapper(monkeypatch):
    """The PALLAS tier reaches K4's wrapper (its plain version on CPU
    tensors) once per probe batch."""
    calls = []
    real = JK.probe_ranges

    def spy(*a, **k):
        calls.append(a[3].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(JK, "probe_ranges", spy)
    fk, fv, dk, dv = _bench_data()
    fs = schema_of(fk=T.LONG, fv=T.LONG)
    ds = schema_of(dk=T.LONG, dv=T.LONG)
    conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": "PALLAS"})
    fact = [ColumnarBatch.from_pydict(
        {"fk": fk[i::2].tolist(), "fv": fv[i::2].tolist()}, fs,
        device="cpu") for i in range(2)]
    dim = ColumnarBatch.from_pydict({"dk": dk.tolist(), "dv": dv.tolist()},
                                    ds, device="cpu")
    join = X.TpuShuffledHashJoinExec(
        conf, X.InMemoryScanExec(conf, [fact], fs),
        X.InMemoryScanExec(conf, [[dim]], ds), [E.col("fk")],
        [E.col("dk")], "inner")
    assert sum(b.num_rows for b in join.execute_columnar()) == N_FACT
    assert calls == [N_FACT // 2, N_FACT // 2]


# ---------------------------------------------------------------------------
# the chooser
# ---------------------------------------------------------------------------
KEYSETS = {"int": ((JT.INT,), (T.INT,)), "long": ((JT.LONG,), (T.LONG,)),
           "two": ((JT.INT, JT.INT), (T.INT, T.INT)),
           "wide": ((JT.LONG, JT.LONG), (T.LONG, T.LONG))}


@pytest.mark.parametrize("conf_dict", [
    {}, {"spark.rapids.tpu.sql.join.strategy": "SEARCH"},
    {"spark.rapids.tpu.sql.join.pallasProbe.enabled": True}])
def test_chooser_cpu_branch_matches_reference(conf_dict):
    for keys in KEYSETS.values():
        for cap in (128, 1 << 15, 1 << 16, 1 << 20):
            for how in ("inner", "left", "full", "semi", "anti"):
                want = jchoose(JConf(conf_dict), cap, keys[0], how,
                               backend="cpu")[0]
                got = choose_join_strategy(RapidsConf(conf_dict), cap,
                                           keys[1], how, "cpu")[0]
                assert got == want, (keys, cap, how)


def test_chooser_cuda_branch():
    auto = RapidsConf({})
    # the bench shape: one int64 key, build cap 2^17 -> DIRECT (fused)
    s, why = choose_join_strategy(auto, 1 << 17, (T.LONG,), "inner", "cuda")
    assert s == "DIRECT" and "fuses" in why
    assert jchoose(JConf({}), 1 << 17, (JT.LONG,), "inner",
                   backend="tpu")[0] == s
    # full joins never fuse: the cost model, at the H100's 3350 GB/s
    s, why = choose_join_strategy(auto, 1 << 17, (T.LONG,), "full", "cuda")
    assert s == "RADIX" and "3350GB/s" in why
    # a declared peak moves the model: a slow memory makes the search win
    slow = RapidsConf({"spark.rapids.tpu.roofline.peakHbmGBps": 0.05})
    s, why = choose_join_strategy(slow, 1 << 22, (T.LONG, T.LONG, T.LONG),
                                  "inner", "cuda")
    assert s == "SEARCH", why
    # the legacy toggle and forced values win on any device
    legacy = RapidsConf({"spark.rapids.tpu.sql.join.pallasProbe.enabled":
                         True})
    assert choose_join_strategy(legacy, 1 << 17, (T.LONG,), "inner",
                                "cuda")[0] == "PALLAS"
    forced = RapidsConf({"spark.rapids.tpu.sql.join.strategy": "RADIX"})
    assert choose_join_strategy(forced, 128, (T.INT,), "inner",
                                "cuda") == ("RADIX", "forced by "
                                            "spark.rapids.tpu.sql.join."
                                            "strategy")


# ---------------------------------------------------------------------------
# fused fast paths
# ---------------------------------------------------------------------------
_L = {"k": [i % 29 for i in range(120)], "a": list(range(120))}
_RU = {"k2": list(range(29)), "b": [i * 2 for i in range(29)]}
_RD = {"k2": [i % 4 for i in range(29)], "b": [i * 2 for i in range(29)]}


def _fast_kind(j):
    st = j._fast_built
    return st["kind"] if isinstance(st, dict) else st


@pytest.mark.parametrize("build", ["unique", "dup"])
@pytest.mark.parametrize("how", ["inner", "left", "semi", "full"])
@pytest.mark.parametrize("strategy", ["DIRECT", "RADIX", "SEARCH"])
def test_fast_path_taken_where_the_reference_takes_it(strategy, how, build):
    rd = _RU if build == "unique" else _RD
    jl, jr = (jschema_of(k=JT.INT, a=JT.LONG), jschema_of(k2=JT.INT,
                                                         b=JT.LONG))
    pl, pr = schema_of(k=T.INT, a=T.LONG), schema_of(k2=T.INT, b=T.LONG)
    settings = {"spark.rapids.tpu.sql.join.strategy": strategy}
    jc, pc = JConf(settings), RapidsConf(settings)
    ref = JJoin(jc, JX.InMemoryScanExec(jc, [[JBatch.from_pydict(_L, jl)]],
                                        jl),
                JX.InMemoryScanExec(jc, [[JBatch.from_pydict(rd, jr)]], jr),
                [JE.col("k")], [JE.col("k2")], how)
    port = X.TpuShuffledHashJoinExec(
        pc, X.InMemoryScanExec(pc, [[ColumnarBatch.from_pydict(
            _L, pl, device="cpu")]], pl),
        X.InMemoryScanExec(pc, [[ColumnarBatch.from_pydict(
            rd, pr, device="cpu")]], pr),
        [E.col("k")], [E.col("k2")], how)
    assert bool(port.fusable) == bool(ref.fusable)
    assert _fast_kind(port) == _fast_kind(ref)
    if build == "dup" and how in ("inner", "left"):
        assert _fast_kind(port) is False  # duplicates decline fusion
    if strategy == "SEARCH" or how == "full":
        assert _fast_kind(port) is False


def test_fused_join_runs_inside_the_aggregate_chain():
    pl, pr = schema_of(k=T.INT, a=T.LONG), schema_of(k2=T.INT, b=T.LONG)
    conf = RapidsConf({})
    left = X.InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
        _L, pl, device="cpu")]], pl)
    join = X.TpuShuffledHashJoinExec(
        conf, left, X.InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
            _RU, pr, device="cpu")]], pr), [E.col("k")], [E.col("k2")])
    filt = X.TpuFilterExec(conf, E.GreaterThan(E.col("b"), E.lit(10)), join)
    agg = X.TpuHashAggregateExec(conf, [E.col("k")],
                                 [A.agg(A.Sum(E.col("a")), "s")], filt)
    source, chain = filt.fused_source_chain()
    assert source is left and chain == [join, filt]
    rows = sorted(agg.collect())
    want = {}
    for k, a in zip(_L["k"], _L["a"]):
        if 2 * k > 10:
            want[k] = want.get(k, 0) + a
    assert rows == sorted(want.items())
    assert join.metrics["numOutputBatches"].value == 0  # never ran alone
