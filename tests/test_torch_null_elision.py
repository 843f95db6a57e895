"""The port's null elision (``ops/filter_gather.elide_validity``,
``plugin/plananalysis.entry_nonnull_flags`` and their pipeline entries)
against the reference's.

A statically non-null column's stored validity is replaced by the
liveness mask at a pipeline entry. That is bit-identical only under the
batch invariant (padding rows invalid, a non-null column's live rows
valid), which is checked here for every way the port builds a batch:
``from_pydict``, the parquet decode of REQUIRED columns,
``arrow_to_batch``, ``head_rows``, ``truncate_cols`` (a limit keeps its
capacity) and split halves. The project, expand, fused chain and
aggregate run with ``sql.analysis.nullElision.enabled`` on and off in
both packages: every run gives the same rows.
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp
from spark_rapids_tpu import exec as JM
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JB
from spark_rapids_tpu.columnar.column import dict_column_from_pylist as j_dict
from spark_rapids_tpu.conf import RapidsConf as JC
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr.eval import ColV as JColV
from spark_rapids_tpu.expr.eval import DictV as JDictV
from spark_rapids_tpu.expr.eval import StrV as JStrV
from spark_rapids_tpu.expr.eval import evaluate_projection as j_eval
from spark_rapids_tpu.ops import filter_gather as JFG
from spark_rapids_tpu.plugin.plananalysis import entry_nonnull_flags as j_flags
from spark_rapids_tpu_torch import exec as PM
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch as PB
from spark_rapids_tpu_torch.columnar.column import \
    dict_column_from_pylist as p_dict
from spark_rapids_tpu_torch.conf import RapidsConf as PC
from spark_rapids_tpu_torch.exec import basic as PBasic
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.expr.eval import evaluate_projection as p_eval
from spark_rapids_tpu_torch.expr.values import ColV, DictV, StrV
from spark_rapids_tpu_torch.ops import filter_gather as PFG
from spark_rapids_tpu_torch.plugin.plananalysis import \
    entry_nonnull_flags as p_flags

KEY = "spark.rapids.tpu.sql.analysis.nullElision.enabled"
ON, OFF = {KEY: True}, {KEY: False}


# ---------------------------------------------------------------------------
# elide_validity and entry_nonnull_flags
# ---------------------------------------------------------------------------
def _planes(v):
    if isinstance(v, (DictV, JDictV)):
        return [np.asarray(v.codes), np.asarray(v.validity),
                np.asarray(v.dictionary.offsets),
                np.asarray(v.dictionary.chars),
                (v.mat_cap, v.max_len, v.unique)]
    if isinstance(v, (StrV, JStrV)):
        return [np.asarray(v.offsets), np.asarray(v.chars),
                np.asarray(v.validity)]
    return [np.asarray(v.data), np.asarray(v.validity)]


def _vals(n=5, cap=8):
    rng = np.random.default_rng(4)
    data = rng.integers(-9, 9, cap)
    valid = np.arange(cap) < n
    valid[1] = False  # a stored null the elision must overwrite
    offs = np.array([0, 1, 3, 3, 6, 8, 8, 8, 8], np.int32)
    chars = np.frombuffer(b"abcdefgh" + bytes(8), np.uint8).copy()
    strs = ["x", None, "yy", "x", "z"]
    pd = p_dict(strs, capacity=cap, device="cpu").dictv
    jd = j_dict(strs, capacity=cap).dictv
    port = [ColV(torch.from_numpy(data), torch.from_numpy(valid)),
            StrV(torch.from_numpy(offs), torch.from_numpy(chars),
                 torch.from_numpy(valid)), pd]
    ref = [JColV(jnp.asarray(data), jnp.asarray(valid)),
           JStrV(jnp.asarray(offs), jnp.asarray(chars),
                 jnp.asarray(valid)), jd]
    return port, ref, n, cap


@pytest.mark.parametrize("flags", [(), (False, False, False),
                                   (True, False, True), (True, True, True),
                                   (False, True)])
def test_elide_validity_is_the_references(flags):
    port, ref, n, cap = _vals()
    got = PFG.elide_validity(port, PFG.live_of(n, cap), flags)
    want = JFG.elide_validity(ref, JFG.live_of(n, cap), flags)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        for a, b in zip(_planes(g), _planes(w)):
            if isinstance(a, tuple):
                assert a == b
            else:
                assert a.tolist() == b.tolist()


@pytest.mark.parametrize("nullable", [(True, True), (False, True),
                                      (False, False)])
@pytest.mark.parametrize("on", [True, False])
def test_entry_nonnull_flags_are_the_references(nullable, on):
    def schema(TT):
        return TT.StructType(tuple(
            TT.StructField(f"c{i}", TT.LONG, nb)
            for i, nb in enumerate(nullable)))

    got = p_flags(schema(T), PC({KEY: on}))
    want = j_flags(schema(JT), JC({KEY: on}))
    assert got == want
    assert got == (tuple(not nb for nb in nullable)
                   if on and not all(nullable) else ())


# ---------------------------------------------------------------------------
# the pipelines, elision on and off, in both packages
# ---------------------------------------------------------------------------
def _data(n=300, seed=7):
    rng = np.random.default_rng(seed)
    return {"k": [int(x) for x in rng.integers(0, 6, n)],
            "a": [int(x) for x in rng.integers(-50, 50, n)],
            "b": [None if x < 0.2 else float(x) for x in rng.random(n)],
            "s": [["p", "qq", "rrr"][i % 3] for i in rng.integers(0, 3, n)]}


def _schema(TT):
    return TT.StructType((TT.StructField("k", TT.INT, False),
                          TT.StructField("a", TT.LONG, False),
                          TT.StructField("b", TT.DOUBLE, True),
                          TT.StructField("s", TT.STRING, False)))


REF = dict(T=JT, E=JE, A=JA, M=JM, C=JC, X=JM.TpuExpandExec,
           B=lambda d, s: JB.from_pydict(d, s))
PORT = dict(T=T, E=PE, A=PA, M=PM, C=PC, X=PBasic.TpuExpandExec,
            B=lambda d, s: PB.from_pydict(d, s, device="cpu"))


def _scan(m, conf):
    sch = _schema(m["T"])
    return m["M"].InMemoryScanExec(
        conf, [[m["B"](_data(), sch), m["B"](_data(90, 8), sch)]], sch)


def _project(m, conf):
    E = m["E"]
    return m["M"].TpuProjectExec(conf, [
        E.Alias(E.Add(E.col("a"), E.col("k")), "ak"),
        E.Alias(E.IsNull(E.col("a")), "an"),
        E.Alias(E.Coalesce((E.col("b"), E.Literal.of(-1.0))), "bc"),
        E.col("s")], _scan(m, conf))


def _expand(m, conf):
    E = m["E"]
    return m["X"](conf, [
        [E.col("k"), E.Alias(E.IsNotNull(E.col("a")), "x")],
        [E.Literal(None, m["T"].INT), E.Alias(E.IsNull(E.col("k")), "x")]],
        ["k", "x"], _scan(m, conf))


def _chain(m, conf):
    E = m["E"]
    filt = m["M"].TpuFilterExec(
        conf, E.GreaterThan(E.col("a"), E.Literal.of(-20)), _scan(m, conf))
    return m["M"].TpuProjectExec(conf, [
        E.col("k"), E.Alias(E.Multiply(E.col("a"), E.Literal.of(3)), "a3"),
        E.Alias(E.IsNull(E.col("s")), "sn")], filt)


def _aggregate(m, conf):
    E, A = m["E"], m["A"]
    return m["M"].TpuHashAggregateExec(
        conf, [E.col("k")],
        [A.agg(A.Sum(E.col("a")), "sa"), A.agg(A.Count(E.col("a")), "ca"),
         A.agg(A.Min(E.col("b")), "mb"), A.agg(A.Count(None), "c")],
        _chain_for_agg(m, conf))


def _chain_for_agg(m, conf):
    E = m["E"]
    return m["M"].TpuFilterExec(
        conf, E.IsNotNull(E.col("k")), _scan(m, conf))


PIPELINES = {"project": _project, "expand": _expand, "chain": _chain,
             "aggregate": _aggregate}


def _key(row):
    return tuple((v is None, repr(v)) for v in row)


@pytest.mark.parametrize("fused", ["ON", "OFF"])
@pytest.mark.parametrize("pipe", sorted(PIPELINES))
def test_pipelines_agree_with_elision_on_and_off(pipe, fused):
    extra = {"spark.rapids.tpu.sql.agg.fusedPlan": fused}
    runs = []
    for m in (REF, PORT):
        for el in (ON, OFF):
            plan = PIPELINES[pipe](m, m["C"]({**el, **extra}))
            rows = plan.collect()
            runs.append(rows if pipe in ("project", "chain", "expand")
                        else sorted(rows, key=_key))
    assert runs[0] and all(r == runs[0] for r in runs[1:])


def test_the_aggregate_elides_its_source_and_buffer_flags(monkeypatch):
    """The streaming update gets the source schema's flags, the merge and
    the result projection the buffers' (the non-null key)."""
    from spark_rapids_tpu_torch.exec import aggregate as AG

    seen = []
    real = AG.elide_validity

    def spy(cols, live, nonnull):
        seen.append(tuple(nonnull))
        return real(cols, live, nonnull)

    monkeypatch.setattr(AG, "elide_validity", spy)

    def run(el):
        conf = PC({**el, "spark.rapids.tpu.sql.agg.fusedPlan": "OFF"})
        PM.TpuHashAggregateExec(conf, [PE.col("k")],
                                [PA.agg(PA.Sum(PE.col("a")), "sa")],
                                _scan(PORT, conf)).collect()

    run(ON)
    src = (True, True, False, True)
    # both batches' updates, then the merge and the projection over the
    # buffers: k, then sum(a)
    assert seen == [src, src, (True, False), (True, False)]
    seen.clear()
    run(OFF)
    assert seen == [(), (), ()]  # the projection skips an empty flag set


# ---------------------------------------------------------------------------
# the batch invariant, for every way the port builds a batch
# ---------------------------------------------------------------------------
def _invariant(batch, nonnull_cols):
    n, cap = batch.num_rows, batch.capacity
    live = (torch.arange(cap) < n).tolist()
    for j in nonnull_cols:
        assert batch.columns[j].validity.tolist() == live, j


def _elided_equal(batch, TT=T):
    """An elided projection of every column equals the plain one."""
    exprs = [PE.BoundReference(i, f.dataType, f.nullable)
             for i, f in enumerate(batch.schema.fields)]
    a = [c.to_host(batch.num_rows).to_pylist()
         for c in p_eval(exprs, batch, conf=PC(ON))]
    b = [c.to_host(batch.num_rows).to_pylist()
         for c in p_eval(exprs, batch, conf=PC(OFF))]
    assert a == b


def _pd_batch():
    return PB.from_pydict(_data(), _schema(T), device="cpu")


def test_from_pydict_keeps_the_invariant_and_matches_the_reference():
    b = _pd_batch()
    _invariant(b, (0, 1, 3))
    _elided_equal(b)
    jb = JB.from_pydict(_data(), _schema(JT))
    exprs_p = [PE.BoundReference(i, f.dataType, f.nullable)
               for i, f in enumerate(b.schema.fields)]
    exprs_j = [JE.BoundReference(i, f.dataType, f.nullable)
               for i, f in enumerate(jb.schema.fields)]
    got = [c.to_host(b.num_rows).to_pylist()
           for c in p_eval(exprs_p, b, conf=PC(ON))]
    want = [c.to_host().to_pylist()
            for c in j_eval(exprs_j, jb, conf=JC(ON))]
    assert got == want
    flags = p_flags(b.schema, PC(ON))
    assert [c.to_host(b.num_rows).to_pylist()
            for c in p_eval(exprs_p, b, nonnull=flags)] == want


def _arrow_table():
    import pyarrow as pa

    d = _data(200, 3)
    sch = pa.schema([pa.field("k", pa.int32(), False),
                     pa.field("a", pa.int64(), False),
                     pa.field("b", pa.float64(), True),
                     pa.field("s", pa.string(), False)])
    return pa.table(d, schema=sch)


def test_arrow_to_batch_keeps_the_invariant():
    from spark_rapids_tpu_torch.io.arrow_convert import arrow_to_batch

    b = arrow_to_batch(_arrow_table(), _schema(T), device="cpu")
    assert b.capacity > b.num_rows
    _invariant(b, (0, 1, 3))
    _elided_equal(b)


@pytest.mark.parametrize("dict_strings", [True, False])
def test_the_parquet_decode_of_required_columns_keeps_it(tmp_path,
                                                         dict_strings):
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.io.parquet import ParquetScanner

    path = str(tmp_path / "t.parquet")
    pq.write_table(_arrow_table(), path, row_group_size=150)
    sc = ParquetScanner(path, PC({
        "spark.rapids.tpu.sql.format.parquet.dictStrings.enabled":
            dict_strings}))
    assert [f.nullable for f in sc.schema.fields] == [False, False, True,
                                                      False]
    batches, _ = sc.read_split_device(0, "cpu")
    assert [b.num_rows for b in batches] == [150, 50]
    for b in batches:
        _invariant(b, (0, 1, 3))
        _elided_equal(b)
    for _, cap, entries in sc.device_stage_plans(0, "cpu"):
        live = torch.arange(cap) < (150 if cap == 256 else 50)
        for (args, run, f) in entries:
            out = run(args, "cpu")
            v = out.validity if isinstance(out, DictV) else out[-1]
            if not f.nullable:
                assert v.tolist() == live.tolist()


def test_head_rows_and_truncate_keep_it():
    from spark_rapids_tpu_torch.exec.base import head_rows, vals_of_batch

    b = _pd_batch()
    h = head_rows(b, 100)
    assert h.capacity == 128
    _invariant(h, (0, 1, 3))
    _elided_equal(h)
    cols = PFG.truncate_cols(vals_of_batch(b), 37)
    t = PM.batch_from_vals(cols, b.schema, 37, capacity=b.capacity)
    assert t.capacity == b.capacity
    _invariant(t, (0, 1, 3))
    _elided_equal(t)
    # a dictionary column truncated the same way
    d = p_dict(["u", "v", "w"] * 20, device="cpu")
    dt = PFG.truncate_cols([d.dictv], 11)[0]
    assert dt.validity.tolist() == (torch.arange(d.capacity) < 11).tolist()


def test_split_halves_keep_it():
    from spark_rapids_tpu_torch.columnar import split_batch

    lo, hi = split_batch(_pd_batch())
    for half in (lo, hi) + split_batch(hi):
        _invariant(half, (0, 1, 3))
        _elided_equal(half)
