"""String grouping keys and string min/max in the port against the
reference, on the CPU: ``ops/groupby.groupby_agg`` and ``reduce_no_keys``
on the same planes, ``TpuHashAggregateExec`` over one batch and over three
(the partials merge through the string concat), the chain a string
min/max breaks, and TPC-H Q1's shape through both sessions.

String keys take the sort path under every tier in the port; under
PALLAS the reference reduces that path with its RADIX tiled reduction
(``groupby.py:1023-1035``), which runs under XLA here. Group sets,
strings, counts and integer sums are exact; f64 sums within rtol 1e-12
on the order-preserving paths (AUTO and SCATTER) and within rtol 1e-4 /
atol 1e-6 where the reference sums f32 hi/lo pairs (PALLAS).
"""
import functools
import math

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.exec import InMemoryScanExec as JScan
from spark_rapids_tpu.exec import TpuFilterExec as JFilter
from spark_rapids_tpu.exec import TpuHashAggregateExec as JAgg
from spark_rapids_tpu.exec import TpuProjectExec as JProject
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr.eval import ColV as JColV
from spark_rapids_tpu.expr.eval import StrV as JStrV
from spark_rapids_tpu.ops import groupby as JG
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import (InMemoryScanExec, TpuFilterExec,
                                         TpuHashAggregateExec,
                                         TpuProjectExec)
from spark_rapids_tpu_torch.exec.base import NUM_OUTPUT_BATCHES
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.values import ColV, StrV
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops.sort import str_max_lens
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

from test_torch_string_keys import _planes, _strings

def _tol(strategy):
    return (1e-4, 1e-6) if strategy == "PALLAS" else (1e-12, 0.0)


def _val(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _column(v, n):
    """Python values of the first ``n`` rows of a ColV / StrV of either
    engine (strings as bytes)."""
    valid = _val(v.validity)[:n]
    if isinstance(v, (StrV, JStrV)):
        off, chars = _val(v.offsets), _val(v.chars)
        return [bytes(chars[off[i]:off[i + 1]]) if valid[i] else None
                for i in range(n)]
    data = _val(v.data)[:n]
    return [d.item() if ok else None for d, ok in zip(data, valid)]


def _rows(keys, aggs, n):
    n = int(_val(n))
    cols = [_column(c, n) for c in list(keys) + list(aggs)]
    return sorted(zip(*cols), key=repr)


def _same(got, want, rtol, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                if math.isnan(b):
                    assert math.isnan(a)
                else:
                    assert abs(a - b) <= atol + rtol * abs(b), (g, w)
            else:
                assert a == b, (g, w)


OPS = ["count_star", "count", "sum", "sum", "min", "max", "min", "max",
       "max"]
#: value column per op (None for count_star)
VAL_OF = [None, "i", "i", "f", "t", "t", "i", "f", "u"]


def _inputs(seed, cap, rows):
    rng = np.random.default_rng(seed)
    s = _planes(_strings(seed, rows, 0.15), cap)
    t = _planes(_strings(seed + 1, rows, 0.3), cap)
    u = _planes(_strings(seed + 2, rows, 0.0), cap)
    k = rng.integers(0, 5, cap).astype(np.int32)
    kv = rng.random(cap) < 0.9
    i = rng.integers(-(2**40), 2**40, cap)
    iv = rng.random(cap) < 0.85
    f = rng.normal(size=cap) * 10 + 100
    fv = rng.random(cap) < 0.9
    return {"s": s, "t": t, "u": u, "k": (k, kv), "i": (i, iv),
            "f": (f, fv)}


def _engine_cols(d, names, jax_side):
    out = []
    for nm in names:
        if nm is None:
            out.append(None)
            continue
        p = d[nm]
        if len(p) == 3:
            out.append(JStrV(*(jnp.asarray(a) for a in p)) if jax_side
                       else StrV(*(torch.from_numpy(a.copy()) for a in p)))
        else:
            out.append(JColV(*(jnp.asarray(a) for a in p)) if jax_side
                       else ColV(*(torch.from_numpy(a.copy()) for a in p)))
    return out


KEY_SETS = {"string": ["s"], "string_int": ["s", "k"],
            "int_string": ["k", "t"], "int": ["k"]}
TYPES = {"s": "STRING", "t": "STRING", "k": "INT"}
#: (keys, strategy): string keys under SCATTER (the reference's sort
#: path, as under AUTO) and PALLAS (its RADIX reduction there); int keys
#: (string min/max over the hash tiers' rank columns) under the kernel
#: tier
GROUPBY_CASES = [("string", "SCATTER"), ("string", "PALLAS"),
                 ("string_int", "SCATTER"), ("string_int", "PALLAS"),
                 ("int_string", None), ("int", "PALLAS")]


@pytest.mark.parametrize("keys,strategy", GROUPBY_CASES)
def test_groupby_agg_matches_reference(keys, strategy):
    rows = 100  # 28 pad rows
    d = _inputs(31, 128, rows)
    names = KEY_SETS[keys]
    pk = _engine_cols(d, names, False)
    pv = _engine_cols(d, VAL_OF, False)
    sml = str_max_lens(pk)
    svml = str_max_lens([v for op, v in zip(OPS, pv)
                         if op in ("min", "max") and isinstance(v, StrV)])
    ref = JG.groupby_agg(_engine_cols(d, names, True),
                         [getattr(JT, TYPES[k]) for k in names],
                         _engine_cols(d, VAL_OF, True), OPS, rows,
                         str_max_lens=sml, str_val_max_lens=svml,
                         strategy=strategy)
    got = G.groupby_agg(pk, [getattr(T, TYPES[k]) for k in names], pv, OPS,
                        rows, str_max_lens=sml, str_val_max_lens=svml,
                        strategy=strategy)
    _same(_rows(*got), _rows(*ref), *_tol(strategy or "AUTO"))


def test_string_keys_take_the_sort_path_under_every_tier(monkeypatch):
    d = _inputs(32, 128, 128)
    calls = []
    real = G.hash_groupby
    monkeypatch.setattr(G, "hash_groupby",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    vals = _engine_cols(d, VAL_OF, False)
    svml = str_max_lens([v for op, v in zip(OPS, vals)
                         if op in ("min", "max")])
    for strategy in (None, "SCATTER", "PALLAS"):
        keys = _engine_cols(d, ["s"], False)
        G.groupby_agg(keys, [T.STRING], vals, OPS, 128, strategy=strategy,
                      str_max_lens=str_max_lens(keys), str_val_max_lens=svml)
    assert not calls
    G.groupby_agg(_engine_cols(d, ["k"], False), [T.INT], vals, OPS, 128,
                  str_val_max_lens=svml)
    assert calls


@pytest.mark.parametrize("rows", [0, 90, 128])
def test_grand_string_min_max_matches_reference(rows):
    d = _inputs(33, 128, max(rows, 1))
    ops = ["min", "max", "count_star", "max", "min"]
    vals = ["t", "t", None, "u", "i"]
    ref = JG.reduce_no_keys(_engine_cols(d, vals, True), ops, rows,
                            [64, 64, 64])
    got = G.reduce_no_keys(_engine_cols(d, vals, False), ops, rows,
                           str_val_max_lens=[64, 64, 64])
    assert [_column(c, 1) for c in got] == [_column(c, 1) for c in ref]


def test_one_rank_sort_serves_min_and_max_of_a_column(monkeypatch):
    d = _inputs(34, 128, 128)
    calls = []
    real = G._plain_rank
    monkeypatch.setattr(G, "_plain_rank",
                        lambda *a: calls.append(1) or real(*a))
    t = _engine_cols(d, ["t"], False)[0]
    G.reduce_no_keys([t, t, None], ["min", "max", "count_star"], 128,
                     str_val_max_lens=str_max_lens([t, t]))
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# the exec, over one batch and over three
# ---------------------------------------------------------------------------
SCHEMA = (("s", "STRING"), ("k", "INT"), ("t", "STRING"), ("v", "LONG"),
          ("f", "DOUBLE"))


def _data(seed, n):
    rng = np.random.default_rng(seed)
    return {"s": _strings(seed, n, 0.1),
            "k": [None if rng.random() < 0.1 else int(rng.integers(0, 4))
                  for _ in range(n)],
            "t": _strings(seed + 50, n, 0.25),
            "v": [int(x) for x in rng.integers(-1000, 1000, n)],
            "f": [float(x) for x in rng.normal(size=n) * 10 + 100]}


def _scans(sizes):
    js = JT.StructType(tuple(JT.StructField(a, getattr(JT, b))
                             for a, b in SCHEMA))
    ps = schema_of(**{a: getattr(T, b) for a, b in SCHEMA})
    datas = [_data(40 + i, n) for i, n in enumerate(sizes)]
    return (lambda c: JScan(c, [[JBatch.from_pydict(d, js) for d in datas]],
                            js),
            lambda c: InMemoryScanExec(c, [[ColumnarBatch.from_pydict(
                d, ps, device="cpu") for d in datas]], ps))


def _aggs(m, keys):
    E_, A_ = m
    return ([E_.col(k) for k in keys],
            [A_.agg(A_.Count(None), "n"), A_.agg(A_.Sum(E_.col("v")), "sv"),
             A_.agg(A_.Sum(E_.col("f")), "sf"),
             A_.agg(A_.Min(E_.col("t")), "mn"),
             A_.agg(A_.Max(E_.col("t")), "mx"),
             A_.agg(A_.Max(E_.col("s")), "ms")])


def _exec_rows(rows):
    return sorted(rows, key=repr)


#: (strategy, keys, batches): each tier over string keys in one batch
#: and in three (a merge through the string concat), int keys and the
#: grand aggregate with string min/max
EXEC_CASES = [("AUTO", "s", 1), ("SCATTER", "s_k", 3), ("PALLAS", "s", 3),
              ("AUTO", "none", 3)]


@pytest.mark.parametrize("strategy,keys,batches", EXEC_CASES)
def test_exec_matches_reference(strategy, keys, batches):
    names = [] if keys == "none" else keys.split("_")
    jscan, pscan = _scans((120,) if batches == 1 else (70, 1, 100))
    conf = {"spark.rapids.tpu.sql.agg.strategy": strategy,
            "spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    jc, pc = JConf(conf), RapidsConf(conf)
    ref = JAgg(jc, *_aggs((JE, JA), names), jscan(jc)).collect()
    agg = TpuHashAggregateExec(pc, *_aggs((E, A), names), pscan(pc))
    got = agg.collect()
    _same(_exec_rows(got), _exec_rows(ref), *_tol(strategy))
    if "s" in names:
        assert "string keys: sort path" in agg.describe()


@pytest.mark.parametrize("string_minmax", [True, False])
def test_string_min_max_runs_its_chain_as_execs(string_minmax):
    """A string min/max under a fused filter -> project runs that chain
    as real execs, as the reference's (``aggregate.py:955-970``); other
    aggregates keep it fused. Rows equal the reference's either way."""
    jscan, pscan = _scans((70, 130))

    def plan(m, scan, conf):
        E_, A_, Filter, Project, Agg = m
        filt = Filter(conf, E_.GreaterThan(E_.col("v"), E_.Literal.of(-500)),
                      scan(conf))
        proj = Project(conf, [E_.col("k"), E_.col("t"), E_.col("v")], filt)
        fn = A_.Max(E_.col("t")) if string_minmax else A_.Max(E_.col("v"))
        return filt, Agg(conf, [E_.col("k")],
                         [A_.agg(fn, "m"), A_.agg(A_.Count(None), "n")],
                         proj)

    _, jagg = plan((JE, JA, JFilter, JProject, JAgg), jscan, JConf({}))
    pagg = plan((E, A, TpuFilterExec, TpuProjectExec,
                 TpuHashAggregateExec), pscan, RapidsConf({}))[1]
    assert sorted(pagg.collect(), key=repr) == sorted(jagg.collect(),
                                                      key=repr)
    # the project runs (with the filter fused into it) only as an exec
    ran = pagg.children[0].metrics[NUM_OUTPUT_BATCHES].value
    assert (ran > 0) == string_minmax


# ---------------------------------------------------------------------------
# TPC-H Q1's shape through both sessions
# ---------------------------------------------------------------------------
def _lineitem_rows(n=1 << 12, seed=17):
    rng = np.random.default_rng(seed)
    modes = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
    rows = []
    for _ in range(n):
        ship = int(rng.integers(8036, 10562))
        received = ship + int(rng.integers(1, 31))
        status = "O" if ship > 9298 else "F"
        flag = ("RA"[int(rng.integers(0, 2))] if received <= 9298 else "N")
        qty = float(rng.integers(1, 51))
        price = round(qty * float(rng.uniform(900, 2100)), 2)
        rows.append((flag, status, modes[int(rng.integers(0, 7))], qty,
                     price, int(rng.integers(0, 11)) / 100,
                     int(rng.integers(0, 9)) / 100, ship))
    return rows


def _q1(m, sess):
    T_, E_, A_ = m
    df = sess.from_rows(_lineitem_rows(), T_.StructType(tuple(
        T_.StructField(a, getattr(T_, b)) for a, b in (
            ("l_returnflag", "STRING"), ("l_linestatus", "STRING"),
            ("l_shipmode", "STRING"), ("l_quantity", "DOUBLE"),
            ("l_extendedprice", "DOUBLE"), ("l_discount", "DOUBLE"),
            ("l_tax", "DOUBLE"), ("l_shipdate", "INT")))))
    price = E_.col("l_extendedprice")
    disc = E_.Multiply(price, E_.Subtract(E_.Literal.of(1.0),
                                          E_.col("l_discount")))
    charge = E_.Multiply(disc, E_.Add(E_.Literal.of(1.0), E_.col("l_tax")))
    return (df.where(E_.LessThanOrEqual(E_.col("l_shipdate"),
                                        E_.Literal.of(10471)))
            .group_by("l_returnflag", "l_linestatus")
            .agg(A_.agg(A_.Sum(E_.col("l_quantity")), "sum_qty"),
                 A_.agg(A_.Sum(price), "sum_base_price"),
                 A_.agg(A_.Sum(disc), "sum_disc_price"),
                 A_.agg(A_.Sum(charge), "sum_charge"),
                 A_.agg(A_.Average(E_.col("l_quantity")), "avg_qty"),
                 A_.agg(A_.Average(price), "avg_price"),
                 A_.agg(A_.Average(E_.col("l_discount")), "avg_disc"),
                 A_.agg(A_.Count(None), "count_order"),
                 A_.agg(A_.Min(E_.col("l_shipmode")), "min_mode"),
                 A_.agg(A_.Max(E_.col("l_shipmode")), "max_mode"))
            .order_by("l_returnflag", "l_linestatus"))


@functools.lru_cache(maxsize=None)
def _q1_cpu_engine_rows():
    return _q1((T, E, A), PSession({"spark.rapids.tpu.sql.enabled": False},
                                   device="cpu")).collect()


@pytest.mark.parametrize("strategy", ["AUTO", "PALLAS"])
def test_tpch_q1_matches_reference_and_cpu_engine(strategy):
    conf = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
            "spark.rapids.tpu.sql.agg.strategy": strategy}
    ref = _q1((JT, JE, JA), JSession(conf)).collect()
    sess = PSession(conf, device="cpu")
    got = _q1((T, E, A), sess).collect()
    cpu = _q1_cpu_engine_rows()
    assert [r[:2] for r in got] == [("A", "F"), ("N", "F"), ("N", "O"),
                                    ("R", "F")]
    _same(got, ref, *_tol(strategy))
    _same(got, cpu, 1e-12, 0.0)
    assert "Cpu" not in sess.last_executed_plan.tree_string()
