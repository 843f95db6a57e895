"""The port's own copy of the CPU engine (``cpu/plan.py`` over
``cpu/interpreter.py``) against the reference's, plan for plan.

The port session falls back to this engine, and it is the oracle of the
differential tests, so every ``Cpu*Exec`` must give the reference's rows
exactly, in the reference's order. Each case builds the same plan from
both packages' own classes (same names and fields) over the same seeded
rows: scan, filter, project, grouped and grand aggregates, every join
type, sorts, windows, limits, union, expand, generate and range.
"""
import math

import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import conf as JC
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.cpu import plan as JP
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr import windows as JW
from spark_rapids_tpu_torch import conf as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.cpu import plan as PP
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.expr import windows as PW

REF = dict(T=JT, E=JE, A=JA, W=JW, C=JP, conf=JC.RapidsConf({}))
PORT = dict(T=T, E=PE, A=PA, W=PW, C=PP, conf=PC.RapidsConf({}))


def _rows(seed=5, n=120):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 6)) if rng.random() > 0.1 else None
        v = int(rng.integers(-1000, 1000)) if rng.random() > 0.15 else None
        d = float(rng.normal() * 100) if rng.random() > 0.1 else None
        if i % 17 == 0:
            d = [float("nan"), -0.0, 0.0, float("inf")][i % 4]
        s = ["a", "bb", "", "ccc", None, "bb"][i % 6]
        out.append((k, v, d, s))
    return out


def _schema(m):
    T_ = m["T"]
    return T_.StructType((T_.StructField("k", T_.INT),
                          T_.StructField("v", T_.LONG),
                          T_.StructField("d", T_.DOUBLE),
                          T_.StructField("s", T_.STRING)))


def _scan(m, parts=2, seed=5):
    rows = _rows(seed)
    per = -(-len(rows) // parts)
    return m["C"].CpuScanExec(
        m["conf"], [rows[i * per:(i + 1) * per] for i in range(parts)],
        _schema(m))


def _dim(m):
    T_ = m["T"]
    rows = [(k, f"name{k}", None if k is None else k * 1.5)
            for k in (0, 1, 2, 2, 7, None)]
    return m["C"].CpuScanExec(m["conf"], [rows], T_.StructType((
        T_.StructField("dk", T_.INT), T_.StructField("name", T_.STRING),
        T_.StructField("w", T_.DOUBLE))))


def _filter(m):
    E = m["E"]
    return m["C"].CpuFilterExec(
        m["conf"], E.And(E.GreaterThan(E.col("v"), E.Literal.of(-500)),
                         E.IsNotNull(E.col("k"))), _scan(m))


def _project(m):
    E = m["E"]
    T_ = m["T"]
    return m["C"].CpuProjectExec(m["conf"], [
        E.col("k"),
        E.Alias(E.Pmod(E.col("v"), E.Literal.of(7)), "pm"),
        E.Alias(E.Round(E.col("d"), 1), "r"),
        E.Alias(E.Length(E.col("s")), "len"),
        E.Alias(E.Cast(E.col("v"), T_.DOUBLE), "vd"),
        E.Alias(E.If(E.IsNull(E.col("d")), E.Literal.of(-1.0),
                     E.Sqrt(E.Abs(E.col("d")))), "sq"),
    ], _filter(m))


def _agg(m, keys=("k",), parts=2):
    E, A = m["E"], m["A"]
    return m["C"].CpuHashAggregateExec(m["conf"], [E.col(k) for k in keys], [
        A.agg(A.Sum(E.col("v")), "s"),
        A.agg(A.Count(E.col("d")), "c"),
        A.agg(A.Count(), "n"),
        A.agg(A.Average(E.col("v")), "a"),
        A.agg(A.Min(E.col("d")), "mn"),
        A.agg(A.Max(E.col("v")), "mx"),
        A.agg(A.First(E.col("v")), "f"),
        A.agg(A.Last(E.col("d")), "l"),
    ], _scan(m, parts))


def _sort(m, asc=True, nulls_first=None):
    E = m["E"]
    return m["C"].CpuSortExec(m["conf"], [E.col("k"), E.col("v")],
                              [(asc, nulls_first), (not asc, None)],
                              _scan(m))


def _join(m, how):
    E = m["E"]
    return m["C"].CpuJoinExec(m["conf"], _scan(m, 1), _dim(m), [E.col("k")],
                              [E.col("dk")], how, None)


def _window(m, func_name):
    E, A, W = m["E"], m["A"], m["W"]
    spec = W.WindowSpec((E.col("k"),), (E.col("v"),), ((True, None),))
    funcs = {
        "row_number": W.RowNumber(),
        "rank": W.Rank(),
        "dense_rank": W.DenseRank(),
        "lead": W.Lead(E.col("v"), 1),
        "lag": W.Lag(E.col("d"), 2),
        "running_sum": A.Sum(E.col("v")),
        "whole_count": A.Count(E.col("d")),
    }
    f = funcs[func_name]
    if func_name == "whole_count":
        spec = W.WindowSpec((E.col("k"),))
    return m["C"].CpuWindowExec(
        m["conf"], [W.WindowExpression(f, spec, func_name)], _scan(m, 1))


PLANS = {
    "scan": lambda m: _scan(m),
    "filter": _filter,
    "project": _project,
    "aggregate_grouped": lambda m: _agg(m),
    "aggregate_two_keys": lambda m: _agg(m, ("k", "s")),
    "aggregate_grand": lambda m: _agg(m, ()),
    "sort_asc": lambda m: _sort(m),
    "sort_desc_nulls_first": lambda m: _sort(m, False, True),
    "local_limit": lambda m: m["C"].CpuLocalLimitExec(m["conf"], 7,
                                                      _scan(m)),
    "collect_limit": lambda m: m["C"].CpuCollectLimitExec(m["conf"], 75,
                                                          _scan(m)),
    "union": lambda m: m["C"].CpuUnionExec(m["conf"],
                                           [_scan(m), _scan(m, 3, 9)]),
    "expand": lambda m: m["C"].CpuExpandExec(
        m["conf"], [[m["E"].col("k"), m["E"].Literal.of(1)],
                    [m["E"].col("v"), m["E"].Literal.of(2)]],
        ["x", "tag"], _scan(m)),
    "generate": lambda m: m["C"].CpuGenerateExec(
        m["conf"], [m["E"].col("v"), m["E"].Literal.of(0)], "g", True,
        _scan(m, 1)),
    "range": lambda m: m["C"].CpuRangeExec(m["conf"], -5, 40, 3, 2, "id"),
}
for _how in ("inner", "left", "right", "full", "semi", "anti"):
    PLANS[f"join_{_how}"] = lambda m, h=_how: _join(m, h)
for _f in ("row_number", "rank", "dense_rank", "lead", "lag", "running_sum",
           "whole_count"):
    PLANS[f"window_{_f}"] = lambda m, f=_f: _window(m, f)


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, float):
        return (type(b) is float and a == b
                and math.copysign(1, a) == math.copysign(1, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_cpu_engine_matches_reference(plan):
    ref = PLANS[plan](REF)
    got = PLANS[plan](PORT)
    assert [f.name for f in got.output_schema.fields] == \
        [f.name for f in ref.output_schema.fields]
    assert [f.dataType.simpleString for f in got.output_schema.fields] == \
        [f.dataType.simpleString for f in ref.output_schema.fields]
    rr, gr = ref.collect(), got.collect()
    assert len(gr) == len(rr) and len(rr) > 0
    for r, g in zip(rr, gr):
        assert len(r) == len(g)
        assert all(_same(a, b) for a, b in zip(r, g)), (r, g)
