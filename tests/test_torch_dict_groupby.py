"""Dictionary-encoded group keys and min/max inputs in the port against the
reference, on the CPU.

A unique dictionary key groups on its int32 codes through the hash tiers
in both packages (``ops/groupby.py:983-1017``) under AUTO, SCATTER and
PALLAS (the port's kernel wrappers run their plain versions on CPU
tensors); a DictV min/max input reduces over the ranks of a sort of its
dictionary (``_dict_rank``), grouped and grand; several batches carry
different dictionaries, so the partials' keys materialize before the
merge. Group sets, strings, counts and integer sums are exact; f64 sums
within rtol 1e-12 on the order-preserving tiers and within rtol 1e-4 /
atol 1e-6 where the reference sums f32 hi/lo pairs (PALLAS).
"""
import math
import random

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.batch import schema_of as jschema_of
from spark_rapids_tpu.columnar.column import \
    column_from_pylist as jcolumn_from_pylist
from spark_rapids_tpu.columnar.column import \
    dict_column_from_pylist as jdict_from_pylist
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.exec import InMemoryScanExec as JScan
from spark_rapids_tpu.exec import TpuHashAggregateExec as JAgg
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (ColumnarBatch,
                                             column_from_pylist,
                                             dict_column_from_pylist,
                                             schema_of)
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import InMemoryScanExec, \
    TpuHashAggregateExec
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.values import ColV, DictV
from spark_rapids_tpu_torch.ops import groupby as G

POOL = ["alpha-001", "beta-smallX", "", "Gamma%_x", "delta verylong-value-42",
        "üñé-mixed", "a.b.c", "  pad  ", "X", "tail-9", "42", "-7"]
BRANDS = [f"brand#{i:03d}" for i in range(40)]


def _tol(strategy):
    return (1e-4, 1e-6) if strategy == "PALLAS" else (1e-12, 0.0)


def _same(got, want, rtol, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert abs(a - b) <= atol + rtol * abs(b), (g, w)
            else:
                assert a == b, (g, w)


def _rows(seed, n):
    """(s, k, v, f, m, p) per row: s a pooled key (15% null), k a small
    int (10% null), v a long, f a double (10% null), m a brand name (20%
    null, dictionary-encoded), p the same names as a plain column."""
    rng = random.Random(seed)

    def maybe(x, p):
        return None if rng.random() < p else x

    out = []
    for _ in range(n):
        b = maybe(rng.choice(BRANDS), 0.2)
        out.append((maybe(rng.choice(POOL), 0.15), maybe(rng.randrange(4),
                                                         0.1),
                    rng.randrange(-10**9, 10**9),
                    maybe(rng.uniform(-1e3, 1e3), 0.1), b, b))
    return out


NAMES = ("s", "k", "v", "f", "m", "p")
DICT_COLS = ("s", "m")


def _scans(sizes, seed=5):
    """One scan per package over batches of ``sizes`` rows, each batch
    with dictionaries of its own (the distinct values it holds)."""
    rows = _rows(seed, sum(sizes))
    jtypes = dict(s=JT.STRING, k=JT.INT, v=JT.LONG, f=JT.DOUBLE,
                  m=JT.STRING, p=JT.STRING)
    ptypes = dict(s=T.STRING, k=T.INT, v=T.LONG, f=T.DOUBLE, m=T.STRING,
                  p=T.STRING)
    js, ps = jschema_of(**jtypes), schema_of(**ptypes)
    jbs, pbs = [], []
    at = 0
    for n in sizes:
        cols = list(zip(*rows[at:at + n]))
        at += n
        jc, pc = [], []
        for nm, vals in zip(NAMES, cols):
            vals = list(vals)
            if nm in DICT_COLS:
                jc.append(jdict_from_pylist(vals, jtypes[nm]))
                pc.append(dict_column_from_pylist(vals, device="cpu"))
            else:
                jc.append(jcolumn_from_pylist(vals, jtypes[nm]))
                pc.append(column_from_pylist(vals, ptypes[nm],
                                             device="cpu"))
        jbs.append(JBatch(jc, js, n))
        pbs.append(ColumnarBatch(pc, ps, n))
    return ((lambda conf: JScan(conf, [jbs], js)),
            (lambda conf: InMemoryScanExec(conf, [pbs], ps)), rows)


def _aggs(m, keys):
    E_, A_ = m
    return ([E_.col(k) for k in keys],
            [A_.agg(A_.Count(None), "n"), A_.agg(A_.Sum(E_.col("v")), "sv"),
             A_.agg(A_.Sum(E_.col("f")), "sf"),
             A_.agg(A_.Min(E_.col("m")), "mn"),
             A_.agg(A_.Max(E_.col("m")), "mx"),
             A_.agg(A_.Max(E_.col("p")), "mp")])


def _oracle(rows, keys):
    """The aggregate of ``_aggs`` in Python (f64 sums by math.fsum)."""
    idx = [NAMES.index(k) for k in keys]
    groups = {}
    for r in rows:
        groups.setdefault(tuple(r[i] for i in idx), []).append(r)
    out = []
    for key, rs in groups.items():
        fs = [r[3] for r in rs if r[3] is not None]
        ms = [r[4] for r in rs if r[4] is not None]
        mb = [m.encode() for m in ms]
        out.append(key + (len(rs), sum(r[2] for r in rs),
                          math.fsum(fs) if fs else None,
                          min(mb).decode() if ms else None,
                          max(mb).decode() if ms else None,
                          max(mb).decode() if ms else None))
    return sorted(out, key=repr)


#: (strategy, keys, batch sizes): the dictionary key alone and beside an
#: int key, in one batch (the partial's keys stay encoded) and in three
#: (each with its own dictionaries: the merge materializes), and the
#: grand aggregate (dictionary min/max over ranks)
EXEC_CASES = [("AUTO", "s", (150,)), ("SCATTER", "s", (70, 1, 100)),
              ("PALLAS", "s", (150,)), ("PALLAS", "s_k", (70, 1, 100)),
              ("SCATTER", "k_s", (150,)), ("AUTO", "k", (70, 100)),
              ("AUTO", "none", (70, 1, 100)), ("PALLAS", "none", (150,))]


@pytest.mark.parametrize("strategy,keys,sizes", EXEC_CASES,
                         ids=[f"{a}-{b}-{len(c)}" for a, b, c in EXEC_CASES])
def test_exec_matches_reference(strategy, keys, sizes):
    names = [] if keys == "none" else keys.split("_")
    jscan, pscan, rows = _scans(sizes)
    conf = {"spark.rapids.tpu.sql.agg.strategy": strategy,
            "spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    jc, pc = JConf(conf), RapidsConf(conf)
    ref = sorted(JAgg(jc, *_aggs((JE, JA), names), jscan(jc)).collect(),
                 key=repr)
    agg = TpuHashAggregateExec(pc, *_aggs((E, A), names), pscan(pc))
    got = sorted(agg.collect(), key=repr)
    if "s" in names and len(names) > 1 and len(sizes) > 1:
        # the reference's multi-key code-key merge truncates the keys'
        # bytes (test_reference_multi_key_code_merge_fault)
        assert len(ref) != len(got)
    else:
        _same(got, ref, *_tol(strategy))
    _same(got, _oracle(rows, names), *_tol(strategy))
    d = agg.describe()
    if "s" in names:
        assert f"update: {G.DICT_CODE_ROUTE}" in d, d
        merged = len(sizes) > 1
        assert (G.STRING_KEY_ROUTE in d) == merged, d


def _dict_val(values, cap=None):
    return dict_column_from_pylist(values, capacity=cap,
                                   device="cpu").dictv


@pytest.mark.parametrize("strategy", ["SCATTER", "PALLAS"])
def test_unique_dict_key_groups_on_codes(strategy):
    """``groupby_agg`` on a unique DictV key: the code route, a DictV key
    out over the same dictionary (``unique`` kept, ``mat_cap`` the
    dictionary's bytes bucketed), equal to grouping the plain strings."""
    rng = random.Random(9)
    keys = [None if rng.random() < 0.1 else rng.choice(POOL)
            for _ in range(200)]
    vals = torch.tensor([rng.randrange(1000) for _ in range(200)] + [0] * 56)
    k = _dict_val(keys)
    live = torch.arange(256) < 200
    v = ColV(vals, live.clone())
    routes = []
    out_k, out_a, n = G.groupby_agg([k], [T.STRING], [v, None],
                                    ["sum", "count_star"], 200,
                                    strategy=strategy, str_max_lens=[64],
                                    routes=routes)
    assert routes == [G.DICT_CODE_ROUTE]
    dk = out_k[0]
    assert isinstance(dk, DictV) and dk.unique
    assert dk.dictionary is k.dictionary and dk.max_len == k.max_len
    assert dk.mat_cap == 128
    n = int(n)
    col = dict_column_from_pylist([], device="cpu")
    col.dictv, col.validity = dk, dk.validity
    col.length = n
    got = sorted(zip(col.to_host(n).to_pylist(), out_a[0].data[:n].tolist(),
                     out_a[1].data[:n].tolist()), key=repr)
    want = {}
    for kk, vv in zip(keys, vals.tolist()):
        s_, c_ = want.get(kk, (0, 0))
        want[kk] = (s_ + vv, c_ + 1)
    assert got == sorted(((kk, s_, c_) for kk, (s_, c_) in want.items()),
                         key=repr)


def test_non_unique_dict_key_takes_the_string_sort_path():
    """A DictV with ``unique`` cleared (after a transforming kernel)
    materializes and sorts by bytes, with its bound from ``max_len``."""
    k = _dict_val(["b", "a", "b", None, "c"])
    k.unique = False
    routes = []
    out_k, out_a, n = G.groupby_agg([k], [T.STRING], [None], ["count_star"],
                                    5, str_max_lens=[4], routes=routes)
    assert routes == [G.STRING_KEY_ROUTE]
    assert not isinstance(out_k[0], DictV)
    n = int(n)
    off = out_k[0].offsets
    got = [(bytes(out_k[0].chars[off[i]:off[i + 1]].tolist()).decode()
            if out_k[0].validity[i] else None, int(out_a[0].data[i]))
           for i in range(n)]
    assert got == [(None, 1), ("a", 1), ("b", 2), ("c", 1)]


def test_dict_key_without_a_bound_raises():
    """Each string key, dictionary-encoded too, takes its slot of
    ``str_max_lens``: a missing one raises rather than guess."""
    k = _dict_val(["a", "b"])
    with pytest.raises(ValueError, match="byte bound"):
        G.groupby_agg([k], [T.STRING], [None], ["count_star"], 2)


def test_dict_rank_orders_the_dictionary_bytewise():
    """``_dict_rank``: the dictionary's entries sorted as unsigned bytes
    (an entry order that is not sorted, as a parquet file's may be), each
    row's rank through its code, null rows masked."""
    from spark_rapids_tpu_torch.columnar import dict_column_from_parts

    entries = [b"zeta", b"", b"\xc3\xa9t\xc3\xa9", b"alpha", b"Zulu"]
    doff = np.cumsum([0] + [len(e) for e in entries]).astype(np.int32)
    codes = np.array([0, 1, 2, 3, 4, 2, 0, 1], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool)
    c = dict_column_from_parts(8, codes, doff,
                               np.frombuffer(b"".join(entries), np.uint8),
                               valid, mat_cap=128, max_len=5, unique=True,
                               device="cpu")
    order, rank = G._dict_rank(c.dictv)
    assert [entries[i] for i in order.tolist()] == sorted(entries)
    by = {e: r for r, e in enumerate(sorted(entries))}
    want = [by[entries[k]] for k in codes]
    assert rank.validity.tolist() == valid.tolist()
    assert [r for r, ok in zip(rank.data.tolist(), valid) if ok] == [
        w for w, ok in zip(want, valid) if ok]


def test_reference_multi_key_code_merge_fault():
    """A reference fault the port does not copy (ROADMAP.md §C): the
    reference rewraps a code key's output with its dictionary's bytes as
    ``mat_cap`` (``groupby.py:1003-1013``), but beside another key one
    entry heads several groups, so the merge's materialization cuts the
    keys' bytes. Smallest input: one 100-byte entry under two int keys in
    one batch (200 bytes of keys for a 128-byte pool), and a second
    batch."""
    big = "x" * 100
    parts = [([big, big], [0, 1]), (["y"], [0])]
    jschema = jschema_of(s=JT.STRING, k=JT.INT)
    schema = schema_of(s=T.STRING, k=T.INT)
    jbs = [JBatch([jdict_from_pylist(s_, JT.STRING),
                   jcolumn_from_pylist(k_, JT.INT)], jschema, len(s_))
           for s_, k_ in parts]
    pbs = [ColumnarBatch([dict_column_from_pylist(s_, device="cpu"),
                          column_from_pylist(k_, T.INT, device="cpu")],
                         schema, len(s_)) for s_, k_ in parts]
    want = [(big, 0, 1), (big, 1, 1), ("y", 0, 1)]

    def plan(M, AA, Scan, Agg, bs, sch, cf):
        return Agg(cf, [M.col("s"), M.col("k")],
                   [AA.agg(AA.Count(None), "n")], Scan(cf, [bs], sch))

    ref = sorted(plan(JE, JA, JScan, JAgg, jbs, jschema, JConf()).collect())
    got = sorted(plan(E, A, InMemoryScanExec, TpuHashAggregateExec, pbs,
                      schema, RapidsConf({})).collect())
    assert got == want
    # the reference's first key keeps 28 of its bytes, NUL-padded, and
    # two groups merge
    assert ref != want and any("\x00" in r[0] for r in ref)
