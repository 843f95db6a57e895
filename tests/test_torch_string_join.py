"""String join keys and string payloads in the port against the
reference, on the CPU.

``TpuShuffledHashJoinExec`` over string keys of one, two and four chunk
words (bytes bounded by 4, 8 and 16), where the two sides bound their
keys on their own (a build of 8-byte keys against a probe of 16-byte
keys: the shorter side's words are zero-padded, and a probe key that
only shares the build key's first 8 bytes must not match), with a
string payload on both sides and duplicate and null keys. The reference
runs once per dataset and join type (SEARCH); every port tier (SEARCH,
DIRECT, RADIX, PALLAS on the probe kernel's plain version, and AUTO)
must give the same rows in the same order. Also the key words against
the reference's, the RADIX tier's segment broadcast against the
``cummax`` it replaces, and TPC-DS q8/q24's zip join through both
sessions and the CPU engine. Everything here is exact.
"""
import functools

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.exec import InMemoryScanExec as JScan
from spark_rapids_tpu.exec.join import TpuShuffledHashJoinExec as JJoin
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr.eval import ColV as JColV
from spark_rapids_tpu.expr.eval import StrV as JStrV
from spark_rapids_tpu.ops import join as RJ
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                         TpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.values import ColV, StrV
from spark_rapids_tpu_torch.ops import join as J
from spark_rapids_tpu_torch.ops.radix_bin import segment_start_broadcast
from spark_rapids_tpu_torch.ops.sort import str_max_lens
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

from test_torch_string_keys import _planes, _strings

JOINS = ("inner", "left", "right", "full", "semi", "anti", "inner_cond")
STRATEGIES = ("SEARCH", "DIRECT", "RADIX", "PALLAS", "AUTO")
_PREFIX = "abcdefgh"
#: key pools: (probe keys, build keys), each side's longest key giving
#: its word count
POOLS = {
    # one word a side: at most 4 bytes
    "w1": (["", "a", "a\x00", "ab", "abc", "abcd", "é", "zz", "q"],
           ["", "a", "ab", "abcd", "é", "zz", "x"]),
    # two words: up to 8 bytes
    "w2": (["abcde", _PREFIX, _PREFIX[:7], "日本語", "a", "", "abcdefg\x00"],
           [_PREFIX, "abcde", "abcdX", "日本語", "a", "zzzzzzzz"]),
    # a probe of 16-byte keys (4 words) against a build of 8-byte ones
    # (2 words): keys sharing the build's 8 bytes must not match
    "unequal": ([_PREFIX, _PREFIX + "X", _PREFIX + "\x00",
                 _PREFIX + "ijklmnop", "abc", "", "zzzzzzzz" + "zzzzzzz"],
                [_PREFIX, "abc", "", "zzzzzzzz", "abcdefgi"]),
}


def _side(pool, n, seed, nulls):
    rng = np.random.default_rng(seed)
    keys = [None if rng.random() < nulls else pool[int(rng.integers(
        0, len(pool)))] for _ in range(n)]
    return {"k": keys, "a": [int(x) for x in rng.integers(0, 50, n)],
            "p": _strings(seed + 7, n, 0.2)}


@functools.lru_cache(maxsize=None)
def _dataset(name):
    probe_pool, build_pool = POOLS[name]
    return (_side(probe_pool, 60, 1, 0.1),
            {f"{c}2": v for c, v in _side(build_pool, 25, 2, 0.1).items()})


def _schemas(m):
    T_ = m
    return (T_.StructType((T_.StructField("k", T_.STRING),
                           T_.StructField("a", T_.LONG),
                           T_.StructField("p", T_.STRING))),
            T_.StructType((T_.StructField("k2", T_.STRING),
                           T_.StructField("a2", T_.LONG),
                           T_.StructField("p2", T_.STRING))))


def _how(join):
    return "inner" if join == "inner_cond" else join


@functools.lru_cache(maxsize=None)
def _reference_rows(dataset, join):
    ld, rd = _dataset(dataset)
    ls, rs = _schemas(JT)
    conf = JConf({"spark.rapids.tpu.sql.join.strategy": "SEARCH"})
    cond = (JE.GreaterThan(JE.col("a2"), JE.col("a"))
            if join == "inner_cond" else None)
    j = JJoin(conf, JScan(conf, [[JBatch.from_pydict(ld, ls)]], ls),
              JScan(conf, [[JBatch.from_pydict(rd, rs)]], rs),
              [JE.col("k")], [JE.col("k2")], _how(join), cond)
    return j.collect()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("join", JOINS)
@pytest.mark.parametrize("dataset", sorted(POOLS))
def test_string_join_rows_in_reference_order(dataset, join, strategy):
    want = _reference_rows(dataset, join)
    ld, rd = _dataset(dataset)
    ls, rs = _schemas(T)
    conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": strategy})
    cond = (E.GreaterThan(E.col("a2"), E.col("a"))
            if join == "inner_cond" else None)
    j = TpuShuffledHashJoinExec(
        conf,
        InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
            ld, ls, device="cpu")]], ls),
        InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
            rd, rs, device="cpu")]], rs),
        [E.col("k")], [E.col("k2")], _how(join), cond)
    assert j.collect() == want, j.describe()
    if strategy != "AUTO":
        assert f"strategy={strategy}" in j.describe()


def test_unequal_widths_do_not_match_on_a_shared_prefix():
    """The probe's 16-byte keys against the build's 8-byte ones: a key
    that shares only the build key's 8 bytes finds no row."""
    b = StrV(*(torch.from_numpy(a) for a in _planes([_PREFIX], 128)))
    p = StrV(*(torch.from_numpy(a) for a in _planes(
        [_PREFIX, _PREFIX + "X"], 128)))
    bml, pml = str_max_lens([b]), str_max_lens([p])
    bw, _ = J.radix_key_words([b], [T.STRING], bml)
    pw, _ = J.radix_key_words([p], [T.STRING], pml)
    assert (len(bw), len(pw)) == (2, 4)
    bw, pw = J.pad_key_words(bw, pw, J.key_word_widths([b], bml),
                             J.key_word_widths([p], pml))
    live = torch.arange(128) < 2
    for strategy in ("SEARCH", "DIRECT", "RADIX", "PALLAS"):
        lo, hi = J.probe_ranges(bw, 1, pw, live, strategy)
        assert (hi - lo)[:2].tolist() == [1, 0], strategy


#: multi-key joins whose string keys the two sides bound apart: the
#: build's first key fits 8 bytes; the probe comes in two batches, one
#: of keys of at most 4 bytes and one of up to 16, so each key is widened
#: on the build side in one batch and on the probe side in the other
MULTI_POOLS = {
    "string_long": (
        (["abc", "", "zz", "ab", "é"], [0, 1, 2]),
        ([_PREFIX, _PREFIX + "X", "abcdefghijklmnop", "abc", "zz"],
         [0, 1, 2]),
        ([_PREFIX, "abc", "", "zz", "abcdefgi"], [0, 1, 2])),
    "string_string": (
        (["abc", "", "zz", "ab"], ["x", "", "q", "y"]),
        ([_PREFIX, _PREFIX + "X", "abc", "abcdefghijklmnop"],
         ["abcdefghijkl", "x", "abcdefghijklmnopq", ""]),
        ([_PREFIX, "abc", "", "zz"], ["x", "abcdefghijkl", "", "q"])),
}


def _multi_rows(pools, n, seed):
    rng = np.random.default_rng(seed)
    s_pool, t_pool = pools
    rows = []
    for i in range(n):
        s = None if rng.random() < 0.1 else s_pool[int(rng.integers(
            0, len(s_pool)))]
        t = t_pool[int(rng.integers(0, len(t_pool)))]
        rows.append((s, t, "p%d" % (seed * 100 + i)))
    return rows


def _multi_oracle(left, right, how):
    """Plain nested-loop equi-join on the first two columns (null keys
    never match), for every join type."""
    def key(r):
        return None if r[0] is None or r[1] is None else r[:2]

    def hits(row, others):
        k = key(row)
        return [o for o in others if k is not None and key(o) == k]

    nl, nr = len(left[0]), len(right[0])
    if how == "semi":
        return [l for l in left if hits(l, right)]
    if how == "anti":
        return [l for l in left if not hits(l, right)]
    out = []
    if how == "right":
        for r in right:
            ms = hits(r, left)
            out += [l + r for l in ms] or [(None,) * nl + r]
        return out
    for l in left:
        ms = hits(l, right)
        out += [l + r for r in ms]
        if not ms and how in ("left", "full"):
            out.append(l + (None,) * nr)
    if how == "full":
        out += [(None,) * nl + r for r in right if not hits(r, left)]
    return out


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("join", JOINS[:-1])
@pytest.mark.parametrize("dataset", sorted(MULTI_POOLS))
def test_multi_key_join_with_unequal_string_widths(dataset, join,
                                                   strategy):
    """(string, long) and (string, string) keys whose string bounds
    differ between the build and each probe batch find every true match
    and nothing else: each key's words are padded right after its own
    (the reference pads at the end of the word list and loses these
    rows, ROADMAP.md §C)."""
    short, wide, build = MULTI_POOLS[dataset]
    k2 = T.LONG if dataset == "string_long" else T.STRING
    ls = T.StructType((T.StructField("s", T.STRING), T.StructField("t", k2),
                       T.StructField("p", T.STRING)))
    rs = T.StructType((T.StructField("s2", T.STRING),
                       T.StructField("t2", k2),
                       T.StructField("p2", T.STRING)))
    probes = [_multi_rows(short, 40, 1), _multi_rows(wide, 40, 2)]
    brows = _multi_rows(build, 30, 3)
    conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": strategy})
    j = TpuShuffledHashJoinExec(
        conf,
        InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
            dict(zip(("s", "t", "p"), zip(*rows))), ls, device="cpu")
            for rows in probes]], ls),
        InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
            dict(zip(("s2", "t2", "p2"), zip(*brows))), rs,
            device="cpu")]], rs),
        [E.col("s"), E.col("t")], [E.col("s2"), E.col("t2")], join)
    want = _multi_oracle(probes[0] + probes[1], brows, join)
    got = j.collect()
    assert sorted(got, key=repr) == sorted(want, key=repr), j.describe()
    # both probe batches hold true matches
    assert all(_multi_oracle(rows, brows, "inner") for rows in probes)


def test_reference_pads_multi_key_words_at_the_end():
    """The smallest input of the reference's fault (ROADMAP.md §C): key
    (s, i), a build of one 8-byte s and a probe batch whose longest s
    needs 16 bytes. The reference finds no row for the true match; the
    port finds it."""
    ls = (("s", "STRING"), ("i", "LONG"))
    rows = ({"s": [_PREFIX, _PREFIX + "i"], "i": [7, 7]},
            {"s2": [_PREFIX], "i2": [7]})

    def plan(m, scan, join, conf, batch, **kw):
        left = m.StructType(tuple(m.StructField(n, getattr(m, t))
                                  for n, t in ls))
        right = m.StructType(tuple(m.StructField(n + "2", getattr(m, t))
                                   for n, t in ls))
        return join(conf, scan(conf, [[batch.from_pydict(
            rows[0], left, **kw)]], left), scan(conf, [[batch.from_pydict(
                rows[1], right, **kw)]], right),
            [m_col("s"), m_col("i")], [m_col("s2"), m_col("i2")],
            "inner").collect()

    m_col = JE.col
    ref = plan(JT, JScan, JJoin, JConf({}), JBatch)
    m_col = E.col
    got = plan(T, InMemoryScanExec, TpuShuffledHashJoinExec, RapidsConf({}),
               ColumnarBatch, device="cpu")
    assert got == [(_PREFIX, 7, _PREFIX, 7)]
    assert ref == []


@pytest.mark.parametrize("lens", [(), (4,), (8, 16), (64, 4)])
def test_radix_key_words_match_reference(lens):
    s = _planes(_strings(3, 100), 128)
    t = _planes(_strings(4, 100, 0.3), 128)
    i = np.random.default_rng(5).integers(-9, 9, 128)
    iv = np.arange(128) % 9 != 0
    ref, rnull = RJ.radix_key_words(
        [JStrV(*(jnp.asarray(a) for a in s)),
         JColV(jnp.asarray(i), jnp.asarray(iv)),
         JStrV(*(jnp.asarray(a) for a in t))],
        [JT.STRING, JT.LONG, JT.STRING], lens)
    # the reference bounds a string key past ``lens`` by 64 bytes; the
    # port needs every bound given
    got, gnull = J.radix_key_words(
        [StrV(*(torch.from_numpy(a.copy()) for a in s)),
         ColV(torch.from_numpy(i), torch.from_numpy(iv)),
         StrV(*(torch.from_numpy(a.copy()) for a in t))],
        [T.STRING, T.LONG, T.STRING], tuple(lens) + (64,) * (2 - len(lens)))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(r).astype(np.int64))
    np.testing.assert_array_equal(gnull.numpy(), np.asarray(rnull))


@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_segment_start_broadcast_equals_the_cummax(n):
    """The cumsum + scatter + gather equals the ``torch.cummax`` it
    replaced on the values the RADIX merge feeds it (nondecreasing across
    segment starts), rows before the first flag (-1) included."""
    g = torch.Generator().manual_seed(n)
    flags = torch.rand(n, generator=g) < 0.2
    if n > 2:
        flags[:2] = False
    values = torch.cumsum(torch.randint(0, 3, (n,), generator=g),
                          0).to(torch.int32)
    marked = torch.where(flags, values, -1)
    old = torch.cummax(marked, 0).values if n else marked
    assert torch.equal(segment_start_broadcast(flags, values), old)


# ---------------------------------------------------------------------------
# TPC-DS q8/q24's join on a zip code, through both sessions
# ---------------------------------------------------------------------------
def _zip_frames(m, sess, n=1 << 12, dim=500, seed=18):
    T_ = m
    rng = np.random.default_rng(seed)
    cities = ["Oakwood", "Riverside", "Fairview", "Midway", "Greenville",
              "Five Points", "Pleasant Hill", "Centerville"]
    states = ["AK", "CA", "NY", "TX", "WA"]
    zips = rng.permutation(dim)
    drows = [("%05d" % z, cities[int(rng.integers(0, len(cities)))],
              states[int(rng.integers(0, len(states)))]) for z in zips]
    frows = []
    for _ in range(n):
        r = rng.random()
        z = (None if r < 0.05 else "X%04d" % rng.integers(0, 999)
             if r < 0.07 else "%05d" % rng.integers(0, dim))
        frows.append((z, round(float(rng.uniform(0, 300)), 2)))
    fact = sess.from_rows(frows, T_.StructType((
        T_.StructField("zip", T_.STRING),
        T_.StructField("net_paid", T_.DOUBLE))))
    dimf = sess.from_rows(drows, T_.StructType((
        T_.StructField("dzip", T_.STRING), T_.StructField("city", T_.STRING),
        T_.StructField("state", T_.STRING))))
    return fact, dimf


def _q18(m, sess):
    T_, E_, A_ = m
    fact, dim = _zip_frames(T_, sess)
    return (fact.join(dim, [("zip", "dzip")], "inner")
            .group_by("city")
            .agg(A_.agg(A_.Count(None), "n"),
                 A_.agg(A_.Sum(E_.col("net_paid")), "s"),
                 A_.agg(A_.Min(E_.col("state")), "mn"),
                 A_.agg(A_.Max(E_.col("state")), "mx")))


def _close_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(sorted(got), sorted(want)):
        assert g[:2] == w[:2] and g[3:] == w[3:], (g, w)
        assert abs(g[2] - w[2]) <= 1e-12 * abs(w[2]), (g, w)


@functools.lru_cache(maxsize=None)
def _cpu_engine_rows():
    return _q18((T, E, A), PSession({"spark.rapids.tpu.sql.enabled": False},
                                    device="cpu")).collect()


@pytest.mark.parametrize("strategy", ["AUTO", "PALLAS"])
def test_zip_join_matches_reference_and_cpu_engine(strategy):
    conf = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
            "spark.rapids.tpu.sql.join.strategy": strategy}
    ref = _q18((JT, JE, JA), JSession(conf)).collect()
    sess = PSession(conf, device="cpu")
    got = _q18((T, E, A), sess).collect()
    _close_rows(got, ref)
    _close_rows(got, _cpu_engine_rows())
    plan = sess.last_executed_plan.tree_string()
    assert "Cpu" not in plan and "TpuShuffledHashJoinExec" in plan


def test_expanded_pool_refuses_an_int32_overflow(monkeypatch):
    """An expansion whose string payload would reach 2^31 bytes raises
    instead of wrapping its int32 offsets."""
    from spark_rapids_tpu_torch.exec import join as XJ
    from spark_rapids_tpu_torch.ops import concat as C

    monkeypatch.setattr(C, "MAX_POOL_BYTES", 10)
    s = StrV(*(torch.from_numpy(a) for a in _planes(["abcdef"], 128)))
    rows = torch.zeros(4, dtype=torch.int32)
    live = torch.ones(4, dtype=torch.bool)
    assert XJ._expanded_pools([([s], rows[:1], live[:1])]) == [[128]]
    with pytest.raises(ValueError, match="int32"):
        XJ._expanded_pools([([s], rows, live)])
