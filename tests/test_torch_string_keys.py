"""String keys in the port's sort, hash, concat and window layers against
the reference's, on the CPU.

The same numpy-seeded strings go through the reference
(``spark_rapids_tpu``, under ``JAX_PLATFORMS=cpu``) and the port
(``device="cpu"``, the plain versions). Exact throughout: the chunk words
(``ops/sort.string_chunk_keys``), ``max_string_len``, Murmur3 over
strings, every sort permutation (ASC/DESC x nulls first/last, pad rows
included) and the rows of the execs, in order. The strings cover the
empty string, multi-byte UTF-8, common prefixes of 3, 4, 5, 8, 9, 16 and
17 bytes, bytes above 0x7f and ``"a"`` against ``"a\\x00"``: zero-padded
chunks give those two equal keys, in the reference's sort, group-by and
join alike, and the port keeps the reference's answer (ROADMAP.md §C).
"""
import itertools

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.exec import InMemoryScanExec as JScan
from spark_rapids_tpu.exec.basic import TpuCoalesceBatchesExec as JCoalesce
from spark_rapids_tpu.exec.sort import TpuSortExec as JSort
from spark_rapids_tpu.exec.window import TpuWindowExec as JWindow
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr import windows as JW
from spark_rapids_tpu.expr.eval import ColV as JColV
from spark_rapids_tpu.expr.eval import StrV as JStrV
from spark_rapids_tpu.ops import concat as JC
from spark_rapids_tpu.ops import hashing as JH
from spark_rapids_tpu.ops import sort as JS
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import InMemoryScanExec
from spark_rapids_tpu_torch.exec.basic import TpuCoalesceBatchesExec
from spark_rapids_tpu_torch.exec.sort import TpuSortExec
from spark_rapids_tpu_torch.exec.window import TpuWindowExec
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr import windows as W
from spark_rapids_tpu_torch.expr.values import ColV, StrV
from spark_rapids_tpu_torch.ops import concat as C
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.ops import sort as S
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

_BASE = "abcdefghijklmnopqrstuvwxyz"
#: the edge cases: empty, NUL-padded, UTF-8, and common prefixes
EDGE = (["", "a", "a\x00", "a\x00\x00", "\x00", "é", "ü", "日本", "\U0001F600",
         "ÿ", "b", "ab"]
        + [p + s for L in (3, 4, 5, 8, 9, 16, 17) for p in [_BASE[:L]]
           for s in ("", "x", "\x00", "é", "\x7f")])
ORDERS = list(itertools.product([True, False], [True, False]))


def _strings(seed, n, null_share=0.1):
    """``n`` strings: the edge cases and random ones (with NUL and high
    code points), some null."""
    rng = np.random.default_rng(seed)
    alphabet = ["a", "b", "\x00", "é", "z", "日"]
    out = []
    for i in range(n):
        if rng.random() < null_share:
            out.append(None)
        elif rng.random() < 0.5:
            out.append(EDGE[int(rng.integers(0, len(EDGE)))])
        else:
            k = int(rng.integers(0, 20))
            out.append("".join(alphabet[j] for j in
                               rng.integers(0, len(alphabet), k)))
    return out


def _planes(strs, cap):
    """(offsets (cap+1,) int32, chars, validity (cap,)) of ``strs`` padded
    to ``cap`` rows; the pool ends in non-zero garbage no row owns."""
    bs = [b"" if s is None else s.encode() for s in strs]
    lens = [len(b) for b in bs] + [0] * (cap - len(bs))
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    chars = np.frombuffer(b"".join(bs) + b"\xfe" * 7, np.uint8).copy()
    valid = np.array([s is not None for s in strs] + [False] * (cap - len(bs)))
    return off, chars, valid


def _jstr(p):
    return JStrV(*(jnp.asarray(a) for a in p))


def _pstr(p):
    return StrV(*(torch.from_numpy(a.copy()) for a in p))


def _eq(ref, got):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("max_len", [1, 4, 5, 8, 16, 32, 64])
def test_chunk_words_match_reference(max_len):
    p = _planes(_strings(1, 90), 128)
    for asc, nf in ORDERS:
        ref = JS.string_chunk_keys(_jstr(p), JS.SortOrder(asc, nf), max_len)
        got = S.string_chunk_keys(_pstr(p), S.SortOrder(asc, nf), max_len)
        assert len(ref) == len(got) == 1 + max(1, (max_len + 3) // 4)
        for r, g in zip(ref, got):
            _eq(np.asarray(r).astype(np.int64), g)


def test_max_string_len_and_its_bucket():
    for seed, cap in ((2, 128), (3, 256)):
        strs = _strings(seed, cap - 20)
        p = _planes(strs, cap)
        m = int(JS.max_string_len(_jstr(p)))
        assert int(S.max_string_len(_pstr(p))) == m
        assert S.str_max_lens([_pstr(p), ColV(torch.zeros(cap),
                                              torch.ones(cap, dtype=bool)),
                               _pstr(p)]) == (max(4, 1 << (m - 1).bit_length()),) * 2
    assert S.str_max_lens([_pstr(_planes(["", None], 128))]) == (4,)
    assert S.str_max_lens([]) == ()


@pytest.mark.parametrize("max_len", [4, 16, 64])
def test_murmur3_over_strings_matches_reference(max_len):
    p = _planes(_strings(4, 100), 128)
    ints = np.random.default_rng(4).integers(-9, 9, 128).astype(np.int32)
    iv = np.arange(128) % 7 != 0
    ref = JH.murmur3([_jstr(p), JColV(jnp.asarray(ints), jnp.asarray(iv))],
                     [JT.STRING, JT.INT], str_max_lens=[max_len])
    got = H.murmur3([_pstr(p), ColV(torch.from_numpy(ints),
                                    torch.from_numpy(iv))],
                    [T.STRING, T.INT], str_max_lens=[max_len])
    _eq(ref, got)


@pytest.mark.parametrize("asc,nulls_first", ORDERS)
@pytest.mark.parametrize("keys", ["s", "s_i", "i_s", "s_t"])
@pytest.mark.parametrize("rows", [100, 128])
def test_sort_permutation_matches_reference(asc, nulls_first, keys, rows):
    cap = 128
    s = _planes(_strings(5, rows), cap)
    t = _planes(_strings(6, rows, 0.3), cap)
    rng = np.random.default_rng(7)
    i = rng.integers(0, 3, cap).astype(np.int32)
    iv = rng.random(cap) < 0.9
    cols = {"s": (_jstr(s), _pstr(s), JT.STRING, T.STRING),
            "t": (_jstr(t), _pstr(t), JT.STRING, T.STRING),
            "i": (JColV(jnp.asarray(i), jnp.asarray(iv)),
                  ColV(torch.from_numpy(i), torch.from_numpy(iv)),
                  JT.INT, T.INT)}
    names = keys.split("_")
    # the second key sorts the other way round
    orders = [(asc, nulls_first), (not asc, not nulls_first)][:len(names)]
    lens = S.str_max_lens([cols[k][1] for k in names])
    ref = JS.sort_permutation(
        [cols[k][0] for k in names], [cols[k][2] for k in names],
        [JS.SortOrder(a, nf) for a, nf in orders], rows, lens)
    got = S.sort_permutation(
        [cols[k][1] for k in names], [cols[k][3] for k in names],
        [S.SortOrder(a, nf) for a, nf in orders], rows, lens)
    _eq(ref, got)
    # a bound above the longest row changes nothing
    wide = S.sort_permutation(
        [cols[k][1] for k in names], [cols[k][3] for k in names],
        [S.SortOrder(a, nf) for a, nf in orders], rows,
        [2 * x for x in lens])
    _eq(ref, wide)


def test_sort_cols_gathers_strings_as_reference():
    s = _planes(_strings(8, 120), 128)
    v = np.arange(128, dtype=np.int64)
    vv = np.ones(128, bool)
    ref = JS.sort_cols([_jstr(s), JColV(jnp.asarray(v), jnp.asarray(vv))],
                       [0], [JT.STRING], [JS.SortOrder(False, None)], 120,
                       [32])
    got = S.sort_cols([_pstr(s), ColV(torch.from_numpy(v),
                                      torch.from_numpy(vv))],
                      [0], [T.STRING], [S.SortOrder(False, None)], 120, [32])
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            _eq(a, b)


def _parts(seeds, caps, rows):
    return [(_planes(_strings(sd, n), cap), n)
            for sd, cap, n in zip(seeds, caps, rows)]


def test_concat_string_matches_reference():
    parts = _parts((9, 10, 11), (128, 256, 128), (100, 0, 77))
    lengths = [n for _, n in parts]
    nbytes = [int(p[0][n]) for p, n in parts]
    ref = JC.concat_string([_jstr(p) for p, _ in parts], lengths, nbytes,
                           256, 4096)
    got = C.concat_string([_pstr(p) for p, _ in parts], lengths, nbytes,
                          256, 4096)
    for r, g in zip(ref, got):
        _eq(r, g)
    assert got.offsets[-1] == sum(nbytes)


def test_concat_batches_cols_matches_reference():
    parts = _parts((12, 13, 14), (128, 128, 256), (50, 128, 200))
    rng = np.random.default_rng(15)
    fixed = [(rng.integers(-99, 99, p[2].shape[0]),
              rng.random(p[2].shape[0]) < 0.8) for p, _ in parts]
    lengths = [n for _, n in parts]
    nbytes = [[int(p[0][n])] for p, n in parts]
    ref, rn = JC.concat_batches_cols(
        [[JColV(jnp.asarray(d), jnp.asarray(v)), _jstr(p)]
         for (d, v), (p, _) in zip(fixed, parts)], lengths, nbytes, 512,
        [8192])
    got, gn = C.concat_batches_cols(
        [[ColV(torch.from_numpy(d), torch.from_numpy(v)), _pstr(p)]
         for (d, v), (p, _) in zip(fixed, parts)], lengths, nbytes, 512,
        [8192])
    assert rn == gn == sum(lengths)
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            _eq(a, b)


def test_concat_string_refuses_an_int32_overflow():
    p = _pstr(_planes(["ab"], 128))
    with pytest.raises(ValueError, match="int32"):
        C.concat_string([p, p], [1, 1], [2**30, 2**30], 256, 128)


# ---------------------------------------------------------------------------
# execs over several batches: coalesce, sort, window
# ---------------------------------------------------------------------------
SCHEMA = (("s", "STRING"), ("k", "INT"), ("t", "STRING"), ("v", "LONG"))


def _data(seed, n):
    rng = np.random.default_rng(seed)
    return {"s": _strings(seed, n), "k": [None if rng.random() < 0.1 else
                                          int(rng.integers(0, 4))
                                          for _ in range(n)],
            "t": _strings(seed + 100, n, 0.2),
            "v": [int(x) for x in rng.integers(-1000, 1000, n)]}


def _scans(sizes=(70, 1, 130)):
    js = JT.StructType(tuple(JT.StructField(a, getattr(JT, b))
                             for a, b in SCHEMA))
    ps = schema_of(**{a: getattr(T, b) for a, b in SCHEMA})
    datas = [_data(20 + i, n) for i, n in enumerate(sizes)]
    jscan = JScan(JConf({}), [[JBatch.from_pydict(d, js) for d in datas]],
                  js)
    pscan = InMemoryScanExec(RapidsConf({}), [[ColumnarBatch.from_pydict(
        d, ps, device="cpu") for d in datas]], ps)
    return jscan, pscan


def test_coalesce_concatenates_strings_as_reference():
    jscan, pscan = _scans()
    ref = JCoalesce(JConf({}), jscan, 150).collect()
    exec_ = TpuCoalesceBatchesExec(RapidsConf({}), pscan, 150)
    got = exec_.collect()
    assert got == ref
    assert [b.num_rows for b in exec_.execute_partition(0)] == [201]


@pytest.mark.parametrize("asc,nulls_first", ORDERS)
def test_sort_exec_string_keys_over_batches_as_reference(asc, nulls_first):
    jscan, pscan = _scans()
    orders = [(asc, nulls_first), (True, None), (not asc, None)]
    ref = JSort(JConf({}), [JE.col("s"), JE.col("k"), JE.col("t")], orders,
                jscan).collect()
    got = TpuSortExec(RapidsConf({}), [E.col("s"), E.col("k"), E.col("t")],
                      orders, pscan).collect()
    assert got == ref


@pytest.mark.parametrize("spec", ["string_partition", "string_order",
                                  "both_desc"])
def test_window_string_keys_as_reference(spec):
    part, order, orders = {
        "string_partition": (("s",), ("v",), ((True, None),)),
        "string_order": (("k",), ("t",), ((True, None),)),
        "both_desc": (("s",), ("t", "v"), ((False, True), (False, None))),
    }[spec]

    def build(m, X, scan, conf):
        ws = m.WindowSpec(tuple(m_col(X, c) for c in part),
                          tuple(m_col(X, c) for c in order), orders)
        fns = [m.WindowExpression(m.RowNumber(), ws, "rn"),
               m.WindowExpression(m.Rank(), ws, "rk"),
               m.WindowExpression(m.DenseRank(), ws, "drk"),
               m.WindowExpression(X[1].Sum(m_col(X, "v")), ws, "sv")]
        return X[2](conf, fns, scan)

    def m_col(X, c):
        return X[0].col(c)

    jscan, pscan = _scans()
    ref = build(JW, (JE, JA, JWindow), jscan, JConf({})).collect()
    got = build(W, (E, A, TpuWindowExec), pscan, RapidsConf({})).collect()
    assert got == ref


# ---------------------------------------------------------------------------
# through the sessions
# ---------------------------------------------------------------------------
def _item_rows(n=1 << 12, seed=19):
    """Q19's item table at 2^12 rows: 16-byte ids "AAAAAAAA" + eight
    letters A-P, TPC-DS categories, brand ids in [1, 1000], sales."""
    rng = np.random.default_rng(seed)
    cats = ["Books", "Children", "Electronics", "Home", "Jewelry", "Men",
            "Music", "Shoes", "Sports", "Women"]
    ids = rng.integers(0, 2**32, n)
    rows = []
    for i in range(n):
        item = "AAAAAAAA" + "".join(chr(65 + ((int(ids[i]) >> (4 * k)) & 15))
                                    for k in range(7, -1, -1))
        rows.append((item, cats[int(rng.integers(0, 10))],
                     int(rng.integers(1, 1001)), int(rng.integers(0, 10**6))))
    return rows


def _item_df(m, sess):
    T_ = m["T"]
    return sess.from_rows(_item_rows(), T_.StructType((
        T_.StructField("i_item_id", T_.STRING),
        T_.StructField("i_category", T_.STRING),
        T_.StructField("i_brand_id", T_.INT),
        T_.StructField("sales", T_.LONG))))


def _q19a(m, sess):
    return _item_df(m, sess).order_by("i_item_id", ascending=False).limit(100)


def _q19b(m, sess):
    W_, E_ = m["W"], m["E"]
    spec = W_.WindowSpec((E_.col("i_category"),), (E_.col("sales"),),
                         ((False, None),))
    return (_item_df(m, sess)
            .with_windows(W_.WindowExpression(W_.Rank(), spec, "rk"))
            .where(E_.LessThanOrEqual(E_.col("rk"), E_.Literal.of(3))))


def _q19c(m, sess):
    E_, A_ = m["E"], m["A"]
    return _item_df(m, sess).group_by("i_brand_id").agg(
        A_.agg(A_.Min(E_.col("i_item_id")), "mn"),
        A_.agg(A_.Max(E_.col("i_item_id")), "mx"),
        A_.agg(A_.Count(None), "n"))


REF = dict(T=JT, E=JE, A=JA, W=JW)
PORT = dict(T=T, E=E, A=A, W=W)


@pytest.mark.parametrize("query", ["q19a", "q19b", "q19c"])
def test_q19_shapes_match_reference_and_cpu_engine(query):
    q = {"q19a": _q19a, "q19b": _q19b, "q19c": _q19c}[query]
    ref = q(REF, JSession({})).collect()
    sess = PSession({}, device="cpu")
    got = q(PORT, sess).collect()
    cpu = q(PORT, PSession({"spark.rapids.tpu.sql.enabled": False},
                           device="cpu")).collect()
    ordered = query != "q19c"
    assert (got if ordered else sorted(got)) == (ref if ordered
                                                 else sorted(ref))
    assert (got if ordered else sorted(got)) == (cpu if ordered
                                                 else sorted(cpu))
    assert "Cpu" not in sess.last_executed_plan.tree_string()


def _nul_df(m, sess):
    T_ = m["T"]
    rows = [("a\x00", 1), ("a", 2), ("", 3), ("a\x00", 4), ("a", 5),
            ("a\x00\x00", 6), ("b", 7)]
    return sess.from_rows(rows, T_.StructType((T_.StructField("s", T_.STRING),
                                               T_.StructField("v", T_.INT))))


def _nul_sort(m, sess):
    return _nul_df(m, sess).order_by("s")


def _nul_group(m, sess):
    A_, E_ = m["A"], m["E"]
    return _nul_df(m, sess).group_by("s").agg(A_.agg(A_.Count(None), "n"),
                                              A_.agg(A_.Sum(E_.col("v")),
                                                     "sv"))


def _nul_join(m, sess):
    T_ = m["T"]
    dim = sess.from_rows([("a", 10), ("a\x00", 20)], T_.StructType((
        T_.StructField("d", T_.STRING), T_.StructField("w", T_.INT))))
    return _nul_df(m, sess).join(dim, [("s", "d")], "inner")


@pytest.mark.parametrize("query", ["sort", "group", "join"])
def test_trailing_nul_keys_merge_as_in_the_reference(query):
    """Zero-padded chunks make "a", "a\\x00" and "a\\x00\\x00" one key in
    the reference's sort (ties keep row order), group-by and join, where
    Spark and the CPU engine keep them apart: the port keeps the
    reference's answer (ROADMAP.md §C)."""
    q = {"sort": _nul_sort, "group": _nul_group, "join": _nul_join}[query]
    ref = q(REF, JSession({})).collect()
    got = q(PORT, PSession({}, device="cpu")).collect()
    cpu = q(PORT, PSession({"spark.rapids.tpu.sql.enabled": False},
                           device="cpu")).collect()
    if query == "sort":
        assert got == ref
        assert [r[1] for r in got] == [3, 1, 2, 4, 5, 6, 7]
        assert got != cpu
    else:
        assert sorted(got) == sorted(ref)
        assert sorted(got) != sorted(cpu)


def _long_computed_key(m, sess):
    T_, E_ = m["T"], m["E"]
    base = "x" * 70
    rows = [(base + "b", 1), (base + "a", 2), (base + "c", 3)]
    return sess.from_rows(rows, T_.StructType((
        T_.StructField("s", T_.STRING), T_.StructField("v", T_.INT)))
    ).order_by(E_.Upper(E_.col("s")))


def test_computed_string_key_sorts_by_every_byte():
    """A computed sort key is bounded by its own longest row, so keys that
    differ only past byte 64 still sort apart, as in the CPU engine. The
    reference bounds a computed key by 64 bytes (``exec/sort.py:87-97``)
    and ties them (ROADMAP.md §C, a kept divergence)."""
    got = _long_computed_key(PORT, PSession({}, device="cpu")).collect()
    cpu = _long_computed_key(PORT, PSession(
        {"spark.rapids.tpu.sql.enabled": False}, device="cpu")).collect()
    ref = _long_computed_key(REF, JSession({})).collect()
    assert [r[1] for r in got] == [r[1] for r in cpu] == [2, 1, 3]
    assert [r[1] for r in ref] == [1, 2, 3]
