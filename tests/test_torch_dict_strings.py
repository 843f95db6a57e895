"""Dictionary-encoded string columns in the port against the reference, on
the CPU: every string expression the port lowers, through the DictV
routes and with each package's ``DICT_MATERIALIZE_EAGERLY`` seam flipped
(the ``dict_mode`` fixture), on the same seeded rows; the column layer;
all-null and empty dictionaries; ``dict_rewrap``; a transformed key; a
mixed dictionary/plain concat; filter -> project keeping the dictionary;
and the native UDF over a dictionary column.

Strings, validity, codes and dictionaries must be equal bit for bit, and
the rows must equal the port's CPU engine, for the item-15 nodes too
(``tests/test_torch_string_exprs.py`` holds the rest of them).
"""
import os
import random

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar import column as jcolmod
from spark_rapids_tpu.columnar.batch import schema_of as jschema_of
from spark_rapids_tpu.columnar.column import \
    column_from_pylist as jcolumn_from_pylist
from spark_rapids_tpu.columnar.column import \
    dict_column_from_pylist as jdict_from_pylist
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.exec import InMemoryScanExec as JScan
from spark_rapids_tpu.exec import TpuFilterExec as JFilter
from spark_rapids_tpu.exec import TpuHashAggregateExec as JAgg
from spark_rapids_tpu.exec import TpuProjectExec as JProject
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import bind_references as jbind
from spark_rapids_tpu.expr import evaluate_projection as jevaluate
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.udf import native as RN
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (ColumnarBatch,
                                             column_from_pylist,
                                             dict_column_from_pylist,
                                             schema_of)
from spark_rapids_tpu_torch.columnar import column as colmod
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.cpu import eval_expression_rows
from spark_rapids_tpu_torch.exec import (InMemoryScanExec, TpuFilterExec,
                                         TpuHashAggregateExec,
                                         TpuProjectExec)
from spark_rapids_tpu_torch.exec.basic import TpuCoalesceBatchesExec
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.eval import evaluate_projection
from spark_rapids_tpu_torch.expr.values import (DictV, StrV, dict_rewrap,
                                                materialize_dict)
from spark_rapids_tpu_torch.udf import string_word_count

N = 96
#: the reference test's pool: empties, case, pattern metacharacters,
#: multibyte UTF-8, pads, numerics
POOL = ["alpha-001", "beta-smallX", "", "Gamma%_x", "delta verylong-value-42",
        "üñé-mixed", "a.b.c", "  pad  ", "X", "tail-9", "42", "-7"]


def make_rows(seed=0, n=N, null_prob=0.15):
    rng = random.Random(seed)

    def gen():
        return None if rng.random() < null_prob else rng.choice(POOL)

    return [gen() for _ in range(n)], [gen() for _ in range(n)]


def batches(s, t):
    """The same rows in both packages: ``s`` dictionary-encoded, ``t``
    plain."""
    jb = JBatch([jdict_from_pylist(s, JT.STRING),
                 jcolumn_from_pylist(t, JT.STRING)],
                jschema_of(s=JT.STRING, t=JT.STRING), len(s))
    pb = ColumnarBatch([dict_column_from_pylist(s, device="cpu"),
                        column_from_pylist(t, T.STRING, device="cpu")],
                       schema_of(s=T.STRING, t=T.STRING), len(s))
    return jb, pb


@pytest.fixture(params=["dict", "materialized"])
def dict_mode(request, monkeypatch):
    """Each test body twice: on the dictionary routes, and with both
    packages' materialize-eagerly seam flipped."""
    eager = request.param == "materialized"
    monkeypatch.setattr(colmod, "DICT_MATERIALIZE_EAGERLY", eager)
    monkeypatch.setattr(jcolmod, "DICT_MATERIALIZE_EAGERLY", eager)
    return request.param


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_column(ref, got):
    """Rows equal; a dictionary-encoded result on both sides with the
    same dictionary, codes (valid rows), validity and metadata."""
    assert got.to_host().to_pylist() == ref.to_pylist()
    assert got.is_dict == ref.is_dict
    if ref.is_dict:
        r, g = ref.dictv, got.dictv
        rv, gv = _np(r.validity), _np(g.validity)
        np.testing.assert_array_equal(gv, rv)
        np.testing.assert_array_equal(_np(g.codes)[gv], _np(r.codes)[rv])
        ro, go = _np(r.dictionary.offsets), _np(g.dictionary.offsets)
        np.testing.assert_array_equal(go, ro)
        np.testing.assert_array_equal(_np(g.dictionary.chars)[:go[-1]],
                                      _np(r.dictionary.chars)[:ro[-1]])
        assert (g.mat_cap, g.max_len, g.unique) == (r.mat_cap, r.max_len,
                                                    r.unique)


def check(build, seed=0, null_prob=0.15):
    s, t = make_rows(seed, null_prob=null_prob)
    jb, pb = batches(s, t)
    [ref] = jevaluate([jbind(build(JE, JT), jb.schema)], jb)
    bound = E.bind_references(build(E, T), pb.schema)
    [got] = evaluate_projection([bound], pb)
    assert_same_column(ref, got)
    assert got.to_host().to_pylist() == eval_expression_rows(
        bound, list(zip(s, t)))


def _null(M, TT):
    return M.Literal(None, TT.STRING)


#: the reference test's STRING_OPS rows whose nodes the port lowers
STRING_OPS = [
    ("upper", lambda M, TT: M.Upper(M.col("s"))),
    ("lower", lambda M, TT: M.Lower(M.col("s"))),
    ("length", lambda M, TT: M.Length(M.col("s"))),
    ("substring", lambda M, TT: M.Substring(M.col("s"), M.lit(2),
                                            M.lit(3))),
    ("substring_neg", lambda M, TT: M.Substring(M.col("s"), M.lit(-4),
                                                M.lit(3))),
    ("trim", lambda M, TT: M.StringTrim(M.col("s"))),
    ("ltrim", lambda M, TT: M.StringTrimLeft(M.col("s"))),
    ("rtrim", lambda M, TT: M.StringTrimRight(M.col("s"))),
    ("startswith", lambda M, TT: M.StartsWith(M.col("s"), M.lit("a"))),
    ("endswith", lambda M, TT: M.EndsWith(M.col("s"), M.lit("1"))),
    ("contains", lambda M, TT: M.Contains(M.col("s"), M.lit("X"))),
    ("eq_lit", lambda M, TT: M.EqualTo(M.col("s"), M.lit("alpha-001"))),
    ("eq_null_safe_lit",
     lambda M, TT: M.EqualNullSafe(M.col("s"), M.lit("X"))),
    ("eq_null_safe_null",
     lambda M, TT: M.EqualNullSafe(M.col("s"), _null(M, TT))),
    ("lt_lit", lambda M, TT: M.LessThan(M.col("s"), M.lit("delta"))),
    ("le_lit", lambda M, TT: M.LessThanOrEqual(M.col("s"), M.lit("X"))),
    ("gt_lit", lambda M, TT: M.GreaterThan(M.col("s"), M.lit("42"))),
    ("ge_lit_flipped",
     lambda M, TT: M.GreaterThanOrEqual(M.lit("delta"), M.col("s"))),
    ("lt_null_lit", lambda M, TT: M.LessThan(M.col("s"), _null(M, TT))),
    ("cmp_dict_vs_plain",
     lambda M, TT: M.LessThanOrEqual(M.col("s"), M.col("t"))),
    ("cast_string_identity", lambda M, TT: M.Cast(M.col("s"), TT.STRING)),
    ("concat_mixed",
     lambda M, TT: M.Concat((M.col("s"), M.lit("-"), M.col("t")))),
    ("concat_dict_dict", lambda M, TT: M.Concat((M.col("s"), M.col("s")))),
    ("upper_of_substring", lambda M, TT: M.Upper(
        M.Substring(M.col("s"), M.lit(1), M.lit(6)))),
    ("length_of_trim", lambda M, TT: M.Length(M.StringTrim(M.col("s")))),
    ("is_null", lambda M, TT: M.IsNull(M.col("s"))),
]


@pytest.mark.parametrize("build", [b for _, b in STRING_OPS],
                         ids=[k for k, _ in STRING_OPS])
def test_string_op_matches_reference(build, dict_mode):
    check(build, seed=7)


#: string nodes of item 15, on a dictionary input
NOT_PORTED = [
    ("in_list", lambda M, TT: M.In(M.col("s"), ("X", "", "nope"))),
    ("cast_int", lambda M, TT: M.Cast(M.col("s"), TT.INT)),
    ("if_mixed", lambda M, TT: M.If(M.Contains(M.col("s"), M.lit("a")),
                                    M.col("s"), M.col("t"))),
    ("coalesce", lambda M, TT: M.Coalesce((M.col("s"), M.col("t")))),
    ("like", lambda M, TT: M.Like(M.col("s"), M.lit("%a%1%"))),
    ("initcap", lambda M, TT: M.InitCap(M.col("s"))),
]


@pytest.mark.parametrize("build", [b for _, b in NOT_PORTED],
                         ids=[k for k, _ in NOT_PORTED])
def test_item_15_nodes_raise_on_a_dictionary(build, dict_mode):
    """Named for when these nodes raised (item 15): each now takes the
    reference's dictionary route and gives its column and the CPU
    engine's rows."""
    check(build, seed=3)


@pytest.mark.parametrize("null_prob", [1.0, 0.0], ids=["all_null",
                                                         "no_null"])
def test_all_null_and_full_dictionaries(dict_mode, null_prob):
    check(lambda M, TT: M.Upper(M.col("s")), seed=11, null_prob=null_prob)
    check(lambda M, TT: M.EqualTo(M.col("s"), M.lit("X")), seed=12,
          null_prob=null_prob)
    check(lambda M, TT: M.Length(M.col("s")), seed=13, null_prob=null_prob)


def test_empty_dictionary_column():
    """No rows at all and only null rows: the dictionary is one empty
    entry, as in the reference, and every route reads it."""
    for values in ([], [None] * 5):
        jc = jdict_from_pylist(values, JT.STRING)
        pc = dict_column_from_pylist(values, device="cpu")
        assert pc.dictv.dict_size == jc.dictv.dict_size == 1
        assert (pc.dictv.mat_cap, pc.dictv.max_len) == (jc.dictv.mat_cap,
                                                        jc.dictv.max_len)
        assert pc.to_host().to_pylist() == values
        assert pc.materialize().to_host().to_pylist() == values
        assert pc.capacity == jc.capacity and pc.is_string


def test_column_round_trip_and_materialize():
    s, _ = make_rows(seed=3)
    jc = jdict_from_pylist(s, JT.STRING)
    pc = dict_column_from_pylist(s, device="cpu")
    assert pc.is_dict and pc.is_string and pc.capacity == jc.capacity
    assert_same_column(jc, pc)
    mat = pc.materialize()
    assert not mat.is_dict
    assert mat.to_host().to_pylist() == s
    jm = jc.materialize()
    np.testing.assert_array_equal(_np(mat.offsets), _np(jm.offsets))
    np.testing.assert_array_equal(_np(mat.chars), _np(jm.chars))
    batch = ColumnarBatch([pc], schema_of(s=T.STRING), len(s))
    assert [r[0] for r in batch.to_rows()] == s


def test_dict_rewrap_folds_entry_nulls_and_clears_unique():
    """A kernel over the dictionary ("a", "b", "c") whose entry "b" comes
    back null: the rows coding it turn null, the dictionary's validity is
    all true, and ``unique`` is cleared unless asked for."""
    pc = dict_column_from_pylist(["b", "a", None, "a", "c"], device="cpu")
    v = pc.dictv
    d = v.dictionary
    out = StrV(d.offsets, d.chars, torch.tensor([True, False, True]))
    w = dict_rewrap(v, out)
    assert isinstance(w, DictV) and not w.unique
    assert w.validity[:5].tolist() == [False, True, False, True, True]
    assert bool(w.dictionary.validity.all())
    assert (w.mat_cap, w.max_len) == (v.mat_cap, v.max_len)
    assert dict_rewrap(v, out, unique=True).unique
    s = materialize_dict(w)
    assert s.offsets[:6].tolist() == [0, 0, 1, 1, 2, 3]


def test_filter_project_keeps_the_dictionary(dict_mode):
    """filter contains(s, 'a') -> project (upper(s)[1:6], length(s), s):
    the projected strings stay dictionary-encoded on the dictionary
    route, and the rows equal the reference's and an oracle's."""
    s, t = make_rows(seed=31)
    jb, pb = batches(s, t)
    jconf, conf = JConf(), RapidsConf({})

    def plan(M, Scan, Filter, Project, b, cf):
        f = Filter(cf, M.Contains(M.col("s"), M.lit("a")),
                   Scan(cf, [[b]], b.schema))
        return Project(cf, [
            M.Alias(M.Substring(M.Upper(M.col("s")), M.lit(1), M.lit(6)),
                    "u"),
            M.Alias(M.Length(M.col("s")), "ln"), M.col("s")], f)

    want = [(x.upper()[:6], len(x), x) for x in s
            if x is not None and "a" in x]
    got_plan = plan(E, InMemoryScanExec, TpuFilterExec, TpuProjectExec, pb,
                    conf)
    out = list(got_plan.execute_columnar())
    assert all(b.columns[0].is_dict == (dict_mode == "dict")
               and b.columns[2].is_dict == (dict_mode == "dict")
               for b in out)
    rows = [r for b in out for r in b.to_rows()]
    assert rows == want
    assert rows == plan(JE, JScan, JFilter, JProject, jb, jconf).collect()


def _groupby_oracle(keys, vals):
    out = {}
    for k, v in zip(keys, vals):
        c, s_ = out.get(k, (0, 0))
        out[k] = (c + 1, s_ + v)
    return sorted(((k, c, s_) for k, (c, s_) in out.items()), key=repr)


def test_groupby_on_a_transformed_dict_key(dict_mode):
    """upper() clears ``unique`` (entries can merge): the key
    materializes and groups by bytes, in both packages."""
    n = 96
    rng = random.Random(22)
    keys = [rng.choice(["ab", "AB", "aB", "c", ""]) for _ in range(n)]
    vals = [rng.randrange(100) for _ in range(n)]
    jschema, schema = jschema_of(k=JT.STRING, v=JT.LONG), schema_of(
        k=T.STRING, v=T.LONG)
    jb = JBatch([jdict_from_pylist(keys, JT.STRING),
                 jcolumn_from_pylist(vals, JT.LONG)], jschema, n)
    pb = ColumnarBatch([dict_column_from_pylist(keys, device="cpu"),
                        column_from_pylist(vals, T.LONG, device="cpu")],
                       schema, n)

    def plan(M, AA, Scan, Project, Agg, b, cf):
        proj = Project(cf, [M.Alias(M.Upper(M.col("k")), "k"), M.col("v")],
                       Scan(cf, [[b]], b.schema))
        return Agg(cf, [M.col("k")], [AA.agg(AA.Count(M.col("v")), "c"),
                                      AA.agg(AA.Sum(M.col("v")), "sv")],
                   proj)

    agg = plan(E, A, InMemoryScanExec, TpuProjectExec, TpuHashAggregateExec,
               pb, RapidsConf({}))
    got = sorted(agg.collect(), key=repr)
    assert got == _groupby_oracle([k.upper() for k in keys], vals)
    ref = plan(JE, JA, JScan, JProject, JAgg, jb, JConf()).collect()
    assert got == sorted(ref, key=repr)
    assert "string keys: sort path" in agg.describe()
    assert "codes" not in agg.describe()


def test_mixed_dict_and_plain_concat(dict_mode):
    """One dictionary batch and one plain batch of the same column
    through the coalescing exec: the dictionary materializes for the
    splice, in both packages."""
    from spark_rapids_tpu.exec import TpuCoalesceBatchesExec as JCoalesce

    s1, _ = make_rows(seed=51, n=40)
    s2, _ = make_rows(seed=52, n=24)
    s3, _ = make_rows(seed=53, n=30)
    schema, jschema = schema_of(s=T.STRING), jschema_of(s=JT.STRING)
    pbs = [ColumnarBatch([dict_column_from_pylist(s1, device="cpu")],
                         schema, 40),
           ColumnarBatch([column_from_pylist(s2, T.STRING, device="cpu")],
                         schema, 24),
           ColumnarBatch([dict_column_from_pylist(s3, device="cpu")],
                         schema, 30)]
    jbs = [JBatch([jdict_from_pylist(s1, JT.STRING)], jschema, 40),
           JBatch([jcolumn_from_pylist(s2, JT.STRING)], jschema, 24),
           JBatch([jdict_from_pylist(s3, JT.STRING)], jschema, 30)]
    co = TpuCoalesceBatchesExec(RapidsConf({}),
                                InMemoryScanExec(RapidsConf({}), [pbs],
                                                 schema), target_rows=1000)
    got = [r[0] for r in co.collect()]
    assert got == s1 + s2 + s3
    ref = JCoalesce(JConf(), JScan(JConf(), [jbs], jschema),
                    target_rows=1000).collect()
    assert got == [r[0] for r in ref]


WC_ROWS = ["hello world", None, "  one  ", "", "a b\tc", "hello world"]


def test_native_udf_over_a_dictionary_column():
    """The reference's word-count UDF asserts a StrV and fails on the
    DictV its lowering hands it (``udf/native.py:111``, ROADMAP.md §C);
    the port materializes the DictV first and gives the plain column's
    answer."""
    jschema, schema = jschema_of(s=JT.STRING), schema_of(s=T.STRING)
    jb = JBatch([jdict_from_pylist(WC_ROWS, JT.STRING)], jschema,
                len(WC_ROWS))
    bound = jbind(RN.string_word_count(JE.col("s")), jschema)
    with pytest.raises(AssertionError, match="string column"):
        jevaluate([bound], jb)
    plain = JBatch([jcolumn_from_pylist(WC_ROWS, JT.STRING)], jschema,
                   len(WC_ROWS))
    [want] = jevaluate([bound], plain)
    pb = ColumnarBatch([dict_column_from_pylist(WC_ROWS, device="cpu")],
                       schema, len(WC_ROWS))
    pbound = E.bind_references(string_word_count(E.col("s")), schema)
    [got] = evaluate_projection([pbound], pb)
    assert got.to_host().to_pylist() == want.to_pylist() == [
        2, None, 1, 0, 3, 2]


def test_parquet_all_null_chunk_gets_one_zero_slot(tmp_path, dict_mode):
    """An all-null string chunk carries an empty dictionary page: the
    scan pads it to one empty entry, and both sessions read the same
    rows."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    from spark_rapids_tpu.io.scan_cache import DeviceScanCache as JCache
    from spark_rapids_tpu.sql.session import TpuSession as JSession
    from spark_rapids_tpu_torch.exec.scan import TpuFileSourceScanExec
    from spark_rapids_tpu_torch.io import parquet as PPQ
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

    t = pa.table({"s": pa.array([None] * 300, pa.string()),
                  "k": pa.array(np.arange(300, dtype=np.int32))})
    path = os.path.join(str(tmp_path), "nulls.parquet")
    pq.write_table(t, path, row_group_size=128)
    JCache.reset()
    DeviceScanCache.reset()
    want = JSession({}).read.parquet(path).collect()
    sess = PSession({}, device="cpu")
    got = sess.read.parquet(path).collect()
    assert got == want == [(None, i) for i in range(300)]
    conf = RapidsConf({})
    scan = TpuFileSourceScanExec(conf, PPQ.ParquetScanner(path, conf),
                                 "parquet", "cpu")
    out = [b for p in range(scan.num_partitions)
           for b in scan.execute_partition(p)]
    assert len(out) == 3
    for b in out:
        d = b.columns[0].dictv
        assert d is not None and d.dict_size == 1 and d.unique
        assert d.dictionary.offsets.tolist() == [0, 0]
        assert not bool(d.validity.any())
    DeviceScanCache.reset()
