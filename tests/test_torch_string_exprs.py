"""The other string expressions (LIKE, RLIKE, regexp_replace, replace,
locate, the pads, substring_index, split_part, initcap, the casts from
and to strings, string ``In`` and string selection) against the
reference, on the CPU.

Every node goes through both packages' ``evaluate_projection`` on the
same seeded rows, on a dictionary-encoded column (its DictV route, and
with both packages' materialize-eagerly seam flipped: the ``dict_mode``
fixture) and on a plain one. Strings, validity, codes, dictionaries and
their metadata must be equal bit for bit, and the rows must equal the
port's CPU engine. The casts' edges (INT64_MIN and MAX, 19 and 20
digits, signs, blanks, overflow) are pinned against the reference and
the CPU engine; so is one reference fault the port does not copy. Two
small TPC-H queries (Q13 with its LIKE, Q22 with its ``substring ... in``)
run through both packages' sessions, and the planner gives the
reference's fallback reasons for the patterns neither device lowers.
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.batch import schema_of as jschema_of
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import bind_references as jbind
from spark_rapids_tpu.expr import evaluate_projection as jevaluate
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
from spark_rapids_tpu_torch.cpu import eval_expression_rows
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr import eval_strings as ES
from spark_rapids_tpu_torch.expr.eval import evaluate_projection
from spark_rapids_tpu_torch.ops import regex_kernels
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

from test_torch_dict_strings import check, dict_mode  # noqa: F401
from test_torch_plananalysis import comparable_explain


def _on(col):
    """Build the node over column ``col``: ``s`` is dictionary-encoded,
    ``t`` plain (``test_torch_dict_strings.batches``)."""
    def cases(build):
        return lambda M, TT: build(M, TT, M.col(col))
    return cases


#: (name, build(M, TT, c)) over a string column c
NODES = [
    ("initcap", lambda M, TT, c: M.InitCap(c)),
    ("like_pct", lambda M, TT, c: M.Like(c, M.lit("%a%1%"))),
    ("like_anchored", lambda M, TT, c: M.Like(c, M.lit("a%-%1"))),
    ("like_prefix", lambda M, TT, c: M.Like(c, M.lit("delta%"))),
    ("like_suffix", lambda M, TT, c: M.Like(c, M.lit("%-9"))),
    ("like_underscore", lambda M, TT, c: M.Like(c, M.lit("_ail-_"))),
    ("like_underscore_utf8", lambda M, TT, c: M.Like(c, M.lit("_ñé-mixed"))),
    ("like_exact", lambda M, TT, c: M.Like(c, M.lit("X"))),
    ("like_all_pct", lambda M, TT, c: M.Like(c, M.lit("%%"))),
    ("like_empty", lambda M, TT, c: M.Like(c, M.lit(""))),
    ("like_escape", lambda M, TT, c: M.Like(c, M.lit("%\\%\\_x"))),
    ("like_null", lambda M, TT, c: M.Like(c, M.Literal(None, TT.STRING))),
    ("rlike_literal", lambda M, TT, c: M.RLike(c, M.lit("a\\.b"))),
    ("rlike_dot", lambda M, TT, c: M.RLike(c, M.lit("a.b"))),
    ("rlike_anchored", lambda M, TT, c: M.RLike(c, M.lit("^[a-z]+-[0-9]"))),
    ("rlike_end", lambda M, TT, c: M.RLike(c, M.lit("[0-9]$"))),
    ("rlike_utf8_class", lambda M, TT, c: M.RLike(c, M.lit("[^ -~]"))),
    ("regexp_replace", lambda M, TT, c: M.RegExpReplace(c, M.lit("a"),
                                                        M.lit("_Q_"))),
    ("regexp_replace_escaped", lambda M, TT, c: M.RegExpReplace(
        c, M.lit("\\."), M.lit(""))),
    ("replace_grow", lambda M, TT, c: M.StringReplace(c, M.lit("a"),
                                                      M.lit("zzz"))),
    ("replace_shrink", lambda M, TT, c: M.StringReplace(c, M.lit("-mi"),
                                                        M.lit("é"))),
    ("replace_empty_search", lambda M, TT, c: M.StringReplace(
        c, M.lit(""), M.lit("zz"))),
    ("replace_null", lambda M, TT, c: M.StringReplace(
        c, M.lit("a"), M.Literal(None, TT.STRING))),
    ("locate", lambda M, TT, c: M.StringLocate(M.lit("a"), c, M.lit(1))),
    ("locate_from_3", lambda M, TT, c: M.StringLocate(M.lit("-"), c,
                                                      M.lit(3))),
    ("locate_utf8", lambda M, TT, c: M.StringLocate(M.lit("m"), c,
                                                    M.lit(2))),
    ("locate_zero_start", lambda M, TT, c: M.StringLocate(M.lit("a"), c,
                                                          M.lit(0))),
    ("locate_null_start", lambda M, TT, c: M.StringLocate(
        M.lit("a"), c, M.Literal(None, TT.INT))),
    ("lpad", lambda M, TT, c: M.StringLPad(c, M.lit(8), M.lit("*"))),
    ("rpad", lambda M, TT, c: M.StringRPad(c, M.lit(8), M.lit("*"))),
    ("lpad_multi", lambda M, TT, c: M.StringLPad(c, M.lit(11),
                                                 M.lit("ab✓"))),
    ("rpad_cut", lambda M, TT, c: M.StringRPad(c, M.lit(3), M.lit("."))),
    ("lpad_zero", lambda M, TT, c: M.StringLPad(c, M.lit(0), M.lit("*"))),
    ("substring_index", lambda M, TT, c: M.SubstringIndex(c, M.lit("-"),
                                                          M.lit(1))),
    ("substring_index_neg", lambda M, TT, c: M.SubstringIndex(
        c, M.lit("."), M.lit(-2))),
    ("substring_index_zero", lambda M, TT, c: M.SubstringIndex(
        c, M.lit("."), M.lit(0))),
    ("split_part", lambda M, TT, c: M.StringSplitPart(c, M.lit("-"),
                                                      M.lit(1))),
    ("split_part_0", lambda M, TT, c: M.StringSplitPart(c, M.lit("."),
                                                        M.lit(0))),
    ("split_part_2", lambda M, TT, c: M.StringSplitPart(c, M.lit("."),
                                                        M.lit(2))),
    ("cast_int", lambda M, TT, c: M.Cast(c, TT.INT)),
    ("cast_bigint", lambda M, TT, c: M.Cast(c, TT.LONG)),
    ("cast_tinyint", lambda M, TT, c: M.Cast(c, TT.BYTE)),
    ("cast_bool", lambda M, TT, c: M.Cast(c, TT.BOOLEAN)),
    ("cast_roundtrip", lambda M, TT, c: M.Cast(M.Cast(c, TT.LONG),
                                               TT.STRING)),
    ("cast_bool_roundtrip", lambda M, TT, c: M.Cast(
        M.Contains(c, M.lit("a")), TT.STRING)),
    ("in_list", lambda M, TT, c: M.In(c, ("X", "üñé-mixed", "", "nope"))),
    ("in_list_null", lambda M, TT, c: M.In(c, ("42", None))),
    ("if_strings", lambda M, TT, c: M.If(M.Contains(c, M.lit("a")), c,
                                         M.col("t"))),
    ("if_null_branch", lambda M, TT, c: M.If(M.IsNull(M.col("t")), c,
                                             M.Literal(None, TT.STRING))),
    ("coalesce", lambda M, TT, c: M.Coalesce((c, M.col("t"),
                                              M.lit("none")))),
    ("case_when", lambda M, TT, c: M.CaseWhen(
        ((M.Contains(c, M.lit("a")), M.lit("has a")),
         (M.IsNull(c), M.col("t"))), c)),
    ("case_when_no_else", lambda M, TT, c: M.CaseWhen(
        ((M.StartsWith(c, M.lit("X")), c),), None)),
    ("like_of_initcap", lambda M, TT, c: M.Like(M.InitCap(c),
                                                M.lit("%X%"))),
]


@pytest.mark.parametrize("col", ["s", "t"], ids=["dict", "plain"])
@pytest.mark.parametrize("build", [b for _, b in NODES],
                         ids=[k for k, _ in NODES])
def test_item_15_node_matches_reference(build, col, dict_mode):
    check(_on(col)(build), seed=5)


def _strings_both(values):
    jb = JBatch.from_pydict({"s": values}, jschema_of(s=JT.STRING))
    pb = ColumnarBatch.from_pydict({"s": values}, schema_of(s=T.STRING),
                                   device="cpu")
    return jb, pb


def _cast_both(values, build, dictionary=False):
    jb, pb = _strings_both(values)
    if dictionary:
        from spark_rapids_tpu.columnar.column import \
            dict_column_from_pylist as jdict
        from spark_rapids_tpu_torch.columnar import dict_column_from_pylist

        jb = JBatch([jdict(values, JT.STRING)], jb.schema, len(values))
        pb = ColumnarBatch([dict_column_from_pylist(values, device="cpu")],
                           pb.schema, len(values))
    [ref] = jevaluate([jbind(build(JE, JT), jb.schema)], jb)
    bound = E.bind_references(build(E, T), pb.schema)
    [got] = evaluate_projection([bound], pb)
    cpu = eval_expression_rows(bound, [(v,) for v in values])
    return ref.to_pylist(), got.to_host().to_pylist(), cpu


INT_EDGES = [
    "9223372036854775807", "9223372036854775808", "-9223372036854775808",
    "-9223372036854775809", "18446744073709551615", "99999999999999999999",
    "0000000000000000000000042", "-0000000000000000000000042",
    "1000000000000000000", "9999999999999999999", "-9999999999999999999",
    "+9223372036854775807", "  -17  ", "\t+5\n", "", " ", "+", "-", "--1",
    "1-", "12 3", "0x10", "1e3", "3.0", None, "2147483647",
    "2147483648", "-2147483648", "-2147483649", "32767", "-32769", "127",
    "-128", "128", "-0", "007",
]


@pytest.mark.parametrize("to", ["LONG", "INT", "SHORT", "BYTE"])
def test_cast_string_to_int_edges(to):
    ref, got, cpu = _cast_both(
        INT_EDGES, lambda M, TT: M.Cast(M.col("s"), getattr(TT, to)))
    assert got == ref
    assert got == cpu


FLOAT_VALUES = [
    "1.5", "-2.25", "3", ".5", "5.", "1e3", "2.5e-2", "1E2", "-0.125",
    " 7.5 ", "inf", "-Infinity", "NaN", "abc", "1.2.3", "1e", "", None,
    "+4.5", "1e+2", "123456789012345678901234", "0.000000000000000000123",
    "1e308", "1e-310", "12.34e-5", "1e1e1", "-.5e1", "99.99",
]


@pytest.mark.parametrize("layout", ["plain", "dict"])
@pytest.mark.parametrize("to", ["DOUBLE", "FLOAT"])
def test_cast_string_to_float_matches_reference(to, layout):
    """The reference's parse (its pools start unsigned here: see the fault
    below); a dictionary casts its entries once. Exact where the
    reference's digit sum is exact (at most 15 digits, |exponent| small),
    else within the reference's own tolerance, rel 1e-12
    (``tests/data_gen.approx_equal``); a subnormal result is the one
    kept divergence."""
    ref, got, _ = _cast_both(
        FLOAT_VALUES, lambda M, TT: M.Cast(M.col("s"), getattr(TT, to)),
        dictionary=layout == "dict")
    assert len(got) == len(ref)
    for v, r, g in zip(FLOAT_VALUES, ref, got):
        assert (r is None) == (g is None), v
        if r is None or np.isnan(r):
            assert r is None or np.isnan(g), v
        elif 0 < abs(g) < np.finfo(np.float64).tiny:
            # the reference's backends flush a subnormal to zero
            # (ROADMAP.md §C, C2); the port keeps it, as its CPU engine
            assert r == 0.0, (v, r, g)
        elif sum(ch.isdigit() for ch in v) <= 15:
            assert r == g, (v, r, g)
        else:
            assert g == pytest.approx(r, rel=1e-12), (v, r, g)


def test_reference_string_to_float_sign_fault():
    """The reference reads every row without an exponent as exponent
    digits when the pool's first byte is a sign (``eval_strings.py:860-863``:
    its BIG marker + 1 wraps in int32), giving NULL or a wrong value; the
    port gives the CPU engine's answer."""
    vals = ["-1.5", "2.5", "3"]
    ref, got, cpu = _cast_both(vals, lambda M, TT: M.Cast(M.col("s"),
                                                          TT.DOUBLE))
    assert ref == [None, None, 3000.0]
    assert got == cpu == [-1.5, 2.5, 3.0]


def test_cast_int_to_string_edges():
    vals = [0, 1, -1, 2**63 - 1, -(2**63), 42, None, 10**18, -(10**18),
            999999999999999999, 10**9]
    jb = JBatch.from_pydict({"a": vals}, jschema_of(a=JT.LONG))
    pb = ColumnarBatch.from_pydict({"a": vals}, schema_of(a=T.LONG),
                                   device="cpu")
    [ref] = jevaluate([jbind(JE.Cast(JE.col("a"), JT.STRING), jb.schema)],
                      jb)
    [got] = evaluate_projection([E.bind_references(
        E.Cast(E.col("a"), T.STRING), pb.schema)], pb)
    assert got.to_host().to_pylist() == ref.to_pylist() == [
        None if v is None else str(v) for v in vals]


DATE_STRINGS = ["2020-01-01", " 2019-2-9 ", "2020-02-30", None, "x",
                "2020-12-31 23:59:59.5", "1969-12-31T00:00:01"]


@pytest.mark.parametrize("to", ["DATE", "TIMESTAMP"])
def test_cast_from_and_to_dates_matches_reference(to):
    """string -> date/timestamp -> string (ROADMAP item 6) on the same
    rows as the reference: every value and validity equal."""
    jb = JBatch.from_pydict({"s": DATE_STRINGS}, jschema_of(s=JT.STRING))
    pb = ColumnarBatch.from_pydict({"s": DATE_STRINGS},
                                   schema_of(s=T.STRING), device="cpu")
    exprs = [(M.Cast(M.col("s"), getattr(TT, to)),
              M.Cast(M.Cast(M.col("s"), getattr(TT, to)), TT.STRING))
             for M, TT in ((JE, JT), (E, T))]
    ref = jevaluate([jbind(e, jb.schema) for e in exprs[0]], jb)
    got = evaluate_projection([E.bind_references(e, pb.schema)
                               for e in exprs[1]], pb)
    for r, g in zip(ref, got):
        assert g.to_host().to_pylist() == r.to_pylist()
    assert got[1].to_host().to_pylist()[0].startswith("2020-01-01")


def test_float_to_string_stays_unsupported():
    from spark_rapids_tpu_torch.expr.values import UnsupportedExpressionError

    pb = ColumnarBatch.from_pydict({"d": [1.5]}, schema_of(d=T.DOUBLE),
                                   device="cpu")
    with pytest.raises(UnsupportedExpressionError, match="float -> string"):
        evaluate_projection([E.bind_references(
            E.Cast(E.col("d"), T.STRING), pb.schema)], pb)


def test_rlike_goes_through_the_dfa_and_caches_it():
    ES._DFA_CACHE.clear()
    jb, pb = _strings_both(["a-1", "b", None, "zz-9"])
    bound = E.bind_references(E.RLike(E.col("s"), E.lit("^[a-z]+-[0-9]")),
                              pb.schema)
    [got] = evaluate_projection([bound], pb)
    assert got.to_host().to_pylist() == [True, False, None, True]
    assert "^[a-z]+-[0-9]" in ES._DFA_CACHE
    assert regex_kernels.LAUNCHES["dfa_accept_rows"] == 0  # CPU: plain


# ---------------------------------------------------------------------------
# sessions: small TPC-H Q13 and Q22, and the tagging reasons
# ---------------------------------------------------------------------------
WORDS = ["special", "requests", "pending", "deposits", "furious", "sly",
         "ironic", "packages", "express", "accounts", "carefully", "final"]


def _tpch_rows(n_cust=120, n_ord=400, seed=3):
    rng = np.random.default_rng(seed)
    cust = []
    for k in range(1, n_cust + 1):
        cc = int(rng.integers(10, 35))
        phone = f"{cc}-{rng.integers(100, 1000)}-{rng.integers(100, 1000)}-" \
                f"{rng.integers(1000, 10000)}"
        bal = round(float(rng.uniform(-999.99, 9999.99)), 2)
        cust.append((k, phone, bal))
    orders = []
    for o in range(1, n_ord + 1):
        ck = int(rng.integers(1, n_cust + 1))
        if ck % 3 == 0:  # one customer in three has no orders
            ck += 1 if ck < n_cust else -1
        words = rng.choice(WORDS, int(rng.integers(2, 7)))
        orders.append((o, ck, " ".join(words)))
    return cust, orders


def _cust_schema(m):
    TT = m["T"]
    return TT.StructType((TT.StructField("c_custkey", TT.LONG),
                          TT.StructField("c_phone", TT.STRING),
                          TT.StructField("c_acctbal", TT.DOUBLE)))


def _ord_schema(m):
    TT = m["T"]
    return TT.StructType((TT.StructField("o_orderkey", TT.LONG),
                          TT.StructField("o_custkey", TT.LONG),
                          TT.StructField("o_comment", TT.STRING)))


REF = dict(T=JT, E=JE, A=JA)
PORT = dict(T=T, E=E, A=A)


def _q13(m, sess, pred):
    Em, Am = m["E"], m["A"]
    cust, orders = _tpch_rows()
    c = sess.from_rows(cust, _cust_schema(m))
    o = sess.from_rows(orders, _ord_schema(m)).where(pred(Em))
    return (c.join(o, [("c_custkey", "o_custkey")], how="left")
            .group_by("c_custkey")
            .agg(Am.agg(Am.Count(Em.col("o_orderkey")), "c_count"))
            .group_by("c_count").agg(Am.agg(Am.Count(), "custdist"))
            .order_by("custdist", "c_count", ascending=False))


Q13_PREDICATES = {
    "like": lambda M: M.Not(M.Like(M.col("o_comment"),
                                   M.lit("%special%requests%"))),
    "rlike_dfa": lambda M: M.Not(M.RLike(M.col("o_comment"),
                                         M.lit("^[a-z]+ (sly|furious)"))),
    # beyond the 16-state DFA in both packages: the filter falls back
    "rlike_refused": lambda M: M.Not(M.RLike(M.col("o_comment"),
                                             M.lit("special.*requests"))),
}


@pytest.mark.parametrize("pred", sorted(Q13_PREDICATES))
def test_tpch_q13_matches_reference(pred):
    p = Q13_PREDICATES[pred]
    ref = _q13(REF, JSession({}), p).collect()
    got = _q13(PORT, PSession({}, device="cpu"), p).collect()
    assert got == ref and len(got) > 1
    if pred == "rlike_refused":
        like = _q13(PORT, PSession({}, device="cpu"),
                    Q13_PREDICATES["like"]).collect()
        assert got == like


def _q22(m, sess):
    Em, Am, TT = m["E"], m["A"], m["T"]
    cust, orders = _tpch_rows()
    codes = ("13", "31", "23", "29", "30", "18", "17")

    def code(c):
        return Em.Substring(Em.col("c_phone"), Em.lit(1), Em.lit(2))

    def cust_df():
        return sess.from_rows(cust, _cust_schema(m))

    in_codes = Em.In(code(None), codes)
    [(avg,)] = (cust_df().where(Em.And(Em.GreaterThan(
        Em.col("c_acctbal"), Em.Literal(0.0, TT.DOUBLE)), in_codes))
        .agg(Am.agg(Am.Average(Em.col("c_acctbal")), "a")).collect())
    o = sess.from_rows(orders, _ord_schema(m))
    return (cust_df().where(Em.And(in_codes, Em.GreaterThan(
        Em.col("c_acctbal"), Em.Literal(avg, TT.DOUBLE))))
        .join(o, [("c_custkey", "o_custkey")], how="anti")
        .select(Em.Alias(code(None), "cntrycode"), Em.col("c_acctbal"))
        .group_by("cntrycode")
        .agg(Am.agg(Am.Count(), "numcust"),
             Am.agg(Am.Sum(Em.col("c_acctbal")), "totacctbal"))
        .order_by("cntrycode"))


def test_tpch_q22_matches_reference():
    vfa = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    ref = _q22(REF, JSession(vfa)).collect()
    got = _q22(PORT, PSession(vfa, device="cpu")).collect()
    assert len(got) == len(ref) > 1
    for r, g in zip(ref, got):
        assert r[:2] == g[:2]
        assert g[2] == pytest.approx(r[2], rel=1e-12)


#: patterns neither device lowers: the planner falls back with the
#: reference's reason
TAGGED = {
    "like_mixed": (lambda M: M.Like(M.col("s"), M.lit("%a_b%")),
                   "Like: patterns mixing % and _ are not supported"),
    "like_bad_escape": (lambda M: M.Like(M.col("s"), M.lit("a\\")),
                        "Like: the pattern 'a\\' is invalid"),
    "rlike_unsupported": (lambda M: M.RLike(M.col("s"), M.lit("(?i)ab")),
                          "RLike: pattern not supported by the byte DFA"),
    "rlike_too_many_states": (lambda M: M.RLike(
        M.col("s"), M.lit("special.*requests")), "DFA exceeds 16 states"),
    "regexp_replace_group": (lambda M: M.RegExpReplace(
        M.col("s"), M.lit("a"), M.lit("x\\$y")),
        "RegExpReplace: replacement with group references"),
    "regexp_replace_not_literal": (lambda M: M.RegExpReplace(
        M.col("s"), M.lit("a+"), M.lit("b")),
        "RegExpReplace: pattern is not literal-equivalent"),
}


def _tag_df(m, sess, build):
    TT, Em = m["T"], m["E"]
    schema = TT.StructType((TT.StructField("s", TT.STRING),))
    rows = [("ab",), ("a_b",), (None,), ("xyz",)]
    return sess.from_rows(rows, schema).select(Em.Alias(build(Em), "r"))


@pytest.mark.parametrize("case", sorted(TAGGED))
def test_unsupported_patterns_fall_back_with_the_reference_reason(case):
    build, reason = TAGGED[case]
    ref_df = _tag_df(REF, JSession({}), build)
    port_df = _tag_df(PORT, PSession({}, device="cpu"), build)
    ref_text = ref_df.explain()
    assert reason in ref_text
    assert comparable_explain(port_df.explain()) == comparable_explain(
        ref_text)
    if case == "like_bad_escape":  # both CPU engines refuse the pattern
        for df in (ref_df, port_df):
            with pytest.raises(ValueError, match="LIKE pattern"):
                df.collect()
        return
    assert port_df.collect() == ref_df.collect()


def test_c6_cpu_engines_read_non_ascii_digits():
    """ROADMAP.md §C, C6 (open, pinned): the device casts of both
    packages give NULL for a non-ASCII digit, as Spark's
    ``UTF8String.toLong`` does; both CPU engines read it with Python's
    ``int``, so a plan that falls back gives 3."""
    from spark_rapids_tpu.cpu import eval_expression_rows as jeval_rows

    vals = ["٣", "7"]
    ref, got, cpu = _cast_both(vals, lambda M, TT: M.Cast(M.col("s"),
                                                          TT.INT))
    assert ref == got == [None, 7]
    jbound = jbind(JE.Cast(JE.col("s"), JT.INT), jschema_of(s=JT.STRING))
    assert cpu == jeval_rows(jbound, [(v,) for v in vals]) == [3, 7]
