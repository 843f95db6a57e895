"""The port's string expressions against the reference's lowering.

Both packages build the same tree from their own expression classes; the
same string columns (the seeded samples of ``test_torch_strings``, one
ASCII-only and one with multi-byte UTF-8) go through the reference's
``expr/eval.lower`` and the port's. String results must be equal plane
for plane (offsets, chars pool, validity); other results in validity and
in data on every valid row. ``evaluate_projection`` is compared at the
batch level; the item-15 nodes (``test_string_expressions_not_ported_raise``,
named for when they raised) lower to the reference's planes too.
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.batch import schema_of as jschema_of
from spark_rapids_tpu.expr import eval as JEV
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr.values import ColV as JColV
from spark_rapids_tpu.expr.values import StrV as JStrV
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import batch_from_host_arrays, schema_of
from spark_rapids_tpu_torch.expr import eval as EV
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.values import ColV, StrV

from test_torch_strings import sample_strings, strvs

CAP = 256


def _inputs(ascii_only):
    """Columns 0, 1: strings; 2: an int64 column."""
    s = sample_strings(31 if ascii_only else 32, CAP, ascii_only)
    t = sample_strings(33 if ascii_only else 34, CAP, ascii_only)
    # equal and prefix-equal pairs for the comparisons
    for i in range(0, CAP, 7):
        t[i] = s[i]
    for i in range(3, CAP, 11):
        if s[i]:
            t[i] = s[i][:-1]
    (js, ps), (jt, pt) = strvs(s), strvs(t)
    v = np.random.default_rng(5).integers(-50, 50, CAP)
    vv = np.random.default_rng(6).random(CAP) < 0.9
    return ([js, jt, JColV(jnp.asarray(v), jnp.asarray(vv))],
            [ps, pt, ColV(torch.from_numpy(v), torch.from_numpy(vv))])


def _lower_both(build, ascii_only):
    jcols, pcols = _inputs(ascii_only)
    ref = JEV.lower(build(JE, JT), jcols, CAP)
    got = EV.lower(build(E, T), pcols, CAP)
    return ref, got


def _assert_same(ref, got):
    if isinstance(ref, JStrV):
        assert isinstance(got, StrV)
        for part in ("offsets", "chars", "validity"):
            np.testing.assert_array_equal(getattr(got, part).numpy(),
                                          np.asarray(getattr(ref, part)),
                                          err_msg=part)
        return
    assert isinstance(got, ColV)
    rv = np.asarray(ref.validity)
    np.testing.assert_array_equal(got.validity.numpy(), rv)
    rd, gd = np.asarray(ref.data), got.data.numpy()
    assert rd.dtype == gd.dtype, (rd.dtype, gd.dtype)
    np.testing.assert_array_equal(gd[rv], rd[rv])


def s0(M, TT):
    return M.BoundReference(0, TT.STRING)


def s1(M, TT):
    return M.BoundReference(1, TT.STRING)


def L(M, v, TT=None):
    if v is None and TT is not None:
        return M.Literal(None, TT.STRING)
    return M.Literal.of(v)


CASES = {
    "length": lambda M, TT: M.Length(s0(M, TT)),
    "upper": lambda M, TT: M.Upper(s0(M, TT)),
    "lower": lambda M, TT: M.Lower(s0(M, TT)),
    "concat": lambda M, TT: M.Concat((s0(M, TT), L(M, "-é-"), s1(M, TT))),
    "concat_null_literal": lambda M, TT: M.Concat((s0(M, TT),
                                                   M.Literal(None, TT.NULL))),
    "literal": lambda M, TT: L(M, "héllo wörld"),
    "literal_empty": lambda M, TT: L(M, ""),
    "literal_null": lambda M, TT: L(M, None, TT),
    "is_null": lambda M, TT: M.IsNull(s0(M, TT)),
    "is_not_null": lambda M, TT: M.IsNotNull(s0(M, TT)),
    "q9_project_u": lambda M, TT: M.Substring(M.Upper(s0(M, TT)), L(M, 1),
                                              L(M, 6)),
    "q9_length_u": lambda M, TT: M.Length(M.Substring(
        M.Upper(s0(M, TT)), L(M, 1), L(M, 6))),
    "nested_contains_upper": lambda M, TT: M.Contains(M.Lower(s0(M, TT)),
                                                      L(M, "x")),
}
for _pos, _len in ((1, 6), (0, 3), (3, 2), (-2, 5), (-10, 4), (100, 2),
                   (2, 0), (2, -1), (1, 2**31 - 1), (None, 3), (2, None)):
    CASES[f"substring_{_pos}_{_len}"] = (
        lambda M, TT, p=_pos, n=_len: M.Substring(
            s0(M, TT), M.Literal(p, TT.INT), M.Literal(n, TT.INT)))
for _cls in ("StringTrim", "StringTrimLeft", "StringTrimRight"):
    for _set in (None, "", " \t", "aX"):
        CASES[f"{_cls}_{_set!r}"] = (
            lambda M, TT, c=_cls, t=_set: getattr(M, c)(s0(M, TT), t))
for _cls in ("StartsWith", "EndsWith", "Contains"):
    for _pat in ("", "X", "a", " ", "中", "Hello", None):
        CASES[f"{_cls}_{_pat!r}"] = (
            lambda M, TT, c=_cls, p=_pat: getattr(M, c)(s0(M, TT),
                                                        L(M, p, TT)))
for _cmp in ("EqualTo", "EqualNullSafe", "LessThan", "LessThanOrEqual",
             "GreaterThan", "GreaterThanOrEqual"):
    CASES[f"{_cmp}_columns"] = (
        lambda M, TT, c=_cmp: getattr(M, c)(s0(M, TT), s1(M, TT)))
    CASES[f"{_cmp}_literal"] = (
        lambda M, TT, c=_cmp: getattr(M, c)(L(M, "Hello"), s0(M, TT)))


@pytest.mark.parametrize("ascii_only", [True, False], ids=["ascii", "utf8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_string_expression_matches_reference(case, ascii_only):
    ref, got = _lower_both(CASES[case], ascii_only)
    _assert_same(ref, got)


def test_evaluate_projection_matches_reference():
    """The batch-level entry over a padded batch with strings: the same
    planes in, the same columns (and rows) out."""
    s = sample_strings(41, 300, False)
    v = list(range(300))
    jschema = jschema_of(s=JT.STRING, v=JT.LONG)
    jb = JBatch.from_pydict({"s": s, "v": v}, jschema)
    jcs, jcv = jb.columns
    pb = batch_from_host_arrays(
        schema_of(s=T.STRING, v=T.LONG),
        [(np.asarray(jcs.offsets), np.asarray(jcs.chars)),
         np.asarray(jcv.data)],
        [np.asarray(jcs.validity), np.asarray(jcv.validity)], 300,
        jb.capacity, device="cpu")

    def exprs(M, TT):
        s_, v_ = M.BoundReference(0, TT.STRING), M.BoundReference(1,
                                                                  TT.LONG)
        return [M.Substring(M.Upper(s_), M.Literal.of(2), M.Literal.of(4)),
                M.Length(s_), M.Concat((s_, M.Literal.of("!"))),
                M.StringTrim(s_), M.Contains(s_, M.Literal.of("é")),
                M.Add(v_, M.Length(s_))]

    ref = JEV.evaluate_projection(exprs(JE, JT), jb)
    got = EV.evaluate_projection(exprs(E, T), pb)
    for r, g in zip(ref, got):
        assert g.dtype.simpleString == r.dtype.simpleString
        assert g.to_host().to_pylist() == r.to_pylist()
        if r.is_string:
            for part in ("offsets", "chars", "validity"):
                np.testing.assert_array_equal(
                    getattr(g, part).numpy(), np.asarray(getattr(r, part)))


#: the string expressions of ROADMAP.md item 15, which now lower
NOT_PORTED = {
    "like": lambda M, TT: M.Like(s0(M, TT), M.lit("a%")),
    "rlike": lambda M, TT: M.RLike(s0(M, TT), M.lit("a+")),
    "initcap": lambda M, TT: M.InitCap(s0(M, TT)),
    "locate": lambda M, TT: M.StringLocate(M.lit("a"), s0(M, TT),
                                           M.lit(1)),
    "replace": lambda M, TT: M.StringReplace(s0(M, TT), M.lit("a"),
                                             M.lit("b")),
    "regexp_replace": lambda M, TT: M.RegExpReplace(s0(M, TT), M.lit("a"),
                                                    M.lit("b")),
    "lpad": lambda M, TT: M.StringLPad(s0(M, TT), M.lit(5), M.lit("*")),
    "rpad": lambda M, TT: M.StringRPad(s0(M, TT), M.lit(5), M.lit("*")),
    "substring_index": lambda M, TT: M.SubstringIndex(s0(M, TT), M.lit(","),
                                                      M.lit(1)),
    "split_part": lambda M, TT: M.StringSplitPart(s0(M, TT), M.lit(","),
                                                  M.lit(0)),
    "cast_to_int": lambda M, TT: M.Cast(s0(M, TT), TT.INT),
    "cast_to_string": lambda M, TT: M.Cast(M.BoundReference(2, TT.LONG),
                                           TT.STRING),
    "if_string": lambda M, TT: M.If(M.IsNull(M.BoundReference(2, TT.LONG)),
                                    s0(M, TT), s1(M, TT)),
    "coalesce_string": lambda M, TT: M.Coalesce((s0(M, TT), M.lit("x"))),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_string_expressions_not_ported_raise(case):
    """These nodes raised, naming ROADMAP.md item 15, until it was
    ported; each now lowers to the reference's planes, ASCII and UTF-8."""
    for ascii_only in (True, False):
        ref, got = _lower_both(NOT_PORTED[case], ascii_only)
        _assert_same(ref, got)


def test_non_literal_patterns_are_unsupported_as_in_the_reference():
    _, pcols = _inputs(True)
    for expr in (E.Contains(E.BoundReference(0, T.STRING),
                            E.BoundReference(1, T.STRING)),
                 E.Substring(E.BoundReference(0, T.STRING),
                             E.BoundReference(2, T.LONG), E.lit(2)),
                 E.EqualTo(E.BoundReference(0, T.STRING),
                           E.BoundReference(2, T.LONG))):
        with pytest.raises(EV.UnsupportedExpressionError):
            EV.lower(expr, pcols, CAP)
