"""Lowerings of the string expression family, the ported subset.

Counterpart of ``spark_rapids_tpu/expr/eval_strings.py`` (same function
names and results): case mapping, substring, concat, the trims, the
literal predicates (StartsWith / EndsWith / Contains) and string
comparisons, built from ``ops/strings.py``. Patterns, positions and
lengths must be literals, as in the reference. A dictionary-encoded input
(``DictV``) runs each of these once over its dictionary
(:func:`_on_dict`, :func:`dict_compare_literal`); concat materializes it.
The reference's other string nodes
(``expressions.NOT_PORTED_STRING_NODES``) and string selection in If /
CaseWhen / Coalesce raise ``NotImplementedError`` naming their ROADMAP.md
item; their dictionary routes come with that item.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .. import types as T
from ..ops import strings as S
from . import expressions as E
from .values import (ColV, DictV, StrV, UnsupportedExpressionError,
                     clipped_codes, dict_gather_col, dict_rewrap,
                     materialize_dict)

_BIG = S.BIG


def _char_cap(v: StrV) -> int:
    return int(v.chars.shape[0])


def as_strv(v, cap: int) -> StrV:
    """A string value as it is, a DictV materialized (per-row selection
    needs the plain layout); a NULL-typed ColV (null literal) as an
    all-null empty StrV."""
    if isinstance(v, DictV):
        return materialize_dict(v)
    if isinstance(v, StrV):
        return v
    return _all_null_str(cap, v.validity.device)


def _on_dict(c, cap: int, fn: Callable):
    """Late materialization (reference ``eval_strings.py:59``): on a DictV
    the kernel ``fn(strv, rows)`` runs ONCE over the dictionary and its
    result comes back through the codes, a DictV for a string result
    (``unique`` cleared) and an int32 gather for a column result; a plain
    input runs it per row. Every kernel routed here keeps or shrinks its
    bytes, so ``mat_cap`` carries over."""
    if not isinstance(c, DictV):
        return fn(c, cap)
    out = fn(c.dictionary, c.dict_size)
    if isinstance(out, StrV):
        return dict_rewrap(c, out)
    return dict_gather_col(c, out)


_CMP = {E.EqualTo: "eq", E.EqualNullSafe: "eq", E.LessThan: "lt",
        E.LessThanOrEqual: "le", E.GreaterThan: "gt",
        E.GreaterThanOrEqual: "ge"}


def dict_compare_literal(expr, c: DictV, value, cap: int,
                         flipped: bool = False) -> ColV:
    """A comparison of a DictV against a string literal (reference
    ``eval_strings.py:76``): compare the dictionary's entries with the
    literal, gather the verdicts by code. ``flipped``: the literal is
    the LEFT operand."""
    dev = c.validity.device
    k = c.dict_size
    lit_null = value is None
    raw = b"" if lit_null else (
        value if isinstance(value, bytes) else str(value).encode("utf-8"))
    nb = torch.tensor(list(raw), dtype=torch.uint8, device=dev)
    lit = StrV(torch.arange(k + 1, dtype=torch.int32, device=dev) * len(raw),
               nb.repeat(k) if len(raw) else torch.zeros(
                   1, dtype=torch.uint8, device=dev),
               torch.ones(k, dtype=torch.bool, device=dev))
    d = c.dictionary
    lt, eq = S.compare(lit, d) if flipped else S.compare(d, lit)
    res_d = {"eq": eq, "lt": lt, "le": lt | eq, "gt": ~(lt | eq),
             "ge": ~lt}[_CMP[type(expr)]]
    res = res_d[clipped_codes(c)]
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    if isinstance(expr, E.EqualNullSafe):
        if lit_null:
            return ColV(~c.validity, ones)
        return ColV(c.validity & res, ones)
    valid = c.validity & (not lit_null)
    return ColV(valid & res, valid)


def lit_str(e: E.Expression, what: str) -> Optional[str]:
    if not isinstance(e, E.Literal) or not isinstance(
            e.data_type, (T.StringType, T.NullType)):
        raise UnsupportedExpressionError(f"{what} must be a string literal")
    return e.value


def lit_int(e: E.Expression, what: str) -> Optional[int]:
    if not isinstance(e, E.Literal) or isinstance(e.value,
                                                  (str, bytes, float)):
        raise UnsupportedExpressionError(f"{what} must be an integer literal")
    return e.value


def _all_null_col(cap: int, device, dtype=torch.bool) -> ColV:
    return ColV(torch.zeros(cap, dtype=dtype, device=device),
                torch.zeros(cap, dtype=torch.bool, device=device))


def _all_null_str(cap: int, device) -> StrV:
    return StrV(torch.zeros(cap + 1, dtype=torch.int32, device=device),
                torch.zeros(1, dtype=torch.uint8, device=device),
                torch.zeros(cap, dtype=torch.bool, device=device))


def compare_strings(expr: E.Expression, l: StrV, r: StrV, cap: int) -> ColV:
    """Binary comparisons over strings: unsigned byte order."""
    lt, eq = S.compare(l, r)
    gt = ~(lt | eq)
    res = {
        E.EqualTo: eq, E.EqualNullSafe: eq,
        E.LessThan: lt, E.LessThanOrEqual: lt | eq,
        E.GreaterThan: gt, E.GreaterThanOrEqual: gt | eq,
    }[type(expr)]
    if isinstance(expr, E.EqualNullSafe):
        both_null = ~l.validity & ~r.validity
        val = (l.validity & r.validity & res) | both_null
        return ColV(val, torch.ones(cap, dtype=torch.bool,
                                    device=val.device))
    return ColV(res, l.validity & r.validity)


# ---------------------------------------------------------------------------
# per-expression lowerings
# ---------------------------------------------------------------------------
def _upper_lower(expr, c: StrV, upper: bool) -> StrV:
    return StrV(c.offsets, S.map_case(c.chars, c.offsets[-1], upper),
                c.validity)


def _substring(expr: E.Substring, c: StrV, cap: int) -> StrV:
    pos = lit_int(expr.pos, "substring pos")
    ln = lit_int(expr.len, "substring len")
    if pos is None or ln is None:
        return _all_null_str(cap, c.validity.device)
    nchars = S.char_counts(c).to(torch.int64)
    # UTF8String.substringSQL: start = pos>0 ? pos-1 : (pos<0 ? n+pos : 0)
    if pos > 0:
        start = torch.full((cap,), pos - 1, dtype=torch.int64,
                           device=nchars.device)
    elif pos < 0:
        start = nchars + pos
    else:
        start = torch.zeros(cap, dtype=torch.int64, device=nchars.device)
    end = start + ln
    zero = torch.zeros((), dtype=torch.int64, device=nchars.device)
    s0 = torch.minimum(torch.maximum(start, zero), nchars).to(torch.int32)
    e0 = torch.minimum(torch.maximum(end, zero), nchars).to(torch.int32)
    e0 = torch.maximum(e0, s0)
    bs = S.char_to_byte(c, s0)
    be = S.char_to_byte(c, e0)
    new_lens = torch.where(c.validity, be - bs, 0)
    off, chars = S.take_slices(c, bs, new_lens, _char_cap(c))
    return StrV(off, chars, c.validity)


def _concat(pieces: List[StrV]) -> StrV:
    out_cap = sum(_char_cap(p) for p in pieces)
    off, chars, valid = S.concat(pieces, out_cap)
    return StrV(off, chars, valid)


def _trim(expr, c: StrV, cap: int) -> StrV:
    trim_str = expr.trim_str
    if trim_str is None:
        tset = b" "
    elif trim_str == "":
        return c  # Spark: an empty trim set is a no-op
    else:
        tset = trim_str.encode("utf-8")
        if any(b >= 0x80 for b in tset):
            raise UnsupportedExpressionError(
                "trim with non-ASCII trim characters is not supported")
    n = _char_cap(c)
    pos = torch.arange(n, dtype=torch.int32, device=c.chars.device)
    rid = S.row_ids(c.offsets, n)
    within = pos - c.offsets[:-1][rid.long()]
    in_set = torch.zeros(n, dtype=torch.bool, device=pos.device)
    for b in set(tset):
        in_set = in_set | (c.chars == b)
    keep = (pos < c.offsets[-1]) & ~in_set
    lens = S.byte_lens(c.offsets)
    first = S._segment_reduce(torch.where(keep, within, _BIG), rid, cap,
                              "amin", _BIG)
    last = S._segment_reduce(torch.where(keep, within, -1), rid, cap,
                             "amax", -(2**31))
    first = torch.where(first == _BIG, lens, first)  # all-trimmed row
    if isinstance(expr, E.StringTrimLeft):
        bs, nl = c.offsets[:-1] + first, lens - first
    elif isinstance(expr, E.StringTrimRight):
        # in int64: an empty last row's identity + 1 stays in range
        bs, nl = c.offsets[:-1], last.long() + 1
    else:
        bs = c.offsets[:-1] + first
        nl = torch.clamp(last.long() + 1 - first, min=0)
    nl = torch.where(c.validity, torch.clamp(nl, min=0), 0).to(torch.int32)
    off, chars = S.take_slices(c, bs, nl, n)
    return StrV(off, chars, c.validity)


def _string_predicate(expr, c: StrV, cap: int) -> ColV:
    pat = lit_str(expr.right, type(expr).__name__ + " pattern")
    dev = c.validity.device
    if pat is None:
        return _all_null_col(cap, dev)
    pb = pat.encode("utf-8")
    lens = S.byte_lens(c.offsets)
    if not pb:
        return ColV(torch.ones(cap, dtype=torch.bool, device=dev),
                    c.validity)
    n = _char_cap(c)
    m = S.find_matches(c.chars, pb)
    mp = len(pb)
    off = c.offsets[:-1]
    if isinstance(expr, E.StartsWith):
        res = (lens >= mp) & m[off.clamp(0, n - 1).long()]
    elif isinstance(expr, E.EndsWith):
        res = (lens >= mp) & m[(off + lens - mp).clamp(0, n - 1).long()]
    else:  # Contains
        P = S.prefix_counts(m)
        hi = (off + torch.clamp(lens - mp, min=0) + 1).clamp(0, n)
        cnt = P[hi.long()] - P[off.clamp(0, n).long()]
        res = (lens >= mp) & (cnt > 0)
    return ColV(res, c.validity)


def _string_input(v, what: str):
    if not isinstance(v, (StrV, DictV)):
        raise UnsupportedExpressionError(f"{what} takes a string input")
    return v


def lower_strings(expr: E.Expression, ev: Callable, cap: int):
    """Lower a ported string-family expression; None if ``expr`` is not
    one. Dictionary-encoded inputs go through :func:`_on_dict`; concat
    materializes them. The reference's other string nodes raise."""
    if isinstance(expr, E.NOT_PORTED_STRING_NODES):
        raise NotImplementedError(
            f"{type(expr).__name__} is {T.NOT_PORTED_STRING_EXPRS}")
    if isinstance(expr, (E.Upper, E.Lower)):
        up = isinstance(expr, E.Upper)
        return _on_dict(_string_input(ev(expr.child), type(expr).__name__),
                        cap, lambda c, k: _upper_lower(expr, c, up))
    if isinstance(expr, E.Substring):
        return _on_dict(_string_input(ev(expr.str), "substring"), cap,
                        lambda c, k: _substring(expr, c, k))
    if isinstance(expr, E.Concat):
        return _concat([as_strv(ev(e), cap) for e in expr.children_])
    if isinstance(expr, (E.StringTrim, E.StringTrimLeft, E.StringTrimRight)):
        return _on_dict(_string_input(ev(expr.column), "trim"), cap,
                        lambda c, k: _trim(expr, c, k))
    if isinstance(expr, (E.StartsWith, E.EndsWith, E.Contains)):
        c = _string_input(ev(expr.left), type(expr).__name__)
        return _on_dict(c, cap, lambda c_, k: _string_predicate(expr, c_, k))
    return None
