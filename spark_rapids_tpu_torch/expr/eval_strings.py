"""Lowerings of the string expression family.

Counterpart of ``spark_rapids_tpu/expr/eval_strings.py`` (same function
names and results), built from ``ops/strings.py``: case mapping, initcap,
substring, concat, the trims, the literal predicates, LIKE, RLIKE (the
byte DFA of ``ops/regex.py``), regexp_replace and replace, locate, the
pads, substring_index, split_part, string selection for If / CaseWhen /
Coalesce, string ``In`` and the casts from and to strings. Patterns,
positions and lengths must be literals, as in the reference; what the
reference refuses raises ``UnsupportedExpressionError`` with its reason,
which the planner reads as a fallback. A dictionary-encoded input
(``DictV``) takes the reference's route: most nodes run once over the
dictionary (:func:`_on_dict`, :func:`dict_compare_literal`), concat,
selection and the pads materialize it.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..columnar.column import choose_capacity
from ..ops import strings as S
from . import expressions as E
from .eval_datetime import (format_date, format_timestamp, parse_date,
                            parse_timestamp)
from .values import (ColV, DictV, StrV, UnsupportedExpressionError,
                     clipped_codes, dict_gather_col, dict_rewrap,
                     materialize_dict)

_BIG = S.BIG


def _char_cap(v: StrV) -> int:
    return int(v.chars.shape[0])


def as_strv(v, cap: int, device=None) -> StrV:
    """A string value as it is, a DictV materialized (per-row selection
    needs the plain layout); a NULL-typed ColV (null literal), or None
    (on ``device``), as an all-null empty StrV."""
    if isinstance(v, DictV):
        return materialize_dict(v)
    if isinstance(v, StrV):
        return v
    return _all_null_str(cap, device if v is None else v.validity.device)


def _on_dict(c, cap: int, fn: Callable, growth: int = 1):
    """Late materialization (reference ``eval_strings.py:59``): on a DictV
    the kernel ``fn(strv, rows)`` runs ONCE over the dictionary and its
    result comes back through the codes, a DictV for a string result
    (``unique`` cleared) and an int32 gather for a column result; a plain
    input runs it per row. ``growth`` is the kernel's worst-case growth
    of output bytes (replace), which scales the result's ``mat_cap``."""
    if not isinstance(c, DictV):
        return fn(c, cap)
    out = fn(c.dictionary, c.dict_size)
    if isinstance(out, StrV):
        return dict_rewrap(c, out, growth)
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


def _row_sums(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-row int64 sums of per-byte ``values`` over each row's bytes
    ``[offsets[i], offsets[i+1])`` (the reference's ``segment_sum``; the
    callers zero the bytes past the data): the differences of one int64
    prefix sum at the row offsets, exact and without atomics (an
    ``index_add_`` over the row ids puts all of a row's bytes on one
    address)."""
    n = values.shape[0]
    pre = torch.zeros(n + 1, dtype=torch.int64, device=values.device)
    torch.cumsum(values, 0, dtype=torch.int64, out=pre[1:])
    return (S._at(pre, offsets[1:].clamp(0, n))
            - S._at(pre, offsets[:-1].clamp(0, n)))


def _first_at(mask: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per row: the within-row index of its first byte where ``mask``
    holds, BIG if none (the reference's ``segment_min`` of the masked
    within-row index): the next match at the row's start, with no
    atomics."""
    n = mask.shape[0]
    off = offsets[:-1].clamp(0, n)
    q = S._at(S.next_match(mask), off)
    return torch.where(q < offsets[1:].clamp(0, n), q - off, _BIG)


def _last_at(mask: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per row: the within-row index of its last byte where ``mask``
    holds, -1 if none (``segment_max``): the last match before the row's
    end, from the match count there and the matches' positions."""
    n = mask.shape[0]
    before = S.prefix_counts(mask)
    pos = torch.full((n + 1,), -1, dtype=torch.int32, device=mask.device)
    pos.scatter_(0, torch.where(mask, before[1:] - 1, n).long(),
                 S._iota(n, mask))
    off = offsets[:-1].clamp(0, n)
    k = S._at(before, offsets[1:].clamp(0, n))
    q = S._at(pos, (k - 1).clamp(min=0))
    return torch.where((k > 0) & (q >= off), q - off, -1)


def _live_bytes(new_offsets: torch.Tensor, out_cap: int, fill: Callable
                ) -> torch.Tensor:
    """A ``out_cap``-byte pool whose live bytes ``[0, new_offsets[-1])``
    are ``fill(pos, rid, within)`` and whose padding is zero: the
    reference's whole-capacity pass, run over the live bytes only (one
    sync for their count)."""
    total = min(int(new_offsets[-1]), out_cap)
    out = torch.zeros(out_cap, dtype=torch.uint8, device=new_offsets.device)
    if total:
        pos = S._iota(total, new_offsets)
        rid = S.rows_of_positions(new_offsets, total)
        out[:total] = fill(pos, rid, pos - S._at(new_offsets, rid))
    return out


def select_strings(choices: Sequence[StrV], sel: torch.Tensor,
                   valid: torch.Tensor, cap: int) -> StrV:
    """Per-row choice among string columns (If / CaseWhen / Coalesce;
    reference ``eval_strings.py:133``)."""
    out_cap = sum(_char_cap(c) for c in choices)
    lens = torch.stack([S.byte_lens(c.offsets) for c in choices])
    rows = torch.arange(cap, device=valid.device)
    new_lens = torch.where(valid, lens[sel.long(), rows], 0)
    new_offsets = S.offsets_of_lens(new_lens)

    def fill(pos, rid, within):
        out = torch.zeros_like(pos, dtype=torch.uint8)
        pick = S._at(sel, rid)
        for k, c in enumerate(choices):
            src = (S._at(c.offsets[:-1], rid) + within).clamp(
                0, _char_cap(c) - 1)
            out = torch.where(pick == k, S._at(c.chars, src), out)
        return out

    return StrV(new_offsets, _live_bytes(new_offsets, out_cap, fill), valid)


def string_in(c: StrV, values, cap: int) -> ColV:
    """String ``In`` against literals (reference ``eval_strings.py:168``):
    a NULL among the values makes a non-match NULL."""
    non_null = [v for v in values if v is not None]
    has_null = len(non_null) != len(values)
    match = torch.zeros(cap, dtype=torch.bool, device=c.validity.device)
    for v in non_null:
        match = match | S.equals_literal(c, str(v).encode("utf-8"))
    valid = c.validity & (match | (not has_null))
    return ColV(match, valid)


# ---------------------------------------------------------------------------
# per-expression lowerings
# ---------------------------------------------------------------------------
def _upper_lower(expr, c: StrV, upper: bool) -> StrV:
    return StrV(c.offsets, S.map_case(c.chars, c.offsets[-1], upper),
                c.validity)


def _initcap(c: StrV) -> StrV:
    """Spark initcap: lower everything, then upper the first character of
    each space-separated word (reference ``eval_strings.py:187``). A row
    start past the pool marks nothing."""
    total = c.offsets[-1]
    n = _char_cap(c)
    low = S.map_case(c.chars, total, upper=False)
    up = S.map_case(low, total, upper=True)
    starts = S.char_starts(low, total)
    prv = torch.cat([torch.full((1,), 0x20, dtype=torch.uint8,
                                device=low.device), low[:-1]])
    row_start = torch.zeros(n + 1, dtype=torch.bool, device=low.device)
    row_start[c.offsets[:-1].clamp(0, n).long()] = True
    word = starts & (row_start[:n] | (prv == 0x20))
    # the continuation byte of a word-start 2-byte char keeps the mapped
    # pair
    word2 = word | (torch.cat([torch.zeros(1, dtype=torch.bool,
                                           device=low.device), word[:-1]])
                    & ((low & 0xC0) == 0x80))
    return StrV(c.offsets, torch.where(word2, up, low), c.validity)


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


_DFA_CACHE: dict = {}


def _rlike(expr: E.RLike, c: StrV, cap: int) -> ColV:
    """str RLIKE pattern (reference ``eval_strings.py:302``): a
    literal-equivalent pattern is a Contains (no state cap); any other
    goes through the byte DFA (``ops/regex.py``; the hand-written kernel
    on the card). Patterns outside the subset or over the state cap
    raise Unsupported, so the planner falls back."""
    from ..ops import regex as RX

    pat = lit_str(expr.pattern, "RLike pattern")
    if pat is None:
        return _all_null_col(cap, c.validity.device)
    literal = RX.regex_as_literal(pat)
    if literal:
        synth = E.Contains(expr.left, E.Literal(literal, T.STRING))
        return _string_predicate(synth, c, cap)
    dfa = _DFA_CACHE.get(pat)
    if dfa is None:
        try:
            dfa = RX.compile_search_dfa(pat)
        except RX.RegexUnsupported as e:
            raise UnsupportedExpressionError(f"RLike pattern: {e}")
        if len(_DFA_CACHE) > 256:
            _DFA_CACHE.clear()
        _DFA_CACHE[pat] = dfa
    res = RX.dfa_accept_rows(c.offsets, c.chars, c.validity, dfa)
    return ColV(res, c.validity)


def _regexp_replace(expr: E.RegExpReplace, c: StrV, cap: int) -> StrV:
    """regexp_replace with the reference's literal guard: a
    literal-equivalent pattern lowers to the plain replace."""
    from ..ops import regex as RX

    pat = lit_str(expr.pattern, "regexp_replace pattern")
    repl = lit_str(expr.replacement, "regexp_replace replacement")
    if pat is None or repl is None:
        # Spark: a null pattern or replacement gives null
        return _all_null_str(cap, c.validity.device)
    literal = RX.regex_as_literal(pat)
    if literal is None or literal == "":
        raise UnsupportedExpressionError(
            "regexp_replace pattern is not literal-equivalent")
    if "$" in repl or "\\" in repl:
        raise UnsupportedExpressionError(
            "regexp_replace replacement with group references")
    synth = E.StringReplace(expr.str, E.Literal(literal, T.STRING),
                            E.Literal(repl, T.STRING))
    return _replace(synth, c, cap)


def _parse_like(pattern: str, escape: str) -> List[str]:
    """Tokenize a LIKE pattern into literal chunks and ``%`` / ``_``
    tokens (reference ``eval_strings.py:354``). Raises ValueError for an
    invalid escape, as Spark does."""
    toks: List[str] = []
    cur: List[str] = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape:
            if i + 1 >= len(pattern):
                raise ValueError(
                    f"the pattern '{pattern}' is invalid, it is not allowed "
                    "to end with the escape character")
            nxt = pattern[i + 1]
            if nxt not in ("_", "%", escape):
                raise ValueError(
                    f"the pattern '{pattern}' is invalid, the escape "
                    f"character is not allowed to precede '{nxt}'")
            cur.append(nxt)
            i += 2
            continue
        if ch in ("%", "_"):
            if cur:
                toks.append("".join(cur))
                cur = []
            toks.append(ch)
        else:
            cur.append(ch)
        i += 1
    if cur:
        toks.append("".join(cur))
    return toks


def _like(expr: E.Like, c: StrV, cap: int) -> ColV:
    """LIKE (reference ``eval_strings.py:391``): an all-``_`` pattern
    matches char by char; ``%`` patterns match their literal chunks
    greedily left to right (:func:`ops.strings.next_match`); a mixture of
    both is Unsupported."""
    dev = c.validity.device
    pattern = lit_str(expr.pattern, "LIKE pattern")
    if pattern is None:
        return _all_null_col(cap, dev)
    try:
        toks = _parse_like(pattern, expr.escape)
    except ValueError as e:
        raise UnsupportedExpressionError(str(e))
    has_pct = "%" in toks
    has_us = "_" in toks
    if has_pct and has_us:
        raise UnsupportedExpressionError(
            "LIKE patterns mixing % and _ are not supported on TPU")
    lens = S.byte_lens(c.offsets)
    n = _char_cap(c)
    off = c.offsets[:-1].long()
    if has_us:
        pat_chars: List[Optional[str]] = []
        for t in toks:
            if t == "_":
                pat_chars.append(None)
            else:
                pat_chars.extend(t)
        res = S.char_counts(c) == len(pat_chars)
        for k, pc in enumerate(pat_chars):
            if pc is None:
                continue
            bs = pc.encode("utf-8")
            bp = S.char_to_byte(c, torch.full((cap,), k, dtype=torch.int32,
                                              device=dev)).long()
            for j, b in enumerate(bs):
                res = res & (c.chars[(bp + j).clamp(0, n - 1)] == b)
            # the char's byte length must match too
            nxt = S.char_to_byte(c, torch.full((cap,), k + 1,
                                               dtype=torch.int32,
                                               device=dev)).long()
            res = res & ((nxt - bp) == len(bs))
        return ColV(res, c.validity)
    chunks = [t for t in toks if t != "%"]
    anchored_start = bool(toks) and toks[0] != "%"
    anchored_end = bool(toks) and toks[-1] != "%"
    if not chunks:
        # the pattern is '' or all '%'
        res = (torch.ones(cap, dtype=torch.bool, device=dev) if has_pct
               else lens == 0)
        return ColV(res, c.validity)
    if len(chunks) == 1 and anchored_start and anchored_end:
        return ColV(S.equals_literal(c, chunks[0].encode("utf-8")),
                    c.validity)
    lens = lens.long()
    res = torch.ones(cap, dtype=torch.bool, device=dev)
    pos = off
    rest = chunks
    if anchored_start:
        pb = chunks[0].encode("utf-8")
        m = S.find_matches(c.chars, pb)
        res = res & (lens >= len(pb)) & m[off.clamp(0, n - 1)]
        pos = off + len(pb)
        rest = chunks[1:]
    tail = None
    if anchored_end and rest:
        tail = rest[-1]
        rest = rest[:-1]
    for ck in rest:
        pb = ck.encode("utf-8")
        nm = S.next_match(S.find_matches(c.chars, pb))
        q = nm[pos.clamp(0, n)].long()
        ok = (q < _BIG) & ((q + len(pb)) <= (off + lens))
        res = res & ok
        pos = torch.where(ok, q + len(pb), n + 1)
    if tail is not None:
        pb = tail.encode("utf-8")
        m = S.find_matches(c.chars, pb)
        tstart = off + lens - len(pb)
        res = res & (lens >= len(pb)) & (tstart >= pos) & m[
            tstart.clamp(0, n - 1)]
    return ColV(res, c.validity)


def _locate(expr: E.StringLocate, c: StrV, cap: int) -> ColV:
    """locate(substr, str, start): the 1-based character position of the
    first match at or after character ``start``, 0 if none (reference
    ``eval_strings.py:471``)."""
    dev = c.validity.device
    sub = lit_str(expr.substr, "locate substr")
    start = lit_int(expr.start, "locate start")
    if start is None:
        # the reference: a null start gives 0 for every row, null or not
        return ColV(torch.zeros(cap, dtype=torch.int32, device=dev),
                    torch.ones(cap, dtype=torch.bool, device=dev))
    if sub is None:
        return _all_null_col(cap, dev, torch.int32)
    if start < 1 or sub == "":
        v = 1 if start >= 1 else 0
        return ColV(torch.full((cap,), v, dtype=torch.int32, device=dev),
                    c.validity)
    pb = sub.encode("utf-8")
    n = _char_cap(c)
    nm = S.next_match(S.find_matches(c.chars, pb))
    bstart = S.char_to_byte(c, torch.full((cap,), start - 1,
                                          dtype=torch.int32, device=dev))
    q = S._at(nm, bstart.clamp(0, n))
    off = c.offsets[:-1]
    found = q.long() <= (off + S.byte_lens(c.offsets) - len(pb)).long()
    cp = S.char_prefix(c.chars, c.offsets[-1])
    first = S._at(cp, off.clamp(0, n))
    res = torch.where(found, S._at(cp, q.clamp(0, n)) - first + 1,
                      0).to(torch.int32)
    return ColV(res, c.validity)


def _replace(expr: E.StringReplace, c: StrV, cap: int) -> StrV:
    """replace(str, search, repl) with literal operands (reference
    ``eval_strings.py:501``): non-overlapping matches, found in one pass
    (a self-overlapping search string is Unsupported), each kept byte
    and each replacement byte scattered to its output position."""
    search = lit_str(expr.search, "replace search")
    repl = lit_str(expr.replacement, "replace replacement")
    if search is None or repl is None:
        return _all_null_str(cap, c.validity.device)
    sb, rb = search.encode("utf-8"), repl.encode("utf-8")
    if not sb:
        return c  # Spark: an empty search returns the input unchanged
    if S.has_border(sb):
        raise UnsupportedExpressionError(
            "replace with a self-overlapping search string is not "
            "supported on TPU (order-dependent greedy matching)")
    ms, mr = len(sb), len(rb)
    n = _char_cap(c)
    pos = S._iota(n, c.chars)
    rid = S.row_ids(c.offsets, n)
    lens = S.byte_lens(c.offsets)
    within = pos - S._at(c.offsets[:-1], rid)
    m = S.find_matches(c.chars, sb)
    m = m & ((within + ms) <= S._at(lens, rid))  # no match across rows
    P = S.prefix_counts(m)
    cnt = S._at(P, c.offsets[1:]) - S._at(P, c.offsets[:-1])
    new_lens = torch.where(c.validity, lens + cnt * (mr - ms), 0)
    new_offsets = S.offsets_of_lens(new_lens)
    out_cap = n if mr <= ms else choose_capacity(n // ms * (mr - ms) + n)
    in_match = (P[1:] - S._at(P, (pos - ms + 1).clamp(0, n))) > 0
    repl_before = P[:-1] - S._at(S._at(P, c.offsets[:-1]), rid)
    base = (S._at(new_offsets[:-1], rid) + within
            + repl_before * (mr - ms)).long()
    kept = (pos < c.offsets[-1]) & ~in_match
    out = torch.zeros(out_cap + 1, dtype=torch.uint8, device=c.chars.device)
    drop = torch.full_like(base, out_cap)
    out[torch.where(kept, base, drop)] = c.chars
    for k in range(mr):
        out[torch.where(m, base + k, drop)] = rb[k]
    return StrV(new_offsets, out[:out_cap], c.validity)


def _pad(expr, c: StrV, cap: int, left: bool) -> StrV:
    """lpad / rpad to ``len`` characters with a literal pad string
    (reference ``eval_strings.py:540``); a longer string is cut to
    ``len`` characters."""
    dev = c.validity.device
    L = lit_int(expr.len, "pad length")
    pad = lit_str(expr.pad, "pad string")
    if L is None or pad is None:
        return _all_null_str(cap, dev)
    n = _char_cap(c)
    if L <= 0:
        return StrV(torch.zeros(cap + 1, dtype=torch.int32, device=dev),
                    torch.zeros(1, dtype=torch.uint8, device=dev),
                    c.validity)
    # the reference's bound on the output pool (cap * 4 * L bytes); it
    # depends on L only, so the planner's probe falls back on it
    if L > 4096:
        raise UnsupportedExpressionError(
            f"pad length {L} exceeds the device kernel bound 4096")
    pb = pad.encode("utf-8")
    pad_offs = [0]
    for ch in pad:
        pad_offs.append(pad_offs[-1] + len(ch.encode("utf-8")))
    pc = len(pad)
    nchars = S.char_counts(c)
    lens = S.byte_lens(c.offsets)
    trunc = nchars >= L
    tb = S.char_to_byte(c, torch.full((cap,), L, dtype=torch.int32,
                                      device=dev)) - c.offsets[:-1]
    if pc:
        need = torch.clamp(L - nchars, min=0)
        ptable = torch.tensor(pad_offs, dtype=torch.int32, device=dev)
        pad_bytes = (torch.div(need, pc, rounding_mode="floor") * len(pb)
                     + S._at(ptable, need % pc))
    else:
        pad_bytes = torch.zeros(cap, dtype=torch.int32, device=dev)
    str_bytes = torch.where(trunc, tb, lens)
    pl_row = torch.where(trunc, 0, pad_bytes)
    out_lens = torch.where(c.validity, str_bytes + pl_row, 0)
    new_offsets = S.offsets_of_lens(out_lens)
    out_cap = choose_capacity(max(cap * 4 * L, 1))
    prep = torch.tensor(list(pb) or [0], dtype=torch.uint8, device=dev)

    def fill(pos, rid, w):
        pl = S._at(pl_row, rid)
        sb = S._at(str_bytes, rid)
        in_pad = w < pl if left else w >= sb
        sw = w - pl if left else w
        out = S._at(c.chars, (S._at(c.offsets[:-1], rid) + sw).clamp(0, n - 1))
        if pc:
            pw = torch.remainder(w if left else w - sb, len(pb))
            out = torch.where(in_pad, S._at(prep, pw), out)
        return out

    return StrV(new_offsets, _live_bytes(new_offsets, out_cap, fill),
                c.validity)


def _occurrence_matrix(m: torch.Tensor, rid: torch.Tensor,
                       off_of_rid: torch.Tensor, P: torch.Tensor, cap: int,
                       K: int) -> torch.Tensor:
    """(cap, K) byte positions of each row's first K matches (BIG where
    the row has fewer)."""
    n = m.shape[0]
    pos = S._iota(n, m)
    ordn = P[:-1] - S._at(P, off_of_rid)
    return _scatter_matrix(pos, torch.where(m & (ordn < K), rid, cap),
                           ordn.clamp(0, K - 1), cap, K)


def _scatter_matrix(pos, tgt_r, tgt_c, cap: int, K: int) -> torch.Tensor:
    mat = torch.full(((cap + 1) * K,), _BIG, dtype=torch.int32,
                     device=pos.device)
    mat[(tgt_r.long() * K + tgt_c.long())] = pos
    return mat[:cap * K].view(cap, K)


def _substring_index(expr: E.SubstringIndex, c: StrV, cap: int) -> StrV:
    """substring_index(str, delim, count) with a one-byte delimiter
    (reference ``eval_strings.py:611``)."""
    delim = lit_str(expr.delim, "substring_index delim")
    count = lit_int(expr.count, "substring_index count")
    if delim is None or count is None:
        return _all_null_str(cap, c.validity.device)
    db = delim.encode("utf-8")
    if len(db) != 1:
        raise UnsupportedExpressionError(
            "substring_index only supports single-byte delimiters on TPU")
    n = _char_cap(c)
    lens = S.byte_lens(c.offsets)
    off = c.offsets[:-1]
    if count == 0:
        noff, chars = S.take_slices(c, off, torch.zeros_like(lens), n)
        return StrV(noff, chars, c.validity)
    if abs(count) > n:
        # more delimiters than the pool can hold: the whole string
        noff, chars = S.take_slices(c, off, torch.where(c.validity, lens, 0),
                                    n)
        return StrV(noff, chars, c.validity)
    pos = S._iota(n, c.chars)
    m = S.find_matches(c.chars, db) & (pos < c.offsets[-1])
    rid = S.row_ids(c.offsets, n)
    P = S.prefix_counts(m)
    cnt = S._at(P, c.offsets[1:]) - S._at(P, off)
    off_r = S._at(off, rid)
    if count > 0:
        mat = _occurrence_matrix(m, rid, off_r, P, cap, count)
        end = torch.where(cnt >= count, mat[:, count - 1], off + lens)
        bs, nl = off, end - off
    else:
        K = -count
        ord_end = (S._at(cnt, rid) - (P[:-1] - S._at(P, off_r))) - 1
        mat = _scatter_matrix(
            pos, torch.where(m & (ord_end < K) & (ord_end >= 0), rid, cap),
            ord_end.clamp(0, K - 1), cap, K)
        start = torch.where(cnt >= K, mat[:, K - 1] + 1, off)
        bs, nl = start, off + lens - start
    nl = torch.where(c.validity, torch.clamp(nl, min=0), 0)
    noff, chars = S.take_slices(c, bs, nl, n)
    return StrV(noff, chars, c.validity)


def _split_part(expr: E.StringSplitPart, c: StrV, cap: int) -> StrV:
    """split(str, delim)[index] with a literal delimiter (reference
    ``eval_strings.py:658``): NULL past the last part."""
    delim = lit_str(expr.delim, "split delimiter")
    idx = lit_int(expr.index, "split index")
    if delim is None or idx is None:
        return _all_null_str(cap, c.validity.device)
    db = delim.encode("utf-8")
    if not db:
        raise UnsupportedExpressionError("split with empty delimiter")
    if idx < 0:
        raise UnsupportedExpressionError("split index must be >= 0")
    if S.has_border(db):
        raise UnsupportedExpressionError(
            "split with a self-overlapping delimiter is not supported on "
            "TPU")
    md = len(db)
    n = _char_cap(c)
    if idx > n // md:
        # past any possible part: all null
        return _all_null_str(cap, c.validity.device)
    pos = S._iota(n, c.chars)
    rid = S.row_ids(c.offsets, n)
    lens = S.byte_lens(c.offsets)
    off = c.offsets[:-1]
    off_r = S._at(off, rid)
    m = S.find_matches(c.chars, db)
    m = m & ((pos - off_r + md) <= S._at(lens, rid)) & (pos < c.offsets[-1])
    P = S.prefix_counts(m)
    cnt = S._at(P, c.offsets[1:]) - S._at(P, off)
    mat = _occurrence_matrix(m, rid, off_r, P, cap, idx + 1)
    start = off if idx == 0 else torch.where(cnt >= idx,
                                             mat[:, idx - 1] + md, _BIG)
    end = torch.where(cnt > idx, mat[:, idx], off + lens)
    in_range = cnt >= idx  # idx < the number of parts, cnt + 1
    valid = c.validity & in_range
    nl = torch.where(valid, torch.clamp(end - torch.minimum(start, end),
                                        min=0), 0)
    noff, chars = S.take_slices(c, torch.where(in_range, start, 0), nl, n)
    return StrV(noff, chars, valid)


# ---------------------------------------------------------------------------
# string casts (reference: GpuCast.scala's string rows)
# ---------------------------------------------------------------------------
_TRUE_STRINGS = (b"t", b"true", b"y", b"yes", b"1")
_FALSE_STRINGS = (b"f", b"false", b"n", b"no", b"0")


def _trimmed_lower(c: StrV, cap: int) -> StrV:
    """A whitespace-trimmed, lowercased copy (for string -> bool and
    number)."""
    low = S.map_case(c.chars, c.offsets[-1], upper=False)
    n = _char_cap(c)
    # Java Character.isWhitespace over ASCII: \t \n \v \f \r and space
    ws = (low == 0x20) | ((low >= 0x09) & (low <= 0x0D))
    keep = (S._iota(n, low) < c.offsets[-1]) & ~ws
    lens = S.byte_lens(c.offsets)
    first = _first_at(keep, c.offsets)
    last = _last_at(keep, c.offsets)
    first = torch.where(first == _BIG, lens, first)
    nl = torch.where(c.validity, torch.clamp(last + 1 - first, min=0), 0)
    off, chars = S.take_slices(StrV(c.offsets, low, c.validity),
                               c.offsets[:-1] + first, nl, n)
    return StrV(off, chars, c.validity)


def cast_string_to_bool(c: StrV, cap: int) -> ColV:
    t = _trimmed_lower(c, cap)
    is_true = torch.zeros(cap, dtype=torch.bool, device=c.validity.device)
    is_false = torch.zeros_like(is_true)
    for lit in _TRUE_STRINGS:
        is_true = is_true | S.equals_literal(t, lit)
    for lit in _FALSE_STRINGS:
        is_false = is_false | S.equals_literal(t, lit)
    return ColV(is_true, c.validity & (is_true | is_false))


_INTEGRAL = ("tinyint", "smallint", "int", "bigint")
_POW10 = [10**k for k in range(19)]


def _row_bytes(t: StrV):
    n = _char_cap(t)
    pos = S._iota(n, t.chars)
    rid = S.row_ids(t.offsets, n)
    return n, pos, rid, pos - S._at(t.offsets[:-1], rid), pos < t.offsets[-1]


def cast_string_to_int(c: StrV, cap: int, to: T.DataType) -> ColV:
    """Spark's non-ANSI string -> integral (``UTF8String.toLong``):
    trimmed, an optional sign, digits only; anything else, and overflow,
    gives NULL. The reference accumulates the magnitude in uint64; here
    it is two int64 parts, the digit at 10^18 and the 18 below it, with
    the same 19-significant-digit limit and overflow rule."""
    t = _trimmed_lower(c, cap)
    n, pos, rid, within, in_data = _row_bytes(t)
    lens = S.byte_lens(t.offsets)
    first = S._at(t.chars, t.offsets[:-1].clamp(0, n - 1))
    has_sign = (first == ord("-")) | (first == ord("+"))
    neg = first == ord("-")
    sign_len = has_sign.to(torch.int32)
    is_digit = (t.chars >= ord("0")) & (t.chars <= ord("9"))
    bad = in_data & ~is_digit & ~((within == 0) & S._at(has_sign, rid))
    nbad = _row_sums(bad, t.offsets)
    ndigits = lens - sign_len
    # significant digits: leading zeros do not count toward the 19
    nz_first = _first_at(in_data & is_digit & (t.chars != ord("0")),
                         t.offsets)
    sig = torch.where(nz_first == _BIG, 1, lens - nz_first)
    ok = (nbad == 0) & (ndigits >= 1) & (sig <= 19)
    place = S._at(ndigits, rid) - 1 - (within - S._at(sign_len, rid))
    digit = torch.where(in_data & is_digit, t.chars.long() - ord("0"), 0)
    pw = torch.tensor(_POW10, dtype=torch.int64, device=pos.device)
    low = _row_sums(torch.where((place >= 0) & (place < 18),
                                digit * S._at(pw, place.clamp(0, 17)), 0),
                    t.offsets)
    top = _row_sums(torch.where(place == 18, digit, 0), t.offsets)
    # magnitude = top * 10^18 + low <= 2^63 (negative) or 2^63 - 1
    room = torch.where(neg, 2**63 - 9 * 10**18, 2**63 - 1 - 9 * 10**18)
    ok = ok & ((top < 9) | ((top == 9) & (low <= room)))
    head = top.clamp(0, 9) * 10**18
    sval = torch.where(neg, -head - low, head + low)
    dt = T.torch_dtype(to)
    if to.name != "bigint":
        info = torch.iinfo(dt)
        ok = ok & (sval >= info.min) & (sval <= info.max)
    valid = c.validity & ok
    return ColV(torch.where(valid, sval, 0).to(dt), valid)


#: significant digits a mantissa keeps (the reference's 17)
_MANT_DIGITS = 17


def cast_string_to_float(c: StrV, cap: int, to: T.DataType) -> ColV:
    """string -> float/double, the reference's parse (not a correctly
    rounded strtod): the 17 most significant mantissa digits summed in
    f64 from the most significant one, each times 10^place, then times
    10^(exponent - fraction digits). The reference reads a row with no
    exponent as signed when the pool's first byte is a sign (an int32
    overflow of its BIG marker): the port does not copy that."""
    t = _trimmed_lower(c, cap)
    n, pos, rid, within, in_data = _row_bytes(t)
    dev = pos.device
    lens = S.byte_lens(t.offsets)
    res = torch.zeros(cap, dtype=torch.float64, device=dev)
    special = torch.zeros(cap, dtype=torch.bool, device=dev)
    for lit, v in [(b"inf", np.inf), (b"+inf", np.inf), (b"-inf", -np.inf),
                   (b"infinity", np.inf), (b"+infinity", np.inf),
                   (b"-infinity", -np.inf), (b"nan", np.nan)]:
        hit = S.equals_literal(t, lit)
        res = torch.where(hit, v, res)
        special = special | hit
    ch = t.chars
    off = t.offsets[:-1]
    first = S._at(ch, off.clamp(0, n - 1))
    has_sign = (first == ord("-")) | (first == ord("+"))
    neg = first == ord("-")
    is_digit = (ch >= ord("0")) & (ch <= ord("9"))
    is_dot = ch == ord(".")
    is_e = ch == ord("e")
    epos = _first_at(in_data & is_e, t.offsets)
    dotpos = _first_at(in_data & is_dot, t.offsets)
    n_e = _row_sums(in_data & is_e, t.offsets)
    n_dot = _row_sums(in_data & is_dot, t.offsets)
    has_e = epos < _BIG
    mant_end = torch.where(has_e, epos, lens)
    in_mant = in_data & (within < S._at(mant_end, rid)) & is_digit
    Pm = S.prefix_counts(in_mant)
    md_before = _row_sums(in_mant, t.offsets)
    w = _first_at(in_mant & (ch != ord("0")), t.offsets)
    at = (off.long() + w.clamp(max=n).long()).clamp(max=n)
    nzidx = torch.where(w < _BIG, S._at(Pm, at) - S._at(Pm, off), _BIG)
    # the byte of each row's k-th mantissa digit: a scatter by ordinal
    at_ord = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    at_ord[torch.where(in_mant, Pm[:-1], n).long()] = pos
    base = S._at(Pm, off).long() + nzidx.long()
    mant = torch.zeros(cap, dtype=torch.float64, device=dev)
    for k in range(_MANT_DIGITS):
        o = nzidx.long() + k
        here = (nzidx < _BIG) & (o < md_before)
        p = at_ord[torch.where(here, base + k, n).clamp(max=n)]
        d = (S._at(ch, p) - ord("0")).to(torch.float64)
        place = (md_before - 1 - o).to(torch.float64)
        mant = torch.where(here, mant + d * torch.pow(10.0, place), mant)
    frac = torch.where(
        dotpos < mant_end,
        _row_sums(in_mant & (within > S._at(dotpos, rid)), t.offsets), 0)
    e_first = S._at(ch, (off.long() + epos.long() + 1).clamp(0, n - 1))
    e_sign = has_e & (epos < lens) & (e_first == ord("-"))
    e_has_sign = has_e & ((e_first == ord("-")) | (e_first == ord("+")))
    in_exp = in_data & (within.long() > S._at(epos.long() + e_has_sign.long(),
                                            rid))
    exp_dig_bad = _row_sums(in_exp & ~is_digit, t.offsets)
    ndexp = torch.where(has_e, lens.long() - epos - 1 - e_has_sign.long(), 0)
    Pe = S.prefix_counts(in_exp & is_digit)
    eidx = Pe[:-1] - S._at(S._at(Pe, off), rid)
    eplace = S._at(ndexp, rid) - 1 - eidx
    pw = torch.tensor(_POW10[:9], dtype=torch.int64, device=dev)
    econtrib = torch.where(in_exp & is_digit & (eplace < 9),
                           (ch.long() - ord("0"))
                           * S._at(pw, eplace.clamp(0, 8)), 0)
    eval_ = _row_sums(econtrib, t.offsets).to(torch.int32)
    eval_ = torch.where(e_sign, -eval_, eval_)
    scale = (eval_ - frac).to(torch.float64)
    val = mant * torch.pow(10.0, scale)
    val = torch.where(neg, -val, val)
    bad = (in_data & ~is_digit & ~is_dot & ~is_e
           & ~((within == 0) & S._at(has_sign, rid))
           & ~((within.long() == S._at(epos.long(), rid) + 1)
               & S._at(e_has_sign, rid)))
    nbad = _row_sums(bad, t.offsets)
    ok = ((nbad == 0) & (n_dot <= 1) & (n_e <= 1) & (md_before >= 1)
          & (~has_e | (ndexp >= 1)) & (exp_dig_bad == 0)
          & ((dotpos == _BIG) | (dotpos < mant_end)))
    out = torch.where(special, res, val)
    valid = c.validity & (ok | special)
    dt = torch.float32 if isinstance(to, T.FloatType) else torch.float64
    return ColV(torch.where(valid, out, 0.0).to(dt), valid)


def cast_int_to_string(c: ColV, cap: int, frm: T.DataType) -> StrV:
    """Integral -> decimal string. The reference takes the magnitude in
    uint64; here the digits come from the non-positive value (INT64_MIN
    has no positive int64) by truncating division."""
    x = c.data.to(torch.int64)
    neg = x < 0
    q = torch.where(neg, x, -x)  # <= 0
    digits = []
    for _ in range(19):  # least significant first
        nxt = torch.div(q, 10, rounding_mode="trunc")
        digits.append(nxt * 10 - q)
        q = nxt
    digits = torch.stack(digits, dim=1)  # (cap, 19)
    nz = digits != 0
    hi = 18 - torch.argmax(torch.flip(nz, [1]).to(torch.int32), dim=1)
    nd = torch.where(nz.any(dim=1), hi + 1, 1).to(torch.int32)
    lens = torch.where(c.validity, nd + neg.to(torch.int32), 0)
    new_offsets = S.offsets_of_lens(lens)
    out_cap = choose_capacity(max(cap * 20, 128))
    dig8 = (digits + ord("0")).to(torch.uint8)

    def fill(pos, rid, w):
        sneg = S._at(neg, rid)
        k = S._at(nd, rid) - 1 - (w - sneg.to(torch.int32))
        d = dig8[rid.long(), k.clamp(0, 18).long()]
        return torch.where((w == 0) & sneg, ord("-"), d).to(torch.uint8)

    return StrV(new_offsets, _live_bytes(new_offsets, out_cap, fill),
                c.validity)


def cast_bool_to_string(c: ColV, cap: int) -> StrV:
    lens = torch.where(c.validity, torch.where(c.data, 4, 5), 0).to(
        torch.int32)
    new_offsets = S.offsets_of_lens(lens)
    out_cap = choose_capacity(max(cap * 5, 128))
    dev = c.validity.device
    tpat = torch.tensor(list(b"true\x00"), dtype=torch.uint8, device=dev)
    fpat = torch.tensor(list(b"false"), dtype=torch.uint8, device=dev)

    def fill(pos, rid, w):
        w = w.clamp(0, 4).long()
        return torch.where(S._at(c.data, rid), tpat[w], fpat[w])

    return StrV(new_offsets, _live_bytes(new_offsets, out_cap, fill),
                c.validity)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def _replace_growth(expr) -> int:
    """Worst-case growth of output bytes of a (regexp_)replace with
    literal operands (1 where the lowering nulls out or raises)."""
    try:
        if isinstance(expr, E.RegExpReplace):
            from ..ops import regex as RX

            pat = lit_str(expr.pattern, "p")
            search = RX.regex_as_literal(pat) if pat is not None else None
        else:
            search = lit_str(expr.search, "s")
        repl = lit_str(expr.replacement, "r")
    except UnsupportedExpressionError:
        return 1
    if not search or repl is None:
        return 1
    ms = len(search.encode("utf-8"))
    mr = len(repl.encode("utf-8"))
    return max(1, -(-mr // ms))



def _string_input(v, what: str):
    if not isinstance(v, (StrV, DictV)):
        raise UnsupportedExpressionError(f"{what} takes a string input")
    return v


def lower_strings(expr: E.Expression, ev: Callable, cap: int):
    """Lower a string-family expression; None if ``expr`` is not one
    (reference ``eval_strings.py:968``). Dictionary-encoded inputs go
    through :func:`_on_dict`; concat materializes them, and the pads
    materialize only a DictV (a non-string child must go on failing)."""
    if isinstance(expr, (E.Upper, E.Lower)):
        up = isinstance(expr, E.Upper)
        return _on_dict(_string_input(ev(expr.child), type(expr).__name__),
                        cap, lambda c, k: _upper_lower(expr, c, up))
    if isinstance(expr, E.InitCap):
        return _on_dict(_string_input(ev(expr.child), "initcap"), cap,
                        lambda c, k: _initcap(c))
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
    if isinstance(expr, E.Like):
        return _on_dict(_string_input(ev(expr.left), "LIKE"), cap,
                        lambda c, k: _like(expr, c, k))
    if isinstance(expr, E.RLike):
        return _on_dict(_string_input(ev(expr.left), "RLIKE"), cap,
                        lambda c, k: _rlike(expr, c, k))
    if isinstance(expr, E.RegExpReplace):
        return _on_dict(_string_input(ev(expr.str), "regexp_replace"), cap,
                        lambda c, k: _regexp_replace(expr, c, k),
                        growth=_replace_growth(expr))
    if isinstance(expr, E.StringLocate):
        c = _string_input(ev(expr.str), "locate")
        if isinstance(c, DictV) and isinstance(expr.start, E.Literal) \
                and expr.start.value is None:
            # a null start gives 0 for EVERY row, null inputs too: the
            # validity is not the input's, so it must not go through the
            # codes
            dev = c.validity.device
            return ColV(torch.zeros(cap, dtype=torch.int32, device=dev),
                        torch.ones(cap, dtype=torch.bool, device=dev))
        return _on_dict(c, cap, lambda c_, k: _locate(expr, c_, k))
    if isinstance(expr, E.StringReplace):
        return _on_dict(_string_input(ev(expr.str), "replace"), cap,
                        lambda c, k: _replace(expr, c, k),
                        growth=_replace_growth(expr))
    if isinstance(expr, (E.StringLPad, E.StringRPad)):
        # no dictionary-level form (mat_cap cannot bound the padded
        # width): materialize a DictV, and only a DictV
        c = _string_input(ev(expr.str), "pad")
        if isinstance(c, DictV):
            c = materialize_dict(c)
        return _pad(expr, c, cap, left=isinstance(expr, E.StringLPad))
    if isinstance(expr, E.SubstringIndex):
        return _on_dict(_string_input(ev(expr.str), "substring_index"), cap,
                        lambda c, k: _substring_index(expr, c, k))
    if isinstance(expr, E.StringSplitPart):
        return _on_dict(_string_input(ev(expr.str), "split"), cap,
                        lambda c, k: _split_part(expr, c, k))
    return None


def lower_string_cast(c: StrV, to: T.DataType, cap: int):
    """Casts FROM string (reference ``eval_strings.py:1028``)."""
    if isinstance(to, T.StringType):
        return c
    if isinstance(to, T.BooleanType):
        return cast_string_to_bool(c, cap)
    if to.name in _INTEGRAL:
        return cast_string_to_int(c, cap, to)
    if to.is_floating:
        return cast_string_to_float(c, cap, to)
    if isinstance(to, T.DateType):
        return parse_date(c, cap)
    if isinstance(to, T.TimestampType):
        return parse_timestamp(c, cap)
    raise UnsupportedExpressionError(
        f"cast string -> {to.simpleString} is not supported on TPU")


def lower_cast_to_string(c: ColV, frm: T.DataType, cap: int):
    """Casts TO string from fixed-width types (reference
    ``eval_strings.py:1050``)."""
    if isinstance(frm, T.BooleanType):
        return cast_bool_to_string(c, cap)
    if frm.name in _INTEGRAL:
        return cast_int_to_string(c, cap, frm)
    if isinstance(frm, T.DateType):
        return format_date(c, cap)
    if isinstance(frm, T.TimestampType):
        return format_timestamp(c, cap)
    if frm.is_floating:
        raise UnsupportedExpressionError(
            "cast float -> string is not supported on TPU (would require "
            "Java shortest-repr formatting; the reference gates this behind "
            "spark.rapids.sql.castFloatToString.enabled for the same reason)")
    raise UnsupportedExpressionError(
        f"cast {frm.simpleString} -> string is not supported on TPU")
