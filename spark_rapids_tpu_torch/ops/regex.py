"""Regular expressions: a host-compiled byte DFA and its per-row matcher.

Own copy of ``spark_rapids_tpu/ops/regex.py``. The host half is the
reference's as it is: :func:`regex_as_literal` (the reference's
"treated like a regular string" guard), a parser of the supported subset
(literals, ``.``, classes, ``* + ? {m,n}``, alternation, grouping, ``^ $``
anchors; UTF-8 aware: multi-byte characters become byte-sequence
alternations, so ``.`` and negated classes count code points) into a
Thompson NFA, and the subset construction of a byte DFA of at most 16
states (:class:`Dfa`: ``lut_lo``/``lut_hi`` pack the 4-bit next states
of each input byte). Unsupported constructs raise
:class:`RegexUnsupported` and the planner falls back to the CPU for the
expression. Semantics follow Java's Pattern for the subset (which agrees
with Python ``re`` there; the CPU engine uses ``re``).

The device half, :func:`dfa_accept_rows`, is the reference's segmented
``lax.associative_scan`` of packed transition vectors. PyTorch has no
associative scan with a user combine, so the port walks each row through
the DFA in a hand-written CUDA kernel (``ops/regex_kernels.py``,
``csrc/regex_kernels.cu``); CPU tensors take its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

# the device half: the row matcher (its kernel on a CUDA tensor, its plain
# version on a CPU one)
from .regex_kernels import dfa_accept_rows  # noqa: F401

MAX_DFA_STATES = 16


class RegexUnsupported(Exception):
    """Pattern outside the supported subset — caller falls back."""


# ---------------------------------------------------------------------------
# the "treated like a regular string" guard (GpuOverrides.scala:414)
# ---------------------------------------------------------------------------
_META = set(".^$*+?()[]{}|\\")


def regex_as_literal(pattern: str) -> Optional[str]:
    """The literal string this regex matches verbatim, or None.

    Mirrors ``canRegexpBeTreatedLikeARegularString``: no active
    metacharacters; ``\\x`` escapes of metacharacters unescape."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            if i + 1 >= len(pattern):
                return None
            n = pattern[i + 1]
            # escaped punctuation is that literal char in Java (and
            # Python); escaped letters/digits are regex classes
            if not n.isalnum():
                out.append(n)
                i += 2
                continue
            return None
        if c in _META:
            return None
        out.append(c)
        i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# parser -> NFA (byte-based, UTF-8 aware)
# ---------------------------------------------------------------------------
ByteSet = FrozenSet[int]

_ASCII_D = frozenset(range(0x30, 0x3A))
_ASCII_W = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
    + list(range(0x61, 0x7B)) + [0x5F]
)
_ASCII_S = frozenset([0x20, 0x09, 0x0A, 0x0B, 0x0C, 0x0D])
_ALL_ASCII = frozenset(range(0x80))


@dataclasses.dataclass
class _Nfa:
    """Thompson NFA: states 0..n-1; edges (src, byteset|None=eps, dst)."""

    n: int = 0
    eps: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    edges: List[Tuple[int, ByteSet, int]] = dataclasses.field(
        default_factory=list)

    def state(self) -> int:
        self.n += 1
        return self.n - 1


@dataclasses.dataclass(frozen=True)
class _Frag:
    start: int
    end: int


def _byte_edge(nfa: _Nfa, bs: ByteSet) -> _Frag:
    s, e = nfa.state(), nfa.state()
    nfa.edges.append((s, bs, e))
    return _Frag(s, e)


_CONT = frozenset(range(0x80, 0xC0))


def _nonascii_char(nfa: _Nfa) -> _Frag:
    """Fragment matching ONE non-ASCII codepoint (its UTF-8 bytes)."""
    s, e = nfa.state(), nfa.state()
    # 2-byte
    m1 = nfa.state()
    nfa.edges.append((s, frozenset(range(0xC2, 0xE0)), m1))
    nfa.edges.append((m1, _CONT, e))
    # 3-byte
    m2a, m2b = nfa.state(), nfa.state()
    nfa.edges.append((s, frozenset(range(0xE0, 0xF0)), m2a))
    nfa.edges.append((m2a, _CONT, m2b))
    nfa.edges.append((m2b, _CONT, e))
    # 4-byte
    m3a, m3b, m3c = nfa.state(), nfa.state(), nfa.state()
    nfa.edges.append((s, frozenset(range(0xF0, 0xF5)), m3a))
    nfa.edges.append((m3a, _CONT, m3b))
    nfa.edges.append((m3b, _CONT, m3c))
    nfa.edges.append((m3c, _CONT, e))
    return _Frag(s, e)


def _char_frag(nfa: _Nfa, ascii_set: ByteSet, include_nonascii: bool) -> _Frag:
    """Fragment matching one CHARACTER from an ASCII set, optionally also
    any non-ASCII character."""
    if not include_nonascii:
        return _byte_edge(nfa, ascii_set)
    s, e = nfa.state(), nfa.state()
    if ascii_set:
        a = _byte_edge(nfa, ascii_set)
        nfa.eps.append((s, a.start))
        nfa.eps.append((a.end, e))
    na = _nonascii_char(nfa)
    nfa.eps.append((s, na.start))
    nfa.eps.append((na.end, e))
    return _Frag(s, e)


def _literal_char(nfa: _Nfa, ch: str) -> _Frag:
    b = ch.encode("utf-8")
    if len(b) == 1:
        return _byte_edge(nfa, frozenset([b[0]]))
    frag = None
    for byte in b:
        f = _byte_edge(nfa, frozenset([byte]))
        if frag is None:
            frag = f
        else:
            nfa.eps.append((frag.end, f.start))
            frag = _Frag(frag.start, f.end)
    return frag


class _Parser:
    """Recursive-descent parser for the supported subset."""

    def __init__(self, pattern: str, nfa: _Nfa):
        self.p = pattern
        self.i = 0
        self.nfa = nfa
        self.anchored_start = False
        self.anchored_end = False

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self) -> _Frag:
        if self.peek() == "^":
            self.anchored_start = True
            self.next()
        frag = self.alternation(top=True)
        if self.i < len(self.p):
            raise RegexUnsupported(f"trailing input at {self.i}")
        return frag

    def alternation(self, top: bool = False) -> _Frag:
        frags = [self.concat(top)]
        while self.peek() == "|":
            self.next()
            frags.append(self.concat(top))
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.state(), self.nfa.state()
        for f in frags:
            self.nfa.eps.append((s, f.start))
            self.nfa.eps.append((f.end, e))
        return _Frag(s, e)

    def concat(self, top: bool = False) -> _Frag:
        frags: List[_Frag] = []
        while True:
            c = self.peek()
            if c is None or c in "|)":
                break
            if c == "$":
                if not top or self.i + 1 != len(self.p):
                    raise RegexUnsupported("'$' not at end")
                self.anchored_end = True
                self.next()
                break
            if c == "^":
                raise RegexUnsupported("'^' not at start")
            frags.append(self.repeat())
        if not frags:
            s = self.nfa.state()
            return _Frag(s, s)
        out = frags[0]
        for f in frags[1:]:
            self.nfa.eps.append((out.end, f.start))
            out = _Frag(out.start, f.end)
        return out

    def repeat(self) -> _Frag:
        atom_start = self.i
        frag = self.atom()
        c = self.peek()
        if c not in ("*", "+", "?", "{"):
            return frag
        if c == "{":
            m, n = self._bounds()
        else:
            self.next()
            m, n = {"*": (0, None), "+": (1, None), "?": (0, 1)}[c]
        if self.peek() == "?":
            raise RegexUnsupported("lazy quantifier")
        atom_src = self.p[atom_start : self.i]
        # expand {m,n} by atom repetition (DFA doesn't count)
        if m > 8 or (n is not None and n > 16):
            raise RegexUnsupported("large bounded repetition")

        def clone() -> _Frag:
            sub = _Parser(atom_src, self.nfa)
            f = sub.repeat_cloned()
            return f

        return self._repeat_frag(frag, m, n, clone)

    def repeat_cloned(self) -> _Frag:
        # atom_src includes the quantifier-free atom only
        return self.atom()

    def _repeat_frag(self, frag, m, n, clone) -> _Frag:
        nfa = self.nfa
        if (m, n) == (0, None):  # *
            s = nfa.state()
            nfa.eps.append((s, frag.start))
            nfa.eps.append((frag.end, s))
            return _Frag(s, s)
        if (m, n) == (1, None):  # +
            nfa.eps.append((frag.end, frag.start))
            s, e = nfa.state(), nfa.state()
            nfa.eps.append((s, frag.start))
            nfa.eps.append((frag.end, e))
            return _Frag(s, e)
        if (m, n) == (0, 1):  # ?
            s, e = nfa.state(), nfa.state()
            nfa.eps.append((s, frag.start))
            nfa.eps.append((frag.end, e))
            nfa.eps.append((s, e))
            return _Frag(s, e)
        # {m,n} / {m,}: m required copies then (n-m) optional (or a star)
        parts: List[_Frag] = [frag]
        for _ in range(m - 1 if m > 0 else 0):
            parts.append(clone())
        out: Optional[_Frag] = None
        for f in parts if m > 0 else []:
            if out is None:
                out = f
            else:
                nfa.eps.append((out.end, f.start))
                out = _Frag(out.start, f.end)
        if n is None:  # {m,}: trailing star of a clone
            f = clone()
            s = nfa.state()
            nfa.eps.append((s, f.start))
            nfa.eps.append((f.end, s))
            star = _Frag(s, s)
            if out is None:
                return star
            nfa.eps.append((out.end, star.start))
            return _Frag(out.start, star.end)
        for _ in range(n - m):
            f = clone()
            s, e = nfa.state(), nfa.state()
            nfa.eps.append((s, f.start))
            nfa.eps.append((f.end, e))
            nfa.eps.append((s, e))
            opt = _Frag(s, e)
            if out is None:
                out = opt
            else:
                nfa.eps.append((out.end, opt.start))
                out = _Frag(out.start, opt.end)
        assert out is not None
        return out

    def _bounds(self) -> Tuple[int, Optional[int]]:
        assert self.next() == "{"
        j = self.p.find("}", self.i)
        if j < 0:
            raise RegexUnsupported("unclosed {")
        body = self.p[self.i : j]
        self.i = j + 1
        if "," in body:
            lo, hi = body.split(",", 1)
            if not lo.isdigit() or (hi and not hi.isdigit()):
                raise RegexUnsupported(f"bounds {{{body}}}")
            return int(lo), (int(hi) if hi else None)
        if not body.isdigit():
            raise RegexUnsupported(f"bounds {{{body}}}")
        return int(body), int(body)

    def atom(self) -> _Frag:
        c = self.next()
        if c == "(":
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2
            elif self.peek() == "?":
                raise RegexUnsupported("special group")
            f = self.alternation()
            if self.peek() != ")":
                raise RegexUnsupported("unclosed group")
            self.next()
            return f
        if c == ".":
            # Java dot: any char except line terminators (\n \r; the
            # non-ASCII terminators U+0085/U+2028/U+2029 still match —
            # documented incompat, they are vanishingly rare in data)
            return _char_frag(
                self.nfa, _ALL_ASCII - frozenset([0x0A, 0x0D]), True)
        if c == "[":
            return self._char_class()
        if c == "\\":
            return self._escape()
        if c in "*+?{":
            raise RegexUnsupported(f"dangling quantifier {c!r}")
        return _literal_char(self.nfa, c)

    def _escape(self) -> _Frag:
        if self.peek() is None:
            raise RegexUnsupported("dangling backslash")
        c = self.next()
        table = {
            "d": (_ASCII_D, False), "D": (_ALL_ASCII - _ASCII_D, True),
            "w": (_ASCII_W, False), "W": (_ALL_ASCII - _ASCII_W, True),
            "s": (_ASCII_S, False), "S": (_ALL_ASCII - _ASCII_S, True),
        }
        if c in table:
            bs, nonascii = table[c]
            return _char_frag(self.nfa, bs, nonascii)
        simple = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "0": "\0"}
        if c in simple:
            return _literal_char(self.nfa, simple[c])
        if not c.isalnum():  # escaped punctuation = literal (Java)
            return _literal_char(self.nfa, c)
        raise RegexUnsupported(f"escape \\{c}")

    def _char_class(self) -> _Frag:
        neg = False
        if self.peek() == "^":
            neg = True
            self.next()
        members: Set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexUnsupported("unclosed [")
            if c == "]" and not first:
                self.next()
                break
            first = False
            c = self.next()
            if c == "\\":
                e = self.next() if self.peek() is not None else None
                if e is None:
                    raise RegexUnsupported("dangling backslash in class")
                cls = {"d": _ASCII_D, "w": _ASCII_W, "s": _ASCII_S}.get(e)
                if cls is not None:
                    members |= set(cls)
                    continue
                simple = {"n": "\n", "t": "\t", "r": "\r"}.get(e, e)
                if len(simple.encode("utf-8")) != 1:
                    raise RegexUnsupported("non-ASCII class member")
                members.add(simple.encode("utf-8")[0])
                continue
            if ord(c) > 0x7F:
                raise RegexUnsupported("non-ASCII class member")
            if self.peek() == "-" and self.i + 1 < len(self.p) and \
                    self.p[self.i + 1] != "]":
                self.next()
                hi = self.next()
                if ord(hi) > 0x7F:
                    raise RegexUnsupported("non-ASCII class range")
                if ord(hi) < ord(c):
                    raise RegexUnsupported("reversed class range")
                members |= set(range(ord(c), ord(hi) + 1))
            else:
                members.add(ord(c))
        if neg:
            return _char_frag(self.nfa, _ALL_ASCII - frozenset(members), True)
        return _char_frag(self.nfa, frozenset(members), False)


# ---------------------------------------------------------------------------
# NFA -> DFA (subset construction)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Dfa:
    """Byte DFA packed for device execution.

    lut_lo/lut_hi: (256,) uint32 — per input byte, the packed transition
    vector next[s] for s in 0..15 (4 bits each; states >= 8 in hi).
    State 0 is the start; ``dead`` marks the absorbing reject state."""

    nstates: int
    lut_lo: np.ndarray
    lut_hi: np.ndarray
    accept_mask: int
    start_accept: bool
    absorbing: bool = True  # no '$': accept sticks once reached


def compile_search_dfa(pattern: str) -> Dfa:
    """DFA for Java ``Matcher.find`` semantics (unanchored unless ^/$)."""
    nfa = _Nfa()
    parser = _Parser(pattern, nfa)
    frag = parser.parse()
    start = nfa.state()
    accept = frag.end
    nfa.eps.append((start, frag.start))
    if not parser.anchored_start:
        # leading any-byte loop (bytes, not chars: prefix skipping does
        # not need codepoint alignment — match starts are byte positions
        # and multi-byte atoms re-align)
        loop = _byte_edge(nfa, frozenset(range(256)))
        nfa.eps.append((start, loop.start))
        nfa.eps.append((loop.end, start))
    absorbing = not parser.anchored_end
    return _build_dfa(nfa, start, accept, absorbing)


def _build_dfa(nfa: _Nfa, start: int, accept: int, absorbing: bool) -> Dfa:
    eps_adj: Dict[int, List[int]] = {}
    for a, b in nfa.eps:
        eps_adj.setdefault(a, []).append(b)
    by_src: Dict[int, List[Tuple[ByteSet, int]]] = {}
    for s, bs, d in nfa.edges:
        by_src.setdefault(s, []).append((bs, d))

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in eps_adj.get(s, ()):
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure(frozenset([start]))
    dfa_ids: Dict[FrozenSet[int], int] = {start_set: 0}
    order: List[FrozenSet[int]] = [start_set]
    trans: List[List[int]] = []
    i = 0
    ACCEPT_SENTINEL = frozenset([-1])
    while i < len(order):
        cur = order[i]
        i += 1
        row = [None] * 256
        if cur is ACCEPT_SENTINEL or (absorbing and accept in cur):
            # absorbing accept: all bytes stay accepted
            aid = dfa_ids.get(ACCEPT_SENTINEL)
            if aid is None:
                aid = len(order)
                if aid >= MAX_DFA_STATES:
                    raise RegexUnsupported(
                        f"DFA exceeds {MAX_DFA_STATES} states")
                dfa_ids[ACCEPT_SENTINEL] = aid
                order.append(ACCEPT_SENTINEL)
            trans.append([aid] * 256)
            continue
        # group target sets per byte
        for b in range(256):
            tgt = set()
            for s in cur:
                for bs, d in by_src.get(s, ()):
                    if b in bs:
                        tgt.add(d)
            t = closure(frozenset(tgt)) if tgt else frozenset()
            tid = dfa_ids.get(t)
            if tid is None:
                tid = len(order)
                if tid >= MAX_DFA_STATES:
                    raise RegexUnsupported(
                        f"DFA exceeds {MAX_DFA_STATES} states")
                dfa_ids[t] = tid
                order.append(t)
            row[b] = tid
        trans.append(row)

    n = len(order)
    accept_mask = 0
    for st, sid in dfa_ids.items():
        if st is ACCEPT_SENTINEL or (st is not None and accept in st):
            accept_mask |= 1 << sid
    lut_lo = np.zeros(256, np.uint32)
    lut_hi = np.zeros(256, np.uint32)
    for b in range(256):
        lo = 0
        hi = 0
        for s in range(min(n, 16)):
            nxt = trans[s][b]
            if s < 8:
                lo |= nxt << (4 * s)
            else:
                hi |= nxt << (4 * (s - 8))
        lut_lo[b] = lo
        lut_hi[b] = hi
    return Dfa(
        nstates=n, lut_lo=lut_lo, lut_hi=lut_hi,
        accept_mask=accept_mask,
        start_accept=bool(accept_mask & 1),
        absorbing=absorbing,
    )
