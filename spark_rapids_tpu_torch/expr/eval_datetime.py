"""Lowerings of the date/time expression family.

Counterpart of ``spark_rapids_tpu/expr/eval_datetime.py``: branch-free
civil-calendar integer math (the era / year-of-era decomposition) as
elementwise torch ops, with the same function names and results. DATE
columns are int32 days since the unix epoch; TIMESTAMP columns are int64
microseconds since the epoch, UTC. Every division that can see a
negative value floors (``torch.div(..., rounding_mode="floor")``, as the
reference's ``jnp.floor_divide``), so pre-epoch rows come out right.

The string conversions (:func:`format_date`, :func:`format_timestamp`,
:func:`parse_date`, :func:`parse_timestamp`) work over the port's
``StrV``; the formatters render each row once into a small per-row
character matrix and fill only the live bytes of the output pool.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .. import types as T
from ..columnar.column import choose_capacity
from ..ops import strings as S
from . import expressions as E
from .values import ColV, StrV, UnsupportedExpressionError

_US_PER_DAY = 86_400_000_000
_US_PER_SEC = 1_000_000
_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
_POW10 = [10**k for k in range(19)]


def _fdiv(a, b):
    """Floor division (``jnp.floor_divide``)."""
    return torch.div(a, b, rounding_mode="floor")


def _pow10(k: torch.Tensor) -> torch.Tensor:
    """10**k for an integer tensor k in [0, 18]."""
    table = torch.tensor(_POW10, dtype=torch.int64, device=k.device)
    return table[k.clamp(0, 18).long()]


# ---------------------------------------------------------------------------
# civil-calendar core (Howard Hinnant's algorithms, integer only)
# ---------------------------------------------------------------------------
def civil_from_days(days) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """days since the epoch -> (year, month, day), proleptic Gregorian."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def days_from_civil(y, m, d) -> torch.Tensor:
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = m.to(torch.int64) + torch.where(m > 2, -3, 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def is_leap(y) -> torch.Tensor:
    return ((y % 4) == 0) & (((y % 100) != 0) | ((y % 400) == 0))


def days_in_month(y, m) -> torch.Tensor:
    base = torch.tensor(_MONTH_DAYS, dtype=torch.int64, device=m.device)
    d = base[torch.clamp(m - 1, 0, 11).long()]
    return torch.where((m == 2) & is_leap(y), 29, d)


def _days_of(expr_dtype: T.DataType, data) -> torch.Tensor:
    """A DATE or TIMESTAMP column as days since the epoch."""
    if isinstance(expr_dtype, T.TimestampType):
        return _fdiv(data.to(torch.int64), _US_PER_DAY)
    return data.to(torch.int64)


def _time_of_day(us) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    us = us.to(torch.int64)
    sod = _fdiv(us - _fdiv(us, _US_PER_DAY) * _US_PER_DAY, _US_PER_SEC)
    return _fdiv(sod, 3600), _fdiv(sod, 60) % 60, sod % 60


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------
def lower_datetime(expr: E.Expression, ev: Callable, cap: int):
    """Lower a date/time expression; None if ``expr`` is not one."""
    from .eval_strings import lit_str

    def i32(x):
        return x.to(torch.int32)

    if isinstance(expr, E._DateUnary):
        c = ev(expr.child)
        dt = expr.child.dtype
        if not isinstance(dt, (T.DateType, T.TimestampType)):
            raise UnsupportedExpressionError(
                f"{type(expr).__name__} needs a date/timestamp input")
        if isinstance(expr, (E.Hour, E.Minute, E.Second)):
            if not isinstance(dt, T.TimestampType):
                raise UnsupportedExpressionError(
                    f"{type(expr).__name__} needs a timestamp input")
            h, mi, s = _time_of_day(c.data)
            v = {E.Hour: h, E.Minute: mi, E.Second: s}[type(expr)]
            return ColV(i32(v), c.validity)
        days = _days_of(dt, c.data)
        if isinstance(expr, E.DayOfWeek):
            return ColV(i32(torch.remainder(days + 4, 7) + 1), c.validity)
        if isinstance(expr, E.WeekDay):
            return ColV(i32(torch.remainder(days + 3, 7)), c.validity)
        y, m, d = civil_from_days(days)
        if isinstance(expr, E.Year):
            return ColV(i32(y), c.validity)
        if isinstance(expr, E.Quarter):
            return ColV(i32(_fdiv(m - 1, 3) + 1), c.validity)
        if isinstance(expr, E.Month):
            return ColV(i32(m), c.validity)
        if isinstance(expr, E.DayOfMonth):
            return ColV(i32(d), c.validity)
        if isinstance(expr, E.DayOfYear):
            first = days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
            return ColV(i32(days - first + 1), c.validity)
        raise UnsupportedExpressionError(type(expr).__name__)

    if isinstance(expr, (E.DateAdd, E.DateSub)):
        s = ev(expr.start_date)
        n = ev(expr.days)
        sign = 1 if isinstance(expr, E.DateAdd) else -1
        v = s.data.to(torch.int64) + sign * n.data.to(torch.int64)
        return ColV(i32(v), s.validity & n.validity)

    if isinstance(expr, E.DateDiff):
        e_ = ev(expr.end_date)
        s_ = ev(expr.start_date)
        v = (_days_of(expr.end_date.dtype, e_.data)
             - _days_of(expr.start_date.dtype, s_.data))
        return ColV(i32(v), e_.validity & s_.validity)

    if isinstance(expr, E.LastDay):
        c = ev(expr.start_date)
        days = _days_of(expr.start_date.dtype, c.data)
        y, m, d = civil_from_days(days)
        first = days_from_civil(y, m, torch.ones_like(d))
        return ColV(i32(first + days_in_month(y, m) - 1), c.validity)

    if isinstance(expr, E.UnixTimestamp):  # covers ToUnixTimestamp
        c = ev(expr.child)
        dt = expr.child.dtype
        if isinstance(dt, T.TimestampType):
            v = _fdiv(c.data.to(torch.int64), _US_PER_SEC)
        elif isinstance(dt, T.DateType):
            v = c.data.to(torch.int64) * 86400
        else:
            raise UnsupportedExpressionError(
                "unix_timestamp over strings needs the gated timestamp "
                "parser; only date/timestamp inputs run on TPU")
        return ColV(v, c.validity)

    if isinstance(expr, E.FromUnixTime):
        fmt = lit_str(expr.format, "from_unixtime format")
        if fmt != "yyyy-MM-dd HH:mm:ss":
            raise UnsupportedExpressionError(
                "from_unixtime supports only the default "
                "'yyyy-MM-dd HH:mm:ss' format on TPU")
        c = ev(expr.sec)
        us = c.data.to(torch.int64) * _US_PER_SEC
        return format_timestamp(ColV(us, c.validity), cap,
                                with_fraction=False)

    if isinstance(expr, E.TimeAdd):
        c = ev(expr.start)
        v = c.data.to(torch.int64) + (expr.days * _US_PER_DAY
                                      + expr.microseconds)
        return ColV(v, c.validity)

    if isinstance(expr, E.TruncDate):
        fmt = lit_str(expr.fmt, "trunc format")
        c = ev(expr.date)
        dev = c.validity.device
        null = ColV(torch.zeros(cap, dtype=torch.int32, device=dev),
                    torch.zeros(cap, dtype=torch.bool, device=dev))
        if fmt is None:
            return null
        f = fmt.lower()
        days = _days_of(expr.date.dtype, c.data)
        y, m, d = civil_from_days(days)
        one = torch.ones_like(m)
        if f in ("year", "yyyy", "yy"):
            v = days_from_civil(y, one, one)
        elif f in ("quarter",):
            v = days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
        elif f in ("month", "mon", "mm"):
            v = days_from_civil(y, m, one)
        elif f in ("week",):
            v = days - torch.remainder(days + 3, 7)  # back to Monday
        else:
            return null  # Spark: an unknown format gives NULL
        return ColV(i32(v), c.validity)

    return None


# ---------------------------------------------------------------------------
# date/timestamp <-> string (the Cast rows of eval_strings)
# ---------------------------------------------------------------------------
def _year_width(ya: torch.Tensor) -> torch.Tensor:
    """Digits of |year|: 4, zero-padded, wider past 9999 (the reference
    takes a float log10; integer compares give the same counts)."""
    w = torch.full_like(ya, 4)
    for k in range(4, 18):
        w = w + (ya >= _POW10[k]).to(torch.int64)
    return w


def _render(rows: torch.Tensor, lens: torch.Tensor, valid: torch.Tensor,
            out_cap: int) -> StrV:
    """A StrV from a (cap, W) uint8 matrix of each row's characters and
    the row lengths: only the live bytes are gathered."""
    from .eval_strings import _live_bytes

    lens = torch.where(valid, lens, 0).to(torch.int32)
    new_offsets = S.offsets_of_lens(lens)

    def fill(pos, rid, w):
        return rows[rid.long(), w.long()]

    return StrV(new_offsets, _live_bytes(new_offsets, out_cap, fill), valid)


def _digit(v: torch.Tensor, k) -> torch.Tensor:
    """The character of decimal digit k (0 = least significant) of v."""
    p = _pow10(k) if isinstance(k, torch.Tensor) else _POW10[k]
    return (_fdiv(v, p) % 10 + ord("0")).to(torch.uint8)


def _date_prefix(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor,
                 width: int):
    """Per-row characters of ``[-]yyyy-MM-dd`` in columns [0, width),
    and each row's length."""
    neg = (y < 0).to(torch.int64)
    ya = torch.abs(y)
    yw = _year_width(ya)
    cols = []
    for j in range(width):
        rel = j - neg - yw  # 0 '-', 1..2 MM, 3 '-', 4..5 dd
        ych = _digit(ya, yw - 1 - (j - neg))
        ch = torch.where((j == 0) & (neg == 1), ord("-"), ych)
        ch = torch.where((rel == 0) | (rel == 3), ord("-"), ch)
        for r, v, k in ((1, m, 1), (2, m, 0), (4, d, 1), (5, d, 0)):
            ch = torch.where(rel == r, _digit(v, k), ch)
        cols.append(ch.to(torch.uint8))
    return cols, neg + yw + 6, neg + yw


def format_date(c: ColV, cap: int) -> StrV:
    """DATE -> 'yyyy-MM-dd' (years zero-padded to 4 digits, wider past
    9999, with a sign before the epoch of year 0)."""
    y, m, d = civil_from_days(c.data.to(torch.int64))
    cols, lens, _ = _date_prefix(y, m, d, 14)
    return _render(torch.stack(cols, dim=1), lens, c.validity,
                   choose_capacity(max(cap * 11, 128)))


def format_timestamp(c: ColV, cap: int, with_fraction: bool = True) -> StrV:
    """TIMESTAMP -> 'yyyy-MM-dd HH:mm:ss[.ffffff]' (the fraction trimmed
    of trailing zeros and left out when zero, as Spark's cast)."""
    us = c.data.to(torch.int64)
    y, m, d = civil_from_days(_fdiv(us, _US_PER_DAY))
    h, mi, s = _time_of_day(us)
    frac = us - _fdiv(us, _US_PER_SEC) * _US_PER_SEC
    tz = torch.where(frac == 0, 6, 0)
    f = frac
    for _ in range(6):
        drop = (f != 0) & (f % 10 == 0)
        f = torch.where(drop, _fdiv(f, 10), f)
        tz = tz + drop.to(torch.int64)
    fdig = torch.where(frac == 0, 0, 6 - tz)
    if not with_fraction:
        fdig = torch.zeros_like(fdig)
    width = 1 + 17 + 16
    cols, _, head = _date_prefix(y, m, d, width)
    for j in range(width):
        rel = j - head - 6  # 0 ' ', 1..2 HH, 3 ':', 4..5 mm, 6 ':', ...
        ch = cols[j]
        ch = torch.where(rel == 0, ord(" "), ch)
        ch = torch.where((rel == 3) | (rel == 6), ord(":"), ch)
        ch = torch.where(rel == 9, ord("."), ch)
        for r, v, k in ((1, h, 1), (2, h, 0), (4, mi, 1), (5, mi, 0),
                        (7, s, 1), (8, s, 0)):
            ch = torch.where(rel == r, _digit(v, k), ch)
        ch = torch.where(rel >= 10, _digit(frac, 15 - rel), ch)
        cols[j] = ch.to(torch.uint8)
    lens = head + 15 + torch.where(fdig > 0, fdig + 1, 0)
    return _render(torch.stack(cols, dim=1), lens, c.validity,
                   choose_capacity(max(cap * 27, 128)))


def _seg_value(t: StrV, start, length, max_len: int, n: int):
    """Parse the all-digit segment [start, start + length) -> (value,
    ok)."""
    val = torch.zeros(start.shape[0], dtype=torch.int64, device=start.device)
    ok = torch.ones(start.shape[0], dtype=torch.bool, device=start.device)
    for k in range(max_len):
        inseg = k < length
        b = S._at(t.chars, torch.clamp(start + k, 0, n - 1)).to(torch.int64)
        isd = (b >= ord("0")) & (b <= ord("9"))
        ok = ok & (~inseg | isd)
        dig = torch.where(inseg & isd, b - ord("0"), 0)
        val = val * torch.where(inseg, 10, 1) + dig
    ok = ok & (length >= 1) & (length <= max_len)
    return val, ok


def _live(t: StrV, n: int) -> torch.Tensor:
    """The live bytes of a pool of ``n`` bytes."""
    return S._iota(n, t.chars) < t.offsets[-1]


def parse_date(c: StrV, cap: int) -> ColV:
    """Spark's stringToDate subset: 'yyyy[-M[M][-d[d]]]' after trimming;
    anything else is NULL."""
    from .eval_strings import _occurrence_matrix, _trimmed_lower

    t = _trimmed_lower(c, cap)
    n = int(t.chars.shape[0])
    lens = S.byte_lens(t.offsets)
    off = t.offsets[:-1]
    m = S.find_matches(t.chars, b"-") & _live(t, n)
    P = S.prefix_counts(m)
    rid = S.row_ids(t.offsets, n)
    mat = _occurrence_matrix(m, rid, S._at(off, rid), P, cap, 2)
    ndash = S._at(P, t.offsets[1:]) - S._at(P, off)
    end = off + lens
    p1 = torch.where(ndash >= 1, mat[:, 0], end)
    p2 = torch.where(ndash >= 2, mat[:, 1], end)
    yv, yok = _seg_value(t, off, p1 - off, 4, n)
    yok = yok & ((p1 - off) == 4)  # the year has exactly 4 digits
    mv, mok = _seg_value(t, p1 + 1, p2 - p1 - 1, 2, n)
    dv, dok = _seg_value(t, p2 + 1, end - p2 - 1, 2, n)
    mv = torch.where(ndash >= 1, mv, 1)
    dv = torch.where(ndash >= 2, dv, 1)
    ok = yok & (ndash <= 2)
    ok = ok & ((ndash < 1) | mok) & ((ndash < 2) | dok)
    ok = ok & (yv >= 1) & (mv >= 1) & (mv <= 12) & (dv >= 1)
    ok = ok & (dv <= days_in_month(yv, mv))
    days = days_from_civil(yv, mv, dv)
    return ColV(torch.where(ok, days, 0).to(torch.int32), c.validity & ok)


def parse_timestamp(c: StrV, cap: int) -> ColV:
    """The gated string -> timestamp: 'yyyy-MM-dd[ HH:mm:ss[.f{1,6}]]'
    (a space or 'T' between date and time), the subset behind
    castStringToTimestamp.enabled."""
    from .eval_strings import _occurrence_matrix, _trimmed_lower

    t = _trimmed_lower(c, cap)
    n = int(t.chars.shape[0])
    lens = S.byte_lens(t.offsets)
    off = t.offsets[:-1]
    end = off + lens
    iota = S._iota(n, t.chars)
    live = iota < t.offsets[-1]
    # split date | time at the first ' ' or 't' (a lowercased T)
    nm = S.next_match((S.find_matches(t.chars, b" ")
                       | S.find_matches(t.chars, b"t")) & live)
    sep = S._at(nm, torch.clamp(off, 0, n))
    has_time = (sep < end) & (sep >= off)
    dend = torch.where(has_time, sep, end).to(torch.int32)
    dlen = dend - off
    doff, dchars = S.take_slices(t, off, torch.clamp(dlen, min=0), n)
    dcol = parse_date(StrV(doff, dchars, c.validity), cap)
    # a time needs a FULL yyyy-MM-dd date (Spark rejects
    # '2020-01 10:20:30'): the dashes within the date part
    Pd = S.prefix_counts(S.find_matches(t.chars, b"-") & live)
    ndash_date = (S._at(Pd, torch.clamp(dend, 0, n))
                  - S._at(Pd, torch.clamp(off, 0, n)))
    # the time part: HH:mm:ss[.frac]
    ts = torch.where(has_time, sep + 1, end).to(torch.int32)
    rid = S.row_ids(t.offsets, n)
    cm_time = (S.find_matches(t.chars, b":") & live
               & (iota >= S._at(ts, rid)))
    Pt = S.prefix_counts(cm_time)
    matc = _occurrence_matrix(cm_time, rid, S._at(off, rid), Pt, cap, 2)
    ncolon = S._at(Pt, t.offsets[1:]) - S._at(Pt, off)
    nmd = S.next_match(S.find_matches(t.chars, b".") & live)
    dpos = S._at(nmd, torch.clamp(ts, 0, n))
    has_frac = (dpos < end) & has_time
    send = torch.where(has_frac, dpos, end).to(torch.int32)
    c1 = torch.where(ncolon >= 1, matc[:, 0], send)
    c2 = torch.where(ncolon >= 2, matc[:, 1], send)
    hv, hok = _seg_value(t, ts, c1 - ts, 2, n)
    miv, miok = _seg_value(t, c1 + 1, c2 - c1 - 1, 2, n)
    sv, sok = _seg_value(t, c2 + 1, send - c2 - 1, 2, n)
    fv, fok = _seg_value(t, dpos + 1, end - dpos - 1, 6, n)
    flen = torch.where(has_frac, end - dpos - 1, 0)
    fus = fv * _pow10(torch.clamp(6 - flen, 0, 6))
    tok = torch.where(
        has_time,
        hok & miok & sok & (ncolon == 2) & (hv < 24) & (miv < 60)
        & (sv < 60) & (ndash_date == 2)
        & (~has_frac | (fok & (flen >= 1))),
        True)
    tod = torch.where(has_time,
                      (hv * 3600 + miv * 60 + sv) * _US_PER_SEC
                      + torch.where(has_frac, fus, 0), 0)
    ok = dcol.validity & tok
    us = dcol.data.to(torch.int64) * _US_PER_DAY + tod
    return ColV(torch.where(ok, us, 0), ok)
