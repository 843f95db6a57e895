"""Dates and timestamps (ROADMAP item 6) against the reference, on the CPU.

Every case of the reference's ``tests/test_datetime.py`` runs here
through both packages: the same numpy-seeded rows (the reference's edge
days and microseconds among them: the epoch, the day before it, years 1
and 9999, leap days, pre-epoch microseconds) go through the reference's
``evaluate_projection`` and the port's (``device="cpu"``). Days,
microseconds, strings (offsets and live bytes), validity over the whole
capacity and row order must be equal bit for bit, and every row must
equal the port's CPU engine (Python's ``datetime``). The string casts
also run on a dictionary-encoded column (each entry once, then a
gather). The parquet scan's date, timestamp and decimal columns collect
with the reference's values, except that a MILLIS or NANOS timestamp
becomes microseconds, where the reference's device decode keeps the raw
value (ROADMAP.md §C; pinned by
:func:`test_reference_reads_parquet_timestamp_units_raw`).
"""
import datetime
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

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
from spark_rapids_tpu_torch.columnar import (ColumnarBatch,
                                             dict_column_from_pylist,
                                             schema_of)
from spark_rapids_tpu_torch.cpu import eval_expression_rows
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.eval import evaluate_projection
from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession
from test_torch_plananalysis import comparable_explain

N = 96
_EPOCH = datetime.date(1970, 1, 1).toordinal()
_EDGE_DAYS = [0, -1, 1, -719162, 2932896,
              datetime.date(2000, 2, 29).toordinal() - _EPOCH,
              datetime.date(1900, 2, 28).toordinal() - _EPOCH,
              datetime.date(2100, 3, 1).toordinal() - _EPOCH,
              datetime.date(1969, 12, 31).toordinal() - _EPOCH]
_EDGE_US = [0, -1, 1, 86_400_000_000, -86_400_000_001, 1_000_000,
            -999_999, 946684800123456, -12345678901234]
HOST = {"spark.rapids.tpu.shuffle.mode": "host"}


def _gen(rng, n, edges, lo, hi, null_prob=0.15):
    r = rng.random(n)
    pick = rng.integers(0, len(edges), n)
    uni = rng.integers(lo, hi, n, endpoint=True)
    return [None if r[i] < null_prob else int(
        edges[pick[i]] if r[i] < null_prob + 0.25 else uni[i])
        for i in range(n)]


def make_data(seed, n=N):
    rng = np.random.default_rng(seed)
    return {"dt": _gen(rng, n, _EDGE_DAYS, -100_000, 100_000),
            "ts": _gen(rng, n, _EDGE_US, -5 * 10**15, 5 * 10**15),
            "n": _gen(rng, n, [0], -1000, 1000, 0.1)}


def _schemas(types):
    return (jschema_of(**{k: f(JT) for k, f in types.items()}),
            schema_of(**{k: f(T) for k, f in types.items()}))


TYPES = {"dt": lambda TT: TT.DATE, "ts": lambda TT: TT.TIMESTAMP,
         "n": lambda TT: TT.INT}


def assert_same(ref, got):
    """Validity over the whole capacity; fixed-width values where valid
    (floats by their bits); a string's offsets and live bytes; then the
    Python rows."""
    rv, gv = np.asarray(ref.validity), got.validity.numpy()
    assert np.array_equal(rv, gv)
    if got.is_string:
        ro, go = np.asarray(ref.offsets), got.offsets.numpy()
        assert np.array_equal(ro, go)
        live = int(go[-1])
        assert np.array_equal(np.asarray(ref.chars)[:live],
                              got.chars.numpy()[:live])
    else:
        rd, gd = np.asarray(ref.data), got.data.numpy()
        assert rd.dtype == gd.dtype
        if rd.dtype.kind == "f":
            rd, gd = rd.view(np.int64), gd.view(np.int64)
        assert np.array_equal(np.where(rv, rd, 0), np.where(gv, gd, 0))
    assert got.to_host().to_pylist() == ref.to_pylist()


def run_both(build, data, types=TYPES, engine=True):
    js, ps = _schemas(types)
    jb = JBatch.from_pydict(data, js)
    pb = ColumnarBatch.from_pydict(data, ps, device="cpu")
    [ref] = jevaluate([jbind(build(JE, JT), js)], jb)
    bound = E.bind_references(build(E, T), ps)
    [got] = evaluate_projection([bound], pb)
    assert_same(ref, got)
    if engine:
        rows = list(zip(*[data[k] for k in types]))
        assert got.to_host().to_pylist() == eval_expression_rows(bound, rows)
    return got


def check(build, seed=0):
    return run_both(build, make_data(seed))


@pytest.mark.parametrize("col", ["dt", "ts"])
@pytest.mark.parametrize("op", ["Year", "Quarter", "Month", "DayOfMonth",
                                "DayOfYear", "DayOfWeek", "WeekDay"])
def test_date_fields(op, col):
    check(lambda M, TT: getattr(M, op)(M.col(col)), seed=len(op) + len(col))


@pytest.mark.parametrize("op", ["Hour", "Minute", "Second"])
def test_time_fields(op):
    check(lambda M, TT: getattr(M, op)(M.col("ts")), seed=len(op))


DATE_ARITH = {
    "date_add_col": lambda M, TT: M.DateAdd(M.col("dt"), M.col("n")),
    "date_sub_col": lambda M, TT: M.DateSub(M.col("dt"), M.col("n")),
    "date_add_lit": lambda M, TT: M.DateAdd(M.col("dt"), M.lit(365)),
    "datediff_lit": lambda M, TT: M.DateDiff(M.col("dt"), M.lit(0)),
    "datediff_date": lambda M, TT: M.DateDiff(M.Literal(18321, TT.DATE),
                                              M.col("dt")),
    "datediff_ts": lambda M, TT: M.DateDiff(M.col("ts"), M.col("dt")),
    "last_day": lambda M, TT: M.LastDay(M.col("dt")),
    "last_day_ts": lambda M, TT: M.LastDay(M.col("ts")),
}


@pytest.mark.parametrize("case", sorted(DATE_ARITH))
def test_date_arith(case):
    # both CPU engines read a timestamp's last_day input as days (and
    # overflow), so that case holds the port to the reference alone
    run_both(DATE_ARITH[case], make_data(301), engine=case != "last_day_ts")


UNIX = {
    "unix_ts": lambda M, TT: M.UnixTimestamp(M.col("ts")),
    "unix_date": lambda M, TT: M.UnixTimestamp(M.col("dt")),
    "to_unix": lambda M, TT: M.ToUnixTimestamp(M.col("ts")),
    "from_unixtime": lambda M, TT: M.FromUnixTime(
        M.UnixTimestamp(M.col("ts")), M.lit("yyyy-MM-dd HH:mm:ss")),
}


@pytest.mark.parametrize("case", sorted(UNIX))
def test_unix_roundtrip(case):
    check(UNIX[case], seed=310)


@pytest.mark.parametrize("interval", [(3, 5_500_000), (-1, -1), (0, 0)])
def test_time_add(interval):
    check(lambda M, TT: M.TimeAdd(M.col("ts"), *interval), seed=320)


@pytest.mark.parametrize("fmt", ["year", "YY", "month", "MON", "quarter",
                                 "week", "bogus"])
def test_trunc(fmt):
    check(lambda M, TT: M.TruncDate(M.col("dt"), M.lit(fmt)), seed=len(fmt))


def test_trunc_null_format():
    check(lambda M, TT: M.TruncDate(M.col("dt"), M.Literal(None, TT.STRING)),
          seed=3)


CASTS = {
    "date_ts": ("dt", "TIMESTAMP"), "ts_date": ("ts", "DATE"),
    "ts_long": ("ts", "LONG"),
    "ts_int": ("ts", "INT"), "ts_bool": ("ts", "BOOLEAN"),
    "int_ts": ("n", "TIMESTAMP"),
}


@pytest.mark.parametrize("case", sorted(CASTS))
def test_cast_date_timestamp(case):
    c, to = CASTS[case]
    check(lambda M, TT: M.Cast(M.col(c), getattr(TT, to)), seed=330)


def test_cast_timestamp_to_double_is_correctly_rounded():
    """timestamp -> double is Spark's ``us / 1e6``, correctly rounded in
    f64: the port gives its CPU engine's values bit for bit. The
    reference's XLA program multiplies by the reciprocal instead (XLA
    rewrites a division by a constant), which is one ulp off on some rows
    (ROADMAP.md §C); on each row it equals ``us * 1e-6``."""
    data = make_data(333, 4 * N)
    js, ps = _schemas(TYPES)
    [ref] = jevaluate([jbind(JE.Cast(JE.col("ts"), JT.DOUBLE), js)],
                      JBatch.from_pydict(data, js))
    bound = E.bind_references(E.Cast(E.col("ts"), T.DOUBLE), ps)
    [got] = evaluate_projection([bound], ColumnarBatch.from_pydict(
        data, ps, device="cpu"))
    rows = [(None, v, None) for v in data["ts"]]
    got_rows = got.to_host().to_pylist()
    assert got_rows == eval_expression_rows(bound, rows)
    assert got_rows == [None if v is None else v / 1e6 for v in data["ts"]]
    assert ref.to_pylist() == [None if v is None else v * 1e-6
                               for v in data["ts"]]
    assert ref.to_pylist() != got_rows


@pytest.mark.parametrize("col", ["dt", "ts"])
def test_cast_datetime_to_string(col):
    check(lambda M, TT: M.Cast(M.col(col), TT.STRING), seed=340)


DATE_STRINGS = [
    "2020-02-29", "2019-02-29", "2020-1-5", "2020-13-01", "2020-00-10",
    "1999-12-31", "2020", "2020-06", " 2020-06-15 ", "garbage", "20-01-01",
    "2020-01-00", "2020-01-32", "0001-01-01", "9999-12-31", "", None,
    "2020-01-01-05", "2020--01", "2020-06-15\t"]
TS_STRINGS = [
    "2020-02-29 13:14:15", "2020-02-29T13:14:15", "2020-02-29",
    "2020-02-29 13:14:15.5", "2020-02-29 13:14:15.123456",
    "2020-02-29 25:00:00", "2020-02-29 13:60:00", "1969-12-31 23:59:59",
    "2020", "2020-06", "bad", "", None, "2020-02-29 1:2:3",
    "2020-01 10:20:30", "2020 1:2:3", "0001-01-01 00:00:00.000001",
    " 2020-02-29t01:02:03.4 "]


def _check_cast_strings(values, to):
    run_both(lambda M, TT: M.Cast(M.col("s"), getattr(TT, to)),
             {"s": values}, {"s": lambda TT: TT.STRING})


def _dict_cast(values, to):
    """The cast over a dictionary-encoded column: each entry parsed once
    and gathered, the rows equal to the plain column's."""
    dc = dict_column_from_pylist(values, device="cpu")
    pb = ColumnarBatch([dc], schema_of(s=T.STRING), len(values))
    [got] = evaluate_projection([E.bind_references(
        E.Cast(E.col("s"), getattr(T, to)), pb.schema)], pb)
    plain = ColumnarBatch.from_pydict({"s": values}, schema_of(s=T.STRING),
                                      device="cpu")
    [want] = evaluate_projection([E.bind_references(
        E.Cast(E.col("s"), getattr(T, to)), plain.schema)], plain)
    assert got.to_host().to_pylist() == want.to_host().to_pylist()


@pytest.mark.parametrize("layout", ["plain", "dict"])
def test_cast_string_to_date(layout):
    (_check_cast_strings if layout == "plain" else _dict_cast)(
        DATE_STRINGS, "DATE")


@pytest.mark.parametrize("layout", ["plain", "dict"])
def test_cast_string_to_timestamp(layout):
    (_check_cast_strings if layout == "plain" else _dict_cast)(
        TS_STRINGS, "TIMESTAMP")


def test_cast_bool_to_timestamp_micros():
    """Spark maps true -> 1 MICROsecond."""
    got = run_both(lambda M, TT: M.Cast(M.col("p"), TT.TIMESTAMP),
                   {"p": [True, False, None]}, {"p": lambda TT: TT.BOOLEAN})
    assert got.to_host().to_pylist() == [1, 0, None]


@pytest.mark.parametrize("case", ["ts_bool", "double_ts"])
def test_cast_edge_pairs(case):
    """ts -> bool reads the microseconds; double -> ts nulls non-finite
    values and saturates."""
    vals = {"ts": [500_000, 0, -1, None],
            "d": [float("nan"), float("inf"), 1.5, -2.5e200]}
    types = {"ts": lambda TT: TT.TIMESTAMP, "d": lambda TT: TT.DOUBLE}
    build = {"ts_bool": lambda M, TT: M.Cast(M.col("ts"), TT.BOOLEAN),
             "double_ts": lambda M, TT: M.Cast(M.col("d"), TT.TIMESTAMP)}
    run_both(build[case], vals, types)


@pytest.mark.parametrize("col", ["dt", "ts"])
def test_cast_string_date_round_trip(col):
    data = make_data(350)
    to = "DATE" if col == "dt" else "TIMESTAMP"
    got = run_both(lambda M, TT: M.Cast(M.Cast(M.col(col), TT.STRING),
                                        getattr(TT, to)), data)
    lo, hi = (-719162, 2932896) if col == "dt" else (
        -719162 * 86_400_000_000, 2932897 * 86_400_000_000 - 1)
    for g, w in zip(got.to_host().to_pylist(), data[col]):
        if w is not None and lo <= w <= hi:
            assert g == w


PREDICATES = {
    "and": lambda M, TT: M.And(M.GreaterThanOrEqual(M.Year(M.col("dt")),
                                                    M.lit(2000)),
                               M.LessThan(M.Month(M.col("dt")), M.lit(7))),
    "if": lambda M, TT: M.If(M.EqualTo(M.Quarter(M.col("dt")), M.lit(1)),
                             M.DateAdd(M.col("dt"), M.lit(90)), M.col("dt")),
    "compare_dates": lambda M, TT: M.LessThan(
        M.col("dt"), M.Cast(M.lit("1999-06-01"), TT.DATE)),
    "coalesce": lambda M, TT: M.Coalesce((M.col("ts"),
                                          M.Cast(M.col("dt"),
                                                 TT.TIMESTAMP))),
}


@pytest.mark.parametrize("case", sorted(PREDICATES))
def test_datetime_in_predicates(case):
    check(PREDICATES[case], seed=360)


def _q5_table(rng, n):
    base = datetime.date(1998, 1, 1).toordinal() - _EPOCH
    return base, pa.table({
        "sold_date": pa.array(
            [base + int(rng.integers(0, 1500)) if rng.random() > 0.03
             else None for _ in range(n)], pa.date32()),
        "store": pa.array(rng.integers(1, 13, n).astype(np.int32)),
        "profit": pa.array(rng.integers(-500, 2000, n).astype(np.int64))})


def test_q5_like_date_query_from_parquet(tmp_path):
    """The reference's q5-style shape: parquet scan -> date-range filter
    -> aggregate, through both sessions (the reference under the host
    exchange)."""
    rng = np.random.default_rng(7)
    base, t = _q5_table(rng, 3000)
    pq.write_table(t, str(tmp_path / "sales.parquet"), row_group_size=512)

    def build(M, AA, TT, s):
        lo = M.Literal(base + 200, TT.DATE)
        df = s.read.parquet(str(tmp_path))
        return (df.where(M.And(
            M.GreaterThanOrEqual(M.col("sold_date"), lo),
            M.LessThanOrEqual(M.col("sold_date"),
                              M.DateAdd(lo, M.lit(30)))))
            .with_column("yr", M.Year(M.col("sold_date")))
            .group_by("store")
            .agg(AA.agg(AA.Count(None), "cnt"),
                 AA.agg(AA.Sum(M.col("profit")), "total"),
                 AA.agg(AA.Max(M.col("sold_date")), "last")))

    got = build(E, A, T, PSession({}, device="cpu"))
    ref = build(JE, JA, JT, JSession(HOST))
    assert sorted(got.collect()) == sorted(ref.collect())
    assert comparable_explain(got.explain()) == comparable_explain(
        ref.explain())


def test_planner_gates_string_to_timestamp():
    from spark_rapids_tpu.conf import RapidsConf as JConf
    from spark_rapids_tpu.plugin.overrides import check_expression as jcheck
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.plugin.overrides import check_expression

    key = "spark.rapids.tpu.sql.castStringToTimestamp.enabled"
    for settings in ({}, {key: True}):
        for to in ("TIMESTAMP", "DATE"):
            got = check_expression(E.Cast(E.col("s"), getattr(T, to)),
                                   schema_of(s=T.STRING),
                                   RapidsConf(settings))
            assert got == jcheck(JE.Cast(JE.col("s"), getattr(JT, to)),
                                 jschema_of(s=JT.STRING), JConf(settings))
            assert bool(got) == (to == "TIMESTAMP" and not settings)
    assert "castStringToTimestamp" in check_expression(
        E.Cast(E.col("s"), T.TIMESTAMP), schema_of(s=T.STRING),
        RapidsConf({}))[0]


# ---------------------------------------------------------------------------
# the parquet scan
# ---------------------------------------------------------------------------
_TS = [datetime.datetime(2000, 1, 1, 12, 0, 0, 123456),
       datetime.datetime(1969, 12, 31, 23, 59, 59), None]


def _ts_table():
    return pa.table({u: pa.array(_TS, pa.timestamp(u))
                     for u in ("ns", "ms", "us")})


def _scan(sess):
    scan = sess.last_executed_plan.tpu_child
    while scan.children:
        scan = scan.children[0]
    return scan


def test_reference_reads_parquet_timestamp_units_raw(tmp_path):
    """The reference's device decode (``parquet_device.plan_decode``)
    keeps an INT64 TIMESTAMP chunk's raw values: a MILLIS or NANOS column
    comes back in its own unit, and year() of 2000-01-01 12:00:00.123456
    stored in nanoseconds gives 31970. The port converts each unit to
    microseconds on the device and gives the host path's values."""
    path = str(tmp_path / "ts.parquet")
    pq.write_table(_ts_table(), path)
    us = [946728000123456, -1_000_000, None]
    ms = [946728000123000, -1_000_000, None]

    def q(M, s):
        return s.read.parquet(path).select(
            M.col("ns"), M.col("ms"), M.col("us"),
            M.Alias(M.Year(M.col("ns")), "y"))

    DeviceScanCache.reset()
    psess = PSession({}, device="cpu")
    got = q(E, psess).collect()
    assert [r[:3] for r in got] == [list(t) for t in zip(us, ms, us)] or \
        [tuple(r[:3]) for r in got] == list(zip(us, ms, us))
    assert [r[3] for r in got] == [2000, 1969, None]
    assert _scan(psess).metrics["hostFallbackChunks"].value == 0
    ref = q(JE, JSession({})).collect()
    assert ref[0][0] == 946728000123456000 and ref[0][3] == 31970
    assert ref[0][1] == 946728000123 and ref[1][2] == -1_000_000
    DeviceScanCache.reset()


@pytest.mark.parametrize("layout", ["flba", "integer"])
def test_parquet_dates_decimals_timestamps(tmp_path, layout):
    """date32, timestamps of each unit and decimal128 (p <= 18; FLBA as
    pyarrow writes by default, INT32 / INT64 as Spark does) collect
    through the port's session with the reference's values (its host
    reader's for the timestamps), microseconds for every unit. The
    integer layout keeps every chunk on the device route; FLBA decimals
    take the host decoder, as in the reference."""
    rng = np.random.default_rng(17)
    n = 1000
    cents = rng.integers(-10**6, 10**6, n)
    us = rng.integers(-4 * 10**15, 4 * 10**15, n)
    big = rng.integers(-10**17, 10**17, n)
    valid = rng.random(n) > 0.1
    t = pa.table({
        "d": pa.array(rng.integers(-30_000, 30_000, n).astype(np.int32),
                      pa.date32(), mask=~valid),
        "m": pa.array([Decimal(int(c)).scaleb(-2) if v else None
                       for c, v in zip(cents, valid)], pa.decimal128(7, 2)),
        "w": pa.array([Decimal(int(c)).scaleb(-4) for c in big],
                      pa.decimal128(18, 4)),
        "ns": pa.array(us * 1000, pa.timestamp("ns")),
        "ms": pa.array(us // 1000, pa.timestamp("ms")),
        "us": pa.array(us, pa.timestamp("us"))})
    path = str(tmp_path / "t")
    import os

    os.makedirs(path)
    pq.write_table(t, os.path.join(path, "a.parquet"), row_group_size=300,
                   store_decimal_as_integer=(layout == "integer"))
    DeviceScanCache.reset()
    psess = PSession({}, device="cpu")
    got = psess.read.parquet(path).collect()
    host = {c: t.column(c).to_pylist() for c in ("d", "m", "w")}
    want = list(zip(
        [None if v is None else (v - datetime.date(1970, 1, 1)).days
         for v in host["d"]], host["m"], host["w"],
        *[t.column(u).cast(pa.timestamp("us")).cast(pa.int64()).to_pylist()
          for u in ("ns", "ms", "us")]))
    assert got == want
    ref = JSession({}).read.parquet(path).select(
        *[JE.col(c) for c in ("d", "m", "w", "us")]).collect()
    assert [(r[0], r[1], r[2], r[5]) for r in got] == ref
    assert _scan(psess).metrics["hostFallbackChunks"].value == (
        0 if layout == "integer" else 2 * 4)
    DeviceScanCache.reset()
