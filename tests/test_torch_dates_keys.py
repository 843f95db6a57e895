"""Dates, timestamps and decimals (ROADMAP item 6) as keys, and TPC-H Q1
with the spec's types, through both packages, on the CPU.

TPC-H Q1 over decimal(15,2) columns: both planners refuse its sums
(decimal(25,2) is past DECIMAL64) at plan time with the same error; the
same shape within DECIMAL64 runs on the device in both. A sort, a RANGE window over a date, a group by and a join keyed by a
date and a decimal run through both sessions over 3 partitions, under
both exchange transports (device pieces and the host wire format): the
same rows in the same order, no plan node on the CPU. murmur3 over each
type, its partition ids, the serializer's bytes and the Arrow round trip
equal the reference's bit for bit.
"""
import datetime
from decimal import Decimal

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.batch import schema_of as jschema_of
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr import windows as JW
from spark_rapids_tpu.expr.eval import ColV as JColV
from spark_rapids_tpu.ops import hashing as JH
from spark_rapids_tpu.shuffle import serializer as JS
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr import windows as W
from spark_rapids_tpu_torch.expr.values import ColV
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.shuffle import serializer as PS
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

from test_torch_dates_session import HOST, _no_fallback


# ---------------------------------------------------------------------------
# TPC-H Q1 with the spec's types
# ---------------------------------------------------------------------------
def _lineitem(M, TT, s):
    D = Decimal
    rows = [(D("17.00"), D("21168.23"), D("0.04"), D("0.02"), "N", "O",
             9131), (D("36.00"), D("45983.16"), D("0.09"), D("0.06"), "R",
                     "F", 8888), (None, D("1.00"), D("0.00"), D("0.00"),
                                  "A", "F", 10000)]
    dec = TT.DecimalType(15, 2)
    schema = TT.StructType(tuple(TT.StructField(n, t) for n, t in (
        ("l_quantity", dec), ("l_extendedprice", dec), ("l_discount", dec),
        ("l_tax", dec), ("l_returnflag", TT.STRING),
        ("l_linestatus", TT.STRING), ("l_shipdate", TT.DATE))))
    return s.from_rows(rows, schema)


def _tpch_q1(M, AA, TT, s):
    one = M.lit(Decimal("1"))
    price = M.col("l_extendedprice")
    disc = M.Multiply(price, M.Subtract(one, M.col("l_discount")))
    return (_lineitem(M, TT, s)
            .where(M.LessThanOrEqual(
                M.col("l_shipdate"),
                M.DateSub(M.Cast(M.lit("1998-12-01"), TT.DATE), M.lit(90))))
            .group_by("l_returnflag", "l_linestatus")
            .agg(AA.agg(AA.Sum(M.col("l_quantity")), "sum_qty"),
                 AA.agg(AA.Sum(price), "sum_base_price"),
                 AA.agg(AA.Sum(disc), "sum_disc_price"),
                 AA.agg(AA.Average(M.col("l_quantity")), "avg_qty"),
                 AA.agg(AA.Count(None), "count_order"))
            .order_by("l_returnflag", "l_linestatus"))


def _error(fn):
    try:
        fn()
    except TypeError as e:
        return str(e)
    return None


def test_tpch_q1_with_spec_decimals_refused_alike():
    """TPC-H Q1 over decimal(15,2): sum needs decimal(25,2) and avg
    decimal(19,6), past DECIMAL64. Neither package can type the
    aggregate, on the device or on its CPU engine: both refuse the plan
    with the same TypeError (why Q17 and Q20 keep f64 money)."""
    for what in ("explain", "collect"):
        got = _error(lambda: getattr(_tpch_q1(E, A, T, PSession(
            {}, device="cpu")), what)())
        ref = _error(lambda: getattr(_tpch_q1(JE, JA, JT, JSession(HOST)),
                                     what)())
        assert got == ref
        assert "DECIMAL64" in got


def test_tpch_q1_shape_within_decimal64():
    """The same plan over decimal(7,2) columns and without the product's
    sum (decimal(16,4) sums to 26 digits): on the device in both, the
    same rows."""
    def q(M, AA, TT, s):
        dec = TT.DecimalType(7, 2)
        rows = [(Decimal("17.00"), Decimal("2116.23"), "N", 9131),
                (Decimal("36.00"), Decimal("4598.16"), "R", 8888),
                (Decimal("1.50"), None, "N", 9000), (None, Decimal("1"),
                                                     "A", 10400)]
        schema = TT.StructType(tuple(TT.StructField(n, t) for n, t in (
            ("q", dec), ("p", dec), ("f", TT.STRING), ("d", TT.DATE))))
        return (s.from_rows(rows, schema)
                .where(M.LessThanOrEqual(M.col("d"), M.DateSub(M.Cast(
                    M.lit("1998-12-01"), TT.DATE), M.lit(90))))
                .group_by("f")
                .agg(AA.agg(AA.Sum(M.col("q")), "sq"),
                     AA.agg(AA.Sum(M.col("p")), "sp"),
                     AA.agg(AA.Average(M.col("p")), "ap"),
                     AA.agg(AA.Count(None), "n"))
                .order_by("f"))

    got = q(E, A, T, PSession({}, device="cpu"))
    _no_fallback(got)
    assert got.collect() == q(JE, JA, JT, JSession(HOST)).collect()


# ---------------------------------------------------------------------------
# sort, window, exchange with date and decimal keys
# ---------------------------------------------------------------------------
def _rows(n=240, seed=23):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append((
            None if rng.random() < 0.05 else int(rng.integers(10_900, 10_960)),
            None if rng.random() < 0.05 else Decimal(int(rng.integers(
                -500, 500))).scaleb(-2),
            None if rng.random() < 0.05 else int(rng.integers(
                -10**15, 10**15)),
            int(rng.integers(-1000, 1000))))
    return out


def _frame(M, TT, s, parts=3):
    schema = TT.StructType((TT.StructField("k", TT.DATE),
                            TT.StructField("d", TT.DecimalType(7, 2)),
                            TT.StructField("ts", TT.TIMESTAMP),
                            TT.StructField("v", TT.LONG)))
    return s.from_rows(_rows(), schema, num_partitions=parts)


def _sort(M, AA, WW, TT, s):
    return _frame(M, TT, s).order_by(
        M.col("d"), M.col("k"), M.col("ts"), M.col("v"),
        ascending=[False, True, True, True])


def _group(M, AA, WW, TT, s):
    return (_frame(M, TT, s).group_by("k", "d")
            .agg(AA.agg(AA.Count(None), "n"), AA.agg(AA.Sum(M.col("v")), "s"),
                 AA.agg(AA.Max(M.col("ts")), "mx"),
                 AA.agg(AA.Min(M.col("d")), "mn"))
            .order_by("k", "d"))


def _window(M, AA, WW, TT, s):
    spec = WW.WindowSpec(partition_by=(M.col("v"),), order_by=(M.col("k"),),
                         orders=((True, None),),
                         frame=WW.WindowFrame(WW.RANGE, -7, WW.CURRENT_ROW))
    spec2 = WW.WindowSpec(order_by=(M.col("d"),), orders=((False, None),))
    df = _frame(M, TT, s).with_column(
        "v", M.Pmod(M.col("v"), M.lit(5)))
    return (df.with_windows(
        WW.WindowExpression(AA.Count(None), spec, "week_n"),
        WW.WindowExpression(AA.Sum(M.col("d")), spec, "week_sum"))
        .with_windows(WW.WindowExpression(WW.RowNumber(), spec2, "rn"))
        .order_by("rn"))


def _join(M, AA, WW, TT, s):
    other = _frame(M, TT, s, parts=2).select(
        M.Alias(M.col("k"), "k2"), M.Alias(M.col("d"), "d2"),
        M.Alias(M.col("v"), "v2"))
    return (_frame(M, TT, s).join(other, [("k", "k2"), ("d", "d2")])
            .group_by("k").agg(AA.agg(AA.Count(None), "n"),
                               AA.agg(AA.Sum(M.col("v2")), "s"))
            .order_by("k"))


QUERIES = {"sort": _sort, "group": _group, "window": _window, "join": _join}


@pytest.mark.parametrize("transport", ["device", "host"])
@pytest.mark.parametrize("q", sorted(QUERIES))
def test_date_and_decimal_keys(q, transport):
    settings = {"spark.rapids.tpu.shuffle.transport.class": transport}
    got = QUERIES[q](E, A, W, T, PSession(settings, device="cpu"))
    _no_fallback(got)
    ref = QUERIES[q](JE, JA, JW, JT, JSession({**HOST, **settings}))
    assert got.collect() == ref.collect()


# ---------------------------------------------------------------------------
# hashes, partition ids, wire bytes
# ---------------------------------------------------------------------------
def _typed_columns(rng, n=513):
    days = rng.integers(-10**6, 10**6, n).astype(np.int32)
    days[:3] = [0, -1, 2**31 - 1]
    us = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    us[:3] = [0, -1, -(2**63)]
    dec = rng.integers(-(10**18) + 1, 10**18 - 1, n, dtype=np.int64)
    return [(days, "DATE"), (us, "TIMESTAMP"), (dec, ("DecimalType", 18, 4)),
            ((dec % 10**7).astype(np.int64), ("DecimalType", 7, 2))]


def _t(TT, spec):
    return getattr(TT, spec[0])(*spec[1:]) if isinstance(spec, tuple) \
        else getattr(TT, spec)


@pytest.mark.parametrize("which", [[0], [1], [2], [3], [0, 1, 2, 3]])
def test_murmur3_and_partition_ids_are_the_references(which):
    """DATE hashes as one int word, TIMESTAMP and DECIMAL as a long: the
    group-by buckets, join buckets and exchange partitions of both
    packages agree row for row."""
    rng = np.random.default_rng(sum(which) + 5)
    cols = [_typed_columns(rng)[i] for i in which]
    valid = [rng.random(513) < 0.85 for _ in cols]
    ref = np.asarray(JH.murmur3(
        [JColV(jnp.asarray(d), jnp.asarray(v)) for (d, _), v in
         zip(cols, valid)], [_t(JT, s) for _, s in cols]))
    got = H.murmur3([ColV(torch.from_numpy(d), torch.from_numpy(v))
                     for (d, _), v in zip(cols, valid)],
                    [_t(T, s) for _, s in cols])
    assert np.array_equal(got.numpy(), ref)
    for n in (1, 4, 200):
        assert np.array_equal(
            H.partition_ids(got, n).numpy(),
            np.asarray(JH.partition_ids(jnp.asarray(ref), n)))


def test_serializer_bytes_are_the_references():
    rows = [r for r in _rows(50, 4)] + [(None, None, None, 0)]
    data = {n: [r[j] for r in rows] for j, n in enumerate(("k", "d", "ts",
                                                           "v"))}
    js = jschema_of(k=JT.DATE, d=JT.DecimalType(7, 2), ts=JT.TIMESTAMP,
                    v=JT.LONG)
    ps = schema_of(k=T.DATE, d=T.DecimalType(7, 2), ts=T.TIMESTAMP,
                   v=T.LONG)
    jb = JBatch.from_pydict(data, js)
    pb = ColumnarBatch.from_pydict(data, ps, device="cpu")
    ref = JS.serialize_batch(jb, "none")
    assert PS.serialize_batch(pb, "none") == ref
    back = PS.deserialize_batch(ref, "cpu")
    assert back.schema == ps and back.to_rows() == rows
    assert JS.deserialize_batch(PS.serialize_batch(pb)).to_rows() == rows


def test_arrow_round_trip():
    """``batch_to_arrow`` gives the reference's Arrow table (date32,
    timestamp[us, UTC], decimal128 from the unscaled ints)."""
    from spark_rapids_tpu.io.arrow_convert import batch_to_arrow as jto
    from spark_rapids_tpu_torch.io.arrow_convert import (arrow_to_batch,
                                                         batch_to_arrow)

    rows = _rows(40, 6)
    data = {n: [r[j] for r in rows] for j, n in enumerate(("k", "d", "ts",
                                                           "v"))}
    pb = ColumnarBatch.from_pydict(data, schema_of(
        k=T.DATE, d=T.DecimalType(7, 2), ts=T.TIMESTAMP, v=T.LONG),
        device="cpu")
    jb = JBatch.from_pydict(data, jschema_of(
        k=JT.DATE, d=JT.DecimalType(7, 2), ts=JT.TIMESTAMP, v=JT.LONG))
    table = batch_to_arrow(pb)
    assert table.equals(jto(jb))
    assert arrow_to_batch(table, device="cpu").to_rows() == rows
    assert table.column("k").to_pylist() == [
        None if r[0] is None else datetime.date(1970, 1, 1)
        + datetime.timedelta(days=r[0]) for r in rows]
