"""Decimals, dates and timestamps (ROADMAP item 6) through both packages'
sessions over TPC-DS and TPC-H tables, on the CPU.

TPC-DS q5's store channel (the chip check's Q25) and its per-day rollup
(Q27) at 2^12 store_sales rows over 3 parquet files, with Spark's INT32
decimals and with pyarrow's FLBA ones, against the numpy oracles of
``chip_smoke.py`` and the reference's session. The reference's FINAL
aggregate binds a decimal sum to its buffer type and widens it again past
DECIMAL64, so its partitioned decimal sums raise (ROADMAP.md §C); its
rows come from the same rows in one file (one partition, no merge). The
reference's q5-like date query runs over the same tables. TPC-H Q1 with
the spec's types, the keys, hashes and wire bytes are in
``test_torch_dates_keys.py``.
"""
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)

import chip_smoke as CS
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession
from test_torch_plananalysis import comparable_explain

HOST = {"spark.rapids.tpu.shuffle.mode": "host"}
ROWS = 1 << 12


@pytest.fixture(scope="module", params=["integer", "flba"])
def tpcds(request, tmp_path_factory):
    """The chip check's three tables at 2^12 store_sales rows: the fact
    as 3 files (Spark's INT32 decimals, or pyarrow's FLBA), the same rows
    as one file, date_dim and store."""
    base = tmp_path_factory.mktemp(request.param)
    t = CS.store_sales_table(np, ROWS)
    tables = CS.tpcds_sales_tables(pa, np, t)
    kw = {"store_decimal_as_integer": request.param == "integer"}
    paths = {k: str(base / k) for k in tables}
    CS._write_files(pa, pq, paths["store_sales"], tables["store_sales"], 3,
                    **kw)
    one = str(base / "store_sales_one")
    CS._write_files(pa, pq, one, tables["store_sales"], 1, **kw)
    for k in ("date_dim", "store"):
        CS._write_files(pa, pq, paths[k], tables[k], 1)
    DeviceScanCache.reset()
    yield t, paths, dict(paths, store_sales=one), {}
    DeviceScanCache.reset()


def _ref_rows(tpcds, q, settings=None):
    """The reference's rows of ``q`` over the one-file copy (computed once
    per layout), and its ``explain()`` of ``q`` under ``settings`` over
    the multi-file tables the port reads (the analysis reads their
    footers; nothing runs)."""
    _, paths, one, cache = tpcds
    settings = dict(settings or {})

    def df_of(sess, p):
        return (CS.q25_df(sess, p, JE, JA, JT) if q == "Q25"
                else CS.q27_df(sess, p["store_sales"], JE, JA))

    if q not in cache:
        cache[q] = df_of(JSession(HOST), one).collect()
    key = (q, tuple(sorted(settings.items())))
    if key not in cache:
        cache[key] = comparable_explain(
            df_of(JSession({**HOST, **settings}), paths).explain())
    return cache[q], cache[key]


def _no_fallback(df):
    text = df.explain()
    assert not any(ln.lstrip().startswith("!") for ln in text.splitlines())
    return text


@pytest.mark.parametrize("strategy", ["PALLAS", "AUTO"])
def test_q25_tpcds_q5_store_channel(tpcds, strategy):
    t, paths, _, _ = tpcds
    settings = {"spark.rapids.tpu.sql.join.strategy": strategy}
    psess = PSession(settings, device="cpu")
    df = CS.q25_df(psess, paths, E, A, T)
    text = _no_fallback(df)
    got = df.collect()
    assert got == CS.q25_oracle(np, t)
    assert (got, comparable_explain(text)) == _ref_rows(tpcds, "Q25",
                                                        settings)
    assert all(isinstance(r[1], Decimal) for r in got)


def test_q27_per_day_rollup(tpcds):
    t, paths, _, _ = tpcds
    psess = PSession({}, device="cpu")
    df = CS.q27_df(psess, paths["store_sales"], E, A)
    text = _no_fallback(df)
    got = df.collect()
    assert got == CS.q27_oracle(np, t)
    assert (got, comparable_explain(text)) == _ref_rows(tpcds, "Q27")


def test_reference_partitioned_decimal_sum_raises(tpcds):
    """The reference's FINAL aggregate of a partitioned decimal sum binds
    Sum to the decimal(17,2) buffer and asks for decimal(27,2): a
    TypeError where the port merges (``aggregates.merge_input_type``)."""
    t, paths, _, _ = tpcds
    with pytest.raises(TypeError, match=r"sum\(decimal\(17,2\)\) buffer"):
        CS.q27_df(JSession(HOST), paths["store_sales"], JE, JA).collect()


def test_q5_like_over_the_spec_tables(tpcds):
    """The reference's ``test_q5_like_date_query_from_parquet`` shape
    over the fact table: a sold-date range filter with date_add, year(),
    group by store: count and a decimal sum."""
    t, paths, one, _ = tpcds

    def q(M, AA, TT, s, p):
        lo = M.Cast(M.lit("2000-01-01"), TT.DATE)
        return (s.read.parquet(p["store_sales"])
                .where(M.And(M.GreaterThanOrEqual(M.col("ss_sold_date"), lo),
                             M.LessThanOrEqual(M.col("ss_sold_date"),
                                               M.DateAdd(lo, M.lit(30)))))
                .with_column("yr", M.Year(M.col("ss_sold_date")))
                .group_by("ss_store_sk", "yr")
                .agg(AA.agg(AA.Count(None), "n"),
                     AA.agg(AA.Sum(M.col("ss_net_profit")), "p"))
                .order_by("ss_store_sk"))

    got = q(E, A, T, PSession({}, device="cpu"), paths).collect()
    assert got == q(JE, JA, JT, JSession(HOST), one).collect()
    assert len(got) == CS.STORES
