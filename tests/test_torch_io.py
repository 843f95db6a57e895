"""The port's file formats and writers (``io/csv.py``, ``io/orc.py``,
``io/commit.py``, ``io/parquet.write_parquet``, ``sql/session``'s
``DataFrameReader.csv``/``.orc`` and ``DataFrameWriter``) against the
reference's.

Every case of the reference's ``tests/test_io.py`` that touches CSV, ORC,
a writer or the commit protocol runs through both packages' sessions on
the same files, written under ``tmp_path`` by pyarrow from seeded data,
and their rows must be equal: the port on ``device="cpu"``, the
reference on its JAX CPU backend. Beside them: the CPU-engine route of
the writer, a write that fails in the middle, the device scan cache's
invalidation by a commit, the parquet-only routes a CSV or ORC split must
stay out of, and the two reference faults of the CSV decimal scan
(ROADMAP.md §C), pinned beside the port's correct rows.
"""
import decimal
import os
import random

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
paorc = pytest.importorskip("pyarrow.orc")
pacsv = pytest.importorskip("pyarrow.csv")
pq = pytest.importorskip("pyarrow.parquet")

from spark_rapids_tpu import types as JT  # noqa: E402
from spark_rapids_tpu.expr import aggregates as JA  # noqa: E402
from spark_rapids_tpu.expr import expressions as JE  # noqa: E402
from spark_rapids_tpu.sql import session as JS  # noqa: E402
from spark_rapids_tpu_torch import types as PT  # noqa: E402
from spark_rapids_tpu_torch.expr import aggregates as PA  # noqa: E402
from spark_rapids_tpu_torch.expr import expressions as PE  # noqa: E402
from spark_rapids_tpu_torch.io import commit as PCOMMIT  # noqa: E402
from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache  # noqa: E402
from spark_rapids_tpu_torch.sql import session as PS  # noqa: E402

PORT = {"T": PT, "E": PE, "A": PA}
REF = {"T": JT, "E": JE, "A": JA}


def _psession(settings=None):
    return PS.TpuSession(settings or {}, device="cpu")


def _jsession(settings=None):
    return JS.TpuSession(settings or {})


@pytest.fixture(autouse=True)
def _fresh_scanners():
    """Scanners are cached per path in both packages; a test's files are
    new, but a path can be rewritten inside one test."""
    PS._SCANNER_CACHE.clear()
    JS._SCANNER_CACHE.clear()
    yield
    PS._SCANNER_CACHE.clear()
    JS._SCANNER_CACHE.clear()


def _key(row):
    return tuple((v is None, repr(type(v)), v if v == v else "nan")
                 for v in row)


def _rows_equal(got, want):
    assert sorted(got, key=_key) == sorted(want, key=_key)


def _both(q, settings=None):
    """``q(m, session)`` through both packages; their rows, which must be
    equal (order aside)."""
    got = q(PORT, _psession(settings)).collect()
    want = q(REF, _jsession(settings)).collect()
    _rows_equal(got, want)
    return got


def _mixed_table(n=2000, seed=0):
    """The reference test file's table: nullable int32, double, string
    (ASCII and UTF-8, empty) and int64 columns."""
    rnd = random.Random(seed)
    return pa.table({
        "k": pa.array(
            [rnd.randint(0, 50) if rnd.random() > 0.05 else None
             for _ in range(n)], pa.int32()),
        "v": pa.array(
            [rnd.random() * 100 if rnd.random() > 0.05 else None
             for _ in range(n)], pa.float64()),
        "s": pa.array(
            [rnd.choice(["a", "bb", None, "ccc", "ddd€", ""])
             for _ in range(n)], pa.string()),
        "l": pa.array(
            [rnd.randint(-2**40, 2**40) for _ in range(n)], pa.int64()),
    })


def _schema(m, *fields):
    T = m["T"]
    return T.StructType([T.StructField(n, getattr(T, t) if isinstance(
        t, str) else t(T)) for n, t in fields])


# ---------------------------------------------------------------------------
# CSV scans
# ---------------------------------------------------------------------------
def _small_csv(tmp_path):
    p = str(tmp_path / "x.csv")
    with open(p, "w") as f:
        f.write("a,b,c\n1,foo,1.5\n2,bar,\n,baz,2.5\n")
    return p


def test_csv_scan_inferred_schema(tmp_path):
    p = _small_csv(tmp_path)
    got = _both(lambda m, s: s.read.csv(p))
    assert len(got) == 3


def test_csv_scan_explicit_schema(tmp_path):
    p = _small_csv(tmp_path)
    got = _both(lambda m, s: s.read.csv(p, schema=_schema(
        m, ("a", "LONG"), ("b", "STRING"), ("c", "DOUBLE"))))
    assert got[0][2] in (1.5, 2.5, None)


def test_csv_scan_without_header(tmp_path):
    p = str(tmp_path / "h.csv")
    with open(p, "w") as f:
        f.write("1,foo,1.5\n2,bar,\n3,baz,2.5\n")
    got = _both(lambda m, s: s.read.csv(p, schema=_schema(
        m, ("a", "LONG"), ("b", "STRING"), ("c", "DOUBLE")), header=False))
    assert sorted(r[0] for r in got) == [1, 2, 3]
    # inferred too: pyarrow names the columns f0, f1, f2
    got = _both(lambda m, s: s.read.csv(p, header=False))
    assert len(got) == 3


def test_csv_scan_other_separator(tmp_path):
    p = str(tmp_path / "p.csv")
    with open(p, "w") as f:
        f.write("a|b\n1|x,y\n2|z\n")
    got = _both(lambda m, s: s.read.csv(p, sep="|"))
    assert sorted(got) == [(1, "x,y"), (2, "z")]


def test_csv_scan_directory_of_files(tmp_path):
    t = _mixed_table(900, seed=3)
    d = tmp_path / "many"
    d.mkdir()
    for i in range(3):
        pacsv.write_csv(t.slice(i * 300, 300), str(d / f"part{i}.csv"))
    schema = lambda m: _schema(  # noqa: E731
        m, ("k", "INT"), ("v", "DOUBLE"), ("s", "STRING"), ("l", "LONG"))
    got = _both(lambda m, s: s.read.csv(str(d), schema=schema(m))
                .group_by("k").agg(m["A"].agg(m["A"].Sum(m["E"].col("l")),
                                              "sl")))
    assert len(got) > 10
    sess = _psession()
    df = sess.read.csv(str(d), schema=schema(PORT))
    assert df.session._execute(df.node).num_partitions == 3


def test_csv_scan_empty_file(tmp_path):
    p = str(tmp_path / "e.csv")
    with open(p, "w") as f:
        f.write("a,b\n")
    got = _both(lambda m, s: s.read.csv(p, schema=_schema(
        m, ("a", "LONG"), ("b", "STRING"))))
    assert got == []


@pytest.mark.parametrize("dtype", ["DATE", "BOOLEAN", "INT", "FLOAT"])
def test_csv_scan_typed_columns(tmp_path, dtype):
    p = str(tmp_path / "typed.csv")
    vals = {"DATE": ["2000-01-01", "", "1969-12-31"],
            "BOOLEAN": ["true", "", "false"],
            "INT": ["7", "", "-3"], "FLOAT": ["1.25", "", "-0.5"]}[dtype]
    with open(p, "w") as f:
        f.write("i,x\n" + "".join(f"{i},{v}\n" for i, v in enumerate(vals)))
    got = _both(lambda m, s: s.read.csv(p, schema=_schema(
        m, ("i", "LONG"), ("x", dtype))))
    assert sorted(got, key=lambda r: r[0])[1] == (1, None)


def test_csv_filter_project_aggregate(tmp_path):
    p = str(tmp_path / "m.csv")
    pacsv.write_csv(_mixed_table(1500, seed=7), p)

    def q(m, s):
        E, A = m["E"], m["A"]
        return (s.read.csv(p)
                .where(E.GreaterThan(E.col("k"), E.lit(10)))
                .select("k", E.Alias(E.Multiply(E.col("v"), E.lit(2.0)),
                                     "v2"))
                .group_by("k")
                .agg(A.agg(A.Count(E.col("v2")), "c"),
                     A.agg(A.Max(E.col("v2")), "mx")))
    got = _both(q)
    assert got


# ---------------------------------------------------------------------------
# reference faults of the CSV decimal scan (ROADMAP.md §C)
# ---------------------------------------------------------------------------
def test_reference_reads_csv_decimals_as_double_bits(tmp_path):
    """Reference ``io/csv.py:61-65`` leaves a decimal column out of
    pyarrow's ConvertOptions: pyarrow infers a double, and its bits are
    read as the unscaled int64. The port parses ``decimal128(p, s)``."""
    p = str(tmp_path / "d.csv")
    with open(p, "w") as f:
        f.write("a,d\n1,12.34\n2,-0.05\n")
    schema = lambda m: _schema(  # noqa: E731
        m, ("a", "LONG"), ("d", lambda T: T.DecimalType(7, 2)))
    got = _psession().read.csv(p, schema=schema(PORT)).collect()
    assert got == [(1, decimal.Decimal("12.34")),
                   (2, decimal.Decimal("-0.05"))]
    ref = _jsession().read.csv(p, schema=schema(REF)).collect()
    assert ref == [(1, decimal.Decimal("46231364204799773.90")),
                   (2, decimal.Decimal("46231364204799773.90"))]


def test_reference_raises_on_csv_decimal_with_nulls(tmp_path):
    """The same fault with a null decimal and a DATE column beside it:
    the reference raises, on its device route and on its CPU engine."""
    p = str(tmp_path / "w.csv")
    with open(p, "w") as f:
        f.write("a,d,t\n1,12.34,2000-01-01\n2,,1999-12-31\n3,-0.05,\n")
    schema = lambda m: _schema(  # noqa: E731
        m, ("a", "LONG"), ("d", lambda T: T.DecimalType(7, 2)),
        ("t", "DATE"))
    want = [(1, decimal.Decimal("12.34"), 10957), (2, None, 10956),
            (3, decimal.Decimal("-0.05"), None)]
    for settings in ({}, {"spark.rapids.tpu.sql.enabled": False}):
        got = _psession(settings).read.csv(p, schema=schema(PORT)).collect()
        assert got == want
        with pytest.raises(ValueError, match="could not be broadcast"):
            _jsession(settings).read.csv(p, schema=schema(REF)).collect()


# ---------------------------------------------------------------------------
# ORC scans
# ---------------------------------------------------------------------------
def _orc_file(tmp_path, name="x.orc", n=800, seed=9, **kw):
    p = str(tmp_path / name)
    paorc.write_table(_mixed_table(n, seed=seed), p, **kw)
    return p


def test_orc_scan_aggregate(tmp_path):
    p = _orc_file(tmp_path)
    got = _both(lambda m, s: s.read.orc(p).group_by("k").agg(
        m["A"].agg(m["A"].Count(m["E"].col("v")), "c")))
    assert got


def test_orc_scan_stripes_are_splits(tmp_path):
    p = _orc_file(tmp_path, n=20000, seed=4, stripe_size=64 << 10)
    nstripes = paorc.ORCFile(p).nstripes
    assert nstripes > 1
    df = _psession().read.orc(p)
    assert df.session._execute(df.node).num_partitions == nstripes
    _both(lambda m, s: s.read.orc(p))


def test_orc_column_pruning(tmp_path):
    p = _orc_file(tmp_path)
    got = _both(lambda m, s: s.read.orc(p, columns=["k", "s"]))
    assert len(got[0]) == 2
    assert _psession().read.orc(p, columns=["k", "s"]).columns == ["k", "s"]


def test_reference_orc_pruning_out_of_file_order_raises(tmp_path):
    """Reference ``OrcScanner.read_split`` takes ``read_stripe``'s columns
    in file order under a schema in the requested order, and raises; the
    port selects the requested order."""
    p = str(tmp_path / "o.orc")
    paorc.write_table(pa.table({"k": pa.array([1, 2, None], pa.int32()),
                                "s": ["a", None, "c"]}), p)
    for settings in ({}, {"spark.rapids.tpu.sql.enabled": False}):
        got = _psession(settings).read.orc(p, columns=["s", "k"]).collect()
        assert got == [("a", 1), (None, 2), ("c", None)]
        with pytest.raises(IndexError):
            _jsession(settings).read.orc(p, columns=["s", "k"]).collect()


def test_orc_filter_pushdown(tmp_path):
    _orc_file(tmp_path, "a.orc", n=2000, seed=23)

    def q(m, s):
        E = m["E"]
        return s.read.orc(str(tmp_path)).where(
            E.And(E.GreaterThanOrEqual(E.col("k"), E.lit(20)),
                  E.IsNotNull(E.col("s"))))
    got = _both(q)
    sess = _psession()
    q(PORT, sess).collect()
    scan = sess.last_executed_plan.tpu_child.children[0]
    pushed = {(f.column, f.op) for f in scan.scanner.filters}
    assert pushed == {("k", ">="), ("s", "notnull")}
    # the pushed filters ran on the host, before the upload
    assert scan.metrics["numOutputRows"].value == len(got) < 2000


NAN_TABLE = {"x": [0.5, float("nan"), 2.0, None, float("nan"), -1.0],
             "k": [1, 2, 3, 4, 5, 6]}
NAN_FILTERS = [(op, v) for op in ("GreaterThan", "GreaterThanOrEqual",
                                  "EqualTo", "LessThan", "LessThanOrEqual")
               for v in (1.0, float("nan"))]


def _nan_files(tmp_path):
    """The table as ORC and as parquet of two-row row groups, so a row
    group holds only ``0.5, NaN``: parquet's min/max leave the NaN out."""
    t = pa.table({"x": pa.array(NAN_TABLE["x"], pa.float64()),
                  "k": pa.array(NAN_TABLE["k"], pa.int64())})
    po, pp = str(tmp_path / "n.orc"), str(tmp_path / "n.parquet")
    paorc.write_table(t, po)
    pq.write_table(t, pp, row_group_size=2)
    return po, pp


def _nan_keys(m, df_of, op, v):
    """The ``k`` of the rows that pass ``x <op> v``."""
    E = m["E"]
    return sorted(r[1] for r in df_of().where(
        getattr(E, op)(E.col("x"), E.lit(v))).collect())


@pytest.mark.parametrize("op,v", NAN_FILTERS, ids=str)
def test_pushdown_keeps_nan_rows(tmp_path, op, v):
    """Spark orders NaN above every other value and equal to itself. The
    ORC host pre-filter and the parquet row-group pruning are advisory:
    a pushed comparison over NaN rows gives the rows the same comparison
    gives over the same data in memory, in the port and in the
    reference."""
    po, pp = _nan_files(tmp_path)
    sess = _psession()
    schema = _schema(PORT, ("x", "DOUBLE"), ("k", "LONG"))
    want = _nan_keys(PORT, lambda: sess.create_dataframe(NAN_TABLE, schema),
                     op, v)
    js = _jsession()
    assert want == _nan_keys(REF, lambda: js.create_dataframe(
        NAN_TABLE, _schema(REF, ("x", "DOUBLE"), ("k", "LONG"))), op, v)
    assert _nan_keys(PORT, lambda: sess.read.orc(po), op, v) == want
    assert _nan_keys(PORT, lambda: sess.read.parquet(pp), op, v) == want


def test_reference_pushdown_drops_nan_rows(tmp_path):
    """Reference ``io/orc.apply_filters_host`` compares with pyarrow's
    IEEE rules before the upload, and reference ``io/parquet._stats_allow``
    prunes by min/max that leave NaN out: ``x > 1.0`` loses the NaN rows
    that the reference's own in-memory filter keeps. The port keeps them
    (``test_pushdown_keeps_nan_rows``)."""
    po, pp = _nan_files(tmp_path)
    js = _jsession()
    df = js.create_dataframe(NAN_TABLE, _schema(REF, ("x", "DOUBLE"),
                                                ("k", "LONG")))
    assert _nan_keys(REF, lambda: df, "GreaterThan", 1.0) == [2, 3, 5]
    assert _nan_keys(REF, lambda: js.read.orc(po), "GreaterThan", 1.0) == [3]
    assert _nan_keys(REF, lambda: js.read.parquet(pp), "GreaterThan",
                     1.0) == [3]


def test_orc_empty_file_is_one_split(tmp_path):
    p = str(tmp_path / "e.orc")
    paorc.write_table(_mixed_table(0), p)
    got = _both(lambda m, s: s.read.orc(p))
    assert got == []


# ---------------------------------------------------------------------------
# writers: round trips, empty results, stats dictionaries
# ---------------------------------------------------------------------------
def _write_both(tmp_path, fmt, q, **kw):
    """``q(m, session)`` written as ``fmt`` by both packages; their stats."""
    stats = []
    for m, sess, tag in ((PORT, _psession(), "p"), (REF, _jsession(), "j")):
        path = str(tmp_path / f"out_{tag}.{fmt}")
        stats.append(getattr(q(m, sess).write, fmt)(path, **kw))
        assert os.path.exists(path)
        assert not os.path.exists(path + "._temporary")
    return stats


def _read(m, sess, fmt, path):
    return getattr(sess.read, fmt)(path)


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_write_query_read_round_trip(tmp_path, fmt):
    pq.write_table(_mixed_table(seed=5), str(tmp_path / "in.parquet"))

    def q(m, s):
        E = m["E"]
        return s.read.parquet(str(tmp_path / "in.parquet")).where(
            E.GreaterThan(E.col("k"), E.lit(10)))
    pstats, jstats = _write_both(tmp_path, fmt, q)
    assert pstats == jstats if fmt != "parquet" else (
        pstats.keys() == jstats.keys()
        and pstats["numRows"] == jstats["numRows"] > 0)
    # every writer's file read back by both packages, all four equal
    rows = [_read(m, sess, fmt, str(tmp_path / f"out_{tag}.{fmt}")
                  ).collect()
            for tag in ("p", "j")
            for m, sess in ((PORT, _psession()), (REF, _jsession()))]
    for r in rows[1:]:
        _rows_equal(r, rows[0])
    want = q(REF, _jsession()).collect()
    n = pstats["numRows" if fmt == "parquet" else "rows"]
    assert len(rows[0]) == len(want) == n


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_write_empty_result(tmp_path, fmt):
    pq.write_table(pa.table({"k": pa.array([1, 2], pa.int64())}),
                   str(tmp_path / "in.parquet"))

    def q(m, s):
        E = m["E"]
        return s.read.parquet(str(tmp_path / "in.parquet")).where(
            E.GreaterThan(E.col("k"), E.lit(100)))
    pstats, jstats = _write_both(tmp_path, fmt, q)
    if fmt == "parquet":
        assert pstats["numRows"] == jstats["numRows"] == 0
        assert pstats["numBatches"] == jstats["numBatches"]
    else:
        assert pstats == jstats == {"rows": 0, "batches": 1, "files": 1}
    schema = lambda m: _schema(m, ("k", "LONG"))  # noqa: E731
    for tag in ("p", "j"):
        path = str(tmp_path / f"out_{tag}.{fmt}")
        if fmt == "csv":
            assert _psession().read.csv(path, schema=schema(PORT)
                                        ).collect() == []
        else:
            assert _read(PORT, _psession(), fmt, path).collect() == []


def test_csv_writer_round_trip(tmp_path):
    pq.write_table(_mixed_table(300, seed=22), str(tmp_path / "in.parquet"))
    pstats, jstats = _write_both(
        tmp_path, "csv",
        lambda m, s: s.read.parquet(str(tmp_path / "in.parquet")))
    assert pstats == jstats == {"rows": 300, "batches": 1, "files": 1}
    back = [pacsv.read_csv(str(tmp_path / f"out_{t}.csv")) for t in "pj"]
    assert back[0].num_rows == 300
    assert back[0].equals(back[1])


def test_parquet_stats_key_for_key(tmp_path):
    t = pa.table({"k": pa.array(np.arange(1000, dtype=np.int64)),
                  "v": pa.array(np.linspace(0, 1, 1000))})
    pq.write_table(t, str(tmp_path / "in.parquet"), row_group_size=250)
    pstats, jstats = _write_both(
        tmp_path, "parquet",
        lambda m, s: s.read.parquet(str(tmp_path / "in.parquet")))
    assert pstats == jstats
    assert pstats["numRows"] == 1000
    assert pstats["bytes"] == os.path.getsize(str(tmp_path / "out_p.parquet"))


def test_decimal_write_round_trip(tmp_path):
    D = decimal.Decimal
    t = pa.table({
        "d": pa.array([D("12.34"), None, D("-0.05"), D("99999.99")],
                      pa.decimal128(10, 2)),
        "v": pa.array([1, 2, 3, 4], pa.int64()),
    })
    pq.write_table(t, str(tmp_path / "dec.parquet"))
    _write_both(tmp_path, "parquet",
                lambda m, s: s.read.parquet(str(tmp_path / "dec.parquet")))
    for tag in "pj":
        back = pq.read_table(str(tmp_path / f"out_{tag}.parquet"))
        assert back.column("d").to_pylist() == [
            D("12.34"), None, D("-0.05"), D("99999.99")]
        assert back.schema.field("d").type == pa.decimal128(10, 2)


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_writer_cpu_engine_route(tmp_path, fmt):
    """A Python UDF keeps the plan on the CPU engine: the writer batches
    its rows (``DataFrameWriter.ROWS_PER_BATCH`` at a time)."""
    t = pa.table({"x": pa.array(np.arange(300, dtype=np.int64))})
    pq.write_table(t, str(tmp_path / "in.parquet"))

    def q(m, s):
        E = m["E"]
        return s.read.parquet(str(tmp_path / "in.parquet")).select(
            E.Alias(E.PythonUDF(lambda v: v * 3 + 1, (E.col("x"),),
                                m["T"].LONG), "y"))
    sess = _psession()
    small = PS.DataFrameWriter.ROWS_PER_BATCH
    PS.DataFrameWriter.ROWS_PER_BATCH = 128
    try:
        path = str(tmp_path / f"udf.{fmt}")
        stats = getattr(q(PORT, sess).write, fmt)(path)
    finally:
        PS.DataFrameWriter.ROWS_PER_BATCH = small
    from spark_rapids_tpu_torch.exec.transitions import ColumnarToRowExec

    assert not isinstance(sess.last_executed_plan, ColumnarToRowExec)
    n, b = ("numRows", "numBatches") if fmt == "parquet" else (
        "rows", "batches")
    assert (stats[n], stats[b]) == (300, 3)
    schema = _schema(PORT, ("y", "LONG"))
    back = (sess.read.csv(path, schema=schema) if fmt == "csv"
            else getattr(sess.read, fmt)(path)).collect()
    assert sorted(back) == [(3 * i + 1,) for i in range(300)]
    assert sorted(q(REF, _jsession()).collect()) == sorted(back)


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_failed_write_leaves_no_file(tmp_path, fmt):
    """A drain that fails in the middle commits nothing: no file and no
    temporary file remain."""
    t = pa.table({"x": pa.array(np.arange(300, dtype=np.int64))})
    pq.write_table(t, str(tmp_path / "in.parquet"))

    def boom(v):
        if v == 200:
            raise RuntimeError("udf failed at row 200")
        return v

    E = PE
    df = _psession().read.parquet(str(tmp_path / "in.parquet")).select(
        E.Alias(E.PythonUDF(boom, (E.col("x"),), PT.LONG), "y"))
    small = PS.DataFrameWriter.ROWS_PER_BATCH
    PS.DataFrameWriter.ROWS_PER_BATCH = 64
    path = str(tmp_path / f"bad.{fmt}")
    try:
        with pytest.raises(RuntimeError, match="row 200"):
            getattr(df.write, fmt)(path)
    finally:
        PS.DataFrameWriter.ROWS_PER_BATCH = small
    assert sorted(os.listdir(tmp_path)) == ["in.parquet"]


def test_committed_file_protocol(tmp_path):
    path = str(tmp_path / "sub" / "f.bin")
    with pytest.raises(ValueError):
        with PCOMMIT.committed_file(path) as tmp:
            assert tmp == path + "._temporary"
            with open(tmp, "wb") as f:
                f.write(b"partial")
            raise ValueError("writer failed")
    assert os.listdir(tmp_path / "sub") == []
    with PCOMMIT.committed_file(path) as tmp:
        with open(tmp, "wb") as f:
            f.write(b"whole")
    assert open(path, "rb").read() == b"whole"
    assert os.listdir(tmp_path / "sub") == ["f.bin"]


def test_write_invalidates_device_scan_cache(tmp_path):
    """A parquet read (through a symlink) fills the device scan cache
    under the file's real path; a write over that file drops its entries,
    frees their ledger records with reason ``invalidate``, and the next
    read gives the new rows."""
    from spark_rapids_tpu_torch.memory import ledger as L
    from spark_rapids_tpu_torch.memory.catalog import BufferCatalog

    DeviceScanCache.reset()
    src = str(tmp_path / "src.parquet")
    out = str(tmp_path / "out.parquet")
    link = str(tmp_path / "link.parquet")
    pq.write_table(pa.table({"k": pa.array(np.arange(100, dtype=np.int64))}),
                   src)
    sess = _psession()
    E = PE
    sess.read.parquet(src).write.parquet(out)
    os.symlink(out, link)
    led = BufferCatalog.get().ledger
    L.force_arm(True)
    try:
        assert len(sess.read.parquet(link).collect()) == 100
        cache = DeviceScanCache._instance
        real = os.path.realpath(out)

        def entries_of_out():
            return [k for k in cache._entries if k[0] == real]

        assert entries_of_out()
        before = cache.stats()["bytes"]
        freed = []
        note_free = led.note_free

        def spy(lid, reason=None, **kw):
            freed.append(reason)
            return note_free(lid, reason=reason, **kw)

        led.note_free = spy
        try:
            sess.read.parquet(src).where(
                E.LessThan(E.col("k"), E.lit(10))).write.parquet(out)
        finally:
            del led.note_free
        assert not entries_of_out()
        assert cache.stats()["bytes"] < before
        assert "invalidate" in freed
    finally:
        L.force_arm(False)
        DeviceScanCache.reset()
    assert sorted(sess.read.parquet(out).collect()) == [
        (i,) for i in range(10)]


def _write_row_groups(m, sess, path, n, groups):
    """``n`` rows of ``k`` written by ``sess`` as ``groups`` row groups
    (one a batch, one batch a partition)."""
    T = m["T"]
    return sess.create_dataframe(
        {"k": list(range(n))}, T.StructType([T.StructField("k", T.LONG)]),
        num_partitions=groups).write.parquet(path)


@pytest.mark.parametrize("first,then", [(1, 3), (3, 1)],
                         ids=["more_row_groups", "fewer_row_groups"])
def test_rewrite_reads_new_row_groups_without_clearing(tmp_path, first,
                                                        then):
    """The session caches a scanner per path with its row-group splits; a
    write over that path drops it, so the next read through the same
    session, with nothing cleared, plans the new file's row groups."""
    path = str(tmp_path / "r.parquet")
    sess = _psession()
    _write_row_groups(PORT, sess, path, 6 * first, first)
    assert len(sess.read.parquet(path).collect()) == 6 * first
    assert pq.ParquetFile(path).metadata.num_row_groups == first
    _write_row_groups(PORT, sess, path, 6 * then, then)
    assert pq.ParquetFile(path).metadata.num_row_groups == then
    assert sorted(sess.read.parquet(path).collect()) == [
        (i,) for i in range(6 * then)]


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_write_into_a_scanned_directory_is_seen(tmp_path, fmt):
    """A directory's cached scanner holds its file list; a write of a new
    file into that directory drops it, and the next read sees the file."""
    d = tmp_path / "d"
    d.mkdir()
    sess = _psession()
    T = PT
    schema = T.StructType([T.StructField("k", T.LONG)])
    for i in range(2):
        getattr(sess.create_dataframe(
            {"k": [10 * i, 10 * i + 1]}, schema).write, fmt)(
            str(d / f"part-{i}.{fmt}"))
        got = sorted(getattr(sess.read, fmt)(str(d)).collect())
        assert got == [(k,) for j in range(i + 1) for k in (10 * j,
                                                             10 * j + 1)]


def test_reference_reads_stale_row_groups_after_rewrite(tmp_path):
    """Reference ``sql/session._make_scanner`` caches a scanner per path
    with no file identity in its key, and its commit drops only the
    device scan cache: a rewrite with more row groups reads the old
    file's one row group, one with fewer raises. The port drops the
    path's scanners at the commit
    (``test_rewrite_reads_new_row_groups_without_clearing``)."""
    path = str(tmp_path / "r.parquet")
    sess = _jsession()
    _write_row_groups(REF, sess, path, 6, 1)
    assert len(sess.read.parquet(path).collect()) == 6
    _write_row_groups(REF, sess, path, 18, 3)
    assert pq.ParquetFile(path).metadata.num_row_groups == 3
    assert len(sess.read.parquet(path).collect()) == 6
    JS._SCANNER_CACHE.clear()
    assert len(sess.read.parquet(path).collect()) == 18
    _write_row_groups(REF, sess, path, 6, 1)
    with pytest.raises(IndexError, match="out of bounds"):
        sess.read.parquet(path).collect()


# ---------------------------------------------------------------------------
# the parquet-only routes a CSV or ORC split stays out of
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["csv", "orc"])
def test_csv_and_orc_splits_skip_parquet_routes(tmp_path, fmt):
    from spark_rapids_tpu_torch.exec.scan import TpuFileSourceScanExec
    from spark_rapids_tpu_torch.plugin.plananalysis import analyze_plan

    t = _mixed_table(400, seed=31).select(["k", "l"])
    path = str(tmp_path / f"t.{fmt}")
    (pacsv.write_csv if fmt == "csv" else paorc.write_table)(t, path)
    sess = _psession()
    df = getattr(sess.read, fmt)(path)
    top = sess._execute(df.node)
    scan = top.tpu_child
    assert isinstance(scan, TpuFileSourceScanExec)
    assert scan.fused_stage_plans(0) is None
    assert scan._mesh_row_groups() is None
    assert scan.mesh_stage_items() is None
    assert scan.partition_rows() is None
    assert not hasattr(scan.scanner, "read_split_device")
    analysis = analyze_plan(sess.last_cpu_plan, sess.conf,
                            device=sess.device)
    text = "\n".join(analysis.render_lines())
    assert "pipelined device decode" not in text
    _both(lambda m, s: getattr(s.read, fmt)(path))


def test_csv_mesh_staging_is_none(tmp_path, monkeypatch):
    """Under a mesh stage a CSV source has no static row counts: the
    forecast's staging is None (reference plananalysis ``:1600``) and the
    query still gives the reference's rows."""
    from spark_rapids_tpu_torch.plugin.plananalysis import forecast_mesh

    monkeypatch.setenv("SRTPU_TORCH_VIRTUAL_DEVICES", "4")
    t = _mixed_table(600, seed=13).select(["k", "l"])
    p = str(tmp_path / "mesh")
    os.mkdir(p)
    for i in range(2):  # two splits: one partition never meets a mesh
        pacsv.write_csv(t.slice(300 * i, 300), os.path.join(p, f"{i}.csv"))
    ici = {"spark.rapids.tpu.shuffle.mode": "ici",
           "spark.rapids.tpu.mesh.devices": 4}
    sess = _psession(ici)

    def q(m, s):
        A, E = m["A"], m["E"]
        return s.read.csv(p).group_by("k").agg(
            A.agg(A.Sum(E.col("l")), "sl"))
    df = q(PORT, sess)
    plan = sess._execute(df.node)
    fc = forecast_mesh(plan.tpu_child)
    assert fc is not None
    assert all(st.get("staging") is None for st in fc["stages"])
    got = df.collect()
    want = q(REF, _jsession({"spark.rapids.tpu.shuffle.mode": "host"})
             ).collect()
    _rows_equal(got, want)


def test_write_runs_in_a_query_window(tmp_path):
    """A write's drain is a query: with the event log on it emits
    ``query_start`` and a ``query_end`` with ``rows=None`` (a count would
    cost a sync a batch), ``error`` set when the drain fails, and the
    ledger sweeps it, as the reference's writer does."""
    from spark_rapids_tpu_torch import events

    pq.write_table(pa.table({"x": pa.array(np.arange(50, dtype=np.int64))}),
                   str(tmp_path / "in.parquet"))
    sess = _psession({"spark.rapids.tpu.eventLog.enabled": True})
    try:
        E = PE
        df = sess.read.parquet(str(tmp_path / "in.parquet"))
        df.write.parquet(str(tmp_path / "ok.parquet"))

        def boom(v):
            raise RuntimeError("udf failed")

        with pytest.raises(RuntimeError, match="udf failed"):
            df.select(E.Alias(E.PythonUDF(boom, (E.col("x"),), PT.LONG),
                              "y")).write.csv(str(tmp_path / "bad.csv"))
        recs = sess.events.records()
    finally:
        sess.close()
        events.uninstall()
    starts = [r for r in recs if r["event"] == "query_start"]
    ends = [r for r in recs if r["event"] == "query_end"]
    assert len(starts) == len(ends) == 2
    assert [(r["rows"], r["error"]) for r in ends] == [(None, False),
                                                       (None, True)]
    assert {r["query_id"] for r in starts} == {r["query_id"] for r in ends}
    assert not os.path.exists(str(tmp_path / "bad.csv"))
