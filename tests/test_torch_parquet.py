"""The port's parquet scan (``io/parquet.py``, ``io/parquet_device.py``,
``io/scan_cache.py``, ``exec/scan.py``) against the reference's.

Files are written by pyarrow under ``tmp_path`` from seeded numpy columns:
dictionary and PLAIN pages, int32/int64/float/double, nullable columns,
v1 and v2 data pages, several row groups, and the uncompressed, snappy
and gzip codecs. Each column chunk goes through the reference's host
planning and device decode and through the port's; values and validity
must be equal on every row (bit for bit). Pushed filters must prune the
same row groups, a second read must come from the device scan cache, and
the bench's parquet query (``bench.py:540``, 2^14 rows) must give the
same rows through both sessions.
"""
import os

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import spark_rapids_tpu  # noqa: E402,F401
from spark_rapids_tpu import types as JT  # noqa: E402
from spark_rapids_tpu.expr import aggregates as JA  # noqa: E402
from spark_rapids_tpu.expr import expressions as JE  # noqa: E402
from spark_rapids_tpu.io import parquet as JPQ  # noqa: E402
from spark_rapids_tpu.io import parquet_device as JPD  # noqa: E402
from spark_rapids_tpu.sql.session import TpuSession as JSession  # noqa: E402
from spark_rapids_tpu_torch import types as T  # noqa: E402
from spark_rapids_tpu_torch.conf import RapidsConf  # noqa: E402
from spark_rapids_tpu_torch.exec.scan import TpuFileSourceScanExec  # noqa: E402
from spark_rapids_tpu_torch.expr import aggregates as PA  # noqa: E402
from spark_rapids_tpu_torch.expr import expressions as PE  # noqa: E402
from spark_rapids_tpu_torch.io import parquet as PPQ  # noqa: E402
from spark_rapids_tpu_torch.io import parquet_device as PPD  # noqa: E402
from spark_rapids_tpu_torch.io.arrow_convert import arrow_schema_to_tpu  # noqa: E402
from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache  # noqa: E402
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession  # noqa: E402
from test_torch_plananalysis import comparable_explain

N = 3000


def _table(seed=3, n=N):
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.2
    i32 = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    i32[:4] = [-(2**31), 2**31 - 1, 0, -1]
    low = rng.integers(0, 40, n).astype(np.int32)
    i64 = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    i64[:3] = [-(2**63), 2**63 - 1, 0]
    f32 = rng.normal(size=n).astype(np.float32)
    f32[:3] = [np.nan, -0.0, np.inf]
    f64 = np.round(rng.uniform(1, 100, 97), 2)[rng.integers(0, 97, n)]
    f64[:3] = [np.nan, -0.0, -np.inf]
    return pa.table({
        "i32": pa.array(i32),
        "low": pa.array(low),
        "i64": pa.array(i64),
        "f32": pa.array(f32),
        "f64": pa.array(f64),
        "n_i32": pa.array(low, mask=nulls),
        "n_i64": pa.array(i64, mask=np.roll(nulls, 1)),
        "n_f64": pa.array(f64, mask=np.roll(nulls, 2)),
        "all_null": pa.array(np.zeros(n, np.int64), mask=np.ones(n, bool)),
    })


FILES = {
    f"{enc}_{ver}_{codec}": dict(use_dictionary=enc == "dict",
                                 data_page_version=ver, compression=codec)
    for enc in ("dict", "plain")
    for ver in ("1.0", "2.0")
    for codec in ("NONE", "SNAPPY", "GZIP")
}


def _write(tmp_path, name, opts, table=None, rg=1000):
    path = os.path.join(str(tmp_path), f"{name}.parquet")
    pq.write_table(table if table is not None else _table(), path,
                   row_group_size=rg, data_page_size=4096, **opts)
    return path


def _decode_all(mod, path, device=None):
    """Every column chunk of every row group through ``mod``'s host
    planning and device decode: {(rg, name): (data, validity)} as numpy,
    or the route name when the chunk falls back to the host decoder."""
    pf = pq.ParquetFile(path)
    with open(path, "rb") as f:
        raw = f.read()
    tschema = arrow_schema_to_tpu(pf.schema_arrow)
    out = {}
    for rg in range(pf.metadata.num_row_groups):
        rgmd = pf.metadata.row_group(rg)
        for ci in range(rgmd.num_columns):
            col = pf.schema.column(ci)
            name = rgmd.column(ci).path_in_schema
            f = tschema.fields[tschema.field_index(name)]
            dt = getattr(JT if mod is JPD else T, type(f.dataType).__name__
                         .replace("Type", "").upper()
                         .replace("INTEGER", "INT"))
            try:
                plan = mod.plan_chunk(raw, rgmd.column(ci),
                                      col.max_definition_level,
                                      col.max_repetition_level)
                cap = 1 << max(7, (rgmd.num_rows - 1).bit_length())
                kw = {} if mod is JPD else {"device": device}
                dc = mod.chunk_to_device_column(plan, dt, cap, **kw)
            except mod._FallbackError:
                out[(rg, name)] = "host"
                continue
            data = np.asarray(dc.data if mod is JPD else dc.data.cpu())
            valid = np.asarray(dc.validity if mod is JPD
                               else dc.validity.cpu())
            out[(rg, name)] = (data[:rgmd.num_rows], valid[:rgmd.num_rows])
    return out


@pytest.mark.parametrize("name", sorted(FILES))
def test_chunk_decode_matches_reference(tmp_path, name):
    path = _write(tmp_path, name, FILES[name])
    ref = _decode_all(JPD, path)
    got = _decode_all(PPD, path, "cpu")
    assert ref.keys() == got.keys()
    device_chunks = 0
    for key, r in ref.items():
        g = got[key]
        if isinstance(r, str):
            assert g == r, key
            continue
        device_chunks += 1
        rd, rv = r
        gd, gv = g
        np.testing.assert_array_equal(gv, rv, err_msg=str(key))
        assert gd.dtype == rd.dtype, key
        # bit for bit (NaN payloads and the sign of zero included)
        view = {4: np.int32, 8: np.int64}[rd.dtype.itemsize]
        np.testing.assert_array_equal(gd.view(view)[rv], rd.view(view)[rv],
                                      err_msg=str(key))
    assert device_chunks > 0


def _dict_chunks(mod, path, device=None):
    """Every row group's ``s`` chunk through ``mod``'s decode under
    dictStrings: {rg: (codes, dict offsets, dict chars, validity,
    mat_cap, max_len, unique)} as numpy and host ints."""
    pf = pq.ParquetFile(path)
    with open(path, "rb") as f:
        raw = f.read()
    ci = pf.schema_arrow.get_field_index("s")
    col = pf.schema.column(ci)
    out = {}
    for rg in range(pf.metadata.num_row_groups):
        rgmd = pf.metadata.row_group(rg)
        plan = mod.plan_chunk(raw, rgmd.column(ci), col.max_definition_level,
                              col.max_repetition_level)
        cap = 1 << max(7, (rgmd.num_rows - 1).bit_length())
        kw = {} if mod is JPD else {"device": device}
        dc = mod.chunk_to_device_column(
            plan, JT.STRING if mod is JPD else T.STRING, cap,
            dict_strings=True, **kw)
        assert dc.is_dict, rg
        d = dc.dictv
        out[rg] = tuple(np.asarray(x if mod is JPD else x.cpu()) for x in (
            d.codes, d.dictionary.offsets, d.dictionary.chars,
            d.validity)) + (d.mat_cap, d.max_len, d.unique)
    return out


def test_dictionary_strings(tmp_path):
    """Dictionary-encoded BYTE_ARRAY: under dictStrings (the default) each
    chunk scans to a DictV holding the file's own dictionary, with the
    reference's codes, validity and metadata; with it on and off the port's
    session gives the reference's rows."""
    rng = np.random.default_rng(2)
    words = np.array(["", "a", "bb", "ccc", "é€", "z" * 40], dtype=object)
    s = words[rng.integers(0, len(words), 2000)]
    t = pa.table({"s": pa.array(s, mask=rng.random(2000) < 0.1),
                  "k": pa.array(rng.integers(0, 5, 2000).astype(np.int32))})
    path = _write(tmp_path, "strings", {}, t, rg=700)
    ref = _dict_chunks(JPD, path)
    got = _dict_chunks(PPD, path, "cpu")
    pf = pq.ParquetFile(path, read_dictionary=["s"])
    assert ref.keys() == got.keys()
    for rg, (rc, roff, rch, rv, rmat, rlen, runiq) in ref.items():
        gc, goff, gch, gv, gmat, glen, guniq = got[rg]
        np.testing.assert_array_equal(gv, rv)
        np.testing.assert_array_equal(gc[gv], rc[rv])
        np.testing.assert_array_equal(goff, roff)
        np.testing.assert_array_equal(gch[:goff[-1]], rch[:roff[-1]])
        assert (gmat, glen, guniq) == (rmat, rlen, runiq) and guniq
        # the dictionary is the file's own, in the file's order
        fd = pf.read_row_group(rg, columns=["s"]).column(0).chunk(0)
        entries = [gch[a:b].tobytes().decode() for a, b in
                   zip(goff[:-1], goff[1:])]
        assert entries == fd.dictionary.to_pylist()
    for on in (True, False):
        conf = {"spark.rapids.tpu.sql.format.parquet.dictStrings.enabled":
                on}
        DeviceScanCache.reset()
        want = JSession(conf).read.parquet(path).collect()
        DeviceScanCache.reset()
        df = PSession(conf, device="cpu").read.parquet(path)
        assert df.collect() == want, on
        # the scan hands out the layout the conf asks for
        sc = PPQ.ParquetScanner(path, RapidsConf(conf))
        scan = TpuFileSourceScanExec(RapidsConf(conf), sc, "parquet", "cpu")
        batches = [b for p in range(scan.num_partitions)
                   for b in scan.execute_partition(p)]
        si = scan.output_schema.field_index("s")
        assert len(batches) == 3
        assert all(b.columns[si].is_dict == on for b in batches)
    DeviceScanCache.reset()


FILTERS = [
    [("low", ">=", 30)],
    [("low", "<", 3), ("i32", ">", 0)],
    [("i64", "=", 0)],
    [("n_i32", "isnull", None)],
    [("all_null", "notnull", None)],
    [("f64", "<=", 1.5)],
]


@pytest.mark.parametrize("filters", FILTERS, ids=str)
def test_pushed_filters_prune_the_same_row_groups(tmp_path, filters):
    rng = np.random.default_rng(4)
    t = _table()
    # sorted runs, so min/max statistics can prune
    order = np.argsort(np.asarray(t.column("low")), kind="stable")
    t = t.take(pa.array(order))
    path = _write(tmp_path, "sorted", {}, t, rg=int(rng.integers(300, 500)))
    pf = pq.ParquetFile(path)
    ref = JPQ.prune_row_groups(pf, [JPQ.PushedFilter(*f) for f in filters])
    got = PPQ.prune_row_groups(pf, [PPQ.PushedFilter(*f) for f in filters])
    assert got == ref
    assert 0 < pf.metadata.num_row_groups


def test_second_read_hits_the_scan_cache(tmp_path):
    path = _write(tmp_path, "cached", FILES["dict_1.0_SNAPPY"])
    DeviceScanCache.reset()
    conf = RapidsConf({})
    sc = PPQ.ParquetScanner(path, conf)
    exec_ = TpuFileSourceScanExec(conf, sc, "parquet", "cpu")
    first = [b for p in range(exec_.num_partitions)
             for b in exec_.execute_partition(p)]
    stats = DeviceScanCache.get_instance(conf).stats()
    assert stats["hits"] == 0 and stats["entries"] == 3
    assert exec_.metrics["hostDecodeTime"].value > 0
    assert exec_.metrics["uploadBytes"].value > 0
    second = [b for p in range(exec_.num_partitions)
              for b in exec_.execute_partition(p)]
    stats = DeviceScanCache.get_instance(conf).stats()
    assert stats["hits"] == 3
    assert all(a is b for a, b in zip(first, second))
    DeviceScanCache.reset()


def _bench_file(tmp_path, log2_rows=14):
    """The bench parquet table (``bench.py:550-559``) at 2^14 rows."""
    n = 1 << log2_rows
    rng = np.random.default_rng(0)
    prices = np.round(rng.uniform(1.0, 100.0, 9750), 2)
    t = pa.table({
        "ss_item_sk": rng.integers(1, 18001, n).astype(np.int32),
        "ss_quantity": rng.integers(1, 101, n).astype(np.int32),
        "ss_wholesale_cost": prices[rng.integers(0, 9750, n)],
        "ss_sold_date_sk": (2450815 + rng.integers(0, 2400, n)).astype(
            np.int32),
    })
    path = os.path.join(str(tmp_path), "store_sales")
    os.makedirs(path)
    pq.write_table(t, os.path.join(path, "part-0.parquet"),
                   row_group_size=n // 4)
    return path


def _bench_query(m, sess, path):
    E, A = m["E"], m["A"]
    return (sess.read.parquet(path)
            .where(E.GreaterThanOrEqual(E.col("ss_sold_date_sk"),
                                        E.Literal.of(2452015)))
            .group_by("ss_quantity")
            .agg(A.agg(A.Sum(E.col("ss_wholesale_cost")), "s"),
                 A.agg(A.Count(E.col("ss_item_sk")), "c")))


def test_bench_parquet_query_through_both_sessions(tmp_path):
    path = _bench_file(tmp_path)
    vfa = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    ref = sorted(_bench_query(dict(E=JE, A=JA), JSession(vfa), path)
                 .collect())
    psess = PSession(vfa, device="cpu")
    df = _bench_query(dict(E=PE, A=PA), psess, path)
    got = sorted(df.collect())
    assert len(got) == len(ref) == 100
    for r, g in zip(ref, got):
        assert g[0] == r[0] and g[2] == r[2]
        assert abs(g[1] - r[1]) <= 1e-9 * max(1.0, abs(r[1]))
    text = df.explain()
    assert text.split("\n== Static Plan Analysis ==")[0] == (
        "*Exec <HashAggregateExec> will run on TPU\n"
        "  *Exec <FilterExec> will run on TPU\n"
        "    *Exec <FileSourceScanExec> will run on TPU")
    assert comparable_explain(text) == comparable_explain(_bench_query(
        dict(E=JE, A=JA), JSession(vfa), path).explain())
    scan = psess.last_executed_plan.tpu_child.children[0].children[0]
    assert isinstance(scan, TpuFileSourceScanExec)
    assert scan.metrics["numOutputBatches"].value == 4  # one per row group
    # every column chunk took the device-decode route: none went through
    # pyarrow's host decode, and the plain reader never ran
    assert scan.metrics["hostFallbackChunks"].value == 0
    assert scan.metrics["scanTime"].value == 0
    assert 0 < scan.metrics["uploadBytes"].value < (1 << 14) * 20


def test_host_fallback_chunks_are_counted(tmp_path):
    """A PLAIN BYTE_ARRAY column is one the device decoder does not take:
    each of its chunks decodes through pyarrow on the host, is counted in
    ``hostFallbackChunks``, and the rows equal the reference's."""
    rng = np.random.default_rng(5)
    words = np.array(["x", "yy", "", "zzz"], dtype=object)
    t = pa.table({"s": pa.array(words[rng.integers(0, 4, 2000)]),
                  "k": pa.array(rng.integers(0, 9, 2000).astype(np.int32))})
    path = _write(tmp_path, "plain_strings", {"use_dictionary": False}, t,
                  rg=700)
    DeviceScanCache.reset()
    psess = PSession({}, device="cpu")
    got = psess.read.parquet(path).collect()
    assert got == JSession({}).read.parquet(path).collect()
    scan = psess.last_executed_plan.tpu_child
    assert isinstance(scan, TpuFileSourceScanExec)
    assert scan.metrics["hostFallbackChunks"].value == 3  # s, 3 row groups
    DeviceScanCache.reset()


def _uvarint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _hybrid_stream(rng, bw, runs):
    """A hybrid stream of random RLE and bit-packed runs (whole groups of
    8, random bytes) and the number of values it holds."""
    out = bytearray()
    total = 0
    for _ in range(runs):
        if rng.random() < 0.4:
            count = int(rng.integers(1, 300))
            out += _uvarint(count << 1)
            v = int(rng.integers(0, 1 << bw))
            out += v.to_bytes((bw + 7) // 8, "little")
            total += count
        else:
            groups = int(rng.integers(1, 70))
            out += _uvarint((groups << 1) | 1)
            out += rng.integers(0, 256, groups * bw, dtype=np.uint8).tobytes()
            total += groups * 8
    return bytes(out), total


@pytest.mark.parametrize("bw", [1, 2, 3, 5, 7, 8, 9, 12, 14, 16, 17, 20, 24])
def test_hybrid_decode_matches_reference(bw):
    """The port's vectorized hybrid decoder against the reference's
    run-by-run one: every value and the end position, for a stream read
    whole, cut inside a run (padding values), and offset in its buffer."""
    rng = np.random.default_rng(bw)
    body, total = _hybrid_stream(rng, bw, 40)
    data = b"\x07" * 5 + body + b"\x00" * 3
    for n in (total, total - 5, max(1, total // 3)):
        rv, rp = JPD.hybrid_decode_np(data, 5, 5 + len(body), bw, n)
        gv, gp = PPD.hybrid_decode_np(data, 5, 5 + len(body), bw, n)
        assert gp == rp
        np.testing.assert_array_equal(gv, rv)
    with pytest.raises(PPD._FallbackError):
        PPD.hybrid_decode_np(data, 5, 5 + len(body), bw, total + 1)


@pytest.mark.parametrize("reader", ["PERFILE", "COALESCING",
                                    "MULTITHREADED"])
@pytest.mark.parametrize("device_decode", [True, False])
def test_reader_types_and_routes_match_reference(tmp_path, reader,
                                                 device_decode):
    """A two-file directory (so two splits, one partition each) read
    under every reader type, on the device-decode route and on the host
    route (arrow_to_batch), filtered: the same rows as the reference."""
    d = os.path.join(str(tmp_path), "two")
    os.makedirs(d)
    for i in range(2):
        pq.write_table(_table(seed=10 + i, n=1500),
                       os.path.join(d, f"part-{i}.parquet"),
                       row_group_size=600)
    settings = {
        "spark.rapids.tpu.sql.format.parquet.reader.type": reader,
        "spark.rapids.tpu.sql.format.parquet.deviceDecode.enabled":
            device_decode}

    def q(E, sess):
        return (sess.read.parquet(d, columns=["low", "i64", "n_f64"])
                .where(E.LessThan(E.col("low"), E.Literal.of(8))))

    ref = q(JE, JSession(settings)).collect()
    psess = PSession(settings, device="cpu")
    got = q(PE, psess).collect()
    key = repr
    assert sorted(got, key=key) == sorted(ref, key=key) and len(got) > 0
    assert psess.last_executed_plan.tpu_child.num_partitions == 2
