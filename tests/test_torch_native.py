"""The port's binding of the repo's native host code
(``spark_rapids_tpu_torch/native.py``) against the reference's
(``spark_rapids_tpu/native.py``): the lz4 block codec byte for byte, the
C++ hybrid decoder against the numpy decoder and the reference's decode,
the BYTE_ARRAY dictionary parse against the Python loop it replaces, the
serializer's lz4 frames, and a host-shuffle session query under lz4.
Both libraries build with g++ at first use; the port's into
``spark_rapids_tpu_torch/_build/``, never into ``native/``.
"""
import os
import random
import struct

import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import native as JN
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.io import parquet_device as JPD
from spark_rapids_tpu.shuffle import serializer as JS
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import native as PN
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.io import parquet_device as PPD
from spark_rapids_tpu_torch.shuffle import serializer as PS
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

LZ4_CASES = {
    "empty": b"",
    "one": b"a",
    "text": b"hello world " * 1000,
    "bytes": bytes(range(256)) * 64,
    "zeros": b"\x00" * 100_000,
    "random": random.Random(3).randbytes(50_000),
    "mixed": b"abcabcabcabc" + random.Random(4).randbytes(17) + b"z" * 21,
}


def test_library_builds_into_the_ports_build_dir():
    native_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    before = sorted(os.listdir(native_dir))
    assert PN.available(), PN.BUILD_ERROR
    assert PN.LIBRARY.parent.name == "_build"
    assert PN.LIBRARY.parent.parent.name == "spark_rapids_tpu_torch"
    assert PN.LIBRARY.exists()
    assert sorted(os.listdir(native_dir)) == before


@pytest.mark.parametrize("case", sorted(LZ4_CASES))
def test_lz4_is_the_references(case):
    raw = LZ4_CASES[case]
    comp = PN.lz4_compress(raw)
    assert comp == JN.lz4_compress(raw)
    assert PN.lz4_decompress(comp, len(raw)) == raw
    assert JN.lz4_decompress(comp, len(raw)) == raw


def test_lz4_rejects_a_corrupt_payload():
    raw = LZ4_CASES["text"]
    comp = PN.lz4_compress(raw)
    with pytest.raises(ValueError, match="corrupt"):
        PN.lz4_decompress(comp[: len(comp) // 2], len(raw))
    with pytest.raises(ValueError, match="corrupt"):
        PN.lz4_decompress(comp, len(raw) + 5)


def test_lz4_without_the_library_raises(monkeypatch):
    monkeypatch.setattr(PN, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        PN.lz4_compress(b"abc")
    with pytest.raises(RuntimeError, match="native library unavailable"):
        PN.lz4_decompress(b"abc", 3)
    assert PN.pq_hybrid_decode(b"", 0, 0, 3, 0, np.empty(0, np.uint8)) \
        is None


# ---------------------------------------------------------------------------
# the hybrid RLE / bit-packed stream
# ---------------------------------------------------------------------------
def _uleb(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pack(vals, bw: int) -> bytes:
    acc = 0
    for i, v in enumerate(vals):
        acc |= int(v) << (i * bw)
    return acc.to_bytes(len(vals) * bw // 8, "little")


def _stream(rng, bw: int, n: int):
    """A hybrid stream of ``n`` values mixing RLE and bit-packed runs, and
    the values it holds."""
    out, vals = bytearray(), []
    while len(vals) < n:
        if rng.random() < 0.5:
            k = rng.randint(1, 40)
            v = rng.randrange(1 << bw)
            out += _uleb(k << 1) + v.to_bytes((bw + 7) // 8, "little")
            vals += [v] * k
        else:
            groups = rng.randint(1, 6)
            run = [rng.randrange(1 << bw) for _ in range(groups * 8)]
            out += _uleb((groups << 1) | 1) + _pack(run, bw)
            vals += run
    return bytes(out), vals[:n]


@pytest.mark.parametrize("bw", range(1, 25))
def test_hybrid_decode_is_the_numpy_decoders_and_the_references(bw):
    rng = random.Random(bw)
    for n in (1, 7, 8, 300, 1000):
        data, want = _stream(rng, bw, n)
        pad = b"\xff" * 3
        data = pad + data + pad  # a stream inside a page
        end = len(data) - len(pad)
        before = dict(PPD.DECODE_ROUTES)
        got, pos = PPD.hybrid_decode(data, len(pad), end, bw, n)
        assert PPD.DECODE_ROUTES["native"] == before["native"] + 1
        assert got.dtype == PPD._code_dtype(bw)
        assert got.tolist() == want
        np_vals, np_pos = PPD.hybrid_decode_np(data, len(pad), end, bw, n)
        ref, ref_pos = JPD.hybrid_decode(data, len(pad), end, bw, n)
        assert np_vals.tolist() == want == ref.tolist()
        assert pos == np_pos == ref_pos


def test_hybrid_decode_without_the_library_takes_numpy(monkeypatch):
    data, want = _stream(random.Random(1), 5, 500)
    monkeypatch.setattr(PN, "_load", lambda: None)
    before = dict(PPD.DECODE_ROUTES)
    got, pos = PPD.hybrid_decode(data, 0, len(data), 5, 500)
    assert got.tolist() == want and got.dtype == np.uint8
    assert PPD.DECODE_ROUTES["numpy"] == before["numpy"] + 1


MALFORMED = {
    "packed_run_past_the_end": (_uleb((4 << 1) | 1) + b"\x00" * 5, 6, 32),
    "rle_value_past_the_end": (_uleb(10 << 1), 12, 10),
    "header_past_the_end": (b"\x80\x80", 3, 4),
    "too_few_values": (_uleb(3 << 1) + b"\x01", 4, 50),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_streams_fall_back_like_the_reference(case):
    data, bw, n = MALFORMED[case]

    def outcome(fn, err):
        try:
            vals, pos = fn(data, 0, len(data), bw, n)
        except err:
            return "fallback"
        return vals.tolist(), pos

    got = outcome(PPD.hybrid_decode, PPD._FallbackError)
    assert got == outcome(JPD.hybrid_decode, JPD._FallbackError)
    assert got == "fallback"


# ---------------------------------------------------------------------------
# BYTE_ARRAY dictionary pages
# ---------------------------------------------------------------------------
DICT_CASES = {
    "empty_entries": [b"", b"", b"a", b""],
    "non_ascii": ["héllo".encode(), "日本語".encode(), b"\xff\x00\x01",
                  "\U0001f600".encode()],
    "many": [f"value-{i}".encode() * (i % 5) for i in range(3000)],
    "none": [],
}


def _old_loop(raw: bytes, count: int):
    offs = np.zeros(count + 1, np.int64)
    chars = []
    p = 0
    for i in range(count):
        (ln,) = struct.unpack_from("<I", raw, p)
        p += 4
        chars.append(raw[p: p + ln])
        p += ln
        offs[i + 1] = offs[i] + ln
    pool = b"".join(chars)
    return offs, (np.frombuffer(pool, np.uint8).copy() if pool
                  else np.zeros(1, np.uint8))


@pytest.mark.parametrize("case", sorted(DICT_CASES))
def test_binary_dictionary_is_the_old_loop(case):
    entries = DICT_CASES[case]
    raw = b"".join(struct.pack("<I", len(e)) + e for e in entries)
    plan = PPD.ChunkPlan("BYTE_ARRAY", len(entries), False)
    PPD._load_dictionary(plan, raw, len(entries))
    offs, chars = _old_loop(raw, len(entries))
    assert plan.dict_offsets.dtype == np.int64
    assert plan.dict_offsets.tolist() == offs.tolist()
    assert plan.dict_chars.tolist() == chars.tolist()
    jplan = JPD.ChunkPlan("BYTE_ARRAY", len(entries), False)
    JPD._load_dictionary(jplan, raw, len(entries))
    assert jplan.dict_offsets.tolist() == offs.tolist()
    assert jplan.dict_chars.tolist() == chars.tolist()


def test_malformed_binary_dictionary_falls_back():
    raw = struct.pack("<I", 50) + b"short"
    plan = PPD.ChunkPlan("BYTE_ARRAY", 1, False)
    with pytest.raises(PPD._FallbackError):
        PPD._load_dictionary(plan, raw, 1)


# ---------------------------------------------------------------------------
# the serializer's lz4 frames and a host-shuffle query
# ---------------------------------------------------------------------------
def _wire(TT, BatchCls, n, **kw):
    rng = np.random.default_rng(n)
    words = ["", "x", "héllo", "日本", "spark-rapids " * 3]
    sch = TT.StructType((TT.StructField("i", TT.INT),
                         TT.StructField("d", TT.DOUBLE),
                         TT.StructField("s", TT.STRING)))
    data = {"i": [None if j % 9 == 0 else int(rng.integers(-99, 99))
                  for j in range(n)],
            "d": [float(rng.standard_normal()) for _ in range(n)],
            "s": [None if j % 5 == 0 else words[j % len(words)]
                  for j in range(n)]}
    return BatchCls.from_pydict(data, sch, **kw)


@pytest.mark.parametrize("n", (0, 1, 100, 5000))
def test_serializer_lz4_frames_are_the_references(n):
    data = PS.serialize_batch(_wire(T, PBatch, n, device="cpu"), "lz4")
    assert data == JS.serialize_batch(_wire(JT, JBatch, n), "lz4")
    assert data[4] == 2
    back = PS.deserialize_batch(data, "cpu")
    assert back.to_rows() == JS.deserialize_batch(data).to_rows()


def test_host_shuffle_query_with_lz4():
    rows = [(i % 17, i * 3 - 500, f"k{i % 11}") for i in range(3000)]
    conf = {"spark.rapids.tpu.shuffle.mode": "host",
            "spark.rapids.tpu.shuffle.transport.class": "host",
            "spark.rapids.tpu.shuffle.compression.codec": "lz4"}

    def q(TT, E, A, sess):
        schema = TT.StructType((TT.StructField("k", TT.INT),
                                TT.StructField("v", TT.LONG),
                                TT.StructField("s", TT.STRING)))
        return (sess.from_rows(rows, schema, num_partitions=3)
                .group_by("s").agg(A.agg(A.Sum(E.col("v")), "sv"),
                                   A.agg(A.Count(None), "n"),
                                   A.agg(A.Max(E.col("k")), "mk")))

    sess = PSession(conf, device="cpu")
    got = sorted(q(T, PE, PA, sess).collect())
    assert "TpuShuffleExchangeExec" in sess.explain_metrics()
    assert got == sorted(q(JT, JE, JA, JSession(conf)).collect())
