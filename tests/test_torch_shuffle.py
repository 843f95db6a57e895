"""The port's shuffle layer (``spark_rapids_tpu_torch/shuffle/``) against
the reference's ``spark_rapids_tpu/shuffle/`` on the same seeded rows.

Partition ids must be equal bit for bit: a one-row difference moves a
row into another reduce partition. Hash ids over int, long, double
(with ±0.0, NaN, ±inf) and string keys (ASCII, UTF-8, long rows) at the
string bounds each exchange measures; round-robin and range ids, the
range bounds holding nulls and NaN; ``partition_cols``' offsets and its
stability; the serializer's bytes for codec ``none`` equal to the
reference's, and round trips of an empty batch and of one with nulls
and UTF-8.
"""
import math

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.exec import base as JB
from spark_rapids_tpu.ops import filter_gather as JFG
from spark_rapids_tpu.ops.sort import SortOrder as JOrder
from spark_rapids_tpu.ops.sort import max_string_len as j_max_len
from spark_rapids_tpu.columnar.column import choose_capacity as j_cap
from spark_rapids_tpu.shuffle import partition as JP
from spark_rapids_tpu.shuffle import serializer as JS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import base as PB
from spark_rapids_tpu_torch.ops import filter_gather as PFG
from spark_rapids_tpu_torch.ops.sort import SortOrder, str_max_lens
from spark_rapids_tpu_torch.shuffle import partition as PP
from spark_rapids_tpu_torch.shuffle import serializer as PS

N = 300
STRINGS = ["", "a", "ab", "zz", "héllo", "日本語", "x" * 70, "A\x00b",
           "abc", "abd"]


def _rows(seed=3):
    rng = np.random.default_rng(seed)
    dbl = [0.0, -0.0, math.nan, math.inf, -math.inf, 1.5, -2.25, 1e300]
    rows = []
    for i in range(N):
        rows.append((
            None if rng.random() < 0.1 else int(rng.integers(-2**31,
                                                             2**31 - 1)),
            None if rng.random() < 0.1 else int(rng.integers(-2**62,
                                                             2**62)),
            None if rng.random() < 0.1 else (
                dbl[int(rng.integers(0, len(dbl)))] if rng.random() < 0.5
                else float(rng.normal() * 100)),
            None if rng.random() < 0.1 else STRINGS[int(rng.integers(
                0, len(STRINGS)))],
        ))
    return rows


def _schema(TT):
    return TT.StructType((TT.StructField("i", TT.INT),
                          TT.StructField("l", TT.LONG),
                          TT.StructField("d", TT.DOUBLE),
                          TT.StructField("s", TT.STRING)))


def _pydict(rows):
    return {n: [r[j] for r in rows] for j, n in enumerate("ilds")}


@pytest.fixture(scope="module")
def batches():
    rows = _rows()
    jb = JBatch.from_pydict(_pydict(rows), _schema(JT))
    pb = ColumnarBatch.from_pydict(_pydict(rows), _schema(T), device="cpu")
    return rows, jb, pb


def _ref_str_lens(jb, key_indices):
    """The reference exchange's per-batch byte bound of each string key
    (``exchange.py:227-237``)."""
    out = []
    for i in key_indices:
        c = jb.columns[i]
        if c.is_string:
            from spark_rapids_tpu.expr.eval import StrV as JStrV

            m = int(j_max_len(JStrV(c.offsets, c.chars, c.validity)))
            out.append(max(4, j_cap(max(1, m), 4)))
    return tuple(out)


def _both_ids(jpart, ppart, batches, key_indices, map_index=0):
    rows, jb, pb = batches
    jvals = JB.vals_of_batch(jb)
    pvals = PB.vals_of_batch(pb)
    jlive = JFG.live_of(jb.num_rows, jb.capacity)
    plive = PFG.live_of(pb.num_rows, pb.capacity)
    jsml = _ref_str_lens(jb, key_indices)
    psml = str_max_lens([pvals[i] for i in key_indices])
    assert psml == jsml
    ref = np.asarray(jpart.partition_ids(jvals, jb.schema, jlive, map_index,
                                         str_max_lens=jsml))[:len(rows)]
    got = ppart.partition_ids(pvals, pb.schema, plive, map_index,
                              psml).numpy()[:len(rows)]
    return ref, got


@pytest.mark.parametrize("keys", [[0], [1], [2], [3], [0, 3], [2, 1],
                                  [3, 2, 0]])
@pytest.mark.parametrize("n", [1, 3, 8, 200])
def test_hash_partition_ids_are_the_references(batches, keys, n):
    ref, got = _both_ids(JP.HashPartitioning(keys, n),
                         PP.HashPartitioning(keys, n), batches, keys)
    assert got.dtype == np.int32
    assert (got >= 0).all() and (got < n).all()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,map_index", [(1, 0), (4, 0), (4, 3), (7, 12)])
def test_round_robin_partition_ids_are_the_references(batches, n,
                                                      map_index):
    ref, got = _both_ids(JP.RoundRobinPartitioning(n),
                         PP.RoundRobinPartitioning(n), batches, [],
                         map_index)
    np.testing.assert_array_equal(got, ref)
    ref, got = _both_ids(JP.SinglePartitioning(), PP.SinglePartitioning(),
                         batches, [])
    np.testing.assert_array_equal(got, ref)


#: (key column, ascending, nulls first, bounds): bounds with nulls, NaN,
#: -0.0 and strings that share prefixes
RANGE_CASES = {
    "int_asc": (0, True, None, [[None, -5, 10**6]]),
    "int_desc_nulls_first": (0, False, True, [[None, 7, -3]]),
    "long_asc": (1, True, None, [[-2**61, 0, None]]),
    "long_desc": (1, False, None, [[2**61, 0, -2**61]]),
    "double_nan_zero": (2, True, None, [[-0.0, 1.5, math.nan]]),
    "double_desc_nulls_last": (2, False, False, [[math.nan, 0.0, None]]),
    "double_inf": (2, True, False, [[-math.inf, 0.0, math.inf]]),
    "string_asc": (3, True, None, [[None, "ab", "héllo"]]),
    "string_desc": (3, False, None, [["zz", "abc", ""]]),
}


@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_range_partition_ids_are_the_references(batches, case):
    k, asc, nf, bounds = RANGE_CASES[case]
    jpart = JP.RangePartitioning([k], [JOrder(asc, nf)], 4, bounds)
    ppart = PP.RangePartitioning([k], [SortOrder(asc, nf)], 4, bounds)
    ref, got = _both_ids(jpart, ppart, batches, [k])
    np.testing.assert_array_equal(got, ref)
    assert len(set(got.tolist())) > 1


def test_two_key_range_partition_ids_are_the_references(batches):
    bounds = [["ab", "ab", "zz"], [0.0, math.nan, None]]
    jpart = JP.RangePartitioning([3, 2], [JOrder(True, None),
                                          JOrder(False, None)], 4, bounds)
    ppart = PP.RangePartitioning([3, 2], [SortOrder(True, None),
                                          SortOrder(False, None)], 4, bounds)
    ref, got = _both_ids(jpart, ppart, batches, [3, 2])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("P", [1, 3, 16])
def test_partition_cols_offsets_and_stability(batches, P):
    """Offsets equal the reference's; within each partition the rows keep
    their batch order (the reduce side's row order rests on it); the
    padding rows are excluded."""
    rows, jb, pb = batches
    rng = np.random.default_rng(P)
    pids = rng.integers(0, P, pb.capacity).astype(np.int32)
    jcols, joff = JP.partition_cols(JB.vals_of_batch(jb), jnp.asarray(pids),
                                    jb.num_rows, P)
    pcols, poff = PP.partition_cols(PB.vals_of_batch(pb),
                                    torch.from_numpy(pids), pb.num_rows, P)
    np.testing.assert_array_equal(poff.numpy(), np.asarray(joff))
    assert int(poff[-1]) == len(rows)
    got = PB.batch_from_vals(pcols, pb.schema, len(rows)).to_rows()
    ref = JB.batch_from_vals(jcols, jb.schema, len(rows)).to_rows()
    assert [tuple(map(repr, r)) for r in got] == \
        [tuple(map(repr, r)) for r in ref]
    order = np.argsort(pids[:len(rows)], kind="stable")
    assert [tuple(map(repr, r)) for r in got] == \
        [tuple(map(repr, rows[i])) for i in order]


def _wire_batches(TT, BatchCls, rows, **kw):
    sch = TT.StructType((TT.StructField("i", TT.INT),
                         TT.StructField("l", TT.LONG),
                         TT.StructField("d", TT.DOUBLE),
                         TT.StructField("s", TT.STRING),
                         TT.StructField("b", TT.BOOLEAN)))
    data = {n: [r[j] for r in rows] for j, n in enumerate("ildsb")}
    return BatchCls.from_pydict(data, sch, **kw)


WIRE_ROWS = {
    "empty": [],
    "nulls_utf8": [(1, 2, 0.5, "héllo", True), (None, None, None, None, None),
                   (-7, 2**62, -0.0, "", False), (3, -1, math.nan, "日本語",
                                                  None),
                   (0, 0, math.inf, None, True)],
    "seeded": [r + (i % 3 == 0,) for i, r in enumerate(_rows(9))],
}


@pytest.mark.parametrize("case", sorted(WIRE_ROWS))
def test_serializer_bytes_are_the_references(case):
    rows = WIRE_ROWS[case]
    jb = _wire_batches(JT, JBatch, rows)
    pb = _wire_batches(T, ColumnarBatch, rows, device="cpu")
    ref = JS.serialize_batch(jb, "none")
    assert PS.serialize_batch(pb, "none") == ref
    names = [f.name for f in pb.schema.fields]
    assert PS.serialize_host_columns(pb.host_columns(), names,
                                     len(rows)) == ref


@pytest.mark.parametrize("case", sorted(WIRE_ROWS))
def test_serializer_round_trip(case):
    rows = WIRE_ROWS[case]
    pb = _wire_batches(T, ColumnarBatch, rows, device="cpu")
    back, byte_lens = PS.deserialize_with_byte_lens(
        PS.serialize_batch(pb), "cpu")
    assert back.schema == pb.schema
    assert [tuple(map(repr, r)) for r in back.to_rows()] == \
        [tuple(map(repr, r)) for r in rows]
    assert byte_lens == (sum(len(r[3].encode()) for r in rows
                             if r[3] is not None),)
    # the reference reads the port's bytes
    jback = JS.deserialize_batch(PS.serialize_batch(pb))
    assert [tuple(map(repr, r)) for r in jback.to_rows()] == \
        [tuple(map(repr, r)) for r in rows]


def test_codecs():
    pb = _wire_batches(T, ColumnarBatch, WIRE_ROWS["nulls_utf8"],
                       device="cpu")
    with pytest.raises(NotImplementedError, match="native host decoders"):
        PS.serialize_batch(pb, "lz4")
    try:
        import zstandard  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            PS.serialize_batch(pb, "zstd")
        return
    data = PS.serialize_batch(pb, "zstd")
    assert data[4] == 1
    assert [tuple(map(repr, r)) for r in
            PS.deserialize_batch(data, "cpu").to_rows()] == \
        [tuple(map(repr, r)) for r in WIRE_ROWS["nulls_utf8"]]
