"""The string slice end to end: the bench's string query (Q9, bench.py
``shape_string``) and the native-UDF word count (Q10) as exec trees in the
port, on ``device="cpu"``, against the same trees in the reference, at
2^12 rows.

Q9: scan -> filter contains(s, "X") -> project (upper(s)[1:6], length(s),
v) -> grand aggregate; the reference runs it over the expanded string
column and over the bench's own dictionary-encoded one (same values), and
both must give the port's row, which must also equal the pool oracle.
Q10: scan -> project (k, string_word_count(s)) -> aggregate by k, over
the chip check's word-count text, under AUTO and forced PALLAS; rows
equal the reference's and the generator's word counts.
"""
import numpy as np
import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

import bench
import chip_smoke
from spark_rapids_tpu import exec as JX
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.batch import schema_of as jschema_of
from spark_rapids_tpu.columnar.column import DeviceColumn as JColumn
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.udf import native as RN
from spark_rapids_tpu_torch import exec as X
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (ColumnarBatch,
                                             batch_from_host_arrays, schema_of)
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.udf import string_word_count

N = 1 << 12


def _port_batch(jb, schema):
    """The port's batch over a reference batch's planes."""
    datas, valids = [], []
    for c in jb.columns:
        if c.is_string:
            datas.append((np.asarray(c.offsets), np.asarray(c.chars)))
        else:
            datas.append(np.asarray(c.data))
        valids.append(np.asarray(c.validity))
    return batch_from_host_arrays(schema, datas, valids, jb.num_rows,
                                  jb.capacity, device="cpu")


def _string_col(offsets, chars, valid, n):
    """A reference string column from numpy planes, padded to its
    capacity bucket as the reference's own upload pads."""
    from spark_rapids_tpu.columnar.column import choose_capacity

    cap = choose_capacity(n)
    off = np.full(cap + 1, offsets[-1], np.int32)
    off[:n + 1] = offsets
    v = np.zeros(cap, bool)
    v[:n] = valid
    pool = np.zeros(choose_capacity(max(int(offsets[-1]), 1)), np.uint8)
    pool[:chars.size] = chars
    return JColumn(JT.STRING, n, None, jnp.asarray(v), jnp.asarray(off),
                   jnp.asarray(pool))


def _fixed_col(dtype, data, n):
    from spark_rapids_tpu.columnar.column import choose_capacity

    cap = choose_capacity(n)
    d = np.zeros(cap, data.dtype)
    d[:n] = data
    return JColumn(dtype, n, jnp.asarray(d), jnp.asarray(np.arange(cap) < n))


# ---------------------------------------------------------------------------
# Q9
# ---------------------------------------------------------------------------
def _q9(M, E_, A_, conf, batches, schema):
    col, lit = E_.col, E_.lit
    scan = M.InMemoryScanExec(conf, [batches], schema)
    filt = M.TpuFilterExec(conf, E_.Contains(col("s"), lit("X")), scan)
    proj = M.TpuProjectExec(conf, [
        E_.Alias(E_.Substring(E_.Upper(col("s")), lit(1), lit(6)), "u"),
        E_.Alias(E_.Length(col("s")), "ln"), col("v")], filt)
    agg = M.TpuHashAggregateExec(conf, [], [
        A_.agg(A_.Sum(E_.Length(col("u"))), "ul"),
        A_.agg(A_.Sum(col("ln")), "l"), A_.agg(A_.Count(None), "c"),
        A_.agg(A_.Sum(col("v")), "sv")], proj)
    return proj, agg


def _q9_inputs():
    idx, v, offsets, chars = chip_smoke.string_pool_rows(np, N)
    jschema = jschema_of(s=JT.STRING, v=JT.LONG)
    jb = JBatch([_string_col(offsets, chars, np.ones(N, bool), N),
                 _fixed_col(JT.LONG, v, N)], jschema, N)
    return idx, v, jb


def test_q9_matches_reference_and_pool_oracle():
    idx, v, jb = _q9_inputs()
    pschema = schema_of(s=T.STRING, v=T.LONG)
    pb = _port_batch(jb, pschema)
    conf = {}
    ref = _q9(JX, JE, JA, JConf(conf), [jb], jb.schema)[1].collect()
    # the bench's own input: the same values dictionary-encoded
    dcol = bench._dev_string_col(chip_smoke.STRING_POOL, idx, N, JT.STRING)
    jdb = JBatch([dcol, jb.columns[1]], jb.schema, N)
    ref_dict = _q9(JX, JE, JA, JConf(conf), [jdb], jb.schema)[1].collect()
    _, agg = _q9(X, E, A, RapidsConf(conf), [pb], pschema)
    got = X.ColumnarToRowExec(agg.conf, agg).collect()
    assert got == ref == ref_dict
    # the oracle: per pool entry, its values times its row count
    counts = np.bincount(idx, minlength=len(chip_smoke.STRING_POOL))
    hit = np.array(["X" in p for p in chip_smoke.STRING_POOL])
    ul = sum(min(6, len(p)) * c for p, c, h in
             zip(chip_smoke.STRING_POOL, counts, hit) if h)
    ln = sum(len(p) * c for p, c, h in
             zip(chip_smoke.STRING_POOL, counts, hit) if h)
    mask = hit[idx]
    assert got == [(ul, ln, int(mask.sum()), int(v[mask].sum()))]


def test_q9_in_the_bench_layout_matches_the_reference():
    """Q9 over the bench's own dictionary column in both packages
    (``bench._dev_string_col`` and the chip check's ``pool_dict_column``:
    the same codes, dictionary and metadata), rows equal; the filtered
    projection keeps ``u`` dictionary-encoded over the 14 entries."""
    idx, v, jb = _q9_inputs()
    dcol = bench._dev_string_col(chip_smoke.STRING_POOL, idx, N, JT.STRING)
    pcol = chip_smoke.pool_dict_column(np, "cpu", chip_smoke.STRING_POOL,
                                       idx)
    jd, pd = dcol.dictv, pcol.dictv
    for part in ("codes", "validity"):
        np.testing.assert_array_equal(getattr(pd, part).numpy(),
                                      np.asarray(getattr(jd, part)))
    for part in ("offsets", "chars"):
        np.testing.assert_array_equal(getattr(pd.dictionary, part).numpy(),
                                      np.asarray(getattr(jd.dictionary,
                                                         part)))
    assert (pd.mat_cap, pd.max_len, pd.unique, pd.dict_size) == (
        jd.mat_cap, jd.max_len, jd.unique, 14)
    pschema = schema_of(s=T.STRING, v=T.LONG)
    pb = ColumnarBatch([pcol, _port_batch(jb, pschema).columns[1]],
                       pschema, N)
    jdb = JBatch([dcol, jb.columns[1]], jb.schema, N)
    jproj, jagg = _q9(JX, JE, JA, JConf({}), [jdb], jb.schema)
    pproj, pagg = _q9(X, E, A, RapidsConf({}), [pb], pschema)
    assert X.ColumnarToRowExec(pagg.conf, pagg).collect() == jagg.collect()
    [out] = list(pproj.execute_partition(0))
    assert out.columns[0].is_dict and out.columns[0].dictv.dict_size == 14
    assert X.ColumnarToRowExec(pproj.conf, pproj).collect() == \
        jproj.collect()


def test_q9_projection_emits_compacted_strings_like_reference():
    """The filtered projection on its own: rows compact once at the end
    of the fused chain, string columns through the string gather."""
    _, _, jb = _q9_inputs()
    pschema = schema_of(s=T.STRING, v=T.LONG)
    pb = _port_batch(jb, pschema)
    jproj = _q9(JX, JE, JA, JConf({}), [jb], jb.schema)[0]
    pproj = _q9(X, E, A, RapidsConf({}), [pb], pschema)[0]
    [jout] = list(jproj.execute_partition(0))
    [pout] = list(pproj.execute_partition(0))
    assert pout.num_rows == jout.num_rows
    for jc, pc in zip(jout.columns, pout.columns):
        if jc.is_string:
            for part in ("offsets", "chars", "validity"):
                np.testing.assert_array_equal(
                    getattr(pc, part).numpy(), np.asarray(getattr(jc, part)))
    assert X.ColumnarToRowExec(pproj.conf, pproj).collect() == \
        jproj.collect()


# ---------------------------------------------------------------------------
# Q10
# ---------------------------------------------------------------------------
def _q10(M, E_, A_, udf, conf, batches, schema):
    col = E_.col
    scan = M.InMemoryScanExec(conf, [batches], schema)
    proj = M.TpuProjectExec(conf, [col("k"),
                                   E_.Alias(udf(col("s")), "wc")], scan)
    return M.TpuHashAggregateExec(conf, [col("k")], [
        A_.agg(A_.Sum(col("wc")), "sw"), A_.agg(A_.Count(col("wc")), "cw"),
        A_.agg(A_.Count(None), "c")], proj)


def _q10_inputs(nbatches=4):
    rng = np.random.default_rng(10)
    per = N // nbatches
    jschema = jschema_of(k=JT.INT, s=JT.STRING)
    jbs, ks, words, valids = [], [], [], []
    for _ in range(nbatches):
        k = rng.integers(0, 64, per).astype(np.int32)
        off, chars, valid, w = chip_smoke.word_count_text(np, rng, per)
        jbs.append(JBatch([_fixed_col(JT.INT, k, per),
                           _string_col(off, chars, valid, per)], jschema,
                          per))
        ks.append(k)
        words.append(w)
        valids.append(valid)
    return jbs, np.concatenate(ks), np.concatenate(words), \
        np.concatenate(valids)


@pytest.mark.parametrize("strategy", ["AUTO", "PALLAS"])
def test_q10_word_count_matches_reference_and_generator(strategy):
    jbs, k, words, valid = _q10_inputs()
    pschema = schema_of(k=T.INT, s=T.STRING)
    pbs = [_port_batch(b, pschema) for b in jbs]
    conf = {"spark.rapids.tpu.sql.agg.strategy": strategy}
    ref = _q10(JX, JE, JA, RN.string_word_count, JConf(conf), jbs,
               jbs[0].schema).collect()
    agg = _q10(X, E, A, string_word_count, RapidsConf(conf), pbs, pschema)
    got = X.ColumnarToRowExec(agg.conf, agg).collect()
    assert sorted(got) == sorted(ref)
    sw = np.bincount(k, weights=np.where(valid, words, 0), minlength=64)
    cw = np.bincount(k[valid], minlength=64)
    c = np.bincount(k, minlength=64)
    assert sorted(got) == [(g, int(sw[g]), int(cw[g]), int(c[g]))
                           for g in range(64) if c[g]]


# ---------------------------------------------------------------------------
# what the slice leaves out raises
# ---------------------------------------------------------------------------
def test_string_layers_not_ported_raise():
    """What still refuses strings, as the reference does: the sync-free
    padded concat (fixed-width only) and first/last over strings at the
    exec (the type matrix keeps them on the CPU). Neither names a ROADMAP
    item: nothing is left to port there."""
    conf = RapidsConf({})
    schema = schema_of(s=T.STRING, v=T.LONG)
    b = ColumnarBatch.from_pydict({"s": ["a", None, "b"], "v": [1, 2, 3]},
                                  schema, device="cpu")
    scan = X.InMemoryScanExec(conf, [[b]], schema)
    for fn in (A.First, A.Last):
        with pytest.raises(NotImplementedError,
                           match="type matrix") as e:
            X.TpuHashAggregateExec(conf, [E.col("v")],
                                   [A.agg(fn(E.col("s")), "m")], scan)
        assert "ROADMAP" not in str(e.value)
    from spark_rapids_tpu_torch.exec.base import vals_of_batch
    from spark_rapids_tpu_torch.ops import concat as C

    vals = vals_of_batch(b)
    with pytest.raises(NotImplementedError,
                       match="fixed-width columns only") as e:
        C.concat_padded_cols([vals, vals], [3, 3], 256)
    assert "ROADMAP" not in str(e.value)


@pytest.mark.parametrize("grouped", [True, False])
def test_count_of_a_string_column(grouped):
    """count(s) counts the non-null rows. Held against a plain oracle: the
    reference's exec layer cannot take a string aggregate input (its
    reductions read ``.data`` of the string value; ROADMAP.md, queue C)."""
    vals = ["a", None, "", "é", None, "xyz"]
    keys = [1, 1, 2, 2, 3, 3]
    ps = schema_of(k=T.INT, s=T.STRING)
    pb = ColumnarBatch.from_pydict({"k": keys, "s": vals}, ps, device="cpu")
    conf = RapidsConf({})
    agg = X.TpuHashAggregateExec(
        conf, [E.col("k")] if grouped else [],
        [A.agg(A.Count(E.col("s")), "n"), A.agg(A.Count(None), "c")],
        X.InMemoryScanExec(conf, [[pb]], ps))
    got = sorted(X.ColumnarToRowExec(conf, agg).collect())
    assert got == ([(1, 1, 2), (2, 2, 2), (3, 1, 2)] if grouped
                   else [(4, 6)])
