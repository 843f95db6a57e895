"""Nondeterministic and metadata expressions in the port
(``expr/nondet.py``, ``expr/eval.py``'s inline hash,
``exec/basic.TpuProjectExec``'s context path) against the reference.

rand is counter-based (splitmix64 over seed, partition and row), so its
doubles, the ids, the partition ids, the file names and the hashes are
compared bit for bit: through both sessions on the same seeded rows, over
``from_rows(..., num_partitions=3)`` and over a three-file parquet
directory, and through both CPU engines.
"""
import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr import nondet as JN
from spark_rapids_tpu.sql import session as JS
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import basic as XB
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import eval as EV
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.expr import nondet as PN
from spark_rapids_tpu_torch.sql import session as PS
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

REF = dict(T=JT, E=JE, A=JA, S=lambda st: JSession(st))
PORT = dict(T=T, E=PE, A=PA, S=lambda st: PSession(st, device="cpu"))
OFF = {"spark.rapids.tpu.sql.enabled": False}
PLAIN = {"spark.rapids.tpu.sql.format.parquet.dictStrings.enabled": False}

M64 = (1 << 64) - 1
EXTREMES = (0, 1, 42, (1 << 63) - 1, 1 << 63, M64, -1, -(1 << 63),
            0x9E3779B97F4A7C15)


def _schema(m):
    T_ = m["T"]
    return T_.StructType((T_.StructField("k", T_.INT),
                          T_.StructField("v", T_.LONG),
                          T_.StructField("d", T_.DOUBLE),
                          T_.StructField("s", T_.STRING)))


def _rows(n=300):
    rng = np.random.default_rng(5)
    words = ["", "a", "héllo", "日本語", "xyzéé", "spark",
             "0123456789abcdef", "\U0001f600 smile"]
    out = []
    for i in range(n):
        out.append((
            int(rng.integers(0, 9)),
            None if i % 11 == 0 else int(rng.integers(-2**62, 2**62)),
            None if i % 13 == 0 else float(rng.choice(
                [0.0, -0.0, float("nan"), 1.5, -2.25e300,
                 float(rng.standard_normal())])),
            None if i % 7 == 0 else words[int(rng.integers(0, len(words)))],
        ))
    return out


def _df(m, sess, parts=3):
    return sess.from_rows(_rows(), _schema(m), num_partitions=parts)


def _ctx_select(m, sess):
    E = m["E"]
    return _df(m, sess).select(
        E.col("k"),
        E.Alias(E.SparkPartitionID(), "pid"),
        E.Alias(E.MonotonicallyIncreasingID(), "mid"),
        E.Alias(E.Rand(7), "r7"),
        E.Alias(E.Add(E.Rand(7), E.Literal.of(1.0)), "r7b"),
        E.Alias(E.Rand(-3), "rneg"),
        E.Alias(E.InputFileName(), "f"),
        E.Alias(E.Murmur3Hash((E.col("k"), E.col("v"), E.col("d"))), "h"),
        E.Alias(E.Murmur3Hash((E.col("s"), E.col("k"))), "hs"))


def _same(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float) and math.isnan(x):
                assert isinstance(y, float) and math.isnan(y)
            else:
                assert type(x) is type(y) and x == y, (ra, rb)


@pytest.mark.parametrize("seed", EXTREMES)
@pytest.mark.parametrize("pid", (0, 5, (1 << 63) + 3, M64))
def test_rand_double_torch_is_the_references(seed, pid):
    import jax.numpy as jnp
    import torch

    rows = np.array([0, 1, 2, 3, (1 << 62) + 7, (1 << 63) - 1, -(1 << 63),
                     -1, -12345] + list(range(1000, 1064)), np.int64)
    got = PN.rand_double_torch(seed, pid, torch.from_numpy(rows)).numpy()
    ref = np.asarray(JN.rand_double_jax(seed, pid, jnp.asarray(rows)))
    assert got.view(np.int64).tolist() == ref.view(np.int64).tolist()
    assert got.tolist() == [PN.rand_double_scalar(seed, pid, int(r))
                            for r in rows]
    assert ((got >= 0) & (got < 1)).all()


def test_context_expressions_through_both_sessions():
    ref = _ctx_select(REF, REF["S"]({})).collect()
    got = _ctx_select(PORT, PORT["S"]({})).collect()
    _same(got, ref)
    assert {r[1] for r in got} == {0, 1, 2}
    mids = [r[2] for r in got]
    assert len(set(mids)) == len(mids)
    assert all(r[4] == r[3] + 1.0 for r in got)  # rand(7) shared
    assert all(r[6] == "" for r in got)  # no file scan below


def test_context_expressions_through_the_cpu_engines():
    """The CPU engines agree with each other, and with the device on
    every value but one kept divergence of both packages (ROADMAP.md
    §C): the device hash canonicalizes -0.0 to 0.0, the CPU engine's
    scalar murmur3 hashes -0.0's own bits."""
    cpu = _ctx_select(PORT, PORT["S"](OFF)).collect()
    _same(cpu, _ctx_select(REF, REF["S"](OFF)).collect())
    dev = _ctx_select(PORT, PORT["S"]({})).collect()
    _same([r[:7] + r[8:] for r in cpu], [r[:7] + r[8:] for r in dev])
    negz = [d is not None and d == 0.0 and math.copysign(1, d) < 0
            for _, _, d, _ in _rows()]
    # from_rows keeps the row order within and across partitions
    assert [c[7] != g[7] for c, g in zip(cpu, dev)] == negz
    assert any(negz)


def test_context_expressions_over_parquet_files(tmp_path):
    rows = _rows()
    d = tmp_path / "t"
    d.mkdir()
    for i in range(3):
        part = rows[i * 100:(i + 1) * 100]
        pq.write_table(pa.table({
            "k": pa.array([r[0] for r in part], pa.int32()),
            "v": pa.array([r[1] for r in part], pa.int64()),
            "s": pa.array([r[3] for r in part], pa.string())}),
            str(d / f"part-{i}.parquet"), row_group_size=40)

    def q(m, sess):
        E = m["E"]
        return sess.read.parquet(str(d)).select(
            E.col("k"), E.Alias(E.InputFileName(), "f"),
            E.Alias(E.SparkPartitionID(), "pid"),
            E.Alias(E.MonotonicallyIncreasingID(), "mid"),
            E.Alias(E.Rand(11), "r"),
            E.Alias(E.Murmur3Hash((E.col("s"), E.col("v"))), "h"))

    # the reference's hash of a dictionary-encoded string column raises
    # (its murmur3 reads a DictV's data plane; ROADMAP.md §C): its side
    # reads the strings plain, the port's both ways
    def fresh(m, settings):
        # the scanners are cached per path, with their conf
        for mod in (JS, PS):
            mod._SCANNER_CACHE.clear()
        return m["S"](settings)

    with pytest.raises(AttributeError):
        q(REF, fresh(REF, {})).collect()
    want = q(REF, fresh(REF, PLAIN)).collect()
    got = q(PORT, fresh(PORT, {})).collect()
    _same(got, want)
    _same(q(PORT, fresh(PORT, PLAIN)).collect(), want)
    assert {os.path.basename(r[1]) for r in got} == {
        f"part-{i}.parquet" for i in range(3)}
    _same(q(PORT, fresh(PORT, OFF)).collect(), got)


FIXED = (("b", "BOOLEAN", lambda r: bool(r % 2)),
         ("i8", "BYTE", lambda r: r % 256 - 128),
         ("i16", "SHORT", lambda r: r * 37 % 65536 - 32768),
         ("i32", "INT", lambda r: (r * 2654435761) % 2**32 - 2**31),
         ("i64", "LONG", lambda r: (r * 0x9E3779B97F4A7C15) % 2**64 - 2**63),
         ("f32", "FLOAT", lambda r: [0.0, -0.0, float("nan"), 1.25,
                                     -3.0e38, float(r) / 7][r % 6]),
         ("f64", "DOUBLE", lambda r: [0.0, -0.0, float("nan"), float("inf"),
                                      -1e300, r / 3.0][r % 6]),
         ("dt", "DATE", lambda r: r * 97 - 20000),
         ("ts", "TIMESTAMP", lambda r: r * 86_400_000_123 - 2**50))


@pytest.mark.parametrize("name", [f[0] for f in FIXED])
def test_hash_of_every_fixed_width_type(name):
    """hash() over a fixed-width column lowers inline (no context path)
    and equals the reference's bit for bit, NULLs included."""
    _, tname, gen = next(f for f in FIXED if f[0] == name)
    rows = [(i, None if i % 9 == 0 else gen(i)) for i in range(200)]

    def q(m):
        T_, E = m["T"], m["E"]
        schema = T_.StructType((T_.StructField("k", T_.INT),
                                T_.StructField("x", getattr(T_, tname))))
        sess = m["S"]({})
        return sess.from_rows(rows, schema, num_partitions=2).select(
            E.Alias(E.Murmur3Hash((E.col("x"),)), "h"),
            E.Alias(E.Murmur3Hash((E.col("x"), E.col("k")), seed=7), "h2"))

    got = q(PORT).collect()
    assert got == q(REF).collect()
    schema = T.StructType((T.StructField("x", getattr(T, tname)),))
    assert EV.tpu_supports(PE.Murmur3Hash((PE.col("x"),)), schema) == (
        True, "")


def test_hash_of_strings_with_nulls_and_non_ascii():
    rows = [(s,) for s in ["", None, "a", "ab", "abc", "abcd", "abcde",
                           "héllo wörld", "日本語テキスト", None,
                           "\U0001f600\U0001f601", "x" * 70]]

    def q(m):
        T_, E = m["T"], m["E"]
        sess = m["S"]({})
        schema = T_.StructType((T_.StructField("s", T_.STRING),))
        return sess.from_rows(rows, schema).select(
            E.col("s"), E.Alias(E.Murmur3Hash((E.col("s"),)), "h"))

    got = q(PORT).collect()
    assert got == q(REF).collect()
    assert [r[1] for r in got] == [PN.murmur3_scalar(r[0], T.STRING, 42)
                                   for r in rows]


def test_shared_rand_columns_and_the_project_does_not_fuse():
    sess = PORT["S"]({})
    E = PE
    df = (_df(PORT, sess)
          .where(E.GreaterThan(E.col("k"), E.Literal.of(2)))
          .select(E.col("k"), E.Alias(E.Rand(5), "a"),
                  E.Alias(E.Multiply(E.Rand(5), E.Literal.of(2.0)), "b")))
    rows = df.collect()
    plan = sess.last_executed_plan.tpu_child
    assert isinstance(plan, XB.TpuProjectExec) and not plan.fusable
    assert plan._ctx_exprs == (PE.Rand(5),)
    assert isinstance(plan.children[0], XB.TpuFilterExec)
    assert all(r[2] == r[1] * 2.0 for r in rows)
    ref = (_df(REF, REF["S"]({}))
           .where(JE.GreaterThan(JE.col("k"), JE.Literal.of(2)))
           .select(JE.col("k"), JE.Alias(JE.Rand(5), "a"),
                   JE.Alias(JE.Multiply(JE.Rand(5), JE.Literal.of(2.0)),
                            "b"))).collect()
    _same(rows, ref)


def test_context_expression_outside_a_project_falls_back():
    """A filter on rand() is tagged off (the reference's reason) and runs
    on the CPU engine; aggregating a projected rand runs on the device."""
    def q(m, sess):
        E, A = m["E"], m["A"]
        return (_df(m, sess)
                .select(E.col("k"), E.Alias(E.Rand(42), "r"))
                .where(E.LessThan(E.col("r"), E.Literal.of(0.25)))
                .group_by("k").agg(A.agg(A.Count(None), "n"),
                                   A.agg(A.Sum(E.col("r")), "sr")))

    got = sorted(q(PORT, PORT["S"]({})).collect())
    want = sorted(q(REF, REF["S"]({})).collect())
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for g, w in zip(got, want):
        assert math.isclose(g[2], w[2], rel_tol=1e-12)

    def qf(m):
        E = m["E"]
        sess = m["S"]({})
        df = _df(m, sess).where(E.LessThan(E.Rand(3), E.Literal.of(0.5)))
        return df.explain()

    assert "only run on TPU inside a projection" in qf(PORT)
    port_lines = qf(PORT).splitlines()
    ref_lines = qf(REF).split("== Static Plan Analysis ==")[0].splitlines()
    assert [ln for ln in port_lines if ln.strip()] == [
        ln for ln in ref_lines if ln.strip()]
