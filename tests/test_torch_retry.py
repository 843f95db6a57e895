"""OOM retry and split-and-retry in the port (``memory/retry.py``,
``columnar/split.py``, ``faults.py``) against the reference, the
scenarios of the reference's ``tests/test_retry.py`` run on both
packages: the same fault spec and seed give the same fault arrivals,
the same typed-error fields (op, attempts, split depth) and the same
rows, through an aggregate, a sort, a join probe and a project; the
split pieces equal the reference's plane for plane; and an error that
is not a device OOM is never retried.

Both aggregates also consult the ``oom`` channel before their fused
whole-plan route (``exec/aggregate.py``), whose fallback
``tests/test_torch_fused_agg.py`` holds; here both sides run with
``sql.agg.fusedPlan=OFF``, so that the per-batch harness counts the same
arrivals in both.
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import faults as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import dict_column_from_pylist as j_dict
from spark_rapids_tpu.columnar import split_batch as j_split
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.memory import retry as JR
from spark_rapids_tpu.memory.catalog import BufferCatalog as JCat
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import faults as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.columnar import dict_column_from_pylist as p_dict
from spark_rapids_tpu_torch.columnar import split_batch as p_split
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.memory import retry as PR
from spark_rapids_tpu_torch.memory.catalog import BufferCatalog as PCat
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

NO_BACKOFF = {"spark.rapids.tpu.memory.oomRetry.backoffMs": 0}
REF = dict(T=JT, E=JE, A=JA, F=JF, R=JR, S=lambda st: JSession(
    {**st, "spark.rapids.tpu.sql.agg.fusedPlan": "OFF"}))
PORT = dict(T=T, E=PE, A=PA, F=PF, R=PR,
            S=lambda st: PSession(
                {**st, "spark.rapids.tpu.sql.agg.fusedPlan": "OFF"},
                device="cpu"))


@pytest.fixture(autouse=True)
def _uninstall():
    PF.uninstall()
    JF.uninstall()
    yield
    PF.uninstall()
    JF.uninstall()
    PCat.reset()
    JCat.reset()


def _data(n=1000):
    return {"k": [i % 7 if i % 11 else None for i in range(n)],
            "a": [(i * 13) % 400 - 200 for i in range(n)],
            "b": [None if i % 9 == 0 else i * 5 for i in range(n)],
            "s": [None if i % 5 == 0 else ("x" * (i % 4)) + str(i % 37)
                  for i in range(n)]}


def _schema(m):
    T_ = m["T"]
    return T_.StructType((T_.StructField("k", T_.INT),
                          T_.StructField("a", T_.LONG),
                          T_.StructField("b", T_.LONG),
                          T_.StructField("s", T_.STRING)))


def _queries(m, sess):
    E, A, T_ = m["E"], m["A"], m["T"]
    left = sess.create_dataframe(_data(), _schema(m))
    right = sess.create_dataframe(
        {"k": [i % 7 for i in range(21)], "w": [i * 100 for i in range(21)]},
        T_.StructType((T_.StructField("k", T_.INT),
                       T_.StructField("w", T_.LONG))))
    return {
        "TpuHashAggregateExec": left.group_by("k").agg(
            A.agg(A.Sum(E.col("a")), "sa"), A.agg(A.Min(E.col("a")), "mn"),
            A.agg(A.Max(E.col("b")), "mx"), A.agg(A.Count(E.col("b")), "cb"),
            A.agg(A.Count(None), "cs")),
        "TpuSortExec": left.order_by("b", "k", "s"),
        # duplicate build keys: the general join, probed per batch
        "TpuShuffledHashJoinExec": left.join(right, "k"),
        "TpuProjectExec": left.select(
            E.col("k"), E.Alias(E.Add(E.col("b"), E.Literal.of(1)), "b1"),
            E.col("s")),
    }


def _run(m, op, spec, extra=None):
    sess = m["S"]({"spark.rapids.tpu.test.faults.oom": spec, **NO_BACKOFF,
                   **(extra or {})})
    rows = _queries(m, sess)[op].collect()
    return rows, m["F"].active().fired()


OPS = ("TpuHashAggregateExec", "TpuSortExec", "TpuShuffledHashJoinExec",
       "TpuProjectExec")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("spec", (">256", "@1", "%2", "?5"))
def test_same_spec_same_arrivals_and_rows(op, spec):
    extra = {"spark.rapids.tpu.test.faults.seed": 7}
    PR.reset_stats()
    got, pf = _run(PORT, op, op + spec, extra)
    want, jf = _run(REF, op, op + spec, extra)
    assert pf == jf, (pf, jf)
    # '%2' and '?5' count arrivals at the site, which a one-batch plan
    # may not reach twice; the first two specs always fire
    assert pf or spec in ("%2", "?5")
    if op == "TpuSortExec":
        assert got == want
    else:
        assert sorted(got, key=repr) == sorted(want, key=repr)
    st = PR.stats()[op]
    assert st["retries"] == len(pf)
    cap_spec = spec == ">256"
    # 1000 rows (cap 1024) fail down to 250-row pieces (cap 256): depth 2
    assert st["max_depth"] == (2 if cap_spec else 0)
    plain = PORT["S"]({})
    assert sorted(_queries(PORT, plain)[op].collect(), key=repr) == \
        sorted(got, key=repr)


@pytest.mark.parametrize("op", OPS)
def test_exhaustion_raises_the_same_typed_error(op):
    errs = []
    for m in (PORT, REF):
        with pytest.raises(m["R"].TpuSplitAndRetryOOM) as ei:
            _run(m, op, op, {
                "spark.rapids.tpu.memory.oomRetry.maxSplitDepth": 2})
        e = ei.value
        errs.append((e.op, e.attempts, e.split_depth))
        assert "RESOURCE_EXHAUSTED" in str(e)
        m["F"].uninstall()
    # two attempts at each of depths 0, 1 and 2 of the first piece
    assert errs[0] == errs[1] == (op, 6, 2)


def test_merge_exhaustion_is_a_typed_retry_oom():
    errs = []
    for m in (PORT, REF):
        with pytest.raises(m["R"].TpuRetryOOM) as ei:
            _run(m, "TpuHashAggregateExec", "TpuHashAggregateExec.merge")
        errs.append((ei.value.op, ei.value.attempts))
        m["F"].uninstall()
    assert errs[0] == errs[1] == ("TpuHashAggregateExec.merge", 2)


def test_retry_disabled_is_a_plain_call():
    """With oomRetry off the harness is a plain call: it consults no
    fault spec, in both packages."""
    out = []
    for m in (PORT, REF):
        rows, fired = _run(m, "TpuSortExec", "TpuSortExec",
                           {"spark.rapids.tpu.memory.oomRetry.enabled":
                            False})
        assert fired == []
        out.append(rows)
        m["F"].uninstall()
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# split_batch against the reference's
# ---------------------------------------------------------------------------
def _torture(TT, Batch, dict_of, n, **kw):
    schema = TT.StructType((TT.StructField("i", TT.INT),
                            TT.StructField("d", TT.DOUBLE),
                            TT.StructField("s", TT.STRING),
                            TT.StructField("nul", TT.LONG)))
    data = {"i": [None if k % 7 == 0 else (k * 3) % 251 - 100
                  for k in range(n)],
            "d": [None if k % 11 == 0 else k / 3.0 - 5.0 for k in range(n)],
            "s": [None if k % 5 == 0 else ("é" * (k % 4)) + str(k)
                  for k in range(n)],
            "nul": [None] * n}
    b = Batch.from_pydict(data, schema, **kw)
    dc = dict_of([None if k % 3 == 0 else f"d{k % 6}" for k in range(n)],
                 **kw)
    full = TT.StructType(tuple(schema.fields)
                         + (TT.StructField("dict", TT.STRING),))
    return Batch(list(b.columns) + [dc], full, n)


def _planes(col, np_of):
    if col.is_dict:
        d = col.dictv
        return [np_of(d.codes), np_of(d.validity),
                np_of(d.dictionary.offsets), np_of(d.dictionary.chars),
                (d.mat_cap, d.max_len, d.unique)]
    if col.is_string:
        return [np_of(col.offsets), np_of(col.chars), np_of(col.validity)]
    return [np_of(col.data), np_of(col.validity)]


def _rec(split, b, depth):
    if depth == 0 or b.num_rows < 2:
        return [b]
    lo, hi = split(b)
    return _rec(split, lo, depth - 1) + _rec(split, hi, depth - 1)


@pytest.mark.parametrize("n", (2, 5, 7, 1000))
@pytest.mark.parametrize("depth", (1, 2, 3))
def test_split_pieces_are_the_references(n, depth):
    pb = _torture(T, PBatch, p_dict, n, device="cpu")
    jb = _torture(JT, JBatch, j_dict, n)
    ppieces = _rec(p_split, pb, depth)
    jpieces = _rec(j_split, jb, depth)
    assert [p.num_rows for p in ppieces] == [j.num_rows for j in jpieces]
    rows = []
    for p, j in zip(ppieces, jpieces):
        assert p.capacity == j.capacity
        for pc, jc in zip(p.columns, j.columns):
            pp = _planes(pc, lambda t: t.numpy())
            jp = _planes(jc, np.asarray)
            for a, b in zip(pp, jp):
                if isinstance(a, tuple):
                    assert a == b
                else:
                    assert a.tolist() == b.tolist()
        assert p.to_rows() == j.to_rows()
        rows += p.to_rows()
    assert rows == pb.to_rows()
    back = PR.concat_batches(RapidsConf({}), ppieces)
    assert back.to_rows() == pb.to_rows()


def test_split_floor_raises():
    b = PBatch.from_pydict({"a": [1]}, T.StructType(
        (T.StructField("a", T.INT),)), device="cpu")
    with pytest.raises(ValueError, match="cannot split a 1-row batch"):
        p_split(b)


# ---------------------------------------------------------------------------
# what is and is not a device OOM
# ---------------------------------------------------------------------------
NOT_OOM = {
    "value_error": ValueError("bad"),
    "illegal_address": RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
    "oom_text_only": RuntimeError("CUDA out of memory (a message only)"),
    "build": RuntimeError("nvcc failed: error: identifier undefined"),
    "launch": RuntimeError("srt_probe_ranges launch failed: too many "
                           "resources requested"),
}


@pytest.mark.parametrize("case", sorted(NOT_OOM))
def test_an_error_that_is_not_a_device_oom_is_never_retried(case):
    calls = []
    err = NOT_OOM[case]

    def attempt(b):
        calls.append(b.num_rows)
        raise err

    b = PBatch.from_pydict({"a": list(range(100))}, T.StructType(
        (T.StructField("a", T.INT),)), device="cpu")
    with pytest.raises(type(err)) as ei:
        PR.with_oom_retry("op", attempt, b, RapidsConf(NO_BACKOFF))
    assert ei.value is err and calls == [100]
    assert not PR.is_device_oom(err)


def test_device_ooms_are_recovered():
    torch_oom = getattr(torch, "OutOfMemoryError",
                        torch.cuda.OutOfMemoryError)
    assert PR.is_device_oom(torch_oom("CUDA out of memory"))
    assert PR.is_device_oom(PF.InjectedOOM("x"))
    assert PR.is_device_oom(PR.TpuOutOfDeviceMemory("named"))
    assert not PR.is_device_oom(PR.TpuSplitAndRetryOOM("final"))
    b = PBatch.from_pydict({"a": list(range(100))}, T.StructType(
        (T.StructField("a", T.INT),)), device="cpu")
    seen = []

    def attempt(piece):
        seen.append(piece.num_rows)
        if piece.num_rows > 30:
            raise torch_oom("CUDA out of memory. Tried to allocate 2 GiB")
        return piece

    out = PR.with_oom_retry("op", attempt, b, RapidsConf(NO_BACKOFF),
                            combine="list")
    assert [p.num_rows for p in out] == [25, 25, 25, 25]
    assert seen == [100, 100, 50, 50, 25, 25, 50, 50, 25, 25]
    assert sum((p.to_rows() for p in out), []) == b.to_rows()


def test_named_oom_wraps_only_device_ooms():
    with pytest.raises(PR.TpuOutOfDeviceMemory, match="in stage_x"):
        with PR.named_oom("stage_x"):
            raise PF.InjectedOOM("RESOURCE_EXHAUSTED")
    with pytest.raises(KeyError):
        with PR.named_oom("stage_x"):
            raise KeyError("k")


def test_the_failed_attempts_frames_are_released_before_the_retry():
    """The retry runs after the handler has exited: the failed attempt's
    tensors are already unreferenced when the next attempt starts."""
    import gc
    import weakref

    b = PBatch.from_pydict({"a": list(range(64))}, T.StructType(
        (T.StructField("a", T.INT),)), device="cpu")
    refs = []

    def attempt(piece):
        big = torch.zeros(1 << 16)
        refs.append(weakref.ref(big))
        if len(refs) == 1:
            raise PF.InjectedOOM("RESOURCE_EXHAUSTED: first attempt")
        gc.collect()
        assert refs[0]() is None, "the first attempt's tensor is alive"
        return piece

    assert PR.with_oom_retry("op", attempt, b,
                             RapidsConf(NO_BACKOFF)) is b
    assert len(refs) == 2


def test_fault_spec_grammar_is_the_references():
    for spec in ("a@2,b%3,c", "Tpu*>512", "s?8", "Tpu?ortExec@1"):
        conf = {"spark.rapids.tpu.test.faults.oom": spec,
                "spark.rapids.tpu.test.faults.seed": 3}
        p = PF.FaultInjector(RapidsConf(conf))
        from spark_rapids_tpu.conf import RapidsConf as JConf

        j = JF.FaultInjector(JConf(conf))
        sites = ["a", "b", "c", "TpuSortExec", "s", "x"]
        for k in range(12):
            site = sites[k % len(sites)]
            outs = []
            for inj, exc in ((p, PF.InjectedOOM), (j, JF.InjectedOOM)):
                try:
                    inj.check("oom", site, cap=256 << (k % 4))
                    outs.append("ok")
                except exc as e:
                    outs.append(str(e))
            assert outs[0] == outs[1]
        assert p.fired() == j.fired()
    for bad in ("a@0", "a%x", "a>-1", "a?0"):
        with pytest.raises(ValueError, match="bad fault spec"):
            PF.FaultInjector(RapidsConf(
                {"spark.rapids.tpu.test.faults.oom": bad}))


def test_transfer_channel_at_packed_upload():
    from spark_rapids_tpu_torch.io.arrow_convert import packed_upload

    PF.install(RapidsConf({"spark.rapids.tpu.test.faults.transfer":
                           "packed_upload@2"}))
    packed_upload([np.arange(5)], "cpu")
    with pytest.raises(PF.InjectedTransferError, match="packed_upload"):
        packed_upload([np.arange(5)], "cpu")
    packed_upload([np.arange(5)], "cpu")
