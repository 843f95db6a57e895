"""The port's buffer donation (``plugin/donation.py``) and host-resident
scan (``exec/basic.InMemoryScanExec``) against the reference's.

The certification table, the dispatch mask and the exclusivity predicate
must be the reference's on the same batches (dictionary batches
included); the release must keep every storage another tensor shares;
the guard must put the planes back when the dispatch fails; the witness
must type a read of a released plane; and a host-resident query's rows
must be the reference's with donation on and off, the donating run
releasing bytes and the copying one none.
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu import faults as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.columnar import column as JCol
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.plugin import donation as JD
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import faults as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
from spark_rapids_tpu_torch.columnar import column as PCol
from spark_rapids_tpu_torch.conf import RapidsConf as PConf
from spark_rapids_tpu_torch.exec import InMemoryScanExec
from spark_rapids_tpu_torch.exec.base import vals_of_batch
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import expressions as PE
from spark_rapids_tpu_torch.io.arrow_convert import packed_upload
from spark_rapids_tpu_torch.plugin import donation as D
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

REF = dict(T=JT, E=JE, A=JA, S=JSession)
PORT = dict(T=T, E=PE, A=PA, S=lambda c: PSession(c, device="cpu"))


@pytest.fixture(autouse=True)
def _witness_off():
    yield
    D.uninstall_witness()
    JD.uninstall_witness()
    PF.uninstall()
    JF.uninstall()


def test_certification_table_is_the_references():
    assert list(D.DONATION_SPECS) == list(JD.DONATION_SPECS)
    for site, spec in D.DONATION_SPECS.items():
        ref = JD.DONATION_SPECS[site]
        assert (spec.argnums, spec.retry, spec.certified) == (
            ref.argnums, ref.retry, ref.certified), site
        assert spec.reason and "jax" not in spec.reason
    assert D.certified_sites() == JD.certified_sites()


def _pair(dict_col: bool):
    """The same rows as a batch of each package (``k`` a dictionary
    column when ``dict_col``)."""
    data = {"k": ["a", "b", None, "a"], "v": [1, None, 3, 4]}
    out = []
    for m, B, Col, dev in ((JT, JB, JCol, {}), (T, None, PCol,
                                                  {"device": "cpu"})):
        sch = m.StructType((m.StructField("k", m.STRING),
                            m.StructField("v", m.LONG)))
        if m is JT:
            b = JB.ColumnarBatch.from_pydict(data, sch)
        else:
            b = ColumnarBatch.from_pydict(data, sch, device="cpu")
        if dict_col:
            dc = Col.dict_column_from_pylist(data["k"], **dev)
            b = type(b)([dc] + list(b.columns[1:]), b.schema, 4)
        out.append(b)
    return out


@pytest.mark.parametrize("dict_col", [False, True])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("settings", [
    {}, {"spark.rapids.tpu.sql.donation.enabled": False},
    {"spark.rapids.tpu.sql.donation.retrySnapshot.enabled": False}])
def test_masks_are_the_references(dict_col, exclusive, settings):
    jb, pb = _pair(dict_col)
    if exclusive:
        JD.mark_exclusive(jb)
        D.mark_exclusive(pb)
    jc, pc = JConf(settings), PConf(settings)
    assert D.batch_donatable(pb) == JD.batch_donatable(jb)
    for site in list(JD.DONATION_SPECS) + ["no_such_site"]:
        assert D.dispatch_mask(site, pb, pc) == JD.dispatch_mask(
            site, jb, jc), site
        assert D.dispatch_mask(site, [pb, pb], pc) == JD.dispatch_mask(
            site, [jb, jb], jc), site
    assert D.dispatch_mask("agg_plan", []) == JD.dispatch_mask(
        "agg_plan", []) == ()
    D.claim(pb)
    assert not D.is_exclusive(pb)


def _views_batch(host_arrays, n):
    """A batch whose three planes are typed views of ONE uploaded buffer
    (``packed_upload``), as the host-resident scan's uploads are."""
    k, v, valid = packed_upload(host_arrays, "cpu")
    sch = schema_of(k=T.INT, v=T.LONG)
    return ColumnarBatch([PCol.DeviceColumn(T.INT, n, k, valid),
                          PCol.DeviceColumn(T.LONG, n, v, valid)], sch, n)


def _host(n=256):
    return [np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int64) * 3,
            np.ones(n, bool)]


def test_release_frees_a_storage_the_batch_alone_holds():
    b = D.mark_exclusive(_views_batch(_host(), 256))
    nbytes, planes = D.release_batches(b)
    assert planes == 3 and nbytes >= 256 * 13  # the validity is shared
    assert all(c.data.numel() == 0 and c.validity.numel() == 0
               for c in b.columns)


def test_release_keeps_a_storage_another_batch_shares():
    """Two batches cut from one buffer (the split pieces' layout): the
    storage is shared, so neither releases it, and counts nothing."""
    b = _views_batch(_host(), 256)
    c0 = b.columns[0]
    half = ColumnarBatch([PCol.DeviceColumn(T.INT, 128, c0.data[:128],
                                            c0.validity[:128])],
                         schema_of(k=T.INT), 128)
    assert D.release_batches(D.mark_exclusive(half)) == (0, 0)
    assert half.columns[0].data.numel() == 128
    assert D.release_batches(D.mark_exclusive(b)) == (0, 0)
    assert torch.equal(b.columns[1].data, torch.arange(256) * 3)


def test_release_keeps_a_storage_the_output_holds():
    """A projection that passes a column through shares its tensor with
    the output: that storage stays, the other is released."""
    sch = schema_of(k=T.INT, v=T.LONG)
    b = D.mark_exclusive(ColumnarBatch.from_pydict(
        {"k": list(range(8)), "v": list(range(8))}, sch, device="cpu"))
    out = ColumnarBatch([b.columns[0]], schema_of(k=T.INT), 8)
    nbytes, planes = D.release_batches(b, keep=out)
    assert planes == 2  # v's data and validity
    assert out.to_rows() == [(i,) for i in range(8)]
    assert b.columns[1].data.numel() == 0


def test_mark_fresh_refuses_a_pass_through_of_a_shared_input():
    sch = schema_of(k=T.INT)
    inp = ColumnarBatch.from_pydict({"k": [1, 2]}, sch, device="cpu")
    through = ColumnarBatch([inp.columns[0]], sch, 2)
    assert not D.is_exclusive(D.mark_fresh(through, inp))
    fresh = ColumnarBatch.from_pydict({"k": [1, 2]}, sch, device="cpu")
    assert D.is_exclusive(D.mark_fresh(fresh, inp))
    # an exclusive input hands its planes on
    assert D.is_exclusive(D.mark_fresh(through, D.mark_exclusive(inp)))


def test_guard_restores_planes_on_an_injected_oom():
    """The retry contract: a dispatch that fails after its planes were
    released gets them back from the host snapshot, equal to before, and
    the failure propagates."""
    b = D.mark_exclusive(_views_batch(_host(), 256))
    want = [c.data.clone() for c in b.columns]
    inj = PF.install(PConf({"spark.rapids.tpu.test.faults.oom": "site"}))
    snap = D.snapshot_counters()
    with pytest.raises(PF.InjectedOOM):
        with D.guard("agg_update", b, op="T", conf=PConf({})):
            D.release_batches(b)
            assert b.columns[0].data.numel() == 0
            inj.check("oom", "site")
    assert D.counters_since(snap) == {}
    for c, w in zip(b.columns, want):
        assert torch.equal(c.data, w)
        assert c.validity.all()


def test_guard_counts_into_the_metric_and_events():
    from spark_rapids_tpu_torch.exec.base import Metric

    b = D.mark_exclusive(_views_batch(_host(), 256))
    m = Metric("donatedBytes")
    snap = D.snapshot_counters()
    with D.guard("agg_update", b, op="T", snapshot=False, metric=m) as done:
        pass
    assert m.kind == "bytes" and m.value == done.bytes > 0
    assert D.counters_since(snap) == {"agg_update": done.bytes}


def test_witness_types_a_read_of_a_released_plane():
    b = D.mark_exclusive(_views_batch(_host(), 256))
    D.install_witness()
    with D.guard("join", b, op="TpuShuffledHashJoinExec", snapshot=False):
        pass
    with pytest.raises(D.TpuDonationViolation) as e:
        vals_of_batch(b)
    assert e.value.site == "join" and e.value.op == "TpuShuffledHashJoinExec"


def test_witness_requires_a_release():
    """A donating dispatch whose every storage another tensor shares
    released nothing: the witness raises, naming the site."""
    b = D.mark_exclusive(_views_batch(_host(), 256))
    keep = b.columns[0].data[:4]  # noqa: F841 - shares the one storage
    D.install_witness()
    with pytest.raises(D.TpuDonationViolation, match="fused_chain"):
        with D.guard("fused_chain", b, snapshot=False):
            pass


def test_session_conf_arms_the_witness():
    assert not D.witness_enabled()
    PSession({"spark.rapids.tpu.tools.donation.witness.enabled": True},
             device="cpu")
    assert D.witness_enabled()


def test_host_resident_scan_uploads_fresh_exclusive_batches():
    sch = schema_of(k=T.INT, v=T.LONG)
    b = ColumnarBatch.from_pydict({"k": [1, 2, None], "v": [4, None, 6]},
                                  sch, device="cpu")
    scan = InMemoryScanExec(PConf(
        {"spark.rapids.tpu.sql.inMemoryScan.hostResident": True}),
        [[b]], sch)
    outs = [next(scan.execute_partition(0)) for _ in range(2)]
    assert all(D.is_exclusive(o) and o is not b for o in outs)
    assert outs[0].columns[0].data.data_ptr() != \
        outs[1].columns[0].data.data_ptr()
    assert outs[0].to_rows() == b.to_rows() == [(1, 4), (2, None),
                                                (None, 6)]
    # the default mode yields the batch itself, never marked
    scan = InMemoryScanExec(PConf({}), [[b]], sch)
    (o,) = list(scan.execute_partition(0))
    assert o is b and not D.is_exclusive(o)


def _agg_query(m, sess, data):
    E, A, T_ = m["E"], m["A"], m["T"]
    sch = T_.StructType((T_.StructField("k", T_.INT),
                         T_.StructField("a", T_.LONG),
                         T_.StructField("b", T_.DOUBLE)))
    return (sess.create_dataframe(data, sch)
            .where(E.GreaterThanOrEqual(E.col("a"), E.Literal.of(0)))
            .group_by("k")
            .agg(A.agg(A.Sum(E.col("a")), "sa"),
                 A.agg(A.Min(E.col("a")), "mn"),
                 A.agg(A.Max(E.col("b")), "mx"),
                 A.agg(A.Count(E.col("b")), "cb")))


def _join_query(m, sess, ldata, rdata):
    T_ = m["T"]
    lsch = T_.StructType((T_.StructField("k", T_.INT),
                          T_.StructField("a", T_.LONG)))
    rsch = T_.StructType((T_.StructField("k2", T_.INT),
                          T_.StructField("b", T_.LONG)))
    return sess.create_dataframe(ldata, lsch).join(
        sess.create_dataframe(rdata, rsch), on=[("k", "k2")], how="inner")


HOST = {"spark.rapids.tpu.sql.inMemoryScan.hostResident": True}
COPY = {**HOST, "spark.rapids.tpu.sql.donation.enabled": False}


@pytest.mark.parametrize("strategy", ["SCATTER", "SORT", "PALLAS"])
def test_host_resident_agg_rows_are_the_references(strategy):
    n = 900
    data = {"k": [i % 17 for i in range(n)],
            "a": [None if i % 13 == 0 else i * 3 for i in range(n)],
            "b": [i / 7.0 - 20.0 for i in range(n)]}
    st = {"spark.rapids.tpu.sql.agg.strategy": strategy}
    want = sorted(_agg_query(REF, JSession({**COPY, **st}), data).collect(),
                  key=repr)
    got = {}
    for mode, settings in (("on", HOST), ("off", COPY)):
        snap = D.snapshot_counters()
        rows = _agg_query(PORT, PSession({**settings, **st}, device="cpu"),
                          data).collect()
        got[mode] = (sorted(rows, key=repr), D.counters_since(snap))
    assert got["on"][0] == got["off"][0] == want
    assert got["on"][1].get("agg_update", 0) + got["on"][1].get(
        "agg_plan", 0) > 0
    assert got["off"][1] == {}


@pytest.mark.parametrize("strategy", ["SEARCH", "PALLAS"])
def test_host_resident_join_rows_are_the_references(strategy):
    n = 700
    ldata = {"k": [i % 29 for i in range(n)],
             "a": [None if i % 19 == 0 else i for i in range(n)]}
    rdata = {"k2": [i % 11 for i in range(29)],
             "b": [i * 10 for i in range(29)]}
    st = {"spark.rapids.tpu.sql.join.strategy": strategy}
    want = sorted(_join_query(REF, JSession({**COPY, **st}), ldata,
                              rdata).collect(), key=repr)
    got = {}
    for mode, settings in (("on", HOST), ("off", COPY)):
        snap = D.snapshot_counters()
        rows = _join_query(PORT, PSession({**settings, **st}, device="cpu"),
                           ldata, rdata).collect()
        got[mode] = (sorted(rows, key=repr), D.counters_since(snap))
    assert got["on"][0] == got["off"][0] == want
    assert got["on"][1].get("join", 0) > 0
    assert got["off"][1] == {}


def test_host_resident_rows_with_the_witness_on():
    """The donating run under the witness: every donating dispatch
    released something and nothing read a released plane."""
    data = {"k": [i % 5 for i in range(300)],
            "a": list(range(300)), "b": [i / 3.0 for i in range(300)]}
    want = sorted(_agg_query(PORT, PSession(COPY, device="cpu"),
                             data).collect(), key=repr)
    D.install_witness()
    got = sorted(_agg_query(PORT, PSession(HOST, device="cpu"),
                            data).collect(), key=repr)
    assert got == want
