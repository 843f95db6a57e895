"""The port's mesh stages (``exec/mesh.py``) against the reference's.

Every differential query runs through both packages' sessions under
``spark.rapids.tpu.shuffle.mode=ici`` with ``mesh.devices`` in {2, 4, 8}:
the reference on its own 8-device virtual CPU mesh (``tests/conftest.py``),
the port on 8 virtual shards laid over the CPU (the fixture sets
``SRTPU_TORCH_VIRTUAL_DEVICES``). Integers, strings, nulls and row sets
must be equal, and so must the row order under ORDER BY (compared as
multisets elsewhere). Float sums agree within rtol 1e-12 on the exact
f64 paths and within rtol 1e-4 / atol 1e-6 under ``variableFloatAgg``
(``tests/test_radix_agg.py``'s tolerances).

The reference's mesh programs are slow to compile, so only a dozen
queries run on its side; the other mesh cases hold the port's mesh plan
to its own host-exchange plan of the same query (which the exchange
tests hold to the reference) or to a Python oracle.
"""
import os

import pytest
import torch

from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.parallel import mesh as PM
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

from test_torch_exchange import PORT, REF, check, left, right

ICI = {"spark.rapids.tpu.shuffle.mode": "ici",
       "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
HOST = {"spark.rapids.tpu.shuffle.mode": "host",
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
VFA = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
N_DEV = 8


@pytest.fixture(autouse=True)
def virtual_devices(monkeypatch):
    """8 virtual shards over the CPU, and one torch thread a test: the
    xdist workers share the box's cores, and the mesh's many small ops
    stall in an oversubscribed thread pool (3x slower with 8 threads on
    a loaded box)."""
    monkeypatch.setenv(PM.VIRTUAL_DEVICES_ENV, str(N_DEV))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(n, extra=None):
    return {**ICI, "spark.rapids.tpu.mesh.devices": n, **(extra or {})}


def against_reference(q, n, extra=None):
    """(reference rows, port rows, port session) of ``q(m, sess)`` on an
    ``n``-shard mesh in both packages."""
    settings = _mesh(n, extra)
    ref = q(REF, JSession(settings)).collect()
    ps = PSession(settings, device="cpu")
    return ref, q(PORT, ps).collect(), ps


def against_host(q, n, extra=None):
    """(host-exchange rows, mesh rows, mesh session) of the port."""
    hs = PSession({**HOST, **(extra or {})}, device="cpu")
    want = q(PORT, hs).collect()
    ms = PSession(_mesh(n, extra), device="cpu")
    return want, q(PORT, ms).collect(), ms


def check_rows(want, got, order_keys=(), **tol):
    """The same rows as multisets, and under ORDER BY the same sequence
    of sort keys (``order_keys``: column positions); ties may permute the
    other columns, as the plan leaves them free."""
    check(want, got, **tol)
    if order_keys:
        def seq(rows):
            return [tuple(repr(r[i]) for i in order_keys) for r in rows]
        assert seq(got) == seq(want)


def plan_of(sess):
    return sess.last_executed_plan.tree_string()


def _col(m, name):
    return m["E"].UnresolvedAttribute(name)


def _agg(m, sess):
    A = m["A"]
    return left(m, sess).group_by("k").agg(
        A.agg(A.Count(None), "n"), A.agg(A.Sum(_col(m, "x")), "sx"),
        A.agg(A.Min(_col(m, "x")), "mn"), A.agg(A.Max(_col(m, "k")), "mx"))


def _agg_many(m, sess):
    """About 80 groups a shard: past a small exchange cap."""
    A = m["A"]
    return left(m, sess).group_by("x").agg(
        A.agg(A.Count(None), "n"), A.agg(A.Sum(_col(m, "k")), "sk"))


#: a starting exchange cap of 8 groups a shard (the bucket minimum too)
SMALL_CAP = {"spark.rapids.tpu.shuffle.mesh.aggExchangeCapacity": 8,
             "spark.rapids.tpu.sql.shapeBucket.minRows": 8}


def _agg_avg_two_keys(m, sess):
    A, E = m["A"], m["E"]
    df = left(m, sess).with_column(
        "g", E.Remainder(_col(m, "x"), E.Literal(4, m["T"].LONG)))
    return df.group_by("k", "g").agg(
        A.agg(A.Average(_col(m, "d")), "av"),
        A.agg(A.Count(_col(m, "d")), "cd"))


def _agg_string_key(m, sess):
    A = m["A"]
    return left(m, sess).group_by("s").agg(
        A.agg(A.Count(None), "n"), A.agg(A.Sum(_col(m, "x")), "sx"))


def _sort(m, sess):
    return left(m, sess).order_by("x", "k")


def _sort_strings(m, sess):
    return left(m, sess).order_by("s", "x", "k")


#: the sort keys' positions in the rows of _sort and _sort_strings
SORT_KEYS = (1, 0)
STRING_SORT_KEYS = (3, 1, 0)


def _join(m, sess):
    return left(m, sess).join(right(m, sess), on=[("k", "rk")])


def _join_strings(m, sess):
    return left(m, sess).join(right(m, sess), on=[("s", "rs")])


def _window(m, sess):
    W, A = m["W"], m["A"]
    spec = W.WindowSpec(partition_by=(_col(m, "k"),),
                        order_by=(_col(m, "x"), _col(m, "d")),
                        orders=((True, True), (True, True)))
    return left(m, sess).select("k", "x", "d").with_windows(
        W.WindowExpression(A.Sum(_col(m, "x")), spec, "rs"),
        W.WindowExpression(W.RowNumber(), spec, "rn"))


#: (query, mesh width, extra settings, sort keys, stage, rtol, atol)
REF_CASES = {
    "agg": (_agg, 4, {}, (), "TpuMeshAggregateExec", 1e-12, 0.0),
    "agg_avg_two_keys": (_agg_avg_two_keys, 8, VFA, (),
                         "TpuMeshAggregateExec", 1e-4, 1e-6),
    "agg_string_key": (_agg_string_key, 2, {}, (),
                       "TpuMeshAggregateExec", 1e-12, 0.0),
    "agg_exchange_cap_retry": (_agg_many, 4, SMALL_CAP, (),
                               "TpuMeshAggregateExec", 1e-12, 0.0),
    "sort": (_sort, 8, {}, SORT_KEYS, "TpuMeshSortExec", 1e-12, 0.0),
    "sort_strings": (_sort_strings, 4, {}, STRING_SORT_KEYS,
                     "TpuMeshSortExec", 1e-12, 0.0),
    "join": (_join, 4, {}, (), "TpuMeshHashJoinExec", 1e-12, 0.0),
    "window": (_window, 4, {}, (), "TpuMeshWindowExec", 1e-12, 0.0),
}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_mesh_stage_against_reference(case):
    q, n, extra, keys, stage, rtol, atol = REF_CASES[case]
    ref, got, ps = against_reference(q, n, extra)
    assert stage in plan_of(ps), plan_of(ps)
    assert f"mesh={n}" in plan_of(ps)
    check_rows(ref, got, keys, rtol=rtol, atol=atol)


def test_agg_exchange_cap_retry_doubles_the_cap():
    want, got, ms = against_host(_agg_many, 4, SMALL_CAP)
    stage = ms.last_executed_plan.tpu_child
    assert stage.node_name == "TpuMeshAggregateExec"
    assert stage.mesh_actuals["exchange_cap"] > 8
    check_rows(want, got)


#: the mesh plan against the port's own host-exchange plan
HOST_CASES = {
    "agg_2": (_agg, 2, {}, ()),
    "agg_8_pallas": (_agg, 8, {"spark.rapids.tpu.sql.agg.strategy":
                                "PALLAS"}, ()),
    "agg_4_radix": (_agg, 4, {"spark.rapids.tpu.sql.agg.strategy":
                               "RADIX"}, ()),
    "agg_string_key_8": (_agg_string_key, 8, {}, ()),
    "sort_2": (_sort, 2, {}, SORT_KEYS),
    "sort_strings_8": (_sort_strings, 8, {}, STRING_SORT_KEYS),
    "sort_no_granule": (_sort, 4, {
        "spark.rapids.tpu.shuffle.mesh.exchangeBucketFactor": 0.0},
        SORT_KEYS),
    "sort_tight_granule": (_sort, 8, {
        "spark.rapids.tpu.shuffle.mesh.exchangeBucketFactor": 0.01},
        SORT_KEYS),
    "join_8": (_join, 8, {}, ()),
    "join_strings_4": (_join_strings, 4, {}, ()),
    "join_search": (_join, 4, {"spark.rapids.tpu.sql.join.strategy":
                                "SEARCH"}, ()),
    "join_pallas": (_join, 4, {"spark.rapids.tpu.sql.join.strategy":
                                "PALLAS"}, ()),
    "window_8": (_window, 8, {}, ()),
    "window_whole_plan_off": (_window, 2, {
        "spark.rapids.tpu.shuffle.mesh.wholePlan.enabled": False}, ()),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_mesh_stage_against_host_exchange(case):
    q, n, extra, keys = HOST_CASES[case]
    want, got, ms = against_host(q, n, extra)
    assert "TpuMesh" in plan_of(ms)
    check_rows(want, got, keys)


def test_window_string_partition_falls_back():
    W, A = PORT["W"], PORT["A"]

    def q(m, sess):
        W, A = m["W"], m["A"]
        spec = W.WindowSpec(partition_by=(_col(m, "s"),),
                            order_by=(_col(m, "x"),),
                            orders=((True, True),))
        return left(m, sess).with_windows(
            W.WindowExpression(A.Sum(_col(m, "x")), spec, "rs"))

    ref, got, ps = against_reference(q, 4)
    assert "TpuMeshWindowExec" not in plan_of(ps)
    assert "TpuWindowExec" in plan_of(ps)
    check_rows(ref, got)
    assert W and A


def test_computed_string_key_falls_back_to_host_exchange():
    """A computed string key has no staged byte bound: the planner takes
    the single-process exchange."""
    def q(m, sess):
        A, E = m["A"], m["E"]
        key = E.Alias(E.Concat((_col(m, "s"),
                                E.Literal("-", m["T"].STRING))), "s2")
        return left(m, sess).group_by(key).agg(A.agg(A.Count(None), "n"))

    want, got, ms = against_host(q, 4)
    assert "TpuMeshAggregateExec" not in plan_of(ms)
    assert "TpuShuffleExchangeExec" in plan_of(ms)
    check_rows(want, got)


def test_empty_and_skewed_partitions():
    """Every row in one partition, more shards than rows elsewhere."""
    sess = PSession(_mesh(8), device="cpu")
    df = sess.create_dataframe(
        {"k": [1] * 50 + [2], "v": list(range(51))},
        T.StructType([T.StructField("k", T.INT),
                      T.StructField("v", T.LONG)]), num_partitions=6)
    A = PORT["A"]
    rows = sorted(df.group_by("k").agg(A.agg(A.Count(None), "n"),
                                       A.agg(A.Sum(_col(PORT, "v")),
                                             "sv")).collect())
    assert "TpuMeshAggregateExec" in plan_of(sess)
    assert rows == [(1, 50, sum(range(50))), (2, 1, 50)]
    assert sorted(df.order_by("v").collect()) == sorted(
        [(1, v) for v in range(50)] + [(2, 50)])


def test_auto_takes_the_mesh_only_with_more_than_one_device(monkeypatch):
    auto = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
    sess = PSession(auto, device="cpu")
    _agg(PORT, sess).collect()
    assert "TpuMeshAggregateExec" in plan_of(sess)
    monkeypatch.delenv(PM.VIRTUAL_DEVICES_ENV)
    sess = PSession(auto, device="cpu")
    _agg(PORT, sess).collect()
    assert "TpuMeshAggregateExec" not in plan_of(sess)


# ---------------------------------------------------------------------------
# the mesh itself: shard devices, the conf cap and its error
# ---------------------------------------------------------------------------
def test_get_mesh_conf_cap_and_memoization():
    m2 = PM.get_mesh(conf=RapidsConf({"spark.rapids.tpu.mesh.devices": 2}),
                     device="cpu")
    assert m2.size == 2
    assert PM.get_mesh(2, device="cpu") is m2
    assert PM.get_mesh(conf=RapidsConf({}), device="cpu").size == N_DEV
    assert PM.get_mesh(conf=RapidsConf(
        {"spark.rapids.tpu.shuffle.meshSize": 3}), device="cpu").size == 3
    # mesh.devices wins over meshSize
    assert PM.get_mesh(conf=RapidsConf(
        {"spark.rapids.tpu.mesh.devices": 4,
         "spark.rapids.tpu.shuffle.meshSize": 2}), device="cpu").size == 4
    assert all(d.type == "cpu" for d in m2.devices)


def test_get_mesh_too_many_devices_is_an_error():
    with pytest.raises(ValueError, match="mesh.devices=4096.*"
                       + PM.VIRTUAL_DEVICES_ENV):
        PM.get_mesh(conf=RapidsConf({"spark.rapids.tpu.mesh.devices": 4096}),
                    device="cpu")
    with pytest.raises(ValueError, match="mesh.devices=9"):
        _agg(PORT, PSession(_mesh(9), device="cpu")).collect()


def test_device_count_without_virtual_devices(monkeypatch):
    monkeypatch.delenv(PM.VIRTUAL_DEVICES_ENV)
    assert PM.device_count("cpu") == 1
    monkeypatch.setenv(PM.VIRTUAL_DEVICES_ENV, "3")
    assert [str(d) for d in PM.local_devices("cpu")] == ["cpu"] * 3


def test_virtual_devices_lay_round_robin_over_the_cards(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv(PM.VIRTUAL_DEVICES_ENV, "5")
    assert [str(d) for d in PM.local_devices("cuda")] == [
        "cuda:0", "cuda:1", "cuda:0", "cuda:1", "cuda:0"]
    monkeypatch.delenv(PM.VIRTUAL_DEVICES_ENV)
    assert PM.device_count(None) == 2
    assert os.environ.get(PM.VIRTUAL_DEVICES_ENV) is None
