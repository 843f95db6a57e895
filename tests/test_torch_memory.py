"""The port's memory plane (``spark_rapids_tpu_torch/memory/``) against
the reference's: the spill catalog's tiers and victim order, the budget,
the disk tier, spillable values and batches (strings and dictionaries
included), the semaphore, and the ledger's leak sentinel.

The two catalogs see the same sequence of registrations, sizes,
priorities and budgets, and must move the same buffers to the same tiers
at the same moments.
"""
import gc
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.memory import catalog as JC
from spark_rapids_tpu.memory import semaphore as JSem
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (ColumnarBatch,
                                             dict_column_from_pylist)
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.expr.values import ColV, DictV, StrV
from spark_rapids_tpu_torch.memory import catalog as PC
from spark_rapids_tpu_torch.memory import ledger as PL
from spark_rapids_tpu_torch.memory import semaphore as PSem
from spark_rapids_tpu_torch.memory.spillable import (SpillableColumnarBatch,
                                                     SpillableVals)
from spark_rapids_tpu_torch.sql.session import TpuSession

BUDGET = "spark.rapids.tpu.memory.hbm.budgetBytes"
HOST_CAP = "spark.rapids.tpu.memory.host.spillStorageSize"


@pytest.fixture(autouse=True)
def _fresh_catalogs():
    yield
    PC.BufferCatalog.reset()
    JC.BufferCatalog.reset()
    PL.force_arm(False)


def _both(settings):
    return (PC.BufferCatalog.reset(RapidsConf(settings), "cpu"),
            JC.BufferCatalog.reset(JConf(settings)))


# (priority, int64 elements) registered in this order
SEQUENCE = [(0, 10), (-100, 12), (-50, 8), (0, 6), (-100, 4), (-50, 16)]


@pytest.mark.parametrize("budget", (1, 120, 200, 400, 10_000))
def test_spill_tiers_and_order_are_the_references(budget):
    pc, jc = _both({BUDGET: budget})
    ph, jh = [], []
    for prio, n in SEQUENCE:
        ph.append(PC.SpillableHandle({"a": torch.arange(n)}, prio, pc))
        jh.append(JC.SpillableHandle({"a": jnp.arange(n)}, prio, jc))
        assert [h.tier for h in ph] == [h.tier for h in jh]
        assert (pc.device_bytes, pc.host_bytes) == (
            jc.device_bytes, jc._host_bytes)
    # bring each back (lowest priority first) and read it
    for k in sorted(range(len(ph)), key=lambda i: SEQUENCE[i][0]):
        assert ph[k].materialize()["a"].tolist() == list(
            range(SEQUENCE[k][1]))
        jh[k].materialize()
        assert [h.tier for h in ph] == [h.tier for h in jh]
    for a, b in (("device_to_host", "device_to_host"),
                 ("host_to_disk", "host_to_disk"),
                 ("spilled_bytes", "spilled_bytes"),
                 ("unspills", "unspills"),
                 ("peak_device_bytes", "peak_device_bytes")):
        assert getattr(pc.metrics, a) == getattr(jc.metrics, b), a
    for h in ph + jh:
        h.close()
    assert pc.device_bytes == pc.host_bytes == 0


def test_a_registration_that_reaches_the_disk_tier():
    """The reference's catalog raises when a buffer's own registration
    spills it on to disk (its id is assigned after ``register`` returns;
    ROADMAP.md §C); the port's registers first, then spills."""
    pc, jc = _both({BUDGET: 1, HOST_CAP: 64})
    with pytest.raises(AttributeError, match="_id"):
        JC.SpillableHandle({"a": jnp.arange(10)}, 0, jc)
    h = PC.SpillableHandle({"a": torch.arange(10)}, 0, pc)
    assert h.tier == PC.TIER_DISK
    assert h.materialize()["a"].tolist() == list(range(10))
    h.close()
    JC.BufferCatalog.reset()


def test_ensure_headroom_and_largest_spillable():
    pc, jc = _both({})
    assert pc.budget is None  # a CPU device: unlimited, accounting only
    ph = [PC.SpillableHandle({"a": torch.zeros(n, dtype=torch.float64)},
                             p, pc) for p, n in SEQUENCE]
    jh = [JC.SpillableHandle({"a": jnp.zeros(n, jnp.float64)}, p, jc)
          for p, n in SEQUENCE]
    ph[1].pinned = jh[1].pinned = True
    assert pc.largest_spillable() == jc.largest_spillable() == 16 * 8
    assert pc.ensure_headroom(60) == jc.ensure_headroom(60)
    assert [h.tier for h in ph] == [h.tier for h in jh]
    assert pc.ensure_headroom() == jc.ensure_headroom()
    assert [h.tier for h in ph] == [h.tier for h in jh]
    assert ph[1].tier == PC.TIER_DEVICE
    for h in ph + jh:
        h.close()


def test_budget_derivation(monkeypatch):
    conf = RapidsConf({BUDGET: 12345})
    assert PC.derive_hbm_budget(conf, "cpu") == 12345
    assert PC.derive_hbm_budget(RapidsConf({}), "cpu") is None
    total = 80 * 10**9
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (total // 2, total))
    want = int(total * 0.9) - (1 << 28)
    assert PC.derive_hbm_budget(RapidsConf({}), "cuda") == want
    frac = RapidsConf({"spark.rapids.tpu.memory.hbm.allocFraction": 0.5,
                       "spark.rapids.tpu.memory.hbm.reserve": 1 << 20})
    assert PC.derive_hbm_budget(frac, "cuda") == total // 2 - (1 << 20)
    tiny = RapidsConf({"spark.rapids.tpu.memory.hbm.allocFraction": 0.0})
    assert PC.derive_hbm_budget(tiny, "cuda") == 1 << 20


def test_disk_tier_round_trip_and_cleanup(tmp_path):
    pc = PC.BufferCatalog.reset(RapidsConf({BUDGET: 1, HOST_CAP: 1}), "cpu")
    pc._spill_dir = str(tmp_path)
    arrays = {"i": torch.arange(-5, 95, dtype=torch.int64),
              "b": torch.arange(100) % 3 == 0,
              "u": torch.arange(100, dtype=torch.uint8),
              "f": torch.linspace(-1, 1, 100, dtype=torch.float64)}
    h = PC.SpillableHandle({k: v.clone() for k, v in arrays.items()},
                           0, pc)
    assert h.tier == PC.TIER_DISK and pc.metrics.host_to_disk == 1
    assert list(tmp_path.iterdir())
    back = h.materialize()
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    assert not list(tmp_path.iterdir())
    h2 = PC.SpillableHandle({"x": torch.ones(50)}, 0, pc)
    assert h2.tier == h.tier == PC.TIER_DISK
    h2.close()
    h.close()
    assert not list(tmp_path.iterdir())
    assert pc.device_bytes == pc.host_bytes == 0


def test_a_collected_handle_unregisters_itself():
    pc = PC.BufferCatalog.reset(RapidsConf({}), "cpu")
    h = PC.SpillableHandle({"a": torch.zeros(1000)}, 0, pc)
    assert pc.device_bytes == 4000
    del h
    gc.collect()
    assert pc.device_bytes == 0 and not pc._buffers


def _batch(n=300):
    rng = np.random.default_rng(2)
    words = ["", "a", "héllo", "日本語", "spark-rapids"]
    ints = [None if i % 7 == 0 else int(rng.integers(-10**9, 10**9))
            for i in range(n)]
    strs = [None if i % 5 == 0 else words[i % len(words)] for i in range(n)]
    dct = dict_column_from_pylist(
        [None if i % 6 == 0 else ["x", "yy", "日本"][i % 3]
         for i in range(n)], device="cpu")
    schema = T.StructType((T.StructField("i", T.LONG),
                           T.StructField("s", T.STRING),
                           T.StructField("d", T.STRING)))
    plain = ColumnarBatch.from_pydict({"i": ints, "s": strs}, T.StructType(
        schema.fields[:2]), device="cpu")
    return ColumnarBatch(plain.columns + [dct], schema, n)


@pytest.mark.parametrize("tier", ("device", "host", "disk"))
def test_spillable_batch_with_strings_and_dictionaries(tier):
    settings = {"device": {}, "host": {BUDGET: 1},
                "disk": {BUDGET: 1, HOST_CAP: 1}}[tier]
    pc = PC.BufferCatalog.reset(RapidsConf(settings), "cpu")
    b = _batch()
    want = b.to_rows()
    sb = SpillableColumnarBatch(b, catalog=pc)
    assert sb.tier == {"device": 0, "host": 1, "disk": 2}[tier]
    got = sb.get_batch()
    assert got.columns[2].is_dict
    d0, d1 = b.columns[2].dictv, got.columns[2].dictv
    assert (d1.mat_cap, d1.max_len, d1.unique) == (
        d0.mat_cap, d0.max_len, d0.unique)
    assert got.capacity == b.capacity and got.to_rows() == want
    sv = SpillableVals([ColV(b.columns[0].data, b.columns[0].validity),
                        StrV(b.columns[1].offsets, b.columns[1].chars,
                             b.columns[1].validity), d0], catalog=pc)
    vals = sv.get_vals()
    assert isinstance(vals[2], DictV) and isinstance(vals[1], StrV)
    assert torch.equal(vals[0].data, b.columns[0].data)
    assert torch.equal(vals[1].chars, b.columns[1].chars)
    assert torch.equal(vals[2].codes, d0.codes)
    sb.close()
    sv.close()


def test_semaphore_is_reentrant_per_thread():
    sem = PSem.TpuSemaphore(1)
    sem.acquire_if_necessary()
    sem.acquire_if_necessary()  # re-entrant: no deadlock
    assert sem.holder_names() == [threading.current_thread().name]
    sem.release_if_necessary()
    assert sem.holder_names()
    sem.release_if_necessary()
    assert sem.holder_names() == []
    sem.release_if_necessary()  # an extra release is a no-op
    with sem:
        with sem:
            pass
    assert sem.holder_names() == []


def test_semaphore_timeout_names_the_holders():
    msgs = []
    for mod in (PSem, JSem):
        sem = mod.TpuSemaphore(1, timeout_ms=50)
        hold, done = threading.Event(), threading.Event()

        def holder():
            sem.acquire_if_necessary()
            hold.set()
            done.wait(5)
            sem.release_if_necessary()

        t = threading.Thread(target=holder, name="srt-holder")
        t.start()
        hold.wait(5)
        with pytest.raises(mod.TpuSemaphoreTimeout) as ei:
            sem.acquire_if_necessary()
        done.set()
        t.join()
        msgs.append(str(ei.value))
    for m in msgs:
        assert "held by: srt-holder" in m and "1 permit(s)" in m
        assert "acquireTimeoutMs=50" in m
    strip = [m.split(" after ")[0] + m.split("ms (")[1] for m in msgs]
    assert strip[0] == strip[1]


def test_semaphore_from_the_session_conf():
    PSem.TpuSemaphore.reset(RapidsConf(
        {"spark.rapids.tpu.sql.concurrentTpuTasks": 3}))
    try:
        assert PSem.TpuSemaphore.get().permits == 3
    finally:
        PSem.TpuSemaphore.reset()


def test_ledger_leak_sentinel():
    PL.force_arm(True)
    pc = PC.BufferCatalog.reset(RapidsConf({}), "cpu")
    kept = []
    with PL.query_scope(7):
        kept.append(PC.SpillableHandle({"a": torch.zeros(10)}, 0, pc))
        kept.append(PC.SpillableHandle({"b": torch.zeros(20)}, 0, pc,
                                       ledger_kind="plan_state"))
        gone = PC.SpillableHandle({"c": torch.zeros(5)}, 0, pc)
        gone.close()
    assert pc.ledger.query_peak(7) == 140
    leaks = pc.ledger.sweep_query(7)
    assert [r["bytes"] for r in leaks] == [40]
    assert leaks[0]["site"].startswith("test_torch_memory.py:")
    assert pc.ledger.stats()["leaked_live"] == 1
    kept[0].close()
    assert pc.ledger.stats()["leaked_live"] == 0
    assert pc.ledger.sweep_query(8) == []


def test_session_sweeps_its_queries():
    PL.force_arm(True)
    sess = TpuSession({}, device="cpu")
    rows = [(i % 5, i) for i in range(500)]
    schema = T.StructType((T.StructField("k", T.INT),
                           T.StructField("v", T.LONG)))
    # duplicate build keys: the general (sorted, spillable) build
    dim = sess.from_rows([(k % 5, k) for k in range(10)], T.StructType(
        (T.StructField("dk", T.INT), T.StructField("w", T.LONG))))
    got = sorted(sess.from_rows(rows, schema).join(dim, [("k", "dk")])
                 .select("k", "w").collect())
    assert len(got) == 1000
    cat = PC.BufferCatalog.get()
    assert cat.ledger.stats()["allocs"] >= 2  # the spillable build
    assert sess.last_leaks == []  # plan state is exempt


def test_catalog_follows_the_session_memory_conf():
    TpuSession({BUDGET: 4096}, device="cpu")
    assert PC.BufferCatalog.get().budget == 4096
    first = PC.BufferCatalog.get()
    TpuSession({BUDGET: 4096}, device="cpu")
    assert PC.BufferCatalog.get() is first
    TpuSession({}, device="cpu")
    assert PC.BufferCatalog.get().budget is None


def test_a_join_build_in_use_is_never_spilled():
    """The probe holds the build's tensors: a spill of them would copy
    them to the host and free nothing. Neither bringing the other half
    of the build back nor an emergency spill may take them while they
    are in use; once the probe is done they are spillable again."""
    from spark_rapids_tpu_torch.exec.join import _SpillableBuild

    cat = PC.BufferCatalog.reset(RapidsConf({BUDGET: 1}), "cpu")
    cols = [ColV(torch.arange(64), torch.ones(64, dtype=torch.bool))]
    sb = _SpillableBuild(cols, [torch.arange(64)], torch.ones(
        64, dtype=torch.bool))
    assert sb.tiers == (PC.TIER_HOST, PC.TIER_HOST)
    assert cat.metrics.device_to_host == 2
    with sb.pinned() as (bcols, words, live):
        assert sb.tiers == (PC.TIER_DEVICE, PC.TIER_DEVICE)
        assert cat.ensure_headroom() == 0
        assert cat.largest_spillable() == 0
        with sb.pinned():  # a second probe of the same build
            pass
        assert cat.ensure_headroom() == 0
        assert torch.equal(bcols[0].data, torch.arange(64))
    assert cat.metrics.device_to_host == 2
    assert cat.metrics.unspills == 2
    assert cat.ensure_headroom() > 0
    assert sb.tiers == (PC.TIER_HOST, PC.TIER_HOST)


def test_a_join_under_a_small_budget_spills_its_build_once():
    sess = TpuSession({BUDGET: 1}, device="cpu")
    schema = T.StructType((T.StructField("k", T.INT),
                           T.StructField("v", T.LONG)))
    dim = sess.from_rows([(k % 5, k) for k in range(10)], T.StructType(
        (T.StructField("dk", T.INT), T.StructField("w", T.LONG))))
    got = sorted(sess.from_rows([(i % 5, i) for i in range(500)], schema)
                 .join(dim, [("k", "dk")]).select("k", "w").collect())
    assert got == sorted((i % 5, w) for i in range(500)
                         for w in range(10) if w % 5 == i % 5)
    m = PC.BufferCatalog.get().metrics
    # the build's two handles: spilled as they register, back once each
    assert (m.device_to_host, m.unspills) == (2, 2)
