"""The port's collectives and distributed operators (``parallel/``).

``all_to_all_exchange`` and ``gather_all`` are held to the reference's,
which run under ``shard_map`` on its 8-device virtual CPU mesh: the same
per-shard rows (data, validity, string bytes) go through both, and each
shard must receive the same rows IN THE SAME ORDER (source-block order,
then the stable partition sort), the same counts and the same ``ok``.
The distributed group-by, sort and join over 8 CPU shards are held to
Python oracles: integers exactly, rows as multisets, the sort's global
order exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spark_rapids_tpu.expr.eval import ColV as JColV, StrV as JStrV
from spark_rapids_tpu.parallel import all_to_all_exchange as j_exchange
from spark_rapids_tpu.parallel.collective import gather_all as j_gather_all
from spark_rapids_tpu.parallel.mesh import shard_map
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.values import ColV, StrV
from spark_rapids_tpu_torch.ops.sort import SortOrder
from spark_rapids_tpu_torch.parallel import (all_to_all_exchange, dist_groupby,
                                             dist_hash_join, dist_sort,
                                             gather_all)

from test_torch_mesh import virtual_devices  # noqa: F401 (autouse)

N_DEV = 8
CPU = [torch.device("cpu")] * N_DEV


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices("cpu")
    if len(devs) < N_DEV:
        pytest.skip(f"need {N_DEV} virtual devices, have {len(devs)}")
    return Mesh(np.array(devs[:N_DEV]), ("dp",))


def _put(mesh, arr):
    return jax.device_put(arr, NamedSharding(mesh, P("dp")))


def _shard_strings(rows_per_shard, ccap):
    """Per-shard (offsets, chars) planes of byte strings, each shard's
    pool padded to ``ccap`` bytes."""
    offs, chars = [], []
    for rows in rows_per_shard:
        o = np.zeros(len(rows) + 1, np.int32)
        o[1:] = np.cumsum([len(b) for b in rows])
        c = np.zeros(ccap, np.uint8)
        blob = b"".join(rows)
        c[:len(blob)] = np.frombuffer(blob, np.uint8) if blob else c[:0]
        offs.append(o)
        chars.append(c)
    return offs, chars


def _exchange_case(seed, local=24, ccap=256):
    rng = np.random.default_rng(seed)
    data = rng.integers(-1000, 1000, (N_DEV, local)).astype(np.int64)
    valid = rng.random((N_DEV, local)) > 0.15
    target = rng.integers(0, N_DEV, (N_DEV, local)).astype(np.int32)
    live = rng.integers(0, local + 1, N_DEV).astype(np.int32)
    live[2] = 0  # an empty shard
    words = [b"", b"a", b"bc", b"hello", "héllo".encode(), b"x" * 9]
    strs = [[words[int(i)] for i in rng.integers(0, len(words), local)]
            for _ in range(N_DEV)]
    svalid = rng.random((N_DEV, local)) > 0.1
    return data, valid, target, live, strs, svalid, ccap


def _reference_exchange(mesh, case, bucket_cap):
    data, valid, target, live, strs, svalid, ccap = case
    local = data.shape[1]
    offs, chars = _shard_strings(strs, ccap)

    def step(d, v, o, ch, sv, t, n):
        lv = jnp.arange(local) < n[0]
        cols, rn, ok = j_exchange(
            [JColV(d, v & lv), JStrV(o, ch, sv & lv)], t, n[0], "dp",
            N_DEV, bucket_cap=bucket_cap)
        return (cols[0].data, cols[0].validity, cols[1].offsets,
                cols[1].chars, cols[1].validity, jnp.reshape(rn, (1,)), ok)

    fn = jax.jit(shard_map(
        step, mesh=mesh, in_specs=(P("dp"),) * 7,
        out_specs=(P("dp"),) * 6 + (P(),)))
    out = fn(_put(mesh, data.reshape(-1)), _put(mesh, valid.reshape(-1)),
             _put(mesh, np.concatenate(offs)),
             _put(mesh, np.concatenate(chars)),
             _put(mesh, svalid.reshape(-1)), _put(mesh, target.reshape(-1)),
             _put(mesh, live))
    d, v, o, ch, sv, cnt, ok = (np.asarray(x) for x in out)
    return _per_shard(d, v, o, ch, sv, cnt), cnt.tolist(), bool(ok)


def _per_shard(d, v, o, ch, sv, cnt):
    """Received rows per shard: (value or None, bytes or None)."""
    rows = []
    rc, oc, cc = (d.shape[0] // N_DEV, o.shape[0] // N_DEV,
                  ch.shape[0] // N_DEV)
    for s in range(N_DEV):
        n = int(cnt[s])
        ds, vs = d[s * rc:(s + 1) * rc], v[s * rc:(s + 1) * rc]
        os_, cs = o[s * oc:(s + 1) * oc], ch[s * cc:(s + 1) * cc]
        svs = sv[s * rc:(s + 1) * rc]
        rows.append([(int(ds[i]) if vs[i] else None,
                      bytes(cs[os_[i]:os_[i + 1]]) if svs[i] else None)
                     for i in range(n)])
    return rows


def _port_exchange(case, bucket_cap):
    data, valid, target, live, strs, svalid, ccap = case
    local = data.shape[1]
    offs, chars = _shard_strings(strs, ccap)
    shard_cols, pids, rows = [], [], []
    for s in range(N_DEV):
        lv = torch.arange(local) < int(live[s])
        shard_cols.append([
            ColV(torch.tensor(data[s]), torch.tensor(valid[s]) & lv),
            StrV(torch.tensor(offs[s]), torch.tensor(chars[s]),
                 torch.tensor(svalid[s]) & lv)])
        pids.append(torch.tensor(target[s]))
        rows.append(int(live[s]))
    out, cnt, ok = all_to_all_exchange(shard_cols, pids, rows, CPU,
                                       bucket_cap=bucket_cap)
    got = []
    for cols, n in zip(out, cnt):
        n = int(n)
        c0, c1 = cols
        got.append([(int(c0.data[i]) if c0.validity[i] else None,
                     bytes(c1.chars[int(c1.offsets[i]):int(c1.offsets[i + 1])]
                           .numpy()) if c1.validity[i] else None)
                    for i in range(n)])
    return got, [int(c) for c in cnt], bool(ok)


@pytest.mark.parametrize("bucket_cap", [0, 6, 2])
def test_all_to_all_exchange_against_reference(mesh, bucket_cap):
    case = _exchange_case(3)
    ref_rows, ref_cnt, ref_ok = _reference_exchange(mesh, case, bucket_cap)
    got_rows, got_cnt, got_ok = _port_exchange(case, bucket_cap)
    assert got_ok == ref_ok
    assert ref_ok == (bucket_cap != 2)  # 2-row blocks overflow here
    if ref_ok:
        assert got_cnt == ref_cnt
        assert got_rows == ref_rows


def test_gather_all_against_reference(mesh):
    local = 16
    rng = np.random.default_rng(5)
    data = rng.integers(0, 100, (N_DEV, local)).astype(np.int32)
    valid = rng.random((N_DEV, local)) > 0.2
    live = rng.integers(0, local + 1, N_DEV).astype(np.int32)

    def step(d, v, n):
        cols, cnt = j_gather_all([JColV(d, v)], n[0], "dp")
        return cols[0].data, cols[0].validity, jnp.reshape(cnt, (1,))

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(P("dp"),) * 3,
                           out_specs=(P("dp"),) * 3))
    d, v, cnt = (np.asarray(x) for x in fn(
        _put(mesh, data.reshape(-1)), _put(mesh, valid.reshape(-1)),
        _put(mesh, live)))
    per = d.shape[0] // N_DEV
    n = int(cnt[0])
    ref = [(int(d[i]) if v[i] else None) for i in range(n)]
    cols, total = gather_all(
        [[ColV(torch.tensor(data[s]), torch.tensor(valid[s]))]
         for s in range(N_DEV)], [int(x) for x in live], CPU[0])
    got = [(int(cols[0].data[i]) if cols[0].validity[i] else None)
           for i in range(int(total))]
    assert got == ref
    assert per >= n


def _fixed_shards(cols_per_shard):
    return [[ColV(torch.tensor(d), torch.ones(len(d), dtype=torch.bool))
             for d in cols] for cols in cols_per_shard]


def test_dist_groupby_group_cap_and_oracle():
    local = 64
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 40, (N_DEV, local)).astype(np.int32)
    vals = rng.integers(-50, 50, (N_DEV, local)).astype(np.int64)
    want = {}
    for k, v in zip(keys.reshape(-1), vals.reshape(-1)):
        s, c = want.get(int(k), (0, 0))
        want[int(k)] = (s + int(v), c + 1)
    for group_cap, ok_want in ((0, True), (64, True), (8, False)):
        shards = _fixed_shards([[keys[s], vals[s]] for s in range(N_DEV)])
        fk, fa, fn, ok = dist_groupby(
            [[c[0]] for c in shards], [T.INT], [[c[1], c[1]] for c in shards],
            ["sum", "count"], ["sum", "sum"], [local] * N_DEV, CPU,
            group_cap=group_cap)
        assert bool(ok) is ok_want
        if not ok_want:
            continue
        got = {}
        for k, a, n in zip(fk, fa, fn):
            for i in range(int(n)):
                key = int(k[0].data[i])
                assert key not in got  # groups are shard-disjoint
                got[key] = (int(a[0].data[i]), int(a[1].data[i]))
        assert got == want


def test_dist_sort_global_order():
    local = 50
    rng = np.random.default_rng(9)
    keys = rng.integers(-10**12, 10**12, (N_DEV, local)).astype(np.int64)
    keys[1, :10] = 7  # a run of ties across the bounds
    pay = np.arange(N_DEV * local, dtype=np.int32).reshape(N_DEV, local)
    shards = _fixed_shards([[keys[s], pay[s]] for s in range(N_DEV)])
    for bucket_cap in (0, 32):
        out, rn, ok = dist_sort(shards, [0], [T.LONG],
                                [SortOrder(True, True)], [local] * N_DEV,
                                CPU, bucket_cap=bucket_cap)
        if not bool(ok):
            assert bucket_cap  # only a tight granule may overflow
            continue
        got = [(int(c[0].data[i]), int(c[1].data[i]))
               for c, n in zip(out, rn) for i in range(int(n))]
        assert [k for k, _ in got] == sorted(keys.reshape(-1).tolist())
        assert sorted(p for _, p in got) == list(range(N_DEV * local))


@pytest.mark.parametrize("strategy", ["DIRECT", "SEARCH", "RADIX",
                                      "PALLAS"])
def test_dist_hash_join_inner(strategy):
    local = 40
    rng = np.random.default_rng(11)
    lk = rng.integers(0, 30, (N_DEV, local)).astype(np.int64)
    lv = rng.integers(0, 1000, (N_DEV, local)).astype(np.int64)
    rk = np.arange(N_DEV * 5, dtype=np.int64).reshape(N_DEV, 5) % 24
    rv = np.arange(N_DEV * 5, dtype=np.int64).reshape(N_DEV, 5) * 10
    out, cnt, ok = dist_hash_join(
        _fixed_shards([[lk[s], lv[s]] for s in range(N_DEV)]), [0],
        _fixed_shards([[rk[s], rv[s]] for s in range(N_DEV)]), [0],
        [T.LONG], [local] * N_DEV, [5] * N_DEV, CPU, out_cap=512,
        probe_strategy=strategy)
    assert bool(ok)
    got = sorted((int(c[0].data[i]), int(c[1].data[i]), int(c[2].data[i]),
                  int(c[3].data[i]))
                 for c, n in zip(out, cnt) for i in range(int(n)))
    want = sorted((int(a), int(b), int(c), int(d))
                  for a, b in zip(lk.reshape(-1), lv.reshape(-1))
                  for c, d in zip(rk.reshape(-1), rv.reshape(-1)) if a == c)
    assert got == want
    # a too-small output capacity reports overflow
    _, _, ok = dist_hash_join(
        _fixed_shards([[lk[s], lv[s]] for s in range(N_DEV)]), [0],
        _fixed_shards([[rk[s], rv[s]] for s in range(N_DEV)]), [0],
        [T.LONG], [local] * N_DEV, [5] * N_DEV, CPU, out_cap=4,
        probe_strategy=strategy)
    assert not bool(ok)
