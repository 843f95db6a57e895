"""The port's sort (``ops/sort.py``, ``exec/sort.py``) and limits against
the reference's, on the CPU.

``sort_permutation`` must give the reference's permutation exactly, pad
rows included, over int, long, double (NaN, +-0.0, subnormals, +-inf),
float, boolean and null keys, each ascending and descending with nulls
first and last, and over mixed multi-key orders; ``sort_cols`` the
reference's gathered columns. ``TpuSortExec`` (under a local limit) over
a multi-batch scan gives the reference exec's rows in the same order.
"""
import itertools

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.exec import InMemoryScanExec as JScan
from spark_rapids_tpu.exec.basic import TpuLocalLimitExec as JLimit
from spark_rapids_tpu.exec.sort import TpuSortExec as JSort
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr.eval import ColV as JColV
from spark_rapids_tpu.ops import sort as JS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import InMemoryScanExec
from spark_rapids_tpu_torch.exec.basic import TpuLocalLimitExec
from spark_rapids_tpu_torch.exec.sort import TpuSortExec
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.values import ColV
from spark_rapids_tpu_torch.ops import sort as S

CAP = 256
ROWS = 231  # pad rows sort last, in the reference's order too


def _key(kind, rng):
    if kind == "int":
        d = rng.integers(-5, 5, CAP).astype(np.int32)
        d[:4] = [-(2**31), 2**31 - 1, 0, -1]
    elif kind == "long":
        d = rng.integers(-4, 4, CAP).astype(np.int64) * (2**61)
        d[:4] = [-(2**63), 2**63 - 1, 0, -1]
    elif kind == "double":
        d = rng.choice([-1.5, 0.0, 2.0, 1e300], CAP)
        d[:8] = [np.nan, -0.0, 0.0, 5e-324, -1e-310, np.inf, -np.inf,
                 -np.nan]
    elif kind == "float":
        d = rng.choice([-1.5, 0.0, 2.0], CAP).astype(np.float32)
        d[:4] = [np.nan, -0.0, np.inf, 1e-45]
    else:  # boolean
        d = rng.random(CAP) < 0.5
    return d, rng.random(CAP) < 0.85


_DT = {"int": "INT", "long": "LONG", "double": "DOUBLE", "float": "FLOAT",
       "boolean": "BOOLEAN"}
ORDERS = [(a, nf) for a in (True, False) for nf in (None, True, False)]


def _perms(keys, kinds, orders, num_rows):
    ref = JS.sort_permutation(
        [JColV(jnp.asarray(d), jnp.asarray(v)) for d, v in keys],
        [getattr(JT, _DT[k]) for k in kinds],
        [JS.SortOrder(a, nf) for a, nf in orders], num_rows)
    got = S.sort_permutation(
        [ColV(torch.from_numpy(d.copy()), torch.from_numpy(v.copy()))
         for d, v in keys],
        [getattr(T, _DT[k]) for k in kinds],
        [S.SortOrder(a, nf) for a, nf in orders], num_rows)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("kind", sorted(_DT))
@pytest.mark.parametrize("order", ORDERS, ids=lambda o: f"{o[0]}-{o[1]}")
def test_one_key_permutation_matches_reference(kind, order):
    rng = np.random.default_rng(hash(kind) % 1000)
    ref, got = _perms([_key(kind, rng)], [kind], [order], ROWS)
    np.testing.assert_array_equal(got, ref)


MULTI = [("int", "double"), ("long", "boolean"), ("boolean", "int", "long"),
         ("double", "float", "int")]


@pytest.mark.parametrize("kinds", MULTI, ids="-".join)
def test_mixed_multi_key_permutation_matches_reference(kinds):
    rng = np.random.default_rng(len(kinds))
    keys = [_key(k, rng) for k in kinds]
    for orders in itertools.islice(
            itertools.product(ORDERS, repeat=len(kinds)), 0, None, 5):
        for n in (CAP, ROWS, 0):
            ref, got = _perms(keys, kinds, orders, n)
            np.testing.assert_array_equal(got, ref, err_msg=str(orders))


def test_device_row_count_and_live_mask():
    """A 0-d row count and a liveness mask (as the window exec passes)
    give the reference's permutation too."""
    rng = np.random.default_rng(3)
    d, v = _key("long", rng)
    live = rng.random(CAP) < 0.7
    ref = JS.sort_permutation([JColV(jnp.asarray(d), jnp.asarray(v))],
                              [JT.LONG], [JS.SortOrder(False, None)],
                              jnp.asarray(live))
    got = S.sort_permutation([ColV(torch.from_numpy(d), torch.from_numpy(v))],
                             [T.LONG], [S.SortOrder(False, None)],
                             torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = S.sort_permutation([ColV(torch.from_numpy(d), torch.from_numpy(v))],
                             [T.LONG], [S.SortOrder(True, False)],
                             torch.tensor(ROWS, dtype=torch.int32))
    ref = JS.sort_permutation([JColV(jnp.asarray(d), jnp.asarray(v))],
                              [JT.LONG], [JS.SortOrder(True, False)],
                              jnp.int32(ROWS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sort_cols_matches_reference():
    rng = np.random.default_rng(5)
    cols = [_key("int", rng), _key("double", rng), _key("long", rng)]
    orders = [(False, None), (True, False)]
    ref = JS.sort_cols([JColV(jnp.asarray(d), jnp.asarray(v))
                        for d, v in cols], [0, 2], [JT.INT, JT.LONG],
                       [JS.SortOrder(a, nf) for a, nf in orders], ROWS)
    got = S.sort_cols([ColV(torch.from_numpy(d), torch.from_numpy(v))
                       for d, v in cols], [0, 2], [T.INT, T.LONG],
                      [S.SortOrder(a, nf) for a, nf in orders], ROWS)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.validity.numpy(),
                                      np.asarray(r.validity))
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(r.data))


# ---------------------------------------------------------------------------
# the exec, over several batches, under a local limit
# ---------------------------------------------------------------------------
def _batch_data(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "k": [None if rng.random() < 0.1 else int(rng.integers(0, 6))
              for _ in range(n)],
        "x": [None if rng.random() < 0.1 else int(rng.integers(-2**62, 2**62))
              for _ in range(n)],
        "d": [float(v) for v in rng.choice([np.nan, -0.0, 0.0, 1.5, -2.0],
                                           n)],
    }


SCHEMA = dict(k="INT", x="LONG", d="DOUBLE")
EXEC_CASES = {
    "k_asc_x_desc": ([("k", True, None), ("x", False, None)], None),
    "d_desc_nulls_first": ([("d", False, True), ("k", True, False)], None),
    "x_limit_17": ([("x", True, None)], 17),
    "k_limit_past_rows": ([("k", False, None)], 10_000),
}


def _exec_rows(mod, case):
    keys, limit = EXEC_CASES[case]
    if mod == "ref":
        conf = JConf({})
        sch = JT.StructType(tuple(JT.StructField(n, getattr(JT, t))
                                  for n, t in SCHEMA.items()))
        batches = [JBatch.from_pydict(_batch_data(s, n), sch)
                   for s, n in ((1, 70), (2, 0), (3, 130), (4, 41))]
        scan, sort_, lim, col = JScan(conf, [batches], sch), JSort, JLimit, \
            JE.col
    else:
        conf = RapidsConf({})
        sch = schema_of(**{n: getattr(T, t) for n, t in SCHEMA.items()})
        batches = [ColumnarBatch.from_pydict(_batch_data(s, n), sch,
                                             device="cpu")
                   for s, n in ((1, 70), (2, 0), (3, 130), (4, 41))]
        scan = InMemoryScanExec(conf, [batches], sch)
        sort_, lim, col = TpuSortExec, TpuLocalLimitExec, E.col
    plan = sort_(conf, [col(k) for k, _, _ in keys],
                 [(a, nf) for _, a, nf in keys], scan)
    if limit is not None:
        plan = lim(conf, limit, plan)
    return plan, [tuple(repr(v) for v in r) for r in plan.collect()]


@pytest.mark.parametrize("case", sorted(EXEC_CASES))
def test_sort_exec_over_batches_matches_reference(case):
    jplan, ref = _exec_rows("ref", case)
    plan, got = _exec_rows("port", case)
    assert got == ref
    assert plan.tree_string() == jplan.tree_string()
