"""Dictionary-encoded join keys and payloads in the port against the
reference, on the CPU.

``TpuShuffledHashJoinExec`` with a DictV key and a DictV payload on both
sides (the build's keys repeat, so the expansion repeats rows), over two
probe batches and two build batches, each batch with its own
dictionaries: the build materializes (reference ``join.py:214-220``), the
probe keys enter the radix words as plain strings (``:704-710``), and
the probe's payloads materialize before the expansion (``:778-783``) but
stay encoded where the probe only drops rows. The reference runs once per
join type (SEARCH); every port tier must give its rows in its order, and
the same rows as the plain layout. An int-keyed join carries DictV
payloads through the fused fast paths. Everything here is exact.
"""
import functools
import random

import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import \
    column_from_pylist as jcolumn_from_pylist
from spark_rapids_tpu.columnar.column import \
    dict_column_from_pylist as jdict_from_pylist
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.exec import InMemoryScanExec as JScan
from spark_rapids_tpu.exec.join import TpuShuffledHashJoinExec as JJoin
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (ColumnarBatch,
                                             column_from_pylist,
                                             dict_column_from_pylist)
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                         TpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.expr import expressions as E

JOINS = ("inner", "left", "right", "full", "semi", "anti", "inner_cond")
STRATEGIES = ("SEARCH", "DIRECT", "RADIX", "PALLAS", "AUTO")
KEYS = ["", "a", "ab", "abcde", "abcdefgh", "日本語", "zz", "q", "é", "x"]
PAYLOADS = ["red", "green", "", "blue-ish", "ü"]


def _side(n, seed, key_pool, suffix=""):
    rng = random.Random(seed)

    def maybe(pool, p):
        return None if rng.random() < p else rng.choice(pool)

    return {f"k{suffix}": [maybe(key_pool, 0.1) for _ in range(n)],
            f"a{suffix}": [rng.randrange(50) for _ in range(n)],
            f"p{suffix}": [maybe(PAYLOADS, 0.2) for _ in range(n)]}


#: probe: 2 batches of 40 and 25 rows; build: 2 batches of 12 and 9 rows
#: over fewer keys (duplicates, so matched probe rows repeat)
PROBE = [_side(40, 1, KEYS[:9]), _side(25, 2, KEYS[:9])]
BUILD = [_side(12, 3, KEYS[:6] + ["x"], "2"), _side(9, 4, KEYS[2:7], "2")]


def _types(TT, key_dtype):
    return [key_dtype, TT.LONG, TT.STRING]


def _batches(parts, suffix, dictionary, engine, key_dtype=None):
    """The batches of one side in one engine: string columns
    dictionary-encoded (``dictionary``) or plain."""
    TT = JT if engine == "jax" else T
    names = [f"k{suffix}", f"a{suffix}", f"p{suffix}"]
    types = _types(TT, key_dtype or TT.STRING)
    schema = TT.StructType(tuple(TT.StructField(n, t)
                                 for n, t in zip(names, types)))
    out = []
    for part in parts:
        cols = []
        for nm, dt in zip(names, types):
            vals = part[nm]
            if key_dtype is not None and nm == names[0]:
                vals = [None if v is None else KEYS.index(v) for v in vals]
            if isinstance(dt, (JT.StringType, T.StringType)) and dictionary:
                cols.append(jdict_from_pylist(vals, dt) if engine == "jax"
                            else dict_column_from_pylist(vals, dt,
                                                         device="cpu"))
            else:
                cols.append(jcolumn_from_pylist(vals, dt) if engine == "jax"
                            else column_from_pylist(vals, dt, device="cpu"))
        n = len(part[names[0]])
        out.append((JBatch if engine == "jax" else ColumnarBatch)(
            cols, schema, n))
    return out, schema


def _how(join):
    return "inner" if join == "inner_cond" else join


def _join(engine, conf, join, dictionary, key_dtype=None):
    M = JE if engine == "jax" else E
    Scan = JScan if engine == "jax" else InMemoryScanExec
    Join = JJoin if engine == "jax" else TpuShuffledHashJoinExec
    lb, ls = _batches(PROBE, "", dictionary, engine, key_dtype)
    rb, rs = _batches(BUILD, "2", dictionary, engine, key_dtype)
    cond = (M.GreaterThan(M.col("a2"), M.col("a"))
            if join == "inner_cond" else None)
    return Join(conf, Scan(conf, [lb], ls), Scan(conf, [rb], rs),
                [M.col("k")], [M.col("k2")], _how(join), cond)


@functools.lru_cache(maxsize=None)
def _reference_rows(join):
    conf = JConf({"spark.rapids.tpu.sql.join.strategy": "SEARCH"})
    return _join("jax", conf, join, True).collect()


@functools.lru_cache(maxsize=None)
def _plain_rows(join, strategy):
    conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": strategy})
    return _join("torch", conf, join, False).collect()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("join", JOINS)
def test_dict_join_rows_in_reference_order(join, strategy):
    conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": strategy})
    j = _join("torch", conf, join, True)
    got = j.collect()
    assert got == _reference_rows(join), j.describe()
    assert got == _plain_rows(join, strategy)
    if strategy != "AUTO":
        assert f"strategy={strategy}" in j.describe()
    # duplicate build keys: matched probe rows repeat
    if join in ("inner", "left", "full"):
        assert len({r[:3] for r in got}) < len(got)


@pytest.mark.parametrize("join", ["semi", "anti"])
def test_row_dropping_probe_keeps_its_dictionaries(join):
    """Semi and anti joins only drop probe rows: the probe's DictV key
    and payload come out encoded."""
    j = _join("torch", RapidsConf({}), join, True)
    out = [b for p in range(j.num_partitions)
           for b in j.execute_partition(p)]
    assert out and all(b.columns[0].is_dict and b.columns[2].is_dict
                       for b in out)
    assert [r for b in out for r in b.to_rows()] == _reference_rows(join)


@pytest.mark.parametrize("strategy", ["DIRECT", "RADIX", "AUTO"])
@pytest.mark.parametrize("join", ["inner", "left", "semi", "anti"])
def test_int_key_join_carries_dict_payloads(join, strategy):
    """An int key (the key pool's index) with DictV payloads on both
    sides: the reference's rows in its order. Semi and anti joins fuse
    into the probe's chain and keep the probe's payload encoded."""
    rconf = JConf({"spark.rapids.tpu.sql.join.strategy": "SEARCH"})
    want = _join("jax", rconf, join, True, JT.INT).collect()
    conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": strategy})
    j = _join("torch", conf, join, True, T.INT)
    out = [b for p in range(j.num_partitions)
           for b in j.execute_partition(p)]
    assert [r for b in out for r in b.to_rows()] == want, j.describe()
    if join in ("semi", "anti"):
        assert all(b.columns[2].is_dict for b in out)


def test_a_row_repeating_gather_needs_dictionaries_materialized():
    """``filter_gather.gather`` moves a DictV's codes for a row subset;
    one whose indices repeat rows (``repeats=True``, the expansion's)
    raises on a DictV, since ``mat_cap`` bounds row subsets only."""
    import torch

    from spark_rapids_tpu_torch.expr.values import DictV, as_plain_str
    from spark_rapids_tpu_torch.ops import filter_gather as FG

    v = dict_column_from_pylist(["b", None, "a"], device="cpu").dictv
    idx = torch.tensor([2, 0, 0, 2] + [0] * 124, dtype=torch.int32)
    live = torch.arange(128) < 4
    [sub] = FG.gather([v], idx, live)
    assert isinstance(sub, DictV) and sub.dictionary is v.dictionary
    with pytest.raises(ValueError, match="materialized"):
        FG.gather([v], idx, live, repeats=True)
    [plain] = FG.gather([as_plain_str(v)], idx, live, [128], repeats=True)
    off = plain.offsets
    assert [bytes(plain.chars[off[i]:off[i + 1]].tolist()).decode()
            for i in range(4)] == ["a", "b", "b", "a"]
