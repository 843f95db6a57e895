"""The port's ``TpuShuffledHashJoinExec`` against the reference's, on the
CPU: every join type (and an inner join with a residual condition) over
the reference's torture datasets (``tests/test_join_strategies.py``
``_torture_datasets``: unique, duplicate-heavy, all-null, NaN / -0.0 keys,
empty build, empty probe), under each port strategy.

The reference runs once per dataset and join type (SEARCH, its general
path; cached), and every port strategy — SEARCH, DIRECT, RADIX, PALLAS (on
the probe kernel's plain version) and AUTO — must give the same rows IN
THE SAME ORDER: probe order, then sorted build order. Floats compare by
``repr``, so NaN matches NaN and -0.0 must stay -0.0.
"""
import functools

import pytest

import spark_rapids_tpu  # noqa: F401  (x64 enable)

from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.exec import InMemoryScanExec as JScan
from spark_rapids_tpu.exec.join import TpuShuffledHashJoinExec as JJoin
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import (ColumnarToRowExec, InMemoryScanExec,
                                         TpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.expr import expressions as E

from test_join_strategies import _torture_datasets

DATASETS = {d[0]: d[1:] for d in _torture_datasets()}
#: the six join types, plus an inner join with the residual b > a
JOINS = ("inner", "left", "right", "full", "semi", "anti", "inner_cond")
STRATEGIES = ("SEARCH", "DIRECT", "RADIX", "PALLAS", "AUTO")
#: the reference's compiled programs, shared between its execs of one
#: join type and schema (they compile the same programs)
_REF_JITS: dict = {}


def _norm(rows):
    return [tuple(repr(v) if isinstance(v, float) else v for v in r)
            for r in rows]


def _port_schema(jschema):
    return schema_of(**{f.name: getattr(T, type(f.dataType).__name__)()
                        for f in jschema.fields})


def _how(join):
    return "inner" if join == "inner_cond" else join


@functools.lru_cache(maxsize=None)
def _reference_rows(dataset, join):
    ld, lsch, rd, rsch = DATASETS[dataset]
    conf = JConf({"spark.rapids.tpu.sql.join.strategy": "SEARCH"})
    cond = (JE.GreaterThan(JE.col("b"), JE.col("a"))
            if join == "inner_cond" else None)
    j = JJoin(conf, JScan(conf, [[JBatch.from_pydict(ld, lsch)]], lsch),
              JScan(conf, [[JBatch.from_pydict(rd, rsch)]], rsch),
              [JE.col(lsch.fields[0].name)], [JE.col(rsch.fields[0].name)],
              _how(join), cond)
    j._jits = _REF_JITS.setdefault((join, repr(lsch), repr(rsch)), {})
    return _norm(j.collect())


def _port_join(dataset, join, strategy):
    ld, lsch, rd, rsch = DATASETS[dataset]
    pl, pr = _port_schema(lsch), _port_schema(rsch)
    conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": strategy})
    cond = (E.GreaterThan(E.col("b"), E.col("a"))
            if join == "inner_cond" else None)
    return TpuShuffledHashJoinExec(
        conf,
        InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
            ld, pl, device="cpu")]], pl),
        InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
            rd, pr, device="cpu")]], pr),
        [E.col(pl.fields[0].name)], [E.col(pr.fields[0].name)], _how(join),
        cond)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("join", JOINS)
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_join_rows_in_reference_order(dataset, join, strategy):
    want = _reference_rows(dataset, join)
    j = _port_join(dataset, join, strategy)
    got = _norm(j.collect())
    assert got == want, j.describe()
    if strategy != "AUTO":
        assert f"strategy={strategy}" in j.describe()


def test_output_schema_nullability_matches_reference():
    ld, lsch, rd, rsch = DATASETS["unique"]
    conf = JConf({})
    for how in ("inner", "left", "right", "full", "semi", "anti"):
        ref = JJoin(conf, JScan(conf, [[JBatch.from_pydict(ld, lsch)]], lsch),
                    JScan(conf, [[JBatch.from_pydict(rd, rsch)]], rsch),
                    [JE.col("k")], [JE.col("k2")], how)
        port = _port_join("unique", how, "AUTO")
        assert ([(f.name, f.nullable) for f in port.output_schema.fields]
                == [(f.name, f.nullable) for f in ref.output_schema.fields])


def test_left_out_join_shapes_raise():
    ld, lsch, rd, rsch = DATASETS["unique"]
    pl, pr = _port_schema(lsch), _port_schema(rsch)
    conf = RapidsConf({})
    scans = [InMemoryScanExec(conf, [[ColumnarBatch.from_pydict(
        d, s, device="cpu")]], s) for d, s in ((ld, pl), (rd, pr))]
    # co-partitioned builds are ported: a full outer join keeps its
    # probe side's partitions (one unmatched-build pass each)
    full = TpuShuffledHashJoinExec(conf, *scans, [E.col("k")],
                                   [E.col("k2")], "full", partitioned=True)
    assert full.num_partitions == scans[0].num_partitions
    # a keyed "cross" join runs as the reference's does: like inner
    cross = TpuShuffledHashJoinExec(conf, *scans, [E.col("k")],
                                    [E.col("k2")], "cross")
    inner = TpuShuffledHashJoinExec(conf, *scans, [E.col("k")],
                                    [E.col("k2")], "inner")
    assert sorted(map(repr, ColumnarToRowExec(conf, cross).collect())) == \
        sorted(map(repr, ColumnarToRowExec(conf, inner).collect()))
    with pytest.raises(ValueError, match="inner joins"):
        TpuShuffledHashJoinExec(conf, *scans, [E.col("k")], [E.col("k2")],
                                "left", E.GreaterThan(E.col("b"),
                                                      E.col("a")))
