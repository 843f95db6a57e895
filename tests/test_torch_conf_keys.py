"""The conf keys the port registers in this slice, against the
reference's: the keys the reference only registers and documents,
``RapidsConf.batch_size_bytes``, the tool allowlists, the session's
lock-order witness (``tools.racecheck.witness.enabled``) and the type
matrix's cross-check against the lowering probe
(``sql.matrix.probeCrossCheck.enabled``, ``plugin/typechecks``'s
cross-check log).
"""
import pytest

from spark_rapids_tpu import conf as JC
from spark_rapids_tpu.plugin import typechecks as JTC
from spark_rapids_tpu.sql import TpuSession as JSession
from spark_rapids_tpu_torch import conf as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.plugin import overrides as PO
from spark_rapids_tpu_torch.plugin import typechecks as PTC
from spark_rapids_tpu_torch.sql import TpuSession as PSession
from spark_rapids_tpu_torch.utils import locks as PL

CROSS = {"spark.rapids.tpu.sql.matrix.probeCrossCheck.enabled": True}

#: the keys this slice registers, each with a value a session takes
NEW_KEYS = {
    "spark.rapids.tpu.sql.incompatibleOps.enabled": True,
    "spark.rapids.tpu.sql.hasNans": False,
    "spark.rapids.tpu.sql.castFloatToString.enabled": True,
    "spark.rapids.tpu.sql.replaceSortMergeJoin.enabled": False,
    "spark.rapids.tpu.sql.hashAgg.replaceMode": "partial",
    "spark.rapids.tpu.sql.stableSort.enabled": False,
    "spark.rapids.tpu.sql.batchSizeBytes": 1 << 20,
    "spark.rapids.tpu.shuffle.bounceBuffers.size": 1 << 16,
    "spark.rapids.tpu.tools.lint.allowlistPath": "x.txt",
    "spark.rapids.tpu.tools.racecheck.allowlistPath": "y.txt",
    "spark.rapids.tpu.tools.racecheck.witness.enabled": False,
    "spark.rapids.tpu.sql.matrix.probeCrossCheck.enabled": True,
    "spark.rapids.tpu.sql.exportColumnarRdd": True,
}


@pytest.mark.parametrize("key", sorted(NEW_KEYS))
def test_new_key_is_the_reference_entry(key):
    import spark_rapids_tpu.ml  # noqa: F401 — registers exportColumnarRdd
    import spark_rapids_tpu_torch.ml  # noqa: F401

    p, j = PC._REGISTRY[key], JC._REGISTRY[key]
    assert (p.default, p.doc, p.internal) == (j.default, j.doc, j.internal)
    v = NEW_KEYS[key]
    assert PSession({key: v}, device="cpu").conf._values[key] == v
    assert JSession({key: v}).conf._values[key] == v


def test_batch_size_bytes():
    key = "spark.rapids.tpu.sql.batchSizeBytes"
    assert PC.RapidsConf({}).batch_size_bytes == 1 << 31
    assert PC.RapidsConf({key: "4096"}).batch_size_bytes == 4096
    assert JC.RapidsConf({key: "4096"}).batch_size_bytes == 4096
    with pytest.raises(ValueError, match="must be positive"):
        PC.RapidsConf({key: 0})
    with pytest.raises(ValueError, match="not in allowed values"):
        PC.RapidsConf({"spark.rapids.tpu.sql.hashAgg.replaceMode": "x"})


def test_race_witness_key_installs_the_witness():
    PL.uninstall_witness()
    try:
        PSession({}, device="cpu")
        assert PL._WITNESS is None
        PSession({"spark.rapids.tpu.tools.racecheck.witness.enabled": True},
                 device="cpu")
        w = PL._WITNESS
        assert w is not None
        sess = PSession({}, device="cpu")
        sess.range(0, 100).where(E.GreaterThan(E.col("id"), E.lit(5))
                                 ).collect()
        assert PL._WITNESS is w
    finally:
        PL.uninstall_witness()


def _query(m, sess):
    T_, E_ = m
    schema = T_.StructType([T_.StructField("a", T_.LONG),
                            T_.StructField("s", T_.STRING)])
    df = sess.create_dataframe({"a": [1, 2, None], "s": ["x", None, "z"]},
                               schema)
    return df.where(E_.IsNotNull(E_.col("a"))).select(
        E_.Alias(E_.Add(E_.col("a"), E_.lit(1)), "a1"),
        E_.Alias(E_.Upper(E_.col("s")), "u"))


def test_cross_check_logs_nothing_on_clean_plans():
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.expr import expressions as JE

    PTC.clear_cross_check_log()
    JTC.clear_cross_check_log()
    got = _query((T, E), PSession(CROSS, device="cpu")).collect()
    want = _query((JT, JE), JSession(CROSS)).collect()
    assert got == want == [(2, "X"), (3, None)]
    assert PTC.cross_check_log() == JTC.cross_check_log() == []


def test_cross_check_records_a_probe_fallback(monkeypatch):
    """The probe refuses an expression the matrix accepts: the
    disagreement is logged and the expression falls back to the CPU
    engine, with the probe's reason, as in the reference."""
    real = PO.tpu_supports

    def probe(expr, schema):
        if any(isinstance(n, E.Upper) for n in _walk(expr)):
            return False, "probe refuses Upper"
        return real(expr, schema)

    monkeypatch.setattr(PO, "tpu_supports", probe)
    PTC.clear_cross_check_log()
    try:
        sess = PSession(CROSS, device="cpu")
        rows = _query((T, E), sess).collect()
        log = PTC.cross_check_log()
        text = _query((T, E), sess).explain()
    finally:
        PTC.clear_cross_check_log()
    assert rows == [(2, "X"), (3, None)]
    assert any(ln.startswith("Alias: matrix=ON_TPU(-) probe=FALLBACK("
                             "probe refuses Upper") for ln in log), log
    assert "probe refuses Upper" in text
    # off (the default), the probe never runs
    PTC.clear_cross_check_log()
    _query((T, E), PSession({}, device="cpu")).collect()
    assert PTC.cross_check_log() == []


def test_cross_check_records_an_unported_node(monkeypatch):
    """Where the port's lowering raises NotImplementedError (a node it
    has not ported), the probe records a probe that raised, and the
    planner still raises instead of falling back."""
    real = PO.tpu_supports

    def probe(expr, schema):
        if any(isinstance(n, E.Upper) for n in _walk(expr)):
            raise NotImplementedError("Upper is not ported")
        return real(expr, schema)

    monkeypatch.setattr(PO, "tpu_supports", probe)
    PTC.clear_cross_check_log()
    try:
        with pytest.raises(NotImplementedError, match="not ported"):
            _query((T, E), PSession(CROSS, device="cpu")).collect()
        log = PTC.cross_check_log()
    finally:
        PTC.clear_cross_check_log()
    assert any("probe=FALLBACK(lowering probe raised: Upper is not "
               "ported)" in ln for ln in log), log


def test_cross_check_log_is_bounded():
    PTC.clear_cross_check_log()
    for i in range(PTC._CROSS_CHECK_MAX + 10):
        PTC.note_cross_check_disagreement(f"m{i}")
    log = PTC.cross_check_log()
    assert len(log) == PTC._CROSS_CHECK_MAX and log[0] == "m0"
    log.append("not kept")
    assert len(PTC.cross_check_log()) == PTC._CROSS_CHECK_MAX
    PTC.clear_cross_check_log()
    assert PTC.cross_check_log() == []


def _walk(e):
    yield e
    for c in e.children:
        yield from _walk(c)
