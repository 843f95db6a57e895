"""The port's generated docs (``plugin/docgen.py``) against its
registries and against the reference's.

``docs/torch/configs.md`` and ``docs/torch/supported_ops.md`` must be
what the port's registries generate now (the ``--check`` gate), its
supported-ops matrix must be the reference's cell for cell, and its conf
table must have the reference's row for every key both register (the
descriptions that name JAX APIs aside: the port's sources name none).
The two packages register the same keys.
"""
import os
import re

from spark_rapids_tpu.conf import _REGISTRY as JREG
from spark_rapids_tpu.plugin import docgen as JD
from spark_rapids_tpu_torch.conf import _REGISTRY as PREG
from spark_rapids_tpu_torch.plugin import docgen as PD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows_by_key(md: str) -> dict:
    """The conf table's rows (before any later section), by key."""
    table = md.split("\n## ")[0]
    return {ln.split(" | ")[0][2:]: ln for ln in table.splitlines()
            if ln.startswith("| spark.rapids.tpu.")}


def test_generated_docs_are_in_sync():
    assert PD.check_docs(os.path.join(ROOT, PD.DOCS_DIR)) == []
    assert PD.main(["--check", "--outdir",
                    os.path.join(ROOT, PD.DOCS_DIR)]) == 0


def test_supported_ops_equal_the_reference():
    """Cell for cell; the header names the module that regenerates it,
    and the native UDF's description says what the port's takes (a torch
    columnar function, where the reference's is a JAX/Pallas one)."""
    port = PD.supported_ops_md().splitlines()
    ref = JD.supported_ops_md().splitlines()
    assert len(port) == len(ref)
    differ = [i for i, (a, b) in enumerate(zip(port, ref)) if a != b]
    assert len(differ) == 2 and differ[0] == 2
    assert port[2] == ref[2].replace("spark_rapids_tpu.plugin.docgen",
                                     "spark_rapids_tpu_torch.plugin.docgen")
    i = differ[1]
    assert port[i].startswith("| NativeUDF |")
    assert port[i] == ref[i].replace("user JAX/Pallas columnar UDF",
                                     "user columnar UDF")


#: keys whose reference description names JAX APIs; the port's sources
#: name no JAX (tests/test_torch_package.py), so their descriptions are
#: the port's own
JAX_NAMING_KEYS = {
    "spark.rapids.tpu.aotCache.dir",
    "spark.rapids.tpu.aotCache.enabled",
    "spark.rapids.tpu.aotCache.maxBytes",
    "spark.rapids.tpu.mesh.devices",
    "spark.rapids.tpu.sql.agg.strategy",
    "spark.rapids.tpu.sql.join.strategy",
    "spark.rapids.tpu.sql.trace.enabled",
}


def test_configs_equal_the_reference():
    port = _rows_by_key(PD.configs_md())
    ref = _rows_by_key(JD.configs_md())
    for key in set(port) & set(ref):
        if key in JAX_NAMING_KEYS:
            assert "jax" in JREG[key].doc and "jax" not in PREG[key].doc
            cells = lambda row: row.split(" | ")[:2]  # noqa: E731
            assert cells(port[key]) == cells(ref[key]), key
        else:
            assert port[key] == ref[key], key
    assert set(port) <= set(ref)
    assert set(JREG) == set(PREG)
    for key, e in PREG.items():
        j = JREG[key]
        assert (e.default, e.internal) == (j.default, j.internal), key
        assert (e.doc == j.doc) is (key not in JAX_NAMING_KEYS), key
        assert tuple(e.valid_values or ()) == tuple(j.valid_values or ())
    # the port's notes follow the table, one row a noted key
    notes = PD.configs_md().split("\n## On the port\n")[1]
    noted = set(re.findall(r"^\| (spark\.rapids\.tpu\.[^ ]+) \|", notes,
                           re.M))
    assert noted == {k for k, e in PREG.items()
                     if e.port_note and not e.internal}
