"""Package boundary of the PyTorch/CUDA port.

* importing every port module leaves JAX and the reference package out of
  ``sys.modules`` (checked in a fresh interpreter);
* no port source (nor ``chip_smoke.py``) names ``jax`` or the reference
  package as a module;
* the entry points resolve ``device=None`` to the CUDA card and raise
  when there is none, instead of running on the CPU;
* a missing ``nvcc`` makes the kernel build raise instead of falling back.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "spark_rapids_tpu_torch"


#: every subpackage the import walk must reach
SUBPACKAGES = ("columnar", "cpu", "exec", "expr", "io", "obs", "ops", "plugin",
               "sql", "udf", "utils")


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for sub in {SUBPACKAGES!r}:\n"
        "    assert 'spark_rapids_tpu_torch.' + sub in sys.modules, sub\n"
        "assert 'spark_rapids_tpu_torch.udf.native' in sys.modules\n"
        "for mod in ('events', 'envinfo'):\n"
        "    assert 'spark_rapids_tpu_torch.' + mod in sys.modules, mod\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'spark_rapids_tpu'\n"
        "             or m.startswith('spark_rapids_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_port_source_names_jax_or_the_reference():
    pattern = re.compile(r"\bjax\b|\bspark_rapids_tpu\.|"
                         r"import spark_rapids_tpu\b")
    sources = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) + [
        ROOT / "chip_smoke.py"]
    assert len(sources) > 15
    assert PKG / "udf" / "native.py" in sources
    offenders = []
    for path in sources:
        for no, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.search(line):
                offenders.append(f"{path.relative_to(ROOT)}:{no}: {line}")
    assert not offenders, "\n".join(offenders)


def test_default_device_is_the_card_and_never_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import (ColumnarBatch,
                                                 batch_from_host_arrays,
                                                 resolve_device, schema_of)
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import InMemoryScanExec

    schema = schema_of(k=T.INT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColumnarBatch.from_pydict({"k": [1, 2]}, schema)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_from_host_arrays(schema, [np.zeros(128, np.int32)],
                               [np.ones(128, bool)], 128, 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InMemoryScanExec.from_pydict(RapidsConf({}), {"k": [1]}, schema)
    # asking for the CPU explicitly is the tests' way in
    b = ColumnarBatch.from_pydict({"k": [1, None]}, schema, device="cpu")
    assert b.columns[0].data.device.type == "cpu"
    assert b.to_rows() == [(1,), (None,)]


def _without_nvcc(monkeypatch, tmp_path, K):
    from spark_rapids_tpu_torch.ops import _cuda_build

    monkeypatch.setattr(K, "_LIB", None)
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from spark_rapids_tpu_torch.ops import groupby_kernels as K

    _without_nvcc(monkeypatch, tmp_path, K)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build_kernels()


def test_join_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from spark_rapids_tpu_torch.ops import join_kernels as K

    _without_nvcc(monkeypatch, tmp_path, K)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build_kernels()


def test_udf_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from spark_rapids_tpu_torch.ops import udf_kernels as K

    _without_nvcc(monkeypatch, tmp_path, K)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build_kernels()


def test_unknown_conf_key_rejected_like_the_reference():
    from spark_rapids_tpu_torch.conf import RapidsConf

    with pytest.raises(ValueError, match="unknown config key"):
        RapidsConf({"spark.rapids.tpu.sql.noSuchKey": 1})
    with pytest.raises(ValueError, match="not in allowed values"):
        RapidsConf({"spark.rapids.tpu.sql.agg.strategy": "FAST"})
    assert RapidsConf({"spark.other": 1}).shape_bucket_min == 128


def test_scan_without_batches_or_device_is_on_the_card():
    """A scan with nothing to take its device from is an entry point:
    device=None means the card, which raises here."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import schema_of
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import InMemoryScanExec

    schema = schema_of(k=T.INT)
    if torch.cuda.is_available():
        assert InMemoryScanExec(RapidsConf({}), [[]], schema).device.type \
            == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InMemoryScanExec(RapidsConf({}), [[]], schema)
    assert InMemoryScanExec(RapidsConf({}), [[]], schema,
                            device="cpu").device.type == "cpu"
