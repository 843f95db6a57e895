"""Building and binding the port's CUDA C++ kernel libraries.

Each ``csrc/*.cu`` source has a plain C interface. On first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under the
git-ignored ``_build/`` (named by a hash of the source, so an edited
source rebuilds) and loaded with ``ctypes``. A missing ``nvcc`` raises:
there is no fallback. Kernels launch on PyTorch's current stream and
return the launch's ``cudaError_t``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
#: shared memory one block may opt into on an H100 (227 KB), after
#: ``cudaFuncSetAttribute``; the kernels' planners size their tables by it
BLOCK_SMEM = 232_448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc(source: Path) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"nvcc not found: the kernels are built from {source} "
                       "on first use and need the CUDA toolkit")


def build_library(source: Path, build_dir: Path, log: List[str]) -> Path:
    """Compile ``source`` once per content into ``build_dir`` and return
    the library's path; ``nvcc``'s output (``-Xptxas -v``: registers,
    shared memory, spills) is appended to ``log``."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    so = build_dir / f"lib{source.stem}_{tag}.so"
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(source), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr}{res.stdout}")
        log.append(res.stderr + res.stdout)
        os.replace(tmp, so)
    return so


def check_launch(error_string, rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error; ``error_string`` is the
    library's ``cudaGetErrorString`` binding."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{error_string(rc).decode()}")


def ptrs(tensors: Sequence[torch.Tensor]):
    """A C array of the tensors' device pointers."""
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[t.data_ptr() for t in tensors])


def stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
