"""Building and binding the port's CUDA C++ kernel libraries.

Each ``csrc/*.cu`` source has a plain C interface. On first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under the
git-ignored ``_build/`` (named by a hash of the source, so an edited
source rebuilds) and loaded with ``ctypes``. A missing ``nvcc`` raises:
there is no fallback. Kernels launch on PyTorch's current stream and
return the launch's ``cudaError_t``.

With the persistent kernel-library cache installed
(``serve/program_cache.py``, ``spark.rapids.tpu.aotCache.*``),
:func:`load_library` takes the library from the cache's directory instead
and builds, with ``nvcc``, only on a miss. Every ``nvcc`` run is a
compile miss: it emits one ``compile_miss`` event (the site is the
library's stem) and its live twin, which feeds the watchdog's
recompile-storm rule, and it passes the ``compile`` fault channel first.
The time each load took, and whether it came from the cache, is kept per
thread for the cost plane (``kernel_cost.py``: a harvested call's
``compile_ms``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

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


_VERSION_LOCK = threading.Lock()
_VERSION: Dict[str, Optional[str]] = {}


def compiler_version() -> Optional[str]:
    """The last line of ``nvcc --version`` (once per process), or None
    when no ``nvcc`` is found: the kernel-library cache's identity names
    the compiler that built an entry."""
    with _VERSION_LOCK:
        if "nvcc" not in _VERSION:
            try:
                out = subprocess.run([nvcc(Path("nvcc")), "--version"],
                                     capture_output=True, text=True,
                                     check=True).stdout
                _VERSION["nvcc"] = out.strip().splitlines()[-1].strip()
            except (RuntimeError, OSError, subprocess.CalledProcessError):
                _VERSION["nvcc"] = None
        return _VERSION["nvcc"]


# -- compile misses ----------------------------------------------------------
_MISS_LOCK = threading.Lock()
#: ``nvcc`` runs in this process, by library stem
COMPILE_MISSES: Dict[str, int] = {}


def note_compile_miss(stem: str) -> None:
    """Count one library build: the ``compile_miss`` event and its live
    twin (the watchdog's recompile-storm feed)."""
    from .. import events as _events
    from .. import obs as _obs

    with _MISS_LOCK:
        COMPILE_MISSES[stem] = COMPILE_MISSES.get(stem, 0) + 1
        total = sum(COMPILE_MISSES.values())
    _events.emit("compile_miss", site=stem, total=total)
    if _obs.enabled():
        _obs.note_compile_miss(stem)


def compile_miss_count() -> int:
    with _MISS_LOCK:
        return sum(COMPILE_MISSES.values())


def nvcc_compile(source: Path, out: Path, log: List[str]) -> None:
    """Run ``nvcc`` on ``source`` into ``out`` (the ``compile`` fault
    channel first); ``nvcc``'s output is appended to ``log``."""
    from .. import faults as _faults

    if _faults.enabled():
        _faults.check("compile", source.stem)
    cmd = [nvcc(source), *NVCC_FLAGS, "-o", str(out), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stderr}{res.stdout}")
    log.append(res.stderr + res.stdout)
    note_compile_miss(source.stem)


def build_library(source: Path, build_dir: Path, log: List[str]) -> Path:
    """Compile ``source`` once per content into ``build_dir`` and return
    the library's path; ``nvcc``'s output (``-Xptxas -v``: registers,
    shared memory, spills) is appended to ``log``."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    so = build_dir / f"lib{source.stem}_{tag}.so"
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        nvcc_compile(source, tmp, log)
        os.replace(tmp, so)
    return so


def open_library(path: Path, symbols: Sequence[str]) -> ctypes.CDLL:
    """Load a library and require each of ``symbols`` (AttributeError
    when one is missing)."""
    lib = ctypes.CDLL(str(path))
    for s in symbols:
        getattr(lib, s)
    return lib


# -- loads, for the cost plane -------------------------------------------------
_LOADS = threading.local()


def load_stats() -> tuple:
    """(nanoseconds, libraries from the cache, build milliseconds those
    saved) of the library loads this thread made so far."""
    return (getattr(_LOADS, "ns", 0), getattr(_LOADS, "cached", 0),
            getattr(_LOADS, "saved_ms", 0.0))


def load_library(source: Path, build_dir: Path, log: List[str],
                 symbols: Sequence[str]) -> ctypes.CDLL:
    """The loaded library of ``source``: from the kernel-library cache
    when one is installed (built and stored there on a miss), else built
    into ``build_dir`` as :func:`build_library` does."""
    from ..serve import program_cache as _progcache

    t0 = time.perf_counter_ns()
    pc = _progcache.active() if _progcache.enabled() else None
    if pc is None:
        lib, cached, saved = open_library(
            build_library(source, build_dir, log), symbols), 0, 0.0
    else:
        lib, saved = pc.load_library(source, log, symbols)
        cached = 1 if saved is not None else 0
    _LOADS.ns = getattr(_LOADS, "ns", 0) + time.perf_counter_ns() - t0
    _LOADS.cached = getattr(_LOADS, "cached", 0) + cached
    _LOADS.saved_ms = getattr(_LOADS, "saved_ms", 0.0) + (saved or 0.0)
    return lib


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
