"""The native word-count UDF's hand-written Hopper kernel (K5) and its
plain PyTorch version.

Counterpart of the Pallas kernel in ``spark_rapids_tpu/udf/native.py``.
The CUDA C++ lives in ``csrc/udf_kernels.cu``; it is compiled for
``sm_90a`` by ``nvcc`` on first use into ``_build/`` and loaded with
``ctypes`` (``ops/_cuda_build.py``).

=====  ======================  ============================================
 K     wrapper                  replaces (spark_rapids_tpu/...)
=====  ======================  ============================================
 K5    :func:`word_starts`      udf/native.py ``_word_start_kernel``
                                (launched by ``_word_starts_pallas``)
=====  ======================  ============================================

Dispatch: the wrapper runs the plain version ONLY for tensors on the CPU
(the tests, and the reference comparison). For CUDA tensors it launches
the kernel or raises — no fallback. Each launch adds one to
:data:`LAUNCHES`; nothing else does.

Bound on an H100: bytes — each char read once and one int32 flag
written, 5 bytes per char.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional

import torch

from . import _cuda_build

SOURCE = _cuda_build.PKG / "csrc" / "udf_kernels.cu"
BUILD_DIR = _cuda_build.BUILD_DIR

#: kernel launches per wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {"word_starts": 0}
#: nvcc's output (``-Xptxas -v``) from the build this process loaded
BUILD_LOG: List[str] = []

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_kernels() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        so = _cuda_build.build_library(SOURCE, BUILD_DIR, BUILD_LOG)
        lib = ctypes.CDLL(str(so))
        vp = ctypes.c_void_p
        lib.srt_word_starts.argtypes = [vp, ctypes.c_int64, vp, vp]
        lib.srt_word_starts.restype = ctypes.c_int
        lib.srt_udf_error_string.argtypes = [ctypes.c_int]
        lib.srt_udf_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def is_space(b: torch.Tensor) -> torch.Tensor:
    """ASCII whitespace, the word delimiters of the reference's kernel:
    space, tab, newline, vertical tab, form feed, carriage return."""
    return (b == 0x20) | ((b >= 0x09) & (b <= 0x0D))


def word_starts_plain(chars: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: 1 where a byte is not whitespace and its
    predecessor is (the byte before the first counts as a space)."""
    sp = is_space(chars)
    prev_sp = torch.cat([torch.ones(1, dtype=torch.bool,
                                    device=chars.device), sp])[:-1]
    return (~sp & prev_sp).to(torch.int32)


def word_starts(chars: torch.Tensor) -> torch.Tensor:
    """K5: (nchars,) int32 word-start flags of a uint8 chars pool."""
    if chars.dtype != torch.uint8 or chars.dim() != 1:
        raise ValueError(f"word_starts takes a 1-D uint8 pool, got "
                         f"{chars.dtype} of shape {tuple(chars.shape)}")
    dev = chars.device
    if dev.type == "cpu":
        return word_starts_plain(chars)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lib = build_kernels()
    n = chars.shape[0]
    chars = chars.contiguous()
    if chars.data_ptr() % 4:  # the kernel loads four bytes at a time
        chars = chars.clone()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.srt_word_starts(chars.data_ptr(), n, out.data_ptr(),
                                 _cuda_build.stream(dev))
    _cuda_build.check_launch(lib.srt_udf_error_string, rc, "word_starts")
    LAUNCHES["word_starts"] += 1
    return out
