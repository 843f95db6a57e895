"""The native word-count UDF's hand-written Hopper kernel (K5) and its
plain PyTorch version.

Counterpart of the Pallas kernel in ``spark_rapids_tpu/udf/native.py``
together with the ragged row reduction that consumes its flags there. The
CUDA C++ lives in ``csrc/udf_kernels.cu``; it is compiled for ``sm_90a``
by ``nvcc`` on first use into ``_build/`` and loaded with ``ctypes``
(``ops/_cuda_build.py``).

=====  ======================  ============================================
 K     wrapper                  replaces (spark_rapids_tpu/...)
=====  ======================  ============================================
 K5    :func:`word_counts`      udf/native.py ``_word_start_kernel``
                                (launched by ``_word_starts_pallas``) and
                                the prefix-sum row reduction of
                                ``_word_count_columnar``
=====  ======================  ============================================

Dispatch: the wrapper runs the plain version ONLY for tensors on the CPU
(the tests, and the reference comparison). For CUDA tensors it launches
the kernel or raises — no fallback. Each launch adds one to
:data:`LAUNCHES`; nothing else does.

Bound on an H100: bytes — the live chars read once, plus 4 bytes of
offsets and 4 bytes of output per row.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional

import torch

from .. import kernel_cost as _kernel_cost
from . import _cuda_build

SOURCE = _cuda_build.PKG / "csrc" / "udf_kernels.cu"
BUILD_DIR = _cuda_build.BUILD_DIR

#: kernel launches per wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {"word_counts": 0}
#: nvcc's output (``-Xptxas -v``) from the build this process loaded
BUILD_LOG: List[str] = []
#: the library's C symbols (a loaded library lacking one is refused)
SYMBOLS = ("srt_word_counts",
           "srt_udf_error_string",)

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


#: guards :data:`LAUNCHES`: sessions on several threads launch at once,
#: and ``+=`` on a dict entry can lose an increment when threads switch
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """Add one launch of ``name`` to :data:`LAUNCHES` (called once by
    the wrapper, just after its kernel launched)."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def build_kernels() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = _cuda_build.load_library(SOURCE, BUILD_DIR, BUILD_LOG,
                                       SYMBOLS)
        vp = ctypes.c_void_p
        lib.srt_word_counts.argtypes = [vp, ctypes.c_int64, vp,
                                        ctypes.c_int64, vp, vp]
        lib.srt_word_counts.restype = ctypes.c_int
        lib.srt_udf_error_string.argtypes = [ctypes.c_int]
        lib.srt_udf_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def is_space(b: torch.Tensor) -> torch.Tensor:
    """ASCII whitespace, the word delimiters of the reference's kernel:
    space, tab, newline, vertical tab, form feed, carriage return."""
    return (b == 0x20) | ((b >= 0x09) & (b <= 0x0D))


def word_starts_plain(chars: torch.Tensor) -> torch.Tensor:
    """Per-byte word-start flags, the reference's ``_word_start_kernel``:
    1 where a byte is not whitespace and its predecessor is (the byte
    before the first counts as a space)."""
    sp = is_space(chars)
    prev_sp = torch.cat([torch.ones(1, dtype=torch.bool,
                                    device=chars.device), sp])[:-1]
    return (~sp & prev_sp).to(torch.int32)


def word_starts(chars: torch.Tensor) -> torch.Tensor:
    """(nchars,) int32 word-start flags of a uint8 chars pool on the CPU.
    No path runs it on the card: there the flags stay in the registers of
    K5 (:func:`word_counts`)."""
    if chars.dtype != torch.uint8 or chars.dim() != 1:
        raise ValueError(f"word_starts takes a 1-D uint8 pool, got "
                         f"{chars.dtype} of shape {tuple(chars.shape)}")
    if chars.device.type != "cpu":
        raise ValueError(f"no kernel for device {chars.device}: on the card "
                         "the word count runs fused in word_counts")
    return word_starts_plain(chars)


def word_counts_plain(offsets: torch.Tensor,
                      chars: torch.Tensor) -> torch.Tensor:
    """Plain version of K5, the reference's chain: word-start flags over
    the pool, an int32 prefix sum, its difference at the row offsets
    (clamped to the pool), and a fix for rows that start mid-pool with a
    non-space byte after a non-space byte."""
    nch = chars.shape[0]
    dev = chars.device
    flags = word_starts_plain(chars)
    # int32 as the reference (its totals stay below 2^31 bytes)
    P = torch.empty(nch + 1, dtype=torch.int32, device=dev)
    P[:1] = 0
    torch.cumsum(flags, 0, dtype=torch.int32, out=P[1:])
    lo = offsets[:-1].clamp(0, nch).long()
    hi = offsets[1:].clamp(0, nch).long()
    counts = P[hi] - P[lo]
    if nch == 0:
        return counts
    last = nch - 1
    first = chars[lo.clamp(0, last)]
    prev = chars[(lo - 1).clamp(0, last)]
    fix = (hi > lo) & ~is_space(first) & (lo > 0) & ~is_space(prev)
    return (counts + fix.to(torch.int32)).to(torch.int32)


def word_counts_bytes(offsets: torch.Tensor):
    """K5's byte model, what the word count needs: the live chars read
    once, 4 bytes of offsets and 4 of output per row."""
    rows = offsets.shape[0] - 1
    return (offsets[-1] - offsets[0]).to(torch.int64) + 8 * rows


def word_counts(offsets: torch.Tensor, chars: torch.Tensor) -> torch.Tensor:
    """K5: (rows,) int32 word counts of a string column's rows
    (``offsets`` (rows+1,) int32, ``chars`` the uint8 pool). Offsets are
    clamped to [0, len(chars)]; bytes past ``offsets[rows]`` are never
    read."""
    if chars.dtype != torch.uint8 or chars.dim() != 1:
        raise ValueError(f"word_counts takes a 1-D uint8 pool, got "
                         f"{chars.dtype} of shape {tuple(chars.shape)}")
    if offsets.dim() != 1 or offsets.shape[0] < 1 or (
            offsets.is_floating_point() or offsets.dtype == torch.bool):
        raise ValueError(f"word_counts takes (rows+1,) integer offsets, got "
                         f"{offsets.dtype} of shape {tuple(offsets.shape)}")
    dev = chars.device
    if offsets.device != dev:
        raise ValueError(f"offsets on {offsets.device}, chars on {dev}")
    if dev.type == "cpu":
        return word_counts_plain(offsets, chars)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lib = build_kernels()
    rows, nch = offsets.shape[0] - 1, chars.shape[0]
    if rows == 0 or nch == 0:  # no row holds a byte: nothing to launch
        return torch.zeros(rows, dtype=torch.int32, device=dev)
    if nch >= 2**31 - 4096:
        raise ValueError(f"word_counts takes pools below 2^31 - 4096 "
                         f"bytes, got {nch}")
    off = offsets.to(torch.int32).contiguous()
    chars = chars.contiguous()
    if chars.data_ptr() % 16:  # the kernel loads 16 bytes at a time
        chars = chars.clone()
    out = torch.empty(rows, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev), _kernel_cost.kernel_launch(
            "word_counts", lambda: word_counts_bytes(off)):
        rc = lib.srt_word_counts(off.data_ptr(), rows, chars.data_ptr(), nch,
                                 out.data_ptr(), _cuda_build.stream(dev))
    _cuda_build.check_launch(lib.srt_udf_error_string, rc, "word_counts")
    count_launch("word_counts")
    return out
