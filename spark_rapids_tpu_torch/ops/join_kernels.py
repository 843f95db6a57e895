"""The hash-join probe's hand-written Hopper kernel (K4) and its plain
PyTorch version.

Counterpart of ``spark_rapids_tpu/ops/pallas_join.py`` (the PALLAS tier
of ``ops/join.probe_ranges``). The CUDA C++ lives in
``csrc/join_kernels.cu``; it is compiled for ``sm_90a`` by ``nvcc`` on
first use into ``_build/`` and loaded with ``ctypes``
(``ops/_cuda_build.py``).

=====  ======================  ============================================
 K     wrapper                  replaces (spark_rapids_tpu/...)
=====  ======================  ============================================
 K4    :func:`probe_ranges`     ops/pallas_join.py ``_probe_kernel``
                                (driver ``pallas_probe_ranges``)
=====  ======================  ============================================

Dispatch: the wrapper runs the plain version ONLY for tensors on the CPU
(the tests, and the reference comparison). For CUDA tensors it launches
the kernel or raises — no fallback. Each launch adds one to
:data:`LAUNCHES`; nothing else does.

Bound on an H100: bytes. The probe needs each probe row's u32 key words
(4 bytes each) and its liveness byte, writes two int32s, and reads the
build's packed u64 keys: (4 x words + 9) bytes per probe row + 8 bytes
per build row. The wrapper passes the words as the int64 tensors they
ride in, so the kernel reads 8 bytes per word: (8 x words + 9) bytes per
probe row as called. It looks each key up instead of the TPU kernel's
O(probe x build) tiled equality mask: a bucket index over the live keys'
span in shared memory (:func:`plan_probe`), then the few build rows of
the probe's bucket from L2; see the .cu notes.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import kernel_cost as _kernel_cost
from . import _cuda_build
from ._cuda_build import BLOCK_SMEM

SOURCE = _cuda_build.PKG / "csrc" / "join_kernels.cu"
BUILD_DIR = _cuda_build.BUILD_DIR

#: kernel launches per wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {"probe_ranges": 0}
#: nvcc's output (``-Xptxas -v``) from the build this process loaded
BUILD_LOG: List[str] = []
#: the library's C symbols (a loaded library lacking one is refused)
SYMBOLS = ("srt_probe_ranges",
           "srt_join_error_string",)
#: elements of the plain version's equality mask per chunk of probe rows
PLAIN_CHUNK_ELEMS = 1 << 24
#: log2 of the largest bucket index the planner picks: 2^15 + 1 u32
#: bounds, 128 KB of each block's shared memory
MAX_LOG2_BUCKETS = 15

_M32 = 0xFFFFFFFF
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
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.srt_probe_ranges.argtypes = [vp, vp, vp, i64, vp, vp, i64, i32,
                                         vp, i64, i32, vp, vp, vp, vp, vp, vp]
        lib.srt_probe_ranges.restype = i32
        lib.srt_join_error_string.argtypes = [i32]
        lib.srt_join_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def pack_key(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """One or two u32 key words (int64 tensors) as one u64 key, in an
    int64 tensor's bit pattern: ``hi << 32 | lo`` (reference
    ``ops/join._pack_u64``)."""
    if len(words) == 1:
        return words[0].to(torch.int64)
    return (words[0].to(torch.int64) << 32) | (words[1].to(torch.int64)
                                               & _M32)


def plan_probe(nb: int, budget: int = BLOCK_SMEM) -> int:
    """K4's bucket index for ``nb`` build rows: log2 of its bucket count,
    the next power of two >= nb, at least 2 and at most 2^15, and
    smaller while the index (2^r + 1 u32 in each block's shared memory)
    would not fit ``budget`` bytes. The kernel cuts the live keys' span
    into these buckets; bucket b holds rows [index[b], index[b + 1])."""
    r = max(1, min(MAX_LOG2_BUCKETS, (max(nb, 1) - 1).bit_length()))
    while r > 1 and probe_index_bytes(r) > budget:
        r -= 1
    return r


def probe_index_bytes(log2_buckets: int) -> int:
    """Shared memory of K4's bucket index: 2^r + 1 u32 bounds."""
    return ((1 << log2_buckets) + 1) * 4


def _check_args(build_words, probe_words, probe_live) -> None:
    nw = len(build_words)
    if nw != len(probe_words) or not 1 <= nw <= 2:
        raise ValueError(f"the probe kernel takes 1 or 2 key words per side "
                         f"(equal counts), got {nw} and {len(probe_words)}")
    dev = probe_live.device
    m = probe_live.shape[0]
    nb = build_words[0].shape[0]
    for w in list(build_words) + list(probe_words):
        if w.device != dev:
            raise ValueError(f"key words on {w.device}, probe_live on {dev}")
    if any(w.shape != (m,) for w in probe_words) or any(
            w.shape != (nb,) for w in build_words):
        raise ValueError("key words of one side must share one length")
    if nb >= 2**31 or m >= 2**31:
        raise ValueError("the probe kernel takes fewer than 2^31 rows a side")


def probe_ranges_plain(build_words: Sequence[torch.Tensor], build_count,
                       probe_words: Sequence[torch.Tensor],
                       probe_live: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4, the reference kernel's definition: an equality
    mask of each probe row against the live build rows [0, build_count),
    reduced to (first = min matching index, count = matches); lo = first
    where count > 0, else 0; dead probe rows (0, 0). Probe rows go in
    chunks so the mask stays under :data:`PLAIN_CHUNK_ELEMS` elements."""
    dev = probe_live.device
    nb = build_words[0].shape[0]
    m = probe_live.shape[0]
    bidx = torch.arange(nb, dtype=torch.int32, device=dev)
    blive = bidx < build_count
    bkey = pack_key(build_words)
    pkey = pack_key(probe_words)
    lo = torch.zeros(m, dtype=torch.int32, device=dev)
    cnt = torch.zeros(m, dtype=torch.int32, device=dev)
    rows = max(1, PLAIN_CHUNK_ELEMS // max(1, nb))
    for s in range(0, m, rows):
        e = min(m, s + rows)
        eq = ((pkey[s:e, None] == bkey[None, :]) & blive[None, :]
              & probe_live[s:e, None])
        c = eq.sum(1, dtype=torch.int32)
        first = torch.where(eq, bidx[None, :], nb).amin(1) if nb else c
        lo[s:e] = torch.where(c > 0, first.to(torch.int32), 0)
        cnt[s:e] = c
    return lo, lo + cnt


def probe_ranges_bytes(m: int, nwords: int, nb: int) -> int:
    """K4's byte model, what the probe needs: 4 bytes per u32 key word,
    the liveness byte and two int32s out per probe row, 8 bytes per build
    row (its packed u64 key). (The wrapper's ABI moves each probe word
    as an int64: 8 bytes.)"""
    return m * (4 * nwords + 1 + 8) + 8 * nb


def probe_ranges(build_words: Sequence[torch.Tensor], build_count,
                 probe_words: Sequence[torch.Tensor],
                 probe_live: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (lo, hi) int32 per probe row — the [lo, hi) range of build rows
    in [0, build_count) whose key equals the probe row's; (0, 0) for an
    unmatched or dead row. Build rows [0, build_count) must be sorted
    ascending by key (the join exec's sorted build); ``build_count`` is a
    host int or a 0-d tensor (then read on the device: no host sync)."""
    _check_args(build_words, probe_words, probe_live)
    dev = probe_live.device
    if dev.type == "cpu":
        return probe_ranges_plain(build_words, build_count, probe_words,
                                  probe_live)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lib = build_kernels()
    m = probe_live.shape[0]
    nb = build_words[0].shape[0]
    pw = [w.to(torch.int64).contiguous() for w in probe_words]
    bw = [w.to(torch.int64).contiguous() for w in build_words]
    live = probe_live.to(torch.bool).contiguous()
    if isinstance(build_count, torch.Tensor):  # read on the device
        bc_t = build_count.to(device=dev, dtype=torch.int32).reshape(1)
        bc_ptr, bc_val = bc_t.data_ptr(), 0
    else:
        bc_ptr, bc_val = None, int(build_count)
    lo = torch.empty(m, dtype=torch.int32, device=dev)
    hi = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return lo, hi
    log2_buckets = plan_probe(nb)
    # scratch: the packed keys (two spare rows: the kernel reads whole
    # aligned pairs), the bucket index, the grid barrier's counter
    keys = torch.empty(nb + 2, dtype=torch.int64, device=dev)
    index = torch.empty((1 << log2_buckets) + 1, dtype=torch.int32,
                        device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    two = len(pw) > 1
    with torch.cuda.device(dev), _kernel_cost.kernel_launch(
            "probe_ranges", lambda: probe_ranges_bytes(m, len(pw), nb)):
        rc = lib.srt_probe_ranges(
            pw[0].data_ptr(), pw[1].data_ptr() if two else None,
            live.data_ptr(), m, bw[0].data_ptr(),
            bw[1].data_ptr() if two else None, nb, len(pw), bc_ptr, bc_val,
            log2_buckets, keys.data_ptr(), index.data_ptr(),
            barrier.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            _cuda_build.stream(dev))
    _cuda_build.check_launch(lib.srt_join_error_string, rc, "probe_ranges")
    count_launch("probe_ranges")
    return lo, hi
