"""The hash-groupby update's hand-written Hopper kernels, their plain
PyTorch versions, and the order words.

Counterpart of ``spark_rapids_tpu/ops/pallas_groupby.py`` (the PALLAS
aggregation tier). The CUDA C++ lives in ``csrc/groupby_kernels.cu``; it
is compiled for ``sm_90a`` by ``nvcc`` on first use into ``_build/`` (a
shared library with a plain C interface, loaded with ``ctypes``; see
``ops/_cuda_build.py``).

=====  ========================  ====================================
 K     wrapper                    replaces (spark_rapids_tpu/...)
=====  ========================  ====================================
 K1    :func:`bucket_sum`         ops/pallas_groupby.py ``_sum_kernel``
 K2    :func:`bucket_float_sum`   ops/pallas_groupby.py ``_float_kernel``
 K3    :func:`bucket_winner`      ops/pallas_groupby.py ``_winner_kernel``
 --    :func:`ordered_segment_sum` the serial XLA ``segment_sum`` of the
                                  exact float sums (ops/groupby.py)
=====  ========================  ====================================

Dispatch: each wrapper runs its plain version ONLY for tensors on the CPU
(the tests, and the reference comparison). For CUDA tensors it launches
its kernel or raises — there is no fallback to the plain version when
``nvcc`` or the library is missing. Each launch adds one to
:data:`LAUNCHES`; nothing else does.

Bounds on an H100 (see the .cu notes): K1-K3 are bytes-bound, the input
stream (seg int32 + value and validity planes, each read once) plus
B x columns x 8 bytes of output. The kernels keep the bucket table in
shared memory per block and flush it once, instead of the TPU kernels'
one-hot blocks in VMEM; K1's table is planned into passes that fit
(:func:`plan_bucket_sum`), K2's into replicas (:func:`plan_bucket_fsum`).
The ordered segment sum is bound by the chain of dependent f64 adds of
its longest segment.

torch has little uint32/uint64 support, so 64-bit words (order words,
unsigned accumulators) ride in int64 tensors with the same bit pattern;
the kernels read them as unsigned through raw pointers.

Each kernel's byte model (``*_bytes``: what its launch must move, each
input read once and each output written once) is kept here, beside its
wrapper: the cost plane's attribution (``kernel_cost.kernel_launch``)
and ``chip_smoke.py``'s bound column read the same formula.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import kernel_cost as _kernel_cost
from . import _cuda_build
from ._cuda_build import ptrs as _ptrs
from ._cuda_build import stream as _stream
from .sort import SIGN64, radix_of

SOURCE = _cuda_build.PKG / "csrc" / "groupby_kernels.cu"
BUILD_DIR = _cuda_build.BUILD_DIR

#: columns per launch (SRT_MAXC in the .cu)
MAX_COLS = 16
#: shared memory one block may opt into on an H100 (227 KB); K1's pass
#: tables and K2's replicas are planned within it, K3's table stays in it
#: up to BLOCK_SMEM // 8 buckets
BLOCK_SMEM = _cuda_build.BLOCK_SMEM
#: the reference's PALLAS capacity bound (its 4-bit limb accumulators);
#: kept so both engines accept the same inputs
MAX_ROWS = 1 << 27
_M32 = 0xFFFFFFFF
#: the winner's identities, as int64 bit patterns of the u64 word
IDENT_MIN = -1  # all ones
IDENT_MAX = 0

#: kernel launches per wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {"bucket_sum": 0, "bucket_float_sum": 0,
                            "bucket_winner": 0, "ordered_segment_sum": 0}
#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
#: the build this process loaded
BUILD_LOG: List[str] = []
#: the library's C symbols (a loaded library lacking one is refused)
SYMBOLS = ("srt_bucket_sum",
           "srt_bucket_fsum",
           "srt_bucket_winner",
           "srt_ordered_segment_sum",
           "srt_dadd_chain",
           "srt_error_string",)

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
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.srt_bucket_sum.argtypes = [vp, i64, i32, i32, i32, pp, pp,
                                       ctypes.POINTER(i32), i32,
                                       ctypes.c_uint, vp, vp]
        lib.srt_bucket_fsum.argtypes = [vp, i64, i32, i32, pp, pp, i32, vp,
                                        vp]
        lib.srt_bucket_winner.argtypes = [vp, i64, i32, i32, vp, i32, vp,
                                          vp]
        lib.srt_ordered_segment_sum.argtypes = [vp, vp, i32, vp, vp]
        lib.srt_dadd_chain.argtypes = [vp, i64, vp, vp]
        for f in (lib.srt_bucket_sum, lib.srt_bucket_fsum,
                  lib.srt_bucket_winner, lib.srt_ordered_segment_sum,
                  lib.srt_dadd_chain):
            f.restype = i32
        lib.srt_error_string.argtypes = [i32]
        lib.srt_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def _check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    _cuda_build.check_launch(lib.srt_error_string, rc, name)


def _on_card(seg: torch.Tensor, others: Sequence[torch.Tensor]) -> bool:
    """True to launch the kernel, False to run the plain version (CPU
    tensors only). Mixed devices, and columns whose length is not seg's
    (the kernels would read past them), raise."""
    for t in others:
        if t.device != seg.device:
            raise ValueError(f"tensor on {t.device}, seg on {seg.device}")
        if t.shape != seg.shape:
            raise ValueError(f"column of shape {tuple(t.shape)} for seg of "
                             f"shape {tuple(seg.shape)}")
    if seg.device.type == "cpu":
        return False
    if seg.device.type != "cuda":
        raise ValueError(f"no kernel for device {seg.device}")
    return True


def _check_rows(n: int) -> None:
    if n >= MAX_ROWS:
        raise ValueError(f"the bucket kernels take fewer than 2^27 rows "
                         f"(the reference's bound), got {n}")


def drop_index(seg: torch.Tensor, B: int) -> torch.Tensor:
    """Row -> output slot, with dropped rows (seg < 0 or >= B) sent to the
    spare slot B that the plain versions cut off."""
    s = seg.to(torch.int64)
    return torch.where((s >= 0) & (s < B), s, B)


# ---------------------------------------------------------------------------
# K1: exact int64 sums and counts per bucket
# ---------------------------------------------------------------------------
def bucket_sum_plain(seg, B, int_cols=(), count_cols=()):
    """Plain version of K1: int64 ``index_add_`` (wraps mod 2^64)."""
    cols = ([torch.where(v, d.to(torch.int64), 0) for d, v in int_cols]
            + [v.to(torch.int64) for v in count_cols])
    if not cols:
        return [], []
    acc = torch.zeros((B + 1, len(cols)), dtype=torch.int64,
                      device=seg.device)
    acc.index_add_(0, drop_index(seg, B), torch.stack(cols, 1))
    outs = [acc[:B, i] for i in range(len(cols))]
    return outs[:len(int_cols)], outs[len(int_cols):]


def table_bytes(B: int, nint: int, lo: int, hi: int) -> int:
    """Bytes of K1's shared table for columns [lo, hi) of a launch whose
    first ``nint`` columns are int sums (u64) and the rest counts (u32)."""
    ni = max(0, min(hi, nint) - lo)
    return B * (8 * ni + 4 * (hi - lo - ni))


def plan_bucket_sum(B: int, nint: int, ncnt: int,
                    budget: int = BLOCK_SMEM) -> List[Tuple[int, int, bool]]:
    """K1's passes over one launch's columns (``nint`` int columns, then
    ``ncnt`` count columns): ``(lo, hi, shared)`` ranges covering the
    columns once, in order. A shared pass's table fits ``budget``; filling
    each pass greedily makes the passes as few as contiguous ranges allow.
    A column whose table alone exceeds the budget accumulates in device
    memory (``shared`` False); consecutive such columns share one pass.
    The kernel runs every pass in one launch (one pass per grid row)."""
    passes: List[Tuple[int, int, bool]] = []
    for c in range(nint + ncnt):
        shared = table_bytes(B, nint, c, c + 1) <= budget
        if passes and passes[-1][2] == shared and (
                not shared
                or table_bytes(B, nint, passes[-1][0], c + 1) <= budget):
            passes[-1] = (passes[-1][0], c + 1, shared)
        else:
            passes.append((c, c + 1, shared))
    return passes


def _live(seg: torch.Tensor, B: int) -> torch.Tensor:
    return (seg >= 0) & (seg < B)


def bucket_sum_bytes(seg, B: int, int_cols=(), count_cols=()):
    """K1's byte model: the segment ids (4 B a row), one validity byte a
    live row per column, 8 B a live valid value, 8 B a bucket per column
    out (a 0-d tensor)."""
    live = _live(seg, B)
    L = len(int_cols) + len(count_cols)
    n_data = sum(((v & live).sum() for _, v in int_cols),
                 torch.zeros((), dtype=torch.int64, device=seg.device))
    return 4 * seg.shape[0] + live.sum() * L + 8 * n_data + 8 * B * L


def bucket_float_sum_bytes(seg, B: int, float_cols=()):
    """K2's byte model: as K1's, every column a float sum."""
    live = _live(seg, B)
    F = len(float_cols)
    n_data = sum(((v & live).sum() for _, v in float_cols),
                 torch.zeros((), dtype=torch.int64, device=seg.device))
    return 4 * seg.shape[0] + live.sum() * F + 8 * n_data + 8 * B * F


def bucket_winner_bytes(seg, B: int):
    """K3's byte model: the segment ids, each live row's 8-byte word,
    the table out."""
    return 4 * seg.shape[0] + 8 * _live(seg, B).sum() + 8 * B


def ordered_segment_sum_bytes(seg, nseg: int):
    """The ordered sum's byte model: 8 B a row, 8 B a kept value, 8 B a
    segment out."""
    return 8 * seg.shape[0] + 8 * _live(seg, nseg).sum() + 8 * nseg


def bucket_sum(seg: torch.Tensor, B: int,
               int_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
               count_cols: Sequence[torch.Tensor] = ()
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """K1: per-bucket int64 sums of ``int_cols`` [(data, valid)] (mod 2^64,
    Java wraparound) and counts of ``count_cols`` [valid]. Rows with
    seg < 0 or seg >= B drop out. One launch per :data:`MAX_COLS`
    columns, its passes planned by :func:`plan_bucket_sum`."""
    n = seg.shape[0]
    _check_rows(n)
    flat = [t for d, v in int_cols for t in (d, v)] + list(count_cols)
    if not _on_card(seg, flat):
        return bucket_sum_plain(seg, B, int_cols, count_cols)
    lib = build_kernels()
    dev = seg.device
    seg32 = seg.to(torch.int32).contiguous()
    entries = ([(d.to(torch.int64).contiguous(), v.to(torch.bool).contiguous())
                for d, v in int_cols]
               + [(None, v.to(torch.bool).contiguous()) for v in count_cols])
    outs: List[torch.Tensor] = []
    with torch.cuda.device(dev):
        for lo in range(0, len(entries), MAX_COLS):
            chunk = entries[lo:lo + MAX_COLS]
            datas = [d for d, _ in chunk if d is not None]
            passes = plan_bucket_sum(B, len(datas), len(chunk) - len(datas))
            bounds = [p[0] for p in passes] + [len(chunk)]
            in_device_memory = sum(1 << i for i, p in enumerate(passes)
                                   if not p[2])
            out = torch.zeros((len(chunk), B), dtype=torch.int64, device=dev)
            part = ([(d, v) for d, v in chunk if d is not None],
                    [v for d, v in chunk if d is None])
            with _kernel_cost.kernel_launch(
                    "bucket_sum", lambda p=part: bucket_sum_bytes(
                        seg32, B, p[0], p[1])):
                rc = lib.srt_bucket_sum(
                    seg32.data_ptr(), n, B, len(datas),
                    len(chunk) - len(datas), _ptrs(datas),
                    _ptrs([v for _, v in chunk]),
                    (ctypes.c_int * len(bounds))(*bounds), len(passes),
                    in_device_memory, out.data_ptr(), _stream(dev))
            _check(lib, rc, "bucket_sum")
            count_launch("bucket_sum")
            outs.extend(out.unbind(0))
    return outs[:len(int_cols)], outs[len(int_cols):]


# ---------------------------------------------------------------------------
# K2: f64 sums per bucket (order-insensitive)
# ---------------------------------------------------------------------------
def bucket_float_sum_plain(seg, B, float_cols=()):
    """Plain version of K2: f64 ``index_add_``."""
    if not float_cols:
        return []
    cols = [torch.where(v, d.to(torch.float64), 0.0) for d, v in float_cols]
    acc = torch.zeros((B + 1, len(cols)), dtype=torch.float64,
                      device=seg.device)
    acc.index_add_(0, drop_index(seg, B), torch.stack(cols, 1))
    return [acc[:B, i] for i in range(len(cols))]


#: K2 keeps at most one table replica per warp of its 1024-thread block
MAX_FSUM_REPLICAS = 32


def plan_bucket_fsum(B: int, F: int, budget: int = BLOCK_SMEM) -> int:
    """K2's table placement for ``B`` buckets and ``F`` f64 columns: the
    number of replicas of the (B, F) table each block keeps in shared
    memory (warp w adds into replica w % replicas, so a shared CAS retry
    mostly happens between lanes of one warp), or 0 for global atomics on
    the output when one table exceeds ``budget``. As many replicas as fit
    ``budget``, up to one per warp: the kernel's registers hold an SM to
    one 1024-thread block, so the replicas cost no occupancy."""
    table = B * F * 8
    if table > budget:
        return 0
    return min(MAX_FSUM_REPLICAS, budget // max(table, 1))


def bucket_float_sum(seg: torch.Tensor, B: int,
                     float_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                     = ()) -> List[torch.Tensor]:
    """K2: per-bucket f64 sums of ``float_cols`` [(data, valid)]. The
    summation order is run-dependent (the variableFloatAgg family); NaN
    and inf stay in their own bucket. One launch per :data:`MAX_COLS`
    columns, its table placed by :func:`plan_bucket_fsum`."""
    _check_rows(seg.shape[0])
    flat = [t for d, v in float_cols for t in (d, v)]
    if not _on_card(seg, flat):
        return bucket_float_sum_plain(seg, B, float_cols)
    lib = build_kernels()
    dev = seg.device
    n = seg.shape[0]
    seg32 = seg.to(torch.int32).contiguous()
    entries = [(d.to(torch.float64).contiguous(),
                v.to(torch.bool).contiguous()) for d, v in float_cols]
    outs: List[torch.Tensor] = []
    with torch.cuda.device(dev):
        for lo in range(0, len(entries), MAX_COLS):
            chunk = entries[lo:lo + MAX_COLS]
            # zeroed on the stream by the entry point
            out = torch.empty((B, len(chunk)), dtype=torch.float64,
                              device=dev)
            with _kernel_cost.kernel_launch(
                    "bucket_float_sum", lambda c=chunk:
                    bucket_float_sum_bytes(seg32, B, c)):
                rc = lib.srt_bucket_fsum(
                    seg32.data_ptr(), n, B, len(chunk),
                    _ptrs([d for d, _ in chunk]),
                    _ptrs([v for _, v in chunk]),
                    plan_bucket_fsum(B, len(chunk)), out.data_ptr(),
                    _stream(dev))
            _check(lib, rc, "bucket_float_sum")
            count_launch("bucket_float_sum")
            outs.extend(out[:, i] for i in range(len(chunk)))
    return outs


# ---------------------------------------------------------------------------
# K3: per-bucket lexicographic winner of a (hi, lo) u32 word pair, packed
# as one u64 word hi<<32|lo (int64 bit pattern)
# ---------------------------------------------------------------------------
def bucket_winner_plain(seg, B, op, word):
    """Plain version of K3: ``scatter_reduce_`` amin/amax on the word
    mapped to signed order."""
    is_min = op == "min"
    s = word ^ SIGN64
    init = (IDENT_MIN if is_min else IDENT_MAX) ^ SIGN64
    acc = torch.full((B + 1,), init, dtype=torch.int64, device=seg.device)
    acc.scatter_reduce_(0, drop_index(seg, B), s,
                        "amin" if is_min else "amax", include_self=True)
    return acc[:B] ^ SIGN64


def plan_bucket_winner(B: int, budget: int = BLOCK_SMEM) -> bool:
    """K3's table placement: True for one u64 word per bucket in each
    block's shared memory (B x 8 bytes within ``budget``: up to 29 056
    buckets), False for global atomics on the output. The kernel runs
    1024-thread blocks, as many per SM as the table leaves room for (the
    card's occupancy query), in one wave."""
    return B * 8 <= budget


def bucket_winner(seg: torch.Tensor, B: int, op: str,
                  word: torch.Tensor) -> torch.Tensor:
    """K3: (B,) winner words: the unsigned ``op`` ('min'/'max') of the
    64-bit ``word`` over each bucket's rows. Rows excluded from the
    reduction must carry the op identity (all ones for min, 0 for max);
    empty buckets return the identity."""
    if op not in ("min", "max"):
        raise ValueError(f"op must be 'min' or 'max', got {op!r}")
    if not _on_card(seg, [word]):
        return bucket_winner_plain(seg, B, op, word)
    lib = build_kernels()
    dev = seg.device
    # the kernel loads four rows at a time (an int4 of seg, two longlong2
    # of words): a view that starts off a 16-byte boundary is copied
    seg32, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (
        seg.to(torch.int32).contiguous(), word.to(torch.int64).contiguous()))
    out = torch.full((B,), IDENT_MIN if op == "min" else IDENT_MAX,
                     dtype=torch.int64, device=dev)
    with torch.cuda.device(dev), _kernel_cost.kernel_launch(
            "bucket_winner", lambda: bucket_winner_bytes(seg32, B)):
        rc = lib.srt_bucket_winner(seg32.data_ptr(), seg.shape[0], B,
                                   int(op == "min"), w.data_ptr(),
                                   int(plan_bucket_winner(B)),
                                   out.data_ptr(), _stream(dev))
    _check(lib, rc, "bucket_winner")
    count_launch("bucket_winner")
    return out


# ---------------------------------------------------------------------------
# ordered segment sum: exact-mode float sums, serial row order per segment
# ---------------------------------------------------------------------------
def ordered_segment_sum_plain(vals, seg, nseg):
    """Plain version: f64 ``index_add_`` (on the CPU a serial walk in row
    order, like the reference's XLA-CPU segment_sum)."""
    acc = torch.zeros(nseg + 1, dtype=torch.float64, device=vals.device)
    acc.index_add_(0, drop_index(seg, nseg), vals.to(torch.float64))
    return acc[:nseg]


def ordered_segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                        nseg: int) -> torch.Tensor:
    """(nseg,) f64 sums of ``vals`` per segment, each taken serially in
    row order from 0.0. On the card ``seg`` must be NONDECREASING (rows
    sorted by segment, stably); ids outside [0, nseg) drop out."""
    if not _on_card(seg, [vals]):
        return ordered_segment_sum_plain(vals, seg, nseg)
    lib = build_kernels()
    dev = seg.device
    v = vals.to(torch.float64).contiguous()
    # searched in seg's own integer type: no int64 copy of the column
    s = seg.contiguous() if seg.dtype in (torch.int32, torch.int64) else (
        seg.to(torch.int64).contiguous())
    bounds = torch.searchsorted(
        s, torch.arange(nseg + 1, dtype=s.dtype, device=dev))
    out = torch.zeros(nseg, dtype=torch.float64, device=dev)
    if nseg == 0:
        return out
    with torch.cuda.device(dev), _kernel_cost.kernel_launch(
            "ordered_segment_sum",
            lambda: ordered_segment_sum_bytes(s, nseg)):
        rc = lib.srt_ordered_segment_sum(v.data_ptr(), bounds.data_ptr(),
                                         nseg, out.data_ptr(), _stream(dev))
    _check(lib, rc, "ordered_segment_sum")
    count_launch("ordered_segment_sum")
    return out


def dadd_chain(x: torch.Tensor, nadds: int) -> torch.Tensor:
    """Launch the one-thread probe: ``nadds`` dependent f64 adds in
    registers, from ``x[0]`` adding ``x[1]`` and ``x[2]`` in turn; its
    time over ``nadds`` is the card's dependent DADD latency, the ordered
    segment sum's floor per row of its longest segment. A measurement
    probe, on card tensors only; it is no path's kernel and has no
    launch count."""
    if x.device.type != "cuda" or x.dtype != torch.float64 or x.numel() < 3:
        raise ValueError("dadd_chain takes 3 float64 values on a CUDA card")
    lib = build_kernels()
    x = x.contiguous()
    out = torch.empty(1, dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.srt_dadd_chain(x.data_ptr(), nadds, out.data_ptr(),
                                _stream(x.device))
    _check(lib, rc, "dadd_chain")
    return out


# ---------------------------------------------------------------------------
# order words and the kernel tier's entry points
# ---------------------------------------------------------------------------
def _order_words(data: torch.Tensor, fill_excluded: torch.Tensor,
                 op: str, keep_zero_sign: bool = False) -> torch.Tensor:
    """The packed (hi, lo) order word of one column (the sort radix
    encoding: NaN canonical-largest, -0.0 folded, or with
    ``keep_zero_sign`` just below 0.0), with the op identity at excluded
    rows. 32-bit and bool values fill the hi word (lo = 0), as in the
    reference's bit-exact branch (``pallas_groupby.py:343-351``)."""
    w = radix_of(data, keep_zero_sign)
    if data.element_size() < 8:
        w = w << 32
    ident = IDENT_MIN if op == "min" else IDENT_MAX
    return torch.where(fill_excluded, ident, w)


def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    return (((x + 2**31) & _M32) - 2**31).to(torch.int32)


def _decode_word(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Invert :func:`_order_words` for winner words."""
    hi = (w >> 32) & _M32
    if dtype == torch.float32:
        bits = torch.where(hi >= (1 << 31), hi ^ (1 << 31), hi ^ _M32)
        return _u32_to_i32(bits).view(torch.float32)
    if dtype == torch.float64:
        bits = torch.where(w < 0, w ^ SIGN64, ~w)
        return bits.view(torch.float64)
    if dtype == torch.bool:
        return hi != 0
    if dtype == torch.int64:
        return w ^ SIGN64
    return _u32_to_i32(hi ^ (1 << 31)).to(dtype)


def kernel_bucket_reduce(seg, B, int_cols=(), count_cols=(), float_cols=()):
    """Kernel tier of ``bucket_reduce`` (reference:
    ``pallas_bucket_reduce``): K1 for integer sums and counts, K2 for
    float sums. Same contract and the same bit-exact integer results."""
    isums, counts = (bucket_sum(seg, B, int_cols, count_cols)
                     if int_cols or count_cols else ([], []))
    fsums = bucket_float_sum(seg, B, float_cols) if float_cols else []
    return isums, counts, fsums


def min_max_by_words(winner, seg, B, op, cols, keep_zero_sign=False):
    """Per-bucket min/max of identity-prefilled columns through
    ``winner`` (K3's wrapper or its plain version): each column's order
    word (:func:`_order_words`) is reduced and decoded back to the
    column's dtype; callers overwrite empty buckets via their count
    mask."""
    no = torch.zeros(seg.shape[0], dtype=torch.bool, device=seg.device)
    return [_decode_word(winner(seg, B, op, _order_words(
        d, no, op, keep_zero_sign)), d.dtype) for d in cols]


def kernel_bucket_min_max(seg, B, op, cols):
    """Kernel tier of ``bucket_min_max`` (reference:
    ``pallas_bucket_min_max``), on K3."""
    return min_max_by_words(bucket_winner, seg, B, op, cols)


def kernel_bucket_position(seg, B, op, consider):
    """(row, found) per bucket: the first ('min') or last ('max')
    considered row (reference: ``pallas_bucket_position``). Row indices
    ride +1 so the max identity 0 stays distinct."""
    cap = seg.shape[0]
    idx = torch.arange(1, cap + 1, dtype=torch.int64, device=seg.device)
    ident = IDENT_MIN if op == "min" else IDENT_MAX
    w = bucket_winner(seg, B, op, torch.where(consider, idx, ident))
    found = w != ident
    row = torch.where(found, w - 1, -1).to(torch.int32)
    return row, found
