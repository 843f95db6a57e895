"""The regex row matcher's hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``dfa_accept_rows`` in ``spark_rapids_tpu/ops/regex.py``
(``:563``), which is XLA, not Pallas: a segmented ``lax.associative_scan``
that composes packed 16-state transition vectors along the byte pool. The
CUDA C++ lives in ``csrc/regex_kernels.cu``; it is compiled for ``sm_90a``
by ``nvcc`` on first use into ``_build/`` and loaded with ``ctypes``
(``ops/_cuda_build.py``).

Dispatch: the wrapper runs the plain version ONLY for tensors on the CPU
(the tests, and the comparison on the card). For CUDA tensors it launches
the kernel or raises; no fallback. Each launch adds one to
:data:`LAUNCHES`; nothing else does.

Bound on an H100: bytes. The live rows' bytes are read once, plus 4
bytes of offsets, 1 of validity and 1 of output a row; a walk that stops
early (:func:`stop_states`) needs only the bytes up to its stop
(:func:`dfa_exit_plain` counts them).

The kernel takes the DFA as a (16, 256) table of next states laid out
[state][byte] on the card and a mask of stop states; both are made once
per DFA and device (:func:`device_table`).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernel_cost as _kernel_cost
from . import _cuda_build

SOURCE = _cuda_build.PKG / "csrc" / "regex_kernels.cu"
BUILD_DIR = _cuda_build.BUILD_DIR

#: kernel launches per wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {"dfa_accept_rows": 0}
#: nvcc's output (``-Xptxas -v``) from the build this process loaded
BUILD_LOG: List[str] = []
#: the library's C symbols (a loaded library lacking one is refused)
SYMBOLS = ("srt_dfa_accept_rows",
           "srt_regex_error_string",)

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
#: (id(dfa), device) -> (the dfa, its [state][byte] table there, its stop
#: mask); the dfa is held so that its id is not reused
_TABLES: Dict[Tuple[int, torch.device], Tuple[object, torch.Tensor, int]] = {}


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
        lib.srt_dfa_accept_rows.argtypes = [
            vp, ctypes.c_int64, vp, ctypes.c_int64, vp, vp,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
            vp, vp]
        lib.srt_dfa_accept_rows.restype = ctypes.c_int
        lib.srt_regex_error_string.argtypes = [ctypes.c_int]
        lib.srt_regex_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def transition_table(dfa) -> np.ndarray:
    """(256, 16) uint8 next states, unpacked on the host from the
    compiler's packed ``lut_lo``/``lut_hi`` (torch has no unsigned 32-bit
    shifts on every backend)."""
    shifts = np.arange(8, dtype=np.uint32) * 4
    lo = (dfa.lut_lo[:, None] >> shifts[None, :]) & 15
    hi = (dfa.lut_hi[:, None] >> shifts[None, :]) & 15
    return np.concatenate([lo, hi], axis=1).astype(np.uint8)


def dead_states(dfa) -> int:
    """Bit mask of the DFA's dead states: reachable ids (below
    ``nstates``) that do not accept and that every byte leads back to."""
    tbl = transition_table(dfa)
    ids = np.arange(16)
    dead = (tbl == ids[None, :]).all(axis=0) & (ids < dfa.nstates)
    dead &= ((dfa.accept_mask >> ids) & 1) == 0
    return int((dead.astype(np.int64) << ids).sum())


def stop_states(dfa) -> int:
    """Bit mask of the states where a walk may stop with its verdict
    known: the dead states, and in an absorbing DFA the accepting ones
    (every byte leads from them to an accepting state). No byte leads out
    of the set."""
    acc = dfa.accept_mask & 0xFFFF if dfa.absorbing else 0
    return dead_states(dfa) | acc


def device_table(dfa, dev: torch.device) -> Tuple[torch.Tensor, int]:
    """The kernel's DFA on ``dev``: (4096,) uint8 next states at
    ``state * 256 + byte``, and :func:`stop_states`. Made once per DFA and
    device."""
    key = (id(dfa), dev)
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not dfa:
        tbl = np.ascontiguousarray(transition_table(dfa).T).reshape(-1)
        if len(_TABLES) > 256:
            _TABLES.clear()
        hit = (dfa, torch.from_numpy(tbl).to(dev), stop_states(dfa))
        _TABLES[key] = hit
    return hit[1], hit[2]


def _check(offsets, chars, validity) -> None:
    if chars.dtype != torch.uint8 or chars.dim() != 1:
        raise ValueError(f"dfa_accept_rows takes a 1-D uint8 pool, got "
                         f"{chars.dtype} of shape {tuple(chars.shape)}")
    if offsets.dtype != torch.int32 or offsets.dim() != 1 or (
            offsets.shape[0] < 1):
        raise ValueError(f"dfa_accept_rows takes (cap+1,) int32 offsets, "
                         f"got {offsets.dtype} of shape "
                         f"{tuple(offsets.shape)}")
    if validity.dtype != torch.bool or validity.shape != (
            offsets.shape[0] - 1,):
        raise ValueError(f"dfa_accept_rows takes (cap,) bool validity, got "
                         f"{validity.dtype} of shape "
                         f"{tuple(validity.shape)}")
    if not (offsets.device == chars.device == validity.device):
        raise ValueError(f"offsets on {offsets.device}, chars on "
                         f"{chars.device}, validity on {validity.device}")


def dfa_accept_rows_plain(offsets: torch.Tensor, chars: torch.Tensor,
                          validity: torch.Tensor, dfa) -> torch.Tensor:
    """Plain version: walk byte column ``j = 0 .. max_len-1`` of every row
    at once through the unpacked (256, 16) table, a row keeping its state
    once ``j`` passes its length; the state before the last byte gives
    Java's ``$`` rule, as in the kernel. Offsets clamp to the pool."""
    dev = chars.device
    cap = offsets.shape[0] - 1
    nch = chars.shape[0]
    lo = offsets[:-1].clamp(0, nch).long()
    hi = torch.maximum(offsets[1:].clamp(0, nch).long(), lo)
    lens = hi - lo
    tbl = torch.from_numpy(transition_table(dfa).reshape(-1)).to(dev).long()
    acc_tbl = torch.tensor([(dfa.accept_mask >> s) & 1 for s in range(16)],
                           dtype=torch.bool, device=dev)
    st = torch.zeros(cap, dtype=torch.long, device=dev)
    prev = st
    last = torch.zeros(cap, dtype=torch.long, device=dev)
    max_len = int(lens.max()) if cap else 0
    for j in range(max_len):
        live = j < lens
        b = chars[(lo + j).clamp(max=max(nch - 1, 0))].long()
        prev = torch.where(live, st, prev)
        last = torch.where(live, b, last)
        st = torch.where(live, tbl[b * 16 + st], st)
    acc = acc_tbl[st]
    if not dfa.absorbing:
        acc = acc | ((last == 0x0A) & acc_tbl[prev])
    acc = torch.where(lens > 0, acc, dfa.start_accept)
    return acc & validity


def dfa_exit_plain(offsets: torch.Tensor, chars: torch.Tensor,
                   validity: torch.Tensor, dfa):
    """Where each row's walk may stop, and its verdict there: (steps,
    verdict), ``steps`` (cap,) int64 the bytes stepped up to and including
    the first that brings the state into :func:`stop_states` (the row's
    length if none does; 0 for null and empty rows). A row that stops
    before its last byte takes its stop state's verdict; one that stops on
    its last byte or never takes the full walk's (Java's '\\n' rule
    included). The sum of ``steps`` is the bytes a walk must read."""
    dev = chars.device
    cap = offsets.shape[0] - 1
    nch = chars.shape[0]
    lo = offsets[:-1].clamp(0, nch).long()
    hi = torch.maximum(offsets[1:].clamp(0, nch).long(), lo)
    lens = torch.where(validity, hi - lo, torch.zeros_like(lo))
    tbl = torch.from_numpy(transition_table(dfa).reshape(-1)).to(dev).long()
    bits = torch.arange(16, device=dev)
    acc_tbl = ((dfa.accept_mask >> bits) & 1).bool()
    stop_tbl = ((stop_states(dfa) >> bits) & 1).bool()
    st = torch.zeros(cap, dtype=torch.long, device=dev)
    prev = st
    last = torch.zeros(cap, dtype=torch.long, device=dev)
    steps = lens.clone()
    stopped = torch.zeros(cap, dtype=torch.bool, device=dev)
    for j in range(int(lens.max()) if cap else 0):
        if j % 256 == 255 and not bool(((j < lens) & ~stopped).any()):
            break  # every row has stopped
        live = (j < lens) & ~stopped
        b = chars[(lo + j).clamp(max=max(nch - 1, 0))].long()
        prev = torch.where(live, st, prev)
        last = torch.where(live, b, last)
        st = torch.where(live, tbl[b * 16 + st], st)
        now = live & stop_tbl[st]
        steps = torch.where(now, j + 1, steps)
        stopped |= now
    acc = acc_tbl[st]
    if not dfa.absorbing:
        full = acc | ((last == 0x0A) & acc_tbl[prev])
        acc = torch.where(stopped & (steps < lens), acc, full)
    acc = torch.where(lens > 0, acc, dfa.start_accept)
    return steps, acc & validity


def dfa_accept_rows_bytes(offsets: torch.Tensor):
    """The DFA kernel's byte model over every live byte: the rows' chars,
    4 bytes of offsets a row (and one more), the validity byte and the
    verdict byte a row. A walk that stops early reads fewer
    (``chip_smoke.py`` also bounds the walked bytes)."""
    cap = offsets.shape[0] - 1
    return ((offsets[-1] - offsets[0]).to(torch.int64) + 4 * (cap + 1)
            + 2 * cap)


def dfa_accept_rows(offsets: torch.Tensor, chars: torch.Tensor,
                    validity: torch.Tensor, dfa) -> torch.Tensor:
    """(cap,) bool: each row's DFA verdict ANDed with ``validity``
    (``offsets`` (cap+1,) int32, ``chars`` the uint8 pool, ``dfa`` an
    ``ops.regex.Dfa``). Bytes outside ``[offsets[i], offsets[i+1])`` are
    never read for row ``i``."""
    _check(offsets, chars, validity)
    dev = chars.device
    if dev.type == "cpu":
        return dfa_accept_rows_plain(offsets, chars, validity, dfa)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lib = build_kernels()
    cap, nch = offsets.shape[0] - 1, chars.shape[0]
    out = torch.empty(cap, dtype=torch.bool, device=dev)
    if cap == 0:
        return out
    table, stop = device_table(dfa, dev)
    off = offsets.contiguous()
    chars = chars.contiguous()  # any alignment: the kernel shifts to 16
    valid = validity.contiguous()
    with torch.cuda.device(dev), _kernel_cost.kernel_launch(
            "dfa_accept_rows", lambda: dfa_accept_rows_bytes(off)):
        rc = lib.srt_dfa_accept_rows(
            off.data_ptr(), cap, chars.data_ptr(), nch, valid.data_ptr(),
            table.data_ptr(),
            dfa.accept_mask & 0xFFFF, stop, int(dfa.absorbing),
            int(dfa.start_accept), out.data_ptr(), _cuda_build.stream(dev))
    _cuda_build.check_launch(lib.srt_regex_error_string, rc,
                             "dfa_accept_rows")
    count_launch("dfa_accept_rows")
    return out
