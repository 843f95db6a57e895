"""The RADIX tier's segment reduction: a hand-written Hopper kernel and
its plain PyTorch version.

Counterpart of ``tiled_segment_groupby`` in
``spark_rapids_tpu/ops/radix_bin.py`` (``:221``), which is XLA, not
Pallas: a ``lax.fori_loop`` over tiles of the radix-sorted order. The CUDA
C++ lives in ``csrc/radix_kernels.cu``; it is compiled for ``sm_90a`` by
``nvcc`` on first use into ``_build/`` and loaded with ``ctypes``
(``ops/_cuda_build.py``).

The caller hands over the sort's permutation, the NONDECREASING segment
id of every sorted position (dead rows last, outside ``[0, cap)``, as
``ops/groupby.segment_ids_from_radix_keys`` gives them) and a list of
:class:`Stream` s over the columns in ORIGINAL row order; the kernel
gathers each row at the permutation and splits float rows into their
NORMAL/BIG/flag streams in registers.

Dispatch: :func:`segment_reduce` runs the plain version
(:func:`segment_reduce_plain`, the reference's tile loop in
``ops/radix_bin.py``) ONLY for tensors on the CPU. For CUDA tensors it
launches the kernel or raises; no fallback. Each call that launches adds
one to :data:`LAUNCHES`; nothing else does.

Outputs are indexed by segment id. On the card only the ids that the
live rows reach, ``[0, nseg)``, are written; the rest of each ``cap``-row
output is left as allocated, and callers mask it.

Bound on an H100: bytes. The permutation (8 B) and segment id (4 B) of
every live row once, each distinct column and validity at the live rows
once, and each segment's outputs once (:func:`bound_bytes`).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from . import _cuda_build
from . import radix_bin as RB
from ._cuda_build import stream as _stream

SOURCE = _cuda_build.PKG / "csrc" / "radix_kernels.cu"
BUILD_DIR = _cuda_build.BUILD_DIR

#: kernel launches per wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {"radix_segment_reduce": 0}
#: nvcc's output (``-Xptxas -v``) from the build this process loaded
BUILD_LOG: List[str] = []
#: sorted rows a warp of the kernel owns (WARP_TILE in the .cu)
WARP_TILE = 1024

_KINDS = {"count": 0, "isum": 1, "fsum": 2, "pos": 3, "win": 4}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


class Stream(NamedTuple):
    """One reduction over the segments. ``kind``:

    * 'count': count of the rows ``valid`` marks (None: every live row);
    * 'isum': wrapping int64 sum of int ``data`` at its ``valid`` rows;
    * 'fsum': float ``data`` at its ``valid`` rows as (normal, big, flags)
      (``radix_bin.float_sum_streams``, recombined by
      ``radix_bin.combine_float_sum``);
    * 'pos': the first (``op`` 'min') or last ('max') row ``valid`` marks
      (None: every live row);
    * 'win': the winner row of the u64 order word ``data`` (int64 bits,
      ``radix_bin.order_word``) over the rows ``valid`` marks, by ``op``.
    """

    kind: str
    data: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    op: str = "min"


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
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        pp = ctypes.POINTER(ctypes.c_void_p)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.srt_radix_segment_reduce.argtypes = [
            vp, vp, i64, i32, i32, ip, ip, ip, pp, pp, pp, pp, pp, vp, vp]
        lib.srt_radix_segment_reduce.restype = i32
        lib.srt_radix_error_string.argtypes = [i32]
        lib.srt_radix_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def _outputs(streams: Sequence[Stream], cap: int, dev) -> List[tuple]:
    """Each stream's output tensors, unwritten (the kernel writes every
    segment the live rows reach)."""
    outs: List[tuple] = []
    for s in streams:
        if s.kind in ("count", "isum"):
            outs.append((torch.empty(cap, dtype=torch.int64, device=dev),))
        elif s.kind == "fsum":
            outs.append((torch.empty(cap, dtype=torch.float64, device=dev),
                         torch.empty(cap, dtype=torch.float64, device=dev),
                         torch.empty(cap, dtype=torch.uint8, device=dev)))
        else:
            outs.append((torch.empty(cap, dtype=torch.int32, device=dev),))
    return outs


def segment_reduce_plain(perm: torch.Tensor, seg: torch.Tensor,
                         streams: Sequence[Stream],
                         ref_tile: int) -> List[tuple]:
    """Plain version: the reference's tile loop
    (:func:`radix_bin.tiled_segment_groupby`) over ``ref_tile``-row tiles,
    the segment ids standing in for the sorted key words. Returns per
    stream a tuple of (cap,) tensors: (int64,) for count and isum,
    (normal f64, big f64, flags uint8) for fsum, (int32 rows,) for pos
    and win."""
    cap = perm.shape[0]
    live_sorted = (seg >= 0) & (seg < cap)
    live_in = torch.zeros(cap, dtype=torch.bool, device=perm.device)
    live_in[perm] = live_sorted
    adds: List[RB.AddSpec] = []
    poss: List[RB.PosSpec] = []
    wins: List[RB.MinMaxSpec] = []
    where = []  # per stream: (family, index) of its outputs
    nfam = {"u64": 0, "u32": 0, "f64": 0, "or": 0}

    def add(fam, build):
        adds.append(RB.AddSpec(build, fam))
        nfam[fam] += 1
        return nfam[fam] - 1

    def cons_of(valid):
        if valid is None:
            return lambda tk: torch.ones(tk.p_t.shape[0], dtype=torch.bool,
                                         device=tk.p_t.device)
        return lambda tk, v=valid: tk.take(v)

    for s in streams:
        if s.kind == "count":
            c = cons_of(s.valid)
            where.append(("u32", add("u32", lambda tk, c=c: c(tk))))
        elif s.kind == "isum":
            def ib(tk, d=s.data, v=s.valid):
                return torch.where(tk.take(v), tk.take(d).to(torch.int64), 0)
            where.append(("u64", add("u64", ib)))
        elif s.kind == "fsum":
            def fp(tk, i, d=s.data, v=s.valid):
                return RB.float_sum_streams(tk.take(d), tk.take(v))[i]
            fi = add("f64", lambda tk, f=fp: f(tk, 0))
            add("f64", lambda tk, f=fp: f(tk, 1))
            oi = add("or", lambda tk, f=fp: f(tk, 2))
            where.append(("fsum", (fi, oi)))
        elif s.kind == "pos":
            poss.append(RB.PosSpec(cons_of(s.valid), s.op))
            where.append(("pos", len(poss) - 1))
        elif s.kind == "win":
            wins.append(RB.MinMaxSpec(lambda tk, d=s.data: tk.take(d),
                                      cons_of(s.valid), s.op))
            where.append(("win", len(wins) - 1))
        else:
            raise ValueError(f"unknown stream kind {s.kind!r}")
    out = RB.tiled_segment_groupby(perm, [seg], live_in, adds, poss, wins,
                                   tile_rows=ref_tile)
    res: List[tuple] = []
    for fam, i in where:
        if fam == "u32":
            res.append((out.u32[i],))
        elif fam == "u64":
            res.append((out.u64[i],))
        elif fam == "fsum":
            res.append((out.f64[i[0]], out.f64[i[0] + 1], out.flags[i[1]]))
        elif fam == "pos":
            res.append((out.pos_rows[i],))
        else:
            res.append((out.winner_rows[i],))
    return res


def distinct_inputs(streams: Sequence[Stream]) -> List[torch.Tensor]:
    """The streams' columns and validities, each tensor once (streams
    share them: an aggregate's count and its sum read one validity)."""
    seen: Dict[tuple, torch.Tensor] = {}
    for s in streams:
        for t in (s.data, s.valid):
            if t is not None:
                seen.setdefault((t.data_ptr(), t.element_size()), t)
    return list(seen.values())


def bound_bytes(perm: torch.Tensor, streams: Sequence[Stream], nlive: int,
                nseg: int) -> int:
    """Bytes the reduction must move: the permutation and the segment
    ids of the ``nlive`` live rows once, each distinct column and
    validity at those rows once, and ``nseg`` segments' outputs once."""
    total = nlive * (perm.element_size() + 4)
    for t in distinct_inputs(streams):
        total += nlive * t.element_size()
    for s in streams:
        total += nseg * {"count": 8, "isum": 8, "fsum": 17}.get(s.kind, 4)
    return total


def segment_reduce(perm: torch.Tensor, seg: torch.Tensor,
                   streams: Sequence[Stream], ref_tile: int) -> List[tuple]:
    """Every stream reduced per segment of the sorted order (see
    :class:`Stream` and :func:`segment_reduce_plain` for the outputs).
    ``ref_tile`` is the reference's tile length, which decides max's tie
    across tiles. On the card a call makes two launches (the tiles, then
    the fold of the segments that span them) for each block of up to 32
    streams, and counts one in :data:`LAUNCHES`."""
    cap = perm.shape[0]
    for s in streams:
        for t in (s.data, s.valid):
            if t is not None and (t.device != perm.device
                                  or t.shape[0] != cap):
                raise ValueError(f"stream tensor of shape {tuple(t.shape)} "
                                 f"on {t.device} for {cap} rows on "
                                 f"{perm.device}")
    if seg.device != perm.device or seg.shape[0] != cap:
        raise ValueError("seg must match perm's device and length")
    if perm.device.type == "cpu":
        return segment_reduce_plain(perm, seg, streams, ref_tile)
    if perm.device.type != "cuda":
        raise ValueError(f"no kernel for device {perm.device}")
    if cap >= 1 << 31:
        raise ValueError(f"the RADIX kernel takes fewer than 2^31 rows, "
                         f"got {cap}")
    lib = build_kernels()
    dev = perm.device
    outs = _outputs(streams, cap, dev)
    if cap == 0 or not streams:
        return outs
    p64 = perm.to(torch.int64).contiguous()
    s32 = seg.to(torch.int32).contiguous()
    kinds, is_min, esizes, datas, valids, o0, o1, o2 = ([] for _ in range(8))
    for s, o in zip(streams, outs):
        d = s.data
        if d is not None:
            if s.kind == "fsum" and d.dtype not in (torch.float32,
                                                     torch.float64):
                d = d.to(torch.float64)
            elif s.kind != "fsum" and d.dtype not in (torch.int32,
                                                      torch.int64):
                d = d.to(torch.int64)
            d = d.contiguous()
        v = None if s.valid is None else s.valid.to(torch.bool).contiguous()
        kinds.append(_KINDS[s.kind])
        is_min.append(int(s.op == "min"))
        esizes.append(0 if d is None else d.element_size())
        datas.append(d)
        valids.append(v)
        o0.append(o[0])
        o1.append(o[1] if len(o) > 1 else None)
        o2.append(o[2] if len(o) > 2 else None)
    ntiles = -(-cap // WARP_TILE)
    scratch = torch.empty((len(streams), ntiles, 6), dtype=torch.int64,
                          device=dev)

    def vptrs(ts):
        return (ctypes.c_void_p * len(ts))(
            *[None if t is None else t.data_ptr() for t in ts])

    ints = ctypes.c_int * len(streams)
    with torch.cuda.device(dev):
        rc = lib.srt_radix_segment_reduce(
            p64.data_ptr(), s32.data_ptr(), cap, int(ref_tile),
            len(streams), ints(*kinds), ints(*is_min), ints(*esizes),
            vptrs(datas), vptrs(valids), vptrs(o0), vptrs(o1), vptrs(o2),
            scratch.data_ptr(), _stream(dev))
    _cuda_build.check_launch(lib.srt_radix_error_string, rc,
                             "radix_segment_reduce")
    LAUNCHES["radix_segment_reduce"] += 1
    return outs

