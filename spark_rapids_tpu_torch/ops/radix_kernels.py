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
:class:`Stream` s over the columns in ORIGINAL row order.
:func:`pack_arguments` turns the streams into a table of their distinct
inputs (a validity or a column that several streams read is in it once)
and four ints a stream; the kernel gathers each distinct input once a
row, at the permutation, and every stream reduces from that stage (float
rows split into their NORMAL/BIG/flag streams in registers). All outputs
are views of one allocation.

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

import array
import ctypes
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import kernel_cost as _kernel_cost
from . import _cuda_build
from . import radix_bin as RB
from ._cuda_build import stream as _stream

SOURCE = _cuda_build.PKG / "csrc" / "radix_kernels.cu"
BUILD_DIR = _cuda_build.BUILD_DIR

#: kernel launches per wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {"radix_segment_reduce": 0}
#: nvcc's output (``-Xptxas -v``) from the build this process loaded
BUILD_LOG: List[str] = []
#: the library's C symbols (a loaded library lacking one is refused)
SYMBOLS = ("srt_radix_segment_reduce",
           "srt_radix_tile_rows",
           "srt_radix_error_string",)
#: sorted rows a block of the kernel owns (TILE in the .cu)
TILE_ROWS = 1024

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
        # the arrays go as the addresses of array.array buffers
        lib.srt_radix_segment_reduce.argtypes = [
            vp, vp, i64, i32, i32, vp, vp, i32, vp, vp, vp, vp]
        lib.srt_radix_segment_reduce.restype = i32
        if lib.srt_radix_tile_rows() != TILE_ROWS:
            raise RuntimeError(f"{SOURCE.name} has tiles of "
                               f"{lib.srt_radix_tile_rows()} rows, the "
                               f"wrapper {TILE_ROWS}")
        lib.srt_radix_error_string.argtypes = [i32]
        lib.srt_radix_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


class Packed(NamedTuple):
    """A call's arguments as the kernel takes them: each distinct column
    and validity once, in the dtype the kernel reads (``inputs``), and
    per stream its kind, ``is_min`` and the indices of its data and its
    validity in ``inputs`` (:data:`NONE` for none), four ints a stream
    (``sargs``)."""

    inputs: List[torch.Tensor]
    sargs: List[int]


#: the index of a stream's absent data or validity in :attr:`Packed.sargs`
NONE = -1


def _target_dtype(kind: str, t: torch.Tensor) -> torch.dtype:
    """The dtype the kernel reads a stream's data in: float sums f32 or
    f64, integer sums int32 or int64, order words int64."""
    if kind == "fsum":
        return t.dtype if t.dtype in (torch.float32, torch.float64) \
            else torch.float64
    if kind == "isum" and t.dtype == torch.int32:
        return torch.int32
    return torch.int64


def _check(t: torch.Tensor, cap: int, device: torch.device) -> None:
    if t.device != device or t.shape[0] != cap:
        raise ValueError(f"stream tensor of shape {tuple(t.shape)} on "
                         f"{t.device} for {cap} rows on {device}")


def pack_arguments(streams: Sequence[Stream], cap: int,
                   device: torch.device) -> Packed:
    """The streams' distinct inputs and per-stream indices (see
    :class:`Packed`). A tensor two streams share (an aggregate's count
    and its sum read one validity, sum and avg one column) is one input;
    a conversion is made only where a dtype needs one, once per tensor.
    Raises on a tensor on another device or of another length."""
    by_obj: Dict[tuple, int] = {}  # (id, dtype read) -> input
    by_mem: Dict[tuple, int] = {}  # (address, dtype, dtype read) -> input
    inputs: List[torch.Tensor] = []
    sargs: List[int] = []

    def slot(t: torch.Tensor, dtype: torch.dtype) -> int:
        i = by_obj.get((id(t), dtype))
        if i is not None:
            return i
        key = (t.data_ptr(), t.dtype, dtype)
        i = by_mem.get(key)
        if i is None:
            _check(t, cap, device)
            i = by_mem[key] = len(inputs)
            inputs.append((t if t.dtype == dtype else t.to(dtype))
                          .contiguous())
        by_obj[id(t), dtype] = i
        return i

    for s in streams:
        kind = _KINDS.get(s.kind)
        if kind is None:
            raise ValueError(f"unknown stream kind {s.kind!r}")
        sargs += (kind, int(s.op == "min"),
                  NONE if s.data is None else
                  slot(s.data, _target_dtype(s.kind, s.data)),
                  NONE if s.valid is None else slot(s.valid, torch.bool))
    return Packed(inputs, sargs)


def _outputs(streams: Sequence[Stream], cap: int, dev) -> Tuple[
        List[tuple], List[int]]:
    """Each stream's output tensors, rows of one unwritten allocation
    (the kernel writes every segment the live rows reach), and their
    device addresses, three a stream (0 where a kind has fewer): count
    and isum one int64 row, fsum two f64 rows (normal, big) and a uint8
    row (flags), pos and win one int32 row. The 8-byte rows come first,
    so every row is aligned."""
    kinds = [s.kind for s in streams]
    nf = kinds.count("fsum")
    n64 = kinds.count("count") + kinds.count("isum")
    n32 = len(kinds) - nf - n64
    a = 8 * cap * n64
    b = a + 16 * cap * nf
    c = b + 4 * cap * n32
    buf = torch.empty(max(1, c + cap * nf), dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    i64 = buf[:a].view(torch.int64).view(n64, cap).unbind(0) if n64 else ()
    f64 = (buf[a:b].view(torch.float64).view(2 * nf, cap).unbind(0)
           if nf else ())
    i32 = buf[b:c].view(torch.int32).view(n32, cap).unbind(0) if n32 else ()
    u8 = buf[c:].view(nf, cap).unbind(0) if nf else ()
    outs: List[tuple] = []
    addrs: List[int] = []
    j64 = jf = j32 = 0
    for k in kinds:
        if k == "fsum":
            outs.append((f64[2 * jf], f64[2 * jf + 1], u8[jf]))
            o = base + a + 16 * cap * jf
            addrs += (o, o + 8 * cap, base + c + cap * jf)
            jf += 1
        elif k == "count" or k == "isum":
            outs.append((i64[j64],))
            addrs += (base + 8 * cap * j64, 0, 0)
            j64 += 1
        else:
            outs.append((i32[j32],))
            addrs += (base + b + 4 * cap * j32, 0, 0)
            j32 += 1
    return outs, addrs


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


def segment_reduce_bytes(perm: torch.Tensor, seg: torch.Tensor,
                         streams: Sequence[Stream]) -> int:
    """:func:`bound_bytes` at this call's live rows and segments (two
    host reads)."""
    cap = perm.shape[0]
    nlive = int(((seg >= 0) & (seg < cap)).sum())
    nseg = int(seg[:nlive].max()) + 1 if nlive else 0
    return bound_bytes(perm, streams, nlive, nseg)


def segment_reduce(perm: torch.Tensor, seg: torch.Tensor,
                   streams: Sequence[Stream], ref_tile: int) -> List[tuple]:
    """Every stream reduced per segment of the sorted order (see
    :class:`Stream` and :func:`segment_reduce_plain` for the outputs).
    ``ref_tile`` is the reference's tile length, which decides max's tie
    across tiles. On the card a call makes two launches (the tiles, then
    the fold of the segments that span them) for each group of up to 32
    streams whose distinct inputs fit the kernel's stage, and counts one
    in :data:`LAUNCHES`."""
    cap = perm.shape[0]
    if seg.device != perm.device or seg.shape[0] != cap:
        raise ValueError("seg must match perm's device and length")
    if perm.device.type == "cpu":
        for s in streams:
            for t in (s.data, s.valid):
                if t is not None:
                    _check(t, cap, perm.device)
        return segment_reduce_plain(perm, seg, streams, ref_tile)
    if perm.device.type != "cuda":
        raise ValueError(f"no kernel for device {perm.device}")
    if cap >= 1 << 31:
        raise ValueError(f"the RADIX kernel takes fewer than 2^31 rows, "
                         f"got {cap}")
    lib = build_kernels()
    dev = perm.device
    packed = pack_arguments(streams, cap, dev)
    outs, addrs = _outputs(streams, cap, dev)
    if cap == 0 or not streams:
        return outs
    p64 = perm.to(torch.int64).contiguous()
    s32 = seg.to(torch.int32).contiguous()
    sargs = array.array("i", packed.sargs)
    outp = array.array("Q", addrs)
    inp = array.array("Q", [t.data_ptr() for t in packed.inputs] or [0])
    ins = array.array("i", [t.element_size() for t in packed.inputs] or [0])
    ni = len(packed.inputs)
    # the tile partials: (streams, tiles, 6) u64
    scratch = torch.empty(len(streams) * -(-cap // TILE_ROWS) * 6,
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev), _kernel_cost.kernel_launch(
            "radix_segment_reduce",
            lambda: segment_reduce_bytes(perm, seg, streams)):
        rc = lib.srt_radix_segment_reduce(
            p64.data_ptr(), s32.data_ptr(), cap,
            int(ref_tile), len(streams), sargs.buffer_info()[0],
            outp.buffer_info()[0], ni, inp.buffer_info()[0],
            ins.buffer_info()[0], scratch.data_ptr(), _stream(dev))
    _cuda_build.check_launch(lib.srt_radix_error_string, rc,
                             "radix_segment_reduce")
    count_launch("radix_segment_reduce")
    return outs
