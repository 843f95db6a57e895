"""Bucket reductions under four tiers.

Counterpart of ``spark_rapids_tpu/ops/bucket_reduce.py``:

  * **PALLAS** — the hand-written bucket kernels K1-K3
    (``ops/groupby_kernels.py``) on the card, their plain versions on
    the CPU;
  * **SCATTER** — torch ``index_add_`` / ``scatter_reduce_``, the way the
    reference's SCATTER tier uses XLA segment ops. These are the kernels'
    plain versions themselves (one copy of each reduction), so the
    SCATTER tier on the card is the same code that the kernels are held
    against;
  * **SORT** — rows stably sorted by bucket id, then every bucket's sum
    is a difference of prefix sums at its boundaries
    (:func:`contiguous_segment_reduce`);
  * **MATMUL** — the reference's one-hot limb matmul: int64 values split
    into eight 8-bit limbs reduced by a one-hot f32 product in 65 536-row
    blocks (65 536 x 255 < 2^24 keeps every block's sums exact), counts
    a ones limb, floats an f32 hi/lo pair. The product is
    ``torch.matmul`` in full f32: with TF32 on it would not be exact, so
    the tier raises while ``torch.backends.cuda.matmul.allow_tf32`` is
    set.

Min/max under SCATTER, SORT and MATMUL reduce with ``scatter_reduce_``
(the reference's ``segment_min``/``segment_max``); under PALLAS on K3.
The reference's 16-bit one-hot lookup of :func:`bucket_lookup_u32` is a
plain gather here, which gives the same bits. Rows whose bucket id lies
outside [0, B) drop out of every reduction.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import groupby_kernels as K

#: rows per MATMUL block: 65536 * 255 < 2^24 keeps the f32 sums exact
BLOCK_R = 1 << 16
#: 8-bit limbs per int64
N_LIMBS = 8
#: one-hot elements one MATMUL product may hold (1 GiB of f32)
_ONE_HOT_ELEMS = 1 << 28
#: the largest finite f32: larger magnitudes detour around the product
F32_MAX = 3.4028234663852886e38
#: |x| above this (or not finite) detours around SORT's prefix sums
F64_BIG = 2.0 ** 500

#: test hook, as the reference's: force the MATMUL tier on any strategy
FORCE_MATMUL = False
#: test hook, as the reference's: one pass per column instead of one
#: fused pass per family (the baseline the fusion is held to)
FORCE_PER_COLUMN = False

TIERS = ("MATMUL", "SCATTER", "SORT", "PALLAS")


def _resolve_strategy(strategy: Optional[str] = None) -> str:
    """The lowering for one reduction: an already-chosen tier from the
    aggregate exec's chooser (``FORCE_MATMUL`` outranks it); None, AUTO
    and RADIX (whose plans never reach the bucket tiers) are SCATTER,
    the plain torch tier."""
    if FORCE_MATMUL:
        return "MATMUL"
    if strategy in TIERS:
        return strategy
    return "SCATTER"


def check_full_f32(dev: torch.device) -> None:
    """Raise unless f32 products on ``dev`` run in full f32: the MATMUL
    tier's exactness needs it, and TF32 keeps 10 mantissa bits."""
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the MATMUL aggregation tier needs full f32 products (65 536 x "
            "255 < 2^24 per block), but torch.backends.cuda.matmul."
            "allow_tf32 is on")


def _prefix_boundaries(sorted_seg: torch.Tensor, B: int) -> torch.Tensor:
    """``bounds[b]`` = the first position of the NONDECREASING ids with
    id >= b, shape (B+1,); ids outside [0, B) fall outside every range."""
    return torch.searchsorted(
        sorted_seg, torch.arange(B + 1, dtype=sorted_seg.dtype,
                                 device=sorted_seg.device), side="left")


def _any_host(flags: Sequence[torch.Tensor]) -> List[bool]:
    """Each 0-d bool on the host, with one sync for all of them."""
    if not flags:
        return []
    return [bool(x) for x in torch.stack(flags).tolist()]


def contiguous_segment_reduce(
    seg: torch.Tensor,
    B: int,
    int_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
    count_cols: Sequence[torch.Tensor] = (),
    float_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Per-bucket sums and counts over a NONDECREASING ``seg`` as
    prefix-sum differences at the bucket boundaries (reference
    ``bucket_reduce.py:116``). Integer sums and counts are bit-exact: the
    int64 prefixes wrap mod 2^64, and differences of wrapped prefixes are
    the wrapped sums. A non-finite or huge (|x| > 2^500) float row would
    poison every later bucket's prefix, so those rows detour through a
    segment sum; whether any does is one host decision for all float
    columns (the reference's ``lax.cond``)."""
    bounds = _prefix_boundaries(seg, B)
    lo, hi = bounds[:-1], bounds[1:]

    def diffs(cols: List[torch.Tensor]) -> torch.Tensor:
        # one prefix sum per column along its contiguous row: a scan down
        # the outer dimension of an (n, k) stack took 3.4 s at 2^26 rows
        # on the H100
        c = torch.cumsum(torch.stack(cols), 1)
        padded = torch.cat([torch.zeros_like(c[:, :1]), c], 1)
        return padded[:, hi] - padded[:, lo]

    out_int: List[torch.Tensor] = []
    out_cnt: List[torch.Tensor] = []
    out_flt: List[torch.Tensor] = []
    cols = ([torch.where(v, d.to(torch.int64), 0) for d, v in int_cols]
            + [v.to(torch.int64) for v in count_cols])
    if cols:
        s = diffs(cols)
        out_int = [s[i] for i in range(len(int_cols))]
        out_cnt = [s[len(int_cols) + i] for i in range(len(count_cols))]
    if float_cols:
        finite_cols, bads = [], []
        for data, valid in float_cols:
            d = torch.where(valid, data.to(torch.float64), 0.0)
            bad = ~torch.isfinite(d) | (d.abs() > F64_BIG)
            finite_cols.append(torch.where(bad, 0.0, d))
            bads.append((bad, d))
        f = diffs(finite_cols)
        detour = _any_host([b.any() for b, _ in bads])
        for i, ((bad, d), take) in enumerate(zip(bads, detour)):
            out = f[i]
            if take:
                out = out + K.bucket_float_sum_plain(
                    seg, B, [(torch.where(bad, d, 0.0), bad)])[0]
            out_flt.append(out)
    return out_int, out_cnt, out_flt


def _bucket_reduce_sort(seg, B, int_cols, count_cols, float_cols):
    """SORT: stably sort rows by bucket id, gather every column into
    bucket order once, reduce the now-contiguous buckets with
    :func:`contiguous_segment_reduce` (reference ``bucket_reduce.py:194``)."""
    perm = torch.argsort(seg, stable=True)
    return contiguous_segment_reduce(
        seg[perm], B,
        [(d[perm], v[perm]) for d, v in int_cols],
        [v[perm] for v in count_cols],
        [(d[perm], v[perm]) for d, v in float_cols])


def _one_hot_products(seg: torch.Tensor, B: int,
                      cols: torch.Tensor) -> torch.Tensor:
    """(nblocks, L, B) f32: per block of :data:`BLOCK_R` rows, the one-hot
    product ``cols_block^T @ one_hot(seg_block)``; ids outside [0, B)
    one-hot to a zero row. As many blocks a product as
    :data:`_ONE_HOT_ELEMS` one-hot elements allow."""
    n, L = cols.shape
    dev = seg.device
    R = min(BLOCK_R, max(n, 1))
    nb = max(1, -(-n // R))
    pad = nb * R - n
    seg_p = torch.cat([seg.to(torch.int64),
                       torch.full((pad,), -1, dtype=torch.int64, device=dev)])
    cols_p = torch.cat([cols, torch.zeros((pad, L), dtype=cols.dtype,
                                          device=dev)])
    ids = torch.arange(B, dtype=torch.int64, device=dev)
    step = max(1, _ONE_HOT_ELEMS // (R * max(B, 1)))
    parts = []
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        s = seg_p[b0 * R:b1 * R].reshape(b1 - b0, R)
        oh = (s[:, :, None] == ids).to(torch.float32)  # (k, R, B)
        c = cols_p[b0 * R:b1 * R].reshape(b1 - b0, R, L)
        parts.append(torch.bmm(c.transpose(1, 2), oh))  # (k, L, B)
    return torch.cat(parts)


def _bucket_reduce_matmul(seg, B, int_cols, count_cols, float_cols):
    """MATMUL (reference ``bucket_reduce.py:269-362``): every column's
    limbs stacked into one (n, L) f32 operand reduced by one one-hot
    product per row block; block partials are exact integers below 2^24
    and accumulate in int64 (ints) or f64 (the float hi/lo pairs). Float
    rows beyond the f32 range (or NaN) detour through a segment sum;
    whether any does is one host decision for all float columns."""
    check_full_f32(seg.device)
    limbs: List[torch.Tensor] = []
    for data, valid in int_cols:
        d = torch.where(valid, data.to(torch.int64), 0)
        for i in range(N_LIMBS):
            limbs.append(((d >> (8 * i)) & 0xFF).to(torch.float32))
    for valid in count_cols:
        limbs.append(valid.to(torch.float32))
    nf_start = len(limbs)
    ovfs = []
    for data, valid in float_cols:
        d = torch.where(valid, data.to(torch.float64), 0.0)
        ovf = ~(d.abs() <= F32_MAX)
        d_main = torch.where(ovf, 0.0, d)
        hi = d_main.to(torch.float32)
        limbs.append(hi)
        limbs.append((d_main - hi.to(torch.float64)).to(torch.float32))
        ovfs.append((ovf, d))
    if not limbs:
        return [], [], []
    S = _one_hot_products(seg, B, torch.stack(limbs, -1))
    acc_i = S[:, :nf_start, :].to(torch.int64).sum(0)  # exact
    acc_f = S[:, nf_start:, :].to(torch.float64).sum(0)
    out_int: List[torch.Tensor] = []
    k = 0
    for _ in int_cols:
        total = torch.zeros(B, dtype=torch.int64, device=seg.device)
        for i in range(N_LIMBS):
            total = total + (acc_i[k] << (8 * i))
            k += 1
        out_int.append(total)
    out_cnt = [acc_i[k + i] for i in range(len(count_cols))]
    out_flt: List[torch.Tensor] = []
    detour = _any_host([o.any() for o, _ in ovfs])
    for i, ((ovf, d), take) in enumerate(zip(ovfs, detour)):
        out = acc_f[2 * i] + acc_f[2 * i + 1]
        if take:
            out = out + K.bucket_float_sum_plain(
                seg, B, [(torch.where(ovf, d, 0.0), ovf)])[0]
        out_flt.append(out)
    return out_int, out_cnt, out_flt


def _bucket_reduce_pass(seg, B, int_cols=(), count_cols=(), float_cols=(),
                        strategy=None):
    tier = _resolve_strategy(strategy)
    if tier == "PALLAS":
        return K.kernel_bucket_reduce(seg, B, int_cols, count_cols,
                                      float_cols)
    if tier == "SORT":
        return _bucket_reduce_sort(seg, B, int_cols, count_cols, float_cols)
    if tier == "MATMUL":
        return _bucket_reduce_matmul(seg, B, int_cols, count_cols,
                                     float_cols)
    isums, counts = K.bucket_sum_plain(seg, B, int_cols, count_cols)
    return isums, counts, K.bucket_float_sum_plain(seg, B, float_cols)


def bucket_reduce(
    seg: torch.Tensor,
    B: int,
    int_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
    count_cols: Sequence[torch.Tensor] = (),
    float_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
    strategy: Optional[str] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Every requested reduction across every column in one pass per
    family (one pass per column under ``FORCE_PER_COLUMN``).

    seg: (n,) int32 bucket ids; ids outside [0, B) are dropped.
    int_cols:   [(data int64/int32, valid bool)] -> exact int64 sums (B,)
    count_cols: [valid bool] -> int64 counts (B,)
    float_cols: [(data f64/f32, valid bool)] -> f64 sums (B,)
    """
    if not FORCE_PER_COLUMN:
        return _bucket_reduce_pass(seg, B, int_cols, count_cols,
                                   float_cols, strategy)
    out_int: List[torch.Tensor] = []
    out_cnt: List[torch.Tensor] = []
    out_flt: List[torch.Tensor] = []
    for spec in int_cols:
        out_int += _bucket_reduce_pass(seg, B, [spec], (), (), strategy)[0]
    for valid in count_cols:
        out_cnt += _bucket_reduce_pass(seg, B, (), [valid], (), strategy)[1]
    for spec in float_cols:
        out_flt += _bucket_reduce_pass(seg, B, (), (), [spec], strategy)[2]
    return out_int, out_cnt, out_flt


def bucket_min_max(seg: torch.Tensor, B: int, op: str,
                   cols: Sequence[torch.Tensor],
                   strategy: Optional[str] = None) -> List[torch.Tensor]:
    """Per-bucket min/max of identity-prefilled columns (callers overwrite
    empty buckets via their count mask). Every tier reduces the columns'
    order words, NaN largest: PALLAS on K3, folding -0.0 into 0.0 as the
    reference's PALLAS tier does; SCATTER, SORT and MATMUL on K3's plain
    version (``scatter_reduce_``) with -0.0 below 0.0, as the reference's
    ``segment_min``/``segment_max`` order the raw values
    (``bucket_reduce.py:364-388``)."""
    if _resolve_strategy(strategy) == "PALLAS":
        return K.min_max_by_words(K.bucket_winner, seg, B, op, cols)
    return K.min_max_by_words(K.bucket_winner_plain, seg, B, op, cols,
                              keep_zero_sign=True)


def bucket_lookup_u32(seg: torch.Tensor, B: int,
                      table: torch.Tensor) -> torch.Tensor:
    """Per-row lookup of a bucket table value (a plain clipped gather, the
    same bits as the reference's 16-bit one-hot lookup under MATMUL);
    rows with seg outside [0, B) read 0."""
    s = seg.to(torch.int64)
    t = table[s.clamp(0, B - 1)]
    return torch.where((s >= 0) & (s < B), t, torch.zeros_like(t))


def bucket_equal_check(seg: torch.Tensor, B: int, word: torch.Tensor,
                       rep_table: torch.Tensor,
                       live: torch.Tensor) -> torch.Tensor:
    """0-d bool: every live row's ``word`` equals its bucket's
    representative (exact collision detection for the hash tier)."""
    mismatch = live & (bucket_lookup_u32(seg, B, rep_table) != word)
    return ~torch.any(mismatch)
