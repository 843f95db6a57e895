"""Spark-compatible Murmur3_x86_32 hashing of fixed-width and string
columns.

Counterpart of ``spark_rapids_tpu/ops/hashing.py``, bit-exact with it (the
hash bucket tier of the group-by depends on that). torch has no uint32
arithmetic on every device, so each 32-bit word rides in an int64 tensor
holding a value in [0, 2^32): products wrap mod 2^64 and are masked back
to their low 32 bits, which are exactly the uint32 products.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import types as T
from ..expr.values import StrV, Val

DEFAULT_SEED = 42

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    k1 = (k1 * _C1) & _M32
    k1 = _rotl(k1, 15)
    return (k1 * _C2) & _M32


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = h1 ^ k1
    h1 = _rotl(h1, 13)
    return (h1 * 5 + 0xE6546B64) & _M32


def _fmix(h1: torch.Tensor, length: int) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an integer tensor, as an int64 in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def hash_int(data: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashInt: one 4-byte word (int/short/byte/bool/float-bits)."""
    return _fmix(_mix_h1(seed, _mix_k1(_u32(data))), 4)


def hash_long(data: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashLong: low word then high word (Murmur3_x86_32.hashLong)."""
    u = data.to(torch.int64)
    low = u & _M32
    high = (u >> 32) & _M32
    h1 = _mix_h1(seed, _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return _fmix(h1, 8)


def hash_string(col: StrV, seed: torch.Tensor, max_len: int) -> torch.Tensor:
    """hashUnsafeBytes over UTF-8 (reference ``hashing.py:78``): each
    full 4-byte little-endian block, then each tail byte sign-extended.
    ``max_len`` bounds the byte length (bucketed by the caller)."""
    cap = col.offsets.shape[0] - 1
    dev = col.offsets.device
    starts = col.offsets[:-1].to(torch.int64)
    ends = col.offsets[1:].to(torch.int64)
    lens = ends - starts
    pool = torch.cat([col.chars.reshape(-1),
                      torch.zeros(4, dtype=torch.uint8, device=dev)])
    win = pool.unfold(0, 4, 1)  # win[p] = pool[p:p + 4], a view
    h1 = seed.expand(cap)
    for c in range(max_len // 4 + 1):
        base = starts + 4 * c
        word = win[base.clamp(0, win.shape[0] - 1)].contiguous().view(
            torch.int32).reshape(cap)
        h1 = torch.where(base + 4 <= ends, _mix_h1(h1, _mix_k1(_u32(word))),
                         h1)
    aligned = starts + (lens & ~3)
    for b in range(3):
        pos = aligned + b
        sbyte = pool[pos.clamp(0, pool.shape[0] - 1)].view(torch.int8)
        h1 = torch.where(pos < ends, _mix_h1(h1, _mix_k1(_u32(sbyte))), h1)
    return _fmix(h1, lens & _M32)


def canonical_float(data: torch.Tensor) -> torch.Tensor:
    """NaN canonicalized; -0.0 and subnormals folded to +0.0. The
    reference's backends treat subnormals as zero in these compares (XLA
    on the CPU and the TPU), so a subnormal hashes and groups with 0.0
    there; the port does the same to stay bit-exact with it."""
    d = torch.where(torch.isnan(data), float("nan"), data)
    return torch.where(d.abs() < torch.finfo(d.dtype).tiny, 0.0, d)


def flush_subnormals(data: torch.Tensor) -> torch.Tensor:
    """A float tensor as the reference's backends read its operands in
    compares, zero checks and min/max: a subnormal is the zero of its
    sign. Other dtypes pass through."""
    if not data.is_floating_point():
        return data
    return torch.where(data.abs() < torch.finfo(data.dtype).tiny,
                       torch.copysign(torch.zeros_like(data), data), data)


def hash_column(col: Val, dtype: T.DataType, seed: torch.Tensor,
                str_max_len: Optional[int] = None) -> torch.Tensor:
    """Hash one column into the running per-row seed; nulls leave it
    as-is. A string column needs its byte bound ``str_max_len``."""
    if isinstance(col, StrV):
        if str_max_len is None:
            raise ValueError("a string column needs its byte bound "
                             "(ops/sort.str_max_lens)")
        return torch.where(col.validity,
                           hash_string(col, seed, str_max_len), seed)
    data = col.data
    if isinstance(dtype, T.BooleanType):
        h = hash_int(data.to(torch.int32), seed)
    elif isinstance(dtype, T.FloatType):
        h = hash_int(canonical_float(data).view(torch.int32), seed)
    elif isinstance(dtype, T.DoubleType):
        h = hash_long(canonical_float(data).view(torch.int64), seed)
    elif isinstance(dtype, (T.LongType, T.TimestampType, T.DecimalType)):
        h = hash_long(data, seed)
    elif isinstance(dtype, (T.ByteType, T.ShortType, T.IntegerType,
                            T.DateType)):
        h = hash_int(data, seed)
    else:
        raise TypeError(f"hashing {dtype.simpleString} is not supported")
    return torch.where(col.validity, h, seed)


def murmur3(cols: Sequence[Val], dtypes: Sequence[T.DataType],
            seed: int = DEFAULT_SEED,
            str_max_lens: Sequence[int] = ()) -> torch.Tensor:
    """Spark Murmur3Hash(expr*) — int32 result, seed chained across
    columns; ``str_max_lens`` bounds each string column in turn (each
    must have one)."""
    cap = cols[0].validity.shape[0]
    h = torch.full((cap,), seed & _M32, dtype=torch.int64,
                   device=cols[0].validity.device)
    lens = iter(str_max_lens)
    for c, dt in zip(cols, dtypes):
        h = hash_column(c, dt, h,
                        next(lens, None) if isinstance(c, StrV) else None)
    return (((h + 2**31) & _M32) - 2**31).to(torch.int32)


def partition_ids(hashes: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Spark's ``pmod(hash, n)`` partition assignment (HashPartitioning;
    reference ``hashing.py:158``): int32 ids in [0, n), also for negative
    hashes."""
    return torch.remainder(hashes.to(torch.int64),
                           num_partitions).to(torch.int32)
