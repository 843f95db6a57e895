"""Spark-compatible Murmur3_x86_32 hashing, fixed-width columns.

Counterpart of ``spark_rapids_tpu/ops/hashing.py``, bit-exact with it (the
hash bucket tier of the group-by depends on that). torch has no uint32
arithmetic on every device, so each 32-bit word rides in an int64 tensor
holding a value in [0, 2^32): products wrap mod 2^64 and are masked back
to their low 32 bits, which are exactly the uint32 products.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .. import types as T
from ..expr.values import ColV

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


def hash_column(col: ColV, dtype: T.DataType,
                seed: torch.Tensor) -> torch.Tensor:
    """Hash one column into the running per-row seed; nulls leave it as-is."""
    data = col.data
    if isinstance(dtype, T.BooleanType):
        h = hash_int(data.to(torch.int32), seed)
    elif isinstance(dtype, T.FloatType):
        h = hash_int(canonical_float(data).view(torch.int32), seed)
    elif isinstance(dtype, T.DoubleType):
        h = hash_long(canonical_float(data).view(torch.int64), seed)
    elif isinstance(dtype, T.LongType):
        h = hash_long(data, seed)
    elif isinstance(dtype, (T.ByteType, T.ShortType, T.IntegerType)):
        h = hash_int(data, seed)
    else:
        raise NotImplementedError(
            f"hashing {dtype.simpleString} is {T.NOT_PORTED_TYPES}")
    return torch.where(col.validity, h, seed)


def murmur3(cols: Sequence[ColV], dtypes: Sequence[T.DataType],
            seed: int = DEFAULT_SEED) -> torch.Tensor:
    """Spark Murmur3Hash(expr*) — int32 result, seed chained across
    columns."""
    cap = cols[0].validity.shape[0]
    h = torch.full((cap,), seed & _M32, dtype=torch.int64,
                   device=cols[0].validity.device)
    for c, dt in zip(cols, dtypes):
        h = hash_column(c, dt, h)
    return (((h + 2**31) & _M32) - 2**31).to(torch.int32)
