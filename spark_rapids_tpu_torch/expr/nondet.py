"""Nondeterministic expressions: the counter-based ``rand`` and Spark's
Murmur3_x86_32.

Own copy of ``spark_rapids_tpu/expr/nondet.py``. ``rand`` is a
counter-based generator, value = mix(seed, partition, row): splitmix64
over the three, the top 53 bits / 2^53 (the reference's design, so a
seed and a partitioning give the same doubles in both packages and on
the CPU engine). The scalar functions are what the CPU interpreter
evaluates; :func:`rand_double_torch` is the device half, bit for bit the
same. The hash's device half is ``ops/hashing.murmur3``.
"""
from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
_INV53 = 1.0 / (1 << 53)


def _splitmix64_scalar(z: int) -> int:
    z = (z + _GOLDEN) & _MASK64
    z = ((z ^ (z >> 30)) * _MIX1) & _MASK64
    z = ((z ^ (z >> 27)) * _MIX2) & _MASK64
    return z ^ (z >> 31)


def rand_double_scalar(seed: int, pid: int, row: int) -> float:
    """One uniform double in [0, 1) — the CPU oracle path."""
    base = _splitmix64_scalar((seed & _MASK64) ^ ((pid & _MASK64) * _GOLDEN))
    h = _splitmix64_scalar(base ^ (row & _MASK64))
    return (h >> 11) * _INV53


def _i64(u: int) -> int:
    """The int64 holding the bits of the uint64 ``u``."""
    u &= _MASK64
    return u - (1 << 64) if u >= (1 << 63) else u


def _shr(z, k: int):
    """Logical right shift of int64 bits: ``>>`` on int64 is arithmetic,
    so the bits shifted in from the sign are masked off."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def rand_double_torch(seed: int, pid: int, rows):
    """Uniform doubles for the int64 row indices ``rows``, bit for bit
    :func:`rand_double_scalar` (reference ``rand_double_jax``). torch has
    no full uint64 arithmetic, so splitmix64 runs on int64 bits: an add or
    a multiply wraps to the uint64 result's bits, every shift is masked
    to a logical one, and the top 53 bits are a non-negative int64, so
    their conversion to f64 is exact."""
    import torch

    base = _splitmix64_scalar((seed & _MASK64) ^ ((pid & _MASK64) * _GOLDEN))
    z = rows.to(torch.int64) ^ _i64(base)
    z = z + _i64(_GOLDEN)
    z = (z ^ _shr(z, 30)) * _i64(_MIX1)
    z = (z ^ _shr(z, 27)) * _i64(_MIX2)
    z = z ^ _shr(z, 31)
    return _shr(z, 11).to(torch.float64) * _INV53


_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mixk1(k1: int) -> int:
    k1 = (k1 * 0xCC9E2D51) & _M32
    k1 = _rotl32(k1, 15)
    return (k1 * 0x1B873593) & _M32


def _mixh1(h1: int, k1: int) -> int:
    h1 = (h1 ^ k1) & _M32
    h1 = _rotl32(h1, 13)
    return (h1 * 5 + 0xE6546B64) & _M32


def _fmix(h1: int, length: int) -> int:
    h1 = (h1 ^ length) & _M32
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def _as_i32(u: int) -> int:
    return u - (1 << 32) if u >= (1 << 31) else u


def murmur3_scalar(value, dtype, seed: int) -> int:
    """Hash one value with Spark's semantics: null leaves the seed
    untouched; int-family/date hash as one word, long/timestamp as two,
    float/double via their bits, strings as UTF-8 bytes."""
    from .. import types as T

    h = seed & _M32
    if value is None:
        return _as_i32(h)
    if isinstance(dtype, (T.BooleanType,)):
        return _as_i32(_fmix(_mixh1(h, _mixk1(1 if value else 0)), 4))
    if isinstance(dtype, (T.ByteType, T.ShortType, T.IntegerType, T.DateType)):
        return _as_i32(_fmix(_mixh1(h, _mixk1(int(value) & _M32)), 4))
    if isinstance(dtype, (T.LongType, T.TimestampType)):
        x = int(value) & _MASK64
        h = _mixh1(h, _mixk1(x & _M32))
        h = _mixh1(h, _mixk1((x >> 32) & _M32))
        return _as_i32(_fmix(h, 8))
    if isinstance(dtype, T.FloatType):
        bits = int(np.float32(value).view(np.int32)) & _M32
        return _as_i32(_fmix(_mixh1(h, _mixk1(bits)), 4))
    if isinstance(dtype, T.DoubleType):
        bits = int(np.float64(value).view(np.int64)) & _MASK64
        h = _mixh1(h, _mixk1(bits & _M32))
        h = _mixh1(h, _mixk1((bits >> 32) & _M32))
        return _as_i32(_fmix(h, 8))
    if isinstance(dtype, (T.StringType, T.BinaryType)):
        b = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        n = len(b) - len(b) % 4
        for i in range(0, n, 4):
            h = _mixh1(h, _mixk1(int.from_bytes(b[i: i + 4], "little")))
        for i in range(n, len(b)):
            sbyte = b[i] - 256 if b[i] >= 128 else b[i]
            h = _mixh1(h, _mixk1(sbyte & _M32))
        return _as_i32(_fmix(h, len(b)))
    raise ValueError(f"murmur3 of {dtype.simpleString} not supported")
