"""Radix keys and the multi-key stable sort, fixed-width part.

Counterpart of ``spark_rapids_tpu/ops/sort.py``. Every key column becomes
order-preserving unsigned radix keys (sign-bit flip for integers, the IEEE
total-order trick for floats with Spark's NaN-largest / -0.0 == 0.0
rules; subnormals fold to 0.0 as on the reference's backends). torch lacks unsigned 64-bit comparisons, so a radix key rides in
an int64 tensor holding the same bit pattern as the reference's uint32 or
uint64 key; XOR with the sign bit (:data:`SIGN64`) maps unsigned order to
signed order for sorting. Only the bit-exact f64 branch of
``_float_radix`` (``sort.py:76-79``) is ported: the TPU's f32-pair branch
has no meaning on a card with native f64.

torch has no multi-key sort: :func:`sort_with_radix_keys` runs one stable
sort per key, least significant first.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from .. import types as T
from ..expr.values import ColV
from .filter_gather import live_of
from .hashing import canonical_float, flush_subnormals

#: int64 with only bit 63 set; ``k ^ SIGN64`` turns unsigned order into
#: signed order
SIGN64 = -(2**63)
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SortOrder:
    ascending: bool = True
    nulls_first: bool = None  # type: ignore[assignment]  # None = Spark default

    @property
    def nulls_first_resolved(self) -> bool:
        if self.nulls_first is None:
            return self.ascending
        return self.nulls_first


def _int_radix(data: torch.Tensor) -> torch.Tensor:
    """Sign-bit flip: the uint32 key (in [0, 2^32)) for <= 32-bit
    integers, the uint64 key's bit pattern for int64."""
    if data.element_size() <= 4:
        return (data.to(torch.int64) & _M32) ^ (1 << 31)
    return data ^ SIGN64


def _float_radix(data: torch.Tensor,
                 keep_zero_sign: bool = False) -> torch.Tensor:
    """IEEE total-order trick with Spark's NaN-largest and -0.0 == 0.0;
    with ``keep_zero_sign`` -0.0 sorts just below 0.0, as the reference's
    SCATTER-tier min/max order them (a subnormal reads as the zero of its
    sign there)."""
    if keep_zero_sign:
        d = flush_subnormals(torch.where(torch.isnan(data), float("nan"),
                                         data))
    else:
        d = canonical_float(data)  # NaN canonical; -0.0, subnormals -> +0.0
    if data.dtype == torch.float32:
        bits = d.view(torch.int32).to(torch.int64) & _M32
        neg = bits >= (1 << 31)
        return torch.where(neg, bits ^ _M32, bits ^ (1 << 31))
    bits = d.view(torch.int64)
    return torch.where(bits < 0, ~bits, bits ^ SIGN64)


def radix_of(data: torch.Tensor, keep_zero_sign: bool = False) -> torch.Tensor:
    """The order-preserving radix key of a fixed-width value tensor
    (``keep_zero_sign``: see :func:`_float_radix`)."""
    if data.is_floating_point():
        return _float_radix(data, keep_zero_sign)
    if data.dtype == torch.bool:
        return data.to(torch.int64)
    return _int_radix(data)


def fixed_radix_keys(col: ColV, dtype: T.DataType,
                     order: SortOrder) -> List[torch.Tensor]:
    """[null_rank, value_key] for a fixed-width column."""
    if dtype.is_floating:
        k = _float_radix(col.data)
    elif isinstance(dtype, T.BooleanType):
        k = col.data.to(torch.int64)
    else:
        k = _int_radix(col.data)
    if not order.ascending:
        raise NotImplementedError(
            "descending sort keys come with the sort exec: see ROADMAP.md, "
            "queue A 'Later slices'")
    null_rank = torch.where(
        col.validity, 1, 0 if order.nulls_first_resolved else 2)
    k = torch.where(col.validity, k, 0)
    return [null_rank.to(torch.int64), k]


def sort_with_radix_keys(key_cols: Sequence[ColV],
                         key_dtypes: Sequence[T.DataType],
                         orders: Sequence[SortOrder],
                         num_rows) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(permutation, sorted radix key arrays); padding rows sort last.

    Lexicographic over [pad_rank, per key (null_rank, value_key)], ties
    by row id — one stable sort per key, least significant first."""
    cap = key_cols[0].validity.shape[0]
    dev = key_cols[0].validity.device
    pad_rank = (~live_of(num_rows, cap, dev)).to(torch.int64)
    keys: List[torch.Tensor] = []
    for colv, dtype, order in zip(key_cols, key_dtypes, orders):
        keys.extend(fixed_radix_keys(colv, dtype, order))
    perm = torch.arange(cap, dtype=torch.int64, device=dev)
    for k in reversed([pad_rank] + keys):
        perm = perm[torch.argsort(k[perm] ^ SIGN64, stable=True)]
    return perm, [k[perm] for k in keys]
