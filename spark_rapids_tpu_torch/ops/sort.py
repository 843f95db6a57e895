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

torch has no multi-key sort: :func:`sort_with_radix_keys` packs the
lexicographic key sequence into as few int64 sort keys as its digits'
widths allow (a rank of 1-2 bits and a 32-bit radix share one word; a
64-bit radix takes a word of its own) and runs one stable ``argsort`` per
word, least significant first. String keys (``string_chunk_keys``) are
not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from .. import types as T
from ..expr.values import ColV, StrV, Val
from .filter_gather import gather, live_of
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


def _flip(k: torch.Tensor, bits: int) -> torch.Tensor:
    """Reverse the unsigned order of a ``bits``-wide radix key (the
    reference's ``~k`` on its uint32 / uint64 key)."""
    return ~k if bits == 64 else k ^ ((1 << bits) - 1)


def _radix_bits(dtype: T.DataType, data: torch.Tensor) -> int:
    if isinstance(dtype, T.BooleanType):
        return 1
    return 64 if data.element_size() == 8 else 32


def fixed_radix_keys(col: ColV, dtype: T.DataType,
                     order: SortOrder) -> List[torch.Tensor]:
    """[null_rank, value_key] for a fixed-width column (reference
    ``sort.py:98``): a descending key's radix is flipped; null rows rank
    0 (nulls first) or 2 (nulls last) and carry key 0."""
    if dtype.is_floating:
        k = _float_radix(col.data)
    elif isinstance(dtype, T.BooleanType):
        k = col.data.to(torch.int64)
    else:
        k = _int_radix(col.data)
    if not order.ascending:
        k = _flip(k, _radix_bits(dtype, col.data))
    null_rank = torch.where(
        col.validity, 1, 0 if order.nulls_first_resolved else 2)
    k = torch.where(col.validity, k, 0)
    return [null_rank.to(torch.int64), k]


def _sort_words(digits: Sequence[Tuple[torch.Tensor, int, bool]]
                ) -> List[Tuple[torch.Tensor, bool, bool]]:
    """Pack (key, bits, is_rank) digits, most significant first, into
    sort words, least significant word first, as (word, is_64bit,
    ranks_only). Digits share a word while it stays within 63 bits
    (non-negative, so signed order is unsigned order); a 64-bit digit
    takes a word of its own, sorted through ``^ SIGN64``."""
    words: List[Tuple[torch.Tensor, bool, bool]] = []
    acc, used, ranks_only = None, 0, True
    for k, bits, is_rank in reversed(digits):
        if acc is not None and (bits == 64 or used + bits > 63):
            words.append((acc, False, ranks_only))
            acc, used, ranks_only = None, 0, True
        if bits == 64:
            words.append((k, True, False))
            continue
        acc = k if acc is None else acc | (k << used)
        used += bits
        ranks_only = ranks_only and is_rank
    if acc is not None:
        words.append((acc, False, ranks_only))
    return words


def _sort_order(key_cols: Sequence[Val], key_dtypes: Sequence[T.DataType],
                orders: Sequence[SortOrder],
                num_rows) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(permutation, radix key arrays in row order); padding rows sort
    last.

    The order is the reference's ``lax.sort`` over [pad_rank, per key
    (null_rank, value_key), row_id] (``sort.py:164``). The digits pack
    into int64 words (:func:`_sort_words`), each sorted by one stable
    ``argsort``, least significant first, so ties keep row order. A word
    of ranks only (no value key) is skipped when it is the same on every
    row (one host sync): a stable sort by a constant is the identity. The
    pad rank is left out, with no sync, when the row count is a host int
    equal to the capacity."""
    for c in key_cols:
        if isinstance(c, StrV):
            raise NotImplementedError(
                f"sorting by a string key is {T.NOT_PORTED_STRING_LAYERS}")
    cap = key_cols[0].validity.shape[0]
    dev = key_cols[0].validity.device
    keys: List[torch.Tensor] = []
    digits: List[Tuple[torch.Tensor, int, bool]] = []
    if not (isinstance(num_rows, int) and num_rows >= cap):
        digits.append(((~live_of(num_rows, cap, dev)).to(torch.int64), 1,
                       True))
    for colv, dtype, order in zip(key_cols, key_dtypes, orders):
        null_rank, k = fixed_radix_keys(colv, dtype, order)
        keys.extend([null_rank, k])
        digits.append((null_rank, 2, True))
        digits.append((k, _radix_bits(dtype, colv.data), False))
    perm = None
    for w, wide, ranks_only in _sort_words(digits):
        if ranks_only and cap and not bool((w != w[0]).any()):
            continue
        wp = w if perm is None else w[perm]
        if wide:
            wp = wp ^ SIGN64
        p = torch.argsort(wp, stable=True)
        perm = p if perm is None else perm[p]
    if perm is None:
        perm = torch.arange(cap, dtype=torch.int64, device=dev)
    return perm, keys


def sort_with_radix_keys(key_cols: Sequence[Val],
                         key_dtypes: Sequence[T.DataType],
                         orders: Sequence[SortOrder],
                         num_rows) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(permutation, sorted radix key arrays: [null_rank, value_key] per
    key); padding rows sort last (reference ``sort.py:164``). Callers
    find group and peer boundaries from the sorted keys."""
    perm, keys = _sort_order(key_cols, key_dtypes, orders, num_rows)
    return perm, [k[perm] for k in keys]


def sort_permutation(key_cols: Sequence[Val],
                     key_dtypes: Sequence[T.DataType],
                     orders: Sequence[SortOrder],
                     num_rows) -> torch.Tensor:
    """Stable sort permutation over the given keys; padding rows go last
    (reference ``sort.py:196``). The radix keys are not gathered."""
    return _sort_order(key_cols, key_dtypes, orders, num_rows)[0]


def sort_cols(cols: Sequence[Val], key_indices: Sequence[int],
              key_dtypes: Sequence[T.DataType],
              orders: Sequence[SortOrder], num_rows) -> List[Val]:
    """Sort all columns by the keys at ``key_indices`` (reference
    ``sort.py:210``)."""
    c0 = cols[0]
    cap = (c0.offsets.shape[0] - 1 if isinstance(c0, StrV)
           else c0.validity.shape[0])
    perm = sort_permutation([cols[i] for i in key_indices], key_dtypes,
                            orders, num_rows)
    # live rows sort first, so this is ``iota < num_rows`` for a count
    valid_slot = live_of(num_rows, cap, c0.validity.device)[perm]
    return gather(cols, perm, valid_slot)
