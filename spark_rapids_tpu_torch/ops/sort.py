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
word, least significant first. A string key sorts by its
:func:`string_chunk_keys`: 4-byte big-endian chunks of its bytes,
zero-padded to a byte bound the caller measured (:func:`str_max_lens`),
two chunks to a 64-bit word.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import torch

from .. import types as T
from ..columnar.column import choose_capacity
from ..expr.values import ColV, DictV, StrV, Val
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


def max_string_len(col: StrV) -> torch.Tensor:
    """Device scalar: the longest row's byte length (reference
    ``sort.py:227``); callers bucket it on the host."""
    lens = col.offsets[1:] - col.offsets[:-1]
    if lens.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=lens.device)
    return lens.max()


def str_max_lens(vals: Sequence[Val]) -> Tuple[int, ...]:
    """The byte bound of each string value in ``vals``, in order: its
    longest row rounded up to a power of two of at least 4 (the
    reference's ``max(4, choose_capacity(max(1, m), 4))``), where a
    dictionary-encoded value's longest row is its ``max_len`` (reference
    ``aggregate.py:503``). One host sync for all the plain ones; none
    when there is none."""
    strs = [v for v in vals if isinstance(v, (StrV, DictV))]
    plain = [v for v in strs if isinstance(v, StrV)]
    synced = iter(torch.stack([max_string_len(v) for v in plain]).tolist()
                  if plain else ())
    ms = [v.max_len if isinstance(v, DictV) else next(synced)
          for v in strs]
    return tuple(max(4, choose_capacity(max(1, int(m)), 4)) for m in ms)


def chunk_count(max_len: int) -> int:
    """The 4-byte chunks of a string key bounded by ``max_len`` bytes."""
    return max(1, (max_len + 3) // 4)


def next_bound(lens: Iterator[int]) -> int:
    """The next string key's byte bound from an iterator over a
    ``str_max_lens``. A key past its bound is cut there, so a string key
    without one raises rather than take a guess."""
    b = next(lens, None)
    if b is None:
        raise ValueError("a string key needs its byte bound "
                         "(ops/sort.str_max_lens)")
    return b


def _chunk_pairs(col: StrV, nchunks: int) -> List[torch.Tensor]:
    """Each row's bytes as big-endian 8-byte words, zero past the row's
    end: word i is ``(chunk[2i] << 32) | chunk[2i+1]`` as an int64 bit
    pattern, ceil(nchunks / 2) words. One 8-byte window gather per word
    (the reference takes the bytes one at a time)."""
    cap = col.offsets.shape[0] - 1
    dev = col.offsets.device
    starts = col.offsets[:-1].to(torch.int64)
    lens = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
    pool = torch.cat([col.chars.reshape(-1),
                      torch.zeros(8, dtype=torch.uint8, device=dev)])
    win = pool.unfold(0, 8, 1)  # win[p] = pool[p:p + 8], a view
    last = win.shape[0] - 1
    lane = torch.arange(8, dtype=torch.int64, device=dev)
    out: List[torch.Tensor] = []
    for i in range((nchunks + 1) // 2):
        b = win[(starts + 8 * i).clamp(0, last)]
        keep = lane < (lens - 8 * i).clamp(0, 8).unsqueeze(1)
        b = torch.where(keep, b, torch.zeros((), dtype=torch.uint8,
                                             device=dev))
        out.append(b.flip(1).contiguous().view(torch.int64).reshape(cap))
    return out


def _string_digits(col: StrV, order: SortOrder, max_len: int
                   ) -> List[Tuple[torch.Tensor, int, bool]]:
    """The sort digits of a string key, most significant first: its null
    rank, then its chunks two to a 64-bit digit (an odd last chunk is a
    32-bit digit). A descending key flips every chunk, padding included;
    null rows carry 0."""
    nchunks = chunk_count(max_len)
    null_rank = torch.where(
        col.validity, 1, 0 if order.nulls_first_resolved else 2)
    digits = [(null_rank.to(torch.int64), 2, True)]
    for i, w in enumerate(_chunk_pairs(col, nchunks)):
        bits = 64 if 2 * i + 1 < nchunks else 32
        if bits == 32:
            w = (w >> 32) & _M32
        if not order.ascending:
            w = _flip(w, bits)
        digits.append((torch.where(col.validity, w, 0), bits, False))
    return digits


def string_chunk_keys(col: StrV, order: SortOrder,
                      max_len: int) -> List[torch.Tensor]:
    """[null_rank, chunk0, chunk1, ...] (reference ``sort.py:118``): the
    4-byte big-endian u32 chunks of each row's bytes, zero-padded past
    its end to ``max(1, ceil(max_len / 4))`` chunks, each flipped for a
    descending key and 0 on null rows, so lexicographic order over the
    chunks is unsigned byte order (Spark's UTF8String order) with a
    shorter string first. Each chunk rides in an int64 in [0, 2^32)."""
    nchunks = chunk_count(max_len)
    digits = _string_digits(col, order, max_len)
    keys = [digits[0][0]]
    for w, bits, _ in digits[1:]:
        if bits == 64:
            keys.extend([(w >> 32) & _M32, w & _M32])
        else:
            keys.append(w)
    return keys[:1 + nchunks]


def _key_digits(colv: Val, dtype: T.DataType, order: SortOrder,
                max_len: int) -> List[Tuple[torch.Tensor, int, bool]]:
    """(key, bits, is_rank) digits of one sort key, most significant
    first."""
    if isinstance(colv, StrV):
        return _string_digits(colv, order, max_len)
    null_rank, k = fixed_radix_keys(colv, dtype, order)
    return [(null_rank, 2, True), (k, _radix_bits(dtype, colv.data), False)]


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
                orders: Sequence[SortOrder], num_rows,
                str_max_lens: Sequence[int] = ()
                ) -> Tuple[torch.Tensor, List[List[torch.Tensor]]]:
    """(permutation, each key's digit arrays in row order); padding rows
    sort last.

    The order is the reference's ``lax.sort`` over [pad_rank, per key
    its radix keys, row_id] (``sort.py:164``): (null_rank, value_key)
    for a fixed-width key, (null_rank, chunks...) for a string key, whose
    byte bound is the next of ``str_max_lens`` (each string key must
    have one). The digits pack into int64 words (:func:`_sort_words`), each
    sorted by one stable ``argsort``, least significant first, so ties
    keep row order. A word of ranks only (no value key) is skipped when
    it is the same on every row (one host sync): a stable sort by a
    constant is the identity. The pad rank is left out, with no sync,
    when the row count is a host int equal to the capacity."""
    cap = key_cols[0].validity.shape[0]
    dev = key_cols[0].validity.device
    keys: List[List[torch.Tensor]] = []
    digits: List[Tuple[torch.Tensor, int, bool]] = []
    if not (isinstance(num_rows, int) and num_rows >= cap):
        digits.append(((~live_of(num_rows, cap, dev)).to(torch.int64), 1,
                       True))
    lens = iter(str_max_lens)
    for colv, dtype, order in zip(key_cols, key_dtypes, orders):
        ml = next_bound(lens) if isinstance(colv, StrV) else 0
        kd = _key_digits(colv, dtype, order, ml)
        keys.append([d[0] for d in kd])
        digits.extend(kd)
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
                         orders: Sequence[SortOrder], num_rows,
                         str_max_lens: Sequence[int] = ()
                         ) -> Tuple[torch.Tensor, List[List[torch.Tensor]]]:
    """(permutation, per key its digit arrays in sorted order); padding
    rows sort last (reference ``sort.py:164``). Two adjacent sorted rows
    hold equal keys iff every array of the key matches, so callers find
    group and peer boundaries from them (a string key's chunks come two
    to a 64-bit array)."""
    perm, keys = _sort_order(key_cols, key_dtypes, orders, num_rows,
                             str_max_lens)
    return perm, [[k[perm] for k in ks] for ks in keys]


def sort_permutation(key_cols: Sequence[Val],
                     key_dtypes: Sequence[T.DataType],
                     orders: Sequence[SortOrder], num_rows,
                     str_max_lens: Sequence[int] = ()) -> torch.Tensor:
    """Stable sort permutation over the given keys; padding rows go last
    (reference ``sort.py:196``). The radix keys are not gathered."""
    return _sort_order(key_cols, key_dtypes, orders, num_rows,
                       str_max_lens)[0]


def sort_cols(cols: Sequence[Val], key_indices: Sequence[int],
              key_dtypes: Sequence[T.DataType],
              orders: Sequence[SortOrder], num_rows,
              str_max_lens: Sequence[int] = ()) -> List[Val]:
    """Sort all columns by the keys at ``key_indices`` (reference
    ``sort.py:210``)."""
    c0 = cols[0]
    cap = c0.validity.shape[0]
    perm = sort_permutation([cols[i] for i in key_indices], key_dtypes,
                            orders, num_rows, str_max_lens)
    # live rows sort first, so this is ``iota < num_rows`` for a count
    valid_slot = live_of(num_rows, cap, c0.validity.device)[perm]
    return gather(cols, perm, valid_slot)
