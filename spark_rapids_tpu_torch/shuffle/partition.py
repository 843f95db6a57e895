"""Partitionings and the device partition step.

Counterpart of ``spark_rapids_tpu/shuffle/partition.py``: single,
round-robin, Spark-exact murmur3 hash and sampled range partitioning,
each giving an int32 partition id per row, and :func:`partition_cols`,
which stable-sorts a batch's rows by (padding, partition id) and returns
the per-partition offsets. The reference computes all of it outside any
Pallas kernel, so the port runs it on torch ops: the hash, one stable
``argsort`` (:func:`partition_order`), the row gather and a ``bincount``
for the offsets.

A range partitioning compares each row's radix words (``ops/sort``) with
the bounds' words lexicographically. torch compares int64 as signed, so
a 64-bit radix word (an int64 or double key, whose bit pattern is the
reference's uint64 key) is compared through ``^ SIGN64``; every other
word lies in [0, 2^32) and compares as it is.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..expr.values import ColV, StrV, Val
from ..ops import hashing
from ..ops.filter_gather import gather, live_of
from ..ops.sort import SIGN64, SortOrder, fixed_radix_keys, string_chunk_keys


class Partitioning:
    """Base partitioning contract (reference ``partition.py:32``)."""

    #: key-based partitionings define num_partitions and key_indices
    #: (column ordinals); callers read key_indices via getattr
    num_partitions: int

    def partition_ids(self, cols: Sequence[Val], schema: T.StructType,
                      live: torch.Tensor, map_index: int,
                      str_max_lens: Sequence[int] = ()) -> torch.Tensor:
        """(cap,) int32 partition id per row (any value for dead rows).
        ``str_max_lens``: the byte bound of each string key in turn, so
        that long strings hash and compare over all their bytes."""
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


def count_bounds_le(row_words: Sequence[torch.Tensor],
                    bound_words: Sequence[torch.Tensor],
                    n_bounds: int) -> torch.Tensor:
    """Per row, how many bounds compare <= it lexicographically over
    parallel words (reference ``partition.py:54``): its range partition
    id. Words must compare as signed int64 (see the module doc)."""
    cap = row_words[0].shape[0]
    dev = row_words[0].device
    pid = torch.zeros(cap, dtype=torch.int32, device=dev)
    for b in range(n_bounds):
        le = torch.ones(cap, dtype=torch.bool, device=dev)
        lt = torch.zeros(cap, dtype=torch.bool, device=dev)
        for rw, bw in zip(row_words, bound_words):
            bv = bw[b]
            lt = lt | (le & (bv < rw))
            le = le & (bv == rw)
        pid = pid + (lt | le).to(torch.int32)
    return pid


@dataclasses.dataclass
class SinglePartitioning(Partitioning):
    """Everything to partition 0 (reference: GpuSinglePartitioning)."""

    num_partitions: int = 1

    def partition_ids(self, cols, schema, live, map_index, str_max_lens=()):
        return torch.zeros(live.shape[0], dtype=torch.int32,
                           device=live.device)

    def describe(self):
        return "SinglePartitioning"


@dataclasses.dataclass
class RoundRobinPartitioning(Partitioning):
    """Row-cyclic distribution starting at the map partition index, so
    results are deterministic (reference ``partition.py:86``)."""

    num_partitions: int

    def partition_ids(self, cols, schema, live, map_index, str_max_lens=()):
        idx = torch.arange(live.shape[0], dtype=torch.int64,
                           device=live.device)
        return ((idx + map_index) % self.num_partitions).to(torch.int32)

    def describe(self):
        return f"RoundRobinPartitioning({self.num_partitions})"


@dataclasses.dataclass
class HashPartitioning(Partitioning):
    """Spark-bit-exact ``pmod(murmur3(keys), n)`` (reference
    ``partition.py:104``). ``key_indices`` index the batch columns; a
    string key hashes over all its bytes (its bound from the exchange)."""

    key_indices: List[int]
    num_partitions: int

    def partition_ids(self, cols, schema, live, map_index, str_max_lens=()):
        key_cols = [cols[i] for i in self.key_indices]
        key_dts = [schema.fields[i].dataType for i in self.key_indices]
        h = hashing.murmur3(key_cols, key_dts, str_max_lens=str_max_lens)
        return hashing.partition_ids(h, self.num_partitions)

    def describe(self):
        return (f"HashPartitioning(keys={self.key_indices}, "
                f"n={self.num_partitions})")


def _wide(dt: T.DataType, data: torch.Tensor) -> bool:
    """True when the value word of a fixed key is a 64-bit radix."""
    return not isinstance(dt, T.BooleanType) and data.element_size() == 8


def _signed_words(words: List[torch.Tensor], wide: bool
                  ) -> List[torch.Tensor]:
    """[null_rank, value] with a 64-bit value word made signed-ordered."""
    if wide:
        return [words[0], words[1] ^ SIGN64]
    return words


def range_key_words(key_cols: Sequence[Val],
                    key_dtypes: Sequence[T.DataType],
                    orders: Sequence[SortOrder],
                    str_max_lens: Sequence[int] = ()) -> List[torch.Tensor]:
    """Each row's words for a range comparison, most significant first
    and signed-ordered (:func:`count_bounds_le`): per key its null rank
    and value word, or a string key's null rank and chunks under its
    byte bound (the next of ``str_max_lens``; 64 when there is none)."""
    words: List[torch.Tensor] = []
    lens = iter(str_max_lens)
    for colv, dt, order in zip(key_cols, key_dtypes, orders):
        if isinstance(colv, StrV):
            words.extend(string_chunk_keys(colv, order, next(lens, 64)))
        else:
            words.extend(_signed_words(fixed_radix_keys(colv, dt, order),
                                       _wide(dt, colv.data)))
    return words


@dataclasses.dataclass
class RangePartitioning(Partitioning):
    """Ordered partitioning against sampled bounds (reference
    ``partition.py:125``): the exchange samples the bounds on the host
    and hands them in as per-key value lists; rows compare against each
    bound with Spark's full ordering (nulls, NaN, -0.0) through the sort's
    radix words."""

    key_indices: List[int]
    orders: List[SortOrder]
    num_partitions: int
    #: per key: num_partitions - 1 bound values (host, possibly None)
    bounds: Optional[List[List[object]]] = None

    def partition_ids(self, cols, schema, live, map_index, str_max_lens=()):
        assert self.bounds is not None, "bounds must be sampled before use"
        nb = self.num_partitions - 1
        if nb <= 0:
            return torch.zeros(live.shape[0], dtype=torch.int32,
                               device=live.device)
        dev = live.device
        key_cols = [cols[i] for i in self.key_indices]
        key_dts = [schema.fields[i].dataType for i in self.key_indices]
        row_keys = range_key_words(key_cols, key_dts, self.orders,
                                   str_max_lens)
        bound_keys: List[torch.Tensor] = []
        lens = iter(str_max_lens)
        for colv, dt, order, bvals in zip(key_cols, key_dts, self.orders,
                                          self.bounds):
            if isinstance(colv, StrV):
                bound_keys.extend(_string_bound_keys(
                    bvals, order, next(lens, 64), dev))
            else:
                bound_keys.extend(_signed_words(
                    _fixed_bound_keys(bvals, dt, order, dev),
                    _wide(dt, colv.data)))
        # row r belongs to partition j iff bounds[j-1] <= r < bounds[j]
        return count_bounds_le(row_keys, bound_keys, nb)

    def describe(self):
        return (f"RangePartitioning(keys={self.key_indices}, "
                f"n={self.num_partitions})")


def _fixed_bound_keys(bvals: Sequence[object], dt: T.DataType,
                      order: SortOrder, device) -> List[torch.Tensor]:
    """Radix-encode host bound values as the rows are (reference
    ``partition.py:185``). The bounds are the sample's Python values, a
    ``Decimal`` for a decimal key: they take its unscaled int64, as the
    column holds it."""
    from ..columnar.column import HostColumn

    host = HostColumn.from_pylist(list(bvals), dt)
    col = ColV(torch.tensor(host.data, device=device),
               torch.tensor(host.validity, device=device))
    return fixed_radix_keys(col, dt, order)


def _string_bound_keys(bvals: Sequence[object], order: SortOrder,
                       max_len: int, device) -> List[torch.Tensor]:
    """The chunk words of host string bounds (reference
    ``partition.py:203``)."""
    nb = len(bvals)
    bufs = [(v.encode("utf-8") if isinstance(v, str) else (v or b""))
            for v in bvals]
    offsets = np.zeros(nb + 1, np.int32)
    for i, b in enumerate(bufs):
        offsets[i + 1] = offsets[i] + len(b)
    chars = np.frombuffer(b"".join(bufs) or b"\0", np.uint8).copy()
    valid = np.array([v is not None for v in bvals], bool)
    col = StrV(torch.tensor(offsets, device=device),
               torch.tensor(chars, device=device),
               torch.tensor(valid, device=device))
    return string_chunk_keys(col, order, max_len)


def partition_order(pids: torch.Tensor, num_rows, num_partitions: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(word, perm, counts): each row's partition id with padding rows at
    P (``word``), the stable order of the rows by it, and the live rows
    of each partition (P,). One stable ``argsort`` of ``word`` is the
    reference's sort by (padding, partition id), so rows keep their
    order within a partition."""
    cap = pids.shape[0]
    live = live_of(num_rows, cap, pids.device)
    word = torch.where(live, pids.to(torch.int64), num_partitions)
    mask = isinstance(num_rows, torch.Tensor) and num_rows.dim() == 1
    if num_partitions == 1 and not mask:
        # one partition over a live prefix: the stable order is the
        # identity
        perm = torch.arange(cap, dtype=torch.int64, device=pids.device)
    else:
        perm = torch.argsort(word, stable=True)
    counts = torch.bincount(word, minlength=num_partitions + 1)
    return word, perm, counts[:num_partitions]


def partition_cols(cols: Sequence[Val], pids: torch.Tensor, num_rows,
                   num_partitions: int
                   ) -> Tuple[List[Val], torch.Tensor]:
    """Stable-sort rows by (padding, partition id); return (sorted cols,
    offsets) (reference ``partition.py:227``). ``offsets`` is (P+1,)
    int32: partition j holds sorted rows [offsets[j], offsets[j+1]) and
    offsets[P] is the live row count; padding rows sort last."""
    _, perm, counts = partition_order(pids, num_rows, num_partitions)
    live = live_of(num_rows, pids.shape[0], pids.device)
    out_cols = gather(cols, perm, live[perm])
    offsets = torch.zeros(num_partitions + 1, dtype=torch.int32,
                          device=pids.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return out_cols, offsets
