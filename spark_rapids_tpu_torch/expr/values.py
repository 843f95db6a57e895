"""Value representation shared by the expression lowering and the ops.

Counterpart of ``spark_rapids_tpu/expr/values.py``: fixed-width ``ColV``,
the Arrow-layout string ``StrV`` and the dictionary-encoded string
``DictV`` (late materialization), with the helpers that move between
them.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch


class ColV(NamedTuple):
    data: torch.Tensor
    validity: torch.Tensor


class StrV(NamedTuple):
    """A string column: ``offsets`` (cap+1,) int32, ``chars`` uint8 (the
    byte pool, padded past ``offsets[cap]`` with zeros), ``validity``
    (cap,) bool."""

    offsets: torch.Tensor
    chars: torch.Tensor
    validity: torch.Tensor


class DictV:
    """A dictionary-encoded string column (reference ``values.py:25``;
    cudf's dictionary32): string kernels run once over the small
    ``dictionary`` and per-row work is an int32 gather over ``codes``.

      codes       (cap,) int32, each row's index into the dictionary; null
                  and padding slots may hold any code, so every gather
                  goes through :func:`clipped_codes`
      dictionary  a StrV of ``dict_size`` entries (its validity is all
                  true: entry-level nulls fold into row validity)
      validity    (cap,) bool, the ROW validity

    Host metadata (the reference keeps it static in the pytree aux data):

      mat_cap   a byte pool large enough to materialize every row (the
                exact byte total at the scan, bucketed; scaled by each
                growing kernel's factor). It holds under row SUBSETS
                only: an exec that repeats rows materializes first.
      max_len   a bound on one entry's byte length: the byte bound of a
                sort or rank over the column, with no host sync
      unique    distinct codes mean distinct strings (a parquet
                dictionary); value-transforming kernels clear it, since
                ``upper()`` can merge entries. Grouping uses the codes
                themselves only when it is set.
    """

    __slots__ = ("codes", "dictionary", "validity", "mat_cap", "max_len",
                 "unique")

    def __init__(self, codes: torch.Tensor, dictionary: StrV,
                 validity: torch.Tensor, mat_cap: int, max_len: int,
                 unique: bool = False):
        self.codes = codes
        self.dictionary = dictionary
        self.validity = validity
        self.mat_cap = int(mat_cap)
        self.max_len = int(max_len)
        self.unique = bool(unique)

    @property
    def dict_size(self) -> int:
        """Entries in the dictionary."""
        return int(self.dictionary.offsets.shape[0]) - 1

    def __repr__(self):
        return (f"DictV(dict_size={self.dict_size}, mat_cap={self.mat_cap}, "
                f"max_len={self.max_len}, unique={self.unique})")


Val = Union[ColV, StrV, DictV]


def val_capacity(v: Val) -> int:
    """Row capacity of any column value."""
    if isinstance(v, StrV):
        return int(v.offsets.shape[0]) - 1
    return int(v.validity.shape[0])


def clipped_codes(v: DictV) -> torch.Tensor:
    """Codes clipped into the dictionary's range, as int64 gather
    indices (null and padding slots may hold any code; validity masks
    them downstream)."""
    return v.codes.long().clamp(0, max(v.dict_size - 1, 0))


def dict_gather_col(v: DictV, dict_col: ColV) -> ColV:
    """A dictionary-level ColV (one row per entry) as a per-row ColV:
    one gather through the codes."""
    idx = clipped_codes(v)
    data = dict_col.data[idx]
    valid = v.validity & dict_col.validity[idx]
    return ColV(torch.where(valid, data, torch.zeros_like(data)), valid)


def dict_rewrap(v: DictV, out_dict: StrV, mat_growth: int = 1,
                unique: bool = False) -> DictV:
    """Wrap a string kernel's output over ``v.dictionary`` back into a
    DictV (reference ``values.py:113``). Entry-level nulls fold into the
    row validity, so ``DictV.validity`` stays the row validity
    downstream; ``mat_growth`` is the kernel's worst byte growth (1 for
    case mapping, substring and trims). ``unique`` is cleared by
    default: a transformed dictionary may hold equal entries."""
    from ..columnar.column import choose_capacity

    validity = v.validity & out_dict.validity[clipped_codes(v)]
    ones = torch.ones(v.dict_size, dtype=torch.bool,
                      device=v.validity.device)
    mat_cap = (v.mat_cap if mat_growth == 1
               else choose_capacity(max(1, v.mat_cap * mat_growth), 128))
    return DictV(v.codes, StrV(out_dict.offsets, out_dict.chars, ones),
                 validity, mat_cap, v.max_len * mat_growth, unique)


def materialize_dict(v: DictV) -> StrV:
    """A DictV expanded to the plain StrV layout: one string gather of
    the dictionary's entries into a pool of ``mat_cap`` bytes (the
    escape hatch of every consumer without a dictionary path)."""
    from ..ops.filter_gather import gather_string

    d = v.dictionary
    ones = torch.ones(v.dict_size, dtype=torch.bool, device=d.offsets.device)
    return gather_string(StrV(d.offsets, d.chars, ones), clipped_codes(v),
                         v.validity, v.mat_cap)


def as_plain_str(v):
    """The StrV of any string value (a StrV as it is)."""
    return materialize_dict(v) if isinstance(v, DictV) else v


class UnsupportedExpressionError(Exception):
    """Raised while lowering an expression the engine cannot run."""
