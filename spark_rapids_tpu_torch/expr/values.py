"""Value representation shared by the expression lowering and the ops.

Counterpart of ``spark_rapids_tpu/expr/values.py``: fixed-width ``ColV``
and the Arrow-layout string ``StrV``. Dictionary-encoded values
(``DictV``, late materialization) are not ported yet (ROADMAP.md, queue
A item 'Dictionary-encoded string columns').
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


Val = Union[ColV, StrV]


class UnsupportedExpressionError(Exception):
    """Raised while lowering an expression the engine cannot run."""
