"""Native (columnar) UDF interface + the in-tree example.

Counterpart of ``spark_rapids_tpu/udf/native.py`` (reference analog:
``RapidsUDF.java:22`` — a UDF class implements ``evaluateColumnar`` and
the plugin runs that instead of row-by-row code). The user registers a
COLUMNAR function over the engine's column values (``ColV`` fixed width,
``StrV`` Arrow offsets + bytes), plus the ordinary row function for the
CPU fallback; the columnar function runs inside the projection. A
dictionary-encoded input reaches it materialized as a ``StrV``
(``expr/eval.py``): the reference hands the ``DictV`` itself, and its
word count asserts on one (ROADMAP.md §C).

In-tree example: :func:`string_word_count`, the UDF the reference ships
(``string_word_count.cu``): the reference's per-byte Pallas pass and its
ragged row reduction are one hand-written kernel, K5
(``ops/udf_kernels.word_counts``).
"""
from __future__ import annotations

import re
from typing import Callable, Optional

from .. import types as T
from ..expr import expressions as E
from ..expr.values import ColV, StrV
from ..ops import udf_kernels


def tpu_udf(columnar_fn: Callable, row_fn: Callable,
            return_type: T.DataType):
    """Register a native UDF: ``columnar_fn(cap, *vals) -> Val`` runs in
    the engine's projection (vals are ColV/StrV); ``row_fn(*args)`` is the
    row function. Returns a builder: ``wc = tpu_udf(...); wc(col("s"))``."""

    def apply(*args: E.Expression) -> E.Expression:
        return E.NativeUDF(columnar_fn, row_fn, tuple(args), return_type)

    apply.columnar_fn = columnar_fn
    apply.row_fn = row_fn
    return apply


# ---------------------------------------------------------------------------
# in-tree example: string word count (reference: string_word_count.cu)
# ---------------------------------------------------------------------------
def _word_count_columnar(cap: int, s) -> ColV:
    """Word count per row: one K5 launch from the chars pool to the
    per-row counts (``ops/udf_kernels.word_counts``)."""
    assert isinstance(s, StrV), "string_word_count takes a string column"
    return ColV(udf_kernels.word_counts(s.offsets, s.chars), s.validity)


def _word_count_row(s: Optional[str]) -> Optional[int]:
    if s is None:
        return None
    # ASCII whitespace only, as the kernel: str.split() would also split
    # on Unicode spaces
    return sum(1 for w in re.split("[ \t\n\x0b\x0c\r]+", s) if w)


#: the in-tree native UDF: ``string_word_count(col("s"))`` in any
#: projection
string_word_count = tpu_udf(_word_count_columnar, _word_count_row, T.INT)
