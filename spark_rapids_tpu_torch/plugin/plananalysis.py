"""Static plan analysis: the one part the port's pipelines consume.

Counterpart of ``entry_nonnull_flags`` of
``spark_rapids_tpu/plugin/plananalysis.py`` (reference ``:263``). It rests
on the batch invariant (``columnar/column.py``): padding slots always
hold validity False and a declared non-null column's live rows are all
valid, so its validity IS the liveness mask, bit for bit
(``ops/filter_gather.elide_validity``). The rest of the reference's
analyzer (the nullability lattice over expressions, the layout and
compile-cache forecasts, the ``fusedPlan``/``stageFusion`` lines of its
report, ``plananalysis.py:1020-1042``) is not ported (ROADMAP.md item 26).
"""
from __future__ import annotations

from ..conf import ANALYSIS_NULL_ELISION, RapidsConf
from ..types import StructType


def entry_nonnull_flags(schema: StructType, conf: RapidsConf) -> tuple:
    """Per-column elision flags for a batch of ``schema`` entering a fused
    pipeline; () when elision is disabled or no column is non-null (the
    mask-carrying path)."""
    if not conf.get(ANALYSIS_NULL_ELISION):
        return ()
    flags = tuple(not f.nullable for f in schema.fields)
    return flags if any(flags) else ()
