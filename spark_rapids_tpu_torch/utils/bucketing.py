"""Shape-bucketing helpers (counterpart of ``spark_rapids_tpu/utils/bucketing.py``).

Ragged batch sizes are padded up to power-of-two capacity buckets. The
port keeps one copy of that rule, ``columnar/column.py``'s
``choose_capacity``, which every batch the runtime builds applies;
:func:`bucket_rows` is that function under the reference's name, so the
static plan analyzer (``plugin/plananalysis.py``) sizes the batches it
forecasts with the runtime's own rule.
"""
from __future__ import annotations

from ..columnar.column import choose_capacity as bucket_rows  # noqa: F401
from ..columnar.column import round_up_pow2  # noqa: F401
