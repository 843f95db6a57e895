"""The CPU engine: row-at-a-time fallback and differential oracle
(own copy of ``spark_rapids_tpu/cpu``)."""
from .interpreter import eval_expression_rows  # noqa: F401
