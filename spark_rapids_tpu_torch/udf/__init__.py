"""UDF layer of the port (reference: ``spark_rapids_tpu/udf``): the
native columnar UDF interface and its in-tree example,
``string_word_count``. The Python-bytecode UDF compiler
(``udf/compiler.py``) comes with the session planner (ROADMAP.md, queue
A, slice 4)."""
from .native import string_word_count, tpu_udf  # noqa: F401
