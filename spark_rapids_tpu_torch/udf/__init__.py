"""UDF layer of the port (reference: ``spark_rapids_tpu/udf``): the
native columnar UDF interface and its in-tree example,
``string_word_count``. The Python-bytecode UDF compiler
(``udf/compiler.py``) is not ported yet (ROADMAP.md, queue A item 'The
Python-bytecode UDF compiler'); the session raises when it would run."""
from .native import string_word_count, tpu_udf  # noqa: F401
