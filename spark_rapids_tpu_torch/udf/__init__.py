"""UDF layer of the port (reference: ``spark_rapids_tpu/udf``): the
Python-bytecode UDF compiler (``udf``, ``try_compile``, ``compile_udf``)
and the native columnar UDF interface with its in-tree example,
``string_word_count``."""
from typing import Callable, Optional

from .. import types as T
from ..expr import expressions as E
from .compiler import compile_udf
from .native import string_word_count, tpu_udf  # noqa: F401


def udf(fn: Callable, return_type: Optional[T.DataType] = None):
    """Wrap a Python function as a SQL UDF: ``udf(f)(col("a"), lit(2))``.

    With spark.rapids.tpu.sql.udfCompiler.enabled the planner compiles the
    bytecode into the engine's expression tree; otherwise the PythonUDF
    node evaluates row by row on the CPU engine."""

    def apply(*args: E.Expression) -> E.Expression:
        return E.PythonUDF(fn, tuple(args), return_type)

    apply.fn = fn
    return apply


def try_compile(node: "E.PythonUDF") -> Optional[E.Expression]:
    """PythonUDF -> engine expression tree, or None when not compilable."""
    return compile_udf(node.func, node.children_)


__all__ = ["udf", "try_compile", "compile_udf", "tpu_udf",
           "string_word_count"]
