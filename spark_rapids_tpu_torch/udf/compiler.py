"""Python-bytecode UDF compiler: CPython bytecode -> engine expression trees.

Own copy of ``spark_rapids_tpu/udf/compiler.py`` over the port's
``expr/expressions.py``: the same opcode walk, the same ``_FUNCTIONS``
and ``_STR_METHODS`` tables and the same contract (anything outside them
raises ``UnsupportedUDF`` inside, and :func:`compile_udf` returns None:
the UDF stays a PythonUDF node and runs row by row on the CPU engine).
The walk reads the bytecode of the running interpreter (the opcode set
of CPython 3.12), so its trees equal the reference's on the same Python.

Reference analog: the udf-compiler module (udf-compiler/.../Instruction.scala
:198-934 abstract interpretation of ~200 JVM opcodes, CFG.scala:44-141 basic
blocks, CatalystExpressionBuilder/State condition propagation). ``dis``
yields the instruction stream, a symbolic stack machine abstractly
interprets it with Expression values, and conditional jumps fork the walk
with path conditions that fold back into If trees.

Semantics note (documented drift, like the reference's experimental flag):
the compiled tree uses SQL null/zero-division semantics (null propagates,
x/0 -> null) where the raw Python function would raise; `//` compiles to
floor(a/b) and `%` to Pmod, matching Python for positive divisors.
"""
from __future__ import annotations

import dis
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import types as T
from ..expr import expressions as E


class UnsupportedUDF(Exception):
    pass


# -- callable surface -------------------------------------------------------
def _unary(ctor):
    return lambda args: ctor(args[0])


_FUNCTIONS: Dict[Any, Callable] = {
    math.sqrt: _unary(E.Sqrt), math.exp: _unary(E.Exp),
    math.sin: _unary(E.Sin), math.cos: _unary(E.Cos),
    math.tan: _unary(E.Tan), math.asin: _unary(E.Asin),
    math.acos: _unary(E.Acos), math.atan: _unary(E.Atan),
    math.sinh: _unary(E.Sinh), math.cosh: _unary(E.Cosh),
    math.tanh: _unary(E.Tanh), math.expm1: _unary(E.Expm1),
    math.log10: _unary(E.Log10), math.log2: _unary(E.Log2),
    math.log1p: _unary(E.Log1p), math.fabs: _unary(E.Abs),
    math.floor: _unary(E.Floor), math.ceil: _unary(E.Ceil),
    math.degrees: _unary(E.ToDegrees), math.radians: _unary(E.ToRadians),
    math.log: _unary(E.Log),
    math.atan2: lambda a: E.Atan2(a[0], a[1]),
    math.pow: lambda a: E.Pow(a[0], a[1]),
    abs: _unary(E.Abs),
    len: _unary(E.Length),
    float: lambda a: E.Cast(a[0], T.DOUBLE),
    int: lambda a: E.Cast(a[0], T.LONG),
    str: lambda a: E.Cast(a[0], T.STRING),
    bool: lambda a: E.Cast(a[0], T.BOOLEAN),
    round: lambda a: E.Round(a[0], a[1].value if len(a) > 1 else 0),
}

_STR_METHODS: Dict[str, Callable] = {
    "upper": lambda s, a: E.Upper(s),
    "lower": lambda s, a: E.Lower(s),
    "strip": lambda s, a: E.StringTrim(s, a[0].value if a else None),
    "lstrip": lambda s, a: E.StringTrimLeft(s, a[0].value if a else None),
    "rstrip": lambda s, a: E.StringTrimRight(s, a[0].value if a else None),
    "startswith": lambda s, a: E.StartsWith(s, a[0]),
    "endswith": lambda s, a: E.EndsWith(s, a[0]),
    "replace": lambda s, a: E.StringReplace(s, a[0], a[1]),
    "title": None,  # unsupported markers fall through to UnsupportedUDF
}

_BINOPS = {
    "+": E.Add, "-": E.Subtract, "*": E.Multiply,
    "&": E.BitwiseAnd, "|": E.BitwiseOr, "^": E.BitwiseXor,
    "<<": E.ShiftLeft, ">>": E.ShiftRight,
}
_CMPS = {
    "<": E.LessThan, "<=": E.LessThanOrEqual, "==": E.EqualTo,
    ">": E.GreaterThan, ">=": E.GreaterThanOrEqual,
}


class _Method:
    """Stack marker: a method bound to an expression receiver."""

    def __init__(self, receiver: E.Expression, name: str):
        self.receiver = receiver
        self.name = name


class _Callable:
    """Stack marker: a resolved host function (math.sqrt etc.)."""

    def __init__(self, fn: Any):
        self.fn = fn


def _const_expr(v: Any) -> E.Expression:
    if v is None:
        return E.Literal(None, T.NULL)
    return E.Literal.of(v)


def _dtype_of(e: E.Expression):
    try:
        return e.dtype
    except Exception:
        return None  # unresolved column: unknown until binding


def _as_bool(e: E.Expression) -> E.Expression:
    dt = _dtype_of(e)
    if dt == T.BOOLEAN:
        return e
    if dt is None or not dt.is_numeric:
        # string/other truthiness is NOT `!= 0`; falling back beats a
        # silent miscompile
        raise UnsupportedUDF(
            "truthiness of a non-numeric value (use explicit comparisons)")
    # Python truthiness of numbers: x != 0
    return E.Not(E.EqualTo(e, E.Literal(0, T.INT)))


def _binary(op: str, l: E.Expression, r: E.Expression) -> E.Expression:
    if op in _BINOPS:
        if op == "+" and (
            isinstance(_dtype_of(l), T.StringType)
            or isinstance(_dtype_of(r), T.StringType)
        ):
            return E.Concat((l, r))
        return _BINOPS[op](l, r)
    if op == "/":
        return E.Divide(l, r)
    if op == "//":
        return E.Floor(E.Divide(l, r))  # Python floors
    if op == "%":
        return E.Pmod(l, r)  # matches Python for positive divisors
    if op == "**":
        return E.Pow(l, r)
    raise UnsupportedUDF(f"binary op {op!r}")


class _Compiler:
    """Symbolic walk of the instruction stream; conditional jumps fork the
    path (the CFG + State propagation of the reference, expressed as a
    depth-first interpretation — UDF bodies are small)."""

    MAX_STEPS = 4000

    def __init__(self, fn: Callable, args: Tuple[E.Expression, ...]):
        self.fn = fn
        code = fn.__code__
        if code.co_argcount != len(args):
            raise UnsupportedUDF("argument count mismatch")
        if code.co_flags & 0x0C:  # *args / **kwargs
            raise UnsupportedUDF("varargs not supported")
        self.instrs = list(dis.get_instructions(fn))
        self.by_offset = {i.offset: idx for idx, i in enumerate(self.instrs)}
        self.locals: Dict[str, E.Expression] = dict(
            zip(code.co_varnames, args))
        self.steps = 0
        self.returns: List[Tuple[List[E.Expression], E.Expression]] = []

    # -- global/name resolution -------------------------------------------
    def _resolve_global(self, name: str) -> Any:
        if name in self.fn.__globals__:
            return self.fn.__globals__[name]
        import builtins

        if hasattr(builtins, name):
            return getattr(builtins, name)
        raise UnsupportedUDF(f"unresolvable global {name!r}")

    def run(self) -> E.Expression:
        self._walk(0, [], dict(self.locals), [])
        if not self.returns:
            raise UnsupportedUDF("no return value")
        # fold return points (in path order) into nested CaseWhen
        conds, val = self.returns[-1]
        expr = val
        for conds, val in reversed(self.returns[:-1]):
            c = conds[0]
            for extra in conds[1:]:
                c = E.And(c, extra)
            expr = E.If(c, val, expr)
        return expr

    def _walk(self, idx: int, stack: List[Any], local: Dict[str, Any],
              conds: List[E.Expression]) -> None:
        while True:
            self.steps += 1
            if self.steps > self.MAX_STEPS:
                raise UnsupportedUDF("instruction budget exceeded (loop?)")
            ins = self.instrs[idx]
            op = ins.opname
            if op in ("RESUME", "CACHE", "PRECALL", "NOP", "PUSH_NULL",
                      "EXTENDED_ARG"):
                idx += 1
                continue
            if op in ("LOAD_FAST", "LOAD_FAST_CHECK"):
                if ins.argval not in local:
                    raise UnsupportedUDF(f"unbound local {ins.argval!r}")
                stack.append(local[ins.argval])
            elif op == "STORE_FAST":
                local[ins.argval] = stack.pop()
            elif op == "LOAD_CONST":
                v = ins.argval
                if isinstance(v, tuple):
                    stack.append(v)  # IN-list / call shape
                else:
                    stack.append(_const_expr(v))
            elif op == "RETURN_CONST":
                self.returns.append((list(conds), _const_expr(ins.argval)))
                return
            elif op == "RETURN_VALUE":
                v = stack.pop()
                if not isinstance(v, E.Expression):
                    raise UnsupportedUDF("non-expression return")
                self.returns.append((list(conds), v))
                return
            elif op == "LOAD_GLOBAL":
                stack.append(_Callable(self._resolve_global(ins.argval)))
            elif op == "LOAD_ATTR":
                recv = stack.pop()
                if isinstance(recv, _Callable):  # e.g. math.sqrt
                    stack.append(_Callable(getattr(recv.fn, ins.argval)))
                elif isinstance(recv, E.Expression):
                    stack.append(_Method(recv, ins.argval))
                else:
                    raise UnsupportedUDF(f"attr on {type(recv).__name__}")
            elif op == "BINARY_OP":
                r, l = stack.pop(), stack.pop()
                sym = ins.argrepr.rstrip("=")  # += etc. reuse the base op
                stack.append(_binary(sym, l, r))
            elif op == "COMPARE_OP":
                r, l = stack.pop(), stack.pop()
                sym = ins.argrepr
                if sym == "!=":
                    stack.append(E.Not(E.EqualTo(l, r)))
                elif sym in _CMPS:
                    stack.append(_CMPS[sym](l, r))
                else:
                    raise UnsupportedUDF(f"compare {sym!r}")
            elif op == "IS_OP":
                r, l = stack.pop(), stack.pop()
                if not (isinstance(r, E.Literal) and r.value is None):
                    raise UnsupportedUDF("`is` only supported against None")
                stack.append(
                    E.IsNotNull(l) if ins.argval == 1 else E.IsNull(l))
            elif op == "CONTAINS_OP":
                r, l = stack.pop(), stack.pop()
                if not isinstance(r, tuple):
                    raise UnsupportedUDF("`in` needs a constant tuple")
                e = E.In(l, tuple(r))
                stack.append(E.Not(e) if ins.argval == 1 else e)
            elif op == "UNARY_NEGATIVE":
                stack.append(E.UnaryMinus(stack.pop()))
            elif op == "UNARY_NOT":
                stack.append(E.Not(_as_bool(stack.pop())))
            elif op == "UNARY_INVERT":
                stack.append(E.BitwiseNot(stack.pop()))
            elif op == "POP_TOP":
                stack.pop()
            elif op == "COPY":
                stack.append(stack[-ins.argval])
            elif op == "SWAP":
                stack[-ins.argval], stack[-1] = stack[-1], stack[-ins.argval]
            elif op == "CALL":
                argc = ins.argval
                args = stack[len(stack) - argc:]
                del stack[len(stack) - argc:]
                callee = stack.pop()
                stack.append(self._call(callee, args))
            elif op == "KW_NAMES":
                raise UnsupportedUDF("keyword arguments not supported")
            elif op in ("POP_JUMP_IF_FALSE", "POP_JUMP_IF_TRUE",
                        "POP_JUMP_IF_NONE", "POP_JUMP_IF_NOT_NONE"):
                v = stack.pop()
                if op.endswith("NONE"):
                    cond = E.IsNull(v) if op.endswith("IF_NONE") else \
                        E.IsNotNull(v)
                    taken_cond, fall_cond = cond, _negate(cond)
                else:
                    b = _as_bool(v)
                    if op == "POP_JUMP_IF_TRUE":
                        taken_cond, fall_cond = b, _negate(b)
                    else:
                        taken_cond, fall_cond = _negate(b), b
                tgt = self.by_offset[ins.argval]
                # fork: taken path first, then fall-through (path order
                # keeps the nested-If fold faithful to evaluation order)
                self._walk(tgt, list(stack), dict(local),
                           conds + [taken_cond])
                conds = conds + [fall_cond]
                idx += 1
                continue
            elif op in ("JUMP_FORWARD",):
                idx = self.by_offset[ins.argval]
                continue
            elif op in ("JUMP_BACKWARD", "JUMP_BACKWARD_NO_INTERRUPT",
                        "FOR_ITER"):
                raise UnsupportedUDF("loops are not supported")
            else:
                raise UnsupportedUDF(f"opcode {op}")
            idx += 1

    def _call(self, callee: Any, args: List[Any]) -> E.Expression:
        if isinstance(callee, _Method):
            m = _STR_METHODS.get(callee.name)
            if m is None:
                raise UnsupportedUDF(f"method .{callee.name}()")
            return m(callee.receiver, args)
        if isinstance(callee, _Callable):
            ctor = _FUNCTIONS.get(callee.fn)
            if ctor is None:
                raise UnsupportedUDF(f"function {callee.fn!r}")
            return ctor(args)
        raise UnsupportedUDF("call of non-function")


def _negate(e: E.Expression) -> E.Expression:
    if isinstance(e, E.IsNull):
        return E.IsNotNull(e.child)
    if isinstance(e, E.IsNotNull):
        return E.IsNull(e.child)
    if isinstance(e, E.Not):
        return e.child
    return E.Not(e)


def compile_udf(fn: Callable,
                args: Tuple[E.Expression, ...]) -> Optional[E.Expression]:
    """fn(scalar args) -> Expression over ``args``; None = not compilable
    (the planner keeps the PythonUDF node and the operator falls back)."""
    try:
        return _Compiler(fn, tuple(args)).run()
    except UnsupportedUDF:
        return None
    except Exception:  # defensive: never break planning on weird bytecode
        return None
