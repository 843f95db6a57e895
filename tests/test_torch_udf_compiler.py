"""The port's Python-bytecode UDF compiler (``udf/compiler.py``) against
the reference's, on the CPU.

The compiled trees must equal the reference's ``compile_udf`` trees
(same ``repr``: the same node classes, fields and literals) for the
reference's cases (``tests/test_udf.py``) and a few more; the
uncompilable ones must give None in both. Through the session, a
compilable UDF under ``spark.rapids.tpu.sql.udfCompiler.enabled`` plans
onto the device with the reference's ``explain()`` lines and gives the
reference's rows (and the raw Python function's); an uncompilable one
falls back with the reference's reason.
"""
import math

import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu.udf import compile_udf as j_compile
from spark_rapids_tpu.udf import udf as j_udf
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession
from spark_rapids_tpu_torch.udf import compile_udf, udf
from test_torch_plananalysis import comparable_explain

ON = {"spark.rapids.tpu.sql.udfCompiler.enabled": True}
REF = dict(T=JT, E=JE, udf=j_udf)
PORT = dict(T=T, E=E, udf=udf)


def f_arith(x, y):
    return (x + y) * 2 - x


def f_cond(x):
    return x * 2 if x > 0 else -x


def f_hypot(x, y):
    return math.sqrt(x * x + y * y)


def f_strings(s):
    return s.upper().strip()


def f_loop(x):
    t = 0
    for _ in range(3):
        t += x
    return t


def f_open(x):
    return open("f")  # noqa: SIM115


def f_bucket(x: int) -> int:
    if x is None:
        return -1
    return x // 10 if x >= 0 else -(-x // 10)


def f_tag(s: str) -> str:
    return ("BIG_" + s.upper()) if len(s) > 3 else s.lower()


def f_cos_sim(dot: float, na: float, nb: float) -> float:
    d = math.sqrt(na) * math.sqrt(nb)
    return dot / d if d != 0 else 0.0


def f_q16(v: int) -> int:
    return v * 3 + 1 if v > 100 else -v


def f_membership(x):
    return x in (1, 3, 5) and not x is None  # noqa: E714


def f_shout(s: str) -> str:
    return "BIG_" + s.upper().strip()


def f_len(s: str) -> int:
    return len(s) * 2 + 1


def f_replace(s):
    return s.replace("a", "b")


def f_kwargs(x):
    return round(x, ndigits=2)


def f_bits(x, y):
    return (x & 7) | (y << 2) ^ ~x


#: name -> (function, argument column names)
FUNCS = {
    "arith": (f_arith, "ab"), "conditional": (f_cond, "a"),
    "hypot": (f_hypot, "ab"), "string_methods": (f_strings, "s"),
    "loop": (f_loop, "a"), "unknown_call": (f_open, "a"),
    "varargs": (lambda *a: a[0], "a"), "is_none_floor_div": (f_bucket, "a"),
    "string_concat_len": (f_tag, "s"), "cos_sim": (f_cos_sim, "bbb"),
    "q16_branch": (f_q16, "a"), "membership": (f_membership, "a"),
    "replace": (f_replace, "s"), "kwargs": (f_kwargs, "b"),
    "bitwise": (f_bits, "aa"), "shout": (f_shout, "s"),
    "length": (f_len, "s"),
}
UNCOMPILABLE = {"loop", "unknown_call", "varargs", "kwargs"}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_compiled_tree_equals_reference(name):
    fn, args = FUNCS[name]
    ref = j_compile(fn, tuple(JE.col(a) for a in args))
    got = compile_udf(fn, tuple(E.col(a) for a in args))
    assert (got is None) == (name in UNCOMPILABLE) == (ref is None)
    assert repr(got) == repr(ref)


def _schema(m):
    T_ = m["T"]
    return T_.StructType((T_.StructField("a", T_.LONG),
                          T_.StructField("b", T_.DOUBLE),
                          T_.StructField("s", T_.STRING)))


def _data(n=200):
    return {
        "a": [i * 3 - 100 if i % 7 else None for i in range(n)],
        "b": [i / 3.0 if i % 5 else None for i in range(n)],
        "s": [f"w{i % 9}x" if i % 11 else None for i in range(n)],
    }


def _guarded(m, sess, guard_cols):
    E_ = m["E"]
    df = sess.create_dataframe(_data(), _schema(m))
    for c in guard_cols:
        df = df.where(E_.IsNotNull(E_.col(c)))
    return df


#: name -> (function, args, guard columns: raw Python takes no None)
SESSION = {
    "hypot": (f_hypot, "ab", "ab"),
    "cos_sim": (f_cos_sim, "bbb", "b"),
    "is_none_floor_div": (f_bucket, "a", ""),
    "string_concat": (f_shout, "s", "s"),
    "string_length": (f_len, "s", "s"),
    "q16_branch": (f_q16, "a", "a"),
    "loop_falls_back": (f_loop, "a", "a"),
}


def _query(m, sess, name):
    fn, args, guard = SESSION[name]
    E_ = m["E"]
    u = m["udf"](fn)
    return _guarded(m, sess, guard).select(
        E_.col("a"), E_.Alias(u(*[E_.col(c) for c in args]), "r"))


def _norm(rows):
    return [tuple(round(v, 9) if isinstance(v, float) else v for v in r)
            for r in rows]


@pytest.mark.parametrize("name", sorted(SESSION))
def test_session_rows_and_explain_match_reference(name):
    jdf = _query(REF, JSession(ON), name)
    ref = jdf.collect()
    sess = PSession(ON, device="cpu")
    df = _query(PORT, sess, name)
    assert comparable_explain(df.explain()) == comparable_explain(
        jdf.explain())
    got = df.collect()
    assert _norm(got) == _norm(ref)
    tree = sess.last_executed_plan.tree_string()
    assert ("CpuProjectExec" in tree) == (name == "loop_falls_back")
    # the raw Python function, row by row, on the guarded rows
    fn, args, _ = SESSION[name]
    cols = _schema(PORT).names
    want = [(r[0], fn(*[r[cols.index(c)] for c in args]))
            for r in zip(*[_data()[c] for c in cols])
            if all(r[cols.index(c)] is not None for c in SESSION[name][2])]
    assert _norm(got) == _norm(want)


@pytest.mark.parametrize("fn", [f_replace, f_tag], ids=["replace",
                                                      "string_if"])
def test_unported_string_expression_raises_naming_its_item(fn):
    """``.replace`` compiles to StringReplace, and ``f_tag`` to an If that
    selects strings. Both raised, naming ROADMAP.md item 15, until it was
    ported; now the compiled trees run on the device and give the
    reference's rows and the Python function's."""
    def query(m, sess):
        u = m["udf"](fn)
        return _guarded(m, sess, "s").select(
            m["E"].Alias(u(m["E"].col("s")), "r"))

    ref = query(REF, JSession(ON)).collect()
    sess = PSession(ON, device="cpu")
    got = query(PORT, sess).collect()
    assert got == ref
    assert "CpuProjectExec" not in sess.last_executed_plan.tree_string()
    want = [(fn(s),) for s in _data()["s"] if s is not None]
    assert got == want
