"""TpuSession + DataFrame: the Catalyst stand-in of the port.

Own copy of ``spark_rapids_tpu/sql/session.py``'s planning core: a
DataFrame is an immutable logical node tree; ``collect()`` lowers it to a
CPU physical plan (``cpu/plan.py``, what Spark would hand us), runs the
override pass (``plugin/overrides.py``) and executes the result behind a
``ColumnarToRowExec``. ``last_executed_plan``, ``last_explain`` and
``explain_metrics()`` expose what happened, for the differential tests.
A plan over several partitions (``from_rows(..., num_partitions=n)``, a
parquet directory of several files) runs through the exchanges
(``exec/exchange.py``).

Device rule: ``TpuSession(settings, device=None)`` runs on the CUDA card,
and raises without one unless the caller passes ``device="cpu"``.

Left out, as later ROADMAP.md items: plan analysis (so ``explain()``
returns the tagging lines only), the event log, the observability plane,
serving and the XLA cost and HLO planes, and ``DataFrameWriter`` and the
CSV and ORC readers ('The remaining modules'); their conf keys are not
registered. With ``spark.rapids.tpu.sql.udfCompiler.enabled`` on, each
``PythonUDF`` is compiled to engine expressions where its bytecode allows
(``udf/compiler.py``); an uncompilable one, and every one with the conf
off (the default), falls back to the CPU engine, as in the reference.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..columnar import resolve_device
from ..conf import RapidsConf
from ..cpu import plan as C
from ..exec.transitions import ColumnarToRowExec
from ..expr import aggregates as A
from ..expr import expressions as E
from ..plugin.overrides import TpuOverrides, not_ported as _not_ported
from ..types import StructType

REMAINING_ITEM = "The remaining modules"


@dataclasses.dataclass(frozen=True)
class LNode:
    """Logical node; lowered 1:1 to a CPU physical exec."""

    kind: str
    args: tuple  # hashable payload
    children: Tuple["LNode", ...] = ()


_SCANNER_CACHE: Dict[tuple, Any] = {}
_SCANNER_CACHE_LOCK = threading.Lock()


def _make_scanner(fmt: str, path: str, opts: tuple, conf: RapidsConf,
                  pushed: tuple = ()):
    """Build (and cache) a file scanner; the cache avoids re-parsing
    footers on every schema access. The key holds the conf values
    planning depends on (an ``id(conf)`` could be reused after GC and
    serve a scanner planned under other settings); the lock keeps two
    threads planning at once from building one scanner twice."""
    from ..conf import (
        CLOUD_SCHEMES,
        MAX_READER_BATCH_SIZE_BYTES,
        PARQUET_DEVICE_DECODE,
        PARQUET_DICT_STRINGS,
        PARQUET_PIPELINE_MAX_IN_FLIGHT,
        PARQUET_READER_TYPE,
        SCAN_DEVICE_CACHE,
        SCAN_DEVICE_CACHE_MAX_BYTES,
    )

    # the reference keys on the planning confs only; the scanner also
    # reads the decode confs when it runs (a dictStrings-on scanner hands
    # out dictionary-encoded columns where an off one expands them), so a
    # later session must not inherit an earlier session's scanner
    # through them
    key = (fmt, path, opts, pushed, conf.get(PARQUET_READER_TYPE),
           conf.get(MAX_READER_BATCH_SIZE_BYTES), conf.get(CLOUD_SCHEMES),
           conf.get(PARQUET_DEVICE_DECODE), conf.get(PARQUET_DICT_STRINGS),
           conf.get(PARQUET_PIPELINE_MAX_IN_FLIGHT),
           conf.get(SCAN_DEVICE_CACHE), conf.get(SCAN_DEVICE_CACHE_MAX_BYTES))
    sc = _SCANNER_CACHE.get(key)
    if sc is not None:
        return sc
    with _SCANNER_CACHE_LOCK:
        sc = _SCANNER_CACHE.get(key)
        if sc is not None:
            return sc
        od = dict(opts)
        if fmt == "parquet":
            from ..io.parquet import ParquetScanner

            sc = ParquetScanner(
                path, conf, columns=od.get("columns"),
                filters=list(pushed))
        elif fmt in ("csv", "orc"):
            raise _not_ported(f"the {fmt} scan", REMAINING_ITEM)
        else:
            raise ValueError(f"unknown file format {fmt}")
        if len(_SCANNER_CACHE) > 256:
            _SCANNER_CACHE.clear()
        _SCANNER_CACHE[key] = sc
    return sc


def _extract_pushed_filters(cond: E.Expression) -> tuple:
    """col-vs-literal conjuncts for row-group pruning (reference: the
    parquet pushdown assembled in GpuParquetScan's filterBlocks). Unknown
    shapes are simply not pushed — pruning is advisory, the filter exec
    still runs."""
    from ..io.parquet import PushedFilter

    out: List[PushedFilter] = []

    def visit(e: E.Expression):
        if isinstance(e, E.And):
            visit(e.left)
            visit(e.right)
            return
        ops = {
            E.EqualTo: "=", E.LessThan: "<", E.LessThanOrEqual: "<=",
            E.GreaterThan: ">", E.GreaterThanOrEqual: ">=",
        }
        t = type(e)
        if t in ops:
            l, r = e.left, e.right
            if isinstance(l, E.UnresolvedAttribute) and isinstance(r, E.Literal):
                out.append(PushedFilter(l.name, ops[t], r.value))
            elif isinstance(r, E.UnresolvedAttribute) and isinstance(l, E.Literal):
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
                out.append(PushedFilter(r.name, flip[ops[t]], l.value))
        elif isinstance(e, E.IsNull) and isinstance(
                e.child, E.UnresolvedAttribute):
            out.append(PushedFilter(e.child.name, "isnull"))
        elif isinstance(e, E.IsNotNull) and isinstance(
                e.child, E.UnresolvedAttribute):
            out.append(PushedFilter(e.child.name, "notnull"))

    visit(cond)
    return tuple(out)


def _resolve_udfs(e: E.Expression, conf: RapidsConf) -> E.Expression:
    """Resolution pass (reference ``session.py:135-155``): PythonUDF ->
    bytecode-compiled expression tree when
    spark.rapids.tpu.sql.udfCompiler.enabled. Uncompilable UDFs stay
    PythonUDF nodes and run row by row on the CPU engine."""
    from ..conf import UDF_COMPILER_ENABLED

    if not conf.get(UDF_COMPILER_ENABLED):
        return e

    def rw(node):
        if isinstance(node, E.PythonUDF):
            from ..udf import try_compile

            compiled = try_compile(node)
            if compiled is not None:
                return compiled
        return node

    return e.transform(rw)


def _lower(node: LNode, conf: RapidsConf) -> C.CpuExec:
    k = node.kind
    rx = lambda ex: _resolve_udfs(ex, conf)  # noqa: E731
    if k == "filter" and node.children[0].kind == "file_scan":
        # push col-vs-literal conjuncts into the scan for row-group pruning
        (cond,) = node.args
        cond = rx(cond)
        fmt, path, opts = node.children[0].args
        pushed = (
            _extract_pushed_filters(cond) if fmt in ("parquet", "orc") else ())
        sc = _make_scanner(fmt, path, opts, conf, pushed)
        return C.CpuFilterExec(conf, cond, C.CpuFileScanExec(conf, sc, fmt))
    kids = [_lower(c, conf) for c in node.children]
    if k == "file_scan":
        fmt, path, opts = node.args
        return C.CpuFileScanExec(
            conf, _make_scanner(fmt, path, opts, conf), fmt)
    if k == "scan":
        rows, schema, nparts = node.args
        per = (len(rows) + nparts - 1) // nparts if rows else 0
        parts = [
            list(rows[i * per: (i + 1) * per]) if per else []
            for i in range(nparts)
        ] if nparts > 1 else [list(rows)]
        return C.CpuScanExec(conf, parts, schema)
    if k == "range":
        start, end, step, slices, name = node.args
        return C.CpuRangeExec(conf, start, end, step, slices, name)
    if k == "project":
        (exprs,) = node.args
        return C.CpuProjectExec(conf, [rx(e) for e in exprs], kids[0])
    if k == "filter":
        (cond,) = node.args
        return C.CpuFilterExec(conf, rx(cond), kids[0])
    if k == "aggregate":
        keys, aggs = node.args
        return C.CpuHashAggregateExec(
            conf, [rx(e) for e in keys], [rx(a) for a in aggs], kids[0])
    if k == "sort":
        exprs, orders = node.args
        return C.CpuSortExec(
            conf, [rx(e) for e in exprs], list(orders), kids[0])
    if k == "limit":
        (n,) = node.args
        return C.CpuLocalLimitExec(conf, n, kids[0])
    if k == "collect_limit":
        (n,) = node.args
        return C.CpuCollectLimitExec(conf, n, kids[0])
    if k == "generate":
        gens, name, with_pos = node.args
        return C.CpuGenerateExec(
            conf, [rx(g) for g in gens], name, with_pos, kids[0])
    if k == "union":
        return C.CpuUnionExec(conf, kids)
    if k == "expand":
        projections, names = node.args
        return C.CpuExpandExec(conf, [list(p) for p in projections], list(names), kids[0])
    if k == "join":
        lkeys, rkeys, how, cond = node.args
        return C.CpuJoinExec(conf, kids[0], kids[1], list(lkeys), list(rkeys), how, cond)
    if k == "window":
        (wexprs,) = node.args
        return C.CpuWindowExec(conf, list(wexprs), kids[0])
    raise ValueError(f"unknown logical node {k}")


def _as_expr(e: Union[str, E.Expression]) -> E.Expression:
    return E.col(e) if isinstance(e, str) else e


class TpuSession:
    """reference analog: SparkSession with the plugin installed."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None,
                 device=None):
        self.conf = RapidsConf(settings)
        self.device = resolve_device(device)
        self.overrides = TpuOverrides(self.conf, self.device)
        self.last_executed_plan = None
        self.last_cpu_plan = None

    @property
    def last_explain(self) -> str:
        return self.overrides.last_explain

    def create_dataframe(
        self, data: Dict[str, Sequence[Any]], schema: StructType,
        num_partitions: int = 1,
    ) -> "DataFrame":
        names = schema.names
        n = len(data[names[0]]) if names else 0
        rows = tuple(
            tuple(data[name][i] for name in names) for i in range(n)
        )
        return DataFrame(self, LNode("scan", (rows, schema, num_partitions)))

    def from_rows(self, rows: Sequence[tuple], schema: StructType,
                  num_partitions: int = 1) -> "DataFrame":
        return DataFrame(
            self, LNode("scan", (tuple(tuple(r) for r in rows), schema,
                                 num_partitions)))

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_slices: int = 1) -> "DataFrame":
        if end is None:
            start, end = 0, start
        return DataFrame(self, LNode("range", (start, end, step, num_slices,
                                               "id")))

    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)

    # -- execution ---------------------------------------------------------
    def _execute(self, node: LNode) -> C.CpuExec:
        """Lower -> override pass -> the collect boundary (reference
        ``_execute``, ``session.py:361-447``, without plan analysis,
        events and observability)."""
        cpu = _lower(node, self.conf)
        self.last_cpu_plan = cpu
        final, is_tpu = self.overrides.apply(cpu)
        if is_tpu:
            final = ColumnarToRowExec(self.conf, final)
        self.last_executed_plan = final
        return final

    def _collect(self, node: LNode) -> List[tuple]:
        return self._execute(node).collect()

    def explain_metrics(self) -> str:
        """Per-operator report of the last executed plan (reference
        ``session.py:692``): one line per device exec with its
        ``describe()`` (the exchanges and adaptive reads as planned and
        resolved) and its metrics, such as an exchange's
        ``partitionSize``, ``dataSize`` and ``shuffleBytesWritten``."""
        from ..exec.base import TpuExec, format_metrics

        plan = self.last_executed_plan
        if plan is None:
            return "<no plan executed yet>"
        node = plan.tpu_child if isinstance(plan, ColumnarToRowExec) else plan
        if not isinstance(node, TpuExec):
            return "<last plan ran on CPU; no device metrics>"
        return format_metrics(node)


class GroupedData:
    def __init__(self, df: "DataFrame", keys: Sequence[E.Expression]):
        self._df = df
        self._keys = list(keys)

    def agg(self, *aggs: A.AggregateExpression) -> "DataFrame":
        return DataFrame(
            self._df.session,
            LNode("aggregate", (tuple(self._keys), tuple(aggs)), (self._df.node,)),
        )

    def count(self) -> "DataFrame":
        return self.agg(A.agg(A.Count(), "count"))


class DataFrameReader:
    """reference analog: spark.read with the plugin's scan rules."""

    def __init__(self, session: "TpuSession"):
        self._session = session

    def parquet(self, path: str,
                columns: Optional[Sequence[str]] = None) -> "DataFrame":
        opts = (("columns", tuple(columns) if columns else None),)
        return DataFrame(
            self._session, LNode("file_scan", ("parquet", path, opts)))

    def csv(self, path: str, schema: Optional[StructType] = None,
            header: bool = True, sep: str = ",") -> "DataFrame":
        raise _not_ported("the csv scan", REMAINING_ITEM)

    def orc(self, path: str,
            columns: Optional[Sequence[str]] = None) -> "DataFrame":
        raise _not_ported("the orc scan", REMAINING_ITEM)


class DataFrame:
    def __init__(self, session: TpuSession, node: LNode):
        self.session = session
        self.node = node

    @property
    def write(self):
        raise _not_ported("DataFrameWriter", REMAINING_ITEM)

    # -- transformations ---------------------------------------------------
    def select(self, *exprs: Union[str, E.Expression]) -> "DataFrame":
        return DataFrame(
            self.session,
            LNode("project", (tuple(_as_expr(e) for e in exprs),), (self.node,)),
        )

    def where(self, cond: E.Expression) -> "DataFrame":
        return DataFrame(self.session, LNode("filter", (cond,), (self.node,)))

    filter = where

    def with_column(self, name: str, expr: E.Expression) -> "DataFrame":
        schema = self.schema
        exprs: List[E.Expression] = []
        replaced = False
        for f in schema.fields:
            if f.name == name:
                exprs.append(E.Alias(expr, name))
                replaced = True
            else:
                exprs.append(E.col(f.name))
        if not replaced:
            exprs.append(E.Alias(expr, name))
        return self.select(*exprs)

    def group_by(self, *keys: Union[str, E.Expression]) -> GroupedData:
        return GroupedData(self, [_as_expr(k) for k in keys])

    def agg(self, *aggs: A.AggregateExpression) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def order_by(self, *exprs: Union[str, E.Expression],
                 ascending: Union[bool, Sequence[bool]] = True,
                 nulls_first: Union[None, bool, Sequence[Optional[bool]]] = None,
                 ) -> "DataFrame":
        es = [_as_expr(e) for e in exprs]
        if isinstance(ascending, bool):
            ascending = [ascending] * len(es)
        if nulls_first is None or isinstance(nulls_first, bool):
            nulls_first = [nulls_first] * len(es)
        orders = tuple(zip(ascending, nulls_first))
        return DataFrame(self.session, LNode("sort", (tuple(es), orders), (self.node,)))

    sort = order_by

    def limit(self, n: int) -> "DataFrame":
        """Global limit (Spark CollectLimit semantics: at most n rows total,
        taken from partitions in order)."""
        return DataFrame(
            self.session, LNode("collect_limit", (n,), (self.node,)))

    def local_limit(self, n: int) -> "DataFrame":
        """Per-partition limit (Spark LocalLimit)."""
        return DataFrame(self.session, LNode("limit", (n,), (self.node,)))

    def explode(self, values: Sequence[E.Expression], name: str = "col",
                pos: bool = False) -> "DataFrame":
        """explode(array(e1..eN)): one output row per element, keeping the
        input columns (posexplode with ``pos=True``)."""
        return DataFrame(
            self.session,
            LNode("generate", (tuple(values), name, pos), (self.node,)))

    def cross_join(self, other: "DataFrame",
                   condition: Optional[E.Expression] = None) -> "DataFrame":
        """Cartesian product, optionally with a residual condition."""
        return DataFrame(
            self.session,
            LNode("join", ((), (), "inner", condition),
                  (self.node, other.node)),
        )

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(
            self.session, LNode("union", (), (self.node, other.node))
        )

    def join(self, other: "DataFrame", on: Union[str, Sequence[str], Sequence[Tuple[str, str]]],
             how: str = "inner", condition: Optional[E.Expression] = None) -> "DataFrame":
        if isinstance(on, str):
            on = [on]
        pairs = [
            (k, k) if isinstance(k, str) else k for k in on
        ]
        lkeys = tuple(E.col(a) for a, _ in pairs)
        rkeys = tuple(E.col(b) for _, b in pairs)
        return DataFrame(
            self.session,
            LNode("join", (lkeys, rkeys, how, condition), (self.node, other.node)),
        )

    def with_windows(self, *wexprs) -> "DataFrame":
        """Append window columns (function OVER partition/order spec)."""
        return DataFrame(
            self.session, LNode("window", (tuple(wexprs),), (self.node,))
        )

    def distinct(self) -> "DataFrame":
        keys = tuple(E.col(f.name) for f in self.schema.fields)
        return DataFrame(
            self.session, LNode("aggregate", (keys, ()), (self.node,))
        )

    # -- actions -----------------------------------------------------------
    @property
    def schema(self) -> StructType:
        return _lower(self.node, self.session.conf).output_schema

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    def collect(self) -> List[tuple]:
        return self.session._collect(self.node)

    def count(self) -> int:
        return len(self.collect())

    def to_pydict(self) -> Dict[str, List[Any]]:
        rows = self.collect()
        names = self.columns
        return {n: [r[i] for r in rows] for i, n in enumerate(names)}

    def explain(self) -> str:
        """The tagging report: which operators run on the device and, for
        each that does not, why (the reference's ``explain()`` without its
        static plan analysis block). Nothing is lowered or executed."""
        from ..plugin.overrides import PlanMeta

        meta = PlanMeta(_lower(self.node, self.session.conf),
                        self.session.conf, device=self.session.device)
        meta.tag_for_tpu()
        return "\n".join(meta.explain_lines())
