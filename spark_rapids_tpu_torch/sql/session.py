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

Memory plane: a session installs the fault injector from its
``test.faults.*`` confs, rebuilds the process's spill catalog when its
``memory.*`` confs differ from the catalog's, and, with the ledger armed,
runs each collect in a query scope that the leak sentinel sweeps at its
end (``last_leaks``).

Observability (reference ``session.py:361-555``): ``self.events`` is the
session's event logger (``events.py``; a no-op unless
``eventLog.enabled``/``eventLog.dir``) and the live plane starts per its
confs (``obs.ensure_started``: registry, ``/metrics`` + ``/status``
exporter, watchdog). With either on, every drain emits ``query_start``
(with the environment), ``plan_tagged``, ``plan_analysis`` and
``query_end`` (also when it fails), registers and ends the query's live
progress (the analyzer's ``rows_by_op``/``batches_by_op`` are its
denominators), and runs in a ledger query scope (the ledger arms with
them; the sweep folds the query's peak into the per-digest history).
``export_trace(path)`` writes the ring as a Chrome/Perfetto trace;
``obs_address`` is the exporter's URL; ``close()`` flushes the log.

Plan analysis (``plugin/plananalysis.py``, reference ``session.py:361-447``):
``explain()`` appends the analyzer's ``== Static Plan Analysis ==`` block
under ``sql.analysis.enabled``; a collect runs the analyzer (before any
device work) under ``sql.analysis.crossCheck.enabled``, or with events,
obs or serving on and ``sql.analysis.enabled``; ``last_analysis`` keeps
the result.

Serving (``serve/``, reference ``session.py:558-680``): with
``spark.rapids.tpu.serve.enabled`` a collect plans on the calling thread
under the session's plan lock, takes its analysis from the process-wide
``SharedPlanCache``, is admitted by the ``QueryScheduler`` against its
peak forecast (the ledger's observed peak once the plan's digest has
run), host-prefetches its scans, drains, and releases its reservation.
A reject or a queue timeout is a named error that still closes the
query's ``query_end`` window; a device OOM of an admitted query is
requeued once with its forecast raised to the observed peak.

Files (reference ``session.py:79-90`` and ``:748-846``): ``read.parquet``,
``read.csv`` and ``read.orc`` plan file scans (``io/``); ``df.write``
(:class:`DataFrameWriter`) hands a device plan's batches straight to the
parquet, ORC or CSV writer, or a CPU plan's rows 65 536 at a time, in
the same query window as a collect.

Left out, as the later ROADMAP.md item 26.2: the XLA cost and HLO planes
(the port compiles no programs). With
``spark.rapids.tpu.sql.udfCompiler.enabled`` on, each ``PythonUDF`` is
compiled to engine expressions where its bytecode allows
(``udf/compiler.py``); an uncompilable one, and every one with the conf
off (the default), falls back to the CPU engine, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .. import events as _events
from .. import faults as _faults
from .. import obs as _obs
from ..columnar import resolve_device
from ..conf import (HBM_BUDGET_BYTES, HBM_POOL_FRACTION, HBM_RESERVE,
                    HOST_SPILL_STORAGE_SIZE, LEAK_SENTINEL_ENABLED,
                    MEMORY_DEBUG, RACECHECK_WITNESS_ENABLED, SPILL_ENABLED,
                    RapidsConf)
from ..cpu import plan as C
from ..exec.transitions import ColumnarToRowExec
from ..memory.catalog import BufferCatalog, CatalogInUseError
from ..memory.ledger import query_scope
from ..expr import aggregates as A
from ..expr import expressions as E
from ..plugin.overrides import TpuOverrides
from ..serve import scheduler as _serve  # registers the serve.* confs
from ..types import StructType
from ..utils import locks as _locks

_QUERY_SEQ = [0]
_QUERY_SEQ_LOCK = threading.Lock()


def _next_query_id() -> int:
    """Process-unique query ids (reference ``session.py:246``)."""
    with _QUERY_SEQ_LOCK:
        _QUERY_SEQ[0] += 1
        return _QUERY_SEQ[0]


_SESSION_SEQ = [0]
_SESSION_SEQ_LOCK = threading.Lock()


def _next_session_id() -> str:
    """A session's stable name in serving queues and event lanes."""
    with _SESSION_SEQ_LOCK:
        _SESSION_SEQ[0] += 1
        return f"session-{_SESSION_SEQ[0]}"


#: the conf keys the spill catalog is built from
_CATALOG_KEYS = (HBM_BUDGET_BYTES, HBM_POOL_FRACTION, HBM_RESERVE,
                 HOST_SPILL_STORAGE_SIZE, SPILL_ENABLED, MEMORY_DEBUG,
                 LEAK_SENTINEL_ENABLED)


def _configure_catalog(conf: RapidsConf, device) -> None:
    """Replace the process's spill catalog when this session's memory
    confs or device type differ from the ones it was built for (the
    catalog is a process singleton; a session with another budget gets a
    catalog of its own, and buffers registered with the old one keep
    their accounts there). The serving scheduler's reservations live in
    the catalog, so the swap happens with admission held still and only
    while no ticket is admitted or waiting and nothing is reserved:
    otherwise :class:`CatalogInUseError`. The new catalog's ledger
    starts with no observed peaks (they were measured under the old
    confs), so the next admissions take the analyzer's forecasts."""
    want = (device.type, tuple(conf.get(k) for k in _CATALOG_KEYS))

    def built_for(cat) -> bool:
        return cat is not None and (cat.device_type, tuple(
            cat.conf.get(k) for k in _CATALOG_KEYS)) == want

    if built_for(BufferCatalog._instance):
        return
    with _serve.QueryScheduler.admission_paused() as tickets:
        old = BufferCatalog._instance
        if built_for(old):
            return
        reserved = old.reserved_bytes if old is not None else 0
        if tickets or reserved:
            raise CatalogInUseError(
                f"a session with other memory confs cannot replace the "
                f"process's spill catalog while {tickets} serving "
                f"ticket(s) are admitted or waiting and {reserved} bytes "
                f"are reserved; build it before serving starts or after "
                f"the queries finish")
        BufferCatalog.reset(conf, device)


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
        elif fmt == "csv":
            from ..io.csv import CsvScanner

            sc = CsvScanner(
                path, conf, schema=od.get("schema"),
                header=od.get("header", True), sep=od.get("sep", ","))
        elif fmt == "orc":
            from ..io.orc import OrcScanner

            sc = OrcScanner(path, conf, columns=od.get("columns"),
                            filters=list(pushed))
        else:
            raise ValueError(f"unknown file format {fmt}")
        if len(_SCANNER_CACHE) > 256:
            _SCANNER_CACHE.clear()
        _SCANNER_CACHE[key] = sc
    return sc


def invalidate_scanners(path: str) -> None:
    """Drop the cached scanners that a write to ``path`` makes stale
    (``io/commit.committed_file`` calls this after each commit). A
    scanner keeps what it planned from the files it found when it was
    built: the file list, the parquet row-group splits, the ORC stripes,
    the inferred CSV schema. So one over the rewritten file, or over a
    directory or pattern that now holds it, is built anew."""
    import fnmatch
    import os

    from ..io.scan_cache import _real

    real = _real(path)
    with _SCANNER_CACHE_LOCK:
        for key, sc in list(_SCANNER_CACHE.items()):
            root = _real(key[1])
            if (real == root or real.startswith(root + os.sep)
                    or fnmatch.fnmatchcase(real, root)
                    or any(_real(f) == real for f, _ in sc.files)):
                del _SCANNER_CACHE[key]


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
        self.last_analysis = None
        #: stable name in serving queues / event lanes ("session-N")
        self.serve_id = _next_session_id()
        # planning mutates session state (last_* fields, the pending obs
        # slot): the serving path lets N threads share one session, so
        # plan+claim runs under this lock (the drain itself is arbitrated
        # by the scheduler and the semaphore, not this lock)
        self._plan_lock = _locks.ordered_lock("sql.plan", reentrant=True)
        self._serve_analysis = None
        self._serve_plan_key = None
        self._last_digest: Optional[str] = None
        #: the leak sentinel's finds at the last query's end (the ledger
        #: arms while events or obs are on, or by ``ledger.force_arm``)
        self.last_leaks: List[dict] = []
        # the structured event log (events.py): a ring buffer always
        # backs export_trace(); a JSONL sink appears when eventLog.dir is
        # set. Disabled (the default) costs one boolean per emit site.
        self.events = _events.EventLogger(self.conf)
        self._active_query: Optional[int] = None
        self._pending_obs: Optional[tuple] = None
        # the deterministic fault injector (faults.py): installs nothing
        # with the test.faults.* confs off; tests pair an install with
        # faults.uninstall() (reference session.py:282-287)
        _faults.install(self.conf)
        _configure_catalog(self.conf, self.device)
        # the live observability plane (obs/): None, with nothing
        # started, unless metrics.live / metrics.http / watchdog is on
        self._obs_plane = _obs.ensure_started(self.conf)
        # the runtime lock-order witness (utils/locks.py): every
        # ordered_lock acquire checked against LOCK_ORDER; process-global
        # once on, tests pair it with uninstall_witness() (reference
        # session.py:301-302)
        if self.conf.get(RACECHECK_WITNESS_ENABLED):
            _locks.install_witness()

    def close(self) -> None:
        """Flush and close the session's event sink and detach it from
        the process-global emit path. The obs plane is process-wide and
        stays up for other sessions; stop it with ``obs.shutdown()``."""
        if _events._ACTIVE is self.events:
            _events.uninstall()
        self.events.close()

    @property
    def obs_address(self) -> Optional[str]:
        """Base URL of the live metrics exporter (None unless
        spark.rapids.tpu.metrics.http.enabled): <url>/metrics is the
        Prometheus scrape target, <url>/status feeds tools/tpu_top.py."""
        return (self._obs_plane.address
                if self._obs_plane is not None else None)

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
        """Lower -> static analysis -> override pass -> the collect
        boundary (reference ``_execute``, ``session.py:361-447``). With
        events or obs on, the query gets its id here, and its
        ``query_start``, ``plan_tagged`` and ``plan_analysis`` events."""
        from ..conf import ANALYSIS_CROSS_CHECK, ANALYSIS_ENABLED, SQL_ENABLED

        cpu = _lower(node, self.conf)
        self.last_cpu_plan = cpu
        obs_on = _obs.enabled()
        serve_on = self._serve_enabled()
        run_analysis = self.conf.get(SQL_ENABLED) and (
            self.conf.get(ANALYSIS_CROSS_CHECK)
            # with event logging on, the analyzer's forecasts ride in the
            # log (tools/tpu_profile.py's forecast-vs-actual report); the
            # live plane needs them too — /status progress denominators;
            # the serving scheduler needs the peak forecast for admission
            or ((self.events.enabled or obs_on or serve_on)
                and self.conf.get(ANALYSIS_ENABLED)))
        digest: Optional[str] = None
        if self.events.enabled or obs_on or serve_on:
            import hashlib

            digest = hashlib.sha1(
                cpu.tree_string().encode()).hexdigest()[:12]
        self._last_digest = digest
        analysis = None
        self._serve_analysis = None
        self._serve_plan_key = None
        if run_analysis:
            # the static analyzer runs BEFORE conversion and execution:
            # it never touches the device (plugin/plananalysis.py)
            from ..plugin.plananalysis import analyze_plan

            if serve_on and digest is not None:
                # one analysis per plan digest across ALL sessions: the
                # admission forecast of a repeated plan shape is served
                # from the shared cache instead of recomputed (keyed by
                # the device type too: the choosers' notes read it)
                from ..serve import SharedPlanCache, conf_fingerprint

                key = (digest, conf_fingerprint(self.conf),
                       self.device.type)
                self._serve_plan_key = key
                analysis, _hit = SharedPlanCache.get().analysis_for(
                    key, lambda: analyze_plan(cpu, self.conf,
                                              device=self.device))
                self.last_analysis = analysis
            else:
                analysis = self.last_analysis = analyze_plan(
                    cpu, self.conf, device=self.device)
            self._serve_analysis = analysis
        final, is_tpu = self.overrides.apply(cpu)
        if is_tpu:
            final = ColumnarToRowExec(self.conf, final)
        self.last_executed_plan = final
        self._active_query = None
        self._pending_obs = None
        if self.events.enabled or obs_on:
            qid = self._active_query = _next_query_id()
            if self.events.enabled:
                self._emit_query_events(node, qid, digest, is_tpu,
                                        analysis)
            if obs_on:
                # registered on the draining thread by _run_collect; THIS
                # query's analysis only (last_analysis may hold an
                # earlier query's when the analyzer was skipped here)
                self._pending_obs = (
                    qid, digest,
                    analysis.rows_by_op if analysis is not None else None,
                    analysis.batches_by_op
                    if analysis is not None else None)
        return final

    def _emit_query_events(self, node: LNode, qid: int, plan_digest: str,
                           is_tpu: bool, analysis=None) -> None:
        """query_start + plan_tagged + plan_analysis for one execution
        (reference ``session.py:468``). The session's logger becomes the
        process-wide active sink, so engine-level emitters (catalog,
        caches, transports, pool threads) attribute to this session's
        log."""
        import hashlib

        from .. import envinfo as _envinfo

        _events.install(self.events)
        _events.emit("query_start", query_id=qid, plan_digest=plan_digest,
                     sql_hash=hashlib.sha1(
                         repr(node).encode()).hexdigest()[:12],
                     env=_envinfo.environment_info(self.device))
        meta = self.overrides.last_meta
        if meta is not None:
            fallbacks = []

            def walk(m):
                if m.reasons:
                    name = m.rule.name if m.rule else m.wrapped.node_name
                    fallbacks.append({"op": name,
                                      "reasons": list(m.reasons)})
                for c in m.child_metas:
                    walk(c)

            walk(meta)
            _events.emit("plan_tagged", query_id=qid, on_tpu=is_tpu,
                         fallbacks=fallbacks)
        if analysis is not None:
            _events.emit("plan_analysis", query_id=qid,
                         **analysis.event_fields())

    def _claim_query(self) -> tuple:
        """``(qid, pending, digest)`` that :meth:`_execute` left for the
        query it just planned: its id, its live-progress registration and
        its plan digest. The registration slot is cleared, so a query
        registers once. The serving path claims under the plan lock, where
        concurrent submits on one session would otherwise race the slots."""
        pending, self._pending_obs = self._pending_obs, None
        return self._active_query, pending, self._last_digest

    @contextlib.contextmanager
    def _query_window(self, qid: Optional[int], pending: Optional[tuple],
                      digest: Optional[str]):
        """The window a query's drain runs in (reference
        ``session.py:507-555``): its live progress registered on this (the
        draining) thread, its buffers owned by it in a ledger query scope,
        and in a finally the ``query_end`` event (duration, rows, error),
        the end of its progress and the ledger's sweep (its peak folded
        into the digest's history, and its leaks: ``last_leaks``). The
        window opens while events or obs are on, or the ledger is
        force-armed; with all off nothing of this runs. ``qid``,
        ``pending`` and ``digest`` are the query's claim
        (:meth:`_claim_query`). Yields a dict whose ``rows`` the drain
        sets when it knows the count (a writer leaves it None)."""
        t0 = time.perf_counter_ns()
        cat = BufferCatalog.get()
        ledger = cat.ledger
        if qid is None and ledger.armed():
            qid = _next_query_id()
        out: Dict[str, Optional[int]] = {"rows": None}
        if qid is None:
            yield out
            return
        obs_qid = None
        if pending is not None and _obs.enabled():
            obs_qid, pdigest, rows_by_op, batches_by_op = pending
            _obs.note_query_start(obs_qid, pdigest, rows_by_op,
                                  batches_by_op)
        ok = False
        try:
            with query_scope(qid):
                yield out
            ok = True
        finally:
            rows = out["rows"] if ok else None
            if self.events.enabled:
                _events.emit("query_end", query_id=qid,
                             dur=time.perf_counter_ns() - t0, rows=rows,
                             error=not ok)
            if obs_qid is not None:
                _obs.note_query_end(obs_qid, rows=rows, error=not ok)
            # buffers collected during the drain are unregistered (and
            # their buffer_free emitted) before the sentinel looks
            cat.drain_collected()
            self.last_leaks = ledger.sweep_query(qid, digest=digest)

    def _run_collect(self, final: C.CpuExec, qid: Optional[int],
                     pending: Optional[tuple],
                     digest: Optional[str]) -> List[tuple]:
        """Drain and collect in the query's window
        (:meth:`_query_window`)."""
        with self._query_window(qid, pending, digest) as out:
            rows = final.collect()
            out["rows"] = len(rows)
        return rows

    # -- serving path (serve/scheduler.py) ---------------------------------
    def _serve_enabled(self) -> bool:
        return self.conf.get(_serve.SERVE_ENABLED)

    def _collect(self, node: LNode) -> List[tuple]:
        """Plan + drain one query, through the serving scheduler when
        spark.rapids.tpu.serve.enabled is set."""
        if not self._serve_enabled():
            final = self._execute(node)
            return self._run_collect(final, *self._claim_query())
        return self._collect_serve(node)

    def _collect_serve(self, node: LNode) -> List[tuple]:
        """Serve-path drain with the OOM requeue contract (reference
        ``session.py:569``): an admitted query whose runtime peak busts
        its forecast, and whose spill/retry/split recovery
        (``memory/retry.py``) still could not complete it, releases its
        reservation (the finally of :meth:`_collect_serve_once`) and is
        resubmitted exactly ONCE with its forecast raised to its observed
        peak, so the scheduler queues it until that much headroom is
        real. A second typed OOM propagates: forecast misses become
        queueing, a genuine can't-fit a named error, never a loop."""
        from ..memory.retry import TpuOOMError
        from ..serve import QueryScheduler

        try:
            return self._collect_serve_once(node)
        except TpuOOMError as e:
            # THIS query's observed need: the ledger's per-query peak
            # when it tracked the failed attempt, else the catalog
            # watermark the typed error captured — never the process'
            # lifetime peak. Capped at the total budget, so a transient
            # OOM never turns into a permanent ServeAdmissionRejected.
            cat = BufferCatalog.get()
            led_peak = cat.observed_query_peak(self._active_query)
            observed = led_peak or getattr(e, "watermark", None) or 0
            budget, _, _ = cat.admission_state()
            if budget is not None:
                observed = min(observed, budget)
            QueryScheduler.get(self.conf).note_oom_requeue(
                self.serve_id, self._last_digest or "", observed or None,
                forecast_source="ledger" if led_peak else "watermark")
            return self._collect_serve_once(
                node, forecast_floor=observed or None)

    def _collect_serve_once(self, node: LNode,
                            forecast_floor: Optional[int] = None
                            ) -> List[tuple]:
        """Submit through the scheduler (reference ``session.py:614``):
        plan on the calling thread (a queued query's host work overlaps
        the running query's device work), admit against the peak
        forecast, host-prefetch the scans after admission but BEFORE the
        device semaphore, then drain. The reservation releases in a
        finally, so a failed query frees its headroom.
        ``forecast_floor``: the OOM requeue's raised forecast."""
        from ..serve import QueryScheduler, SharedPlanCache
        from ..serve.scheduler import SERVE_PRIORITY

        sched = QueryScheduler.get(self.conf)
        with self._plan_lock:
            final = self._execute(node)
            qid, pending, digest = self._claim_query()
            plan_key = self._serve_plan_key
            analysis = self._serve_analysis
        # the analyzer's peak forecast whenever it produced one: parquet
        # plans forecast a peak (footer-derived residency) without being
        # fully bounded
        forecast = analysis.peak_hbm if analysis is not None else None
        forecast_source = "analyzer"
        # the measured-stats loop: once the ledger has observed a
        # completed run of this plan digest, its peak replaces the
        # static bound
        observed = BufferCatalog.get().ledger.observed_peak(digest)
        if observed:
            forecast = observed
            forecast_source = "ledger"
        if forecast_floor is not None:
            forecast = max(forecast or 0, forecast_floor)
        try:
            # priority/timeout/depth are THIS session's settings — the
            # scheduler singleton may have been created by another one
            ticket = sched.acquire(
                self.serve_id, self.conf.get(SERVE_PRIORITY), forecast,
                digest, conf_=self.conf, forecast_source=forecast_source)
        except Exception:
            # a reject/timeout must still CLOSE the query_start window
            # _execute opened
            if self.events.enabled and qid is not None:
                _events.emit("query_end", query_id=qid, dur=0, rows=None,
                             error=True)
            raise
        try:
            if isinstance(final, ColumnarToRowExec):
                # host-side decode starts now, on the prefetch pool,
                # while whoever holds the semaphore keeps the device busy
                final.tpu_child.host_prefetch()
            rows = self._run_collect(final, qid=qid, pending=pending,
                                     digest=digest)
            if plan_key is not None:
                SharedPlanCache.get().mark_warm(plan_key)
            return rows
        finally:
            sched.release(ticket)

    def export_trace(self, path: str) -> str:
        """Write the session's event ring buffer as Chrome/Perfetto
        trace-event JSON (reference ``session.py:659``); raises when event
        logging is off entirely."""
        if not self.events.enabled:
            raise RuntimeError(
                "event logging is off: set spark.rapids.tpu.eventLog."
                "enabled (ring buffer only) or eventLog.dir (JSONL file) "
                "to record a trace")
        return _events.export_chrome_trace(self.events.records(), path)

    def explain_metrics(self) -> str:
        """Per-operator report of the last executed plan (reference
        ``session.py:692``): one line per device exec with its
        ``describe()`` (the exchanges and adaptive reads as planned and
        resolved) and its metrics, such as an exchange's
        ``partitionSize``, ``dataSize`` and ``shuffleBytesWritten``, every
        exec's ``bytesTouched`` and, under
        ``metrics.deviceSync.enabled``, its ``opTimeDevice`` and
        ``hbm_gbps[device]``; the memory footer last."""
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
        opts = (("schema", schema), ("header", header), ("sep", sep))
        return DataFrame(
            self._session, LNode("file_scan", ("csv", path, opts)))

    def orc(self, path: str,
            columns: Optional[Sequence[str]] = None) -> "DataFrame":
        opts = (("columns", tuple(columns) if columns else None),)
        return DataFrame(
            self._session, LNode("file_scan", ("orc", path, opts)))


class DataFrameWriter:
    """reference analog: df.write through GpuParquetFileFormat and
    GpuFileFormatWriter's commit protocol (reference
    ``session.py:761-846``). Each writer returns its stats dictionary:
    ``numRows``, ``numBatches`` and ``bytes`` for parquet, ``rows``,
    ``batches`` and ``files`` for ORC and CSV, as in the reference."""

    #: rows a batch of a CPU plan's output carries to the writer
    ROWS_PER_BATCH = 65536

    def __init__(self, df: "DataFrame"):
        self._df = df

    def _batches(self):
        """(batches, schema): the plan's output as a generator of device
        batches. The query is planned and claimed now, so a later query on
        the session cannot take its slots; its window
        (:meth:`TpuSession._query_window`, with ``rows=None``: a count
        would cost a sync a batch) opens and closes with the drain, on
        the draining thread, also when the drain fails or is
        abandoned."""
        df = self._df
        sess = df.session
        final = sess._execute(df.node)
        claim = sess._claim_query()
        schema = final.output_schema

        def gen():
            with sess._query_window(*claim):
                if isinstance(final, ColumnarToRowExec):
                    # the device batches go to the writer as they are
                    yield from final.tpu_child.execute_columnar()
                    return
                from ..columnar.batch import batch_from_rows

                buf: List[tuple] = []
                for row in (r for p in range(final.num_partitions)
                            for r in final.execute_rows_partition(p)):
                    buf.append(row)
                    if len(buf) >= self.ROWS_PER_BATCH:
                        yield batch_from_rows(buf, schema, sess.device)
                        buf = []
                if buf:
                    yield batch_from_rows(buf, schema, sess.device)

        return gen(), schema

    def parquet(self, path: str,
                compression: str = "snappy") -> Dict[str, int]:
        from ..io.parquet import write_parquet

        batches, schema = self._batches()
        return write_parquet(batches, path, schema, compression)

    def orc(self, path: str, compression: str = "zstd") -> Dict[str, int]:
        from ..io.orc import write_orc

        batches, schema = self._batches()
        return write_orc(batches, path, schema, compression)

    def csv(self, path: str) -> Dict[str, int]:
        from ..io.csv import write_csv

        batches, schema = self._batches()
        return write_csv(batches, path, schema)


class DataFrame:
    def __init__(self, session: TpuSession, node: LNode):
        self.session = session
        self.node = node

    @property
    def write(self) -> DataFrameWriter:
        return DataFrameWriter(self)

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
        """The tagging report (which operators run on the device and, for
        each that does not, why) plus — under sql.analysis.enabled — the
        static plan analysis: per-operator batch layouts, nullability,
        the compile-signature forecast and the predicted peak footprint
        checked against the memory budget (reference ``session.py:981``).
        Nothing is lowered or executed and nothing is allocated."""
        from ..conf import ANALYSIS_ENABLED, SQL_ENABLED
        from ..plugin.overrides import PlanMeta

        conf = self.session.conf
        cpu = _lower(self.node, conf)
        meta = PlanMeta(cpu, conf, device=self.session.device)
        meta.tag_for_tpu()
        lines = meta.explain_lines()
        if conf.get(SQL_ENABLED) and conf.get(ANALYSIS_ENABLED):
            from ..plugin.plananalysis import analyze_plan

            analysis = analyze_plan(cpu, conf, meta=meta,
                                    device=self.session.device)
            self.session.last_analysis = analysis
            lines.extend(analysis.render_lines())
        return "\n".join(lines)
