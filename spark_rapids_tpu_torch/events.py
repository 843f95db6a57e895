"""Structured query event log: durable, visualizable, diffable telemetry.

Counterpart of ``spark_rapids_tpu/events.py``, with the same schema
letter for letter (event names, required and optional fields), so the
reference's consumers (``tools/tpu_profile.py``, ``tools/tpu_heap.py``)
read the port's logs as they read the reference's. Every interesting
moment of a query's life — plan tagging, per-op per-batch spans on the
host and device lanes, host-link transfers, spills, the buffer ledger,
shuffle traffic, scan-cache activity, the strategy picks — is emitted as
ONE typed JSON object with a monotonic timestamp.

The families of the reference's program plane have the port's own
emitters: ``compile_miss`` a kernel-library build
(``ops/_cuda_build.py``), ``program_cost`` and ``hlo_summary`` the cost
plane's harvests (``kernel_cost.py``, ``kernel_summary.py``),
``program_cache`` the kernel-library cache (``serve/program_cache.py``)
and ``donation`` a donating site (``plugin/donation.py``). The session emits
``plan_analysis`` (``plugin/plananalysis.py``), the serving scheduler
``admission`` and ``queue`` (``serve/scheduler.py``). The mesh stages
(``exec/mesh.py``) stamp their per-shard ``transfer`` and device-lane
``op_span`` events with the optional ``shard`` field.

Sinks: when ``spark.rapids.tpu.eventLog.dir`` is set, events append to a
JSONL file (one file per logger, line-buffered, thread-safe); a bounded
in-memory ring buffer ALWAYS backs ``TpuSession.export_trace()`` (Chrome /
Perfetto trace-event JSON) even with no directory configured.

Zero-overhead contract: with event logging off (the default), the module
global ``_ENABLED`` stays False and every hot-path call site guards on
``enabled()`` — no dict is built, no lock taken, no sink written, and
``TpuExec.op_timed`` keeps its fast path. The active logger is process
global, not per thread, so events from the parquet decode pool's threads
and the watchdog's thread reach it too.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .conf import (EVENT_LOG_DIR, EVENT_LOG_ENABLED,  # noqa: F401
                   EVENT_LOG_FLIGHT_RECORDER, EVENT_LOG_RING_SIZE,
                   RapidsConf)
from .utils.locks import ordered_lock

# ---------------------------------------------------------------------------
# Event schema: every event carries ``ts`` (perf_counter_ns — the same
# monotonic clock op_timed stamps spans with) and ``event``; the registry
# below names the REQUIRED typed fields per event so the emitters, the
# profiler tool, and the schema round-trip test can never drift apart.
# ---------------------------------------------------------------------------
EVENT_TYPES: Dict[str, tuple] = {
    # query lifecycle (sql/session.py)
    "query_start": ("query_id", "plan_digest", "sql_hash"),
    "query_end": ("query_id", "dur", "rows"),
    # plan tagging: one record per query with every fallback reason the
    # type matrix produced (plugin/overrides.py + typechecks.py)
    "plan_tagged": ("query_id", "on_tpu", "fallbacks"),
    # static plan analyzer forecasts (plugin/plananalysis.py); rows/
    # batches_by_op are the denominators /status progress divides into
    "plan_analysis": ("query_id", "bounded", "site_forecast", "bytes_by_op",
                      "rows_by_op", "batches_by_op", "peak_hbm", "budget",
                      "warnings"),
    # per-op per-batch spans: ``lane`` separates host wall-clock
    # (op_timed) from the device-sync wait (record_batch's fence)
    "op_span": ("op", "section", "start", "dur", "lane"),
    # per-op batch accounting (rows may be null while still a device
    # scalar — no sync just for logging)
    "op_batch": ("op", "rows", "bytes"),
    # pipeline-cache compile miss, naming the site (exec/base.py)
    "compile_miss": ("site", "total"),
    # compiled-program cost harvest (xla_cost.py): exactly ONE per
    # compile miss, emitted at the program's first call — trace/compile
    # phase split (ms) plus what XLA says the program costs per
    # invocation (cost_analysis/memory_analysis). Cost fields are None
    # when the backend didn't report them (the CPU fallback reports a
    # different key set than a real TPU) — consumers guard on presence.
    # Renders as a duration span on the Perfetto "compile" track plus a
    # cumulative compile-seconds counter; tools/tpu_profile.py joins it
    # against the op_span device lane in '== roofline =='.
    # ``alias_bytes``: input bytes XLA aliased to outputs under buffer
    # donation (plugin/donation.py); temp_bytes arrives alias-CORRECTED
    # (raw temp minus alias — see xla_cost.harvest_compiled), so a
    # donating program's temp genuinely reflects scratch HBM
    "program_cost": ("site", "digest", "backend", "trace_ms",
                     "compile_ms", "flops", "bytes_accessed", "temp_bytes",
                     "argument_bytes", "output_bytes", "alias_bytes"),
    # per-fusion HLO attribution of one harvested program (hlo.py):
    # emitted right after its program_cost twin (same site+digest), it
    # names WHICH instructions own the bytes — top-K fusions by
    # attributed bytes with an idiom classification (scatter-add /
    # one-hot dot / gather / transpose-copy / collective), the
    # module-wide scatter count, the largest-output producer, and the
    # parse coverage fraction (text parsing over backend dialects is
    # best-effort: coverage < 1 explains a shortfall, never a failure)
    "hlo_summary": ("site", "digest", "backend", "instructions",
                    "coverage", "total_bytes", "scatter_count",
                    "top_fusions", "largest_output"),
    # host-link transfers: packed uploads (h2d), sanctioned host_pull
    # reads (d2h), host_fence sync points (direction "fence", 0 bytes)
    "transfer": ("direction", "bytes", "site"),
    # spill lifecycle with the catalog's LIVE device-byte watermark
    "spill": ("kind", "bytes", "device_bytes"),
    # per-buffer HBM ledger lifecycle (memory/ledger.py): one alloc per
    # ledger-tracked buffer (spillable handle / scan-cache entry /
    # admission reservation) with its full owner tag — the op in scope,
    # the owning query window, the creation call site ("file.py:line")
    # and its stable 12-hex origin digest; one free with the reason
    # (close / donate / split / evict / release / ...). bid is the
    # ledger id, unique per catalog generation across all kinds.
    "buffer_alloc": ("bid", "kind", "bytes", "op", "query_id", "site",
                     "origin"),
    "buffer_free": ("bid", "kind", "bytes", "reason", "op", "query_id"),
    # live-heap snapshot at a query-window close (memory/ledger.py
    # sweep): total attributed device-live bytes, the per-op breakdown,
    # the top-3 owners, and how many flagged leaks are still live —
    # tools/tpu_heap.py cross-checks its reconstruction against these
    "heap_snapshot": ("query_id", "live_bytes", "by_op", "top",
                      "leaked"),
    # OOM recovery plane (memory/retry.py): one record per recovery
    # action. ``kind`` is retry (spill+backoff before re-attempt) /
    # split (escalation to half-capacity) / requeue (the serve
    # scheduler re-admitting a query with its forecast inflated to the
    # observed peak); ``attempt`` counts attempts so far, ``depth`` the
    # split recursion level, watermark/budget the catalog state at the
    # failure (budget null = unlimited)
    "oom_retry": ("op", "kind", "attempt", "depth", "watermark",
                  "budget"),
    # one split-and-retry halving: the input rows and both pieces'
    # (first piece takes the extra row on odd counts)
    "batch_split": ("op", "depth", "rows", "rows_left", "rows_right"),
    # one donating dispatch (plugin/donation.py): ``bytes`` of input
    # planes handed to XLA for reuse, ``planes`` how many arrays, at
    # which certified compile site, attributed to the dispatching op
    "donation": ("site", "op", "bytes", "planes"),
    # shuffle pieces through the transport SPI (shuffle/transport.py)
    "shuffle_write": ("shuffle_id", "map_id", "reduce_id", "rows", "bytes",
                      "codec"),
    "shuffle_fetch": ("shuffle_id", "reduce_id", "pieces", "rows", "bytes",
                      "codec"),
    # device scan-cache activity (io/scan_cache.py)
    "scan_cache": ("op", "bytes"),
    # persistent AOT program cache (serve/program_cache.py): ``op`` is
    # hit (entry deserialized at lookup) / miss (no entry — the plain
    # compile path runs and stores) / put (entry written atomically) /
    # deserialize (first-call compile of a deserialized program; its
    # near-zero cost rides in the optional ``ms``) / evict (size-capped
    # LRU) / corrupt (poisoned entry deleted, plain compile fallback) /
    # write_error (store failed, query unaffected). ``key`` is the same
    # 12-hex signature digest program_cost carries, so the profiler can
    # join the two event families per program.
    "program_cache": ("op", "site", "key", "bytes"),
    # per-plan aggregation-strategy choice (exec/aggregate.py): the AUTO
    # chooser's pick (or the forced conf value) with its cost-model
    # reason — logged so tpu_profile can hold the chooser accountable
    # against the measured op spans of the SAME run
    "agg_strategy": ("op", "strategy", "reason", "cap"),
    # per-plan join-strategy choice (exec/join.py): the AUTO chooser's
    # probe-lowering pick (or the forced conf value) with its cost-model
    # reason, keyed by the build side's capacity bucket
    "join_strategy": ("op", "strategy", "reason", "build_cap"),
    # pipelined parquet decode stages (io/parquet_device.py): host chunk
    # decode, staged h2d upload, device unpack dispatch; ``dur`` is the
    # stage's host wall-clock (ns) so the overlap is visible in Perfetto
    "pq_pipeline": ("stage", "rg", "bytes", "dur"),
    # watchdog alerts (obs/watchdog.py): kind is stall / hbm_pressure /
    # recompile_storm; the same rules replay offline via
    # tools/tpu_profile.py --alerts
    "alert": ("kind", "detail", "value", "threshold"),
    # serving-layer admission decisions (serve/scheduler.py): verdict is
    # admit / queue / reject; forecast_bytes is the analyzer's peak-HBM
    # forecast (null for unbounded plans), free_bytes the live headroom
    # (budget - watermark - reservations) at decision time
    "admission": ("session", "digest", "verdict", "forecast_bytes",
                  "free_bytes", "reason"),
    # fair-queue lifecycle (serve/scheduler.py): op enqueue / dequeue /
    # timeout; depth is the session's queue depth after the op; wait_ns
    # is the queued duration (dequeue/timeout only, else 0). The queue
    # WAIT itself also rides as an op_span on the session's serve lane
    # so Perfetto shows the interleaving.
    "queue": ("session", "op", "depth", "wait_ns"),
}

#: OPTIONAL fields per event type — emitted only in specific contexts,
#: absent otherwise (consumers must .get()). ``shard``: mesh SPMD stages
#: stamp per-chip staging transfers and per-chip completion spans with
#: the shard index; the Perfetto export renders those on '<op> [chip k]'
#: tracks (chrome_trace below). Declared here so the schema registry
#: stays the single source of truth for emitters AND consumers — a new
#: optional field lands in this map, not as silent drift.
EVENT_OPTIONAL_FIELDS: Dict[str, tuple] = {
    # ``env``: environment provenance (envinfo.environment_info —
    # backend, device kind/count, framework version, host cores) so an offline
    # diff can warn loudly when two logs came from different hardware
    # (the recurring CPU-fallback-vs-device comparability confusion)
    "query_start": ("env",),
    "op_span": ("shard",),
    "transfer": ("shard",),
    # ``op``: the exec whose hot section compiled the program (absent
    # for compiles outside any op scope, e.g. scan staging helpers);
    # ``out_bytes``: per-output byte breakdown when the backend reports
    # one; ``generated_code_bytes``: memory_analysis code size;
    # ``peak_hbm_gbps``/``peak_tflops``: explicitly conf-declared
    # roofline peaks riding to the offline profiler (absent when the
    # confs are 0.0 and per-backend defaults apply);
    # ``from_cache``/``saved_ms``: set when the AOT program cache
    # (serve/program_cache.py) re-emitted a PERSISTED cost payload on a
    # deserialize hit — bytes/flops are the original harvest,
    # trace_ms/compile_ms are this process's near-zero deserialize +
    # cached-compile cost, saved_ms the original bill avoided
    "program_cost": ("op", "out_bytes", "generated_code_bytes",
                     "peak_hbm_gbps", "peak_tflops", "from_cache",
                     "saved_ms"),
    # ``retries``: transient-failure retries the network transport paid
    # before this fetch succeeded (shuffle/network.py exponential
    # backoff; absent on the in-process transports, 0 on a clean fetch)
    "shuffle_fetch": ("retries",),
    # ``op``: same attribution as program_cost; ``accounted_frac``: this
    # summary's total_bytes / the program's cost_analysis bytes accessed
    # (absent when the backend reported no byte cost) — XLA applies
    # utilization weighting inside fusions, so the ratio reports how
    # much of the compiler's figure the shape-level attribution explains;
    # ``from_cache``: the summary was re-emitted from an AOT
    # program-cache entry's persisted payload (the program's HLO was
    # parsed in the process that originally compiled it)
    "hlo_summary": ("op", "accounted_frac", "from_cache"),
    # ``ms``: deserialize(+cached-compile) duration on hit/deserialize
    # records; ``detail``: human-readable cause on corrupt/write_error
    "program_cache": ("ms", "detail"),
    # ``bid``: the ledger id of the buffer that moved tier (present only
    # while the HBM ledger is armed — lets tpu_heap.py attribute spill
    # churn to the owning op without a second bookkeeping stream)
    "spill": ("bid",),
    # ``forecast_source``: where the admitted forecast came from —
    # "analyzer" (static plan bound) or "ledger" (observed per-digest
    # peak, the ROADMAP 5a measured-stats feed)
    "admission": ("forecast_source",),
}


class EventLogger:
    """Thread-safe typed event sink: ring buffer + optional JSONL file."""

    def __init__(self, conf_: Optional[RapidsConf] = None,
                 path: Optional[str] = None,
                 ring_size: Optional[int] = None):
        conf_ = conf_ or RapidsConf({})
        log_dir = conf_.get(EVENT_LOG_DIR)
        self.enabled = bool(conf_.get(EVENT_LOG_ENABLED) or log_dir or path)
        self._lock = ordered_lock("events.logger")
        size = ring_size or conf_.get(EVENT_LOG_RING_SIZE)
        self._ring: collections.deque = collections.deque(maxlen=size)
        self.path: Optional[str] = None
        self._fh = None
        #: flight-recorder mode: eventLog.dir names where alert-triggered
        #: ring dumps land, but NO streaming sink is opened — the ring is
        #: the only live store (see dump_flight_record)
        self.flight_dir: Optional[str] = None
        if (self.enabled and log_dir and path is None
                and conf_.get(EVENT_LOG_FLIGHT_RECORDER)):
            os.makedirs(log_dir, exist_ok=True)
            self.flight_dir = log_dir
            return
        if self.enabled and (path or log_dir):
            if path is None:
                os.makedirs(log_dir, exist_ok=True)
                path = os.path.join(
                    log_dir,
                    f"tpu-events-{os.getpid()}-{_next_file_seq()}.jsonl")
            self.path = path
            # line-buffered so an offline reader sees every completed
            # event even if the process never calls close()
            self._fh = open(path, "a", buffering=1)
            # teardown durability: a dying interpreter (SystemExit mid-
            # query, a session nobody closed) must not strand a truncated
            # final line — atexit flushes/closes the sink as a last
            # resort. Registered through a WEAKREF so the hook never
            # pins a dropped logger (a service churning short-lived
            # sessions must not accumulate fds/ring buffers until exit:
            # a collected logger's fh still closes via the io finalizer,
            # as before); close() unregisters the hook entirely.
            import atexit
            import weakref

            ref = weakref.ref(self)

            def _atexit_close(_ref=ref):
                logger = _ref()
                if logger is not None:
                    logger.close()

            self._atexit_cb = _atexit_close
            atexit.register(_atexit_close)

    def emit(self, etype: str, **fields: Any) -> None:
        if not self.enabled:
            return
        # ``tid`` (the emitting thread) rides on every record like ``ts``
        # does: under concurrent serving, query windows overlap in time,
        # and the offline profiler attributes per-op events to the query
        # whose drain thread emitted them (the same by-thread model the
        # live progress tracker uses)
        rec = {"ts": time.perf_counter_ns(), "event": etype,
               "tid": threading.get_ident()}
        rec.update(fields)
        with self._lock:
            self._ring.append(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")

    def records(self) -> List[dict]:
        """Snapshot of the ring buffer (oldest first)."""
        with self._lock:
            return list(self._ring)

    def dump_flight_record(self, episode: int) -> Optional[str]:
        """Write the current ring snapshot to the flight-recorder dir as
        ``tpu-flightrec-<pid>-<episode>.jsonl`` (one file per watchdog
        alert episode — the black box recovered after an incident). A
        no-op returning None outside flight-recorder mode: a streaming
        logger already persists everything, and a ring-only logger with
        no eventLog.dir has nowhere to dump."""
        if self.flight_dir is None:
            return None
        recs = self.records()
        path = os.path.join(
            self.flight_dir,
            f"tpu-flightrec-{os.getpid()}-{episode}.jsonl")
        # write-then-rename so a reader (or a dying interpreter) never
        # sees a half-written dump
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for r in recs:
                f.write(json.dumps(r, separators=(",", ":")) + "\n")
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        with self._lock:
            if self._fh is None:
                return
            self._fh.flush()
            self._fh.close()
            self._fh = None
        cb = getattr(self, "_atexit_cb", None)
        if cb is not None:
            self._atexit_cb = None
            import atexit

            try:
                atexit.unregister(cb)
            except Exception:  # pragma: no cover - interpreter teardown
                pass


_FILE_SEQ = [0]
_FILE_SEQ_LOCK = threading.Lock()


def _next_file_seq() -> int:
    with _FILE_SEQ_LOCK:
        _FILE_SEQ[0] += 1
        return _FILE_SEQ[0]


# ---------------------------------------------------------------------------
# Process-global active logger. Emit sites live deep in the engine (the
# buffer catalog, the scan cache, the shuffle transports) where no session
# handle exists, so the session INSTALLS its logger at execute time; with
# nothing installed the fast path is one module-global boolean read.
# ---------------------------------------------------------------------------
_ENABLED = False
_ACTIVE: Optional[EventLogger] = None


def enabled() -> bool:
    """The hot-path guard: True only while an enabled logger is installed.
    Call sites that would build an event dict per batch check this FIRST."""
    return _ENABLED


def install(logger: EventLogger) -> None:
    global _ENABLED, _ACTIVE
    if logger.enabled:
        _ACTIVE = logger
        _ENABLED = True


def uninstall() -> None:
    global _ENABLED, _ACTIVE
    _ACTIVE = None
    _ENABLED = False


def emit(etype: str, **fields: Any) -> None:
    """Emit through the active logger; a no-op when logging is off."""
    if not _ENABLED:
        return
    logger = _ACTIVE
    if logger is not None:
        logger.emit(etype, **fields)


def flight_dump(episode: int) -> Optional[str]:
    """Dump the active logger's ring for one watchdog alert episode
    (None when logging is off or the logger is not a flight recorder).
    Called by the watchdog right after it raises a new alert batch, so
    the dump contains the alert events themselves plus everything the
    ring held leading up to them."""
    logger = _ACTIVE
    if logger is None:
        return None
    return logger.dump_flight_record(episode)


# ---------------------------------------------------------------------------
# Chrome / Perfetto trace-event export: the in-memory event stream becomes
# a trace-event JSON object that opens directly in ui.perfetto.dev (or
# chrome://tracing). One track (tid) per operator — host spans on the op's
# own track, device-sync waits on "<op> [device]" — plus counter tracks for
# the HBM device-byte watermark and cumulative compile misses, and instant
# markers for transfers/shuffle/scan-cache activity.
# ---------------------------------------------------------------------------
_PID = 1


def chrome_trace(records: List[dict]) -> dict:
    if not records:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(
        min(r["ts"] for r in records),
        min((r["start"] for r in records if r.get("event") == "op_span"),
            default=records[0]["ts"]),
    )

    tids: Dict[str, int] = {}
    meta: List[dict] = []

    def tid_of(track: str) -> int:
        t = tids.get(track)
        if t is None:
            t = tids[track] = len(tids) + 1
            meta.append({"ph": "M", "pid": _PID, "tid": t,
                         "name": "thread_name", "args": {"name": track}})
        return t

    def us(ns: int) -> float:
        return (ns - base) / 1e3

    out: List[dict] = []
    open_queries: Dict[Any, dict] = {}
    compile_s = 0.0
    #: per-op device-live bytes reconstructed from the HBM ledger's
    #: buffer lifecycle — rendered as one counter track per op so the
    #: watermark's owners are visually attributable at any timestamp
    hbm_by_op: Dict[str, int] = {}
    ledger_ops: Dict[Any, str] = {}
    ledger_dev: set = set()  # bids currently device-resident

    def hbm_counter(ts: int, op: Optional[str], delta: int) -> None:
        key = op or "(unattributed)"
        hbm_by_op[key] = hbm_by_op.get(key, 0) + delta
        out.append({"ph": "C", "pid": _PID, "name": f"hbm_bytes {key}",
                    "ts": us(ts), "args": {"bytes": hbm_by_op[key]}})

    for r in records:
        ev = r.get("event")
        ts = r["ts"]
        if ev == "op_span":
            # a span with a ``shard`` gets its own per-chip track, so a
            # mesh SPMD stage renders one lane per device (all 8 chips
            # visible side by side); shard-less spans keep the host /
            # [device] pair of tracks
            shard = r.get("shard")
            if shard is not None:
                track = f"{r['op']} [chip {shard}]"
            else:
                track = r["op"] + (" [device]" if r.get("lane") == "device"
                                   else "")
            name = r["op"] + (("." + r["section"]) if r.get("section")
                              else "")
            args = {"lane": r["lane"]}
            if shard is not None:
                args["shard"] = shard
            out.append({"ph": "X", "pid": _PID, "tid": tid_of(track),
                        "name": name, "ts": us(r["start"]),
                        "dur": r["dur"] / 1e3, "args": args})
        elif ev == "query_start":
            open_queries[r.get("query_id")] = r
        elif ev == "query_end":
            qs = open_queries.pop(r.get("query_id"), None)
            start = qs["ts"] if qs is not None else ts - r["dur"]
            out.append({"ph": "X", "pid": _PID, "tid": tid_of("query"),
                        "name": f"query {r.get('query_id')}",
                        "ts": us(start), "dur": r["dur"] / 1e3,
                        "args": {"rows": r.get("rows")}})
        elif ev == "compile_miss":
            out.append({"ph": "C", "pid": _PID, "name": "compile_misses",
                        "ts": us(ts), "args": {"misses": r["total"]}})
            out.append({"ph": "i", "pid": _PID, "tid": tid_of("compile"),
                        "name": f"miss:{r['site']}", "ts": us(ts), "s": "t"})
        elif ev == "program_cost":
            # compiles were invisible in traces (instant miss markers
            # only): render the harvested trace+compile phases as a REAL
            # duration span ending at the emit timestamp, plus a
            # cumulative compile-seconds counter track
            dur_ms = (r.get("trace_ms") or 0) + (r.get("compile_ms") or 0)
            compile_s += dur_ms / 1e3
            args = {"site": r.get("site"), "digest": r.get("digest"),
                    "trace_ms": r.get("trace_ms"),
                    "compile_ms": r.get("compile_ms")}
            for k in ("flops", "bytes_accessed", "temp_bytes"):
                if r.get(k) is not None:
                    args[k] = r[k]
            out.append({"ph": "X", "pid": _PID, "tid": tid_of("compile"),
                        "name": f"compile:{r.get('site')}"
                                + (f" [{r['op']}]" if r.get("op") else ""),
                        "ts": us(ts) - dur_ms * 1e3, "dur": dur_ms * 1e3,
                        "args": args})
            out.append({"ph": "C", "pid": _PID, "name": "compile_seconds",
                        "ts": us(ts), "args": {"seconds": round(compile_s, 4)}})
        elif ev == "spill":
            out.append({"ph": "C", "pid": _PID, "name": "hbm_device_bytes",
                        "ts": us(ts), "args": {"bytes": r["device_bytes"]}})
            out.append({"ph": "i", "pid": _PID, "tid": tid_of("memory"),
                        "name": f"{r['kind']} {r['bytes']}B", "ts": us(ts),
                        "s": "t"})
            # a ledger-stamped spill moves its buffer's bytes off (or
            # back onto) the owning op's counter track
            bid = r.get("bid")
            if bid in ledger_ops:
                if r["kind"] == "unspill" and bid not in ledger_dev:
                    ledger_dev.add(bid)
                    hbm_counter(ts, ledger_ops[bid], r["bytes"])
                elif r["kind"] == "device_to_host" and bid in ledger_dev:
                    ledger_dev.discard(bid)
                    hbm_counter(ts, ledger_ops[bid], -r["bytes"])
        elif ev == "buffer_alloc":
            if r.get("kind") != "reservation":
                ledger_ops[r["bid"]] = r.get("op")
                ledger_dev.add(r["bid"])
                hbm_counter(ts, r.get("op"), r["bytes"])
        elif ev == "buffer_free":
            bid = r.get("bid")
            if bid in ledger_ops:
                if bid in ledger_dev:
                    hbm_counter(ts, ledger_ops[bid], -r["bytes"])
                ledger_dev.discard(bid)
                del ledger_ops[bid]
        elif ev == "heap_snapshot":
            out.append({"ph": "i", "pid": _PID, "tid": tid_of("memory"),
                        "name": f"heap {r.get('live_bytes')}B live, "
                                f"{r.get('leaked')} leaked", "ts": us(ts),
                        "s": "t"})
        elif ev == "oom_retry":
            # the resilience track: recovery actions land beside the
            # compile track, so a degraded query's half-capacity
            # recompiles are attributable to the split that caused them
            out.append({"ph": "i", "pid": _PID, "tid": tid_of("resilience"),
                        "name": f"oom_{r['kind']} {r['op']} "
                                f"(attempt {r.get('attempt')}, "
                                f"depth {r.get('depth')})",
                        "ts": us(ts), "s": "t",
                        "args": {"watermark": r.get("watermark"),
                                 "budget": r.get("budget")}})
        elif ev == "batch_split":
            out.append({"ph": "i", "pid": _PID, "tid": tid_of("resilience"),
                        "name": f"split {r['op']} depth {r.get('depth')}: "
                                f"{r.get('rows')} -> "
                                f"{r.get('rows_left')}+"
                                f"{r.get('rows_right')}",
                        "ts": us(ts), "s": "t"})
        elif ev == "transfer":
            # per-shard staging uploads land on their chip's transfer
            # track so the sharded scan's upload pipeline is visible
            shard = r.get("shard")
            track = ("transfers" if shard is None
                     else f"transfers [chip {shard}]")
            out.append({"ph": "i", "pid": _PID, "tid": tid_of(track),
                        "name": f"{r['direction']} {r['bytes']}B "
                                f"({r['site']})",
                        "ts": us(ts), "s": "t"})
        elif ev in ("shuffle_write", "shuffle_fetch"):
            out.append({"ph": "i", "pid": _PID, "tid": tid_of("shuffle"),
                        "name": f"{ev} {r['bytes']}B", "ts": us(ts),
                        "s": "t"})
        elif ev == "scan_cache":
            out.append({"ph": "i", "pid": _PID, "tid": tid_of("scan_cache"),
                        "name": f"{r['op']}", "ts": us(ts), "s": "t"})
        elif ev == "program_cache":
            # the AOT cache's lifecycle lands on the compile track: a
            # deserialize marker where a multi-second compile span would
            # otherwise sit is the visual proof of a warm start
            out.append({"ph": "i", "pid": _PID, "tid": tid_of("compile"),
                        "name": f"aot_{r['op']}:{r.get('site') or ''}",
                        "ts": us(ts), "s": "t",
                        "args": {"key": r.get("key"),
                                 "bytes": r.get("bytes")}})
        elif ev == "alert":
            out.append({"ph": "i", "pid": _PID, "tid": tid_of("watchdog"),
                        "name": f"{r['kind']}: {r.get('detail', '')}",
                        "ts": us(ts), "s": "t"})
        elif ev == "pq_pipeline":
            # emitted at stage END with its duration: render the span so
            # decode/upload overlap is visible as parallel tracks
            out.append({"ph": "X", "pid": _PID,
                        "tid": tid_of(f"pq {r['stage']}"),
                        "name": f"{r['stage']} rg{r.get('rg')}",
                        "ts": us(ts - (r.get("dur") or 0)),
                        "dur": (r.get("dur") or 0) / 1e3,
                        "args": {"bytes": r.get("bytes")}})
        elif ev == "admission":
            out.append({"ph": "i", "pid": _PID, "tid": tid_of("serve"),
                        "name": f"{r['verdict']} session {r['session']}"
                                f" ({r.get('reason') or 'fits'})",
                        "ts": us(ts), "s": "t"})
        elif ev == "queue":
            # PER-SESSION depth counter tracks (the event's depth field
            # is the session's own queue depth — one global track would
            # zigzag between sessions' depths); the wait spans
            # themselves arrive as op_span records on the matching
            # 'serve session-N' lanes
            out.append({"ph": "C", "pid": _PID,
                        "name": f"queue_depth {r['session']}",
                        "ts": us(ts), "args": {"depth": r["depth"]}})
        # plan_tagged / plan_analysis / op_batch / agg_strategy /
        # join_strategy carry no timeline shape; the offline profiler
        # reads them from the JSONL log instead
    out.sort(key=lambda e: e["ts"])
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def export_chrome_trace(records: List[dict], path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(records), f)
    return path
