"""Live metrics registry: the ONLINE half of observability.

Counterpart of ``spark_rapids_tpu/obs/registry.py``, with the same
metric catalog letter for letter (names, kinds, help texts, labels), so
a Prometheus scrape of the port reads as one of the reference. Where the
event log is the offline record, this registry is what an operator
watches in real time: per-op host/device time and bytes, the
BufferCatalog device-byte watermark, shuffle transport traffic,
scan-cache effectiveness, the strategy picks.

Design mirrors events.py so the two planes share one mental model:

  * a process-global ``install()``-ed registry behind a module-global
    ``_ENABLED`` boolean — with nothing installed (the default) every
    hot-path call site pays ONE boolean read and builds nothing;
  * every metric is DECLARED up front in :data:`METRICS` (name, kind,
    help, label names) — the single source of truth for the emit sites
    and the Prometheus renderer, with :data:`EVENT_BACKED_METRICS`
    naming each event type's live twin;
  * the registry lock is a LEAF lock (``obs.registry`` in
    ``utils/locks.py``): no registry method ever calls into another
    engine subsystem, so emitters may call in while holding their own
    locks (the BufferCatalog does) with no lock-ordering hazard.

The program-plane families have the port's own emitters: compile
misses are kernel-library builds (``ops/_cuda_build.py``), program costs
and HLO summaries the cost plane's harvests (``kernel_cost.py``), the
program cache the kernel-library cache (``serve/program_cache.py``),
donated bytes the donating sites (``plugin/donation.py``). The serving scheduler (``serve/``) feeds the
``tpu_serve_*`` families, the catalog ``tpu_hbm_reserved_bytes``. The mesh stages feed
``tpu_mesh_staged_rows`` and ``tpu_mesh_shard_seconds`` per shard, the
network shuffle client ``tpu_shuffle_fetch_retries``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..utils.locks import ordered_lock

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

#: per-batch host-time histogram buckets (seconds)
_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0)

# ---------------------------------------------------------------------------
# The metric catalog. Counters are cumulative since install; gauges are
# last-write; the histogram buckets per-batch operator wall time.
# Prometheus exposition appends ``_total`` to counters.
# ---------------------------------------------------------------------------
METRICS: Dict[str, Tuple[str, str, Tuple[str, ...]]] = {
    "tpu_op_time_seconds": (
        COUNTER, "Cumulative operator time by lane (host wall-clock from "
        "op_timed; device wait under metrics.deviceSync.enabled)",
        ("op", "lane")),
    "tpu_op_rows": (
        COUNTER, "Output rows recorded per operator", ("op",)),
    "tpu_op_batches": (
        COUNTER, "Output batches recorded per operator", ("op",)),
    "tpu_op_bytes": (
        COUNTER, "Output bytesTouched recorded per operator", ("op",)),
    "tpu_op_batch_seconds": (
        HISTOGRAM, "Per-batch operator host time distribution", ("op",)),
    "tpu_compile_misses": (
        COUNTER, "XLA pipeline-cache compile misses by site", ("site",)),
    "tpu_compile_seconds": (
        COUNTER, "Harvested XLA program build time by site and phase "
        "(trace = jit lower, compile = XLA backend compile — the "
        "program_cost event's live twin, xla_cost.py)", ("site", "phase")),
    "tpu_program_temp_bytes": (
        GAUGE, "Largest XLA temp allocation harvested per compile site "
        "(memory_analysis temp_size_in_bytes high-water mark; a jump "
        "means a kernel started materializing intermediates the layout "
        "model doesn't know about)", ("site",)),
    "tpu_hlo_scatter_programs": (
        COUNTER, "Harvested programs whose optimized HLO contains at "
        "least one scatter-classified instruction, by compile site "
        "(hlo.py per-fusion attribution — the hlo_summary event's live "
        "twin; scatters are the byte-amplification idiom the roofline "
        "push hunts)", ("site",)),
    "tpu_hlo_top_fusion_bytes": (
        GAUGE, "Largest single-fusion byte attribution harvested per "
        "compile site (high-water mark; a jump means one fusion started "
        "owning more of the program's traffic — the per-instruction "
        "refinement of tpu_program_temp_bytes)", ("site",)),
    "tpu_transfers": (
        COUNTER, "Host-link transfers by direction (h2d/d2h/fence)",
        ("direction",)),
    "tpu_transfer_bytes": (
        COUNTER, "Host-link bytes by direction", ("direction",)),
    "tpu_spills": (
        COUNTER, "Buffer-catalog spill events by kind "
        "(device_to_host/host_to_disk/unspill)", ("kind",)),
    "tpu_spill_bytes": (
        COUNTER, "Bytes moved by spill events, by kind", ("kind",)),
    "tpu_hbm_device_bytes": (
        GAUGE, "Live catalog-tracked device bytes (the BufferCatalog "
        "watermark)", ()),
    "tpu_hbm_peak_device_bytes": (
        GAUGE, "High-water mark of catalog-tracked device bytes", ()),
    "tpu_hbm_budget_bytes": (
        GAUGE, "Derived HBM spill budget (0 = unlimited/unknown)", ()),
    "tpu_shuffle_pieces": (
        COUNTER, "Shuffle pieces through the transport SPI",
        ("direction", "codec")),
    "tpu_shuffle_bytes": (
        COUNTER, "Shuffle transport bytes", ("direction", "codec")),
    "tpu_shuffle_codec_seconds": (
        COUNTER, "Shuffle codec time (encode/decode)", ("op",)),
    "tpu_scan_cache_ops": (
        COUNTER, "Device scan-cache operations (hit/miss/put/evict)",
        ("op",)),
    "tpu_program_cache": (
        COUNTER, "Persistent AOT program-cache operations "
        "(hit/miss/put/deserialize/evict/corrupt/write_error — "
        "serve/program_cache.py; the program_cache event's live twin). "
        "A warm process shows hits ~= deserializes and zero compile "
        "misses; corrupt entries are deleted and fall through to plain "
        "compiles.", ("op",)),
    "tpu_program_cache_resident_bytes": (
        GAUGE, "Bytes resident in the AOT program-cache directory "
        "(updated after each store's size-capped LRU sweep)", ()),
    "tpu_program_cache_saved_seconds": (
        COUNTER, "Original trace+compile seconds the persisted cost "
        "payloads say deserialize hits avoided (the compile-seconds-"
        "avoided estimate tpu_profile's program-cache section reports)",
        ()),
    "tpu_scan_cache_hit_ratio": (
        GAUGE, "hits / (hits + misses) of the device scan cache", ()),
    "tpu_scan_cache_resident_bytes": (
        GAUGE, "Bytes resident in the device scan cache", ()),
    "tpu_queries": (
        COUNTER, "Queries by lifecycle state (started/finished/failed)",
        ("state",)),
    "tpu_queries_live": (
        GAUGE, "Queries currently executing", ()),
    "tpu_mesh_staged_rows": (
        COUNTER, "Rows staged onto each mesh shard (per-chip lane of the "
        "multichip SPMD path)", ("device",)),
    "tpu_mesh_shard_seconds": (
        COUNTER, "Per-chip completion time of mesh SPMD programs "
        "(dispatch to that shard's outputs ready — upper bound, polled "
        "in shard order; the live twin of the per-chip op_span lanes)",
        ("device",)),
    "tpu_watchdog_alerts": (
        COUNTER, "Watchdog alerts raised, by kind "
        "(stall/hbm_pressure/recompile_storm)", ("kind",)),
    "tpu_agg_strategy": (
        COUNTER, "Aggregation lowering choices by resolved strategy "
        "(MATMUL/SCATTER/SORT — conf sql.agg.strategy)", ("strategy",)),
    "tpu_join_strategy": (
        COUNTER, "Join probe lowering choices by resolved strategy "
        "(SEARCH/DIRECT/RADIX/PALLAS — conf sql.join.strategy; the "
        "join_strategy event's live twin)", ("strategy",)),
    "tpu_pq_pipeline_stages": (
        COUNTER, "Pipelined parquet decode stages completed "
        "(decode/upload/unpack)", ("stage",)),
    "tpu_pq_pipeline_bytes": (
        COUNTER, "Bytes through the pipelined parquet decode stages",
        ("stage",)),
    "tpu_serve_admissions": (
        COUNTER, "Serving-layer admission decisions by verdict "
        "(admit/queue/reject — serve/scheduler.py)", ("verdict",)),
    "tpu_serve_queue": (
        COUNTER, "Fair-queue lifecycle ops (enqueue/dequeue/timeout)",
        ("op",)),
    "tpu_serve_queue_depth": (
        GAUGE, "Queries currently waiting in the serving queue (all "
        "sessions)", ()),
    "tpu_serve_queue_wait_seconds": (
        HISTOGRAM, "Queued duration per admitted query", ()),
    "tpu_serve_plan_cache": (
        COUNTER, "Shared plan-cache lookups by outcome (hit/miss) — one "
        "analysis/compile-prep per plan digest across sessions", ("op",)),
    "tpu_hbm_reserved_bytes": (
        GAUGE, "Outstanding admission reservations (admitted peak-HBM "
        "forecasts not yet released)", ()),
    "tpu_oom_retries": (
        COUNTER, "OOM recovery actions by op and kind (retry = spill + "
        "re-attempt, split = escalation to half capacity, requeue = the "
        "serve scheduler re-admitting with an inflated forecast — "
        "memory/retry.py; the oom_retry event's live twin). A nonzero "
        "rate means forecasts are wrong or the budget is tight; the "
        "watchdog's retry-storm rule alerts on a burst.", ("op", "kind")),
    "tpu_batch_splits": (
        COUNTER, "Split-and-retry halvings by op (the batch_split "
        "event's live twin): each one means the op completed on "
        "half-capacity programs instead of dying", ("op",)),
    "tpu_shuffle_fetch_retries": (
        COUNTER, "Network shuffle fetch transient-failure outcomes "
        "(retry = backed off and re-fetched, failure = retries "
        "exhausted, FetchFailedError raised — shuffle/network.py)",
        ("outcome",)),
    "tpu_donated_bytes": (
        COUNTER, "Input-plane bytes donated to XLA per certified "
        "compile site (plugin/donation.py; the donation event's live "
        "twin). Donated planes' HBM is reused for program outputs/"
        "temps — zero here with donation enabled means no dispatch "
        "qualified (batches not exclusive, dict columns, or the site "
        "is uncertified).", ("site",)),
    "tpu_hbm_bytes": (
        GAUGE, "Device-live HBM bytes attributed per owning op by the "
        "per-buffer ledger (memory/ledger.py; the buffer_alloc/"
        "buffer_free events' live twin). Covers spillable handles AND "
        "scan-cache entries — the attributed decomposition of "
        "tpu_hbm_device_bytes plus cache residency; '(unattributed)' "
        "rows are buffers created outside any op scope.", ("op",)),
    "tpu_hbm_leaked_buffers": (
        COUNTER, "Buffers the leak sentinel flagged as outliving their "
        "owning query (memory/ledger.py sweep at query end; the "
        "heap_snapshot event's live twin). Any nonzero value is a "
        "lifecycle bug — the /status heap block names the owners.", ()),
}

#: event type -> the live metric family that carries the same signal, so
#: the offline (events.EVENT_TYPES) and online planes can never drift: a
#: new event type without a live twin fails tests/test_torch_obs.py.
EVENT_BACKED_METRICS: Dict[str, str] = {
    "query_start": "tpu_queries",
    "query_end": "tpu_queries",
    "plan_tagged": "tpu_queries",
    "plan_analysis": "tpu_queries",
    "op_span": "tpu_op_time_seconds",
    "op_batch": "tpu_op_rows",
    "compile_miss": "tpu_compile_misses",
    "program_cost": "tpu_compile_seconds",
    "hlo_summary": "tpu_hlo_scatter_programs",
    "transfer": "tpu_transfer_bytes",
    "spill": "tpu_spill_bytes",
    "shuffle_write": "tpu_shuffle_bytes",
    "shuffle_fetch": "tpu_shuffle_bytes",
    "scan_cache": "tpu_scan_cache_ops",
    "program_cache": "tpu_program_cache",
    "alert": "tpu_watchdog_alerts",
    "agg_strategy": "tpu_agg_strategy",
    "join_strategy": "tpu_join_strategy",
    "pq_pipeline": "tpu_pq_pipeline_stages",
    "admission": "tpu_serve_admissions",
    "queue": "tpu_serve_queue",
    "oom_retry": "tpu_oom_retries",
    "batch_split": "tpu_batch_splits",
    "donation": "tpu_donated_bytes",
    "buffer_alloc": "tpu_hbm_bytes",
    "buffer_free": "tpu_hbm_bytes",
    "heap_snapshot": "tpu_hbm_leaked_buffers",
}


def _label_values(name: str, labels: Dict[str, str]) -> tuple:
    """Order **labels by the metric's declared label names (missing
    labels render empty, unknown labels raise — a typo at an emit site
    must fail loudly in tests, not mint a new series silently)."""
    declared = METRICS[name][2]
    unknown = set(labels) - set(declared)
    if unknown:
        raise ValueError(f"{name}: undeclared label(s) {sorted(unknown)}")
    return tuple(str(labels.get(k, "")) for k in declared)


class MetricsRegistry:
    """Thread-safe named counters/gauges/histograms + open-span table.

    One lock guards everything; every method is O(1)-ish and NEVER calls
    out of this module (leaf-lock discipline — see module docstring)."""

    def __init__(self):
        self._lock = ordered_lock("obs.registry")
        # name -> label-values tuple -> float
        self._vals: Dict[str, Dict[tuple, float]] = {
            name: {} for name in METRICS
        }
        # histograms: name -> labels -> [bucket counts..., +inf, sum]
        self._hist: Dict[str, Dict[tuple, List[float]]] = {
            name: {} for name, (kind, _, _) in METRICS.items()
            if kind == HISTOGRAM
        }
        # open operator spans (the stall watchdog's sample set):
        # token -> (op, section, start_ns)
        self._spans: Dict[int, Tuple[str, str, int]] = {}
        self._span_seq = 0
        # recent compile misses (ts_ns, site) for live storm detection
        self._miss_ring: deque = deque(maxlen=4096)
        # recent OOM recovery actions (ts_ns, op) — the retry-storm
        # watchdog rule's window (same shape as the miss ring)
        self._retry_ring: deque = deque(maxlen=4096)

    # -- writes ------------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        key = _label_values(name, labels)
        with self._lock:
            d = self._vals[name]
            d[key] = d.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        key = _label_values(name, labels)
        with self._lock:
            self._vals[name][key] = float(value)

    def set_gauge_max(self, name: str, value: float, **labels: str) -> None:
        """High-water-mark gauge write: keeps the larger of the current
        and new value under ONE lock acquisition (a read-then-set pair
        would race concurrent emitters)."""
        key = _label_values(name, labels)
        with self._lock:
            d = self._vals[name]
            cur = d.get(key)
            if cur is None or value > cur:
                d[key] = float(value)

    def rebase_gauge(self, name: str) -> None:
        """Drop every labeled row of a high-water gauge so the next
        ``set_gauge_max`` writes record a fresh window's peak — the
        bench's per-shape rebase (the BufferCatalog peak-watermark
        pattern: the gauge is a monotonic process-wide max, and a
        window owner resetting it between windows is the only way a
        later window's reading is its OWN peak, not an earlier,
        hungrier one's)."""
        with self._lock:
            self._vals[name].clear()

    def observe(self, name: str, value: float, **labels: str) -> None:
        key = _label_values(name, labels)
        with self._lock:
            h = self._hist[name].get(key)
            if h is None:
                h = self._hist[name][key] = [0.0] * (len(_BUCKETS) + 2)
            for i, ub in enumerate(_BUCKETS):
                if value <= ub:
                    h[i] += 1
            h[len(_BUCKETS)] += 1          # +Inf / count
            h[len(_BUCKETS) + 1] += value  # sum

    # -- open spans (stall detection) --------------------------------------
    def span_open(self, op: str, section: str = "",
                  start_ns: Optional[int] = None) -> int:
        with self._lock:
            self._span_seq += 1
            token = self._span_seq
            self._spans[token] = (
                op, section, start_ns or time.perf_counter_ns())
            return token

    def span_close(self, token: int) -> None:
        with self._lock:
            self._spans.pop(token, None)

    def open_spans(self) -> List[Tuple[str, str, int]]:
        with self._lock:
            return list(self._spans.values())

    # -- compile-miss ring (live storm detection) --------------------------
    def note_compile_miss(self, site: str,
                          ts_ns: Optional[int] = None) -> None:
        self.inc("tpu_compile_misses", 1, site=site)
        with self._lock:
            self._miss_ring.append((ts_ns or time.perf_counter_ns(), site))

    def recent_compile_misses(self) -> List[Tuple[int, str]]:
        with self._lock:
            return list(self._miss_ring)

    # -- OOM-retry ring (live retry-storm detection) -----------------------
    def note_oom_retry(self, op: str, kind: str = "retry",
                       ts_ns: Optional[int] = None) -> None:
        self.inc("tpu_oom_retries", 1, op=op, kind=kind)
        with self._lock:
            self._retry_ring.append(
                (ts_ns or time.perf_counter_ns(), op))

    def recent_oom_retries(self) -> List[Tuple[int, str]]:
        with self._lock:
            return list(self._retry_ring)

    # -- reads -------------------------------------------------------------
    def value(self, name: str, **labels: str) -> float:
        key = _label_values(name, labels)
        with self._lock:
            return self._vals[name].get(key, 0.0)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{name: {"k=v,k=v": value}} — the JSON-friendly view /status
        embeds (histograms report their count and sum)."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for name, series in self._vals.items():
                if METRICS[name][0] == HISTOGRAM:
                    continue
                if series:
                    declared = METRICS[name][2]
                    out[name] = {
                        ",".join(f"{k}={v}" for k, v in zip(declared, key)):
                        val for key, val in series.items()
                    }
            for name, series in self._hist.items():
                if series:
                    declared = METRICS[name][2]
                    out[name] = {}
                    for key, h in series.items():
                        lbl = ",".join(
                            f"{k}={v}" for k, v in zip(declared, key))
                        out[name][lbl + ("|count" if lbl else "count")] = \
                            h[len(_BUCKETS)]
                        out[name][lbl + ("|sum" if lbl else "sum")] = \
                            h[len(_BUCKETS) + 1]
        return out

    # -- Prometheus text exposition (version 0.0.4) ------------------------
    def render_prometheus(self) -> str:
        """Every declared family renders its # HELP / # TYPE header even
        with zero samples (so scrapers — and the completeness check —
        see the full catalog from the first scrape)."""
        def esc(v: str) -> str:
            return v.replace("\\", "\\\\").replace('"', '\\"') \
                    .replace("\n", "\\n")

        def num(value: float) -> str:
            # FULL precision: %g's 6 significant digits would quantize a
            # byte counter past ~1e6 and make small scrape-to-scrape
            # deltas vanish under Prometheus rate(); repr is the
            # shortest exact round-trip (integers render bare)
            if float(value).is_integer() and abs(value) < 1e15:
                return str(int(value))
            return repr(float(value))

        def fmt(name: str, key: tuple, declared: tuple, value: float,
                extra: str = "") -> str:
            pairs = [f'{k}="{esc(v)}"'
                     for k, v in zip(declared, key) if v != ""]
            if extra:
                pairs.append(extra)
            lbl = "{" + ",".join(pairs) + "}" if pairs else ""
            return f"{name}{lbl} {num(value)}"

        lines: List[str] = []
        with self._lock:
            for name in sorted(METRICS):
                kind, help_, declared = METRICS[name]
                ename = name + ("_total" if kind == COUNTER else "")
                lines.append(f"# HELP {ename} {help_}")
                lines.append(f"# TYPE {ename} {kind}")
                if kind == HISTOGRAM:
                    for key, h in sorted(self._hist[name].items()):
                        for i, ub in enumerate(_BUCKETS):
                            lines.append(fmt(
                                name + "_bucket", key, declared, h[i],
                                extra=f'le="{ub:g}"'))
                        lines.append(fmt(
                            name + "_bucket", key, declared,
                            h[len(_BUCKETS)], extra='le="+Inf"'))
                        lines.append(fmt(name + "_count", key, declared,
                                         h[len(_BUCKETS)]))
                        lines.append(fmt(name + "_sum", key, declared,
                                         h[len(_BUCKETS) + 1]))
                    continue
                for key, value in sorted(self._vals[name].items()):
                    lines.append(fmt(ename, key, declared, value))
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Process-global active registry — the events.py install pattern: emit
# sites live deep in the engine where no session handle exists, so the
# observability plane INSTALLS the registry; with nothing installed the
# fast path is one module-global boolean read.
# ---------------------------------------------------------------------------
_ENABLED = False
_ACTIVE: Optional[MetricsRegistry] = None


def enabled() -> bool:
    """The hot-path guard: True only while a registry is installed. Call
    sites that would build labels/compute values check this FIRST."""
    return _ENABLED


def active() -> Optional[MetricsRegistry]:
    return _ACTIVE


def install(registry: MetricsRegistry) -> None:
    global _ENABLED, _ACTIVE
    _ACTIVE = registry
    _ENABLED = True


def uninstall() -> None:
    global _ENABLED, _ACTIVE
    _ACTIVE = None
    _ENABLED = False


# -- module-level emit helpers (no-ops when nothing is installed) -----------
def inc(name: str, value: float = 1.0, **labels: str) -> None:
    if not _ENABLED:
        return
    reg = _ACTIVE
    if reg is not None:
        reg.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels: str) -> None:
    if not _ENABLED:
        return
    reg = _ACTIVE
    if reg is not None:
        reg.set_gauge(name, value, **labels)


def observe(name: str, value: float, **labels: str) -> None:
    if not _ENABLED:
        return
    reg = _ACTIVE
    if reg is not None:
        reg.observe(name, value, **labels)
