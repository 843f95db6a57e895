"""Live observability plane: metrics registry, HTTP exporter, watchdog.

Counterpart of ``spark_rapids_tpu/obs/__init__.py``, the ONLINE half of
observability (the event log is the offline half):
``ensure_started(conf)`` idempotently installs the process-global
:class:`MetricsRegistry`, and — per conf — starts the ``/metrics`` +
``/status`` HTTP exporter thread and the watchdog. Everything here
follows the events.py zero-overhead contract: with the plane off (the
default) every engine emit site pays one module-global boolean read
(``enabled()``) and nothing else — no locks, no dicts, no threads.

This module is also the facade the engine emits through: the helpers
below (``note_op_batch``, ``add_op_time``, ``note_query_start``/``end``,
span open/close, the OOM-retry twins) update the registry AND the
per-query progress tracker in one call so call sites stay one-liners.
``note_compile_miss``, ``note_program_cost`` and ``note_hlo_summary``
are kept for the shared schema; eager PyTorch compiles no programs, so
nothing in the port calls them.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from .progress import ProgressTracker, tracker
from .registry import (
    EVENT_BACKED_METRICS,
    METRICS,
    MetricsRegistry,
    active,
    enabled,
    inc,
    install,
    observe,
    set_gauge,
    uninstall,
)
from .watchdog import Alert, Watchdog, WatchdogRules, replay_alerts
from ..utils.locks import ordered_lock as _ordered_lock

__all__ = [
    "Alert", "EVENT_BACKED_METRICS", "METRICS", "MetricsRegistry",
    "ObsPlane", "ProgressTracker", "Watchdog", "WatchdogRules",
    "active", "add_op_time", "enabled", "ensure_started", "inc",
    "install", "note_batch_split", "note_compile_miss",
    "note_hlo_summary", "note_oom_retry",
    "note_op_batch", "note_program_cost",
    "note_query_end", "note_query_start", "observe", "plane",
    "replay_alerts",
    "set_gauge", "shutdown", "span_close", "span_open", "tracker",
    "uninstall",
]


# ---------------------------------------------------------------------------
# Engine-facing emit helpers (all no-ops while the plane is off; callers
# still guard on enabled() before computing anything expensive)
# ---------------------------------------------------------------------------
def add_op_time(op: str, lane: str, dur_ns: int) -> None:
    reg = active()
    if reg is None:
        return
    reg.inc("tpu_op_time_seconds", dur_ns / 1e9, op=op, lane=lane)
    if lane == "host":
        reg.observe("tpu_op_batch_seconds", dur_ns / 1e9, op=op)


def span_open(op: str, section: str = "") -> Optional[int]:
    reg = active()
    return reg.span_open(op, section) if reg is not None else None


def span_close(token: Optional[int]) -> None:
    reg = active()
    if reg is not None and token is not None:
        reg.span_close(token)


def note_op_batch(op: str, rows: Optional[int], nbytes: int) -> None:
    reg = active()
    if reg is None:
        return
    reg.inc("tpu_op_batches", 1, op=op)
    if rows:
        reg.inc("tpu_op_rows", rows, op=op)
    reg.inc("tpu_op_bytes", nbytes, op=op)
    tracker().note_batch(op, rows, nbytes)


def note_compile_miss(site: str) -> None:
    reg = active()
    if reg is not None:
        reg.note_compile_miss(site)


def note_oom_retry(op: str, kind: str = "retry") -> None:
    """Live twin of the oom_retry event (memory/retry.py): counter plus
    the ring the watchdog's retry-storm window samples."""
    reg = active()
    if reg is not None:
        reg.note_oom_retry(op, kind)


def note_batch_split(op: str) -> None:
    """Live twin of the batch_split event."""
    reg = active()
    if reg is not None:
        reg.inc("tpu_batch_splits", 1, op=op)


def note_program_cost(site: str, trace_s: float, compile_s: float,
                      temp_bytes: Optional[int] = None) -> None:
    """Live twins of the program_cost event (xla_cost.py): compile
    seconds by site+phase, and the largest-temp-allocation high-water
    gauge (None when the backend's memory_analysis reported nothing)."""
    reg = active()
    if reg is None:
        return
    reg.inc("tpu_compile_seconds", trace_s, site=site, phase="trace")
    reg.inc("tpu_compile_seconds", compile_s, site=site, phase="compile")
    if temp_bytes is not None:
        reg.set_gauge_max("tpu_program_temp_bytes", temp_bytes, site=site)


def note_hlo_summary(site: str, scatter_count: int,
                     top_fusion_bytes: int) -> None:
    """Live twins of the hlo_summary event (hlo.py): scatter-program
    counter per site (incremented once per program containing any
    scatter-classified instruction) and the largest-single-fusion byte
    high-water gauge."""
    reg = active()
    if reg is None:
        return
    if scatter_count:
        reg.inc("tpu_hlo_scatter_programs", 1, site=site)
    if top_fusion_bytes:
        reg.set_gauge_max("tpu_hlo_top_fusion_bytes", top_fusion_bytes,
                          site=site)


def note_query_start(query_id, plan_digest: str = "",
                     rows_forecast: Optional[Dict[str, int]] = None,
                     batches_forecast: Optional[Dict[str, int]] = None
                     ) -> None:
    reg = active()
    if reg is None:
        return
    reg.inc("tpu_queries", 1, state="started")
    tracker().begin(query_id, plan_digest, rows_forecast,
                    batches_forecast)
    reg.set_gauge("tpu_queries_live", tracker().live_count())


def note_query_end(query_id, rows: Optional[int] = None,
                   error: bool = False) -> None:
    reg = active()
    if reg is None:
        return
    reg.inc("tpu_queries", 1, state="failed" if error else "finished")
    tracker().end(query_id, rows, error)
    reg.set_gauge("tpu_queries_live", tracker().live_count())


# ---------------------------------------------------------------------------
# The process-global plane: registry (+ exporter thread, + watchdog) —
# ONE per process no matter how many sessions ask (like BufferCatalog).
# ---------------------------------------------------------------------------
class ObsPlane:
    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.server = None     # MetricsServer when http.enabled
        self.watchdog: Optional[Watchdog] = None

    @property
    def address(self) -> Optional[str]:
        return self.server.address if self.server is not None else None


_PLANE: Optional[ObsPlane] = None
_PLANE_LOCK = _ordered_lock("obs.plane")


def plane() -> Optional[ObsPlane]:
    return _PLANE


def ensure_started(conf_) -> Optional[ObsPlane]:
    """Install the registry and start the conf'd threads (idempotent).

    Returns None — and starts NOTHING, installs NOTHING — unless one of
    metrics.live.enabled / metrics.http.enabled / watchdog.enabled is
    set: the off path must not even construct a registry (the CI obs
    job asserts no exporter thread and no registry with defaults)."""
    from ..conf import (
        LIVE_METRICS_ENABLED,
        METRICS_HTTP_ENABLED,
        METRICS_HTTP_HOST,
        METRICS_HTTP_PORT,
        WATCHDOG_ENABLED,
        WATCHDOG_INTERVAL_MS,
    )

    want_http = conf_.get(METRICS_HTTP_ENABLED)
    want_dog = conf_.get(WATCHDOG_ENABLED)
    if not (conf_.get(LIVE_METRICS_ENABLED) or want_http or want_dog):
        return None
    from ..memory.catalog import derive_hbm_budget

    global _PLANE
    with _PLANE_LOCK:
        if _PLANE is None:
            reg = MetricsRegistry()
            install(reg)
            _PLANE = ObsPlane(reg)
            reg.set_gauge("tpu_hbm_budget_bytes",
                          derive_hbm_budget(conf_) or 0)
        p = _PLANE
        if want_dog and p.watchdog is None:
            p.watchdog = Watchdog(
                p.registry, WatchdogRules.from_conf(conf_),
                interval_s=conf_.get(WATCHDOG_INTERVAL_MS) / 1e3,
                # pressure fallback when the live catalog carries no
                # budget of its own (lazily created under default conf)
                conf_budget=derive_hbm_budget(conf_))
            p.watchdog.start()
            if p.server is not None:  # late watchdog joins a live server
                p.server.watchdog = p.watchdog
        if want_http and p.server is None:
            from .server import MetricsServer

            p.server = MetricsServer(
                p.registry, tracker(), p.watchdog,
                host=conf_.get(METRICS_HTTP_HOST),
                port=int(conf_.get(METRICS_HTTP_PORT))).start()
    return _PLANE


def shutdown() -> None:
    """Stop threads, uninstall the registry, clear progress (tests /
    clean process exit). The WHOLE teardown holds _PLANE_LOCK so a
    concurrent ensure_started() cannot install a fresh plane halfway
    through and have it silently uninstalled underneath it (the server/
    watchdog threads never call ensure_started, so joining them under
    the lock cannot deadlock)."""
    global _PLANE
    with _PLANE_LOCK:
        p = _PLANE
        _PLANE = None
        if p is not None:
            if p.server is not None:
                p.server.stop()
            if p.watchdog is not None:
                p.watchdog.stop()
            uninstall()
            tracker().reset()
