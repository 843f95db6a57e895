"""Stall / pressure / storm / leak watchdog over the live registry.

Counterpart of ``spark_rapids_tpu/obs/watchdog.py``, every rule ported:

  * **stall** — an operator span has been OPEN longer than
    ``watchdog.stallThresholdMs`` (a hung device wait, a wedged host
    decode, a deadlocked semaphore);
  * **hbm_pressure** — the BufferCatalog device-byte watermark is above
    ``watchdog.hbmPressureFraction`` of the shared budget
    (derive_hbm_budget — the SAME derivation the spiller uses);
  * **buffer_leak** — the ledger's query-end sentinel flagged buffers
    that outlived their owning query;
  * **retry_storm** — at least ``watchdog.retryStorm.threshold`` OOM
    recovery actions on one op inside the window;
  * **recompile_storm** — at least ``sql.analysis.recompileStorm
    .threshold`` compile misses on ONE site within
    ``watchdog.recompileStorm.windowMs``. The port's compile misses are
    its kernel-library builds (``ops/_cuda_build.note_compile_miss``: one
    per ``nvcc`` run, the site the library's stem).

Every alert is surfaced three ways: a ``log.warning``, an ``alert``
event in the event log (so offline traces show when the watchdog
fired), and the ``alerts`` list in ``/status``. An alert key stays
ACTIVE while its condition holds — one alert per episode, not one per
sample tick.

:func:`replay_alerts` runs the same rules over a recorded event log
(``tools/tpu_profile.py --alerts``) so thresholds can be tuned from
recordings without re-running anything.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from .. import events as _events
from .registry import MetricsRegistry

log = logging.getLogger("spark_rapids_tpu_torch.obs")

STALL = "stall"
HBM_PRESSURE = "hbm_pressure"
RECOMPILE_STORM = "recompile_storm"
RETRY_STORM = "retry_storm"
BUFFER_LEAK = "buffer_leak"


def _default_storm_threshold() -> int:
    # ONE home for the storm count: the conf entry's declared default
    from ..conf import ANALYSIS_STORM_THRESHOLD

    return ANALYSIS_STORM_THRESHOLD.default


@dataclasses.dataclass(frozen=True)
class WatchdogRules:
    """Thresholds shared by the live sampler and the offline replay."""

    stall_ns: int = 30_000 * 1_000_000
    pressure_fraction: float = 0.85
    storm_threshold: int = dataclasses.field(
        default_factory=_default_storm_threshold)
    storm_window_ns: int = 10_000 * 1_000_000
    #: OOM-retry burst threshold (per op, inside storm_window_ns): a
    #: storm means forecasts are systematically wrong or the budget is
    #: too tight for the traffic — the query completes, but every batch
    #: pays spill + backoff (+ half-capacity recompiles)
    retry_storm_threshold: int = 8

    @classmethod
    def from_conf(cls, conf_) -> "WatchdogRules":
        from ..conf import (
            ANALYSIS_STORM_THRESHOLD,
            WATCHDOG_PRESSURE_FRACTION,
            WATCHDOG_RETRY_STORM_THRESHOLD,
            WATCHDOG_STALL_MS,
            WATCHDOG_STORM_WINDOW_MS,
        )

        return cls(
            stall_ns=int(conf_.get(WATCHDOG_STALL_MS)) * 1_000_000,
            pressure_fraction=conf_.get(WATCHDOG_PRESSURE_FRACTION),
            # ONE storm definition engine-wide: the live window reuses the
            # static analyzer's per-site signature threshold
            storm_threshold=conf_.get(ANALYSIS_STORM_THRESHOLD),
            storm_window_ns=int(
                conf_.get(WATCHDOG_STORM_WINDOW_MS)) * 1_000_000,
            retry_storm_threshold=conf_.get(
                WATCHDOG_RETRY_STORM_THRESHOLD),
        )


@dataclasses.dataclass
class Alert:
    kind: str        # stall | hbm_pressure | recompile_storm |
                     # retry_storm | buffer_leak
    detail: str      # what tripped (op name, site, watermark source)
    value: float     # the measured quantity (ns, bytes, miss count)
    threshold: float  # the rule it crossed
    ts: int          # perf_counter_ns at detection

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        if self.kind == STALL:
            return (f"stall: {self.detail} span open "
                    f"{self.value / 1e9:.1f}s "
                    f"(threshold {self.threshold / 1e9:.1f}s)")
        if self.kind == HBM_PRESSURE:
            return (f"hbm_pressure: {self.detail} at "
                    f"{self.value / 1e6:.1f}MB, over "
                    f"{self.threshold / 1e6:.1f}MB")
        if self.kind == RETRY_STORM:
            return (f"retry_storm: op {self.detail} hit {self.value:g} "
                    f"OOM recovery actions in window "
                    f"(threshold {self.threshold:g}) — forecasts or the "
                    "HBM budget need attention")
        if self.kind == BUFFER_LEAK:
            return (f"buffer_leak: {self.value:g} buffer"
                    f"{'' if self.value == 1 else 's'} outlived the "
                    f"owning query — {self.detail}")
        return (f"recompile_storm: site {self.detail} compiled "
                f"{self.value:g} times in window "
                f"(threshold {self.threshold:g})")


class Watchdog:
    """Samples the registry (and the BufferCatalog) on an interval.

    ``check_now()`` is the deterministic single-tick entry point the
    tests (and the optional background thread) drive; it returns only
    NEWLY raised alerts. The same condition re-alerts only after it
    clears — a 60s stall is one alert, not sixty."""

    def __init__(self, registry: MetricsRegistry, rules: WatchdogRules,
                 interval_s: float = 1.0,
                 budget: Optional[int] = None,
                 conf_budget: Optional[int] = None, history: int = 64):
        self.registry = registry
        self.rules = rules
        self.interval_s = interval_s
        self._budget = budget  # hard override (tests / tooling)
        # fallback when the LIVE catalog has no budget (e.g. it was
        # lazily created under a default conf while the session that
        # enabled the watchdog set memory.hbm.budgetBytes) — without it
        # the pressure rule would silently never fire in that setup
        self._conf_budget = conf_budget
        self._alerts: deque = deque(maxlen=history)
        self._active: Set[tuple] = set()
        self._episode = 0  # flight-recorder dump counter (one per batch)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- one sample tick ---------------------------------------------------
    def check_now(self, now_ns: Optional[int] = None) -> List[Alert]:
        now = now_ns if now_ns is not None else time.perf_counter_ns()
        found: Dict[tuple, Alert] = {}

        # stalls: operator spans still open past the threshold
        for op, section, start in self.registry.open_spans():
            age = now - start
            if age >= self.rules.stall_ns:
                name = op + ("." + section if section else "")
                found[(STALL, op, start)] = Alert(
                    STALL, name, age, self.rules.stall_ns, now)

        # HBM pressure: live watermark vs the shared budget
        from ..memory.catalog import BufferCatalog

        cat = BufferCatalog.get()
        # precedence: explicit override, then the budget the SPILLER
        # actually enforces (the catalog's), then the watchdog conf's
        # own derivation as a last resort
        budget = self._budget
        if budget is None:
            budget = cat.budget if cat.budget else self._conf_budget
        if budget:
            limit = self.rules.pressure_fraction * budget
            dev = cat.device_bytes
            if dev >= limit:
                detail = "BufferCatalog device watermark"
                # the HBM ledger (when armed) knows WHO holds the bytes —
                # an actionable alert names the owners, not just the level
                owners = cat.ledger.top_owners(3)
                if owners:
                    detail += " — top owners: " + ", ".join(
                        f"{op} {b / 1e6:.1f}MB" for op, b in owners)
                found[(HBM_PRESSURE,)] = Alert(
                    HBM_PRESSURE, detail, dev, limit, now)

        # buffer leaks: the ledger's query-end sentinel flagged live
        # buffers that outlived their owning query — the alert stays
        # active until the leaked buffers are actually freed
        leaks = cat.ledger.live_leaks()
        if leaks:
            top = sorted(
                leaks, key=lambda r: -(r.get("bytes") or 0))[:3]
            detail = ", ".join(
                f"{r.get('op') or '(unattributed)'} "
                f"{(r.get('bytes') or 0) / 1e6:.1f}MB "
                f"(query {r.get('query_id')})" for r in top)
            found[(BUFFER_LEAK,)] = Alert(
                BUFFER_LEAK, detail, len(leaks), 1, now)

        # live recompile storm: misses per site inside the window
        lo = now - self.rules.storm_window_ns
        per_site: Dict[str, int] = {}
        for ts, site in self.registry.recent_compile_misses():
            if ts >= lo:
                per_site[site] = per_site.get(site, 0) + 1
        for site, n in per_site.items():
            if n >= self.rules.storm_threshold:
                found[(RECOMPILE_STORM, site)] = Alert(
                    RECOMPILE_STORM, site, n,
                    self.rules.storm_threshold, now)

        # live retry storm: OOM recovery actions per op inside the window
        per_op: Dict[str, int] = {}
        for ts, op in self.registry.recent_oom_retries():
            if ts >= lo:
                per_op[op] = per_op.get(op, 0) + 1
        for op, n in per_op.items():
            if n >= self.rules.retry_storm_threshold:
                found[(RETRY_STORM, op)] = Alert(
                    RETRY_STORM, op, n,
                    self.rules.retry_storm_threshold, now)

        new: List[Alert] = []
        with self._lock:
            for key, alert in found.items():
                if key not in self._active:
                    self._active.add(key)
                    self._alerts.append(alert)
                    new.append(alert)
            # conditions that cleared may fire again as a fresh episode
            self._active &= set(found)
        for alert in new:
            log.warning("watchdog %s", alert.describe())
            self.registry.inc("tpu_watchdog_alerts", 1, kind=alert.kind)
            if _events.enabled():
                _events.emit("alert", kind=alert.kind, detail=alert.detail,
                             value=alert.value, threshold=alert.threshold)
        if new and _events.enabled():
            # flight recorder: in ring-only mode (eventLog.flightRecorder
            # .enabled) each alert episode dumps the ring — including the
            # alert events just emitted — to eventLog.dir for post-hoc
            # diagnosis; a streaming logger returns None (already durable)
            with self._lock:
                self._episode += 1
                episode = self._episode
            path = _events.flight_dump(episode)
            if path:
                log.warning("watchdog flight record: %s", path)
        return new

    def alerts(self) -> List[Alert]:
        with self._lock:
            return list(self._alerts)

    # -- background thread -------------------------------------------------
    def start(self) -> None:
        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.check_now()
                except Exception:  # pragma: no cover - never kill the host
                    log.exception("watchdog tick failed")

        # the thread-slot transition runs under the lock: two unserialized
        # start() calls otherwise both see None and spawn two tick threads
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=run, name="srtpu-watchdog", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        # claim the thread under the lock, join OUTSIDE it: the tick
        # thread takes the same lock in check_now, so joining while
        # holding it would stall stop() behind an in-flight tick
        with self._lock:
            t = self._thread
            self._thread = None
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5)


# ---------------------------------------------------------------------------
# Offline replay: the same rules over a PR-5 event log, so thresholds are
# tuned against recordings (tools/tpu_profile.py --alerts).
# ---------------------------------------------------------------------------
def replay_alerts(events: List[dict], rules: WatchdogRules,
                  budget: Optional[int] = None) -> List[Alert]:
    """Alerts the watchdog WOULD have raised over a recorded run.

    Mapping from the live sampler (which sees open spans / live
    watermarks) to the log (which records closed spans / spill events):

      * stall            — any ``op_span`` whose dur >= stall_ns (the
                           span was necessarily open that long);
      * hbm_pressure     — any ``spill``/``unspill`` whose live
                           ``device_bytes`` watermark crossed the
                           pressure line (budget from the log's
                           ``plan_analysis`` events unless overridden);
      * recompile_storm  — per-site sliding window over
                           ``compile_miss`` events; one alert per
                           episode (the count must drop below the
                           threshold before the same site alerts again);
      * retry_storm      — the same sliding-window/episode rule over
                           ``oom_retry`` events per op (the live rule
                           samples the registry's retry ring);
      * buffer_leak      — any ``heap_snapshot`` with ``leaked > 0``
                           (the ledger's query-end sentinel fired); one
                           alert per episode, cleared by a clean
                           snapshot.

    When the log carries ledger events (``buffer_alloc``/``buffer_free``
    plus bid-stamped spills), the pressure alert reconstructs per-op
    device residency and names the top-3 owning ops at the moment the
    watermark crossed the line — the replay twin of the live alert's
    ``top_owners`` detail.
    """
    out: List[Alert] = []
    site_win: Dict[str, deque] = {}
    site_storming: Dict[str, bool] = {}
    retry_win: Dict[str, deque] = {}
    retry_storming: Dict[str, bool] = {}
    pressure_active = False
    leak_active = False
    # bid -> (op, bytes) for device-resident ledger buffers, so the
    # pressure alert can name owners from the recording alone
    heap: Dict[object, tuple] = {}
    off_device: Set[object] = set()
    for r in events:
        ev = r.get("event")
        ts = r.get("ts", 0)
        if ev == "plan_analysis" and budget is None:
            budget = r.get("budget")
        elif ev == "op_span":
            # host lane only, matching the live sampler (which watches
            # op_timed's open-span table): a deviceSync log carries a
            # device-wait twin of the same episode — counting both would
            # replay one live stall as two alerts
            if r.get("lane", "host") != "host":
                continue
            dur = r.get("dur") or 0
            if dur >= rules.stall_ns:
                name = r.get("op", "?") + (
                    "." + r["section"] if r.get("section") else "")
                out.append(Alert(STALL, name, dur, rules.stall_ns, ts))
        elif ev == "spill":
            bid = r.get("bid")
            if bid is not None and bid in heap:
                if r.get("kind") == "device_to_host":
                    off_device.add(bid)
                elif r.get("kind") == "unspill":
                    off_device.discard(bid)
            if not budget:
                continue
            limit = rules.pressure_fraction * budget
            dev = r.get("device_bytes") or 0
            if dev >= limit and not pressure_active:
                detail = "BufferCatalog device watermark"
                by_op: Dict[str, int] = {}
                for hbid, (hop, hbytes) in heap.items():
                    if hbid not in off_device:
                        by_op[hop] = by_op.get(hop, 0) + hbytes
                owners = sorted(
                    by_op.items(), key=lambda kv: -kv[1])[:3]
                if owners:
                    detail += " — top owners: " + ", ".join(
                        f"{op} {b / 1e6:.1f}MB" for op, b in owners)
                out.append(Alert(HBM_PRESSURE, detail, dev, limit, ts))
            pressure_active = dev >= limit
        elif ev == "buffer_alloc":
            if r.get("kind") != "reservation":
                heap[r.get("bid")] = (
                    r.get("op") or "(unattributed)", r.get("bytes") or 0)
        elif ev == "buffer_free":
            heap.pop(r.get("bid"), None)
            off_device.discard(r.get("bid"))
        elif ev == "heap_snapshot":
            leaked = r.get("leaked") or 0
            if leaked and not leak_active:
                out.append(Alert(
                    BUFFER_LEAK, f"query {r.get('query_id')}",
                    leaked, 1, ts))
            leak_active = leaked > 0
        elif ev == "compile_miss":
            site = r.get("site", "?")
            win = site_win.setdefault(site, deque())
            win.append(ts)
            lo = ts - rules.storm_window_ns
            while win and win[0] < lo:
                win.popleft()
            if len(win) >= rules.storm_threshold:
                if not site_storming.get(site):
                    out.append(Alert(
                        RECOMPILE_STORM, site, len(win),
                        rules.storm_threshold, ts))
                site_storming[site] = True
            else:
                site_storming[site] = False
        elif ev == "oom_retry":
            op = r.get("op", "?")
            win = retry_win.setdefault(op, deque())
            win.append(ts)
            lo = ts - rules.storm_window_ns
            while win and win[0] < lo:
                win.popleft()
            if len(win) >= rules.retry_storm_threshold:
                if not retry_storming.get(op):
                    out.append(Alert(
                        RETRY_STORM, op, len(win),
                        rules.retry_storm_threshold, ts))
                retry_storming[op] = True
            else:
                retry_storming[op] = False
    return out
