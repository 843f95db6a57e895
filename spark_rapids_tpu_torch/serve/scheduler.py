"""Concurrent multi-query serving: admission control + fair scheduling.

Counterpart of ``spark_rapids_tpu/serve/scheduler.py``, letter for
letter in its conf keys, verdicts and events. The ``TpuSemaphore`` caps
how many threads hold the device, but nothing decides whether a plan
even FITS, queues work, or keeps one chatty session from starving the
rest. The :class:`QueryScheduler` connects two signals:

  * the static plan analyzer's **peak forecast**
    (``plugin/plananalysis.py``), or the HBM ledger's observed peak once
    the plan's digest has run (``memory/ledger.observed_peak``);
  * the live **BufferCatalog watermark + budget** (``memory/catalog.py``:
    ``hbm.budgetBytes``, or ``allocFraction`` of the card's memory).

Admission compares the two and answers **admit / queue / reject**:

  * *admit* — the forecast fits the live headroom (budget − watermark −
    outstanding reservations); the forecast is RESERVED in the catalog
    until release so concurrent admits can't promise the same bytes
    twice. A fixed budget therefore yields queueing, not OOMs.
  * *queue* — the forecast doesn't fit right now. The query waits in its
    session's FIFO; sessions drain round-robin (priority tiers first),
    so one heavy session can't starve the others. While queued, the
    submit thread has already done its host-side work (lowering,
    analysis, plan-cache fill), and after admission it host-prefetches
    its scans before taking the device semaphore, so host decode of
    query B overlaps device work of query A.
  * *reject* — the forecast exceeds the TOTAL budget (it can never fit)
    or the session's queue is at serve.maxQueueDepth; a named error,
    not a hang.

Progress guarantee: when nothing is admitted and nothing else waits, the
head ticket is admitted even if its forecast exceeds the headroom
("bypass") — residual catalog-tracked buffers (caches) must not wedge
the queue; the spiller then enforces the budget as it always has for a
single query. A plan the analyzer does not bound (no forecast) reserves
nothing. Reference analog: GpuSemaphore plus the admission/queueing
every production serving tier layers above it.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Deque, Dict, List, Optional

from .. import events as _events
from .. import obs as _obs
from ..conf import RapidsConf, conf
from ..utils.locks import ordered_lock

SERVE_ENABLED = conf(
    "spark.rapids.tpu.serve.enabled", False,
    "Route query execution through the process-wide QueryScheduler "
    "(serve/scheduler.py): plans are admitted by checking the static "
    "analyzer's peak-HBM forecast against the live BufferCatalog "
    "watermark and derived budget (admit / queue / reject-with-reason), "
    "queued per session with round-robin across sessions, and the "
    "admitted query host-prefetches its scans before taking the device "
    "semaphore so host decode overlaps the running query's device "
    "compute. Off (the default) keeps the single-session direct path.")
SERVE_MAX_QUEUE_DEPTH = conf(
    "spark.rapids.tpu.serve.maxQueueDepth", 64,
    "Per-session queue cap: a submit that would queue deeper than this "
    "is rejected with a named error instead of growing the backlog "
    "without bound (load shedding).", check=lambda v: (
        None if v > 0 else "must be positive"))
SERVE_QUEUE_TIMEOUT_MS = conf(
    "spark.rapids.tpu.serve.queueTimeoutMs", 0,
    "Give up on a queued query after this many milliseconds with a "
    "named error carrying its queue position and the admission reason; "
    "0 (the default) waits indefinitely.", conf_type=int,
    check=lambda v: None if v >= 0 else "must be >= 0")
SERVE_PRIORITY = conf(
    "spark.rapids.tpu.serve.priority", 0,
    "Scheduling priority of THIS session's queries (a per-session "
    "setting): higher-priority sessions' queues drain first; sessions "
    "at the same priority round-robin.", conf_type=int)
SERVE_ADMISSION_ENABLED = conf(
    "spark.rapids.tpu.serve.admission.enabled", True,
    "Forecast-based admission control. Off admits every submit "
    "immediately (fair queueing and pipelining still apply); on — the "
    "default — plans whose peak-HBM forecast exceeds the live headroom "
    "queue until reservations release, and plans that can never fit "
    "the total budget are rejected with a named reason.")


def _pretty_bytes(n: Optional[int]) -> str:
    if n is None:
        return "unbounded"
    if abs(n) >= 1 << 30:
        return f"{n / (1 << 30):.2f} GB"
    if abs(n) >= 1 << 20:
        return f"{n / (1 << 20):.1f} MB"
    return f"{n} B"


class ServeAdmissionRejected(RuntimeError):
    """The scheduler refused the query outright (reason in the message):
    forecast above the total budget, or queue depth at the cap."""


class ServeQueueTimeout(RuntimeError):
    """serve.queueTimeoutMs elapsed while the query waited for headroom."""


class Ticket:
    """One submitted query's trip through the scheduler."""

    __slots__ = ("session", "digest", "forecast", "priority", "seq",
                 "event", "enqueue_ns", "admit_ns", "reservation",
                 "verdict", "reason", "bypass", "forecast_source")

    def __init__(self, session: str, digest: str, forecast: Optional[int],
                 priority: int, seq: int,
                 forecast_source: str = "analyzer"):
        self.session = session
        self.digest = digest
        self.forecast = forecast
        #: where the forecast figure came from: "analyzer" (the static
        #: plan analyzer's peak) or "ledger" (a measured per-digest peak
        #: from the HBM ledger replaced the static guess — the
        #: measured-stats admission loop)
        self.forecast_source = forecast_source
        self.priority = priority
        self.seq = seq
        self.event = threading.Event()
        self.enqueue_ns = time.perf_counter_ns()
        self.admit_ns: Optional[int] = None
        self.reservation: Optional[int] = None
        self.verdict = ""
        self.reason = ""
        self.bypass = False


class QueryScheduler:
    """Process-wide fair scheduler with forecast-based admission.

    Usage (sql/session.py's serve path)::

        ticket = scheduler.acquire(session, priority, forecast, digest)
        try:
            ...host prefetch + drain (the semaphore caps device holders)
        finally:
            scheduler.release(ticket)
    """

    _instance: Optional["QueryScheduler"] = None
    _instance_lock = threading.Lock()

    def __init__(self, conf_: Optional[RapidsConf] = None):
        self.conf = conf_ or RapidsConf({})
        self._lock = ordered_lock("serve.scheduler")
        self._queues: Dict[str, Deque[Ticket]] = {}
        self._rr_order: List[str] = []  # round-robin rotation of sessions
        self._active: Dict[int, Ticket] = {}  # seq -> admitted ticket
        self._seq = 0
        # stats the stress test and /status read
        self.admitted = 0
        self.queued = 0
        self.rejected = 0
        self.timeouts = 0
        self.bypass_admissions = 0
        #: admitted queries that OOMed at runtime (a forecast MISS the
        #: static plane couldn't see) and were requeued once with their
        #: forecast inflated to the observed peak watermark
        self.oom_requeues = 0
        #: max simultaneously-admitted queries — proof the scheduler
        #: actually overlaps work (the pipelining claim is structural)
        self.peak_active = 0
        #: high-water mark of the summed admitted forecasts — the stress
        #: test's "zero admission-forecast violations" figure: with no
        #: bypass, it must never exceed the HBM budget
        self.peak_inflight_forecast = 0

    # -- singleton ---------------------------------------------------------
    @classmethod
    def get(cls, conf_: Optional[RapidsConf] = None) -> "QueryScheduler":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = QueryScheduler(conf_)
            return cls._instance

    @classmethod
    def instance(cls) -> Optional["QueryScheduler"]:
        """The live scheduler if any (the /status serve block peeks
        without creating one)."""
        return cls._instance

    @classmethod
    def reset(cls, conf_: Optional[RapidsConf] = None) -> "QueryScheduler":
        with cls._instance_lock:
            cls._instance = QueryScheduler(conf_)
            return cls._instance

    @classmethod
    @contextlib.contextmanager
    def admission_paused(cls):
        """Hold admission still and yield the number of admitted and
        waiting tickets (0 when there is no scheduler, and none can be
        created meanwhile). A session replaces the process's spill
        catalog under it, and only when that number is 0, so no admission
        reserves on a catalog that is being replaced."""
        with cls._instance_lock:
            sched = cls._instance
            if sched is None:
                yield 0
                return
            with sched._lock:
                yield len(sched._active) + sched._depth()

    # -- internals (call under self._lock) ---------------------------------
    def _catalog(self):
        from ..memory.catalog import BufferCatalog

        return BufferCatalog.get()

    def _headroom(self) -> tuple:
        """(budget, free) from ONE locked catalog snapshot — separate
        property reads could mix two catalog states mid-update. The
        budget falls back to the scheduler conf's own derivation when
        the lazily-created catalog carries none (the same fallback the
        watchdog's pressure rule uses); (None, None) = no budget,
        admission has nothing to check."""
        budget, device, reserved = self._catalog().admission_state()
        if budget is None:
            from ..memory.catalog import derive_hbm_budget

            budget = derive_hbm_budget(self.conf)
        if budget is None:
            return None, None
        return budget, budget - device - reserved

    def _inflight_forecast(self) -> int:
        return sum(t.forecast or 0 for t in self._active.values())

    def _depth(self, session: Optional[str] = None) -> int:
        if session is not None:
            q = self._queues.get(session)
            return len(q) if q else 0
        return sum(len(q) for q in self._queues.values())

    def _admit_locked(self, t: Ticket, bypass: bool = False) -> None:
        t.reservation = self._catalog().reserve(
            t.forecast or 0, label=f"{t.session}:{t.digest}")
        t.admit_ns = time.perf_counter_ns()
        t.verdict = "admit"
        t.bypass = bypass
        self._active[t.seq] = t
        self.admitted += 1
        self.peak_active = max(self.peak_active, len(self._active))
        if bypass:
            self.bypass_admissions += 1
        self.peak_inflight_forecast = max(
            self.peak_inflight_forecast, self._inflight_forecast())
        if _obs.enabled():
            _obs.inc("tpu_serve_admissions", 1, verdict="admit")
        t.event.set()

    def _emit_admission(self, t: Ticket, verdict: str,
                        free: Optional[int]) -> None:
        if _events.enabled():
            _events.emit("admission", session=t.session, digest=t.digest,
                         verdict=verdict, forecast_bytes=t.forecast,
                         free_bytes=free, reason=t.reason,
                         forecast_source=t.forecast_source)

    def _emit_queue(self, t: Ticket, op: str, depth: int,
                    wait_ns: int = 0) -> None:
        if _events.enabled():
            _events.emit("queue", session=t.session, op=op, depth=depth,
                         wait_ns=wait_ns)
            if op in ("dequeue", "timeout") and wait_ns:
                # the queue wait as a span on the session's serve lane —
                # Perfetto then shows queued/running interleaving per
                # session next to the per-op tracks
                _events.emit("op_span", op=f"serve {t.session}",
                             section="queue_wait", start=t.enqueue_ns,
                             dur=wait_ns, lane="host")
        if _obs.enabled():
            _obs.inc("tpu_serve_queue", 1, op=op)
            _obs.set_gauge("tpu_serve_queue_depth", self._depth())
            if op == "dequeue":
                _obs.observe("tpu_serve_queue_wait_seconds", wait_ns / 1e9)

    def _pump_locked(self) -> None:
        """Admit every waiting head that fits, honoring priority tiers
        and round-robin within a tier; called whenever headroom may have
        grown (a release), a query timed out of the queue, or a new
        ticket enqueued.

        Anti-starvation barrier: backfilling past a head that does not
        fit is allowed only for tickets that ARRIVED EARLIER (lower seq)
        or carry strictly higher priority — a steady stream of small
        later queries can therefore never starve a large-forecast head:
        once it is the oldest skipped ticket, no younger same-or-lower
        priority work admits, the active set drains, and it fits (or the
        nothing-running bypass takes it)."""
        while True:
            heads = [
                (s, self._queues[s][0]) for s in self._rr_order
                if self._queues.get(s)
            ]
            if not heads:
                return
            # stable sort keeps rr rotation order within a priority tier
            heads.sort(key=lambda st: -st[1].priority)
            _, free = self._headroom()
            admitted_one = False
            blocked: Optional[Ticket] = None  # oldest skipped head
            for s, t in heads:
                fits = free is None or (t.forecast or 0) <= free
                bypass = not fits and not self._active
                if not (fits or bypass):
                    if blocked is None or t.seq < blocked.seq:
                        blocked = t
                    continue
                if blocked is not None and t.seq > blocked.seq \
                        and t.priority <= blocked.priority:
                    continue  # no queue-jumping past a starving head
                self._queues[s].popleft()
                # rotate: s goes to the back of its tier
                self._rr_order.remove(s)
                self._rr_order.append(s)
                wait = time.perf_counter_ns() - t.enqueue_ns
                if bypass:
                    t.reason = (
                        f"bypass: nothing running, admitting despite "
                        f"forecast {_pretty_bytes(t.forecast)} > "
                        f"{_pretty_bytes(free)} free (spill will enforce "
                        "the budget)")
                self._admit_locked(t, bypass=bypass)
                self._emit_queue(t, "dequeue", self._depth(s), wait)
                self._emit_admission(t, "admit", free)
                admitted_one = True
                break  # re-evaluate headroom + rr order from scratch
            if not admitted_one:
                return

    # -- API ---------------------------------------------------------------
    def acquire(self, session: str, priority: int,
                forecast: Optional[int], digest: str,
                conf_: Optional[RapidsConf] = None,
                forecast_source: str = "analyzer") -> Ticket:
        """Block until the query is admitted (or raise). The caller runs
        its host prefetch + drain after this returns and MUST pair it
        with :meth:`release` in a finally.

        ``conf_``: the SUBMITTING session's conf — queue timeout, depth
        cap, and the admission on/off switch are per-submit settings
        read from it (the process-wide singleton was created by
        whichever session touched it first; silently pinning every
        later session to that session's limits would be a trap). Omitted
        = the scheduler's own conf."""
        conf_ = conf_ or self.conf
        admission_on = conf_.get(SERVE_ADMISSION_ENABLED)
        max_depth = conf_.get(SERVE_MAX_QUEUE_DEPTH)
        timeout_ms = conf_.get(SERVE_QUEUE_TIMEOUT_MS)
        with self._lock:
            self._seq += 1
            t = Ticket(session, digest, forecast, priority, self._seq,
                       forecast_source=forecast_source)
            if session not in self._rr_order:
                self._rr_order.append(session)
                self._queues.setdefault(session, collections.deque())
            budget, free = self._headroom()
            if (admission_on and budget is not None
                    and forecast is not None and forecast > budget):
                t.reason = (
                    f"forecast {_pretty_bytes(forecast)} exceeds the "
                    f"total HBM budget {_pretty_bytes(budget)} — the "
                    "plan can never fit; shrink it or raise "
                    "spark.rapids.tpu.memory.hbm.budgetBytes")
                self.rejected += 1
                if _obs.enabled():
                    _obs.inc("tpu_serve_admissions", 1, verdict="reject")
                self._emit_admission(t, "reject", free)
                raise ServeAdmissionRejected(
                    f"session {session} plan {digest}: {t.reason}")
            if self._depth(session) >= max_depth:
                t.reason = (
                    f"session queue depth {self._depth(session)} at "
                    f"spark.rapids.tpu.serve.maxQueueDepth={max_depth}")
                self.rejected += 1
                if _obs.enabled():
                    _obs.inc("tpu_serve_admissions", 1, verdict="reject")
                self._emit_admission(t, "reject", free)
                raise ServeAdmissionRejected(
                    f"session {session} plan {digest}: {t.reason}")
            fits = (not admission_on or free is None
                    or (forecast or 0) <= free)
            waiting_elsewhere = self._depth() > 0
            if self._depth(session) == 0 and fits and not waiting_elsewhere:
                # fast path: nothing queued anywhere and it fits — admit
                # on the submit thread (round-robin is vacuous here)
                t.reason = ("admission off" if not admission_on else
                            "no HBM budget derived" if free is None else
                            f"forecast {_pretty_bytes(forecast)} <= "
                            f"{_pretty_bytes(free)} free")
                self._admit_locked(t)
                self._emit_admission(t, "admit", free)
                return t
            if self._depth(session) == 0 and not fits and not self._active:
                # progress guarantee: nothing running, nothing can shrink
                # the watermark — admit and let the spiller enforce
                t.reason = (
                    f"bypass: nothing running, admitting despite "
                    f"forecast {_pretty_bytes(forecast)} > "
                    f"{_pretty_bytes(free)} free (spill will enforce "
                    "the budget)")
                self._admit_locked(t, bypass=True)
                self._emit_admission(t, "admit", free)
                return t
            # queue: behind this session's FIFO / other sessions' turns
            t.verdict = "queue"
            t.reason = (
                f"queued: forecast {_pretty_bytes(forecast)} > "
                f"{_pretty_bytes(free)} free" if not fits else
                f"queued: behind {self._depth()} waiting quer"
                f"{'y' if self._depth() == 1 else 'ies'}")
            self._queues[session].append(t)
            self.queued += 1
            if _obs.enabled():
                _obs.inc("tpu_serve_admissions", 1, verdict="queue")
            self._emit_admission(t, "queue", free)
            self._emit_queue(t, "enqueue", self._depth(session))
            # a fitting ticket queued only for fairness may be admittable
            # right away once round-robin considers it
            self._pump_locked()
        if timeout_ms > 0:
            if not t.event.wait(timeout_ms / 1e3):
                # may have been admitted in the instant the wait gave up:
                # _try_timeout decides under the lock
                if self._try_timeout(t):
                    raise ServeQueueTimeout(
                        f"session {session} plan {digest} gave up after "
                        f"{timeout_ms}ms in the serving queue "
                        f"(spark.rapids.tpu.serve.queueTimeoutMs); "
                        f"last verdict: {t.reason}")
                t.event.wait()  # admitted concurrently; set is imminent
        else:
            t.event.wait()
        return t

    def note_oom_requeue(self, session: str, digest: str,
                         inflated_forecast: Optional[int],
                         forecast_source: str = "watermark") -> None:
        """Record one OOM-driven requeue (sql/session._collect_serve):
        the admitted query failed with a typed device-OOM despite the
        recovery plane, its reservation is already released, and it is
        being resubmitted ONCE with its forecast inflated to the
        observed peak watermark — forecast misses become queueing, not
        crashes. Surfaced in stats()/'/status', the admission event
        stream, and the oom_retry resilience events."""
        with self._lock:
            self.oom_requeues += 1
        if _obs.enabled():
            _obs.inc("tpu_serve_admissions", 1, verdict="requeue")
            _obs.note_oom_retry(f"serve {session}", "requeue")
        if _events.enabled():
            _events.emit(
                "admission", session=session, digest=digest,
                verdict="requeue", forecast_bytes=inflated_forecast,
                free_bytes=None,
                reason="admitted query OOMed at runtime; requeued once "
                       "with forecast inflated to the observed peak "
                       "watermark",
                forecast_source=forecast_source)
            _events.emit(
                "oom_retry", op=f"serve {session}", kind="requeue",
                attempt=1, depth=0, watermark=inflated_forecast,
                budget=None)

    def _try_timeout(self, t: Ticket) -> bool:
        """Remove a still-queued ticket (timeout); False if it was
        admitted concurrently (the caller proceeds with it)."""
        with self._lock:
            q = self._queues.get(t.session)
            if q is None or t not in q:
                return False
            q.remove(t)
            self.timeouts += 1
            wait = time.perf_counter_ns() - t.enqueue_ns
            self._emit_queue(t, "timeout", self._depth(t.session), wait)
            # the queue shape changed: a successor head that fits (or
            # the anti-starvation barrier the departed ticket held) may
            # now admit — without this pump it would idle until some
            # unrelated release
            self._pump_locked()
            return True

    def release(self, t: Ticket) -> None:
        """Return the ticket's reservation and wake whatever now fits."""
        with self._lock:
            if t.seq not in self._active:
                return
            del self._active[t.seq]
            if t.reservation is not None:
                self._catalog().release_reservation(t.reservation)
                t.reservation = None
            if _events.enabled() and t.admit_ns is not None:
                # the admitted run on the session's serve lane, next to
                # its queue_wait span
                _events.emit(
                    "op_span", op=f"serve {t.session}", section="run",
                    start=t.admit_ns,
                    dur=time.perf_counter_ns() - t.admit_ns, lane="host")
            self._pump_locked()

    # -- introspection (/status, tools/tpu_top.py, tests) ------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "admitted": self.admitted, "queued": self.queued,
                "rejected": self.rejected, "timeouts": self.timeouts,
                "bypass_admissions": self.bypass_admissions,
                "oom_requeues": self.oom_requeues,
                "peak_inflight_forecast": self.peak_inflight_forecast,
                "peak_active": self.peak_active,
                "active": len(self._active), "waiting": self._depth(),
            }

    def queue_status(self) -> List[dict]:
        """Waiting queries in drain order (priority tiers, then rr),
        each with its session, queue position, and admission reason —
        the /status + tpu_top payload."""
        now = time.perf_counter_ns()
        with self._lock:
            heads: List[dict] = []
            order = sorted(
                (s for s in self._rr_order if self._queues.get(s)),
                key=lambda s: -(self._queues[s][0].priority
                                if self._queues[s] else 0))
            pos = 0
            for s in order:
                for t in self._queues[s]:
                    heads.append({
                        "session": t.session, "digest": t.digest,
                        "position": pos, "priority": t.priority,
                        "forecast_bytes": t.forecast,
                        "reason": t.reason,
                        "waited_ms": (now - t.enqueue_ns) / 1e6,
                    })
                    pos += 1
            return heads

    def active_status(self) -> List[dict]:
        now = time.perf_counter_ns()
        with self._lock:
            return [{
                "session": t.session, "digest": t.digest,
                "forecast_bytes": t.forecast, "bypass": t.bypass,
                "running_ms": ((now - t.admit_ns) / 1e6
                               if t.admit_ns else None),
            } for t in sorted(self._active.values(),
                              key=lambda t: t.seq)]
