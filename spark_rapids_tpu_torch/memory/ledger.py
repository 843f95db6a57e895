"""Per-buffer HBM ledger: lifecycle attribution + leak sentinel.

Counterpart of ``spark_rapids_tpu/memory/ledger.py``. Every registered
SpillableHandle and scan-cache entry gets a ledger record with an owner
tag — (query id, op, creation site, creation-path digest) — and a full
lifecycle (alloc -> spill/unspill -> free-with-reason), emitted as typed
``buffer_alloc``/``buffer_free``/``heap_snapshot`` events with live obs
twins (the ``tpu_hbm_bytes{op=...}`` gauge family, the leak counter).

Zero-overhead-off contract: every hot entry point checks
:meth:`Ledger.armed` FIRST — with events and obs off and no force arm,
no record dict is built, no labels are touched, no lock beyond the
armed read is taken. ``force_arm()`` is the bench/test hook, so
attribution works without standing up the whole obs plane.

The owning op comes from :func:`op_scope`, a thread-local stack that
``TpuExec.op_timed`` enters (only while events or obs are on) — the
port's stand-in for the reference's ``xla_cost.op_scope``, which it also
feeds the XLA cost plane from. The owning query comes from
:func:`query_scope`, which the session enters around each drain.

The **leak sentinel** rides the query window: ``sweep_query(qid)`` at
query end flags still-live spillable buffers whose owning query is gone
— surfaced as a watchdog alert, a ``/status`` heap block and the
session's ``last_leaks``. Scan-cache entries and declared plan state
(join builds, broadcast batches) outlive queries by design and are
exempt; so are admission reservations, which the serving scheduler
releases after the query window closes.

The sweep also folds each query's observed peak into a bounded
per-plan-digest history: :meth:`Ledger.observed_peak` is the measured
figure the serving admission (``sql/session._collect_serve_once``)
charges in place of the analyzer's static forecast once a digest has
run.
"""
from __future__ import annotations

import hashlib
import logging
import os
import sys
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from .. import events as _events
from .. import obs as _obs
from ..conf import LEAK_SENTINEL_ENABLED, LEDGER_ENABLED, RapidsConf
from ..utils.locks import ordered_lock

log = logging.getLogger("spark_rapids_tpu_torch.memory.ledger")

#: record kinds
KIND_SPILLABLE = "spillable"
KIND_SCAN_CACHE = "scan_cache"
KIND_RESERVATION = "reservation"
#: deliberately-retained exec state (join build sides, broadcast
#: batches): reused across re-executions of the cached plan, so
#: outliving one query is the point — the creating site DECLARES it
#: (SpillableHandle ledger_kind) instead of the sentinel guessing
KIND_PLAN_STATE = "plan_state"

#: kinds the leak sentinel never flags: scan-cache entries and declared
#: plan state outlive queries by design, reservations are released by
#: the scheduler AFTER the query window closes (session finally ->
#: sched.release ordering)
SWEEP_EXEMPT_KINDS = frozenset(
    {KIND_SCAN_CACHE, KIND_RESERVATION, KIND_PLAN_STATE})

#: bounded history sizes (per-digest observed peaks / per-query peaks)
_DIGEST_HISTORY = 256
_QUERY_HISTORY = 256

# -- force arm (bench/tests): attribution without events/obs ---------------
_FORCE = False


def force_arm(on: bool = True) -> None:
    """Arm the ledger regardless of events/obs state (bench per-shape
    attribution, tests). NOT a public conf — the production arm signal
    is the event log / obs plane being on."""
    global _FORCE
    _FORCE = on


def force_armed() -> bool:
    return _FORCE


# -- threadlocal query ownership scope -------------------------------------
_QUERY = threading.local()


@contextmanager
def query_scope(query_id: Optional[str]):
    """Every buffer registered on this thread while the scope is open is
    owned by ``query_id`` (the execution paths in sql/session.py enter
    it around collect/write drains). Nests: an inner scope shadows."""
    stack = getattr(_QUERY, "stack", None)
    if stack is None:
        stack = _QUERY.stack = []
    stack.append(query_id)
    try:
        yield
    finally:
        # defensive pop: a generator-held scope can be finalized on a
        # DIFFERENT thread (GC of an abandoned writer drain) whose
        # threadlocal stack never saw the push — pop only what we pushed
        cur = getattr(_QUERY, "stack", None)
        if cur and cur[-1] == query_id:
            cur.pop()
        elif stack and stack[-1] == query_id:
            stack.pop()


def current_query() -> Optional[str]:
    stack = getattr(_QUERY, "stack", None)
    return stack[-1] if stack else None


# -- creation-site capture -------------------------------------------------
#: memoized (filename, lineno) -> (site, origin digest); unbounded in
#: principle but keyed by static call sites, so bounded by the code.
#: The memo lock is a raw leaf below the whole hierarchy: nothing is
#: acquired under it (pure relpath/sha1 compute on a miss).
_SITE_CACHE: Dict[tuple, Tuple[str, str]] = {}
_SITE_LOCK = threading.Lock()
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP_FILES = (os.path.join(_PKG_DIR, "memory"),)


def _call_site() -> Tuple[str, str]:
    """(site, origin) of the nearest caller outside memory/: site is
    ``file.py:lineno`` (human), origin is a stable 12-hex digest of the
    full path form (machine — survives basename collisions)."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_SKIP_FILES[0]):
            key = (fn, f.f_lineno)
            with _SITE_LOCK:
                hit = _SITE_CACHE.get(key)
                if hit is None:
                    rel = os.path.relpath(fn, _PKG_DIR) \
                        if fn.startswith(_PKG_DIR) \
                        else os.path.basename(fn)
                    site = f"{rel}:{f.f_lineno}"
                    origin = hashlib.sha1(
                        f"{fn}:{f.f_lineno}".encode()).hexdigest()[:12]
                    hit = _SITE_CACHE[key] = (site, origin)
            return hit
        f = f.f_back
    return ("<unknown>", "000000000000")


# -- threadlocal op ownership scope ----------------------------------------
_OP = threading.local()


@contextmanager
def op_scope(name: str):
    """Buffers registered on this thread while the scope is open are
    owned by the op ``name`` (``TpuExec.op_timed`` enters it around each
    hot section while events or obs are on). Nests: an inner scope
    shadows."""
    stack = getattr(_OP, "stack", None)
    if stack is None:
        stack = _OP.stack = []
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def current_op() -> Optional[str]:
    stack = getattr(_OP, "stack", None)
    return stack[-1] if stack else None


class Ledger:
    """The per-buffer book. One instance per BufferCatalog; all state
    under its own ordered lock ("memory.ledger", below the catalog so
    catalog paths may call in while holding theirs, above the event/obs
    leaf sinks the note_* methods emit into)."""

    def __init__(self, conf_: Optional[RapidsConf] = None):
        self.conf = conf_ or RapidsConf({})
        self._enabled = bool(self.conf.get(LEDGER_ENABLED))
        self._sentinel = bool(self.conf.get(LEAK_SENTINEL_ENABLED))
        self._lock = ordered_lock("memory.ledger", reentrant=True)
        self._records: Dict[int, dict] = {}
        self._next_lid = 0
        #: device-live bytes per op (scan cache included: those arrays
        #: occupy HBM even though the catalog watermark never saw them)
        self._by_op: Dict[str, int] = {}
        self._op_peak: Dict[str, int] = {}
        self._live_bytes = 0
        self._churn_by_op: Dict[str, int] = {}
        #: per-query device-live/peak (bounded; keyed by query id, which
        #: is process-globally unique — the owner tag also carries tid)
        self._query_live: Dict[str, int] = {}
        self._query_peak: "OrderedDict[str, int]" = OrderedDict()
        #: per-plan-digest observed peaks (the admission feed)
        self._digest_peak: "OrderedDict[str, int]" = OrderedDict()
        self._alloc_count = 0
        self._free_count = 0
        self._leaked_total = 0
        self._leaked_live = 0

    # -- arming ------------------------------------------------------------
    def armed(self) -> bool:
        """True when lifecycle recording is on. The ONE hot-path guard:
        callers check it before building any record (zero-overhead-off
        contract)."""
        if not self._enabled:
            return False
        return _FORCE or _events.enabled() or _obs.enabled()

    # -- lifecycle ---------------------------------------------------------
    def note_alloc(self, nbytes: int, kind: str = KIND_SPILLABLE,
                   op: Optional[str] = None, site: Optional[str] = None,
                   query_id: Optional[str] = None) -> Optional[int]:
        """Record an allocation; returns the ledger id (lid) the caller
        must hand back to note_free/note_spill/note_unspill, or None
        when the ledger is not armed. ``op``/``site``/``query_id``
        default to the ambient attribution context (the op scope,
        caller's code site, threadlocal query scope)."""
        if not self.armed():
            return None
        if site is None:
            site, origin = _call_site()
        else:
            origin = hashlib.sha1(site.encode()).hexdigest()[:12]
        if op is None:
            op = current_op()
        if query_id is None:
            query_id = current_query()
        opkey = op or "(unattributed)"
        device = kind != KIND_RESERVATION
        with self._lock:
            lid = self._next_lid
            self._next_lid += 1
            self._records[lid] = {
                "lid": lid, "kind": kind, "bytes": int(nbytes),
                "op": op, "query_id": query_id,
                "tid": threading.get_ident(), "site": site,
                "origin": origin,
                "alloc_ns": time.perf_counter_ns(),
                "device": device, "leaked": False,
            }
            self._alloc_count += 1
            if device:
                self._live_bytes += nbytes
                nb = self._by_op.get(opkey, 0) + nbytes
                self._by_op[opkey] = nb
                if nb > self._op_peak.get(opkey, 0):
                    self._op_peak[opkey] = nb
                if query_id is not None:
                    ql = self._query_live.get(query_id, 0) + nbytes
                    self._query_live[query_id] = ql
                    if ql > self._query_peak.get(query_id, 0):
                        self._note_query_peak(query_id, ql)
            if _obs.enabled() and device:
                _obs.set_gauge("tpu_hbm_bytes", self._by_op[opkey],
                               op=opkey)
        if _events.enabled():
            _events.emit("buffer_alloc", bid=lid, kind=kind,
                         bytes=int(nbytes), op=op, query_id=query_id,
                         site=site, origin=origin)
        return lid

    def note_free(self, lid: Optional[int], reason: str = "close") -> None:
        if lid is None or not self._enabled:
            return
        with self._lock:
            r = self._records.pop(lid, None)
            if r is None:
                return  # already freed — close() is idempotent upstream
            self._free_count += 1
            if r["leaked"]:
                self._leaked_live -= 1
            opkey = r["op"] or "(unattributed)"
            if r["device"]:
                self._live_bytes -= r["bytes"]
                self._by_op[opkey] = self._by_op.get(opkey, 0) - r["bytes"]
                qid = r["query_id"]
                if qid is not None and qid in self._query_live:
                    self._query_live[qid] -= r["bytes"]
            if _obs.enabled() and r["device"]:
                _obs.set_gauge("tpu_hbm_bytes", self._by_op[opkey],
                               op=opkey)
        if _events.enabled():
            _events.emit("buffer_free", bid=lid, kind=r["kind"],
                         bytes=r["bytes"], reason=reason, op=r["op"],
                         query_id=r["query_id"])

    def note_spill(self, lid: Optional[int]) -> None:
        """Buffer left the device tier (device->host): its bytes stop
        counting as device-live for its op/query, and count as churn."""
        if lid is None or not self._enabled:
            return
        with self._lock:
            r = self._records.get(lid)
            if r is None or not r["device"]:
                return
            r["device"] = False
            opkey = r["op"] or "(unattributed)"
            self._live_bytes -= r["bytes"]
            self._by_op[opkey] = self._by_op.get(opkey, 0) - r["bytes"]
            self._churn_by_op[opkey] = \
                self._churn_by_op.get(opkey, 0) + r["bytes"]
            qid = r["query_id"]
            if qid is not None and qid in self._query_live:
                self._query_live[qid] -= r["bytes"]
            if _obs.enabled():
                _obs.set_gauge("tpu_hbm_bytes", self._by_op[opkey],
                               op=opkey)

    def note_unspill(self, lid: Optional[int]) -> None:
        if lid is None or not self._enabled:
            return
        with self._lock:
            r = self._records.get(lid)
            if r is None or r["device"]:
                return
            r["device"] = True
            opkey = r["op"] or "(unattributed)"
            self._live_bytes += r["bytes"]
            nb = self._by_op.get(opkey, 0) + r["bytes"]
            self._by_op[opkey] = nb
            if nb > self._op_peak.get(opkey, 0):
                self._op_peak[opkey] = nb
            qid = r["query_id"]
            if qid is not None:
                ql = self._query_live.get(qid, 0) + r["bytes"]
                self._query_live[qid] = ql
                if ql > self._query_peak.get(qid, 0):
                    self._note_query_peak(qid, ql)
            if _obs.enabled():
                _obs.set_gauge("tpu_hbm_bytes", nb, op=opkey)

    def _note_query_peak(self, qid: str, peak: int) -> None:
        # under self._lock
        self._query_peak[qid] = peak
        self._query_peak.move_to_end(qid)
        while len(self._query_peak) > _QUERY_HISTORY:
            self._query_peak.popitem(last=False)

    # -- query end: peak fold + leak sentinel ------------------------------
    def sweep_query(self, query_id: Optional[str],
                    digest: Optional[str] = None) -> List[dict]:
        """Close a query's ownership window: fold its observed peak into
        the per-digest history (the admission feed) and — when the
        sentinel is on — flag every still-live spillable buffer it owns
        as leaked; emit the ``heap_snapshot``. Returns the leak records
        (copies) for the caller (watchdog alert detail, the session's
        ``last_leaks``)."""
        if query_id is None or not self._enabled:
            return []
        leaks: List[dict] = []
        with self._lock:
            peak = self._query_peak.get(query_id)
            self._query_live.pop(query_id, None)
            if digest and peak:
                old = self._digest_peak.get(digest, 0)
                self._digest_peak[digest] = max(old, peak)
                self._digest_peak.move_to_end(digest)
                while len(self._digest_peak) > _DIGEST_HISTORY:
                    self._digest_peak.popitem(last=False)
            if self._sentinel:
                for r in self._records.values():
                    if (r["query_id"] == query_id and not r["leaked"]
                            and r["kind"] not in SWEEP_EXEMPT_KINDS):
                        r["leaked"] = True
                        self._leaked_total += 1
                        self._leaked_live += 1
                        leaks.append(dict(r))
        if leaks:
            for r in leaks:
                log.warning(
                    "leaked buffer %d: %d B from %s (op %s) outlives "
                    "query %s", r["lid"], r["bytes"], r["site"],
                    r["op"], query_id)
            if _obs.enabled():
                _obs.inc("tpu_hbm_leaked_buffers", len(leaks))
        if _events.enabled():
            snap = self.snapshot()
            _events.emit("heap_snapshot", query_id=query_id,
                         live_bytes=snap["live_bytes"],
                         by_op=snap["by_op"], top=snap["top"],
                         leaked=snap["leaked"])
        return leaks

    # -- admission feed ----------------------------------------------------
    def observed_peak(self, digest: Optional[str]) -> Optional[int]:
        """Largest device-byte peak any completed run of this plan digest
        reached — the measured replacement for the analyzer's static
        bound in the serve admission path."""
        if not digest or not self._enabled:
            return None
        with self._lock:
            return self._digest_peak.get(digest)

    def query_peak(self, query_id: Optional[str]) -> Optional[int]:
        """Observed device-byte peak of one query (survives its sweep in
        the bounded history)."""
        if query_id is None or not self._enabled:
            return None
        with self._lock:
            return self._query_peak.get(query_id)

    # -- views -------------------------------------------------------------
    def top_owners(self, n: int = 3) -> List[Tuple[str, int]]:
        """Top ops by device-live bytes (watchdog pressure detail)."""
        with self._lock:
            rows = [(op, b) for op, b in self._by_op.items() if b > 0]
        rows.sort(key=lambda kv: kv[1], reverse=True)
        return rows[:n]

    def snapshot(self, top: int = 3) -> dict:
        """JSON-able live-heap view (heap_snapshot event payload and the
        /status heap block's core)."""
        with self._lock:
            by_op = {op: b for op, b in self._by_op.items() if b > 0}
            live = self._live_bytes
            leaked = self._leaked_live
        rows = sorted(by_op.items(), key=lambda kv: kv[1], reverse=True)
        return {"live_bytes": live, "by_op": by_op,
                "top": [[op, b] for op, b in rows[:top]],
                "leaked": leaked}

    def live_leaks(self) -> List[dict]:
        """Still-live records the sentinel has flagged (copies)."""
        with self._lock:
            return [dict(r) for r in self._records.values()
                    if r["leaked"]]

    def op_peaks(self) -> Dict[str, int]:
        """Per-op peak device-live bytes since construction (or the last
        rebase) — explain_metrics' memory footer."""
        with self._lock:
            return dict(self._op_peak)

    def status_block(self) -> dict:
        """The /status ``heap`` block."""
        snap = self.snapshot(top=3)
        with self._lock:
            snap["leaked_total"] = self._leaked_total
            snap["allocs"] = self._alloc_count
            snap["frees"] = self._free_count
            snap["tracked"] = len(self._records)
            snap["spill_churn_bytes"] = sum(self._churn_by_op.values())
        return snap

    def stats(self) -> dict:
        with self._lock:
            return {
                "allocs": self._alloc_count,
                "frees": self._free_count,
                "tracked": len(self._records),
                "live_bytes": self._live_bytes,
                "leaked_live": self._leaked_live,
                "leaked_total": self._leaked_total,
            }
