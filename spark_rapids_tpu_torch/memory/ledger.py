"""Per-buffer device-memory ledger: lifecycle attribution and the leak
sentinel.

Counterpart of ``spark_rapids_tpu/memory/ledger.py``. Every registered
``SpillableHandle`` gets a record with an owner tag (query id, op,
creation site, creation-path digest) and a lifecycle (alloc ->
spill/unspill -> free with a reason). ``query_scope(qid)`` makes a
query own what its thread registers, and the ledger keeps each query's
device-byte peak; ``sweep_query(qid)`` at query end flags still-live
spillable buffers of the finished query as leaked (the leak sentinel). Scan-cache entries, admission reservations and declared plan
state (join builds, broadcast batches) are exempt: they outlive queries
by design.

Left out until their items land: the ``buffer_alloc``/``buffer_free``/
``heap_snapshot`` events, the obs gauges, and the per-op and per-plan
views that feed them and the serve admission (ROADMAP.md items 7, 13
and 26). The reference arms the ledger while events or live metrics are
on; the port has neither yet, so only :func:`force_arm` (benches,
tests) arms it, and a plain session records nothing.
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

from ..conf import LEAK_SENTINEL_ENABLED, RapidsConf

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

#: bounded history of per-query peaks
_QUERY_HISTORY = 256

# -- force arm (benches, tests) --------------------------------------------
_FORCE = False


def force_arm(on: bool = True) -> None:
    """Arm the ledger (benches, tests). The reference also arms it while
    its event log or live metrics are on, which the port has not yet."""
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


class Ledger:
    """The per-buffer book. One instance per BufferCatalog; all state
    under its own lock (taken below the catalog's, so catalog paths may
    call in while holding theirs)."""

    def __init__(self, conf_: Optional[RapidsConf] = None):
        self.conf = conf_ or RapidsConf({})
        self._sentinel = bool(self.conf.get(LEAK_SENTINEL_ENABLED))
        self._lock = threading.RLock()
        self._records: Dict[int, dict] = {}
        self._next_lid = 0
        self._live_bytes = 0
        #: per-query device-live bytes and (bounded) peaks
        self._query_live: Dict[str, int] = {}
        self._query_peak: "OrderedDict[str, int]" = OrderedDict()
        self._alloc_count = 0
        self._free_count = 0
        self._leaked_total = 0
        self._leaked_live = 0

    def armed(self) -> bool:
        """True when lifecycle recording is on: the one hot-path guard,
        checked before any record is built."""
        return _FORCE

    # -- lifecycle ---------------------------------------------------------
    def note_alloc(self, nbytes: int, kind: str = KIND_SPILLABLE,
                   op: Optional[str] = None, site: Optional[str] = None,
                   query_id: Optional[str] = None) -> Optional[int]:
        """Record an allocation; returns the ledger id (lid) to hand back
        to note_free/note_spill/note_unspill, or None when the ledger is
        not armed. ``site`` and ``query_id`` default to the caller's code
        site and the thread's query scope."""
        if not self.armed():
            return None
        if site is None:
            site, origin = _call_site()
        else:
            origin = hashlib.sha1(site.encode()).hexdigest()[:12]
        if query_id is None:
            query_id = current_query()
        device = kind != KIND_RESERVATION
        with self._lock:
            lid = self._next_lid
            self._next_lid += 1
            self._records[lid] = {
                "lid": lid, "kind": kind, "bytes": int(nbytes),
                "op": op, "query_id": query_id,
                "tid": threading.get_ident(), "site": site,
                "origin": origin, "alloc_ns": time.perf_counter_ns(),
                "device": device, "leaked": False,
            }
            self._alloc_count += 1
            if device:
                self._live_bytes += nbytes
                self._add_query_bytes(query_id, nbytes)
        return lid

    def _add_query_bytes(self, qid: Optional[str], nbytes: int) -> None:
        # under self._lock
        if qid is None:
            return
        live = self._query_live.get(qid, 0) + nbytes
        self._query_live[qid] = live
        if nbytes > 0 and live > self._query_peak.get(qid, 0):
            self._query_peak[qid] = live
            self._query_peak.move_to_end(qid)
            while len(self._query_peak) > _QUERY_HISTORY:
                self._query_peak.popitem(last=False)

    def note_free(self, lid: Optional[int], reason: str = "close") -> None:
        if lid is None:
            return
        with self._lock:
            r = self._records.pop(lid, None)
            if r is None:
                return  # already freed: close() is idempotent upstream
            self._free_count += 1
            if r["leaked"]:
                self._leaked_live -= 1
            if r["device"]:
                self._live_bytes -= r["bytes"]
                if r["query_id"] in self._query_live:
                    self._add_query_bytes(r["query_id"], -r["bytes"])

    def note_spill(self, lid: Optional[int]) -> None:
        """The buffer left the device tier: its bytes stop counting as
        device-live for its query."""
        self._move(lid, to_device=False)

    def note_unspill(self, lid: Optional[int]) -> None:
        self._move(lid, to_device=True)

    def _move(self, lid: Optional[int], to_device: bool) -> None:
        if lid is None:
            return
        with self._lock:
            r = self._records.get(lid)
            if r is None or r["device"] == to_device:
                return
            r["device"] = to_device
            delta = r["bytes"] if to_device else -r["bytes"]
            self._live_bytes += delta
            if to_device or r["query_id"] in self._query_live:
                self._add_query_bytes(r["query_id"], delta)

    # -- query end: the leak sentinel --------------------------------------
    def sweep_query(self, query_id: Optional[str]) -> List[dict]:
        """Close a query's ownership window and, with the sentinel on,
        flag every still-live buffer it owns (scan-cache entries,
        reservations and declared plan state exempt) as leaked. Returns
        the leak records (copies)."""
        if query_id is None:
            return []
        leaks: List[dict] = []
        with self._lock:
            self._query_live.pop(query_id, None)
            if self._sentinel:
                for r in self._records.values():
                    if (r["query_id"] == query_id and not r["leaked"]
                            and r["kind"] not in SWEEP_EXEMPT_KINDS):
                        r["leaked"] = True
                        self._leaked_total += 1
                        self._leaked_live += 1
                        leaks.append(dict(r))
        for r in leaks:
            log.warning("leaked buffer %d: %d B from %s outlives query %s",
                        r["lid"], r["bytes"], r["site"], query_id)
        return leaks

    # -- views -------------------------------------------------------------
    def query_peak(self, query_id: Optional[str]) -> Optional[int]:
        """Observed device-byte peak of one query (kept in a bounded
        history after its sweep)."""
        if query_id is None:
            return None
        with self._lock:
            return self._query_peak.get(query_id)

    def live_leaks(self) -> List[dict]:
        """Still-live records the sentinel has flagged (copies)."""
        with self._lock:
            return [dict(r) for r in self._records.values()
                    if r["leaked"]]

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
