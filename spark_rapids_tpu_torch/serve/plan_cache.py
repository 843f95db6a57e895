"""Process-shared plan cache keyed by plan digest.

Counterpart of ``spark_rapids_tpu/serve/plan_cache.py``. N sessions
submitting the same plan shape pay the planning-side work ONCE: the
static analysis (the admission forecast the scheduler checks) is
computed on first submit and served from here afterwards, and the first
completed execution marks the digest "warm". The digest is the
sha1-of-tree_string the session stamps into ``query_start`` events
(``sql/session.py``), extended with a conf fingerprint: two sessions
submitting one plan under different layout or memory settings must not
share a forecast.

Thread-safe under concurrent sessions: one in-flight computation per
key; later arrivals wait on it instead of recomputing. The reference's
warm flag also means "its XLA programs sit in the compile caches"; the
port compiles nothing, so warm is only the first completed execution.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

from .. import obs as _obs
from ..utils.locks import ordered_lock

#: one analysis per distinct (digest, conf fingerprint) is plenty; the
#: cap only bounds a pathological digest churn (ragged ad-hoc plans)
_MAX_ENTRIES = 4096


class SharedPlanCache:
    """digest -> (analysis, warm flag) with single-flight computation."""

    _instance: Optional["SharedPlanCache"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = ordered_lock("serve.plan_cache")
        self._entries: Dict[tuple, Any] = {}
        self._inflight: Dict[tuple, threading.Event] = {}
        self._warm: Dict[tuple, bool] = {}
        self.hits = 0
        self.misses = 0

    @classmethod
    def get(cls) -> "SharedPlanCache":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = SharedPlanCache()
            return cls._instance

    @classmethod
    def reset(cls) -> "SharedPlanCache":
        with cls._instance_lock:
            cls._instance = SharedPlanCache()
            return cls._instance

    def analysis_for(self, key: tuple,
                     compute: Callable[[], Any]) -> Tuple[Any, bool]:
        """(analysis, was_hit). Single-flight: the first submitter of a
        key computes while later submitters of the SAME key wait on its
        event — never N analyses of one plan, and never a lock held
        across the (CPU-heavy) computation for unrelated keys."""
        while True:
            with self._lock:
                if key in self._entries:
                    self.hits += 1
                    if _obs.enabled():
                        _obs.inc("tpu_serve_plan_cache", 1, op="hit")
                    return self._entries[key], True
                ev = self._inflight.get(key)
                if ev is None:
                    ev = self._inflight[key] = threading.Event()
                    mine = True
                else:
                    mine = False
            if not mine:
                ev.wait()
                continue  # re-read: the computer published (or failed)
            try:
                value = compute()
            except BaseException:
                # a failed analysis must not wedge later submitters of
                # the same key into waiting forever — clear the flight
                # so the next one retries
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()
                raise
            with self._lock:
                if len(self._entries) > _MAX_ENTRIES:
                    self._entries.clear()
                    self._warm.clear()
                self._entries[key] = value
                self._inflight.pop(key, None)
                self.misses += 1
                if _obs.enabled():
                    _obs.inc("tpu_serve_plan_cache", 1, op="miss")
            ev.set()
            return value, False

    def mark_warm(self, key: tuple) -> None:
        """First completed execution of this digest (surfaced as the
        ``warm`` count in :meth:`stats`)."""
        with self._lock:
            self._warm[key] = True

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries),
                    "warm": sum(1 for v in self._warm.values() if v)}


def conf_fingerprint(conf_) -> tuple:
    """The part of a cache key that keeps sessions with different
    settings apart: the explicitly-set conf values (layout, memory and
    analysis behavior all hang off registered entries, and defaults are
    identical process-wide)."""
    return tuple(sorted(conf_._values.items()))
