"""Per-query live progress: rows done vs the plan analyzer's forecast.

Counterpart of ``spark_rapids_tpu/obs/progress.py``. record_batch's live
numerators (rows, batches, bytes per op) divide into each op's forecast
row and batch counts. The port has no plan analyzer yet (ROADMAP.md item
26), so its sessions register no forecasts: every op shows its
numerators with a null denominator and a null progress, as the
reference's do with ``sql.analysis.enabled`` off.

Attribution is BY THREAD: a session begins its query on the thread that
will drain the plan (collect consumes on the caller's thread), so
concurrent sessions in different threads each feed their own query's
numerators. Numerators are best-effort progress, never accounting of
record.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional


class OpProgress:
    __slots__ = ("rows", "batches", "bytes")

    def __init__(self):
        self.rows = 0
        self.batches = 0
        self.bytes = 0


class QueryState:
    __slots__ = ("query_id", "plan_digest", "start_ns", "end_ns",
                 "thread_ident", "rows_forecast", "batches_forecast",
                 "ops", "done", "error", "rows_out")

    def __init__(self, query_id, plan_digest: str,
                 rows_forecast: Dict[str, int],
                 batches_forecast: Dict[str, int], thread_ident: int):
        self.query_id = query_id
        self.plan_digest = plan_digest
        self.start_ns = time.perf_counter_ns()
        self.end_ns: Optional[int] = None
        self.thread_ident = thread_ident
        self.rows_forecast = dict(rows_forecast or {})
        self.batches_forecast = dict(batches_forecast or {})
        self.ops: Dict[str, OpProgress] = {}
        self.done = False
        self.error = False
        self.rows_out: Optional[int] = None

    def to_status(self) -> dict:
        end = self.end_ns or time.perf_counter_ns()
        ops: List[dict] = []
        for op in sorted(set(self.ops) | set(self.rows_forecast)
                         | set(self.batches_forecast)):
            p = self.ops.get(op)
            rows = p.rows if p else 0
            batches = p.batches if p else 0
            rf = self.rows_forecast.get(op)
            bf = self.batches_forecast.get(op)
            # rows when both sides have them; else batches (a lazy row
            # count — still a device scalar — records batches only);
            # no denominator at all -> None, never a fake percentage
            if rf and rows:
                progress: Optional[float] = min(1.0, rows / rf)
            elif bf and batches:
                progress = min(1.0, batches / bf)
            elif rf or bf:
                progress = 0.0
            else:
                progress = None
            ops.append({
                "op": op, "rows": rows, "rows_forecast": rf,
                "batches": batches, "batches_forecast": bf,
                "bytes": p.bytes if p else 0, "progress": progress,
            })
        state = ("failed" if self.error
                 else "finished" if self.done else "running")
        return {
            "query_id": self.query_id, "plan_digest": self.plan_digest,
            "state": state, "elapsed_ms": (end - self.start_ns) / 1e6,
            "rows_out": self.rows_out, "ops": ops,
        }


class ProgressTracker:
    """Thread-safe live-query table + a short finished-query history.

    The lock is a LEAF lock (same discipline as the metrics registry):
    no method calls out of this module."""

    def __init__(self, history: int = 16):
        self._lock = threading.Lock()
        self._live: Dict[object, QueryState] = {}
        self._by_thread: Dict[int, object] = {}
        self._recent: deque = deque(maxlen=history)

    def begin(self, query_id, plan_digest: str = "",
              rows_forecast: Optional[Dict[str, int]] = None,
              batches_forecast: Optional[Dict[str, int]] = None) -> None:
        ident = threading.get_ident()
        st = QueryState(query_id, plan_digest, rows_forecast or {},
                        batches_forecast or {}, ident)
        with self._lock:
            self._live[query_id] = st
            self._by_thread[ident] = query_id

    def note_batch(self, op: str, rows: Optional[int],
                   nbytes: int) -> None:
        """Called from record_batch on the draining thread; silently a
        no-op when the thread has no live query (direct exec tests)."""
        with self._lock:
            qid = self._by_thread.get(threading.get_ident())
            st = self._live.get(qid) if qid is not None else None
            if st is None:
                return
            p = st.ops.get(op)
            if p is None:
                p = st.ops[op] = OpProgress()
            p.batches += 1
            if rows:
                p.rows += rows
            p.bytes += nbytes

    def end(self, query_id, rows: Optional[int] = None,
            error: bool = False) -> None:
        with self._lock:
            st = self._live.pop(query_id, None)
            if st is None:
                return
            if self._by_thread.get(st.thread_ident) == query_id:
                del self._by_thread[st.thread_ident]
            st.done = True
            st.error = error
            st.rows_out = rows
            st.end_ns = time.perf_counter_ns()
            self._recent.append(st)

    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    def status(self) -> List[dict]:
        """Live queries first (oldest first), then recent history.
        Payloads are built UNDER the lock: note_batch inserts into
        st.ops concurrently, and iterating that dict unlocked could
        raise mid-scrape — /status must stay parseable mid-run."""
        with self._lock:
            live = sorted(self._live.values(), key=lambda s: s.start_ns)
            return [s.to_status() for s in live] + \
                   [s.to_status() for s in reversed(self._recent)]

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._by_thread.clear()
            self._recent.clear()


#: process-global tracker (always present — emit sites are gated on
#: registry.enabled(), so an idle tracker costs nothing)
_TRACKER = ProgressTracker()


def tracker() -> ProgressTracker:
    return _TRACKER
