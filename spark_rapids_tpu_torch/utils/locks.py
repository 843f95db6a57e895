"""Declared lock hierarchy + ordered-lock wrapper + runtime witness.

Own copy of ``spark_rapids_tpu/utils/locks.py`` (the port imports
nothing of the reference package): the same manifest, ranks, names and
witness, so a lock of the port ranks where the reference's twin does.

* ``LOCK_ORDER`` is the manifest: the total order in which named engine
  locks may nest. A thread holding lock A may only acquire a lock that
  appears LATER in the manifest; the runtime witness (off by default) checks
  actual acquisition orders against it.

* ``ordered_lock(name)`` is the thin wrapper every named engine lock is
  built from. With the witness off (the default) an acquire costs one
  module-global read on top of the underlying ``threading.Lock`` — the
  events/obs zero-overhead pattern. With the witness on, each acquire
  validates the declared order against the thread's held set, records
  the (held, acquired) edge, and raises :class:`LockOrderInversion`
  naming the colliding pair BEFORE blocking — a would-be deadlock
  surfaces as a typed error at the second lock, not a hang.

* ``LEAF_SINKS`` names the manifest locks that everything may feed
  (metric/event emission): they are at the bottom of the order and must
  never call out while held — the witness would raise on it.

The manifest lists locks of modules the port has no counterpart of
(``aot.store_probe``, ``aot.load_probe``, ``exec.pipeline_cache``): they
keep their ranks so the two packages' tables stay one table.
``serve.scheduler`` and ``serve.plan_cache`` are the serving path's
(``serve/``), ``aot.stats`` the kernel-library cache's
(``serve/program_cache.py``).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# The manifest: outermost-first. A thread may only acquire DOWNWARD
# (toward the leaves). Kept as a plain literal tuple, as in the reference.
# ---------------------------------------------------------------------------
LOCK_ORDER = (
    # per-session plan+claim mutex: the serving path lets N threads
    # share one session, so plan+execute runs under it end to end —
    # outermost by design (nothing below ever calls back into a session)
    "sql.plan",
    # serving admission: holds the lock across catalog snapshots,
    # reservations, and admission/queue emission
    "serve.scheduler",
    # shared static-analysis cache single-flight bookkeeping
    "serve.plan_cache",
    # obs plane install/teardown (registry gauge writes happen under it)
    "obs.plane",
    # per-exchange map-side one-shot latch, held across the whole map
    # run (compiles, retry plane, transport writes); stacked exchanges
    # nest child latches under the parent's — same-name nesting is the
    # design, hence reentrant
    "exec.exchange_map",
    # the process-global compiled-pipeline caches' double-checked slow
    # path; re-entrant (an AOT lookup can consult it again)
    "exec.pipeline_cache",
    # AOT store/load probes' first-call transitions (export+compile /
    # deserialize+fallback) — they emit cost events and can touch the
    # catalog through the OOM-retry plane, never the layers above
    "aot.store_probe",
    "aot.load_probe",
    # per-handle tier-transition lock: always taken BEFORE the catalog
    # (close() unregisters under it; the catalog never holds ITS lock
    # while calling into a handle — see BufferCatalog.request)
    "memory.spillable",
    # spillable-buffer registry: spill decisions + reservation
    # accounting; re-entrant (spill paths re-enter through handles)
    "memory.catalog",
    # device scan-cache entry table: put/evict call into the HBM ledger
    # (entries carry owner tags) and the event/obs leaf sinks while
    # held; OOM recovery calls drop_under_pressure with no lock above
    "io.scan_cache",
    # per-buffer HBM ledger (owner attribution + leak sentinel): fed by
    # the catalog under ITS lock and by the scan cache, emits into the
    # event/obs leaf sinks — so it sits between the two
    "memory.ledger",
    # TpuSemaphore's holder table (who to blame on acquire timeout)
    "memory.semaphore_holders",
    # -- leaf sinks: pure accounting, must never call out while held --
    "exec.compile_counter",
    "aot.stats",
    "events.logger",
    "obs.registry",
)

#: manifest locks that every layer may feed while holding anything
#: (metric/event emission): they must have NO outgoing lock edges.
LEAF_SINKS = frozenset(
    {"exec.compile_counter", "aot.stats", "events.logger", "obs.registry"})

_RANK: Dict[str, int] = {n: i for i, n in enumerate(LOCK_ORDER)}


def rank_of(name: str) -> int:
    return _RANK[name]


class LockOrderInversion(RuntimeError):
    """Acquisition order violated the declared ``LOCK_ORDER``: raised by
    the witness at the second (colliding) acquire, naming both locks, so
    a potential deadlock is a typed error instead of a hang."""

    def __init__(self, held: str, acquiring: str, thread: str):
        self.held = held
        self.acquiring = acquiring
        super().__init__(
            f"lock-order inversion in thread {thread!r}: acquiring "
            f"{acquiring!r} (rank {_RANK[acquiring]}) while holding "
            f"{held!r} (rank {_RANK[held]}) — the declared hierarchy "
            f"(spark_rapids_tpu_torch/utils/locks.py LOCK_ORDER) only "
            f"permits acquiring downward")


class _Witness:
    """Per-thread held-name stacks + the global observed-edge table.

    The internal bookkeeping lock is a raw ``threading.Lock`` BELOW the
    whole hierarchy on purpose: it is only ever taken with no callouts,
    so it can never participate in an inversion itself."""

    def __init__(self):
        self._tls = threading.local()
        self._lock = threading.Lock()
        #: (outer, inner) -> times observed
        self.edges: Dict[Tuple[str, str], int] = {}
        #: inversions observed (outer, inner, thread) — populated even
        #: though the acquire also raises, so a stress harness that
        #: swallows per-query errors still reports the tally
        self.inversions: List[Tuple[str, str, str]] = []

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def check(self, name: str, reentrant: bool) -> None:
        """Validate BEFORE blocking on the underlying lock."""
        st = self._stack()
        if not st:
            return
        rank = _RANK[name]
        tname = threading.current_thread().name
        for held in st:
            if held == name:
                if reentrant:
                    continue
                with self._lock:
                    self.inversions.append((held, name, tname))
                raise LockOrderInversion(held, name, tname)
            if _RANK[held] >= rank:
                with self._lock:
                    self.inversions.append((held, name, tname))
                raise LockOrderInversion(held, name, tname)

    def note_acquired(self, name: str) -> None:
        st = self._stack()
        if st:
            with self._lock:
                for held in st:
                    if held != name:
                        k = (held, name)
                        self.edges[k] = self.edges.get(k, 0) + 1
        st.append(name)

    def note_released(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return


#: the module-global gate: ``None`` = witness off (the default) — an
#: ordered_lock acquire then costs ONE extra global read (the
#: events/obs zero-overhead pattern)
_WITNESS: Optional[_Witness] = None


def install_witness() -> _Witness:
    """Turn the runtime witness on (process-global, idempotent): tests,
    and the SRTPU_RACECHECK_WITNESS=1 environment hook below."""
    global _WITNESS
    w = _WITNESS
    if w is None:
        w = _WITNESS = _Witness()
    return w


def uninstall_witness() -> None:
    global _WITNESS
    _WITNESS = None


def witness_active() -> bool:
    return _WITNESS is not None


def observed_edges() -> Dict[Tuple[str, str], int]:
    """Actual (outer, inner) acquisition pairs seen so far — the chaos
    suite cross-checks these against the static acquire graph."""
    w = _WITNESS
    if w is None:
        return {}
    with w._lock:
        return dict(w.edges)


def observed_inversions() -> List[Tuple[str, str, str]]:
    w = _WITNESS
    if w is None:
        return []
    with w._lock:
        return list(w.inversions)


def witness_report() -> Dict[str, object]:
    """JSON-able summary (the chaos CI step prints + asserts on it)."""
    return {
        "active": witness_active(),
        "edges": sorted(f"{a} -> {b}" for a, b in observed_edges()),
        "inversions": [list(t) for t in observed_inversions()],
    }


class OrderedLock:
    """A named lock participating in the declared hierarchy.

    Drop-in for the ``with lock: ...`` / ``acquire()``/``release()``
    surface the engine uses. ``reentrant=True`` wraps an RLock (same-
    thread re-acquisition of the SAME name is not an inversion)."""

    __slots__ = ("name", "reentrant", "_lock")

    def __init__(self, name: str, reentrant: bool = False):
        if name not in _RANK:
            raise ValueError(
                f"unknown lock name {name!r}: every ordered_lock must be "
                f"declared in spark_rapids_tpu_torch/utils/locks.py LOCK_ORDER")
        self.name = name
        self.reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        w = _WITNESS
        if w is not None:
            w.check(self.name, self.reentrant)
        ok = self._lock.acquire(blocking, timeout)
        if ok and w is not None:
            w.note_acquired(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        w = _WITNESS
        if w is not None:
            w.note_released(self.name)

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return (f"OrderedLock({self.name!r}, rank={_RANK[self.name]}, "
                f"reentrant={self.reentrant})")


def ordered_lock(name: str, reentrant: bool = False) -> OrderedLock:
    """THE way to create a named engine lock (see LOCK_ORDER)."""
    return OrderedLock(name, reentrant=reentrant)


# subprocess hook: the chaos/serve CI stress steps flip the witness on in
# child processes where no conf handle exists yet
if os.environ.get("SRTPU_RACECHECK_WITNESS", "") == "1":
    install_witness()
