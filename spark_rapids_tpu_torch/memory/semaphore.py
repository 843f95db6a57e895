"""The device concurrency semaphore.

Counterpart of ``spark_rapids_tpu/memory/semaphore.py`` (reference
analog: GpuSemaphore.scala:27-106): caps how many tasks hold the device
at once (``spark.rapids.tpu.sql.concurrentTpuTasks``), acquired before a
task's first device work, re-entrant per task, released at task end.
Here a task is a thread: each thread executing partitions acquires once,
and nested execs piggyback on the thread-local count."""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..conf import (
    CONCURRENT_TPU_TASKS,
    SEMAPHORE_ACQUIRE_TIMEOUT_MS,
    RapidsConf,
)


class TpuSemaphoreTimeout(RuntimeError):
    """Raised when sql.semaphore.acquireTimeoutMs elapses before a permit
    frees. Names the threads holding permits, so a wedged holder is
    identifiable from the error alone."""


class TpuSemaphore:
    _instance: Optional["TpuSemaphore"] = None
    _lock = threading.Lock()

    def __init__(self, permits: int, timeout_ms: int = 0):
        self.permits = permits
        self.timeout_ms = timeout_ms
        self._sem = threading.BoundedSemaphore(permits)
        self._local = threading.local()
        # thread ident -> thread name for every current permit holder —
        # read (under the holders lock) to name the culprits when an
        # acquire times out
        self._holders: Dict[int, str] = {}
        self._holders_lock = threading.Lock()

    @classmethod
    def initialize(cls, conf: Optional[RapidsConf] = None) -> "TpuSemaphore":
        with cls._lock:
            if cls._instance is None:
                c = conf or RapidsConf({})
                cls._instance = TpuSemaphore(
                    c.get(CONCURRENT_TPU_TASKS),
                    c.get(SEMAPHORE_ACQUIRE_TIMEOUT_MS))
            return cls._instance

    @classmethod
    def get(cls) -> "TpuSemaphore":
        return cls.initialize()

    @classmethod
    def reset(cls, conf: Optional[RapidsConf] = None) -> "TpuSemaphore":
        with cls._lock:
            cls._instance = None
        return cls.initialize(conf)

    def holder_names(self) -> list:
        with self._holders_lock:
            return sorted(self._holders.values())

    # -- reference API: acquireIfNecessary / releaseIfNecessary ------------
    def acquire_if_necessary(self) -> None:
        depth = getattr(self._local, "depth", 0)
        if depth == 0:
            if self.timeout_ms > 0:
                t0 = time.monotonic()
                if not self._sem.acquire(timeout=self.timeout_ms / 1e3):
                    waited_ms = (time.monotonic() - t0) * 1e3
                    held = ", ".join(self.holder_names()) \
                        or "<released during wait>"
                    raise TpuSemaphoreTimeout(
                        f"thread {threading.current_thread().name!r} gave "
                        f"up acquiring the TPU semaphore after "
                        f"{waited_ms:.0f}ms "
                        f"(spark.rapids.tpu.sql.semaphore.acquireTimeoutMs"
                        f"={self.timeout_ms}); {self.permits} permit(s), "
                        f"held by: {held}")
            else:
                self._sem.acquire()
            with self._holders_lock:
                self._holders[threading.get_ident()] = \
                    threading.current_thread().name
        self._local.depth = depth + 1

    def release_if_necessary(self) -> None:
        depth = getattr(self._local, "depth", 0)
        if depth <= 0:
            return
        depth -= 1
        self._local.depth = depth
        if depth == 0:
            with self._holders_lock:
                self._holders.pop(threading.get_ident(), None)
            self._sem.release()

    def __enter__(self):
        self.acquire_if_necessary()
        return self

    def __exit__(self, *exc):
        self.release_if_necessary()
        return False
