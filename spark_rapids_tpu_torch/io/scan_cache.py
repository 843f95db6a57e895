"""Device scan cache: a device-memory pool for hot file scans.

Own copy of ``DeviceScanCache`` of ``spark_rapids_tpu/io/scan_cache.py``:
a plain LRU by bytes over device tensors (whatever the scanner stores per
row group, with its byte count), keyed by :func:`file_key`, whose
(path, mtime, size) makes a rewritten file miss instead of serving stale
data. The reference's memory-catalog ledger, ordered locks, events and
observability are not ported; one lock guards the entries.

The process singleton follows the reference: a later session's
``scan.deviceCache.maxBytes`` resizes it (evicting when it shrank) instead
of the first session's budget pinning it, and ``get_instance`` returns
None for a conf with the cache off.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple


class DeviceScanCache:
    _instance: Optional["DeviceScanCache"] = None
    _instance_lock = threading.Lock()

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        #: key -> (value, nbytes)
        self._entries: "OrderedDict[tuple, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @classmethod
    def get_instance(cls, conf) -> Optional["DeviceScanCache"]:
        from ..conf import SCAN_DEVICE_CACHE, SCAN_DEVICE_CACHE_MAX_BYTES

        if not conf.get(SCAN_DEVICE_CACHE):
            return None
        budget = int(conf.get(SCAN_DEVICE_CACHE_MAX_BYTES))
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = DeviceScanCache(budget)
                return cls._instance
            inst = cls._instance
        if inst.max_bytes != budget:
            inst.resize(budget)
        return inst

    @classmethod
    def reset(cls) -> None:
        with cls._instance_lock:
            cls._instance = None

    def _evict_over_budget(self) -> None:
        while self._bytes > self.max_bytes and self._entries:
            _, (_, sz) = self._entries.popitem(last=False)
            self._bytes -= sz
            self.evictions += 1

    def resize(self, max_bytes: int) -> None:
        """Adopt a new byte budget, evicting LRU entries if it shrank."""
        with self._lock:
            self.max_bytes = int(max_bytes)
            self._evict_over_budget()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "entries": len(self._entries), "bytes": self._bytes,
                    "max_bytes": self.max_bytes}

    def get(self, key: tuple) -> Optional[Any]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return hit[0]

    def put(self, key: tuple, value: Any, nbytes: int) -> None:
        with self._lock:
            if key in self._entries:
                _, old = self._entries.pop(key)
                self._bytes -= old
            # one oversized entry must not wedge the pool
            if nbytes > self.max_bytes:
                return
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            self._evict_over_budget()


_REALPATH_CACHE: dict = {}


def _real(path: str) -> str:
    """``os.path.realpath`` with a process-lifetime memo: it lstat()s every
    path component, which some overlay filesystems make slow, and scan
    keys need it once per row group. The mtime/size in the key still
    guards against stale reads."""
    r = _REALPATH_CACHE.get(path)
    if r is None:
        if len(_REALPATH_CACHE) > 65536:
            _REALPATH_CACHE.clear()
        r = _REALPATH_CACHE[path] = os.path.realpath(path)
    return r


def file_key(path: str, rg: int, columns, cap_hint=None) -> tuple:
    """Cache key pinned to file identity: mtime and size catch rewrites;
    the real path lets one file reached through a symlink or a relative
    path share one entry. The stat runs on the live path."""
    st = os.stat(path)
    return (_real(path), int(st.st_mtime_ns), st.st_size, rg,
            tuple(columns), cap_hint)
