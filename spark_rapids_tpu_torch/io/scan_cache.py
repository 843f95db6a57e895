"""Device scan cache: a device-memory pool for hot file scans.

Own copy of ``DeviceScanCache`` of ``spark_rapids_tpu/io/scan_cache.py``:
a plain LRU by bytes over device tensors (whatever the scanner stores per
row group, with its byte count), keyed by :func:`file_key`, whose
(path, mtime, size) makes a rewritten file miss instead of serving stale
data. One lock guards the entries (``io.scan_cache`` in
``utils/locks.py``, above the ledger and the event and registry locks it
feeds); under device memory pressure the OOM retry drops them all
(:meth:`DeviceScanCache.drop_under_pressure`). While the ledger is armed
each entry has a ``scan_cache`` ledger record, freed with the reason it
left (evict, replace, pressure_drop, invalidate: a writer's commit
of the file, ``io/commit.py``), and every hit, miss, put, evict
and pressure drop emits a ``scan_cache`` event and its
``tpu_scan_cache_*`` twins, as in the reference.

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

from .. import events as _events
from .. import obs as _obs
from ..utils.locks import ordered_lock


def _ledger():
    from ..memory.catalog import BufferCatalog

    return BufferCatalog.get().ledger


class DeviceScanCache:
    _instance: Optional["DeviceScanCache"] = None
    _instance_lock = threading.Lock()

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._lock = ordered_lock("io.scan_cache")
        #: key -> (value, nbytes)
        self._entries: "OrderedDict[tuple, Tuple[Any, int]]" = OrderedDict()
        #: key -> (ledger, ledger id) of the entries made while the ledger
        #: was armed (the ledger kept: a later catalog reset brings another)
        self._lids: Dict[tuple, tuple] = {}
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
        """Drop the process's cache; its entries' ledger records are
        freed (reason ``reset``)."""
        with cls._instance_lock:
            old, cls._instance = cls._instance, None
        if old is not None:
            with old._lock:
                for key in list(old._lids):
                    old._free_lid(key, "reset")

    def _free_lid(self, key: tuple, reason: str) -> None:
        # under self._lock
        rec = self._lids.pop(key, None)
        if rec is not None:
            rec[0].note_free(rec[1], reason=reason)

    def _evict_over_budget(self) -> None:
        while self._bytes > self.max_bytes and self._entries:
            key, (_, sz) = self._entries.popitem(last=False)
            self._bytes -= sz
            self.evictions += 1
            self._free_lid(key, "evict")
            if _events.enabled():
                _events.emit("scan_cache", op="evict", bytes=sz)
            if _obs.enabled():
                self._obs_note("evict", sz)

    def _obs_note(self, op: str, nbytes: int) -> None:
        """Mirror one cache op into the live registry (called under
        self._lock; the registry lock is a leaf)."""
        _obs.inc("tpu_scan_cache_ops", 1, op=op)
        if op in ("hit", "miss"):
            seen = self.hits + self.misses
            _obs.set_gauge("tpu_scan_cache_hit_ratio",
                           self.hits / seen if seen else 0.0)
        _obs.set_gauge("tpu_scan_cache_resident_bytes", self._bytes)

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
                if _events.enabled():
                    _events.emit("scan_cache", op="miss", bytes=0)
                if _obs.enabled():
                    self._obs_note("miss", 0)
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            if _events.enabled():
                _events.emit("scan_cache", op="hit", bytes=hit[1])
            if _obs.enabled():
                self._obs_note("hit", hit[1])
            return hit[0]

    def drop_under_pressure(self) -> int:
        """Drop every resident entry (OOM recovery, ``memory/retry.py``;
        reference ``scan_cache.py:165``): cached scan columns are
        re-derivable device residency, the first thing to give back.
        Returns the bytes released; entries refill on the next scan."""
        with self._lock:
            freed = self._bytes
            self.evictions += len(self._entries)
            for key in list(self._lids):
                self._free_lid(key, "pressure_drop")
            self._entries.clear()
            self._bytes = 0
            if freed and _events.enabled():
                _events.emit("scan_cache", op="pressure_drop", bytes=freed)
            if freed and _obs.enabled():
                self._obs_note("evict", freed)
            return freed

    def invalidate_path(self, path: str) -> None:
        """Drop every entry of one file (the writers' commit protocol,
        ``io/commit.py``; reference ``scan_cache.py:185``): reads stay
        correct either way through the (mtime, size) key, this frees the
        device memory at once. The path is resolved as :func:`file_key`
        resolves it, so a commit through a symlink still finds the
        scanner's entries; their ledger records are freed with reason
        ``invalidate``."""
        path = _real(path)
        with self._lock:
            for key in [k for k in self._entries if k and k[0] == path]:
                _, sz = self._entries.pop(key)
                self._bytes -= sz
                self._free_lid(key, "invalidate")

    def put(self, key: tuple, value: Any, nbytes: int) -> None:
        with self._lock:
            if key in self._entries:
                _, old = self._entries.pop(key)
                self._bytes -= old
                self._free_lid(key, "replace")
            # one oversized entry must not wedge the pool
            if nbytes > self.max_bytes:
                return
            led = _ledger()
            if led.armed():
                self._lids[key] = (led, led.note_alloc(nbytes,
                                                       kind="scan_cache"))
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            if _events.enabled():
                _events.emit("scan_cache", op="put", bytes=nbytes)
            if _obs.enabled():
                self._obs_note("put", nbytes)
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
