"""Buffer catalog with tiered DEVICE -> HOST -> DISK spill.

Counterpart of ``spark_rapids_tpu/memory/catalog.py`` (reference analog:
RapidsBufferCatalog.scala:34-109, RapidsBufferStore.scala:40,
SpillPriorities.scala:26, DeviceMemoryEventHandler.scala:33). Pressure
is tracked by accounting: each registered buffer adds the bytes its
tensors hold (what the CUDA caching allocator counts as allocated, not
what it has reserved) to the device tier, and :meth:`BufferCatalog.request`
spills the lowest-priority buffers until the budget holds. A spill is
``.to("cpu")`` (and ``np.save`` for the disk tier); a buffer comes back
to its own device when it is used. The device copy is freed once no
other reference holds its tensors.

The catalog holds its buffers weakly: a handle that is garbage collected
without a ``close()`` (a join build or broadcast batch of a plan that is
gone) unregisters itself, where the reference's catalog keeps every such
buffer for the life of the process (ROADMAP.md §C). Its finalizer only
queues the buffer's id on a deque, which takes no lock: a collection can
run at any bytecode, under any lock, the event and registry leaf locks
included. The catalog's next ordinary entry (register, unregister,
request, the watermark reads) and the session's query end drain the
queue, so the buffer's ``buffer_free`` is emitted from a normal call path.

Each spill, unspill and disk move emits a ``spill`` event (with the live
device-byte watermark and, while the ledger is armed, the buffer's
ledger id) and its ``tpu_spills``/``tpu_spill_bytes`` twins, and every
change of the watermark sets the ``tpu_hbm_*`` gauges, as in the
reference (``catalog.py:150-410``). The catalog's lock ranks above the
ledger's and the event and registry locks (``utils/locks.py``), so it
emits while holding it.
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import weakref
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from .. import events as _events
from .. import obs as _obs
from ..conf import (HBM_BUDGET_BYTES, HBM_POOL_FRACTION, HBM_RESERVE,
                    HOST_SPILL_STORAGE_SIZE, MEMORY_DEBUG, SPILL_ENABLED,
                    RapidsConf)
from ..utils.locks import ordered_lock
from .ledger import Ledger

log = logging.getLogger("spark_rapids_tpu_torch.memory")

# tier ordering (reference: RapidsBuffer.scala:54-61 StorageTier)
TIER_DEVICE = 0
TIER_HOST = 1
TIER_DISK = 2

# spill priorities (reference: SpillPriorities.scala:26)
HOST_MEMORY_BUFFER_SPILL_PRIORITY = -100
INPUT_FROM_SHUFFLE_PRIORITY = -50
ACTIVE_BATCHING_PRIORITY = 0


def derive_hbm_budget(conf_: RapidsConf, device=None) -> Optional[int]:
    """The device-tier spill budget: explicit hbm.budgetBytes, else
    allocFraction * the CUDA device's total memory - reserve (from
    ``torch.cuda.mem_get_info``), else None (unlimited: a CPU device, or
    no card)."""
    explicit = conf_.get(HBM_BUDGET_BYTES)
    if explicit:
        return int(explicit)
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else None)
    if dev is None or dev.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(dev)
    frac = conf_.get(HBM_POOL_FRACTION)
    reserve = conf_.get(HBM_RESERVE)
    return max(int(total * frac) - reserve, 1 << 20)


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class SpillMetrics:
    def __init__(self):
        self.device_to_host = 0
        self.host_to_disk = 0
        self.spilled_bytes = 0
        #: buffers brought back to the device after a spill
        self.unspills = 0
        #: high-water mark of catalog-tracked device bytes
        self.peak_device_bytes = 0


class _Slot:
    """The catalog's record of one buffer; it outlives its handle, so a
    collected handle can still be unregistered."""

    __slots__ = ("ref", "size", "tier", "lid", "disk_path")

    def __init__(self, handle: "SpillableHandle"):
        self.ref = weakref.ref(handle)
        self.size = handle.size
        self.tier = TIER_DEVICE
        self.lid: Optional[int] = None
        self.disk_path: Optional[str] = None


class BufferCatalog:
    """Process-wide registry of spillable buffers (reference:
    RapidsBufferCatalog.singleton). Buffers register with a byte size and
    a spill priority; ``request(nbytes)`` spills lowest-priority device
    buffers until the budget holds the new allocation."""

    _instance: Optional["BufferCatalog"] = None
    _instance_lock = threading.Lock()

    def __init__(self, conf_: Optional[RapidsConf] = None, device=None):
        self.conf = conf_ or RapidsConf({})
        self._lock = ordered_lock("memory.catalog", reentrant=True)
        self._buffers: Dict[int, _Slot] = {}
        self._next_id = 0
        self._device_bytes = 0
        self._host_bytes = 0
        self.metrics = SpillMetrics()
        self._spill_dir: Optional[str] = None
        #: ids of handles collected without a close(), queued by their
        #: finalizers and unregistered by :meth:`drain_collected`
        self._collected: deque = deque()
        #: the device type the budget was derived for
        self.device_type = (torch.device(device).type if device is not None
                            else "cuda" if torch.cuda.is_available()
                            else "cpu")
        self._budget = derive_hbm_budget(self.conf, device)
        #: per-buffer lifecycle book (armed while events or obs are on, or
        #: by ``ledger.force_arm``)
        self.ledger = Ledger(self.conf)

    @classmethod
    def get(cls) -> "BufferCatalog":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = BufferCatalog()
            return cls._instance

    @classmethod
    def reset(cls, conf_: Optional[RapidsConf] = None,
              device=None) -> "BufferCatalog":
        """Re-initialize (tests, a session with other memory confs)."""
        with cls._instance_lock:
            cls._instance = BufferCatalog(conf_, device)
            return cls._instance

    @property
    def budget(self) -> Optional[int]:
        """The live spill budget (None = unlimited): the watchdog's
        pressure rule and the /status HBM block read it too."""
        return self._budget

    def _obs_watermark(self) -> None:
        """Mirror the device-byte watermark into the live registry (a
        leaf-lock callee: safe under self._lock)."""
        _obs.set_gauge("tpu_hbm_device_bytes", self._device_bytes)
        _obs.set_gauge("tpu_hbm_peak_device_bytes",
                       self.metrics.peak_device_bytes)
        if self._budget is not None:
            _obs.set_gauge("tpu_hbm_budget_bytes", self._budget)

    # -- registration ------------------------------------------------------
    def register(self, handle: "SpillableHandle") -> _Slot:
        self.drain_collected()
        with self._lock:
            bid = self._next_id
            self._next_id += 1
            slot = _Slot(handle)
            self._buffers[bid] = slot
            handle._id, handle._slot = bid, slot
            self._device_bytes += handle.size
            if self._device_bytes > self.metrics.peak_device_bytes:
                self.metrics.peak_device_bytes = self._device_bytes
            if self.conf.get(MEMORY_DEBUG):
                log.info("register buffer %d (%d B, prio %d): device=%d B",
                         bid, handle.size, handle.priority,
                         self._device_bytes)
            if _obs.enabled():
                self._obs_watermark()
            if self.ledger.armed():
                slot.lid = self.ledger.note_alloc(
                    handle.size, kind=handle.ledger_kind)
        self.request(0)
        return slot

    def drain_collected(self) -> None:
        """Unregister the handles the garbage collector freed since the
        last drain (their finalizers queued their ids)."""
        while self._collected:
            try:
                bid = self._collected.popleft()
            except IndexError:  # another thread drained it first
                return
            self._unregister(bid, "gc")

    def unregister(self, bid: int, reason: str = "close") -> None:
        self.drain_collected()
        self._unregister(bid, reason)

    def _unregister(self, bid: int, reason: str) -> None:
        with self._lock:
            slot = self._buffers.pop(bid, None)
            if slot is None:
                return
            if slot.tier == TIER_DEVICE:
                self._device_bytes -= slot.size
            elif slot.tier == TIER_HOST:
                self._host_bytes -= slot.size
            if _obs.enabled():
                self._obs_watermark()
            self.ledger.note_free(slot.lid, reason)
        if slot.disk_path:
            shutil.rmtree(slot.disk_path, ignore_errors=True)

    def _handles(self, tier: int) -> list:
        """The live handles on ``tier``."""
        with self._lock:
            hs = [sl.ref() for sl in self._buffers.values()
                  if sl.tier == tier]
        return [h for h in hs if h is not None]

    def on_unspill(self, h: "SpillableHandle", from_host: bool) -> None:
        with self._lock:
            if from_host:
                self._host_bytes -= h.size
            self._device_bytes += h.size
            self.metrics.unspills += 1
            if self._device_bytes > self.metrics.peak_device_bytes:
                self.metrics.peak_device_bytes = self._device_bytes
            if _events.enabled():
                _events.emit("spill", kind="unspill", bytes=h.size,
                             device_bytes=self._device_bytes,
                             bid=h._slot.lid)
            if _obs.enabled():
                _obs.inc("tpu_spills", 1, kind="unspill")
                _obs.inc("tpu_spill_bytes", h.size, kind="unspill")
                self._obs_watermark()
            self.ledger.note_unspill(h._slot.lid)
        # the buffer just brought back is the one in use: spill others
        self.request(0, exclude=h)

    # -- pressure ----------------------------------------------------------
    def _account_device_spill(self, freed: int, emergency: bool,
                              handle: "SpillableHandle") -> None:
        """The device->host spill bookkeeping, shared by the proactive
        path (:meth:`request`) and OOM recovery (:meth:`ensure_headroom`)."""
        with self._lock:
            self._device_bytes -= freed
            self._host_bytes += freed
            self.metrics.device_to_host += 1
            self.metrics.spilled_bytes += freed
            lid = handle._slot.lid
            if _events.enabled():
                _events.emit("spill", kind="device_to_host", bytes=freed,
                             device_bytes=self._device_bytes, bid=lid)
            if _obs.enabled():
                _obs.inc("tpu_spills", 1, kind="device_to_host")
                _obs.inc("tpu_spill_bytes", freed, kind="device_to_host")
                self._obs_watermark()
            self.ledger.note_spill(lid)
        if self.conf.get(MEMORY_DEBUG):
            log.info("%sspilled %d B to host (device=%d B)",
                     "emergency " if emergency else "", freed,
                     self._device_bytes)

    def _drain_host_overage(self) -> None:
        """Push host-tier buffers to disk while the tier exceeds
        host.spillStorageSize (budget-independent)."""
        host_cap = self.conf.get(HOST_SPILL_STORAGE_SIZE)
        hosts = sorted(self._handles(TIER_HOST), key=lambda h: h.priority
                       ) if self._host_bytes > host_cap else []
        for h in hosts:
            with self._lock:
                if self._host_bytes <= host_cap:
                    break
            freed = h.spill_to_disk(self._disk_dir())
            if freed:
                with self._lock:
                    self._host_bytes -= freed
                    self.metrics.host_to_disk += 1
                    if _events.enabled():
                        _events.emit("spill", kind="host_to_disk",
                                     bytes=freed,
                                     device_bytes=self._device_bytes)
                    if _obs.enabled():
                        _obs.inc("tpu_spills", 1, kind="host_to_disk")
                        _obs.inc("tpu_spill_bytes", freed,
                                 kind="host_to_disk")

    def _victims(self, exclude):
        return sorted((h for h in self._handles(TIER_DEVICE)
                       if not h.pinned and h is not exclude),
                      key=lambda h: h.priority)

    def request(self, nbytes: int,
                exclude: Optional["SpillableHandle"] = None) -> None:
        """Make room for an upcoming allocation of ``nbytes`` (the
        DeviceMemoryEventHandler analog, invoked proactively). Victims
        are picked under the catalog lock and spilled outside it."""
        self.drain_collected()
        if self._budget is None or not self.conf.get(SPILL_ENABLED):
            return
        with self._lock:
            need = self._device_bytes + nbytes - self._budget
        victims = self._victims(exclude) if need > 0 else []
        for h in victims:
            if need <= 0:
                break
            freed = h.spill_to_host()
            if freed:
                self._account_device_spill(freed, False, h)
                need -= freed
        self._drain_host_overage()

    def ensure_headroom(self, nbytes: Optional[int] = None,
                        exclude: Optional["SpillableHandle"] = None) -> int:
        """Emergency spill for OOM recovery (``memory/retry.py``): drain
        unpinned device-tier buffers to host until ``nbytes`` are freed,
        or all of them when ``nbytes`` is None. Ignores the budget; the
        host tier's cap still holds. Returns bytes freed."""
        if not self.conf.get(SPILL_ENABLED):
            return 0
        total = 0
        for h in self._victims(exclude):
            if nbytes is not None and total >= nbytes:
                break
            freed = h.spill_to_host()
            if freed:
                total += freed
                self._account_device_spill(freed, True, h)
        self._drain_host_overage()
        return total

    def largest_spillable(self) -> int:
        """Size of the largest unpinned device-tier buffer (0: none)."""
        return max((h.size for h in self._handles(TIER_DEVICE)
                    if not h.pinned), default=0)

    def _disk_dir(self) -> str:
        with self._lock:
            if self._spill_dir is None:
                self._spill_dir = tempfile.mkdtemp(prefix="srt_spill_")
            return self._spill_dir

    @property
    def device_bytes(self) -> int:
        self.drain_collected()
        return self._device_bytes

    @property
    def host_bytes(self) -> int:
        self.drain_collected()
        return self._host_bytes


class SpillableHandle:
    """One spillable set of named tensors that round-trips DEVICE -> HOST
    (CPU tensors) -> DISK (``.npy`` files) and back to the device it came
    from (reference: RapidsBuffer.scala:63-140)."""

    def __init__(self, arrays: Dict[str, torch.Tensor], priority: int = 0,
                 catalog: Optional[BufferCatalog] = None,
                 ledger_kind: str = "spillable"):
        self._catalog = catalog or BufferCatalog.get()
        #: ledger record kind: sites whose buffers outlive the query on
        #: purpose (join builds, broadcast batches) declare "plan_state"
        self.ledger_kind = ledger_kind
        self._device: Optional[Dict[str, torch.Tensor]] = dict(arrays)
        self._host: Optional[Dict[str, torch.Tensor]] = None
        self._home = {k: v.device for k, v in arrays.items()}
        self.priority = priority
        self.pinned = False
        self.size = sum(tensor_bytes(a) for a in arrays.values())
        self._closed = False
        # guards tier transitions; the catalog never holds its lock while
        # calling in here
        self._tlock = threading.RLock()
        self._id = -1
        self._slot: _Slot
        self._catalog.register(self)
        # a handle collected without close() queues its id for the
        # catalog's next drain; the finalizer itself takes no lock
        self._finalizer = weakref.finalize(
            self, self._catalog._collected.append, self._id)

    @property
    def tier(self) -> int:
        return self._slot.tier

    @tier.setter
    def tier(self, t: int) -> None:
        self._slot.tier = t

    def spill_to_host(self) -> int:
        with self._tlock:
            if self.tier != TIER_DEVICE or self._closed:
                return 0
            self._host = {k: v.to("cpu") for k, v in self._device.items()}
            self._device = None
            self.tier = TIER_HOST
            return self.size

    def spill_to_disk(self, dirpath: str) -> int:
        with self._tlock:
            if self.tier != TIER_HOST or self._closed:
                return 0
            path = os.path.join(dirpath, f"buf{self._id}")
            os.makedirs(path, exist_ok=True)
            for i, v in enumerate(self._host.values()):
                np.save(os.path.join(path, f"{i}.npy"), v.numpy())
            self._slot.disk_path = path
            self._host = None
            self.tier = TIER_DISK
            return self.size

    def _load_disk(self) -> Dict[str, torch.Tensor]:
        path = self._slot.disk_path
        out = {k: torch.from_numpy(np.load(os.path.join(path, f"{i}.npy")))
               for i, k in enumerate(self._home)}
        shutil.rmtree(path, ignore_errors=True)
        self._slot.disk_path = None
        return out

    def materialize(self) -> Dict[str, torch.Tensor]:
        """The tensors on their own device again (re-registering the
        device bytes); reference SpillableColumnarBatch.getColumnarBatch."""
        with self._tlock:
            if self._closed:
                raise ValueError("buffer already closed")
            if self.tier == TIER_DEVICE:
                return self._device
            from_disk = self.tier == TIER_DISK
            if from_disk:
                self._host = self._load_disk()
            dev = {k: v.to(self._home[k]) for k, v in self._host.items()}
            self._device = dev
            self._host = None
            self.tier = TIER_DEVICE
        self._catalog.on_unspill(self, from_host=not from_disk)
        return dev

    def close(self, reason: str = "close") -> None:
        # under the tier lock, so a close cannot interleave with a spill
        with self._tlock:
            if self._closed:
                return
            self._closed = True
            self._finalizer.detach()
            self._catalog.unregister(self._id, reason=reason)
            self._device = None
            self._host = None
