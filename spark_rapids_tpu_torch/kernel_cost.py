"""The cost plane: what one dispatch of a site costs on the card.

Counterpart of ``spark_rapids_tpu/xla_cost.py``. The reference harvests
XLA's cost and memory analyses of each compiled program at its first
call. The port compiles no programs at its sites, so a "program" here is
one (site, signature) dispatch at the places the reference names a
compile site (``fused_chain``, ``project``, ``agg_update``, ``agg_plan``,
``agg_stage``, ``agg_merge``, ``join``, ``sort``, ``window``,
``exchange``, ``pq_decode``, ``upload_unpack``, the ``mesh_*`` stages),
reached through ``exec/base.site_call``. The signature is the input
batches' column types and capacities and the site's strategy;
:func:`digest_of` names it.

While :func:`harvesting` is true (the event log or the live obs plane is
on, or :data:`FORCE_HARVEST` is set), the first call of each (site,
digest) in the process is harvested, once, into ONE ``program_cost``
event with the reference's fields (and its obs twins), followed by its
``hlo_summary`` twin (``kernel_summary.py``). A warm call emits nothing
and pays nothing (the recompile-guard contract). The harvested call runs
exactly once, as any other call would:

* ``trace_ms`` is the call's host time, ``compile_ms`` the time of any
  kernel library built or loaded during it (0 when none was;
  ``ops/_cuda_build.load_stats``), with ``from_cache``/``saved_ms`` when
  the library came from the kernel-library cache;
* the device time comes from two ``torch.cuda.Event``s around the call,
  with one synchronization, at the harvest's end only (in the record
  table as ``device_ms``: the event schema has no such field);
* ``bytes_accessed`` and ``flops`` are the attribution's totals
  (``kernel_summary.py``: recorded shapes for torch ops, each hand
  kernel's byte model), ``argument_bytes`` and ``output_bytes`` the
  planes in and out, ``alias_bytes`` the bytes donated in the call
  (``plugin/donation.py``), ``temp_bytes`` the allocator's rise above
  the call's start, read from ``torch.cuda.memory_stats`` (None when the
  call set no new peak: the engine never resets the peak, so a rise
  below an earlier peak cannot be seen);
* the peaks that stamp every event (``peak_hbm_gbps``, ``peak_tflops``)
  are the conf's or else the card's, from one source:
  ``conf.DEVICE_PEAKS`` and ``conf.DEVICE_PEAK_TFLOPS``
  (:data:`BACKEND_PEAKS`), so ``tools/tpu_profile.py``'s roofline reads
  the card's peaks from the log.

The profiler and the CUDA events are process-wide resources, so
harvests are serialized by one lock: a first call on another thread
waits for the running harvest, and a site reached inside a harvest on
the same thread is part of it, not a harvest of its own. CUPTI records
every thread's kernels, but the attribution follows the profiler's
per-thread op tree down from the harvest's marker range, so kernels
another thread launches during the window are never charged to the
harvested site (``kernel_summary.py``). A profiler that cannot start —
one already running, such as a caller's own ``torch.profiler`` session —
records no summary and never fails the query.

Zero-overhead contract: with the event log and obs off and
:data:`FORCE_HARVEST` unset, :func:`harvesting` is false, the site pays
one call of it, and no CUDA event is created, no profiler started and
nothing synchronized (``tests/test_torch_kernel_cost.py`` pins this with
spies). The hand-kernel wrappers' :func:`kernel_launch` is one
module-global read then.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import events as _events
from .conf import (DEVICE_PEAK_TFLOPS, DEVICE_PEAKS, HLO_TOP_K,
                   ROOFLINE_PEAK_HBM_GBPS, ROOFLINE_PEAK_TFLOPS)
from .memory.ledger import current_op

#: (peak GB/s, peak TFLOP/s) per backend name (``envinfo``: "gpu" for a
#: CUDA card) when the roofline confs are 0.0
BACKEND_PEAKS: Dict[str, Tuple[float, float]] = {
    "gpu": (DEVICE_PEAKS["cuda"], DEVICE_PEAK_TFLOPS["cuda"]),
    "cpu": (DEVICE_PEAKS["cpu"], DEVICE_PEAK_TFLOPS["cpu"]),
}

#: explicitly conf-set peaks, recorded by the session at execute time
#: (process-global, last writer wins, as the reference's)
_CONF_PEAKS: Optional[Tuple[float, float]] = None
#: the conf-declared top-K of the summaries (None: the entry's default)
_TOP_K: Optional[int] = None


def set_conf_peaks(conf_) -> None:
    global _CONF_PEAKS
    g = conf_.get(ROOFLINE_PEAK_HBM_GBPS)
    t = conf_.get(ROOFLINE_PEAK_TFLOPS)
    _CONF_PEAKS = (g, t) if (g or t) else None


def set_conf_top_k(conf_) -> None:
    global _TOP_K
    _TOP_K = int(conf_.get(HLO_TOP_K))


def peaks(backend: str) -> Tuple[float, float]:
    """(GB/s, TFLOP/s): the conf's where set, else the backend's."""
    dg, dt = BACKEND_PEAKS.get(backend, BACKEND_PEAKS["cpu"])
    g, t = _CONF_PEAKS or (0.0, 0.0)
    return (g or dg, t or dt)


# ---------------------------------------------------------------------------
# Harvest gating + the in-process record tables
# ---------------------------------------------------------------------------
#: bench/harness opt-in: harvest with events and obs off (records land
#: only in the in-process tables). Not a user conf.
FORCE_HARVEST = False

_LOCK = threading.Lock()
_RECORDS: deque = deque(maxlen=8192)
_SUMMARIES: deque = deque(maxlen=8192)
_SEQ = 0
#: (site, digest) pairs harvested in this process
_SEEN: set = set()

COST_FIELDS = ("flops", "bytes_accessed", "temp_bytes", "argument_bytes",
               "output_bytes", "alias_bytes")

_OBS_MOD = None


def harvesting() -> bool:
    """True while first calls should be harvested: two module-global
    reads when everything is off."""
    global _OBS_MOD
    if FORCE_HARVEST:
        return True
    if _events.enabled():
        return True
    mod = _OBS_MOD
    if mod is None:
        with _LOCK:
            if _OBS_MOD is None:
                from . import obs

                _OBS_MOD = obs
            mod = _OBS_MOD
    return mod.enabled()


def snapshot() -> int:
    """Monotonic record sequence: snapshot before a run, pass to
    :func:`records_since` after."""
    with _LOCK:
        return _SEQ


def records_since(seq: int = 0) -> List[dict]:
    with _LOCK:
        return [dict(r) for r in _RECORDS if r["seq"] > seq]


def summaries_since(seq: int = 0) -> List[dict]:
    with _LOCK:
        return [dict(r) for r in _SUMMARIES if r["seq"] > seq]


def digest_of(key: Any) -> str:
    """Stable short digest of a signature: the program's identity across
    the event log, obs and reports."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


def reset_seen() -> None:
    """Forget which (site, digest) pairs were harvested (tests; a rerun
    in the same process otherwise emits nothing)."""
    with _LOCK:
        _SEEN.clear()


def _backend(dev) -> str:
    from . import envinfo

    return envinfo.environment_info(dev).get("backend") or "cpu"


def note_program_cost(site: str, digest: str, trace_ns: int,
                      compile_ns: int, cost: Dict[str, Any],
                      op: Optional[str] = None, backend: str = "cpu"
                      ) -> dict:
    """Record one harvested call: the in-process table always, the typed
    ``program_cost`` event and its obs twins when those are on."""
    global _SEQ
    rec: Dict[str, Any] = {
        "site": site, "digest": digest, "backend": backend,
        "trace_ms": round(trace_ns / 1e6, 3),
        "compile_ms": round(compile_ns / 1e6, 3),
        "op": op,
    }
    g, t = peaks(backend)
    rec["peak_hbm_gbps"] = g
    rec["peak_tflops"] = t
    rec.update(cost)
    with _LOCK:
        _SEQ += 1
        rec["seq"] = _SEQ
        _RECORDS.append(rec)
    if _events.enabled():
        ev = {k: rec.get(k) for k in
              ("site", "digest", "backend", "trace_ms", "compile_ms")
              + COST_FIELDS}
        for k in ("op", "out_bytes", "generated_code_bytes",
                  "peak_hbm_gbps", "peak_tflops", "from_cache",
                  "saved_ms"):
            if rec.get(k) is not None:
                ev[k] = rec[k]
        _events.emit("program_cost", **ev)
    from . import obs as _obs

    if _obs.enabled():
        _obs.note_program_cost(site, trace_ns / 1e9, compile_ns / 1e9,
                               rec.get("temp_bytes"))
    return rec


def note_summary(site: str, digest: str, summary: Dict[str, Any],
                 op: Optional[str], backend: str,
                 bytes_accessed: Optional[float]) -> dict:
    """Record one call's attribution: the table, the ``hlo_summary``
    event (the reference's fields) and its obs twins."""
    global _SEQ
    from .kernel_summary import SUMMARY_FIELDS

    rec: Dict[str, Any] = {"site": site, "digest": digest, "op": op,
                           "backend": backend}
    rec.update(summary)
    measured = sum(r["bytes"] for r in summary.get("top_fusions", ())
                   if r.get("device_ms"))
    # the share of the attributed bytes whose rows the profiler measured
    rec["accounted_frac"] = (round(measured / bytes_accessed, 4)
                             if bytes_accessed else None)
    with _LOCK:
        _SEQ += 1
        rec["seq"] = _SEQ
        _SUMMARIES.append(rec)
    if _events.enabled():
        ev = {k: rec[k] for k in ("site", "digest", "backend")
              + SUMMARY_FIELDS}
        for k in ("op", "accounted_frac"):
            if rec.get(k) is not None:
                ev[k] = rec[k]
        _events.emit("hlo_summary", **ev)
    from . import obs as _obs

    if _obs.enabled():
        top = rec["top_fusions"][0]["bytes"] if rec["top_fusions"] else 0
        _obs.note_hlo_summary(site, rec["scatter_count"], top)
    return rec


# ---------------------------------------------------------------------------
# The hand kernels' launch hook
# ---------------------------------------------------------------------------
#: True while any thread runs a harvest (the wrappers' one read)
_ANY_ACTIVE = False
_ACTIVE = threading.local()
_NULL = contextlib.nullcontext()


class _Launch:
    """One hand-kernel launch inside a harvest: its ``srt::<name>``
    profiler range and, on the card, a CUDA event pair around it on the
    launch's stream (the row's device time when the profiler's trace
    gives it none)."""

    __slots__ = ("_rf", "_evs")

    def __init__(self, name: str, cuda: bool, events: list):
        import torch

        self._rf = torch.profiler.record_function("srt::" + name)
        self._evs = None
        if cuda:
            self._evs = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            events.append(self._evs)

    def __enter__(self):
        self._rf.__enter__()
        if self._evs is not None:
            self._evs[0].record()
        return self

    def __exit__(self, *exc):
        if self._evs is not None:
            self._evs[1].record()
        return self._rf.__exit__(*exc)


def kernel_launch(name: str, model: Callable[[], Any]):
    """Context manager around one hand-kernel launch (its wrapper's):
    inside a harvest on this thread, a ``srt::<name>`` profiler range,
    CUDA events around the launch on the card, and the kernel's byte
    model (a thunk, evaluated after the call's one synchronization);
    otherwise nothing."""
    if not _ANY_ACTIVE:
        return _NULL
    h = getattr(_ACTIVE, "harvest", None)
    if h is None:
        return _NULL
    h.notes.setdefault(name, []).append(model)
    return _Launch(name, h.cuda, h.launch_events.setdefault(name, []))


# ---------------------------------------------------------------------------
# The harvest of one call
# ---------------------------------------------------------------------------
_HARVEST_LOCK = threading.RLock()


def tensors_of(obj, out: Optional[dict] = None) -> dict:
    """Every non-empty tensor reachable from a batch, a column, a value,
    or a container of them, keyed by (device, storage, offset), so a
    tensor held twice counts once."""
    import torch

    out = {} if out is None else out
    if obj is None:
        return out
    if isinstance(obj, torch.Tensor):
        if obj.numel():
            out.setdefault((str(obj.device), obj.untyped_storage().data_ptr(),
                            obj.storage_offset()), obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            tensors_of(x, out)
    elif getattr(obj, "columns", None) is not None:
        for c in obj.columns:
            tensors_of(c, out)
    else:
        for slot in ("data", "validity", "offsets", "chars", "codes",
                     "dictionary", "dictv"):
            v = getattr(obj, slot, None)
            if v is not None and v is not obj:
                tensors_of(v, out)
    return out


def plane_bytes(obj) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in tensors_of(obj).values()))


def _device_of(obj):
    return next((t.device for t in tensors_of(obj).values()), None)


def _kineto_dtypes(prof) -> Dict[int, list]:
    """Operand dtypes by profiler event id, from the raw trace: some
    torch builds leave ``FunctionEvent.input_dtypes`` unset."""
    try:
        return {k.correlation_id(): list(k.dtypes())
                for k in prof.profiler.kineto_results.events()}
    except Exception:  # noqa: BLE001
        return {}


class Harvest:
    """The first call of one (site, digest): :meth:`run` wraps the call
    (CUDA events, memory stats, the profiler), :meth:`emit` records it
    once the site's donation, if any, is done."""

    def __init__(self, site: str, digest: str, op: Optional[str], inputs,
                 device=None):
        self.site = site
        self.digest = digest
        self.op = op
        self.argument_bytes = plane_bytes(inputs)
        self.dev = _device_of(inputs) or device
        self.notes: Dict[str, List[Callable[[], Any]]] = {}
        self.launch_events: Dict[str, list] = {}
        self.cuda = self.dev is not None and self.dev.type == "cuda"
        self.summary: Optional[Dict[str, Any]] = None
        self.device_ms: Optional[float] = None
        self.temp_bytes: Optional[int] = None
        self.trace_ns = 0
        self.compile_ns = 0
        self.from_cache = False
        self.saved_ms = 0.0

    def run(self, work: Callable[[], Any]):
        global _ANY_ACTIVE
        import torch

        from .ops import _cuda_build

        cuda = self.dev is not None and self.dev.type == "cuda"
        marker = f"srt.harvest:{self.site}:{self.digest}"
        loads0 = _cuda_build.load_stats()
        ev0 = ev1 = None
        alloc0 = peak0 = 0
        if cuda:
            st = torch.cuda.memory_stats(self.dev)
            alloc0 = st.get("allocated_bytes.all.current", 0)
            peak0 = st.get("allocated_bytes.all.peak", 0)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
        prof = rf = None
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts, record_shapes=True)
            prof.__enter__()
            rf = torch.profiler.record_function(marker)
            rf.__enter__()
        except Exception:  # noqa: BLE001 - a harvest never fails a query
            rf = None
            if prof is not None:
                try:
                    prof.__exit__(None, None, None)
                except Exception:  # noqa: BLE001
                    pass
            prof = None
        _ACTIVE.harvest = self
        _ANY_ACTIVE = True
        if ev0 is not None:
            ev0.record()
        t0 = time.perf_counter_ns()
        try:
            out = work()
        finally:
            self.trace_ns = time.perf_counter_ns() - t0
            if ev1 is not None:
                ev1.record()
            _ACTIVE.harvest = None
            _ANY_ACTIVE = False
            if rf is not None:
                try:
                    rf.__exit__(None, None, None)
                except Exception:  # noqa: BLE001
                    prof = None
            if ev1 is not None:
                ev1.synchronize()  # the harvest's one sync
            if prof is not None:
                try:
                    prof.__exit__(None, None, None)
                except Exception:  # noqa: BLE001
                    prof = None
        if ev1 is not None:
            self.device_ms = ev0.elapsed_time(ev1)
            st = torch.cuda.memory_stats(self.dev)
            peak1 = st.get("allocated_bytes.all.peak", 0)
            self.temp_bytes = (max(0, peak1 - alloc0) if peak1 > peak0
                               else None)
        loads1 = _cuda_build.load_stats()
        self.compile_ns = loads1[0] - loads0[0]
        self.from_cache = loads1[1] > loads0[1]
        self.saved_ms = loads1[2] - loads0[2]
        notes = {}
        for name, models in self.notes.items():
            vals = []
            for m in models:
                try:
                    vals.append(int(m()))
                except Exception:  # noqa: BLE001
                    vals.append(0)
            notes[name] = vals
        event_ms = {name: [a.elapsed_time(b) for a, b in pairs]
                    for name, pairs in self.launch_events.items()}
        if prof is not None:
            from . import kernel_summary

            try:
                self.summary = kernel_summary.summarize_profile(
                    prof.events(), marker, notes,
                    top_k=_TOP_K or HLO_TOP_K.default,
                    dtypes_of=_kineto_dtypes(prof), event_ms=event_ms)
            except Exception:  # noqa: BLE001
                self.summary = None
        return out

    def emit(self, out, alias_bytes: int = 0) -> dict:
        backend = _backend(self.dev) if self.dev is not None else "cpu"
        s = self.summary or {}
        cost = {
            "flops": s.get("flops"),
            "bytes_accessed": s.get("total_bytes"),
            "temp_bytes": self.temp_bytes,
            "argument_bytes": self.argument_bytes,
            "output_bytes": plane_bytes(out),
            "alias_bytes": int(alias_bytes),
            "device_ms": self.device_ms,
        }
        if self.from_cache:
            cost["from_cache"] = True
            cost["saved_ms"] = round(self.saved_ms, 3)
        rec = note_program_cost(self.site, self.digest, self.trace_ns,
                                self.compile_ns, cost, op=self.op,
                                backend=backend)
        if self.summary is not None:
            summary = {k: v for k, v in self.summary.items()
                       if k not in ("flops", "kernel_rows")}
            srec = note_summary(self.site, self.digest, summary, self.op,
                                backend, rec.get("bytes_accessed"))
            rec["kernel_rows"] = self.summary.get("kernel_rows", [])
            srec["kernel_rows"] = rec["kernel_rows"]
        return rec


def begin(site: str, key_fn: Callable[[], Any], inputs,
          op: Optional[str] = None, device=None) -> Optional[Harvest]:
    """A :class:`Harvest` for this call when it is the first of its
    (site, digest) in the process and no harvest runs on this thread;
    else None. ``device``: the plan's, for a site with no input batch
    (a fused stage, a mesh stage). The caller holds
    :data:`_HARVEST_LOCK` from here to the harvest's end
    (:func:`harvested`)."""
    if getattr(_ACTIVE, "harvest", None) is not None \
            or getattr(_ACTIVE, "depth", 0):
        return None
    digest = digest_of((site,) + tuple(key_fn()))
    with _LOCK:
        if (site, digest) in _SEEN:
            return None
        _SEEN.add((site, digest))
    if device is not None:
        import torch

        device = torch.device(device)
    return Harvest(site, digest, op or current_op(), inputs, device)


def call(site: str, key_fn: Callable[[], Any], work: Callable[[], Any],
         inputs=(), device=None):
    """``work()``, one dispatch of a site that has no exec around it (the
    parquet decode, the upload), harvested like ``exec/base.site_call``'s
    (no donation)."""
    if not harvesting():
        return work()
    h = begin(site, key_fn, inputs, None, device)
    if h is None:
        return work()
    with harvested():
        out = h.run(work)
        h.emit(out)
    return out


@contextlib.contextmanager
def harvested():
    """Hold the harvest lock around one harvest (serialized across
    threads; reentrant, and a nested site on the same thread is part of
    the harvest that holds it)."""
    with _HARVEST_LOCK:
        _ACTIVE.depth = getattr(_ACTIVE, "depth", 0) + 1
        try:
            yield
        finally:
            _ACTIVE.depth -= 1
