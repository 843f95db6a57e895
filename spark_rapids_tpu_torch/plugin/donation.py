"""Buffer donation: the certification table, the batch-exclusivity
protocol, the release, and the runtime witness.

Counterpart of ``spark_rapids_tpu/plugin/donation.py``. The reference
hands an input plane's HBM to XLA (``donate_argnums``) so a program's
outputs and temporaries can reuse it. Eager PyTorch has no program to
hand it to; what it has is the caching allocator. Donation here means:
once a certified site's last read of an exclusive input batch is
enqueued, the site releases that batch's plane storages, and the
allocator can reuse them for the site's outputs and temporaries (and
for the next batch's upload) instead of holding them until the batch
object dies. Three layers, as in the reference:

1. **The certification table** (:data:`DONATION_SPECS`): for every site
   of the reference, whether its input batch is dead after the site (and
   how the site squares with split-and-retry) or why it is not.
2. **The exclusivity protocol** (:func:`mark_exclusive` / :func:`claim`):
   only batches their producer marked exclusive donate — the fused
   chain's outputs, the join's outputs and the host-resident scan's
   fresh uploads — and a consumer that retains a batch past its own
   dispatch claims it first. Dictionary columns never donate: their
   pools are shared by every batch of the column. An output that reuses
   a non-exclusive input's tensor (a projection passing a column
   through) is not marked (:func:`mark_fresh`).
3. **The retry contract** (:func:`guard`): under
   ``donation.retrySnapshot.enabled`` the donated planes are copied to
   the host before the dispatch and put back if it fails, so
   split-and-retry re-reads the batch it is owed; with snapshots off the
   retry-covered sites do not donate.

The release (:func:`release_batches`): a storage is released only when
every tensor that holds it belongs to the donated batch — its planes and
their view bases — which ``torch._C._storage_Use_Count`` confirms. A
storage shared with the site's outputs, with another batch (the typed
views ``io/arrow_convert.packed_upload`` cuts from one upload, the pieces
``columnar/split.py`` cuts from one batch) or with anything else is kept,
and counts nothing. Each holder is then emptied with ``Tensor.set_()``,
which drops its storage: the last drop returns the block to the caching
allocator. (``untyped_storage().resize_(0)`` frees the same block but
leaves every view's sizes over an empty storage, and a later read
dereferences freed memory — a segfault on the CPU, an illegal address on
the card; an emptied tensor reads as zero elements, which raises.) The
allocator reuses a freed block in stream order, so a release is safe
only on the stream its reads were enqueued on: the engine enqueues
everything on each device's default stream (no module of the port sets
a stream — the host-prefetch pool, the serving sessions' threads and the
mesh's per-shard loops included), and a release from any other current
stream releases nothing.

The witness (``tools.donation.witness.enabled``, or
``SRTPU_DONATION_WITNESS=1``) requires that each donating dispatch
released at least one storage, and turns a later read of a released
plane (``exec/base.vals_of_batch``, the engine's one read of a batch's
planes) into :class:`TpuDonationViolation` naming the donating site and
op. Off, a dispatch pays one module-global read for it.
"""
from __future__ import annotations

import os
import threading
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from .. import conf as _conf
from .. import events as _events
from .. import obs as _obs

__all__ = [
    "DonationSpec", "DONATION_SPECS", "certified_sites",
    "TpuDonationViolation", "mark_exclusive", "is_exclusive", "claim",
    "mark_fresh", "batch_donatable", "dispatch_mask", "guard",
    "release_batches", "check_readable", "snapshot_counters",
    "counters_since", "witness_enabled", "enabled",
]


class DonationSpec:
    """One site's donation certification (or refusal).

    ``argnums`` — the site's arguments proven dead after it (argnum 0 is
    the per-batch plane set at every certified site; empty: not
    certified). ``retry`` — how the site squares donation with
    split-and-retry: ``"snapshot"`` or ``None`` for uncertified sites.
    ``reason`` — the safety argument over the port's own code."""

    __slots__ = ("site", "argnums", "retry", "reason")

    def __init__(self, site: str, argnums: Tuple[int, ...],
                 retry: Optional[str], reason: str):
        self.site = site
        self.argnums = argnums
        self.retry = retry
        self.reason = reason

    @property
    def certified(self) -> bool:
        return bool(self.argnums)


DONATION_SPECS: Dict[str, DonationSpec] = {s.site: s for s in [
    DonationSpec(
        "fused_chain", (0,), "snapshot",
        "exec/base.run_fused_chain's attempt reads vals_of_batch(b) once "
        "and lowers the chain over those values; the output batch is "
        "built from the chain's results (batch_from_vals) and b is not "
        "read again. A column the chain passes through keeps its "
        "storage (it is the output's too). Runs under with_oom_retry, "
        "hence snapshot mode."),
    DonationSpec(
        "project", (0,), "snapshot",
        "The same per-batch shape as fused_chain: a standalone projection "
        "is a one-exec fused chain (exec/base.run_fused_chain) and reads "
        "its input's planes once."),
    DonationSpec(
        "agg_update", (0,), "snapshot",
        "exec/aggregate._run_batch reads the batch's planes once (the "
        "chain, the keys and the values lowered from vals_of_batch); the "
        "partial is a new batch and the input is not read again. "
        "Dispatched under with_oom_retry, hence snapshot mode."),
    DonationSpec(
        "agg_plan", (0,), "snapshot",
        "exec/aggregate._run_fused_plan reads every buffered batch once "
        "and reduces them to partials in one call; the device-OOM "
        "fallback (flush_buffered) re-reads the buffered batches, so the "
        "release waits for the plan's success — hence snapshot mode."),
    DonationSpec(
        "agg_stage", (), None,
        "The fused stage (exec/aggregate._run_fused_stage) decodes each "
        "row group itself and drops the decode once its partial exists; "
        "its inputs are the scan's staged pages, which the scan cache "
        "may retain, so no argument is provably dead."),
    DonationSpec(
        "agg_merge", (), None,
        "with_oom_retry_nosplit re-runs the merge over the SAME partials "
        "list on retry, and the sync-free merge and the string merge "
        "read partials the caller still holds."),
    DonationSpec(
        "join", (0,), "snapshot",
        "Only the probe batch donates, after its last read: "
        "exec/join._probe_batch reads its planes for the count phase and "
        "the expand phase's gathers (semi and anti joins: the filter), "
        "and the nested-loop join's _expand for its gathers. The build "
        "side is retained across every probe batch and never donates. "
        "Probe batches run under with_oom_retry, hence snapshot mode."),
    DonationSpec(
        "sort", (), None,
        "The sort buffers every input batch until the partition ends and "
        "gathers the buffered planes after its key pass read them: no "
        "single read is the last."),
    DonationSpec(
        "window", (), None,
        "Window frames re-read the partition's planes once per "
        "function; the partition buffer outlives each pass."),
    DonationSpec(
        "exchange", (), None,
        "The exchange retains batches in partition buffers across the "
        "shuffle boundary and may serve them twice under retry; "
        "retention is the operator's purpose."),
    DonationSpec(
        "pq_unpack", (), None,
        "The parquet device decode reads planes the device scan cache "
        "owns; residency is the point of the cache."),
]}


def certified_sites() -> Tuple[str, ...]:
    return tuple(s.site for s in DONATION_SPECS.values() if s.certified)


class TpuDonationViolation(RuntimeError):
    """A donating dispatch released nothing, or a released plane was
    read afterwards: the certification and what ran disagree. Carries
    the site and op; raised only under the witness."""

    def __init__(self, site: str, op: Optional[str], detail: str):
        self.site = site
        self.op = op
        super().__init__(
            f"donation violation at site={site!r}"
            + (f" op={op!r}" if op else "") + f": {detail}")


# ---------------------------------------------------------------------------
# Exclusivity protocol
# ---------------------------------------------------------------------------
def mark_exclusive(batch):
    """Producer side: this batch's planes are held by nobody but the
    consumer it is yielded to. Returns the batch."""
    try:
        batch.exclusive = True
    except AttributeError:
        pass  # foreign batch types carry no flag
    return batch


def is_exclusive(batch) -> bool:
    return bool(getattr(batch, "exclusive", False))


def claim(batch):
    """Consumer side: take shared ownership of a batch this operator
    retains past its own dispatch, so no later site releases planes it
    still holds. Returns the batch."""
    if getattr(batch, "exclusive", False):
        batch.exclusive = False
    return batch


def _plane_tensors(batch) -> List[Tuple[Any, str, Any]]:
    """(column, slot, tensor) of every plane of a batch's non-dictionary
    columns."""
    out = []
    for c in getattr(batch, "columns", ()):
        if getattr(c, "is_dict", False):
            continue
        for slot in ("data", "validity", "offsets", "chars"):
            t = getattr(c, slot, None)
            if t is not None:
                out.append((c, slot, t))
    return out


def _storage_key(t) -> Tuple[str, int]:
    return (str(t.device), t.untyped_storage().data_ptr())


def mark_fresh(out, inputs):
    """Mark ``out`` exclusive (a producer's output) unless it holds a
    storage of an input that is not exclusive itself: eager torch passes
    a column through as the same tensor, which the input's holders (the
    scan cache, a retained batch) still read. Returns ``out``."""
    if out is None:
        return out
    if not isinstance(inputs, (list, tuple)):
        inputs = (inputs,)
    shared = {_storage_key(t) for b in inputs if not is_exclusive(b)
              for _, _, t in _plane_tensors(b) if t.numel()}
    for c in getattr(out, "columns", ()):
        if getattr(c, "is_dict", False):
            continue
        for slot in ("data", "validity", "offsets", "chars"):
            t = getattr(c, slot, None)
            if t is not None and t.numel() and _storage_key(t) in shared:
                return out
    return mark_exclusive(out)


def _has_dict_columns(batch) -> bool:
    for c in getattr(batch, "columns", ()):
        if getattr(c, "is_dict", False):
            return True
    return False


def batch_donatable(batch) -> bool:
    """A batch's planes may donate iff its producer marked it exclusive
    and no column is dictionary-encoded."""
    return is_exclusive(batch) and not _has_dict_columns(batch)


def _get(conf, entry):
    return entry.default if conf is None else conf.get(entry)


def enabled(conf=None) -> bool:
    return bool(_get(conf, _conf.DONATION_ENABLED))


def snapshot_mode(conf=None) -> bool:
    return bool(_get(conf, _conf.DONATION_RETRY_SNAPSHOT))


_WITNESS_ENV = os.environ.get("SRTPU_DONATION_WITNESS", "") == "1"
_WITNESS_SESSION = False


def install_witness() -> None:
    """Turn the runtime donation witness on (process-global,
    idempotent; a TpuSession under tools.donation.witness.enabled)."""
    global _WITNESS_SESSION
    _WITNESS_SESSION = True


def uninstall_witness() -> None:
    global _WITNESS_SESSION
    _WITNESS_SESSION = False


def witness_enabled() -> bool:
    return _WITNESS_ENV or _WITNESS_SESSION


def dispatch_mask(site: str, batches, conf=None) -> Tuple[int, ...]:
    """The donated arguments of ONE dispatch at ``site`` over
    ``batches`` (a batch or a sequence bound to argnum 0): empty unless
    donation is on, the site is certified, and every batch is exclusive
    and dictionary-free."""
    if not enabled(conf):
        return ()
    spec = DONATION_SPECS.get(site)
    if spec is None or not spec.certified:
        return ()
    if spec.retry == "snapshot" and not snapshot_mode(conf):
        # exclusion mode: retried args must not donate
        return ()
    if not isinstance(batches, (list, tuple)):
        batches = (batches,)
    if not batches:
        return ()
    for b in batches:
        if not batch_donatable(b):
            return ()
    return spec.argnums


# ---------------------------------------------------------------------------
# Donated-bytes accounting (events / obs / the exec metric)
# ---------------------------------------------------------------------------
_COUNTER_LOCK = threading.Lock()
_DONATED_BYTES: Dict[str, int] = {}
_DONATED_PLANES: Dict[str, int] = {}
#: bytes this thread released, for the cost plane's ``alias_bytes``
_THREAD = threading.local()


def _note_donation(site: str, op: Optional[str], nbytes: int,
                   planes: int) -> None:
    with _COUNTER_LOCK:
        _DONATED_BYTES[site] = _DONATED_BYTES.get(site, 0) + nbytes
        _DONATED_PLANES[site] = _DONATED_PLANES.get(site, 0) + planes
    _THREAD.bytes = getattr(_THREAD, "bytes", 0) + nbytes
    if _events.enabled():
        _events.emit("donation", site=site, op=op or "", bytes=nbytes,
                     planes=planes)
    if _obs.enabled():
        _obs.inc("tpu_donated_bytes", nbytes, site=site)


def thread_donated_bytes() -> int:
    """Bytes released on this thread so far."""
    return getattr(_THREAD, "bytes", 0)


def snapshot_counters() -> Dict[str, int]:
    """Cumulative donated bytes per site."""
    with _COUNTER_LOCK:
        return dict(_DONATED_BYTES)


def counters_since(snap: Dict[str, int]) -> Dict[str, int]:
    with _COUNTER_LOCK:
        return {k: v - snap.get(k, 0)
                for k, v in _DONATED_BYTES.items() if v - snap.get(k, 0)}


def reset_counters() -> None:
    with _COUNTER_LOCK:
        _DONATED_BYTES.clear()
        _DONATED_PLANES.clear()


# ---------------------------------------------------------------------------
# The release and the witness's read check
# ---------------------------------------------------------------------------
#: id of a released plane -> (a weak reference to it, site, op), kept only
#: under the witness (a tensor's ``==`` is elementwise, so tensors cannot
#: key a WeakKeyDictionary)
_RELEASED: Dict[int, Tuple[Any, str, Optional[str]]] = {}
_RELEASED_LOCK = threading.Lock()


def _forget(key: int):
    def drop(_ref):
        with _RELEASED_LOCK:
            _RELEASED.pop(key, None)
    return drop


def _on_default_stream(t) -> bool:
    if t.device.type != "cuda":
        return True
    import torch

    return torch.cuda.current_stream(t.device) == \
        torch.cuda.default_stream(t.device)


def release_batches(batches, site: str = "", op: Optional[str] = None,
                    keep=None) -> Tuple[int, int]:
    """Release every storage of ``batches``' planes that nothing outside
    them holds (module docstring) and that no tensor reachable from
    ``keep`` (the site's outputs) uses: an output that passes a column
    through holds the input's very tensor, which the storage's use count
    cannot see. Returns (bytes, planes) released."""
    import torch

    use_count = getattr(torch._C, "_storage_Use_Count", None)
    if use_count is None:
        return 0, 0
    from ..kernel_cost import tensors_of

    if not isinstance(batches, (list, tuple)):
        batches = (batches,)
    kept = {key[:2] for key in tensors_of(keep)}
    groups: Dict[Tuple[str, int], Dict[int, Any]] = {}
    planes_of: Dict[Tuple[str, int], int] = {}
    for b in batches:
        for _, _, t in _plane_tensors(b):
            if not t.numel() or not _on_default_stream(t):
                continue
            key = _storage_key(t)
            if key in kept:
                continue
            holders = groups.setdefault(key, {})
            if id(t) not in holders:
                planes_of[key] = planes_of.get(key, 0) + 1
            holders[id(t)] = t
            base = t._base
            if base is not None:
                holders[id(base)] = base
    nbytes = planes = 0
    witness = witness_enabled()
    for key, holders in groups.items():
        any_t = next(iter(holders.values()))
        st = any_t.untyped_storage()
        # one count is ``st`` itself
        if use_count(st._cdata) - 1 != len(holders):
            continue
        size = st.nbytes()
        del st
        for t in holders.values():
            if witness:
                with _RELEASED_LOCK:
                    _RELEASED[id(t)] = (weakref.ref(t, _forget(id(t))),
                                        site, op)
            t.set_()
        nbytes += size
        planes += planes_of.get(key, 0)
    return nbytes, planes


def check_readable(batch) -> None:
    """Under the witness: raise :class:`TpuDonationViolation` when a
    plane of ``batch`` was released by a donating site."""
    for _, slot, t in _plane_tensors(batch):
        with _RELEASED_LOCK:
            hit = _RELEASED.get(id(t))
        if hit is not None and hit[0]() is t:
            _, site, op = hit
            raise TpuDonationViolation(
                site, op, f"read of a released {slot} plane (the batch was "
                "donated, then read again)")


def _snapshot_planes(tensors) -> List[Any]:
    """Host copies of the donated planes for the guard's restore leg
    (one device-to-host copy each; a ``transfer`` event when logging)."""
    out = [t.to("cpu", copy=True) for t in tensors]
    if _events.enabled() or _obs.enabled():
        nb = sum(int(t.numel() * t.element_size()) for t in out)
        _events.emit("transfer", direction="d2h", bytes=nb,
                     site="donation_snapshot")
        if _obs.enabled():
            _obs.inc("tpu_transfers", 1, direction="d2h")
            _obs.inc("tpu_transfer_bytes", nb, direction="d2h")
    return out


class Donated:
    """What one guarded dispatch released (filled in at the guard's
    exit); the body sets ``keep`` to the site's outputs, whose storages
    are never released."""

    __slots__ = ("bytes", "planes", "keep")

    def __init__(self):
        self.bytes = 0
        self.planes = 0
        self.keep = None


@contextmanager
def guard(site: str, batches, op: Optional[str] = None,
          snapshot: Optional[bool] = None, conf=None, metric=None):
    """Wrap ONE donating dispatch at ``site``. Entry: under snapshot
    mode, copies every plane of ``batches`` to the host. The body runs
    the site and sets the yielded :class:`Donated`'s ``keep`` to its
    outputs. Exit on success: releases what the batches alone hold and
    the outputs do not use (:func:`release_batches`), counts it (the ``donation`` event, its
    live twin, ``metric`` — the exec's ``donatedBytes``) and, under the
    witness, requires that something was released. Exit on failure:
    puts the host copies back into the batches' columns, so a retry
    re-reads the input it is owed, and re-raises. Yields a
    :class:`Donated`."""
    if not isinstance(batches, (list, tuple)):
        batches = (batches,)
    handles = [h for b in batches for h in _plane_tensors(b)]
    want = snapshot if snapshot is not None else snapshot_mode(conf)
    snaps = _snapshot_planes([h[2] for h in handles]) if want else None
    done = Donated()
    try:
        yield done
    except Exception:
        if snaps is not None:
            for (c, slot, t), host in zip(handles, snaps):
                setattr(c, slot, host.to(t.device, copy=True))
        raise
    nbytes, planes = release_batches(batches, site, op, keep=done.keep)
    done.keep = None
    done.bytes, done.planes = nbytes, planes
    _note_donation(site, op, nbytes, planes)
    if metric is not None:
        metric.add(nbytes)
    if witness_enabled() and handles and planes == 0:
        held = sum(int(h[2].numel() * h[2].element_size()) for h in handles)
        raise TpuDonationViolation(
            site, op, f"no plane storage was released after the dispatch "
            f"({held} bytes across {len(handles)} planes still held): "
            "another tensor shares every storage")

