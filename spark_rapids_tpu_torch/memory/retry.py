"""OOM retry and split-and-retry: the runtime recovery plane.

Counterpart of ``spark_rapids_tpu/memory/retry.py`` (reference analog:
RmmRapidsRetryIterator.scala's ``withRetry``/``withRetryNoSplit``). Each
exec's per-batch dispatch runs under :func:`with_oom_retry`: a device
allocation failure releases what the process can give back (spillable
catalog buffers, the device scan cache's residency, the caching
allocator's free blocks, the caller's ``on_pressure`` hook) and
re-attempts with bounded backoff; when the attempts run out, the input
batch splits row-wise in half (``columnar/split.py``) and both halves
recurse, to a bounded depth. The final exhaustion raises
:class:`TpuSplitAndRetryOOM` carrying the op, the catalog's watermark and
budget, the attempts and the split depth.

A device OOM is ``torch.cuda.OutOfMemoryError`` or the injector's
``InjectedOOM`` (``faults.py``), and nothing else: a kernel build or
launch failure, an illegal address or a compiler error surfaces
untouched. A failed attempt's exception keeps the attempt's frames, and
so its tensors, alive through its traceback; the harness drops the
traceback and re-attempts only after the handler has exited, so a retry
does not run with the first attempt's memory still held.

Each recovery action emits the reference's ``oom_retry`` event (kind
``retry`` or ``split``, with the catalog's watermark and budget) and its
``tpu_oom_retries`` twin, and each split a ``batch_split`` event and
``tpu_batch_splits``. Beside them, :func:`stats` counts the attempts,
retries, splits, deepest split and fused-plan fallbacks per op since
:func:`reset_stats`, with logging off too. Left out: the reference's
``_raise_if_donation_uaf`` (eager PyTorch donates no buffers).
"""
from __future__ import annotations

import contextlib
import gc
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from .. import events as _events
from .. import faults as _faults
from .. import obs as _obs
from ..conf import (OOM_RETRY_BACKOFF_MS, OOM_RETRY_ENABLED,
                    OOM_RETRY_MAX_ATTEMPTS, OOM_RETRY_MAX_SPLIT_DEPTH,
                    RapidsConf)

log = logging.getLogger("spark_rapids_tpu_torch.memory")

_TORCH_OOM = getattr(torch, "OutOfMemoryError", torch.cuda.OutOfMemoryError)


# ---------------------------------------------------------------------------
# Typed errors
# ---------------------------------------------------------------------------
class TpuOOMError(RuntimeError):
    """Base of the typed device-memory failures: the op, the catalog
    watermark and budget at failure, the attempts and the split depth."""

    def __init__(self, message: str, op: str = "",
                 watermark: Optional[int] = None,
                 budget: Optional[int] = None, attempts: int = 0,
                 split_depth: int = 0):
        super().__init__(message)
        self.op = op
        self.watermark = watermark
        self.budget = budget
        self.attempts = attempts
        self.split_depth = split_depth


class TpuRetryOOM(TpuOOMError):
    """A device OOM on a non-splittable path whose retries ran out."""


class TpuSplitAndRetryOOM(TpuOOMError):
    """Retries and split-and-retry ran out: the operator cannot complete
    even at 1/2^maxSplitDepth of its batch."""


class TpuOutOfDeviceMemory(TpuOOMError):
    """A device OOM outside the retry harness (scan decode, exchange
    staging, uploads), named with the op, the watermark, the budget and
    the largest spillable buffer."""


def is_device_oom(exc: BaseException) -> bool:
    """True for ``torch.cuda.OutOfMemoryError`` and the injector's
    ``InjectedOOM``. The typed verdicts are final (False), except
    :class:`TpuOutOfDeviceMemory`, a named device OOM that a surrounding
    harness may still fix by spilling."""
    if isinstance(exc, TpuOOMError):
        return isinstance(exc, TpuOutOfDeviceMemory)
    return isinstance(exc, (_TORCH_OOM, _faults.InjectedOOM))


def _hbm_state() -> tuple:
    from .catalog import BufferCatalog

    cat = BufferCatalog.get()
    return cat.device_bytes, cat.budget, cat.largest_spillable()


def classify_oom(exc: BaseException, op: str) -> Optional[TpuRetryOOM]:
    """The typed TpuRetryOOM of a device OOM (None for anything else)."""
    if not is_device_oom(exc):
        return None
    watermark, budget, _ = _hbm_state()
    return TpuRetryOOM(f"device OOM in {op}: {exc}", op=op,
                       watermark=watermark, budget=budget)


def _emit_retry(op: str, kind: str, attempt: int, depth: int) -> None:
    """The ``oom_retry`` event and its live twin (reference
    ``retry.py:161``)."""
    if _events.enabled() or _obs.enabled():
        watermark, budget, _ = _hbm_state()
        _events.emit("oom_retry", op=op, kind=kind, attempt=attempt,
                     depth=depth, watermark=watermark, budget=budget)
        if _obs.enabled():
            _obs.note_oom_retry(op, kind)


# ---------------------------------------------------------------------------
# Recovery counters, kept with logging off
# ---------------------------------------------------------------------------
_STATS: Dict[str, Dict[str, int]] = {}
_STATS_LOCK = threading.Lock()


def _note(op: str, **inc: int) -> None:
    with _STATS_LOCK:
        s = _STATS.setdefault(op, {"attempts": 0, "retries": 0,
                                   "splits": 0, "max_depth": 0})
        for k, v in inc.items():
            if k == "max_depth":
                s[k] = max(s[k], v)
            else:
                s[k] = s.get(k, 0) + v


def stats() -> Dict[str, Dict[str, int]]:
    """Per op since :func:`reset_stats`: harness attempts, retries (failed
    attempts), splits and the deepest split level reached; an aggregate
    whose fused plan fell back to the streaming path on a device OOM also
    counts ``fused_plan_fallback`` (the reference's event kind,
    ``exec/aggregate.py:1070``)."""
    with _STATS_LOCK:
        return {op: dict(s) for op, s in _STATS.items()}


def note_fallback(op: str, kind: str) -> None:
    """Count one fallback of ``kind`` at ``op`` in :func:`stats` (the
    reference emits it as an ``oom_retry`` event of that kind)."""
    _note(op, **{kind: 1})


def reset_stats() -> None:
    with _STATS_LOCK:
        _STATS.clear()


def _detach(e: BaseException) -> BaseException:
    """``e`` with its traceback (and its chain's) dropped, so the failed
    attempt's frames and tensors can be freed."""
    seen = set()
    x: Optional[BaseException] = e
    while x is not None and id(x) not in seen:
        seen.add(id(x))
        x.__traceback__ = None
        x = x.__cause__ or x.__context__
    return e


def _release_pressure(op: str,
                      on_pressure: Optional[Callable[[], None]]) -> int:
    """Give back what the process can: every spillable catalog buffer,
    the device scan cache's residency, cyclic garbage, the caching
    allocator's free blocks, and the caller's hook. Returns the bytes
    known released."""
    from ..io.scan_cache import DeviceScanCache
    from .catalog import BufferCatalog

    freed = BufferCatalog.get().ensure_headroom()
    cache = DeviceScanCache._instance
    if cache is not None:
        freed += cache.drop_under_pressure()
    # tensors that only cyclic garbage still holds (a failed attempt's
    # frames caught in a context manager's cycle) are freed by a
    # collection, not by their refcount
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    if on_pressure is not None:
        try:
            on_pressure()
        except Exception:  # pragma: no cover - a hook must not mask OOM
            log.exception("on_pressure hook failed during OOM recovery")
    return freed


def concat_batches(conf_: RapidsConf, batches: Sequence):
    """Split pieces' outputs re-joined row-wise through the engine's
    multi-batch concat (``exec/base.concat_batches``)."""
    from ..exec.base import concat_batches as _concat

    batches = [b for b in batches if b is not None]
    if len(batches) == 1:
        return batches[0]
    return _concat(batches[0].schema, batches, conf_.shape_bucket_min)


def _backoff(backoff_ms: int, attempt: int) -> None:
    if backoff_ms:
        time.sleep(backoff_ms / 1e3 * (1 << (attempt - 1)))


class _Harness:
    """One :func:`with_oom_retry` call's settings and attempt count (a
    plain object: a recursive closure would put the attempt function, and
    the tensors it captures, in a reference cycle)."""

    __slots__ = ("op", "fn", "on_pressure", "max_attempts", "backoff_ms",
                 "max_depth", "attempts")

    def __init__(self, op, fn, conf_, on_pressure):
        self.op = op
        self.fn = fn
        self.on_pressure = on_pressure
        self.max_attempts = conf_.get(OOM_RETRY_MAX_ATTEMPTS)
        self.backoff_ms = conf_.get(OOM_RETRY_BACKOFF_MS)
        self.max_depth = conf_.get(OOM_RETRY_MAX_SPLIT_DEPTH)
        self.attempts = 0


def _run_split(h: _Harness, b, depth: int) -> List:
    """Attempt ``b``; when the attempts run out, split it and recurse."""
    op = h.op
    last: Optional[BaseException] = None
    for attempt in range(1, h.max_attempts + 1):
        h.attempts += 1
        _note(op, attempts=1)
        try:
            if _faults.enabled():
                _faults.check("oom", op, cap=b.capacity)
            return [h.fn(b)]
        except Exception as e:  # noqa: BLE001 - filtered below
            if not is_device_oom(e):
                raise
            last = _detach(e)
        # the handler has exited: the attempt's frames are released
        _note(op, retries=1)
        _emit_retry(op, "retry", attempt, depth)
        freed = _release_pressure(op, h.on_pressure)
        log.warning(
            "device OOM in %s (attempt %d/%d, split depth %d): "
            "released %d B, retrying", op, attempt, h.max_attempts,
            depth, freed)
        _backoff(h.backoff_ms, attempt)
    n = b.num_rows
    if depth >= h.max_depth or n < 2:
        watermark, budget, _ = _hbm_state()
        raise TpuSplitAndRetryOOM(
            f"device OOM in {op}: {h.attempts} attempt(s) "
            f"exhausted at split depth {depth} "
            f"({n} row(s); watermark {watermark} B, budget "
            f"{budget if budget is not None else 'unlimited'}) — "
            f"last failure: {last}", op=op, watermark=watermark,
            budget=budget, attempts=h.attempts,
            split_depth=depth) from last
    from ..columnar import split_batch

    lo, hi = split_batch(b)
    _note(op, splits=1, max_depth=depth + 1)
    _emit_retry(op, "split", h.attempts, depth + 1)
    if _events.enabled():
        _events.emit("batch_split", op=op, depth=depth + 1, rows=n,
                     rows_left=lo.num_rows, rows_right=hi.num_rows)
    if _obs.enabled():
        _obs.note_batch_split(op)
    log.warning("split-and-retry in %s: %d rows -> %d + %d (depth %d)",
                op, n, lo.num_rows, hi.num_rows, depth + 1)
    out = _run_split(h, lo, depth + 1)
    del lo  # the first half's copy is not needed while the second runs
    return out + _run_split(h, hi, depth + 1)


def with_oom_retry(op: str, attempt_fn: Callable, batch,
                   conf_: RapidsConf,
                   combine: Union[str, Callable, None] = "concat",
                   on_pressure: Optional[Callable[[], None]] = None):
    """``attempt_fn(batch)`` under the retry and split-and-retry harness.

    ``combine`` shapes the result when a split happened:

      * ``"concat"`` (default): the pieces re-join row-wise into ONE
        batch (exact for row-local operators: project and filter chains);
      * ``"list"``: the per-piece outputs in row order (an aggregate's
        partials, a join probe's output batches); always a list;
      * a callable: a custom re-join (the sort re-sorts the stitched
        pieces); a device OOM inside it raises TpuSplitAndRetryOOM.
    """
    if not conf_.get(OOM_RETRY_ENABLED):
        out = attempt_fn(batch)
        return [out] if combine == "list" else out
    h = _Harness(op, attempt_fn, conf_, on_pressure)
    outs = _run_split(h, batch, 0)
    if combine == "list":
        return outs
    if len(outs) == 1:
        return outs[0]
    joiner = (combine if callable(combine)
              else (lambda pieces: concat_batches(conf_, pieces)))
    failed = None
    try:
        return joiner(outs)
    except Exception as e:  # noqa: BLE001 - filtered below
        if not is_device_oom(e):
            raise
        failed = _detach(e)
    watermark, budget, _ = _hbm_state()
    raise TpuSplitAndRetryOOM(
        f"device OOM in {op} while re-joining {len(outs)} split "
        f"piece(s): {failed}", op=op, watermark=watermark, budget=budget,
        attempts=h.attempts) from failed


def with_oom_retry_nosplit(op: str, fn: Callable, conf_: RapidsConf):
    """Retry-only harness for work that cannot split (the aggregate's
    merge): spill and back off between attempts, TpuRetryOOM when they
    run out (the reference's withRetryNoSplit)."""
    if not conf_.get(OOM_RETRY_ENABLED):
        return fn()
    max_attempts = conf_.get(OOM_RETRY_MAX_ATTEMPTS)
    backoff_ms = conf_.get(OOM_RETRY_BACKOFF_MS)
    last: Optional[BaseException] = None
    for attempt in range(1, max_attempts + 1):
        _note(op, attempts=1)
        try:
            if _faults.enabled():
                _faults.check("oom", op)
            return fn()
        except Exception as e:  # noqa: BLE001 - filtered below
            if not is_device_oom(e):
                raise
            last = _detach(e)
        _note(op, retries=1)
        _emit_retry(op, "retry", attempt, 0)
        _release_pressure(op, None)
        _backoff(backoff_ms, attempt)
    watermark, budget, _ = _hbm_state()
    raise TpuRetryOOM(
        f"device OOM in {op}: {max_attempts} attempt(s) exhausted on a "
        f"non-splittable path (watermark {watermark} B) — last failure: "
        f"{last}", op=op, watermark=watermark, budget=budget,
        attempts=max_attempts) from last


@contextlib.contextmanager
def named_oom(op: str):
    """A device OOM outside the retry harness (scan decode, exchange
    staging, uploads) re-raised as :class:`TpuOutOfDeviceMemory` naming
    the op, the watermark, the budget and the largest spillable buffer."""
    try:
        yield
    except Exception as e:  # noqa: BLE001 - filtered below
        if isinstance(e, TpuOOMError) or not is_device_oom(e):
            raise
        watermark, budget, largest = _hbm_state()
        raise TpuOutOfDeviceMemory(
            f"device allocation failed in {op}: {e} "
            f"(catalog watermark {watermark} B, budget "
            f"{budget if budget is not None else 'unlimited'}, largest "
            f"spillable {largest} B)", op=op, watermark=watermark,
            budget=budget) from e
