"""Exec base class, metrics, and batch <-> value plumbing.

Counterpart of ``spark_rapids_tpu/exec/base.py``. An exec exposes
``num_partitions`` and ``execute_partition(i)``; fusable execs
(project, filter, a join on its fused fast path) implement ``lower_batch``
and run as one eager chain of torch calls per batch
(:func:`run_fused_chain`). PyTorch runs eagerly, so there is no ``jit`` and
no ``cached_pipeline``: the reference's compile sites are the places that
call :func:`site_call`, where the cost plane harvests a site's first call
per signature (``kernel_cost.py``) and a certified site donates an
exclusive input batch (``plugin/donation.py``).

Every exec times its hot sections with :meth:`TpuExec.op_timed` (the host
lane: ``totalTime``, an ``op_span`` event, the live open-span table and
op time) and records each output batch with :meth:`TpuExec.record_batch`
(rows, batches, ``bytesTouched``, ``op_batch``; under
``metrics.deviceSync.enabled`` also the device lane: a wait on the
batch's card into ``opTimeDevice``). With the event log, live metrics
and ``sql.trace.enabled`` off (the default), ``op_timed`` is the plain
timed context and ``record_batch`` neither emits nor synchronizes.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from .. import events as _events
from .. import kernel_cost as _kernel_cost
from .. import obs as _obs
from .. import types as T
from ..columnar import ColumnarBatch, DeviceColumn, choose_capacity
from ..conf import RapidsConf
from ..expr.eval import column_of_val, val_of_column
from ..expr.values import DictV, Val
from ..ops import concat as concat_ops
from ..memory.ledger import op_scope
from ..ops import filter_gather
from ..plugin import donation as _donation
from ..types import StructType

NUM_OUTPUT_ROWS = "numOutputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"
TOTAL_TIME = "totalTime"
#: device-accurate per-op time under metrics.deviceSync.enabled (the wait
#: for the op's own output batch on its card)
OP_TIME_DEVICE = "opTimeDevice"
#: output bytes per op: rows x row-bytes from the batch layout
BYTES_TOUCHED = "bytesTouched"
#: input plane bytes an op's certified sites released (plugin/donation.py)
DONATED_BYTES = "donatedBytes"


_PLANNING = threading.local()


@contextlib.contextmanager
def planning_mode():
    """Marks plan construction: adaptive reads report their static
    partition count instead of materializing their stage (reference
    ``exec/base.py:242``)."""
    prev = getattr(_PLANNING, "on", False)
    _PLANNING.on = True
    try:
        yield
    finally:
        _PLANNING.on = prev


def in_planning() -> bool:
    return getattr(_PLANNING, "on", False)


class Metric:
    """One named counter; 'ns' metrics render as ms, 'bytes' as MB."""

    __slots__ = ("name", "value", "kind")

    def __init__(self, name: str, kind: Optional[str] = None):
        self.name = name
        self.value = 0
        if kind is None:
            if "Time" in name or name == TOTAL_TIME:
                kind = "ns"
            elif name.startswith("bytes") or name.endswith("Bytes"):
                kind = "bytes"
            else:
                kind = "count"
        self.kind = kind

    def add(self, v: int) -> None:
        self.value += v

    def set(self, v: int) -> None:
        self.value = v

    def pretty(self) -> str:
        if self.kind == "ns":
            return f"{self.value / 1e6:.1f}ms"
        if self.kind == "bytes":
            return f"{self.value / 1e6:.1f}MB"
        return str(self.value)

    def __repr__(self):
        return f"{self.name}={self.value}"


@contextlib.contextmanager
def timed(metric: Optional[Metric], trace_name: str = "", trace: bool = False,
          event_op: Optional[str] = None, event_section: str = ""):
    """Time a hot section into a metric; optionally open a profiler range
    (reference ``exec/base.py:295``: the JAX profiler's TraceAnnotation;
    here ``torch.profiler.record_function``). ``event_op`` (set only while
    event logging is on) also emits a host-lane ``op_span`` event with the
    start and duration the metric accumulated."""
    ctx = (torch.profiler.record_function(
        trace_name or (metric.name if metric else "op"))
        if trace else contextlib.nullcontext())
    start = time.perf_counter_ns()
    try:
        with ctx:
            yield
    finally:
        dur = time.perf_counter_ns() - start
        if metric is not None:
            metric.add(dur)
        if event_op is not None:
            _events.emit("op_span", op=event_op, section=event_section,
                         start=start, dur=dur, lane="host")


@contextlib.contextmanager
def _op_scoped(inner, op: str):
    """Ownership wrapper (built only while events or obs are on): buffers
    the ledger records inside this exec's hot section carry op=<node_name>
    (reference ``exec/base.py:326``, over ``xla_cost.op_scope``)."""
    with op_scope(op):
        with inner:
            yield


@contextlib.contextmanager
def _obs_timed(inner, op: str, section: str):
    """op_timed's live-metrics wrapper (built ONLY while the obs plane is
    on): the open-span table is what the watchdog samples for stall
    detection, so registration precedes the body."""
    token = _obs.span_open(op, section)
    start = time.perf_counter_ns()
    try:
        with inner:
            yield
    finally:
        _obs.span_close(token)
        _obs.add_op_time(op, "host", time.perf_counter_ns() - start)


class TpuExec:
    """Base physical operator producing columnar batches."""

    #: True when this exec can lower into a shared fused chain
    fusable = False
    #: True when lower_batch may clear liveness bits (filters)
    sparsifies = False

    def __init__(self, conf: RapidsConf, children: Sequence["TpuExec"] = ()):
        from ..conf import ENABLE_TRACE, METRICS_DEVICE_SYNC

        self.conf = conf
        self._trace = conf.get(ENABLE_TRACE)
        self._device_sync = conf.get(METRICS_DEVICE_SYNC)
        self.children: List[TpuExec] = list(children)
        self.metrics: Dict[str, Metric] = {}
        for name in (NUM_OUTPUT_ROWS, NUM_OUTPUT_BATCHES, TOTAL_TIME):
            self.metrics[name] = Metric(name)
        #: named :meth:`op_timed` sections entered, with their counts (an
        #: aggregate's "stage", "plan", "update" and "merge" say which
        #: route it took)
        self.sections: Dict[str, int] = {}

    @property
    def output_schema(self) -> StructType:
        raise NotImplementedError(type(self).__name__)

    @property
    def device(self):
        """The plan's device: a leaf's own, inherited by every parent."""
        if not self.children:
            raise NotImplementedError(type(self).__name__)
        return self.children[0].device

    @property
    def num_partitions(self) -> int:
        if self.children:
            return self.children[0].num_partitions
        return 1

    def execute_partition(self, index: int) -> Iterator[ColumnarBatch]:
        raise NotImplementedError(type(self).__name__)

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        """All partitions, serially (driver-side collect path). Each
        partition holds the device concurrency semaphore while its work
        runs (reference ``exec/base.py:386``: GpuSemaphore)."""
        from ..memory.semaphore import TpuSemaphore

        sem = TpuSemaphore.initialize(self.conf)
        for p in range(self.num_partitions):
            sem.acquire_if_necessary()
            try:
                yield from self.execute_partition(p)
            finally:
                sem.release_if_necessary()

    def host_prefetch(self) -> None:
        """Serving-path pipelining hook (reference ``exec/base.py:402``):
        start this plan's host-side work (file reads, parquet decode on
        the prefetch pool) BEFORE the caller takes the device semaphore,
        so an admitted query's host phase overlaps the running query's
        device work. Default: recurse; scans override (``exec/scan.py``).
        Must not block on the work it starts and must be safe to call at
        most once per plan."""
        for c in self.children:
            c.host_prefetch()

    # -- fusion --------------------------------------------------------------
    def lower_batch(self, cols, live, cap):
        """(cols, live_mask) -> (cols, live_mask), eager torch ops. A
        fast-path join reads its build table from its own state."""
        raise NotImplementedError(type(self).__name__)

    def fusion_stream_child(self) -> Optional["TpuExec"]:
        """The child whose batches stream through this exec's lowering:
        a single-child exec's only child; a fast-path join's probe side
        (its build table is the join's own state)."""
        return self.children[0] if len(self.children) == 1 else None

    def fused_source_chain(self):
        """(source exec, [fusable execs bottom-up ending at self])."""
        node = self
        chain: List[TpuExec] = []
        while node.fusable:
            nxt = node.fusion_stream_child()
            if nxt is None:
                break
            chain.append(node)
            node = nxt
        return node, list(reversed(chain))

    # -- conveniences --------------------------------------------------------
    def metric(self, name: str, kind: Optional[str] = None) -> Metric:
        if name not in self.metrics:
            self.metrics[name] = Metric(name, kind)
        return self.metrics[name]

    def op_timed(self, section: str = "", metric_name: str = TOTAL_TIME):
        """Host wall-clock of a hot section into ``metric_name`` (reference
        ``exec/base.py:472``). Kernel launches are asynchronous, so this is
        enqueue time plus the time of the host syncs inside the section,
        not device time. ``section`` also counts in :attr:`sections`.
        Under ``sql.trace.enabled`` a ``torch.profiler.record_function``
        range named ``<exec>.<section>`` wraps it; with the event log on it
        emits a host-lane ``op_span``; with the obs plane on it registers
        in the open-span table and adds live op time; with either on,
        buffers registered in it are owned by this exec
        (:func:`memory.ledger.op_scope`). With all off it is the plain
        timed context."""
        if section:
            self.sections[section] = self.sections.get(section, 0) + 1
        name = self.node_name + ("." + section if section else "")
        ctx = timed(self.metric(metric_name), name, self._trace,
                    event_op=self.node_name if _events.enabled() else None,
                    event_section=section)
        if _obs.enabled():
            ctx = _obs_timed(ctx, self.node_name, section)
        if _events.enabled() or _obs.enabled():
            ctx = _op_scoped(ctx, self.node_name)
        return ctx

    def record_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Count one output batch (reference ``exec/base.py:509``): rows
        where the count is a host int, the batch, its ``bytesTouched``
        (:func:`batch_bytes` at those rows, else at its capacity), and with
        events or obs on its ``op_batch`` record and live counters. Under
        ``metrics.deviceSync.enabled`` it first waits for the batch's card
        (``torch.cuda.synchronize(device)``; nothing for a CPU batch) and
        records the wait as ``opTimeDevice``, a device-lane ``op_span``
        (section ``device_wait``) and a ``fence`` transfer; with the
        plan-wide conf the children's outputs were fenced already, so the
        wait is this op's own device work. The row count is then read
        (free: the card is idle)."""
        nr = batch.num_rows_lazy
        if self._device_sync:
            t0 = time.perf_counter_ns()
            dev = batch_device(batch)
            if dev is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter_ns() - t0
            self.metric(OP_TIME_DEVICE, "ns").add(dt)
            if _obs.enabled():
                _obs.add_op_time(self.node_name, "device", dt)
                _obs.inc("tpu_transfers", 1, direction="fence")
            if _events.enabled():
                _events.emit("op_span", op=self.node_name,
                             section="device_wait", start=t0, dur=dt,
                             lane="device")
                _events.emit("transfer", direction="fence", bytes=0,
                             site="record_batch")
            if not isinstance(nr, int):
                nr = int(nr)
        if isinstance(nr, int):
            self.metrics[NUM_OUTPUT_ROWS].add(nr)
        self.metrics[NUM_OUTPUT_BATCHES].add(1)
        by = batch_bytes(batch, nr if isinstance(nr, int) else None)
        self.metric(BYTES_TOUCHED, "bytes").add(by)
        if _events.enabled():
            _events.emit("op_batch", op=self.node_name,
                         rows=nr if isinstance(nr, int) else None, bytes=by)
        if _obs.enabled():
            _obs.note_op_batch(self.node_name,
                               nr if isinstance(nr, int) else None, by)
        return batch

    def collect(self) -> List[tuple]:
        """Columnar-to-row boundary for the whole plan."""
        rows: List[tuple] = []
        for batch in self.execute_columnar():
            rows.extend(batch.to_rows())
        return rows

    @property
    def node_name(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def describe(self) -> str:
        return self.node_name

    def program_signature(self) -> str:
        """What this exec computes, for the cost plane's signature
        (:func:`site_call`): its :meth:`describe` unless that also
        reports what a run chose."""
        return self.describe()

    def __repr__(self):
        return self.tree_string()


def format_metrics(plan: TpuExec) -> str:
    """Per-operator metrics report (reference ``exec/base.py:611``): one
    line per exec with its ``describe()`` and its non-zero metrics, plus
    a derived bandwidth labeled by the lane that fed it:
    ``hbm_gbps[device]`` (the op's input and output layout bytes over
    ``opTimeDevice``, deviceSync runs) whenever the device lane exists,
    else ``hbm_gbps[host]`` (over host wall-clock, which an asynchronous
    launch makes far smaller than the device work it queued, so the
    figure overstates bandwidth and says so). Then the
    :func:`memory_footer`. The reference's XLA cost columns and its
    compile-cache line have no counterpart here: the cost plane's
    harvests (``kernel_cost.records_since``) carry a site's costs."""
    lines: List[str] = []

    def walk(node: TpuExec, depth: int) -> None:
        parts = [f"{m.name}={m.pretty()}" for m in node.metrics.values()
                 if m.value]
        dev = node.metrics.get(OP_TIME_DEVICE)
        host = node.metrics.get(TOTAL_TIME)
        byt = node.metrics.get(BYTES_TOUCHED)
        if byt is not None and byt.value:
            # the bandwidth the op demanded: its input stream (the
            # children's output bytes) plus its own output
            io_bytes = byt.value + sum(
                c.metrics[BYTES_TOUCHED].value for c in node.children
                if isinstance(c, TpuExec) and BYTES_TOUCHED in c.metrics)
            if dev is not None and dev.value:
                parts.append(f"hbm_gbps[device]={io_bytes / dev.value:.2f}")
            elif host is not None and host.value:
                parts.append(f"hbm_gbps[host]={io_bytes / host.value:.2f}")
        lines.append("  " * depth + node.describe()
                     + (": " + ", ".join(parts) if parts else ""))
        for c in node.children:
            if isinstance(c, TpuExec):
                walk(c, depth + 1)

    walk(plan, 0)
    lines.append(memory_footer())
    return "\n".join(lines)


def memory_footer() -> str:
    """The explain_metrics memory line (reference ``exec/base.py:733``):
    the buffer catalog's live device bytes, the peak watermark and the
    spill/unspill story (process-wide: the catalog is a process
    singleton), and with the ledger armed the per-op peaks and leaks."""
    from ..memory.catalog import BufferCatalog

    cat = BufferCatalog.get()
    m = cat.metrics

    def mb(v: int) -> str:
        return f"{v / 1e6:.1f}MB"

    line = (f"memory: device {mb(cat.device_bytes)} "
            f"(peak {mb(m.peak_device_bytes)}), "
            f"spilled {mb(m.spilled_bytes)} in {m.device_to_host} "
            f"spill(s) ({m.host_to_disk} to disk), "
            f"{m.unspills} unspill(s)")
    peaks = {op: b for op, b in cat.ledger.op_peaks().items() if b > 0}
    if peaks:
        rows = sorted(peaks.items(), key=lambda kv: kv[1], reverse=True)
        line += "\nmemory by op (peak): " + ", ".join(
            f"{op} {mb(b)}" for op, b in rows)
        leaked = cat.ledger.stats()["leaked_live"]
        if leaked:
            line += f"; LEAKED {leaked} buffer(s)"
    return line


def batch_device(batch: ColumnarBatch) -> Optional[torch.device]:
    """The device of a batch's tensors (None for a batch with no column
    and a host row count)."""
    for c in batch.columns:
        return c.validity.device
    nr = batch.num_rows_lazy
    return nr.device if isinstance(nr, torch.Tensor) else None


def vals_of_batch(batch: ColumnarBatch) -> List[Val]:
    """The batch's columns as lowering values (a dictionary-encoded one
    as its DictV). Under the donation witness a released plane raises
    ``TpuDonationViolation`` here."""
    if _donation.witness_enabled():
        _donation.check_readable(batch)
    return [val_of_column(c) for c in batch.columns]


def _plan_device(exec_: "TpuExec"):
    try:
        return exec_.device
    except NotImplementedError:
        return None


def batch_signature_key(batches, *extra) -> tuple:
    """A site's signature: each input batch's column types and capacity,
    then ``extra`` (the site's strategy)."""
    if not isinstance(batches, (list, tuple)):
        batches = (batches,)
    return tuple((tuple(str(f.dataType) for f in b.schema.fields),
                  b.capacity) for b in batches) + extra


def site_call(exec_: "TpuExec", site: str, batches, work,
              key=None, donate: bool = False):
    """Run ``work()``, one dispatch of the compile site ``site`` over the
    input ``batches``, through the cost plane and donation: while
    ``kernel_cost.harvesting()``, the first call per (site, signature)
    in the process is harvested (``key()`` gives the signature's extra
    parts, :func:`batch_signature_key`, then the exec's
    ``program_signature()``); with ``donate`` and an
    exclusive input at a certified site, the inputs' storages are
    released once ``work`` returned (``plugin/donation.guard``, counted
    in the exec's ``donatedBytes``). With both off it is ``work()``."""
    mask = (_donation.dispatch_mask(site, batches, exec_.conf)
            if donate else ())
    harvest = None
    if _kernel_cost.harvesting():
        harvest = _kernel_cost.begin(
            site, lambda: batch_signature_key(
                batches, *(key() if key is not None else ()))
            + (exec_.program_signature(),),
            batches, exec_.node_name, _plan_device(exec_))
    if not mask and harvest is None:
        return work()
    ctx = (_kernel_cost.harvested() if harvest is not None
           else contextlib.nullcontext())
    with ctx:
        guard = (_donation.guard(site, batches, op=exec_.node_name,
                                 conf=exec_.conf,
                                 metric=exec_.metric(DONATED_BYTES, "bytes"))
                 if mask else contextlib.nullcontext(None))
        with guard as done:
            out = harvest.run(work) if harvest is not None else work()
            if done is not None:
                done.keep = out
        if harvest is not None:
            harvest.emit(out, done.bytes if done is not None else 0)
    return out


def materialized_batch(batch: ColumnarBatch) -> ColumnarBatch:
    """The batch with every dictionary-encoded column expanded to the
    plain string layout (reference ``exec/base.py:766``): the boundary of
    the execs with no dictionary path (sort and window keys, a join's
    build and its row-repeating expansion, a concat of batches)."""
    if not any(c.is_dict for c in batch.columns):
        return batch
    return ColumnarBatch([c.materialize() for c in batch.columns],
                         batch.schema, batch.num_rows_lazy)


def batch_from_vals(vals: Sequence[Val], schema: StructType, num_rows,
                    capacity: Optional[int] = None) -> ColumnarBatch:
    cols = [column_of_val(f.dataType, num_rows, v)
            for f, v in zip(schema.fields, vals)]
    return ColumnarBatch(cols, schema, num_rows, capacity=capacity)


def concat_all(exec_: TpuExec) -> Optional[ColumnarBatch]:
    """Every partition of an exec in ONE batch (the build side)."""
    batches: List[ColumnarBatch] = []
    for p in range(exec_.num_partitions):
        for b in exec_.execute_partition(p):
            if b.num_rows > 0:
                batches.append(b)
    return concat_batches(exec_.output_schema, batches)


def host_ints(xs: Sequence) -> List[int]:
    """Host ints and 0-d device tensors as host ints, with one sync for
    all the tensors among them."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    if not ts:
        return [int(x) for x in xs]
    dev = ts[0].device
    return [int(v) for v in torch.stack([
        torch.as_tensor(x, dtype=torch.int64, device=dev).reshape(())
        for x in xs]).tolist()]


def concat_batches(schema: StructType, batches: List[ColumnarBatch],
                    min_bucket: int = 128) -> Optional[ColumnarBatch]:
    """The live rows of ``batches`` in one batch (reference
    ``exec/join.py:213``). String columns splice their byte pools
    (``ops/concat.concat_batches_cols``): one host sync reads every
    batch's row count and string byte counts. Dictionary-encoded columns
    materialize first, since each batch has its own dictionary; a single
    batch passes through as it is."""
    if not batches:
        return None
    if len(batches) == 1:
        # the caller keeps it (a join's build): no site may release it
        return _donation.claim(batches[0])
    if any(c.is_dict for b in batches for c in b.columns):
        # expand only each batch's live rows (one more sync, for the row
        # counts): an aggregate's partial holds a few groups at its
        # input's capacity
        rows = host_ints([b.num_rows_lazy for b in batches])
        batches = [materialized_batch(head_rows(b, n))
                   for b, n in zip(batches, rows)]
    str_cols = [j for j, f in enumerate(schema.fields)
                if T.is_string(f.dataType)]
    heads = [b.num_rows_lazy for b in batches]
    for b in batches:
        n = b.num_rows_lazy
        for j in str_cols:
            c = b.columns[j]
            cap = c.offsets.shape[0] - 1
            heads.append(c.offsets[min(n, cap) if isinstance(n, int)
                                   else n.long().clamp(0, cap)])
    pulled = host_ints(heads)
    nb, ns = len(batches), len(str_cols)
    lengths = pulled[:nb]
    byte_lengths = [pulled[nb + i * ns:nb + (i + 1) * ns] for i in range(nb)]
    total = sum(lengths)
    out_cap = choose_capacity(total, min_bucket)
    char_caps = [choose_capacity(max(1, sum(bl[k] for bl in byte_lengths)),
                                 128) for k in range(ns)]
    cols, n = concat_ops.concat_batches_cols(
        [vals_of_batch(b) for b in batches], lengths, byte_lengths, out_cap,
        char_caps)
    return batch_from_vals(cols, schema, n)


def head_rows(batch: ColumnarBatch, n: int) -> ColumnarBatch:
    """The batch's first ``n`` rows (its live ones) at the capacity
    bucket of ``n``, when that is smaller: views of each column's data
    planes, a string column's byte pool as it is. The validity planes are
    cut to the ``n`` live rows, so the slots past them are invalid (the
    batch invariant that null elision rests on)."""
    cap = choose_capacity(n)
    if cap >= batch.capacity:
        return batch
    cols = []
    live = None
    for c in batch.columns:
        if live is None:
            live = torch.arange(cap, device=c.validity.device) < n
        if c.is_dict:
            d = c.dictv
            cols.append(DeviceColumn.dict_encoded(c.dtype, n, DictV(
                d.codes[:cap], d.dictionary, d.validity[:cap] & live,
                d.mat_cap, d.max_len, d.unique)))
        elif c.is_string:
            cols.append(DeviceColumn(c.dtype, n, None,
                                     c.validity[:cap] & live,
                                     c.offsets[:cap + 1], c.chars))
        else:
            cols.append(DeviceColumn(c.dtype, n, c.data[:cap],
                                     c.validity[:cap] & live))
    return ColumnarBatch(cols, batch.schema, n)


def batch_bytes(batch: ColumnarBatch, rows: Optional[int] = None) -> int:
    """rows x row-bytes from the batch layout (reference
    ``exec/base.py:582``): a fixed-width column counts its storage width
    plus 1 validity byte a row, a string column 4 offset bytes plus 1
    validity byte a row and its byte pool, a dictionary column 4 code
    bytes plus 1 validity byte a row and its dictionary. ``rows`` falls
    back to the padded capacity when the row count is still a device
    scalar (no sync just for accounting)."""
    total = 0
    for c in batch.columns:
        r = rows if rows is not None else c.capacity
        if c.is_dict:
            d = c.dictv
            total += r * 5 + int(d.dictionary.chars.shape[0])
            total += 4 * int(d.dictionary.offsets.shape[0])
        elif c.is_string:
            total += r * 5 + int(c.chars.shape[0])
        else:
            total += r * (c.data.element_size() + 1)
    return total


def run_fused_chain(exec_self: TpuExec, index: int) -> Iterator[ColumnarBatch]:
    """Shared execute_partition of fusable execs: the chain below (and
    including) ``exec_self`` runs eagerly per batch, threading a liveness
    mask; if any stage sparsified it, rows compact once at the end (string
    columns through the two-pass string gather), and the row count stays
    a device scalar (no host sync). The source's statically non-null
    columns enter with the liveness mask as their validity
    (``ops/filter_gather.elide_validity``, reference
    ``exec/base.py:835-878``) unless ``...analysis.nullElision.enabled``
    is off.

    Each batch runs under the OOM retry harness (``memory/retry.py``,
    reference ``exec/base.py:872``): a device OOM spills and re-attempts,
    and when the attempts run out the batch splits in half and the
    pieces' outputs re-join row-wise (exact: the chain is row-local)."""
    from ..memory.retry import with_oom_retry
    from ..plugin.plananalysis import entry_nonnull_flags

    source, chain = exec_self.fused_source_chain()
    out_schema = exec_self.output_schema
    needs_compact = any(e.sparsifies for e in chain)
    nonnull = entry_nonnull_flags(source.output_schema, exec_self.conf)
    # pressure hook (reference exec/base.py:879): a scan source's prefetch
    # holds device batches an OOM recovery wants back (exec/scan.py)
    on_pressure = getattr(source, "invalidate_prefetch", None)

    def lowered(b: ColumnarBatch) -> ColumnarBatch:
        cols = vals_of_batch(b)
        cap = b.capacity
        nr = b.num_rows_lazy
        dev = cols[0].validity.device if cols else None
        live = filter_gather.live_of(nr, cap, dev)
        cols = filter_gather.elide_validity(cols, live, nonnull)
        for e in chain:
            cols, live = e.lower_batch(cols, live, cap)
        if needs_compact:
            cols, nr = filter_gather.filter_cols(cols, live)
        return batch_from_vals(cols, out_schema, nr, capacity=cap)

    site = "fused_chain"

    def attempt(b: ColumnarBatch) -> ColumnarBatch:
        # the chain's output is a producer's fresh batch unless it passes
        # through a column of a batch somebody else holds
        return _donation.mark_fresh(
            site_call(exec_self, site, b, lambda: lowered(b), donate=True),
            b)

    for b in source.execute_partition(index):
        with exec_self.op_timed():
            out = with_oom_retry(exec_self.node_name, attempt, b,
                                 exec_self.conf, on_pressure=on_pressure)
        yield exec_self.record_batch(out)
