"""Per-kernel attribution of one harvested call: which ops own the bytes.

Counterpart of ``spark_rapids_tpu/hlo.py``. The reference parses a
compiled program's optimized HLO and attributes operand and output bytes
to each top-level instruction (``hlo.py:30-42``). An eager PyTorch call
has no HLO; what it has is the profiler's record of the call. Inside the
cost plane's gated first call (``kernel_cost.py``) ``torch.profiler``
(CPU and CUDA activities, ``record_shapes=True``) records the call under
one marker range, and this module attributes each top-level op under the
marker — each aten op the engine called, and each hand kernel's launch,
which its wrapper brackets with a ``srt::<kernel>`` range while a harvest
runs (:func:`kernel_cost.kernel_launch`):

* an aten op costs its operands' bytes plus its output's, from the
  recorded shapes and dtypes (the output is inferred: the broadcast
  shape for elementwise ops, the index's rows for gathers, values plus
  indices for sorts, nothing for reductions and in-place ops, whose
  written operand is counted once); views, reshapes and empties cost
  zero, as the reference's parameters, bitcasts and tuples do;
* a hand kernel costs its own byte model, the formula its wrapper module
  keeps (``ops/*_kernels.py``), the same one ``chip_smoke.py``'s bound
  column reads;
* each row carries the device milliseconds the profiler measured for the
  kernels it launched.

Rows are classified with the reference's class names (``hlo.py:389``):
``scatter-add`` / ``scatter`` (``index_add_``, ``scatter_add_``,
``scatter_reduce_``, an accumulating ``index_put_``), ``gather``,
``sort``, ``reduce``, ``reduce-window`` (scans), ``dot``,
``transpose/copy``, ``collective``, ``pallas`` for K1-K5, and for the
three hand kernels that replace XLA code the class the reference gives
that code (:data:`HAND_KERNEL_CLASS`).

The summary (the ``hlo_summary`` event's fields) has the top-K rows by
bytes (``hlo.topK``) plus every hand kernel's row wherever it ranks (the
kernels are what the attribution is for), ``scatter_count``,
``largest_output``, and ``coverage``: the share of the kernels the
profiler saw launched in the call's window that a row owns (on the CPU,
where nothing launches, the share of rows whose shapes parsed).

Attribution follows the profiler's per-thread op tree from the marker
down, so the kernels another thread launches during the window (a
serving session, the prefetch pool) are never charged to this call; they
only lower ``coverage``. A hand kernel whose launch the tree does not
link to its range (a ``ctypes`` launch is no aten op) takes its
kernels' time by symbol (:data:`HAND_KERNEL_SYMBOLS`), in launch order,
only when their number in the window matches its rows'. A profile that
cannot be read yields None and never fails the query.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: bytes per element by the profiler's dtype names (C++ type names, and
#: the scalar-type names other torch builds record)
_DTYPE_BYTES: Dict[str, int] = {
    "bool": 1, "unsigned char": 1, "signed char": 1, "char": 1,
    "short int": 2, "unsigned short": 2, "c10::Half": 2,
    "c10::BFloat16": 2, "int": 4, "unsigned int": 4, "float": 4,
    "long int": 8, "long long int": 8, "unsigned long": 8, "double": 8,
    "c10::complex<float>": 8, "c10::complex<double>": 16,
    "Bool": 1, "Byte": 1, "Char": 1, "Short": 2, "Half": 2, "BFloat16": 2,
    "Int": 4, "Float": 4, "Long": 8, "Double": 8,
    "uint8": 1, "int8": 1, "int16": 2, "float16": 2, "bfloat16": 2,
    "int32": 4, "float32": 4, "int64": 8, "float64": 8,
}

#: ops that move no bytes of their own (views, reshapes, empties)
ZERO_BYTE_OPS = frozenset((
    "aten::view", "aten::reshape", "aten::_reshape_alias",
    "aten::_unsafe_view", "aten::view_as", "aten::empty",
    "aten::empty_strided", "aten::empty_like", "aten::as_strided",
    "aten::slice", "aten::select", "aten::unsqueeze", "aten::squeeze",
    "aten::expand", "aten::expand_as", "aten::t", "aten::transpose",
    "aten::permute", "aten::detach", "aten::alias", "aten::unbind",
    "aten::split", "aten::split_with_sizes", "aten::chunk",
    "aten::narrow", "aten::lift_fresh", "aten::resolve_conj",
    "aten::resolve_neg", "aten::set_", "aten::result_type",
    "aten::flatten", "aten::unflatten", "aten::movedim",
    "aten::contiguous", "aten::resize_", "aten::record_stream",
))

#: ops whose output is small (a reduction's or a scalar read)
_REDUCING = frozenset((
    "aten::sum", "aten::amax", "aten::amin", "aten::max", "aten::min",
    "aten::mean", "aten::prod", "aten::any", "aten::all",
    "aten::count_nonzero", "aten::argmax", "aten::argmin",
    "aten::item", "aten::_local_scalar_dense", "aten::equal",
    "aten::is_nonzero", "aten::aminmax",
))
#: elementwise ops whose output is bool
_PREDICATES = frozenset((
    "aten::eq", "aten::ne", "aten::lt", "aten::le", "aten::gt", "aten::ge",
    "aten::logical_and", "aten::logical_or", "aten::logical_not",
    "aten::logical_xor", "aten::isnan", "aten::isinf", "aten::isfinite",
    "aten::isin", "aten::signbit",
))
_GATHERS = frozenset(("aten::index_select", "aten::gather", "aten::take",
                      "aten::index", "aten::embedding",
                      "aten::take_along_dim"))
_SORTS = frozenset(("aten::sort", "aten::argsort", "aten::msort",
                    "aten::topk", "aten::unique", "aten::_unique2",
                    "aten::unique_consecutive", "aten::unique_dim"))
_SCANS = frozenset(("aten::cumsum", "aten::cumprod", "aten::cummax",
                    "aten::cummin", "aten::logcumsumexp"))
_DOTS = frozenset(("aten::mm", "aten::matmul", "aten::bmm", "aten::addmm",
                   "aten::dot", "aten::mv", "aten::einsum",
                   "aten::linear"))
_COPIES = frozenset(("aten::copy_", "aten::clone", "aten::_to_copy",
                     "aten::to"))

#: the class the reference gives the XLA code each hand kernel replaces
#: that is not a Pallas kernel: the exact float sum's serial
#: segment_sum, the RADIX tile loop (ops/radix_bin.py: its dynamic-update
#: windows), and the regex DFA's associative scan, a chain of fused
#: slices, compositions and pads (``hlo.classify`` gives it ``fusion``)
HAND_KERNEL_CLASS: Dict[str, str] = {
    "bucket_sum": "pallas", "bucket_float_sum": "pallas",
    "bucket_winner": "pallas", "probe_ranges": "pallas",
    "word_counts": "pallas",
    "ordered_segment_sum": "scatter-add",
    "radix_segment_reduce": "radix-bin",
    "dfa_accept_rows": "fusion",
}

#: each hand kernel's CUDA symbols (a RADIX call launches two kernels):
#: a row the op tree gave no device time takes its kernels' by name, in
#: launch order, when their count matches the rows'
HAND_KERNEL_SYMBOLS: Dict[str, Tuple[str, ...]] = {
    "bucket_sum": ("bucket_sum_kernel",),
    "bucket_float_sum": ("bucket_fsum_kernel",),
    "bucket_winner": ("bucket_winner_kernel",),
    "ordered_segment_sum": ("ordered_segment_sum_kernel",),
    "probe_ranges": ("probe_ranges_kernel",),
    "word_counts": ("word_counts_kernel",),
    "dfa_accept_rows": ("dfa_accept_rows_kernel",),
    "radix_segment_reduce": ("radix_staged_tiles_kernel",
                             "radix_span_fold_kernel"),
}

#: the reference's hlo_summary payload fields
SUMMARY_FIELDS = ("instructions", "coverage", "total_bytes",
                  "scatter_count", "top_fusions", "largest_output")


#: the element size taken for an operand whose dtype the trace lacks
#: (the engine's columns are mostly int64 and f64); such a row counts
#: against ``coverage``
UNKNOWN_DTYPE_BYTES = 8


def _nbytes(shape, dtype: str) -> Optional[int]:
    """Bytes of one recorded operand (None: not a tensor, or an unknown
    dtype); a TensorList's shapes sum."""
    if not isinstance(shape, (list, tuple)) or not shape:
        return None if not isinstance(shape, (list, tuple)) else (
            _DTYPE_BYTES.get(dtype))
    if isinstance(shape[0], (list, tuple)):
        per = _DTYPE_BYTES.get(dtype, UNKNOWN_DTYPE_BYTES)
        return sum(math.prod(s) * per for s in shape)
    per = _DTYPE_BYTES.get(dtype)
    return None if per is None else math.prod(shape) * per


def _numel(shape) -> int:
    if not isinstance(shape, (list, tuple)):
        return 0
    if shape and isinstance(shape[0], (list, tuple)):
        return sum(math.prod(s) for s in shape)
    return math.prod(shape)


def classify(op: str, concrete: Sequence[Any] = ()) -> str:
    """The reference's class name for one aten op."""
    if op in ("aten::index_add_", "aten::index_add", "aten::scatter_add_",
              "aten::scatter_add", "aten::bincount",
              "aten::_segment_reduce", "aten::segment_reduce"):
        return "scatter-add"
    if op in ("aten::scatter_reduce_", "aten::scatter_reduce"):
        red = concrete[3] if len(concrete) > 3 else None
        return "scatter-add" if red in ("sum", None) else "scatter"
    if op in ("aten::index_put_", "aten::index_put",
              "aten::_index_put_impl_"):
        acc = concrete[3] if len(concrete) > 3 else None
        return "scatter-add" if acc is True else "scatter"
    if op in ("aten::scatter_", "aten::scatter", "aten::masked_scatter_",
              "aten::index_copy_", "aten::index_fill_"):
        return "scatter"
    if op.startswith("c10d::") or "all_reduce" in op or "allreduce" in op \
            or "all_gather" in op or "alltoall" in op:
        return "collective"
    if op in _DOTS:
        return "dot"
    if op in _GATHERS:
        return "gather"
    if op in _SORTS:
        return "sort"
    if op in _SCANS:
        return "reduce-window"
    if op in _REDUCING:
        return "reduce"
    if op in _COPIES:
        return "transpose/copy"
    return op.split("::", 1)[-1]


def op_cost(op: str, shapes: Sequence[Any], dtypes: Sequence[str]
            ) -> Tuple[int, int, float, bool]:
    """(bytes, output bytes, flops, parsed) of one aten op from its
    recorded operand shapes and dtypes (module docstring)."""
    if op in ZERO_BYTE_OPS:
        return 0, 0, 0.0, True
    parsed = True
    if not dtypes and any(s for s in shapes if isinstance(s, (list, tuple))):
        # no dtypes in the trace: tensors are the operands with a shape
        parsed = False
        dtypes = ["?" if s else "Scalar" for s in shapes]
    operands = [(s, d) for s, d in zip(shapes, dtypes)
                if isinstance(s, (list, tuple)) and d not in ("Scalar",
                                                              "ScalarList",
                                                              "")]
    in_bytes = 0
    widest = 0
    numel = 0
    for s, d in operands:
        b = _nbytes(s, d)
        if b is None:
            parsed = False
            b = (_numel(s) * UNKNOWN_DTYPE_BYTES
                 if isinstance(s, (list, tuple)) and s else 0)
        in_bytes += b
        widest = max(widest, _DTYPE_BYTES.get(d, UNKNOWN_DTYPE_BYTES))
        numel = max(numel, _numel(s))
    if op.endswith("_") or op in _REDUCING:
        # in place (the written operand counted once) or a reduction
        out = 0
        flops = float(numel)
    elif op in _GATHERS:
        idx = operands[-1][0] if operands else []
        src = operands[0][0] if operands else []
        rows = _numel(idx)
        inner = (math.prod(src[1:]) if isinstance(src, (list, tuple))
                 and len(src) > 1 and op == "aten::index_select" else 1)
        out = rows * inner * (_DTYPE_BYTES.get(operands[0][1], 8)
                              if operands else 8)
        flops = 0.0
    elif op in _SORTS:
        out = numel * (widest + 8)
        flops = numel * max(1.0, math.log2(max(2, numel)))
    elif op in _DOTS and len(operands) >= 2:
        a, b = operands[-2][0], operands[-1][0]
        m = math.prod(a[:-1]) if len(a) > 1 else 1
        k = a[-1] if a else 1
        n = b[-1] if len(b) > 1 else 1
        out = m * n * widest
        flops = 2.0 * m * n * k
    elif op in ("aten::cat", "aten::stack"):
        out = in_bytes
        flops = 0.0
    else:
        out = numel * (1 if op in _PREDICATES else widest)
        flops = float(numel)
    return in_bytes + out, out, flops, parsed


def _children(ev) -> List[Any]:
    """The top-level ops under ``ev``: its CPU children, looking through
    any user range that is not a hand kernel's (``sql.trace.enabled``'s
    ``record_function`` sections)."""
    out = []
    for c in ev.cpu_children:
        if (not c.name.startswith(("aten::", "srt::"))
                and getattr(c, "is_user_annotation", False)):
            out.extend(_children(c))
        else:
            out.append(c)
    return out


def _kernels_under(ev) -> int:
    n = len(getattr(ev, "kernels", ()) or ())
    for c in ev.cpu_children:
        n += _kernels_under(c)
    return n


def _by_symbol(rows: List[Dict[str, Any]], device) -> int:
    """Give each hand-kernel row the op tree left without device time its
    kernels' time, matched by symbol in launch order (when the kernels
    launched in the window and the rows agree in number); returns the
    kernels so attributed."""
    got = 0
    for name, syms in HAND_KERNEL_SYMBOLS.items():
        mine = [r for r in rows if r.get("kernel") and r["op"] == "srt::"
                + name]
        if not mine or any(r["device_ms"] for r in mine):
            continue
        evs = sorted((e for e in device if any(s in e.name for s in syms)),
                     key=lambda e: e.time_range.start)
        if len(evs) != len(mine) * len(syms):
            continue
        for i, r in enumerate(mine):
            part = evs[i * len(syms):(i + 1) * len(syms)]
            r["device_ms"] = round(sum(e.time_range.elapsed_us()
                                       for e in part) / 1e3, 6)
        got += len(evs)
    return got


def summarize_profile(events, marker: str, notes: Dict[str, List[int]],
                      top_k: int = 5,
                      dtypes_of: Optional[Dict[int, list]] = None,
                      event_ms: Optional[Dict[str, List[float]]] = None
                      ) -> Optional[Dict[str, Any]]:
    """The ``hlo_summary`` payload of one recorded call (module
    docstring): ``events`` the profiler's ``events()``, ``marker`` the
    call's range name, ``notes`` each hand kernel's byte models in launch
    order (``kernel_cost``), ``dtypes_of`` operand dtypes by event id
    where the events lack them, ``event_ms`` each hand kernel's launch
    times from CUDA events, in launch order (a row the trace leaves
    without device time takes its launch's). None when the marker is
    missing."""
    from torch.autograd import DeviceType

    dtypes_of = dtypes_of or {}
    event_ms = event_ms or {}
    # the CPU range (on the card the profiler also records a device-side
    # twin of a record_function range, under the same name)
    mk = [e for e in events if e.name == marker
          and getattr(e, "device_type", DeviceType.CPU) == DeviceType.CPU]
    if not mk:
        return None
    rows: List[Dict[str, Any]] = []
    total = 0
    flops = 0.0
    parsed = 0
    attributed = 0
    seen: Dict[str, int] = {}
    pos: Dict[str, int] = {}
    for c in _children(mk[0]):
        name = c.name
        dev_ms = round((getattr(c, "device_time_total", 0) or 0) / 1e3, 6)
        attributed += _kernels_under(c)
        if name.startswith("srt::"):
            kname = name[len("srt::"):]
            i = pos.get(kname, 0)
            pos[kname] = i + 1
            models = notes.get(kname, [])
            b = int(models[i]) if i < len(models) else 0
            rows.append({"name": kname if i == 0 else f"{kname}#{i}",
                         "op": name,
                         "class": HAND_KERNEL_CLASS.get(kname, "pallas"),
                         "bytes": b, "out_bytes": 0, "device_ms": dev_ms,
                         "kernel": True})
            total += b
            parsed += 1
            continue
        b, out_b, fl, ok = op_cost(
            name, c.input_shapes or [],
            getattr(c, "input_dtypes", None) or dtypes_of.get(c.id) or [])
        parsed += 1 if ok else 0
        total += b
        flops += fl
        if b > 0 or out_b > 0:
            k = seen.get(name, 0)
            seen[name] = k + 1
            rows.append({"name": f"{name}#{k}", "op": name,
                         "class": classify(
                             name, getattr(c, "concrete_inputs", ()) or ()),
                         "bytes": int(b), "out_bytes": int(out_b),
                         "device_ms": dev_ms})
    n = len(_children(mk[0]))
    # the kernels (not the device-side twins of the ranges)
    device = [e for e in events
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("srt")]
    attributed += _by_symbol(rows, device)
    for r in rows:
        if r.get("kernel") and not r["device_ms"]:
            kname, _, i = r["name"].partition("#")
            times = event_ms.get(kname, [])
            k = int(i) if i else 0
            if k < len(times):
                r["device_ms"] = round(times[k], 6)
    launched = len(device)
    coverage = (min(1.0, attributed / launched) if launched
                else (parsed / n if n else 0.0))
    scatter_count = sum(1 for r in rows
                        if r["class"] in ("scatter", "scatter-add"))
    ranked = sorted(rows, key=lambda r: -r["bytes"])
    top = ranked[:top_k] + [r for r in ranked[top_k:] if r.get("kernel")]
    largest = max(rows, key=lambda r: r["out_bytes"], default=None)
    return {
        "instructions": n,
        "coverage": round(coverage, 4),
        "total_bytes": int(total),
        "flops": int(flops),
        "scatter_count": scatter_count,
        "top_fusions": [{k: v for k, v in r.items() if k != "kernel"}
                        for r in top],
        "largest_output": ({"name": largest["name"],
                            "bytes": largest["out_bytes"]}
                           if largest is not None else None),
        "kernel_rows": [{k: v for k, v in r.items() if k != "kernel"}
                        for r in rows if r.get("kernel")],
    }
