"""Buffer-level Arrow -> device column conversion.

Own copy of ``spark_rapids_tpu/io/arrow_convert.py``. The device layout IS
Arrow (data + validity, offsets + chars for strings), so conversion is
numpy buffer reshaping plus one upload per batch, never a per-row loop.
:func:`packed_upload` stages every buffer in one host buffer (pinned for
a CUDA target) and crosses to the device in one ``non_blocking`` copy on
the current stream; the consumer runs on the same stream, so no wait is
needed. Date, timestamp and decimal columns convert on the host as in the
reference: ``date32`` to int32 days, a ``timestamp`` of any unit cast to
int64 microseconds, a ``decimal128`` (precision <= 18) to the low int64
word of its unscaled value. :func:`batch_to_arrow` is the way back. The
upload consults the fault injector's ``transfer`` channel and names a
device OOM (``memory/retry.named_oom``) and emits its h2d ``transfer``
event, as the reference's does.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..columnar.batch import ColumnarBatch
from ..columnar.column import DeviceColumn, choose_capacity, resolve_device


def arrow_type_to_tpu(at) -> T.DataType:
    import pyarrow as pa

    if pa.types.is_boolean(at):
        return T.BOOLEAN
    if pa.types.is_int8(at):
        return T.BYTE
    if pa.types.is_int16(at):
        return T.SHORT
    if pa.types.is_int32(at):
        return T.INT
    if pa.types.is_int64(at):
        return T.LONG
    if pa.types.is_float32(at):
        return T.FLOAT
    if pa.types.is_float64(at):
        return T.DOUBLE
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return T.STRING
    if pa.types.is_binary(at) or pa.types.is_large_binary(at):
        return T.BINARY
    if pa.types.is_date32(at):
        return T.DATE
    if pa.types.is_timestamp(at):
        return T.TIMESTAMP
    if pa.types.is_decimal(at):
        if at.precision > T.DecimalType.MAX_PRECISION:
            raise TypeError(
                f"decimal precision {at.precision} > 18 not supported")
        return T.DecimalType(at.precision, at.scale)
    raise TypeError(f"unsupported arrow type {at}")


def arrow_schema_to_tpu(schema) -> T.StructType:
    return T.StructType(tuple(
        T.StructField(f.name, arrow_type_to_tpu(f.type), f.nullable)
        for f in schema
    ))


def _np_from_arrow_array(arr, dt: T.DataType) -> Tuple[np.ndarray, ...]:
    """(data, validity) or (offsets, chars, validity) numpy views."""
    import pyarrow as pa

    n = len(arr)
    validity = np.ones(n, bool) if arr.null_count == 0 else ~np.asarray(
        arr.is_null())
    if isinstance(dt, (T.StringType, T.BinaryType)):
        if pa.types.is_large_string(arr.type) or pa.types.is_large_binary(arr.type):
            arr = arr.cast(
                pa.string() if isinstance(dt, T.StringType) else pa.binary())
        # slice-safe: combine offsets relative to the slice start
        off_buf = arr.buffers()[1]
        data_buf = arr.buffers()[2]
        offsets = np.frombuffer(off_buf, np.int32,
                                n + 1 + arr.offset)[arr.offset:]
        chars_all = (
            np.frombuffer(data_buf, np.uint8) if data_buf is not None
            else np.zeros(0, np.uint8)
        )
        start = int(offsets[0])
        end = int(offsets[n])
        return (offsets - start, chars_all[start:end], validity)
    if isinstance(dt, T.TimestampType):
        import pyarrow as pa

        arr = arr.cast(pa.timestamp("us"))
        data = np.asarray(arr.view(pa.int64()))
        return (np.where(validity, data, 0).astype(np.int64), validity)
    if isinstance(dt, T.DateType):
        import pyarrow as pa

        data = np.asarray(arr.view(pa.int32()))
        return (np.where(validity, data, 0).astype(np.int32), validity)
    if isinstance(dt, T.DecimalType):
        data = _decimal_to_int64(arr, dt)
        return (np.where(validity, data, 0), validity)
    if isinstance(dt, T.BooleanType):
        data = np.asarray(arr.cast("bool").fill_null(False))
        return (data.astype(bool), validity)
    np_dt = np.dtype(dt.to_numpy())
    # fill_null avoids NaN poison in padding; cheap on host
    try:
        filled = arr.fill_null(0)
    except Exception:
        filled = arr
    data = np.asarray(filled).astype(np_dt, copy=False)
    return (data, validity)


def _decimal_to_int64(arr, dt: T.DecimalType) -> np.ndarray:
    """decimal128 -> unscaled int64 (precision <= 18 fits)."""
    import pyarrow as pa

    i128 = np.frombuffer(arr.buffers()[1], np.int64)
    lo = i128[0::2][arr.offset: arr.offset + len(arr)]
    return lo.copy()


#: numpy dtype of a staged buffer -> the torch dtype its bytes are viewed
#: as on the device (uint16 and uint32 ride as their signed twins; their
#: consumers mask them back)
_TORCH_VIEW = {
    np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
}


def packed_upload(host_arrays: List[np.ndarray], device=None
                  ) -> List[torch.Tensor]:
    """Stage every buffer into ONE host byte buffer (128-byte aligned
    segments), copy it to ``device`` in ONE transfer and split it there
    into typed views, one per input array (reference
    ``arrow_convert.packed_upload``). For a CUDA target the staging
    buffer is pinned and the copy is ``non_blocking``: the caching host
    allocator keeps the buffer alive until the copy has run. Emits one
    ``transfer`` event (direction h2d, the staged bytes) and its
    ``tpu_transfer*`` twins."""
    dev = resolve_device(device)
    layout = []
    pos = 0
    for a in host_arrays:
        pos = (pos + 127) & ~127
        layout.append((pos, a.nbytes, a.dtype))
        pos += a.nbytes
    pin = dev.type == "cuda"
    host = torch.empty(max(pos, 1), dtype=torch.uint8, pin_memory=pin)
    buf = host.numpy()
    for a, (off, nb, _) in zip(host_arrays, layout):
        buf[off: off + nb] = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    from .. import faults as _faults

    if _faults.enabled():
        # an injected host-to-device transfer failure (chaos testing)
        _faults.check("transfer", "packed_upload")
    from ..memory.retry import named_oom

    with named_oom("packed_upload"):
        staged = (host.to(dev, non_blocking=pin) if dev.type != "cpu"
                  else host)
    from .. import events as _events
    from .. import obs as _obs

    if _events.enabled():
        _events.emit("transfer", direction="h2d", bytes=int(pos),
                     site="packed_upload")
    if _obs.enabled():
        _obs.inc("tpu_transfers", 1, direction="h2d")
        _obs.inc("tpu_transfer_bytes", int(pos), direction="h2d")
    return [staged[off: off + nb].view(_TORCH_VIEW[dt])
            for off, nb, dt in layout]


def arrow_to_batch(table_or_rb, schema: Optional[T.StructType] = None,
                   capacity: Optional[int] = None,
                   device=None) -> ColumnarBatch:
    """pyarrow Table/RecordBatch -> device ColumnarBatch: every buffer is
    staged into one host buffer and crosses to ``device`` (``None``: the
    CUDA card) in ONE transfer, at the reference's capacity bucket."""
    import pyarrow as pa

    if isinstance(table_or_rb, pa.Table):
        table_or_rb = table_or_rb.combine_chunks()
        arrays = [
            c.chunk(0) if c.num_chunks else pa.array([], type=c.type)
            for c in table_or_rb.columns
        ]
        a_schema = table_or_rb.schema
    else:
        arrays = table_or_rb.columns
        a_schema = table_or_rb.schema
    if schema is None:
        schema = arrow_schema_to_tpu(a_schema)
    for f in schema.fields:
        T.check_storable(f.dataType)
    n = table_or_rb.num_rows
    cap = capacity or choose_capacity(max(1, n))
    staged: List[np.ndarray] = []
    plans: List[tuple] = []  # per column: ("s", dt) | ("f", dt)
    for arr, f in zip(arrays, schema.fields):
        dt = f.dataType
        parts = _np_from_arrow_array(arr, dt)
        if len(parts) == 3:
            offsets, chars, validity = parts
            nb = int(offsets[n]) if n else 0
            ccap = choose_capacity(max(1, nb), 128)
            o = np.zeros(cap + 1, np.int32)
            o[: n + 1] = offsets[: n + 1]
            o[n + 1:] = nb
            ch = np.zeros(ccap, np.uint8)
            ch[:nb] = chars[:nb]
            v = np.zeros(cap, bool)
            v[:n] = validity
            staged.extend([o, ch, v])
            plans.append(("s", dt))
        else:
            data, validity = parts
            d = np.zeros(cap, data.dtype)
            d[:n] = np.where(validity, data, np.zeros(1, data.dtype))
            v = np.zeros(cap, bool)
            v[:n] = validity
            staged.extend([d, v])
            plans.append(("f", dt))
    devs = packed_upload(staged, device)
    cols: List[DeviceColumn] = []
    i = 0
    for kind, dt in plans:
        if kind == "s":
            o, ch, v = devs[i], devs[i + 1], devs[i + 2]
            i += 3
            cols.append(DeviceColumn(dt, n, None, v, offsets=o, chars=ch))
        else:
            d, v = devs[i], devs[i + 1]
            i += 2
            cols.append(DeviceColumn(dt, n, d, v))
    return ColumnarBatch(cols, schema, n, capacity=cap)


def _string_array(c: DeviceColumn, n: int):
    """A plain string column's first ``n`` rows as an Arrow array built
    from its planes (offsets, the bytes they cover, the validity as a
    bitmap): the writers' data plane, with no Python object a row."""
    import pyarrow as pa

    offsets = np.ascontiguousarray(c.offsets[:n + 1].cpu().numpy())
    chars = c.chars[:int(offsets[n]) if n else 0].cpu().numpy()
    valid = c.validity[:n].cpu().numpy()
    bitmap = (None if valid.all() else
              pa.py_buffer(np.packbits(valid, bitorder="little")))
    at = pa.string() if isinstance(c.dtype, T.StringType) else pa.binary()
    return pa.Array.from_buffers(
        at, n, [bitmap, pa.py_buffer(offsets.astype(np.int32, copy=False)),
                pa.py_buffer(np.ascontiguousarray(chars))],
        null_count=int(n - valid.sum()))


def batch_to_arrow(batch: ColumnarBatch):
    """Device ColumnarBatch -> pyarrow Table (reference
    ``arrow_convert.batch_to_arrow``): DATE as ``date32``, TIMESTAMP as
    ``timestamp[us, UTC]``, a decimal as ``decimal128(p, s)`` built from
    its unscaled ints, a plain string column from its planes
    (:func:`_string_array`)."""
    import decimal as _d

    import pyarrow as pa

    n = batch.num_rows
    arrays = []
    names = []
    for f, c in zip(batch.schema.fields, batch.columns):
        names.append(f.name)
        dt = f.dataType
        if c.is_string and not c.is_dict:
            arrays.append(_string_array(c, n))
            continue
        h = c.to_host(n)
        mask = ~h.validity[:n]
        if isinstance(dt, (T.StringType, T.BinaryType)):
            at = pa.string() if isinstance(dt, T.StringType) else pa.binary()
            arrays.append(pa.array(list(h.data[:n]), type=at))
        elif isinstance(dt, T.DateType):
            arrays.append(pa.array(
                h.data[:n].astype(np.int32), type=pa.int32(),
                mask=mask).cast(pa.date32()))
        elif isinstance(dt, T.TimestampType):
            arrays.append(pa.array(
                h.data[:n].astype(np.int64), type=pa.int64(),
                mask=mask).cast(pa.timestamp("us", tz="UTC")))
        elif isinstance(dt, T.DecimalType):
            # from the unscaled ints: a numeric int64 -> decimal128 cast
            # would scale the value by 10^scale
            arrays.append(pa.array(
                [None if m else _d.Decimal(int(v)).scaleb(-dt.scale)
                 for v, m in zip(h.data[:n], mask)],
                type=pa.decimal128(dt.precision, dt.scale)))
        else:
            arrays.append(pa.array(h.data[:n], mask=mask))
    return pa.table(dict(zip(names, arrays)))
