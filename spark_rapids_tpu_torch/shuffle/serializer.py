"""Host columnar wire format (the JVM-shuffle fallback serializer analog).

Counterpart of ``spark_rapids_tpu/shuffle/serializer.py``, byte for byte:
explicit little-endian framing over numpy buffers, validity bitpacked 8x,
string offsets and bytes as they are, with an optional zstd codec.

Layout (all little-endian):
  magic  u32 = 0x54505542 ("TPUB")
  flags  u8: bit0 = zstd-compressed payload, bit1 = lz4
  ncols  u16
  nrows  u32
  per column header (fixed 8 bytes): type_code u8, precision u8, scale i8,
    name_len u8, reserved u32; then name bytes (utf-8)
  payload (possibly compressed as one zstd frame):
    per column: validity bitpacked ceil(n/8) bytes, then
      fixed: data[:n] raw
      string: offsets[:n+1] i32 raw (a null row is empty) + char bytes

The reference builds a string column's bytes row by row from its host
objects; the port takes them from the device planes in one gather,
which gives the same bytes. Codec ``none`` is always there; ``zstd``
imports ``zstandard`` (a plain ``ImportError`` without it); ``lz4`` is the
reference's native codec and raises until the port binds ``native/``.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from .. import types as T
from ..columnar.batch import ColumnarBatch
from ..columnar.column import (DeviceColumn, HostColumn, choose_capacity,
                               encode_strings)

MAGIC = 0x54505542

#: the item that ports the reference's native host code (lz4 included)
NATIVE_ITEM = "The native host decoders"

_TYPE_CODES = [
    (T.NullType, 0),
    (T.BooleanType, 1),
    (T.ByteType, 2),
    (T.ShortType, 3),
    (T.IntegerType, 4),
    (T.LongType, 5),
    (T.FloatType, 6),
    (T.DoubleType, 7),
    (T.StringType, 8),
    (T.BinaryType, 9),
    (T.DateType, 10),
    (T.TimestampType, 11),
    (T.DecimalType, 12),
]
_CODE_OF = {cls: code for cls, code in _TYPE_CODES}
_CLS_OF = {code: cls for cls, code in _TYPE_CODES}


def _lz4_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "the lz4 shuffle codec (the reference's native C++ block codec) is "
        f"not ported yet: see ROADMAP.md, queue A item '{NATIVE_ITEM}'")


def _dtype_header(dt: T.DataType, name: str) -> bytes:
    code = _CODE_OF[type(dt)]
    prec = getattr(dt, "precision", 0) or 0
    scale = getattr(dt, "scale", 0) or 0
    nm = name.encode("utf-8")[:255]
    return struct.pack("<BBbBI", code, prec, scale, len(nm), 0) + nm


def _read_dtype_header(buf: memoryview, pos: int
                       ) -> Tuple[T.DataType, str, int]:
    code, prec, scale, nlen, _ = struct.unpack_from("<BBbBI", buf, pos)
    pos += 8
    name = bytes(buf[pos: pos + nlen]).decode("utf-8")
    pos += nlen
    cls = _CLS_OF[code]
    dt = cls(prec, scale) if cls is T.DecimalType else cls()
    return dt, name, pos


def _frame(dtypes: List[T.DataType], names: List[str], n: int,
           payload_parts: List[bytes], codec: str) -> bytes:
    flags = {"zstd": 1, "lz4": 2}.get(codec, 0)
    head = struct.pack("<IBHI", MAGIC, flags, len(dtypes), n)
    for dt, nm in zip(dtypes, names):
        head += _dtype_header(dt, nm)
    payload = b"".join(payload_parts)
    if codec == "zstd":
        import zstandard

        payload = zstandard.ZstdCompressor(level=1).compress(payload)
    elif codec == "lz4":
        raise _lz4_not_ported()
    return head + payload


def _string_parts(valid: np.ndarray, offsets: np.ndarray,
                  chars: np.ndarray) -> List[bytes]:
    """A string column's offsets and bytes, null rows empty."""
    lens = np.where(valid, np.diff(offsets.astype(np.int64)), 0)
    new_off = np.zeros(lens.shape[0] + 1, np.int32)
    np.cumsum(lens, out=new_off[1:])
    # each kept byte's source position: its row's start plus its place
    starts = offsets[:-1].astype(np.int64)
    src = (np.repeat(starts - new_off[:-1], lens)
           + np.arange(int(new_off[-1]), dtype=np.int64))
    return [new_off.tobytes(), chars[src].tobytes()]


def serialize_host_columns(cols: List[HostColumn], names: List[str], n: int,
                           codec: str = "none") -> bytes:
    """Serialize host columns (strings as object arrays) to wire bytes
    (reference ``serializer.py:76``)."""
    parts: List[bytes] = []
    for c in cols:
        valid = np.asarray(c.validity[:n], dtype=bool)
        parts.append(np.packbits(valid).tobytes())
        if T.is_string(c.dtype):
            enc = encode_strings(c.data[:n], valid)
            offsets = np.zeros(n + 1, np.int32)
            np.cumsum([len(b) for b in enc], out=offsets[1:])
            parts.append(offsets.tobytes())
            parts.append(b"".join(enc))
        elif not isinstance(c.dtype, T.NullType):
            parts.append(np.ascontiguousarray(c.data[:n]).tobytes())
    return _frame([c.dtype for c in cols], names, n, parts, codec)


def serialize_batch(batch: ColumnarBatch, codec: str = "none") -> bytes:
    """Device batch -> wire bytes: one row-count sync, then each column's
    live planes copied to the host (a dictionary-encoded column
    materializes first)."""
    n = batch.num_rows
    parts: List[bytes] = []
    for c in batch.columns:
        c = c.materialize()
        valid = c.validity[:n].cpu().numpy()
        parts.append(np.packbits(valid).tobytes())
        if c.is_string:
            offsets = c.offsets[:n + 1].cpu().numpy()
            chars = c.chars[:int(offsets[n]) if n else 0].cpu().numpy()
            parts.extend(_string_parts(valid, offsets, chars))
        elif not isinstance(c.dtype, T.NullType):
            parts.append(np.ascontiguousarray(
                c.data[:n].cpu().numpy()).tobytes())
    return _frame([f.dataType for f in batch.schema.fields],
                  [f.name for f in batch.schema.fields], n, parts, codec)


def deserialize_batch(data: bytes, device=None) -> ColumnarBatch:
    """Wire bytes -> a batch uploaded to ``device`` (``None``: the CUDA
    card), at the capacity bucket of its row count."""
    return deserialize_with_byte_lens(data, device)[0]


def deserialize_with_byte_lens(data: bytes, device=None
                               ) -> Tuple[ColumnarBatch, Tuple[int, ...]]:
    """:func:`deserialize_batch` and each string column's byte count, read
    from the wire on the host."""
    buf = memoryview(data)
    magic, flags, ncols, n = struct.unpack_from("<IBHI", buf, 0)
    if magic != MAGIC:
        raise ValueError("bad shuffle stream magic")
    pos = struct.calcsize("<IBHI")
    dts: List[T.DataType] = []
    names: List[str] = []
    for _ in range(ncols):
        dt, name, pos = _read_dtype_header(buf, pos)
        dts.append(dt)
        names.append(name)
    payload = bytes(buf[pos:])
    if flags & 1:
        import zstandard

        payload = zstandard.ZstdDecompressor().decompress(payload)
    elif flags & 2:
        raise _lz4_not_ported()

    p = 0
    nvbytes = (n + 7) // 8
    cols: List[DeviceColumn] = []
    byte_lens: List[int] = []
    for dt in dts:
        valid = np.unpackbits(
            np.frombuffer(payload, np.uint8, nvbytes, p))[:n].astype(bool)
        p += nvbytes
        if T.is_string(dt):
            offsets = np.frombuffer(payload, np.int32, n + 1, p)
            p += 4 * (n + 1)
            total = int(offsets[n]) if n else 0
            chars = np.frombuffer(payload, np.uint8, total, p)
            p += total
            byte_lens.append(total)
            cols.append(_string_column(dt, n, offsets, chars, valid,
                                       device))
        elif isinstance(dt, T.NullType):
            cols.append(HostColumn(dt, np.zeros(n, bool), valid).to_device(
                device=device))
        else:
            npdt = np.dtype(dt.to_numpy())
            arr = np.frombuffer(payload, npdt, n, p).copy()
            p += npdt.itemsize * n
            cols.append(HostColumn(dt, arr, valid).to_device(device=device))
    schema = T.StructType(tuple(
        T.StructField(nm, dt) for nm, dt in zip(names, dts)))
    return ColumnarBatch(cols, schema, n), tuple(byte_lens)


def _string_column(dt, n: int, offsets, chars, valid, device
                   ) -> DeviceColumn:
    """A string column of ``n`` rows at the capacity bucket of ``n``."""
    cap = choose_capacity(n)
    off = np.empty(cap + 1, np.int64)
    off[:n + 1] = offsets
    off[n + 1:] = offsets[n] if n else 0
    v = np.zeros(cap, bool)
    v[:n] = valid
    return DeviceColumn.from_string_arrays(dt, n, off, chars, v, device)
