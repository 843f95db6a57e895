"""Columns over torch tensors: fixed width and Arrow-layout strings.

Counterpart of ``spark_rapids_tpu/columnar/column.py``. A fixed-width
column is a ``data`` tensor of the storage dtype plus a bool ``validity``
tensor, both of length ``capacity`` — the same power-of-two bucket the
reference picks (:func:`choose_capacity`), so capacities and padding line
up row for row. A decimal column holds int64 unscaled values, a DATE int32
days and a TIMESTAMP int64 microseconds (UTC), as the reference's. Padding slots hold validity False and zeroed data. A
string (or binary) column is ``offsets`` (capacity+1 int32, flat past the
last row) plus ``chars`` (the uint8 byte pool, padded with zeros to
``choose_capacity(total bytes)``) plus ``validity``; null rows hold no
bytes. A dictionary-encoded string column holds a ``DictV`` (``dictv``:
int32 codes, a small dictionary and the row validity, which ``validity``
aliases); :meth:`DeviceColumn.materialize` expands it to the plain
layout.
"""
from __future__ import annotations

import dataclasses
import decimal as _dec
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..expr.values import DictV, StrV, materialize_dict
from ..types import STRING, BinaryType, DataType, DecimalType, NullType, \
    check_storable, is_string, torch_dtype


def resolve_device(device=None) -> torch.device:
    """Entry-point device rule: ``None`` means the CUDA card. Asking for a
    card that is not there raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def round_up_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def choose_capacity(rows: int, min_bucket: int = 128) -> int:
    """Capacity bucket for a logical row count (reference
    ``column.py:42``): the next power of two, at least ``min_bucket``.
    String byte pools use the same rule over their byte count."""
    return max(min_bucket, round_up_pow2(rows))


def encode_strings(values: Sequence[Any], validity: np.ndarray
                   ) -> List[bytes]:
    """UTF-8 bytes per row (``bytes`` pass as they are); null rows hold
    none."""
    out: List[bytes] = []
    for v, ok in zip(values, validity):
        if v is None or not ok:
            out.append(b"")
        elif isinstance(v, bytes):
            out.append(v)
        else:
            out.append(str(v).encode("utf-8"))
    return out


def decode_string_rows(chars: np.ndarray, offsets: np.ndarray,
                       validity: np.ndarray, n: int,
                       binary: bool = False) -> np.ndarray:
    """The first ``n`` rows of a string column as Python objects (``str``,
    or ``bytes`` for binary; ``None`` for nulls): one UTF-8 decode of the
    live byte pool, then slices at per-row character offsets (reference
    ``columnar/batch.decode_string_rows``)."""
    data = np.empty(n, dtype=object)
    if n == 0:
        return data
    total = int(offsets[n])
    raw = chars[:total].tobytes()
    bounds = zip(offsets[:n].tolist(), offsets[1:n + 1].tolist(),
                 validity[:n].tolist())
    if binary:
        data[:] = [raw[a:b] if v else None for a, b, v in bounds]
        return data
    try:
        big = raw.decode("utf-8")
    except UnicodeDecodeError:
        # bytes under null rows may be garbage: decode the valid rows alone
        data[:] = [raw[a:b].decode("utf-8") if v else None
                   for a, b, v in bounds]
        return data
    starts = (chars[:total] & 0xC0) != 0x80
    co = np.zeros(total + 1, np.int64)
    np.cumsum(starts, out=co[1:])
    ro = co[offsets[:n + 1]].tolist()
    data[:] = [big[a:b] if v else None
               for a, b, v in zip(ro[:n], ro[1:], validity[:n].tolist())]
    return data


@dataclasses.dataclass
class HostColumn:
    """Host mirror of a column: numpy ``data`` (an object array of
    ``str``/``bytes`` for strings) + bool ``validity``."""

    dtype: DataType
    data: np.ndarray
    validity: np.ndarray

    def __len__(self) -> int:
        return len(self.data)

    @staticmethod
    def from_pylist(values: Sequence[Any], dtype: DataType) -> "HostColumn":
        check_storable(dtype)
        n = len(values)
        validity = np.array([v is not None for v in values], dtype=bool)
        if isinstance(dtype, NullType):
            return HostColumn(dtype, np.zeros(n, bool), np.zeros(n, bool))
        if is_string(dtype):
            data = np.empty(n, dtype=object)
            data[:] = list(values)
            return HostColumn(dtype, data, validity)
        data = np.zeros(n, dtype=dtype.to_numpy())
        if isinstance(dtype, DecimalType):
            # DECIMAL64: a Decimal, str or int -> its unscaled int64,
            # quantized HALF_UP to the scale (reference column.py:85-96)
            q = _dec.Decimal(1).scaleb(-dtype.scale)
            for i, v in enumerate(values):
                if v is not None:
                    data[i] = int(_dec.Decimal(str(v)).quantize(
                        q, rounding=_dec.ROUND_HALF_UP).scaleb(dtype.scale))
            return HostColumn(dtype, data, validity)
        for i, v in enumerate(values):
            if v is not None:
                data[i] = v
        return HostColumn(dtype, data, validity)

    def to_pylist(self) -> List[Any]:
        """Python values: ints for DATE (days) and TIMESTAMP (µs), a
        ``Decimal`` for a decimal, as the reference's ``to_pylist``."""
        scale = (self.dtype.scale if isinstance(self.dtype, DecimalType)
                 else None)
        out: List[Any] = []
        for i in range(len(self.data)):
            if not self.validity[i]:
                out.append(None)
            else:
                v = self.data[i]
                v = v.item() if isinstance(v, np.generic) else v
                if scale is not None:
                    v = _dec.Decimal(v).scaleb(-scale)
                out.append(v)
        return out

    def to_device(self, capacity: Optional[int] = None,
                  name: Optional[str] = None,
                  device=None) -> "DeviceColumn":
        return DeviceColumn.from_host(self, capacity, name, device)


class DeviceColumn:
    """A device-resident column (reference: DeviceColumn's three layouts).
    ``data`` is None for a string column; ``offsets`` and ``chars`` are
    None for a fixed-width one and for a dictionary-encoded one, whose
    ``dictv`` holds its planes."""

    __slots__ = ("dtype", "length", "data", "validity", "offsets", "chars",
                 "dictv")

    def __init__(self, dtype: DataType, length, data: Optional[torch.Tensor],
                 validity: torch.Tensor,
                 offsets: Optional[torch.Tensor] = None,
                 chars: Optional[torch.Tensor] = None, dictv=None):
        self.dtype = dtype
        self.length = length  # logical rows; python int at batch boundaries
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.chars = chars
        self.dictv = dictv

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def is_string(self) -> bool:
        return is_string(self.dtype)

    @property
    def is_dict(self) -> bool:
        return self.dictv is not None

    @staticmethod
    def dict_encoded(dtype: DataType, length, dictv) -> "DeviceColumn":
        return DeviceColumn(dtype, length, None, dictv.validity, dictv=dictv)

    def materialize(self) -> "DeviceColumn":
        """A dictionary-encoded column in the plain string layout (itself
        for any other column)."""
        if not self.is_dict:
            return self
        s = materialize_dict(self.dictv)
        return DeviceColumn(self.dtype, self.length, None, s.validity,
                            s.offsets, s.chars)

    @staticmethod
    def from_host(host: HostColumn, capacity: Optional[int] = None,
                  name: Optional[str] = None, device=None) -> "DeviceColumn":
        dev = resolve_device(device)
        check_storable(host.dtype)
        n = len(host)
        cap = capacity or choose_capacity(n)
        if cap < n:
            what = f"column {name!r}" if name else "column"
            raise ValueError(f"{what}: requested capacity {cap} < row count "
                             f"{n}")
        validity = np.zeros(cap, dtype=bool)
        validity[:n] = host.validity
        if is_string(host.dtype):
            encoded = encode_strings(host.data, host.validity)
            offsets = np.zeros(cap + 1, dtype=np.int64)
            np.cumsum([len(b) for b in encoded], out=offsets[1:n + 1])
            offsets[n + 1:] = offsets[n]
            chars = np.frombuffer(b"".join(encoded), dtype=np.uint8)
            return DeviceColumn.from_string_arrays(
                host.dtype, n, offsets, chars, validity, dev)
        st = torch_dtype(host.dtype)
        npdt = np.bool_ if st == torch.bool else host.dtype.to_numpy()
        data = np.zeros(cap, dtype=npdt)
        data[:n] = np.where(host.validity, host.data, np.zeros(1, npdt))
        return DeviceColumn(host.dtype, n, torch.from_numpy(data).to(dev),
                            torch.from_numpy(validity).to(dev))

    @staticmethod
    def from_string_arrays(dtype: DataType, num_rows: int,
                           offsets: np.ndarray, chars: np.ndarray,
                           validity: np.ndarray, device=None,
                           char_cap: Optional[int] = None
                           ) -> "DeviceColumn":
        """A string column from numpy planes: ``offsets`` (cap+1,),
        ``validity`` (cap,) and the live bytes ``chars``, padded with zeros
        to ``char_cap`` (default: ``choose_capacity`` of the byte count,
        as the reference's upload, ``column.py:212-218``). Offsets must
        start at 0, never fall and fit int32."""
        dev = resolve_device(device)
        offsets = np.asarray(offsets)
        validity = np.asarray(validity, dtype=bool)
        cap = validity.shape[0]
        if offsets.shape != (cap + 1,):
            raise ValueError(f"offsets must have shape ({cap + 1},), got "
                             f"{offsets.shape}")
        total = int(offsets[-1]) if cap else 0
        if cap and (offsets[0] != 0 or np.any(np.diff(offsets) < 0)
                    or total >= 2**31):
            raise ValueError("offsets must start at 0, never fall and stay "
                             "below 2^31")
        chars = np.asarray(chars, dtype=np.uint8)
        if chars.shape[0] < total:
            raise ValueError(f"{chars.shape[0]} chars for {total} bytes of "
                             "rows")
        cc = char_cap or choose_capacity(max(total, 1))
        pool = np.zeros(max(cc, total), dtype=np.uint8)
        pool[:total] = chars[:total]
        return DeviceColumn(
            dtype, num_rows, None, torch.tensor(validity, device=dev),
            torch.tensor(offsets.astype(np.int32), device=dev),
            torch.tensor(pool, device=dev))

    def to_host(self, n: Optional[int] = None) -> HostColumn:
        """The first ``n`` rows (default: the column's length) on the
        host."""
        n = int(self.length) if n is None else n
        validity = self.validity[:n].cpu().numpy().copy()
        if self.is_dict:
            # the codes and the whole dictionary: no byte-count sync
            d = self.dictv
            data = decode_dict_rows(
                d.dictionary.chars.cpu().numpy(),
                d.dictionary.offsets.cpu().numpy(),
                d.codes[:n].cpu().numpy(), validity,
                isinstance(self.dtype, BinaryType))
            return HostColumn(self.dtype, data, validity)
        if self.is_string:
            offsets = self.offsets[:n + 1].cpu().numpy()
            chars = self.chars[:int(offsets[n]) if n else 0].cpu().numpy()
            data = decode_string_rows(chars, offsets, validity, n,
                                      isinstance(self.dtype, BinaryType))
            return HostColumn(self.dtype, data, validity)
        return HostColumn(self.dtype, self.data[:n].cpu().numpy().copy(),
                          validity)

    def __repr__(self):
        return (f"DeviceColumn({self.dtype}, rows={self.length}, "
                f"cap={self.capacity})")


def column_from_pylist(values: Sequence[Any], dtype: DataType,
                       name: Optional[str] = None,
                       device=None) -> DeviceColumn:
    return HostColumn.from_pylist(values, dtype).to_device(
        name=name, device=device)


#: test seam (the reference's ``column.DICT_MATERIALIZE_EAGERLY``): when
#: True, dictionary-encoded columns expand to the plain layout as they
#: enter the lowering, so a query runs the non-dictionary path everywhere
DICT_MATERIALIZE_EAGERLY = False


def decode_dict_rows(dict_chars: np.ndarray, dict_offsets: np.ndarray,
                     codes: np.ndarray, validity: np.ndarray,
                     binary: bool = False) -> np.ndarray:
    """Rows of a dictionary-encoded column as Python objects: each entry
    decoded ONCE, then indexed by the codes (reference
    ``column.py:302``)."""
    D = len(dict_offsets) - 1
    raw = dict_chars[:int(dict_offsets[D])].tobytes()
    bounds = zip(dict_offsets[:D].tolist(), dict_offsets[1:].tolist())
    entries = np.empty(max(D, 1), dtype=object)
    entries[:D] = [raw[a:b] if binary else raw[a:b].decode("utf-8")
                   for a, b in bounds]
    out = entries[np.clip(codes, 0, max(D - 1, 0))]
    out[~validity] = None
    return out


def dict_column_from_parts(length, codes, dict_offsets, dict_chars,
                           validity, mat_cap: int, max_len: int,
                           unique: bool = False,
                           dtype: DataType = STRING,
                           device=None) -> DeviceColumn:
    """A dictionary-encoded string column from numpy (or torch) planes:
    ``codes`` and ``validity`` (cap,), the dictionary's ``dict_offsets``
    (D+1,) and ``dict_chars``, on ``device``."""
    dev = resolve_device(device)

    def up(a, dt):  # a copy: never aliases the caller's numpy planes
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dt)
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)

    doff = up(dict_offsets, torch.int32)
    D = int(doff.shape[0]) - 1
    dictionary = StrV(doff, up(dict_chars, torch.uint8),
                      torch.ones(max(D, 0), dtype=torch.bool, device=dev))
    dv = DictV(up(codes, torch.int32), dictionary, up(validity, torch.bool),
               mat_cap, max_len, unique)
    return DeviceColumn.dict_encoded(dtype, length, dv)


def dict_column_from_pylist(values: Sequence[Any], dtype: DataType = STRING,
                            capacity: Optional[int] = None,
                            device=None) -> DeviceColumn:
    """Dictionary-encode a Python string list (reference
    ``column.py:350``): the distinct values, sorted bytewise, become the
    dictionary (one empty entry when there is none), rows become int32
    codes, ``unique`` is set and ``mat_cap`` is the bucketed byte total."""
    n = len(values)
    cap = capacity or choose_capacity(n)
    binary = isinstance(dtype, BinaryType)
    encoded = [None if v is None else (v if binary else str(v).encode(
        "utf-8")) for v in values]
    distinct = sorted({b for b in encoded if b is not None}) or [b""]
    index = {b: k for k, b in enumerate(distinct)}
    codes = np.zeros(cap, np.int32)
    validity = np.zeros(cap, bool)
    total = 0
    for i, b in enumerate(encoded):
        if b is not None:
            codes[i] = index[b]
            validity[i] = True
            total += len(b)
    doff = np.zeros(len(distinct) + 1, np.int32)
    np.cumsum([len(b) for b in distinct], out=doff[1:])
    pool = b"".join(distinct)
    dch = (np.frombuffer(pool, np.uint8).copy() if pool
           else np.zeros(1, np.uint8))
    return dict_column_from_parts(
        n, codes, doff, dch, validity,
        mat_cap=choose_capacity(max(1, total), 128),
        max_len=max(len(b) for b in distinct), unique=True, dtype=dtype,
        device=device)
