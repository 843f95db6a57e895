"""Device-side parquet page decode.

Own copy of ``spark_rapids_tpu/io/parquet_device.py``. The split between
the two sides is the reference's:

  * HOST (no per-value Python): thrift page headers, codec decompress
    (pyarrow), RLE/bit-packed hybrid expansion of dictionary INDICES to
    the narrowest integer (u8/u16/i32 by bit width), definition levels
    re-packed to validity words, BYTE_ARRAY dictionary pages split into
    offsets and bytes. The hybrid streams and the dictionary pages go
    through the repo's C++ decoders (``native.py``), which release the
    GIL for the decode, on the scan's host-decode thread; only a host
    without a C++ compiler takes the vectorized numpy decoder
    ``hybrid_decode_np`` (and a Python loop for the dictionary pages),
    as in the reference.
  * WIRE: the narrow codes, the packed validity words and the dictionary
    (or the PLAIN value bytes), staged into one host buffer per flush and
    copied to the device in one transfer (``arrow_convert.packed_upload``).
  * DEVICE (torch ops, one whole-column pass per chunk): validity bit
    expansion, present->row indices by a cumsum, the dictionary gather,
    and the PLAIN reassembly as a ``view`` of the uploaded words. The
    reference tiles this pass in a ``fori_loop`` sized for TPU on-chip
    memory (``tiled_fixed_unpack``); the results are the same.

Scope as in the reference: flat schemas, PLAIN int32/int64/float,
RLE_DICTIONARY / PLAIN_DICTIONARY for int32/int64/float/double and
BYTE_ARRAY, definition levels for nullable columns, v1 and v2 data pages,
the codecs pyarrow builds. Anything else falls back to the host arrow
decoder per column. Under ``...parquet.dictStrings.enabled`` (the
default) a dictionary-encoded BYTE_ARRAY chunk stays encoded, as in the
reference (``keep_dict``): the file's codes and its own dictionary upload
as they are and become a ``DictV`` with ``unique`` set (a parquet
dictionary holds distinct values), so no byte of the rows is expanded.
With the conf off such chunks decode to the expanded Arrow layout.

DATE (INT32) and DECIMAL chunks stored as INT32 or INT64 (Spark's layout
for precision <= 9 / <= 18) take the device route like any integer chunk;
an INT32 decimal widens to its int64 storage. An INT64 TIMESTAMP chunk
of unit MILLIS or NANOS becomes microseconds on the device
(:func:`column_time_unit`), where the reference keeps the raw values. A
FIXED_LEN_BYTE_ARRAY decimal (pyarrow's default layout) takes the host
decoder, as in the reference.
"""
from __future__ import annotations

import dataclasses
import struct as _struct
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import types as T

# thrift compact type ids
_T_STOP = 0
_T_TRUE = 1
_T_FALSE = 2
_T_BYTE = 3
_T_I16 = 4
_T_I32 = 5
_T_I64 = 6
_T_DOUBLE = 7
_T_BINARY = 8
_T_LIST = 9
_T_SET = 10
_T_MAP = 11
_T_STRUCT = 12

# parquet page types
DATA_PAGE = 0
DICTIONARY_PAGE = 2
DATA_PAGE_V2 = 3

# parquet encodings
ENC_PLAIN = 0
ENC_PLAIN_DICTIONARY = 2
ENC_RLE = 3
ENC_RLE_DICTIONARY = 8

#: host-side guardrail: pages with more hybrid runs than this fall back
#: (the python run parser is O(runs); typical pages have few runs)
MAX_RUNS_PER_PAGE = 1 << 16


class _Reader:
    """Minimal thrift compact-protocol struct reader (header-only needs)."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        r = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            r |= (b & 0x7F) << shift
            if not b & 0x80:
                return r
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def skip(self, ftype: int) -> None:
        if ftype in (_T_TRUE, _T_FALSE):
            return
        if ftype == _T_BYTE:
            self.pos += 1
        elif ftype in (_T_I16, _T_I32, _T_I64):
            self.varint()
        elif ftype == _T_DOUBLE:
            self.pos += 8
        elif ftype == _T_BINARY:
            # NOTE: must read the varint BEFORE adding — `pos += varint()`
            # loads pos before varint() advances it
            ln = self.varint()
            self.pos += ln
        elif ftype in (_T_LIST, _T_SET):
            b = self.buf[self.pos]
            self.pos += 1
            size = b >> 4
            et = b & 0x0F
            if size == 15:
                size = self.varint()
            for _ in range(size):
                self.skip(et)
        elif ftype == _T_MAP:
            size = self.varint()
            if size:
                kv = self.buf[self.pos]
                self.pos += 1
                for _ in range(size):
                    self.skip(kv >> 4)
                    self.skip(kv & 0x0F)
        elif ftype == _T_STRUCT:
            self.read_struct(lambda fid, ft, rd: rd.skip(ft))
        else:
            raise ValueError(f"thrift type {ftype}")

    def read_struct(self, on_field) -> None:
        """on_field(field_id, ftype, reader) must CONSUME the value."""
        fid = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            if b == _T_STOP:
                return
            delta = b >> 4
            ftype = b & 0x0F
            fid = fid + delta if delta else self.zigzag()
            on_field(fid, ftype, self)


@dataclasses.dataclass
class PageHeader:
    type: int
    uncompressed_size: int
    compressed_size: int
    num_values: int = 0
    encoding: int = ENC_PLAIN
    # v2 extras
    num_nulls: int = 0
    def_levels_len: int = 0
    rep_levels_len: int = 0
    v2_is_compressed: bool = True
    header_len: int = 0


def parse_page_header(buf: bytes, pos: int) -> PageHeader:
    rd = _Reader(buf, pos)
    ph = PageHeader(-1, 0, 0)

    def sub_data(fid, ft, r):
        if fid == 1:
            ph.num_values = r.zigzag()
        elif fid == 2:
            ph.encoding = r.zigzag()
        else:
            r.skip(ft)

    def sub_dict(fid, ft, r):
        if fid == 1:
            ph.num_values = r.zigzag()
        elif fid == 2:
            ph.encoding = r.zigzag()
        else:
            r.skip(ft)

    def sub_v2(fid, ft, r):
        if fid == 1:
            ph.num_values = r.zigzag()
        elif fid == 2:
            ph.num_nulls = r.zigzag()
        elif fid == 4:
            ph.encoding = r.zigzag()
        elif fid == 5:
            ph.def_levels_len = r.zigzag()
        elif fid == 6:
            ph.rep_levels_len = r.zigzag()
        elif fid == 7:
            ph.v2_is_compressed = ft == _T_TRUE
        else:
            r.skip(ft)

    def top(fid, ft, r):
        if fid == 1:
            ph.type = r.zigzag()
        elif fid == 2:
            ph.uncompressed_size = r.zigzag()
        elif fid == 3:
            ph.compressed_size = r.zigzag()
        elif fid == 5 and ft == _T_STRUCT:
            r.read_struct(sub_data)
        elif fid == 7 and ft == _T_STRUCT:
            r.read_struct(sub_dict)
        elif fid == 8 and ft == _T_STRUCT:
            r.read_struct(sub_v2)
        else:
            r.skip(ft)

    rd.read_struct(top)
    ph.header_len = rd.pos - pos
    return ph


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid expansion (host side, vectorized numpy)
# ---------------------------------------------------------------------------
class _FallbackError(Exception):
    """Column can't take the device path; fall back to host decode."""


#: safety bound on hybrid runs per stream (each run costs one cheap numpy
#: slice; this only guards adversarial files)
MAX_RUNS = 1 << 20

def hybrid_decode_np(data: bytes, pos: int, end: int, bw: int,
                     n: int) -> Tuple[np.ndarray, int]:
    """Expand one RLE/bit-packed hybrid stream to n int32 values (the
    reference's function of the same name, same results).

    A Python loop reads only the run headers; then one vectorized pass
    decodes every bit-packed run at once. Each run holds whole groups of
    8 values in ``bw`` bytes, so the runs' bytes end to end form one
    matrix of a row per group, and value j of every group sits at the
    same byte and bit offset: eight column passes of a 4-byte window,
    shifted and masked (bw <= 24), decode them all. The reference unpacks
    each run to single bits and takes a dot product, run by run. Returns
    (values, byte position after the stream)."""
    if bw == 0:
        return np.zeros(n, np.int32), pos
    if bw > 24:
        raise _FallbackError(f"bit width {bw}")
    out = np.zeros(n, np.int32)
    byte_w = (bw + 7) // 8
    packed: List[Tuple[int, int, int]] = []  # (byte pos, groups, out at)
    got = 0
    nruns = 0
    while got < n and pos < end:
        nruns += 1
        if nruns > MAX_RUNS:
            raise _FallbackError("too many hybrid runs")
        header = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        if header & 1:  # bit-packed run of (header>>1) groups of 8
            groups = header >> 1
            nbytes = groups * bw
            if pos + nbytes > len(data):
                raise ValueError("bit-packed run past the end of the page")
            packed.append((pos, groups, got))
            pos += nbytes
            got += groups * 8  # padding values advance the count too
        else:  # RLE run
            count = header >> 1
            v = int.from_bytes(data[pos : pos + byte_w], "little")
            pos += byte_w
            out[got : got + min(count, n - got)] = v
            got += count
    if got < n:
        raise _FallbackError(f"short hybrid stream: {got}/{n}")
    if packed:
        at = np.array(packed, np.int64)
        src = np.frombuffer(data, np.uint8)
        groups = int(at[:, 1].sum())
        # the runs' bytes end to end, one row of bw bytes per group of 8
        # values, padded with 3 zero bytes so a 4-byte window never runs off
        g = np.zeros((groups, bw + 3), np.uint32)
        g[:, :bw] = np.concatenate(
            [src[p0: p0 + k * bw] for p0, k, _ in packed]).reshape(groups, bw)
        vals = np.empty((groups, 8), np.int32)
        mask = np.uint32((1 << bw) - 1)
        for j in range(8):  # value j of each group: a fixed byte and shift
            b0, s0 = (j * bw) >> 3, (j * bw) & 7
            win = (g[:, b0] | (g[:, b0 + 1] << 8) | (g[:, b0 + 2] << 16)
                   | (g[:, b0 + 3] << 24))
            vals[:, j] = (win >> np.uint32(s0)) & mask
        vals = vals.reshape(-1)
        cnt = at[:, 1] * 8
        first = np.cumsum(cnt) - cnt  # each run's first value in ``vals``
        if np.array_equal(at[:, 2], first):  # no RLE run between them
            m = min(n, vals.shape[0])
            out[:m] = vals[:m]
        else:
            dest = (np.repeat(at[:, 2] - first, cnt)
                    + np.arange(vals.shape[0], dtype=np.int64))
            keep = dest < n
            out[dest[keep]] = vals[keep]
    return out, pos


def _code_dtype(bw: int):
    return (np.uint8 if bw <= 8 else
            np.uint16 if bw <= 16 else np.int32)


#: hybrid streams decoded by route since the process started ("native":
#: the C++ decoder; "numpy": :func:`hybrid_decode_np`, taken only when
#: the native library cannot be built), as the kernels count launches
DECODE_ROUTES = {"native": 0, "numpy": 0}
_ROUTES_LOCK = threading.Lock()


def _count_route(route: str) -> None:
    with _ROUTES_LOCK:
        DECODE_ROUTES[route] += 1


def hybrid_decode(data, pos: int, end: int, bw: int,
                  n: int) -> Tuple[np.ndarray, int]:
    """Hybrid-stream decode to the narrowest dtype holding the bit width,
    through the C++ decoder (reference ``parquet_device.py:289``), which
    releases the GIL while it decodes. A malformed stream falls back to
    the host reader; without the native library the numpy decoder
    runs."""
    if bw == 0:
        return np.zeros(n, np.uint8), pos
    if bw > 24:
        raise _FallbackError(f"bit width {bw}")
    from ..native import pq_hybrid_decode

    out = np.empty(n, _code_dtype(bw))
    try:
        newpos = pq_hybrid_decode(data, pos, end, bw, n, out)
    except ValueError as e:
        raise _FallbackError(str(e))
    if newpos is None:  # no C++ compiler on this host
        _count_route("numpy")
        vals, newpos = hybrid_decode_np(data, pos, end, bw, n)
        return vals.astype(out.dtype, copy=False), newpos
    _count_route("native")
    return out, newpos


# ---------------------------------------------------------------------------
# host planning: file bytes -> upload arrays per column chunk
# ---------------------------------------------------------------------------
_PHYS_NP = {
    "INT32": np.dtype(np.int32),
    "INT64": np.dtype(np.int64),
    "FLOAT": np.dtype(np.float32),
    "DOUBLE": np.dtype(np.float64),
    "BOOLEAN": np.dtype(np.bool_),
}


@dataclasses.dataclass
class ChunkPlan:
    """Host-normalized upload payloads of one column chunk."""

    phys: str  # parquet physical type
    num_values: int  # rows in the chunk
    nullable: bool
    # dictionary (None for PLAIN data pages)
    dict_values: Optional[np.ndarray] = None  # numeric dicts
    dict_offsets: Optional[np.ndarray] = None  # string dicts
    dict_chars: Optional[np.ndarray] = None
    # per-PRESENT dictionary code, narrowest dtype (u8/u16/i32)
    codes: Optional[np.ndarray] = None
    # per-row validity (None = no nulls)
    validity: Optional[np.ndarray] = None
    # PLAIN page payloads (concatenated raw value bytes, present only)
    plain_bytes: Optional[bytes] = None
    n_present: int = 0
    # the unit of an INT64 TIMESTAMP chunk's values ("ms", "us" or "ns")
    time_unit: str = "us"


_TIME_UNITS = {"milliseconds": "ms", "microseconds": "us",
               "nanoseconds": "ns"}


def column_time_unit(pqcol) -> str:
    """The unit of a parquet TIMESTAMP column's int64 values (its logical
    type, or the legacy converted type), "us" for any other column. The
    reference's ``plan_decode`` never reads it and keeps millisecond and
    nanosecond values raw (ROADMAP.md §C); the port converts them."""
    import json

    lt = pqcol.logical_type
    if lt is not None and lt.type == "TIMESTAMP":
        unit = json.loads(lt.to_json()).get("timeUnit")
        if unit not in _TIME_UNITS:
            raise _FallbackError(f"timestamp unit {unit}")
        return _TIME_UNITS[unit]
    if pqcol.converted_type == "TIMESTAMP_MILLIS":
        return "ms"
    return "us"


def _timestamp_to_us(data: torch.Tensor, unit: str) -> torch.Tensor:
    """int64 values of ``unit`` as microseconds: milliseconds multiply by
    1000; nanoseconds floor-divide by 1000, right for pre-epoch values
    too (the host route's ``cast(pa.timestamp("us"))`` gives the same)."""
    if unit == "ms":
        return data * 1000
    if unit == "ns":
        return torch.div(data, 1000, rounding_mode="floor")
    return data


def _decompress(codec: str, data: bytes, out_size: int) -> bytes:
    codec = codec.upper()
    if codec == "UNCOMPRESSED":
        return data
    import pyarrow as pa

    try:
        c = pa.Codec(codec.lower())
    except Exception as e:  # codec not built into this pyarrow
        raise _FallbackError(f"codec {codec}: {e}")
    return c.decompress(data, out_size).to_pybytes()


def plan_chunk(
    file_bytes: bytes, col_meta, max_def: int, max_rep: int,
    time_unit: str = "us",
) -> ChunkPlan:
    """Parse one column chunk's pages into a ChunkPlan (host side).
    ``time_unit`` is the column's :func:`column_time_unit`.

    Raises _FallbackError for unsupported shapes/encodings."""
    if max_rep != 0:
        raise _FallbackError("nested (repeated) column")
    phys = col_meta.physical_type
    if phys not in _PHYS_NP and phys != "BYTE_ARRAY":
        raise _FallbackError(f"physical type {phys}")
    codec = col_meta.compression
    n = col_meta.num_values
    st = col_meta.statistics
    has_nulls = (
        max_def > 0
        and (st is None or st.null_count is None or st.null_count > 0)
    )

    doff = col_meta.dictionary_page_offset
    off = doff if doff is not None and doff > 0 else col_meta.data_page_offset
    end = off + col_meta.total_compressed_size

    plan = ChunkPlan(phys=phys, num_values=n, nullable=max_def > 0,
                     time_unit=time_unit)
    pos = off
    values_seen = 0
    code_pages: List[np.ndarray] = []
    valid_pages: List[np.ndarray] = []
    plain_parts: List[bytes] = []
    saw_dict_page = False
    saw_plain_page = False

    def handle_values(raw: bytes, p: int, pend: int, enc: int,
                      presents: int) -> None:
        nonlocal saw_dict_page, saw_plain_page
        if enc in (ENC_RLE_DICTIONARY, ENC_PLAIN_DICTIONARY):
            bw = raw[p] if p < len(raw) else 0
            vals, _ = hybrid_decode(raw, p + 1, pend, bw, presents)
            code_pages.append(vals)
            saw_dict_page = True
        elif enc == ENC_PLAIN:
            if phys in ("BYTE_ARRAY", "BOOLEAN", "DOUBLE"):
                # the reference's routing, kept so both engines decode the
                # same chunks on the same route: BYTE_ARRAY plain needs
                # per-value host parsing, and its f64 path lacks a 64-bit
                # device bitcast
                raise _FallbackError(f"PLAIN {phys}")
            dt = _PHYS_NP[phys]
            need = presents * dt.itemsize
            plain_parts.append(raw[p : p + need])
            saw_plain_page = True
        else:
            raise _FallbackError(f"encoding {enc}")
        if saw_dict_page and saw_plain_page:
            # mixed dict+plain pages (dict overflow mid-chunk): the device
            # program would need both paths; punt to the host decoder
            raise _FallbackError("mixed dict/plain pages")

    while pos < end and values_seen < n:
        ph = parse_page_header(file_bytes, pos)
        pos += ph.header_len
        payload = file_bytes[pos : pos + ph.compressed_size]
        pos += ph.compressed_size
        if ph.type == DICTIONARY_PAGE:
            if ph.encoding not in (ENC_PLAIN, ENC_PLAIN_DICTIONARY):
                raise _FallbackError(f"dict encoding {ph.encoding}")
            raw = _decompress(codec, payload, ph.uncompressed_size)
            _load_dictionary(plan, raw, ph.num_values)
            continue
        if ph.type == DATA_PAGE:
            raw = _decompress(codec, payload, ph.uncompressed_size)
            p = 0
            presents = ph.num_values
            if max_def > 0:
                (ln,) = _struct.unpack_from("<I", raw, p)
                p += 4
                if has_nulls:
                    levels, _ = hybrid_decode(
                        raw, p, p + ln, 1, ph.num_values)
                    vp = levels == 1
                    valid_pages.append(vp)
                    presents = int(vp.sum())
                p += ln
            handle_values(raw, p, len(raw), ph.encoding, presents)
            values_seen += ph.num_values
            continue
        if ph.type == DATA_PAGE_V2:
            if ph.rep_levels_len:
                raise _FallbackError("repeated column (v2)")
            presents = ph.num_values - (
                ph.num_nulls if max_def > 0 else 0)
            if max_def > 0 and has_nulls:
                if ph.def_levels_len:
                    levels, _ = hybrid_decode(
                        payload, 0, ph.def_levels_len, 1, ph.num_values)
                    valid_pages.append(levels == 1)
                else:
                    valid_pages.append(
                        np.ones(ph.num_values, np.bool_))
            vals = payload[ph.def_levels_len :]
            if ph.v2_is_compressed and codec.upper() != "UNCOMPRESSED":
                vals = _decompress(
                    codec, vals, ph.uncompressed_size - ph.def_levels_len)
            handle_values(vals, 0, len(vals), ph.encoding, presents)
            values_seen += ph.num_values
            continue
        # index pages etc: skip
    if values_seen < n:
        raise _FallbackError(f"short chunk: {values_seen}/{n} values")
    if valid_pages:
        plan.validity = np.concatenate(valid_pages)
    if code_pages:
        # pages already decoded to the narrowest dtype for their bit width;
        # concatenate promotes to the widest page's dtype
        codes = (np.concatenate(code_pages) if len(code_pages) > 1
                 else code_pages[0])
        plan.n_present = codes.shape[0]
        if codes.dtype.itemsize > 1 and codes.shape[0]:
            # narrow further when the observed max allows (pages of one
            # chunk may carry a wider bit width than the values need)
            mx = int(codes.max())
            want = (np.uint8 if mx < 256 else
                    np.uint16 if mx < 65536 else None)
            if want is not None and np.dtype(want).itemsize < codes.dtype.itemsize:
                codes = codes.astype(want)
        plan.codes = codes
    elif plain_parts:
        plan.plain_bytes = b"".join(plain_parts)
        dt = _PHYS_NP[phys]
        plan.n_present = len(plan.plain_bytes) // dt.itemsize
    else:
        plan.n_present = 0
        plan.codes = np.zeros(0, np.uint8)
    return plan


def _load_dictionary(plan: ChunkPlan, raw: bytes, count: int) -> None:
    if plan.phys == "BYTE_ARRAY":
        from ..native import pq_binary_dict

        offs32 = np.empty(count + 1, np.int32)
        chars_buf = np.empty(max(1, len(raw) - 4 * count), np.uint8)
        try:
            total = pq_binary_dict(raw, count, offs32, chars_buf)
        except ValueError:
            raise _FallbackError("malformed binary dictionary")
        if total is not None:
            plan.dict_offsets = offs32.astype(np.int64)
            plan.dict_chars = (chars_buf[:total].copy() if total
                               else np.zeros(1, np.uint8))
            return
        offs = np.zeros(count + 1, np.int64)
        chars = []
        p = 0
        for i in range(count):
            (ln,) = _struct.unpack_from("<I", raw, p)
            p += 4
            chars.append(raw[p : p + ln])
            p += ln
            offs[i + 1] = offs[i] + ln
        plan.dict_offsets = offs
        pool = b"".join(chars)
        plan.dict_chars = (
            np.frombuffer(pool, np.uint8).copy() if pool
            else np.zeros(1, np.uint8))
    elif plan.phys == "BOOLEAN":
        raise _FallbackError("boolean dictionary")
    else:
        dt = _PHYS_NP[plan.phys]
        plan.dict_values = np.frombuffer(
            raw[: count * dt.itemsize], dt).copy()


# ---------------------------------------------------------------------------
# device decode (torch ops)
# ---------------------------------------------------------------------------
def unpack_bit_words(words: torch.Tensor, out_cap: int) -> torch.Tensor:
    """bits[j] = bit j of the LSB-first 32-bit word stream (the words ride
    as int32; an arithmetic shift and ``& 1`` still read each bit)."""
    need_w = -(-out_cap // 32)
    w = words[:need_w]
    if w.shape[0] < need_w:
        w = torch.cat([w, torch.zeros(need_w - w.shape[0], dtype=w.dtype,
                                      device=w.device)])
    shifts = torch.arange(32, dtype=w.dtype, device=w.device)
    bits = ((w[:, None] >> shifts[None, :]) & 1) != 0
    return bits.reshape(need_w * 32)[:out_cap]


def _pack_validity_words(validity: np.ndarray) -> np.ndarray:
    b = np.packbits(validity, bitorder="little")
    pad = (-b.shape[0]) % 4
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    return b.view(np.uint32)


def _np_plain_words(plan: ChunkPlan) -> np.ndarray:
    raw = plan.plain_bytes or b""
    pad = (-len(raw)) % 8  # even word count so an int64 view fits
    if pad:
        raw = raw + b"\x00" * pad
    return (
        np.frombuffer(raw, np.uint32).copy()
        if raw else np.zeros(2, np.uint32)
    )


def _as_index(codes: torch.Tensor) -> torch.Tensor:
    """Dictionary codes as int64 gather indices (u16 codes ride as
    int16 and are masked back)."""
    if codes.dtype == torch.int16:
        return codes.to(torch.int64) & 0xFFFF
    return codes.to(torch.int64)


#: the torch dtype a PLAIN page's words are viewed as, by physical type;
#: INT32 columns of a narrower SQL type (tinyint, smallint) are cast after
_PHYS_TORCH = {"INT32": torch.int32, "INT64": torch.int64,
               "FLOAT": torch.float32}


def plan_decode(plan: ChunkPlan, dtype_tpu, cap: int,
                dict_strings: bool = False):
    """The device half of one chunk decode, without running it: returns
    ``(args, run)``, where ``args`` are the host arrays to upload and
    ``run(dev_args)`` produces ``(data, validity)`` for a fixed-width
    column, ``(offsets, chars, validity)`` for strings, or under
    ``dict_strings`` a ``DictV`` for a dictionary-encoded BYTE_ARRAY chunk
    (reference ``parquet_device.py:696``): the codes and the file's
    dictionary as they are, ``max_len`` the longest entry and ``mat_cap``
    the rows' exact byte total, bucketed. Raises ``_FallbackError`` for a
    chunk the host decoder must take."""
    from ..columnar.column import choose_capacity
    from ..expr.values import DictV, StrV
    from ..ops.filter_gather import gather_string

    T.check_storable(dtype_tpu)
    # an INT64 TIMESTAMP chunk of another unit becomes microseconds
    unit = (plan.time_unit if isinstance(dtype_tpu, T.TimestampType)
            else "us")
    n = plan.num_values
    has_def = plan.validity is not None
    is_dict = plan.codes is not None
    is_str = plan.phys == "BYTE_ARRAY"
    if is_str and not is_dict:
        raise _FallbackError("PLAIN BYTE_ARRAY")
    if n == 0:
        if is_str:
            def run_empty_str(dev_args, device):
                return (torch.zeros(cap + 1, dtype=torch.int32,
                                    device=device),
                        torch.zeros(1, dtype=torch.uint8, device=device),
                        torch.zeros(cap, dtype=torch.bool, device=device))
            return [], run_empty_str
        tdt = T.torch_dtype(dtype_tpu)

        def run_empty(dev_args, device):
            return (torch.zeros(cap, dtype=tdt, device=device),
                    torch.zeros(cap, dtype=torch.bool, device=device))
        return [], run_empty

    keep_dict = bool(dict_strings) and is_str and is_dict
    args: List[np.ndarray] = []
    if has_def:
        args.append(_pack_validity_words(plan.validity))
    if is_dict:
        # all-null chunks can carry an EMPTY dictionary: pad one zero slot
        # so the gather has a valid (masked-out) target
        if plan.dict_values is not None and plan.dict_values.shape[0] == 0:
            plan.dict_values = np.zeros(1, plan.dict_values.dtype)
        if plan.dict_offsets is not None and plan.dict_offsets.shape[0] < 2:
            plan.dict_offsets = np.zeros(2, np.int64)
        codes = plan.codes
        pcap = choose_capacity(max(1, codes.shape[0]))
        if codes.shape[0] < pcap:
            codes = np.concatenate(
                [codes, np.zeros(pcap - codes.shape[0], codes.dtype)])
        args.append(codes)
        if is_str:
            D = plan.dict_offsets.shape[0] - 1
            lens = np.diff(plan.dict_offsets)
            total_bytes = int(
                np.bincount(
                    np.clip(plan.codes.astype(np.int64), 0, D - 1),
                    minlength=D,
                ) @ lens
            ) if plan.codes.shape[0] else 0
            ccap = choose_capacity(max(1, total_bytes), 128)
            max_len = int(lens.max()) if D > 0 else 0
            args += [plan.dict_offsets.astype(np.int32), plan.dict_chars]
        else:
            args.append(plan.dict_values)
    else:
        args.append(_np_plain_words(plan))
    phys = plan.phys

    def run(dev_args, device):
        ai = 0
        rows = torch.arange(cap, dtype=torch.int32, device=device)
        if has_def:
            validity = unpack_bit_words(dev_args[ai], cap) & (rows < n)
            ai += 1
            vidx = torch.clamp(
                torch.cumsum(validity, 0, dtype=torch.int32) - 1,
                0, cap - 1).to(torch.int64)
        else:
            validity = rows < n
            vidx = None
        if is_dict:
            codes_ = _as_index(dev_args[ai])
            ai += 1
            if vidx is not None:
                codes_ = codes_[torch.clamp(vidx, 0, codes_.shape[0] - 1)]
            elif codes_.shape[0] < cap:
                codes_ = torch.cat([codes_, codes_.new_zeros(
                    cap - codes_.shape[0])])
            else:
                codes_ = codes_[:cap]
            if is_str:
                doff_, dch_ = dev_args[ai], dev_args[ai + 1]
                D_ = doff_.shape[0] - 1
                dsv = StrV(doff_, dch_, torch.ones(D_, dtype=torch.bool,
                                                   device=device))
                if keep_dict:
                    return DictV(torch.clamp(codes_, 0, D_ - 1).to(
                        torch.int32), dsv, validity, ccap, max_len, True)
                out = gather_string(dsv, torch.clamp(codes_, 0, D_ - 1),
                                    validity, ccap)
                return out.offsets, out.chars, validity
            dvals_ = dev_args[ai]
            data = dvals_[torch.clamp(codes_, 0, dvals_.shape[0] - 1)]
            data = _timestamp_to_us(torch.where(validity, data, 0).to(tdt),
                                    unit)
            return data, validity
        words_ = dev_args[ai]  # int32 words (an even count)
        arr = words_.view(_PHYS_TORCH[phys])
        if arr.shape[0] < cap:
            arr = torch.cat([arr, arr.new_zeros(cap - arr.shape[0])])
        else:
            arr = arr[:cap]
        if vidx is not None:
            arr = arr[vidx]
        return _timestamp_to_us(torch.where(validity, arr, 0).to(tdt),
                                unit), validity

    tdt = None if is_str else T.torch_dtype(dtype_tpu)
    return args, run


def _run_decode(plan: ChunkPlan, dtype_tpu, run, dev_args, device):
    """Run one column's decode over its uploaded args and wrap the result
    as a DeviceColumn."""
    from ..columnar.column import DeviceColumn

    from ..expr.values import DictV

    out = run(dev_args, device)
    n = plan.num_values
    if isinstance(out, DictV):
        return DeviceColumn.dict_encoded(dtype_tpu, n, out)
    if plan.phys == "BYTE_ARRAY":
        offsets, chars, validity = out
        return DeviceColumn(dtype_tpu, n, None, validity, offsets, chars)
    data, validity = out
    return DeviceColumn(dtype_tpu, n, data, validity)


def chunk_to_device_column(plan: ChunkPlan, dtype_tpu, cap: int,
                           dict_strings: bool = False, device=None):
    """Upload a ChunkPlan's payloads (one staged transfer) and expand it
    to a DeviceColumn on ``device``."""
    from ..columnar.column import resolve_device
    from .arrow_convert import packed_upload

    dev = resolve_device(device)
    args, run = plan_decode(plan, dtype_tpu, cap, dict_strings)
    return _run_decode(plan, dtype_tpu, run, packed_upload(args, dev), dev)


# ---------------------------------------------------------------------------
# row groups -> ColumnarBatches (with per-column host fallback)
# ---------------------------------------------------------------------------
_PQDEC_POOL = None
_PQDEC_POOL_LOCK = threading.Lock()


#: host-decode threads. The reference sizes its pool min(8, cores)
#: because its C++ decoder releases the GIL. The port's C++ route
#: releases it for the hybrid streams and dictionary pages only: the
#: page headers, the decompression calls and the numpy around them hold
#: it. Measured on an H100 machine with 8 host cores (chip_smoke.py's
#: host-only planning of Q11's 16 chunks of 2^21 values): 0.149 s on one
#: thread, 0.244 s on two, 0.308 s on four and 0.339 s on eight, the
#: numpy route 0.520 s on one; Q11's cold wall 229, 270, 444 and 434 ms
#: with a pool of 1, 2, 4 and 8 (PERF.md §5). One thread still overlaps
#: the host decode with the consumer's uploads and device decode.
DECODE_THREADS = 1


def _decode_pool() -> ThreadPoolExecutor:
    """The process-shared host-decode pool. Tasks submitted here never
    wait on other tasks of the pool (only leaf chunk-decode work is
    submitted), so it cannot deadlock."""
    global _PQDEC_POOL
    if _PQDEC_POOL is None:
        with _PQDEC_POOL_LOCK:
            if _PQDEC_POOL is None:
                _PQDEC_POOL = ThreadPoolExecutor(
                    max_workers=DECODE_THREADS,
                    thread_name_prefix="srt-pqdec")
    return _PQDEC_POOL


def stage_decode_args(per_col_args: Sequence[Sequence[np.ndarray]],
                      device) -> List[list]:
    """Every column's decode payloads of one row group (codes, validity
    words, dictionaries, plain words) in ONE staged host buffer and ONE
    transfer (``arrow_convert.packed_upload``), split per column on the
    device (reference ``parquet_device.py:861``)."""
    from .arrow_convert import packed_upload

    flat = [a for args in per_col_args for a in args]
    if not flat:
        return [list(args) for args in per_col_args]
    devs = packed_upload(flat, device)
    out = []
    i = 0
    for args in per_col_args:
        out.append(list(devs[i: i + len(args)]))
        i += len(args)
    return out


def _plan_columns(file_bytes, rgmd, pqschema, columns):
    """Host-plan every requested column chunk of one row group on the
    decode pool (reference ``parquet_device.py:949``). Returns (plans by
    name, the names the device decoder cannot take, the summed host
    decode ns)."""
    name_to_ci = {rgmd.column(i).path_in_schema: i
                  for i in range(rgmd.num_columns)}

    def plan_one(name):
        ci = name_to_ci.get(name)
        if ci is None:
            return name, None, 0
        t0 = time.perf_counter_ns()
        pqcol = pqschema.column(ci)
        try:
            plan = plan_chunk(
                file_bytes, rgmd.column(ci), pqcol.max_definition_level,
                pqcol.max_repetition_level, column_time_unit(pqcol))
        except Exception:
            plan = None
        return name, plan, time.perf_counter_ns() - t0

    plans: Dict[str, ChunkPlan] = {}
    fallback: List[str] = []
    ns = 0
    for name, plan, dt in _decode_pool().map(plan_one, columns):
        ns += dt
        if plan is None:
            fallback.append(name)
        else:
            plans[name] = plan
    return plans, fallback, ns


def row_group_device_plans(path: str, pf, rg: int, columns: Sequence[str],
                           tpu_fields, file_bytes=None,
                           dict_strings: bool = False, device=None,
                           metrics=None):
    """The stage-fusion variant of the row-group decode (reference
    ``parquet_device.py:1189``): host-plan every column and upload all of
    the row group's arguments in one transfer, but decode nothing.
    Returns ``(num_rows, cap, entries)`` with ``entries`` =
    ``[(device args, run, field), ...]``, ``run(args, device)`` being the
    column's device decode, so the consumer runs it inside its fused
    stage; None when ANY column needs the host decoder (the fused stage
    has no host path). ``metrics`` receives the host decode time and the
    uploaded bytes, as in :func:`read_row_groups_pipelined`."""
    from ..columnar.column import choose_capacity, resolve_device

    dev = resolve_device(device)
    rgmd = pf.metadata.row_group(rg)
    n = rgmd.num_rows
    cap = choose_capacity(max(1, n))
    if file_bytes is None:
        with open(path, "rb") as f:
            file_bytes = f.read()
    plans, fallback, ns = _plan_columns(file_bytes, rgmd, pf.schema,
                                        columns)
    if metrics is not None and HOST_DECODE_TIME in metrics:
        metrics[HOST_DECODE_TIME].add(ns)
    if fallback or len(plans) != len(columns):
        return None
    staged = []
    for name, f in zip(columns, tpu_fields):
        try:
            args, run = plan_decode(plans[name], f.dataType, cap,
                                    dict_strings)
        except _FallbackError:
            return None
        staged.append((args, run, f))
    dev_args = stage_decode_args([a for (a, _, _) in staged], dev)
    if metrics is not None and UPLOAD_BYTES in metrics:
        metrics[UPLOAD_BYTES].add(sum(a.nbytes for (args, _, _) in staged
                                      for a in args))
    return n, cap, [(da, run, f)
                    for da, (_, run, f) in zip(dev_args, staged)]


#: metric names ``read_row_groups_pipelined`` adds to (ns, bytes and
#: column chunks)
HOST_DECODE_TIME = "hostDecodeTime"
UPLOAD_BYTES = "uploadBytes"
HOST_FALLBACK_CHUNKS = "hostFallbackChunks"


def read_row_groups_pipelined(
    path: str, pf, rgs: Sequence[int], columns: Sequence[str], tpu_fields,
    file_bytes: Optional[bytes] = None, dict_strings: bool = False,
    max_in_flight: int = 3, device=None, metrics=None,
):
    """Pipelined decode→upload over many row groups: a generator yielding
    ``(rg, ColumnarBatch-or-None)`` in row-group order (None = no column
    took the device path; the caller falls back to the plain reader for
    the split). As in the reference:

      * row groups N+1..N+maxInFlight-1 host-decode on the shared pool
        while row group N's staged transfer and device unpack run on the
        consumer thread;
      * within one row group, the first half of the declared columns
        stages and uploads as soon as it has resolved, while the rest
        still decompress (two packed transfers per row group);
      * columns the device decoder cannot take host-decode via pyarrow,
        per column.

    Every upload and every decode runs on the consumer thread's current
    stream, so no cross-stream wait is needed. ``metrics`` (name -> an
    object with ``add``) receives the summed host decode time of the
    chunks (``hostDecodeTime``, ns, across pool threads) and the uploaded
    bytes (``uploadBytes``), and the column chunks the device decoder did
    not take (``hostFallbackChunks``: each decodes through pyarrow on the
    host and uploads whole). Each stage emits the reference's
    ``pq_pipeline`` event (decode a chunk, on its pool thread; upload a
    packed transfer; unpack a row group's device decode) with its host
    wall-clock and its ``tpu_pq_pipeline_*`` twins. Abandoning the
    generator is safe: outstanding pool tasks finish and their results
    are dropped."""
    from .. import events as _events
    from .. import obs as _obs
    from ..columnar.batch import ColumnarBatch
    from ..columnar.column import choose_capacity, resolve_device
    from ..types import StructType
    from .arrow_convert import arrow_to_batch, packed_upload

    dev = resolve_device(device)
    md = pf.metadata
    pqschema = pf.schema
    pool = _decode_pool()
    if file_bytes is None:
        with open(path, "rb") as f:
            file_bytes = f.read()
    fields_by_name = {f.name: f for f in tpu_fields}

    def note(name, v):
        if metrics is not None and name in metrics:
            metrics[name].add(int(v))

    def plan_one(rg, rgmd, name, ci):
        t0 = time.perf_counter_ns()
        if ci is None:
            return name, None, 0
        pqcol = pqschema.column(ci)
        try:
            plan = plan_chunk(
                file_bytes, rgmd.column(ci),
                pqcol.max_definition_level, pqcol.max_repetition_level,
                column_time_unit(pqcol))
        except Exception:
            return name, None, 0
        dt = time.perf_counter_ns() - t0
        if _events.enabled() or _obs.enabled():
            nbytes = int(rgmd.column(ci).total_uncompressed_size)
            _events.emit("pq_pipeline", stage="decode", rg=rg,
                         bytes=nbytes, dur=dt)
            _obs.inc("tpu_pq_pipeline_stages", 1, stage="decode")
            _obs.inc("tpu_pq_pipeline_bytes", nbytes, stage="decode")
        return name, plan, dt

    pending: Dict[int, tuple] = {}  # pos -> (rg, rgmd, [futures])

    def submit(pos):
        rg = rgs[pos]
        rgmd = md.row_group(rg)
        name_to_ci = {
            rgmd.column(i).path_in_schema: i
            for i in range(rgmd.num_columns)
        }
        futs = [pool.submit(plan_one, rg, rgmd, name, name_to_ci.get(name))
                for name in columns]
        pending[pos] = (rg, rgmd, futs)

    window = max(1, int(max_in_flight))
    for pos in range(min(window, len(rgs))):
        submit(pos)

    for pos in range(len(rgs)):
        rg, rgmd, futs = pending.pop(pos)
        n = rgmd.num_rows
        cap = choose_capacity(max(1, n))
        plans: Dict[str, ChunkPlan] = {}
        decoded: Dict[str, tuple] = {}   # name -> (args, run)
        dev_args: Dict[str, list] = {}
        fallback_cols: List[str] = []
        staged_names: List[str] = []
        flushed = False
        # a deterministic split: buffer A is the decoded subset of the
        # first half of the declared columns, buffer B the rest, each in
        # declared order
        order = {name: i for i, name in enumerate(columns)}
        first_half = frozenset(columns[:(len(columns) + 1) // 2])
        resolved: Set[str] = set()

        def flush(names):
            if not names:
                return
            t0 = time.perf_counter_ns()
            flat = [a for nm in names for a in decoded[nm][0]]
            ups = packed_upload(flat, dev)
            nbytes = sum(a.nbytes for a in flat)
            note(UPLOAD_BYTES, nbytes)
            if _events.enabled() or _obs.enabled():
                _events.emit("pq_pipeline", stage="upload", rg=rg,
                             bytes=int(nbytes),
                             dur=time.perf_counter_ns() - t0)
                _obs.inc("tpu_pq_pipeline_stages", 1, stage="upload")
                _obs.inc("tpu_pq_pipeline_bytes", int(nbytes),
                         stage="upload")
            i = 0
            for nm in names:
                k = len(decoded[nm][0])
                dev_args[nm] = ups[i: i + k]
                i += k

        remaining = set(futs)
        while remaining:
            done, remaining = wait(remaining, return_when=FIRST_COMPLETED)
            for fut in done:
                name, plan, dt_ns = fut.result()
                note(HOST_DECODE_TIME, dt_ns)
                resolved.add(name)
                if plan is not None:
                    try:
                        args, run = plan_decode(
                            plan, fields_by_name[name].dataType, cap,
                            dict_strings)
                    except _FallbackError:
                        plan = None
                if plan is None:
                    fallback_cols.append(name)
                    note(HOST_FALLBACK_CHUNKS, 1)
                    continue
                plans[name] = plan
                decoded[name] = (args, run)
                staged_names.append(name)
            if not flushed and first_half <= resolved:
                flush(sorted((nm for nm in staged_names
                              if nm in first_half), key=order.__getitem__))
                staged_names = [nm for nm in staged_names
                                if nm not in first_half]
                flushed = True
        flush(sorted(staged_names, key=order.__getitem__))

        if not plans:
            yield rg, None
            continue
        host_table = (pf.read_row_groups([rg], columns=fallback_cols)
                      if fallback_cols else None)
        t0 = time.perf_counter_ns()
        cols = []
        fields = []
        for name, f in zip(columns, tpu_fields):
            if name in plans:
                cols.append(_run_decode(plans[name], f.dataType,
                                        decoded[name][1], dev_args[name],
                                        dev))
            else:
                sub = host_table.select([name])
                b = arrow_to_batch(sub, StructType((f,)), device=dev)
                cols.append(b.columns[0])
            fields.append(f)
        batch = ColumnarBatch(cols, StructType(tuple(fields)), n)
        if _events.enabled():
            _events.emit("pq_pipeline", stage="unpack", rg=rg, bytes=0,
                         dur=time.perf_counter_ns() - t0)
        if _obs.enabled():
            _obs.inc("tpu_pq_pipeline_stages", 1, stage="unpack")
        # advance the window BEFORE yielding: the next row group's chunks
        # decode while the consumer works on this batch
        nxt = pos + window
        if nxt < len(rgs):
            submit(nxt)
        yield rg, batch
