"""ctypes binding of the repo's native host code (``native/src``).

Counterpart of ``spark_rapids_tpu/native.py``, with the same four entry
points, signatures and errors: the lz4 block codec of the host shuffle
and the parquet host decoders (the RLE/bit-packed hybrid stream and the
BYTE_ARRAY dictionary page). The port builds its own library: at first
use, under a lock, ``g++ -O3 -shared -fPIC -std=c++17`` compiles
``native/src/lz4.cpp`` and ``native/src/parquet_decode.cpp`` into the
git-ignored ``spark_rapids_tpu_torch/_build/``, again whenever a source
is newer than the library. Nothing is written into ``native/``, and the
reference's ``native/build.py`` is neither imported nor run.

The library is host code. Its calls release the GIL (ctypes does for
every foreign call), so the parquet scan's decode pool gets real
parallelism. Without a compiler :func:`available` is False: the parquet
decoders return None and their callers take the numpy route, while the
lz4 codec raises ``RuntimeError``, as in the reference.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG.parent / "native" / "src" / "lz4.cpp",
           _PKG.parent / "native" / "src" / "parquet_decode.cpp")
LIBRARY = _PKG / "_build" / "libsrt_native.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
#: why the library is unavailable ("" while it loads or is untried)
BUILD_ERROR = ""


def build(force: bool = False) -> Path:
    """Compile the library unless it is newer than every source; returns
    its path. Raises ``CalledProcessError`` (g++'s own output attached)
    or ``FileNotFoundError`` (no g++)."""
    if not force and LIBRARY.exists() and all(
            LIBRARY.stat().st_mtime >= s.stat().st_mtime for s in SOURCES):
        return LIBRARY
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                    *(str(s) for s in SOURCES)],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, LIBRARY)  # atomic: another process may be loading it
    return LIBRARY


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, BUILD_ERROR
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.CalledProcessError) as e:
            BUILD_ERROR = (f"{e}: {e.stderr.strip()}"
                           if isinstance(e, subprocess.CalledProcessError)
                           else str(e))
            return None
        lib.srtpu_lz4_bound.restype = ctypes.c_int
        lib.srtpu_lz4_bound.argtypes = [ctypes.c_int]
        lib.srtpu_lz4_compress.restype = ctypes.c_int
        lib.srtpu_lz4_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_char), ctypes.c_int]
        lib.srtpu_lz4_decompress.restype = ctypes.c_int
        lib.srtpu_lz4_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_char), ctypes.c_int]
        lib.srtpu_pq_hybrid_decode.restype = ctypes.c_int64
        lib.srtpu_pq_hybrid_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p]
        lib.srtpu_pq_binary_dict.restype = ctypes.c_int64
        lib.srtpu_pq_binary_dict.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ build failed?)")
    return lib


def lz4_compress(data: bytes) -> bytes:
    lib = _require()
    if not data:
        return b""
    cap = lib.srtpu_lz4_bound(len(data))
    buf = ctypes.create_string_buffer(cap)
    n = lib.srtpu_lz4_compress(data, len(data), buf, cap)
    if n <= 0:
        raise RuntimeError("lz4 compression failed")
    return buf.raw[:n]


def lz4_decompress(data: bytes, out_size: int) -> bytes:
    lib = _require()
    if out_size == 0:
        return b""
    buf = ctypes.create_string_buffer(out_size)
    n = lib.srtpu_lz4_decompress(data, len(data), buf, out_size)
    if n != out_size:
        raise ValueError(f"lz4 payload corrupt ({n} != {out_size})")
    return buf.raw


def pq_hybrid_decode(data, pos: int, end: int, bw: int, n: int, out):
    """Expand one parquet RLE/bit-packed hybrid stream into ``out`` (a
    contiguous numpy array of u8/u16/i32, len >= n). Returns the byte
    position after the stream, or None when the library is unavailable;
    raises ValueError on a malformed stream."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, np.uint8)  # zero-copy view (bytes or mmap)
    rc = lib.srtpu_pq_hybrid_decode(
        src.ctypes.data, pos, min(end, src.shape[0]), bw, n,
        out.dtype.itemsize, out.ctypes.data)
    if rc < 0:
        raise ValueError(f"malformed hybrid stream (bw={bw}, n={n})")
    return int(rc)


def pq_binary_dict(raw: bytes, count: int, offsets, chars) -> Optional[int]:
    """Parse a BYTE_ARRAY PLAIN dictionary page into the int32 ``offsets``
    (count + 1) and u8 ``chars`` numpy arrays. Returns the total char
    bytes, None when the library is unavailable; raises ValueError on a
    malformed page."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(raw, np.uint8)
    rc = lib.srtpu_pq_binary_dict(
        src.ctypes.data, src.shape[0], count,
        offsets.ctypes.data, chars.ctypes.data, chars.shape[0])
    if rc < 0:
        raise ValueError("malformed binary dictionary page")
    return int(rc)
