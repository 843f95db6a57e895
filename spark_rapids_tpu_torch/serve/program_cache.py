"""Persistent kernel-library cache: build once, load everywhere.

Counterpart of ``spark_rapids_tpu/serve/program_cache.py``. The
reference persists XLA programs; the port's only compiled programs are
the ``nvcc``-built libraries of ``csrc/*.cu`` (``ops/_cuda_build.py``),
so this is their disk cache. A fresh process otherwise pays one
``nvcc`` run per library (seconds each) before its first query returns.

Entry anatomy: one ``<sha256>.aot`` file per library, named by its full
identity — (format version, library stem, source digest, ``NVCC_FLAGS``,
``nvcc --version``, torch version, CUDA version, device name, compute
capability, :func:`program_conf_fingerprint`) — so flipping any
component is a natural miss. The file holds an 8-byte header length, a
JSON header (the identity spelled out, the build's milliseconds, the
library's length and sha256) and then the library's bytes. It is written
to a temporary name and renamed, under a best-effort cross-process
lockfile (the reference's single-flight: a loser skips the duplicate
write). A process without ``nvcc`` cannot ask the compiler for its
version, so it takes the newest entry whose header matches every other
component of the identity.

A hit copies the library's bytes to ``<dir>/lib/`` (named by the entry
and the bytes' digest), loads it with ``ctypes`` (no ``nvcc``), checks
the library's symbols, and bumps the entry's mtime; the least recently
used entries are evicted once the directory passes
``aotCache.maxBytes``. A truncated entry, a bad header, a digest
mismatch, a library that fails to load or lacks a symbol: the entry is
poisoned (deleted, one ``program_cache`` ``corrupt`` event) and the
library is rebuilt from its source. There is no other fallback: a miss
in a process without ``nvcc`` raises, as a build without the cache does.
The ``aotcache`` fault channel (``read:<stem>`` / ``write:<stem>``)
drives both negative paths deterministically; ``compile`` fails the
build itself (``ops/_cuda_build.nvcc_compile``).

Events: ``program_cache`` with op hit / miss / put (the store) / evict /
corrupt / write_error, and their live twin ``tpu_program_cache``. The
stats (:class:`ProgramCacheStats`, the reference's keys) feed
``/status``'s ``program_cache``. A harvested call that loaded a library
from the cache reports ``from_cache`` and the build time the entry
recorded (``saved_ms``, ``kernel_cost.py``).

With the confs off (the default) nothing is installed: :func:`enabled`
is one module-global boolean read, no directory is touched, and the
libraries stay in the package's ``_build/`` as before.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import events as _events
from .. import faults as _faults
from .. import obs as _obs
from ..conf import (AOT_CACHE_DIR, AOT_CACHE_ENABLED,  # noqa: F401
                    AOT_CACHE_MAX_BYTES, RapidsConf)
from ..utils.locks import ordered_lock

#: bump to invalidate every existing entry (header + filename component)
FORMAT_VERSION = 1

#: conf prefixes left out of the fingerprint: observability, chaos and the
#: cache's own knobs cannot change what a library computes
_FINGERPRINT_EXCLUDE = (
    "spark.rapids.tpu.aotCache.",
    "spark.rapids.tpu.eventLog.",
    "spark.rapids.tpu.metrics.",
    "spark.rapids.tpu.watchdog.",
    "spark.rapids.tpu.hlo.",
    "spark.rapids.tpu.roofline.",
    "spark.rapids.tpu.tools.",
    "spark.rapids.tpu.test.faults.",
)

#: lockfiles older than this are presumed abandoned (a crashed writer)
_LOCK_STALE_S = 120.0

#: the identity components an entry's header spells out
IDENTITY_KEYS = ("version", "stem", "source_sha256", "nvcc_flags",
                 "nvcc_version", "torch_version", "cuda_version",
                 "device_name", "capability", "conf_fp")


def program_conf_fingerprint(conf_: RapidsConf) -> str:
    """sha256 of the explicitly-set conf values that can shape compiled
    programs (see _FINGERPRINT_EXCLUDE) — the disk twin of
    serve/plan_cache.conf_fingerprint, filtered so observability-only
    settings don't shatter the key space."""
    items = tuple(sorted(
        (k, repr(v)) for k, v in conf_._values.items()
        if not any(k.startswith(p) for p in _FINGERPRINT_EXCLUDE)))
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


class ProgramCacheStats:
    """Thread-safe counters for one installed cache (the reference's
    keys: ``deserialized`` counts libraries loaded from entries,
    ``warm_ms`` the time those loads took, ``saved_ms`` the build time
    their entries recorded)."""

    def __init__(self):
        self._lock = ordered_lock("aot.stats")
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.corrupt = 0
        self.write_errors = 0
        self.deserialized = 0
        self.saved_ms = 0.0
        self.warm_ms = 0.0

    def bump(self, field: str, amount: float = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + amount)

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "hits": self.hits, "misses": self.misses,
                "puts": self.puts, "evictions": self.evictions,
                "corrupt": self.corrupt,
                "write_errors": self.write_errors,
                "deserialized": self.deserialized,
                "saved_ms": round(self.saved_ms, 3),
                "warm_ms": round(self.warm_ms, 3),
            }


def _event(op: str, site: str, key: str, nbytes: int, **extra) -> None:
    if _events.enabled():
        _events.emit("program_cache", op=op, site=site, key=key,
                     bytes=nbytes, **extra)
    if _obs.enabled():
        _obs.inc("tpu_program_cache", 1, op=op)


class ProgramCache:
    """One disk-backed kernel-library store (:func:`install` makes it
    active). The device and compiler components of the identity are read
    at the first load (a card is there by then); tests set them on the
    instance, as the reference's key-flip tests do."""

    def __init__(self, conf_: RapidsConf):
        d = conf_.get(AOT_CACHE_DIR) or os.path.expanduser(
            "~/.cache/spark-rapids-tpu/aot")
        self.dir = os.path.abspath(d)
        self.lib_dir = os.path.join(self.dir, "lib")
        self.max_bytes = conf_.get(AOT_CACHE_MAX_BYTES)
        self.conf_fp = program_conf_fingerprint(conf_)
        self.stats = ProgramCacheStats()
        self.device_name: Optional[str] = None
        self.capability: Optional[str] = None
        #: False until the first load reads it (None: no nvcc found)
        self.nvcc_version: Any = False
        os.makedirs(self.lib_dir, exist_ok=True)

    # -- keying ------------------------------------------------------------
    def _environment(self) -> None:
        import torch

        from ..ops import _cuda_build

        if self.device_name is None:
            if torch.cuda.is_available():
                self.device_name = torch.cuda.get_device_name(0)
                self.capability = "%d.%d" % torch.cuda.get_device_capability(0)
            else:
                self.device_name, self.capability = "cpu", ""
        if self.nvcc_version is False:
            self.nvcc_version = _cuda_build.compiler_version()

    def identity(self, source: Path) -> Dict[str, Any]:
        import torch

        from ..ops import _cuda_build

        self._environment()
        return {
            "version": FORMAT_VERSION, "stem": source.stem,
            "source_sha256": hashlib.sha256(source.read_bytes()).hexdigest(),
            "nvcc_flags": list(_cuda_build.NVCC_FLAGS),
            "nvcc_version": self.nvcc_version,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device_name": self.device_name, "capability": self.capability,
            "conf_fp": self.conf_fp,
        }

    @staticmethod
    def entry_name(ident: Dict[str, Any]) -> str:
        text = repr(tuple((k, ident[k]) for k in IDENTITY_KEYS))
        return hashlib.sha256(text.encode()).hexdigest()[:40] + ".aot"

    # -- disk I/O ------------------------------------------------------------
    @staticmethod
    def _read_header(f) -> Dict[str, Any]:
        raw = f.read(8)
        if len(raw) < 8:
            raise ValueError("truncated entry (no header length)")
        (hlen,) = struct.unpack(">Q", raw)
        head = f.read(hlen) if 0 < hlen < (1 << 20) else b""
        if not head or len(head) != hlen:
            raise ValueError("truncated entry (header)")
        return json.loads(head.decode())

    def _read_entry(self, path: str) -> Tuple[Dict[str, Any], bytes]:
        """Parse one entry; raises on any corruption."""
        with open(path, "rb") as f:
            header = self._read_header(f)
            blob = f.read()
        if header.get("blob_len") != len(blob):
            raise ValueError(f"truncated entry (library {len(blob)} != "
                             f"{header.get('blob_len')} bytes)")
        if hashlib.sha256(blob).hexdigest() != header.get("blob_sha256"):
            raise ValueError("library bytes do not match their digest")
        return header, blob

    def _find(self, ident: Dict[str, Any]) -> Optional[str]:
        """The entry path for ``ident``; without an ``nvcc`` version (no
        compiler in this process) the newest entry matching the rest."""
        path = os.path.join(self.dir, self.entry_name(ident))
        if ident["nvcc_version"] is not None or os.path.exists(path):
            return path if os.path.exists(path) else None
        best = None
        for p, mtime, _ in self._entries():
            try:
                with open(p, "rb") as f:
                    h = self._read_header(f)
            except (OSError, ValueError):
                continue
            if all(h.get(k) == ident[k] for k in IDENTITY_KEYS
                   if k != "nvcc_version"):
                if best is None or mtime > best[1]:
                    best = (p, mtime)
        return None if best is None else best[0]

    def _poison(self, path: str, stem: str, detail: str) -> None:
        """A corrupt entry: delete it (it can only fail again), count it,
        log it; the caller rebuilds from the source."""
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        for p in [path] + self._extracted(path):
            try:
                os.unlink(p)
            except OSError:
                pass
        self.stats.bump("corrupt")
        _event("corrupt", stem, os.path.basename(path)[:12], size,
               detail=detail[:200])

    def _extracted(self, entry_path: str) -> List[str]:
        stem = os.path.basename(entry_path)[:-4]
        try:
            names = os.listdir(self.lib_dir)
        except OSError:
            return []
        return [os.path.join(self.lib_dir, n) for n in names
                if n.startswith(stem + "-")]

    def _extract(self, entry_path: str, header: Dict[str, Any],
                 blob: bytes) -> Path:
        """The library's bytes as a file ``ctypes`` can load, named by the
        entry and the bytes' digest (a changed library never reuses a
        path the dynamic loader has already mapped)."""
        stem = os.path.basename(entry_path)[:-4]
        so = Path(self.lib_dir) / f"{stem}-{header['blob_sha256'][:12]}.so"
        if not so.exists() or so.stat().st_size != len(blob):
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            tmp.write_bytes(blob)
            os.replace(tmp, so)
        return so

    # -- the load ----------------------------------------------------------
    def load_library(self, source: Path, log: List[str],
                     symbols: Sequence[str],
                     build: Optional[Callable[[Path, Path, List[str]],
                                              None]] = None,
                     open_lib: Optional[Callable] = None
                     ) -> Tuple[Any, Optional[float]]:
        """(loaded library, build ms its entry recorded — None when this
        call built it). ``build(source, out, log)`` compiles (default
        ``nvcc``), ``open_lib(path, symbols)`` loads and checks (default
        ``ctypes``); tests pass stubs."""
        from ..ops import _cuda_build

        build = build or _cuda_build.nvcc_compile
        open_lib = open_lib or _cuda_build.open_library
        stem = source.stem
        ident = self.identity(source)
        path: Optional[str] = None
        try:
            if _faults.enabled():
                _faults.check("aotcache", "read:" + stem)
            path = self._find(ident)
            if path is None:
                self.stats.bump("misses")
                _event("miss", stem, self.entry_name(ident)[:12], 0)
            else:
                t0 = time.perf_counter_ns()
                header, blob = self._read_entry(path)
                mismatched = [k for k in IDENTITY_KEYS
                              if header.get(k) != ident[k]
                              and not (k == "nvcc_version"
                                       and ident[k] is None)]
                if mismatched:
                    raise ValueError("identity mismatch on "
                                     + ",".join(mismatched))
                lib = open_lib(self._extract(path, header, blob), symbols)
                ms = (time.perf_counter_ns() - t0) / 1e6
                try:
                    os.utime(path)  # LRU touch: hits protect an entry
                except OSError:
                    pass
                saved = float(header.get("build_ms") or 0.0)
                self.stats.bump("hits")
                self.stats.bump("deserialized")
                self.stats.bump("saved_ms", saved)
                self.stats.bump("warm_ms", ms)
                _event("hit", stem, os.path.basename(path)[:12], len(blob),
                       ms=round(ms, 3))
                return lib, saved
        except Exception as e:  # noqa: BLE001 - poisoned, then rebuilt
            if path is None:
                path = os.path.join(self.dir, self.entry_name(ident))
            if os.path.exists(path):
                self._poison(path, stem, f"{type(e).__name__}: {e}")
        # miss (or a poisoned entry): build from the source, store, load
        path = os.path.join(self.dir, self.entry_name(ident))
        tmp = Path(self.lib_dir) / f".build-{stem}-{os.getpid()}-" \
            f"{threading.get_ident()}.so"
        t0 = time.perf_counter_ns()
        build(source, tmp, log)
        build_ms = (time.perf_counter_ns() - t0) / 1e6
        try:
            blob = tmp.read_bytes()
        finally:
            try:
                tmp.unlink()
            except OSError:
                pass
        header = dict(ident)
        header.update({"build_ms": round(build_ms, 3),
                       "blob_len": len(blob),
                       "blob_sha256": hashlib.sha256(blob).hexdigest(),
                       "created": round(time.time(), 3)})
        self.store(stem, path, header, blob)
        return open_lib(self._extract(path, header, blob), symbols), None

    # -- store + eviction --------------------------------------------------
    def store(self, stem: str, path: str, header: Dict[str, Any],
              blob: bytes) -> None:
        """Atomic write-then-rename under a best-effort cross-process
        lockfile. A racing writer in another process makes this a no-op
        (it is writing the same bytes); any failure counts and logs, and
        the process goes on with the library it built."""
        key = os.path.basename(path)[:12]
        try:
            if _faults.enabled():
                _faults.check("aotcache", "write:" + stem)
            lock = path + ".lock"
            fd = None
            try:
                try:
                    fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                except FileExistsError:
                    try:
                        fresh = (time.time() - os.path.getmtime(lock)
                                 < _LOCK_STALE_S)
                    except OSError:
                        fresh = False
                    if fresh:
                        return  # single-flight: the other process writes
                    try:
                        os.unlink(lock)  # stale lock from a dead writer
                    except OSError:
                        pass
                    fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                hdr = json.dumps(header, separators=(",", ":"),
                                 sort_keys=True).encode()
                tmp = path + f".tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(struct.pack(">Q", len(hdr)))
                    f.write(hdr)
                    f.write(blob)
                os.replace(tmp, path)
            finally:
                if fd is not None:
                    os.close(fd)
                    try:
                        os.unlink(lock)
                    except OSError:
                        pass
        except Exception as e:  # noqa: BLE001 - a store never fails a load
            self.stats.bump("write_errors")
            _event("write_error", stem, key, 0,
                   detail=f"{type(e).__name__}: {e}"[:200])
            return
        self.stats.bump("puts")
        _event("put", stem, key, len(blob))
        self._evict_if_needed()

    def _entries(self) -> List[Tuple[str, float, int]]:
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for n in names:
            if not n.endswith(".aot"):
                continue
            p = os.path.join(self.dir, n)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((p, st.st_mtime, st.st_size))
        return out

    def resident_bytes(self) -> int:
        return sum(sz for _, _, sz in self._entries())

    def _evict_if_needed(self) -> None:
        """Size-capped LRU over entry mtimes (hits touch their entry, so
        the oldest mtime is the least recently used)."""
        entries = self._entries()
        total = sum(sz for _, _, sz in entries)
        if total > self.max_bytes:
            for p, _, sz in sorted(entries, key=lambda t: t[1]):
                if total <= self.max_bytes:
                    break
                try:
                    os.unlink(p)
                except OSError:
                    continue
                for x in self._extracted(p):
                    try:
                        os.unlink(x)
                    except OSError:
                        pass
                total -= sz
                self.stats.bump("evictions")
                _event("evict", "", os.path.basename(p)[:12], sz)
        if _obs.enabled():
            _obs.set_gauge("tpu_program_cache_resident_bytes", total)


# ---------------------------------------------------------------------------
# Process-global active cache (the events/faults install pattern: the
# libraries load where no session handle exists)
# ---------------------------------------------------------------------------
_ENABLED = False
_ACTIVE: Optional[ProgramCache] = None
_INSTALL_LOCK = threading.Lock()


def enabled() -> bool:
    """The hot-path guard: one module-global boolean read."""
    return _ENABLED


def active() -> Optional[ProgramCache]:
    return _ACTIVE


def stats() -> Optional[Dict[str, Any]]:
    """Live counters for /status and tpu_top (None while off)."""
    pc = _ACTIVE
    return pc.stats.to_json() if pc is not None else None


def install(conf_: RapidsConf) -> Optional[ProgramCache]:
    """Install the cache when the confs ask for one (aotCache.dir implies
    aotCache.enabled). Off, the default, installs nothing and touches no
    directory. Idempotent for an identical (dir, fingerprint, cap)."""
    want = conf_.get(AOT_CACHE_ENABLED) or conf_.get(AOT_CACHE_DIR)
    if not want:
        return None
    global _ENABLED, _ACTIVE
    with _INSTALL_LOCK:
        cache = ProgramCache(conf_)
        cur = _ACTIVE
        if (cur is not None and cur.dir == cache.dir
                and cur.conf_fp == cache.conf_fp
                and cur.max_bytes == cache.max_bytes):
            return cur  # same identity: keep the live stats
        _ACTIVE = cache
        _ENABLED = True
        return cache


def uninstall() -> None:
    """Detach the cache (tests pair install with this)."""
    global _ENABLED, _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = None
        _ENABLED = False
