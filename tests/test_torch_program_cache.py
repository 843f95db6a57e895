"""The port's persistent kernel-library cache (``serve/program_cache.py``)
and its compile-miss feed (``ops/_cuda_build.py``).

A machine without ``nvcc`` runs these tests: a stub "build" writes a
file and a stub "load" reads it back and checks its symbols, so the
cache's own logic —
identity, store, hit, LRU eviction, the poisoned entry, the two fault
channels, the stats — runs as it does on the card. The stats keys and
the fault grammar are held to the reference's.
"""
import json
import os
import struct
from pathlib import Path

import pytest

from spark_rapids_tpu import faults as JF
from spark_rapids_tpu.serve import program_cache as JPC
from spark_rapids_tpu_torch import events
from spark_rapids_tpu_torch import faults as PF
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.ops import _cuda_build
from spark_rapids_tpu_torch.serve import program_cache as PC


@pytest.fixture(autouse=True)
def _clean():
    yield
    PC.uninstall()
    PF.uninstall()
    JF.uninstall()
    events.uninstall()


class _Lib:
    def __init__(self, path, text):
        self.path = path
        self.text = text


def _stub_build(calls):
    def build(source, out, log):
        calls.append(source.stem)
        Path(out).write_text("LIB " + source.read_text())
        log.append("built " + source.stem)
    return build


def _stub_open(path, symbols):
    text = Path(path).read_text()
    if not text.startswith("LIB "):
        raise OSError(f"{path}: not a library")
    for s in symbols:
        if s not in text:
            raise AttributeError(s)
    return _Lib(path, text)


def _source(tmp_path, name="k1", body="sym_a sym_b"):
    p = tmp_path / "src" / f"{name}.cu"
    p.parent.mkdir(exist_ok=True)
    p.write_text(body)
    return p


def _cache(tmp_path, **extra):
    pc = PC.ProgramCache(RapidsConf({
        "spark.rapids.tpu.aotCache.dir": str(tmp_path / "aot"), **extra}))
    pc.device_name, pc.capability, pc.nvcc_version = "card", "9.0", "V1"
    return pc


def _logged():
    logger = events.EventLogger(RapidsConf(
        {"spark.rapids.tpu.eventLog.enabled": True}))
    events.install(logger)
    return logger


def _ops(logger):
    return [r["op"] for r in logger.records() if r["event"] == "program_cache"]


def test_store_then_hit(tmp_path):
    src = _source(tmp_path)
    calls = []
    logger = _logged()
    pc = _cache(tmp_path)
    lib, saved = pc.load_library(src, [], ("sym_a",), _stub_build(calls),
                                 _stub_open)
    assert saved is None and calls == ["k1"]
    assert lib.text == "LIB sym_a sym_b"
    entries = [n for n in os.listdir(pc.dir) if n.endswith(".aot")]
    assert entries == [pc.entry_name(pc.identity(src))]
    # the entry: an 8-byte header length, the JSON header, the bytes
    raw = (Path(pc.dir) / entries[0]).read_bytes()
    (hlen,) = struct.unpack(">Q", raw[:8])
    header = json.loads(raw[8:8 + hlen])
    assert header["blob_len"] == len(raw) - 8 - hlen
    assert set(PC.IDENTITY_KEYS) <= set(header)
    assert header["nvcc_flags"] == list(_cuda_build.NVCC_FLAGS)
    # a second process's cache: a hit, no build, the build time saved
    pc2 = _cache(tmp_path)
    lib2, saved2 = pc2.load_library(src, [], ("sym_a",),
                                    _stub_build(calls), _stub_open)
    assert calls == ["k1"] and saved2 == header["build_ms"]
    assert lib2.text == lib.text
    assert pc2.stats.to_json()["hits"] == 1
    assert _ops(logger) == ["miss", "put", "hit"]


def test_stats_keys_are_the_references():
    assert set(PC.ProgramCacheStats().to_json()) == set(
        JPC.ProgramCacheStats().to_json())


def test_identity_keys_apart(tmp_path):
    """Flipping a component of the identity (the source, the compiler,
    the card, the conf fingerprint) is a miss, never a stale hit."""
    src = _source(tmp_path)
    calls = []
    _cache(tmp_path).load_library(src, [], (), _stub_build(calls),
                                  _stub_open)
    for flip in ("nvcc_version", "device_name", "capability"):
        pc = _cache(tmp_path)
        setattr(pc, flip, "other")
        pc.load_library(src, [], (), _stub_build(calls), _stub_open)
    pc = _cache(tmp_path, **{"spark.rapids.tpu.sql.agg.strategy": "SORT"})
    pc.device_name, pc.capability, pc.nvcc_version = "card", "9.0", "V1"
    pc.load_library(src, [], (), _stub_build(calls), _stub_open)
    # observability keys do not key apart
    pc = _cache(tmp_path, **{"spark.rapids.tpu.eventLog.enabled": True})
    pc.load_library(src, [], (), _stub_build(calls), _stub_open)
    src.write_text("sym_a changed")
    _cache(tmp_path).load_library(src, [], (), _stub_build(calls),
                                  _stub_open)
    assert calls == ["k1"] * 6
    assert PC.program_conf_fingerprint(RapidsConf(
        {"spark.rapids.tpu.metrics.live.enabled": True})) == \
        PC.program_conf_fingerprint(RapidsConf({}))


def test_a_process_without_nvcc_takes_the_matching_entry(tmp_path):
    src = _source(tmp_path)
    calls = []
    _cache(tmp_path).load_library(src, [], (), _stub_build(calls),
                                  _stub_open)
    pc = _cache(tmp_path)
    pc.nvcc_version = None
    lib, saved = pc.load_library(src, [], (), _stub_build(calls), _stub_open)
    assert calls == ["k1"] and saved is not None
    # and no entry of another card
    pc = _cache(tmp_path)
    pc.nvcc_version, pc.device_name = None, "other"
    pc.load_library(src, [], (), _stub_build(calls), _stub_open)
    assert calls == ["k1", "k1"]


@pytest.mark.parametrize("damage", ["truncate", "header", "bytes",
                                    "symbol", "load"])
def test_a_poisoned_entry_is_deleted_and_rebuilt(tmp_path, damage):
    src = _source(tmp_path)
    calls = []
    logger = _logged()
    pc = _cache(tmp_path)
    pc.load_library(src, [], ("sym_a",), _stub_build(calls), _stub_open)
    path = os.path.join(pc.dir, pc.entry_name(pc.identity(src)))
    raw = Path(path).read_bytes()
    (hlen,) = struct.unpack(">Q", raw[:8])
    want = ("sym_a",)
    if damage == "truncate":
        Path(path).write_bytes(raw[:len(raw) // 2])
    elif damage == "header":
        Path(path).write_bytes(raw[:8] + b"{" * hlen + raw[8 + hlen:])
    elif damage == "bytes":
        Path(path).write_bytes(raw[:-1] + b"X")
    elif damage == "symbol":
        want = ("sym_missing",)
        src_ok = src.read_text()
        src.write_text(src_ok)  # same source: the entry's identity
    else:  # a library that fails to load, its digest intact
        import hashlib

        blob = b"NOT" + raw[8 + hlen + 3:]
        header = json.loads(raw[8:8 + hlen])
        header["blob_sha256"] = hashlib.sha256(blob).hexdigest()
        head = json.dumps(header).encode()
        Path(path).write_bytes(struct.pack(">Q", len(head)) + head + blob)
    pc2 = _cache(tmp_path)
    if damage == "symbol":
        with pytest.raises(AttributeError):
            pc2.load_library(src, [], want, _stub_build(calls), _stub_open)
        assert pc2.stats.to_json()["corrupt"] == 1
        return
    lib, saved = pc2.load_library(src, [], want, _stub_build(calls),
                                  _stub_open)
    assert saved is None and calls == ["k1", "k1"]
    assert pc2.stats.to_json()["corrupt"] == 1
    assert pc2.stats.to_json()["puts"] == 1
    # rebuilt and stored again: the same library bytes
    assert Path(path).read_bytes().endswith(raw[8 + hlen:])
    assert pc2.load_library(src, [], want, _stub_build(calls),
                            _stub_open)[1] is not None
    assert "corrupt" in _ops(logger)


def test_lru_eviction_over_max_bytes(tmp_path):
    srcs = [_source(tmp_path, f"k{i}", "sym " + "x" * 4000)
            for i in range(4)]
    calls = []
    logger = _logged()
    pc = _cache(tmp_path, **{"spark.rapids.tpu.aotCache.maxBytes": 11000})
    for s in srcs[:2]:
        pc.load_library(s, [], (), _stub_build(calls), _stub_open)
    # a hit touches k0: k1 becomes the least recently used
    os.utime(os.path.join(pc.dir, pc.entry_name(pc.identity(srcs[1]))),
             (1, 1))
    pc.load_library(srcs[0], [], (), _stub_build(calls), _stub_open)
    pc.load_library(srcs[2], [], (), _stub_build(calls), _stub_open)
    left = set(os.listdir(pc.dir)) - {"lib"}
    names = {pc.entry_name(pc.identity(s)): s.stem for s in srcs}
    assert {names[n] for n in left} == {"k0", "k2"}
    assert pc.stats.to_json()["evictions"] == 1
    assert pc.resident_bytes() <= 11000
    assert "evict" in _ops(logger)


def test_fault_channels(tmp_path):
    """``aotcache`` read faults poison and rebuild, write faults skip the
    store; a ``compile`` fault fails the build before nvcc runs. The
    spec grammar is the reference's."""
    src = _source(tmp_path)
    calls = []
    _cache(tmp_path).load_library(src, [], (), _stub_build(calls),
                                  _stub_open)
    PF.install(RapidsConf({"spark.rapids.tpu.test.faults.aotcache":
                           "read:k1@1,write:k1"}))
    pc = _cache(tmp_path)
    pc.load_library(src, [], (), _stub_build(calls), _stub_open)
    s = pc.stats.to_json()
    assert calls == ["k1", "k1"]
    assert (s["corrupt"], s["write_errors"], s["puts"]) == (1, 1, 0)
    assert not [n for n in os.listdir(pc.dir) if n.endswith(".aot")]
    inj = PF.install(RapidsConf({"spark.rapids.tpu.test.faults.compile":
                                 "k1"}))
    with pytest.raises(PF.InjectedCompileError):
        _cuda_build.nvcc_compile(src, tmp_path / "out.so", [])
    assert inj.fired() == [("compile", "k1", 1)]
    assert issubclass(PF.InjectedCacheError, OSError)
    for raw in ("read:*@2", "write:k?3", "k1%2"):
        jf = JF.FaultInjector(JF.RapidsConf(
            {"spark.rapids.tpu.test.faults.aotcache": raw}))
        pf = PF.FaultInjector(RapidsConf(
            {"spark.rapids.tpu.test.faults.aotcache": raw}))
        got = []
        for inj_ in (jf, pf):
            fired = []
            for i in range(4):
                try:
                    inj_.check("aotcache", "read:k1")
                    inj_.check("aotcache", "write:k1")
                except OSError:
                    fired.append(i)
            got.append(fired)
        assert got[0] == got[1], raw


def test_compile_miss_feeds_events_and_the_watchdog():
    from spark_rapids_tpu_torch import obs

    logger = _logged()
    reg = obs.MetricsRegistry()
    obs.install(reg)
    try:
        before = _cuda_build.compile_miss_count()
        for _ in range(3):
            _cuda_build.note_compile_miss("groupby_kernels")
        assert _cuda_build.compile_miss_count() == before + 3
        recs = [r for r in logger.records() if r["event"] == "compile_miss"]
        assert [r["site"] for r in recs] == ["groupby_kernels"] * 3
        assert recs[-1]["total"] == before + 3
        snap = reg.snapshot()
        assert any("tpu_compile_misses" in k for k in snap), snap
    finally:
        obs.uninstall()


def test_load_library_goes_through_the_installed_cache(tmp_path,
                                                       monkeypatch):
    """With the cache installed the kernel modules' load takes it (and
    the cost plane's load stats see a cached library); off, it never
    touches the cache's directory."""
    src = _source(tmp_path)
    seen = []

    def fake(self, source, log, symbols, build=None, open_lib=None):
        seen.append((source.stem, tuple(symbols)))
        return "LIB", 12.5

    monkeypatch.setattr(PC.ProgramCache, "load_library", fake)
    assert PC.install(RapidsConf({})) is None and not PC.enabled()
    pc = PC.install(RapidsConf(
        {"spark.rapids.tpu.aotCache.dir": str(tmp_path / "aot")}))
    assert PC.enabled() and PC.active() is pc
    ns0, cached0, saved0 = _cuda_build.load_stats()
    assert _cuda_build.load_library(src, tmp_path / "b", [], ("s",)) == "LIB"
    ns1, cached1, saved1 = _cuda_build.load_stats()
    assert seen == [("k1", ("s",))]
    assert (cached1 - cached0, saved1 - saved0) == (1, 12.5)
    assert not (tmp_path / "b").exists()


def test_status_shows_the_stats(tmp_path):
    from spark_rapids_tpu_torch import obs
    from spark_rapids_tpu_torch.obs.progress import tracker
    from spark_rapids_tpu_torch.obs.server import build_status

    reg = obs.MetricsRegistry()
    obs.install(reg)
    try:
        assert build_status(reg, tracker(), None)["program_cache"] is None
        PC.install(RapidsConf(
            {"spark.rapids.tpu.aotCache.dir": str(tmp_path / "aot")}))
        st = build_status(reg, tracker(), None)["program_cache"]
        assert st == PC.stats() and set(st) == set(
            JPC.ProgramCacheStats().to_json())
    finally:
        obs.uninstall()
