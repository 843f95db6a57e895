"""Deterministic, conf-gated fault injector (``spark.rapids.tpu.test.faults.*``).

Counterpart of ``spark_rapids_tpu/faults.py``: the same keys, spec
grammar, seeding and error types, so one fault spec drives both packages
to the same arrivals. Five channels, each a conf of comma-separated site
specs:

  * ``oom``      — synthetic device OOM at the top of a retry-harness
                   attempt (the site is the exec's node name);
  * ``transfer`` — host-to-device upload failure in ``packed_upload``;
  * ``fetch``    — network shuffle fetch failure (site ``network_fetch``
                   in ``shuffle/network.ShuffleClient``), a
                   ConnectionError that the client's retry loop takes
                   like a real peer reset;
  * ``compile``  — kernel-library build failure, just before ``nvcc``
                   runs (the site is the library's stem, e.g.
                   ``groupby_kernels``; ``ops/_cuda_build.py``);
  * ``aotcache`` — kernel-library cache I/O failure
                   (``serve/program_cache.py``; sites ``read:<stem>`` /
                   ``write:<stem>``).

Spec grammar (per entry, comma-separated; sites match by fnmatch)::

    site        fire on EVERY arrival at the site
    site@N      fire on exactly the Nth arrival (1-based, once)
    site%K      fire on every Kth arrival
    site>C      fire while the attempt's batch capacity exceeds C rows
                (full batches fail, split halves fit)
    site?K      fire on ONE arrival in [1, K], chosen deterministically
                from test.faults.seed

With the confs off (the default) :func:`enabled` is one module-global
boolean read and nothing is consulted.
"""
from __future__ import annotations

import fnmatch
import threading
from typing import Dict, List, Optional, Tuple

from .conf import (FAULTS_AOTCACHE, FAULTS_COMPILE, FAULTS_ENABLED,
                   FAULTS_FETCH, FAULTS_OOM, FAULTS_SEED, FAULTS_TRANSFER,
                   RapidsConf)

_CHANNEL_CONFS = {
    "oom": FAULTS_OOM,
    "transfer": FAULTS_TRANSFER,
    "fetch": FAULTS_FETCH,
    "compile": FAULTS_COMPILE,
    "aotcache": FAULTS_AOTCACHE,
}


class InjectedFault(RuntimeError):
    """Base of every injector-raised error (tests discriminate on it)."""


class InjectedOOM(InjectedFault):
    """Synthetic device OOM: ``memory/retry.is_device_oom`` takes it as
    it takes ``torch.cuda.OutOfMemoryError``. Its message carries the
    reference's RESOURCE_EXHAUSTED text."""


class InjectedTransferError(InjectedFault, ConnectionError):
    """Synthetic host-link transfer failure."""


class InjectedFetchError(InjectedFault, ConnectionError):
    """Synthetic shuffle fetch failure (a ConnectionError, so the
    transport's retry loop treats it like a real peer reset)."""


class InjectedCompileError(InjectedFault):
    """Synthetic kernel-library build failure."""


class InjectedCacheError(InjectedFault, OSError):
    """Synthetic kernel-library cache I/O failure (an OSError, so the
    cache's read and write paths take it like a real disk fault: the
    entry poisoned on a read, the store skipped on a write)."""


_ERROR_OF = {
    "oom": InjectedOOM,
    "transfer": InjectedTransferError,
    "fetch": InjectedFetchError,
    "compile": InjectedCompileError,
    "aotcache": InjectedCacheError,
}


class _Spec:
    """One parsed site spec."""

    __slots__ = ("pattern", "mode", "arg")

    def __init__(self, pattern: str, mode: str, arg: int):
        self.pattern = pattern
        self.mode = mode  # "always" | "nth" | "every" | "cap_gt" | "seeded"
        self.arg = arg

    def fires(self, arrival: int, cap: Optional[int], seed_at: int) -> bool:
        if self.mode == "always":
            return True
        if self.mode == "nth":
            return arrival == self.arg
        if self.mode == "every":
            return arrival % self.arg == 0
        if self.mode == "cap_gt":
            return cap is not None and cap > self.arg
        # seeded: one deterministic arrival in [1, arg]
        return arrival == seed_at


def _parse_specs(raw: str) -> List[_Spec]:
    """Parse a channel's spec list, VALIDATING at construction (session
    init) so a typo'd schedule is a clear conf error, never a
    mid-query crash from inside the recovery plane (e.g. 'site%0'
    would otherwise divide by zero at the injection site). Separators
    split on their LAST occurrence, so fnmatch '?' inside a pattern
    survives when a real separator follows; a bare trailing '?<K>' is
    always the seeded spec — '?' as a trailing fnmatch wildcard is not
    expressible (use '*')."""
    out: List[_Spec] = []
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        for sep, mode in (("@", "nth"), ("%", "every"), (">", "cap_gt"),
                          ("?", "seeded")):
            if sep in entry:
                pat, _, arg = entry.rpartition(sep)
                try:
                    n = int(arg)
                except ValueError:
                    raise ValueError(
                        f"bad fault spec {entry!r}: expected an integer "
                        f"after {sep!r}")
                if mode == "cap_gt":
                    if n < 0:
                        raise ValueError(
                            f"bad fault spec {entry!r}: capacity "
                            "threshold must be >= 0")
                elif n <= 0:
                    raise ValueError(
                        f"bad fault spec {entry!r}: argument must be "
                        "positive")
                out.append(_Spec(pat.strip(), mode, n))
                break
        else:
            out.append(_Spec(entry, "always", 0))
    return out


class FaultInjector:
    """Per-(channel, site) arrival counters driving the parsed specs —
    deterministic by construction (counts, not clocks)."""

    def __init__(self, conf_: RapidsConf):
        self.seed = int(conf_.get(FAULTS_SEED))
        self._specs: Dict[str, List[_Spec]] = {
            ch: _parse_specs(conf_.get(centry))
            for ch, centry in _CHANNEL_CONFS.items()
        }
        self._counts: Dict[Tuple[str, str], int] = {}
        self._fired: List[Tuple[str, str, int]] = []
        self._lock = threading.Lock()

    def _seed_at(self, channel: str, site: str, k: int) -> int:
        # xorshift-style mix of (seed, channel, site) -> [1, k]
        h = (self.seed * 1_000_003) & 0xFFFFFFFF
        for c in channel + ":" + site:
            h = ((h ^ ord(c)) * 16_777_619) & 0xFFFFFFFF
        return (h % max(1, k)) + 1

    def check(self, channel: str, site: str,
              cap: Optional[int] = None) -> None:
        """Raise the channel's typed injected error if any spec fires on
        this arrival at ``site``."""
        specs = self._specs.get(channel)
        if not specs:
            return
        with self._lock:
            key = (channel, site)
            arrival = self._counts.get(key, 0) + 1
            self._counts[key] = arrival
            hit = None
            for s in specs:
                if not fnmatch.fnmatch(site, s.pattern):
                    continue
                seed_at = (self._seed_at(channel, site, s.arg)
                           if s.mode == "seeded" else 0)
                if s.fires(arrival, cap, seed_at):
                    hit = s
                    break
            if hit is None:
                return
            self._fired.append((channel, site, arrival))
        if channel == "oom":
            raise InjectedOOM(
                f"RESOURCE_EXHAUSTED: injected synthetic device OOM at "
                f"{site} (arrival {arrival}"
                + (f", cap {cap}" if cap is not None else "") + ")")
        raise _ERROR_OF[channel](
            f"injected {channel} fault at {site} (arrival {arrival})")

    def fired(self) -> List[Tuple[str, str, int]]:
        """(channel, site, arrival) for every fault raised so far."""
        with self._lock:
            return list(self._fired)


# ---------------------------------------------------------------------------
# Process-global active injector: injection sites live deep in the engine,
# where no session handle exists.
# ---------------------------------------------------------------------------
_ENABLED = False
_ACTIVE: Optional[FaultInjector] = None
_INSTALL_LOCK = threading.Lock()


def enabled() -> bool:
    """The hot-path guard — one module-global boolean read."""
    return _ENABLED


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def install(conf_: RapidsConf) -> Optional[FaultInjector]:
    """Install the injector when the confs ask for one (idempotent per
    conf; any nonempty channel spec implies faults.enabled). Returns
    None — and installs NOTHING — with the confs off."""
    want = conf_.get(FAULTS_ENABLED) or any(
        conf_.get(c) for c in _CHANNEL_CONFS.values())
    if not want:
        return None
    global _ENABLED, _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = FaultInjector(conf_)
        _ENABLED = True
        return _ACTIVE


def uninstall() -> None:
    global _ENABLED, _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = None
        _ENABLED = False


def check(channel: str, site: str, cap: Optional[int] = None) -> None:
    """Consult the active injector; a no-op when injection is off. Call
    sites guard on :func:`enabled` first so the off path stays one
    boolean read."""
    if not _ENABLED:
        return
    inj = _ACTIVE
    if inj is not None:
        inj.check(channel, site, cap)
