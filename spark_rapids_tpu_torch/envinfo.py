"""Environment provenance: which hardware produced these numbers.

Counterpart of ``spark_rapids_tpu/envinfo.py``: the session rides this
record on every ``query_start`` event, ``/status`` serves it live, and
``tools/tpu_profile.py --diff`` warns when two logs' backends or device
kinds differ — numbers from different hardware compare structure, not
speed.

For a session on the card ``backend`` is ``"gpu"`` (JAX's own name for
a CUDA backend, so both packages' logs read alike) and ``device_kind``
the card's name; for one on the CPU (``device="cpu"``), ``"cpu"`` and
the host's processor. ``torch_version`` takes the place of the
reference's ``jax_version``.

Memoized per device type after the first call: the answer cannot change
within a process, and it is read on every query_start with events on.
"""
from __future__ import annotations

import os
import platform
from typing import Any, Dict, Optional

_CACHED: Dict[str, Dict[str, Any]] = {}


def environment_info(device=None) -> Dict[str, Any]:
    """{backend, device_kind, device_count, torch_version, host_cores} of
    ``device`` (None: the card when there is one) — plain JSON, safe to
    embed in events."""
    import torch

    dtype = (torch.device(device).type if device is not None
             else "cuda" if torch.cuda.is_available() else "cpu")
    env = _CACHED.get(dtype)
    if env is None:
        if dtype == "cuda":
            backend = "gpu"
            kind = torch.cuda.get_device_name()
            count = torch.cuda.device_count()
        else:
            backend = "cpu"
            kind = platform.processor() or platform.machine() or None
            count = 1
        env = _CACHED[dtype] = {
            "backend": backend,
            "device_kind": kind,
            "device_count": count,
            "torch_version": torch.__version__,
            "host_cores": os.cpu_count(),
        }
    return dict(env)


def describe(env: Optional[Dict[str, Any]]) -> str:
    """One operator-readable line ("backend=gpu device=NVIDIA H100 80GB
    HBM3 x1 torch=2.5.1")."""
    if not env:
        return "backend=?"
    return (f"backend={env.get('backend')} "
            f"device={env.get('device_kind')} "
            f"x{env.get('device_count')} "
            f"torch={env.get('torch_version')}")


def environments_differ(a: Optional[Dict[str, Any]],
                        b: Optional[Dict[str, Any]]) -> bool:
    """True when two provenance blocks name different hardware (backend
    or device kind) — the condition under which absolute times are NOT
    comparable. Missing blocks never differ: no evidence, no warning."""
    if not a or not b:
        return False
    return (a.get("backend") != b.get("backend")
            or a.get("device_kind") != b.get("device_kind"))
