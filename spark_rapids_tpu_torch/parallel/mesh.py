"""The device mesh of the mesh stages: an ordered tuple of shard devices.

Counterpart of ``spark_rapids_tpu/parallel/mesh.py``. The reference's
mesh is one SPMD program over its local devices, collectives riding the
interconnect; its faithful counterpart here is a single-process mesh over
a list of torch devices: shard ``s`` is a device, a mesh stage runs its
per-shard work as an eager loop over the shards, and the collectives
copy tensors between the shards' devices (``collective.py``). No
``torch.distributed`` process group is involved (NCCL would refuse two
ranks on one card anyway). The reference's ``shard_map`` version shim has
no counterpart: nothing here is traced.

Virtual devices. The reference's CPU tests get 8 devices from XLA's
``--xla_force_host_platform_device_count``. The port's counterpart is the
environment variable ``SRTPU_TORCH_VIRTUAL_DEVICES=n``, read at call
time: it lays ``n`` logical devices round robin over the real ones, so
shard ``s`` lives on ``cuda:(s % k)`` on a machine with ``k`` cards (all
on ``cuda:0`` on a one-card machine) and on ``cpu`` for a CPU plan.
Unset, a CUDA plan sees ``torch.cuda.device_count()`` devices and a CPU
plan one.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

#: the environment variable of the virtual device count
VIRTUAL_DEVICES_ENV = "SRTPU_TORCH_VIRTUAL_DEVICES"

AXIS = "shards"

_MESH_CACHE: dict = {}


class Mesh:
    """A 1-D mesh: shard ``s`` runs on ``devices[s]``."""

    __slots__ = ("devices",)

    def __init__(self, devices: Tuple[torch.device, ...]):
        self.devices = tuple(devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({', '.join(str(d) for d in self.devices)})"


def _is_cpu(device) -> bool:
    if device is None:
        return not torch.cuda.is_available()
    return torch.device(device).type == "cpu"


def _real_devices(device=None) -> Tuple[torch.device, ...]:
    """The real devices a plan on ``device`` can spread over: every CUDA
    card for a CUDA plan (``None``: the card), the one CPU for a CPU
    plan."""
    if _is_cpu(device):
        return (torch.device("cpu"),)
    return tuple(torch.device("cuda", i)
                 for i in range(max(1, torch.cuda.device_count())))


def virtual_device_count() -> int:
    """``SRTPU_TORCH_VIRTUAL_DEVICES``, or 0 when unset."""
    raw = os.environ.get(VIRTUAL_DEVICES_ENV, "").strip()
    if not raw:
        return 0
    n = int(raw)
    if n < 1:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV}={raw}: must be >= 1")
    return n


def local_devices(device=None) -> Tuple[torch.device, ...]:
    """The visible (logical) devices of a plan on ``device``: the
    virtual ones round robin over the real ones, else the real ones."""
    real = _real_devices(device)
    n = virtual_device_count()
    if not n:
        return real
    return tuple(real[s % len(real)] for s in range(n))


def device_count(device=None) -> int:
    return len(local_devices(device))


def configured_mesh_devices(conf) -> int:
    """The shard count the conf asks for: ``mesh.devices`` caps/forces the
    global mesh width, ``shuffle.meshSize`` (the legacy per-exchange knob)
    still applies when mesh.devices is unset. 0 = all local devices."""
    from ..conf import MESH_DEVICES, SHUFFLE_MESH_SIZE

    n = conf.get(MESH_DEVICES)
    if n == 0:
        n = conf.get(SHUFFLE_MESH_SIZE)
    return n


def get_mesh(n: Optional[int] = None, conf=None, device=None) -> Mesh:
    """A 1-D mesh over the first ``n`` local devices of a plan on
    ``device``.

    ``n`` = None/0 consults ``conf`` (``spark.rapids.tpu.mesh.devices``,
    falling back to ``shuffle.meshSize``); still unset means all local
    devices. A request exceeding the visible device count is a conf error
    named after the key, not a silent truncation. Meshes are memoized per
    device tuple so every stage at the same width shares one Mesh."""
    devs = local_devices(device)
    if not n and conf is not None:
        n = configured_mesh_devices(conf)
    n = n or len(devs)
    if n > len(devs):
        raise ValueError(
            f"spark.rapids.tpu.mesh.devices={n} but only {len(devs)} "
            f"device(s) are visible (set {VIRTUAL_DEVICES_ENV}={n} for a "
            "mesh of virtual devices laid over the real ones)")
    if n < 1:
        raise ValueError(f"mesh of {n} devices makes no sense")
    key = devs[:n]
    m = _MESH_CACHE.get(key)
    if m is None:
        m = _MESH_CACHE[key] = Mesh(key)
    return m


def shard_spec() -> str:
    """Rows split over the shard axis: the one layout of the port's
    mesh, named as the reference's partition spec."""
    return AXIS


def row_sharding(mesh: Mesh) -> Tuple[torch.device, ...]:
    """Where each shard's rows live: row block ``s`` on
    ``mesh.devices[s]`` (the reference's ``NamedSharding`` over the
    shard axis)."""
    return mesh.devices
