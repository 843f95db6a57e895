"""Steady the parallel test run: each test process drops its compiled
XLA programs before they exhaust its memory maps, and under xdist torch's
CPU ops run on one thread in each worker.

XLA:CPU maps every compiled program's code as three memory regions
(r-x, r--, rw-), and JAX and the reference's pipeline caches keep the
programs alive. A long-lived xdist worker of this suite gathers some
21 000 programs, 63 000 maps, against the kernel's limit of 65 530 a
process (``vm.max_map_count``): the next map fails and XLA segfaults, in
a compile, a persistent-cache write or a cache read, late in the run,
in whatever test the worker runs then. One dead worker hangs the run:
pytest-xdist's ``--dist loadfile`` scheduler never gives the crashed
file's remaining tests to the replacement worker. So this module is
also a plugin (``pytest_plugins`` below): at each file boundary, past
:data:`MAP_HIGH_WATER` maps, it clears JAX's caches and the reference's
pipeline caches (36 428 maps fell to 775 in one measurement), and the
next compiles find the persistent cache ``tests/conftest.py`` keeps.

Under xdist it also gives torch's CPU ops one thread: six workers with a
pool of one thread per core each oversubscribe the box, and an op past
torch's grain size then waits on descheduled threads (the port's mesh
tests ran 3x slower that way on a loaded box).

The body runs at collection, in every process that collects the suite,
before any test runs.
"""
import gc
import os

import torch

pytest_plugins = [__name__]

#: memory maps past which a test process drops its compiled programs at
#: the next file boundary (the limit is 65 530; one file adds well under
#: 20 000)
MAP_HIGH_WATER = 35_000

IN_XDIST_WORKER = "PYTEST_XDIST_WORKER" in os.environ
if IN_XDIST_WORKER:
    torch.set_num_threads(1)


def map_count() -> int:
    with open("/proc/self/maps", "rb") as f:
        return f.read().count(b"\n")


def release_compiled_programs() -> None:
    import jax
    from spark_rapids_tpu.exec.base import clear_pipeline_caches

    clear_pipeline_caches()
    jax.clear_caches()
    gc.collect()


def pytest_runtest_teardown(item, nextitem):
    if nextitem is not None and nextitem.path == item.path:
        return
    if map_count() > MAP_HIGH_WATER:
        release_compiled_programs()


def test_this_module_is_a_plugin(request):
    assert request.config.pluginmanager.has_plugin(__name__)


def test_released_programs_free_their_maps():
    import jax
    import jax.numpy as jnp

    before = map_count()
    fns = [jax.jit(lambda x, k=k: x * k + k) for k in range(60)]
    for f in fns:
        f(jnp.arange(4)).block_until_ready()
    grown = map_count() - before
    assert grown >= 60  # a few maps a program
    del fns
    release_compiled_programs()
    assert map_count() - before < grown / 2


def test_one_torch_thread_in_an_xdist_worker():
    assert not IN_XDIST_WORKER or torch.get_num_threads() == 1
