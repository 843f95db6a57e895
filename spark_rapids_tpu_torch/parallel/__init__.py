"""Mesh execution over a list of torch devices.

Counterpart of ``spark_rapids_tpu/parallel/``: partitions map to mesh
shards, the exchange is an all-to-all of per-target blocks between the
shards' devices (``collective.py``), and the distributed operators
(group-by, sort, join: ``distributed.py``) compose the single-device ops
with that exchange. The reference traces each of them into one SPMD
program; here each is an eager loop over the shards
(``mesh.py`` says why).
"""
from .collective import all_to_all_exchange, gather_all
from .distributed import dist_groupby, dist_hash_join, dist_sort

__all__ = [
    "all_to_all_exchange",
    "gather_all",
    "dist_groupby",
    "dist_sort",
    "dist_hash_join",
]
