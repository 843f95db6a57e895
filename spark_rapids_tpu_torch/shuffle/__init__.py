"""Shuffle layer: partitionings, the wire format and the transports.

Counterpart of ``spark_rapids_tpu/shuffle/`` (``__init__``, ``partition``,
``serializer``, ``transport``): partitioning is one stable device sort by
partition id (``partition.partition_cols``), pieces stay on the device in
the in-process transport or round-trip through the host wire format in
the serializing one. The exchange execs that drive them are
``exec/exchange.py``. The reference's network transport
(``shuffle/network.py``) is ROADMAP.md, queue A item 'Multi-device
execution'.
"""
from .partition import (
    HashPartitioning,
    Partitioning,
    RangePartitioning,
    RoundRobinPartitioning,
    SinglePartitioning,
)

__all__ = [
    "Partitioning",
    "HashPartitioning",
    "RangePartitioning",
    "RoundRobinPartitioning",
    "SinglePartitioning",
]
