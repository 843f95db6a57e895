"""Shuffle layer: partitionings, the wire format and the transports.

Counterpart of ``spark_rapids_tpu/shuffle/`` (``__init__``, ``partition``,
``serializer``, ``transport``): partitioning is one stable device sort by
partition id (``partition.partition_cols``), pieces stay on the device in
the in-process transport or round-trip through the host wire format in
the serializing ones, the host bytes (``transport.py``) or a TCP block
server and client between processes (``network.py``). The exchange execs
that drive them are ``exec/exchange.py``.
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
