"""Shared helpers of the port: ``locks`` (the declared lock order) and
``bucketing`` (capacity buckets)."""
from .bucketing import round_up_pow2, bucket_rows  # noqa: F401
