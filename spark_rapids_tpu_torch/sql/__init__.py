"""The DataFrame session of the port (reference: ``spark_rapids_tpu/sql``)."""
from .session import DataFrame, TpuSession  # noqa: F401
