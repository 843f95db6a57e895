"""File I/O of the port (reference ``spark_rapids_tpu/io``): the parquet,
CSV and ORC scans, their writers under one commit protocol, the device
scan cache and the mesh staging."""
