"""File I/O of the port: the parquet scan (reference ``spark_rapids_tpu/io``)."""
