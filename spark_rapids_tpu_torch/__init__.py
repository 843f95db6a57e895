"""PyTorch/CUDA port of the columnar Spark-SQL engine.

The JAX package ``spark_rapids_tpu`` is the reference this package is
held against; the port keeps its layout (``types``, ``conf``,
``columnar/``, ``expr/``, ``ops/``, ``exec/``, ``udf/``, ``cpu/``,
``plugin/``, ``sql/``, ``io/``), its class names, conf keys and
defaults, so one test can drive both. It imports ``torch``, numpy and
(lazily, for parquet) pyarrow, and never JAX or anything of the
reference package.

Device rule: entry points (batch construction/upload,
``InMemoryScanExec`` and ``sql.TpuSession`` with every scan it builds)
run on the CUDA card unless the caller passes ``device="cpu"``; with no
card, ``device=None`` raises instead of quietly running on the CPU.
Everything downstream follows the device of the tensors it is given.
The hand-written Hopper kernels live in ``csrc/`` (the aggregation's,
the join probe's and the word-count UDF's) and are built on first use
into ``_build/`` (see ``ops/_cuda_build.py``).
"""
