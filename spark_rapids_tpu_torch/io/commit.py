"""The single-file commit protocol of the writers.

Own copy of ``spark_rapids_tpu/io/commit.py`` (reference analog:
GpuFileFormatWriter.scala:339's commit semantics): write to a temporary
name, rename it into place on success, and always remove the temporary
file. The parquet, ORC and CSV writers share it.
"""
from __future__ import annotations

import contextlib
import os
from typing import Tuple


@contextlib.contextmanager
def committed_file(path: str):
    """Yield a temp path; ``os.replace`` it onto ``path`` iff the body
    succeeds, unlink it otherwise. After the commit the session drops its
    cached scanners of ``path`` (their splits and schema describe the old
    file) and the device scan cache its entries of ``path``: the
    (mtime, size) key already keeps a read of the new file from hitting
    them, and this frees their device memory at once."""
    tmp = path + "._temporary"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        yield tmp
        os.replace(tmp, path)  # commit
        from ..sql.session import invalidate_scanners
        from .scan_cache import DeviceScanCache

        invalidate_scanners(path)
        with DeviceScanCache._instance_lock:
            inst = DeviceScanCache._instance
        if inst is not None:
            inst.invalidate_path(path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def write_batches(batches, path: str, schema, open_writer,
                  write) -> Tuple[int, int]:
    """The writers' shared loop under :func:`committed_file`: each batch
    goes to the host as an Arrow table and through ``write(writer,
    table)``, the writer opened by ``open_writer(tmp, arrow_schema)`` on
    the first batch; an empty result writes one empty table of
    ``schema``, so the file still carries it. The writer is closed before
    the commit, or before the temp file goes on a failure. Returns
    (rows, batches written)."""
    from ..columnar.batch import ColumnarBatch
    from .arrow_convert import batch_to_arrow

    rows = nbatches = 0
    with committed_file(path) as tmp:
        writer = None
        try:
            for b in batches:
                t = batch_to_arrow(b)
                if writer is None:
                    writer = open_writer(tmp, t.schema)
                write(writer, t)
                rows += t.num_rows
                nbatches += 1
            if writer is None:
                t = batch_to_arrow(ColumnarBatch.from_pydict(
                    {f.name: [] for f in schema.fields}, schema,
                    device="cpu"))
                writer = open_writer(tmp, t.schema)
                write(writer, t)
        finally:
            if writer is not None:
                writer.close()
    return rows, nbatches
