"""Automatic resource management idiom.

Counterpart of ``spark_rapids_tpu/utils/arm.py``, the Python analog of
the reference plugin's Arm trait (sql-plugin/.../Arm.scala:
withResource/closeOnExcept/safeClose). Torch tensors are freed by
reference counting, but spillable buffers, file handles and shuffle
transactions still follow the acquire/close protocol, so the idiom
carries over for those.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, TypeVar

T = TypeVar("T")


@contextlib.contextmanager
def with_resource(resource):
    """`withResource(r) { ... }`: close on scope exit, success or failure."""
    try:
        yield resource
    finally:
        _close(resource)


@contextlib.contextmanager
def close_on_except(resource):
    """`closeOnExcept(r) { ... }`: close only if the body raises."""
    try:
        yield resource
    except BaseException:
        _close(resource)
        raise


def safe_close(resources: Iterable) -> None:
    """Close every resource, raising the first error after closing all."""
    first_err = None
    for r in resources:
        try:
            _close(r)
        except Exception as e:  # noqa: BLE001
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


def _close(resource) -> None:
    if resource is None:
        return
    close = getattr(resource, "close", None)
    if close is not None:
        close()
