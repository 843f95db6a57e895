"""Device memory runtime: the spill catalog, spillable handles, the
ledger, the concurrency semaphore and OOM retry.

Counterpart of ``spark_rapids_tpu/memory/`` (reference analog: the
RapidsBufferCatalog / SpillableColumnarBatch / GpuSemaphore subsystem
and RmmRapidsRetryIterator). The CUDA caching allocator owns the
device's memory; this layer accounts for the buffers it may spill and
recovers from ``torch.cuda.OutOfMemoryError`` at each exec's per-batch
dispatch.
"""
from .catalog import (
    ACTIVE_BATCHING_PRIORITY,
    BufferCatalog,
    HOST_MEMORY_BUFFER_SPILL_PRIORITY,
    INPUT_FROM_SHUFFLE_PRIORITY,
    SpillableHandle,
    TIER_DEVICE,
    TIER_DISK,
    TIER_HOST,
)
from .ledger import Ledger, current_query, force_arm, query_scope
from .retry import (
    TpuOOMError,
    TpuOutOfDeviceMemory,
    TpuRetryOOM,
    TpuSplitAndRetryOOM,
    classify_oom,
    is_device_oom,
    named_oom,
    with_oom_retry,
    with_oom_retry_nosplit,
)
from .semaphore import TpuSemaphore, TpuSemaphoreTimeout
from .spillable import SpillableColumnarBatch, SpillableVals

__all__ = [
    "ACTIVE_BATCHING_PRIORITY",
    "BufferCatalog",
    "HOST_MEMORY_BUFFER_SPILL_PRIORITY",
    "INPUT_FROM_SHUFFLE_PRIORITY",
    "Ledger",
    "SpillableHandle",
    "SpillableColumnarBatch",
    "SpillableVals",
    "TIER_DEVICE",
    "TIER_DISK",
    "TIER_HOST",
    "TpuOOMError",
    "TpuOutOfDeviceMemory",
    "TpuRetryOOM",
    "TpuSemaphore",
    "TpuSemaphoreTimeout",
    "TpuSplitAndRetryOOM",
    "classify_oom",
    "current_query",
    "force_arm",
    "is_device_oom",
    "named_oom",
    "query_scope",
    "with_oom_retry",
    "with_oom_retry_nosplit",
]
