"""Concurrent multi-query serving (counterpart of
``spark_rapids_tpu/serve/``).

``scheduler.QueryScheduler`` — forecast-based admission control (the
static peak forecast vs the live catalog watermark/budget), a fair
per-session queue layered over the TpuSemaphore, and pipelined session
execution (admitted queries host-prefetch scans before taking the device
semaphore). ``plan_cache.SharedPlanCache`` — one static analysis per
plan digest across all sessions. Sessions route through here when
``spark.rapids.tpu.serve.enabled`` is set (``sql/session.py``).
``program_cache`` is the persistent kernel-library cache, the port's
counterpart of the reference's AOT program store.
"""
from .plan_cache import SharedPlanCache, conf_fingerprint
from .scheduler import (
    SERVE_ADMISSION_ENABLED,
    SERVE_ENABLED,
    SERVE_MAX_QUEUE_DEPTH,
    SERVE_PRIORITY,
    SERVE_QUEUE_TIMEOUT_MS,
    QueryScheduler,
    ServeAdmissionRejected,
    ServeQueueTimeout,
    Ticket,
)

__all__ = [
    "QueryScheduler",
    "SERVE_ADMISSION_ENABLED",
    "SERVE_ENABLED",
    "SERVE_MAX_QUEUE_DEPTH",
    "SERVE_PRIORITY",
    "SERVE_QUEUE_TIMEOUT_MS",
    "ServeAdmissionRejected",
    "ServeQueueTimeout",
    "SharedPlanCache",
    "Ticket",
    "conf_fingerprint",
]
