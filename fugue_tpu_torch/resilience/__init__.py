"""Resilience layer: retry/backoff policy, deadlines, failure taxonomy,
fault injection, and structured recovery counters. The port's copy of
``fugue_tpu/resilience``; of its fault sites the port fires
``task.execute``, ``checkpoint.save`` and ``stream.chunk`` (the others
belong to modules not ported yet, ROADMAP.md A.10, and parse all the
same).

Graceful-degradation order everywhere in the codebase:
**parallel → retry → serial → raise** (see ``docs/resilience.md``).
"""

from .counters import ResilienceStats
from .fault import (
    NULL_INJECTOR,
    SITE_CHECKPOINT_SAVE,
    SITE_DIST_BOARD,
    SITE_DIST_HEARTBEAT,
    SITE_DIST_LEASE,
    SITE_MAP_CHUNK,
    SITE_MAP_DISPATCH,
    SITE_RPC_REQUEST,
    SITE_SERVE_CLAIM,
    SITE_SERVE_JOURNAL,
    SITE_SHUFFLE_SPILL,
    SITE_STREAM_CHUNK,
    SITE_TASK_EXECUTE,
    SITE_VIEW_REGISTER,
    FaultInjector,
)
from .policy import (
    ChunkTimeoutError,
    Deadline,
    FailureCategory,
    InjectedFaultError,
    ParallelMapError,
    RetryPolicy,
    WorkerLostError,
    classify_failure,
)

__all__ = [
    "ResilienceStats",
    "FaultInjector",
    "NULL_INJECTOR",
    "SITE_MAP_DISPATCH",
    "SITE_MAP_CHUNK",
    "SITE_TASK_EXECUTE",
    "SITE_RPC_REQUEST",
    "SITE_CHECKPOINT_SAVE",
    "SITE_SERVE_JOURNAL",
    "SITE_SERVE_CLAIM",
    "SITE_SHUFFLE_SPILL",
    "SITE_STREAM_CHUNK",
    "SITE_DIST_LEASE",
    "SITE_DIST_HEARTBEAT",
    "SITE_DIST_BOARD",
    "SITE_VIEW_REGISTER",
    "RetryPolicy",
    "Deadline",
    "FailureCategory",
    "classify_failure",
    "WorkerLostError",
    "ChunkTimeoutError",
    "InjectedFaultError",
    "ParallelMapError",
]
