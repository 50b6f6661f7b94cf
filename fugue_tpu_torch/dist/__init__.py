"""The fault-tolerant worker tier, copied from ``fugue_tpu/dist``.

N host engine processes (:class:`DistWorker`) coordinate over a shared
task board and the HTTP layer; a :class:`DistSupervisor` plans
distributed load → shuffle → reduce jobs, watches leases and heartbeats,
and recovers dead workers by re-dispatch. ``fugue.tpu.dist.enabled=false``
restores single-process execution bit-identically. The workflow pass that
routes a DAG's fragments through it is ``plan/distribute.py``; the
standing views use the heartbeat and lease modules on their own.
"""

from .board import TaskBoard, dump_fn, load_fn, spec_fingerprint
from .heartbeat import (
    DEFAULT_INTERVAL_S,
    DEFAULT_STALE_AFTER_S,
    HeartbeatWriter,
    heartbeat_age_s,
    holder_alive,
    read_heartbeat,
)
from .lease import LeaseBoard
from .stats import DistStats
from .supervisor import DistJobError, DistSupervisor
from .worker import BucketUnavailableError, DistWorker

__all__ = [
    "BucketUnavailableError",
    "DEFAULT_INTERVAL_S",
    "DEFAULT_STALE_AFTER_S",
    "DistJobError",
    "DistStats",
    "DistSupervisor",
    "DistWorker",
    "HeartbeatWriter",
    "LeaseBoard",
    "TaskBoard",
    "dump_fn",
    "heartbeat_age_s",
    "holder_alive",
    "load_fn",
    "read_heartbeat",
    "spec_fingerprint",
]
