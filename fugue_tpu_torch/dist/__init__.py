"""The parts of ``fugue_tpu/dist`` that the standing views stand on:
the heartbeat protocol (``heartbeat.py``) and the per-view watch leases
(``lease.py``), both files in a shared directory. The worker tier, the
task board and the supervisor are not ported (ROADMAP.md A.13).
"""

from .heartbeat import (
    DEFAULT_INTERVAL_S,
    DEFAULT_STALE_AFTER_S,
    HeartbeatWriter,
    heartbeat_age_s,
    holder_alive,
    read_heartbeat,
)
from .lease import LeaseBoard

__all__ = [
    "DEFAULT_INTERVAL_S",
    "DEFAULT_STALE_AFTER_S",
    "HeartbeatWriter",
    "LeaseBoard",
    "heartbeat_age_s",
    "holder_alive",
    "read_heartbeat",
]
