"""Structured resilience counters — retries and fallbacks are never silent.

Every recovery action in the resilience layer increments a named counter
on the owning engine's ``resilience_stats`` so operators can distinguish
"healthy" from "healthy because it retried 400 times". Counter names are
dotted, grouped by layer:

- ``map.chunks_ok``            chunks that completed in the fork pool
- ``map.chunk_retries``        chunks re-dispatched after a retryable failure
- ``map.worker_lost``          pool workers observed dead (OOM/SIGKILL/segfault)
- ``map.deadline_expiries``    chunks that blew their per-chunk deadline
- ``map.quarantined_chunks``   chunks demoted to serial in-driver execution
- ``map.quarantined_partitions`` partitions inside quarantined chunks
- ``map.serial_fallbacks``     quarantined chunks that then succeeded serially
- ``map.pool_rebuilds``        fresh pools forked after a wave was lost
- ``map.worker_chunks``        chunk bodies completed INSIDE fork workers
  (shipped home as counter deltas with each chunk result)
- ``map.worker_partitions``    partitions executed inside fork workers
- ``map.worker_rows_out``      rows produced inside fork workers
- ``workflow.task_retries``    task bodies re-run under the task retry policy
- ``workflow.checkpoint_replays`` tasks served from a StrongCheckpoint
  instead of recomputing
- ``rpc.retries``              HTTP RPC requests re-sent after backoff
"""

import threading
from typing import Dict

__all__ = ["ResilienceStats"]


class ResilienceStats:
    """Thread-safe monotonic counters (fork children mutate their own copy;
    only driver-side increments are observable, which is where every
    recovery decision is made)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def merge(self, delta: Dict[str, int]) -> None:
        """Fold a counter delta (e.g. one shipped home from a forked map
        worker with its chunk result) into this registry."""
        with self._lock:
            for name, n in delta.items():
                self._counters[name] = self._counters.get(name, 0) + int(n)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()

    def __repr__(self) -> str:
        return f"ResilienceStats({self.as_dict()})"
