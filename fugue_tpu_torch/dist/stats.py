"""Worker-tier counters — a ``MetricsRegistry`` source, copied from
``fugue_tpu/dist/stats.py``.

One :class:`DistStats` lives on the supervisor's engine (registered as
``engine.stats()["dist"]``) and one inside each worker. Workers ship
their snapshot home inside every heartbeat (``stats`` key) and every done
record, so the supervisor's ``as_dict()`` can fold a ``workers``
breakdown in without any extra channel — the same ship-home shape fork
workers use for span/histogram deltas. ``reset()`` zeroes counters and
keeps the worker breakdown's identities (the JitCache contract).
"""

import threading
from typing import Any, Dict

__all__ = ["DistStats"]

_COUNTERS = (
    "jobs",
    "jobs_failed",
    "map_tasks",
    "reduce_tasks",
    "tasks_completed",
    "tasks_failed",
    "leases_acquired",
    "leases_renewed",
    "leases_stolen",
    "redispatch_worker_lost",
    "redispatch_transient",
    "speculative_marks",
    "speculative_wins",
    "speculative_losses",
    "fragments_written",
    "fragments_local",
    "fragments_remote",
    "fetch_failures",
    "orphaned_outputs_recovered",
    "artifacts_published",
    "rows_in",
    "rows_out",
    # distributed WORKFLOW jobs (run_workflow_job): one fragment of a
    # workflow DAG routed through the board. Dispatch/steal/speculative/
    # invalidation activity observed while a workflow job is in flight is
    # attributed to that job (before/after deltas — approximate only if
    # unrelated jobs run concurrently on the same supervisor).
    "workflow_jobs",
    "workflow_tasks_dispatched",
    "workflow_tasks_re_dispatched",
    "workflow_tasks_stolen",
    "workflow_tasks_speculative",
    "workflow_fragments_invalidated",
    "workflow_partitions_delta_skipped",
)


class DistStats:
    """Thread-safe counters + a per-worker snapshot breakdown."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c: Dict[str, float] = {}
        self._workers: Dict[str, Dict[str, Any]] = {}

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n

    def get(self, name: str) -> float:
        with self._lock:
            return self._c.get(name, 0)

    def note_worker(self, worker_id: str, snapshot: Dict[str, Any]) -> None:
        """Fold one shipped-home counter snapshot for one worker. The
        worker's counters are MONOTONIC lifetime totals, so snapshots
        from different channels (heartbeats, done records) merge by
        element-wise max — a lagging beat can never roll a fresher
        done-record snapshot back."""
        snap = {k: v for k, v in snapshot.items() if k != "workers"}
        with self._lock:
            cur = self._workers.setdefault(worker_id, {})
            for k, v in snap.items():
                if isinstance(v, (int, float)) and isinstance(
                    cur.get(k), (int, float)
                ):
                    cur[k] = max(cur[k], v)
                else:
                    cur[k] = v

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {k: self._c.get(k, 0) for k in _COUNTERS}
            for k, v in self._c.items():
                if k not in out:
                    out[k] = v
            if self._workers:
                out["workers"] = {w: dict(s) for w, s in self._workers.items()}
        # re-dispatch classification is decided at the steal site (the
        # worker's LeaseBoard, where the liveness evidence is) and shipped
        # home; the supervisor-facing totals fold the worker breakdown in
        for w in out.get("workers", {}).values():
            out["redispatch_worker_lost"] += w.get("leases_stolen_dead", 0)
            out["redispatch_transient"] += w.get("leases_stolen_expired", 0)
        return out

    def reset(self) -> None:
        with self._lock:
            self._c = {}
