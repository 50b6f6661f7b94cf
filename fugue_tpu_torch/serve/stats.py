"""Serving-layer counters: one thread-safe registry source with a global
section and a per-tenant breakdown.

Follows the repo-wide stats contracts: ``inc``/``as_dict`` under one
narrow lock (``CacheStats`` style), and ``reset()`` zeroes counters
without tearing down structure (the ``JitCache.reset`` keep-entries
rule — gauges like queue depth are re-read live, never stored).

The per-tenant breakdown is BOUNDED: tenant ids are client-supplied, so
the map keeps at most ``max_tenants`` (``fugue.tpu.serve.max_tenants``)
entries with least-recently-incremented eviction — the same LRU
discipline as the retention ring. A hostile client minting tenant ids
rotates the breakdown; it cannot leak memory in a long-lived server.
"""

import threading
from collections import OrderedDict
from typing import Dict

__all__ = ["ServeStats"]

_COUNTERS = (
    "submitted",            # every submit() call that reached admission
    "admitted",             # enqueued as a new execution
    "dedup_hits",           # joined an identical in-flight execution
    "idempotent_replays",   # same idempotency key re-submitted
    "rejected_queue_full",
    "rejected_budget",
    "executions",           # executions actually started on a worker
    "completed",
    "failed",
    "canceled",             # submissions canceled by their owner
    "canceled_executions",  # queued executions whose last waiter canceled
    "retained_evictions",   # completed submissions dropped past serve.retain
    "tenant_evictions",     # per-tenant state rotated past serve.max_tenants
    # crash-safe journal (serve/journal.py)
    "journal_appends",      # WAL records fsync'd (admit + exec + done)
    "journal_replays",      # unfinished admissions resubmitted on restart
    # fleet coordination (serve/fleet.py, docs/serving.md "Fleet")
    "fleet_claims",         # cross-replica claims this replica won
    "fleet_claim_steals",   # claims taken from a dead/expired owner
    "fleet_result_hits",    # submissions served from another replica's artifact
    "fleet_publishes",      # results this replica published to the store
    "fleet_waits",          # poll iterations spent waiting on another owner
)

_TENANT_COUNTERS = (
    "submitted",
    "completed",
    "failed",
    "rejected",
    "dedup_hits",
    "rows_out",
    "queue_wait_s",
    "run_s",
)


class ServeStats:
    """Thread-safe serving counters (a ``MetricsRegistry`` source)."""

    def __init__(self, max_tenants: int = 256) -> None:
        self._lock = threading.Lock()
        self._max_tenants = max(1, int(max_tenants))
        self.reset()

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n

    def inc_tenant(self, tenant: str, name: str, n: float = 1) -> None:
        with self._lock:
            t = self._t.setdefault(str(tenant), {})
            t[name] = t.get(name, 0) + n
            self._t.move_to_end(str(tenant))
            while len(self._t) > self._max_tenants:
                self._t.popitem(last=False)
                self._c["tenant_evictions"] = self._c.get("tenant_evictions", 0) + 1

    def get(self, name: str) -> float:
        with self._lock:
            return self._c.get(name, 0)

    def as_dict(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {k: self._c.get(k, 0) for k in _COUNTERS}
            out["tenants"] = {
                tid: {
                    k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in sorted(t.items())
                }
                for tid, t in sorted(self._t.items())
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._c: Dict[str, float] = {}
            self._t: "OrderedDict[str, Dict[str, float]]" = OrderedDict()
