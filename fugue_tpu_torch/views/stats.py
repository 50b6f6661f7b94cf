"""Continuous-view counters — the ``views`` stats group.

Counter-exact parity with the flight recorder:
``registered`` == ``view.register`` events, ``lease_steals`` ==
``view.lease.steal``, ``refreshes`` == ``view.refresh``,
``generations_published`` == ``view.publish``, ``slo_breaches`` ==
``view.slo_breach``, ``unregistered`` == ``view.unregister`` — the
parity test holds each pair equal so a timeline reconstructed from the
event log alone tells the same story the counters do.

``steady_*`` counters exclude each view's cold first generation (which
is full by definition) so the steady-state delta ``skip_fraction`` —
``1 - steady_partitions_fresh / steady_partitions_total`` — measures
what the chaos gate actually asserts (≥ 0.9).
"""

import threading
from typing import Dict

__all__ = ["ViewStats"]

_COUNTERS = (
    "registered",
    "unregistered",
    "refreshes",
    "refresh_failures",
    "generations_published",
    "partitions_fresh",
    "partitions_total",
    "steady_partitions_fresh",
    "steady_partitions_total",
    "full_recomputes",
    "delta_refusals",
    "lease_acquires",
    "lease_steals",
    "lease_losses",
    "slo_boosts",
    "slo_breaches",
    "loop_ticks",
    "watch_errors",
    "superseded_evicted",
)


class ViewStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {k: 0 for k in _COUNTERS}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0
