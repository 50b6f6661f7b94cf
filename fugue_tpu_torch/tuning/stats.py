"""Tuning counters and decision log, copied from
``fugue_tpu/tuning/stats.py`` — an ``engine.metrics`` source
(``engine.stats()["tuning"]``, flattened onto ``/metrics``).

Counters zero on ``reset``; the LEARNED settings (which live in the
:class:`~fugue_tpu_torch.tuning.store.TunedStore`, not here) are kept — a
stats reset must never turn into a perf event by forgetting what the
engine already converged to. Every shared-attribute write happens under
``self._lock``.
"""

import threading
from collections import deque
from typing import Any, Dict, List

__all__ = ["TuningStats", "MAX_DECISIONS"]

# decisions kept for rendering (stats/report); enough for one large plan
MAX_DECISIONS = 64

_COUNTERS = (
    "decisions",  # every knob resolution (adaptive + static)
    "adaptive",  # resolutions served from learned observations
    "static",  # resolutions that fell back to the static rule
    "observations",  # telemetry records absorbed (streams/joins/shuffles)
    "publishes",  # store writes (temp-write+rename publishes)
    "loads",  # store file (re)loads
    "load_failures",  # corrupt/unreadable store files degraded to defaults
    "evictions",  # stale plan fingerprints dropped at publish time
    "converged",  # settings marked converged this process
)


class TuningStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {}
        self._decisions: "deque" = deque(maxlen=MAX_DECISIONS)

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + int(n)

    def decision(self, d: Dict[str, Any]) -> None:
        """Record one knob resolution: ``{"target", "key", "value",
        "source", "evidence", "confidence"}`` — the same record
        ``workflow.explain()`` renders."""
        with self._lock:
            self._c["decisions"] = self._c.get("decisions", 0) + 1
            src = "adaptive" if d.get("source") == "adaptive" else "static"
            self._c[src] = self._c.get(src, 0) + 1
            self._decisions.append(dict(d))

    def last_decisions(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(d) for d in self._decisions]

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {k: self._c.get(k, 0) for k in _COUNTERS}
            out["last_decisions"] = [dict(d) for d in self._decisions]
            return out

    def reset(self) -> None:
        with self._lock:
            self._c = {}
            self._decisions.clear()
