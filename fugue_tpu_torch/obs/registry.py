"""MetricsRegistry — one surface over every stats object an engine owns.

The engine's stats objects (``engine.pipeline_stats``,
``engine.plan_stats``, ``engine.resilience_stats``, ...) sit behind one
contract:

- every source exposes ``as_dict()`` and ``reset()``;
- ``engine.stats()`` → ``registry.as_dict()`` (all sources, one dict);
- ``engine.reset_stats()`` → ``registry.reset()`` (every source, one
  consistent reset);
- per-run deltas: ``before = registry.snapshot()`` … run …
  ``registry.delta(before)`` — one run's values instead of cumulative
  ones.

Sources register lazily (name → object or zero-arg provider) so engines
can register ``lambda: self.resilience_stats`` without forcing creation.
"""

import copy
import threading
from typing import Any, Callable, Dict, List, Union

__all__ = ["MetricsRegistry"]


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sources: Dict[str, Union[Any, Callable[[], Any]]] = {}

    def register(self, name: str, source: Any) -> None:
        """Register a stats source: any object with ``as_dict()`` and
        ``reset()``, or a zero-arg callable returning one (resolved at
        every read, so lazily-created sources work)."""
        with self._lock:
            self._sources[name] = source

    def family(self, name: str, bounds: Any = None, help: str = "") -> Any:
        """Create-or-get a labeled :class:`~fugue_tpu_torch.obs.metrics.HistogramFamily`
        owned by this registry (registered as a source under ``name``, so
        it shows in ``as_dict()``/``stats()`` and resets with
        ``reset()``). The distribution-metric counterpart of
        ``register()`` for plain counters."""
        with self._lock:
            src = self._sources.get(name)
            if src is None:
                from .metrics import DEFAULT_LATENCY_BOUNDS, HistogramFamily

                src = HistogramFamily(
                    name,
                    bounds if bounds is not None else DEFAULT_LATENCY_BOUNDS,
                    help=help,
                )
                self._sources[name] = src
            return src

    def names(self) -> List[str]:
        with self._lock:
            return list(self._sources)

    def get(self, name: str) -> Any:
        with self._lock:
            src = self._sources[name]
        return src() if callable(src) else src

    def as_dict(self) -> Dict[str, Dict[str, Any]]:
        return {name: self.get(name).as_dict() for name in self.names()}

    def reset(self) -> None:
        for name in self.names():
            self.get(name).reset()

    # -- per-run snapshots ---------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Deep copy of the current values — take one before a run."""
        return copy.deepcopy(self.as_dict())

    def delta(self, before: Dict[str, Any]) -> Dict[str, Any]:
        """Numeric difference current − ``before`` (recursive over nested
        dicts; non-numeric leaves report their current value)."""
        return _delta(self.as_dict(), before)


def _delta(cur: Any, before: Any) -> Any:
    if isinstance(cur, dict):
        b = before if isinstance(before, dict) else {}
        return {k: _delta(v, b.get(k)) for k, v in cur.items()}
    if isinstance(cur, bool) or not isinstance(cur, (int, float)):
        return cur
    if isinstance(before, (int, float)) and not isinstance(before, bool):
        d = cur - before
        return round(d, 6) if isinstance(d, float) else d
    return cur
