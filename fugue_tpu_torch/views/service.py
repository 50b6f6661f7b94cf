"""ViewService: the one object the serving tier holds for the views.

Facade over the registry (durable specs + heads on the shared store),
the maintainer (the watch/refresh loop), and the counters — constructed
by :class:`~fugue_tpu_torch.serve.EngineServer` only when
``fugue.tpu.views.enabled`` is on AND a shared store is mounted, and
registered with the engine metrics registry as the ``views`` stats
group (``engine.stats()["views"]`` → ``fugue_tpu_views_*`` on
``/metrics``). Serving reads (:meth:`describe`, :meth:`result`) go
straight to the shared store, so ANY replica answers for every view
regardless of which one holds the watch lease.
"""

import time
from typing import Any, Dict, List, Optional

from ..constants import FUGUE_TPU_CONF_VIEWS_MAX
from ..serve.fleet import parse_view_result_name, view_result_key
from .maintainer import ViewMaintainer
from .registry import ViewRegistry, ViewSpec
from .stats import ViewStats

__all__ = ["ViewService"]


class ViewService:
    def __init__(self, server: Any):
        self._server = server
        self._fleet = server._fleet
        self.stats = ViewStats()
        c = server.engine.conf
        self.registry = ViewRegistry(
            self._fleet.store.root,
            journal=server._journal,
            stats=self.stats,
            injector=server._injector,
            log=server.engine.log,
            max_views=int(c.get(FUGUE_TPU_CONF_VIEWS_MAX, 64)),
        )
        self.maintainer = ViewMaintainer(server, self.registry, self.stats)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        # close the register crash window from this replica's WAL before
        # the first tick (a spec restored here is maintained like any)
        self.registry.replay()
        self.maintainer.start()

    def stop(self, timeout: float = 5.0) -> None:
        self.maintainer.stop(timeout)

    # -- registration API (what /serve/register etc. call) -------------------
    def register(
        self,
        view_id: str,
        factory: Any,
        source: str,
        fmt: str = "",
        tenant: str = "default",
    ) -> Dict[str, Any]:
        spec = self.registry.register(view_id, tenant, source, fmt, factory)
        return self.describe(spec.id) or spec.to_payload()

    def unregister(self, view_id: str) -> bool:
        spec = self.registry.get(view_id)
        if spec is None:
            return False
        gens = self._generations(view_id)
        ok = self.registry.unregister(view_id)
        # retire the view's published payloads; its lease is released by
        # the holder's next tick (spec gone), or expires
        for g in gens:
            self._fleet.remove_result(view_result_key(view_id, g))
        return ok

    def _generations(self, view_id: str) -> List[int]:
        import os

        out = []
        try:
            names = os.listdir(self._fleet.results_dir)
        except OSError:
            return out
        for n in names:
            parsed = parse_view_result_name(n)
            if parsed is not None and parsed[0] == view_id:
                out.append(parsed[1])
        return sorted(out)

    # -- serving reads -------------------------------------------------------
    def describe(self, view_id: str) -> Optional[Dict[str, Any]]:
        spec = self.registry.get(view_id)
        if spec is None:
            return None
        head = self.registry.head(view_id)
        out: Dict[str, Any] = {
            "id": spec.id,
            "tenant": spec.tenant,
            "source": spec.source,
            "format": spec.fmt,
            "created_ts": spec.created_ts,
            "generation": int(head["gen"]) if head else 0,
            "maintainer": self.maintainer.holder(view_id),
        }
        if head is not None:
            out["as_of"] = float(head.get("as_of", 0.0))
            out["staleness_s"] = round(
                max(0.0, time.time() - out["as_of"]), 6
            )
            out["mode"] = head.get("mode")
            out["partitions"] = len(head.get("tokens") or ())
        return out

    def list(self) -> List[Dict[str, Any]]:
        out = []
        for spec in self.registry.list():
            d = self.describe(spec.id)
            if d is not None:
                out.append(d)
        return out

    def result(self, view_id: str) -> Optional[Dict[str, Any]]:
        """The view's latest published generation, from the shared store:
        ``{view, generation, as_of, staleness_s, frames, schemas}`` with
        ``frames`` as ``{yield_name: pandas}``. None before the first
        publish (or for an unknown id — callers distinguish via
        :meth:`describe`)."""
        head = self.registry.head(view_id)
        if head is None:
            return None
        payload = self._fleet.load_result(head["key"])
        if payload is None:
            return None
        frames = {name: item[0] for name, item in payload.items()}
        schemas = {name: item[1] for name, item in payload.items()}
        as_of = float(head.get("as_of", 0.0))
        return {
            "view": view_id,
            "generation": int(head["gen"]),
            "as_of": as_of,
            "staleness_s": round(max(0.0, time.time() - as_of), 6),
            "mode": head.get("mode"),
            "frames": frames,
            "schemas": schemas,
        }

    # -- observability (the "views" metrics source) ---------------------------
    def health(self) -> Dict[str, Any]:
        h = self.maintainer.health()
        h["views_active"] = len(self.registry.list())
        return h

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = self.stats.as_dict()
        specs = self.registry.list()
        out["views_active"] = len(specs)
        max_staleness = 0.0
        by_view: Dict[str, Dict[str, Any]] = {}
        now = time.time()
        for spec in specs:
            head = self.registry.head(spec.id)
            if head is None:
                by_view[spec.id] = {"generation": 0}
                continue
            lag = max(0.0, now - float(head.get("as_of", now)))
            max_staleness = max(max_staleness, lag)
            by_view[spec.id] = {
                "generation": int(head.get("gen", 0)),
                "lag_s": round(lag, 3),
            }
        out["max_staleness_s"] = round(max_staleness, 3)
        out["by_view"] = by_view
        return out

    def reset(self) -> None:
        self.stats.reset()
