"""ViewMaintainer: the loop that keeps standing views fresh.

One daemon thread per replica, ticking every ``fugue.tpu.views.poll_s``
seconds over every registered spec on the shared store:

1. **Lease** — a per-view watch lease (the
   :class:`~fugue_tpu_torch.dist.lease.LeaseBoard` O_CREAT|O_EXCL claim +
   heartbeat primitive, under ``<store>/views/.leases``) guarantees
   exactly one replica advances each view; every replica still serves
   every view from the shared head + result store. A SIGKILLed
   maintainer's lease goes stealable once its heartbeat is provably
   stale (or its lease expires), and the survivor's next tick takes the
   view over — ``view.lease.steal`` in the flight recorder.
2. **Observe** — the view's :class:`~fugue_tpu_torch.views.watcher.SourceWatcher`
   re-lists the source's partition tokens (the delta manifest
   discovery) and classifies against the tokens the current generation
   was built from: ``unchanged`` / ``append`` (delta-served) /
   ``rewrite`` (the refusal ladder at steady state — FULL recompute for
   this generation, counted in ``delta_refusals``, never silent
   staleness).
3. **Refresh** — the view's factory is submitted through the NORMAL
   admission queue under the tenant's policy (interactive traffic still
   wins); a refresh whose wait puts the tenant's ``freshness_s`` SLO at
   risk is boosted by ``fugue.tpu.views.slo_boost`` priority points, and
   a breach emits ``view.slo_breach`` once per pending generation.
4. **Publish** — the yielded frames land in the fleet result store
   under ``view--<id>--g<gen>`` (monotonic generation), the head file
   flips atomically, superseded generations beyond
   ``keep_generations`` are deleted (the latest is pinned from the
   fleet's request-scoped LRU), and ``view.publish`` records it.
"""

import os
import re
import threading
import time
from typing import Any, Dict, Optional

from ..constants import (
    FUGUE_TPU_CONF_DIST_HB_DIR,
    FUGUE_TPU_CONF_DIST_HB_STALE_S,
    FUGUE_TPU_CONF_VIEWS_KEEP_GENERATIONS,
    FUGUE_TPU_CONF_VIEWS_LEASE_S,
    FUGUE_TPU_CONF_VIEWS_POLL_S,
    FUGUE_TPU_CONF_VIEWS_REFRESH_TIMEOUT_S,
    FUGUE_TPU_CONF_VIEWS_SLO_BOOST,
    FUGUE_TPU_CONF_VIEWS_SLO_RISK_FRACTION,
)
from ..dist.heartbeat import DEFAULT_STALE_AFTER_S
from ..dist.lease import LeaseBoard
from ..obs.events import get_event_log
from .registry import ViewRegistry, ViewSpec
from .watcher import WatchError, make_watcher

__all__ = ["ViewMaintainer", "probe_name"]


def probe_name(view_id: str) -> str:
    """Sampler-probe (→ prometheus gauge) name for one view's lag."""
    return "view_lag_s_" + re.sub(r"[^A-Za-z0-9_]", "_", view_id)


class ViewMaintainer:
    def __init__(self, server: Any, registry: ViewRegistry, stats: Any):
        self._server = server
        self._registry = registry
        self._stats = stats
        c = server.engine.conf
        self.owner = server.replica_id
        self.poll_s = float(c.get(FUGUE_TPU_CONF_VIEWS_POLL_S, 1.0))
        self.lease_s = float(c.get(FUGUE_TPU_CONF_VIEWS_LEASE_S, 15.0))
        self.keep_generations = max(
            1, int(c.get(FUGUE_TPU_CONF_VIEWS_KEEP_GENERATIONS, 2))
        )
        self.slo_boost = int(c.get(FUGUE_TPU_CONF_VIEWS_SLO_BOOST, 2))
        self.slo_risk_fraction = float(
            c.get(FUGUE_TPU_CONF_VIEWS_SLO_RISK_FRACTION, 0.8)
        )
        self.refresh_timeout_s = float(
            c.get(FUGUE_TPU_CONF_VIEWS_REFRESH_TIMEOUT_S, 600.0)
        )
        hb_dir = str(c.get(FUGUE_TPU_CONF_DIST_HB_DIR, "")) or None
        self._board = LeaseBoard(
            os.path.join(registry.dir, ".leases"),
            hb_dir=hb_dir,
            hb_stale_s=float(
                c.get(FUGUE_TPU_CONF_DIST_HB_STALE_S, DEFAULT_STALE_AFTER_S)
            ),
        )
        self._lock = threading.Lock()
        self._held: Dict[str, bool] = {}  # view id -> currently maintaining
        self._pending_since: Dict[str, float] = {}  # change observed, not published
        self._breached: Dict[str, int] = {}  # view id -> gen already breach-logged
        self._probes: Dict[str, bool] = {}
        self._last_tick = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._log = server.engine.log

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="fugue-view-maintainer", daemon=True
            )
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop_evt.set()
        if thread is not None:
            thread.join(timeout)
        # release held leases so a peer replica takes over immediately
        # instead of waiting out the lease; unregister this process's
        # lag probes (the views themselves live on)
        with self._lock:
            held = list(self._held)
            self._held.clear()
            probes = list(self._probes)
            self._probes.clear()
        for vid in held:
            self._board.release(vid, self.owner)
        from ..obs import get_sampler

        for name in probes:
            get_sampler().unregister_probe(name)

    def halt_for_test(self) -> None:
        """Stop the loop WITHOUT releasing leases — simulates a wedged
        (or killed) maintainer so lease-steal paths can be exercised
        in-process."""
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop_evt.set()
        if thread is not None:
            thread.join(5.0)

    def health(self) -> Dict[str, Any]:
        with self._lock:
            alive = self._thread is not None and self._thread.is_alive()
            last = self._last_tick
            held = sorted(self._held)
        return {
            "loop_alive": alive,
            "last_tick_age_s": (
                round(time.monotonic() - last, 3) if last else None
            ),
            "maintaining": held,
        }

    def holder(self, view_id: str) -> Optional[str]:
        cur = self._board.read(view_id)
        return cur.get("owner") if cur else None

    # -- the loop ------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.tick_once()
            except Exception as ex:  # the loop must survive anything
                self._stats.inc("watch_errors")
                self._log.warning("views: maintainer tick failed: %s", ex)
            self._stop_evt.wait(self.poll_s)

    def tick_once(self) -> None:
        """One synchronous maintenance pass (the loop body; also the
        test hook — deterministic, no thread needed)."""
        self._stats.inc("loop_ticks")
        with self._lock:
            self._last_tick = time.monotonic()
        specs = self._registry.list()
        ids = {s.id for s in specs}
        # views unregistered elsewhere: drop their leases + local state
        # (their lag probes self-remove via ProbeGone on the next sample)
        with self._lock:
            gone = [vid for vid in self._held if vid not in ids]
            for vid in gone:
                self._held.pop(vid, None)
            for vid in list(self._pending_since):
                if vid not in ids:
                    self._pending_since.pop(vid, None)
                    self._breached.pop(vid, None)
        for vid in gone:
            self._board.release(vid, self.owner)
        for spec in specs:
            if self._stop_evt.is_set():
                return
            try:
                self._maintain(spec)
            except WatchError as ex:
                self._stats.inc("watch_errors")
                self._log.warning("views: %s unobservable: %s", spec.id, ex)
            except Exception as ex:
                self._stats.inc("refresh_failures")
                self._log.warning("views: refresh of %s failed: %s", spec.id, ex)

    # -- per-view work -------------------------------------------------------
    def _maintain(self, spec: ViewSpec) -> None:
        self._ensure_probe(spec.id)
        if not self._acquire(spec.id):
            return
        obs = make_watcher(spec.source, spec.fmt).observe()
        head = self._registry.head(spec.id)
        now = time.time()
        reason: Optional[str] = None
        if head is None:
            if not obs.tokens:
                return  # registered over an empty source: wait for data
            mode, fresh, total = "full", len(obs.tokens), len(obs.tokens)
            if obs.refusal is not None:
                reason = obs.refusal
        else:
            verdict, fresh = make_watcher(spec.source, spec.fmt).classify(
                head.get("tokens") or [], obs
            )
            if verdict == "unchanged":
                with self._lock:
                    self._pending_since.pop(spec.id, None)
                return
            total = len(obs.tokens)
            if verdict == "append" and obs.refusal is None:
                mode = "delta"
            else:
                mode = "full"
                fresh = total
                reason = obs.refusal or "historical partition changed (rewrite)"
                self._stats.inc("delta_refusals")
                self._stats.inc("full_recomputes")
        with self._lock:
            self._pending_since.setdefault(spec.id, now)
            pending_since = self._pending_since[spec.id]
        gen = (int(head["gen"]) if head else 0) + 1
        prio, boosted = self._priority(spec, gen, now - pending_since)
        get_event_log().emit(
            "view.refresh",
            view=spec.id,
            gen=gen,
            mode=mode,
            fresh=fresh,
            total=total,
            priority=prio,
            reason=reason,
        )
        self._stats.inc("refreshes")
        self._stats.inc("partitions_fresh", fresh)
        self._stats.inc("partitions_total", total)
        if head is not None:
            # steady-state counters exclude the cold first generation so
            # skip_fraction measures what delta actually saves
            self._stats.inc("steady_partitions_fresh", fresh)
            self._stats.inc("steady_partitions_total", total)
        self._refresh(spec, gen, obs, mode, prio, boosted, reason)

    def _acquire(self, view_id: str) -> bool:
        """Hold (or take) the view's watch lease. Emits the typed
        view.lease.* events only on transitions, with counter parity."""
        with self._lock:
            held = view_id in self._held
        if held:
            if self._board.renew(view_id, self.owner, self.lease_s):
                return True
            with self._lock:
                self._held.pop(view_id, None)
            self._stats.inc("lease_losses")
            return False
        prev = self._board.read(view_id)
        owned, _cur = self._board.try_acquire(view_id, self.owner, self.lease_s)
        if not owned:
            return False
        with self._lock:
            self._held[view_id] = True
        prev_owner = prev.get("owner") if prev else None
        if prev_owner not in (None, self.owner):
            self._stats.inc("lease_steals")
            get_event_log().emit(
                "view.lease.steal",
                view=view_id,
                owner=self.owner,
                prev_owner=prev_owner,
                reason=self._board.steal_reason(prev) or "expired",
            )
        else:
            self._stats.inc("lease_acquires")
            get_event_log().emit(
                "view.lease.acquire", view=view_id, owner=self.owner
            )
        return True

    def _priority(
        self, spec: ViewSpec, gen: int, lag_s: float
    ) -> "tuple[int, bool]":
        pol = self._server._policy(spec.tenant)
        base = (
            pol.priority if pol.priority is not None
            else self._server.default_priority
        )
        slo = pol.freshness_s
        if slo is None or slo <= 0:
            return int(base), False
        boosted = lag_s >= self.slo_risk_fraction * slo
        if boosted:
            self._stats.inc("slo_boosts")
        if lag_s > slo:
            with self._lock:
                first = self._breached.get(spec.id) != gen
                self._breached[spec.id] = gen
            if first:
                self._stats.inc("slo_breaches")
                get_event_log().emit(
                    "view.slo_breach",
                    view=spec.id,
                    tenant=spec.tenant,
                    gen=gen,
                    lag_s=round(lag_s, 3),
                    slo_s=slo,
                )
        return (max(0, int(base) - self.slo_boost) if boosted else int(base)), boosted

    def _refresh(
        self,
        spec: ViewSpec,
        gen: int,
        obs: Any,
        mode: str,
        prio: int,
        boosted: bool,
        reason: Optional[str],
    ) -> None:
        from ..serve.fleet import view_result_key

        sub = self._server.submit(
            spec.build_factory(),
            tenant=spec.tenant,
            priority=prio,
            idempotency_key=f"view:{spec.id}:g{gen}",
        )
        result = sub.result(timeout=self.refresh_timeout_s)
        frames = self._server._extract_frames(result)
        if frames is None:
            self._stats.inc("refresh_failures")
            self._log.warning(
                "views: %s generation %d yielded unpublishable frames "
                "(unbounded/device-resident); view head NOT advanced",
                spec.id,
                gen,
            )
            return
        # the publish gate: still the maintainer? A stolen lease means a
        # peer may already be building this generation — publishing now
        # could double-publish a generation number
        if not self._board.renew(spec.id, self.owner, self.lease_s):
            with self._lock:
                self._held.pop(spec.id, None)
            self._stats.inc("lease_losses")
            return
        key = view_result_key(spec.id, gen)
        fleet = self._server._fleet
        fleet.publish_result(key, frames)
        self._registry.publish_head(
            spec.id,
            {
                "id": spec.id,
                "gen": gen,
                "as_of": obs.ts,
                "key": key,
                "tokens": obs.tokens,
                "mode": mode,
                "reason": reason,
                "slo_boosted": boosted,
                "published_ts": time.time(),
                "maintainer": self.owner,
            },
        )
        get_event_log().emit(
            "view.publish",
            view=spec.id,
            gen=gen,
            key=key,
            as_of=round(obs.ts, 6),
            mode=mode,
        )
        self._stats.inc("generations_published")
        with self._lock:
            self._pending_since.pop(spec.id, None)
            self._breached.pop(spec.id, None)
        # retention: superseded generations beyond keep_generations go;
        # the latest is additionally PINNED from the fleet's own LRU
        # (fleet.py), so this is the only eviction path for view results
        cutoff = gen - self.keep_generations
        for g in range(max(1, cutoff - 8), cutoff + 1):
            if fleet.remove_result(view_result_key(spec.id, g)):
                self._stats.inc("superseded_evicted")

    # -- observability -------------------------------------------------------
    def _ensure_probe(self, view_id: str) -> None:
        name = probe_name(view_id)
        with self._lock:
            if name in self._probes:
                return
            self._probes[name] = True
        from ..obs import get_sampler
        from ..obs.sampler import ProbeGone

        registry = self._registry

        def lag() -> float:
            head = registry.head(view_id)
            if registry.get(view_id) is None:
                raise ProbeGone()
            if head is None:
                return 0.0
            return max(0.0, time.time() - float(head.get("as_of", 0.0)))

        get_sampler().register_probe(name, lag)
