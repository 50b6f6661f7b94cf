"""Leased task dispatch: at-most-one-live-executor per task, on files.

A *lease* is the worker tier's unit of mutual exclusion: before running a
task a worker must hold ``<dir>/<task_id>.lease.json``, created through
the same ``O_CREAT|O_EXCL`` claim primitive the fleet uses
(:func:`~fugue_tpu_torch.cache.store.try_claim_file`). Ownership is bounded,
not permanent:

- the owner renews the lease at ``lease_s / 3`` while executing
  (``ts`` advances; ``acquired_ts`` — what straggler detection reads —
  does not);
- a lease whose ``ts`` is past ``lease_s`` is stealable (expired: the
  owner is wedged or gone);
- a lease whose owner's heartbeat is STALE is stealable immediately —
  cross-host death needs no lease wait (:mod:`.heartbeat`); a FRESH
  heartbeat never pins an *expired* lease (a live-but-wedged owner must
  not block the job);
- with no heartbeat evidence, the same-host dead-pid probe is the
  fallback, exactly as in the fleet claim protocol.

Steal races settle by re-read-after-atomic-rewrite; a released or stolen
owner's late ``release``/``renew`` is owner-checked and becomes a no-op.
First-publish-wins *done records* (:mod:`.board`) make the residual
two-executors window (steal of a live-but-slow owner, speculation) safe:
both may execute, at most one result is ever observed.
"""

import os
import socket
import time
from typing import Any, Dict, Optional, Tuple

from ..cache.store import (
    read_claim_file,
    release_claim_file,
    try_claim_file,
)
from ..obs.events import get_event_log
from .heartbeat import DEFAULT_STALE_AFTER_S, holder_alive

__all__ = ["LeaseBoard"]


class LeaseBoard:
    """Task leases under one directory (shared filesystem = the board)."""

    def __init__(
        self,
        path: str,
        hb_dir: Optional[str] = None,
        hb_stale_s: float = DEFAULT_STALE_AFTER_S,
        stats: Any = None,
    ):
        self.path = path
        self.hb_dir = hb_dir or None
        self.hb_stale_s = float(hb_stale_s)
        self._stats = stats
        os.makedirs(path, exist_ok=True)

    def _lease(self, task_id: str) -> str:
        return os.path.join(self.path, f"{task_id}.lease.json")

    def _inc(self, name: str, n: int = 1) -> None:
        if self._stats is not None:
            self._stats.inc(name, n)

    # -- liveness ------------------------------------------------------------
    def steal_reason(self, holder: Dict[str, Any]) -> Optional[str]:
        """Why (if at all) ``holder``'s lease may be stolen — the
        taxonomy's re-dispatch split, decided AT the steal site:
        ``"worker_lost"`` (owner provably dead: stale heartbeat, or dead
        same-host pid), ``"expired"`` (lease ran out under a live or
        unknown owner — TRANSIENT), or None (held fast)."""
        alive = holder_alive(
            str(holder.get("owner") or ""), self.hb_dir, self.hb_stale_s
        )
        if alive is False:
            return "worker_lost"
        if alive is None:
            # no heartbeat evidence: same-host dead-pid fallback
            pid = holder.get("pid")
            if pid and holder.get("host") == socket.gethostname():
                try:
                    os.kill(int(pid), 0)
                except ProcessLookupError:
                    return "worker_lost"
                except OSError:
                    pass
        ts = float(holder.get("ts", 0.0))
        lease = float(holder.get("lease_s", 0.0))
        if ts + lease <= time.time():
            # a FRESH heartbeat never pins an expired lease: a live-but-
            # wedged owner must not block the job
            return "expired"
        return None

    def stealable(self, holder: Dict[str, Any]) -> bool:
        return self.steal_reason(holder) is not None

    # -- the protocol --------------------------------------------------------
    def try_acquire(
        self, task_id: str, owner: str, lease_s: float
    ) -> Tuple[bool, Optional[Dict[str, Any]]]:
        """(owned, holder). ``owned`` means ``owner`` holds the lease now
        (fresh, re-entered, or stolen from a dead/expired holder)."""
        now = time.time()
        payload = {
            "owner": owner,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "ts": now,
            "acquired_ts": now,
            "lease_s": float(lease_s),
        }
        holder = self.read(task_id)
        owned, cur = try_claim_file(self._lease(task_id), payload, self.stealable)
        if owned:
            self._inc("leases_acquired")
            if (
                holder is not None
                and holder.get("owner") not in (None, owner)
                and cur is not None
                and cur.get("owner") == owner
            ):
                # classify the steal HERE, where the evidence is: the
                # supervisor folds these shipped-home counters into
                # redispatch_worker_lost / redispatch_transient
                self._inc("leases_stolen")
                reason = self.steal_reason(holder) or "expired"
                self._inc(
                    "leases_stolen_dead"
                    if reason == "worker_lost"
                    else "leases_stolen_expired"
                )
                log = get_event_log()
                if log.enabled:
                    if reason == "worker_lost":
                        # the heartbeat (or dead-pid probe) proved the
                        # holder gone — record the expiry as its own event
                        # so the timeline shows expiry BEFORE the steal
                        log.emit(
                            "hb.expired",
                            holder=holder.get("owner"),
                            task=task_id,
                            age_s=round(now - float(holder.get("ts", now)), 3),
                        )
                    log.emit(
                        "lease.steal",
                        task=task_id,
                        owner=owner,
                        prev_owner=holder.get("owner"),
                        reason=reason,
                    )
            else:
                get_event_log().emit("lease.acquire", task=task_id, owner=owner)
        return owned, cur

    def renew(self, task_id: str, owner: str, lease_s: float) -> bool:
        """Advance the lease clock if ``owner`` still holds it. False
        means the lease was stolen (or released) — the executor should
        abandon its attempt; its publish would lose the done-record race
        anyway."""
        path = self._lease(task_id)
        cur = read_claim_file(path)
        if cur is None or cur.get("owner") != owner:
            return False
        cur["ts"] = time.time()
        cur["lease_s"] = float(lease_s)
        try:
            tmp = f"{path}.__tmp_renew_{os.getpid()}"
            import json as _json

            with open(tmp, "w") as f:
                _json.dump(cur, f)
            os.replace(tmp, path)
        except OSError:
            return False
        # the rename races a stealer's rename; whoever's payload survived
        # owns it — re-read to learn the truth
        after = read_claim_file(path)
        renewed = after is not None and after.get("owner") == owner
        if renewed:
            self._inc("leases_renewed")
            get_event_log().emit("lease.renew", task=task_id, owner=owner)
        return renewed

    def release(self, task_id: str, owner: str) -> bool:
        return release_claim_file(self._lease(task_id), owner)

    def read(self, task_id: str) -> Optional[Dict[str, Any]]:
        return read_claim_file(self._lease(task_id))
