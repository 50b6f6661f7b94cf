"""Deterministic fault injection at named sites.

The resilience layer is only trustworthy if its failure paths are
exercised, so the injector is a first-class, conf/env-driven part of the
subsystem rather than test-local monkeypatching: production code calls
``injector.fire(SITE)`` at each named site and the call is a no-op unless
a fault plan is configured.

Plan grammar (``fugue.tpu.fault.plan`` conf key or ``FUGUE_TPU_FAULT_PLAN``
env var) — semicolon-separated rules::

    <site>=<kind>[:<arg>][@<count>]

    map.chunk=kill                 # SIGKILL the worker running the 1st chunk
    map.chunk=delay:3@2            # sleep 3s inside the first 2 chunks
    rpc.request=error:TimeoutError # raise TimeoutError on the 1st request
    task.execute=error@2           # raise InjectedFaultError on 2 tasks

``count`` (default 1) is the rule's budget: the fault triggers on the
first ``count`` arrivals at the site and never again. Budgets live in
fork-shared memory, so a budget consumed inside a forked pool worker is
visible to every later worker and to the driver — "kill exactly one
worker" means exactly one across the whole map, not one per child.

Named sites wired through the codebase:

- ``map.dispatch`` — driver side, before a chunk is handed to the pool
- ``map.chunk``    — inside the forked worker, before a chunk's first
  partition runs (``kill`` here exercises worker-crash recovery)
- ``task.execute`` — driver side, before a workflow task body runs
- ``rpc.request``  — inside the HTTP RPC client, before the request
- ``checkpoint.save`` — between a checkpoint's data write and its atomic
  publish rename (exercises torn-write recovery)

``kill`` is only honoured in a process other than the injector's creator
(a forked worker); in the driver it degrades to a raised
``InjectedFaultError`` so a mis-scoped plan cannot take down the session.
"""

import multiprocessing as mp
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

from .policy import InjectedFaultError

__all__ = [
    "FaultInjector",
    "NULL_INJECTOR",
    "SITE_MAP_DISPATCH",
    "SITE_MAP_CHUNK",
    "SITE_TASK_EXECUTE",
    "SITE_RPC_REQUEST",
    "SITE_CHECKPOINT_SAVE",
    "SITE_STREAM_CHUNK",
    "SITE_SHUFFLE_SPILL",
    "SITE_SERVE_JOURNAL",
    "SITE_SERVE_CLAIM",
    "SITE_DIST_LEASE",
    "SITE_DIST_HEARTBEAT",
    "SITE_DIST_BOARD",
    "SITE_VIEW_REGISTER",
]

SITE_MAP_DISPATCH = "map.dispatch"
SITE_MAP_CHUNK = "map.chunk"
SITE_TASK_EXECUTE = "task.execute"
SITE_RPC_REQUEST = "rpc.request"
SITE_CHECKPOINT_SAVE = "checkpoint.save"
# inside the streaming ingest pipeline's producer thread, after a chunk is
# decoded and before it is enqueued (the port: torch/pipeline.py) — `error`
# here is the poison-chunk scenario: it must propagate to the consumer
# with its traceback and must never deadlock the bounded queue
SITE_STREAM_CHUNK = "stream.chunk"
# inside the shuffle spill partitioner, between a bucket file's write and
# its atomic publish rename (fugue_tpu/shuffle/partitioner.py) — `error`
# here leaves that one bucket unpublished; the reader recovers it by
# repartitioning ONLY that bucket from a replayable source
SITE_SHUFFLE_SPILL = "shuffle.spill"
# inside EngineServer.submit, between the WAL append and the submission
# entering the queue (fugue_tpu/serve/server.py) — `kill` here leaves a
# journaled-but-never-queued admission: the crash window a restart's
# journal replay (and a FleetClient failover) must cover exactly once
SITE_SERVE_JOURNAL = "serve.journal"
# inside FleetCoordinator.acquire, between the cross-replica claim write
# and execution start (fugue_tpu/serve/fleet.py) — `kill` here leaves a
# dead owner's claim for waiters to steal (lease expiry / dead-pid
# detection); `delay` widens the window so a chaos test can SIGKILL the
# owner deterministically mid-claim
SITE_SERVE_CLAIM = "serve.claim"
# inside DistWorker.run_task, between the task-lease acquisition and the
# task body (fugue_tpu/dist/worker.py) — `error` here leaves an acquired
# lease to unwind-release (the fail record is TRANSIENT, the task is
# re-dispatched); `kill` leaves an orphaned lease for a live worker to
# steal once the dead owner's heartbeat goes stale
SITE_DIST_LEASE = "dist.lease"
# inside HeartbeatWriter's beat loop, before each atomic heartbeat write
# (fugue_tpu/dist/heartbeat.py) — `error` SKIPS that beat (a simulated
# network partition: enough skipped beats and the worker reads as dead
# to lease/claim stealers); `delay` widens the gap the same way
SITE_DIST_HEARTBEAT = "dist.heartbeat"
# inside DistWorker.run_task, between a done record's construction (all
# task outputs durably written) and its exclusive-create publish to the
# board (fugue_tpu/dist/worker.py) — `error` here records a TRANSIENT
# failure with outputs orphaned on disk (the re-dispatch must republish or
# dedup them); `kill` is the torn-publish crash window the lease-steal +
# orphaned-fragment-invalidation ladder must cover without losing or
# double-counting a row
SITE_DIST_BOARD = "dist.board"
# inside ViewRegistry.register, between the WAL append and the spec's
# atomic publish to the shared registry (fugue_tpu/views/registry.py) —
# `error`/`kill` here leave a journaled-but-invisible registration: the
# crash window a restarted replica's view replay must close by
# re-publishing the spec from its own WAL
SITE_VIEW_REGISTER = "view.register"

FUGUE_TPU_FAULT_PLAN_ENV = "FUGUE_TPU_FAULT_PLAN"

# exceptions nameable in `error:<Name>` rules; limited to types whose
# classification is meaningful to the retry machinery
_NAMED_ERRORS: Dict[str, type] = {
    "InjectedFaultError": InjectedFaultError,
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "ConnectionRefusedError": ConnectionRefusedError,
    "OSError": OSError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
}


class _Budget:
    """A decrement-once counter shared across fork children when possible."""

    def __init__(self, count: int):
        self._count = count
        try:
            self._shared: Any = mp.get_context("fork").Value("i", count)
        except (ValueError, OSError):  # no fork on this platform
            self._shared = None
            self._local = count
            self._lock = threading.Lock()

    def acquire(self) -> bool:
        if self._shared is not None:
            with self._shared.get_lock():
                if self._shared.value > 0:
                    self._shared.value -= 1
                    return True
                return False
        with self._lock:
            if self._local > 0:
                self._local -= 1
                return True
            return False

    @property
    def remaining(self) -> int:
        if self._shared is not None:
            return int(self._shared.value)
        return self._local


class _Rule:
    def __init__(self, site: str, kind: str, arg: str, count: int, creator_pid: int):
        if kind not in ("kill", "delay", "error"):
            raise ValueError(f"unknown fault kind {kind!r}")
        self.site = site
        self.kind = kind
        self.arg = arg
        self.budget = _Budget(count)
        self._creator_pid = creator_pid

    def perform(self, site: str) -> None:
        if self.kind == "kill":
            if os.getpid() != self._creator_pid:
                os.kill(os.getpid(), signal.SIGKILL)
            raise InjectedFaultError(
                f"injected kill at {site} (driver process — degraded to raise)"
            )
        if self.kind == "delay":
            time.sleep(float(self.arg or "1"))
            return
        exc_type = _NAMED_ERRORS.get(self.arg or "InjectedFaultError")
        if exc_type is None:
            raise ValueError(f"unknown injected error type {self.arg!r}")
        raise exc_type(f"injected fault at {site}")


def _parse_plan(plan: str, creator_pid: int) -> Dict[str, List[_Rule]]:
    rules: Dict[str, List[_Rule]] = {}
    for raw in plan.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        site, _, action = raw.partition("=")
        site = site.strip()
        action = action.strip()
        if not site or not action:
            raise ValueError(f"malformed fault rule {raw!r}")
        count = 1
        if "@" in action:
            action, _, c = action.rpartition("@")
            count = int(c)
        kind, _, arg = action.partition(":")
        rules.setdefault(site, []).append(
            _Rule(site, kind.strip(), arg.strip(), count, creator_pid)
        )
    return rules


class FaultInjector:
    """Fires configured faults at named sites; inert without a plan.

    Budgets are scoped to the injector instance — the engine creates one
    injector per map call / workflow run, so ``@1`` means "once per map",
    matching the acceptance scenario "SIGKILL one fork worker per map".
    """

    def __init__(self, plan: Optional[str] = None):
        self._plan = plan or ""
        self._rules = _parse_plan(self._plan, os.getpid()) if plan else {}

    @classmethod
    def from_conf(cls, conf: Any) -> "FaultInjector":
        from ..constants import FUGUE_TPU_CONF_FAULT_PLAN

        plan = str(conf.get(FUGUE_TPU_CONF_FAULT_PLAN, "")) or os.environ.get(
            FUGUE_TPU_FAULT_PLAN_ENV, ""
        )
        if not plan:
            return NULL_INJECTOR
        return cls(plan)

    @property
    def enabled(self) -> bool:
        return bool(self._rules)

    @property
    def plan(self) -> str:
        return self._plan

    def fire(self, site: str) -> None:
        """Trigger any armed rule for ``site``; no-op when the plan has no
        rule there or every matching budget is spent."""
        for rule in self._rules.get(site, ()):
            if rule.budget.acquire():
                rule.perform(site)


NULL_INJECTOR = FaultInjector(None)
