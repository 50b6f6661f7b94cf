"""The long-lived engine server: N concurrent sessions, one engine. The
port's copy of ``fugue_tpu/serve/server.py``.

The layers below optimize ONE workflow at a time; heavy traffic from
many users needs an *execution environment serving many jobs*
(arXiv:2301.07896), with per-job scheduling over a shared runtime
(arXiv:2209.06146). :class:`EngineServer` is that environment,
in-process: it owns one live :class:`~fugue_tpu_torch.execution.ExecutionEngine`
(a ``TorchExecutionEngine`` on ``cuda:0``: its device, result/delta
cache, tuner, stats) and admits
``workflow.run`` submissions from any number of concurrent sessions
through an admission/scheduling queue.

The moving parts (docs/serving.md):

- **Admission**: a bounded queue (``fugue.tpu.serve.queue_depth``) —
  past it submissions are REJECTED, and ``/readyz`` reports overloaded
  *before* that so a load balancer can shed first. Tenant byte budgets
  (``fugue.tpu.serve.tenant.<id>.budget_bytes``) gate admission against
  the live charged-byte ledger (:class:`~fugue_tpu_torch.serve.tenant.TenantAccounts`).
- **Scheduling**: ``fugue.tpu.serve.max_concurrent`` worker threads;
  lowest priority number first, FIFO within a priority, and a queued
  execution's effective priority improves one level per
  ``fugue.tpu.serve.aging_s`` waited — starvation-free by construction.
- **Single-flight dedup**: submissions whose post-optimization plan
  fingerprint (:mod:`fugue_tpu_torch.serve.dedup`) matches an in-flight
  execution JOIN it — one execution, every waiter gets the result.
  A canceled waiter detaches without canceling the shared execution.
- **Attribution**: every execution runs inside
  ``run_labels(tenant=...)``, so the span histograms
  (``engine.stats()["latency"]``, ``/metrics``) carry a ``tenant``
  label — bounded-cardinality via the same rotation as ``run``.

Each worker thread runs its workflow through ``FugueWorkflow.run``,
which enters the engine's context (a ``ContextVar``) on that thread. A
yielded ``TorchDataFrame`` stays on the card while the retention ring
(``fugue.tpu.serve.retain``) or a waiter holds it, and its tenant is
charged its device bytes (``cache/store.py`` ``estimate_df_bytes``).
A finished execution keeps only its result or its error: its workflow,
whose context holds every intermediate frame of the run, is dropped.
"""

import os
import socket
import threading
import time
import traceback
import uuid as _uuid
from collections import OrderedDict
from contextlib import nullcontext
from typing import Any, Dict, List, Optional

from ..constants import (
    FUGUE_TPU_CONF_DIST_HB_DIR,
    FUGUE_TPU_CONF_DIST_HB_INTERVAL_S,
    FUGUE_TPU_CONF_SERVE_AGING_S,
    FUGUE_TPU_CONF_SERVE_DEFAULT_PRIORITY,
    FUGUE_TPU_CONF_SERVE_FLEET_ENABLED,
    FUGUE_TPU_CONF_SERVE_FLEET_LEASE_S,
    FUGUE_TPU_CONF_SERVE_FLEET_MAX_RESULTS,
    FUGUE_TPU_CONF_SERVE_FLEET_POLL_S,
    FUGUE_TPU_CONF_SERVE_JOURNAL_DIR,
    FUGUE_TPU_CONF_SERVE_JOURNAL_MAX_BYTES,
    FUGUE_TPU_CONF_SERVE_MAX_CONCURRENT,
    FUGUE_TPU_CONF_SERVE_MAX_TENANTS,
    FUGUE_TPU_CONF_SERVE_QUEUE_DEPTH,
    FUGUE_TPU_CONF_SERVE_REPLICA_ID,
    FUGUE_TPU_CONF_SERVE_RESERVE_BYTES,
    FUGUE_TPU_CONF_SERVE_RETAIN,
    FUGUE_TPU_CONF_TRACE_SPOOL_DIR,
    FUGUE_TPU_CONF_VIEWS_ENABLED,
)
from ..resilience import SITE_SERVE_CLAIM, SITE_SERVE_JOURNAL, FaultInjector
from ..workflow.factory import build_workflow, is_workflow_factory
from .dedup import submission_key
from .fleet import FleetCoordinator, FleetResult
from .journal import SubmissionJournal
from .stats import ServeStats
from .tenant import TenantAccounts, TenantPolicy, tenant_policy

__all__ = [
    "EngineServer",
    "ServeRejected",
    "Submission",
    "SubmissionCanceled",
]


class ServeRejected(Exception):
    """Admission refused (queue full / tenant budget / server stopped)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"submission rejected: {reason}" + (f" ({detail})" if detail else ""))
        self.reason = reason


class SubmissionCanceled(Exception):
    """``result()`` called on a canceled submission."""


class _Execution:
    """One unit of engine work, shared by every deduped waiter."""

    __slots__ = (
        "key", "dag", "tenant", "priority", "seq", "submitted_at",
        "started_at", "finished_at", "started", "state", "result",
        "error", "waiters", "done", "trace",
    )

    def __init__(self, key: Optional[str], dag: Any, tenant: str,
                 priority: int, seq: int):
        self.key = key
        self.trace: Dict[str, str] = {}
        self.dag = dag
        self.tenant = tenant
        self.priority = int(priority)
        self.seq = seq
        self.submitted_at = time.monotonic()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.started = False
        self.state = "queued"  # queued | running | done | failed | canceled
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.waiters: List["Submission"] = []
        self.done = threading.Event()


class Submission:
    """One session's handle on a (possibly shared) execution."""

    def __init__(self, server: "EngineServer", execution: _Execution,
                 tenant: str, priority: int, deduped: bool):
        self.id = _uuid.uuid4().hex[:16]
        self.tenant = tenant
        self.priority = int(priority)
        self.deduped = deduped
        self._server = server
        self._execution = execution
        self._canceled = False
        self._event = threading.Event()

    # -- introspection -------------------------------------------------------
    @property
    def status(self) -> str:
        if self._canceled:
            return "canceled"
        return self._execution.state

    @property
    def done(self) -> bool:
        return self.status in ("done", "failed", "canceled")

    @property
    def queue_wait_s(self) -> Optional[float]:
        ex = self._execution
        if ex.started_at is None:
            return None
        return ex.started_at - ex.submitted_at

    @property
    def run_s(self) -> Optional[float]:
        ex = self._execution
        if ex.started_at is None or ex.finished_at is None:
            return None
        return ex.finished_at - ex.started_at

    # -- blocking API --------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        """True once the submission reached a terminal state."""
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block for the :class:`~fugue_tpu_torch.workflow.FugueWorkflowResult`.

        For a deduped submission this is the EXECUTED workflow's result —
        the yielded frames are shared live objects, exactly like a
        result-cache memory hit. Raises the execution's error, or
        :class:`SubmissionCanceled`; ``TimeoutError`` past ``timeout``.
        Claiming the result releases this submission's tenant byte
        charge (the caller holds the frames now, not the server)."""
        from ..obs import get_tracer

        with get_tracer().span(
            "serve.wait", cat="serve", tenant=self.tenant, id=self.id
        ):
            if not self._event.wait(timeout):
                raise TimeoutError(
                    f"submission {self.id} not done after {timeout}s "
                    f"(status={self.status})"
                )
        if self._canceled:
            raise SubmissionCanceled(f"submission {self.id} was canceled")
        ex = self._execution
        if ex.state == "failed":
            assert ex.error is not None
            raise ex.error
        self._server._accounts.release(self.tenant, self.id)
        return ex.result

    def cancel(self) -> bool:
        """Detach from the execution. Never cancels a SHARED execution:
        other waiters keep theirs; only a queued execution whose last
        waiter leaves is removed from the queue. True when this call
        changed state (idempotent thereafter)."""
        return self._server._cancel(self)


class EngineServer:
    """A long-lived serving front end over one shared engine."""

    def __init__(self, engine: Any = None, conf: Any = None):
        if engine is None:
            from ..execution.factory import make_execution_engine

            engine = make_execution_engine(None, conf=conf)
        self._engine = engine
        c = engine.conf
        self.max_concurrent = max(1, int(c.get(FUGUE_TPU_CONF_SERVE_MAX_CONCURRENT, 2)))
        self.queue_capacity = max(1, int(c.get(FUGUE_TPU_CONF_SERVE_QUEUE_DEPTH, 64)))
        self.default_priority = int(c.get(FUGUE_TPU_CONF_SERVE_DEFAULT_PRIORITY, 5))
        self.aging_s = float(c.get(FUGUE_TPU_CONF_SERVE_AGING_S, 30.0))
        self.default_reserve = int(c.get(FUGUE_TPU_CONF_SERVE_RESERVE_BYTES, 0))
        self.retain = max(1, int(c.get(FUGUE_TPU_CONF_SERVE_RETAIN, 256)))
        self.max_tenants = max(1, int(c.get(FUGUE_TPU_CONF_SERVE_MAX_TENANTS, 256)))
        self.replica_id = str(
            c.get(FUGUE_TPU_CONF_SERVE_REPLICA_ID, "")
        ) or f"{socket.gethostname()}-{os.getpid()}"
        self._stats = ServeStats(max_tenants=self.max_tenants)
        self._accounts = TenantAccounts()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[_Execution] = []
        self._inflight: Dict[str, _Execution] = {}  # dedup key -> execution
        self._subs: Dict[str, Submission] = {}
        self._idem: Dict[str, str] = {}  # idempotency key -> submission id
        self._done_order: List[str] = []  # retention ring of finished subs
        # per-tenant state is LRU-bounded like the retention ring: tenant
        # ids are client-supplied, and a hostile client minting ids must
        # rotate state, never grow it
        self._policies: "OrderedDict[str, TenantPolicy]" = OrderedDict()
        self._overlay_warned: "OrderedDict[str, bool]" = OrderedDict()
        self._store_health: Dict[str, Any] = {}
        self._store_health_ts = 0.0
        self._seq = 0
        self._active = 0
        self._peak_queue = 0
        self._workers: List[threading.Thread] = []
        self._running = False
        self._injector = FaultInjector.from_conf(c)
        # fleet coordination (docs/serving.md "Fleet"): active only when
        # the engine mounts a shared disk store — replicas sharing that
        # directory collapse identical submissions across processes.
        # fleet.enabled=false restores single-server behavior exactly.
        self._fleet: Optional[FleetCoordinator] = None
        if bool(c.get(FUGUE_TPU_CONF_SERVE_FLEET_ENABLED, True)):
            disk = getattr(engine.result_cache, "disk", None)
            if disk is not None:
                self._fleet = FleetCoordinator(
                    disk,
                    self.replica_id,
                    lease_s=float(c.get(FUGUE_TPU_CONF_SERVE_FLEET_LEASE_S, 30.0)),
                    poll_s=float(c.get(FUGUE_TPU_CONF_SERVE_FLEET_POLL_S, 0.05)),
                    max_results=int(
                        c.get(FUGUE_TPU_CONF_SERVE_FLEET_MAX_RESULTS, 256)
                    ),
                    stats=self._stats,
                    injector=self._injector,
                    log=engine.log,
                )
        # crash-safe submission journal (serve/journal.py): per-replica
        # fsync'd WAL; admissions append BEFORE queueing, restarts replay
        self._journal: Optional[SubmissionJournal] = None
        jdir = str(c.get(FUGUE_TPU_CONF_SERVE_JOURNAL_DIR, ""))
        if jdir:
            self._journal = SubmissionJournal(
                os.path.join(jdir, f"{self.replica_id}.jsonl"),
                self.replica_id,
                log=engine.log,
                max_bytes=int(
                    c.get(FUGUE_TPU_CONF_SERVE_JOURNAL_MAX_BYTES, 64 * 1024 * 1024)
                ),
            )
        # cluster tracing: with a spool dir configured this
        # replica exports its span buffer after every execution so a
        # driver-side assembler merges it into ONE fleet trace
        self._spool_dir = str(c.get(FUGUE_TPU_CONF_TRACE_SPOOL_DIR, ""))
        # cross-host liveness: with a heartbeat dir configured
        # this replica beats under its replica_id, and the shared store's
        # claim stealing (cache/store.py) judges it by that beat instead
        # of a same-host pid probe — fleet claim steal works across hosts
        self._heartbeat: Optional[Any] = None
        hb_dir = str(c.get(FUGUE_TPU_CONF_DIST_HB_DIR, ""))
        if hb_dir:
            from ..dist.heartbeat import DEFAULT_INTERVAL_S, HeartbeatWriter

            self._heartbeat = HeartbeatWriter(
                hb_dir,
                self.replica_id,
                interval_s=float(
                    c.get(FUGUE_TPU_CONF_DIST_HB_INTERVAL_S, DEFAULT_INTERVAL_S)
                ),
                injector=self._injector,
                log=engine.log,
            )
        # continuous views (docs/views.md): default OFF, and
        # even when on, inert without the shared store every piece of the
        # subsystem (registry, leases, generation payloads) lives on
        self._views: Optional[Any] = None
        if bool(c.get(FUGUE_TPU_CONF_VIEWS_ENABLED, False)):
            if self._fleet is None:
                engine.log.warning(
                    "views: fugue.tpu.views.enabled is on but no shared "
                    "store is mounted (fugue.tpu.cache.dir, with the fleet "
                    "enabled); continuous views stay off"
                )
            else:
                from ..views import ViewService

                self._views = ViewService(self)
        # serving counters ride the engine's unified registry
        # (engine.stats()["serve"], reset under keep-entries)
        engine.metrics.register("serve", self._stats)
        if self._views is not None:
            engine.metrics.register("views", self._views)
        if self._fleet is not None:
            # fleet rollup (metrics federation): the cross-
            # replica coordination counters as their own stats group —
            # engine.stats()["fleet"] answers "is the fleet dedup/failover
            # machinery actually firing" without digging through serve.*
            engine.metrics.register("fleet", _FleetRollup(self))
        self._register_probes()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "EngineServer":
        with self._lock:
            if self._running:
                return self
            self._running = True
            self._workers = [
                threading.Thread(
                    target=self._worker, name=f"fugue-serve-{i}", daemon=True
                )
                for i in range(self.max_concurrent)
            ]
        for t in self._workers:
            t.start()
        if self._heartbeat is not None:
            self._heartbeat.start()
        self._replay_journal()
        if self._views is not None:
            # after the submission replay: view registrations replay from
            # the same WAL, then the watch loop starts ticking
            self._views.start()
        return self

    def _replay_journal(self) -> None:
        """Resubmit this replica's admitted-but-unfinished journal
        entries under their original idempotency keys (crash recovery).
        The claim protocol turns a replay whose original execution
        published into a fleet result hit, not a re-run."""
        if self._journal is None:
            return
        replayed = 0
        for rec in self._journal.unfinished():
            dag = self._journal.decode_dag(rec)
            if dag is None:
                # audited but not replayable (unpicklable in-process dag)
                self._journal.done(rec.get("sid", ""), "unreplayable")
                continue
            try:
                self.submit(
                    dag,
                    tenant=rec.get("tenant", "default"),
                    priority=rec.get("priority"),
                    idempotency_key=rec.get("idem"),
                    reserve_bytes=rec.get("reserve"),
                )
                self._stats.inc("journal_replays")
                replayed += 1
            except ServeRejected:
                pass  # shed on replay too: rejection is never silent
            finally:
                # the replayed submission journals its own fresh admit
                # record; retire the pre-crash one either way
                self._journal.done(rec.get("sid", ""), "replayed")
        if replayed:
            from ..obs.events import get_event_log

            get_event_log().emit(
                "serve.journal_replay", replica=self.replica_id, entries=replayed
            )

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        """Stop admitting and drain: in-flight executions finish, still-
        queued ones fail their waiters with ``ServeRejected``."""
        if self._views is not None:
            # stop the watch loop first (it submits into the queue being
            # drained below) and release its leases so a peer takes over
            self._views.stop()
        with self._cv:
            if not self._running:
                return
            self._running = False
            dropped, self._queue = self._queue, []
            for ex in dropped:
                ex.state = "failed"
                ex.error = ServeRejected("server_stopped")
                if ex.key is not None:
                    self._inflight.pop(ex.key, None)
            self._cv.notify_all()
        for ex in dropped:
            self._finish_waiters(ex)
            if self._journal is not None:
                for sub in ex.waiters:
                    # an ORDERLY stop retires its drained admissions so a
                    # restart doesn't replay work the client saw rejected
                    # (a crash, by definition, writes nothing here)
                    self._journal.done(sub.id, "dropped")
        with self._lock:
            workers, self._workers = self._workers, []
        for t in workers:
            t.join(timeout=timeout)
        if self._heartbeat is not None:
            # an orderly stop removes the beat file — departure reads as
            # UNKNOWN (pid fallback), not as a death to steal from
            self._heartbeat.stop(remove=True)
        if self._journal is not None:
            self._journal.close()

    def __enter__(self) -> "EngineServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    @property
    def engine(self) -> Any:
        return self._engine

    @property
    def views(self) -> Optional[Any]:
        """The continuous-view service, or None when
        ``fugue.tpu.views.enabled`` is off (the kill-switch contract:
        registration endpoints 404, no watcher threads)."""
        return self._views

    @property
    def running(self) -> bool:
        return self._running

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def active_runs(self) -> int:
        with self._lock:
            return self._active

    def store_health(self) -> Dict[str, Any]:
        """Writability of the shared dirs this replica depends on (the
        fleet result store and the journal dir) — what ``/readyz`` turns
        into a 503 ``store_unwritable`` so the balancer DRAINS a replica
        whose disk died instead of queueing onto it. Probed by actually
        creating+removing a file, cached for 5s (readyz is polled)."""
        now = time.monotonic()
        with self._lock:
            if self._store_health and now - self._store_health_ts < 5.0:
                return dict(self._store_health)
        probes: List[str] = []
        if self._fleet is not None:
            probes.append(self._fleet.results_dir)
        if self._journal is not None:
            d = os.path.dirname(self._journal.path)
            if d:
                probes.append(d)
        health: Dict[str, Any] = {"writable": True, "probed": bool(probes)}
        for d in probes:
            probe = os.path.join(d, f".probe_{_uuid.uuid4().hex}")
            try:
                with open(probe, "w") as f:
                    f.write("ok")
                os.remove(probe)
            except OSError as ex:
                health = {
                    "writable": False,
                    "probed": True,
                    "path": d,
                    "error": f"{type(ex).__name__}: {ex}",
                }
                break
        with self._lock:
            self._store_health = dict(health)
            self._store_health_ts = now
        return health

    # -- admission -----------------------------------------------------------
    def submit(
        self,
        dag: Any,
        tenant: str = "default",
        priority: Optional[int] = None,
        idempotency_key: Optional[str] = None,
        reserve_bytes: Optional[int] = None,
    ) -> Submission:
        """Admit one workflow. ``dag`` is a built ``FugueWorkflow`` or a
        zero-arg factory returning one (factories keep one-pass stream
        sources fresh per submission). Raises :class:`ServeRejected` on
        queue-full / budget / stopped — rejection is an ERROR to the
        session and a counter to the operator, never silent."""
        from ..obs import get_tracer

        tracer = get_tracer()
        tenant = str(tenant)
        tctx: Any = nullcontext()
        if tracer.enabled:
            from ..obs import current_trace_id, trace_scope

            if current_trace_id() is None:
                # cluster tracing: an in-process submission
                # mints its own trace root; an HTTP submission arrives
                # with the client's trace already bound by the handler
                # (rpc/http.py reads X-Fugue-Trace) and keeps it
                tctx = trace_scope()
        with tctx, tracer.span("serve.submit", cat="serve", tenant=tenant) as sp:
            if not self._running:
                raise ServeRejected("server_stopped")
            # the journal records what was SUBMITTED: a factory pickles
            # (and replays fresh); a built dag is journaled best-effort
            raw_dag = dag
            if is_workflow_factory(dag):
                dag = build_workflow(dag)
            self._stats.inc("submitted")
            self._stats.inc_tenant(tenant, "submitted")
            if idempotency_key is not None:
                with self._lock:
                    sid = self._idem.get(idempotency_key)
                    prior = self._subs.get(sid) if sid is not None else None
                if prior is not None:
                    # the retry-safe replay: the client's resend (riding
                    # the HTTP retry policy) maps onto the SAME submission
                    self._stats.inc("idempotent_replays")
                    sp.set(outcome="idempotent_replay", id=prior.id)
                    return prior
            pol = self._policy(tenant)
            prio = (
                int(priority)
                if priority is not None
                else (pol.priority if pol.priority is not None else self.default_priority)
            )
            if pol.conf_overlay:
                dag._conf.update(pol.conf_overlay)
            key = submission_key(dag, self._engine)
            reserve = (
                int(reserve_bytes) if reserve_bytes is not None else self.default_reserve
            )
            # cluster-wide result cache (docs/serving.md "Fleet"): a plan
            # some replica already executed and published answers here
            # without queueing — the cross-replica analogue of a result-
            # cache memory hit. Probed OUTSIDE the admission lock (disk).
            if key is not None and self._fleet is not None:
                sub = self._admit_fleet_hit(
                    key, tenant, prio, reserve, idempotency_key, pol, sp
                )
                if sub is not None:
                    return sub
            with self._cv:
                if not self._running:
                    raise ServeRejected("server_stopped")
                # single-flight: an identical in-flight plan is joined,
                # not re-run — no queue slot, no budget charge (the work
                # and the live result already exist once)
                if key is not None:
                    ex = self._inflight.get(key)
                    if ex is not None and ex.state in ("queued", "running"):
                        sub = Submission(self, ex, tenant, prio, deduped=True)
                        ex.waiters.append(sub)
                        ex.priority = min(ex.priority, prio)
                        self._subs[sub.id] = sub
                        if idempotency_key is not None:
                            self._idem[idempotency_key] = sub.id
                        self._stats.inc("dedup_hits")
                        self._stats.inc_tenant(tenant, "dedup_hits")
                        self._journal_admit(
                            sub, idempotency_key, tenant, prio, reserve, raw_dag
                        )
                        sp.set(outcome="dedup", id=sub.id, key=key[:12])
                        return sub
                if len(self._queue) >= self.queue_capacity:
                    self._stats.inc("rejected_queue_full")
                    self._stats.inc_tenant(tenant, "rejected")
                    sp.set(outcome="rejected_queue_full")
                    raise ServeRejected(
                        "queue_full",
                        f"{len(self._queue)}/{self.queue_capacity} queued",
                    )
                sub = Submission(self, None, tenant, prio, deduped=False)  # type: ignore[arg-type]
                if not self._accounts.try_charge(
                    tenant, sub.id, reserve, pol.budget_bytes
                ):
                    self._stats.inc("rejected_budget")
                    self._stats.inc_tenant(tenant, "rejected")
                    sp.set(outcome="rejected_budget")
                    raise ServeRejected(
                        "tenant_budget",
                        f"tenant {tenant} live {self._accounts.charged(tenant)}B"
                        f" + reserve {reserve}B > budget {pol.budget_bytes}B",
                    )
                self._seq += 1
                ex = _Execution(key, dag, tenant, prio, self._seq)
                if tracer.enabled:
                    # the worker thread re-enters this scope so serve.run
                    # (and the dag's spans) land under the submit's trace
                    from ..obs import trace_carrier

                    ex.trace = trace_carrier()
                ex.waiters.append(sub)
                sub._execution = ex
                # WAL before the queue: an admission the client can see
                # must survive this process dying (the serve.journal
                # fault site sits exactly in that window)
                self._journal_admit(
                    sub, idempotency_key, tenant, prio, reserve, raw_dag
                )
                self._queue.append(ex)
                self._peak_queue = max(self._peak_queue, len(self._queue))
                if key is not None:
                    self._inflight[key] = ex
                self._subs[sub.id] = sub
                if idempotency_key is not None:
                    self._idem[idempotency_key] = sub.id
                self._stats.inc("admitted")
                self._cv.notify()
            sp.set(
                outcome="admitted",
                id=sub.id,
                priority=prio,
                key=(key or "")[:12],
                queue_depth=len(self._queue),
            )
            return sub

    def get(self, submission_id: str) -> Optional[Submission]:
        with self._lock:
            return self._subs.get(submission_id)

    # -- internals -----------------------------------------------------------
    def _journal_admit(
        self,
        sub: Submission,
        idem: Optional[str],
        tenant: str,
        prio: int,
        reserve: int,
        dag: Any,
    ) -> None:
        """WAL append + the ``serve.journal`` fault site (between the
        fsync'd append and the submission becoming admitted)."""
        if self._journal is not None:
            self._journal.admit(sub.id, idem, tenant, prio, reserve, dag)
            self._stats.inc("journal_appends")
        self._injector.fire(SITE_SERVE_JOURNAL)

    def _admit_fleet_hit(
        self,
        key: str,
        tenant: str,
        prio: int,
        reserve: int,
        idem: Optional[str],
        pol: TenantPolicy,
        sp: Any,
    ) -> Optional[Submission]:
        """Serve a submission from another replica's published result
        (or this one's, from a previous life). None = no artifact, take
        the normal admission path."""
        payload = self._fleet.lookup(key)
        if payload is None:
            return None
        try:
            result = self._rehydrate(payload)
        except Exception:
            # an unloadable payload is a miss, never a wedge
            return None
        sub = Submission(self, None, tenant, prio, deduped=True)  # type: ignore[arg-type]
        with self._cv:
            if not self._running:
                raise ServeRejected("server_stopped")
            if not self._accounts.try_charge(tenant, sub.id, reserve, pol.budget_bytes):
                self._stats.inc("rejected_budget")
                self._stats.inc_tenant(tenant, "rejected")
                sp.set(outcome="rejected_budget")
                raise ServeRejected(
                    "tenant_budget",
                    f"tenant {tenant} live {self._accounts.charged(tenant)}B"
                    f" + reserve {reserve}B > budget {pol.budget_bytes}B",
                )
            self._seq += 1
            ex = _Execution(key, None, tenant, prio, self._seq)
            now = time.monotonic()
            ex.started_at = now
            ex.finished_at = now
            ex.state = "done"
            ex.result = result
            ex.waiters.append(sub)
            sub._execution = ex
            self._subs[sub.id] = sub
            if idem is not None:
                self._idem[idem] = sub.id
        measured = _result_bytes(result)
        self._accounts.restate(tenant, sub.id, measured)
        self._stats.inc_tenant(tenant, "completed")
        self._stats.inc_tenant(tenant, "dedup_hits")
        ex.done.set()
        sub._event.set()
        self._retire([sub])
        sp.set(outcome="fleet_hit", id=sub.id, key=key[:12])
        return sub

    def _rehydrate(self, payload: Dict[str, Any]) -> FleetResult:
        """``{name: (pandas, schema_str)}`` → engine frames wrapped in a
        result the waiters (and /serve/result) can read like any other."""
        yields: Dict[str, Any] = {}
        for name, item in payload.items():
            pdf, schema = item
            df = self._engine.to_df(pdf, schema=schema) if schema else (
                self._engine.to_df(pdf)
            )
            yields[name] = df
        return FleetResult(yields)

    @staticmethod
    def _extract_frames(result: Any) -> Optional[Dict[str, Any]]:
        """A publishable ``{name: (pandas, schema_str)}`` of the run's
        yields, or None when any frame can't cross a process boundary
        (unbounded/stream/device-laid-out) — then nothing publishes."""
        frames: Dict[str, Any] = {}
        try:
            for name, y in (result.yields if result is not None else {}).items():
                df = getattr(y, "result", None)
                if df is None or not getattr(df, "is_bounded", False):
                    return None
                frames[name] = (df.as_pandas(), str(df.schema))
        except Exception:
            return None
        return frames
    def _policy(self, tenant: str) -> TenantPolicy:
        with self._lock:
            pol = self._policies.get(tenant)
            if pol is not None:
                self._policies.move_to_end(tenant)
        if pol is None:
            pol = tenant_policy(self._engine.conf, tenant)
            warn = False
            with self._lock:
                if pol.dropped_keys and tenant not in self._overlay_warned:
                    warn = True
                    self._overlay_warned[tenant] = True
                    self._overlay_warned.move_to_end(tenant)
                    while len(self._overlay_warned) > self.max_tenants:
                        self._overlay_warned.popitem(last=False)
                self._policies[tenant] = pol
                self._policies.move_to_end(tenant)
                # LRU-bounded like the retention ring: client-supplied
                # tenant ids must rotate state, never grow it
                while len(self._policies) > self.max_tenants:
                    self._policies.popitem(last=False)
            if warn:
                self._engine.log.warning(
                    "tenant %s conf overlay keys %s dropped: overlays are "
                    "run-scoped fugue.tpu.* keys only; keys outside "
                    "fugue.tpu.* change workflow/compile semantics and "
                    "are refused",
                    tenant,
                    list(pol.dropped_keys),
                )
        return pol

    def _pick_locked(self) -> Optional[_Execution]:
        """Lowest effective (priority − levels aged), FIFO within — an
        O(n) scan over a bounded queue; deterministic by seq."""
        if not self._queue:
            return None
        now = time.monotonic()

        def eff(ex: _Execution) -> Any:
            aged = (
                int((now - ex.submitted_at) / self.aging_s)
                if self.aging_s > 0
                else 0
            )
            return (ex.priority - aged, ex.seq)

        best = min(self._queue, key=eff)
        self._queue.remove(best)
        return best

    def _worker(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._queue:
                    self._cv.wait(timeout=0.5)
                if not self._running:
                    return
                ex = self._pick_locked()
                if ex is None:
                    continue
                ex.started = True
                ex.started_at = time.monotonic()
                ex.state = "running"
                self._active += 1
            try:
                self._run_execution(ex)
            finally:
                with self._cv:
                    self._active -= 1

    def _run_execution(self, ex: _Execution) -> None:
        from ..obs import get_tracer

        tracer = get_tracer()
        wait_s = (ex.started_at or ex.submitted_at) - ex.submitted_at
        self._stats.inc("executions")
        # tenant attribution: the run's span-histogram samples (and every
        # thread the run forks — contexts propagate) carry tenant=<id>;
        # workflow.run's own run_labels nests inside and overlays its
        # workflow/run ids, keeping this tenant label
        labels: Any = nullcontext()
        tctx: Any = nullcontext()
        if tracer.enabled:
            from ..obs import run_labels

            labels = run_labels(tenant=ex.tenant)
            if ex.trace:
                # re-enter the submission's trace on this worker thread:
                # serve.run (and everything the dag forks) attaches under
                # the submitting client's trace id, not a fresh root
                from ..obs import trace_scope

                tctx = trace_scope(ex.trace.get("trace"), ex.trace.get("parent"))
        fleet_owner = False
        with tctx:  # fleet claims/events below carry the submit's trace too
            try:
                # cross-replica single-flight (docs/serving.md "Fleet"): claim
                # the key in the shared store, or serve the owner's published
                # result instead of re-executing. acquire() is bounded by the
                # holder's lease — a dead owner's claim is stolen, never waited
                # on forever.
                if self._fleet is not None and ex.key is not None:
                    role, payload = self._fleet.acquire(ex.key)
                    if role == "result":
                        ex.result = self._rehydrate(payload)
                        ex.finished_at = time.monotonic()
                        ex.state = "done"
                    else:
                        fleet_owner = True
                        # between claim write and execution start — the chaos
                        # tests' deterministic crash point; an injected error
                        # here unwinds through the release below
                        self._injector.fire(SITE_SERVE_CLAIM)
                if ex.state != "done":
                    if self._journal is not None:
                        # the no-double-execution audit reads these: one exec
                        # record per dag actually run on this replica
                        self._journal.exec_start(
                            ex.waiters[0].id if ex.waiters else "", ex.key
                        )
                        self._stats.inc("journal_appends")
                    with labels, tracer.span(
                        "serve.run",
                        cat="serve",
                        tenant=ex.tenant,
                        priority=ex.priority,
                        waiters=len(ex.waiters),
                        queue_wait_s=round(wait_s, 6),
                    ):
                        result = ex.dag.run(self._engine)
                    ex.result = result
                    ex.finished_at = time.monotonic()
                    ex.state = "done"
                    if fleet_owner:
                        frames = self._extract_frames(result)
                        if frames is not None:
                            # publish releases the claim; waiters fleet-wide
                            # load this artifact instead of executing
                            self._fleet.publish_result(ex.key, frames)
                        else:
                            self._fleet.release(ex.key)
            except BaseException as e:  # the waiter gets the error, not the worker
                ex.error = e
                # the traceback keeps its lines, not the run's locals (the
                # dag and its frames), while the submission is retained
                traceback.clear_frames(e.__traceback__)
                ex.finished_at = time.monotonic()
                ex.state = "failed"
                if fleet_owner:
                    # no error tombstones: a failed owner releases the claim
                    # so a cross-replica waiter re-decides (executes) rather
                    # than caching a failure fleet-wide
                    self._fleet.release(ex.key)
            finally:
                # a retained submission keeps only its result: the dag's
                # context holds every intermediate frame of the run (on the
                # card, the LOAD frame too), which no tenant budget charges
                ex.dag = None
        if ex.state == "done":
            self._stats.inc("completed")
        else:
            self._stats.inc("failed")
        measured = _result_bytes(ex.result) if ex.state == "done" else 0
        rows = _result_rows(ex.result) if ex.state == "done" else 0
        run_s = (ex.finished_at or 0.0) - (ex.started_at or 0.0)
        with self._lock:
            if ex.key is not None and self._inflight.get(ex.key) is ex:
                del self._inflight[ex.key]
            waiters = list(ex.waiters)
        for sub in waiters:
            t = sub.tenant
            self._stats.inc_tenant(t, "completed" if ex.state == "done" else "failed")
            self._stats.inc_tenant(t, "queue_wait_s", wait_s)
            self._stats.inc_tenant(t, "run_s", run_s)
            if rows:
                self._stats.inc_tenant(t, "rows_out", rows)
            # live accounting: the reserve becomes the measured bytes the
            # tenant now holds on the server (released when claimed)
            self._accounts.restate(t, sub.id, measured)
            if self._journal is not None:
                self._journal.done(sub.id, ex.state)
                self._stats.inc("journal_appends")
        self._finish_waiters(ex)
        self._retire(waiters)
        self._maybe_publish_spool()

    def _maybe_publish_spool(self) -> None:
        """Cumulative, idempotent span export (obs/spool.py): last write
        wins, so publishing after every execution is safe and cheap."""
        if not self._spool_dir:
            return
        from ..obs import get_tracer

        if not get_tracer().enabled:
            return
        from ..obs.spool import publish_spool

        try:
            publish_spool(self._spool_dir, label=f"replica {self.replica_id}")
        except Exception as ex:
            self._engine.log.warning("trace spool publish failed: %s", ex)

    def _finish_waiters(self, ex: _Execution) -> None:
        ex.done.set()
        with self._lock:
            waiters = list(ex.waiters)
        for sub in waiters:
            sub._event.set()

    def _retire(self, finished: List[Submission]) -> None:
        """Retention ring: keep the last ``serve.retain`` finished
        submissions addressable (RPC result pickup); evicted ones release
        their tenant charge."""
        with self._lock:
            self._done_order.extend(s.id for s in finished)
            evicted: List[Submission] = []
            while len(self._done_order) > self.retain:
                sid = self._done_order.pop(0)
                sub = self._subs.pop(sid, None)
                if sub is not None:
                    evicted.append(sub)
            if evicted:
                gone = {s.id for s in evicted}
                self._idem = {
                    k: v for k, v in self._idem.items() if v not in gone
                }
        for sub in evicted:
            self._accounts.release(sub.tenant, sub.id)
            self._stats.inc("retained_evictions")

    def _cancel(self, sub: Submission) -> bool:
        with self._cv:
            if sub._canceled or sub._execution.state in ("done", "failed"):
                return False
            sub._canceled = True
            ex = sub._execution
            if sub in ex.waiters:
                ex.waiters.remove(sub)
            self._stats.inc("canceled")
            if not ex.waiters and not ex.started and ex in self._queue:
                # the last waiter left a not-yet-started execution: the
                # work is no longer wanted by anyone — drop it
                self._queue.remove(ex)
                ex.state = "canceled"
                ex.dag = None
                if ex.key is not None and self._inflight.get(ex.key) is ex:
                    del self._inflight[ex.key]
                self._stats.inc("canceled_executions")
        self._accounts.release(sub.tenant, sub.id)
        if self._journal is not None:
            self._journal.done(sub.id, "canceled")
        sub._event.set()
        return True

    # -- observability -------------------------------------------------------
    def _register_probes(self) -> None:
        """Queue-depth / active-run gauges on the global resource sampler
        (weakly bound — a collected server's probes remove themselves)."""
        import weakref

        from ..obs import get_sampler
        from ..obs.sampler import ProbeGone

        ref = weakref.ref(self)

        def _probe(attr: str):
            def fn() -> float:
                s = ref()
                if s is None:
                    raise ProbeGone()
                return float(getattr(s, attr))

            return fn

        sampler = get_sampler()
        sampler.register_probe("serve_queue_depth", _probe("queue_depth"))
        sampler.register_probe("serve_active_runs", _probe("active_runs"))

    def stats(self) -> Dict[str, Any]:
        """Counters plus live gauges — what ``/readyz`` and the bench
        load driver read."""
        out = self._stats.as_dict()
        with self._lock:
            out.update(
                queue_depth=len(self._queue),
                queue_capacity=self.queue_capacity,
                peak_queue_depth=self._peak_queue,
                active_runs=self._active,
                max_concurrent=self.max_concurrent,
                inflight_keys=len(self._inflight),
                retained=len(self._done_order),
                replica_id=self.replica_id,
                fleet_enabled=self._fleet is not None,
                journal_enabled=self._journal is not None,
                journal_compactions=(
                    self._journal.compactions if self._journal is not None else 0
                ),
                heartbeat_enabled=self._heartbeat is not None,
            )
        out["charged_bytes"] = self._accounts.as_dict()
        # adaptive-execution convergence at a glance (docs/tuning.md): the
        # long-lived server is exactly where cross-submission learning
        # pays off, so surface the tuner's counters next to the serving
        # gauges (full decisions stay in engine.stats()["tuning"])
        try:
            t = self._engine.tuner.as_dict()
            out["tuning"] = {
                k: t.get(k, 0)
                for k in ("decisions", "adaptive", "static", "converged", "entries")
            }
        except Exception:
            pass
        return out


class _FleetRollup:
    """``engine.stats()["fleet"]`` — the cross-replica view: the
    ``fleet_*`` counters sliced out of :class:`~fugue_tpu_torch.serve.stats.ServeStats`
    (renamed without the prefix) plus live store gauges. Weakly bound so
    a collected server unregisters itself in effect; ``reset()`` is a
    no-op because the underlying counters already reset with the
    ``serve`` source (one reset, not two)."""

    def __init__(self, server: "EngineServer"):
        import weakref

        self._ref = weakref.ref(server)

    def as_dict(self) -> Dict[str, Any]:
        srv = self._ref()
        if srv is None or srv._fleet is None:
            return {}
        st = srv._stats.as_dict()
        out: Dict[str, Any] = {
            k[len("fleet_"):]: v
            for k, v in st.items()
            if k.startswith("fleet_") and isinstance(v, (int, float))
        }
        out["replica_id"] = srv.replica_id
        try:
            out["results_cached"] = sum(
                1
                for n in os.listdir(srv._fleet.results_dir)
                if n.endswith(".result.pkl")
            )
        except OSError:
            out["results_cached"] = 0
        return out

    def reset(self) -> None:
        pass


def _result_bytes(result: Any) -> int:
    """Measured live bytes of a run's yielded frames (best effort)."""
    from ..cache.store import estimate_df_bytes

    total = 0
    try:
        for y in (result.yields if result is not None else {}).values():
            df = getattr(y, "result", None)
            if df is not None:
                total += estimate_df_bytes(df)
    except Exception:
        pass
    return total


def _result_rows(result: Any) -> int:
    total = 0
    try:
        for y in (result.yields if result is not None else {}).values():
            df = getattr(y, "result", None)
            if df is not None and getattr(df, "is_bounded", False):
                total += int(df.count())
    except Exception:
        pass
    return total
