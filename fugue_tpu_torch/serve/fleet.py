"""Fleet coordination: cross-replica single-flight and a failover client.

One :class:`~fugue_tpu_torch.serve.EngineServer` serves one process; many
users need a replicated tier where any single process can
die mid-run without losing or double-executing a submission. Two pieces
live here (docs/serving.md "Fleet"):

:class:`FleetCoordinator` — replicas sharing a disk store directory
(``fugue.tpu.cache.dir``) collapse identical submissions ACROSS servers.
Before executing a fingerprintable plan, a replica claims its key in the
shared store (``ArtifactStore.try_claim`` — atomic ``O_CREAT|O_EXCL``
create, lease expiry + same-host dead-pid detection make a dead owner's
claim stealable). The claim owner executes and publishes the yielded
frames (host pandas + schema, atomic temp-write+rename like every other
store publish); every other replica's waiter polls and serves the
published artifact instead of re-executing. Published results double as
a cluster-wide serve-result cache: a later identical submission on ANY
replica is answered from the store without queueing.

:class:`FleetClient` — the balancer side: reads ``/readyz`` (queue
depth / budget / store health) from every replica, places each
submission on the least-loaded accepting one, sheds on fleet-wide 503,
and — holding the submission payload and an idempotency key — fails a
dead replica's in-flight submissions over to a survivor under the SAME
key. Combined with the claim protocol and each replica's submission
journal (:mod:`~fugue_tpu_torch.serve.journal`), the observable effect is
exactly-once even though execution is at-least-once.

Exactly-once caveats, stated plainly: a LIVE owner that outruns its
lease can be raced by a stealer — both executions are the same
deterministic plan over the same bytes, so the published artifact is
bit-identical whichever wins the atomic rename (set
``fugue.tpu.serve.fleet.lease_s`` above your slowest plan to avoid the
wasted work). Output sinks (``show``/``save``) run once per *executing*
replica, not once per fleet — unfingerprintable plans never enter the
protocol at all and always execute locally.
"""

import os
import threading
import time
import uuid as _uuid
from typing import Any, Dict, List, Optional, Tuple

from ..workflow._checkpoint import _atomic_publish, _best_effort_remove

__all__ = [
    "FleetCoordinator",
    "FleetClient",
    "FleetSubmission",
    "FleetResult",
    "view_result_key",
    "parse_view_result_name",
]

# continuous views (docs/views.md) publish each generation under this
# grammar; "--" is banned in view ids so the name parses unambiguously
_VIEW_RESULT_PREFIX = "view--"
_RESULT_SUFFIX = ".result.pkl"


def view_result_key(view_id: str, generation: int) -> str:
    """Fleet result-store key of one view generation."""
    return f"{_VIEW_RESULT_PREFIX}{view_id}--g{int(generation):08d}"


def parse_view_result_name(name: str) -> Optional[Tuple[str, int]]:
    """``(view_id, generation)`` from a results-dir filename, or None
    for an ordinary request-scoped result."""
    if not name.startswith(_VIEW_RESULT_PREFIX) or not name.endswith(
        _RESULT_SUFFIX
    ):
        return None
    stem = name[len(_VIEW_RESULT_PREFIX): -len(_RESULT_SUFFIX)]
    vid, sep, g = stem.rpartition("--g")
    if not sep or not vid or not g.isdigit():
        return None
    return vid, int(g)


class FleetResult:
    """A rehydrated cross-replica result: duck-types the slice of
    ``FugueWorkflowResult`` the serving layer reads (``.yields`` of
    objects carrying ``.result`` frames)."""

    class _Yield:
        __slots__ = ("result",)

        def __init__(self, df: Any):
            self.result = df

    def __init__(self, yields: Dict[str, Any]):
        self.yields = {k: FleetResult._Yield(df) for k, df in yields.items()}


class FleetCoordinator:
    """Cross-replica single-flight + result cache over a shared store."""

    def __init__(
        self,
        store: Any,
        replica_id: str,
        lease_s: float = 30.0,
        poll_s: float = 0.05,
        max_results: int = 256,
        stats: Any = None,
        injector: Any = None,
        log: Any = None,
    ):
        self.store = store
        self.replica_id = replica_id
        self.lease_s = float(lease_s)
        self.poll_s = max(0.005, float(poll_s))
        self.max_results = int(max_results)
        self.results_dir = os.path.join(store.root, "serve")
        self._stats = stats
        self._injector = injector
        self._log = log
        os.makedirs(self.results_dir, exist_ok=True)

    def _inc(self, name: str, n: int = 1) -> None:
        if self._stats is not None:
            self._stats.inc(name, n)

    def _result_path(self, key: str) -> str:
        return os.path.join(self.results_dir, key + ".result.pkl")

    # -- the result artifact -------------------------------------------------
    def load_result(self, key: str) -> Optional[Dict[str, Any]]:
        """The published ``{yield_name: (pandas, schema_str)}`` payload,
        or None. Torn/corrupt payloads are deleted and read as absent —
        a miss re-executes; it can never serve wrong bytes."""
        path = self._result_path(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        except OSError:
            return None
        try:
            import cloudpickle

            payload = cloudpickle.loads(blob)
            os.utime(path, None)  # LRU touch
            return payload
        except Exception:
            _best_effort_remove(path)
            return None

    def publish_result(self, key: str, frames: Dict[str, Any]) -> bool:
        """Atomically publish the claim owner's yielded frames and
        release the claim. Racing publishers of the same key write
        identical content by construction; the last rename wins whole."""
        import cloudpickle

        final = self._result_path(key)
        tmp = f"{final}.__tmp_{_uuid.uuid4().hex}"
        try:
            with open(tmp, "wb") as f:
                f.write(cloudpickle.dumps(frames))
            _atomic_publish(tmp, final)
        except Exception as ex:
            _best_effort_remove(tmp)
            if self._log is not None:
                self._log.warning(
                    "fleet: result publish of %s failed: %s", key[:12], ex
                )
            self.release(key)
            return False
        self._inc("fleet_publishes")
        self._evict_results()
        self.release(key)
        return True

    def release(self, key: str) -> None:
        self.store.release_claim(key, self.replica_id)

    def remove_result(self, key: str) -> bool:
        """Delete one published payload (the views maintainer retires
        superseded generations through this). True if a file went away."""
        path = self._result_path(key)
        existed = os.path.exists(path)
        _best_effort_remove(path)
        return existed and not os.path.exists(path)

    def _evict_results(self) -> None:
        """mtime-LRU count cap, the ArtifactStore eviction discipline.

        Standing views are NOT request-scoped (small fix): the
        latest generation per view is pinned — it must stay servable for
        ``GET /serve/view/<id>`` until a newer generation supersedes it,
        however much interactive traffic churns the LRU. Pinned files
        are excluded from both the count and the eviction; superseded
        generations age out like any request result (and the maintainer
        retires them proactively)."""
        if self.max_results <= 0:
            return
        try:
            names = [
                n for n in os.listdir(self.results_dir)
                if n.endswith(_RESULT_SUFFIX)
            ]
        except OSError:
            return
        latest_gen: Dict[str, int] = {}
        for n in names:
            parsed = parse_view_result_name(n)
            if parsed is not None:
                vid, gen = parsed
                latest_gen[vid] = max(gen, latest_gen.get(vid, 0))
        evictable = [
            n for n in names
            if (
                (p := parse_view_result_name(n)) is None
                or p[1] < latest_gen.get(p[0], 0)
            )
        ]
        if len(evictable) <= self.max_results:
            return
        entries = []
        for n in evictable:
            p = os.path.join(self.results_dir, n)
            try:
                entries.append((os.stat(p).st_mtime, p))
            except OSError:
                continue
        entries.sort()
        for _mt, p in entries[: max(0, len(entries) - self.max_results)]:
            _best_effort_remove(p)

    # -- the single-flight protocol ------------------------------------------
    def acquire(self, key: str) -> Tuple[str, Optional[Dict[str, Any]]]:
        """Block until this replica either owns the claim for ``key``
        (``("owner", None)`` — caller executes and must publish or
        release) or another replica's published result is servable
        (``("result", payload)``). Bounded by the holder's lease: a dead
        owner's claim is stolen at latest ``lease_s`` after its last
        write, so the wait can't wedge."""
        stole = False
        while True:
            payload = self.load_result(key)
            if payload is not None:
                self._inc("fleet_result_hits")
                return "result", payload
            holder = self.store.read_claim(key)
            owned, _cur = self.store.try_claim(key, self.replica_id, self.lease_s)
            if owned:
                # the owner may have published between our result check
                # and the claim write — serve it rather than re-run
                payload = self.load_result(key)
                if payload is not None:
                    self.release(key)
                    self._inc("fleet_result_hits")
                    return "result", payload
                stole = holder is not None and holder.get("owner") not in (
                    None,
                    self.replica_id,
                )
                self._inc("fleet_claims")
                if stole:
                    self._inc("fleet_claim_steals")
                    # flight recorder: a stolen claim is a
                    # recovery-ladder event — the prior owner died (or
                    # outran its lease) mid-execution
                    from ..obs.events import get_event_log

                    get_event_log().emit(
                        "fleet.claim_steal",
                        key=key[:12],
                        owner=self.replica_id,
                        prev_owner=(holder or {}).get("owner"),
                    )
                # the serve.claim fault site fires in the CALLER, after it
                # has recorded ownership — a fault between claim write and
                # execution start must still release the claim on unwind
                return "owner", None
            self._inc("fleet_waits")
            time.sleep(self.poll_s)

    def lookup(self, key: str) -> Optional[Dict[str, Any]]:
        """Non-blocking: the published result if present (the submit-time
        fast path — a warm fleet answers without queueing)."""
        payload = self.load_result(key)
        if payload is not None:
            self._inc("fleet_result_hits")
        return payload


class FleetSubmission:
    """A client-side handle: which replica holds the submission, plus
    everything needed to replay it elsewhere under the same key."""

    def __init__(
        self, replica: int, sid: str, payload: Dict[str, Any], deduped: bool
    ):
        self.replica = replica
        self.sid = sid
        self.payload = payload
        self.deduped = deduped
        self.failovers = 0

    @property
    def idempotency_key(self) -> str:
        return self.payload["idempotency_key"]


class FleetClient:
    """Least-loaded placement + idempotent failover over N replicas.

    ``replicas`` is a list of ``(host, port)`` pairs (or prebuilt
    :class:`~fugue_tpu_torch.serve.ServeHttpClient` objects). Every submission
    carries an idempotency key (one is minted when the caller brings
    none) so a replay onto ANY replica — after a crash, a timeout, or a
    retry — maps onto one observable submission.
    """

    # the worker_lost taxonomy: ServeWorkerLost (a replica
    # dead or stateless post-admit — WorkerLostError, retryable) and raw
    # transport failures trigger failover; a workflow's own error
    # (rehydrated from the result payload) never does — re-running a
    # deterministically failing plan elsewhere just fails again, and
    # would re-run its side effects. KeyError stays for pre-taxonomy
    # callers' unknown-id shape.
    from ..resilience import WorkerLostError as _WL

    _FAILOVER_ERRORS = (ConnectionError, OSError, KeyError, _WL)

    def __init__(
        self,
        replicas: List[Any],
        connect_timeout: float = 5.0,
        read_timeout: float = 60.0,
    ):
        from .client import ServeHttpClient

        self._clients: List[Any] = [
            r
            if isinstance(r, ServeHttpClient)
            else ServeHttpClient(
                r[0], r[1], connect_timeout=connect_timeout, read_timeout=read_timeout
            )
            for r in replicas
        ]
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}

    def _inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    @property
    def replicas(self) -> int:
        return len(self._clients)

    # -- federated metrics --------------------------------------------------
    def federated_span_metrics(self) -> Tuple[Any, List[Optional[str]]]:
        """Merge every reachable replica's ``/metrics/snapshot`` into one
        fresh :class:`~fugue_tpu_torch.obs.metrics.SpanMetrics`. The encoding is
        associative and commutative, so the merged histogram's per-series
        count equals the SUM of the per-replica counts exactly — nothing
        is estimated. Returns ``(merged, replica_ids)`` (a None replica id
        means the process served metrics without a serve front end)."""
        from ..obs.metrics import SpanMetrics

        merged = SpanMetrics()
        replicas: List[Optional[str]] = []
        for cl in self._clients:
            try:
                snap = cl.metrics_snapshot()
            except Exception:
                self._inc("metrics_unreachable")
                continue
            merged.merge(snap.get("spans") or {})
            replicas.append(snap.get("replica"))
        self._inc("metrics_federations")
        return merged, replicas

    def federated_metrics(self) -> str:
        """ONE fleet-level Prometheus text exposition: per-replica span
        histograms merged via :meth:`federated_span_metrics` and rendered
        through the same ``to_prometheus_text`` the per-replica
        ``/metrics`` route uses — scrape one page for the whole fleet."""
        from ..obs.prom import to_prometheus_text

        merged, _replicas = self.federated_span_metrics()
        return to_prometheus_text(span_metrics=merged)

    # -- placement -----------------------------------------------------------
    def readyz_all(self) -> List[Optional[Dict[str, Any]]]:
        """One ``/readyz`` snapshot per replica; None = unreachable."""
        out: List[Optional[Dict[str, Any]]] = []
        for cl in self._clients:
            try:
                out.append(cl.readyz())
            except Exception:
                out.append(None)
        return out

    @staticmethod
    def _placeable(rz: Optional[Dict[str, Any]]) -> bool:
        if rz is None or not rz.get("accepting", False):
            return False
        if rz.get("status") == "store_unwritable":
            # drain: a replica whose shared disk died must not take new
            # work it can neither journal nor publish
            return False
        return rz.get("queue_free", 0) > 0 or rz.get("status") == "ready"

    def _candidates(self) -> List[int]:
        """Replica indexes ordered least-loaded first (queue depth +
        active runs, ties by index for determinism)."""
        snaps = self.readyz_all()
        scored = [
            (rz.get("queue_depth", 0) + rz.get("active_runs", 0), i)
            for i, rz in enumerate(snaps)
            if self._placeable(rz)
        ]
        scored.sort()
        return [i for _s, i in scored]

    # -- the session API -----------------------------------------------------
    def submit(
        self,
        dag: Any,
        tenant: str = "default",
        priority: Optional[int] = None,
        idempotency_key: Optional[str] = None,
        reserve_bytes: Optional[int] = None,
    ) -> FleetSubmission:
        """Place one submission on the least-loaded accepting replica.
        Raises :class:`~fugue_tpu_torch.serve.ServeRejected` with reason
        ``fleet_unavailable`` when no replica can take it (the
        fleet-wide shed)."""
        from .server import ServeRejected

        payload = {
            "dag": dag,
            "tenant": tenant,
            "priority": priority,
            "idempotency_key": idempotency_key or "fleet-" + _uuid.uuid4().hex,
            "reserve_bytes": reserve_bytes,
        }
        candidates = self._candidates()
        last: Optional[BaseException] = None
        for idx in candidates:
            try:
                sub = self._clients[idx].submit(**payload)
                self._inc("submitted")
                return FleetSubmission(
                    idx, sub["id"], payload, bool(sub.get("deduped"))
                )
            except ServeRejected as ex:
                last = ex  # overloaded between snapshot and submit: next
            except self._FAILOVER_ERRORS as ex:
                last = ex
                self._inc("submit_failovers")
        self._inc("shed")
        raise ServeRejected(
            "fleet_unavailable",
            f"no replica of {len(self._clients)} accepted"
            + (f" (last: {type(last).__name__}: {last})" if last else ""),
        )

    def result(
        self, sub: FleetSubmission, timeout: Optional[float] = None
    ) -> Dict[str, Any]:
        """Block for the submission's frames, failing over to a survivor
        (same idempotency key, same payload) when its replica dies. The
        replica-side journal + claim protocol make the replay a dedup
        hit whenever the original execution published."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (
                None if deadline is None else max(0.05, deadline - time.monotonic())
            )
            try:
                return self._clients[sub.replica].result(sub.sid, timeout=remaining)
            except TimeoutError:
                raise
            except self._FAILOVER_ERRORS:
                self._failover(sub, deadline)

    def _failover(self, sub: FleetSubmission, deadline: Optional[float]) -> None:
        """Re-place ``sub`` on a surviving replica under the SAME
        idempotency key; mutates the handle in place."""
        from .server import ServeRejected

        failed = sub.replica
        while True:
            # prefer survivors; the replica that just failed us is a last
            # resort (it may have restarted and replayed its journal)
            cand = self._candidates()
            cand = [i for i in cand if i != failed] + [i for i in cand if i == failed]
            for idx in cand:
                try:
                    re = self._clients[idx].submit(**sub.payload)
                    sub.replica = idx
                    sub.sid = re["id"]
                    sub.failovers += 1
                    self._inc("failovers")
                    from ..obs.events import get_event_log

                    get_event_log().emit(
                        "fleet.failover",
                        key=sub.idempotency_key[:24],
                        from_replica=failed,
                        to_replica=idx,
                    )
                    return
                except (ServeRejected, *self._FAILOVER_ERRORS):
                    continue
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"failover of {sub.idempotency_key} found no live replica"
                )
            time.sleep(0.1)
