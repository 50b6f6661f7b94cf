"""HTTP RPC server, copied from ``fugue_tpu/rpc/http.py``: worker→driver
callbacks over the network, and the engine's telemetry over HTTP.

A stdlib ``ThreadingHTTPServer``; payloads are cloudpickle over POST, as in
the JAX package. Conf keys:

- ``fugue.rpc.http_server.host`` (default 127.0.0.1)
- ``fugue.rpc.http_server.port`` (default 0 = ephemeral)
- ``fugue.rpc.http_server.timeout`` (legacy single client timeout seconds;
  still honoured as the read-timeout default)
- ``fugue.rpc.http_client.connect_timeout`` (default 5s)
- ``fugue.rpc.http_client.read_timeout`` (default = legacy timeout, 30s)
- ``fugue.tpu.retry.rpc.attempts`` (+ ``fugue.tpu.retry.rpc.*`` backoff keys)

Every request is bounded: connect and read each have their own deadline,
so a driver that vanished mid-call cannot hang a worker.

Connections persist (HTTP/1.1, ``TCP_NODELAY`` at both ends): each client
thread keeps one open connection to the server and sends its calls over
it, where the JAX package's client connects once a call and its server
starts a thread a call. A connection the server dropped (it stopped, or
reset it) is seen before the next request is written, and replaced.

Retry semantics respect idempotency: a failure BEFORE the request is sent
(refused/unreachable/connect timeout) is always retried with backoff — the
server never saw it. A failure AFTER the request went out is only retried
when the client was built with ``idempotent=True``; blindly re-sending a
stateful callback could double-apply it.

The ``/serve/*``, view and ``/dist/fetch`` routes are copied whole. An
``EngineServer`` (``fugue_tpu_torch/serve``) binds the serve and view
routes with ``bind_serve``, and a ``DistWorker`` (``fugue_tpu_torch/dist``)
binds ``/dist/fetch`` with ``bind_dist`` to serve its shuffle fragments;
unbound, a route answers 404.
"""

import base64
import http.client
import json
import os
import select
import socket
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import cloudpickle

from ..resilience import (
    SITE_RPC_REQUEST,
    FaultInjector,
    NULL_INJECTOR,
    ResilienceStats,
    RetryPolicy,
    classify_failure,
)  # classify_failure also stamps /serve/poll's error_code
from .base import RPCClient, RPCServer

# cluster trace propagation: every hop ships the submitting
# run's trace id + the caller's innermost span id; the receiving process
# re-enters the context so its spans attach under the submitting run
TRACE_HEADER = "X-Fugue-Trace"
PARENT_HEADER = "X-Fugue-Parent"


def trace_headers() -> dict:
    """The outbound trace-context headers for the current caller (empty
    when no trace context is bound)."""
    from ..obs.tracer import trace_carrier

    c = trace_carrier()
    if not c:
        return {}
    out = {TRACE_HEADER: c["trace"]}
    if "parent" in c:
        out[PARENT_HEADER] = c["parent"]
    return out


def _scope_from_headers(headers: Any) -> Any:
    """A ``trace_scope`` bound from inbound request headers, or a no-op
    context when the request carries none."""
    trace = headers.get(TRACE_HEADER) if headers is not None else None
    if not trace:
        import contextlib

        return contextlib.nullcontext()
    from ..obs.tracer import trace_scope

    return trace_scope(str(trace), headers.get(PARENT_HEADER))


class HttpRPCClient(RPCClient):
    """Picklable client stub carrying only (host, port, key) + timeouts.

    The retry policy travels with the stub (it's plain data); the stats
    sink and fault injector do not — a forked/remote worker increments its
    own copies, and only driver-side counters are observable anyway.
    """

    def __init__(
        self,
        host: str,
        port: int,
        key: str,
        timeout: float = 30.0,
        connect_timeout: float = 5.0,
        policy: Optional[RetryPolicy] = None,
        idempotent: bool = False,
        stats: Optional[ResilienceStats] = None,
        injector: Optional[FaultInjector] = None,
    ):
        self._host = host
        self._port = port
        self._key = key
        self._timeout = timeout
        self._connect_timeout = connect_timeout
        self._policy = policy or RetryPolicy(max_attempts=1)
        self._idempotent = idempotent
        self._stats = stats
        self._injector = injector

        self._local = threading.local()

    def __getstate__(self) -> dict:
        # stats/injector hold locks & shared memory, and the connections
        # are this process's — strip them so the stub stays
        # cloudpickle-able into any worker
        state = dict(self.__dict__)
        state["_stats"] = None
        state["_injector"] = None
        del state["_local"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._local = threading.local()

    def _connection(self) -> Any:
        """This thread's open connection, or None. One the server dropped
        reads as ready (end of stream) while idle: it is closed here,
        before a request is written to it."""
        conn = getattr(self._local, "conn", None)
        if conn is not None and (conn.sock is None or select.select([conn.sock], [], [], 0)[0]):
            conn.close()
            conn = self._local.conn = None
        return conn

    def _invoke_once(self, payload: bytes) -> bytes:
        """One request; exceptions carry ``_fugue_request_sent`` so the
        retry loop can honour idempotency."""
        sent = False
        conn = self._connection()
        try:
            if conn is None:
                conn = http.client.HTTPConnection(
                    self._host, self._port, timeout=self._connect_timeout
                )
                self._local.conn = conn
                conn.connect()
                # connected: switch the socket to the (usually longer) read
                # deadline for the request/response exchange
                conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.sock.settimeout(self._timeout)
            sent = True
            headers = {"Content-Length": str(len(payload))}
            headers.update(trace_headers())
            conn.request(
                "POST",
                "/invoke",
                body=payload,
                headers=headers,
            )
            resp = conn.getresponse()
            body = resp.read()
            if resp.will_close:
                self._local.conn = None
                conn.close()
            if resp.status != 200:
                raise ConnectionError(f"RPC server returned HTTP {resp.status}")
            return body
        except Exception as ex:
            if conn is not None:
                self._local.conn = None
                conn.close()
            ex._fugue_request_sent = sent  # type: ignore[attr-defined]
            raise

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        from ..obs import get_tracer

        payload = base64.b64encode(cloudpickle.dumps((self._key, args, kwargs)))
        policy = self._policy
        attempts = 0
        with get_tracer().span(
            "rpc.invoke", cat="rpc", key=self._key, bytes_out=len(payload)
        ) as sp:
            while True:
                try:
                    (self._injector or NULL_INJECTOR).fire(SITE_RPC_REQUEST)
                    body = self._invoke_once(payload)
                    break
                except Exception as ex:
                    attempts += 1
                    sent = getattr(ex, "_fugue_request_sent", False)
                    retryable = (self._idempotent or not sent) and policy.should_retry(
                        classify_failure(ex), attempts
                    )
                    if not retryable:
                        sp.set(attempts=attempts)
                        raise
                    if self._stats is not None:
                        self._stats.inc("rpc.retries")
                    time.sleep(policy.delay(attempts, seed=self._key))
            sp.set(attempts=attempts + 1, bytes_in=len(body))
        ok, result = cloudpickle.loads(base64.b64decode(body))
        if not ok:
            raise result
        return result


class HttpRPCServer(RPCServer):
    """Stdlib HTTP RPC server, doubling as the engine's telemetry exposure
    surface and the serving layer's network front end: alongside the POST
    ``/invoke`` callback channel it serves

    - ``GET /metrics`` — Prometheus text exposition: labeled span-latency
      /rows/bytes histograms, resource-sampler gauges, and the bound
      engine's flattened counters (scrapeable while a run is in flight);
    - ``GET /healthz`` — liveness JSON (process up; NEVER load-aware —
      a load balancer must not restart a merely busy server);
    - ``GET /readyz`` — readiness: queue depth/capacity and active runs
      of a bound serving front end (``EngineServer``); answers 503
      with the same JSON shape when the admission queue is full, so
      traffic sheds at the balancer before the server rejects;
    - ``GET /stats`` — one JSON snapshot (engine registry + latency
      summary + sampler state + current run labels + serve stats);
    - ``POST /serve/submit``, ``GET /serve/poll``, ``GET /serve/result``,
      ``POST /serve/cancel`` — the remote session surface over a bound
      EngineServer (idempotency keys make submit
      safe under the retry policy);
    - ``POST /serve/register`` / ``POST /serve/unregister``,
      ``GET /serve/views``, ``GET /serve/view?id=`` (plus ``DELETE``) —
      the continuous-view surface; all answer
      a bare 404 when ``fugue.tpu.views.enabled`` is off, keeping the
      disabled-mode wire contract identical;
    - ``GET /dist/fetch?path=<rel>`` — the worker tier's shuffle-fragment
      channel: a bound dist worker (``DistWorker``) serves files from its OWN data
      dir (path-jailed) so another host's reduce task can pull this
      worker's bucket fragments without a shared filesystem.

    Bind an engine with :meth:`bind_engine` (the engine does this itself
    when it creates or is handed the server), a serving front end with
    :meth:`bind_serve`, and a dist worker with :meth:`bind_dist`;
    unbound, the global span metrics and sampler still serve and the
    serve/dist routes answer 404."""

    def __init__(self, conf: Any = None):
        super().__init__(conf)
        from ..constants import (
            FUGUE_RPC_CONF_HTTP_CONNECT_TIMEOUT,
            FUGUE_RPC_CONF_HTTP_READ_TIMEOUT,
        )

        self._host = self.conf.get("fugue.rpc.http_server.host", "127.0.0.1")
        self._port = int(self.conf.get("fugue.rpc.http_server.port", 0))
        # legacy single-timeout key remains the read-timeout default
        legacy = float(self.conf.get("fugue.rpc.http_server.timeout", 30.0))
        self._timeout = float(
            self.conf.get(FUGUE_RPC_CONF_HTTP_READ_TIMEOUT, legacy)
        )
        self._connect_timeout = float(
            self.conf.get(FUGUE_RPC_CONF_HTTP_CONNECT_TIMEOUT, 5.0)
        )
        self._client_policy = RetryPolicy.from_conf(
            self.conf, prefix="fugue.tpu.retry.rpc", default_attempts=3
        )
        self._stats = ResilienceStats()
        self._httpd: Any = None
        self._thread: Any = None
        self._conns: set = set()  # the open connections, closed when the server stops
        self._conns_lock = threading.Lock()
        self._engine_ref: Any = None
        self._serve_ref: Any = None
        self._dist_ref: Any = None
        self._started_at = time.time()

    # -- telemetry binding ---------------------------------------------------
    def bind_engine(self, engine: Any) -> None:
        """Point /metrics and /stats at ``engine``'s registry (held weakly
        — a collected engine silently unbinds)."""
        self._engine_ref = weakref.ref(engine)

    def bind_serve(self, server: Any) -> None:
        """Point the /serve/* routes and /readyz at a serving front end
        (an ``EngineServer``, held weakly)."""
        self._serve_ref = weakref.ref(server)

    def bind_dist(self, worker: Any) -> None:
        """Point /dist/fetch at a dist worker (held weakly) — anything
        with ``read_blob(rel) -> bytes|None``."""
        self._dist_ref = weakref.ref(worker)

    def _metrics_engine(self) -> Any:
        return self._engine_ref() if self._engine_ref is not None else None

    def _serve_server(self) -> Any:
        return self._serve_ref() if self._serve_ref is not None else None

    def _get_body(self, path: str, query: str = "") -> Optional[Any]:
        """Build (status, content_type, body_bytes) for a GET route, or
        None for an unknown path."""
        if path == "/healthz":
            # the LIVENESS contract: process up + uptime, nothing else —
            # never made load-aware (that's /readyz), or a busy-but-
            # healthy server would get restarted by its balancer
            payload = {
                "status": "ok",
                "pid": os.getpid(),
                "uptime_s": round(time.time() - self._started_at, 3),
            }
            return 200, "application/json", json.dumps(payload).encode()
        if path == "/readyz":
            return self._readyz()
        if path == "/metrics":
            from ..obs import to_prometheus_text

            text = to_prometheus_text(engine=self._metrics_engine())
            return 200, "text/plain; version=0.0.4; charset=utf-8", text.encode()
        if path == "/metrics/snapshot":
            # metrics federation: the machine-readable form —
            # this replica's span-histogram families in the mergeable
            # encoding. A FleetClient merges N of these associatively and
            # renders ONE fleet-level exposition (federated_metrics())
            from ..obs import get_span_metrics
            from ..obs.tracer import proc_ident

            srv = self._serve_server()
            payload = {
                "replica": getattr(srv, "replica_id", None),
                "proc": proc_ident(),
                "spans": get_span_metrics().snapshot(),
            }
            return 200, "application/json", json.dumps(payload).encode()
        if path == "/stats":
            from ..obs import active_run_labels, get_sampler, get_span_metrics

            eng = self._metrics_engine()
            srv = self._serve_server()
            # run labels are context-local to the run's own threads; from
            # the server thread report the scopes currently entered
            # anywhere in the process (most recent under the legacy key)
            active = active_run_labels()
            payload = {
                "engine": eng.stats() if eng is not None else None,
                "latency": get_span_metrics().summary(),
                "telemetry": get_sampler().as_dict(),
                "run_labels": active[-1] if active else {},
                "active_runs": active,
                "serve": srv.stats() if srv is not None else None,
            }
            return 200, "application/json", json.dumps(payload, default=str).encode()
        if path == "/serve/poll":
            return self._serve_poll(query)
        if path == "/serve/result":
            return self._serve_result(query)
        if path == "/serve/views":
            return self._serve_views()
        if path == "/serve/view":
            return self._serve_view(query)
        if path == "/dist/fetch":
            return self._dist_fetch(query)
        return None

    # -- dist worker routes -------------------------------------------------
    def _dist_fetch(self, query: str) -> Any:
        """Serve one shuffle fragment from the bound worker's data dir.
        404 covers everything the caller treats as "unavailable": no
        worker bound, missing file, or a path outside the jail — the
        consumer's orphan-recovery ladder takes it from there."""
        from urllib.parse import parse_qs

        from ..obs import get_tracer

        worker = self._dist_ref() if self._dist_ref is not None else None
        if worker is None:
            return 404, "application/json", b'{"error": "no dist worker bound"}'
        vals = parse_qs(query).get("path")
        rel = vals[0] if vals else ""
        with get_tracer().span("rpc.dist_fetch", cat="rpc", path=rel):
            blob = worker.read_blob(rel) if rel else None
        if blob is None:
            return (
                404,
                "application/json",
                json.dumps({"error": f"no fragment at {rel!r}"}).encode(),
            )
        return 200, "application/octet-stream", blob

    # -- serving routes -----------------------------------------------------
    def _readyz(self) -> Any:
        srv = self._serve_server()
        if srv is None:
            # no serving front end bound: readiness degrades to liveness
            payload = {"status": "ready", "serve_bound": False}
            return 200, "application/json", json.dumps(payload).encode()
        st = srv.stats()
        full = st["queue_depth"] >= st["queue_capacity"] or not srv.running
        # shared-store health: a replica whose cache
        # or journal disk died must be DRAINED by the balancer — it can
        # neither journal admissions nor publish fleet results — so it
        # answers 503 with its own status, distinct from "overloaded"
        health = srv.store_health()
        unwritable = not health.get("writable", True)
        status = (
            "store_unwritable"
            if unwritable
            else ("overloaded" if full else "ready")
        )
        payload = {
            "status": status,
            "serve_bound": True,
            "accepting": bool(srv.running),
            "queue_depth": st["queue_depth"],
            "queue_capacity": st["queue_capacity"],
            "queue_free": max(0, st["queue_capacity"] - st["queue_depth"]),
            "active_runs": st["active_runs"],
            "max_concurrent": st["max_concurrent"],
            "replica_id": st.get("replica_id"),
            "store": health,
        }
        views = getattr(srv, "views", None)
        if views is not None:
            # watcher-loop health: a dead maintainer loop is a
            # readiness fact — views it holds leases on go stale until
            # another replica steals them. Only present when views are on,
            # so the disabled-mode /readyz payload is unchanged.
            payload["views"] = views.health()
        # 503 on full/unwritable: the shape a load balancer sheds on —
        # BEFORE the admission queue starts rejecting sessions outright
        code = 503 if (full or unwritable) else 200
        return code, "application/json", json.dumps(payload).encode()

    @staticmethod
    def _query_id(query: str) -> Optional[str]:
        from urllib.parse import parse_qs

        vals = parse_qs(query).get("id")
        return vals[0] if vals else None

    def _serve_sub(self, query: str) -> Any:
        srv = self._serve_server()
        if srv is None:
            return None, (404, "application/json", b'{"error": "no serve bound"}')
        sid = self._query_id(query)
        sub = srv.get(sid) if sid else None
        if sub is None:
            return None, (
                404,
                "application/json",
                json.dumps({"error": f"unknown submission {sid!r}"}).encode(),
            )
        return sub, None

    def _sub_payload(self, sub: Any) -> dict:
        out = {
            "id": sub.id,
            "status": sub.status,
            "tenant": sub.tenant,
            "priority": sub.priority,
            "deduped": sub.deduped,
            "queue_wait_s": sub.queue_wait_s,
            "run_s": sub.run_s,
        }
        err = sub._execution.error if sub._execution is not None else None
        if sub.status == "failed" and err is not None:
            out["error"] = f"{type(err).__name__}: {err}"
            # the failure taxonomy travels with the error so a remote caller
            # can distinguish retryable (worker_lost/transient/timeout)
            # from fatal (poison) without parsing message strings
            out["error_code"] = classify_failure(err).value
        return out

    def _serve_poll(self, query: str) -> Any:
        sub, err = self._serve_sub(query)
        if err is not None:
            return err
        return 200, "application/json", json.dumps(self._sub_payload(sub)).encode()

    def _serve_result(self, query: str) -> Any:
        """The result channel: yielded frames as host pandas (cloudpickle
        over the wire — device frames are laid out for THIS process's
        mesh and never serialize). 202 + status JSON while pending."""
        sub, err = self._serve_sub(query)
        if err is not None:
            return err
        if sub.status in ("queued", "running"):
            return 202, "application/json", json.dumps(self._sub_payload(sub)).encode()
        try:
            # status is terminal but the waiter event is set a beat later
            # (the execution's finish path runs stats/publish first) —
            # a short bounded wait instead of timeout=0 absorbs the race
            res = sub.result(timeout=5)
            frames = {}
            for name, y in res.yields.items():
                df = getattr(y, "result", None)
                frames[name] = df.as_pandas() if df is not None else None
            body = (True, frames)
        except Exception as e:
            body = (False, e)
        made = (
            200,
            "application/octet-stream",
            base64.b64encode(cloudpickle.dumps(body)),
        )
        # staleness metadata: only when the views subsystem is on — with
        # it off the reply stays byte- and header-identical to the wire
        # contract without views
        if self._views_service() is not None:
            ex = sub._execution
            if ex is not None and ex.finished_at is not None:
                # finished_at is monotonic; rebase onto the wall clock
                as_of = time.time() - (time.monotonic() - ex.finished_at)
                made = made + (
                    {
                        "X-Fugue-As-Of": repr(round(as_of, 6)),
                        "X-Fugue-Staleness-S": repr(
                            round(max(0.0, time.time() - as_of), 6)
                        ),
                    },
                )
        return made

    # -- continuous-view routes ---------------------------------------------
    # Kill-switch contract: when ``fugue.tpu.views.enabled`` is off the
    # server has no ViewService, every handler below returns None, and the
    # caller answers a BARE 404 — byte-identical to an unknown route, so
    # the serve wire contract is unchanged with views disabled.
    def _views_service(self) -> Any:
        srv = self._serve_server()
        return getattr(srv, "views", None) if srv is not None else None

    def _serve_views(self) -> Any:
        vs = self._views_service()
        if vs is None:
            return None
        return 200, "application/json", json.dumps({"views": vs.list()}).encode()

    def _serve_view(self, query: str) -> Any:
        """One view's latest published generation: 202 + describe JSON
        before the first publish, else the frames as b64 cloudpickle with
        ``X-Fugue-As-Of`` / ``X-Fugue-Staleness-S`` / ``X-Fugue-Generation``
        response headers carrying the staleness metadata."""
        vs = self._views_service()
        if vs is None:
            return None
        vid = self._query_id(query)
        desc = vs.describe(vid) if vid else None
        if desc is None:
            return (
                404,
                "application/json",
                json.dumps({"error": f"unknown view {vid!r}"}).encode(),
            )
        res = vs.result(vid)
        if res is None:
            # registered but nothing published yet — poll like /serve/result
            return 202, "application/json", json.dumps(desc).encode()
        headers = {
            "X-Fugue-As-Of": repr(res["as_of"]),
            "X-Fugue-Staleness-S": repr(res["staleness_s"]),
            "X-Fugue-Generation": str(res["generation"]),
        }
        body = base64.b64encode(cloudpickle.dumps(res))
        return 200, "application/octet-stream", body, headers

    def _serve_register(self, raw: bytes) -> Any:
        vs = self._views_service()
        if vs is None:
            return None
        req = cloudpickle.loads(base64.b64decode(raw))
        try:
            desc = vs.register(
                str(req["id"]),
                req["factory"],
                str(req["source"]),
                fmt=str(req.get("format", "") or ""),
                tenant=str(req.get("tenant", "default")),
            )
        except ValueError as e:
            return 400, "application/json", json.dumps({"error": str(e)}).encode()
        return 200, "application/json", json.dumps(desc).encode()

    def _serve_unregister(self, raw: bytes) -> Any:
        vs = self._views_service()
        if vs is None:
            return None
        req = json.loads(raw.decode() or "{}")
        return self._unregister_reply(vs, str(req.get("id", "")))

    def _serve_view_delete(self, query: str) -> Any:
        # DELETE /serve/view?id=<id> — same semantics as /serve/unregister
        vs = self._views_service()
        if vs is None:
            return None
        return self._unregister_reply(vs, self._query_id(query) or "")

    @staticmethod
    def _unregister_reply(vs: Any, vid: str) -> Any:
        if not vid or not vs.unregister(vid):
            return (
                404,
                "application/json",
                json.dumps({"error": f"unknown view {vid!r}"}).encode(),
            )
        return 200, "application/json", json.dumps({"unregistered": vid}).encode()

    def _serve_submit(self, raw: bytes) -> Any:
        from ..serve import ServeRejected

        srv = self._serve_server()
        if srv is None:
            return 404, "application/json", b'{"error": "no serve bound"}'
        req = cloudpickle.loads(base64.b64decode(raw))
        try:
            sub = srv.submit(
                req["dag"],
                tenant=req.get("tenant", "default"),
                priority=req.get("priority"),
                idempotency_key=req.get("idempotency_key"),
                reserve_bytes=req.get("reserve_bytes"),
            )
        except ServeRejected as e:
            # 429-style shed: the reason travels; the client raises it
            payload = {"rejected": e.reason, "error": str(e)}
            return 429, "application/json", json.dumps(payload).encode()
        return 200, "application/json", json.dumps(self._sub_payload(sub)).encode()

    def _serve_cancel(self, raw: bytes) -> Any:
        srv = self._serve_server()
        if srv is None:
            return 404, "application/json", b'{"error": "no serve bound"}'
        req = json.loads(raw.decode() or "{}")
        sub = srv.get(str(req.get("id", "")))
        if sub is None:
            return (
                404,
                "application/json",
                json.dumps({"error": f"unknown submission {req.get('id')!r}"}).encode(),
            )
        changed = sub.cancel()
        payload = dict(self._sub_payload(sub), canceled=changed)
        return 200, "application/json", json.dumps(payload).encode()

    @property
    def host(self) -> str:
        return self._host

    @property
    def port(self) -> int:
        return self._port

    @property
    def resilience_stats(self) -> ResilienceStats:
        return self._stats

    def create_client(self, key: str) -> RPCClient:
        return HttpRPCClient(
            self._host,
            self._port,
            key,
            timeout=self._timeout,
            connect_timeout=self._connect_timeout,
            policy=self._client_policy,
            stats=self._stats,
            injector=FaultInjector.from_conf(self.conf),
        )

    def start_server(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def setup(self) -> None:
                super().setup()
                with server._conns_lock:
                    server._conns.add(self.connection)

            def finish(self) -> None:
                with server._conns_lock:
                    server._conns.discard(self.connection)
                super().finish()

            def _empty(self, status: int) -> None:
                self.send_response(status)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def _reply(
                self,
                status: int,
                ctype: str,
                body: bytes,
                headers: Any = None,
            ) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                # optional 4th tuple element from a route: extra response
                # headers (views staleness metadata); routes that return
                # 3-tuples are wire-identical to before the field existed
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self) -> None:  # noqa: N802
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    raw = self.rfile.read(length)
                    path = self.path.split("?", 1)[0]
                    from ..obs import get_tracer

                    # adopt the caller's trace context (X-Fugue-Trace /
                    # X-Fugue-Parent): spans below land under the
                    # submitting run instead of floating as local roots
                    with _scope_from_headers(self.headers):
                        if path == "/serve/submit":
                            with get_tracer().span("rpc.serve_submit", cat="rpc"):
                                self._reply(*server._serve_submit(raw))
                            return
                        if path == "/serve/cancel":
                            self._reply(*server._serve_cancel(raw))
                            return
                        if path in ("/serve/register", "/serve/unregister"):
                            made = (
                                server._serve_register(raw)
                                if path == "/serve/register"
                                else server._serve_unregister(raw)
                            )
                            if made is None:  # views disabled: bare 404
                                self._empty(404)
                                return
                            self._reply(*made)
                            return
                        key, args, kwargs = cloudpickle.loads(
                            base64.b64decode(raw)
                        )
                        try:
                            with get_tracer().span("rpc.serve", cat="rpc", key=key):
                                result = (True, server.invoke(key, *args, **kwargs))
                        except Exception as e:  # result is the exception itself
                            result = (False, e)
                        body = base64.b64encode(cloudpickle.dumps(result))
                        self._reply(200, "application/octet-stream", body)
                except Exception:  # pragma: no cover - transport error
                    self._empty(500)

            def do_DELETE(self) -> None:  # noqa: N802 — view retirement
                try:
                    path, _, query = self.path.partition("?")
                    made = (
                        server._serve_view_delete(query)
                        if path == "/serve/view"
                        else None
                    )
                    if made is None:
                        self._empty(404)
                        return
                    self._reply(*made)
                except Exception:
                    try:
                        self._empty(500)
                    except Exception:
                        pass

            def do_GET(self) -> None:  # noqa: N802 — telemetry/serve routes
                try:
                    path, _, query = self.path.partition("?")
                    with _scope_from_headers(self.headers):
                        made = server._get_body(path, query)
                        if made is None:
                            self._empty(404)
                            return
                        self._reply(*made)
                except Exception:  # telemetry must never crash the server
                    try:
                        self._empty(500)
                    except Exception:
                        pass

            def log_message(self, *args: Any) -> None:  # silence
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        # the close never waits for a handler thread: one may sit on a kept
        # connection until its client closes it
        self._httpd.block_on_close = False
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop_server(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            # end the persistent connections: their handler threads return,
            # and each client sees its connection dropped before reusing it
            with self._conns_lock:
                conns, self._conns = list(self._conns), set()
            for conn in conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            self._httpd.server_close()
            self._httpd = None
