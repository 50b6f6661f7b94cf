"""Remote session client for the /serve/* HTTP surface.

A thin, dependency-free counterpart of :class:`~fugue_tpu_torch.rpc.http.HttpRPCClient`:
submissions ride POST with cloudpickled payloads, polls/results ride GET.
Retry semantics follow the rpc/http.py idempotency rule — a submit is
only blindly re-sent when it carries an ``idempotency_key`` (the server
then maps the resend onto the SAME submission), otherwise only
failures-before-send retry.

Error taxonomy: a replica that dies POST-ADMIT —
unreachable when the result is fetched, or restarted without this
submission's state — surfaces as :class:`ServeWorkerLost` (``code ==
"worker_lost"``, classified ``WORKER_LOST`` = retryable by the
resilience taxonomy) instead of a generic transport error, so callers (and
:class:`~fugue_tpu_torch.serve.FleetClient`) can mechanically distinguish
"replay me elsewhere" from a workflow's own deterministic failure,
which re-raises as itself and is NEVER retried.
"""

import base64
import http.client
import json
import time
from typing import Any, Dict, Optional

import cloudpickle

from ..resilience import RetryPolicy, WorkerLostError, classify_failure
from .server import ServeRejected

__all__ = ["ServeHttpClient", "ServeWorkerLost"]


class ServeWorkerLost(WorkerLostError, KeyError):
    """A serve replica died (or lost its state) after admitting a
    submission. ``code`` is the stable taxonomy string callers switch
    on; the original transport failure is chained as ``__cause__``.
    Also a ``KeyError`` (the unknown-id contract predates the taxonomy),
    but ``classify_failure`` sees ``WorkerLostError`` first: retryable."""

    code = "worker_lost"

    def __init__(self, message: str, submission_id: Optional[str] = None):
        super().__init__(message)
        self.submission_id = submission_id

    def __str__(self) -> str:  # KeyError would repr() the message
        return self.args[0] if self.args else ""


class ServeHttpClient:
    def __init__(
        self,
        host: str,
        port: int,
        connect_timeout: float = 5.0,
        read_timeout: float = 60.0,
        policy: Optional[RetryPolicy] = None,
    ):
        self._host = host
        self._port = port
        self._connect_timeout = connect_timeout
        self._read_timeout = read_timeout
        self._policy = policy or RetryPolicy(max_attempts=3)

    # -- transport -----------------------------------------------------------
    def _request_once(self, method: str, path: str, body: Optional[bytes]) -> Any:
        sent = False
        conn = http.client.HTTPConnection(
            self._host, self._port, timeout=self._connect_timeout
        )
        try:
            conn.connect()
            if conn.sock is not None:
                conn.sock.settimeout(self._read_timeout)
            sent = True
            headers = {"Content-Length": str(len(body))} if body is not None else {}
            from ..rpc.http import trace_headers

            headers.update(trace_headers())
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, resp.getheader("Content-Type", ""), data
        except Exception as ex:
            ex._fugue_request_sent = sent  # type: ignore[attr-defined]
            raise
        finally:
            conn.close()

    def _request(
        self, method: str, path: str, body: Optional[bytes] = None,
        idempotent: bool = False,
    ) -> Any:
        attempts = 0
        while True:
            try:
                return self._request_once(method, path, body)
            except Exception as ex:
                attempts += 1
                sent = getattr(ex, "_fugue_request_sent", False)
                retryable = (idempotent or not sent) and self._policy.should_retry(
                    classify_failure(ex), attempts
                )
                if not retryable:
                    raise
                time.sleep(self._policy.delay(attempts, seed=path))

    @staticmethod
    def _json(status: int, ctype: str, data: bytes) -> Dict[str, Any]:
        payload = json.loads(data.decode() or "{}")
        payload["_http_status"] = status
        return payload

    # -- the session API -----------------------------------------------------
    def submit(
        self,
        dag: Any,
        tenant: str = "default",
        priority: Optional[int] = None,
        idempotency_key: Optional[str] = None,
        reserve_bytes: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Submit a workflow (a built dag or a zero-arg factory — the
        factory form is what actually crosses the wire cleanly, since a
        built dag may close over local frames). Returns the submission
        payload (``id``, ``status``, ``deduped``…); raises
        :class:`ServeRejected` on a 429 shed."""
        body = base64.b64encode(
            cloudpickle.dumps(
                {
                    "dag": dag,
                    "tenant": tenant,
                    "priority": priority,
                    "idempotency_key": idempotency_key,
                    "reserve_bytes": reserve_bytes,
                }
            )
        )
        status, ctype, data = self._request(
            "POST", "/serve/submit", body,
            idempotent=idempotency_key is not None,
        )
        payload = self._json(status, ctype, data)
        if status == 429:
            raise ServeRejected(payload.get("rejected", "rejected"),
                                payload.get("error", ""))
        if status != 200:
            raise ConnectionError(f"/serve/submit returned HTTP {status}: {payload}")
        return payload

    def _lost(self, sid: str, what: str, cause: Optional[BaseException]) -> Any:
        raise ServeWorkerLost(
            f"serve replica {self._host}:{self._port} lost submission "
            f"{sid} during {what}"
            + (f" ({type(cause).__name__}: {cause})" if cause is not None else ""),
            submission_id=sid,
        ) from cause

    def poll(self, submission_id: str) -> Dict[str, Any]:
        try:
            status, ctype, data = self._request(
                "GET", f"/serve/poll?id={submission_id}", idempotent=True
            )
        except (ConnectionError, OSError) as ex:
            # the replica is gone with our submission: structured
            # worker_lost, not a generic transport error
            return self._lost(submission_id, "poll", ex)
        return self._json(status, ctype, data)

    def result(
        self,
        submission_id: str,
        timeout: Optional[float] = None,
        poll_interval: float = 0.05,
    ) -> Dict[str, Any]:
        """Poll until done, then fetch the yielded frames as pandas
        (``{yield_name: pandas.DataFrame}``). Raises the execution's
        error, re-hydrated — or :class:`ServeWorkerLost` when the
        REPLICA (not the workflow) died post-admit: unreachable, or
        restarted without this submission (404 on a known-admitted id)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                status, ctype, data = self._request(
                    "GET", f"/serve/result?id={submission_id}", idempotent=True
                )
            except (ConnectionError, OSError) as ex:
                return self._lost(submission_id, "result", ex)
            if status == 200 and ctype.startswith("application/octet-stream"):
                ok, payload = cloudpickle.loads(base64.b64decode(data))
                if not ok:
                    raise payload
                return payload
            if status == 404:
                # admitted here, unknown now: the replica restarted and
                # lost (or retention-evicted) this submission's state
                return self._lost(submission_id, "result (unknown id)", None)
            if status != 202:
                raise ConnectionError(f"/serve/result returned HTTP {status}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"submission {submission_id} not done after {timeout}s"
                )
            time.sleep(poll_interval)

    def cancel(self, submission_id: str) -> Dict[str, Any]:
        status, ctype, data = self._request(
            "POST", "/serve/cancel", json.dumps({"id": submission_id}).encode(),
            idempotent=True,  # cancel is naturally idempotent
        )
        return self._json(status, ctype, data)

    # -- continuous views (see docs/views.md) ---------------------------------
    def register_view(
        self,
        view_id: str,
        factory: Any,
        source: str,
        fmt: str = "",
        tenant: str = "default",
    ) -> Dict[str, Any]:
        """Register a continuous view: ``factory`` is a zero-arg workflow
        factory (same wire rule as :meth:`submit` — a BUILT dag may close
        over local frames and is rejected server-side), ``source`` the
        watched path. Raises ``ValueError`` on a 400 (bad id/factory),
        ``KeyError`` on a 404 (views disabled on the replica).
        Registration is idempotent server-side, so retries are safe."""
        body = base64.b64encode(
            cloudpickle.dumps(
                {
                    "id": view_id,
                    "factory": factory,
                    "source": source,
                    "format": fmt,
                    "tenant": tenant,
                }
            )
        )
        status, ctype, data = self._request(
            "POST", "/serve/register", body, idempotent=True
        )
        if status == 404:
            raise KeyError(
                f"/serve/register answered 404 — views disabled on "
                f"{self._host}:{self._port} (fugue.tpu.views.enabled)"
            )
        payload = self._json(status, ctype, data)
        if status == 400:
            raise ValueError(payload.get("error", "invalid view registration"))
        if status != 200:
            raise ConnectionError(f"/serve/register returned HTTP {status}")
        return payload

    def unregister_view(self, view_id: str) -> Dict[str, Any]:
        status, ctype, data = self._request(
            "POST", "/serve/unregister",
            json.dumps({"id": view_id}).encode(),
            idempotent=True,  # unregister is naturally idempotent
        )
        if status == 404 and not data:
            raise KeyError(
                f"/serve/unregister answered 404 — views disabled on "
                f"{self._host}:{self._port}"
            )
        return self._json(status, ctype, data)

    def views(self) -> Dict[str, Any]:
        """``GET /serve/views`` — every registered view's describe dict."""
        status, ctype, data = self._request("GET", "/serve/views", idempotent=True)
        if status != 200:
            raise ConnectionError(f"/serve/views returned HTTP {status}")
        return self._json(status, ctype, data)

    def view(
        self,
        view_id: str,
        timeout: Optional[float] = None,
        poll_interval: float = 0.05,
    ) -> Dict[str, Any]:
        """The view's latest published generation: ``{view, generation,
        as_of, staleness_s, mode, frames, schemas}`` with ``frames`` as
        ``{yield_name: pandas}``. 202 (registered, nothing published yet)
        polls like :meth:`result` when ``timeout`` is set, else raises
        ``TimeoutError`` immediately; 404 raises ``KeyError``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            status, ctype, data = self._request(
                "GET", f"/serve/view?id={view_id}", idempotent=True
            )
            if status == 200 and ctype.startswith("application/octet-stream"):
                return cloudpickle.loads(base64.b64decode(data))
            if status == 404:
                raise KeyError(f"unknown view {view_id!r} (or views disabled)")
            if status != 202:
                raise ConnectionError(f"/serve/view returned HTTP {status}")
            if deadline is None or time.monotonic() > deadline:
                raise TimeoutError(
                    f"view {view_id!r} has no published generation"
                    + (f" after {timeout}s" if timeout is not None else "")
                )
            time.sleep(poll_interval)

    def readyz(self) -> Dict[str, Any]:
        status, ctype, data = self._request("GET", "/readyz", idempotent=True)
        return self._json(status, ctype, data)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """This replica's span-histogram families in the mergeable
        encoding (``GET /metrics/snapshot``) — what
        :meth:`FleetClient.federated_metrics` merges fleet-wide."""
        status, ctype, data = self._request(
            "GET", "/metrics/snapshot", idempotent=True
        )
        if status != 200:
            raise ConnectionError(f"/metrics/snapshot returned HTTP {status}")
        return self._json(status, ctype, data)
