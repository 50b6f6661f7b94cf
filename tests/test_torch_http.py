"""The port's HTTP RPC server (``fugue_tpu_torch/rpc/http.py``) against the
JAX package's (``fugue_tpu/rpc/http.py``), each on loopback.

- A pandas transform with a callback, over each package's HTTP server:
  the rows and the callback's calls equal (exact).
- ``/healthz`` and ``/readyz``: the same JSON keys and values (the pid and
  the uptime aside); unbound, ``/readyz`` answers ``serve_bound: false``.
- ``/metrics`` after the same traced workflow: the same metric families
  and label names, and equal span counts. The reference's result-cache
  and tuner families are left out: the port has neither yet (ROADMAP.md
  queue A); the port adds ``fugue_tpu_plan_chunks_per_verb``.
- The unbound ``/serve/*``, view and ``/dist/fetch`` routes answer 404.
- ``rpc.request`` faults under a retry policy: equal ``rpc.retries``.
- The wire format is cloudpickle at both ends, as in the reference.
- What the port adds: a client keeps one connection a thread (HTTP/1.1),
  and replaces one the server dropped.
"""

import json
import re
import socket
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

import fugue_tpu.api as fa
import fugue_tpu.column as jcolumn
from fugue_tpu import FugueWorkflow as JFugueWorkflow
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.obs import get_span_metrics as jget_span_metrics
from fugue_tpu.obs import get_tracer as jget_tracer
from fugue_tpu.resilience import ResilienceStats as JResilienceStats
from fugue_tpu.resilience import RetryPolicy as JRetryPolicy
from fugue_tpu.rpc.http import HttpRPCClient as JHttpRPCClient

import fugue_tpu_torch.column as tcolumn
from fugue_tpu_torch import api
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.obs import get_span_metrics, get_tracer
from fugue_tpu_torch.resilience import ResilienceStats, RetryPolicy
from fugue_tpu_torch.rpc import NativeRPCServer, make_rpc_server
from fugue_tpu_torch.rpc.http import HttpRPCClient, HttpRPCServer
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow

REF_SERVER = "fugue_tpu.rpc.http.HttpRPCServer"
PORT_SERVER = "fugue_tpu_torch.rpc.http.HttpRPCServer"
# families of sources the port does not have yet (the result cache, the tuner)
PORT_ONLY = ("fugue_tpu_plan_chunks_per_verb",)


def report(df: pd.DataFrame, cb: callable) -> pd.DataFrame:
    cb(len(df))
    return df.assign(n=len(df))


def _frame(n: int = 300, keys: int = 9, seed: int = 4) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, keys, n), "v": rng.random(n)})


def _get(server, route: str):
    try:
        with urllib.request.urlopen(f"http://{server.host}:{server.port}{route}", timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _families(text: str) -> dict:
    """Prometheus text → {family: {label names}} and the samples' values."""
    fams, values = {}, {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = re.match(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)", line)
        name, labels, value = m.group(1, 2, 3)
        keys = tuple(sorted(re.findall(r'([a-zA-Z_]+)="', labels or "")))
        fams.setdefault(name, set()).add(keys)
        values[(name, re.sub(r'(run|workflow)="[^"]*"', r'\1=""', labels or ""))] = value
    return fams, values


@pytest.fixture
def tracers():
    for tr, sm in ((get_tracer(), get_span_metrics()), (jget_tracer(), jget_span_metrics())):
        tr.clear()
        sm.clear()
        tr.enable()
    yield
    for tr, sm in ((get_tracer(), get_span_metrics()), (jget_tracer(), jget_span_metrics())):
        tr.disable()
        tr.clear()
        sm.clear()


@pytest.mark.parametrize("device", [False, True], ids=["host", "torch"])
def test_callbacks_over_http_match_the_reference(device):
    pdf = _frame()
    conf = {"fugue.rpc.server": PORT_SERVER}
    eng = TorchExecutionEngine(device="cpu", conf=conf) if device else NativeExecutionEngine(conf)
    assert isinstance(eng.rpc_server, HttpRPCServer) and eng.rpc_server._metrics_engine() is eng
    got_calls, exp_calls = [], []
    got = api.transform(pdf, report, schema="*,n:long", partition={"by": ["k"]}, callback=got_calls.append,
                        engine=eng)
    jeng = JNativeExecutionEngine({"fugue.rpc.server": REF_SERVER})
    exp = fa.transform(pdf, report, schema="*,n:long", partition={"by": ["k"]}, callback=exp_calls.append,
                       engine=jeng)
    assert sorted(got_calls) == sorted(exp_calls) and len(got_calls) == pdf["k"].nunique()
    cols = ["k", "v", "n"]
    assert (got.sort_values(cols)[cols].values.tolist() == exp.sort_values(cols)[cols].values.tolist())
    assert not eng.rpc_server.running  # the transform stopped it


def test_health_and_readiness_match_the_reference():
    port, ref = HttpRPCServer(), make_rpc_server({"fugue.rpc.server": PORT_SERVER})
    assert isinstance(ref, HttpRPCServer)
    from fugue_tpu.rpc.http import HttpRPCServer as JHttpRPCServer

    jref = JHttpRPCServer()
    with port.start(), jref.start():
        for route in ("/healthz", "/readyz"):
            (s1, b1), (s2, b2) = _get(port, route), _get(jref, route)
            assert s1 == s2 == 200
            p, r = json.loads(b1), json.loads(b2)
            assert sorted(p) == sorted(r)
            for k in ("pid", "uptime_s"):
                p.pop(k, None), r.pop(k, None)
            assert p == r
        assert json.loads(_get(port, "/readyz")[1]) == {"status": "ready", "serve_bound": False}
    assert not port.running


@pytest.mark.parametrize("route", ["/serve/poll?id=x", "/serve/result?id=x", "/serve/views", "/serve/view?id=x",
                                   "/dist/fetch?path=a", "/no/such/route"])
def test_unbound_routes_answer_404(route):
    from fugue_tpu.rpc.http import HttpRPCServer as JHttpRPCServer

    port, ref = HttpRPCServer(), JHttpRPCServer()
    with port.start(), ref.start():
        (s1, b1), (s2, b2) = _get(port, route), _get(ref, route)
    assert s1 == s2 == 404 and b1 == b2


def test_metrics_match_the_reference(tracers, tmp_path):
    """The same traced workflow on each package's host engine, each with its
    HTTP server bound and the same conf (result cache off, a tuned store of
    its own); ``/metrics`` and ``/stats`` scraped after."""
    pages = {}
    conf = {"fugue.tpu.cache.enabled": False}
    for tag, wf, eng, c in (
        ("port", FugueWorkflow, NativeExecutionEngine(
            {"fugue.rpc.server": PORT_SERVER, "fugue.tpu.tuning.path": str(tmp_path / "p.json"), **conf}),
         tcolumn),
        ("ref", JFugueWorkflow, JNativeExecutionEngine(
            {"fugue.rpc.server": REF_SERVER, "fugue.tpu.tuning.path": str(tmp_path / "r.json"), **conf}),
         jcolumn),
    ):
        dag = wf()
        (dag.df(_frame()).filter(c.col("v") > 0.5).partition_by("k")
         .aggregate(c.functions.count(c.col("v")).alias("n")).yield_dataframe_as("r", as_local=True))
        dag.run(eng)
        srv = eng.rpc_server
        with srv.start():
            status, body = _get(srv, "/metrics")
            stats = json.loads(_get(srv, "/stats")[1])
            snap = json.loads(_get(srv, "/metrics/snapshot")[1])
        assert status == 200 and stats["engine"] is not None
        assert set(stats) == {"engine", "latency", "telemetry", "run_labels", "active_runs", "serve"}
        assert set(snap) == {"replica", "proc", "spans"} and snap["spans"]["latency"]
        pages[tag] = _families(body.decode())
    (pf, pv), (rf, rv) = pages["port"], pages["ref"]
    assert any(k.startswith(("fugue_tpu_cache_", "fugue_tpu_tuning_")) for k in pf)
    assert set(pf) - set(rf) == set(PORT_ONLY)
    assert {k: v for k, v in pf.items() if k not in PORT_ONLY} == rf
    counts = {k: v for k, v in pv.items() if k[0] == "fugue_tpu_span_latency_seconds_count"}
    assert counts and counts == {k: v for k, v in rv.items() if k[0] == "fugue_tpu_span_latency_seconds_count"}


def test_rpc_faults_retry_as_the_reference():
    """``rpc.request=error:TimeoutError`` on the first request, two attempts
    a call: the callbacks all arrive, and the server counts one retry, as
    the reference's does."""
    pdf = _frame(n=60, keys=3)
    conf = {"fugue.tpu.fault.plan": "rpc.request=error:TimeoutError", "fugue.tpu.retry.rpc.attempts": 2,
            "fugue.tpu.retry.rpc.base": 0.01}
    eng = TorchExecutionEngine(device="cpu", conf={"fugue.rpc.server": PORT_SERVER, **conf})
    jeng = JNativeExecutionEngine({"fugue.rpc.server": REF_SERVER, **conf})
    got, exp = [], []
    api.transform(pdf, report, schema="*,n:long", partition={"by": ["k"]}, callback=got.append, engine=eng)
    fa.transform(pdf, report, schema="*,n:long", partition={"by": ["k"]}, callback=exp.append, engine=jeng)
    assert sorted(got) == sorted(exp) and sum(got) == 60
    assert eng.rpc_server.resilience_stats.as_dict() == jeng.rpc_server.resilience_stats.as_dict() \
        == {"rpc.retries": 1}


@pytest.mark.parametrize("attempts,idempotent", [(3, True), (2, False)])
def test_connect_failures_retry_as_the_reference(attempts, idempotent):
    """A refused connection (the server never saw it) retries whatever the
    idempotency; the retries equal the reference client's."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    counts = []
    for client_t, policy_t, stats_t in ((HttpRPCClient, RetryPolicy, ResilienceStats),
                                        (JHttpRPCClient, JRetryPolicy, JResilienceStats)):
        stats = stats_t()
        client = client_t("127.0.0.1", port, "key", idempotent=idempotent, stats=stats,
                          policy=policy_t(max_attempts=attempts, base_delay=0.01, jitter=0))
        with pytest.raises(ConnectionError):
            client("payload")
        counts.append(stats.get("rpc.retries"))
    assert counts == [attempts - 1] * 2


def test_server_conf_reaches_clients_and_a_client_pickles():
    """The connect and read timeouts and the retry policy of the conf reach
    the clients; a client crosses a process boundary by cloudpickle
    without its counters and injector, as the reference's does."""
    import cloudpickle

    srv = HttpRPCServer({"fugue.rpc.http_client.connect_timeout": 1.5,
                         "fugue.rpc.http_client.read_timeout": 7.0, "fugue.tpu.retry.rpc.attempts": 4})
    c = srv.create_client("k")
    assert (c._connect_timeout, c._timeout, c._policy.max_attempts) == (1.5, 7.0, 4)
    back = cloudpickle.loads(cloudpickle.dumps(c))
    assert back._stats is None and back._injector is None and back._key == "k"
    assert isinstance(make_rpc_server(), NativeRPCServer)


def test_a_client_keeps_one_connection_and_replaces_a_dropped_one():
    """The port's client sends its calls over one persistent connection a
    thread (the reference connects once a call). A connection the server
    dropped when it stopped is replaced on the next call: the old client
    reaches the server started again on the same port (whose handlers are
    new: its key is unknown there), and once the server is gone the call
    is refused, with no retry under one attempt."""
    from fugue_tpu_torch.rpc import RPCFunc

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = HttpRPCServer({"fugue.rpc.http_server.port": port, "fugue.tpu.retry.rpc.attempts": 1})
    with srv.start():
        client = srv.make_client(RPCFunc(lambda x: x * 2))
        assert [client(i) for i in range(20)] == [2 * i for i in range(20)]
        assert len(srv._conns) == 1
    assert srv._conns == set()
    with srv.start():
        client2 = srv.make_client(RPCFunc(lambda x: x + 1))
        assert client2(1) == 2
        with pytest.raises(KeyError):
            client(1)
    with pytest.raises(ConnectionError):
        client2(1)
    assert srv.resilience_stats.as_dict() == {}
