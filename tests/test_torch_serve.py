"""The serving layer of the port (``fugue_tpu_torch/serve``) against the
JAX package's (``fugue_tpu/serve``).

Each case of ``tests/serve/test_engine_server.py`` and
``tests/serve/test_single_flight.py`` is written once (``case_*``, over
``torch_serve_common.Pkg``) and run through the reference on its
``NativeExecutionEngine`` and through the port on its
``NativeExecutionEngine`` and on ``TorchExecutionEngine(device="cpu")``.
The two must observe the same: results, rejection reasons, the order in
which executions start, dedup joins, counters, stats keys and HTTP
statuses. One case more holds the port alone: a yielded
``TorchDataFrame`` charges its tenant the frame's device bytes.
"""

import threading

import pandas as pd
import pytest
from torch_serve_common import PORTS, REF, Gate, Pkg, agg_dag, frame, http_get, plain, wait_for


@pytest.fixture(params=PORTS)
def port(request):
    return Pkg(request.param)


def both(case, port, *args):
    """The case's observations through the reference and the port."""
    want = case(REF, *args)
    got = case(port, *args)
    assert got == want
    return got


def _frame_key(df: pd.DataFrame) -> list:
    return [tuple(r) for r in df.itertuples(index=False)]


# -- admission, scheduling, results ------------------------------------------


def case_submit_result_roundtrip(pkg):
    eng = pkg.make_engine()
    with pkg.serve.EngineServer(eng) as srv:
        sub = srv.submit(agg_dag(pkg), tenant="t0")
        res = sub.result(timeout=60)
        df = frame(res)
        status, waited = sub.status, sub.queue_wait_s is not None
    st = srv.stats()
    return {"rows": _frame_key(df), "status": status, "waited": waited,
            "counts": (st["submitted"], st["completed"], st["failed"]),
            "tenant": st["tenants"]["t0"]["completed"]}


def test_submit_result_roundtrip(port):
    got = both(case_submit_result_roundtrip, port)
    assert [r[2] for r in got["rows"]] == [16, 16, 16, 16]


def case_factory_and_built_dag(pkg):
    with pkg.serve.EngineServer(pkg.make_engine()) as srv:
        a = srv.submit(lambda: agg_dag(pkg, seed=1), tenant="t0")
        b = srv.submit(agg_dag(pkg, seed=2), tenant="t0")
        ra, rb = frame(a.result(timeout=60)), frame(b.result(timeout=60))
    return {"a": _frame_key(ra), "b": _frame_key(rb), "distinct": not ra.equals(rb)}


def test_factory_and_built_dag_both_accepted(port):
    assert both(case_factory_and_built_dag, port)["distinct"]


def case_failed_run(pkg):
    def boom() -> pd.DataFrame:
        raise RuntimeError("kaboom")

    with pkg.serve.EngineServer(pkg.make_engine()) as srv:
        bad = pkg.FugueWorkflow()
        bad.create(boom, schema="a:int").yield_dataframe_as("g", as_local=True)
        sub = srv.submit(bad)
        with pytest.raises(Exception, match="kaboom"):
            sub.result(timeout=60)
        status = sub.status
        ok = len(frame(srv.submit(agg_dag(pkg)).result(timeout=60)))
    st = srv.stats()
    return {"status": status, "ok_rows": ok, "failed": st["failed"], "completed": st["completed"]}


def test_failed_run_raises_to_the_waiter_only(port):
    assert both(case_failed_run, port) == {"status": "failed", "ok_rows": 4, "failed": 1, "completed": 1}


def case_queue_full(pkg):
    c = pkg.c
    eng = pkg.make_engine({c.FUGUE_TPU_CONF_SERVE_MAX_CONCURRENT: 1, c.FUGUE_TPU_CONF_SERVE_QUEUE_DEPTH: 1})
    gate = Gate(pkg)
    with pkg.serve.EngineServer(eng) as srv:
        blocker = srv.submit(gate.dag())
        assert gate.entered.wait(30)
        queued = srv.submit(agg_dag(pkg, seed=1))
        with pytest.raises(pkg.serve.ServeRejected) as ei:
            srv.submit(agg_dag(pkg, seed=2))
        gate.release.set()
        blocker.result(timeout=60)
        queued.result(timeout=60)
    st = srv.stats()
    return {"reason": ei.value.reason, "rejected": st["rejected_queue_full"], "peak": st["peak_queue_depth"]}


def test_queue_full_rejection_and_peak_depth(port):
    assert both(case_queue_full, port) == {"reason": "queue_full", "rejected": 1, "peak": 1}


def case_tenant_budget(pkg):
    eng = pkg.make_engine({"fugue.tpu.serve.tenant.small.budget_bytes": 1000})
    with pkg.serve.EngineServer(eng) as srv:
        with pytest.raises(pkg.serve.ServeRejected) as ei:
            srv.submit(agg_dag(pkg), tenant="small", reserve_bytes=2000)
        sub = srv.submit(agg_dag(pkg), tenant="small", reserve_bytes=900)
        sub.wait(60)
        charged = srv.stats()["charged_bytes"].get("small", 0)
        sub.result(timeout=60)
        after = srv.stats()["charged_bytes"].get("small", 0)
        srv.submit(agg_dag(pkg, seed=5), tenant="big", reserve_bytes=10**9).result(timeout=60)
    return {"reason": ei.value.reason, "charged_in_budget": 0 < charged <= 1000, "charged": charged,
            "after_claim": after, "rejected_budget": srv.stats()["rejected_budget"]}


def test_tenant_budget_gates_admission_and_releases_on_claim(port):
    got = both(case_tenant_budget, port)
    assert got["charged_in_budget"] and got["after_claim"] == 0 and got["rejected_budget"] == 1


def case_priority_order(pkg):
    c = pkg.c
    eng = pkg.make_engine({c.FUGUE_TPU_CONF_SERVE_MAX_CONCURRENT: 1, c.FUGUE_TPU_CONF_SERVE_DEFAULT_PRIORITY: 5})
    gate = Gate(pkg)
    with pkg.serve.EngineServer(eng) as srv:
        blocker = srv.submit(gate.dag())
        assert gate.entered.wait(30)
        low1 = srv.submit(agg_dag(pkg, seed=1), priority=8)
        low2 = srv.submit(agg_dag(pkg, seed=2), priority=8)
        hi = srv.submit(agg_dag(pkg, seed=3), priority=1)
        gate.release.set()
        for sub in (hi, low1, low2, blocker):
            sub.wait(60)
        t = {n: s._execution.started_at for n, s in (("low1", low1), ("low2", low2), ("hi", hi))}
    return {"order": sorted(t, key=t.get)}


def test_priority_order_with_fifo_ties(port):
    assert both(case_priority_order, port) == {"order": ["hi", "low1", "low2"]}


def case_aging(pkg):
    """An old low-priority execution beats a fresh urgent one: it has
    aged past it. The age is set on the queued execution, not slept."""
    c = pkg.c
    eng = pkg.make_engine({c.FUGUE_TPU_CONF_SERVE_MAX_CONCURRENT: 1, "fugue.tpu.serve.aging_s": 0.05})
    gate = Gate(pkg)
    with pkg.serve.EngineServer(eng) as srv:
        blocker = srv.submit(gate.dag())
        assert gate.entered.wait(30)
        old_low = srv.submit(agg_dag(pkg, seed=1), priority=9)
        with srv._lock:
            old_low._execution.submitted_at -= 0.6  # > 10 levels aged
        fresh_hi = srv.submit(agg_dag(pkg, seed=2), priority=0)
        gate.release.set()
        for s in (blocker, old_low, fresh_hi):
            s.wait(60)
    return {"aged_first": old_low._execution.started_at < fresh_hi._execution.started_at}


def test_aging_promotes_starved_low_priority(port):
    assert both(case_aging, port) == {"aged_first": True}


def case_tenant_overlay(pkg):
    eng = pkg.make_engine({
        "fugue.tpu.serve.tenant.legacy.conf.fugue.tpu.plan.optimize": False,
        "fugue.tpu.serve.tenant.legacy.conf.fugue.workflow.concurrency": 4,
        "fugue.tpu.serve.tenant.legacy.priority": 2,
    })
    pol = pkg.serve.tenant_policy(eng.conf, "legacy")
    with pkg.serve.EngineServer(eng) as srv:
        dag = agg_dag(pkg)
        sub = srv.submit(dag, tenant="legacy")
        sub.result(timeout=60)
    return {"priority": pol.priority, "overlay": dict(pol.conf_overlay), "dropped": pol.dropped_keys,
            "sub_priority": sub.priority, "dag_conf": dag._conf["fugue.tpu.plan.optimize"],
            "report_enabled": dag.last_plan_report.enabled,
            "leaked": "fugue.tpu.plan.optimize" in eng.conf}


def test_tenant_conf_overlay_plan_keys_only(port):
    got = both(case_tenant_overlay, port)
    assert got["overlay"] == {"fugue.tpu.plan.optimize": False} and not got["leaked"]


def case_dedup_key(pkg):
    eng = pkg.make_engine()
    k1 = pkg.serve.submission_key(agg_dag(pkg, seed=7), eng)
    k2 = pkg.serve.submission_key(agg_dag(pkg, seed=7), eng)
    k3 = pkg.serve.submission_key(agg_dag(pkg, seed=8), eng)

    def gen() -> pd.DataFrame:
        return pd.DataFrame({"a": [1]})

    dag = pkg.FugueWorkflow()
    dag.create(gen, schema="a:int").yield_dataframe_as("g", as_local=True)
    return {"keyed": k1 is not None, "same": k1 == k2, "differs": k1 != k3,
            "creator_refused": pkg.serve.submission_key(dag, eng) is None}


def test_dedup_key_identity_and_refusal(port):
    assert both(case_dedup_key, port) == {"keyed": True, "same": True, "differs": True, "creator_refused": True}


def test_dedup_key_refuses_a_device_frame_and_a_stream():
    """What the port's fingerprint refuses gets no dedup key: a
    ``TorchDataFrame`` input and a one-pass stream."""
    import fugue_tpu_torch.dataframe as tdf_mod

    pkg = Pkg("torch")
    eng = pkg.make_engine()
    pdf = pd.DataFrame({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]})
    for src in (eng.to_df(pdf), tdf_mod.LocalDataFrameIterableDataFrame([tdf_mod.PandasDataFrame(pdf)])):
        dag = pkg.FugueWorkflow()
        dag.df(src).partition_by("k").aggregate(pkg.ff.sum(pkg.col("v")).alias("s")).yield_dataframe_as("r")
        assert pkg.serve.submission_key(dag, eng) is None


def case_stats_mounted(pkg):
    eng = pkg.make_engine()
    with pkg.serve.EngineServer(eng) as srv:
        srv.submit(agg_dag(pkg)).result(timeout=60)
        st = eng.stats()
        names = pkg.get_sampler().probe_names()
        vals = pkg.get_sampler().sample_once()
        eng.reset_stats()
        out = {"completed": st["serve"]["completed"],
               "probes": sorted(n for n in names if n.startswith("serve_")),
               "queue_probe": vals["serve_queue_depth"],
               "after_reset": eng.stats()["serve"]["completed"], "running": srv.running,
               "serve_keys": sorted(k for k in st["serve"] if k != "tuning")}
    return out


def test_serve_stats_mounted_on_engine_registry_and_probes(port):
    got = both(case_stats_mounted, port)
    assert got["completed"] == 1 and got["after_reset"] == 0
    assert {"serve_queue_depth", "serve_active_runs"} <= set(got["probes"])


def case_tenant_labels(pkg):
    tr, sm = pkg.get_tracer(), pkg.get_span_metrics()
    tr.clear()
    sm.clear()
    tr.enable()
    try:
        with pkg.serve.EngineServer(pkg.make_engine()) as srv:
            srv.submit(agg_dag(pkg), tenant="acme").result(timeout=60)
        acme = [lab for lab, _h in sm.latency.series() if lab.get("tenant") == "acme"]
        nested = any(lab.get("span") == "workflow.run" and "run" in lab for lab in acme)
        cap = sm.MAX_TENANT_SERIES
        for i in range(cap + 5):
            with pkg.run_labels(tenant=f"bulk{i}"), tr.span("serve.run"):
                pass
        tenants = {lab["tenant"] for lab, _h in sm.latency.series() if "tenant" in lab}
        return {"acme": bool(acme), "nested": nested, "bounded": len(tenants) <= cap,
                "oldest_gone": "bulk0" not in tenants, "newest": f"bulk{cap + 4}" in tenants}
    finally:
        tr.disable()
        tr.clear()
        sm.clear()


def test_tenant_label_attribution_and_rotation(port):
    assert all(both(case_tenant_labels, port).values())


def case_stopped_server(pkg):
    import time

    eng = pkg.make_engine({pkg.c.FUGUE_TPU_CONF_SERVE_MAX_CONCURRENT: 1})
    gate = Gate(pkg)
    srv = pkg.serve.EngineServer(eng).start()
    blocker = srv.submit(gate.dag())
    assert gate.entered.wait(30)
    queued = srv.submit(agg_dag(pkg))
    t = threading.Thread(target=lambda: (time.sleep(0.05), gate.release.set()))
    t.start()
    srv.stop()
    t.join()
    blocker.wait(60)
    reasons = []
    for fn in (lambda: queued.result(timeout=5), lambda: srv.submit(agg_dag(pkg))):
        with pytest.raises(pkg.serve.ServeRejected) as ei:
            fn()
        reasons.append(ei.value.reason)
    return {"blocker": blocker.status, "reasons": reasons}


def test_stopped_server_rejects_and_drains(port):
    assert both(case_stopped_server, port) == {"blocker": "done", "reasons": ["server_stopped"] * 2}


# -- single-flight ------------------------------------------------------------


def sf_dag(pkg, rows: int = 256):
    col, ff = pkg.col, pkg.ff
    dag = pkg.FugueWorkflow()
    (
        dag.df(pd.DataFrame({"k": [i % 8 for i in range(rows)], "v": [float(i) for i in range(rows)]}))
        .filter(col("v") >= 16)
        .partition_by("k")
        .aggregate(ff.sum(col("v")).alias("s"), ff.count(col("v")).alias("n"))
        .yield_dataframe_as("r", as_local=True)
    )
    return dag


def _traced(pkg, fn):
    tr = pkg.get_tracer()
    tr.clear()
    pkg.get_span_metrics().clear()
    tr.enable()
    try:
        return fn(tr)
    finally:
        tr.disable()
        tr.clear()
        pkg.get_span_metrics().clear()


def case_identical_share_one_execution(pkg):
    def run(tr):
        eng = pkg.make_engine({pkg.c.FUGUE_TPU_CONF_SERVE_MAX_CONCURRENT: 1})
        gate = Gate(pkg)
        with pkg.serve.EngineServer(eng) as srv:
            blocker = srv.submit(gate.dag())
            assert gate.entered.wait(30)
            subs, errs = [], []

            def session(i: int) -> None:
                try:
                    subs.append(srv.submit(lambda: sf_dag(pkg), tenant=f"tenant{i}"))
                except Exception as e:  # pragma: no cover
                    errs.append(e)

            threads = [threading.Thread(target=session, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            gate.release.set()
            blocker.result(timeout=60)
            results = [s.result(timeout=60) for s in subs]
        st = srv.stats()
        runs = [r for r in tr.records() if r["name"] == "serve.run"]
        a, b = (res.yields["r"].result for res in results)
        return {"errors": len(errs), "submitted": st["submitted"], "executions": st["executions"],
                "dedup_hits": st["dedup_hits"], "deduped": sorted(s.deduped for s in subs),
                "runs": len(runs), "waiters": sorted(r["args"].get("waiters", 0) for r in runs),
                "same_frame": a is b, "rows": _frame_key(frame(results[0]))}

    return _traced(pkg, run)


def test_identical_concurrent_submissions_share_one_execution(port):
    got = both(case_identical_share_one_execution, port)
    assert got["executions"] == 2 and got["dedup_hits"] == 1 and got["waiters"] == [1, 2]
    assert got["same_frame"]


def case_canceled_waiter(pkg):
    def run(tr):
        eng = pkg.make_engine({pkg.c.FUGUE_TPU_CONF_SERVE_MAX_CONCURRENT: 1})
        gate = Gate(pkg)
        with pkg.serve.EngineServer(eng) as srv:
            blocker = srv.submit(gate.dag())
            assert gate.entered.wait(30)
            keeper = srv.submit(lambda: sf_dag(pkg), tenant="keeper")
            quitter = srv.submit(lambda: sf_dag(pkg), tenant="quitter")
            first, second = quitter.cancel(), quitter.cancel()
            gate.release.set()
            blocker.result(timeout=60)
            rows = len(frame(keeper.result(timeout=60)))
            with pytest.raises(pkg.serve.SubmissionCanceled):
                quitter.result(timeout=5)
        st = srv.stats()
        return {"deduped": quitter.deduped, "cancels": (first, second), "rows": rows,
                "counts": (st["canceled"], st["canceled_executions"], st["executions"], st["completed"])}

    return _traced(pkg, run)


def test_canceled_waiter_does_not_cancel_shared_execution(port):
    assert both(case_canceled_waiter, port)["counts"] == (1, 0, 2, 2)


def case_last_waiter_cancel(pkg):
    def run(tr):
        eng = pkg.make_engine({pkg.c.FUGUE_TPU_CONF_SERVE_MAX_CONCURRENT: 1})
        gate = Gate(pkg)
        with pkg.serve.EngineServer(eng) as srv:
            blocker = srv.submit(gate.dag())
            assert gate.entered.wait(30)
            only = srv.submit(lambda: sf_dag(pkg), tenant="only")
            canceled = only.cancel()
            gate.release.set()
            blocker.result(timeout=60)
            again = srv.submit(lambda: sf_dag(pkg), tenant="only")
            again.result(timeout=60)
        st = srv.stats()
        return {"canceled": canceled, "again_deduped": again.deduped,
                "counts": (st["canceled_executions"], st["executions"])}

    return _traced(pkg, run)


def test_last_waiter_cancel_drops_queued_execution(port):
    assert both(case_last_waiter_cancel, port) == {"canceled": True, "again_deduped": False, "counts": (1, 2)}


def case_post_completion(pkg):
    def run(tr):
        with pkg.serve.EngineServer(pkg.make_engine()) as srv:
            srv.submit(lambda: sf_dag(pkg), tenant="a").result(timeout=60)
            second = srv.submit(lambda: sf_dag(pkg), tenant="b")
            second.result(timeout=60)
        return {"deduped": second.deduped, "executions": srv.stats()["executions"]}

    return _traced(pkg, run)


def test_post_completion_submissions_do_not_share_in_flight(port):
    assert both(case_post_completion, port) == {"deduped": False, "executions": 2}


# -- the HTTP surface -----------------------------------------------------------


class _Http:
    def __init__(self, pkg, **conf):
        c = pkg.c
        self.eng = pkg.make_engine({
            "fugue.rpc.server": pkg.http_server,
            c.FUGUE_TPU_CONF_SERVE_MAX_CONCURRENT: 1,
            c.FUGUE_TPU_CONF_SERVE_QUEUE_DEPTH: 2,
            **conf,
        })
        self.rpc = self.eng.rpc_server
        self.rpc.start()
        self.srv = pkg.serve.EngineServer(self.eng).start()
        self.rpc.bind_serve(self.srv)
        self.client = pkg.serve.ServeHttpClient(self.rpc.host, self.rpc.port)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.stop()
        self.rpc.stop()


def case_rpc_roundtrip(pkg):
    with _Http(pkg) as h:
        cl = h.client
        sub = cl.submit(lambda: agg_dag(pkg, seed=3), tenant="acme")
        frames = cl.result(sub["id"], timeout=60)
        poll = cl.poll(sub["id"])
        missing = cl.poll("nope")["_http_status"]
        with pytest.raises(KeyError):
            cl.result("nope")
        gate = Gate(pkg)
        blocker = h.srv.submit(gate.dag())
        assert gate.entered.wait(30)
        queued = cl.submit(lambda: agg_dag(pkg, seed=4))
        out = cl.cancel(queued["id"])
        gate.release.set()
        blocker.result(timeout=60)
    return {"tenant": sub["tenant"], "deduped": sub["deduped"], "columns": sorted(frames["r"].columns),
            "rows": _frame_key(plain(frames["r"].sort_values("k").reset_index(drop=True))),
            "poll": (poll["status"], poll["run_s"] is not None), "missing": missing,
            "cancel": (out["canceled"], out["status"])}


def test_rpc_submit_poll_result_cancel(port):
    got = both(case_rpc_roundtrip, port)
    assert got["missing"] == 404 and got["cancel"] == (True, "canceled")


def case_rpc_idempotency(pkg):
    with _Http(pkg) as h:
        a = h.client.submit(lambda: agg_dag(pkg, seed=9), tenant="t", idempotency_key="job-1")
        b = h.client.submit(lambda: agg_dag(pkg, seed=9), tenant="t", idempotency_key="job-1")
        replays = h.srv.stats()["idempotent_replays"]
        h.client.result(a["id"], timeout=60)
    return {"same_id": a["id"] == b["id"], "replays": replays}


def test_rpc_idempotency_key_replays_same_submission(port):
    assert both(case_rpc_idempotency, port) == {"same_id": True, "replays": 1}


def case_rpc_429(pkg):
    with _Http(pkg) as h:
        gate = Gate(pkg)
        blocker = h.srv.submit(gate.dag())
        assert gate.entered.wait(30)
        subs = [h.client.submit(lambda s=s: agg_dag(pkg, seed=s)) for s in (1, 2)]
        with pytest.raises(pkg.serve.ServeRejected) as ei:
            h.client.submit(lambda: agg_dag(pkg, seed=3))
        gate.release.set()
        for s in subs:
            h.client.result(s["id"], timeout=60)
        blocker.result(timeout=60)
    return {"reason": ei.value.reason}


def test_rpc_submit_rejection_is_429(port):
    assert both(case_rpc_429, port) == {"reason": "queue_full"}


def case_healthz_readyz(pkg):
    with _Http(pkg) as h:
        seen = []
        code, live = http_get(h.rpc, "/healthz")
        seen.append((code, live["status"], "uptime_s" in live))
        code, ready = http_get(h.rpc, "/readyz")
        seen.append((code, ready["status"], ready["queue_capacity"], ready["queue_free"], ready["serve_bound"]))
        gate = Gate(pkg)
        blocker = h.srv.submit(gate.dag())
        assert gate.entered.wait(30)
        subs = [h.srv.submit(agg_dag(pkg, seed=s)) for s in (1, 2)]
        code, ready = http_get(h.rpc, "/readyz")
        seen.append((code, ready["status"], ready["queue_free"]))
        code, live = http_get(h.rpc, "/healthz")
        seen.append((code, live["status"]))
        gate.release.set()
        blocker.result(timeout=60)
        for s in subs:
            s.result(timeout=60)
        code, ready = http_get(h.rpc, "/readyz")
        seen.append((code, ready["status"]))
    return {"seen": seen}


def test_healthz_liveness_vs_readyz_readiness(port):
    got = both(case_healthz_readyz, port)["seen"]
    assert got[1] == (200, "ready", 2, 2, True) and got[2] == (503, "overloaded", 0)


def case_stats_endpoint(pkg):
    with _Http(pkg) as h:
        h.srv.submit(agg_dag(pkg)).result(timeout=60)
        code, st = http_get(h.rpc, "/stats")
    return {"code": code, "completed": st["serve"]["completed"] >= 1,
            "capacity": st["serve"]["queue_capacity"]}


def test_stats_endpoint_carries_serve_section(port):
    assert both(case_stats_endpoint, port) == {"code": 200, "completed": True, "capacity": 2}


# -- the port alone: device bytes ------------------------------------------------


def test_a_yielded_device_frame_charges_its_device_bytes():
    """A ``TorchDataFrame`` yielded by a submission stays on the engine's
    device while the server holds it, and its tenant is charged the
    frame's ``device_nbytes`` (``estimate_df_bytes``), released when the
    result is claimed."""
    from fugue_tpu_torch.cache.store import estimate_df_bytes
    from fugue_tpu_torch.torch.dataframe import TorchDataFrame

    pkg = Pkg("torch")
    with pkg.serve.EngineServer(pkg.make_engine()) as srv:
        sub = srv.submit(lambda: agg_dag(pkg, rows=4096, as_local=False), tenant="dev")
        assert sub.wait(60)
        charged = srv.stats()["charged_bytes"]["dev"]
        res = sub.result(timeout=60)
        df = res.yields["r"].result
        assert isinstance(df, TorchDataFrame)
        assert charged == df.device_nbytes == estimate_df_bytes(df) > 0
        assert srv.stats()["charged_bytes"].get("dev", 0) == 0
        assert sorted(df.as_pandas()["n"]) == [1024] * 4


def test_a_budget_below_the_device_bytes_rejects_the_next_submission():
    """The budget gate counts the device bytes a tenant holds: with one
    result held, a second submission over the budget is refused."""
    pkg = Pkg("torch")
    probe = pkg.make_engine()
    dag = agg_dag(pkg, rows=4096, as_local=False)
    dag.run(probe)
    nbytes = dag.yields["r"].result.device_nbytes
    eng = pkg.make_engine({"fugue.tpu.serve.tenant.small.budget_bytes": nbytes + 1})
    with pkg.serve.EngineServer(eng) as srv:
        held = srv.submit(lambda: agg_dag(pkg, rows=4096, as_local=False), tenant="small")
        assert held.wait(60)
        assert srv.stats()["charged_bytes"]["small"] == nbytes
        with pytest.raises(pkg.serve.ServeRejected) as ei:
            srv.submit(lambda: agg_dag(pkg, seed=1, as_local=False), tenant="small", reserve_bytes=2)
        assert ei.value.reason == "tenant_budget"
        held.result(timeout=60)
        srv.submit(lambda: agg_dag(pkg, seed=1, as_local=False), tenant="small", reserve_bytes=2).result(timeout=60)
    assert wait_for(lambda: srv.stats()["rejected_budget"] == 1)


@pytest.mark.parametrize("fails", [False, True], ids=["done", "failed"])
def test_a_retained_submission_keeps_its_result_not_its_workflow(fails):
    """A finished execution drops its workflow, whose context holds every
    intermediate frame of the run (on the card, the loaded input too): the
    retention ring keeps the result, or the error with its traceback's
    lines but not the run's locals. So the submitted workflow is collected
    while the server, stopped or not, still retains the submission."""
    import gc
    import weakref

    def boom(df: pd.DataFrame) -> pd.DataFrame:
        raise RuntimeError("kaboom")

    def submit(srv):
        # built in a frame of its own: a UDF's translation may snapshot the
        # caller's locals, which would hold the workflow here
        dag = agg_dag(pkg, rows=4096, as_local=False)
        if fails:
            dag.df(pd.DataFrame({"a": [1]})).transform(boom, schema="*").yield_dataframe_as("x")
        return weakref.ref(dag), srv.submit(dag, tenant="t")

    pkg = Pkg("torch")
    srv = pkg.serve.EngineServer(pkg.make_engine()).start()
    try:
        ref, sub = submit(srv)
        assert sub.wait(60)
        if fails:
            with pytest.raises(RuntimeError, match="kaboom") as ei:
                sub.result(timeout=60)
            assert "boom" in "".join(__import__("traceback").format_tb(ei.value.__traceback__))
        else:
            assert sorted(frame(sub.result(timeout=60))["n"]) == [1024] * 4
    finally:
        srv.stop()
    gc.collect()
    assert srv.stats()["retained"] == 1 and srv.get(sub.id) is sub
    assert ref() is None


def test_chip_smoke_serve_path_on_the_cpu(tmp_path):
    """``chip_smoke.phase_cache_path`` then ``phase_serve_path`` on its
    handed-over directory, at small size on the CPU, in a subprocess that
    loads no JAX, with the CUDA calls stubbed: every cell runs, B1's plain
    version stands in for the kernel (its calls and rows are still
    counted), and the phase's gates hold: one execution for four deduped
    sessions, the priority order, the idempotent replay and the 429, one
    execution across two replicas, the view's ``append`` generation over
    the new rows only."""
    import os
    import subprocess
    import sys

    code = f"""
import sys, torch
sys.path.insert(0, {os.getcwd()!r})
import chip_smoke
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
torch.cuda.memory_allocated = lambda *a, **k: 0
import numpy as np, pandas as pd, pyarrow as pa
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
pdf = chip_smoke.plan_frame(np, pd, 40_960, 0)
import fugue_tpu_torch.tuning.tuner as tuner
tuner.MIN_WALL_S = 0.0
out = chip_smoke.phase_cache_path(torch, np, pd, pa, bg, ff, col, "cpu", pdf, 0, files=4, stream_rows=40_960,
                                  stream_chunk=1_024, tmp_root={str(tmp_path)!r}, keep_source=True)
h = out.pop("handover")
sp = chip_smoke.phase_serve_path(torch, np, pd, pa, bg, ff, col, "cpu", h, 0, new_rows=10_000)
cells = sp["cells"]
assert set(cells) == {{"serve-dedup", "serve-mixed", "serve-http", "serve-fleet", "serve-view"}}, set(cells)
assert cells["serve-dedup"]["b1_rows"] == [h["rows"]]
assert cells["serve-mixed"]["started"] == ["tenant0", "tenant1", "tenant2", "tenant3"]
assert cells["serve-view"]["b1_rows"] == [h["rows"], 10_000]
import os
assert not os.path.exists(str(h["tmp"]))
assert "jax" not in sys.modules
print("OK")
"""
    env = dict(os.environ, FUGUE_TPU_TUNING_PATH=str(tmp_path / "t.json"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0 and p.stdout.strip().endswith("OK"), p.stdout[-3000:] + p.stderr[-3000:]
