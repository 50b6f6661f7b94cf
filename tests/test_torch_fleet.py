"""The serving fleet of the port (``serve/fleet.py``, ``serve/journal.py``,
the claim protocol of ``cache/store.py``) against the JAX package's, the
cases of ``tests/serve/test_fleet.py``.

Each case is written once over ``torch_serve_common.Pkg`` and runs through
the reference on its ``NativeExecutionEngine`` and through the port on its
``NativeExecutionEngine`` and ``TorchExecutionEngine(device="cpu")``; the
two must observe the same. A lease or claim expires by moving its
timestamp back (``expire_lease``), never by sleeping.
"""

import json
import multiprocessing as mp
import os
import shutil
import signal
import socket
import time

import pandas as pd
import pytest
from torch_serve_common import PORTS, REF, Pkg, agg_factory, expire_lease, frame, http_get, wait_for


@pytest.fixture(params=PORTS)
def port(request):
    return Pkg(request.param)


def both(case, port, tmp_path):
    want = case(REF, tmp_path / "ref")
    got = case(port, tmp_path / "port")
    assert got == want
    return got


def _rows(df: pd.DataFrame) -> list:
    return [tuple(r) for r in df.itertuples(index=False)]


def _conf(pkg, store, jdir=None, rid=None, **extra):
    c = pkg.c
    conf = {c.FUGUE_TPU_CONF_CACHE_DIR: str(store)}
    if jdir is not None:
        conf[c.FUGUE_TPU_CONF_SERVE_JOURNAL_DIR] = str(jdir)
    if rid is not None:
        conf[c.FUGUE_TPU_CONF_SERVE_REPLICA_ID] = rid
    conf.update(extra)
    return conf


# -- the claim/lease protocol -----------------------------------------------------


def case_claim_protocol(pkg, tmp):
    st = pkg.ArtifactStore(str(tmp), 0)
    seen = []
    owned, holder = st.try_claim("k1", "A", 30.0)
    seen.append((owned, holder["owner"]))
    owned, holder = st.try_claim("k1", "B", 30.0)
    seen.append((owned, holder["owner"]))
    seen.append(st.try_claim("k1", "A", 30.0)[0])
    seen.append((st.release_claim("k1", "B"), st.release_claim("k1", "A"), st.read_claim("k1")))
    # lease expiry: the holder's clock moved back past its lease
    assert st.try_claim("k", "A", 0.05)[0]
    expire_lease(st._claim("k"))
    owned, holder = st.try_claim("k", "B", 30.0)
    seen.append((owned, holder["owner"]))
    # a dead same-host pid is stealable at once; a torn claim reads absent
    with open(st._claim("g"), "w") as f:
        json.dump({"owner": "ghost", "pid": 2 ** 22 + 12345, "host": socket.gethostname(),
                   "ts": time.time(), "lease_s": 9999.0}, f)
    owned, holder = st.try_claim("g", "B", 30.0)
    seen.append((owned, holder["owner"]))
    with open(st._claim("torn"), "w") as f:
        f.write('{"owner": "gho')
    seen.append((st.read_claim("torn"), st.try_claim("torn", "B", 30.0)[0]))
    return seen


@pytest.mark.parametrize("kind", PORTS[:1])
def test_claim_acquire_hold_release_expire_and_steal(tmp_path, kind):
    got = both(case_claim_protocol, Pkg(kind), tmp_path)
    assert got[0] == (True, "A") and got[1] == (False, "A") and got[4] == (True, "B")


# -- cross-replica single-flight --------------------------------------------------


def case_second_server_serves_first(pkg, tmp):
    store = tmp / "store"
    with pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, store, rid="A"))) as sa:
        ra = frame(sa.submit(agg_factory(pkg, 3)).result(timeout=60))
        pub = sa.stats()["fleet_publishes"]
    with pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, store, rid="B"))) as sb:
        rb = frame(sb.submit(agg_factory(pkg, 3)).result(timeout=60))
        st = sb.stats()
    return {"publishes": pub, "hit": st["fleet_result_hits"] >= 1, "executions": st["executions"],
            "equal": ra.equals(rb), "rows": _rows(rb), "fleet": sorted(sb.engine.stats()["fleet"])}


def test_second_server_serves_first_servers_result(tmp_path, port):
    got = both(case_second_server_serves_first, port, tmp_path)
    assert got["publishes"] == 1 and got["hit"] and got["executions"] == 0 and got["equal"]


def case_fleet_kill_switch(pkg, tmp):
    store = tmp / "store"
    eng = pkg.make_engine(_conf(pkg, store, rid="A", **{pkg.c.FUGUE_TPU_CONF_SERVE_FLEET_ENABLED: False}))
    with pkg.serve.EngineServer(eng) as sa:
        frame(sa.submit(agg_factory(pkg, 3)).result(timeout=60))
        st = sa.stats()
    serve_dir = store / "serve"
    untouched = not os.path.exists(str(serve_dir)) or not os.listdir(str(serve_dir))
    claims = os.listdir(str(store / "claims"))
    with pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, store, rid="B"))) as sb:
        frame(sb.submit(agg_factory(pkg, 3)).result(timeout=60))
        execs = sb.stats()["executions"]
    return {"enabled": st["fleet_enabled"], "publishes": st["fleet_publishes"], "claims": st["fleet_claims"],
            "untouched": untouched, "claim_files": claims, "b_executions": execs}


def test_fleet_kill_switch_restores_single_server_behavior(tmp_path, port):
    assert both(case_fleet_kill_switch, port, tmp_path) == {
        "enabled": False, "publishes": 0, "claims": 0, "untouched": True, "claim_files": [], "b_executions": 1}


def test_two_replicas_at_once_execute_once(tmp_path, port):
    """Two servers on two engines over one store, the same plan submitted
    to both: A claims and runs it, B waits on A's claim and serves the
    result A publishes. A's publish is held until B waits, so the order is
    the same in every run."""
    def case(pkg, tmp):
        store = tmp / "store"
        sa = pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, store, rid="A"))).start()
        sb = pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, store, rid="B"))).start()
        publish = sa._fleet.publish_result

        def held_publish(key, frames):
            assert wait_for(lambda: sb.stats()["fleet_waits"] >= 1)
            return publish(key, frames)

        sa._fleet.publish_result = held_publish
        try:
            a = sa.submit(agg_factory(pkg, 5))
            assert wait_for(lambda: sa.stats()["fleet_claims"] == 1)
            b = sb.submit(agg_factory(pkg, 5))
            got = [frame(s.result(timeout=60)) for s in (a, b)]
            st = {"A": sa.stats(), "B": sb.stats()}
        finally:
            sa.stop()
            sb.stop()
        return {"equal": got[0].equals(got[1]), "rows": _rows(got[0]),
                "counts": {r: (s["fleet_claims"], s["fleet_publishes"], s["fleet_result_hits"])
                           for r, s in st.items()}}

    got = both(case, port, tmp_path)
    assert got["equal"] and got["counts"] == {"A": (1, 1, 0), "B": (0, 0, 1)}


# -- two real processes -----------------------------------------------------------


def _exec_worker(args):
    kind, store, jdir, rid, seed = args
    pkg = Pkg(kind)
    with pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, store, jdir=jdir, rid=rid))) as srv:
        out = frame(srv.submit(agg_factory(pkg, seed), tenant="t").result(timeout=60))
        st = srv.stats()
    return out.values.tolist(), st["executions"], st["fleet_publishes"]


def case_two_process_dedup(pkg, tmp):
    store, jdir = str(tmp / "store"), str(tmp / "journal")
    with mp.get_context("fork").Pool(1) as pool:
        rows_a, exec_a, pub_a = pool.map(_exec_worker, [(pkg.name, store, jdir, "A", 11)])[0]
    with pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, store, jdir=jdir, rid="B"))) as srv:
        rows_b = frame(srv.submit(agg_factory(pkg, 11), tenant="t2").result(timeout=60)).values.tolist()
        st = srv.stats()
    return {"a": (exec_a, pub_a), "hit": st["fleet_result_hits"] >= 1, "b_exec": st["executions"],
            "equal": rows_a == rows_b}


@pytest.mark.parametrize("kind", PORTS[:1])
def test_two_process_cross_server_dedup(tmp_path, kind):
    assert both(case_two_process_dedup, Pkg(kind), tmp_path) == {
        "a": (1, 1), "hit": True, "b_exec": 0, "equal": True}


def _slow_factory(pkg, marker: str, sleep_s: float):
    def build():
        def crawl(df: pd.DataFrame) -> pd.DataFrame:
            with open(marker, "w") as f:
                f.write("running")
            time.sleep(sleep_s)
            return df.assign(v=df["v"] * 2.0)

        col, ff = pkg.col, pkg.ff
        dag = pkg.FugueWorkflow()
        (dag.df(pd.DataFrame({"k": [i % 4 for i in range(32)], "v": [float(i) for i in range(32)]}))
         .transform(crawl, schema="*").partition_by("k").aggregate(ff.sum(col("v")).alias("s"))
         .yield_dataframe_as("r", as_local=True))
        return dag

    return build


def _victim(kind, store, jdir, marker):
    pkg = Pkg(kind)
    srv = pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, store, jdir=jdir, rid="victim"))).start()
    srv.submit(_slow_factory(pkg, marker, 0.8)).wait(60)


def case_claim_steal(pkg, tmp):
    """The owner dies holding the claim (SIGKILL): its same-host pid is
    dead, so the survivor steals the claim at once and executes."""
    store, jdir, marker = str(tmp / "store"), str(tmp / "journal"), str(tmp / "marker")
    os.makedirs(str(tmp), exist_ok=True)
    p = mp.get_context("fork").Process(target=_victim, args=(pkg.name, store, jdir, marker))
    p.start()
    assert wait_for(lambda: os.path.exists(marker))
    os.kill(p.pid, signal.SIGKILL)
    p.join(10)
    with pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, store, jdir=jdir, rid="B"))) as srv:
        got = frame(srv.submit(_slow_factory(pkg, marker, 0.8)).result(timeout=60))
        st = srv.stats()
    dag = _slow_factory(pkg, marker, 0.0)()  # the oracle: fleet and cache off
    dag.run(pkg.make_engine({"fugue.tpu.cache.enabled": False}))
    want = frame(dag)
    return {"steals": st["fleet_claim_steals"] >= 1, "executions": st["executions"],
            "equal": got.equals(want), "rows": _rows(got)}


def test_claim_steal_completes_bit_identical(tmp_path, port):
    got = both(case_claim_steal, port, tmp_path)
    assert got["steals"] and got["executions"] == 1 and got["equal"]


# -- the serve fault sites ----------------------------------------------------------


def case_journal_fault(pkg, tmp):
    eng = pkg.make_engine({"fugue.tpu.fault.plan": "serve.journal=error"})
    with pkg.serve.EngineServer(eng) as srv:
        with pytest.raises(pkg.InjectedFaultError):
            srv.submit(agg_factory(pkg, 1))
        return len(frame(srv.submit(agg_factory(pkg, 1)).result(timeout=60)))


def test_serve_journal_fault_site_fails_admission_once(tmp_path, port):
    assert both(case_journal_fault, port, tmp_path) == 4


def case_claim_fault(pkg, tmp):
    store = tmp / "store"
    eng = pkg.make_engine(_conf(pkg, store, rid="A", **{"fugue.tpu.fault.plan": "serve.claim=error"}))
    with pkg.serve.EngineServer(eng) as srv:
        with pytest.raises(pkg.InjectedFaultError):
            srv.submit(agg_factory(pkg, 2)).result(timeout=60)
        claims = os.listdir(str(store / "claims"))
        return {"claims": claims, "rows": len(frame(srv.submit(agg_factory(pkg, 2)).result(timeout=60)))}


def test_serve_claim_fault_site_releases_claim(tmp_path, port):
    assert both(case_claim_fault, port, tmp_path) == {"claims": [], "rows": 4}


# -- the crash-safe journal ---------------------------------------------------------


def case_journal_records(pkg, tmp):
    j = pkg.serve.SubmissionJournal(str(tmp / "r1.jsonl"), "r1")
    j.admit("s1", "idem-1", "t", 5, 0, agg_factory(pkg, 1))
    j.admit("s2", None, "t", 5, 0, agg_factory(pkg, 2))
    j.exec_start("s1", "key1")
    j.done("s1", "done")
    j.close()
    un = j.unfinished()
    dag = j.decode_dag(un[0])
    with open(j.path, "ab") as f:
        f.write(b'{"op": "admit", "sid": "s3"')
    return {"unfinished": [r["sid"] for r in un], "callable": callable(dag),
            "after_torn": [r["sid"] for r in j.unfinished()]}


def test_journal_records_and_unfinished(tmp_path, port):
    assert both(case_journal_records, port, tmp_path) == {
        "unfinished": ["s2"], "callable": True, "after_torn": ["s2"]}


def case_journal_replay(pkg, tmp):
    store, jdir = str(tmp / "store"), str(tmp / "journal")
    j = pkg.serve.SubmissionJournal(os.path.join(jdir, "R1.jsonl"), "R1")
    j.admit("dead-sid", "idem-9", "acme", 5, 0, agg_factory(pkg, 7))
    j.close()
    with pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, store, jdir=jdir, rid="R1"))) as srv:
        replays = srv.stats()["journal_replays"]
        sub = srv.submit(agg_factory(pkg, 7), tenant="acme", idempotency_key="idem-9")
        idem = srv.stats()["idempotent_replays"]
        rows = len(frame(sub.result(timeout=60)))
    with pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, store, jdir=jdir, rid="R1"))) as srv2:
        again = srv2.stats()["journal_replays"]
    return {"replays": replays, "idem": idem, "rows": rows, "second_restart": again}


def test_journal_replay_on_restart(tmp_path, port):
    assert both(case_journal_replay, port, tmp_path) == {"replays": 1, "idem": 1, "rows": 4, "second_restart": 0}


# -- run-scoped tenant conf -----------------------------------------------------------


def case_overlay_no_leak(pkg, tmp):
    eng = pkg.make_engine({"fugue.tpu.serve.tenant.acme.conf.fugue.tpu.stream.chunk_rows": 777})
    seen = {}

    def probe_factory(tag):
        def build():
            def probe() -> pd.DataFrame:
                seen[tag] = pkg.context_engine().conf.get("fugue.tpu.stream.chunk_rows", -1)
                return pd.DataFrame({"a": [1]})

            dag = pkg.FugueWorkflow()
            dag.create(probe, schema="a:long").yield_dataframe_as("r", as_local=True)
            return dag

        return build

    with pkg.serve.EngineServer(eng) as srv:
        srv.submit(probe_factory("acme"), tenant="acme").result(timeout=60)
        srv.submit(probe_factory("other"), tenant="other").result(timeout=60)
    return {"seen": seen, "leaked": "fugue.tpu.stream.chunk_rows" in eng.conf,
            "leaked_base": "fugue.tpu.stream.chunk_rows" in eng._conf}


def test_tenant_overlay_arbitrary_tpu_keys_no_cross_tenant_leak(tmp_path, port):
    assert both(case_overlay_no_leak, port, tmp_path) == {
        "seen": {"acme": 777, "other": -1}, "leaked": False, "leaked_base": False}


def case_run_conf_scope(pkg, tmp):
    eng = pkg.make_engine()
    dag = pkg.FugueWorkflow({"fugue.tpu.cache.enabled": False})
    dag.df(pd.DataFrame({"a": [1, 2]})).yield_dataframe_as("r", as_local=True)
    dag.run(eng)
    return "fugue.tpu.cache.enabled" in eng.conf


def test_run_conf_scope_restores_after_run(tmp_path, port):
    assert both(case_run_conf_scope, port, tmp_path) is False


# -- bounded per-tenant state -----------------------------------------------------------


def case_stats_lru(pkg, tmp):
    st = pkg.serve.ServeStats(max_tenants=4)
    for i in range(10):
        st.inc_tenant(f"t{i}", "submitted")
    d = st.as_dict()
    return {"tenants": sorted(d["tenants"]), "evictions": d["tenant_evictions"], "keys": sorted(d)}


def test_serve_stats_tenant_breakdown_is_lru_bounded(tmp_path, port):
    got = both(case_stats_lru, port, tmp_path)
    assert got["tenants"] == ["t6", "t7", "t8", "t9"] and got["evictions"] == 6


def case_policy_maps_bounded(pkg, tmp):
    eng = pkg.make_engine({pkg.c.FUGUE_TPU_CONF_SERVE_MAX_TENANTS: 3})
    with pkg.serve.EngineServer(eng) as srv:
        for i in range(8):
            srv.submit(agg_factory(pkg, i), tenant=f"mint{i}").result(timeout=60)
        return (len(srv._policies), len(srv._overlay_warned) <= 3, len(srv.stats()["tenants"]))


def test_server_policy_and_warn_maps_bounded(tmp_path, port):
    assert both(case_policy_maps_bounded, port, tmp_path) == (3, True, 3)


# -- /readyz store health ---------------------------------------------------------------


def case_readyz_store_unwritable(pkg, tmp):
    store = tmp / "store"
    eng = pkg.make_engine(_conf(pkg, store, rid="sick", **{"fugue.rpc.server": pkg.http_server}))
    rpc = eng.rpc_server
    rpc.start()
    srv = pkg.serve.EngineServer(eng).start()
    rpc.bind_serve(srv)
    try:
        seen = []
        code, ready = http_get(rpc, "/readyz")
        seen.append((code, ready["status"], ready["store"]["writable"], ready["replica_id"]))
        shutil.rmtree(str(store / "serve"))
        with srv._lock:
            srv._store_health_ts = 0.0
        code, ready = http_get(rpc, "/readyz")
        seen.append((code, ready["status"], ready["store"]["writable"]))
        fc = pkg.serve.FleetClient([(rpc.host, rpc.port)])
        with pytest.raises(pkg.serve.ServeRejected) as ei:
            fc.submit(agg_factory(pkg, 1))
        seen.append(ei.value.reason)
        code, live = http_get(rpc, "/healthz")
        seen.append((code, live["status"]))
        return seen
    finally:
        srv.stop()
        rpc.stop()


def test_readyz_store_unwritable_503_and_balancer_drain(tmp_path, port):
    got = both(case_readyz_store_unwritable, port, tmp_path)
    assert got[1] == (503, "store_unwritable", False) and got[2] == "fleet_unavailable"
