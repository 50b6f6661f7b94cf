"""The standing views of the port (``fugue_tpu_torch/views``) and the two
``dist`` modules they stand on (``dist/heartbeat.py``, ``dist/lease.py``)
against the JAX package's: the cases of ``tests/views/test_views.py`` and
the heartbeat and lease cases of ``tests/distributed/test_dist.py``.

Each case is written once over ``torch_serve_common.Pkg`` and runs through
the reference on its ``NativeExecutionEngine`` and through the port on its
``NativeExecutionEngine`` and ``TorchExecutionEngine(device="cpu")``; the
two must observe the same generations, modes, reasons, counters and
events. The maintainer's loop is parked after its first tick (``_server``)
and the cases drive ``tick_once()``. A lease expires, or a heartbeat goes
stale, by moving its timestamps back, never by sleeping.
"""

import json
import os
import threading
import time

import pandas as pd
import pytest
from torch_serve_common import PORTS, REF, Pkg, expire_lease, plain, wait_for


@pytest.fixture(params=PORTS)
def port(request):
    return Pkg(request.param)


def both(case, port, tmp_path):
    want = case(REF, tmp_path / "ref")
    got = case(port, tmp_path / "port")
    assert got == want
    return got


def _write_part(src: str, i: int, rows: int = 8, scale: float = 1.0) -> None:
    pd.DataFrame({"k": [i % 4] * rows, "v": [float(i * 10 + j) * scale for j in range(rows)]}).to_parquet(
        os.path.join(src, f"part-{i:05d}.parquet"))


def _factory(pkg, src: str):
    def build():
        dag = pkg.FugueWorkflow()
        (dag.load(src, fmt="parquet").partition_by("k").aggregate(pkg.ff.sum(pkg.col("v")).alias("s"))
         .yield_dataframe_as("r", as_local=True))
        return dag

    return build


def _oracle(src: str) -> list:
    """The source as it is now, summed by ``k`` in pandas."""
    files = sorted(os.listdir(src))
    pdf = pd.concat([pd.read_parquet(os.path.join(src, f)) for f in files], ignore_index=True)
    out = pdf.groupby("k", as_index=False)["v"].sum().rename(columns={"v": "s"})
    return _rows(out)


def _rows(df: pd.DataFrame) -> list:
    df = plain(df.sort_values("k").reset_index(drop=True))
    return [(int(k), float(s)) for k, s in zip(df["k"], df["s"])]


def _result_rows(res: dict) -> list:
    return _rows(res["frames"]["r"])


def _src(tmp) -> str:
    d = str(tmp / "src")
    os.makedirs(d)
    for i in range(2):
        _write_part(d, i)
    return d


def _conf(pkg, tmp, rid, **extra):
    c = pkg.c
    conf = {
        c.FUGUE_TPU_CONF_CACHE_DIR: str(tmp / "store"),
        c.FUGUE_TPU_CONF_SERVE_JOURNAL_DIR: str(tmp / "journal"),
        c.FUGUE_TPU_CONF_SERVE_REPLICA_ID: rid,
        c.FUGUE_TPU_CONF_VIEWS_ENABLED: True,
        c.FUGUE_TPU_CONF_VIEWS_POLL_S: 3600.0,
        "fugue.tpu.tuning.enabled": False,
    }
    conf.update(extra)
    return conf


def _server(pkg, tmp, rid="A", **extra):
    """A started server whose maintainer loop is parked: its first tick at
    ``start()`` has finished and no other comes, so only the case's
    ``tick_once()`` calls advance the views (a loop tick running beside
    one of them would publish a generation twice)."""
    srv = pkg.serve.EngineServer(pkg.make_engine(_conf(pkg, tmp, rid, **extra))).start()
    m = srv.views.maintainer
    m.halt_for_test()
    m._stop_evt.clear()
    return srv


def _expire_view_lease(srv, view_id: str) -> None:
    expire_lease(srv.views.maintainer._board._lease(view_id))


# -- generations ------------------------------------------------------------------


def case_multi_generation(pkg, tmp):
    src = _src(tmp)
    srv = _server(pkg, tmp)
    try:
        vs, m = srv.views, srv.views.maintainer
        vs.register("agg", _factory(pkg, src), src, fmt="parquet", tenant="t1")
        m.tick_once()
        seen = []
        res = vs.result("agg")
        seen.append((res["generation"], res["mode"], _result_rows(res) == _oracle(src)))
        for i in range(2, 5):
            _write_part(src, i)
            m.tick_once()
            res = vs.result("agg")
            seen.append((res["generation"], res["mode"], res["staleness_s"] >= 0.0,
                         _result_rows(res) == _oracle(src)))
        st = srv.engine.stats()["views"]
        d = vs.describe("agg")
        return {"seen": seen, "rows": _result_rows(res),
                "stats": {k: st[k] for k in ("generations_published", "delta_refusals", "steady_partitions_fresh",
                                             "steady_partitions_total")},
                "describe": (d["generation"], d["partitions"], d["maintainer"]), "stats_keys": sorted(st)}
    finally:
        srv.stop()


def test_multi_generation_append_bit_identical(tmp_path, port):
    got = both(case_multi_generation, port, tmp_path)
    assert got["seen"][0] == (1, "full", True)
    assert got["seen"][1:] == [(g, "delta", True, True) for g in (2, 3, 4)]
    assert got["stats"] == {"generations_published": 4, "delta_refusals": 0, "steady_partitions_fresh": 3,
                            "steady_partitions_total": 12}


def case_unchanged(pkg, tmp):
    src = _src(tmp)
    srv = _server(pkg, tmp)
    try:
        vs = srv.views
        vs.register("agg", _factory(pkg, src), src, fmt="parquet")
        for _ in range(3):
            vs.maintainer.tick_once()
        st = vs.stats.as_dict()
        return (st["refreshes"], st["generations_published"])
    finally:
        srv.stop()


def test_unchanged_source_publishes_nothing(tmp_path, port):
    assert both(case_unchanged, port, tmp_path) == (1, 1)


def case_refusal(pkg, tmp):
    src = _src(tmp)
    srv = _server(pkg, tmp)
    try:
        vs, m = srv.views, srv.views.maintainer
        vs.register("agg", _factory(pkg, src), src, fmt="parquet")
        m.tick_once()
        _write_part(src, 2)
        m.tick_once()
        mode2 = vs.result("agg")["mode"]
        _write_part(src, 0, rows=16, scale=3.0)
        m.tick_once()
        res = vs.result("agg")
        head = vs.registry.head("agg")
        st = srv.engine.stats()["views"]
        return {"mode2": mode2, "gen3": (res["generation"], res["mode"]), "equal": _result_rows(res) == _oracle(src),
                "rewrite": "rewrite" in (head.get("reason") or ""),
                "counts": (st["delta_refusals"], st["full_recomputes"])}
    finally:
        srv.stop()


def test_delta_refusal_degrades_to_full_recompute(tmp_path, port):
    assert both(case_refusal, port, tmp_path) == {"mode2": "delta", "gen3": (3, "full"), "equal": True,
                                                  "rewrite": True, "counts": (1, 1)}


def case_wal_replay(pkg, tmp):
    src = _src(tmp)
    srv = _server(pkg, tmp, **{pkg.c.FUGUE_TPU_CONF_FAULT_PLAN: "view.register=error@1"})
    try:
        with pytest.raises(pkg.InjectedFaultError):
            srv.views.register("agg", _factory(pkg, src), src, fmt="parquet")
        before = srv.views.registry.get("agg") is None
    finally:
        srv.stop()
    srv2 = _server(pkg, tmp)
    try:
        vs = srv2.views
        spec = vs.registry.get("agg")
        vs.maintainer.tick_once()
        res = vs.result("agg")
        return {"unpublished": before, "replayed": (spec is not None, spec.tenant),
                "generation": res["generation"], "equal": _result_rows(res) == _oracle(src)}
    finally:
        srv2.stop()


def test_registration_replays_from_wal_after_crash(tmp_path, port):
    assert both(case_wal_replay, port, tmp_path) == {"unpublished": True, "replayed": (True, "default"),
                                                     "generation": 1, "equal": True}


def case_lease_steal(pkg, tmp):
    src = _src(tmp)
    lease = {pkg.c.FUGUE_TPU_CONF_VIEWS_LEASE_S: 0.5}
    a = _server(pkg, tmp, rid="A", **lease)
    b = _server(pkg, tmp, rid="B", **lease)
    try:
        a.views.register("agg", _factory(pkg, src), src, fmt="parquet")
        a.views.maintainer.tick_once()
        seen = [a.views.result("agg")["generation"], a.views.maintainer.holder("agg")]
        a.views.maintainer.halt_for_test()
        _write_part(src, 2)
        seen.append(b.views.result("agg")["generation"])
        b.views.maintainer.tick_once()
        seen.append(b.views.result("agg")["generation"])
        _expire_view_lease(a, "agg")  # A's lease runs out
        b.views.maintainer.tick_once()
        res = b.views.result("agg")
        st = b.engine.stats()["views"]
        return {"seen": seen, "after": (res["generation"], _result_rows(res) == _oracle(src),
                                        b.views.maintainer.holder("agg")),
                "counts": (st["lease_steals"], st["lease_acquires"])}
    finally:
        a.stop()
        b.stop()


def test_lease_steal_moves_maintenance_to_survivor(tmp_path, port):
    assert both(case_lease_steal, port, tmp_path) == {"seen": [1, "A", 1, 1], "after": (2, True, "B"),
                                                      "counts": (1, 0)}


def case_unregister(pkg, tmp):
    src = _src(tmp)
    srv = _server(pkg, tmp)
    try:
        vs, m = srv.views, srv.views.maintainer
        vs.register("agg", _factory(pkg, src), src, fmt="parquet")
        m.tick_once()
        key = pkg.serve.view_result_key("agg", 1)
        seen = [vs._fleet.load_result(key) is not None, vs.unregister("agg"), vs.registry.get("agg") is None,
                vs.list() == [] and vs.result("agg") is None, vs._fleet.load_result(key) is None]
        m.tick_once()
        seen += [m.holder("agg"), m.health()["maintaining"], vs.stats.as_dict()["unregistered"],
                 vs.unregister("agg")]
    finally:
        srv.stop()
    srv2 = _server(pkg, tmp)
    try:
        seen.append(srv2.views.registry.get("agg") is None)
    finally:
        srv2.stop()
    return seen


def test_unregister_stops_maintenance_and_releases_everything(tmp_path, port):
    assert both(case_unregister, port, tmp_path) == [True, True, True, True, True, None, [], 1, False, True]


def case_reregister(pkg, tmp):
    src = _src(tmp)
    srv = _server(pkg, tmp)
    try:
        vs = srv.views
        vs.register("agg", _factory(pkg, src), src, fmt="parquet")
        vs.maintainer.tick_once()
        gone = vs.unregister("agg")
        vs.register("agg", _factory(pkg, src), src, fmt="parquet")
        back = vs.registry.get("agg") is not None
        vs.maintainer.tick_once()
        gen = vs.result("agg")["generation"]
    finally:
        srv.stop()
    srv2 = _server(pkg, tmp)
    try:
        return (gone, back, gen, srv2.views.registry.get("agg") is not None)
    finally:
        srv2.stop()


def test_reregister_after_unregister_is_a_fresh_view(tmp_path, port):
    assert both(case_reregister, port, tmp_path) == (True, True, 1, True)


def case_validation(pkg, tmp):
    src = _src(tmp)
    srv = _server(pkg, tmp, **{"fugue.tpu.views.max": 1})
    try:
        vs = srv.views
        errors = []
        for args in (("bad--id", _factory(pkg, src), src), ("built", _factory(pkg, src)(), src),
                     ("noyield", pkg.FugueWorkflow, src)):
            with pytest.raises(ValueError) as ei:
                vs.register(*args)
            errors.append(str(ei.value).split(" ")[0:3])
        vs.register("agg", _factory(pkg, src), src, fmt="parquet", tenant="t1")
        vs.register("agg", _factory(pkg, src), src, fmt="parquet", tenant="t1")
        n = len(vs.list())
        for args in (("agg", _factory(pkg, src), src + "x"), ("two", _factory(pkg, src), src)):
            with pytest.raises(ValueError) as ei:
                vs.register(*args, fmt="parquet", tenant="t1")
            errors.append(("already registered" in str(ei.value), "max" in str(ei.value)))
        return {"errors": errors, "n": n}
    finally:
        srv.stop()


def test_register_validation_and_caps(tmp_path, port):
    got = both(case_validation, port, tmp_path)
    assert got["n"] == 1 and got["errors"][-2:] == [(True, False), (False, True)]


def case_slo_boost(pkg, tmp):
    src = _src(tmp)
    srv = _server(pkg, tmp, **{"fugue.tpu.serve.max_concurrent": 1, "fugue.tpu.serve.aging_s": 1000.0,
                               "fugue.tpu.serve.tenant.slo.freshness_s": 1.0,
                               "fugue.tpu.views.refresh_timeout_s": 60.0})
    try:
        vs, m = srv.views, srv.views.maintainer
        vs.register("agg", _factory(pkg, src), src, fmt="parquet", tenant="slo")
        m.tick_once()
        _write_part(src, 2)
        with m._lock:
            m._pending_since["agg"] = time.time() - 100.0  # observed long ago: breached
        release, entered = threading.Event(), threading.Event()

        def blocker_factory():
            def make() -> pd.DataFrame:
                entered.set()
                assert release.wait(30)
                return pd.DataFrame({"k": [1], "v": [1.0]})

            dag = pkg.FugueWorkflow()
            dag.create(make, schema="k:long,v:double").yield_dataframe_as("r", as_local=True)
            return dag

        blocker = srv.submit(blocker_factory, tenant="other")
        assert entered.wait(30)  # the single worker is held
        t = threading.Thread(target=m.tick_once)  # blocks on the refresh
        t.start()
        found = {}

        def queued():
            with srv._lock:
                for ex in srv._queue:
                    if ex.tenant == "slo":
                        found["ex"] = ex
            return "ex" in found

        assert wait_for(queued)
        refresh_ex = found["ex"]
        boosted = refresh_ex.priority

        def competitor_factory():
            dag = pkg.FugueWorkflow()
            (dag.df(pd.DataFrame({"k": [2], "v": [4.0]})).partition_by("k")
             .aggregate(pkg.ff.sum(pkg.col("v")).alias("s")).yield_dataframe_as("r", as_local=True))
            return dag

        comp = srv.submit(competitor_factory, tenant="other")
        release.set()
        t.join(60)
        comp.result(timeout=60)
        blocker.result(timeout=60)
        res = vs.result("agg")
        head = vs.registry.head("agg")
        st = srv.engine.stats()["views"]
        return {"boosted": boosted == srv.default_priority - 2,
                "refresh_first": refresh_ex.started_at < comp._execution.started_at,
                "gen": res["generation"], "equal": _result_rows(res) == _oracle(src),
                "head": head["slo_boosted"], "counts": (st["slo_boosts"] >= 1, st["slo_breaches"] >= 1)}
    finally:
        srv.stop()


def test_slo_boost_observable_in_admission_order(tmp_path, port):
    assert both(case_slo_boost, port, tmp_path) == {"boosted": True, "refresh_first": True, "gen": 2,
                                                    "equal": True, "head": True, "counts": (True, True)}


def case_events(pkg, tmp):
    src = _src(tmp)
    d = str(tmp / "events")
    log = pkg.events.get_event_log()
    lease = {pkg.c.FUGUE_TPU_CONF_EVENTS_ENABLED: True, pkg.c.FUGUE_TPU_CONF_EVENTS_DIR: d,
             pkg.c.FUGUE_TPU_CONF_VIEWS_LEASE_S: 0.5}
    try:
        a = _server(pkg, tmp, rid="A", **lease)
        b = _server(pkg, tmp, rid="B", **lease)
        try:
            a.views.register("agg", _factory(pkg, src), src, fmt="parquet")
            a.views.maintainer.tick_once()
            _write_part(src, 2)
            a.views.maintainer.tick_once()
            a.views.maintainer.halt_for_test()
            _write_part(src, 3)
            _expire_view_lease(a, "agg")
            b.views.maintainer.tick_once()
            gen = b.views.result("agg")["generation"]
            b.views.unregister("agg")
            sa, sb = a.views.stats.as_dict(), b.views.stats.as_dict()
        finally:
            a.stop()
            b.stop()
        by_type: dict = {}
        for e in pkg.events.read_events(d):
            if e["type"].startswith("view."):
                by_type.setdefault(e["type"], []).append(e)
        parity = [
            len(by_type["view.register"]) == sa["registered"] + sb.get("registered", 0),
            len(by_type["view.lease.acquire"]) == sa["lease_acquires"],
            len(by_type["view.lease.steal"]) == sb["lease_steals"],
            len(by_type["view.refresh"]) == sa["refreshes"] + sb["refreshes"],
            len(by_type["view.publish"]) == sa["generations_published"] + sb["generations_published"],
            len(by_type["view.unregister"]) == sb["unregistered"],
        ]
        steal = by_type["view.lease.steal"][0]
        from tools.fugue_timeline import main as timeline_main

        return {"gen": gen, "parity": parity, "types": sorted(by_type),
                "publish_gens": sorted(e["gen"] for e in by_type["view.publish"]),
                "steal": (steal["owner"], steal["prev_owner"]),
                "timeline": (timeline_main([d, "--view", "agg"]), timeline_main([d, "--view", "nosuch"]))}
    finally:
        log.configure(d, False)
        log.close()


def test_events_counter_parity_and_timeline(tmp_path, port, capsys):
    got = both(case_events, port, tmp_path)
    assert got["gen"] == 3 and all(got["parity"]) and got["publish_gens"] == [1, 2, 3]
    assert got["steal"] == ("B", "A") and got["timeline"] == (0, 2)


def case_kill_switch(pkg, tmp):
    src = _src(tmp)
    c = pkg.c
    eng = pkg.make_engine({c.FUGUE_TPU_CONF_CACHE_DIR: str(tmp / "store"),
                           c.FUGUE_TPU_CONF_SERVE_JOURNAL_DIR: str(tmp / "journal"),
                           c.FUGUE_TPU_CONF_SERVE_REPLICA_ID: "A", "fugue.tpu.tuning.enabled": False})
    srv = pkg.serve.EngineServer(eng).start()
    try:
        seen = [srv.views is None, "views" not in eng.stats(), "views" not in srv.stats(),
                not any(t.name == "fugue-view-maintainer" for t in threading.enumerate())]
        before = pkg.events.get_event_log().as_dict()["emitted"]
        srv.submit(_factory(pkg, src)).result(timeout=60)
        seen.append(pkg.events.get_event_log().as_dict()["emitted"] == before)
        return seen
    finally:
        srv.stop()


def test_kill_switch_default_off(tmp_path, port):
    assert all(both(case_kill_switch, port, tmp_path))


def case_no_store(pkg, tmp):
    eng = pkg.make_engine({pkg.c.FUGUE_TPU_CONF_VIEWS_ENABLED: True, "fugue.tpu.cache.enabled": False,
                           "fugue.tpu.tuning.enabled": False})
    srv = pkg.serve.EngineServer(eng).start()
    try:
        return srv.views is None
    finally:
        srv.stop()


def test_views_disabled_without_shared_store(tmp_path, port):
    assert both(case_no_store, port, tmp_path) is True


def case_fleet_lru(pkg, tmp):
    from_fleet = pkg.serve.FleetCoordinator
    key = pkg.serve.view_result_key
    store = pkg.ArtifactStore(str(tmp / "store"), 0)
    fleet = from_fleet(store, "A", max_results=2)
    frames = {"r": (pd.DataFrame({"x": [1]}), "x:long")}
    old = time.time() - 1000
    fleet.publish_result(key("agg", 1), frames)
    fleet.publish_result(key("agg", 2), frames)
    for p in (fleet._result_path(key("agg", 1)), fleet._result_path(key("agg", 2))):
        os.utime(p, (old, old))
    for i in range(4):
        fleet.publish_result(f"req-{i}", frames)
    names = os.listdir(fleet.results_dir)
    return (fleet.load_result(key("agg", 2)) is not None, fleet.load_result(key("agg", 1)) is None,
            sum(1 for n in names if pkg.serve.parse_view_result_name(n) is None))


def test_fleet_lru_pins_latest_generation_per_view(tmp_path, port):
    assert both(case_fleet_lru, port, tmp_path) == (True, True, 2)


def case_key_roundtrip(pkg, tmp):
    s = pkg.serve
    return (s.parse_view_result_name(s.view_result_key("hourly_agg.v2", 7) + ".result.pkl"),
            s.parse_view_result_name("abcdef.result.pkl"), s.parse_view_result_name("view--x--g0001.weird"))


def test_view_result_key_roundtrip(tmp_path, port):
    assert both(case_key_roundtrip, port, tmp_path) == (("hourly_agg.v2", 7), None, None)


def case_classify(pkg, tmp):
    classify = pkg.views.classify_tokens

    def tok(path, size, mtime):
        return {"path": path, "size": size, "mtime_ns": mtime}

    base = [tok("a", 10, 1), tok("b", 20, 2)]
    grown_tail = [tok("a", 10, 1), tok("b", 25, 9)]
    return [classify(base, list(base), "parquet"), classify(base, base + [tok("c", 5, 3)], "parquet"),
            classify(base, [tok("a", 11, 9), tok("b", 20, 2)], "parquet")[0],
            classify(base, base[:1], "parquet")[0], classify(base, grown_tail, "csv"),
            classify(base, grown_tail, "parquet")[0]]


def test_watcher_classification(tmp_path, port):
    assert both(case_classify, port, tmp_path) == [("unchanged", 0), ("append", 1), "rewrite", "rewrite",
                                                   ("append", 1), "rewrite"]


# -- heartbeats and leases --------------------------------------------------------


def _age_beat(hb_dir: str, name: str, seconds: float) -> None:
    """Make ``name``'s beat ``seconds`` older: its ``ts`` and its file's
    mtime, which a reader takes the later of."""
    path = os.path.join(hb_dir, f"{name}.hb.json")
    with open(path) as f:
        beat = json.load(f)
    beat["ts"] = float(beat["ts"]) - seconds
    with open(path, "w") as f:
        json.dump(beat, f)
    os.utime(path, (beat["ts"], beat["ts"]))


def case_heartbeat(pkg, tmp):
    hb_mod = pkg.heartbeat
    d = str(tmp / "hb")
    hb = hb_mod.HeartbeatWriter(d, "w0", interval_s=0.1)
    seen = [hb.beat()]
    payload = hb_mod.read_heartbeat(d, "w0")
    seen.append((payload["name"], payload["pid"] == os.getpid(), payload["seq"]))
    seen.append(hb_mod.holder_alive("w0", d, stale_after_s=5.0))
    _age_beat(d, "w0", 10.0)
    seen.append(hb_mod.holder_alive("w0", d, stale_after_s=5.0))
    seen.append(round(hb_mod.heartbeat_age_s(hb_mod.read_heartbeat(d, "w0"))) >= 10)
    seen += [hb_mod.holder_alive("nobody", d), hb_mod.holder_alive("w0", None)]
    with open(os.path.join(d, "torn.hb.json"), "w") as f:
        f.write('{"name": "torn"')
    seen.append(hb_mod.holder_alive("torn", d))
    # the loop beats, and an orderly stop removes the beat
    w = hb_mod.HeartbeatWriter(d, "w1", interval_s=0.05).start()
    first = hb_mod.read_heartbeat(d, "w1")["seq"]
    seen.append(wait_for(lambda: hb_mod.read_heartbeat(d, "w1")["seq"] > first))
    w.stop(remove=True)
    seen.append(hb_mod.read_heartbeat(d, "w1"))
    # the dist.heartbeat fault site skips beats
    from_conf = pkg.serve.server.FaultInjector
    f = hb_mod.HeartbeatWriter(d, "w2", interval_s=0.05, injector=from_conf("dist.heartbeat=error@2"))
    seen += [f.beat(), f.beat(), f.beat(), f.skipped]
    return seen


def test_heartbeat_write_read_fresh_stale_loop_and_fault(tmp_path, port):
    assert both(case_heartbeat, port, tmp_path) == [True, ("w0", True, 1), True, False, True, None, None, None,
                                                    True, None, False, False, True, 2]


def case_leases(pkg, tmp):
    LeaseBoard, HeartbeatWriter = pkg.lease.LeaseBoard, pkg.heartbeat.HeartbeatWriter
    lb = LeaseBoard(str(tmp / "a"))
    seen = [lb.try_acquire("t1", "w0", lease_s=30.0)[0]]
    owned, holder = lb.try_acquire("t1", "w1", lease_s=30.0)
    seen += [owned, holder["owner"], lb.renew("t1", "w0", 30.0), lb.renew("t1", "w1", 30.0),
             lb.release("t1", "w0"), lb.try_acquire("t1", "w1", lease_s=30.0)[0]]
    # expiry: the holder's clock moved back past its lease
    lb2 = LeaseBoard(str(tmp / "b"))
    seen.append(lb2.try_acquire("t1", "w0", lease_s=0.1)[0])
    expire_lease(lb2._lease("t1"))
    owned, cur = lb2.try_acquire("t1", "w1", lease_s=5.0)
    seen += [owned, cur["owner"], lb2.release("t1", "w0"), lb2.read("t1")["owner"]]
    # the heartbeat matrix
    hb_dir = str(tmp / "hb")
    lb3 = LeaseBoard(str(tmp / "leases"), hb_dir=hb_dir, hb_stale_s=0.3)
    HeartbeatWriter(hb_dir, "w0", interval_s=0.05).beat()
    seen.append(lb3.try_acquire("t1", "w0", lease_s=30.0)[0])
    seen += [lb3.stealable(lb3.read("t1")), lb3.try_acquire("t1", "w1", lease_s=30.0)[0]]
    _age_beat(hb_dir, "w0", 1.0)  # a stale beat: provably dead, stealable mid-lease
    seen.append(lb3.steal_reason(lb3.read("t1")))
    owned, cur = lb3.try_acquire("t1", "w1", lease_s=30.0)
    seen += [owned, cur["owner"]]
    HeartbeatWriter(hb_dir, "w1", interval_s=0.05).beat()
    seen.append(lb3.stealable(lb3.read("t1")))
    expire_lease(lb3._lease("t1"))  # a fresh beat never pins an expired lease
    seen.append(lb3.steal_reason(lb3.read("t1")))
    return seen


def test_lease_acquire_expire_and_heartbeat_matrix(tmp_path, port):
    assert both(case_leases, port, tmp_path) == [True, False, "w0", True, False, True, True, True, True, "w1",
                                                 False, "w1", True, False, False, "worker_lost", True, "w1",
                                                 False, "expired"]


def case_store_claim_heartbeat(pkg, tmp):
    hb_dir = str(tmp / "hb")
    os.makedirs(hb_dir)
    store = pkg.ArtifactStore(str(tmp / "store"), cap_bytes=0, hb_dir=hb_dir, hb_stale_s=0.3)
    seen = [store.try_claim("key1", "r0", lease_s=30.0)[0], store.try_claim("key1", "r1", lease_s=30.0)[0]]
    pkg.heartbeat.HeartbeatWriter(hb_dir, "r0", interval_s=0.05).beat()
    _age_beat(hb_dir, "r0", 1.0)
    owned, cur = store.try_claim("key1", "r1", lease_s=30.0)
    seen += [owned, cur["owner"]]
    pkg.heartbeat.HeartbeatWriter(hb_dir, "r1", interval_s=0.05).beat()
    seen.append(store.try_claim("key1", "r2", lease_s=30.0)[0])
    return seen


def test_store_claim_steal_uses_heartbeat_liveness(tmp_path, port):
    assert both(case_store_claim_heartbeat, port, tmp_path) == [True, False, True, "r1", False]


def case_server_heartbeat(pkg, tmp):
    hb_dir = str(tmp / "hb")
    eng = pkg.make_engine({"fugue.tpu.dist.heartbeat.dir": hb_dir, "fugue.tpu.dist.heartbeat.interval_s": 0.05,
                           "fugue.tpu.serve.replica_id": "rX", "fugue.tpu.cache.enabled": False,
                           "fugue.tpu.tuning.enabled": False})
    srv = pkg.serve.EngineServer(eng).start()
    try:
        seen = [pkg.heartbeat.holder_alive("rX", hb_dir, stale_after_s=5.0), srv.stats()["heartbeat_enabled"]]
    finally:
        srv.stop()
    return seen + [pkg.heartbeat.read_heartbeat(hb_dir, "rX")]


def test_engine_server_adopts_heartbeat_liveness(tmp_path, port):
    assert both(case_server_heartbeat, port, tmp_path) == [True, True, None]
