"""The worker tier of the port (``fugue_tpu_torch/dist``: the board, the
worker, the supervisor, their counters; ``shuffle/partitioner.py``'s key
hashing) against the JAX package's: the cases of
``tests/distributed/test_dist.py`` that ``tests/test_torch_views.py`` does
not take, each written once over ``torch_dist_common.Side`` and run
through both packages, the supervisor on the package's native engine and
on its device engine (``JaxExecutionEngine`` on the CPU mesh against
``TorchExecutionEngine(device="cpu")``). Each case returns what it
observed (results against the package's own serial path, audits,
counters, failure categories, spans); both packages must observe the
same. A heartbeat goes stale by moving its timestamps, never by
sleeping. Then the content addresses and bucket ids bit for bit, the
worker as a process of its own, and ``chip_smoke.phase_dist_path`` at a
small size in a process that loads no JAX.
"""

import json
import os
import subprocess
import sys
import threading
import time

import cloudpickle
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
from torch_dist_common import PORT, REF, WorkerPool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = {
    "fugue.tpu.dist.heartbeat.interval_s": 0.1,
    "fugue.tpu.dist.heartbeat.stale_after_s": 0.6,
    "fugue.tpu.dist.lease_s": 2.0,
    "fugue.tpu.dist.poll_s": 0.01,
    "fugue.tpu.cache.enabled": False,
    "fugue.tpu.tuning.enabled": False,
}
KINDS = ["native", "device"]


def _write_inputs(root, n_left=3, n_right=2):
    data = os.path.join(str(root), "data")
    os.makedirs(data, exist_ok=True)
    left, right = [], []
    for i in range(n_left):
        p = os.path.join(data, f"l{i}.parquet")
        pd.DataFrame({"k": [(j * 3 + i) % 7 for j in range(40)],
                      "v": [float(j + i * 40) for j in range(40)]}).to_parquet(p)
        left.append(p)
    for i in range(n_right):
        p = os.path.join(data, f"r{i}.parquet")
        pd.DataFrame({"k": list(range(7)), "w": [float(i * 10 + j) for j in range(7)]}).to_parquet(p)
        right.append(p)
    return left, right


def _map_left(pdf):
    return pdf.assign(v2=pdf["v"] * 2.0)


def _reduce(l, r):
    m = l.merge(r, on="k", how="inner")
    m = m.assign(x=m["v2"] * m["w"])
    return m.groupby("k", as_index=False).agg(s=("x", "sum"), n=("x", "count"))


def _combine(parts):
    pdf = pd.concat(parts, ignore_index=True) if parts else pd.DataFrame()
    return pdf.groupby("k", as_index=False).agg(s=("s", "sum"), n=("n", "sum")).sort_values("k").reset_index(
        drop=True)


def _sup(side, board, kind, **conf):
    engine = side.make_engine(kind, CONF) if kind == "device" else None
    return side.dist.DistSupervisor(str(board), engine=engine, conf=dict(CONF, **conf))


def _serial(side, board, left, right, kind, **kw):
    sup = _sup(side, board, kind, **{"fugue.tpu.dist.enabled": False})
    return sup.run_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, **kw)


def _rows(pdf):
    return pdf.to_dict("list")


def _age_beat(hb_dir, name, seconds):
    """Make ``name``'s beat ``seconds`` older: its ``ts`` and its file's
    mtime, which a reader takes the later of."""
    path = os.path.join(hb_dir, f"{name}.hb.json")
    with open(path) as f:
        beat = json.load(f)
    beat["ts"] = float(beat["ts"]) - seconds
    with open(path, "w") as f:
        json.dump(beat, f)
    os.utime(path, (beat["ts"], beat["ts"]))


def both(case, tmp_path, *args):
    want = case(REF, tmp_path / "ref", *args)
    got = case(PORT, tmp_path / "port", *args)
    assert got == want
    return got


def _zero(audit):
    return audit["rows_lost"] == 0 and audit["rows_double_counted"] == 0


# ---------------------------------------------------------------------------
# jobs: serial oracle, kill switch, end-to-end bit identity
# ---------------------------------------------------------------------------


def case_serial(side, tmp, kind):
    left, right = _write_inputs(tmp)
    serial = _serial(side, tmp / "board", left, right, kind, buckets=4)
    l = _map_left(pd.concat([pd.read_parquet(p) for p in left], ignore_index=True))
    r = pd.concat([pd.read_parquet(p) for p in right], ignore_index=True)
    m = l.merge(r, on="k", how="inner")
    m = m.assign(x=m["v2"] * m["w"])
    want = m.groupby("k", as_index=False).agg(s=("x", "sum"), n=("x", "count")).sort_values("k").reset_index(
        drop=True)
    pd.testing.assert_frame_equal(serial, want)
    return _rows(serial)


@pytest.mark.parametrize("kind", KINDS)
def test_serial_path_matches_direct_pandas(tmp_path, kind):
    both(case_serial, tmp_path, kind)


def case_end_to_end(side, tmp, kind):
    left, right = _write_inputs(tmp)
    board = tmp / "board"
    serial = _serial(side, tmp / "oracle", left, right, kind, buckets=4)
    with WorkerPool(side, board, 2, CONF):
        sup = _sup(side, board, kind)
        jid = sup.plan_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=4)
        got = sup.wait_job(jid, timeout=60)
        audit = sup.audit_job(jid)
        d = sup.engine.stats()["dist"]
    return [got.equals(serial), _rows(got), audit, d["jobs"], d["map_tasks"], d["reduce_tasks"],
            bool(d["workers"]), sum(s.get("tasks_completed", 0) for s in d["workers"].values()) >= 1]


@pytest.mark.parametrize("kind", KINDS)
def test_dist_end_to_end_bit_identical_and_audit_zero(tmp_path, kind):
    got = both(case_end_to_end, tmp_path, kind)
    assert got[0] and _zero(got[2]) and got[2]["map_done"] == 5 and got[2]["reduce_done"] == 4
    assert got[3:] == [1, 5, 4, True, True]


def case_lease_expiry(side, tmp, kind):
    """A ghost grabs a map lease, beats once and dies: a live worker
    steals the lease once the beat is stale, classified WORKER_LOST at
    the steal site, and the job completes bit-identically."""
    left, right = _write_inputs(tmp)
    board = tmp / "board"
    serial = _serial(side, tmp / "oracle", left, right, kind, buckets=4)
    sup = _sup(side, board, kind)
    jid = sup.plan_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=4)
    tid = f"{jid}-m-left-0000"
    side.dist.HeartbeatWriter(sup.board.hb_dir, "ghost", interval_s=0.05).beat()
    owned = sup.leases.try_acquire(tid, "ghost", lease_s=30.0)[0]
    _age_beat(sup.board.hb_dir, "ghost", 1.0)
    with WorkerPool(side, board, 2, CONF):
        got = sup.wait_job(jid, timeout=60)
    return [owned, got.equals(serial), sup.engine.stats()["dist"]["redispatch_worker_lost"] >= 1]


@pytest.mark.parametrize("kind", KINDS)
def test_lease_expiry_mid_task_redispatched_worker_lost(tmp_path, kind):
    assert both(case_lease_expiry, tmp_path, kind) == [True, True, True]


def case_speculative(side, tmp, kind):
    """The owner and the speculative twin both run the same reduce: the
    artifact dedups by content address, one done record survives, the
    loser counts its publish."""
    left, right = _write_inputs(tmp, n_left=1, n_right=1)
    board = tmp / "board"
    w0 = side.dist.DistWorker(str(board), "w0", conf=dict(CONF), start_http=False)
    w1 = side.dist.DistWorker(str(board), "w1", conf=dict(CONF), start_http=False)
    sup = _sup(side, board, kind)
    jid = sup.plan_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=1)
    seen = [w0.run_task(tid) for tid in sup.board.list_tasks() if "-m-" in tid]
    rtid = f"{jid}-r-0000"
    sup.board.mark_speculative(rtid)
    seen.append(w0.leases.try_acquire(rtid, "w0", lease_s=30.0)[0])
    w0.heartbeat.beat()
    seen += [w1.run_task(rtid, speculative=True), w1.stats.get("speculative_wins")]
    w0.leases.release(rtid, "w0")
    seen += [w0.run_task(rtid), w0.stats.get("duplicate_publishes")]
    seen.append(len([n for n in os.listdir(sup.board.done_dir) if n.startswith(rtid)]))
    rec = sup.board.read_done(rtid)
    store = side.ArtifactStore(sup.board.store_dir, cap_bytes=0)
    seen += [rec["worker"], rec["speculative"], len([n for n in os.listdir(store.objs) if n == rec["fp"] + ".parquet"])]
    got = sup.wait_job(jid, timeout=30)
    return seen + [got.equals(_serial(side, tmp / "oracle", left, right, kind, buckets=1))]


@pytest.mark.parametrize("kind", KINDS)
def test_speculative_duplicate_publish_one_record_one_artifact(tmp_path, kind):
    assert both(case_speculative, tmp_path, kind) == [True, True, True, True, 1, True, 1, 1, "w1", True, 1, True]


def case_restart(side, tmp, kind):
    """All job state lives on the board: a new supervisor picks up an
    in-flight job by id and completes it."""
    left, right = _write_inputs(tmp)
    board = tmp / "board"
    serial = _serial(side, tmp / "oracle", left, right, kind, buckets=4)
    sup1 = _sup(side, board, kind)
    jid = sup1.plan_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=4)
    with WorkerPool(side, board, 2, CONF):
        deadline = time.monotonic() + 30
        while sup1.board.done_count(sup1.board.list_tasks()) == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        del sup1
        sup2 = _sup(side, board, kind)
        got = sup2.wait_job(jid, timeout=60)
        audit = sup2.audit_job(jid)
    return [got.equals(serial), _zero(audit)]


@pytest.mark.parametrize("kind", KINDS)
def test_supervisor_restart_resumes_inflight_job(tmp_path, kind):
    assert both(case_restart, tmp_path, kind) == [True, True]


def case_kill_switch(side, tmp, kind):
    left, right = _write_inputs(tmp)
    with WorkerPool(side, tmp / "board", 2, CONF):
        sup = _sup(side, tmp / "board", kind)
        dist = sup.run_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=4,
                                timeout=60)
    off = _sup(side, tmp / "serial_board", kind, **{"fugue.tpu.dist.enabled": False})
    serial = off.run_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=4)
    return [dist.equals(serial), off.board.list_tasks(), _rows(serial)]


@pytest.mark.parametrize("kind", KINDS)
def test_kill_switch_restores_single_process_bit_identically(tmp_path, kind):
    got = both(case_kill_switch, tmp_path, kind)
    assert got[:2] == [True, []]


# ---------------------------------------------------------------------------
# the network-partitioned exchange: remote fetch + orphan recovery
# ---------------------------------------------------------------------------


def case_remote_fetch(side, tmp, kind):
    left, right = _write_inputs(tmp)
    board = tmp / "board"
    serial = _serial(side, tmp / "oracle", left, right, kind, buckets=4)
    conf = dict(CONF, **{"fugue.tpu.dist.fetch": "remote"})
    producer = side.dist.DistWorker(str(board), "wp", conf=conf, start_http=True).start()
    consumer = side.dist.DistWorker(str(board), "wc", conf=conf, start_http=True).start()
    try:
        sup = _sup(side, board, kind, **{"fugue.tpu.dist.fetch": "remote"})
        jid = sup.plan_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=4)
        seen = [producer.run_task(t) for t in sup.board.list_tasks() if "-m-" in t]
        seen += [consumer.run_task(t) for t in sup.board.list_tasks() if "-r-" in t]
        got = sup.wait_job(jid, timeout=30)
        return seen + [got.equals(serial), consumer.stats.get("fragments_remote") > 0,
                       consumer.stats.get("fragments_local"), _zero(sup.audit_job(jid))]
    finally:
        producer.stop()
        consumer.stop()


@pytest.mark.parametrize("kind", KINDS)
def test_remote_fragment_fetch_over_http(tmp_path, kind):
    assert both(case_remote_fetch, tmp_path, kind) == [True] * 9 + [True, True, 0, True]


def case_orphan(side, tmp, kind):
    """The producer dies after its maps, before the consumer fetched: the
    consumer proves the fragments unreachable (a refused connection:
    WORKER_LOST), invalidates the producer's done records, re-runs the
    maps and the job completes bit-identically."""
    left, right = _write_inputs(tmp, n_left=2, n_right=1)
    board = tmp / "board"
    serial = _serial(side, tmp / "oracle", left, right, kind, buckets=2)
    conf = dict(CONF, **{"fugue.tpu.dist.fetch": "remote"})
    producer = side.dist.DistWorker(str(board), "wp", conf=conf, start_http=True).start()
    consumer = side.dist.DistWorker(str(board), "wc", conf=conf, start_http=True).start()
    sup = _sup(side, board, kind, **{"fugue.tpu.dist.fetch": "remote"})
    jid = sup.plan_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=2)
    map_tids = [t for t in sup.board.list_tasks() if "-m-" in t]
    seen = [producer.run_task(t) for t in map_tids]
    producer._rpc.stop_server()
    producer.heartbeat.stop(remove=False)
    _age_beat(sup.board.hb_dir, "wp", 1.0)
    with pytest.raises(side.resilience.WorkerLostError) as ei:
        consumer._execute_reduce(consumer.board.read_task(f"{jid}-r-0000"))
    seen += [side.resilience.classify_failure(ei.value).value, consumer.stats.get("orphaned_outputs_recovered") >= 1,
             any(sup.board.read_done(t) is None for t in map_tids)]
    stop = os.path.join(str(board), "_stop")
    t = threading.Thread(target=consumer.serve_forever, kwargs={"stop_file": stop}, daemon=True)
    t.start()
    try:
        got = sup.wait_job(jid, timeout=60)
        seen += [got.equals(serial), _zero(sup.audit_job(jid))]
    finally:
        with open(stop, "w") as f:
            f.write("stop")
        t.join(timeout=10)
        consumer.stop()
        producer.stop()
    return seen


@pytest.mark.parametrize("kind", KINDS)
def test_orphaned_fragment_recovery_dead_producer(tmp_path, kind):
    assert both(case_orphan, tmp_path, kind) == [True, True, True, "worker_lost", True, True, True, True]


# ---------------------------------------------------------------------------
# failure taxonomy + fault sites
# ---------------------------------------------------------------------------


def case_lease_fault(side, tmp, kind):
    left, right = _write_inputs(tmp, n_left=1, n_right=1)
    board = tmp / "board"
    w = side.dist.DistWorker(str(board), "w0", conf=dict(CONF, **{"fugue.tpu.fault.plan": "dist.lease=error@1"}),
                             start_http=False)
    sup = _sup(side, board, kind)
    jid = sup.plan_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=1)
    tid = f"{jid}-m-left-0000"
    seen = [w.run_task(tid), [f["category"] for f in sup.board.failures(tid)], sup.leases.read(tid)]
    return seen + [w.poll_once(), sup.board.read_done(tid) is not None]


@pytest.mark.parametrize("kind", KINDS)
def test_dist_lease_fault_site_transient_retry(tmp_path, kind):
    assert both(case_lease_fault, tmp_path, kind) == [False, ["transient"], None, True, True]


def _bad_map(pdf):
    raise ValueError("deterministically broken")


def case_poison(side, tmp, kind):
    left, right = _write_inputs(tmp, n_left=1, n_right=1)
    board = tmp / "board"
    with WorkerPool(side, board, 1, CONF):
        sup = _sup(side, board, kind)
        with pytest.raises(side.dist.DistJobError) as ei:
            sup.run_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_bad_map, buckets=1,
                             timeout=30)
        n = len(os.listdir(sup.board.fail_dir))
        time.sleep(0.3)  # workers leave a poisoned task alone: no retry storm
        n2 = len(os.listdir(sup.board.fail_dir))
    return ["poison" in str(ei.value), any("ValueError" in "".join(v) for v in ei.value.report.values()), n2 == n,
            sup.stats.get("jobs_failed")]


@pytest.mark.parametrize("kind", KINDS)
def test_poison_task_aborts_job_with_report(tmp_path, kind):
    assert both(case_poison, tmp_path, kind) == [True, True, True, 1]


def case_spans(side, tmp, kind):
    """With tracing on, each task's ``dist.task`` span rides its done
    record and lands under the supervisor's ``dist.job``."""
    left, right = _write_inputs(tmp, n_left=1, n_right=1)
    tracer = side.get_tracer()
    tracer.enable()
    try:
        tracer.clear()
        with WorkerPool(side, tmp / "board", 1, CONF):
            _sup(side, tmp / "board", kind).run_join_job(left, right, ["k"], _reduce, combine_fn=_combine,
                                                         map_left=_map_left, buckets=2, timeout=60)
        recs = tracer.records()
    finally:
        tracer.disable()
        tracer.clear()
    tasks = [r for r in recs if r["name"] == "dist.task"]
    return [sum(r["name"] == "dist.job" for r in recs), len(tasks), sorted({t["args"]["worker"] for t in tasks}),
            sorted({t["args"]["kind"] for t in tasks})]


@pytest.mark.parametrize("kind", KINDS)
def test_worker_spans_ship_home_with_worker_label(tmp_path, kind):
    assert both(case_spans, tmp_path, kind) == [1, 4, ["w0"], ["map", "reduce"]]


def case_board_fault(side, tmp, kind):
    left, right = _write_inputs(tmp, n_left=1, n_right=1)
    board = tmp / "board"
    w = side.dist.DistWorker(str(board), "w0", conf=dict(CONF, **{"fugue.tpu.fault.plan": "dist.board=error@1"}),
                             start_http=False)
    sup = _sup(side, board, kind)
    jid, tids = sup.plan_workflow_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=1)
    tid = [t for t in tids if t.startswith("wfm-")][0]
    seen = [w.run_task(tid), sup.board.read_done(tid), [f["category"] for f in sup.board.failures(tid)],
            sup.leases.read(tid)]
    for _ in range(len(tids) + 1):
        if sup.board.read_done(tid) is not None:
            break
        assert w.poll_once()
    return seen + [len([n for n in os.listdir(sup.board.done_dir) if n.startswith(tid)])]


@pytest.mark.parametrize("kind", KINDS)
def test_dist_board_fault_site_transient_retry(tmp_path, kind):
    got = both(case_board_fault, tmp_path, kind)
    assert got[:5] == [False, None, ["transient"], None, 1]


def case_events_and_spool(side, tmp, kind):
    """A worker with the event log and a span spool on: every lease it
    takes is an event, and after each task it publishes its spans to the
    spool under its label."""
    left, right = _write_inputs(tmp, n_left=1, n_right=1)
    events_dir, spool = str(tmp / "events"), str(tmp / "spool")
    conf = dict(CONF, **{"fugue.tpu.events.enabled": True, "fugue.tpu.events.dir": events_dir,
                         "fugue.tpu.trace.spool_dir": spool})
    tracer, log = side.get_tracer(), side.get_event_log()
    tracer.enable()
    try:
        with WorkerPool(side, tmp / "board", 1, conf):
            got = _sup(side, tmp / "board", kind).run_join_job(left, right, ["k"], _reduce, combine_fn=_combine,
                                                               map_left=_map_left, buckets=2, timeout=60)
    finally:
        tracer.disable()
        tracer.clear()
        log.configure(None, False)
    events = side.read_events(events_dir)
    docs = side.read_spools(spool)
    return [len(got), sum(e["type"] == "lease.acquire" for e in events), sorted({e.get("owner") for e in events
                                                                                 if e["type"] == "lease.acquire"}),
            [d["label"] for d in docs], sum(sp["name"] == "dist.task" for d in docs for sp in d["spans"]) >= 4,
            docs[0]["stats"]["tasks_completed"] >= 3]


@pytest.mark.parametrize("kind", KINDS)
def test_worker_writes_events_and_span_spool(tmp_path, kind):
    assert both(case_events_and_spool, tmp_path, kind) == [7, 4, ["w0"], ["worker w0"], True, True]


# ---------------------------------------------------------------------------
# workflow jobs on the board
# ---------------------------------------------------------------------------


def case_workflow_job(side, tmp, kind):
    left, right = _write_inputs(tmp)
    serial = _sup(side, tmp / "oracle", kind, **{"fugue.tpu.dist.enabled": False}).run_workflow_job(
        left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=4)
    tokens = {"left": "assign v2", "reduce": "join+agg"}
    seen = []
    with WorkerPool(side, tmp / "board", 2, CONF):
        sup = _sup(side, tmp / "board", kind)
        for _ in range(2):
            got = sup.run_workflow_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left,
                                       buckets=4, tokens=tokens, timeout=60)
            d = sup.stats.as_dict()
            seen.append([got.equals(serial), d["workflow_jobs"], d["workflow_tasks_dispatched"],
                         d["workflow_partitions_delta_skipped"]])
    return seen


@pytest.mark.parametrize("kind", KINDS)
def test_workflow_job_bit_identical_and_warm_delta_skip(tmp_path, kind):
    assert both(case_workflow_job, tmp_path, kind) == [[True, 1, 9, 0], [True, 2, 9, 9]]


def case_restart_mid_reduce(side, tmp, kind):
    left, right = _write_inputs(tmp)
    serial = _sup(side, tmp / "oracle", kind, **{"fugue.tpu.dist.enabled": False}).run_workflow_job(
        left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=4)
    sup1 = _sup(side, tmp / "board", kind)
    jid, tids = sup1.plan_workflow_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left,
                                       buckets=4)
    map_tids = [t for t in tids if t.startswith("wfm-")]
    with WorkerPool(side, tmp / "board", 2, CONF):
        deadline = time.monotonic() + 30
        while sup1.board.done_count(map_tids) < len(map_tids):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        del sup1
        sup2 = _sup(side, tmp / "board", kind)
        got = sup2.wait_job(jid, timeout=60)
        audit = sup2.audit_job(jid)
    return [got.equals(serial), _zero(audit)]


@pytest.mark.parametrize("kind", KINDS)
def test_workflow_job_supervisor_restart_mid_reduce_with_waiter(tmp_path, kind):
    assert both(case_restart_mid_reduce, tmp_path, kind) == [True, True]


def test_workflow_task_ids_equal_the_reference(tmp_path):
    """A workflow job's task ids are content addresses over the fragment's
    tokens and each range's file tokens: over the same files the two
    packages name the same job and the same tasks."""
    left, right = _write_inputs(tmp_path)
    tokens = {"left": "filter[(v > 10)]", "right": "", "reduce": "join[inner,on=['k']]"}
    ids = [side.dist.DistSupervisor(str(tmp_path / side.name), conf=dict(CONF)).plan_workflow_job(
        left, right, ["k"], _reduce, map_left=_map_left, buckets=4, tokens=tokens) for side in (REF, PORT)]
    assert ids[0] == ids[1] and len(ids[0][1]) == 9


# ---------------------------------------------------------------------------
# content addresses and bucket ids, bit for bit
# ---------------------------------------------------------------------------


FINGERPRINT_PARTS = [
    ("j", "reduce", 3, ["m1", "m2"]),
    ("map", "left", "filter[(v > 0.25)]", ["k"], ["i"], 8, [["/a/b.parquet", 100, 1700000000000000000]]),
    ("reduce", "join[inner,on=['k']] ;; aggregate[keys=['k'],cols=['s']]", 0, ["wfm-1", "wfm-2"]),
    ({"b": 1.5, "a": [None, True]}, -0.0, float("inf")),
]


@pytest.mark.parametrize("parts", FINGERPRINT_PARTS, ids=range(len(FINGERPRINT_PARTS)))
def test_spec_fingerprint_deterministic(parts):
    got = PORT.dist.spec_fingerprint(*parts)
    assert got == REF.dist.spec_fingerprint(*parts) == PORT.dist.spec_fingerprint(*parts)
    assert got != PORT.dist.spec_fingerprint(*parts, 1)


def _tz(values, tz):
    return pa.array(pd.to_datetime(pd.Series(values)).dt.tz_localize(tz))


KEY_TABLES = {
    "int": (pa.table({"k": pa.array([1, 2, -5, 2**40, None, 7], pa.int64())}),) * 2,
    "float": (pa.table({"k": pa.array([0.0, -0.0, float("nan"), 1.5, None, -2.25])}),) * 2,
    "int-float": (pa.table({"k": pa.array([1, 0, None, 5, -3, 2], pa.int32())}),
                  pa.table({"k": pa.array([1.0, -0.0, None, 5.0, -3.0, 2.5])})),
    "string": (pa.table({"k": pa.array(["a", "", None, "héllo", "a", "z" * 40])}),) * 2,
    "tz-timestamp": (pa.table({"k": _tz(["2024-01-01 00:00", "2024-06-30 12:30", None, "1999-12-31 23:59",
                                         "2024-01-01 00:00", "2030-03-10 02:30"], "UTC")}),
                     pa.table({"k": _tz(["2023-12-31 19:00", "2024-06-30 08:30", None, "1999-12-31 18:59",
                                         "2023-12-31 19:00", "2030-03-09 21:30"], "US/Eastern")})),
    "bool-and-string": (pa.table({"k": pa.array([True, False, None, True, False, True]),
                                  "s": pa.array(["x", "y", "x", None, "", "x"])}),) * 2,
}


@pytest.mark.parametrize("name", sorted(KEY_TABLES))
@pytest.mark.parametrize("n_buckets", [1, 7, 8, 1024])
def test_bucket_ids_equal_the_reference(name, n_buckets):
    """The kinds both sides normalize to and the bucket of every row, over
    NULLs, -0.0 and NaN, strings and instants in two timezones."""
    t1, t2 = KEY_TABLES[name]
    keys = t1.column_names

    def fields(t):
        return {n: t.schema.field(n) for n in t.schema.names}

    kinds = PORT.canonical_key_kinds(fields(t1), fields(t2), keys)
    assert kinds == REF.canonical_key_kinds(fields(t1), fields(t2), keys) and kinds is not None
    for t in (t1, t2):
        got = PORT.bucket_ids(t, keys, kinds, n_buckets)
        assert got.dtype == np.int64
        assert np.array_equal(got, REF.bucket_ids(t, keys, kinds, n_buckets))
    if name in ("float", "int-float", "tz-timestamp"):  # equal values co-bucket across the sides
        a, b = PORT.bucket_ids(t1, keys, kinds, n_buckets), PORT.bucket_ids(t2, keys, kinds, n_buckets)
        assert a[0] == b[0] and a[1] == b[1]


def test_unhashable_key_pairs_have_no_kind():
    s = pa.schema([("k", pa.string())])
    n = pa.schema([("k", pa.int64())])
    for side in (PORT, REF):
        assert side.canonical_key_kinds({"k": s.field("k")}, {"k": n.field("k")}, ["k"]) is None


# ---------------------------------------------------------------------------
# the worker as a process of its own; chip_smoke's phase at a small size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("traced", [False, True])
def test_worker_processes_run_a_job(tmp_path, traced):
    """``python -m fugue_tpu_torch.dist.worker`` on a board: two fresh
    interpreters drain a join job over HTTP fetches without loading torch
    (a worker is a host engine), traced or not (a traced worker's spans
    mirror into no profiler range and reach the spool); the result equals
    the serial path, the audit is zero, the workers' counters ship home,
    and the stop file ends both with exit code 0."""
    left, right = _write_inputs(tmp_path)
    board = str(tmp_path / "board")
    os.makedirs(board)
    stop = os.path.join(board, "_stop")
    spool = str(tmp_path / "spool")
    conf = dict(CONF, **{"fugue.tpu.dist.fetch": "remote"})
    env = dict(os.environ)
    if traced:
        conf["fugue.tpu.trace.spool_dir"] = spool
        env["FUGUE_TPU_TRACE"] = "1"
    procs = [subprocess.Popen([sys.executable, "-m", "fugue_tpu_torch.dist.worker", "--root", board, "--id", f"w{i}",
                               "--conf", json.dumps(conf), "--stop-file", stop], cwd=ROOT, env=env)
             for i in range(2)]
    # the job's functions live in this module, which a worker cannot
    # import: they travel by value
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        serial = _serial(PORT, tmp_path / "oracle", left, right, "native", buckets=4)
        sup = _sup(PORT, board, "native", **{"fugue.tpu.dist.fetch": "remote"})
        jid = sup.plan_join_job(left, right, ["k"], _reduce, combine_fn=_combine, map_left=_map_left, buckets=4)
        got = sup.wait_job(jid, timeout=120)
        assert got.equals(serial) and _zero(sup.audit_job(jid))
        workers = sup.engine.stats()["dist"]["workers"]
        assert workers and set(workers) <= {"w0", "w1"}
        for p in procs:
            with open(f"/proc/{p.pid}/maps") as f:
                assert "libtorch" not in f.read()
        if traced:
            spans = []
            for name in os.listdir(spool):
                with open(os.path.join(spool, name)) as f:
                    spans += [r["name"] for r in json.load(f)["spans"]]
            assert "dist.task" in spans, sorted(set(spans))
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
        with open(stop, "w") as f:
            f.write("stop")
        codes = [p.wait(timeout=60) for p in procs]
    assert codes == [0, 0]


MIRROR = r"""
import json, sys
from fugue_tpu_torch.obs import get_tracer
tr = get_tracer()
tr.enabled = True
with tr.span("user.map", cat="dist", annotate=True):
    pass
before = "torch" in sys.modules
import torch
with tr.span("user.map", cat="dist", annotate=True):
    pass
print(json.dumps({"before": before, "mirror": tr._annotation_cls() is torch.profiler.record_function,
                  "spans": [r["name"] for r in tr.records()]}))
"""


def test_an_annotated_span_imports_no_torch():
    """A span opened with ``annotate=True`` in a process without torch (a
    traced worker running a job's function) records and mirrors into no
    profiler range, so it does not import torch; once torch is imported,
    the next span mirrors into ``torch.profiler.record_function``."""
    r = subprocess.run([sys.executable, "-c", MIRROR], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"before": False, "mirror": True,
                                                              "spans": ["user.map", "user.map"]}


SMOKE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, pandas as pd, pyarrow as pa, torch
import chip_smoke
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
for name in ("synchronize", "reset_peak_memory_stats", "max_memory_allocated", "memory_allocated", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: 0)
out = chip_smoke.phase_dist_path(torch, np, pd, pa, bg, ff, col, "cpu", 0, rows=120_000, kill_rows=40_000)
print(json.dumps({"jax": "jax" in sys.modules, "cells": {c: {k: r[k] for k in ("launches", "tasks_dispatched",
                  "audit") if k in r} for c, r in out["cells"].items()}, "processes": out["processes"]}))
"""


def test_chip_smoke_dist_path_on_the_cpu():
    """``phase_dist_path`` at a small size on the CPU, in a process that
    loads no JAX: its cells' gates, three and three worker processes, one
    SIGKILLed, every other stopped by its stop file."""
    r = subprocess.run([sys.executable, "-c", SMOKE, ROOT], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["jax"] is False
    cells = last["cells"]
    assert sorted(cells) == ["dist-join-agg-10m", "dist-kill-2m", "dist-warm-10m"]
    assert cells["dist-join-agg-10m"]["tasks_dispatched"] == 25 and cells["dist-warm-10m"]["tasks_dispatched"] == 0
    assert all(c["launches"]["bin_sum"] == 0 for c in cells.values())  # B1 launches on a card only
    assert cells["dist-kill-2m"]["audit"]["rows_lost"] == 0
    proc = last["processes"]
    assert proc["exit_codes"]["board_kill/w0"] == -9
    assert all(c == 0 for w, c in proc["exit_codes"].items() if w != "board_kill/w0")
    assert proc["left_running"] == [] and proc["killed_at_end"] == []
