"""The workflow's distributed pass of the port (``fugue_tpu_torch/plan/
distribute.py``) against the JAX package's: the cases of
``tests/plan/test_distribute.py``, each written once over
``torch_dist_common.Side`` and run through both packages. The planner's
fragments and refusals, and the explain's distributed section, equal the
reference's; a distributed run over in-process workers equals the
package's own local run and the reference's, on the port's native engine
against the reference's and on ``TorchExecutionEngine(device="cpu")``
against ``JaxExecutionEngine``; counters, warm delta skips, the kill
switch's span multiset, the interior-result error and the cache's warm
cut behave as the reference's.
"""

import collections
import os

import pandas as pd
import pytest
from torch_dist_common import PORT, REF, WorkerPool, canon, dist_section

BASE = {
    "fugue.tpu.cache.enabled": False,
    "fugue.tpu.tuning.enabled": False,
    "fugue.tpu.dist.heartbeat.interval_s": 0.1,
    "fugue.tpu.dist.heartbeat.stale_after_s": 0.6,
    "fugue.tpu.dist.poll_s": 0.01,
    "fugue.tpu.dist.buckets": 4,
}
KINDS = ["native", "device"]


def _sources(root, n_left=3, n_right=2):
    ldir, rdir = os.path.join(str(root), "left"), os.path.join(str(root), "right")
    os.makedirs(ldir, exist_ok=True)
    os.makedirs(rdir, exist_ok=True)
    for i in range(n_left):
        pd.DataFrame({"k": [(j * 3 + i) % 7 for j in range(40)],
                      "v": [float(j + i * 40) for j in range(40)]}).to_parquet(os.path.join(ldir, f"l{i}.parquet"))
    for i in range(n_right):
        pd.DataFrame({"k": list(range(7)), "w": [float(i * 10 + j) for j in range(7)]}).to_parquet(
            os.path.join(rdir, f"r{i}.parquet"))
    return ldir, rdir


def _join_agg(side, dag, ldir, rdir):
    col, ff = side.col, side.ff
    a = dag.load(ldir, fmt="parquet").filter(col("v") > 10)
    b = dag.load(rdir, fmt="parquet")
    (a.join(b, how="inner", on=["k"]).partition_by("k")
     .aggregate(ff.sum(col("v")).alias("s"), ff.count(col("w")).alias("n"))
     .yield_dataframe_as("r", as_local=True))


def _sql_wf(side, dag, ldir, rdir):
    a = dag.load(ldir, fmt="parquet")
    b = dag.load(rdir, fmt="parquet")
    dag.select("SELECT a.k AS k, SUM(a.v * b.w) AS s, COUNT(*) AS n FROM ", a, " AS a INNER JOIN ", b,
               " AS b ON a.k = b.k WHERE a.v > 10 GROUP BY a.k").yield_dataframe_as("r", as_local=True)


def _run(side, build, ldir, rdir, conf, engine):
    dag = side.FugueWorkflow()
    build(side, dag, ldir, rdir)
    dag.run(engine, conf=conf)
    return dag.yields["r"].result.as_pandas()


def both(case, tmp_path, *args):
    want = case(REF, tmp_path / "ref", *args)
    got = case(PORT, tmp_path / "port", *args)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# planner units (dry: plan_distribution / explain, no workers)
# ---------------------------------------------------------------------------


def _plan_of(side, build, ldir, rdir, board, extra=None):
    dag = side.FugueWorkflow()
    build(side, dag, ldir, rdir)
    conf = side.ParamDict(dict(BASE, **{"fugue.tpu.dist.board": board}))
    conf.update(extra or {})
    tasks, _, _, _ = side.optimize_tasks(dag._tasks, conf)
    return side.plan_distribution(tasks, conf)


def _summary(plan) -> dict:
    """What a plan decided, in the packages' common words."""
    frags = []
    for f in plan.fragments:
        frags.append({"keys": f.keys, "terminal": f.terminal[0], "how": f.terminal[1] if f.terminal[0] == "join"
                      else None, "covered": len(f.covered_ids), "buckets": f.buckets,
                      "files": [len(s["paths"]) for s in f.sides],
                      "steps": [[st[0] for st in s["steps"]] for s in f.sides],
                      "tail": [op[0] for op in f.tail_ops], "tokens": [s["token"] for s in f.sides] + [f.reduce_token],
                      "describe": f.describe()})
    return {"active": plan.active, "fragments": frags, "refusals": [why for _, why in plan.refusals]}


def case_inert(side, tmp):
    ldir, rdir = _sources(tmp)
    plans = [_plan_of(side, _join_agg, ldir, rdir, ""),
             _plan_of(side, _join_agg, ldir, rdir, str(tmp / "board"), {"fugue.tpu.dist.enabled": False})]
    return [_summary(p) for p in plans]


def test_planner_inert_without_board_or_disabled(tmp_path):
    got = both(case_inert, tmp_path)
    assert all(not p["active"] and not p["fragments"] for p in got)


def case_plan(side, tmp, build):
    ldir, rdir = _sources(tmp)
    plan = _plan_of(side, build, ldir, rdir, str(tmp / "board"))
    out = _summary(plan)
    if plan.fragments and plan.fragments[0].terminal[0] == "sql":
        out["scans"] = plan.fragments[0].terminal[2]
    return out


def test_planner_finds_join_agg_fragment(tmp_path):
    """The canonical workflow lowers to one segment; the planner claims
    the whole subgraph (both loads, the segment, the tail aggregate)."""
    got = both(case_plan, tmp_path, _join_agg)
    assert got["active"] and len(got["fragments"]) == 1 and not got["refusals"]
    frag = got["fragments"][0]
    assert frag["keys"] == ["k"] and frag["terminal"] == "join" and frag["covered"] == 4
    assert frag["files"] == [3, 2] and "filter" in frag["steps"][0] and frag["tail"][-1] == "aggregate"


def test_planner_finds_sql_fragment(tmp_path):
    got = both(case_plan, tmp_path, _sql_wf)
    assert len(got["fragments"]) == 1 and not got["refusals"]
    assert got["fragments"][0]["terminal"] == "sql" and got["fragments"][0]["keys"] == ["k"]
    assert got["scans"] == ["_0", "_1"]


def _csv_join(side, dag, ldir, rdir):
    a = dag.load(os.path.join(os.path.dirname(ldir), "csv_src"), fmt="csv", columns="k:long,v:double")
    a.join(dag.load(rdir, fmt="parquet"), how="inner", on=["k"]).yield_dataframe_as("r", as_local=True)


def _distinct_join(side, dag, ldir, rdir):
    a = dag.load(ldir, fmt="parquet").distinct()
    a.join(dag.load(rdir, fmt="parquet"), how="inner", on=["k"]).yield_dataframe_as("r", as_local=True)


def _pinned(side, dag, ldir, rdir):
    a = dag.load(ldir, fmt="parquet")
    a.join(dag.load(rdir, fmt="parquet"), how="inner", on=["k"]).yield_dataframe_as("r", as_local=True)
    a.yield_dataframe_as("a_too", as_local=True)


def _fan_out(side, dag, ldir, rdir):
    a = dag.load(ldir, fmt="parquet")
    b = dag.load(rdir, fmt="parquet")
    a.join(b, how="inner", on=["k"]).yield_dataframe_as("r", as_local=True)
    a.join(b, how="left_outer", on=["k"]).yield_dataframe_as("r2", as_local=True)


def _sql_shape(head, mid, tail):
    def build(side, dag, ldir, rdir):
        a = dag.load(ldir, fmt="parquet")
        b = dag.load(rdir, fmt="parquet")
        dag.select(head, a, mid, b, tail).yield_dataframe_as("r", as_local=True)

    return build


REFUSALS = {
    "non-parquet": (_csv_join, "csv"),
    "non-row-local": (_distinct_join, None),
    "pinned": (_pinned, "pinned"),
    "multi-consumer": (_fan_out, "consumer"),
    "sql-order": (_sql_shape("SELECT a.k, a.v FROM ", " AS a INNER JOIN ", " AS b ON a.k = b.k ORDER BY a.v"), None),
    "sql-distinct": (_sql_shape("SELECT DISTINCT a.k FROM ", " AS a INNER JOIN ", " AS b ON a.k = b.k"), None),
    "sql-global-agg": (_sql_shape("SELECT SUM(a.v) AS s FROM ", " AS a INNER JOIN ", " AS b ON a.k = b.k"), None),
}


def case_refusal(side, tmp, build):
    ldir, rdir = _sources(tmp)
    csv = tmp / "csv_src"
    csv.mkdir()
    pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]}).to_csv(str(csv / "a.csv"), index=False)
    return _summary(_plan_of(side, build, ldir, rdir, str(tmp / "board")))


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals(tmp_path, name):
    """Every rung the reference's refusal tests climb (a csv source, a
    distinct between load and join, a pinned or fanned-out side, ORDER BY,
    DISTINCT and a global aggregate in SQL): no fragment, the same
    reasons."""
    build, word = REFUSALS[name]
    got = both(case_refusal, tmp_path, build)
    assert not got["fragments"] and got["refusals"]
    if word is not None:
        assert any(word in why for why in got["refusals"])


def case_explain(side, tmp):
    ldir, rdir = _sources(tmp)
    board = str(tmp / "board")
    dag = side.FugueWorkflow()
    _join_agg(side, dag, ldir, rdir)
    return [dist_section(dag.explain(conf=conf), board) for conf in (
        dict(BASE, **{"fugue.tpu.dist.board": board}), dict(BASE),
        dict(BASE, **{"fugue.tpu.dist.board": board, "fugue.tpu.dist.enabled": False}))]


def test_explain_renders_board_plan(tmp_path):
    on, off, disabled = both(case_explain, tmp_path)
    assert "== distributed workflows (board=<board>, 1 fragment(s), 0 refused) ==" in on
    assert "map[left]: 3 file(s)" in on
    assert "distributed workflows: off" in off and "distributed workflows: disabled" in disabled


# ---------------------------------------------------------------------------
# end to end over in-process workers
# ---------------------------------------------------------------------------


def case_run(side, tmp, build, kind):
    ldir, rdir = _sources(tmp)
    board = str(tmp / "board")
    oracle = _run(side, build, ldir, rdir, {"fugue.tpu.dist.board": board, "fugue.tpu.dist.enabled": False},
                  side.make_engine(kind, BASE))
    with WorkerPool(side, board, 2, BASE):
        eng = side.make_engine(kind, BASE)
        got = _run(side, build, ldir, rdir, {"fugue.tpu.dist.board": board}, eng)
        d = eng.stats()["dist"]
    pd.testing.assert_frame_equal(canon(oracle), canon(got))
    return {"rows": canon(got).to_dict("list"), "jobs": d["workflow_jobs"],
            "dispatched": d["workflow_tasks_dispatched"]}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("build", [_join_agg, _sql_wf], ids=["functional", "sql"])
def test_workflow_run_distributed_bit_identical(tmp_path, build, kind):
    """With a board the fragment runs on the tier; the result equals the
    dist-disabled local run of the same package and the reference's, and
    the workflow counters land in the engine's stats."""
    got = both(case_run, tmp_path, build, kind)
    assert got["jobs"] == 1 and got["dispatched"] > 0


def case_warm(side, tmp, kind):
    ldir, rdir = _sources(tmp)
    board = str(tmp / "board")
    seen = []
    with WorkerPool(side, board, 2, BASE):
        eng = side.make_engine(kind, BASE)
        conf = {"fugue.tpu.dist.board": board}
        got1 = _run(side, _join_agg, ldir, rdir, conf, eng)
        d1 = dict(eng.stats()["dist"])
        got2 = _run(side, _join_agg, ldir, rdir, conf, eng)
        d2 = dict(eng.stats()["dist"])
        seen += [got2.equals(got1), d2["workflow_partitions_delta_skipped"] - d1["workflow_partitions_delta_skipped"],
                 d2["workflow_tasks_dispatched"] - d1["workflow_tasks_dispatched"]]
        pd.DataFrame({"k": [1, 2, 3], "v": [500.0, 600.0, 700.0]}).to_parquet(os.path.join(ldir, "l9.parquet"))
        got3 = _run(side, _join_agg, ldir, rdir, conf, eng)
        d3 = dict(eng.stats()["dist"])
        seen += [d3["workflow_partitions_delta_skipped"] - d2["workflow_partitions_delta_skipped"],
                 d3["workflow_tasks_dispatched"] - d2["workflow_tasks_dispatched"]]
        oracle = _run(side, _join_agg, ldir, rdir, {"fugue.tpu.dist.board": board, "fugue.tpu.dist.enabled": False},
                      side.make_engine(kind, BASE))
    pd.testing.assert_frame_equal(canon(oracle), canon(got3))
    return seen + [canon(got3).to_dict("list")]


@pytest.mark.parametrize("kind", KINDS)
def test_workflow_warm_rerun_delta_skips_unchanged_partitions(tmp_path, kind):
    """A warm rerun over the same sources reuses every content-addressed
    done record; over an appended file only its map and the reduces
    re-dispatch."""
    got = both(case_warm, tmp_path, kind)
    assert got[:5] == [True, 9, 0, 5, 5]


def case_kill_switch(side, tmp, kind):
    ldir, rdir = _sources(tmp)
    board = str(tmp / "board")
    tracer = side.get_tracer()
    tracer.enable()
    try:

        def spans(conf):
            tracer.clear()
            got = _run(side, _join_agg, ldir, rdir, conf, side.make_engine(kind, BASE))
            return got, collections.Counter(r["name"] for r in tracer.records()
                                            if r.get("cat") in ("engine", "workflow"))

        got_off, spans_off = spans({"fugue.tpu.dist.board": board, "fugue.tpu.dist.enabled": False})
        got_none, spans_none = spans({})
    finally:
        tracer.disable()
        tracer.clear()
    return [got_off.equals(got_none), spans_off == spans_none, os.path.exists(os.path.join(board, "tasks"))]


@pytest.mark.parametrize("kind", KINDS)
def test_kill_switch_identical_span_multisets(tmp_path, kind):
    """``fugue.tpu.dist.enabled=false`` with a board set equals no board at
    all, the multiset of engine and workflow spans included; nothing
    reaches the board."""
    assert both(case_kill_switch, tmp_path, kind) == [True, True, False]


def case_interior(side, tmp, kind):
    ldir, rdir = _sources(tmp)
    board = str(tmp / "board")
    with WorkerPool(side, board, 2, BASE):
        dag = side.FugueWorkflow()
        a = dag.load(ldir, fmt="parquet")
        a.join(dag.load(rdir, fmt="parquet"), how="inner", on=["k"]).yield_dataframe_as("r", as_local=True)
        dag.run(side.make_engine(kind, BASE), conf={"fugue.tpu.dist.board": board})
        with pytest.raises(side.FugueWorkflowError) as ei:
            _ = a.result
    msg = str(ei.value)
    return ["REMOTELY" in msg, "fugue.tpu.dist.enabled=false" in msg, "persist()" in msg]


@pytest.mark.parametrize("kind", KINDS)
def test_interior_result_raises_descriptive_error(tmp_path, kind):
    assert both(case_interior, tmp_path, kind) == [True, True, True]


def case_cache_cut(side, tmp, kind):
    ldir, rdir = _sources(tmp)
    board = str(tmp / "board")
    conf = dict(BASE, **{"fugue.tpu.cache.enabled": True, "fugue.tpu.cache.dir": str(tmp / "cache"),
                         "fugue.tpu.dist.board": board})
    with WorkerPool(side, board, 2, BASE):
        eng = side.make_engine(kind, conf)
        got1 = _run(side, _join_agg, ldir, rdir, {}, eng)
        d1 = dict(eng.stats().get("dist", {}))
        got2 = _run(side, _join_agg, ldir, rdir, {}, eng)
        d2 = dict(eng.stats().get("dist", {}))
    return [canon(got2).equals(canon(got1)), d1.get("workflow_jobs", 0), d2.get("workflow_jobs", 0)]


@pytest.mark.parametrize("kind", KINDS)
def test_cache_hit_blocks_fragment_warm_local_wins(tmp_path, kind):
    """With the result cache on, the warm run is served from the local
    cache and plans no workflow job."""
    assert both(case_cache_cut, tmp_path, kind) == [True, 1, 1]


def case_timeline(side, tmp, kind):
    """A traced run whose worker fails its first lease (``dist.lease``
    fault): the failure and the retry, carrying the run's trace, in
    ``workflow.timeline()``."""
    ldir, rdir = _sources(tmp)
    board, events_dir = str(tmp / "board"), str(tmp / "events")
    conf = dict(BASE, **{"fugue.tpu.events.enabled": True, "fugue.tpu.events.dir": events_dir})
    tracer, log = side.get_tracer(), side.get_event_log()
    tracer.enable()
    try:
        with WorkerPool(side, board, 1, dict(conf, **{"fugue.tpu.fault.plan": "dist.lease=error@1"})):
            dag = side.FugueWorkflow()
            _join_agg(side, dag, ldir, rdir)
            dag.run(side.make_engine(kind, BASE), conf={"fugue.tpu.dist.board": board})
        lines = dag.timeline(events_dir).splitlines()
    finally:
        tracer.disable()
        tracer.clear()
        log.configure(None, False)
    return [lines[0].startswith("== cluster timeline ("),
            sum(" failed on w0 (transient: InjectedFaultError" in ln for ln in lines),
            sum(" re-dispatched on w0 (failed_retry)" in ln for ln in lines),
            sum(" lease acquired for " in ln for ln in lines)]


@pytest.mark.parametrize("kind", KINDS)
def test_timeline_shows_the_workers_events(tmp_path, kind):
    assert both(case_timeline, tmp_path, kind) == [True, 1, 1, 10]
