"""The port's observability layer (``fugue_tpu_torch/obs``) against the JAX
package's (``fugue_tpu/obs``), on the CPU.

Each workflow case is built once over a namespace of either package's
classes and run on ``JaxExecutionEngine`` (the 8-device CPU mesh) with
``fugue_tpu``'s tracer on and on ``TorchExecutionEngine(device="cpu")``
with the port's tracer on. The two tracers, span-metric stores and
samplers are separate process-wide objects; every test turns on and
clears the ones it uses. Compared:

- span trees: the names and the ancestor chain of every span, counted,
  are equal (transform → join → aggregate; a streamed aggregate, whose
  ``stream.chunk`` spans nest in ``engine.aggregate`` and whose rows sum
  to the frame's; plan_path's lowered workflow, bounded and streamed,
  under ``plan.segment``; tasks on four pool threads under
  ``workflow.run``);
- the tracer core (nesting, attributes, errors, the fork protocol) span
  for span, and the disabled path by its structure: no records, one
  shared null span (no wall-time assertion: a shared run makes them
  flaky);
- the Chrome trace (``fugue.tpu.trace.dir``'s file and an explicit
  export), which both packages' ``validate_chrome_trace`` accept;
- the Prometheus text, which both packages' ``validate_prometheus_text``
  accept, with the same family names from the shared sources
  (``resilience``, ``latency``, ``telemetry``);
- ``engine.stats()`` (the port's sources), ``reset_stats()`` keeping the
  entries, run labels, the report, the event log and ``timeline()``;
- the resource sampler's lifecycle and its device-bytes probe's three
  states (no CUDA build, CUDA not initialized, initialized).
"""

import json
import os
import threading
from collections import Counter
from types import SimpleNamespace
from typing import Dict

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu
import fugue_tpu.column as jcolumn
import fugue_tpu.dataframe as jdf
import fugue_tpu.obs as jobs
from fugue_tpu.jax import JaxExecutionEngine
import fugue_tpu_torch.column as tcolumn
import fugue_tpu_torch.dataframe as tdf
import fugue_tpu_torch.obs as tobs
from fugue_tpu_torch import workflow as twf
from fugue_tpu_torch.constants import (
    FUGUE_TPU_CONF_EVENTS_DIR,
    FUGUE_TPU_CONF_EVENTS_ENABLED,
    FUGUE_TPU_CONF_STREAM_CHUNK_ROWS,
    FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH,
    FUGUE_TPU_CONF_TELEMETRY_ENABLED,
    FUGUE_TPU_CONF_TELEMETRY_INTERVAL,
    FUGUE_TPU_CONF_TELEMETRY_RING,
    FUGUE_TPU_CONF_TRACE_DIR,
    FUGUE_TPU_CONF_TRACE_ENABLED,
)
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.obs import sampler as tsampler
from fugue_tpu_torch.obs.tracer import NULL_SPAN
from fugue_tpu_torch.torch import TorchExecutionEngine
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

# either package's result cache would serve a DAG it ran before without
# running (or tracing) its tasks: both engines run with it off
REF_CONF = {"fugue.tpu.cache.enabled": False}

REF = SimpleNamespace(
    FugueWorkflow=fugue_tpu.FugueWorkflow, col=jcolumn.col, ff=jcolumn.functions,
    ArrowDataFrame=jdf.ArrowDataFrame, Iterable=jdf.LocalDataFrameIterableDataFrame,
    obs=jobs, array=lambda: __import__("jax").Array,
    engine=lambda conf=None: JaxExecutionEngine({**REF_CONF, **(conf or {})}),
)
PORT = SimpleNamespace(
    FugueWorkflow=twf.FugueWorkflow, col=tcolumn.col, ff=tcolumn.functions,
    ArrowDataFrame=tdf.ArrowDataFrame, Iterable=tdf.LocalDataFrameIterableDataFrame,
    obs=tobs, array=lambda: torch.Tensor,
    engine=lambda conf=None: TorchExecutionEngine(device="cpu", conf={**REF_CONF, **(conf or {})}),
)


def _clear(ns) -> None:
    ns.obs.get_tracer().clear()
    ns.obs.get_span_metrics().clear()


@pytest.fixture
def tracers():
    """Both packages' tracers on, with empty buffers and span metrics;
    both off and empty after."""
    for ns in (REF, PORT):
        _clear(ns)
        ns.obs.get_tracer().enable()
    yield
    for ns in (REF, PORT):
        ns.obs.get_tracer().disable()
        _clear(ns)


@pytest.fixture
def samplers():
    """Both packages' samplers stopped and empty before and after: no
    sampler thread outlives a test."""
    for ns in (REF, PORT):
        ns.obs.get_sampler().stop()
        ns.obs.get_sampler().clear()
    yield
    for ns in (REF, PORT):
        ns.obs.get_sampler().stop()
        ns.obs.get_sampler().clear()


def _frame(n: int, groups: int, seed: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, groups, n), "v": rng.random(n)})


def _f32_frame(n: int, groups: int, seed: int = 0) -> pd.DataFrame:
    """plan_path's frame at a small size: int64 keys, float32 ``v``."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame(
        {"k": rng.integers(0, groups, n), "v": rng.random(n, dtype=np.float32)}
    )


def _stream(ns, pdf: pd.DataFrame, step: int):
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)
    return ns.Iterable(
        (ns.ArrowDataFrame(tbl.slice(s, min(step, tbl.num_rows - s))) for s in range(0, tbl.num_rows, step)),
        schema=ns.ArrowDataFrame(tbl).schema,
    )


def _chain(rec, by_id):
    names = []
    while rec is not None:
        names.append(rec["name"])
        rec = by_id.get(rec["parent"])
    return tuple(names)


def _chains(recs) -> Counter:
    by_id = {r["id"]: r for r in recs}
    return Counter(_chain(r, by_id) for r in recs)


def _run_traced(ns, build, conf=None):
    """Build the DAG over ``ns``, run it on a fresh engine of ``ns``, and
    return (result as pandas, the tracer's records)."""
    _clear(ns)
    e = ns.engine(conf)
    try:
        dag = build(ns)
        dag.run(e)
        res = dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True)
    finally:
        e.stop()
    return res, ns.obs.get_tracer().records()


def _both(build, conf=None):
    ref = _run_traced(REF, build, conf)
    port = _run_traced(PORT, build, conf)
    return ref, port


def _assert_same_frames(a: pd.DataFrame, b: pd.DataFrame) -> None:
    assert list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for c in a.columns:
        np.testing.assert_allclose(a[c].to_numpy(np.float64), b[c].to_numpy(np.float64), rtol=1e-5)


# ---- span trees ----------------------------------------------------------------


def test_span_tree_transform_join_aggregate(tracers):
    """Reference ``test_span_tree_transform_join_aggregate``: the same
    spans, nested the same way, on both engines."""
    pdf = _frame(4000, 16)
    dim = pd.DataFrame({"k": np.arange(16), "name": [f"g{i}" for i in range(16)]})

    def build(ns):
        arr = ns.array()

        def tf(df: Dict[str, arr]) -> Dict[str, arr]:
            return {"k": df["k"], "v": df["v"] + 1.0}

        dag = ns.FugueWorkflow()
        a = dag.df(pdf).transform(tf, schema="k:long,v:double")
        j = a.join(dag.df(dim), how="inner", on=["k"])
        j.partition_by("k").aggregate(ns.ff.sum(ns.col("v")).alias("s")).yield_dataframe_as("r", as_local=True)
        return dag

    (ref, ref_recs), (port, port_recs) = _both(build, {FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: 1024})
    _assert_same_frames(ref, port)
    assert len(port) == 16
    assert _chains(port_recs) == _chains(ref_recs)
    names = Counter(r["name"] for r in port_recs)
    assert names["workflow.run"] == 1 and names["workflow.task"] >= 4
    assert names["engine.transform"] == names["engine.join"] == names["engine.aggregate"] == 1
    by_id = {r["id"]: r for r in port_recs}
    for r in port_recs:
        if r["name"].startswith("engine."):
            chain = _chain(r, by_id)
            assert "workflow.task" in chain and chain[-1] == "workflow.run", chain
    (join,) = [r for r in port_recs if r["name"] == "engine.join"]
    (ref_join,) = [r for r in ref_recs if r["name"] == "engine.join"]
    assert join["args"]["strategy"] == ref_join["args"]["strategy"] == "broadcast"


def test_span_tree_streaming_chunks_nest_in_verb(tracers):
    """Reference ``test_span_tree_streaming_chunks_nest_in_verb``: one
    ``stream.chunk`` span a chunk, opened on the consuming thread under
    ``engine.aggregate``, their rows summing to the frame's."""
    pdf = _frame(20_000, 32)

    def build(ns):
        dag = ns.FugueWorkflow()
        (
            dag.df(_stream(ns, pdf, 2048))
            .partition_by("k")
            .aggregate(ns.ff.sum(ns.col("v")).alias("s"), ns.ff.count(ns.col("v")).alias("n"))
            .yield_dataframe_as("r", as_local=True)
        )
        return dag

    conf = {FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: 2048, FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH: 2}
    (ref, ref_recs), (port, port_recs) = _both(build, conf)
    _assert_same_frames(ref, port)
    assert _chains(port_recs) == _chains(ref_recs)
    chunks = [r for r in port_recs if r["name"] == "stream.chunk"]
    assert len(chunks) == 10
    by_id = {r["id"]: r for r in port_recs}
    for c in chunks:
        assert _chain(c, by_id) == ("stream.chunk", "engine.aggregate", "workflow.task", "workflow.run")
        assert c["args"]["verb"] == "aggregate" and c["args"]["rows"] > 0
    assert sum(c["args"]["rows"] for c in chunks) == len(pdf)
    # the producer thread opens no span: every chunk span is the consumer's
    (agg,) = [r for r in port_recs if r["name"] == "engine.aggregate"]
    assert {c["tid"] for c in chunks} == {agg["tid"]}


def _lowered(ns, src):
    """plan_path's lowered workflow: filter → select → keyed float32 SUM."""
    col, ff = ns.col, ns.ff
    dag = ns.FugueWorkflow()
    (
        dag.df(src)
        .filter(col("v") > 0.25)
        .select(col("k"), (col("v") * 2.0).alias("z"))
        .partition_by("k")
        .aggregate(ff.sum(col("z")).alias("s"), ff.count(col("z")).alias("n"))
        .yield_dataframe_as("r", as_local=True)
    )
    return dag


@pytest.mark.parametrize("streamed", [False, True], ids=["bounded", "streamed"])
def test_span_tree_lowered_segment(streamed, tracers):
    """The lowered segment runs under one ``plan.segment`` span in a
    ``workflow.task``; streamed, its chunks nest under that span."""
    pdf = _f32_frame(16_000, 50, seed=1)
    conf = {FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: 4000, FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH: 2}

    def build(ns):
        return _lowered(ns, _stream(ns, pdf, 4000) if streamed else pdf)

    (ref, ref_recs), (port, port_recs) = _both(build, conf)
    _assert_same_frames(ref, port)
    assert _chains(port_recs) == _chains(ref_recs)
    (seg,) = [r for r in port_recs if r["name"] == "plan.segment"]
    by_id = {r["id"]: r for r in port_recs}
    assert _chain(seg, by_id) == ("plan.segment", "workflow.task", "workflow.run")
    assert seg["args"]["terminal"] == "aggregate" and seg["args"]["steps"] >= 1
    (opt,) = [r for r in port_recs if r["name"] == "plan.optimize"]
    assert opt["args"]["segments_lowered"] == 1
    chunks = [r for r in port_recs if r["name"] == "stream.chunk"]
    assert len(chunks) == (4 if streamed else 0)
    assert all(c["parent"] == seg["id"] for c in chunks)
    assert sum(c["args"]["rows"] for c in chunks) == (len(pdf) if streamed else 0)


def test_tasks_on_pool_threads_nest_under_the_run(tracers):
    """With ``fugue.workflow.concurrency`` 4 the tasks run on pool threads,
    whose span stacks are empty: their spans still reach ``workflow.run``
    through its explicit parent, on both packages."""
    pdfs = [_frame(500, 4, seed=s) for s in range(4)]

    def build(ns):
        dag = ns.FugueWorkflow({"fugue.workflow.concurrency": 4})
        parts = [dag.df(p).partition_by("k").aggregate(ns.ff.sum(ns.col("v")).alias("s")) for p in pdfs]
        parts[0].union(*parts[1:], distinct=False).yield_dataframe_as("r", as_local=True)
        return dag

    (ref, ref_recs), (port, port_recs) = _both(build)
    assert len(port) == len(ref) == 16
    assert _chains(port_recs) == _chains(ref_recs)
    (run,) = [r for r in port_recs if r["name"] == "workflow.run"]
    tasks = [r for r in port_recs if r["name"] == "workflow.task"]
    assert len(tasks) == 9 and all(t["parent"] == run["id"] for t in tasks)
    assert len({t["tid"] for t in tasks} - {run["tid"]}) >= 1


# ---- the tracer core -----------------------------------------------------------


def test_span_nesting_args_and_error(tracers):
    """Reference ``test_span_nesting_args_and_error``, the same sequence
    through both tracers: the same records but for ids and clocks."""

    def run(tr):
        with tr.span("outer", cat="t", a=1) as so:
            so.set(b=2)
            with tr.span("inner", cat="t"):
                pass
            with pytest.raises(ValueError):
                with tr.span("boom", cat="t"):
                    raise ValueError("x")
        recs = tr.records()
        by_id = {r["id"]: r for r in recs}
        return [(r["name"], r["cat"], by_id.get(r["parent"], {}).get("name"), r["args"]) for r in recs], tr

    port, tr = run(PORT.obs.get_tracer())
    ref, _ = run(REF.obs.get_tracer())
    assert port == ref
    assert ("boom", "t", "outer", {"error": "ValueError"}) in port
    assert [n["name"] for n in tr.span_tree()] == ["outer"]
    assert all(r["id"].startswith(tobs.proc_ident() + ":") for r in tr.records())


def test_fork_boundary_protocol_mark_take_ingest(tracers):
    tr = PORT.obs.get_tracer()
    m = tr.mark()
    with tr.span("w1"):
        pass
    shipped = tr.take_since(m)
    assert [r["name"] for r in shipped] == ["w1"]
    tr.clear()
    tr.ingest(shipped)
    assert [r["name"] for r in tr.records()] == ["w1"]
    # ingest does not feed the span histograms (the recording side did)
    assert PORT.obs.get_span_metrics().latency.get(span="w1").count == 1


def test_disabled_path_records_nothing():
    """The disabled path by its structure: ``span`` hands out one shared
    null object, a traced verb calls straight through, and a whole traced
    workflow leaves no record and no span metric. The port's null span is
    its own, not the JAX package's."""
    tr = PORT.obs.get_tracer()
    tr.disable()
    _clear(PORT)
    assert tr.span("x", rows=1) is NULL_SPAN and tr.span("y") is NULL_SPAN
    assert NULL_SPAN is not jobs.NULL_SPAN
    with NULL_SPAN as sp:
        sp.set(anything=1)
    calls = []

    @tobs.traced_verb("engine.probe")
    def verb(x):
        calls.append(x)
        return x + 1

    assert verb(1) == 2 and calls == [1]
    e = PORT.engine()
    try:
        _lowered(PORT, _f32_frame(2000, 8)).run(e)
    finally:
        e.stop()
    assert tr.records() == [] and tr.dropped == 0
    assert PORT.obs.get_span_metrics().families()[0].series() == []


def test_trace_conf_enables_and_env_overrides(monkeypatch):
    tr = PORT.obs.get_tracer()
    tr.disable()
    try:
        TorchExecutionEngine(device="cpu", conf={FUGUE_TPU_CONF_TRACE_ENABLED: True})
        assert tr.enabled
        tr.disable()
        monkeypatch.setenv("FUGUE_TPU_TRACE", "0")
        TorchExecutionEngine(device="cpu", conf={FUGUE_TPU_CONF_TRACE_ENABLED: True})
        assert not tr.enabled  # the environment wins over the conf
        monkeypatch.setenv("FUGUE_TPU_TRACE", "1")
        NativeExecutionEngine({FUGUE_TPU_CONF_TRACE_ENABLED: False})
        assert tr.enabled
    finally:
        tr.disable()
        _clear(PORT)
    # the JAX package's tracer is another object: untouched by the port
    assert not REF.obs.get_tracer().enabled


def test_annotations_are_torch_profiler_ranges(tracers):
    """Spans opened with ``annotate=True`` enter a ``torch.profiler``
    range of their name (``fugue.tpu.trace.xla``, on by default); the
    switch turns them off."""
    tr = PORT.obs.get_tracer()
    assert tr._annotation_cls() is torch.profiler.record_function

    def ranges():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tr.span("plan.segment", cat="plan", annotate=True):
                torch.ones(4).sum()
            with tr.span("host.only", cat="t"):
                pass
        return {ev.key for ev in prof.key_averages()}

    assert "plan.segment" in ranges() - {"host.only"}
    tr.xla_annotate = False
    try:
        assert "plan.segment" not in ranges()
    finally:
        tr.xla_annotate = True


# ---- exports --------------------------------------------------------------------


def test_chrome_trace_passes_both_validators(tracers, samplers, tmp_path):
    """The port's Chrome trace of a traced lowered workflow, with the
    sampler's counter tracks, passes both packages' validators; its span
    names are the reference's for the same workflow."""
    pdf = _f32_frame(8000, 20)
    summaries = {}
    for label, ns in (("ref", REF), ("port", PORT)):
        ns.obs.get_sampler().sample_once()
        _, recs = _run_traced(ns, lambda n: _lowered(n, pdf))
        ns.obs.get_sampler().sample_once()
        p = ns.obs.write_chrome_trace(str(tmp_path / f"{label}.json"), recs)
        summaries[label] = ns.obs.validate_chrome_trace(p)
    port_file = str(tmp_path / "port.json")
    assert jobs.validate_chrome_trace(port_file) == summaries["port"]
    assert summaries["port"]["names"] == summaries["ref"]["names"]
    assert summaries["port"]["spans"] == summaries["ref"]["spans"]
    with open(port_file) as f:
        doc = json.load(f)
    counters = {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"}
    assert "host_rss_bytes" in counters and "overlap_fraction" in counters


def test_trace_dir_auto_export(tmp_path, tracers):
    """Reference ``test_workflow_trace_dir_auto_export``: one file a run,
    accepted by both validators."""
    e = TorchExecutionEngine(device="cpu", conf={FUGUE_TPU_CONF_TRACE_DIR: str(tmp_path)})
    try:
        for _ in range(2):
            dag = PORT.FugueWorkflow()
            dag.df(_frame(200, 4)).yield_dataframe_as("r", as_local=True)
            dag.run(e)
    finally:
        e.stop()
    files = sorted(f for f in os.listdir(tmp_path) if f.startswith("fugue_trace_"))
    assert len(files) == 2
    for f in files:
        for validate in (tobs.validate_chrome_trace, jobs.validate_chrome_trace):
            assert "workflow.run" in validate(str(tmp_path / f))["names"]
    # a workflow's conf sets it for its run only; tracing off writes nothing
    other = tmp_path / "wf"
    other.mkdir()
    dag = PORT.FugueWorkflow({FUGUE_TPU_CONF_TRACE_DIR: str(other)})
    dag.df(_frame(200, 4)).yield_dataframe_as("r", as_local=True)
    dag.run(NativeExecutionEngine())
    assert len(os.listdir(other)) == 1
    PORT.obs.get_tracer().disable()
    dag.run(NativeExecutionEngine())
    assert len(os.listdir(other)) == 1


def _families(text: str) -> set:
    return {
        line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")
    }


def test_prometheus_text_passes_both_validators(tracers, samplers):
    """The same faulted-and-retried lowered workflow on both engines: the
    port's page passes both validators, and the families of the shared
    sources (``resilience``, ``latency``, ``telemetry``, ``cache``,
    ``tuning``) are the same. The resource gauges differ by the probes each
    engine registers: the JAX engine's jit-cache and spill probes have no
    port here, and the port's ``device_bytes`` drops out under a torch
    built without CUDA."""
    pdf = _f32_frame(4000, 10)
    conf = {"fugue.tpu.fault.plan": "task.execute=error", "fugue.tpu.retry.task.attempts": 2,
            "fugue.tpu.retry.task.base": 0.001}
    pages = {}
    for label, ns in (("ref", REF), ("port", PORT)):
        _clear(ns)
        e = ns.engine(conf)
        try:
            _lowered(ns, pdf).run(e)
            ns.obs.get_sampler().sample_once()
            assert e.stats()["resilience"] == {"workflow.task_retries": 1}
            pages[label] = ns.obs.to_prometheus_text(e)
        finally:
            e.stop()
    port = pages["port"]
    for validate in (tobs.validate_prometheus_text, jobs.validate_prometheus_text):
        summary = validate(port)
        assert summary["histogram_series"] > 0
    assert 'span="plan.segment"' in port
    fams = {k: _families(v) for k, v in pages.items()}

    def shared(names):
        return {
            n for n in names
            if n.startswith(("fugue_tpu_resilience_", "fugue_tpu_span_", "fugue_tpu_telemetry_",
                             "fugue_tpu_cache_", "fugue_tpu_tuning_"))
        }

    assert shared(fams["port"]) == shared(fams["ref"])
    assert "fugue_tpu_resilience_workflow_task_retries" in fams["port"]
    res = {k: {n for n in v if n.startswith("fugue_tpu_resource_")} for k, v in fams.items()}
    assert res["port"] <= res["ref"]
    only_ref = {n[len("fugue_tpu_resource_"):] for n in res["ref"] - res["port"]}
    expect = {"jit_cache_entries"}
    if not torch.backends.cuda.is_built():
        expect.add("device_bytes")
    assert only_ref == expect
    # the port's own groups: the engine's stats sources, flattened
    assert "fugue_tpu_pipeline_runs" in fams["port"] and "fugue_tpu_plan_segments_executed" in fams["port"]


# ---- engine.stats(), reset_stats(), labels, report ------------------------------


def test_engine_stats_surface_and_reset_keeps_entries(tracers, samplers):
    e = TorchExecutionEngine(
        device="cpu",
        conf={FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: 2048, FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH: 2},
    )
    try:
        st = e.stats()
        assert set(st) == {"resilience", "plan", "analysis", "cache", "tuning", "pipeline", "shuffle",
                           "latency", "telemetry"}
        assert e.result_cache.stats is e.metrics.get("cache") and e.tuner is e.metrics.get("tuning")
        assert e._shuffle_stats is e.metrics.get("shuffle")
        assert e.pipeline_stats is e.metrics.get("pipeline")
        assert e.resilience_stats is e.metrics.get("resilience")
        assert e._host_engine.resilience_stats is e.resilience_stats
        assert e.plan_stats is e.metrics.get("plan")
        _lowered(PORT, _stream(PORT, _f32_frame(6000, 8), 2048)).run(e)
        PORT.obs.get_sampler().sample_once()
        st = e.stats()
        assert st["pipeline"]["runs"] == 1 and st["plan"]["segments_executed"] == 1
        assert st["latency"]["stream.chunk"]["count"] == 3
        assert st["telemetry"]["samples"] == 1
        e.resilience_stats.inc("workflow.task_retries")
        before = e.metrics.snapshot()
        e.resilience_stats.inc("workflow.task_retries", 2)
        assert e.metrics.delta(before)["resilience"]["workflow.task_retries"] == 2
        n_series = len(PORT.obs.get_span_metrics().latency.series())
        probes = PORT.obs.get_sampler().probe_names()
        e.reset_stats()
        st = e.stats()
        assert st["resilience"] == {} and st["latency"] == {} and st["telemetry"]["samples"] == 0
        assert st["pipeline"]["runs"] == 0 and st["plan"]["segments_executed"] == 0
        # the entries stay: histogram series and sampler probes
        assert len(PORT.obs.get_span_metrics().latency.series()) == n_series > 0
        assert PORT.obs.get_sampler().probe_names() == probes
    finally:
        e.stop()


def test_workflow_run_gets_workflow_and_run_labels(tracers):
    """Reference ``test_workflow_run_gets_workflow_and_run_labels``."""
    e = PORT.engine()
    pdf = _frame(500, 4)
    try:
        for _ in range(2):
            dag = PORT.FugueWorkflow()
            dag.df(pdf).yield_dataframe_as("r", as_local=True)
            dag.run(e)
        runs = [
            labels for labels, h in PORT.obs.get_span_metrics().latency.series()
            if labels.get("span") == "workflow.run" and h.count
        ]
        assert len(runs) == 2
        assert len({r["workflow"] for r in runs}) == 1 and runs[0]["workflow"].startswith("wf-")
        assert len({r["run"] for r in runs}) == 2
        assert e.stats()["latency"]["workflow.run"]["count"] == 2
        txt = e.report()
        assert "p50_ms" in txt and "p99_ms" in txt and "workflow.run" in txt and "[pipeline]" in txt
        recs = [r for r in PORT.obs.get_tracer().records() if r["name"] == "workflow.run"]
        assert len({r["trace"] for r in recs}) == 2
    finally:
        e.stop()


def test_event_log_and_timeline(tmp_path, monkeypatch):
    """The copied flight recorder: conf and environment switches, emit and
    read, and ``timeline()`` of the last run filtered to its trace."""
    d = str(tmp_path / "ev")
    log = tobs.get_event_log()
    tr = PORT.obs.get_tracer()
    try:
        e = NativeExecutionEngine({FUGUE_TPU_CONF_EVENTS_ENABLED: True, FUGUE_TPU_CONF_EVENTS_DIR: d})
        assert log.enabled
        tr.enable()
        dag = PORT.FugueWorkflow()
        dag.df(_frame(10, 2)).yield_dataframe_as("r", as_local=True)
        dag.run(e)
        with tobs.trace_scope(dag._last_trace_id):
            log.emit("lease.steal", task="t1", owner="w1", prev_owner="w0", reason="worker_lost")
        with tobs.trace_scope("another"):
            log.emit("lease.steal", task="t2", owner="w9", prev_owner="w8", reason="worker_lost")
        assert {ev["type"] for ev in tobs.read_events(d)} == {"lease.steal"}
        txt = dag.timeline(conf={FUGUE_TPU_CONF_EVENTS_DIR: d})
        assert "stolen by w1 from w0 (worker_lost)" in txt and "w9" not in txt
        assert "no events dir" in PORT.FugueWorkflow().timeline()
        monkeypatch.setenv("FUGUE_TPU_EVENTS", "0")
        NativeExecutionEngine({FUGUE_TPU_CONF_EVENTS_ENABLED: True, FUGUE_TPU_CONF_EVENTS_DIR: d})
        assert not log.enabled
    finally:
        log.configure(d, False)
        log.close()
        tr.disable()
        _clear(PORT)


def _spool_doc(spool_dir, proc: str, label: str, names, trace) -> None:
    """A remote process's spool as a dist worker publishes it: its spans,
    with ids prefixed by its process identity and a raw pid that collides
    with the other host's."""
    spans = [{"name": n, "cat": "dist", "ts": 1000 * i, "dur": 500, "pid": 123, "tid": 1,
              "id": f"{proc}:{i}", "parent": None, "proc": proc, "trace": trace if i == 1 else None,
              "args": {}} for i, n in enumerate(names, 1)]
    doc = {"version": 1, "proc": proc, "pid": 123, "label": label, "spans": spans,
           "counters": [[5, {"host_rss_bytes": 1.0}]], "stats": {}}
    os.makedirs(spool_dir, exist_ok=True)
    with open(os.path.join(spool_dir, proc + ".spool.json"), "w") as f:
        json.dump(doc, f)


def test_spool_and_assembled_trace_match_reference(tmp_path, tracers):
    """The copied span spool and cluster-trace assembler, which no port
    process writes to yet (their dist and serve callers wait): the port's
    spool of a traced run, beside two remote spools and a torn one, merges
    into the trace the JAX package's assembler makes of the same directory,
    and both validators accept the port's file."""
    dag = PORT.FugueWorkflow()
    dag.df(_frame(40, 3)).partition_by("k").aggregate(s=PORT.ff.sum(PORT.col("v"))).yield_dataframe_as(
        "r", as_local=True)
    dag.run(PORT.engine())
    tid = dag._last_trace_id
    local = PORT.obs.get_tracer().records()
    d = str(tmp_path / "spool")
    from fugue_tpu.obs.assemble import assemble_trace as jassemble
    from fugue_tpu_torch.obs.assemble import assemble_trace
    from fugue_tpu_torch.obs.spool import publish_spool, read_spools

    p1 = publish_spool(d, stats={"n": 1}, label="worker w0")
    assert publish_spool(d, stats={"n": 2}, label="worker w0") == p1  # last write wins
    _spool_doc(d, "hostA-123", "worker w0", ["dist.task", "dist.fetch"], tid)
    _spool_doc(d, "hostB-123", "worker w1", ["dist.task"], tid)
    (tmp_path / "spool" / "ghost.spool.json").write_text('{"spans": [')  # torn
    docs = read_spools(d)
    assert [doc["proc"] for doc in docs] == [doc["proc"] for doc in jobs.read_spools(d)]
    assert len(docs) == 3 and {doc["stats"].get("n") for doc in docs} == {2, None}
    summaries = {}
    for name, fn in (("port", assemble_trace), ("ref", jassemble)):
        for filt in (None, tid):
            out = str(tmp_path / f"{name}-{filt}.json")
            got = fn(d, out, local_records=local, local_counters=[], trace_id=filt)
            summaries[name, filt] = {k: got[k] for k in ("spans", "processes", "process_spans",
                                                         "process_names", "traces")}
            if name == "port":
                assert jobs.validate_chrome_trace(out)["spans"] == got["spans"]
    for filt in (None, tid):
        assert summaries["port", filt] == summaries["ref", filt]
    assert summaries["port", None]["processes"] == 3
    assert summaries["port", None]["spans"] == len(local) + 3
    assert summaries["port", tid]["spans"] == len([r for r in local if r.get("trace") == tid]) + 2


# ---- the resource sampler ---------------------------------------------------------


def test_sampler_start_stop_idempotent_and_ring_bounded(samplers):
    s = PORT.obs.get_sampler()
    assert s is not REF.obs.get_sampler() and not s.running
    s.start(interval=0.005, ring_size=8)
    t1 = s._thread
    s.start()
    assert s._thread is t1 and s.running
    t1.join(timeout=0.2)
    s.stop()
    s.stop()
    assert not s.running and not t1.is_alive()
    assert 0 < len(s.series()) <= 8
    vals = s.sample_once()
    assert vals["host_rss_bytes"] > 0
    assert ("device_bytes" in vals) == torch.backends.cuda.is_built()
    ts, last = s.series()[-1]
    assert last == vals and ts > 0
    assert not [t for t in threading.enumerate() if t.name == "fugue-tpu-telemetry" and t.is_alive()]


def test_sampler_probe_lifecycle(samplers):
    """Reference ``test_sampler_probe_lifecycle``: a probe that raises
    ``ProbeGone`` leaves, one that errors stays and skips a tick."""
    s = PORT.obs.get_sampler()
    s.register_probe("custom_gauge", lambda: 42.0)
    assert s.sample_once()["custom_gauge"] == 42.0

    def gone():
        raise tsampler.ProbeGone()

    def flaky():
        raise ValueError("x")

    s.register_probe("dead", gone)
    s.register_probe("flaky", flaky)
    vals = s.sample_once()
    assert "dead" not in s.probe_names() and "flaky" not in vals and "flaky" in s.probe_names()
    s.unregister_probe("custom_gauge")
    s.unregister_probe("flaky")


def test_engine_probes_follow_the_engine(samplers, monkeypatch):
    """Conf starts the sampler and the engine registers its probes, bound
    weakly: a collected engine's probe leaves. The environment wins."""
    import gc

    s = PORT.obs.get_sampler()
    e = TorchExecutionEngine(
        device="cpu",
        conf={FUGUE_TPU_CONF_TELEMETRY_ENABLED: True, FUGUE_TPU_CONF_TELEMETRY_INTERVAL: 0.01,
              FUGUE_TPU_CONF_TELEMETRY_RING: 16},
    )
    assert s.running and s.interval == 0.01
    assert {"host_rss_bytes", "overlap_fraction"} <= set(s.probe_names())
    assert s.sample_once()["overlap_fraction"] == 0.0
    monkeypatch.setenv("FUGUE_TPU_TELEMETRY", "0")
    TorchExecutionEngine(device="cpu", conf={FUGUE_TPU_CONF_TELEMETRY_ENABLED: True})
    assert not s.running
    del e
    gc.collect()
    s.sample_once()  # the last engine's probe is gone with it
    assert "overlap_fraction" not in s.probe_names()


def test_device_bytes_probe_states(monkeypatch):
    """No CUDA build: ``ProbeGone``. CUDA built but not initialized: 0.0,
    with no call that would create a context. Initialized: the caching
    allocator's bytes summed over the devices."""
    monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: False)
    with pytest.raises(tsampler.ProbeGone):
        tsampler._device_bytes()
    monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)

    def touch(*a, **k):
        raise AssertionError("the probe touched CUDA before it was initialized")

    monkeypatch.setattr(torch.cuda, "device_count", touch)
    monkeypatch.setattr(torch.cuda, "memory_allocated", touch)
    assert tsampler._device_bytes() == 0.0
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 1000 * (i + 1))
    assert tsampler._device_bytes() == 3000.0


_OBS_PATH_ON_THE_CPU = """
import json, sys, threading, numpy as np, pandas as pd, pyarrow as pa, torch
import chip_smoke
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.obs import get_sampler, get_tracer
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
pdf = chip_smoke.plan_frame(np, pd, 40_000, 0)
exp = chip_smoke.plan_oracle(np, pd, *(pdf[c].to_numpy() for c in "kvw"))
out = chip_smoke.phase_obs_path(torch, np, pd, pa, bg, ff, col, TorchExecutionEngine(device="cpu"), pdf, exp,
                                stream_rows=40_000, stream_chunk=8_000)
cells = out["cells"]
print("RESULT", json.dumps({c: [r["launches"], r.get("span_names"), r.get("retries")] for c, r in cells.items()}))
print("ROWS", cells["traced-stream"]["chunk_span_rows"])
print("FAULT", cells["fault-retry"]["stream_fault"]["raised"], cells["fault-retry"]["task_attempts"])
print("LEFT", get_tracer().enabled, get_sampler().running, [t.name for t in threading.enumerate()
                                                           if t.name.startswith("fugue")])
print("JAX", "jax" in sys.modules or "fugue_tpu" in sys.modules)
"""


def test_chip_smoke_obs_path_on_the_cpu():
    """The phase's three cells pass their checks at small size in a
    process that loads no JAX: the oracle, the span trees, the Chrome
    trace, the Prometheus page, five chunk spans holding every row, one
    retry, the stream's injected error; no binned-sum launch on the CPU;
    the tracer and sampler off, and no thread of theirs left, after."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _OBS_PATH_ON_THE_CPU], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("RESULT", "ROWS", "FAULT", "LEFT", "JAX")))
    zero = {"bin_sum": 0, "bin_sum_count": 0}
    spans = {"plan.optimize": 1, "workflow.run": 1, "workflow.task": 2, "plan.segment": 1}
    assert json.loads(lines["RESULT"]) == {
        "traced-lowered": [zero, {**spans, "engine.to_df": 2}, None],
        "traced-stream": [zero, {**spans, "engine.to_df": 1, "stream.chunk": 5}, None],
        "fault-retry": [zero, None, 1],
    }
    assert lines["ROWS"] == "40000"
    assert lines["FAULT"] == "injected fault at stream.chunk [2, 1]"
    assert lines["LEFT"] == "False False []"
    assert lines["JAX"] == "False"
