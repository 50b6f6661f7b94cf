"""The port's adaptive tuner (``fugue_tpu_torch/tuning``) against the JAX
package's (``fugue_tpu/tuning``).

The cases of ``tests/tuning/test_tuning.py`` and ``test_roofline.py``:

- the adjustment policy: the port's pure ``adjust_stream``,
  ``adjust_buckets`` and ``adjust_pipeline`` give the reference's
  decision on the same observations;
- the store: atomic publish that keeps foreign keys, a corrupt file read
  as defaults with one warning, LRU eviction of stale plans, a race of
  two processes (each a fresh interpreter with no JAX);
- end to end through ``FugueWorkflow.run`` on ``TorchExecutionEngine(
  device="cpu")``, the tuner on, then off, beside ``JaxExecutionEngine``
  (the 8-device CPU mesh) over the same numpy-seeded rows, tuner on and
  off: equal results, and on the port the learned chunk size, its
  persistence across a restart, the kill switch, per-stream pipeline
  stats, ``explain()``, ``engine.stats()["tuning"]`` and its Prometheus
  lines. The JAX engine gets the rows bounded: its streamed steps have
  aborted a loaded xdist worker (in ``jax/streaming.py``'s donated step,
  with and without its prefetch thread), as they have in runs of
  ``tests/tuning/test_tuning.py``;
- the roofline recorder: fold math, the store's ``rooflines`` key, the
  shared LRU bound, the verb observer's gates.

No CPU test asserts on wall time, so each counts the same in every run:
a stream on the CPU may finish under the tuner's ``MIN_WALL_S`` (0.15 s),
below which a run carries no signal, so the end-to-end cases inject the
stream's observation with a wall of 1 s (``_inject_wall``); the policy
itself is the pure functions'. The reference's tests that need a slow
stream (and fail now and then under xdist) are mirrored this way.

Left out: ``test_tenant_overlay_allows_tuning_keys``, which reads the
serving layer's tenant policy (``serve/``, ROADMAP.md A.13, not ported).
Added: the default store path under ``fugue_tpu_torch/build``, a store
file shared with the JAX package (their plan keys differ), the chunk
counts of chip_smoke's ``tuned-stream`` cell at small size (80 → 20 → 8
chunks), ``join_params`` inside a scope, and a lowered streamed
aggregate whose learned chunk size merges the source's chunks.
"""

import json
import logging
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import fugue_tpu.column as jcolumn
import fugue_tpu.tuning as jtuning
from fugue_tpu import FugueWorkflow as JFugueWorkflow
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu.tuning.tuner import adjust_pipeline as jadjust_pipeline

import fugue_tpu_torch.column as tcolumn
import fugue_tpu_torch.obs.tracer as ttracer
import fugue_tpu_torch.torch.streaming as tstreaming
import fugue_tpu_torch.tuning.tuner as ttuner
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
from fugue_tpu_torch.obs import get_tracer, set_verb_observer, validate_prometheus_text
from fugue_tpu_torch.obs.prom import to_prometheus_text
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.tuning import (
    RooflineRecorder,
    TunedStore,
    adjust_buckets,
    adjust_pipeline,
    adjust_stream,
    default_tuned_path,
    describe_tuning,
    plan_fingerprint,
    resolve_tuned_path,
    rooflines_enabled,
    run_scope,
)
from fugue_tpu_torch.tuning.roofline import MIN_VERB_WALL_S
from fugue_tpu_torch.workflow import FugueWorkflow

CACHE = "fugue.tpu.cache.enabled"
CHUNK_ROWS = "fugue.tpu.stream.chunk_rows"
DEPTH = "fugue.tpu.stream.prefetch_depth"
TUNING = "fugue.tpu.tuning.enabled"
MAX_ENTRIES = "fugue.tpu.tuning.max_entries"
PATH = "fugue.tpu.tuning.path"
ROOFLINES = "fugue.tpu.tuning.rooflines"

ROWS = 60_000
CHUNK = 2048
GROUPS = 32

REF = types.SimpleNamespace(name="ref", col=jcolumn.col, ff=jcolumn.functions, Workflow=JFugueWorkflow,
                            Stream=JStream, Arrow=JArrowDataFrame, engine=JaxExecutionEngine)
PORT = types.SimpleNamespace(name="port", col=tcolumn.col, ff=tcolumn.functions, Workflow=FugueWorkflow,
                             Stream=LocalDataFrameIterableDataFrame, Arrow=ArrowDataFrame,
                             engine=lambda conf=None: TorchExecutionEngine(device="cpu", conf=conf))


def _table(rows=ROWS, seed=5):
    rng = np.random.default_rng(seed)
    return pa.Table.from_pandas(
        pd.DataFrame({"k": rng.integers(0, GROUPS, rows), "v": rng.random(rows)}), preserve_index=False)


_TBL = _table()


def _stream(m, tbl=_TBL, chunk=CHUNK):
    return m.Stream((m.Arrow(tbl.slice(s, min(chunk, tbl.num_rows - s)))
                     for s in range(0, tbl.num_rows, chunk)), schema=m.Arrow(tbl).schema)


def _engine(m, path, **extra):
    return m.engine({CHUNK_ROWS: CHUNK, CACHE: False, PATH: str(path), **extra})


def _run_agg(m, eng, wf_conf=None):
    """The stream's keyed SUM and COUNT through ``FugueWorkflow.run``; the
    JAX engine gets the same rows bounded (its streamed steps have aborted
    a loaded xdist worker, jax/streaming.py)."""
    dag = m.Workflow(wf_conf)
    (dag.df(_TBL.to_pandas() if m is REF else _stream(m)).partition_by("k")
     .aggregate(m.ff.sum(m.col("v")).alias("s"), m.ff.count(m.col("v")).alias("n"))
     .yield_dataframe_as("r", as_local=True))
    dag.run(eng)
    return dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True), dag


@pytest.fixture
def _inject_wall(monkeypatch):
    """The port's stream observations carry a wall of at least 1 s, so
    the policy, not the CPU's speed, decides what a run teaches."""
    real = ttuner.StreamHandle.observe

    def observe(self, run):
        real(self, {**run, "wall_s": max(float(run.get("wall_s", 0.0)), 1.0)})

    monkeypatch.setattr(ttuner.StreamHandle, "observe", observe)


def _same_agg(got: pd.DataFrame, exp: pd.DataFrame) -> None:
    assert got["k"].tolist() == exp["k"].tolist() and got["n"].tolist() == exp["n"].tolist()
    assert np.allclose(got["s"], exp["s"], rtol=1e-9, atol=0)


# ---- the adjustment policy (pure functions), each held to the reference's ----------


def _both_adjust(fn, jfn, *args):
    got, exp = fn(*args), jfn(*args)
    assert got == exp, (got, exp)
    return got


def test_adjust_stream_grows_chunk_when_over_band():
    adj = _both_adjust(adjust_stream, jtuning.adjust_stream, 2048, 0,
                       {"chunks_prefetched": 128, "wall_s": 1.0, "rows": 262144, "bytes": 0}, 1 << 30)
    assert adj is not None and not adj["converged"]
    assert 2048 < adj["chunk_rows"] <= 2048 * 4 and "chunk_rows 2048 ->" in adj["evidence"]


def test_adjust_stream_no_signal_on_tiny_runs():
    for obs in ({"chunks_prefetched": 128, "wall_s": 0.01}, {"chunks_prefetched": 0, "wall_s": 9.9}):
        assert _both_adjust(adjust_stream, jtuning.adjust_stream, 2048, 0, obs, 0) is None


def test_adjust_stream_in_band_converges():
    adj = _both_adjust(adjust_stream, jtuning.adjust_stream, 65536, 0,
                       {"chunks_prefetched": 8, "wall_s": 1.0}, 0)
    assert adj["converged"] and adj["chunk_rows"] == 65536


def test_adjust_stream_depth_responds_to_waits():
    starved = {"chunks_prefetched": 12, "wall_s": 2.0, "producer_wait_s": 0.0, "consumer_wait_s": 1.0}
    assert _both_adjust(adjust_stream, jtuning.adjust_stream, 65536, 2, starved, 0)["prefetch_depth"] == 4
    slow = {"chunks_prefetched": 12, "wall_s": 2.0, "producer_wait_s": 1.0, "consumer_wait_s": 0.0}
    assert _both_adjust(adjust_stream, jtuning.adjust_stream, 65536, 8, slow, 0)["prefetch_depth"] == 4
    serial = {"chunks_prefetched": 12, "wall_s": 2.0, "consumer_wait_s": 1.0}
    assert _both_adjust(adjust_stream, jtuning.adjust_stream, 65536, 0, serial, 0)["prefetch_depth"] == 0


def test_adjust_stream_byte_cap_bounds_chunk():
    adj = _both_adjust(adjust_stream, jtuning.adjust_stream, 4096, 0,
                       {"chunks_prefetched": 256, "wall_s": 3.0, "rows": 1 << 20, "bytes": 1 << 30}, 8 << 20)
    assert adj["chunk_rows"] == 4096


def test_adjust_buckets_shrinks_when_peak_far_under_budget():
    adj = _both_adjust(adjust_buckets, jtuning.adjust_buckets, 256,
                       {"peak_device_bytes": 1 << 20, "wall_s": 2.0}, 256 << 20)
    assert not adj["converged"] and adj["buckets"] == 32
    adj = _both_adjust(adjust_buckets, jtuning.adjust_buckets, 8,
                       {"peak_device_bytes": 64 << 20, "wall_s": 0.05}, 16 << 20)
    assert adj["buckets"] > 8
    adj = _both_adjust(adjust_buckets, jtuning.adjust_buckets, 64,
                       {"peak_device_bytes": 100 << 20, "wall_s": 2.0}, 256 << 20)
    assert adj["converged"] and adj["buckets"] == 64
    assert _both_adjust(adjust_buckets, jtuning.adjust_buckets, 8,
                        {"peak_device_bytes": 1 << 20, "wall_s": 2.0}, 256 << 20) is None
    # the pair pipeline's policy, copied for the shuffle ladder (A.7)
    for obs in ({"pipe_chunks": 12, "wall_s": 1.0, "pipe_consumer_wait_s": 1.0},
                {"pipe_chunks": 12, "wall_s": 1.0, "pipe_producer_wait_s": 1.0, "mem_demotions": 3},
                {"pipe_chunks": 12, "wall_s": 1.0, "mem_bytes_used": 1 << 20},
                {"pipe_chunks": 0, "wall_s": 1.0}):
        _both_adjust(adjust_pipeline, jadjust_pipeline, 2, 1 << 28, obs)


# ---- the store ------------------------------------------------------------------------


def test_store_publish_atomic_and_preserves_foreign_keys(tmp_path):
    path = str(tmp_path / "_tuned.json")
    with open(path, "w") as f:
        json.dump({"dense_sum": {"cpu": "onehot"}}, f)
    store = TunedStore(path)
    assert store.publish("fp1", lambda e: dict(e, streams={"s": {"chunk_rows": 1}}))
    doc = json.load(open(path))
    assert doc["dense_sum"] == {"cpu": "onehot"}
    assert doc["tuning"]["plans"]["fp1"]["streams"]["s"]["chunk_rows"] == 1
    assert doc["tuning"]["plans"]["fp1"]["gen"] == 1
    assert [f for f in os.listdir(tmp_path) if f != "_tuned.json"] == []


def test_store_corrupt_file_defaults_with_one_warning(tmp_path, caplog):
    path = str(tmp_path / "_tuned.json")
    with open(path, "w") as f:
        f.write('{"tuning": {"plans": {"fp1"')  # torn mid-write
    with caplog.at_level(logging.WARNING, logger="fugue_tpu_torch.tuning"):
        s1 = TunedStore(path)
        assert s1.plan_entry("fp1") is None and s1.plans() == {}
        assert TunedStore(path).plan_entry("fp1") is None
    assert len([r for r in caplog.records if "corrupt" in r.getMessage()]) == 1
    assert s1.publish("fp2", lambda e: dict(e, streams={"s": {"chunk_rows": 2}}))
    assert json.load(open(path))["tuning"]["plans"]["fp2"]


def test_store_stale_fingerprint_eviction(tmp_path):
    import time

    path = str(tmp_path / "_tuned.json")
    store = TunedStore(path, max_entries=3)
    for i in range(5):
        assert store.publish(f"fp{i}", lambda e: dict(e, streams={"s": {"chunk_rows": 1}}))
        time.sleep(0.01)  # distinct last-used times
    assert sorted(json.load(open(path))["tuning"]["plans"]) == ["fp2", "fp3", "fp4"]
    assert store.count() == 3


_STORE_RACE = r"""
import sys
from fugue_tpu_torch.tuning import TunedStore
path, wid = sys.argv[1], sys.argv[2]
store = TunedStore(path)
for i in range(25):
    store.publish(f"fp_{wid}", lambda e: dict(e, streams={"s": {"chunk_rows": i + 1}}))
    store.plans()  # a read between publishes always parses
print(store.plan_entry(f"fp_{wid}")["streams"]["s"]["chunk_rows"])
"""


def test_store_two_process_publish_race(tmp_path):
    path = str(tmp_path / "_tuned.json")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.getcwd(), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _STORE_RACE, path, str(w)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for w in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(int(out.strip()))
    assert outs == [25, 25]
    plans = json.load(open(path))["tuning"]["plans"]
    assert set(plans) <= {"fp_0", "fp_1"} and len(plans) >= 1
    assert any(e["streams"]["s"]["chunk_rows"] == 25 for e in plans.values())
    assert all(1 <= e["streams"]["s"]["chunk_rows"] <= 25 for e in plans.values())


# ---- end to end: learning, convergence, restart, the kill switch --------------------------


def test_warm_runs_converge_and_persist(tmp_path, _inject_wall):
    path = tmp_path / "_tuned.json"
    eng = _engine(PORT, path)
    res0, dag0 = _run_agg(PORT, eng)
    fp = dag0.last_plan_fingerprint
    assert fp is not None
    t = eng.stats()["tuning"]
    assert t["decisions"] >= 1 and t["static"] >= 1 and t["observations"] >= 1
    res1, dag1 = _run_agg(PORT, eng)
    assert dag1.last_plan_fingerprint == fp
    pd.testing.assert_frame_equal(res0, res1)
    t = eng.stats()["tuning"]
    last = [d for d in t["last_decisions"] if d["target"] == "stream"][-1]
    assert t["adaptive"] >= 1 and last["source"] == "adaptive" and last["value"]["chunk_rows"] > CHUNK
    entry = json.load(open(path))["tuning"]["plans"][fp]
    assert entry["streams"]["aggregate"]["chunk_rows"] > CHUNK
    eng2 = _engine(PORT, path)  # a restart: a fresh tuner over the same file
    res2, _ = _run_agg(PORT, eng2)
    pd.testing.assert_frame_equal(res0, res2)
    t2 = eng2.stats()["tuning"]
    assert t2["adaptive"] >= 1 and t2["loads"] >= 1
    # the JAX engine, tuner on and off, on the same stream
    ref_on, _ = _run_agg(REF, _engine(REF, tmp_path / "ref.json"))
    ref_off, _ = _run_agg(REF, _engine(REF, tmp_path / "ref.json", **{TUNING: False}))
    for got in (res0, res1, res2):
        _same_agg(got, ref_on)
    pd.testing.assert_frame_equal(ref_on, ref_off)


def test_kill_switch_restores_static_behavior(tmp_path, _inject_wall):
    path = tmp_path / "_tuned.json"
    eng = _engine(PORT, path)
    res_ref, _ = _run_agg(PORT, eng)
    _run_agg(PORT, eng)
    assert eng.stats()["tuning"]["adaptive"] >= 1
    eng_off = _engine(PORT, path, **{TUNING: False})
    res_off, _ = _run_agg(PORT, eng_off)
    pd.testing.assert_frame_equal(res_ref, res_off)
    t = eng_off.stats()["tuning"]
    assert t["decisions"] == 0 and t["observations"] == 0 and t["loads"] == 0
    res_wf, _ = _run_agg(PORT, eng, wf_conf={TUNING: False})  # this workflow only
    pd.testing.assert_frame_equal(res_ref, res_wf)
    assert TUNING not in eng.conf
    _same_agg(res_ref, _run_agg(REF, _engine(REF, tmp_path / "ref.json", **{TUNING: False}))[0])


def test_disabled_matches_never_enabled_chunking(tmp_path, _inject_wall):
    """``enabled=false`` chunks as an engine that never had a store."""
    path = tmp_path / "_tuned.json"
    eng = _engine(PORT, path)
    _run_agg(PORT, eng)
    _run_agg(PORT, eng)  # a learned entry exists now
    learned = tstreaming.last_run_stats["chunks"]
    _run_agg(PORT, _engine(PORT, path, **{TUNING: False}))
    off = tstreaming.last_run_stats["chunks"]
    _run_agg(PORT, _engine(PORT, tmp_path / "other.json"))
    fresh = tstreaming.last_run_stats["chunks"]
    assert off == fresh == -(-ROWS // CHUNK) and learned < off


def test_max_entries_conf(tmp_path):
    assert _engine(PORT, tmp_path / "_tuned.json", **{MAX_ENTRIES: 7}).tuner.store.max_entries == 7


# ---- surfaces -----------------------------------------------------------------------------


def test_per_stream_pipeline_stats(tmp_path):
    eng = _engine(PORT, tmp_path / "_tuned.json", **{DEPTH: 2})
    _run_agg(PORT, eng)
    ps = eng.stats()["pipeline"]
    assert "streams" in ps and len(ps["streams"]) >= 1
    sid, s = next(iter(ps["streams"].items()))
    assert "aggregate" in sid
    for k in ("runs", "chunks_prefetched", "producer_wait_s", "consumer_wait_s", "overlap_fraction"):
        assert k in s
    assert s["runs"] >= 1 and s["chunks_prefetched"] >= 1


def test_explain_renders_decisions(tmp_path, _inject_wall):
    eng = _engine(PORT, tmp_path / "_tuned.json")

    def dag():
        d = FugueWorkflow()
        (d.df(_stream(PORT)).partition_by("k")
         .aggregate(tcolumn.functions.sum(tcolumn.col("v")).alias("s"),
                    tcolumn.functions.count(tcolumn.col("v")).alias("n"))
         .yield_dataframe_as("r", as_local=True))
        return d

    cold = dag().explain(engine=eng)
    assert "Adaptive tuning" in cold and "static: no observations" in cold
    _, d1 = _run_agg(PORT, eng)
    warm = dag().explain(engine=eng)
    assert d1.last_plan_fingerprint in warm and "chunk_rows=" in warm and "obs=" in warm
    off = dag().explain(conf={TUNING: False}, engine=eng)
    assert "DISABLED (fugue.tpu.tuning.enabled=false)" in off


def test_stats_group_and_reset_contract(tmp_path, _inject_wall):
    eng = _engine(PORT, tmp_path / "_tuned.json")
    _run_agg(PORT, eng)
    _run_agg(PORT, eng)
    t = eng.stats()["tuning"]
    assert t["decisions"] >= 2 and t["entries"] >= 1
    eng.reset_stats()
    t = eng.stats()["tuning"]
    assert t["decisions"] == 0 and t["observations"] == 0 and t["entries"] >= 1


def test_tuning_flattens_onto_metrics(tmp_path):
    eng = _engine(PORT, tmp_path / "_tuned.json")
    _run_agg(PORT, eng)
    text = to_prometheus_text(engine=eng)
    assert "fugue_tpu_tuning_decisions" in text and "fugue_tpu_tuning_entries" in text
    validate_prometheus_text(text)


def test_describe_tuning_without_engine(tmp_path):
    lines = describe_tuning({PATH: str(tmp_path / "x.json")}, "deadbeef")
    assert any("static: no observations" in ln for ln in lines)
    ref = jtuning.describe_tuning({PATH: str(tmp_path / "x.json")}, "deadbeef")
    assert lines[2:] == ref[2:] and len(lines) == len(ref)


# ---- the roofline recorder ---------------------------------------------------------------


class _Stats:
    def __init__(self):
        self.d = {}

    def inc(self, k, n=1):
        self.d[k] = self.d.get(k, 0) + n


@pytest.fixture
def tracer():
    tr = get_tracer()
    tr.clear()
    tr.enable()
    yield tr
    tr.disable()
    tr.clear()


def test_fold_math_best_and_totals(tmp_path):
    rec = RooflineRecorder(TunedStore(str(tmp_path / "_tuned.json")))
    rec.observe("engine.filter", "float", 2, wall_s=0.25, rows=1_000_000, nbytes=8_000_000)
    rec.observe("engine.filter", "float", 2, wall_s=0.50, rows=1_000_000, nbytes=16_000_000)
    assert rec.pending_count() == 1
    (entry,) = rec.snapshot().values()
    assert entry["obs"] == 2 and entry["rows"] == 2_000_000 and entry["bytes"] == 24_000_000
    assert entry["best_bytes_s"] == pytest.approx(16_000_000 / 0.5)
    assert entry["best_rows_s"] == pytest.approx(1_000_000 / 0.25)
    assert entry["last_bytes_s"] == pytest.approx(16_000_000 / 0.5)
    assert entry["last_rows_s"] == pytest.approx(1_000_000 / 0.5)
    jrec = jtuning.RooflineRecorder(jtuning.TunedStore(str(tmp_path / "ref.json")))
    jrec.observe("engine.filter", "float", 2, wall_s=0.25, rows=1_000_000, nbytes=8_000_000)
    jrec.observe("engine.filter", "float", 2, wall_s=0.50, rows=1_000_000, nbytes=16_000_000)
    assert jrec.snapshot() == rec.snapshot()


def test_flush_publishes_delta_and_preserves_foreign_keys(tmp_path):
    path = str(tmp_path / "_tuned.json")
    with open(path, "w") as f:
        json.dump({"tuning": {"version": 1, "plans": {"fp": {"x": 1}}}}, f)
    st = _Stats()
    store = TunedStore(path, stats=st)
    rec = RooflineRecorder(store, stats=st)
    rec.observe("engine.take", "int", 4, wall_s=0.1, rows=1000, nbytes=32_000)
    assert rec.flush() and rec.pending_count() == 0
    doc = json.load(open(path))
    assert doc["tuning"]["plans"] == {"fp": {"x": 1}}
    assert doc["rooflines"]["entries"]["engine.take|int|w4"]["obs"] == 1
    assert st.d["roofline_publishes"] == 1
    other = RooflineRecorder(TunedStore(path))
    other.observe("engine.take", "int", 4, wall_s=0.1, rows=1000, nbytes=32_000)
    assert other.flush()
    assert json.load(open(path))["rooflines"]["entries"]["engine.take|int|w4"]["obs"] == 2
    assert store.rooflines()["engine.take|int|w4"]["obs"] == 2


def test_rooflines_share_the_lru_bound(tmp_path):
    st = _Stats()
    store = TunedStore(str(tmp_path / "_tuned.json"), max_entries=3, stats=st)
    rec = RooflineRecorder(store)
    for i in range(5):
        rec.observe(f"engine.v{i}", "float", 1, wall_s=0.1, rows=10, nbytes=80)
        assert rec.flush()
    assert len(store.rooflines()) == 3 and st.d["evictions"] >= 2


def test_tiny_verbs_and_nonframes_are_skipped(tmp_path):
    rec = RooflineRecorder(TunedStore(str(tmp_path / "t.json")))
    rec.record("engine.take", MIN_VERB_WALL_S / 2, object())
    rec.record("engine.take", 1.0, object())
    rec.record("engine.take", 1.0, None)
    assert rec.pending_count() == 0


def test_conf_gate_and_engine_end_to_end(tmp_path, tracer):
    assert rooflines_enabled({}) is True
    set_verb_observer(None)
    e = PORT.engine({ROOFLINES: False})
    try:
        assert ttracer._VERB_OBSERVER is None
    finally:
        e.stop_engine()
        set_verb_observer(None)
    pdf = pd.DataFrame({"k": np.arange(50_000) % 64, "v": np.random.default_rng(0).random(50_000)})
    e = PORT.engine({PATH: str(tmp_path / "t.json")})
    try:
        e.distinct(e.to_df(pdf)).as_pandas()
        roof = e.tuner.roofline.snapshot()
        assert any(k.startswith("engine.distinct|") for k in roof), roof
        for entry in roof.values():
            assert entry["obs"] >= 1 and entry["best_bytes_s"] > 0
        rpt = e.report()
        assert "verb rooflines" in rpt and "engine.distinct" in rpt
    finally:
        e.stop_engine()
        set_verb_observer(None)


def test_observer_never_fires_with_tracing_disabled(tmp_path):
    get_tracer().disable()
    calls = []
    set_verb_observer(lambda name, wall, out: calls.append(name))
    try:
        e = PORT.engine({PATH: str(tmp_path / "t.json"), ROOFLINES: False})
        try:
            e.distinct(e.to_df(pd.DataFrame({"a": [1, 2, 3]}))).as_pandas()
        finally:
            e.stop_engine()
        assert calls == []
    finally:
        set_verb_observer(None)


def test_concurrent_observe_is_consistent(tmp_path):
    rec = RooflineRecorder(TunedStore(str(tmp_path / "t.json")))

    def work():
        for _ in range(200):
            rec.observe("engine.take", "int", 1, wall_s=0.01, rows=10, nbytes=80)

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    (entry,) = rec.snapshot().values()
    assert entry["obs"] == 800 and entry["rows"] == 8000


# ---- what the port adds --------------------------------------------------------------------


def test_store_default_path_and_its_precedence(tmp_path, monkeypatch):
    """No tuned default ships with the port: the default store is a
    git-ignored file beside the built kernels; the environment variable,
    then the conf key, name another."""
    assert default_tuned_path().endswith(os.path.join("fugue_tpu_torch", "build", "_tuned.json"))
    monkeypatch.delenv("FUGUE_TPU_TUNING_PATH", raising=False)
    assert resolve_tuned_path({}) == default_tuned_path()
    monkeypatch.setenv("FUGUE_TPU_TUNING_PATH", str(tmp_path / "env.json"))
    assert resolve_tuned_path({}) == str(tmp_path / "env.json")
    assert resolve_tuned_path({PATH: str(tmp_path / "conf.json")}) == str(tmp_path / "conf.json")


def test_store_shared_with_the_jax_package_keeps_plans_apart(tmp_path, _inject_wall):
    """One store file for both packages: the port's plan key is not the
    reference's for the same DAG, so neither reads what the other
    learned, and both entries stay in the file."""
    path = tmp_path / "_tuned.json"
    _, pdag = _run_agg(PORT, _engine(PORT, path))
    rdag = JFugueWorkflow()
    (rdag.df(_stream(REF)).partition_by("k")
     .aggregate(jcolumn.functions.sum(jcolumn.col("v")).alias("s"),
                jcolumn.functions.count(jcolumn.col("v")).alias("n"))
     .yield_dataframe_as("r", as_local=True))
    from fugue_tpu.plan import optimize_tasks as joptimize_tasks

    # the key the JAX engine's run would store under (its streamed steps
    # are not run here: they have aborted a loaded xdist worker)
    ref_fp = jtuning.plan_fingerprint(joptimize_tasks(rdag._tasks, {})[0])
    assert ref_fp is not None and pdag.last_plan_fingerprint != ref_fp
    plans = json.load(open(path))["tuning"]["plans"]
    assert pdag.last_plan_fingerprint in plans
    eng = _engine(PORT, path)
    _run_agg(PORT, eng)
    assert eng.stats()["tuning"]["adaptive"] >= 1  # its own entry, kept


def _lowered_stream(m, rows, chunk, seed=1):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1000, rows)
    v = rng.random(rows).astype("float32")
    w = rng.random(rows).astype("float32")

    def gen():
        for s in range(0, rows, chunk):
            yield m.Arrow(pa.table({"k": k[s:s + chunk], "v": v[s:s + chunk], "w": w[s:s + chunk]}))

    schema = m.Arrow(pa.table({"k": k[:1], "v": v[:1], "w": w[:1]})).schema
    return m.Stream(gen(), schema=schema), (k, v, w)


def test_tuned_stream_chunk_counts_follow_adjust_stream(tmp_path, _inject_wall):
    """chip_smoke's ``tuned-stream`` at small size: a streamed lowered
    aggregate (filter → select → aggregate, one segment) over 80 source
    chunks of 1,024 rows, run three times through ``FugueWorkflow.run``:
    the learned chunk size merges the source chunks, and the chunk counts
    are the ones ``adjust_stream`` gives (80 → 20 → 8), each run's result
    the tuning-off twin's and the JAX engine's (over the same rows,
    bounded)."""
    rows, chunk = 81_920, 1_024  # the learned sizes (4 and 10 chunks' rows) merge whole chunks
    counts, results = [], []
    key_range = {"fugue.tpu.stream.key_range": "0,999"}
    eng = _engine(PORT, tmp_path / "_tuned.json", **{CHUNK_ROWS: chunk, **key_range})
    twin = _engine(PORT, tmp_path / "_tuned.json", **{CHUNK_ROWS: chunk, TUNING: False, **key_range})

    def run(m, e, bounded=False):
        stream, (k, v, w) = _lowered_stream(m, rows, chunk)
        src = pd.DataFrame({"k": k, "v": v, "w": w}) if bounded else stream
        dag = m.Workflow()
        (dag.df(src).filter(m.col("v") > 0.25).select(m.col("k"), (m.col("v") * m.col("w")).alias("z"))
         .partition_by("k").aggregate(m.ff.sum(m.col("z")).alias("s")).yield_dataframe_as("r", as_local=True))
        dag.run(e)
        return dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True), dag

    expect = [-(-rows // chunk)]
    size = chunk
    for i in range(3):
        res, dag = run(PORT, eng)
        assert dag.last_plan_report.segments_lowered == 1
        counts.append(tstreaming.last_run_stats["chunks"])
        results.append(res)
        adj = adjust_stream(size, 2 if os.cpu_count() > 1 else 0,
                            {"chunks_prefetched": counts[-1], "wall_s": 1.0, "rows": rows}, 0)
        size = adj["chunk_rows"]
        expect.append(-(-rows // size))
    assert counts == expect[:3] == [80, 20, 8], (counts, expect)
    off, _ = run(PORT, twin)
    assert tstreaming.last_run_stats["chunks"] == 80
    # the JAX engine's streamed lowered segment has aborted a loaded xdist
    # worker in its donated step (jax/streaming.py); the same rows bounded
    ref, _ = run(REF, JaxExecutionEngine({CACHE: False, PATH: str(tmp_path / "r.json")}), bounded=True)
    for got in results:
        assert got["k"].tolist() == off["k"].tolist() == ref["k"].tolist()
        assert np.allclose(got["s"], off["s"], rtol=1e-5) and np.allclose(got["s"], ref["s"], rtol=1e-5)


def test_join_params_inside_a_scope(tmp_path):
    """``join_params`` (called by the torch engine's join ladder, which
    hands the handle to the spill join) fills only unknown estimates from
    what a run of the plan observed."""
    eng = _engine(PORT, tmp_path / "_tuned.json")
    assert eng.tuner.join_params(None, 10, None)[:3] == (None, 10, None)  # no scope: static
    with run_scope(eng, "planfp", eng.conf):
        l, r, rr, h = eng.tuner.join_params(None, 10, None)
        assert (l, r, rr) == (None, 10, None) and h.sid == "join"
        h.observe_sides(1000, 20, 50, 5)
    entry = eng.tuner.store.plan_entry("planfp")
    assert entry["joins"]["join"]["left_bytes"] == 1000
    with run_scope(eng, "planfp", eng.conf):
        l, r, rr, h = eng.tuner.join_params(None, 10, None)
        assert (l, r, rr) == (1000, 10, 5)
        assert h.bucket_count(16) == 16  # nothing learned: the static value
    d = [x for x in eng.stats()["tuning"]["last_decisions"] if x["target"] == "join"][-1]
    assert d["source"] == "adaptive" and "left_bytes~1000" in d["evidence"]
    assert plan_fingerprint([]) != jtuning.plan_fingerprint([])
