"""The port's resilience layer (``fugue_tpu_torch/resilience``) against the
JAX package's (``fugue_tpu/resilience``), on the CPU.

- ``RetryPolicy``: the same delays for the same seeds and settings, the
  same retry decisions, the same policy from a conf; ``classify_failure``
  puts the same exceptions in the same categories; the deadline;
- ``FaultInjector``: every site name, plan parsing, budgets (a run-wide
  budget is spent once), the named error types, the rejected plans, and a
  ``kill`` fired in the driver, which degrades to a raise (no test
  signals its own process);
- ``TestWorkflowResilience``'s four cases on the port's host and device
  engines beside the JAX package's host engine: an injected task failure
  retried, a poison task not retried, a checkpoint replay that runs the
  upstream task once, a torn checkpoint write that leaves no file;
- the ``stream.chunk`` site: an injected fault in a streamed aggregate's
  producer reaches the caller as the injected error, with the producer
  thread stopped, and a lowered workflow faulted at ``task.execute`` and
  retried gives the unfaulted run's answer.
"""

import hashlib
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import fugue_tpu
import fugue_tpu.resilience as jres
from fugue_tpu._utils.params import ParamDict as JParamDict
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.jax import JaxExecutionEngine
import fugue_tpu_torch.resilience as tres
from fugue_tpu_torch._utils.params import ParamDict
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

SITES = [n for n in dir(jres) if n.startswith("SITE_")]


# ---- policy ---------------------------------------------------------------------


def _exceptions(ns):
    return [
        ConnectionRefusedError(), ConnectionResetError(), BrokenPipeError(), ns.InjectedFaultError(),
        TimeoutError(), ns.ChunkTimeoutError(), ns.WorkerLostError(), ValueError("bad udf"),
        KeyError("k"), RuntimeError("x"), OSError("io"), KeyboardInterrupt(), SystemExit(),
        MemoryError(),
    ]


def test_classify_failure_matches_the_reference():
    port = [tres.classify_failure(ex).name for ex in _exceptions(tres)]
    ref = [jres.classify_failure(ex).name for ex in _exceptions(jres)]
    assert port == ref
    assert tres.classify_failure(tres.InjectedFaultError()) is tres.FailureCategory.TRANSIENT
    assert tres.classify_failure(ValueError()) is tres.FailureCategory.POISON
    assert tres.classify_failure(KeyboardInterrupt()) is tres.FailureCategory.FATAL


@pytest.mark.parametrize(
    "kw",
    [
        dict(max_attempts=3, base_delay=0.1, multiplier=2.0, jitter=0.5),
        dict(max_attempts=6, base_delay=0.05, multiplier=3.0, max_delay=0.5, jitter=0.25),
        dict(max_attempts=4, base_delay=0.2, multiplier=1.5, jitter=0.0),
    ],
)
def test_retry_delays_and_decisions_match(kw):
    p, r = tres.RetryPolicy(**kw), jres.RetryPolicy(**kw)
    for seed in ("x", "y", hashlib.sha1(b"task").hexdigest(), None):
        assert [p.delay(n, seed=seed) for n in range(1, 8)] == [r.delay(n, seed=seed) for n in range(1, 8)]
    for cat in tres.FailureCategory:
        for n in range(0, 8):
            assert p.should_retry(cat, n) == r.should_retry(jres.FailureCategory[cat.name], n)
    d1, d2 = p.delay(1, seed="x"), p.delay(2, seed="x")
    assert d2 > d1 and p.delay(2, seed="x") == d2
    if kw["jitter"]:
        assert p.delay(2, seed="y") != d2


def _fields(policy):
    """A policy's settings, its categories by name (each package has its
    own enum)."""
    return {k: sorted(c.name for c in v) if k == "retry_on" else v for k, v in vars(policy).items()}


def test_retry_policy_from_conf_matches():
    conf = {"fugue.tpu.retry.attempts": 5, "fugue.tpu.retry.jitter": 0, "fugue.tpu.retry.base": 0.3,
            "fugue.tpu.retry.task.attempts": 2, "fugue.tpu.retry.task.multiplier": 4.0}
    for prefix, default in (("fugue.tpu.retry", 3), ("fugue.tpu.retry.task", 1)):
        kw = dict(prefix=prefix, default_attempts=default)
        p = tres.RetryPolicy.from_conf(ParamDict(conf), **kw)
        r = jres.RetryPolicy.from_conf(JParamDict(conf), **kw)
        assert _fields(p) == _fields(r)
        assert [p.delay(n, seed="s") for n in (1, 2, 3)] == [r.delay(n, seed="s") for n in (1, 2, 3)]
    assert tres.RetryPolicy.from_conf(ParamDict(), prefix="fugue.tpu.retry.task", default_attempts=1).max_attempts == 1


def test_deadline():
    import time

    assert tres.Deadline.after(None).unbounded and tres.Deadline.after(0).unbounded
    assert not tres.Deadline.after(None).expired
    d = tres.Deadline.after(0.01)
    time.sleep(0.03)
    assert d.expired and d.remaining() == 0.0
    with pytest.raises(tres.ChunkTimeoutError):
        d.raise_if_expired("chunk")


# ---- fault injection ------------------------------------------------------------------


def test_every_site_is_the_reference_site():
    assert len(SITES) >= 13
    assert {s: getattr(tres, s) for s in SITES} == {s: getattr(jres, s) for s in SITES}
    assert set(SITES) <= set(tres.__all__)


def _outcomes(ns, plan, fires):
    """What each ``fire`` does: None, or the type name of what it raised."""
    inj = ns.FaultInjector(plan)
    out = []
    for site in fires:
        try:
            inj.fire(site)
            out.append(None)
        except Exception as ex:
            out.append(type(ex).__name__)
    return inj.enabled, out


@pytest.mark.parametrize(
    "plan, fires",
    [
        ("a.site=error:ValueError@2; b.site=delay:0", ["a.site", "a.site", "a.site", "b.site", "x"]),
        ("task.execute=error@2", ["task.execute"] * 3),
        ("stream.chunk=error:RuntimeError;stream.chunk=error:OSError", ["stream.chunk"] * 3),
        ("checkpoint.save=error:TimeoutError", ["checkpoint.save", "checkpoint.save"]),
        ("map.chunk=kill", ["map.chunk", "map.chunk"]),
        ("rpc.request=error:ConnectionError@1; dist.board=error", ["rpc.request", "dist.board", "rpc.request"]),
        (" ;serve.journal = error:ConnectionRefusedError ; ", ["serve.journal"]),
    ],
)
def test_plans_parse_and_fire_as_the_reference(plan, fires):
    assert _outcomes(tres, plan, fires) == _outcomes(jres, plan, fires)


def test_kill_in_driver_degrades_to_raise():
    inj = tres.FaultInjector("x=kill")
    with pytest.raises(tres.InjectedFaultError, match="degraded to raise"):
        inj.fire("x")


@pytest.mark.parametrize("plan", ["site=explode", "just-garbage", "=error", "a=", "a=error@x", "a=error:NoSuchError"])
def test_bad_plans_rejected_as_the_reference(plan):
    def outcome(ns):
        try:
            ns.FaultInjector(plan).fire("a")
            return None
        except Exception as ex:
            return type(ex).__name__

    assert outcome(tres) == outcome(jres) is not None


def test_disabled_without_plan(monkeypatch):
    assert tres.FaultInjector.from_conf(ParamDict()) is tres.NULL_INJECTOR
    assert not tres.NULL_INJECTOR.enabled
    monkeypatch.setenv("FUGUE_TPU_FAULT_PLAN", "task.execute=error")
    inj = tres.FaultInjector.from_conf(ParamDict())
    assert inj.enabled and inj.plan == "task.execute=error"


def test_resilience_stats_match():
    p, r = tres.ResilienceStats(), jres.ResilienceStats()
    for s in (p, r):
        s.inc("workflow.task_retries")
        s.inc("workflow.checkpoint_replays", 3)
    assert p.as_dict() == r.as_dict()
    assert p.get("workflow.checkpoint_replays") == 3 and p.get("nothing") == 0
    p.reset()
    assert p.as_dict() == {}


# ---- the workflow: TestWorkflowResilience's cases ------------------------------------


ENGINES = ["ref", "native", "torch"]


def _engine(kind, conf):
    if kind == "ref":
        return JNativeExecutionEngine(conf)
    if kind == "native":
        return NativeExecutionEngine(conf)
    return TorchExecutionEngine(device="cpu", conf=conf)


def _wf(kind):
    return fugue_tpu.FugueWorkflow if kind == "ref" else FugueWorkflow


@pytest.mark.parametrize("kind", ENGINES)
def test_injected_task_failure_retried(kind):
    def make() -> pd.DataFrame:
        return pd.DataFrame({"a": [1, 2]})

    e = _engine(kind, {"fugue.tpu.fault.plan": "task.execute=error", "fugue.tpu.retry.task.attempts": 2,
                       "fugue.tpu.retry.task.base": 0.01})
    dag = _wf(kind)()
    dag.create(make).yield_dataframe_as("out", as_local=True)
    res = dag.run(e)
    assert res["out"].result.as_array() == [[1], [2]]
    assert e.resilience_stats.get("workflow.task_retries") == 1
    assert e.stats()["resilience"] == {"workflow.task_retries": 1}


@pytest.mark.parametrize("kind", ENGINES)
def test_injected_task_failure_without_retry_raises(kind):
    e = _engine(kind, {"fugue.tpu.fault.plan": "task.execute=error"})
    dag = _wf(kind)()
    dag.df(pd.DataFrame({"a": [1]})).yield_dataframe_as("out", as_local=True)
    with pytest.raises(Exception, match="injected fault at task.execute"):
        dag.run(e)
    assert e.resilience_stats.get("workflow.task_retries") == 0


@pytest.mark.parametrize("kind", ENGINES)
def test_poison_task_not_retried(kind):
    calls = []

    def bad() -> pd.DataFrame:
        calls.append(1)
        raise ValueError("deterministic user bug")

    e = _engine(kind, {"fugue.tpu.retry.task.attempts": 3, "fugue.tpu.retry.task.base": 0.01})
    dag = _wf(kind)()
    dag.create(bad).yield_dataframe_as("out", as_local=True)
    with pytest.raises(Exception):
        dag.run(e)
    assert len(calls) == 1


@pytest.mark.parametrize("kind", ENGINES)
def test_checkpoint_aware_replay_runs_upstream_once(kind, tmp_path):
    calls = []
    fail = [True]

    def upstream() -> pd.DataFrame:
        calls.append(1)
        return pd.DataFrame({"a": [1, 2, 3]})

    def downstream(df: pd.DataFrame) -> pd.DataFrame:
        if fail[0]:
            raise RuntimeError("transient downstream failure")
        return df.assign(b=df["a"] * 2)

    def build():
        dag = _wf(kind)()
        a = dag.create(upstream).deterministic_checkpoint()
        a.transform(downstream, schema="a:long,b:long").yield_dataframe_as("out", as_local=True)
        return dag

    e = _engine(kind, {"fugue.workflow.checkpoint.path": str(tmp_path)})
    with pytest.raises(Exception):
        build().run(e)
    assert len(calls) == 1
    fail[0] = False
    res = build().run(e)
    assert len(calls) == 1
    assert res["out"].result.as_array() == [[1, 2], [2, 4], [3, 6]]
    assert e.resilience_stats.get("workflow.checkpoint_replays") == 1


@pytest.mark.parametrize("kind", ENGINES)
def test_interrupted_checkpoint_write_leaves_no_torn_file(kind, tmp_path):
    calls = []

    def upstream() -> pd.DataFrame:
        calls.append(1)
        return pd.DataFrame({"a": [7]})

    def build():
        dag = _wf(kind)()
        dag.create(upstream).deterministic_checkpoint().yield_dataframe_as("out", as_local=True)
        return dag

    conf = {"fugue.workflow.checkpoint.path": str(tmp_path)}
    with pytest.raises(Exception, match="injected fault at checkpoint.save"):
        build().run(_engine(kind, {**conf, "fugue.tpu.fault.plan": "checkpoint.save=error"}))
    assert list(tmp_path.rglob("*.parquet")) == []
    res = build().run(_engine(kind, conf))
    assert len(calls) == 2
    assert res["out"].result.as_array() == [[7]]
    assert len(list(tmp_path.rglob("*.parquet"))) == 1


def test_retried_task_spans_record_attempts():
    from fugue_tpu_torch.obs import get_span_metrics, get_tracer

    tr = get_tracer()
    tr.clear()
    tr.enable()
    try:
        e = TorchExecutionEngine(device="cpu", conf={
            "fugue.tpu.fault.plan": "task.execute=error@2", "fugue.tpu.retry.task.attempts": 3,
            "fugue.tpu.retry.task.base": 0.001})
        dag = FugueWorkflow()
        dag.df(pd.DataFrame({"a": [1]})).yield_dataframe_as("out", as_local=True)
        dag.run(e)
        (task,) = [r for r in tr.records() if r["name"] == "workflow.task"]
        assert task["args"]["attempts"] == 3 and "error" not in task["args"]
        assert e.resilience_stats.get("workflow.task_retries") == 2
    finally:
        tr.disable()
        tr.clear()
        get_span_metrics().clear()


# ---- the streamed chunk site ---------------------------------------------------------


def _f32_frame(n, groups, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, groups, n), "v": rng.random(n, dtype=np.float32)})


def _stream(pdf, step):
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)
    return LocalDataFrameIterableDataFrame(
        (ArrowDataFrame(tbl.slice(s, min(step, tbl.num_rows - s))) for s in range(0, tbl.num_rows, step)),
        schema=ArrowDataFrame(tbl).schema,
    )


def _lowered(dag_cls, src, conf=None):
    dag = dag_cls(conf)
    (
        dag.df(src)
        .filter(col("v") > 0.25)
        .select(col("k"), (col("v") * 2.0).alias("z"))
        .partition_by("k")
        .aggregate(ff.sum(col("z")).alias("s"), ff.count(col("z")).alias("n"))
        .yield_dataframe_as("r", as_local=True)
    )
    return dag


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name.startswith("fugue-torch-prefetch") and t.is_alive()]


@pytest.mark.parametrize("lowered", [False, True], ids=["engine", "lowered"])
def test_stream_chunk_fault_reaches_the_caller(lowered):
    """``stream.chunk=error`` fires on the producer's thread: the caller
    gets the injected error, and no producer thread is left. The JAX
    engine raises the same for the same plan."""
    pdf = _f32_frame(20_000, 16)
    conf = {"fugue.tpu.stream.chunk_rows": 4000, "fugue.tpu.stream.prefetch_depth": 2,
            "fugue.tpu.fault.plan": "stream.chunk=error@1"}
    e = TorchExecutionEngine(device="cpu", conf=conf)
    with pytest.raises(tres.InjectedFaultError, match="injected fault at stream.chunk"):
        if lowered:
            _lowered(FugueWorkflow, _stream(pdf, 4000)).run(e)
        else:
            e.aggregate(_stream(pdf, 4000), PartitionSpec(by=["k"]), [ff.sum(col("v")).alias("s")])
    assert _prefetch_threads() == []
    j = JaxExecutionEngine({**conf, "fugue.tpu.cache.enabled": False})
    try:
        from fugue_tpu.column import col as jcol, functions as jff
        from fugue_tpu.dataframe import ArrowDataFrame as JA, LocalDataFrameIterableDataFrame as JI

        tbl = pa.Table.from_pandas(pdf, preserve_index=False)
        src = JI((JA(tbl.slice(s, 4000)) for s in range(0, len(pdf), 4000)), schema=JA(tbl).schema)
        dag = fugue_tpu.FugueWorkflow()
        dag.df(src).partition_by("k").aggregate(jff.sum(jcol("v")).alias("s")).yield_dataframe_as("r", as_local=True)
        with pytest.raises(jres.InjectedFaultError, match="injected fault at stream.chunk"):
            dag.run(j)
    finally:
        j.stop()


def test_fault_retry_gives_the_unfaulted_answer():
    """chip_smoke's fault-retry cell at a small size: a lowered workflow
    faulted once at ``task.execute`` and retried equals the plain run
    (keys and counts exact, float32 sums within 1e-4), with one retry."""
    pdf = _f32_frame(30_000, 50, seed=3)
    plain = _lowered(FugueWorkflow, pdf)
    plain.run(TorchExecutionEngine(device="cpu"))
    conf = {"fugue.tpu.fault.plan": "task.execute=error", "fugue.tpu.retry.task.attempts": 2,
            "fugue.tpu.retry.task.base": 0.001}
    e = TorchExecutionEngine(device="cpu")
    dag = _lowered(FugueWorkflow, pdf, conf)
    dag.run(e)
    a = plain.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True)
    b = dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True)
    assert a["k"].tolist() == b["k"].tolist() and a["n"].tolist() == b["n"].tolist()
    np.testing.assert_allclose(b["s"].to_numpy(), a["s"].to_numpy(), rtol=1e-4)
    assert e.stats()["resilience"] == {"workflow.task_retries": 1}
    assert e.plan_stats.as_dict()["segments_executed"] == 1


def test_stream_chunk_fault_frees_the_pipeline_without_a_collection(monkeypatch):
    """The failed stream's prefetcher, its staged chunks and its source are
    freed once the caller has handled the error, with the cyclic collector
    off: no reference cycle holds them (on the card, their device memory)
    until a collection."""
    import gc
    import weakref

    from fugue_tpu_torch.torch import pipeline

    made = []
    init = pipeline.ChunkPrefetcher.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        made.append(weakref.ref(self))

    monkeypatch.setattr(pipeline.ChunkPrefetcher, "__init__", record)
    pdf = _f32_frame(20_000, 16)
    e = TorchExecutionEngine(device="cpu", conf={
        "fugue.tpu.stream.chunk_rows": 4000, "fugue.tpu.stream.prefetch_depth": 2,
        "fugue.tpu.fault.plan": "stream.chunk=error@1"})
    gc.collect()
    gc.disable()
    try:
        try:
            e.aggregate(_stream(pdf, 4000), PartitionSpec(by=["k"]), [ff.sum(col("v")).alias("s")])
        except tres.InjectedFaultError:
            pass
        assert len(made) == 1 and made[0]() is None
    finally:
        gc.enable()
