"""The port's plan optimizer (``fugue_tpu_torch/plan``, run by
``FugueWorkflow.run``) against the JAX package's.

Each case of ``tests/plan/test_optimizer.py`` builds the same DAG through
both packages' workflow classes, on the same seeded numpy frames, with the
optimizer on: ``JaxExecutionEngine`` (the 8-device CPU mesh, result cache
off) against ``TorchExecutionEngine(device="cpu")``, and the two native
engines for the host cases. Then:

- the results are equal: keys, counts and row sets exact, floats within
  ``rtol=1e-5``/``atol=1e-9`` (``np.allclose``; float32 sums in other
  orders);
- the reports count the same pushdowns, pruned columns, fused verbs and
  lowered segments, a UDF transformer in the chain too (both packages
  analyze it, ``tests/test_torch_analysis.py``);
- on the port, each pass's gate toggled off gives the same result;
- the removed-intermediate error, the result aliases, the pinned-task
  rule, pruning into the parquet reader and the chunk producer, and
  ``explain()``'s segment lines, as the reference's cases pin them.
"""

import types
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import fugue_tpu.column as jcolumn
from fugue_tpu import FugueWorkflow as JFugueWorkflow
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
from fugue_tpu.exceptions import FugueWorkflowError as JFugueWorkflowError
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.jax import JaxExecutionEngine

import fugue_tpu_torch.column as tcolumn
import fugue_tpu_torch.torch.dataframe as tdataframe
import fugue_tpu_torch.torch.streaming as tstreaming
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
from fugue_tpu_torch.exceptions import FugueWorkflowError
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.plan import optimize_tasks
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

OPT = "fugue.tpu.plan.optimize"
GATES = ["fugue.tpu.plan.pushdown", "fugue.tpu.plan.prune", "fugue.tpu.plan.fuse",
         "fugue.tpu.plan.lower_segments"]
COUNTS = ["cols_pruned", "filters_pushed", "verbs_fused", "segments_lowered", "verbs_absorbed"]
REF_CONF = {"fugue.tpu.cache.enabled": False}
RTOL, ATOL = 1e-5, 1e-9


def _frame(n=4000, cols=8, groups=16, seed=0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame(
        {
            "k": rng.integers(0, groups, n),
            "v": rng.random(n),
            "w": rng.random(n),
            "s": rng.choice(["a", "b", "c", None], n),
            **{f"x{i}": rng.random(n) for i in range(cols)},
        }
    )


# the names a build function uses, from one package or the other
REF = types.SimpleNamespace(
    col=jcolumn.col, lit=jcolumn.lit, ff=jcolumn.functions, Workflow=JFugueWorkflow,
    Stream=JStream, Arrow=JArrowDataFrame,
)
PORT = types.SimpleNamespace(
    col=tcolumn.col, lit=tcolumn.lit, ff=tcolumn.functions, Workflow=FugueWorkflow,
    Stream=LocalDataFrameIterableDataFrame, Arrow=ArrowDataFrame,
)


def _stream(m: Any, pdf: pd.DataFrame, step: int = 512) -> Any:
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)
    return m.Stream(
        (m.Arrow(tbl.slice(s, min(step, tbl.num_rows - s))) for s in range(0, tbl.num_rows, step)),
        schema=m.Arrow(tbl).schema,
    )


def _engine(m: Any, kind: str, conf: Optional[dict] = None) -> Any:
    conf = dict(conf or {})
    if m is REF:
        conf.update(REF_CONF)
        return JaxExecutionEngine(conf) if kind == "device" else JNativeExecutionEngine(conf)
    return TorchExecutionEngine(device="cpu", conf=conf) if kind == "device" else NativeExecutionEngine(conf)


def _stats(eng: Any) -> Dict[str, int]:
    return dict(eng.stats()["plan"]) if hasattr(eng, "stats") else eng.plan_stats.as_dict()


def run_case(
    build: Callable[[Any, Any], None], m: Any, kind: str = "device", conf: Optional[dict] = None
) -> Any:
    """Run ``build`` on a fresh workflow and engine of package ``m``:
    ``(result pandas, report, plan stats, workflow)``."""
    eng = _engine(m, kind, conf)
    dag = m.Workflow()
    build(dag, m)
    dag.run(eng)
    return dag.yields["r"].result.as_pandas(), dag.last_plan_report, _stats(eng), dag


def same_frames(got: pd.DataFrame, exp: pd.DataFrame, sort: Optional[List[str]] = None) -> None:
    """Equal columns and rows; floats within RTOL/ATOL (NaN equal to NaN),
    everything else exact. ``sort`` orders both first (None: as given)."""
    assert list(got.columns) == list(exp.columns)
    assert len(got) == len(exp)
    if sort:
        got = got.sort_values(sort).reset_index(drop=True)
        exp = exp.sort_values(sort).reset_index(drop=True)
    for c in got.columns:
        g, e = got[c], exp[c]
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            assert np.allclose(g.to_numpy(np.float64), e.to_numpy(np.float64), rtol=RTOL, atol=ATOL,
                               equal_nan=True), c
        else:
            assert g.astype(object).where(g.notna(), None).tolist() == \
                e.astype(object).where(e.notna(), None).tolist(), c


# ---- the parity cases of tests/plan/test_optimizer.py -------------------------


def _aggregate_wide(dag, m, pdf):
    (dag.df(pdf).partition_by("k")
     .aggregate(m.ff.sum(m.col("v")).alias("sv"), m.ff.count(m.col("v")).alias("n"))
     .yield_dataframe_as("r", as_local=True))


def _filter_select_chain(dag, m, pdf):
    (dag.df(pdf).rename({"v": "val"}).filter(m.col("val") > 0.25)
     .select(m.col("k"), m.col("val"), (m.col("val") * 2).alias("v2"))
     .yield_dataframe_as("r", as_local=True))


def _assign_drop_string_filter(dag, m, pdf):
    (dag.df(pdf).assign(v3=m.col("v") * 3).drop(["x0", "x1"]).filter(m.col("s") == "a")
     .yield_dataframe_as("r", as_local=True))


def _join_pushdown(dag, m, pdf):
    dim = pd.DataFrame({"k": np.arange(16), "label": np.arange(16) * 1.0})
    j = dag.df(pdf).inner_join(dag.df(dim), on=["k"]).filter(m.col("v") > 0.8)
    j.partition_by("k").aggregate(m.ff.count(m.col("v")).alias("n")).yield_dataframe_as("r", as_local=True)


def _sql_workflow(dag, m, pdf):
    a = dag.df(pdf)
    dag.select("SELECT k, SUM(v) AS sv FROM ", a, " WHERE v > 0.2 GROUP BY k").yield_dataframe_as(
        "r", as_local=True)


def _streaming_filter_aggregate(dag, m, pdf):
    (dag.df(_stream(m, pdf)).filter(m.col("v") > 0.5).partition_by("k")
     .aggregate(m.ff.sum(m.col("v")).alias("sv"), m.ff.count(m.col("v")).alias("n"))
     .yield_dataframe_as("r", as_local=True))


def _fused_sequential(dag, m, pdf):
    (dag.df(pdf).filter(m.col("s").is_null() | (m.col("v") > 0.1))
     .select(m.col("k"), m.col("s"), m.col("v")).yield_dataframe_as("r", as_local=True))


def _filter_aggregate(dag, m, pdf):
    (dag.df(pdf).filter(m.col("v") > 0.5).partition_by("k")
     .aggregate(m.ff.sum(m.col("v")).alias("sv")).yield_dataframe_as("r", as_local=True))


def _rename_pushdown(dag, m, pdf):
    (dag.df(pdf).rename({"v": "val"}).filter(m.col("val") > 0.5).partition_by("k")
     .aggregate(m.ff.sum(m.col("val")).alias("sv")).yield_dataframe_as("r", as_local=True))


def _fillna_refused(dag, m, pdf):
    dag.df(pdf).fillna(0.0, subset=["v"]).filter(m.col("v") > 0.5).yield_dataframe_as("r", as_local=True)


def _count_lit(dag, m, pdf):
    dag.df(pdf).aggregate(m.ff.count(m.lit(1)).alias("n")).yield_dataframe_as("r", as_local=True)


def _dropna_filter(dag, m, pdf):
    dag.df(pdf).dropna().filter(m.col("x0") > 0.3).yield_dataframe_as("r", as_local=True)


PARITY = {
    "aggregate_wide": (_aggregate_wide, dict(), ["k"]),
    "filter_select_chain": (_filter_select_chain, dict(), None),
    "assign_drop_string_filter": (_assign_drop_string_filter, dict(), None),
    "join_pushdown": (_join_pushdown, dict(), ["k"]),
    "sql_workflow": (_sql_workflow, dict(cols=2), ["k"]),
    "streaming_filter_aggregate": (_streaming_filter_aggregate, dict(cols=4), ["k"]),
    "fused_sequential_fallback": (_fused_sequential, dict(cols=2), None),
    "filter_aggregate": (_filter_aggregate, dict(cols=5), ["k"]),
    "pushdown_rename": (_rename_pushdown, dict(cols=2), ["k"]),
    "pushdown_refused_fillna": (_fillna_refused, dict(cols=2), None),
    "count_lit_keeps_one_column": (_count_lit, dict(cols=3), None),
    "dropna_then_filter": (_dropna_filter, dict(cols=2), None),
}


@pytest.mark.parametrize("kind", ["device", "native"])
@pytest.mark.parametrize("case", list(PARITY))
def test_parity_with_the_reference(case, kind):
    """The same result and the same pass counts as the reference."""
    build, size, sort = PARITY[case]
    pdf = _frame(**size)

    def b(dag, m):
        build(dag, m, pdf)

    got, rep, _, _ = run_case(b, PORT, kind)
    exp, jrep, _, _ = run_case(b, REF, kind)
    same_frames(got, exp, sort)
    assert {c: getattr(rep, c) for c in COUNTS} == {c: getattr(jrep, c) for c in COUNTS}


@pytest.mark.parametrize("gate", GATES + [OPT])
@pytest.mark.parametrize("case", ["filter_select_chain", "join_pushdown", "streaming_filter_aggregate",
                                  "pushdown_rename", "filter_aggregate"])
def test_each_gate_off_gives_the_same_result(case, gate):
    build, size, sort = PARITY[case]
    pdf = _frame(**size)

    def b(dag, m):
        build(dag, m, pdf)

    on, _, _, _ = run_case(b, PORT)
    off, rep, _, _ = run_case(b, PORT, conf={gate: False})
    same_frames(off, on, sort)
    counter = {"fugue.tpu.plan.pushdown": "filters_pushed", "fugue.tpu.plan.prune": "cols_pruned",
               "fugue.tpu.plan.fuse": "verbs_fused", "fugue.tpu.plan.lower_segments": "segments_lowered"}
    if gate == OPT:
        assert not rep.enabled
    else:
        assert getattr(rep, counter[gate]) == 0


def test_transform_udf_results_match():
    """A pandas transformer in the chain: both packages' analyzers
    translate it into plain verbs, which fuse with the filter after it;
    the results and the reports' counts agree. (Named for when the port
    kept the transformer whole.)"""
    pdf = _frame(cols=4)

    def add_one(df: pd.DataFrame) -> pd.DataFrame:
        df = df.copy()
        df["v"] = df["v"] + 1.0
        return df[["k", "v"]]

    def b(dag, m):
        (dag.df(pdf).transform(add_one, schema="k:long,v:double").filter(m.col("v") > 1.5)
         .yield_dataframe_as("r", as_local=True))

    got, rep, _, _ = run_case(b, PORT)
    exp, jrep, _, _ = run_case(b, REF)
    same_frames(got, exp, ["k", "v"])
    counts = COUNTS + ["udfs_analyzed", "udfs_translated"]
    assert {c: getattr(rep, c) for c in counts} == {c: getattr(jrep, c) for c in counts}
    assert rep.udfs_translated == 1 and rep.verbs_fused > 0


def test_noop_guard_udf_keeps_all_columns():
    """An identity transformer that declares every column: the analyzer
    translates it into a cast of each, so every column is read and
    nothing is pruned."""
    pdf = _frame(cols=6)

    def ident(df: pd.DataFrame) -> pd.DataFrame:
        return df

    eng = TorchExecutionEngine(device="cpu")
    dag = FugueWorkflow()
    src = dag.df(pdf)
    schema = ",".join(f"{n}:{'str' if n == 's' else ('long' if n == 'k' else 'double')}" for n in pdf.columns)
    src.transform(ident, schema=schema).yield_dataframe_as("r", as_local=True)
    dag.run(eng)
    assert set(src.result.schema.names) == set(pdf.columns)
    assert dag.last_plan_report.cols_pruned == 0


# ---- pruning reaches the producer ----------------------------------------------


def test_pruning_reaches_bounded_ingest(monkeypatch):
    """No table the device ingests carries the unread columns, and the
    pruned source's handle is the narrow frame."""
    pdf = _frame(cols=20)
    seen = []
    orig = tdataframe.encode_arrow_for_device

    def spy(tbl):
        seen.append(list(tbl.column_names))
        return orig(tbl)

    monkeypatch.setattr(tdataframe, "encode_arrow_for_device", spy)
    dag = FugueWorkflow()
    src = dag.df(pdf)
    src.partition_by("k").aggregate(tcolumn.functions.sum(tcolumn.col("v")).alias("sv")).yield_dataframe_as(
        "r", as_local=True)
    dag.run(TorchExecutionEngine(device="cpu"))
    assert len(dag.yields["r"].result.as_pandas()) == 16
    assert seen and all(set(cols) <= {"k", "v", "sv"} for cols in seen), seen
    assert set(src.result.schema.names) == {"k", "v"}


def test_pruning_reaches_chunk_producer(monkeypatch):
    pdf = _frame(cols=12)
    seen = []
    orig = tstreaming._chunk_columns

    def spy(f, names):
        seen.append(list(f.schema.names))
        return orig(f, names)

    monkeypatch.setattr(tstreaming, "_chunk_columns", spy)
    dag = FugueWorkflow()
    (dag.df(_stream(PORT, pdf)).partition_by("k").aggregate(tcolumn.functions.sum(tcolumn.col("v")).alias("sv"))
     .yield_dataframe_as("r", as_local=True))
    dag.run(TorchExecutionEngine(device="cpu"))
    assert len(dag.yields["r"].result.as_pandas()) == 16
    assert seen and all(set(cols) <= {"k", "v"} for cols in seen), seen


def test_load_pruning_pushes_columns_into_reader(tmp_path):
    """A parquet load with no columns gets the demanded ones, as on the
    reference; explicit columns are not pruned again."""
    pdf = _frame(n=1000, cols=10)
    path = str(tmp_path / "wide.parquet")
    pq.write_table(pa.Table.from_pandas(pdf, preserve_index=False), path)

    def b(dag, m):
        dag.load(path).partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("sv")).yield_dataframe_as(
            "r", as_local=True)

    for kind in ("device", "native"):
        got, rep, _, _ = run_case(b, PORT, kind)
        exp, jrep, _, _ = run_case(b, REF, kind)
        same_frames(got, exp, ["k"])
        assert rep.cols_pruned == jrep.cols_pruned >= 10
        assert rep.bytes_skipped == jrep.bytes_skipped > 0
        assert any("pruned" in s for s in rep.after)
    dag = FugueWorkflow()
    (dag.load(path, columns=["k", "v", "w"]).partition_by("k")
     .aggregate(tcolumn.functions.sum(tcolumn.col("v")).alias("sv")).yield_dataframe_as("r", as_local=True))
    dag.run("native")
    assert all("load" not in n or "pruned" not in n for n in dag.last_plan_report.after)


def test_pruning_reaches_stream_parquet(tmp_path, monkeypatch):
    """A stream of a parquet file read by ``stream_parquet``: the chunks
    the lowered aggregate decodes hold only the demanded columns."""
    pdf = _frame(n=3000, cols=6)
    path = str(tmp_path / "wide.parquet")
    pq.write_table(pa.Table.from_pandas(pdf, preserve_index=False), path)
    seen = []
    orig = tstreaming._chunk_columns

    def spy(f, names):
        seen.append(list(f.schema.names))
        return orig(f, names)

    monkeypatch.setattr(tstreaming, "_chunk_columns", spy)
    dag = FugueWorkflow()
    (dag.df(tstreaming.stream_parquet(path, chunk_rows=1000)).filter(tcolumn.col("v") > 0.5)
     .partition_by("k").aggregate(tcolumn.functions.sum(tcolumn.col("w")).alias("sw"))
     .yield_dataframe_as("r", as_local=True))
    dag.run(TorchExecutionEngine(device="cpu"))
    got = dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True)
    exp = pdf[pdf.v > 0.5].groupby("k", as_index=False).agg(sw=("w", "sum"))
    assert got["k"].tolist() == exp["k"].tolist()
    assert np.allclose(got["sw"], exp["sw"], rtol=RTOL)
    assert seen and all(set(cols) <= {"k", "v", "w"} for cols in seen), seen


# ---- fusion on the device -------------------------------------------------------


def test_fusion_runs_one_device_step():
    """The fused chain runs under ``engine.fused``, with no per-verb
    device step (``fugue::filter``, ``fugue::project``)."""
    pdf = _frame(cols=2)
    dag = FugueWorkflow()
    (dag.df(pdf).filter(tcolumn.col("v") > 0.25).select(tcolumn.col("k"), (tcolumn.col("v") * 2).alias("v2"))
     .yield_dataframe_as("r", as_local=True))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        dag.run(TorchExecutionEngine(device="cpu"))
    names = {e.key for e in prof.key_averages()}
    assert {"fugue::plan_optimize", "engine.fused"} <= names
    assert "fugue::filter" not in names and "fugue::project" not in names
    assert dag.last_plan_report.verbs_fused >= 2 and dag.last_plan_report.cols_pruned >= 1
    out = dag.yields["r"].result.as_pandas()
    exp = pdf[pdf.v > 0.25]
    assert out["k"].tolist() == exp["k"].tolist() and np.allclose(out["v2"], exp["v"] * 2)


# ---- explain, gates, aliases ----------------------------------------------------


def test_explain_report():
    pdf = _frame(cols=5)
    for m in (PORT, REF):
        dag = m.Workflow()
        _filter_aggregate(dag, m, pdf)
        text = dag.explain()
        assert "== logical plan ==" in text and "== optimized plan" in text and "pruned" in text
        assert "lowered segment" in text and "segments_lowered=1" in text
        assert "optimizer disabled" in dag.explain(conf={OPT: False})
    # the port's segment line is the reference's: fingerprint, steps,
    # terminal and the delta-cache annotation
    lines = [[s for s in _built(m, pdf).explain().splitlines() if "lowered segment" in s]
             for m in (PORT, REF)]
    assert lines[0] == lines[1] and len(lines[0]) == 1


def _built(m: Any, pdf: pd.DataFrame) -> Any:
    dag = m.Workflow()
    _filter_select_aggregate(dag, m, pdf)
    return dag


def _filter_select_aggregate(dag, m, pdf):
    (dag.df(pdf).filter(m.col("v") > 0.25).select(m.col("k"), (m.col("v") * m.col("w")).alias("z"))
     .partition_by("k").aggregate(m.ff.sum(m.col("z")).alias("s")).yield_dataframe_as("r", as_local=True))


def test_engine_plan_metrics():
    pdf = _frame(cols=5)
    eng = TorchExecutionEngine(device="cpu")
    dag = FugueWorkflow()
    _aggregate_wide(dag, PORT, pdf)
    dag.run(eng)
    st = eng.plan_stats.as_dict()
    assert st["runs"] == 1 and st["cols_pruned"] >= 5 and st["bytes_skipped"] > 0
    eng.plan_stats.reset()
    assert eng.plan_stats.as_dict()["runs"] == 0


def test_result_alias_final_and_source():
    pdf = _frame(cols=4)
    dag = FugueWorkflow()
    src = dag.df(pdf)
    final = src.filter(tcolumn.col("v") > 0.5).select(tcolumn.col("k"), tcolumn.col("v"))
    final.yield_dataframe_as("r", as_local=True)
    dag.run(TorchExecutionEngine(device="cpu"))
    assert list(final.result.as_pandas().columns) == ["k", "v"]
    assert set(src.result.schema.names) == {"k", "v"}


def test_pinned_tasks_disable_rewrites():
    """A persisted (checkpointed) task is neither rewritten nor fused away."""
    pdf = _frame(cols=4)
    dag = FugueWorkflow()
    src = dag.df(pdf)
    mid = src.filter(tcolumn.col("v") > 0.5).persist()
    mid.select(tcolumn.col("k"), tcolumn.col("v")).yield_dataframe_as("r", as_local=True)
    dag.run(TorchExecutionEngine(device="cpu"))
    assert dag.last_plan_report.verbs_fused == 0
    assert set(mid.result.schema.names) == set(pdf.columns)


def test_pushdown_rewritten_filter_result_is_correct():
    """A filter pushed below its producer: its handle is the new chain
    tail (the same frame as unoptimized), the producer's own intermediate
    raises the reference's error."""
    pdf = pd.DataFrame({"a": [1.0, None, 3.0, 4.0], "b": [1, 2, 3, 4]})
    ref = FugueWorkflow()
    ref_h = ref.df(pdf).dropna().filter(tcolumn.col("b") > 1)
    ref.run("native", {OPT: False})
    expected = ref_h.result.as_pandas().reset_index(drop=True)
    for eng in ("native", TorchExecutionEngine(device="cpu")):
        dag = FugueWorkflow()
        mid = dag.df(pdf).dropna()
        out = mid.filter(tcolumn.col("b") > 1)
        dag.run(eng)
        assert dag.last_plan_report.filters_pushed == 1
        pd.testing.assert_frame_equal(expected, out.result.as_pandas().reset_index(drop=True))
        with pytest.raises(FugueWorkflowError, match="optimized away"):
            mid.result
    jdag = JFugueWorkflow()
    jmid = jdag.df(pdf).dropna()
    jmid.filter(jcolumn.col("b") > 1)
    jdag.run("native")
    with pytest.raises(JFugueWorkflowError, match="optimized away"):
        jmid.result


def test_fused_interior_result_raises_descriptive():
    pdf = _frame(cols=2)
    dag = FugueWorkflow()
    mid = dag.df(pdf).filter(tcolumn.col("v") > 0.5)
    tail = mid.select(tcolumn.col("k"), tcolumn.col("v"))
    tail.yield_dataframe_as("r", as_local=True)
    dag.run(TorchExecutionEngine(device="cpu"))
    assert dag.last_plan_report.verbs_fused >= 2
    assert (tail.result.as_pandas()["v"] > 0.5).all()
    with pytest.raises(FugueWorkflowError, match="optimized away"):
        mid.result


def test_compile_conf_gates_run_without_engine_leak():
    pdf = _frame(cols=2)
    eng = NativeExecutionEngine()
    dag = FugueWorkflow(compile_conf={OPT: False})
    dag.df(pdf).filter(tcolumn.col("v") > 0.5).select(tcolumn.col("k"), tcolumn.col("v")).yield_dataframe_as(
        "r", as_local=True)
    dag.run(eng)
    assert not dag.last_plan_report.enabled
    assert "optimizer disabled" in dag.explain()
    assert OPT not in eng.conf
    dag2 = FugueWorkflow()
    dag2.df(pdf).filter(tcolumn.col("v") > 0.5).select(tcolumn.col("k"), tcolumn.col("v")).yield_dataframe_as(
        "r", as_local=True)
    dag2.run(eng)
    assert dag2.last_plan_report.enabled


def test_optimizer_off_round_trips_the_compiled_tasks():
    pdf = _frame(cols=2)
    dag = FugueWorkflow()
    _filter_aggregate(dag, PORT, pdf)
    tasks, aliases, removed, report = optimize_tasks(dag._tasks, {OPT: False})
    assert tasks is dag._tasks and aliases == {} and removed == set() and not report.enabled
