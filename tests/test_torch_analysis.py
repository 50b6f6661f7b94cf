"""The port's UDF static analyzer (``fugue_tpu_torch/analysis``) against the
JAX package's (``fugue_tpu/analysis``).

Every case of ``tests/analysis/test_analysis.py`` that needs no ``obs``
builds the same workflow through both packages, on the same seeded numpy
frames, and holds three things:

- the port's ``UdfAnalysis`` of the transform task equals the
  reference's: the verdict code, ``row_local``, ``pure``,
  ``deterministic``, the read and write sets, the fingerprint and the
  translated steps, each expression compared by its rendered text;
- the port's plan report and plan stats count what the reference's count
  (``udfs_translated``, ``filters_pushed``, ``cols_pruned``,
  ``verbs_fused``, ``segments_lowered``, ``segments_executed``,
  ``segments_fallback``) and its analysis stats equal the reference's;
- the port's result with analysis on equals its result with analysis off,
  on ``TorchExecutionEngine(device="cpu")`` and on the port's host engine,
  and the reference's result (``JaxExecutionEngine`` on the 8-device CPU
  mesh, result cache off): row outputs with ``pd.testing.assert_frame_equal``
  exactly, as the reference's own test holds them; aggregates within
  ``np.allclose``.

The UDFs are module-level: the analyzer reads their source.
"""

import types
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import fugue_tpu.analysis as janalysis
import fugue_tpu.column as jcolumn
from fugue_tpu import FugueWorkflow as JFugueWorkflow
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.jax import JaxExecutionEngine

import fugue_tpu_torch.analysis as tanalysis
import fugue_tpu_torch.column as tcolumn
import fugue_tpu_torch.torch.dataframe as tdataframe
from fugue_tpu_torch.cache import non_deterministic
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

ANALYZE = "fugue.tpu.plan.analyze_udfs"
TRANSLATE = "fugue.tpu.plan.translate_udfs"
CHUNK = "fugue.tpu.stream.chunk_rows"
REPORT_COUNTS = ["udfs_analyzed", "udfs_translated", "udfs_refused", "filters_pushed", "cols_pruned",
                 "verbs_fused", "segments_lowered"]
STAT_COUNTS = ["segments_lowered", "segments_executed", "segments_fallback"]
RTOL, ATOL = 1e-9, 1e-9  # float64 aggregates summed in other orders

REF = types.SimpleNamespace(
    name="ref", col=jcolumn.col, ff=jcolumn.functions, Workflow=JFugueWorkflow, Stream=JStream,
    Arrow=JArrowDataFrame, analysis=janalysis,
)
PORT = types.SimpleNamespace(
    name="port", col=tcolumn.col, ff=tcolumn.functions, Workflow=FugueWorkflow,
    Stream=LocalDataFrameIterableDataFrame, Arrow=ArrowDataFrame, analysis=tanalysis,
)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _frame(n=4000, cols=6, seed=0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    pdf = pd.DataFrame(
        {
            "k": rng.integers(0, 16, n),
            "v": rng.random(n),
            "w": rng.random(n),
            **{f"x{i}": rng.random(n) for i in range(cols)},
        }
    )
    pdf.loc[pdf.index % 9 == 0, "v"] = np.nan
    return pdf


def _stream(m: Any, pdf: pd.DataFrame, step: int = 512) -> Any:
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)
    return m.Stream(
        (m.Arrow(tbl.slice(s, min(step, tbl.num_rows - s))) for s in range(0, tbl.num_rows, step)),
        schema=m.Arrow(tbl).schema,
    )


def _engine(m: Any, conf: Dict[str, Any], host: bool = False) -> Any:
    if m is REF:
        conf = {"fugue.tpu.cache.enabled": False, **conf}
        return JNativeExecutionEngine(conf) if host else JaxExecutionEngine(conf)
    return NativeExecutionEngine(conf) if host else TorchExecutionEngine(device="cpu", conf=conf)


def _stats(m: Any, eng: Any, what: str) -> Dict[str, Any]:
    if m is REF:
        return dict(eng.stats()[what])
    return (eng.plan_stats if what == "plan" else eng.analysis_stats).as_dict()


def _run_once(build: Callable, m: Any, conf: Optional[dict] = None, host: bool = False,
              sort: Optional[List[str]] = None) -> Any:
    """``(result pandas, engine, workflow)`` of ``build`` on a fresh
    workflow and engine of package ``m``."""
    eng = _engine(m, dict(conf or {}), host)
    dag = m.Workflow()
    build(dag, m)
    dag.run(eng)
    res = dag.yields["r"].result.as_pandas()
    if sort:
        res = res.sort_values(sort).reset_index(drop=True)
    return res, eng, dag


def _render_step(st: Any) -> Any:
    """A translated step with every expression as its rendered text."""
    kind = st[0]
    if kind in ("assign", "select"):
        exprs = st[1].all_cols if kind == "select" else st[1]
        return kind, [f"{e.output_name}={e!r}::{e.as_type}" for e in exprs]
    if kind == "filter":
        return kind, f"{st[1]!r}::{st[1].as_type}"
    if kind == "rename":
        return kind, sorted(dict(st[1]).items())
    return kind, [str(x) for x in st[1:]]


def _facts(a: Any) -> Dict[str, Any]:
    return dict(
        name=a.name, fp=a.fp, code=a.code, reason=a.reason, verdict=a.verdict, row_local=a.row_local,
        pure=a.pure, deterministic=a.deterministic, reads=a.reads, writes=a.writes, star=a.star,
        schema_ok=a.schema_ok, declared=[(n, str(t)) for n, t in a.declared],
        required_extra=a.required_extra,
        steps=None if a.steps is None else [_render_step(s) for s in a.steps],
    )


def _analysis_of(build: Callable, m: Any) -> Any:
    """The package's ``UdfAnalysis`` of the workflow's transform task."""
    dag = m.Workflow()
    build(dag, m)
    tasks = [t for t in dag._tasks if t.params.get_or_none("transformer", object) is not None]
    assert len(tasks) == 1
    return m.analysis.analyze_transform_task(tasks[0]), m.analysis.transform_row_local(tasks[0])


def _same_analysis(build: Callable) -> Dict[str, Any]:
    """The port's analysis of the transform task, and ``transform_row_local``,
    equal the reference's."""
    (port, port_local), (ref, ref_local) = _analysis_of(build, PORT), _analysis_of(build, REF)
    got = _facts(port)
    assert got == _facts(ref) and port_local == ref_local == (port.row_local and port.deterministic)
    return got


def _report_counts(rep: Any) -> Dict[str, int]:
    return {c: getattr(rep, c) for c in REPORT_COUNTS}


def _diags(rep: Any) -> List[Dict[str, Any]]:
    return [{k: d[k] for k in ("udf", "fp", "verdict", "code", "reason", "translated")} for d in rep.udf_diags]


def _same_rows(got: pd.DataFrame, exp: pd.DataFrame) -> None:
    pd.testing.assert_frame_equal(got.reset_index(drop=True), exp.reset_index(drop=True))


def _close_rows(got: pd.DataFrame, exp: pd.DataFrame) -> None:
    """Aggregates: keys and counts exact, floats within RTOL/ATOL."""
    assert list(got.columns) == list(exp.columns) and len(got) == len(exp)
    for c in got.columns:
        g, e = got[c], exp[c]
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            assert np.allclose(g.to_numpy(np.float64), e.to_numpy(np.float64), rtol=RTOL, atol=ATOL,
                               equal_nan=True), c
        else:
            assert g.tolist() == e.tolist(), c


def _parity(build: Callable, sort: Optional[List[str]] = None, conf: Optional[dict] = None,
            exact: bool = True) -> Any:
    """The port with analysis on, against itself with analysis off, the
    port's host engine with it on, and the reference with it on: the
    results agree (``exact``: bit for bit), and the port counts what the
    reference counts. Returns ``(port result, port engine, port workflow)``."""
    conf = dict(conf or {})
    same = _same_rows if exact else _close_rows
    got, eng, dag = _run_once(build, PORT, conf, sort=sort)
    off, _, _ = _run_once(build, PORT, {**conf, ANALYZE: False}, sort=sort)
    host, _, _ = _run_once(build, PORT, conf, host=True, sort=sort)
    exp, jeng, jdag = _run_once(build, REF, conf, sort=sort)
    same(got, off)
    same(host, off)
    same(got, exp)
    assert _report_counts(dag.last_plan_report) == _report_counts(jdag.last_plan_report)
    assert _diags(dag.last_plan_report) == _diags(jdag.last_plan_report)
    st, jst = _stats(PORT, eng, "plan"), _stats(REF, jeng, "plan")
    assert {c: st[c] for c in STAT_COUNTS} == {c: jst[c] for c in STAT_COUNTS}
    assert _stats(PORT, eng, "analysis") == _stats(REF, jeng, "analysis")
    return got, eng, dag


def _transform(udf: Any, schema: str, params: Optional[dict] = None, n: int = 4000) -> Callable:
    pdf = _frame(n)

    def build(dag, m):
        dag.transform(pdf.copy(), using=udf, schema=schema, params=params).yield_dataframe_as(
            "r", as_local=True)

    return build


# module-level UDFs (the analyzer reads their SOURCE; exec'd or REPL
# functions refuse with reason "source")


def udf_arith(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"].fillna(0.0) * 2.0 + df["w"]
    df = df[df["z"] > 0.3]
    return df


def udf_conditional(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = np.where(df["w"] > 0.5, df["w"] * 2.0, df["v"].fillna(0.25))
    mask = df["z"] > 0.4
    df = df[mask]
    return df


def udf_methods(df: pd.DataFrame) -> pd.DataFrame:
    df["c"] = df["v"].clip(0.1, 0.9)
    df["m"] = df["w"].where(df["w"] > 0.5, 0.5)
    df["r"] = df["v"].fillna(0.0).round(2).abs()
    df["kk"] = df["k"].isin([1, 2, 3])
    df["f"] = df["k"].astype("float64")
    return df


def _make_scaled_udf(scale: float):
    # a SCALAR closure cell — allowed (and part of the trace fingerprint)
    def udf_params(df: pd.DataFrame, lo: float, hi: float = 0.8) -> pd.DataFrame:
        df["z"] = (df["v"].fillna(lo) * scale).clip(lo, hi)
        df = df[df["z"] >= lo]
        return df

    return udf_params


def udf_overwrite(df: pd.DataFrame) -> pd.DataFrame:
    df["v"] = df["v"].fillna(0.0) * 2.5
    df["z"] = df["v"] + df["w"]
    return df


def udf_static_if(df: pd.DataFrame, mode: str = "double") -> pd.DataFrame:
    if mode == "double":
        df["z"] = df["v"].fillna(0.0) * 2.0
    else:
        df["z"] = df["v"].fillna(0.0) + 100.0
    return df


def udf_reduction(df: pd.DataFrame) -> pd.DataFrame:
    total = df["v"].fillna(0.0).sum()
    df["z"] = df["v"].fillna(0.0) / (total + 1.0)
    return df


def udf_writes_passthrough_free(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"].fillna(0.0) * 2.0 + df["w"]
    return df


# ---------------------------------------------------------------------------
# parity matrix
# ---------------------------------------------------------------------------


def test_parity_arith_star_bounded():
    build = _transform(udf_arith, "*,z:double")
    facts = _same_analysis(build)
    assert facts["verdict"] == "translatable" and facts["row_local"] and facts["reads"] == {"v", "w", "z"}
    res, eng, dag = _parity(build)
    assert (res["z"] > 0.3).all()
    assert eng.analysis_stats.as_dict()["udfs_translated"] == 1
    assert dag.last_plan_report.udfs_translated == 1


def test_parity_conditional_and_series_mask():
    build = _transform(udf_conditional, "*,z:double")
    _same_analysis(build)
    res, _, dag = _parity(build)
    assert len(res) > 0
    assert dag.last_plan_report.udfs_translated == 1


def test_parity_method_subset():
    build = _transform(udf_methods, "*,c:double,m:double,r:double,kk:bool,f:double")
    _same_analysis(build)
    res, _, dag = _parity(build)
    assert dag.last_plan_report.udfs_translated == 1
    assert res["c"].dropna().between(0.1, 0.9).all()


def test_parity_params_and_closure():
    build = _transform(_make_scaled_udf(3.0), "*,z:double", params=dict(lo=0.2))
    _same_analysis(build)
    res, _, dag = _parity(build)
    assert dag.last_plan_report.udfs_translated == 1
    assert (res["z"] >= 0.2).all()


def test_parity_explicit_schema_overwrite():
    """An explicit full schema may overwrite existing columns (declared
    dtypes are known) and narrows the output to the declared list."""
    build = _transform(udf_overwrite, "k:long,v:double,z:double")
    _same_analysis(build)
    res, _, dag = _parity(build)
    assert list(res.columns) == ["k", "v", "z"]
    assert dag.last_plan_report.udfs_translated == 1


@pytest.mark.parametrize("mode", ["double", "add"])
def test_parity_static_if_takes_bound_branch(mode):
    build = _transform(udf_static_if, "*,z:double", params=dict(mode=mode))
    _same_analysis(build)
    res, _, dag = _parity(build)
    assert dag.last_plan_report.udfs_translated == 1
    if mode == "add":
        assert (res["z"] >= 100.0).all()


def _translated_aggregate(pdf: pd.DataFrame, stream: bool) -> Callable:
    def build(dag, m):
        c = m.col
        (dag.df(_stream(m, pdf) if stream else pdf.copy())
         .transform(using=udf_arith, schema="*,z:double")
         .partition_by("k")
         .aggregate(m.ff.sum(c("z")).alias("s"), m.ff.count(c("z")).alias("n"))
         .yield_dataframe_as("r", as_local=True))

    return build


@pytest.mark.parametrize("stream", [True, False])
def test_parity_streaming_single_segment(stream):
    """The translated UDF chain and the dense aggregate run as ONE lowered
    segment (none falls back), streamed as in the reference's case and in
    memory, with the results of the interpreted path."""
    build = _translated_aggregate(_frame(6000), stream)
    _, eng, dag = _parity(build, sort=["k"], conf={CHUNK: 512}, exact=False)
    st = eng.plan_stats.as_dict()
    assert st["segments_executed"] == 1 and st["segments_fallback"] == 0
    assert dag.last_plan_report.udfs_translated == 1


def test_translated_fuses_with_surrounding_verbs():
    """Workflow verbs around the UDF and the translated steps collapse into
    one fused chain: no standalone filter or select runs."""
    pdf = _frame()

    def build(dag, m):
        c = m.col
        (dag.df(pdf.copy()).filter(c("w") < 0.95).transform(using=udf_arith, schema="*,z:double")
         .select(c("k"), c("z"), (c("z") * 2).alias("z2")).yield_dataframe_as("r", as_local=True))

    _, _, dag = _parity(build)
    rep = dag.last_plan_report
    assert rep.udfs_translated == 1 and rep.verbs_fused >= 4
    assert any("fused" in line for line in rep.after), rep.after


def _pruned_columns_seen(build: Callable, conf: dict, monkeypatch: Any) -> List[List[str]]:
    """The columns of every table the port's device ingests."""
    seen: List[List[str]] = []
    orig = tdataframe.encode_arrow_for_device

    def spy(tbl):
        seen.append(list(tbl.column_names))
        return orig(tbl)

    monkeypatch.setattr(tdataframe, "encode_arrow_for_device", spy)
    _run_once(build, PORT, conf)
    monkeypatch.undo()
    return seen


def _aggregate_of(udf: Any, pdf: pd.DataFrame) -> Callable:
    def build(dag, m):
        (dag.df(pdf.copy()).transform(using=udf, schema="*,z:double").partition_by("k")
         .aggregate(m.ff.sum(m.col("z")).alias("s")).yield_dataframe_as("r", as_local=True))

    return build


def test_pruning_reaches_producer_translated(monkeypatch):
    build = _aggregate_of(udf_arith, _frame(cols=8))
    seen = _pruned_columns_seen(build, {}, monkeypatch)
    assert seen and set(seen[0]) == {"k", "v", "w"}, seen[:3]
    _parity(build, sort=["k"], exact=False)


def test_pruning_reaches_producer_facts_only(monkeypatch):
    """translate_udfs=false: the UDF stays interpreted but its EXACT column
    reads still narrow demand: the producer only carries what the UDF and
    downstream read."""
    build = _aggregate_of(udf_arith, _frame(cols=8))
    seen = _pruned_columns_seen(build, {TRANSLATE: False}, monkeypatch)
    assert seen and set(seen[0]) == {"k", "v", "w"}, seen[:3]
    _, _, dag = _parity(build, sort=["k"], conf={TRANSLATE: False}, exact=False)
    assert dag.last_plan_report.udfs_translated == 0 and dag.last_plan_report.cols_pruned > 0


def test_pushdown_commutes_through_row_local_udf():
    """translate_udfs=false: a filter over a column the (row-local, pure,
    star-schema) UDF never writes commutes BELOW the interpreted UDF."""
    pdf = _frame()

    def build(dag, m):
        c = m.col
        (dag.transform(pdf.copy(), using=udf_writes_passthrough_free, schema="*,z:double")
         .filter(c("x0") < 0.5).select(c("k"), c("z"), c("x0")).yield_dataframe_as("r", as_local=True))

    res, _, dag = _parity(build, conf={TRANSLATE: False})
    assert dag.last_plan_report.filters_pushed >= 1
    assert (res["x0"] < 0.5).all()
    _parity(build)


def test_pruning_under_reduction_udf(monkeypatch):
    """A per-partition reduction is pure but not row-local: interpreted,
    with exact reads, so pruning still reaches the producer."""
    build = _aggregate_of(udf_reduction, _frame(cols=8))
    facts = _same_analysis(build)
    assert facts["code"] == "reduction" and facts["pure"] and not facts["row_local"]
    seen = _pruned_columns_seen(build, {}, monkeypatch)
    assert seen and set(seen[0]) == {"k", "v"}, seen[:3]
    _, eng, dag = _parity(build, sort=["k"], exact=False)
    assert eng.analysis_stats.as_dict()["udfs_translated"] == 0
    d = dag.last_plan_report.udf_diags[0]
    assert d["code"] == "reduction" and not d["translated"]


# ---------------------------------------------------------------------------
# refusal matrix — every case bit-identical with the reason rendered
# ---------------------------------------------------------------------------

_GLOBAL_OFFSET = 1.5


def udf_reads_global(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"].fillna(0.0) + _GLOBAL_OFFSET
    return df


_MUTABLE = [2.0]


def _make_closure_udf():
    lut = _MUTABLE

    def udf_mutable_closure(df: pd.DataFrame) -> pd.DataFrame:
        df["z"] = df["v"].fillna(0.0) * lut[0]
        return df

    return udf_mutable_closure


def udf_apply(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"].apply(lambda x: x * 2)
    return df


def udf_loop(df: pd.DataFrame) -> pd.DataFrame:
    for c in ["v", "w"]:
        df[c] = df[c] * 2
        if c == "v":
            break
    return df


def udf_unknown_method(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"].rolling(3).mean()
    return df


def udf_random(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"].fillna(0.0) + np.random.random()
    return df


def udf_data_dependent_if(df: pd.DataFrame) -> pd.DataFrame:
    if df["v"].mean() > 0.5:
        df["z"] = df["v"].fillna(1.0)
    else:
        df["z"] = df["w"]
    return df


@non_deterministic
def udf_marked(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"].fillna(0.0) * 2.0
    return df


REFUSALS = [
    (udf_reads_global, "globals"),
    (_make_closure_udf(), "mutable-closure"),
    (udf_apply, "apply"),
    (udf_loop, "loop"),
    (udf_unknown_method, "unknown-call"),
    (udf_random, "non-deterministic"),
    (udf_data_dependent_if, "conditional"),
]


@pytest.mark.parametrize("udf,code", REFUSALS, ids=[c for _, c in REFUSALS])
def test_refusal_matrix(udf, code):
    build = _transform(udf, "*" if udf is udf_loop else "*,z:double", n=1200)
    facts = _same_analysis(build)
    assert facts["code"] == code and facts["steps"] is None
    if udf is udf_random:
        # non-deterministic: two runs differ — the refusal and the counts
        _, eng, dag = _run_once(build, PORT)
        _, jeng, jdag = _run_once(build, REF)
        assert _diags(dag.last_plan_report) == _diags(jdag.last_plan_report)
        assert _stats(PORT, eng, "analysis") == _stats(REF, jeng, "analysis")
    else:
        _, eng, _ = _parity(build)
    stats = eng.analysis_stats.as_dict()
    assert stats["udfs_translated"] == 0 and stats["udfs_refused"] >= 1
    assert code in stats["refused"], stats["refused"]
    dag2 = FugueWorkflow()
    build(dag2, PORT)
    assert "interpreted --" in dag2.explain()


def test_refusal_marked_non_deterministic():
    """``@non_deterministic`` (``fugue_tpu_torch.cache``) sets the
    reference's marker: both analyzers refuse, with the same reason."""

    def build(dag, m):
        dag.transform(_frame(600), using=udf_marked, schema="*,z:double").yield_dataframe_as("r", as_local=True)

    facts = _same_analysis(build)
    assert facts["code"] == "non-deterministic" and facts["reason"] == "marked @non_deterministic"


def test_refusal_partitioned_transform():
    pdf = _frame()

    def build(dag, m):
        (dag.df(pdf.copy()).partition_by("k").transform(using=udf_arith, schema="*,z:double")
         .yield_dataframe_as("r", as_local=True))

    facts = _same_analysis(build)
    assert facts["code"] == "partitioned" and facts["required_extra"] == {"k"}
    _, eng, _ = _parity(build, sort=["k", "v", "w"])
    assert eng.analysis_stats.as_dict()["refused"].get("partitioned", 0) >= 1


def udf_writes_passthrough(df: pd.DataFrame) -> pd.DataFrame:
    df["v"] = df["v"].fillna(0.0) * 2.0
    return df


def test_refusal_star_passthrough_write():
    """Writing an existing column under a '*' schema: the enforced output
    dtype is the ORIGINAL input dtype (unknown at plan time) — refuse."""
    build = _transform(udf_writes_passthrough, "*")
    _same_analysis(build)
    _, _, dag = _parity(build)
    d = dag.last_plan_report.udf_diags[0]
    assert not d["translated"] and "passthrough" in (d["reason"] or "")


def udf_stale_series(df: pd.DataFrame) -> pd.DataFrame:
    m = df["v"] > 0.5
    df = df[df["w"] > 0.1]
    df = df[m]
    return df


def test_refusal_stale_series_variable():
    """A mask bound BEFORE a frame mutation is pandas-aligned by the
    captured values — re-evaluating it later would see different rows, so
    the analyzer refuses (aliasing)."""
    build = _transform(udf_stale_series, "*", n=800)
    facts = _same_analysis(build)
    assert facts["code"] == "aliasing"
    _, eng, _ = _parity(build)
    assert eng.analysis_stats.as_dict()["refused"].get("aliasing", 0) >= 1


# ---------------------------------------------------------------------------
# the trace cache and the callable fingerprint
# ---------------------------------------------------------------------------


def udf_edit_v1(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"].fillna(0.0) + 1.0
    return df


def udf_edit_v2(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"].fillna(0.0) + 2.0
    return df


def test_fingerprint_follows_the_udf_source():
    """An edited UDF fingerprints and translates apart; the same one hits
    its cached trace; a scalar closure cell is part of the fingerprint."""
    from fugue_tpu_torch.analysis.analyzer import _TRACE_CACHE

    a1, a2 = (_analysis_of(_transform(u, "*,z:double", n=50), PORT)[0] for u in (udf_edit_v1, udf_edit_v2))
    assert a1.fp != a2.fp and _render_step(a1.steps[0]) != _render_step(a2.steps[0])
    cached = dict(_TRACE_CACHE)
    again = _analysis_of(_transform(udf_edit_v1, "*,z:double", n=50), PORT)[0]
    assert again.fp == a1.fp and dict(_TRACE_CACHE) == cached
    fps = {_analysis_of(_transform(_make_scaled_udf(s), "*,z:double", dict(lo=0.2), 50), PORT)[0].fp
           for s in (2.0, 3.0)}
    assert len(fps) == 2
    for u in (udf_edit_v1, udf_edit_v2):
        _same_analysis(_transform(u, "*,z:double", n=50))


def test_fingerprint_invalidation_on_udf_edit(tmp_path):
    """Reference ``test_fingerprint_invalidation_on_udf_edit``: with the
    result cache on, a translated plan's identity follows the translated
    steps: the same UDF hits warm, an edited one misses; the results equal
    the JAX engine's."""
    pdf = _frame(800)
    out = {}
    for m in (PORT, REF):
        conf = {"fugue.tpu.cache.enabled": True, "fugue.tpu.cache.dir": str(tmp_path / m.name)}

        def build_with(udf):
            return lambda dag, m: dag.transform(pdf.copy(), using=udf, schema="*,z:double").yield_dataframe_as(
                "r", as_local=True)

        r1, _, _ = _run_once(build_with(udf_edit_v1), m, conf)
        r1b, _, d1b = _run_once(build_with(udf_edit_v1), m, conf)
        assert d1b.last_cache_plan.summary()["executes"] == 0  # a warm hit
        pd.testing.assert_frame_equal(r1, r1b)
        r2, _, d2 = _run_once(build_with(udf_edit_v2), m, conf)
        assert d2.last_cache_plan.summary()["executes"] >= 1  # edited: computed again
        assert not r1.equals(r2)
        out[m.name] = (r1, r2)
    for got, exp in zip(out["port"], out["ref"]):
        pd.testing.assert_frame_equal(got, exp)


def test_delta_cache_serves_analyzed_udf_chain(tmp_path):
    """Reference ``test_delta_cache_serves_analyzed_udf_chain``: a row-local
    analyzed UDF chain over a grown parquet directory recomputes only the
    appended partition on the warm run, equal to a run with the cache off
    and to the JAX engine's."""
    import os

    import pyarrow.parquet as pq

    out = {}
    for m in (PORT, REF):
        src = str(tmp_path / m.name / "src")
        os.makedirs(src)

        def write_part(i):
            rng = np.random.default_rng(500 + i)
            n = 700
            pq.write_table(pa.table({"k": rng.integers(0, 8, n).astype("int64"), "v": rng.random(n),
                                     "w": rng.random(n)}), os.path.join(src, f"part_{i:03d}.parquet"))

        for i in range(3):
            write_part(i)

        def build(dag, m):
            dag.load(src, fmt="parquet").transform(using=udf_arith, schema="*,z:double").yield_dataframe_as(
                "r", as_local=True)

        conf = {"fugue.tpu.cache.enabled": True, "fugue.tpu.cache.dir": str(tmp_path / m.name / "cache")}
        _run_once(build, m, conf)
        write_part(3)  # the source grows
        r2, e2, _ = _run_once(build, m, conf)
        cs = e2.stats()["cache"]
        assert cs["partial_hits"] >= 1, cs
        assert cs["delta_partitions_fresh"] == 1 and cs["delta_partitions"] == 3, cs
        ref, _, _ = _run_once(build, m, {"fugue.tpu.cache.enabled": False})
        pd.testing.assert_frame_equal(r2, ref)
        out[m.name] = r2
    pd.testing.assert_frame_equal(out["port"], out["ref"])


# ---------------------------------------------------------------------------
# surface: lint, counters, conf gates
# ---------------------------------------------------------------------------


def test_lint_structured_diagnostics():
    pdf = _frame()
    reps = {}
    for m in (PORT, REF):
        dag = m.Workflow()
        (dag.transform(pdf, using=udf_arith, schema="*,z:double").partition_by("k")
         .aggregate(m.ff.sum(m.col("z")).alias("s")).yield_dataframe_as("r", as_local=True))
        rep = dag.lint()
        dag2 = m.Workflow()
        dag2.transform(pdf, using=udf_apply, schema="*,z:double").yield_dataframe_as("r2", as_local=True)
        # two joins, one under the budget and one past it: the join
        # findings are the strategy ladder's, without the device_exchange
        # rung (plan time counts 8 shards in the JAX package, 1 in the port)
        dag3 = m.Workflow({"fugue.tpu.shuffle.device_budget_bytes": 100_000,
                           "fugue.tpu.shuffle.device_exchange.enabled": False})
        a = dag3.df(pdf)
        a.inner_join(dag3.df(pdf[["k"]].drop_duplicates()))
        a.left_outer_join(dag3.df(pdf.rename(columns={c: c + "_r" for c in pdf.columns if c != "k"})))
        reps[m.name] = (rep, dag2.lint(), dag.explain(lint=True), dag3.lint())
    rep, rep2, text, rep3 = reps["port"]
    udfs = rep.udfs
    assert len(udfs) == 1 and udfs[0].status == "translated", rep.as_dict()
    assert any(d.kind == "segment" for d in rep.diagnostics), rep.as_dict()
    assert "== lint ==" in text and "[udf]" in text
    assert rep2.udfs[0].status == "apply", rep2.as_dict()
    assert "apply" in rep2.udfs[0].message
    assert [d.status for d in rep3.by_kind("join")] == ["broadcast", "shuffle_spill"], rep3.as_dict()
    # udf, join and segment findings as the reference's (the notes differ
    # by the passes each package has)
    for got, exp in ((rep, reps["ref"][0]), (rep2, reps["ref"][1]), (rep3, reps["ref"][3])):
        for kind in ("udf", "join", "segment"):
            assert [d.as_dict() for d in got.by_kind(kind)] == [d.as_dict() for d in exp.by_kind(kind)]


def test_counters_and_reset():
    """``engine.analysis_stats`` counts what the reference's
    ``stats()["analysis"]`` counts, refusals by reason code."""
    for udf, want in ((udf_arith, {"udfs_analyzed": 1, "udfs_translated": 1, "udfs_refused": 0, "refused": {}}),
                      (udf_apply, {"udfs_analyzed": 1, "udfs_translated": 0, "udfs_refused": 1,
                                   "refused": {"apply": 1}})):
        build = _transform(udf, "*,z:double", n=800)
        _, eng, _ = _run_once(build, PORT)
        _, jeng, _ = _run_once(build, REF)
        assert eng.analysis_stats.as_dict() == _stats(REF, jeng, "analysis") == want
        eng.analysis_stats.reset()
        assert eng.analysis_stats.as_dict()["udfs_analyzed"] == 0
    assert tanalysis.REASON_CODES == janalysis.REASON_CODES and len(tanalysis.REASON_CODES) == 22


def test_conf_gates():
    build = _transform(udf_arith, "*,z:double", n=800)
    res_off, eng_off, dag_off = _run_once(build, PORT, {ANALYZE: False})
    assert eng_off.analysis_stats.as_dict()["udfs_analyzed"] == 0
    assert dag_off.last_plan_report.udfs_analyzed == 0
    res_nt, eng_nt, dag_nt = _run_once(build, PORT, {TRANSLATE: False})
    st = eng_nt.analysis_stats.as_dict()
    assert st["udfs_analyzed"] == 1 and st["udfs_translated"] == 0
    assert st["refused"].get("disabled") == 1
    _same_rows(res_off, res_nt)
    _, jeng_nt, jdag_nt = _run_once(build, REF, {TRANSLATE: False})
    assert st == _stats(REF, jeng_nt, "analysis")
    assert _diags(dag_nt.last_plan_report) == _diags(jdag_nt.last_plan_report)


def test_exec_udf_refuses_no_source():
    """A UDF with no retrievable source (exec'd) refuses conservatively."""
    ns = {"pd": pd}
    exec(
        "def bump(df: pd.DataFrame) -> pd.DataFrame:\n"
        "    return df.assign(z=df['v'] + 1.0)\n",
        ns,
    )
    build = _transform(ns["bump"], "*,z:double", n=600)
    facts = _same_analysis(build)
    assert facts["code"] == "source"
    _, eng, _ = _parity(build)
    st = eng.analysis_stats.as_dict()
    assert st["udfs_translated"] == 0 and st["refused"].get("source") == 1


_ANALYSIS_PATH_ON_THE_CPU = """
import json, sys, numpy as np, pandas as pd, pyarrow as pa, torch
import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
chip_smoke.CALLBACK_ROWS = 20_000
pdf = chip_smoke.plan_frame(np, pd, 40_000, 0)
out = chip_smoke.phase_analysis_path(torch, np, pd, pa, bg, api, ff, col, TorchExecutionEngine(device="cpu"), pdf,
                                     stream_rows=40_000, stream_chunk=8_000)
print("RESULT", json.dumps({c: [r.get("plan"), r.get("stream_plan"), r["launches"]] for c, r in out["cells"].items()}))
print("CALLBACK", json.dumps([out["cells"]["callback-1k"]["callback"], out["cells"]["callback-1k"]["lint"]]))
print("JAX", "jax" in sys.modules or "fugue_tpu" in sys.modules)
"""


def test_chip_smoke_analysis_path_on_the_cpu():
    """The phase's four cells pass their oracles and twins at small size:
    one lowered segment for each translated and unsigned chain, none
    fallen back, 1,000 callback calls, no binned-sum launch on the CPU,
    and no JAX loaded."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _ANALYSIS_PATH_ON_THE_CPU], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("RESULT", "CALLBACK", "JAX")))
    cells = json.loads(lines["RESULT"])
    zero = {"bin_sum": 0, "bin_sum_count": 0}
    translated = {"pushdowns": 0, "prunes": 0, "fusions": 3, "segments_lowered": 1, "segments_executed": 1,
                  "segments_fallback": 0, "udfs_translated": 1}
    chain = dict(translated, fusions=2, udfs_translated=0)
    assert cells == {
        "translated-uniform-1k": [translated, None, zero],
        "stream-translated-f32": [translated, None, zero],
        "lowered-uint32": [chain, chain, zero],
        "callback-1k": [None, None, zero],
    }
    assert json.loads(lines["CALLBACK"]) == [{"calls": 1000, "rows": 20_000},
                                              {"report_rows": "signature", "scale": "callback"}]
    assert lines["JAX"] == "False"


# ---------------------------------------------------------------------------
# C20: NULL compares answer as the UDF does in pandas
# ---------------------------------------------------------------------------


def udf_not_positive(df: pd.DataFrame) -> pd.DataFrame:
    df = df[~(df["v"] > 0.0)]
    return df


def udf_not_a(df: pd.DataFrame) -> pd.DataFrame:
    df = df[df["s"] != "a"]
    return df


def udf_both_flags(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = (df["v"] > 0.0) & (df["i"] > 2)
    return df


def _null_frame(n: int = 40, seed: int = 3) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n)
    v[rng.random(n) < 0.2] = np.nan
    i = pd.array(rng.integers(0, 5, n), dtype="Int64")
    i[rng.random(n) < 0.25] = pd.NA
    s = rng.choice(np.array(["a", "b", "c"], dtype=object), n)
    s[rng.random(n) < 0.2] = None
    return pd.DataFrame({"k": np.arange(n), "v": v, "i": i, "s": s})


@pytest.mark.parametrize("udf,schema", [(udf_not_positive, "*"), (udf_not_a, "*"),
                                        (udf_both_flags, "*,z:bool")])
def test_null_compares_answer_as_pandas(udf, schema):
    """C20: with the analyzer on, the port refuses ``~`` over a comparison,
    ``!=`` and a comparison kept as a column (``unknown-construct``), so
    the UDF runs in pandas and gives what it gives there: the reference's
    answer, and the port's own, with ``fugue.tpu.plan.analyze_udfs=false``.
    The reference with the analyzer on translates them and answers in the
    column IR's three-valued logic (ROADMAP.md §C C20). Rows exact, in key
    order, compared as arrow values."""
    pdf = _null_frame()

    def build(dag: Any, m: Any) -> None:
        dag.transform(pdf.copy(), using=udf, schema=schema).yield_dataframe_as("r", as_local=True)

    def rows(conf: dict, m: Any) -> Any:
        eng = _engine(m, conf)
        dag = m.Workflow()
        build(dag, m)
        dag.run(eng)
        tbl = dag.yields["r"].result.as_arrow()
        return tbl.take(pc.sort_indices(tbl, [("k", "ascending")])).to_pylist(), eng, dag

    off = {ANALYZE: False}
    got, eng, dag = rows({}, PORT)
    exp, ref_on = rows(off, REF)[0], rows({}, REF)[0]
    assert got == exp == rows(off, PORT)[0]
    assert dag.last_plan_report.udfs_translated == 0
    assert eng.analysis_stats.as_dict()["refused"] == {"unknown-construct": 1}
    a, _ = _analysis_of(build, PORT)
    assert a.steps is None and a.code == "unknown-construct" and a.reads == ({"v"} if udf is udf_not_positive
                                                                         else {"s"} if udf is udf_not_a
                                                                         else {"v", "i"})
    # the reference, translating, answers otherwise on these NULLs
    assert got != ref_on
