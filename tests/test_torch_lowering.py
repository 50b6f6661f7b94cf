"""The port's segment lowering (``fugue_tpu_torch/plan/lowering.py`` and
``TorchExecutionEngine.lowered_segment``) against the JAX package's.

Each case of ``tests/plan/test_lowering.py`` runs through both packages
with the optimizer on (``JaxExecutionEngine`` on the 8-device CPU mesh
against ``TorchExecutionEngine(device="cpu")``), and on the port also with
``fugue.tpu.plan.lower_segments=false`` (the per-verb path). Then:

- the three results are equal: keys, counts and row sets exact, floats
  within ``rtol=1e-5``/``atol=1e-9`` (``np.allclose``);
- the port's ``plan_stats`` count the segments lowered, executed and
  fallen back as the reference's ``stats()["plan"]`` does;
- a lowered segment runs under one ``fugue::plan_segment`` span, with no
  per-verb span (``fugue::fused``, ``fugue::filter``, ``fugue::project``);
  a refused one runs the per-verb path under the verbs' own spans;
- the host engine runs a segment per verb;
- the lowered stream's key range and NULL contract apply to the raw
  chunks, as the reference's; a lowered take's chunk with a NULL in an
  int column runs the chain per verb, counted;
- chains over uint16/32/64 columns, streamed, and a plain unsigned
  SUM/AVG, bounded and streamed, lower where the reference's do.
"""

from typing import Any

import numpy as np
import pandas as pd
import pytest
import torch

from fugue_tpu_torch.exceptions import FugueInvalidOperation
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow
from tests.test_torch_plan import PORT, REF, _stream, run_case, same_frames
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

LOWER = "fugue.tpu.plan.lower_segments"
CHUNK = 2048
_STATS = ["segments_lowered", "verbs_absorbed", "segments_executed", "segments_fallback"]


def _frame(n=20_000, groups=32, seed=0, strings=False) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    d = {"k": rng.integers(0, groups, n), "v": rng.random(n), "w": rng.random(n)}
    if strings:
        d["s"] = rng.choice(["a", "b", "c", None], n)
    return pd.DataFrame(d)


def _three(build, sort=None, kind="device"):
    """The port lowered, the port per verb, the reference: results equal;
    returns the lowered run's stats and the reference's."""
    conf = {"fugue.tpu.stream.chunk_rows": CHUNK}
    got, _, st, _ = run_case(build, PORT, kind, conf)
    per_verb, _, st_off, _ = run_case(build, PORT, kind, {**conf, LOWER: False})
    exp, _, jst, _ = run_case(build, REF, kind, conf)
    same_frames(got, exp, sort)
    same_frames(per_verb, exp, sort)
    assert st_off["segments_lowered"] == st_off["segments_executed"] == 0
    return st, jst


def _f32(pdf: pd.DataFrame) -> pd.DataFrame:
    out = pdf.copy()
    out["v"] = out["v"].astype(np.float32)
    out["w"] = out["w"].astype(np.float32)
    out.loc[::97, "v"] = np.nan
    return out


# ---- parity: lowered, per verb and the reference ----------------------------


def _agg5(m: Any, src: str) -> list:
    c = m.col(src)
    return [m.ff.sum(c).alias("s"), m.ff.count(c).alias("n"), m.ff.avg(c).alias("m"),
            m.ff.min(c).alias("lo"), m.ff.max(c).alias("hi")]


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("f32", [False, True])
def test_parity_fused_aggregate(stream, f32):
    """stream or frame → filter → select → dense aggregate (the flagship):
    one segment, lowered and executed on both packages."""
    pdf = _f32(_frame()) if f32 else _frame()

    def build(dag, m):
        src = _stream(m, pdf, CHUNK) if stream else pdf
        (dag.df(src).filter(m.col("v") > 0.25).select(m.col("k"), (m.col("v") * m.col("w")).alias("z"))
         .partition_by("k").aggregate(*_agg5(m, "z")).yield_dataframe_as("r", as_local=True))

    st, jst = _three(build, ["k"])
    assert {c: st[c] for c in _STATS} == {c: jst[c] for c in _STATS}
    assert st["segments_executed"] == 1 and st["segments_fallback"] == 0


def test_bounded_sum_of_an_addition():
    pdf = _frame()

    def build(dag, m):
        (dag.df(pdf).filter(m.col("v") > 0.25).select(m.col("k"), (m.col("v") + m.col("w")).alias("z"))
         .partition_by("k").aggregate(m.ff.sum(m.col("z")).alias("s"), m.ff.count(m.col("z")).alias("n"))
         .yield_dataframe_as("r", as_local=True))

    st, jst = _three(build, ["k"])
    assert st["segments_executed"] == jst["segments_executed"] == 1


def test_parity_streaming_take():
    pdf = _frame()

    def build(dag, m):
        (dag.df(_stream(m, pdf, CHUNK)).filter(m.col("v") > 0.5).select(m.col("k"), m.col("v"))
         .take(5, presort="v desc").yield_dataframe_as("r", as_local=True))

    st, jst = _three(build, ["v"])
    assert st["segments_executed"] == jst["segments_executed"] == 1


def test_parity_streaming_distinct():
    pdf = _frame()

    def build(dag, m):
        (dag.df(_stream(m, pdf, CHUNK)).select(m.col("k"), (m.col("v") > 0.5).alias("hi")).distinct()
         .yield_dataframe_as("r", as_local=True))

    st, jst = _three(build, ["k", "hi"])
    assert st["segments_executed"] == jst["segments_executed"] == 1


def test_parity_broadcast_join_probe():
    pdf = _frame()
    dim = pd.DataFrame({"k": np.arange(32), "label_v": np.arange(32) * 1.5})

    def build(dag, m):
        d = dag.df(dim)
        (dag.df(_stream(m, pdf, CHUNK)).filter(m.col("v") > 0.25).select(m.col("k"), m.col("v"))
         .join(d, how="inner", on=["k"]).yield_dataframe_as("r", as_local=True))

    st, jst = _three(build, ["k", "v"])
    assert st["segments_executed"] == jst["segments_executed"] == 1


def test_parity_sql_workflow():
    pdf = _frame()

    def build(dag, m):
        a = dag.df(pdf)
        dag.select("SELECT k, SUM(v) AS sv FROM ", a, " WHERE v > 0.2 GROUP BY k").yield_dataframe_as(
            "r", as_local=True)

    st, jst = _three(build, ["k"])
    assert {c: st[c] for c in _STATS} == {c: jst[c] for c in _STATS}


def test_parity_native_engine():
    """The host engine runs a lowered segment per verb: the same result."""
    pdf = _frame()

    def build(dag, m):
        (dag.df(pdf).filter(m.col("v") > 0.25).select(m.col("k"), (m.col("v") * 2).alias("v2"))
         .partition_by("k").aggregate(m.ff.sum(m.col("v2")).alias("s")).yield_dataframe_as("r", as_local=True))

    _three(build, ["k"], kind="native")


# ---- refusals ------------------------------------------------------------------


def test_refusal_udf_transformer_breaks_chain():
    """A pandas transformer between the chain and the aggregate: no segment
    forms on either package, and the missing analyzer changes no result."""
    pdf = _frame()

    def bump(df: pd.DataFrame) -> pd.DataFrame:
        df = df.copy()
        df["v"] = df["v"] + 1.0
        return df

    def build(dag, m):
        (dag.df(pdf).filter(m.col("v") > 0.25).transform(bump, schema="*").partition_by("k")
         .aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True))

    st, jst = _three(build, ["k"])
    assert st["segments_lowered"] == jst["segments_lowered"] == 0


def _host_only(dag, m, pdf):
    (dag.df(_stream(m, pdf, CHUNK)).filter(m.col("s").is_null() | (m.col("v") > 0.1))
     .select(m.col("k"), m.col("s"), m.col("v")).partition_by("k")
     .aggregate(m.ff.count(m.col("v")).alias("n")).yield_dataframe_as("r", as_local=True))


def test_refusal_host_only_chain_runs_per_verb():
    """A streamed chain over a string column: the segment forms, its gate
    refuses, and it runs per verb — the reference's counts, and the
    per-verb path's ranges with no ``plan.segment``."""
    pdf = _frame(strings=True)
    st, jst = _three(lambda dag, m: _host_only(dag, m, pdf), ["k"])
    assert {c: st[c] for c in _STATS} == {c: jst[c] for c in _STATS}
    assert st["segments_lowered"] == st["segments_fallback"] == 1 and st["segments_executed"] == 0
    spans = {}
    for lower in (True, False):
        eng = TorchExecutionEngine(device="cpu", conf={"fugue.tpu.stream.chunk_rows": CHUNK, LOWER: lower})
        dag = FugueWorkflow()
        _host_only(dag, PORT, pdf)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            dag.run(eng)
        spans[lower] = {e.key for e in prof.key_averages() if e.key.startswith(("fugue::", "engine.", "plan."))}
    assert "plan.segment" not in spans[True]
    assert spans[True] - {"fugue::plan_optimize"} == spans[False] - {"fugue::plan_optimize"}


def test_refusal_unlowerable_predicate_falls_back():
    """LIKE has no device form over raw stream columns: per verb."""
    from fugue_tpu.column.expressions import _LikeExpr as JLike
    from fugue_tpu_torch.column.expressions import _LikeExpr

    pdf = _frame(strings=True)

    def build(dag, m):
        like = (_LikeExpr if m is PORT else JLike)(m.col("s"), "a%")
        (dag.df(_stream(m, pdf, CHUNK)).filter(like | (m.col("v") > 0.9)).select(m.col("k"), m.col("v"))
         .partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True))

    st, jst = _three(build, ["k"])
    assert st["segments_fallback"] == jst["segments_fallback"] == 1


def test_refusal_key_range_over_the_dense_bound():
    """A bounded key range over 2^18: the gate refuses, per verb, counted."""
    pdf = _frame()
    pdf.loc[0, "k"] = 1 << 20

    def build(dag, m):
        (dag.df(pdf).filter(m.col("v") > 0.25).select(m.col("k"), m.col("v")).partition_by("k")
         .aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True))

    st, jst = _three(build, ["k"])
    assert st["segments_fallback"] == jst["segments_fallback"] == 1


# ---- spans, gate, explain, stats -----------------------------------------------


def test_span_shape():
    """One ``plan.segment`` range in place of the per-verb ranges, with
    tracing off: the engine opens it through ``annotate``."""
    pdf = _frame()
    for stream in (True, False):
        eng = TorchExecutionEngine(device="cpu", conf={"fugue.tpu.stream.chunk_rows": CHUNK})
        dag = FugueWorkflow()
        (dag.df(_stream(PORT, pdf, CHUNK) if stream else pdf).filter(PORT.col("v") > 0.25)
         .select(PORT.col("k"), (PORT.col("v") * PORT.col("w")).alias("z")).partition_by("k")
         .aggregate(PORT.ff.sum(PORT.col("z")).alias("s")).yield_dataframe_as("r", as_local=True))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            dag.run(eng)
        counts = {e.key: e.count for e in prof.key_averages()}
        assert counts.get("plan.segment") == 1
        assert not {"engine.fused", "fugue::filter", "fugue::project"} & set(counts)


def test_conf_gate_off_keeps_per_verb_plan():
    pdf = _frame()
    eng = TorchExecutionEngine(device="cpu", conf={LOWER: False})
    dag = FugueWorkflow()
    (dag.df(pdf).filter(PORT.col("v") > 0.25).partition_by("k").aggregate(PORT.ff.sum(PORT.col("v")).alias("s"))
     .yield_dataframe_as("r", as_local=True))
    dag.run(eng)
    assert dag.last_plan_report.segments_lowered == 0
    st = eng.plan_stats.as_dict()
    assert st["segments_lowered"] == st["segments_executed"] == 0


def test_explain_renders_segment():
    pdf = _frame()
    dag = FugueWorkflow()
    (dag.df(pdf).filter(PORT.col("v") > 0.5).select(PORT.col("k"), PORT.col("v")).partition_by("k")
     .aggregate(PORT.ff.sum(PORT.col("v")).alias("sv")).yield_dataframe_as("r", as_local=True))
    text = dag.explain()
    assert "lowered segment" in text and "segments_lowered=1" in text
    assert "lowered segment" not in dag.explain(conf={LOWER: False})


def test_plan_stats_reset_contract():
    pdf = _frame(n=2000)
    eng = TorchExecutionEngine(device="cpu")
    dag = FugueWorkflow()
    (dag.df(pdf).filter(PORT.col("v") > 0.5).partition_by("k").aggregate(PORT.ff.sum(PORT.col("v")).alias("s"))
     .yield_dataframe_as("r", as_local=True))
    dag.run(eng)
    st = eng.plan_stats.as_dict()
    assert st["segments_lowered"] == 1 and st["verbs_absorbed"] >= 2
    assert st["segments_executed"] + st["segments_fallback"] == 1
    eng.plan_stats.reset()
    st = eng.plan_stats.as_dict()
    assert st["segments_lowered"] == 0 and st["segments_executed"] == 0


# ---- the raw-chunk contract ---------------------------------------------------------


def test_lowered_stream_key_range_reads_the_raw_chunks():
    """The lowered stream probes its key range on the RAW first chunk, and
    a later raw key outside it raises, even where the chain's filter
    would drop that row; the per-verb path filters first and answers.
    The reference does the same (``jax/streaming.py`` :767-770)."""
    pdf = _frame(n=4 * CHUNK, groups=8)
    pdf.loc[3 * CHUNK, ["k", "v"]] = [1000, 0.0]

    def build(dag, m):
        (dag.df(_stream(m, pdf, CHUNK)).filter(m.col("v") > 0.25).select(m.col("k"), m.col("v"))
         .partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True))

    conf = {"fugue.tpu.stream.chunk_rows": CHUNK}
    for m in (PORT, REF):
        with pytest.raises(Exception, match="outside range") as err:
            run_case(build, m, "device", conf)
        assert type(err.value).__name__ == FugueInvalidOperation.__name__
    got, _, _, _ = run_case(build, PORT, "device", {**conf, LOWER: False})
    exp = pdf[pdf.v > 0.25].groupby("k", as_index=False).agg(s=("v", "sum"))
    assert got.sort_values("k")["k"].tolist() == exp["k"].tolist()
    # a declared range covers the stream: lowered, the filter's answer
    got, _, st, _ = run_case(build, PORT, "device", {**conf, "fugue.tpu.stream.key_range": "0,1000"})
    assert st["segments_executed"] == 1
    same_frames(got.sort_values("k").reset_index(drop=True), exp)


def test_null_in_an_int_column_runs_that_chunk_per_verb():
    """A lowered take over a stream whose one chunk holds a NULL in an int
    column: that chunk runs the chain per verb, counted in
    ``plan_stats.chunks_per_verb``; the answer is the reference's."""
    pdf = _frame(n=4 * CHUNK)
    pdf["i"] = pd.array(np.arange(len(pdf)), dtype="Int64")
    pdf.loc[5, "i"] = None

    def build(dag, m):
        (dag.df(_stream(m, pdf, CHUNK)).filter(m.col("v") > 0.5).select(m.col("k"), m.col("i"), m.col("v"))
         .take(7, presort="v desc").yield_dataframe_as("r", as_local=True))

    conf = {"fugue.tpu.stream.chunk_rows": CHUNK}
    got, _, st, _ = run_case(build, PORT, "device", conf)
    exp, _, jst, _ = run_case(build, REF, "device", conf)
    same_frames(got, exp, ["v"])
    assert st["segments_executed"] == jst["segments_executed"] == 1
    assert st["chunks_per_verb"] == 1


# ---- chip_smoke.py's plan_path phase, at small size -----------------------------

# the phase with the torch.cuda calls it makes as no-ops, in a process of
# its own that loads no JAX, as chip_smoke.py runs on the card
_PLAN_PATH_ON_THE_CPU = """
import json, sys, numpy as np, pandas as pd, pyarrow as pa, torch
import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
out = chip_smoke.phase_plan_path(torch, np, pd, pa, bg, api, ff, col, TorchExecutionEngine(device="cpu"), 0,
                                 rows=40_000, stream_rows=40_000, stream_chunk=8_000)
print("RESULT", json.dumps({c: [r.get("plan"), r["launches"]] for c, r in out["cells"].items()}))
print("JAX", "jax" in sys.modules or "fugue_tpu" in sys.modules)
"""


@pytest.mark.parametrize("lower", [True, False], ids=["lowered", "per_verb"])
def test_workflow_run_keeps_no_input_column_alive(lower):
    """ROADMAP.md C18: a run of filter → select → aggregate over a persisted
    frame, lowered or per verb, leaves no reference cycle holding the
    frame's columns: with the GC off they free when the caller drops the
    frame (``chip_smoke.py``'s ``stream-lowered-f32`` reads the card's
    peak right after ``lowered-uniform-1k`` drops its 1.6 GB frame)."""
    import gc
    import weakref

    from fugue_tpu_torch.column import col, functions as ff

    eng = TorchExecutionEngine(device="cpu")
    pdf = _frame(n=4096)
    enabled = gc.isenabled()
    gc.disable()
    try:
        tdf = eng.persist(eng.to_df(pdf))
        alive = [weakref.ref(t) for t in tdf.device_cols.values()]
        assert alive
        dag = FugueWorkflow({LOWER: lower})
        (dag.df(tdf).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
         .partition_by("k").aggregate(s=ff.sum(col("z")), n=ff.count(col("z"))).yield_dataframe_as("r"))
        dag.run(eng)
        got = dag.yields["r"].result.as_pandas()
        assert eng.plan_stats.as_dict()["segments_executed"] == (1 if lower else 0)
        keep = pdf[pdf.v > 0.25]
        assert sorted(got.k) == sorted(keep.k.unique()) and got.n.sum() == len(keep)
        del dag, tdf
        assert [r() for r in alive] == [None] * len(alive)
    finally:
        if enabled:
            gc.enable()


def _unsigned_frame(dt: Any, n: int = 20_000, seed: int = 0) -> pd.DataFrame:
    """``k`` over 32 keys and ``u`` at the top of the type, both of ``dt``."""
    pdf = _frame(n, seed=seed)
    pdf["k"] = pdf["k"].astype(dt)
    top = int(np.iinfo(dt).max)
    pdf["u"] = (np.uint64(top - 6) + (np.arange(n) % 7).astype(np.uint64)).astype(dt)
    return pdf


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("dt", [np.uint16, np.uint32, np.uint64])
def test_unsigned_chains_lower(dt, stream):
    """A chain over unsigned columns lowers where the reference's does:
    a streamed chain keyed by a uint16/32/64 column (its raw chunks staged
    in the frame's storage), and a plain unsigned SUM/AVG, which wraps in
    its type and finishes on the host as the in-memory aggregate does;
    MIN/MAX of the unsigned value at the top of its type. One segment
    executed, none fallen back, the reference's counts and results."""
    pdf = _unsigned_frame(dt)
    aggs = {
        "sum": lambda m, c: [m.ff.sum(c("u")).alias("s"), m.ff.avg(c("u")).alias("m"),
                             m.ff.sum(c("z")).alias("sz"), m.ff.count(c("z")).alias("n")],
        "minmax": lambda m, c: [m.ff.min(c("u")).alias("lo"), m.ff.max(c("u")).alias("hi")],
    }
    for name, make in aggs.items():

        def build(dag, m):
            src = _stream(m, pdf, CHUNK) if stream else pdf
            c = m.col
            (dag.df(src).filter(c("v") > 0.25).select(c("k"), (c("v") * c("w")).alias("z"), c("u"))
             .partition_by("k").aggregate(*make(m, c)).yield_dataframe_as("r", as_local=True))

        st, jst = _three(build, ["k"])
        assert {c: st[c] for c in _STATS} == {c: jst[c] for c in _STATS}, name
        assert st["segments_executed"] == 1 and st["segments_fallback"] == 0, name


def test_streamed_uint64_keys_across_two_to_the_63():
    """uint64 keys on both sides of 2**63 key a lowered stream in their
    storage (the reference's streamed plan reads them as float64,
    ROADMAP.md C16, so pandas is the oracle here): the same groups, counts
    and sums as pandas, one segment."""
    pdf = _unsigned_frame(np.uint64)
    pdf["k"] = np.uint64((1 << 63) - 16) + pdf["k"].to_numpy()
    conf = {"fugue.tpu.stream.chunk_rows": CHUNK}

    def build(dag, m):
        c = m.col
        (dag.df(_stream(m, pdf, CHUNK)).filter(c("v") > 0.25).select(c("k"), (c("v") * c("w")).alias("z"), c("u"))
         .partition_by("k").aggregate(m.ff.sum(c("z")).alias("s"), m.ff.count(c("z")).alias("n"),
                                      m.ff.max(c("u")).alias("hi"))
         .yield_dataframe_as("r", as_local=True))

    got, _, st, _ = run_case(build, PORT, "device", conf)
    keep = pdf[pdf["v"] > 0.25].assign(z=lambda d: d["v"] * d["w"])
    exp = keep.groupby("k", as_index=False).agg(s=("z", "sum"), n=("z", "size"), hi=("u", "max"))
    got = got.sort_values("k").reset_index(drop=True)
    assert got["k"].tolist() == exp["k"].tolist() and got["n"].tolist() == exp["n"].tolist()
    assert got["hi"].tolist() == exp["hi"].tolist() and np.allclose(got["s"], exp["s"])
    assert int(got["k"].min()) < (1 << 63) <= int(got["k"].max())
    assert st["segments_executed"] == 1 and st["segments_fallback"] == 0


def test_streamed_unsigned_take_lowers():
    """A lowered chain feeding a take over a uint64 stream: the survivors
    come back from the storage to their values."""
    pdf = _unsigned_frame(np.uint64)

    def build(dag, m):
        c = m.col
        (dag.df(_stream(m, pdf, CHUNK)).filter(c("v") > 0.5).select(c("k"), c("u"), c("v"))
         .take(7, presort="v desc").yield_dataframe_as("r", as_local=True))

    st, jst = _three(build, ["v"])
    assert st["segments_executed"] == jst["segments_executed"] == 1


def test_chip_smoke_plan_path_on_the_cpu():
    """The phase's four cells pass their oracles and twins at small size:
    one lowered segment executed for each chain cell, none for the SQL
    one, no binned-sum launch on the CPU, and no JAX loaded."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _PLAN_PATH_ON_THE_CPU], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines() if line.startswith(("RESULT", "JAX")))
    cells = json.loads(lines["RESULT"])
    zero = {"bin_sum": 0, "bin_sum_count": 0}
    lowered = {"pushdowns": 0, "prunes": 0, "fusions": 2, "segments_lowered": 1, "segments_executed": 1,
               "segments_fallback": 0}
    assert cells == {
        "lowered-uniform-1k": [lowered, zero],
        "stream-lowered-f32": [lowered, zero],
        "unsigned-keys": [None, zero],
        "sql-dialect": [dict(lowered, fusions=0, segments_lowered=0, segments_executed=0), zero],
    }
    assert lines["JAX"] == "False"
