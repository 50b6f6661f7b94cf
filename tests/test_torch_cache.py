"""The port's result cache (``fugue_tpu_torch/cache``) against the JAX
package's (``fugue_tpu/cache``).

Each case of ``tests/cache/test_result_cache.py`` runs through both
packages on the same numpy-seeded frames: ``TorchExecutionEngine(device=
"cpu")`` beside ``JaxExecutionEngine`` (the 8-device CPU mesh), and the two
native engines where the reference uses its native engine. Each package
keeps the reference's assertions (hits, skips, refusals, invalidations,
durability, counters), and the port's result equals the JAX engine's:
keys and counts exact, floats within ``rtol=1e-9`` (both sum float64
inputs), for cold, warm (memory and disk) and cache-off runs alike.

Left out of the reference's cases: ``test_disabled_overhead_under_2_percent``,
a wall-time bound, which the card phase ``cache_path`` of ``chip_smoke.py``
measures instead (a CPU test asserts on no wall time).

Added: a cache directory shared by both packages serves neither the
other's artifacts (the fingerprint holds the engine's class), the memory
tier counts a ``TorchDataFrame``'s bytes, the plan holds no frame longer
than the LRU does, only the engine's ``fugue.tpu.cache.enabled`` turns
the cache off (a workflow's conf does not, in either package), the reason strings of refused
fingerprints, the keys of ``engine.stats()["cache"]``, and
``chip_smoke.phase_cache_path`` at small size on the CPU.
"""

import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import types
import weakref

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import fugue_tpu.column as jcolumn
from fugue_tpu import FugueWorkflow as JFugueWorkflow
from fugue_tpu.cache import clean_cache_dir as jclean_cache_dir
from fugue_tpu.cache import non_deterministic as jnon_deterministic
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
from fugue_tpu.exceptions import FugueWorkflowError as JFugueWorkflowError
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu.obs import get_tracer as jget_tracer

import fugue_tpu_torch.column as tcolumn
from fugue_tpu_torch.cache import ResultCache, clean_cache_dir, estimate_df_bytes, non_deterministic
from fugue_tpu_torch.cache.fingerprint import fingerprint_tasks
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
from fugue_tpu_torch.exceptions import FugueWorkflowError
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.obs import get_tracer
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

DIR = "fugue.tpu.cache.dir"
ENABLED = "fugue.tpu.cache.enabled"
SALT = "fugue.tpu.cache.salt"
OPT = "fugue.tpu.plan.optimize"
CHUNK = "fugue.tpu.stream.chunk_rows"
CHECKPOINT = "fugue.workflow.checkpoint.path"
RTOL = 1e-9

REF = types.SimpleNamespace(
    name="ref", col=jcolumn.col, ff=jcolumn.functions, Workflow=JFugueWorkflow,
    engine=JaxExecutionEngine, native=JNativeExecutionEngine, Stream=JStream,
    Arrow=JArrowDataFrame, non_deterministic=jnon_deterministic, tracer=jget_tracer,
    WorkflowError=JFugueWorkflowError, clean=jclean_cache_dir,
)
PORT = types.SimpleNamespace(
    name="port", col=tcolumn.col, ff=tcolumn.functions, Workflow=FugueWorkflow,
    engine=lambda conf=None: TorchExecutionEngine(device="cpu", conf=conf),
    native=NativeExecutionEngine, Stream=LocalDataFrameIterableDataFrame, Arrow=ArrowDataFrame,
    non_deterministic=non_deterministic, tracer=get_tracer, WorkflowError=FugueWorkflowError,
    clean=clean_cache_dir,
)
PKGS = (PORT, REF)


def _frame(n=3000, seed=0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame(
        {
            "k": rng.integers(0, 16, n),
            "v": rng.random(n),
            "w": rng.random(n),
            "s": rng.choice(["a", "b", "c", None], n),
        }
    )


def _stream(m, pdf: pd.DataFrame, step: int = 512):
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)
    return m.Stream(
        (m.Arrow(tbl.slice(s, min(step, tbl.num_rows - s))) for s in range(0, tbl.num_rows, step)),
        schema=m.Arrow(tbl).schema,
    )


def _run(m, build, conf, native=False, engine=None, sort=None):
    eng = engine if engine is not None else (m.native(conf) if native else m.engine(conf))
    dag = m.Workflow()
    build(dag, m)
    dag.run(eng)
    res = dag.yields["r"].result.as_pandas()
    if sort:
        res = res.sort_values(sort).reset_index(drop=True)
    return res, eng, dag


def _stats(eng):
    return eng.stats()["cache"]


def _same(got: pd.DataFrame, exp: pd.DataFrame, sort=None) -> None:
    """The port's frame equals the reference's: the same columns and rows,
    keys, counts and strings exact, floats within ``RTOL``, NULLs where
    the reference has them."""
    assert list(got.columns) == list(exp.columns)
    assert len(got) == len(exp)
    if sort:
        got = got.sort_values(sort).reset_index(drop=True)
        exp = exp.sort_values(sort).reset_index(drop=True)
    for c in exp.columns:
        g, e = got[c], exp[c]
        assert (g.isna().to_numpy() == e.isna().to_numpy()).all(), c
        ok = ~e.isna().to_numpy()
        gv, ev = g.to_numpy()[ok], e.to_numpy()[ok]
        if e.dtype.kind == "f":
            assert np.allclose(gv.astype(float), ev.astype(float), rtol=RTOL, atol=0), c
        else:
            assert [*map(str, gv)] == [*map(str, ev)], c


def _both(case, tmp_path, sort=None):
    """``case(m, dir)`` for the port and the reference, each in its own
    directory; the frames it returns are held equal pairwise."""
    outs = {}
    for m in PKGS:
        d = tmp_path / m.name
        d.mkdir()
        outs[m.name] = case(m, d)
    for got, exp in zip(outs["port"], outs["ref"]):
        _same(got, exp, sort)
    return outs


# ---- bit-identical parity: warm hit == cold run == cache-off run -------------------


def _parity_case(build, tmp_path, sort=None, native=False):
    """cold (publishes) -> warm on a FRESH engine (disk hit) -> the run
    with the cache off; all three equal, optimizer on and off, and the
    port's equal to the reference's."""

    def case(m, d):
        outs = []
        for opt in (True, False):
            conf = {DIR: str(d / f"cache_opt_{opt}"), OPT: opt}
            cold, _, _ = _run(m, build, conf, native, sort=sort)
            warm, we, _ = _run(m, build, conf, native, sort=sort)
            ref, _, _ = _run(m, build, {**conf, ENABLED: False}, native, sort=sort)
            assert _stats(we)["hits_disk"] >= 1, _stats(we)
            pd.testing.assert_frame_equal(cold, warm)
            pd.testing.assert_frame_equal(warm, ref)
            outs += [cold, warm]
        return outs

    _both(case, tmp_path)


def test_parity_aggregate(tmp_path):
    pdf = _frame()

    def build(dag, m):
        (dag.df(pdf).partition_by("k")
         .aggregate(m.ff.sum(m.col("v")).alias("s"), m.ff.count(m.col("v")).alias("n"))
         .yield_dataframe_as("r", as_local=True))

    _parity_case(build, tmp_path, sort=["k"])


def test_parity_filter_select(tmp_path):
    pdf = _frame()

    def build(dag, m):
        (dag.df(pdf).filter(m.col("v") > 0.4)
         .select(m.col("k"), m.col("v"), (m.col("v") * 2).alias("v2"))
         .yield_dataframe_as("r", as_local=True))

    _parity_case(build, tmp_path)


def test_parity_join(tmp_path):
    left = _frame(800, seed=1)
    right = pd.DataFrame({"k": np.arange(16), "label": [f"g{i}" for i in range(16)]})

    def build(dag, m):
        dag.df(left).join(dag.df(right), how="inner", on=["k"]).yield_dataframe_as("r", as_local=True)

    _parity_case(build, tmp_path, sort=["k", "v"])


# schema: *,v2:double
def _demean(df: pd.DataFrame) -> pd.DataFrame:
    return df.assign(v2=df["v"] - df["v"].mean())


def test_parity_transform_udf(tmp_path):
    pdf = _frame(1000, seed=2)

    def build(dag, m):
        dag.df(pdf).partition_by("k").transform(_demean).yield_dataframe_as("r", as_local=True)

    _parity_case(build, tmp_path, sort=["k", "v"])


def test_parity_sql(tmp_path):
    pdf = _frame(1200, seed=3)

    def build(dag, m):
        dag.select("SELECT k, SUM(v) AS s FROM", dag.df(pdf), "GROUP BY k").yield_dataframe_as(
            "r", as_local=True)

    _parity_case(build, tmp_path, sort=["k"])


def test_parity_native_engine(tmp_path):
    pdf = _frame(700, seed=4)

    def build(dag, m):
        (dag.df(pdf).partition_by("k").aggregate(m.ff.avg(m.col("w")).alias("m"))
         .yield_dataframe_as("r", as_local=True))

    _parity_case(build, tmp_path, sort=["k"], native=True)


def test_streaming_input_refuses_but_downstream_parity(tmp_path):
    """A one-pass stream poisons its subtree: both runs recompute, with
    equal results, and the refusal is counted."""
    pdf = _frame(2000, seed=5)

    def case(m, d):
        def build(dag, m):
            (dag.df(_stream(m, pdf)).partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s"))
             .yield_dataframe_as("r", as_local=True))

        # serial streams: the JAX engine's prefetch thread beside its
        # donated accumulator has aborted a loaded xdist worker
        conf = {DIR: str(d / "cache_stream"), CHUNK: 512, "fugue.tpu.stream.prefetch_depth": 0}
        cold, _, _ = _run(m, build, conf, sort=["k"])
        warm, we, _ = _run(m, build, conf, sort=["k"])
        pd.testing.assert_frame_equal(cold, warm)
        assert _stats(we)["hits_disk"] == 0 and _stats(we)["refusals"] >= 1
        return [cold]

    _both(case, tmp_path)


# ---- the frontier cut: producers upstream of a hit never run -----------------------


def test_warm_run_skips_producers_zero_spans(tmp_path):
    """The warm run records no engine verb and no ``workflow.task`` span
    of the skipped producers, and ``bytes_skipped`` covers >= 90% of the
    source file."""
    src = str(tmp_path / "src.parquet")
    rng = np.random.default_rng(7)
    n = 50_000
    pq.write_table(pa.table({"k": rng.integers(0, 32, n), "v": rng.random(n),
                             **{f"x{i}": rng.random(n) for i in range(6)}}), src)

    def case(m, d):
        def build(dag, m):
            (dag.load(src).filter(m.col("v") > 0.25).partition_by("k")
             .aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True))

        conf = {DIR: str(d / "cache")}
        cold, _, _ = _run(m, build, conf, sort=["k"])
        tr = m.tracer()
        was = tr.enabled
        tr.enable()
        tr.clear()
        try:
            warm, we, dag = _run(m, build, conf, sort=["k"])
            names = [r["name"] for r in tr.records()]
        finally:
            if not was:
                tr.disable()
            tr.clear()
        pd.testing.assert_frame_equal(cold, warm)
        producer = [x for x in names if x in ("engine.filter", "engine.aggregate", "stream.chunk")
                    or x.startswith("engine.load") or x == "plan.segment"]
        assert producer == [], names
        assert names.count("workflow.task") == 1, names
        assert "cache.lookup" in names and "task.cache_hit" in names, names
        st = _stats(we)
        assert st["tasks_skipped"] >= 1 and st["bytes_skipped"] >= 0.9 * os.path.getsize(src)
        assert dag.last_cache_plan.summary()["executes"] == 0
        return [cold, warm]

    _both(case, tmp_path)


def test_skipped_interior_result_raises_descriptive(tmp_path):
    pdf = _frame(500, seed=8)

    def case(m, d):
        conf = {DIR: str(d / "cache"), "fugue.tpu.plan.lower_segments": False}

        def run_once():
            dag = m.Workflow()
            mid = dag.df(pdf).filter(m.col("v") > 0.5)
            mid.partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as(
                "r", as_local=True)
            dag.run(m.engine(conf))
            return dag, mid

        run_once()
        dag, mid = run_once()  # warm: create and filter skipped
        with pytest.raises(m.WorkflowError, match="result-cache"):
            _ = mid.result
        return [dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True)]

    _both(case, tmp_path)


def test_explain_renders_cut_points(tmp_path):
    pdf = _frame(400, seed=9)

    def case(m, d):
        def build(dag, m):
            (dag.df(pdf).filter(m.col("v") > 0.1).partition_by("k")
             .aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True))

        res, eng, _ = _run(m, build, {DIR: str(d / "cache")}, sort=["k"])
        dag = m.Workflow()
        build(dag, m)
        text = dag.explain(engine=eng)
        assert "result cache" in text and "HIT[" in text
        assert "skipped (downstream hit cuts the plan here)" in text
        cut = [ln for ln in text.splitlines() if ln.startswith("== result cache")]
        assert len(cut) == 1
        return [res]

    outs = {}
    for m in PKGS:
        (tmp_path / m.name).mkdir()
        outs[m.name] = case(m, tmp_path / m.name)
    _same(outs["port"][0], outs["ref"][0])


# ---- invalidation -----------------------------------------------------------------


def test_mutated_load_file_invalidates(tmp_path):
    def case(m, d):
        src = str(d / "src.parquet")
        conf = {DIR: str(d / "cache")}

        def write(seed):
            rng = np.random.default_rng(seed)
            pq.write_table(pa.table({"k": rng.integers(0, 8, 2000), "v": rng.random(2000)}), src)

        def build(dag, m):
            (dag.load(src).partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s"))
             .yield_dataframe_as("r", as_local=True))

        write(0)
        r1, _, _ = _run(m, build, conf, sort=["k"])
        time.sleep(0.01)  # a distinct mtime even on coarse file systems
        write(1)
        r2, e2, _ = _run(m, build, conf, sort=["k"])
        assert _stats(e2)["hits_disk"] == 0 and not r1.equals(r2)
        ref, _, _ = _run(m, build, {**conf, ENABLED: False}, sort=["k"])
        pd.testing.assert_frame_equal(r2, ref)
        return [r1, r2]

    _both(case, tmp_path)


def _exec_udf(name: str, body: str):
    ns = {"pd": pd}
    exec(f"def {name}(df: pd.DataFrame) -> pd.DataFrame:\n    return {body}\n", ns)
    return ns[name]


def test_edited_udf_source_invalidates(tmp_path):
    """Two UDFs of one name and module with other bodies never share a
    fingerprint."""
    pdf = _frame(600, seed=10)

    def case(m, d):
        conf = {DIR: str(d / "cache")}

        def build_with(udf):
            return lambda dag, m: (dag.df(pdf).partition_by("k").transform(udf, schema="*")
                                   .yield_dataframe_as("r", as_local=True))

        r1, _, _ = _run(m, build_with(_exec_udf("bump", "df.assign(v=df['v'] + 1.0)")), conf,
                        sort=["k", "v"])
        r1b, e1b, d1b = _run(m, build_with(_exec_udf("bump", "df.assign(v=df['v'] + 1.0)")), conf,
                             sort=["k", "v"])
        assert _stats(e1b)["hits_disk"] >= 1 and d1b.last_cache_plan.summary()["executes"] == 0
        pd.testing.assert_frame_equal(r1, r1b)
        r2, _, d2 = _run(m, build_with(_exec_udf("bump", "df.assign(v=df['v'] + 2.0)")), conf,
                         sort=["k", "v"])
        assert d2.last_cache_plan.summary()["executes"] >= 1 and not r1.equals(r2)
        return [r1, r2]

    _both(case, tmp_path)


def test_closure_value_differentiates_udfs(tmp_path):
    pdf = _frame(400, seed=11)

    def make(offset):
        # schema: *
        def shift(df: pd.DataFrame) -> pd.DataFrame:
            return df.assign(v=df["v"] + offset)

        return shift

    def case(m, d):
        conf = {DIR: str(d / "cache")}

        def build_with(udf):
            return lambda dag, m: dag.df(pdf).transform(udf, schema="*").yield_dataframe_as(
                "r", as_local=True)

        r1, _, _ = _run(m, build_with(make(1.0)), conf, sort=["k", "v"])
        r2, _, d2 = _run(m, build_with(make(5.0)), conf, sort=["k", "v"])
        assert d2.last_cache_plan.summary()["executes"] >= 1 and not r1.equals(r2)
        return [r1, r2]

    _both(case, tmp_path)


def test_partition_spec_and_salt_invalidate(tmp_path):
    pdf = _frame(500, seed=12)

    def case(m, d):
        def build_by(key):
            return lambda dag, m: (dag.df(pdf).partition_by(key)
                                   .aggregate(m.ff.count(m.col("v")).alias("n"))
                                   .yield_dataframe_as("r", as_local=True))

        conf = {DIR: str(d / "cache")}
        r1, _, _ = _run(m, build_by("k"), conf, sort=["k"])
        _, _, d2 = _run(m, build_by("s"), conf)  # another PartitionSpec: miss
        assert d2.last_cache_plan.summary()["executes"] >= 1
        r3, e3, d3 = _run(m, build_by("k"), conf, sort=["k"])  # the same spec: hit
        assert _stats(e3)["hits_disk"] >= 1 and d3.last_cache_plan.summary()["executes"] == 0
        _, e4, _ = _run(m, build_by("k"), {**conf, SALT: "v2"})  # a new salt misses all
        assert _stats(e4)["hits_disk"] == 0
        return [r1, r3]

    _both(case, tmp_path)


def test_optimizer_setting_stability(tmp_path):
    """Fingerprints are of the optimized plan: the same setting twice
    hits; the optimizer toggled misses safely, with equal results."""
    pdf = _frame(900, seed=13)

    def case(m, d):
        def build(dag, m):
            (dag.df(pdf).filter(m.col("v") > 0.3).select(m.col("k"), m.col("v")).partition_by("k")
             .aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True))

        on = {DIR: str(d / "cache"), OPT: True}
        r_on, _, _ = _run(m, build, on, sort=["k"])
        r_on2, e2, _ = _run(m, build, on, sort=["k"])
        assert _stats(e2)["hits_disk"] >= 1
        r_off, _, _ = _run(m, build, {**on, OPT: False}, sort=["k"])
        pd.testing.assert_frame_equal(r_on, r_on2)
        pd.testing.assert_frame_equal(r_on, r_off)
        return [r_on]

    _both(case, tmp_path)


# ---- refusal (poisoning) ----------------------------------------------------------


def test_non_deterministic_marker_poisons_subtree(tmp_path):
    pdf = _frame(300, seed=14)

    def case(m, d):
        calls = {"n": 0}

        @m.non_deterministic
        def jitter(df: pd.DataFrame) -> pd.DataFrame:
            calls["n"] += 1
            return df.assign(v=df["v"] + 0.0)

        def build(dag, m):
            (dag.df(pdf).transform(jitter, schema="*").partition_by("k")
             .aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True))

        conf = {DIR: str(d / "cache")}
        r1, _, _ = _run(m, build, conf, sort=["k"])
        _, e2, d2 = _run(m, build, conf)
        assert calls["n"] >= 2
        assert _stats(e2)["refusals"] >= 2 and d2.last_cache_plan.summary()["executes"] >= 2
        return [r1]

    _both(case, tmp_path)


def test_seedless_sample_refuses(tmp_path):
    pdf = _frame(500, seed=15)

    def case(m, d):
        conf = {DIR: str(d / "cache")}
        _run(m, lambda dag, m: dag.df(pdf).sample(frac=0.5).yield_dataframe_as("r", as_local=True), conf)
        _, e2, d2 = _run(m, lambda dag, m: dag.df(pdf).sample(frac=0.5).yield_dataframe_as(
            "r", as_local=True), conf)
        assert d2.last_cache_plan.summary()["executes"] >= 1 and _stats(e2)["refusals"] >= 1

        def seeded(dag, m):
            dag.df(pdf).sample(frac=0.5, seed=42).yield_dataframe_as("r", as_local=True)

        r1, _, _ = _run(m, seeded, conf)
        r2, e4, d4 = _run(m, seeded, conf)
        assert _stats(e4)["hits_disk"] >= 1 and d4.last_cache_plan.summary()["executes"] == 0
        pd.testing.assert_frame_equal(r1, r2)
        return [r1]

    _both(case, tmp_path)


# ---- durability ---------------------------------------------------------------------


def test_persist_survives_engine_restart(tmp_path):
    """A persist() publishes to the artifact store, so a fresh engine (a
    new process) serves it without computing."""
    pdf = _frame(800, seed=16)

    def case(m, d):
        def build(dag, m):
            (dag.df(pdf).filter(m.col("v") > 0.2).persist().partition_by("k")
             .aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True))

        conf = {DIR: str(d / "cache")}
        r1, _, _ = _run(m, build, conf, sort=["k"])
        r2, e2, _ = _run(m, build, conf, sort=["k"])
        assert _stats(e2)["hits_disk"] >= 1
        pd.testing.assert_frame_equal(r1, r2)
        return [r1, r2]

    _both(case, tmp_path)


def test_strong_checkpoint_single_artifact_two_indexes(tmp_path):
    """A deterministic checkpoint's file is indexed by the cache (a ref),
    never copied."""
    pdf = _frame(600, seed=17)

    def case(m, d):
        cache, cp = str(d / "cache"), str(d / "checkpoints")
        conf = {DIR: cache, CHECKPOINT: cp}

        def build(dag, m):
            (dag.df(pdf).filter(m.col("v") > 0.4).deterministic_checkpoint().partition_by("k")
             .aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True))

        r1, e1, _ = _run(m, build, conf, sort=["k"])
        assert _stats(e1)["links"] >= 1
        objs = os.path.join(cache, "objs")
        refs = [f for f in os.listdir(objs) if f.endswith(".ref.json")]
        assert len(refs) >= 1
        with open(os.path.join(objs, refs[0])) as f:
            target = json.load(f)["path"]
        assert os.path.dirname(os.path.abspath(target)) == os.path.abspath(cp)
        r2, _, _ = _run(m, build, conf, sort=["k"])
        pd.testing.assert_frame_equal(r1, r2)
        return [r1]

    _both(case, tmp_path)


def test_torn_artifact_falls_back_to_recompute(tmp_path):
    pdf = _frame(700, seed=18)

    def case(m, d):
        conf = {DIR: str(d / "cache")}

        def build(dag, m):
            (dag.df(pdf).partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s"))
             .yield_dataframe_as("r", as_local=True))

        r1, _, _ = _run(m, build, conf, sort=["k"])
        objs = os.path.join(conf[DIR], "objs")
        for f in os.listdir(objs):
            if f.endswith(".parquet"):
                with open(os.path.join(objs, f), "r+b") as fh:  # tear every artifact
                    fh.truncate(16)
        r2, e2, _ = _run(m, build, conf, sort=["k"])
        pd.testing.assert_frame_equal(r1, r2)
        assert _stats(e2)["hits_disk"] == 0
        r3, e3, _ = _run(m, build, conf, sort=["k"])  # republished: hits again
        assert _stats(e3)["hits_disk"] >= 1
        pd.testing.assert_frame_equal(r1, r3)
        return [r1, r3]

    _both(case, tmp_path)


_RACE = r"""
import os
import sys
import time
import numpy as np
import pandas as pd
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow

d, src, barrier, n = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
eng = NativeExecutionEngine({"fugue.tpu.cache.dir": d})
dag = FugueWorkflow()
if src == "-":
    rng = np.random.default_rng(0)  # the same data in both processes
    pdf = pd.DataFrame({"k": rng.integers(0, 8, 4000), "v": rng.random(4000)})
    (dag.df(pdf).partition_by("k").aggregate(ff.sum(col("v")).alias("s"))
     .yield_dataframe_as("r", as_local=True))
else:
    (dag.load(src, fmt="parquet").filter(col("v") > 10).partition_by("k")
     .aggregate(ff.sum(col("v")).alias("s"), ff.avg(col("v")).alias("m"))
     .yield_dataframe_as("r", as_local=True))
# every process plans at once: the race is over the same store state
open(os.path.join(barrier, f"ready_{os.getpid()}"), "w").close()
while len(os.listdir(barrier)) < n:
    time.sleep(0.0005)
dag.run(eng)
out = dag.yields["r"].result.as_pandas().sort_values("k")
print(repr((out.values.tolist(), eng.stats()["cache"]["partial_hits"])))
"""


def _race(d: str, src: str = "-", n: int = 2):
    """``n`` processes of the port, started together, running one DAG
    over one cache directory (a fresh interpreter each, with no JAX)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.getcwd(), os.environ.get("PYTHONPATH", "")]))
    barrier = tempfile.mkdtemp(prefix="race_", dir=os.path.dirname(d))
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, d, src, barrier, str(n)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(n)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(eval(out.strip().splitlines()[-1]))
    return outs


def test_concurrent_two_process_publish_race(tmp_path):
    """Two processes publishing the same fingerprints at once both
    succeed, the artifacts left are whole, and a third run hits them; the
    result is the JAX native engine's."""
    d = str(tmp_path / "cache")
    (r1, _), (r2, _) = _race(d)
    assert r1 == r2
    ((warm, _),) = _race(d, n=1)
    assert warm == r1
    eng = NativeExecutionEngine({DIR: d})
    objs = os.listdir(os.path.join(d, "objs"))
    assert any(f.endswith(".parquet") for f in objs)
    for f in objs:
        if f.endswith(".parquet"):
            assert eng.result_cache.disk.load(f[: -len(".parquet")], eng) is not None
    rng = np.random.default_rng(0)
    pdf = pd.DataFrame({"k": rng.integers(0, 8, 4000), "v": rng.random(4000)})
    exp, _, _ = _run(REF, lambda dag, m: dag.df(pdf).partition_by("k").aggregate(
        m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True), {ENABLED: False},
        native=True, sort=["k"])
    _same(pd.DataFrame(r1, columns=["k", "s"]).astype({"k": "int64"}), exp)


def test_concurrent_two_process_append_race(tmp_path):
    """Two processes warm-run one grown directory at once: both take the
    delta path, their results are equal, and the store ends with one
    whole artifact a fingerprint and no temporary file."""
    d, src = str(tmp_path / "cache"), str(tmp_path / "src")
    os.makedirs(src)

    def write_part(i):
        rng = np.random.default_rng(100 + i)
        pq.write_table(pa.table({"k": rng.integers(0, 8, 1500).astype("int64"),
                                 "v": rng.integers(0, 100, 1500).astype("float64")}),
                       os.path.join(src, f"p_{i:02d}.parquet"))

    for i in range(3):
        write_part(i)
    _race(d, src, n=1)  # publishes the manifest
    write_part(3)
    (r1, ph1), (r2, ph2) = _race(d, src)
    assert r1 == r2 and ph1 >= 1 and ph2 >= 1
    objs = os.listdir(os.path.join(d, "objs"))
    assert not any("__tmp" in f for f in objs)
    fps = [f[: -len(".parquet")] for f in objs if f.endswith(".parquet")]
    assert len(fps) == len(set(fps))
    eng = NativeExecutionEngine({DIR: d})
    for fp in fps:
        assert eng.result_cache.disk.load(fp, eng) is not None
    ((warm, ph3),) = _race(d, src, n=1)
    assert warm == r1 and ph3 == 0
    exp, _, _ = _run(REF, lambda dag, m: (
        dag.load(src, fmt="parquet").filter(m.col("v") > 10).partition_by("k")
        .aggregate(m.ff.sum(m.col("v")).alias("s"), m.ff.avg(m.col("v")).alias("m"))
        .yield_dataframe_as("r", as_local=True)), {ENABLED: False}, native=True, sort=["k"])
    _same(pd.DataFrame(r1, columns=["k", "s", "m"]).astype({"k": "int64"}), exp)


# ---- lifecycle and the path with the cache off -------------------------------------


def test_reset_stats_zeroes_counters_keeps_entries(tmp_path):
    pdf = _frame(400, seed=19)

    def case(m, d):
        def build(dag, m):
            (dag.df(pdf).partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s"))
             .yield_dataframe_as("r", as_local=True))

        r1, eng, _ = _run(m, build, {DIR: str(d / "cache")}, sort=["k"])
        assert _stats(eng)["publishes"] >= 1
        before = _stats(eng)["mem_entries"]
        eng.reset_stats()
        st = _stats(eng)
        assert st["publishes"] == 0 and st["lookups"] == 0 and st["mem_entries"] == before
        r2, _, _ = _run(m, build, None, engine=eng, sort=["k"])
        assert _stats(eng)["hits_mem"] >= 1
        return [r1, r2]

    _both(case, tmp_path)


def test_disabled_is_pre_cache_path(tmp_path):
    pdf = _frame(500, seed=20)

    def case(m, d):
        eng = m.engine({ENABLED: False, "fugue.tpu.plan.lower_segments": False})
        for _ in range(2):
            dag = m.Workflow()
            mid = dag.df(pdf).filter(m.col("v") > 0.5)
            mid.partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as(
                "r", as_local=True)
            dag.run(eng)
            interior = mid.result.as_pandas()  # interior results stay addressable
        st = _stats(eng)
        assert all(v in (0, False) for k, v in st.items() if k != "disk_enabled"), st
        assert dag.last_cache_plan is None
        return [interior.sort_values(["k", "v"]).reset_index(drop=True)]

    _both(case, tmp_path)


def test_unwritable_dir_degrades_to_memory_only(tmp_path):
    pdf = _frame(300, seed=22)

    def case(m, d):
        bad = str(d / "ro")
        with open(bad, "w") as f:  # a file where the directory would be
            f.write("not a directory")

        def build(dag, m):
            (dag.df(pdf).partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s"))
             .yield_dataframe_as("r", as_local=True))

        r1, eng, _ = _run(m, build, {DIR: bad}, native=True, sort=["k"])
        assert _stats(eng)["disk_enabled"] is False
        r2, _, _ = _run(m, build, None, engine=eng, sort=["k"])
        assert _stats(eng)["hits_mem"] >= 1
        return [r1, r2]

    _both(case, tmp_path)


def test_clean_cache_dir_helper(tmp_path):
    pdf = _frame(200, seed=23)

    def case(m, d):
        cache = str(d / "cache")
        _run(m, lambda dag, m: dag.df(pdf).partition_by("k").aggregate(
            m.ff.sum(m.col("v")).alias("s")).yield_dataframe_as("r", as_local=True),
            {DIR: cache}, native=True)
        assert any(f.endswith(".parquet") for f in os.listdir(os.path.join(cache, "objs")))
        msg = m.clean(cache)
        assert "removed" in msg and not os.path.isdir(os.path.join(cache, "objs"))
        assert "nothing cleaned" in m.clean("")
        return []

    _both(case, tmp_path)


# ---- what the port adds ------------------------------------------------------------


def test_shared_dir_serves_neither_package_the_other(tmp_path):
    """One ``fugue.tpu.cache.dir`` for both packages: each publishes its
    own artifacts (the fingerprint holds the engine's class) and hits
    only its own."""
    pdf = _frame(600, seed=24)
    conf = {DIR: str(tmp_path / "shared")}

    def build(dag, m):
        (dag.df(pdf).partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s"))
         .yield_dataframe_as("r", as_local=True))

    ref, re_, _ = _run(REF, build, conf, sort=["k"])
    assert _stats(re_)["publishes"] >= 1
    port, pe, _ = _run(PORT, build, conf, sort=["k"])
    assert _stats(pe)["hits_disk"] == 0 and _stats(pe)["publishes"] >= 1
    port2, pe2, _ = _run(PORT, build, conf, sort=["k"])
    ref2, re2, _ = _run(REF, build, conf, sort=["k"])
    assert _stats(pe2)["hits_disk"] >= 1 and _stats(re2)["hits_disk"] >= 1
    manifests = os.listdir(os.path.join(conf[DIR], "objs"))
    assert len([f for f in manifests if f.endswith(".parquet")]) >= 2
    for got, exp in ((port, ref), (port2, ref2)):
        _same(got, exp)


def test_memory_tier_counts_device_bytes(tmp_path):
    """A ``TorchDataFrame`` in the memory tier counts its device bytes
    (columns, NULL masks, validity mask) and its host columns; the
    ``result_cache_mem_bytes`` probe reads the tier."""
    from fugue_tpu_torch.obs import get_sampler
    from fugue_tpu_torch.torch import TorchDataFrame

    pdf = _frame(1000, seed=25)
    eng = PORT.engine()
    tdf = eng.to_df(pdf)
    exp = sum(t.nbytes for t in tdf.device_cols.values()) + sum(
        t.nbytes for t in tdf.null_masks.values()) + (tdf.host_table.nbytes if tdf.host_table is not None else 0)
    assert isinstance(tdf, TorchDataFrame) and tdf.device_nbytes == exp
    assert estimate_df_bytes(tdf) == exp
    masked = eng.filter(tdf, PORT.col("v") > 0.5)
    assert estimate_df_bytes(masked) == masked.device_nbytes > 0

    def build(dag, m):
        (dag.df(pdf).filter(m.col("v") > 0.5).select(m.col("k"), m.col("v"))
         .yield_dataframe_as("r", as_local=True))

    _run(PORT, build, None, engine=eng)
    mem = eng.result_cache.mem
    assert mem.entries >= 1
    assert mem.bytes == sum(nb for _, nb in mem._entries.values())
    assert all(nb == estimate_df_bytes(df) for df, nb in mem._entries.values())
    probes = eng._resource_probe_fns()
    assert probes["result_cache_mem_bytes"](eng) == float(mem.bytes)
    assert probes["result_cache_mem_entries"](eng) == float(mem.entries)
    assert get_sampler() is not None
    fresh = PORT.engine()
    assert fresh._resource_probe_fns()["result_cache_mem_bytes"](fresh) == 0.0
    assert fresh._result_cache is None  # the probe does not make the cache


def test_cache_plan_holds_no_frame_past_the_lru(tmp_path):
    """The planner's frontier frames live no longer than the LRU's: after
    ``clear()`` and the workflow dropped, a weak reference to the served
    frame is dead with the collector off (C17's kind of fault)."""
    pdf = _frame(800, seed=26)
    eng = PORT.engine()

    def build(dag, m):
        (dag.df(pdf).partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s"))
         .yield_dataframe_as("r", as_local=True))

    _run(PORT, build, None, engine=eng)
    ((frame, _),) = list(eng.result_cache.mem._entries.values())[-1:]
    ref = weakref.ref(frame)
    del frame
    res, _, dag = _run(PORT, build, None, engine=eng)
    assert _stats(eng)["hits_mem"] == 1 and dag.last_cache_plan.hits
    gc.collect()
    gc.disable()
    try:
        eng.result_cache.clear()
        dag.release_task_results()
        dag._last_context._cache_plan = None
        del dag, res
        assert ref() is None
    finally:
        gc.enable()


def test_only_the_engine_conf_turns_the_cache_off(tmp_path):
    """``fugue.tpu.cache.enabled`` is read from the engine's conf: in a
    workflow's conf over an engine whose cache is on (and made), it
    changes nothing, in both packages; in the engine's conf, nothing is
    looked up."""

    def case(m, d):
        pdf = _frame(500, seed=27)

        def run(eng, conf=None):
            dag = m.Workflow(conf)
            (dag.df(pdf).partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s"))
             .yield_dataframe_as("r", as_local=True))
            dag.run(eng)
            return dag, dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True)

        eng = m.engine({DIR: str(d / "cache")})
        _, cold = run(eng)
        dag, warm = run(eng, {ENABLED: False})
        assert _stats(eng)["hits_mem"] == 1 and dag.last_cache_plan.hits
        off = m.engine({ENABLED: False, DIR: str(d / "cache")})
        dag, plain = run(off)
        run(off)
        assert dag.last_cache_plan is None and _stats(off)["lookups"] == 0
        assert not os.listdir(d / "cache") or _stats(off)["publishes"] == 0
        return [cold, warm, plain]

    _both(case, tmp_path)


def test_refusal_reasons_are_the_reference_s(tmp_path):
    """A refused fingerprint is a miss with the reference's reason."""
    pdf = _frame(300, seed=28)

    def reasons(m, build):
        dag = m.Workflow()
        build(dag, m)
        from fugue_tpu.cache.fingerprint import fingerprint_tasks as jfingerprint_tasks

        fp = fingerprint_tasks if m is PORT else jfingerprint_tasks
        rep = fp(dag._tasks, {}, "x")
        return sorted(set(rep.reasons.values()))

    @non_deterministic
    def pj(df: pd.DataFrame) -> pd.DataFrame:
        return df

    @jnon_deterministic
    def rj(df: pd.DataFrame) -> pd.DataFrame:
        return df

    builds = [
        lambda dag, m: dag.df(_stream(m, pdf)).partition_by("k").aggregate(
            m.ff.sum(m.col("v")).alias("s")).show(),
        lambda dag, m: dag.df(pdf).sample(frac=0.5).show(),
        lambda dag, m: dag.df(pdf).transform(pj if m is PORT else rj, schema="*").show(),
        lambda dag, m: dag.load(str(tmp_path / "missing.parquet")).show(),
    ]
    for b in builds:
        got, exp = reasons(PORT, b), reasons(REF, b)
        assert got == exp and len(got) >= 2, (got, exp)
    # a device frame refuses as the reference's device frame does, by name
    eng = PORT.engine()
    dag = FugueWorkflow()
    dag.df(eng.to_df(pdf)).show()
    (reason,) = set(fingerprint_tasks(dag._tasks, {}, "x").reasons.values()) - {
        "output sink (side effects run every time)"}
    assert reason == "TorchDataFrame input (no content digest; identity-of-object is refused)"


def test_stats_keys_are_the_reference_s(tmp_path):
    pdf = _frame(300, seed=29)

    def build(dag, m):
        (dag.df(pdf).partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s"))
         .yield_dataframe_as("r", as_local=True))

    keys = {}
    for m in PKGS:
        _, eng, _ = _run(m, build, {DIR: str(tmp_path / m.name)})
        st = eng.stats()
        keys[m.name] = (sorted(st["cache"]), sorted(st["tuning"]))
    assert keys["port"] == keys["ref"]
    assert isinstance(ResultCache({}).stats.as_dict()["disk_enabled"], bool)


def test_chip_smoke_cache_path_on_the_cpu(tmp_path):
    """``chip_smoke.phase_cache_path`` at small size on the CPU, in a
    subprocess that loads no JAX, with the CUDA calls stubbed: every cell
    runs, B1's plain version stands in for the kernel, and the gates of
    the phase (hits, partitions, oracles, the twin, the tuned stream's
    chunk counts) hold. The tuner's ``MIN_WALL_S`` is set to 0 in the
    subprocess, so the stream's learning does not hang on the CPU's speed."""
    code = f"""
import sys, torch
sys.path.insert(0, {os.getcwd()!r})
import chip_smoke
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
torch.cuda.memory_allocated = lambda *a, **k: 0
import numpy as np, pandas as pd, pyarrow as pa
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine
assert "jax" not in sys.modules
pdf = chip_smoke.plan_frame(np, pd, 81_920, 0)
import fugue_tpu_torch.tuning.tuner as tuner
tuner.MIN_WALL_S = 0.0  # a CPU stream of 80 small chunks may finish under it
out = chip_smoke.phase_cache_path(torch, np, pd, pa, bg, ff, col, "cpu", pdf, 0, files=4,
                                  stream_rows=81_920, stream_chunk=1_024, tmp_root={str(tmp_path)!r})
assert out["cells"]["tuned-stream"]["chunks"] == [80, 20, 8], out["cells"]["tuned-stream"]["chunks"]
assert set(out["cells"]) == {{"cache-cold", "cache-warm-mem", "cache-warm-disk", "cache-delta",
                             "tuned-stream"}}
assert "jax" not in sys.modules
print("OK")
"""
    env = dict(os.environ, FUGUE_TPU_TUNING_PATH=str(tmp_path / "t.json"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0 and p.stdout.strip().endswith("OK"), p.stdout[-3000:] + p.stderr[-3000:]
