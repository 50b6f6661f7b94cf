"""The port's delta cache (``fugue_tpu_torch/cache/delta.py``) against the
JAX package's (``fugue_tpu/cache/delta.py``).

Each case of ``tests/cache/test_delta_cache.py`` runs through both
packages over the same numpy-seeded parquet (or csv) partitions:
``TorchExecutionEngine(device="cpu")`` beside ``JaxExecutionEngine`` (the
8-device CPU mesh), and the two native engines where the reference
parametrizes over its native engine. A source is written, run cold, grown
by a partition and run warm: each package keeps the reference's
assertions (a partial hit that recomputes only the new partitions, equal
to a run with the cache off; the refusal ladder, with its reason in
``explain()``; the store's consistency; the fallback), and the port's
result equals the JAX engine's: keys, counts, MIN/MAX and NULLs exact,
sums and averages within ``rtol=1e-9`` (the port folds partials in
float64, ROADMAP.md C2).

Every reference case applies on one card; none is left out. Added: the
delta recompute's fresh partial goes through the engine's lowered segment
(the binned-sum kernel's route on the card) over the new rows only.
"""

import json
import os
import types

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import fugue_tpu.column as jcolumn
from fugue_tpu import FugueWorkflow as JFugueWorkflow
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.jax import JaxExecutionEngine

import fugue_tpu_torch.cache.delta as delta_mod
import fugue_tpu_torch.column as tcolumn
from fugue_tpu_torch.cache.store import ArtifactStore
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame, PandasDataFrame
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.obs import validate_prometheus_text
from fugue_tpu_torch.obs.prom import to_prometheus_text
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

DIR = "fugue.tpu.cache.dir"
ENABLED = "fugue.tpu.cache.enabled"
DELTA = "fugue.tpu.cache.delta.enabled"
OPT = "fugue.tpu.plan.optimize"
RTOL = 1e-9

REF = types.SimpleNamespace(
    name="ref", col=jcolumn.col, ff=jcolumn.functions, Workflow=JFugueWorkflow,
    engine=JaxExecutionEngine, native=JNativeExecutionEngine, Stream=JStream, Arrow=JArrowDataFrame,
)
PORT = types.SimpleNamespace(
    name="port", col=tcolumn.col, ff=tcolumn.functions, Workflow=FugueWorkflow,
    engine=lambda conf=None: TorchExecutionEngine(device="cpu", conf=conf),
    native=NativeExecutionEngine, Stream=LocalDataFrameIterableDataFrame, Arrow=ArrowDataFrame,
)
PKGS = (PORT, REF)


def _write_part(src: str, i: int, n: int = 900, seed=None, lo=0, hi=12, nulls=False):
    rng = np.random.default_rng(1000 + i if seed is None else seed)
    v = rng.integers(0, 100, n).astype("float64")
    if nulls:
        v[rng.random(n) < 0.1] = np.nan
    pq.write_table(
        pa.table({"k": rng.integers(lo, hi, n).astype("int64"), "v": v,
                  "w": rng.integers(0, 50, n).astype("int64")}),
        os.path.join(src, f"part_{i:03d}.parquet"),
    )


def _src_dir(root, name="src", files=3, **kw) -> str:
    src = str(root / name)
    os.makedirs(src, exist_ok=True)
    for i in range(files):
        _write_part(src, i, **kw)
    return src


BUILDS = {
    "chain": lambda dag, m, src: (
        dag.load(src, fmt="parquet").filter(m.col("v") > 10)
        .select(m.col("k"), (m.col("v") * 2).alias("x"), m.col("w"))
        .yield_dataframe_as("r", as_local=True)),
    "filter": lambda dag, m, src: (
        dag.load(src, fmt="parquet").filter(m.col("v") > 50).yield_dataframe_as("r", as_local=True)),
    "agg": lambda dag, m, src: (
        dag.load(src, fmt="parquet").filter(m.col("v") > 10).partition_by("k")
        .aggregate(m.ff.sum(m.col("v")).alias("s"), m.ff.count(m.col("v")).alias("n"),
                   m.ff.avg(m.col("v")).alias("m"), m.ff.min(m.col("v")).alias("lo"),
                   m.ff.max(m.col("v")).alias("hi"))
        .yield_dataframe_as("r", as_local=True)),
}
SORT = {"chain": ["k", "x", "w"], "filter": ["k", "v", "w"], "agg": ["k"]}


def _run(m, build, src, conf, native=False, engine=None):
    eng = engine if engine is not None else (m.native(conf) if native else m.engine(conf))
    dag = m.Workflow()
    build(dag, m, src)
    dag.run(eng)
    return dag.yields["r"].result.as_pandas(), eng, dag


def _stats(eng):
    return eng.stats()["cache"]


def _same(got: pd.DataFrame, exp: pd.DataFrame, sort=None) -> None:
    """Equal columns and rows: keys, counts, MIN/MAX and NULLs exact,
    other floats within ``RTOL``."""
    assert list(got.columns) == list(exp.columns) and len(got) == len(exp)
    if sort:
        got = got.sort_values(sort).reset_index(drop=True)
        exp = exp.sort_values(sort).reset_index(drop=True)
    for c in exp.columns:
        g, e = got[c], exp[c]
        assert (g.isna().to_numpy() == e.isna().to_numpy()).all(), c
        ok = ~e.isna().to_numpy()
        gv, ev = g.to_numpy()[ok].astype(float), e.to_numpy()[ok].astype(float)
        if c in ("s", "m", "x"):
            assert np.allclose(gv, ev, rtol=RTOL, atol=0), c
        else:
            assert (gv == ev).all(), c


def _both(case, tmp_path, sort=None):
    outs = {}
    for m in PKGS:
        d = tmp_path / m.name
        d.mkdir()
        outs[m.name] = case(m, d)
    for got, exp in zip(outs["port"], outs["ref"]):
        _same(got, exp, sort)
    return outs


def _delta_cycle(m, build, src, conf, grow, native=False):
    """cold -> grow -> warm (a delta partial hit) -> the run with the cache
    off; warm equals it."""
    cold, _, _ = _run(m, build, src, conf, native)
    grow()
    warm, we, wdag = _run(m, build, src, conf, native)
    ref, _, _ = _run(m, build, src, {**conf, ENABLED: False}, native)
    st = _stats(we)
    assert st["partial_hits"] >= 1 and st["delta_partitions_fresh"] >= 1, st
    assert st["bytes_skipped_delta"] > 0, st
    pd.testing.assert_frame_equal(warm, ref)
    return cold, warm, we, wdag


# ---- the delta parity matrix ---------------------------------------------------------


@pytest.mark.parametrize("shape", ["chain", "filter", "agg"])
@pytest.mark.parametrize("native", [False, True], ids=["device", "native"])
@pytest.mark.parametrize("opt", [True, False])
def test_delta_parity(tmp_path, shape, native, opt):
    def case(m, d):
        src = _src_dir(d)
        conf = {DIR: str(d / "cache"), OPT: opt}
        cold, warm, _, _ = _delta_cycle(m, BUILDS[shape], src, conf, lambda: _write_part(src, 3), native)
        return [cold, warm]

    _both(case, tmp_path, SORT[shape])


@pytest.mark.parametrize("native", [False, True], ids=["device", "native"])
def test_delta_aggregate_nulls_and_new_keys(tmp_path, native):
    """NULL values (an all-NULL group's sum stays NULL, avg is sum/count)
    and keys that first appear in the new partition."""

    def case(m, d):
        src = _src_dir(d, nulls=True)
        cold, warm, _, _ = _delta_cycle(m, BUILDS["agg"], src, {DIR: str(d / "cache")},
                                        lambda: _write_part(src, 3, lo=12, hi=16, nulls=True), native)
        return [cold, warm]

    _both(case, tmp_path, ["k"])


def test_delta_multi_generation(tmp_path):
    """Two appends: the second warm run reads the manifest the first
    republished."""

    def case(m, d):
        out = []
        conf = {DIR: str(d / "cache")}
        for shape in ("chain", "agg"):
            sub = _src_dir(d, name=f"src_{shape}")
            _run(m, BUILDS[shape], sub, conf)
            _write_part(sub, 3)
            _run(m, BUILDS[shape], sub, conf)
            _write_part(sub, 4)
            warm, we, _ = _run(m, BUILDS[shape], sub, conf)
            ref, _, _ = _run(m, BUILDS[shape], sub, {**conf, ENABLED: False})
            pd.testing.assert_frame_equal(warm, ref)
            assert _stats(we)["partial_hits"] >= 1
            out.append(warm.sort_values(SORT[shape]).reset_index(drop=True))
        return out

    _both(case, tmp_path)


def test_grown_csv_single_file(tmp_path):
    """An appended csv whose prefix is unchanged: only the appended rows
    recompute."""

    def case(m, d):
        f = str(d / "data.csv")
        rng = np.random.default_rng(7)

        def append(n):
            pd.DataFrame({"k": rng.integers(0, 8, n), "v": rng.integers(0, 50, n)}).to_csv(
                f, mode="a" if os.path.exists(f) else "w", header=False, index=False)

        append(2500)

        def build(dag, m, src):
            (dag.load(src, fmt="csv", columns="k:long,v:double", header=False)
             .filter(m.col("v") > 5).partition_by("k")
             .aggregate(m.ff.sum(m.col("v")).alias("s"), m.ff.avg(m.col("v")).alias("m"))
             .yield_dataframe_as("r", as_local=True))

        cold, warm, we, _ = _delta_cycle(m, build, f, {DIR: str(d / "cache")}, lambda: append(40))
        assert _stats(we)["bytes_skipped_delta"] > 0
        return [cold, warm]

    _both(case, tmp_path, ["k"])


# ---- the refusal ladder ---------------------------------------------------------------


def _refusal_case(tmp_path, mutate, expect_reason):
    """cold -> mutate the source -> warm: no delta, the result of a run
    with the cache off, and the reason in explain()."""

    def case(m, d):
        src = _src_dir(d)
        conf = {DIR: str(d / "cache")}
        build = BUILDS["agg"]
        _run(m, build, src, conf)
        mutate(src)
        probe = m.engine(conf)
        dag = m.Workflow()
        build(dag, m, src)
        exp = dag.explain(engine=probe)
        assert expect_reason in exp, exp
        warm, we, _ = _run(m, build, src, conf, engine=probe)
        ref, _, _ = _run(m, build, src, {**conf, ENABLED: False})
        pd.testing.assert_frame_equal(warm, ref)
        st = _stats(we)
        assert st["partial_hits"] == 0 and st["delta_refusals"] >= 1, st
        return [warm]

    _both(case, tmp_path, ["k"])


def test_changed_partition_contents_refuses(tmp_path):
    _refusal_case(tmp_path, lambda src: _write_part(src, 1, seed=999),
                  "partition contents changed (not an append)")


def _write_first(src):
    rng = np.random.default_rng(5)
    pq.write_table(pa.table({"k": rng.integers(0, 12, 500).astype("int64"),
                             "v": rng.integers(0, 100, 500).astype("float64"),
                             "w": rng.integers(0, 50, 500).astype("int64")}),
                   os.path.join(src, "aaa_first.parquet"))  # sorts before part_*


def test_new_partition_sorting_before_cached_refuses(tmp_path):
    _refusal_case(tmp_path, _write_first, "partition order changed")


def test_deleted_partition_refuses(tmp_path):
    _refusal_case(tmp_path, lambda src: os.remove(os.path.join(src, "part_001.parquet")),
                  "cached partitions missing from source")


def test_non_row_local_verb_refuses_but_load_still_deltas(tmp_path):
    """A distinct has no delta form, but the LOAD under it is still
    delta-served."""

    def build(dag, m, s):
        dag.load(s, fmt="parquet").filter(m.col("v") > 10).distinct().yield_dataframe_as("r", as_local=True)

    def case(m, d):
        src = _src_dir(d)
        conf = {DIR: str(d / "cache")}
        _run(m, build, src, conf)
        _write_part(src, 3)
        probe = m.engine(conf)
        dag = m.Workflow()
        build(dag, m, src)
        exp = dag.explain(engine=probe)
        assert ("not row-local" in exp or "not incrementally maintainable" in exp) and "DELTA[" in exp, exp
        warm, we, _ = _run(m, build, src, conf, engine=probe)
        ref, _, _ = _run(m, build, src, {**conf, ENABLED: False})
        pd.testing.assert_frame_equal(warm, ref)
        st = _stats(we)
        assert st["partial_hits"] >= 1 and st["delta_partitions"] == 3
        return [warm]

    _both(case, tmp_path, ["k", "v", "w"])


def test_edited_udf_downstream_recomputes_correctly(tmp_path):
    """An edited UDF is not delta-served; the run still serves the Load's
    delta and recomputes the transform."""

    def make(mult):
        ns = {"pd": pd}
        exec(f"def scale(df: pd.DataFrame) -> pd.DataFrame:\n    return df.assign(v=df['v'] * {mult}.0)\n", ns)
        return ns["scale"]

    def build_with(udf):
        return lambda dag, m, s: dag.load(s, fmt="parquet").transform(udf, schema="*").yield_dataframe_as(
            "r", as_local=True)

    def case(m, d):
        src = _src_dir(d)
        conf = {DIR: str(d / "cache")}
        _run(m, build_with(make(2)), src, conf)
        _write_part(src, 3)
        warm, we, _ = _run(m, build_with(make(3)), src, conf)
        ref, _, _ = _run(m, build_with(make(3)), src, {**conf, ENABLED: False})
        pd.testing.assert_frame_equal(warm, ref)
        assert _stats(we)["partial_hits"] >= 1
        return [warm]

    _both(case, tmp_path, ["k", "v", "w"])


def test_stream_input_refuses_delta(tmp_path):
    pdf = pd.DataFrame({"k": np.arange(2000) % 7, "v": np.arange(2000, dtype="float64")})

    def case(m, d):
        def stream():
            tbl = pa.Table.from_pandas(pdf, preserve_index=False)
            return m.Stream((m.Arrow(tbl.slice(s, 500)) for s in range(0, 2000, 500)),
                            schema=m.Arrow(tbl).schema)

        def build(dag, m, _s):
            (dag.df(stream()).partition_by("k").aggregate(m.ff.sum(m.col("v")).alias("s"))
             .yield_dataframe_as("r", as_local=True))

        # serial streams: the JAX engine's prefetch thread beside its
        # donated accumulator has aborted a loaded xdist worker
        conf = {DIR: str(d / "cache"), "fugue.tpu.stream.prefetch_depth": 0}
        r1, _, _ = _run(m, build, None, conf)
        r2, e2, _ = _run(m, build, None, conf)
        assert _stats(e2)["partial_hits"] == 0
        r1, r2 = (r.sort_values("k").reset_index(drop=True) for r in (r1, r2))
        pd.testing.assert_frame_equal(r1, r2)
        return [r1]

    _both(case, tmp_path, ["k"])


def test_delta_disabled_conf_gate(tmp_path):
    def case(m, d):
        src = _src_dir(d)
        conf = {DIR: str(d / "cache"), DELTA: False}
        _run(m, BUILDS["agg"], src, conf)
        _write_part(src, 3)
        warm, we, _ = _run(m, BUILDS["agg"], src, conf)
        ref, _, _ = _run(m, BUILDS["agg"], src, {**conf, ENABLED: False})
        pd.testing.assert_frame_equal(warm, ref)
        st = _stats(we)
        assert st["partial_hits"] == 0 and st["manifest_publishes"] == 0
        return [warm]

    _both(case, tmp_path, ["k"])


# ---- store consistency ----------------------------------------------------------------


def test_disk_max_entries_evicts_lru(tmp_path):
    """The count cap beside the byte cap, oldest mtime first, sidecars
    included; the port's store keeps the reference store's layout."""
    from fugue_tpu.cache.store import ArtifactStore as JArtifactStore
    from fugue_tpu.dataframe import PandasDataFrame as JPandasDataFrame

    left = {}
    for name, store_cls, frame_cls, eng in (
        ("port", ArtifactStore, PandasDataFrame, NativeExecutionEngine({})),
        ("ref", JArtifactStore, JPandasDataFrame, JNativeExecutionEngine({})),
    ):
        store = store_cls(str(tmp_path / name), cap_bytes=0, cap_entries=2)
        for i, fp in enumerate(["fp_a", "fp_b", "fp_c"]):
            store.publish(fp, frame_cls(pd.DataFrame({"x": [i]}), "x:long"), eng, "x:long")
            t = 1_000_000 + i  # a fixed mtime order
            os.utime(store._obj(fp), (t, t))
        assert store.evict_to_cap() == 1
        left[name] = sorted(os.listdir(store.objs))
        assert not os.path.exists(store._meta("fp_a"))
        loaded, _ = store.load("fp_c", eng)
        assert loaded.as_array() == [[2]]
    assert left["port"] == left["ref"] == sorted(
        ["fp_b.parquet", "fp_b.meta.json", "fp_c.parquet", "fp_c.meta.json"])


def test_evicted_partition_artifact_invalidates_only_its_manifest(tmp_path):
    """One chain's partial artifact deleted: that chain recomputes whole
    (its stale manifest removes itself), the other keeps its delta."""

    def case(m, d):
        src_a, src_b = _src_dir(d, name="src_a"), _src_dir(d, name="src_b")
        cache = str(d / "cache")
        conf = {DIR: cache}
        _run(m, BUILDS["agg"], src_a, conf)
        _run(m, BUILDS["chain"], src_b, conf)
        _write_part(src_a, 3)
        _write_part(src_b, 3)
        manifests = os.path.join(cache, "manifests")
        acc = [(f, json.load(open(os.path.join(manifests, f)))) for f in os.listdir(manifests)]
        victims = [(f, mf) for f, mf in acc if mf["mode"] == "acc"]
        assert victims
        vf, vm = victims[0]
        os.remove(os.path.join(cache, "objs", vm["partial"]["artifact"] + ".parquet"))
        warm_a, ea, _ = _run(m, BUILDS["agg"], src_a, conf)
        warm_b, eb, _ = _run(m, BUILDS["chain"], src_b, conf)
        ref_a, _, _ = _run(m, BUILDS["agg"], src_a, {**conf, ENABLED: False})
        ref_b, _, _ = _run(m, BUILDS["chain"], src_b, {**conf, ENABLED: False})
        pd.testing.assert_frame_equal(warm_a, ref_a)
        pd.testing.assert_frame_equal(warm_b, ref_b)
        assert _stats(ea)["delta_refusals"] >= 1 and _stats(eb)["partial_hits"] >= 1
        m2 = json.load(open(os.path.join(manifests, vf)))
        assert len(m2["partitions"]) == 4
        assert os.path.exists(os.path.join(cache, "objs", m2["partial"]["artifact"] + ".parquet"))
        return [warm_a.sort_values("k").reset_index(drop=True)]

    _both(case, tmp_path)


def test_runtime_failure_falls_back_to_full_recompute(tmp_path, monkeypatch):
    """A delta recompute that fails mid-run recomputes from the source in
    place: no error, no wrong data."""
    import fugue_tpu.cache.delta as jdelta_mod

    def boom(engine, hit):
        raise RuntimeError("injected delta failure")

    def case(m, d):
        src = _src_dir(d)
        conf = {DIR: str(d / "cache")}
        _run(m, BUILDS["agg"], src, conf)
        _write_part(src, 3)
        mod = delta_mod if m is PORT else jdelta_mod
        with monkeypatch.context() as mp:
            mp.setattr(mod, "_load_fresh", boom)
            warm, we, _ = _run(m, BUILDS["agg"], src, conf)
        ref, _, _ = _run(m, BUILDS["agg"], src, {**conf, ENABLED: False})
        pd.testing.assert_frame_equal(warm, ref)
        assert _stats(we)["partial_hits"] >= 1
        return [warm]

    _both(case, tmp_path, ["k"])


# ---- persist, restart, observability ----------------------------------------------------


def test_persist_delta_merged_survives_restart(tmp_path):
    """A delta-merged persist() publishes the merged artifact: a later
    exact run on a fresh engine takes the whole-task hit."""

    def build(dag, m, s):
        (dag.load(s, fmt="parquet").filter(m.col("v") > 10).partition_by("k")
         .aggregate(m.ff.sum(m.col("v")).alias("s"), m.ff.avg(m.col("v")).alias("m"))
         .persist().yield_dataframe_as("r", as_local=True))

    def case(m, d):
        src = _src_dir(d)
        conf = {DIR: str(d / "cache")}
        _run(m, build, src, conf)
        _write_part(src, 3)
        warm, we, _ = _run(m, build, src, conf)
        assert _stats(we)["partial_hits"] >= 1
        again, e3, _ = _run(m, build, src, conf)
        st = _stats(e3)
        assert st["hits_mem"] + st["hits_disk"] >= 1 and st["partial_hits"] == 0, st
        pd.testing.assert_frame_equal(warm, again)
        return [warm]

    _both(case, tmp_path, ["k"])


def test_explain_renders_delta_partitions(tmp_path):
    def case(m, d):
        src = _src_dir(d)
        conf = {DIR: str(d / "cache")}
        _run(m, BUILDS["agg"], src, conf)
        _write_part(src, 3)
        dag = m.Workflow()
        BUILDS["agg"](dag, m, src)
        exp = dag.explain(engine=m.engine(conf))
        assert "DELTA[3/4 partitions]" in exp, exp
        assert "delta:source" in exp and "delta:accumulator" in exp, exp
        return [[ln.split(" -- ")[0] for ln in exp.splitlines() if ln.startswith("  t")]]

    outs = {}
    for m in PKGS:
        (tmp_path / m.name).mkdir()
        outs[m.name] = case(m, tmp_path / m.name)
    assert outs["port"] == outs["ref"]


def test_delta_counters_flatten_to_valid_prometheus(tmp_path):
    src = _src_dir(tmp_path)
    conf = {DIR: str(tmp_path / "cache")}
    _run(PORT, BUILDS["agg"], src, conf)
    _write_part(src, 3)
    _, we, _ = _run(PORT, BUILDS["agg"], src, conf)
    text = to_prometheus_text(engine=we)
    validate_prometheus_text(text)
    for want in ("fugue_tpu_cache_partial_hits", "fugue_tpu_cache_delta_partitions",
                 "fugue_tpu_cache_bytes_skipped_delta"):
        assert want in text, want
    assert "fugue_tpu_cache_partial_hits 1" in text, text


# ---- what the port adds ------------------------------------------------------------------


def test_delta_partial_runs_the_lowered_segment_over_new_rows(tmp_path, monkeypatch):
    """The delta recompute of a lowered aggregate computes its fresh
    partial through the engine's ``lowered_segment`` over the new
    partition's rows only (where the card runs the binned-sum kernel),
    then merges with the cached partial: the JAX engine's result."""
    seen = []
    real = TorchExecutionEngine.lowered_segment

    def spy(self, dfs, *a, **k):
        seen.append(sum(d.count() for d in dfs))
        return real(self, dfs, *a, **k)

    monkeypatch.setattr(TorchExecutionEngine, "lowered_segment", spy)

    def build(dag, m, src):
        (dag.load(src, fmt="parquet").filter(m.col("v") > 25)
         .select(m.col("k"), (m.col("v") * m.col("w")).alias("z")).partition_by("k")
         .aggregate(m.ff.sum(m.col("z")).alias("s")).yield_dataframe_as("r", as_local=True))

    def case(m, d):
        src = _src_dir(d, files=4)
        conf = {DIR: str(d / "cache")}
        cold, warm, we, wdag = _delta_cycle(m, build, src, conf, lambda: _write_part(src, 4, n=333))
        if m is PORT:
            assert seen[0] == 4 * 900 and seen[1] == 333, seen
            assert wdag.last_plan_report.segments_lowered == 1
        return [cold, warm]

    outs = _both(case, tmp_path, ["k"])
    assert len(outs["port"][1]) == 12
