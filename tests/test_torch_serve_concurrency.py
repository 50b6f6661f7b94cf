"""Several sessions on one port engine, the cases of
``tests/serve/test_concurrency.py`` on ``TorchExecutionEngine(device="cpu")``
and the port's ``NativeExecutionEngine``.

Threads run ``workflow.run`` on ONE engine, directly and through an
``EngineServer``; every result must equal its serial oracle bit for bit
(integer-valued floats, so every fold order sums exactly; the oracle is
the JAX package's engine and a fresh port engine), and the counters must
stay coherent: ``PlanStats.runs``, the serve counters and gauges, and
the kernel's launch count.

The reference's ``JitCache`` case
(``test_jit_cache_counters_survive_a_counter_hammer``) has no
counterpart: the port compiles nothing and keeps no jit cache. Its place
is taken by the launch counter of the binned-sum kernel
(``ops/bin_groupby.py``), the one count the port's card check reads.
"""

import threading
from typing import Any, Dict, List

import pandas as pd
import pytest
from torch_serve_common import Pkg, plain
from torch_tuned_store import own_tuned_store  # noqa: F401

from fugue_tpu import FugueWorkflow as JFugueWorkflow
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.jax import JaxExecutionEngine

THREADS = 2
RUNS_PER_THREAD = 4
NO_CACHE = {"fugue.tpu.cache.enabled": False}


def _frame(seed: int) -> pd.DataFrame:
    n = 2048
    return pd.DataFrame({"k": [(i * 7 + seed) % 16 for i in range(n)],
                         "v": [float((i * 13 + seed) % 1000) for i in range(n)]})


def _mk_dag(pkg: Any, seed: int) -> Any:
    col, ff = pkg.col, pkg.ff
    dag = pkg.FugueWorkflow()
    (dag.df(_frame(seed)).filter(col("v") > 50).partition_by("k")
     .aggregate(ff.sum(col("v")).alias("s"), ff.count(col("v")).alias("n"), ff.avg(col("v")).alias("m"))
     .yield_dataframe_as("r", as_local=True))
    return dag


def _run_once(pkg: Any, eng: Any, seed: int) -> pd.DataFrame:
    dag = _mk_dag(pkg, seed)
    dag.run(eng)
    return plain(dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True))


def _reference(seed: int) -> pd.DataFrame:
    dag = JFugueWorkflow()
    (dag.df(_frame(seed)).filter(jcol("v") > 50).partition_by("k")
     .aggregate(jff.sum(jcol("v")).alias("s"), jff.count(jcol("v")).alias("n"), jff.avg(jcol("v")).alias("m"))
     .yield_dataframe_as("r", as_local=True))
    dag.run(JaxExecutionEngine(NO_CACHE))
    return plain(dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True))


@pytest.fixture(params=["torch", "native"])
def pkg(request):
    return Pkg(request.param)


def test_two_threads_through_workflow_run_bit_identical_and_coherent(pkg):
    eng = pkg.make_engine(NO_CACHE)
    oracle = {t: _run_once(pkg, pkg.make_engine(NO_CACHE), t) for t in range(THREADS)}
    for t in range(THREADS):
        pd.testing.assert_frame_equal(oracle[t], _reference(t), check_dtype=False)
    eng.reset_stats()
    results: Dict[int, List[pd.DataFrame]] = {t: [] for t in range(THREADS)}
    errors: List[BaseException] = []

    def hammer(t: int) -> None:
        try:
            for _ in range(RUNS_PER_THREAD):
                results[t].append(_run_once(pkg, eng, t))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    for t in range(THREADS):
        assert len(results[t]) == RUNS_PER_THREAD
        for df in results[t]:
            pd.testing.assert_frame_equal(df, oracle[t])
    assert eng.stats()["plan"]["runs"] == THREADS * RUNS_PER_THREAD


def test_launch_counts_survive_a_counter_hammer():
    """The kernel's launch count is exact when several sessions launch at
    once (``_count_launch`` holds a lock; a bare ``+=`` can lose counts)."""
    import os
    import sys

    from fugue_tpu_torch.ops import bin_groupby as bg

    per_thread, n_threads = 5_000, 2 * (os.cpu_count() or 2)
    before = bg.LAUNCHES["bin_sum"]
    barrier = threading.Barrier(n_threads)

    def spin() -> None:
        barrier.wait()
        for _ in range(per_thread):
            bg._count_launch("bin_sum")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=spin) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert bg.LAUNCHES["bin_sum"] - before == n_threads * per_thread
    bg.LAUNCHES["bin_sum"] = before


def test_lazy_engine_singletons_are_created_once_under_concurrency(pkg):
    for _ in range(5):  # the race window is small: take a few shots
        eng = pkg.make_engine()
        seen: Dict[str, List[Any]] = {"cache": [], "metrics": [], "plan": [], "tuner": [], "rpc": []}
        barrier = threading.Barrier(4)

        def touch() -> None:
            barrier.wait()
            seen["cache"].append(eng.result_cache)
            seen["metrics"].append(eng.metrics)
            seen["plan"].append(eng.plan_stats)
            seen["tuner"].append(eng.tuner)
            seen["rpc"].append(eng.rpc_server)

        threads = [threading.Thread(target=touch) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for name, objs in seen.items():
            assert len({id(o) for o in objs}) == 1, f"{name} created twice"


def test_hammer_through_engine_server_matches_serial(tmp_path, pkg):
    """Six sessions over three plans through one ``EngineServer`` on one
    engine with the result cache on: bit-identical to serial runs, none
    fails, and the engine never ran all six from scratch."""
    eng = pkg.make_engine({"fugue.tpu.cache.enabled": True, "fugue.tpu.cache.dir": str(tmp_path / "cache"),
                           "fugue.tpu.serve.max_concurrent": 3})
    oracle = {s: _run_once(pkg, pkg.make_engine(NO_CACHE), s) for s in range(3)}
    failures: List[BaseException] = []
    outs: List[Any] = []
    with pkg.serve.EngineServer(eng) as srv:

        def session(i: int) -> None:
            seed = i % 3
            try:
                res = srv.submit(lambda: _mk_dag(pkg, seed), tenant=f"t{seed}").result(timeout=120)
                outs.append((seed, plain(res.yields["r"].result.as_pandas().sort_values("k")
                                         .reset_index(drop=True))))
            except BaseException as e:
                failures.append(e)

        threads = [threading.Thread(target=session, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not failures, failures
    assert len(outs) == 6
    for seed, df in outs:
        pd.testing.assert_frame_equal(df, oracle[seed])
    st = srv.stats()
    assert st["failed"] == 0 and st["submitted"] == 6
    assert st["completed"] == st["executions"]
    assert sum(t["completed"] for t in st["tenants"].values()) == 6
    assert st["executions"] <= 6
    assert st["active_runs"] == 0 and st["queue_depth"] == 0


def test_two_streamed_workflows_at_once_keep_their_own_pipelines():
    """Two one-pass streams aggregated at the same time on one engine,
    through a server with two workers: each stream has its own prefetcher
    and staging ring, so each answers its own oracle."""
    from fugue_tpu_torch.dataframe import LocalDataFrameIterableDataFrame, PandasDataFrame

    pkg = Pkg("torch")
    eng = pkg.make_engine({**NO_CACHE, "fugue.tpu.serve.max_concurrent": 2, "fugue.tpu.stream.chunk_rows": 256})
    frames = {s: _frame(s) for s in (1, 2)}

    def factory(seed: int):
        def build():
            pdf = frames[seed]
            chunks = [PandasDataFrame(pdf.iloc[i:i + 300].reset_index(drop=True)) for i in range(0, len(pdf), 300)]
            col, ff = pkg.col, pkg.ff
            dag = pkg.FugueWorkflow()
            (dag.df(LocalDataFrameIterableDataFrame(chunks)).filter(col("v") > 50).partition_by("k")
             .aggregate(ff.sum(col("v")).alias("s"), ff.count(col("v")).alias("n"), ff.avg(col("v")).alias("m"))
             .yield_dataframe_as("r", as_local=True))
            return dag

        return build

    with pkg.serve.EngineServer(eng) as srv:
        subs = {s: srv.submit(factory(s), tenant=f"s{s}") for s in (1, 2)}
        got = {s: plain(sub.result(timeout=120).yields["r"].result.as_pandas().sort_values("k")
                        .reset_index(drop=True)) for s, sub in subs.items()}
        assert srv.stats()["dedup_hits"] == 0  # one-pass streams never share
    for s in (1, 2):
        pd.testing.assert_frame_equal(got[s], _reference(s), check_dtype=False)
