"""The port's host-map fork pool (``fugue_tpu_torch/execution/parallel_map.py``
and ``PandasMapEngine._pool_workers`` / ``_run_forked``) against the JAX
package's (``fugue_tpu/execution/parallel_map.py``): the cases of
``tests/core/test_parallel_map.py`` and the map parts of
``tests/core/test_resilience.py``.

Each pooled map runs the same seeded numpy frame through the port's host
engine and ``TorchExecutionEngine(device="cpu")`` with the pool forced on
(``fugue.tpu.map.parallelism`` 2, no row floor), through the port's serial
map, and through the reference's pooled map (its host engine and
``JaxExecutionEngine`` on the 8-device CPU mesh). Row sets and keys exact;
floats ``np.allclose`` at ``rtol=1e-12`` (the same pandas arithmetic, row
for row). Recovery counters: every counter that does not depend on which
chunks were in flight when a worker died equals the reference's. No test
times the pool: the reference's own wall-time test flakes.
"""

import os
import time

import numpy as np
import pandas as pd
import pytest

import fugue_tpu.api as fa
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.execution.native_execution_engine import PandasMapEngine as JPandasMapEngine
from fugue_tpu.execution.parallel_map import split_chunks as jsplit_chunks
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu_torch import api
from fugue_tpu_torch.execution import NativeExecutionEngine, PandasMapEngine
from fugue_tpu_torch.execution import parallel_map as pm
from fugue_tpu_torch.obs import get_tracer
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine

PARENT_PID = os.getpid()
RTOL = 1e-12
PAR_CONF = {
    "fugue.tpu.map.parallelism": 2,
    "fugue.tpu.map.parallel_min_rows": 0,
    "fugue.tpu.retry.base": 0.02,
}
# counters fixed by the plan and the data alone (not by which chunks were
# in flight when a worker died or a deadline passed)
FIXED = ("map.worker_lost", "map.chunks_ok", "map.worker_chunks", "map.worker_partitions",
         "map.worker_rows_out", "map.quarantined_chunks", "map.quarantined_partitions",
         "map.serial_fallbacks")


def _frame(n_keys: int = 16, rows: int = 4000, seed: int = 7) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, n_keys, rows), "v": rng.random(rows)})


def _demean(pdf: pd.DataFrame) -> pd.DataFrame:
    return pdf.assign(d=pdf["v"] - pdf["v"].mean())


def _tag(pdf: pd.DataFrame) -> pd.DataFrame:
    return pd.DataFrame({"n": [len(pdf)], "s": [float(pdf["v"].sum())]})


def _first_two(pdf: pd.DataFrame) -> pd.DataFrame:
    return pdf.head(2)


def _keep_big(pdf: pd.DataFrame) -> pd.DataFrame:
    return pdf[pdf["v"] > 0.5].assign(d=0.0)


def _child_poison(pdf: pd.DataFrame) -> pd.DataFrame:
    if os.getpid() != PARENT_PID and pdf["k"].iloc[0] == 3:
        raise ValueError("poison in worker")
    return pdf.assign(d=1.0)


def _port(conf: dict, device: bool) -> object:
    return TorchExecutionEngine(device="cpu", conf=conf) if device else NativeExecutionEngine(conf)


def _sorted(res: object, by: list) -> pd.DataFrame:
    pdf = res.as_pandas() if hasattr(res, "as_pandas") else pd.DataFrame(res)
    return pdf.sort_values(by).reset_index(drop=True)


def _same(got: pd.DataFrame, exp: pd.DataFrame) -> None:
    assert list(got.columns) == list(exp.columns) and len(got) == len(exp)
    for c in got.columns:
        g, e = got[c].to_numpy(), exp[c].to_numpy()
        if g.dtype.kind == "f":
            assert np.allclose(g, e.astype(np.float64), rtol=RTOL, atol=0), c
        else:
            assert g.tolist() == e.tolist(), c


@pytest.fixture
def tracer():
    tr = get_tracer()
    tr.clear()
    tr.enable()
    yield tr
    tr.disable()
    tr.clear()


@pytest.mark.parametrize("sizes,n", [([100, 1, 1, 1, 1, 100], 2), ([], 4), ([5], 4),
                                     (list(np.random.default_rng(0).integers(1, 50, 37)), 8),
                                     ([3] * 64, 8), ([1, 1000, 1], 3)])
def test_split_chunks_equals_the_reference(sizes, n):
    assert [list(c) for c in pm.split_chunks(sizes, n)] == [list(c) for c in jsplit_chunks(sizes, n)]


@pytest.mark.parametrize("device", [False, True], ids=["host", "torch"])
@pytest.mark.parametrize("case", ["keyed", "presort", "num", "empty_outputs"])
def test_pooled_map_matches_serial_and_the_reference(device, case):
    """The port's pooled map against its serial map and the reference's
    pooled map (host engine and JAX engine), with the pool's counters on
    the engine the user holds."""
    df = _frame()
    kw = dict(schema="k:long,v:double,d:double", partition={"by": ["k"]})
    fn, by = _demean, ["k", "v"]
    if case == "presort":
        fn, kw = _first_two, dict(schema="*", partition={"by": ["k"], "presort": "v desc"})
    elif case == "num":
        fn, kw, by = _tag, dict(schema="n:long,s:double", partition={"num": 8}), ["n", "s"]
    elif case == "empty_outputs":
        fn = _keep_big
    pooled = _port(PAR_CONF, device)
    got = api.transform(df, fn, engine=pooled, **kw)
    serial = api.transform(df, fn, engine=_port({}, device), **kw)
    ref = fa.transform(df, fn, engine=JNativeExecutionEngine(PAR_CONF), **kw)
    jeng = JaxExecutionEngine(PAR_CONF)
    ref_jax = fa.transform(df, fn, engine=jeng, **kw)
    jeng.stop()
    exp = _sorted(ref, by)
    for res in (got, serial, ref_jax):
        _same(_sorted(res, by), exp)
    stats = pooled.resilience_stats.as_dict()
    assert stats["map.chunks_ok"] == stats["map.worker_chunks"] >= 2
    assert stats["map.worker_partitions"] == (8 if case == "num" else df["k"].nunique())


def test_pooled_map_of_a_device_frame_comes_back_to_the_device():
    df = _frame()
    eng = TorchExecutionEngine(device="cpu", conf=PAR_CONF)
    res = api.transform(eng.to_df(df), _demean, schema="k:long,v:double,d:double",
                        partition={"by": ["k"]}, engine=eng, as_fugue=True)
    assert isinstance(res, TorchDataFrame) and res.device == eng.device
    serial = api.transform(df, _demean, schema="k:long,v:double,d:double", partition={"by": ["k"]},
                           engine=TorchExecutionEngine(device="cpu"))
    _same(_sorted(res, ["k", "v"]), _sorted(serial, ["k", "v"]))
    assert eng.resilience_stats.as_dict()["map.chunks_ok"] >= 2


@pytest.mark.parametrize("device", [False, True], ids=["host", "torch"])
@pytest.mark.parametrize("fault", ["kill", "error", "poison", "delay"])
def test_recovery_matches_the_reference(device, fault):
    """``map.chunk=kill`` (a worker SIGKILLed: a fresh pool retries its
    chunk), ``map.chunk=error@2`` (two chunks fail once, retried),
    a poison partition (fails in every worker: quarantined to the driver,
    where it runs) and ``map.chunk=delay`` past ``fugue.tpu.map.chunk_timeout``
    (the wave torn down and retried): the unfaulted result, and the
    reference's counters."""
    df = _frame(n_keys=8, rows=2000)
    conf = dict(PAR_CONF)
    fn = _demean
    if fault == "kill":
        conf["fugue.tpu.fault.plan"] = "map.chunk=kill"
    elif fault == "error":
        conf["fugue.tpu.fault.plan"] = "map.chunk=error@2"
    elif fault == "poison":
        fn = _child_poison
    else:
        conf.update({"fugue.tpu.fault.plan": "map.chunk=delay:10", "fugue.tpu.map.chunk_timeout": 0.6})
    kw = dict(schema="k:long,v:double,d:double", partition={"by": ["k"]})
    baseline = api.transform(df, fn, engine=_port(PAR_CONF, device), **kw)
    eng = _port(conf, device)
    t0 = time.perf_counter()
    got = api.transform(df, fn, engine=eng, **kw)
    assert time.perf_counter() - t0 < 8  # never waited out the injected 10 s stall
    jeng = JNativeExecutionEngine(conf)
    exp = fa.transform(df, fn, engine=jeng, **kw)
    _same(_sorted(got, ["k", "v"]), _sorted(baseline, ["k", "v"]))
    _same(_sorted(got, ["k", "v"]), _sorted(exp, ["k", "v"]))
    st, jst = eng.resilience_stats.as_dict(), jeng.resilience_stats.as_dict()
    assert {c: st.get(c, 0) for c in FIXED} == {c: jst.get(c, 0) for c in FIXED}
    retried = {"kill": "map.chunk_retries", "error": "map.chunk_retries", "poison": "map.serial_fallbacks",
               "delay": "map.deadline_expiries"}[fault]
    assert st.get(retried, 0) >= 1 and jst.get(retried, 0) >= 1
    if fault == "error":
        assert st["map.chunk_retries"] == jst["map.chunk_retries"] == 2
    if fault == "kill":
        assert st["map.worker_lost"] == 1 and st["map.pool_rebuilds"] >= 1
    assert not pm._FORK_STATE


def test_unrecoverable_poison_raises_a_partition_report():
    df = _frame(n_keys=6, rows=1200)

    def always_poison(pdf: pd.DataFrame) -> pd.DataFrame:
        if pdf["k"].iloc[0] == 2:
            raise ValueError("always poison")
        return pdf.assign(d=1.0)

    msgs = []
    for transform, eng in ((api.transform, NativeExecutionEngine(PAR_CONF)),
                           (fa.transform, JNativeExecutionEngine(PAR_CONF))):
        with pytest.raises(Exception) as ei:
            transform(df, always_poison, schema="k:long,v:double,d:double", partition={"by": ["k"]},
                      engine=eng)
        msgs.append(str(ei.value))
    assert all("partition" in m and "always poison" in m for m in msgs)


@pytest.mark.parametrize("device", [False, True], ids=["host", "torch"])
def test_a_callback_transformer_stays_serial(device, tracer):
    """A transformer with a callback runs in the driver, as in the
    reference: the callback's calls equal the reference's, and no pool
    forms."""
    df = _frame(n_keys=5, rows=500)

    def report(pdf: pd.DataFrame, announce: callable) -> pd.DataFrame:
        announce(int(pdf["k"].iloc[0]))
        return pdf

    got, exp = [], []
    api.out_transform(df, report, partition={"by": ["k"]}, callback=got.append, engine=_port(PAR_CONF, device))
    fa.out_transform(df, report, partition={"by": ["k"]}, callback=exp.append,
                     engine=JNativeExecutionEngine(PAR_CONF))
    assert sorted(got) == sorted(exp) == list(range(5))
    assert not [r for r in tracer.records() if r["name"].startswith("map.")]


@pytest.mark.parametrize("device", [False, True], ids=["host", "torch"])
def test_a_small_frame_stays_serial(device, monkeypatch):
    """Below ``fugue.tpu.map.parallel_min_rows`` (default 10^5) the map is
    serial even with the pool asked for: no pool is made."""

    def no_pool(*a, **k):  # pragma: no cover - failing is the assert
        raise AssertionError("no pool below the row floor")

    monkeypatch.setattr(pm, "_make_pool", no_pool)
    eng = _port({"fugue.tpu.map.parallelism": 4}, device)
    res = api.transform(_frame(), _demean, schema="k:long,v:double,d:double", partition={"by": ["k"]},
                        engine=eng)
    assert len(res) == 4000 and "map.chunks_ok" not in eng.resilience_stats.as_dict()


def test_one_chunk_skips_the_pool(monkeypatch, tracer):
    def no_pool(*a, **k):  # pragma: no cover
        raise AssertionError("a single chunk makes no pool")

    monkeypatch.setattr(pm, "_make_pool", no_pool)
    df = pd.DataFrame({"k": [1] * 50, "v": np.arange(50.0)})
    res = api.transform(df, _demean, schema="k:long,v:double,d:double", partition={"by": ["k"]},
                        engine=NativeExecutionEngine(PAR_CONF))
    assert len(res) == 50
    assert [r["name"] for r in tracer.records() if r["name"].startswith("map.")] == []


def test_the_auto_size_is_one_on_the_port():
    """The auto pool size is ``min(get_current_parallelism(), os.cpu_count())``:
    1 on the port's one device, so it maps serially unless the conf asks;
    the reference's on the 8-device CPU mesh is ``min(8, cpu_count)``."""
    jeng = JaxExecutionEngine({})
    ref = JPandasMapEngine(jeng._host_engine, parallelism_engine=jeng)
    teng = TorchExecutionEngine(device="cpu")
    port = PandasMapEngine(teng._host_engine, parallelism_engine=teng)
    n_rows, n_parts = 10**6, 100
    assert port._pool_workers(_demean, n_rows, n_parts) == 1
    assert ref._pool_workers(_demean, n_rows, n_parts) == (min(8, os.cpu_count() or 1)
                                                            if (os.cpu_count() or 1) > 1 else 1)
    asked = TorchExecutionEngine(device="cpu", conf={"fugue.tpu.map.parallelism": 3})
    assert asked.map_engine._host_map._pool_workers(_demean, n_rows, n_parts) == 3
    assert asked.map_engine._host_map._pool_workers(_demean, 10, n_parts) == 1  # the row floor
    jeng.stop()


def test_the_spans_come_home(tracer):
    """The workers' ``map.worker_chunk`` and ``map.partition`` spans come
    home through the tracer's fork protocol, under the driver's
    ``map.parallel`` span, with the reference's counts."""
    from fugue_tpu.obs import get_tracer as jget_tracer

    df = _frame(n_keys=12, rows=3000)
    kw = dict(schema="k:long,v:double,d:double", partition={"by": ["k"]})
    api.transform(df, _demean, engine=TorchExecutionEngine(device="cpu", conf=PAR_CONF), **kw)
    recs = tracer.records()
    jtr = jget_tracer()
    jtr.clear()
    jtr.enable()
    try:
        fa.transform(df, _demean, engine=JNativeExecutionEngine(PAR_CONF), **kw)
        jrecs = jtr.records()
    finally:
        jtr.disable()
        jtr.clear()

    def counts(rs):
        return {n: sum(r["name"] == n for r in rs) for n in ("map.parallel", "map.worker_chunk", "map.partition")}

    assert counts(recs) == counts(jrecs)
    assert counts(recs)["map.partition"] == 12 and counts(recs)["map.parallel"] == 1
    par = [r for r in recs if r["name"] == "map.parallel"][0]
    chunks = [r for r in recs if r["name"] == "map.worker_chunk"]
    assert all(r["parent"] == par["id"] for r in chunks)
    assert {r["args"]["worker_pid"] for r in chunks} - {os.getpid()}
    assert sum(r["args"]["rows_out"] for r in chunks) == 3000


_SERVICES_PATH_ON_THE_CPU = """
import json, sys, numpy as np, pandas as pd, torch
import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.obs import get_tracer
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import frame_from_numpy
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache", "set_sync_debug_mode"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
pdf = chip_smoke.plan_frame(np, pd, 40_000, 0)
pdf["k"] = pdf["k"] % 100
exp = chip_smoke.plan_oracle(np, pd, *(pdf[c].to_numpy() for c in "kvw"))
out = chip_smoke.phase_services_path(torch, np, pd, bg, api, ff, col, frame_from_numpy, torch.device("cpu"), pdf,
                                     exp, 0, callback_rows=4_000, udf_rows=150_000, device_rows=150_000, workers=2)
cells = out["cells"]
print("RESULT", json.dumps({c: r["launches"] for c, r in cells.items()}))
print("HTTP", cells["http-callback-1k"]["callback"]["calls"], cells["http-callback-1k"]["fault"]["retries"],
      cells["http-scrape"]["prometheus"]["plan_segment_count"], cells["http-scrape"]["readyz"])
print("POOL", cells["pool-demean-1m"]["workers"], cells["pool-demean-1m"]["worker_pids"],
      cells["pool-kill"]["resilience"]["map.worker_lost"], cells["pool-kill"]["children_left"])
print("LEFT", get_tracer().enabled, len(get_tracer().records()))
print("JAX", "jax" in sys.modules or "fugue_tpu" in sys.modules)
"""


def test_chip_smoke_services_path_on_the_cpu():
    """The phase's six cells pass their checks at small size in a process
    that loads no JAX (no binned-sum launch on the CPU): the profiled
    lowered call's trace, callbacks over HTTP and the faulted call's one
    retry, the scrape, the pooled maps against their serial twins, and
    the killed worker's recovery with no child left."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _SERVICES_PATH_ON_THE_CPU], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("RESULT", "HTTP", "POOL", "LEFT", "JAX")))
    zero = {"bin_sum": 0, "bin_sum_count": 0}
    assert json.loads(lines["RESULT"]) == {c: zero for c in (
        "profiled-lowered", "http-callback-1k", "http-scrape", "pool-demean-1m", "pool-demean-device-10m",
        "pool-kill")}
    assert lines["HTTP"] == "100 {'rpc.retries': 1} 3 {'status': 'ready', 'serve_bound': False}"
    assert lines["POOL"] == "2 2 1 []"
    assert lines["LEFT"] == "False 0"
    assert lines["JAX"] == "False"
