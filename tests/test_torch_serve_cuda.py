"""The serving layer on a CUDA card: several sessions on one
``TorchExecutionEngine`` on ``cuda:0``. Without a card every test here
skips. This file imports no JAX, so it also runs where JAX is not
installed::

    python -m pytest --noconftest -m cuda tests/test_torch_serve_cuda.py

- four threads running lowered aggregates on one engine count exactly
  four B1 launches and give the serial results;
- four sessions submitting one plan to an ``EngineServer`` share one
  execution: B1 launches once;
- after ``stop()`` and the yielded frames are dropped, the allocated
  device bytes are back where they were before the server started, while
  the stopped server, its retained submissions and its engine are still
  referenced: a finished execution keeps its result, not its workflow
  (whose context holds every intermediate frame of the run).
"""

import gc
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.serve import EngineServer
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow

pytestmark = pytest.mark.cuda

ROWS, GROUPS = 400_000, 500
NO_CACHE = {"fugue.tpu.cache.enabled": False}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frame(seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, GROUPS, ROWS), "v": rng.random(ROWS, dtype=np.float32),
                         "w": rng.random(ROWS, dtype=np.float32)})


def _chain(src, t: float) -> FugueWorkflow:
    dag = FugueWorkflow()
    (dag.df(src).filter(col("v") > t).select(col("k"), (col("v") * col("w")).alias("z"))
     .partition_by("k").aggregate(s=ff.sum(col("z")), n=ff.count(col("z"))).yield_dataframe_as("r"))
    return dag


def _rows(df) -> pd.DataFrame:
    return df.as_pandas().sort_values("k").reset_index(drop=True)


def _zero() -> None:
    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0


def test_four_threads_count_four_launches_and_give_the_serial_results(cuda_device):
    e = TorchExecutionEngine(device=cuda_device, conf=NO_CACHE)
    frames = {i: e.persist(e.to_df(_frame(i))) for i in range(4)}
    ts = {i: 0.1 + 0.2 * i for i in range(4)}
    serial = {}
    for i in range(4):
        dag = _chain(frames[i], ts[i])
        dag.run(e)
        serial[i] = _rows(dag.yields["r"].result)
    torch.cuda.synchronize()
    _zero()
    got, errors = {}, []
    barrier = threading.Barrier(4)

    def session(i: int) -> None:
        try:
            barrier.wait()
            dag = _chain(frames[i], ts[i])
            dag.run(e)
            got[i] = _rows(dag.yields["r"].result)
        except BaseException as ex:  # pragma: no cover
            errors.append(ex)

    threads = [threading.Thread(target=session, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    assert bg.LAUNCHES == {"bin_sum": 4, "bin_sum_count": 0}
    for i in range(4):
        pd.testing.assert_frame_equal(got[i][["k", "n"]], serial[i][["k", "n"]])
        np.testing.assert_allclose(got[i]["s"], serial[i]["s"], rtol=1e-5)


def _serve_four_sessions(cuda_device) -> EngineServer:
    """Four sessions submit one plan while a gate holds the one worker:
    one shared execution, B1 once, the oracle. Returns the stopped server,
    the shared result's yields dropped."""
    e = TorchExecutionEngine(device=cuda_device, conf={**NO_CACHE, "fugue.tpu.serve.max_concurrent": 1})
    pdf = _frame(7)
    srv = EngineServer(e).start()
    release, entered = threading.Event(), threading.Event()

    def gate() -> pd.DataFrame:
        entered.set()
        assert release.wait(60)
        return pd.DataFrame({"a": [1]})

    blocker = FugueWorkflow()
    blocker.create(gate, schema="a:long").yield_dataframe_as("g", as_local=True)
    held = srv.submit(blocker)
    assert entered.wait(60)
    _zero()
    subs = [srv.submit(lambda: _chain(pdf, 0.25), tenant=f"t{i}") for i in range(4)]
    release.set()
    held.result(timeout=60)
    results = [s.result(timeout=120) for s in subs]
    torch.cuda.synchronize()
    frame = results[0].yields["r"].result
    shared = [r.yields["r"].result is frame for r in results]
    assert isinstance(frame, TorchDataFrame) and frame.device == cuda_device
    assert shared == [True] * 4
    assert bg.LAUNCHES["bin_sum"] == 1
    st = srv.stats()
    assert st["executions"] == 2 and st["dedup_hits"] == 3  # the gate and one shared run
    want = pdf[pdf["v"] > 0.25].assign(z=lambda d: d["v"].astype(np.float64) * d["w"]).groupby("k")["z"]
    got = _rows(frame)
    np.testing.assert_array_equal(got["n"].to_numpy(), want.count().to_numpy())
    np.testing.assert_allclose(got["s"].to_numpy(), want.sum().to_numpy(), rtol=1e-4)
    srv.stop()
    results[0].yields.clear()  # the one result all four waiters share
    return srv


def test_a_deduped_submission_launches_once_and_memory_returns(cuda_device):
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    srv = _serve_four_sessions(cuda_device)
    gc.collect()
    torch.cuda.synchronize()
    # the stopped server still holds its retained submissions and its engine
    assert not srv.running and srv.stats()["retained"] == 5  # the gate and the four sessions
    assert torch.cuda.memory_allocated(cuda_device) == before
