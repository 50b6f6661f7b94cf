"""The worker tier and the workflow's distributed pass on a CUDA card: a
join fragment runs on two worker processes (``python -m
fugue_tpu_torch.dist.worker``, host engines that never import torch),
its frame lands on ``cuda:0`` with its float32 columns, the local
``select → aggregate`` segment launches B1 once and matches a float64
oracle, and a warm rerun dispatches nothing. Without a card every test
here skips. This file imports no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_dist_cuda.py
"""

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.dist import read_heartbeat
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = {"fugue.tpu.dist.heartbeat.interval_s": 0.1, "fugue.tpu.dist.heartbeat.stale_after_s": 1.0,
        "fugue.tpu.dist.lease_s": 2.0, "fugue.tpu.dist.poll_s": 0.01, "fugue.tpu.dist.fetch": "remote",
        "fugue.tpu.cache.enabled": False, "fugue.tpu.tuning.enabled": False}


@pytest.fixture
def tier(tmp_path):
    """Sources, a board and two worker processes on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    os.makedirs(tmp_path / "fact")
    os.makedirs(tmp_path / "dim")
    for i in range(3):
        n = 50_000
        pd.DataFrame({"k": rng.integers(0, 5_000, n), "g": rng.integers(0, 64, n),
                      "v": rng.random(n, dtype=np.float32)}).to_parquet(str(tmp_path / "fact" / f"p{i}.parquet"))
    pd.DataFrame({"k": np.arange(5_000), "w": rng.random(5_000, dtype=np.float32)}).to_parquet(
        str(tmp_path / "dim" / "d.parquet"))
    board = str(tmp_path / "board")
    os.makedirs(board)
    stop = os.path.join(board, "_stop")
    procs = [subprocess.Popen([sys.executable, "-m", "fugue_tpu_torch.dist.worker", "--root", board, "--id", f"w{i}",
                               "--conf", json.dumps(CONF), "--stop-file", stop], cwd=ROOT)
             for i in range(2)]
    try:
        deadline = time.monotonic() + 120
        while not all(read_heartbeat(os.path.join(board, "hb"), f"w{i}") for i in range(2)):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs)
            time.sleep(0.05)
        yield tmp_path, board, procs
    finally:
        with open(stop, "w") as f:
            f.write("stop")
        codes = [p.wait(timeout=60) for p in procs]
    assert codes == [0, 0]


def _dag(tmp_path, board):
    dag = FugueWorkflow({"fugue.tpu.dist.board": board, "fugue.tpu.dist.buckets": 4,
                         "fugue.tpu.dist.workflow_timeout_s": 120})
    (dag.load(str(tmp_path / "fact"), fmt="parquet").filter(col("v") > 0.25)
     .join(dag.load(str(tmp_path / "dim"), fmt="parquet"), how="inner", on=["k"])
     .select(col("g"), (col("v") * col("w")).alias("z"))
     .partition_by("g").aggregate(ff.sum(col("z")).alias("s"), ff.count(col("z")).alias("n"))
     .yield_dataframe_as("r"))
    return dag


def _oracle(tmp_path) -> pd.DataFrame:
    fact = pd.concat([pd.read_parquet(str(tmp_path / "fact" / f"p{i}.parquet")) for i in range(3)])
    dim = pd.read_parquet(str(tmp_path / "dim" / "d.parquet"))
    m = fact[fact["v"] > 0.25].merge(dim, on="k")
    m["z"] = (m["v"] * m["w"]).astype(np.float64)
    return m.groupby("g", as_index=False).agg(s=("z", "sum"), n=("z", "count"))


def _holds_card_or_torch(pid: int) -> bool:
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            pass
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def test_fragment_on_workers_aggregate_on_the_card(tier):
    tmp_path, board, procs = tier
    engine = TorchExecutionEngine(conf={"fugue.tpu.cache.enabled": False})
    landed = []
    orig = engine.to_df

    def spy(df, *a, **k):
        res = orig(df, *a, **k)
        if isinstance(df, pd.DataFrame):
            landed.append({c: str(t) for c, t in df.dtypes.items()})
        return res

    engine.to_df = spy
    for k in bg.LAUNCHES:
        bg.LAUNCHES[k] = 0
    res = _dag(tmp_path, board).run(engine).yields["r"].result
    assert isinstance(res, TorchDataFrame) and res.device == torch.device("cuda", 0)
    assert bg.LAUNCHES["bin_sum"] == 1
    assert any({"v": "float32", "w": "float32"}.items() <= d.items() for d in landed)
    got = res.as_pandas().sort_values("g").reset_index(drop=True)
    exp = _oracle(tmp_path)
    assert got["g"].tolist() == exp["g"].tolist() and got["n"].tolist() == exp["n"].tolist()
    np.testing.assert_allclose(got["s"].to_numpy(), exp["s"].to_numpy(), rtol=1e-4)
    d = engine.stats()["dist"]
    assert d["workflow_jobs"] == 1 and d["workflow_tasks_dispatched"] == 8  # 3 + 1 maps, 4 reduces
    assert not any(_holds_card_or_torch(p.pid) for p in procs)
    # warm: every done record reused, B1 once again
    for k in bg.LAUNCHES:
        bg.LAUNCHES[k] = 0
    res2 = _dag(tmp_path, board).run(engine).yields["r"].result
    assert bg.LAUNCHES["bin_sum"] == 1
    assert engine.stats()["dist"]["workflow_partitions_delta_skipped"] == 8
    assert res2.as_pandas().sort_values("g")["n"].tolist() == exp["n"].tolist()
    del res, res2, engine
    gc.collect()
