"""The plan optimizer's lowered segments and the unsigned device columns on
a CUDA card. Without a card every test here skips. This file imports no
JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_plan_cuda.py

- a lowered bounded aggregate launches B1 (``bin_sum``) once a call, and a
  lowered streamed one once a chunk; each equals its per-verb twin
  (``fugue.tpu.plan.lower_segments=false``) within ``rtol=1e-4``, and a
  float64 numpy oracle within the same (keys and counts exact);
- a uint64 key's join and a uint32 key's aggregate equal a numpy oracle
  (rows, keys and counts exact; float sums ``rtol=1e-4``).
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from fugue_tpu_torch import api
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

pytestmark = pytest.mark.cuda

RTOL = 1e-4
ROWS, CHUNK, GROUPS = 1_000_000, 100_000, 1000
LOWER = "fugue.tpu.plan.lower_segments"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frame(seed: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    v = rng.random(ROWS, dtype=np.float32)
    v[rng.random(ROWS) < 0.01] = np.nan
    return pd.DataFrame({"k": rng.integers(0, GROUPS, ROWS), "v": v, "w": rng.random(ROWS, dtype=np.float32)})


def _oracle(pdf: pd.DataFrame) -> pd.DataFrame:
    keep = pdf["v"].to_numpy() > 0.25
    k = pdf["k"].to_numpy()[keep]
    z = pdf["v"].to_numpy()[keep] * pdf["w"].to_numpy()[keep]
    return pd.DataFrame({"k": np.arange(GROUPS), "s": np.bincount(k, weights=z.astype(np.float64),
                                                                  minlength=GROUPS),
                         "n": np.bincount(k, minlength=GROUPS)})


def _run(engine, src, conf=None) -> pd.DataFrame:
    dag = FugueWorkflow(conf)
    (dag.df(src).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
     .partition_by("k").aggregate(s=ff.sum(col("z")), n=ff.count(col("z"))).yield_dataframe_as("r"))
    dag.run(engine)
    return dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True)


def _same(got: pd.DataFrame, exp: pd.DataFrame) -> None:
    assert got["k"].tolist() == exp["k"].tolist() and got["n"].tolist() == exp["n"].tolist()
    assert np.allclose(got["s"], exp["s"], rtol=RTOL, atol=0)


def test_lowered_bounded_aggregate_launches_b1_once(cuda_device):
    pdf = _frame()
    engine = TorchExecutionEngine(device=cuda_device)
    tdf = engine.to_df(pdf)
    _run(engine, tdf)  # warm-up: the kernel's build and the range probe
    bg.LAUNCHES["bin_sum"] = 0
    before = engine.plan_stats.as_dict()["segments_executed"]
    got = _run(engine, tdf)
    assert bg.LAUNCHES["bin_sum"] == 1
    assert engine.plan_stats.as_dict()["segments_executed"] == before + 1
    _same(got, _oracle(pdf))
    _same(got, _run(engine, tdf, {LOWER: False}))


def test_lowered_streamed_aggregate_launches_b1_once_a_chunk(cuda_device):
    pdf = _frame(1)
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)

    def stream():
        return LocalDataFrameIterableDataFrame(
            (ArrowDataFrame(tbl.slice(s, CHUNK)) for s in range(0, ROWS, CHUNK)), schema="k:long,v:float,w:float")

    engine = TorchExecutionEngine(device=cuda_device, conf={"fugue.tpu.stream.chunk_rows": CHUNK})
    bg.LAUNCHES["bin_sum"] = 0
    got = _run(engine, stream())
    assert bg.LAUNCHES["bin_sum"] == ROWS // CHUNK
    st = engine.plan_stats.as_dict()
    assert st["segments_executed"] == 1 and st["segments_fallback"] == 0
    _same(got, _oracle(pdf))
    _same(got, _run(engine, stream(), {LOWER: False}))


def test_uint64_join_and_uint32_aggregate(cuda_device):
    rng = np.random.default_rng(2)
    base = np.uint64((1 << 63) - 50)
    dim = pd.DataFrame({"u": base + np.arange(100, dtype=np.uint64), "label": np.arange(100)})
    pick = rng.integers(0, 110, 100_000)
    left = pd.DataFrame({"u": base + pick.astype(np.uint64), "x": rng.random(100_000)})
    engine = TorchExecutionEngine(device=cuda_device)
    got = api.join(engine.to_df(left), engine.to_df(dim), how="inner", on=["u"], engine=engine, as_fugue=True)
    assert got.device.type == "cuda" and str(got.schema) == "u:uint64,x:double,label:long"
    got = got.as_pandas().sort_values(["u", "x"]).reset_index(drop=True)
    hit = pick < 100
    exp = pd.DataFrame({"u": left["u"][hit], "x": left["x"][hit], "label": pick[hit]}).sort_values(
        ["u", "x"]).reset_index(drop=True)
    assert got["u"].tolist() == exp["u"].tolist() and got["label"].tolist() == exp["label"].tolist()
    assert got["x"].tolist() == exp["x"].tolist()
    k = rng.integers(0, GROUPS, ROWS)
    v = rng.random(ROWS, dtype=np.float32)
    res = api.aggregate(engine.to_df(pd.DataFrame({"k": (k + 4_000_000_000).astype(np.uint32), "v": v})),
                        partition_by="k", engine=engine, s=ff.sum(col("v")), n=ff.count(col("v")),
                        lo=ff.min(col("v")), hi=ff.max(col("v")))
    assert str(res.schema).startswith("k:uint32,")
    out = res.as_pandas().sort_values("k").reset_index(drop=True)
    assert out["k"].tolist() == (np.arange(GROUPS) + 4_000_000_000).tolist()
    assert out["n"].tolist() == np.bincount(k, minlength=GROUPS).tolist()
    assert np.allclose(out["s"], np.bincount(k, weights=v.astype(np.float64), minlength=GROUPS), rtol=RTOL)
    mm = pd.DataFrame({"k": k, "v": v}).groupby("k")["v"].agg(["min", "max"])
    assert out["lo"].tolist() == mm["min"].tolist() and out["hi"].tolist() == mm["max"].tolist()
