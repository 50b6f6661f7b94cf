"""Zip and comap on a CUDA card: the zipped frames stay on ``cuda:0`` until
the comap, the comap's output comes back to ``cuda:0``, no blob row is
built on the device route, and the binned-sum kernels (B1, B2) launch no
time; the answers are the port's own CPU run's on the same inputs.
Without a card every test here skips. This file imports no JAX, so it
also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_zip_cuda.py
"""

from typing import Any, List

import numpy as np
import pandas as pd
import pytest
import torch

from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as f
from fugue_tpu_torch.dataframe import DataFrames
from fugue_tpu_torch.execution import execution_engine as base_engine
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from fugue_tpu_torch.torch.zipped import ZippedTorchDataFrame
from fugue_tpu_torch.workflow import FugueWorkflow

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return TorchExecutionEngine()


@pytest.fixture
def no_blobs(monkeypatch):
    def _no_blobs(*args: Any, **kwargs: Any) -> Any:
        raise AssertionError("blob serialization used on the device zip path")

    monkeypatch.setattr(base_engine._PartitionSerializer, "run", _no_blobs)


def _frames(n: int = 1 << 14) -> List[pd.DataFrame]:
    rng = np.random.default_rng(0)
    v = rng.random(n).astype(np.float32)
    v[rng.random(n) < 0.01] = np.nan
    a = pd.DataFrame({"k": rng.integers(0, 100, n), "v": v})
    b = pd.DataFrame({"k": rng.integers(0, 110, n // 8), "w": rng.random(n // 8)})
    return [a, b]


def cogroup(a: pd.DataFrame, b: pd.DataFrame) -> pd.DataFrame:
    k = a["k"].iloc[0] if len(a) else b["k"].iloc[0]  # an outer zip's key may lack a side
    return pd.DataFrame({"k": [k], "n_a": [len(a)], "sum_v": [a["v"].sum()],
                         "n_b": [len(b)], "mean_w": [b["w"].mean()]})


def _run(engine: Any, how: str = "inner") -> pd.DataFrame:
    a, b = _frames()
    dag = FugueWorkflow()
    dag.zip(dag.df(engine.to_df(a)), dag.df(engine.to_df(b)), how=how, partition={"by": ["k"]}).transform(
        cogroup, schema="k:long,n_a:long,sum_v:double,n_b:long,mean_w:double"
    ).yield_dataframe_as("r")
    res = dag.run(engine).yields["r"].result
    assert isinstance(res, TorchDataFrame) and res.device == engine.device
    return res.as_pandas().sort_values("k").reset_index(drop=True)


def test_zipped_frames_stay_on_the_card_until_the_comap(cuda_engine, no_blobs):
    a, b = _frames()
    z = cuda_engine.zip(DataFrames(cuda_engine.to_df(a), cuda_engine.to_df(b)), partition_spec=PartitionSpec(by=["k"]))
    assert isinstance(z, ZippedTorchDataFrame)
    for frame in z.zip_frames:
        assert frame.device == torch.device("cuda:0")
        assert all(t.device == torch.device("cuda:0") for t in frame.device_cols.values())


@pytest.mark.parametrize("how", ["inner", "left_outer", "full_outer"])
def test_comap_output_on_the_card_matches_the_cpu(how, cuda_engine, no_blobs):
    before = dict(bg.LAUNCHES)
    got = _run(cuda_engine, how)
    assert bg.LAUNCHES == before  # B1 and B2 launch no time on this path
    exp = _run(TorchExecutionEngine(device="cpu"), how)
    pd.testing.assert_frame_equal(got, exp, rtol=1e-5)


def test_fugue_sql_cogroup_on_the_card(cuda_engine, no_blobs):
    a, b = _frames()
    sql = """
    r = TRANSFORM a, b PREPARTITION BY k USING cogroup SCHEMA k:long,n_a:long,sum_v:double,n_b:long,mean_w:double
    """
    before = dict(bg.LAUNCHES)
    got = api.fugue_sql(sql, a=cuda_engine.to_df(a), b=cuda_engine.to_df(b), engine=cuda_engine, as_fugue=True)
    assert bg.LAUNCHES == before
    assert isinstance(got, TorchDataFrame) and got.device == torch.device("cuda:0")
    exp = api.fugue_sql(sql, a=a, b=b, engine="torch", device="cpu", as_fugue=True)
    pd.testing.assert_frame_equal(got.as_pandas().sort_values("k").reset_index(drop=True),
                                  exp.as_pandas().sort_values("k").reset_index(drop=True), rtol=1e-5)


def test_engine_context_on_the_card():
    """Verbs called with no engine inside ``engine_context("torch")`` run
    on the context engine, on ``cuda:0``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, _ = _frames()
    with api.engine_context("torch") as e:
        res = api.aggregate(a, partition_by="k", n=f.count(col("v")), as_fugue=True)
        assert api.get_context_engine() is e
    assert isinstance(res, TorchDataFrame) and res.device == torch.device("cuda:0")
    assert sorted(res.as_pandas()["n"].tolist()) == sorted(a.groupby("k")["v"].count().tolist())
