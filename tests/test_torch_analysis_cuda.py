"""The UDF analyzer's translated segment on a CUDA card. Without a card
every test here skips. This file imports no JAX, so it also runs where JAX
is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_analysis_cuda.py

- a pandas UDF the analyzer translates (``scale``: ``z = fillna(v, 0) * w``
  as float32, kept where ``z > 0.1``) lowers with the aggregate after it
  into one segment: B1 (``bin_sum``) launches once a call over a frame on
  the card and once a chunk over a stream, and the result equals its twin
  with ``fugue.tpu.plan.analyze_udfs=false`` (the UDF in pandas on the
  host) and a float64 numpy oracle (keys and counts exact, sums
  ``rtol=1e-4``);
- a callback reaches a UDF that runs on the host behind the device
  engine, once a key.
"""

from typing import Callable

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

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
ANALYZE = "fugue.tpu.plan.analyze_udfs"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def scale(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"].fillna(0.0) * df["w"]
    df = df[df["z"] > 0.1]
    return df


def report_rows(df: pd.DataFrame, cb: Callable) -> pd.DataFrame:
    cb(len(df))
    return df


def _frame(seed: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    v = rng.random(ROWS, dtype=np.float32)
    v[rng.random(ROWS) < 0.01] = np.nan
    return pd.DataFrame({"k": rng.integers(0, GROUPS, ROWS), "v": v, "w": rng.random(ROWS, dtype=np.float32)})


def _oracle(pdf: pd.DataFrame) -> pd.DataFrame:
    v, w, k = pdf["v"].to_numpy(), pdf["w"].to_numpy(), pdf["k"].to_numpy()
    z = np.where(np.isnan(v), np.float32(0), v) * w
    keep = z > np.float32(0.1)
    return pd.DataFrame({"k": np.arange(GROUPS),
                         "s": np.bincount(k[keep], weights=z[keep].astype(np.float64), minlength=GROUPS),
                         "n": np.bincount(k[keep], minlength=GROUPS)})


def _run(engine, src, conf=None):
    dag = FugueWorkflow(conf)
    (dag.df(src).transform(scale, schema="*,z:float").partition_by("k")
     .aggregate(s=ff.sum(col("z")), n=ff.count(col("z"))).yield_dataframe_as("r"))
    dag.run(engine)
    return dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True), dag.last_plan_report


def _same(got: pd.DataFrame, exp: pd.DataFrame) -> None:
    assert got["k"].tolist() == exp["k"].tolist() and got["n"].tolist() == exp["n"].tolist()
    assert np.allclose(got["s"].to_numpy(), exp["s"].to_numpy(), rtol=RTOL, atol=0)


@pytest.mark.parametrize("stream", [False, True])
def test_translated_segment_launches_b1(cuda_device, stream):
    pdf = _frame()
    exp = _oracle(pdf)
    eng = TorchExecutionEngine(device=cuda_device, conf={"fugue.tpu.stream.chunk_rows": CHUNK,
                                                         "fugue.tpu.stream.key_range": f"0,{GROUPS - 1}"})
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)

    def src():
        if not stream:
            return eng.persist(eng.to_df(pdf))
        return LocalDataFrameIterableDataFrame(
            (ArrowDataFrame(tbl.slice(s, CHUNK)) for s in range(0, ROWS, CHUNK)),
            schema=ArrowDataFrame(tbl.slice(0, 0)).schema)

    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    got, rep = _run(eng, src())
    assert bg.LAUNCHES["bin_sum"] == (ROWS // CHUNK if stream else 1)
    assert rep.udfs_translated == 1 and eng.plan_stats.as_dict()["segments_executed"] == 1
    assert eng.plan_stats.as_dict()["segments_fallback"] == 0
    twin, twin_rep = _run(eng, src(), {ANALYZE: False})
    assert twin_rep.udfs_analyzed == 0
    _same(got, exp)
    _same(twin, exp)


def test_callback_on_the_device_engine(cuda_device):
    eng = TorchExecutionEngine(device=cuda_device)
    pdf = _frame().iloc[:100_000]
    rows = []
    dag = FugueWorkflow()
    dag.df(pdf).partition_by("k").transform(report_rows, schema="*", callback=rows.append).yield_dataframe_as("r")
    dag.run(eng)
    assert dag.yields["r"].result.count() == len(pdf)
    assert len(rows) == pdf["k"].nunique() and sum(rows) == len(pdf)
