"""The host engine behind ``TorchExecutionEngine`` on a CUDA card: a host
transformer's input reaches pandas through one copy to the host, its
result comes back as a ``TorchDataFrame`` on ``cuda:0``, and the answers
are the port's own CPU run's on the same inputs. Without a card every test
here skips. This file imports no JAX, so it also runs where JAX is not
installed::

    python -m pytest --noconftest -m cuda tests/test_torch_host_cuda.py

The host map and the host join are the same pandas code on either
device, so results are compared exactly after sorting by every column.
"""

from typing import Any, Dict, List

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fugue_tpu_torch import api
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from fugue_tpu_torch.torch import dataframe as tdf_module

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return TorchExecutionEngine()


def _frame(n: int = 1 << 14) -> pd.DataFrame:
    rng = np.random.default_rng(0)
    return pd.DataFrame({
        "k": rng.integers(0, 50, n),
        "s": np.array(["ant", "bee", None, "cat"], dtype=object)[rng.integers(0, 4, n)],
        "n": pd.array(np.where(rng.random(n) < 0.1, None, rng.integers(0, 9, n)), dtype="Int64"),
        "v": rng.random(n),
    })


def demean(df: pd.DataFrame) -> pd.DataFrame:
    df["v"] = df["v"] - df["v"].mean()
    return df


def _sorted(pdf: pd.DataFrame) -> pd.DataFrame:
    return pdf.sort_values(list(pdf.columns)).reset_index(drop=True)


def test_host_transformer_input_reaches_pandas_through_one_copy(cuda_engine, monkeypatch):
    tdf = cuda_engine.to_df(_frame())
    calls: List[Any] = []
    orig = tdf_module.TorchDataFrame.as_local_bounded

    def spy(self):
        calls.append(self)
        return orig(self)

    monkeypatch.setattr(tdf_module.TorchDataFrame, "as_local_bounded", spy)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = api.transform(tdf, demean, schema="*", partition={"by": ["k"]}, engine=cuda_engine)
        torch.cuda.synchronize()
    # one trip to the host: one copy of each device column (k, s's codes,
    # n and its mask, v), and nothing read back before it
    assert calls == [tdf]
    d2h = sum(e.count for e in prof.key_averages() if "DtoH" in e.key)
    assert d2h == len(tdf.device_cols) + len(tdf.null_masks)
    assert isinstance(res, TorchDataFrame)
    assert res.device == torch.device("cuda", 0)
    assert all(t.device == res.device for t in res.device_cols.values())
    exp = api.transform(_frame(), demean, schema="*", partition={"by": ["k"]}, device="cpu")
    pd.testing.assert_frame_equal(_sorted(res.as_pandas()), _sorted(exp))


def test_every_annotation_form_comes_back_to_the_card(cuda_engine):
    def lists(rows: List[List[Any]]) -> List[List[Any]]:
        return [[r[0], r[3] * 2] for r in rows]

    def dicts(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return [{"k": r["k"], "v": r["v"] * 2} for r in rows]

    def arrow(t: pa.Table) -> pa.Table:
        return t.select(["k", "v"])

    for fn in (lists, dicts, arrow):
        got = api.transform(_frame(512), fn, schema="k:long,v:double", partition=["k"], engine=cuda_engine)
        exp = api.transform(_frame(512), fn, schema="k:long,v:double", partition=["k"], device="cpu")
        assert isinstance(got, pd.DataFrame)
        pd.testing.assert_frame_equal(_sorted(got), _sorted(exp))


def test_host_join_comes_back_to_the_card(cuda_engine):
    """A decimal key: the JAX engine joins it on its host, the port too."""
    import decimal

    dec = pa.decimal128(5, 0)
    left = pa.table({"k": pa.array([decimal.Decimal(i % 7) for i in range(64)], dec),
                     "v": np.arange(64.0)})
    right = pa.table({"k": pa.array([decimal.Decimal(i) for i in range(5)], dec), "w": np.arange(5.0)})
    got = cuda_engine.join(cuda_engine.to_df(left), cuda_engine.to_df(right), how="inner")
    cpu = TorchExecutionEngine(device="cpu")
    exp = cpu.join(cpu.to_df(left), cpu.to_df(right), how="inner")
    assert isinstance(got, TorchDataFrame) and got.device == torch.device("cuda", 0)
    pd.testing.assert_frame_equal(_sorted(got.as_pandas()), _sorted(exp.as_pandas()))


def test_load_and_save_go_through_the_card(cuda_engine, tmp_path):
    path = str(tmp_path / "f.parquet")
    api.save(_frame(256), path, engine=cuda_engine)
    got = api.load(path, engine=cuda_engine)
    assert isinstance(got, TorchDataFrame) and got.device == torch.device("cuda", 0)
    pd.testing.assert_frame_equal(got.as_pandas(), TorchExecutionEngine(device="cpu").to_df(_frame(256)).as_pandas())
