"""The warehouse and the hybrid engine (``sqlite_torch``) on a CUDA card:
a torch UDF's map returns a ``TorchDataFrame`` on ``cuda:0``, ``CONNECT
torch`` from the hybrid over a float32 column launches B1 once and
matches ``bin_sum_ref``, ``CONNECT sqlite`` from a frame on ``cuda:0``
answers as on the CPU, and ``stop()`` gives the device its bytes back.
Without a card every test here skips. This file imports no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_warehouse_cuda.py
"""

import gc
from typing import Dict

import numpy as np
import pandas as pd
import pytest
import torch

from fugue_tpu_torch import api
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from fugue_tpu_torch.torch import group_ops as go
from fugue_tpu_torch.warehouse import WarehouseDataFrame, WarehouseTorchExecutionEngine

pytestmark = pytest.mark.cuda
NO_CACHE = {"fugue.tpu.cache.enabled": False}


@pytest.fixture
def hybrid():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    e = WarehouseTorchExecutionEngine(NO_CACHE)
    yield e
    e.stop()


def _frame(n: int = 1 << 14) -> pd.DataFrame:
    rng = np.random.default_rng(0)
    return pd.DataFrame({"k": rng.integers(0, 100, n), "v": rng.random(n).astype(np.float32),
                         "w": rng.random(n)})


def demean(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    z = ((cols["v"] - go.per_row(cols, go.mean(cols, cols["v"]))) * cols["w"]).float()
    return {"k": cols["k"], "z": z}


def _reset() -> None:
    for k in bg.LAUNCHES:
        bg.LAUNCHES[k] = 0


def test_the_map_of_a_torch_udf_runs_on_the_card(hybrid):
    assert hybrid.device == torch.device("cuda", 0)
    seen = []
    orig = hybrid.torch_engine.map_engine.map_dataframe

    def spy(*a, **k):
        res = orig(*a, **k)
        seen.append(res)
        return res

    hybrid.torch_engine.map_engine.map_dataframe = spy
    wdf = hybrid.to_df(_frame())
    out = api.transform(wdf, demean, schema="k:long,z:float", partition={"by": ["k"]}, engine=hybrid,
                        as_fugue=True)
    assert len(seen) == 1 and isinstance(seen[0], TorchDataFrame) and seen[0].device.type == "cuda"
    assert isinstance(out, WarehouseDataFrame) and str(out.as_arrow().schema.field("z").type) == "float"
    cpu = WarehouseTorchExecutionEngine(NO_CACHE, device="cpu")
    ref = api.transform(cpu.to_df(_frame()), demean, schema="k:long,z:float", partition={"by": ["k"]},
                        engine=cpu, as_fugue=True)
    g = out.as_pandas().sort_values(["k", "z"]).reset_index(drop=True)
    r = ref.as_pandas().sort_values(["k", "z"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(g, r, rtol=1e-5, atol=1e-6)
    cpu.stop()


def test_connect_torch_from_the_hybrid_launches_b1_once(hybrid):
    pdf = _frame()
    _reset()
    # pdf lands in sqlite with its recorded schema (v:float), so the
    # temporary torch engine reads v back as float32
    res = api.fugue_sql("""
    sums = CONNECT torch SELECT k, SUM(v) AS s FROM pdf WHERE w > 0.1 GROUP BY k
    SELECT k, s FROM sums ORDER BY k
    """, pdf=pdf, engine=hybrid, as_fugue=True)
    assert bg.LAUNCHES["bin_sum"] == 1
    got = res.as_pandas()
    keep = pdf[pdf["w"] > 0.1]
    keys = torch.as_tensor(keep["k"].to_numpy(), dtype=torch.int32)
    vals = torch.as_tensor(keep["v"].to_numpy())
    want = bg.bin_sum_ref(keys, vals, None, 128)[:100]
    np.testing.assert_array_equal(got["k"].to_numpy(), np.arange(100))
    np.testing.assert_allclose(got["s"].to_numpy(), want.numpy(), rtol=1e-5, atol=1e-3)


def test_connect_sqlite_from_a_cuda_frame_answers_as_on_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pdf = _frame()
    q = """
    a = CONNECT sqlite SELECT k, COUNT(*) AS n, SUM(w) AS s FROM t WHERE v > 0.5 GROUP BY k
    SELECT k, n, s FROM a ORDER BY k
    """
    got = api.fugue_sql(q, t=TorchExecutionEngine(conf=NO_CACHE).to_df(pdf), engine=TorchExecutionEngine(conf=NO_CACHE),
                        as_fugue=True)
    cpu = TorchExecutionEngine(device="cpu", conf=NO_CACHE)
    want = api.fugue_sql(q, t=cpu.to_df(pdf), engine=cpu, as_fugue=True)
    assert isinstance(got, TorchDataFrame) and got.device.type == "cuda"
    assert str(got.schema) == str(want.schema) and got.as_array() == want.as_array()


def test_device_memory_back_after_stop():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    e = WarehouseTorchExecutionEngine(NO_CACHE)
    res = api.fugue_sql("""
    c = TRANSFORM pdf PREPARTITION BY k USING demean SCHEMA k:long,z:float
    sums = CONNECT torch SELECT k, SUM(z) AS s FROM c GROUP BY k
    SELECT k, s FROM sums ORDER BY k
    """, pdf=_frame(), engine=e, as_fugue=True)
    assert res.count() == 100
    del res
    gc.collect()
    left = e.connection.execute("SELECT name FROM sqlite_temp_master WHERE type='table'").fetchall()
    e.stop()
    del e
    gc.collect()
    torch.cuda.synchronize()
    assert left == [] and torch.cuda.memory_allocated() == before
