"""The spill ladder on a CUDA card: a join past the device budget spills
and joins bucket pair by bucket pair on ``cuda:0`` and equals its twin
joined whole (``fugue.tpu.shuffle.enabled=false``); a stream the
streaming plan refuses spills; a spilled repartition keeps every key in
one chunk; the pairs' peak stays under the budget, and measuring it
leaves an outer ``max_memory_allocated`` reader's peak as it was. Without
a card every test here skips. This file imports no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_shuffle_cuda.py
"""

import gc
import glob
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame, PandasDataFrame
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine

pytestmark = pytest.mark.cuda
BUDGET = 1 << 20
HOWS = ["inner", "left_outer", "left_semi", "left_anti", "right_outer", "full_outer"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _engines(dev, tmp_path, **conf):
    base = {"fugue.tpu.cache.enabled": False, "fugue.tpu.shuffle.dir": str(tmp_path), **conf}
    spill = TorchExecutionEngine(dev, conf={**base, "fugue.tpu.shuffle.device_budget_bytes": BUDGET})
    whole = TorchExecutionEngine(dev, conf={**base, "fugue.tpu.shuffle.enabled": False})
    return spill, whole


def _frames(n=200_000, seed=0):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, n // 4, n).astype(object)
    lk[::97] = None
    left = pd.DataFrame({"k": pd.array(lk, dtype="Int64"), "a": rng.random(n, dtype=np.float32),
                         "s": rng.choice(["x", "yy", "zzz"], n)})
    right = pd.DataFrame({"k": rng.integers(0, n // 4, n // 2), "b": rng.normal(size=n // 2)})
    return left, right


def _norm(res):
    pdf = res.as_arrow().replace_schema_metadata(None).to_pandas()
    return pdf.sort_values(list(pdf.columns)).reset_index(drop=True)


@pytest.mark.parametrize("how", HOWS)
def test_a_spilled_join_on_the_card_equals_its_whole_twin(dev, tmp_path, how):
    left, right = _frames()
    spill, whole = _engines(dev, tmp_path)
    got = _norm(spill.join(PandasDataFrame(left), PandasDataFrame(right), how=how, on=["k"]))
    st = spill.stats()["shuffle"]
    assert st["joins_spill"] == 1 and st["bucket_joins"] > 1, st
    assert 0 < st["peak_device_bytes"] <= BUDGET, st["peak_device_bytes"]
    assert st["device_budget_source"] == "conf"
    exp = _norm(whole.join(whole.to_df(left), whole.to_df(right), how=how, on=["k"]))
    pd.testing.assert_frame_equal(got, exp[list(got.columns)])
    assert not glob.glob(os.path.join(str(tmp_path), "shuffle-*"))


def test_a_refused_stream_join_spills_on_the_card(dev, tmp_path):
    left, right = _frames(seed=1)
    tbl = pa.Table.from_pandas(left, preserve_index=False)
    spill, whole = _engines(dev, tmp_path)
    stream = LocalDataFrameIterableDataFrame(
        (ArrowDataFrame(tbl.slice(s, 40_000)) for s in range(0, tbl.num_rows, 40_000)))
    got = _norm(spill.join(stream, PandasDataFrame(right), how="left_semi", on=["k"]))
    assert spill.stats()["shuffle"]["joins_spill"] == 1
    exp = _norm(whole.join(whole.to_df(left), whole.to_df(right), how="left_semi", on=["k"]))
    pd.testing.assert_frame_equal(got, exp)


def test_a_spilled_repartition_on_the_card_keeps_keys_whole(dev, tmp_path):
    left, _ = _frames(seed=2)
    spill, _ = _engines(dev, tmp_path)
    tdf = spill.to_df(left)
    assert isinstance(tdf, TorchDataFrame) and tdf.device == dev
    res = spill.repartition(tdf, PartitionSpec(algo="hash", by=["k"]))
    seen, parts = set(), []
    for sub in res.native:
        t = sub.as_pandas()
        keys = set(t["k"].dropna().tolist()) | ({None} if t["k"].isna().any() else set())
        assert not (keys & seen)
        seen |= keys
        parts.append(t)
    got = pd.concat(parts).sort_values(["k", "a", "s"]).reset_index(drop=True)
    exp = left.sort_values(["k", "a", "s"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(got, exp.astype(got.dtypes.to_dict()))
    assert spill.stats()["shuffle"]["repartitions_spill"] == 1


@pytest.mark.parametrize("pipelined", [True, False])
def test_the_pair_peak_leaves_an_outer_readers_peak(dev, tmp_path, pipelined):
    """An outer reader resets the peak, holds a tensor and frees a larger
    one, then a spill join runs (it resets the peak at every pair): the
    reader's ``max_memory_allocated`` afterwards is what it would have
    been without the join, and the join's own peak is still measured."""
    left, right = _frames(seed=3)
    spill, _ = _engines(dev, tmp_path, **{"fugue.tpu.shuffle.pipeline.enabled": pipelined})
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.empty(1 << 20, dtype=torch.uint8, device=dev)
    big = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    del big
    outer = torch.cuda.max_memory_allocated(dev)
    got = spill.join(PandasDataFrame(left), PandasDataFrame(right), how="inner", on=["k"]).as_pandas()
    torch.cuda.synchronize()
    assert len(got) > 0
    st = spill.stats()["shuffle"]
    assert 0 < st["peak_device_bytes"] <= BUDGET
    # the join's own pairs stay far under the 64 MiB the reader saw
    assert torch.cuda.max_memory_allocated(dev) == outer
    del held
