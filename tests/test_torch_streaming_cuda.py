"""The streaming paths on a CUDA card against the port's own CPU run on the
same chunks. Without a card every test here skips. This file imports no
JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_streaming_cuda.py

The values are multiples of 1/4 of small size, so every sum is exact in
any order of addition: results compare byte for byte, although the card
adds with atomics.
"""

from typing import Dict

import numpy as np
import pandas as pd
import pytest
import torch

from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.constants import (
    FUGUE_TPU_CONF_STREAM_CHUNK_ROWS,
    FUGUE_TPU_CONF_STREAM_KEY_RANGE,
    FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH,
)
from fugue_tpu_torch.dataframe import LocalDataFrameIterableDataFrame
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine, streaming
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

pytestmark = pytest.mark.cuda

GROUPS = 1000
SCHEMA = "k:long,v:double,w:long"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _chunks(rows: int, size: int, f32: bool = False):
    for i, s in enumerate(range(0, rows, size)):
        rng = np.random.default_rng(i)
        n = min(size, rows - s)
        v = rng.integers(-400, 400, n) / 4.0
        yield pd.DataFrame({"k": rng.integers(0, GROUPS, n),
                            "v": v.astype(np.float32) if f32 else v,
                            "w": rng.integers(-50, 50, n)})


def _stream(rows: int, size: int, f32: bool = False) -> LocalDataFrameIterableDataFrame:
    return LocalDataFrameIterableDataFrame(
        _chunks(rows, size, f32), schema="k:long,v:float,w:long" if f32 else SCHEMA)


def _engine(device, chunk: int, depth: int = 2) -> TorchExecutionEngine:
    return TorchExecutionEngine(device=device, conf={
        FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: chunk,
        FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH: depth,
        FUGUE_TPU_CONF_STREAM_KEY_RANGE: f"0,{GROUPS - 1}",
    })


AGGS = [ff.sum(col("v")).alias("s"), ff.count(col("v")).alias("n"), ff.avg(col("v")).alias("m"),
        ff.min(col("v")).alias("lo"), ff.max(col("w")).alias("hi"), ff.sum(col("w")).alias("sw")]


def _aggregate(device, rows, chunk, depth=2, source_chunk=None) -> pd.DataFrame:
    res = _engine(device, chunk, depth).aggregate(
        _stream(rows, source_chunk or chunk), PartitionSpec(by=["k"]), AGGS)
    return res.as_pandas().sort_values("k").reset_index(drop=True)


def _join_map(device, rows, chunk, depth=2) -> pd.DataFrame:
    eng = _engine(device, chunk, depth)
    dim = pd.DataFrame({"k": np.arange(0, GROUPS, 2), "c": np.arange(0, GROUPS, 2) * 0.5,
                        "tag": [f"t{i}" for i in range(0, GROUPS, 2)]})
    joined = eng.join(_stream(rows, chunk), eng.to_df(dim), how="left_outer")
    parts = [p.as_pandas() for p in joined.native]
    assert streaming.last_run_stats["verb"] == "join"
    joined = pd.concat(parts, ignore_index=True)

    def fn(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": cols["k"], "y": cols["v"] * 2.0 + cols["w"]}

    mapped = api.transform(_stream(rows, chunk), fn, schema="k:long,y:double", engine=eng)
    assert isinstance(mapped, LocalDataFrameIterableDataFrame)
    y = mapped.as_pandas()
    assert streaming.last_run_stats["verb"] == "map"
    return pd.concat([joined, y.rename(columns={"k": "k2"})], axis=1)


def test_card_and_cpu_give_the_same_bytes(cuda_device):
    rows, chunk = 3_000_000, 1 << 19
    pd.testing.assert_frame_equal(_aggregate(cuda_device, rows, chunk), _aggregate("cpu", rows, chunk))
    pd.testing.assert_frame_equal(_join_map(cuda_device, rows, chunk), _join_map("cpu", rows, chunk))


def test_serial_and_prefetched_streams_give_the_same_bytes(cuda_device):
    rows, chunk = 3_000_000, 1 << 19
    pd.testing.assert_frame_equal(_aggregate(cuda_device, rows, chunk, depth=0),
                                  _aggregate(cuda_device, rows, chunk, depth=2))
    pd.testing.assert_frame_equal(_join_map(cuda_device, rows, chunk, depth=0),
                                  _join_map(cuda_device, rows, chunk, depth=2))


def test_peak_memory_follows_the_chunk_not_the_stream(cuda_device):
    chunk = 1 << 20

    def peak(rows: int, size: int) -> int:
        torch.cuda.empty_cache()
        _aggregate(cuda_device, rows, size, source_chunk=chunk)
        return streaming.last_run_stats["peak_device_bytes"]

    base = peak(8 * chunk, chunk)
    assert peak(32 * chunk, chunk) <= 1.1 * base  # four times the chunks
    assert peak(32 * chunk, 4 * chunk) >= 2 * base  # four times the chunk's rows


def test_float32_sum_launches_b1_once_a_chunk(cuda_device):
    rows, chunk = 2_500_000, 1 << 19
    eng = _engine(cuda_device, chunk)
    for k in bg.LAUNCHES:
        bg.LAUNCHES[k] = 0
    res = eng.aggregate(_stream(rows, chunk, f32=True), PartitionSpec(by=["k"]),
                        [ff.sum(col("v")).alias("s"), ff.avg(col("v")).alias("m")])
    chunks = -(-rows // chunk)
    assert streaming.last_run_stats["chunks"] == chunks
    assert bg.LAUNCHES == {"bin_sum": chunks, "bin_sum_count": 0}
    cpu = _engine("cpu", chunk).aggregate(_stream(rows, chunk, f32=True), PartitionSpec(by=["k"]),
                                          [ff.sum(col("v")).alias("s"), ff.avg(col("v")).alias("m")])
    pd.testing.assert_frame_equal(res.as_pandas().sort_values("k").reset_index(drop=True),
                                  cpu.as_pandas().sort_values("k").reset_index(drop=True))
