"""The result cache, the delta cache and the tuner on a CUDA card. Without a
card every test here skips. This file imports no JAX, so it also runs where
JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cache_cuda.py

- a LOAD → filter → select → aggregate workflow over a parquet directory:
  the cold run launches B1 once, over every row; a memory hit and a disk
  hit launch it 0 times; a delta run over one more file launches it over
  the new rows only (then over the merged partials), equal to the run
  with the cache off;
- the memory tier holds the result frames on the card, and after
  ``result_cache.clear()`` and a collection ``torch.cuda.memory_allocated``
  is back at its value before the first run, to the byte;
- a streamed lowered aggregate run twice through ``FugueWorkflow.run``:
  the second run merges the source's chunks to the learned size, and B1
  launches once a chunk either way.
"""

import gc

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine, streaming
from fugue_tpu_torch.tuning import tuner
from fugue_tpu_torch.workflow import FugueWorkflow

pytestmark = pytest.mark.cuda

FILE_ROWS, FILES = 400_000, 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _part(i: int):
    rng = np.random.default_rng(70 + i)
    v = rng.random(FILE_ROWS, dtype=np.float32)
    v[rng.random(FILE_ROWS) < 0.01] = np.nan
    return pa.table({"k": rng.integers(0, 1000, FILE_ROWS, dtype=np.int64), "v": v,
                     "w": rng.random(FILE_ROWS, dtype=np.float32)})


def _oracle(tables):
    t = pa.concat_tables(tables)
    k, v, w = (t.column(c).to_numpy() for c in ("k", "v", "w"))
    keep = v > 0.25
    z = (v[keep] * w[keep]).astype(np.float64)
    return np.bincount(k[keep], minlength=1000), np.bincount(k[keep], weights=z, minlength=1000)


def _run(eng, src, conf=None):
    dag = FugueWorkflow(conf)
    (dag.load(src, fmt="parquet").filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
     .partition_by("k").aggregate(s=ff.sum(col("z")), n=ff.count(col("z")))
     .yield_dataframe_as("r", as_local=True))
    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    rows = []
    real = bg.bin_sum

    def spy(keys, values, valid, buckets):
        rows.append(int(keys.shape[0]))
        return real(keys, values, valid, buckets)

    bg.bin_sum = spy
    try:
        dag.run(eng)
        torch.cuda.synchronize()
    finally:
        bg.bin_sum = real
    res = dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True)
    return res, bg.LAUNCHES["bin_sum"], rows


def _check(res, tables):
    n, s = _oracle(tables)
    keys = np.nonzero(n)[0]
    assert np.array_equal(res["k"].to_numpy(), keys) and np.array_equal(res["n"].to_numpy(), n[keys])
    assert np.allclose(res["s"].to_numpy(), s[keys], rtol=1e-4, atol=0)


def test_b1_across_cold_hit_and_delta_and_memory_back(cuda_device, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    tables = [_part(i) for i in range(FILES)]
    for i, t in enumerate(tables):
        pq.write_table(t, src / f"part_{i:03d}.parquet")
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    conf = {"fugue.tpu.cache.dir": str(tmp_path / "cache")}
    eng = TorchExecutionEngine(device=cuda_device, conf=conf)
    cold, launches, rows = _run(eng, str(src))
    assert launches == 1 and rows == [FILES * FILE_ROWS]
    _check(cold, tables)
    warm, launches, rows = _run(eng, str(src))
    assert launches == 0 and rows == [] and eng.stats()["cache"]["hits_mem"] == 1
    fresh = TorchExecutionEngine(device=cuda_device, conf=conf)
    disk, launches, rows = _run(fresh, str(src))
    assert launches == 0 and rows == [] and fresh.stats()["cache"]["hits_disk"] == 1
    assert cold.equals(warm) and cold.equals(disk)
    tables.append(_part(FILES))
    pq.write_table(tables[-1], src / f"part_{FILES:03d}.parquet")
    delta, launches, rows = _run(eng, str(src))
    st = eng.stats()["cache"]
    assert st["partial_hits"] == 1 and st["delta_partitions"] == FILES
    assert rows[0] == FILE_ROWS and all(r <= 2000 for r in rows[1:]) and launches == len(rows)
    _check(delta, tables)
    off = TorchExecutionEngine(device=cuda_device, conf={**conf, "fugue.tpu.cache.enabled": False})
    twin, launches, rows = _run(off, str(src))
    assert launches == 1 and rows == [(FILES + 1) * FILE_ROWS]
    assert np.array_equal(delta["n"].to_numpy(), twin["n"].to_numpy())
    assert np.allclose(delta["s"].to_numpy(), twin["s"].to_numpy(), rtol=1e-4, atol=0)
    held = eng._resource_probe_fns()["result_cache_mem_bytes"](eng)
    assert held == eng.result_cache.mem.bytes > 0
    frames = [df for df, _ in eng.result_cache.mem._entries.values()]
    assert all(df.device == cuda_device for df in frames)
    del frames
    for e in (eng, fresh, off):
        e.result_cache.clear()
    del cold, warm, disk, delta, twin, eng, fresh, off
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


def test_tuned_stream_merges_chunks_and_launches_b1_once_a_chunk(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setattr(tuner, "MIN_WALL_S", 0.0)  # a short stream still teaches
    n, chunk = 64 * 4096, 4096
    rng = np.random.default_rng(3)
    tbl = pa.table({"k": rng.integers(0, 1000, n, dtype=np.int64), "v": rng.random(n, dtype=np.float32),
                    "w": rng.random(n, dtype=np.float32)})
    eng = TorchExecutionEngine(device=cuda_device, conf={
        "fugue.tpu.stream.chunk_rows": chunk, "fugue.tpu.stream.key_range": "0,999",
        "fugue.tpu.tuning.path": str(tmp_path / "t.json")})
    counts = []
    for _ in range(2):
        stream = LocalDataFrameIterableDataFrame(
            (ArrowDataFrame(tbl.slice(s, chunk)) for s in range(0, n, chunk)), schema="k:long,v:float,w:float")
        dag = FugueWorkflow()
        (dag.df(stream).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
         .partition_by("k").aggregate(s=ff.sum(col("z")), n=ff.count(col("z"))).yield_dataframe_as("r", as_local=True))
        for name in bg.LAUNCHES:
            bg.LAUNCHES[name] = 0
        dag.run(eng)
        torch.cuda.synchronize()
        counts.append(streaming.last_run_stats["chunks"])
        assert bg.LAUNCHES["bin_sum"] == counts[-1]
        _check(dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True), [tbl])
    assert counts == [64, 16]
