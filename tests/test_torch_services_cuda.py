"""The profiler hooks and the host map's fork pool on a CUDA card. Without a
card every test here skips. This file imports no JAX, so it also runs
where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_services_cuda.py

- a pooled host map forked after CUDA is initialized and a kernel has run
  equals the serial map, and its children ran the UDF without touching
  CUDA (a child that did would raise, and its chunk would fall back to
  the driver: no fallback, retry or lost worker is counted);
- the pandas frame the children read is pageable: no column is a view of
  pinned host memory, which CUDA keeps out of a forked child;
- ``profile()`` of a lowered workflow, with tracing off, holds one
  ``plan.segment`` range with the B1 kernel launched inside it;
- so does a ``profile()`` made after 20 earlier captures and then
  ``IDLE_AFTER_CAPTURES_S`` seconds idle, and it keeps the kernel of every
  launch it recorded: a capture made a while after earlier ones loses its
  first kernel records, which the warm-up step's small kernels take (with
  ``WARMUP_KERNELS = 0`` this test fails).
"""

import os
import sys
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.execution import parallel_map as pm
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.parallel.profiler import profile
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow

pytestmark = pytest.mark.cuda

ROWS, GROUPS = 400_000, 500
ROOT = Path(__file__).resolve().parent.parent
POOL = {"fugue.tpu.map.parallelism": 4, "fugue.tpu.map.parallel_min_rows": 0}
# idle seconds after the earlier captures: long enough that a capture
# without the warm-up kernels loses records on the H100
IDLE_AFTER_CAPTURES_S = 120.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frame(seed: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, GROUPS, ROWS), "v": rng.random(ROWS, dtype=np.float32),
                         "w": rng.random(ROWS, dtype=np.float32)})


def where_it_ran(df: pd.DataFrame) -> pd.DataFrame:
    df["v"] = df["v"] - df["v"].mean()
    df["pid"] = os.getpid()
    df["bad_fork"] = bool(torch.cuda._is_in_bad_fork())
    return df


def _rows(res) -> pd.DataFrame:
    pdf = res.as_pandas() if isinstance(res, TorchDataFrame) else res
    return pdf.sort_values(["k", "w"]).reset_index(drop=True)


def test_pooled_map_after_a_kernel_matches_serial(cuda_device):
    e = TorchExecutionEngine(device=cuda_device, conf=POOL)
    tdf = e.persist(e.to_df(_frame()))
    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    e.aggregate(tdf, PartitionSpec(by=["k"]), [ff.sum(col("v")).alias("s")]).count()
    assert bg.LAUNCHES["bin_sum"] == 1 and torch.cuda.is_initialized()
    schema = "k:long,v:float,w:float,pid:long,bad_fork:bool"
    pooled = api.transform(tdf, where_it_ran, schema=schema, partition={"by": ["k"]}, engine=e, as_fugue=True)
    assert isinstance(pooled, TorchDataFrame) and pooled.device == cuda_device
    serial = api.transform(tdf, where_it_ran, schema=schema, partition={"by": ["k"]},
                           engine=TorchExecutionEngine(device=cuda_device), as_fugue=True)
    got, exp = _rows(pooled), _rows(serial)
    assert got[["k", "w"]].equals(exp[["k", "w"]])
    assert np.allclose(got["v"].to_numpy(), exp["v"].to_numpy(), rtol=1e-6, atol=1e-7)
    assert set(got["pid"]) - {os.getpid()} and got["bad_fork"].all() and not exp["bad_fork"].any()
    st = e.resilience_stats.as_dict()
    assert st["map.chunks_ok"] >= 4 and st["map.worker_partitions"] == GROUPS
    assert not {k for k in st if k in ("map.worker_lost", "map.chunk_retries", "map.serial_fallbacks",
                                        "map.quarantined_chunks")}, st
    assert not pm._FORK_STATE


def test_the_pooled_frame_is_pageable(cuda_device, monkeypatch):
    seen = []
    real = pm.run_partitions_forked

    def spy(pdf, *a, **k):
        for c in pdf.columns:
            arr = pdf[c].to_numpy()
            if arr.dtype.kind in "biuf":
                with warnings.catch_warnings():  # a read-only view: torch warns, and reads it
                    warnings.simplefilter("ignore")
                    seen.append((c, torch.from_numpy(arr).is_pinned()))
        return real(pdf, *a, **k)

    monkeypatch.setattr(pm, "run_partitions_forked", spy)
    e = TorchExecutionEngine(device=cuda_device, conf=POOL)
    tdf = e.to_df(_frame(1))
    assert not any(torch.from_numpy(e._host(tdf).as_pandas()[c].to_numpy()).is_pinned() for c in ("k", "v"))
    api.transform(tdf, where_it_ran, schema="k:long,v:float,w:float,pid:long,bad_fork:bool",
                  partition={"by": ["k"]}, engine=e)
    assert [c for c, _ in seen] == ["k", "v", "w"]
    assert not any(pinned for _, pinned in seen), seen


def test_profile_records_b1_inside_plan_segment(cuda_device, tmp_path):
    e = TorchExecutionEngine(device=cuda_device)
    tdf = e.persist(e.to_df(_frame(2)))

    def call():
        dag = FugueWorkflow()
        (dag.df(tdf).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
         .partition_by("k").aggregate(s=ff.sum(col("z"))).yield_dataframe_as("r"))
        dag.run(e)
        return dag.yields["r"].result.count()

    assert call() == GROUPS
    with profile(str(tmp_path / "warm")):
        call()
    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    with profile(str(tmp_path / "trace")):
        call()
    assert bg.LAUNCHES["bin_sum"] == 1
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ranges = chip_smoke.profiled_ranges(str(files[0]), "plan.segment", "binned_")
    assert ranges["ranges"] == 1 and ranges["kernels"] == 1 and ranges["inside"] == 1, ranges
    assert chip_smoke.profiled_ranges(str(files[0]), "fugue::plan_segment", "binned_")["ranges"] == 0


def test_profile_after_earlier_captures_and_idle_keeps_every_kernel(cuda_device, tmp_path):
    import time

    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as tprofile

    e = TorchExecutionEngine(device=cuda_device)
    tdf = e.persist(e.to_df(_frame(3)))

    def call():
        dag = FugueWorkflow()
        (dag.df(tdf).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
         .partition_by("k").aggregate(s=ff.sum(col("z"))).yield_dataframe_as("r"))
        dag.run(e)
        return dag.yields["r"].result.count()

    assert call() == GROUPS
    x = torch.ones(1 << 16, device=cuda_device)
    for _ in range(20):  # captures as chip_smoke._trace makes them
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                      schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as p:
            (x * 2).sum()
            torch.cuda.synchronize()
            p.step()
            (x * 3).sum()
            torch.cuda.synchronize()
            p.step()
    # the loss grows with the time since the last capture, not with their number
    time.sleep(IDLE_AFTER_CAPTURES_S)
    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    with profile(str(tmp_path / "trace")):
        call()
    assert bg.LAUNCHES["bin_sum"] == 1
    (path,) = list((tmp_path / "trace").glob("*.json"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    records = chip_smoke.launches_without_kernel(str(path))
    assert records["launches"] > 0 and records["without_kernel"] == 0, records
    ranges = chip_smoke.profiled_ranges(str(path), "plan.segment", "binned_")
    assert ranges["ranges"] == 1 and ranges["kernels"] == 1 and ranges["inside"] == 1, ranges
