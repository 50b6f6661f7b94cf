"""The observability and resilience layers on a CUDA card. Without a card
every test here skips. This file imports no JAX, so it also runs where
JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_obs_cuda.py

- the sampler's ``device_bytes`` equals ``torch.cuda.memory_allocated``
  summed over the devices, tensors made and freed in between;
- a sampler started before the process's first CUDA call creates no CUDA
  context (a fresh process: CUDA stays uninitialized while it samples,
  and ``device_bytes`` reads 0.0 until the process itself uses the card);
- a ``torch.profiler`` capture of a traced lowered workflow holds the
  tracer's ``plan.segment`` range, with the B1 kernel launched inside it;
- an injected ``stream.chunk`` fault frees what the failed stream held:
  ``torch.cuda.memory_allocated()`` is back at its value before the call
  as soon as the caller has handled the error, before any collection.
"""

import gc
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
from fugue_tpu_torch.obs import get_sampler, get_span_metrics, get_tracer
from fugue_tpu_torch.obs.sampler import _device_bytes
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.resilience import InjectedFaultError
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

pytestmark = pytest.mark.cuda

ROWS, CHUNK, GROUPS = 1_000_000, 200_000, 1000
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tracer():
    tr = get_tracer()
    tr.clear()
    tr.enable()
    yield tr
    tr.disable()
    tr.clear()
    get_span_metrics().clear()


def _frame(seed: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, GROUPS, ROWS), "v": rng.random(ROWS, dtype=np.float32),
                         "w": rng.random(ROWS, dtype=np.float32)})


def _chain(src, conf=None) -> FugueWorkflow:
    dag = FugueWorkflow(conf)
    (dag.df(src).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
     .partition_by("k").aggregate(s=ff.sum(col("z")), n=ff.count(col("z"))).yield_dataframe_as("r"))
    return dag


def _stream(pdf: pd.DataFrame):
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)
    return LocalDataFrameIterableDataFrame(
        (ArrowDataFrame(tbl.slice(s, CHUNK)) for s in range(0, len(pdf), CHUNK)), schema="k:long,v:float,w:float")


def test_device_bytes_is_memory_allocated(cuda_device):
    torch.cuda.synchronize()
    base = _device_bytes()
    assert base == float(sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count())))
    t = torch.empty(1 << 24, dtype=torch.float32, device=cuda_device)
    assert _device_bytes() == base + t.numel() * t.element_size()
    vals = get_sampler().sample_once()
    assert vals["device_bytes"] == _device_bytes()
    del t
    assert _device_bytes() == base
    get_sampler().clear()


_SAMPLER_FIRST = """
import json, time, torch
from fugue_tpu_torch.obs import get_sampler
s = get_sampler().start(interval=0.005)
time.sleep(0.3)
before = [v["device_bytes"] for _, v in s.series()]
init_before = torch.cuda.is_initialized()
x = torch.ones(1 << 20, device="cuda")
torch.cuda.synchronize()
after = s.sample_once()["device_bytes"]
s.stop()
print("RESULT", json.dumps({"samples": len(before), "max_before": max(before), "init_before": init_before,
                            "after": after, "tensor": x.numel() * x.element_size(), "errors": s.sample_errors}))
"""


def test_sampler_before_the_first_cuda_call_creates_no_context(cuda_device):
    proc = subprocess.run([sys.executable, "-c", _SAMPLER_FIRST], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    res = json.loads(line[len("RESULT "):])
    assert res["samples"] > 10 and res["errors"] == 0
    assert res["init_before"] is False and res["max_before"] == 0.0
    assert res["after"] >= res["tensor"]


def test_plan_segment_range_holds_b1(cuda_device, tracer, tmp_path):
    e = TorchExecutionEngine(device=cuda_device)
    tdf = e.persist(e.to_df(_frame()))

    def call():
        dag = _chain(tdf)
        dag.run(e)
        return dag.yields["r"].result.count()

    call()
    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts,
                                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        call()
        torch.cuda.synchronize()
        prof.step()
        call()
        torch.cuda.synchronize()
        prof.step()
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ranges = chip_smoke.profiled_ranges(path, "plan.segment", "binned_")
    assert bg.LAUNCHES["bin_sum"] == 2
    assert ranges["ranges"] >= 1 and ranges["kernels"] >= 1 and ranges["inside"] == ranges["kernels"], ranges
    assert [r["name"] for r in tracer.records()].count("plan.segment") == 3


def test_stream_chunk_fault_releases_device_memory(cuda_device):
    pdf = _frame(1)
    e = TorchExecutionEngine(device=cuda_device, conf={
        "fugue.tpu.stream.chunk_rows": CHUNK, "fugue.tpu.stream.key_range": f"0,{GROUPS - 1}"})
    ok = _chain(_stream(pdf))
    ok.run(e)  # what a first call creates lazily is there before the baseline
    assert ok.yields["r"].result.count() == GROUPS
    del ok
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    raised = None
    try:  # not pytest.raises: its record of the error would hold the frames
        _chain(_stream(pdf), {"fugue.tpu.fault.plan": "stream.chunk=error@1"}).run(e)
    except InjectedFaultError as ex:
        raised = str(ex)
    assert raised == "injected fault at stream.chunk"
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert not [t for t in threading.enumerate() if t.name.startswith("fugue-torch-prefetch")]
