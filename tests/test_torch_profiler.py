"""The port's profiler hooks (``fugue_tpu_torch/parallel/profiler.py``), the
counterparts of ``tests/core/test_profiler.py``.

``profile`` is a ``torch.profiler`` capture that writes one Chrome trace
file, where the JAX package's writes xplane protobufs; ``annotate`` is a
``record_function`` range. The conf key and ``profiled_engine_context``'s
contract are the reference's, held side by side. The engine names its
regions with the span tracer's names (``plan.segment``, ``engine.join``,
``engine.fused``) through ``annotate``, once a region, whether tracing is
on or off.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fugue_tpu.parallel import profiler as jprofiler
from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.obs import get_tracer
from fugue_tpu_torch.parallel.profiler import (
    FUGUE_TPU_CONF_PROFILE_DIR,
    annotate,
    profile,
    profiled_engine_context,
)
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow


def _trace_files(root) -> list:
    return sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".json"))


def _events(root) -> list:
    files = _trace_files(root)
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def _ranges(events, name: str) -> int:
    return sum(1 for e in events if e.get("name") == name and e.get("ph") == "X"
               and e.get("cat") in ("user_annotation", "cpu_op"))


@pytest.fixture
def tracing():
    tr = get_tracer()
    tr.clear()
    yield tr
    tr.disable()
    tr.clear()


def test_profile_writes_a_chrome_trace_with_the_annotation(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profile(log_dir):
        with annotate("fugue-tpu-test-region"):
            (torch.arange(16.0) * 2).sum()
    events = _events(log_dir)
    assert _ranges(events, "fugue-tpu-test-region") == 1
    # the reference's capture of the same region writes its own artifacts
    ref_dir = str(tmp_path / "ref")
    with jprofiler.profile(ref_dir), jprofiler.annotate("fugue-tpu-test-region"):
        (jnp.arange(16.0) * 2).sum().block_until_ready()
    assert any(files for _, _, files in os.walk(ref_dir))


def test_annotate_without_a_capture_is_a_noop():
    with annotate("no-trace-active"), jprofiler.annotate("no-trace-active"):
        assert float(torch.tensor(1.0)) == 1.0


@pytest.mark.parametrize("engine", ["native", "torch-instance"])
def test_profiled_engine_context_activates_on_conf(tmp_path, engine):
    """The conf key (the reference's) turns a capture on; the engine in
    the context is the one named or given."""
    assert FUGUE_TPU_CONF_PROFILE_DIR == jprofiler.FUGUE_TPU_CONF_PROFILE_DIR == "fugue.tpu.profile.dir"
    log_dir = str(tmp_path / "engine_trace")
    conf = {FUGUE_TPU_CONF_PROFILE_DIR: log_dir}
    if engine == "native":
        with profiled_engine_context("native", conf=conf) as e:
            assert e.conf.get(FUGUE_TPU_CONF_PROFILE_DIR, "") == log_dir
            torch.arange(32.0).sum()
        with jprofiler.profiled_engine_context("native", conf=conf) as je:
            assert je.conf.get(FUGUE_TPU_CONF_PROFILE_DIR, "") == log_dir
    else:
        eng = TorchExecutionEngine(device="cpu")
        with profiled_engine_context(eng, conf=conf) as e:
            assert e is eng and torch._C._autograd._profiler_enabled()
            api.aggregate(pd.DataFrame({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]}), partition_by="k",
                          s=ff.sum(col("v")))
        assert FUGUE_TPU_CONF_PROFILE_DIR not in eng.conf  # the engine's conf is not written
    assert len(_trace_files(log_dir)) == 1


def test_profiled_engine_context_inert_without_conf(tmp_path):
    with profiled_engine_context("native") as e:
        assert e.conf.get(FUGUE_TPU_CONF_PROFILE_DIR, "") == ""
        assert not torch._C._autograd._profiler_enabled()
    with jprofiler.profiled_engine_context("native") as je:
        assert je.conf.get(FUGUE_TPU_CONF_PROFILE_DIR, "") == ""


def test_an_aggregate_names_its_verb_once(tmp_path, tracing):
    """With tracing on, a port aggregate under ``profile`` shows one
    ``engine.aggregate`` range (the traced verb's)."""
    eng = TorchExecutionEngine(device="cpu")
    df = eng.to_df(pd.DataFrame({"k": np.arange(100) % 7, "v": np.arange(100.0)}))
    tracing.enable()
    with profile(str(tmp_path)):
        eng.aggregate(df, PartitionSpec(by=["k"]), [ff.sum(col("v")).alias("s")])
    assert _ranges(_events(str(tmp_path)), "engine.aggregate") == 1


@pytest.mark.parametrize("traced", [False, True])
def test_a_lowered_workflow_names_plan_segment_once(tmp_path, tracing, traced):
    """plan_path's chain (filter → select → aggregate) lowers into one
    segment: one ``plan.segment`` range and no ``fugue::plan_segment``,
    with tracing off and on; with it on, one ``plan.segment`` span too."""
    rng = np.random.default_rng(0)
    pdf = pd.DataFrame({"k": rng.integers(0, 50, 4000), "v": rng.random(4000).astype(np.float32),
                        "w": rng.random(4000).astype(np.float32)})
    eng = TorchExecutionEngine(device="cpu")
    dag = FugueWorkflow()
    (dag.df(pdf).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
     .partition_by("k").aggregate(s=ff.sum(col("z"))).yield_dataframe_as("r", as_local=True))
    if traced:
        tracing.enable()
    with profile(str(tmp_path)):
        dag.run(eng)
    events = _events(str(tmp_path))
    assert _ranges(events, "plan.segment") == 1
    assert _ranges(events, "fugue::plan_segment") == 0
    assert eng.plan_stats.as_dict()["segments_executed"] == 1
    assert sum(r["name"] == "plan.segment" for r in tracing.records()) == (1 if traced else 0)


def test_a_nested_capture_raises(tmp_path):
    with profile(str(tmp_path / "outer")):
        with pytest.raises(RuntimeError, match="already active"):
            with profile(str(tmp_path / "inner")):
                pass
    with torch.profiler.profile():
        with pytest.raises(RuntimeError, match="already active"):
            with profile(str(tmp_path / "inner2")):
                pass
    assert len(_trace_files(str(tmp_path / "outer"))) == 1
    assert not os.path.exists(str(tmp_path / "inner"))
