"""The port's ingest pipeline (``fugue_tpu_torch/torch/pipeline.py``) on
the CPU: the cases of ``tests/jax_engine/test_pipeline.py`` that the port
covers.

- A prefetched stream (depth 2) gives exactly the serial one's result
  (depth 0) on the aggregate, the compiled map and the keyed map, and both
  match ``JaxExecutionEngine``'s on the same chunks (exact keys and
  counts; floats with pandas' ``assert_frame_equal`` default);
- the prefetcher's contracts: a producer's exception re-raised with its
  traceback, at most ``depth`` chunks read ahead, depth 0 starting no
  thread, a closed prefetcher stopping its producer, and the stats
  measuring overlap;
- the staging copy pads a short chunk with zeros.
"""

import time
import traceback
from typing import Dict

import jax
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu.api as fa
from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
from fugue_tpu.dataframe import PandasDataFrame as JPandasDataFrame
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu.jax import group_ops as jgo
from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.constants import (
    FUGUE_TPU_CONF_STREAM_CHUNK_ROWS,
    FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH,
)
from fugue_tpu_torch.dataframe import (
    ArrowDataFrame,
    LocalDataFrameIterableDataFrame,
    PandasDataFrame,
)
from fugue_tpu_torch.torch import TorchExecutionEngine, pipeline, streaming
from fugue_tpu_torch.torch import group_ops as go
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

CHUNK = 2048


def _conf(depth: int) -> dict:
    return {FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: CHUNK, FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH: depth}


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine(_conf(2))
    yield e
    e.stop_engine()


def _frame(n: int = 30_000, groups: int = 128, seed: int = 3) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, groups, n), "v": rng.random(n)})


def _streams(pdf: pd.DataFrame, n_chunks: int = 11):
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)
    step = max(1, (tbl.num_rows + n_chunks - 1) // n_chunks)
    parts = [tbl.slice(s, min(step, tbl.num_rows - s)) for s in range(0, tbl.num_rows, step)]
    return (JStream((JArrowDataFrame(t) for t in parts), schema=JArrowDataFrame(tbl).schema),
            LocalDataFrameIterableDataFrame((ArrowDataFrame(t) for t in parts),
                                            schema=ArrowDataFrame(tbl).schema))


def _serial_and_prefetched(run) -> dict:
    """``run(engine, stream of the port)`` at depth 0 and depth 2, as pandas;
    the prefetched run's pipeline stats checked."""
    out = {}
    for depth in (0, 2):
        e = TorchExecutionEngine(device="cpu", conf=_conf(depth))
        out[depth] = run(e)
        last = e.pipeline_stats.last_run
        assert (last == {}) if depth == 0 else (last["chunks_prefetched"] >= 8)
    pd.testing.assert_frame_equal(out[0], out[2])  # exact, dtypes too
    return out


def test_prefetched_aggregate_is_the_serial_one(jax_engine):
    pdf = _frame()
    aggs = [("sv", "sum"), ("n", "count"), ("m", "avg")]
    out = _serial_and_prefetched(lambda e: e.aggregate(
        _streams(pdf)[1], PartitionSpec(by=["k"]),
        [getattr(ff, f)(col("v")).alias(n) for n, f in aggs]).as_pandas().sort_values("k")
        .reset_index(drop=True))
    assert streaming.last_run_stats["rows"] == len(pdf)
    exp = jax_engine.aggregate(_streams(pdf)[0], JPartitionSpec(by=["k"]),
                               [getattr(jff, f)(jcol("v")).alias(n) for n, f in aggs])
    pd.testing.assert_frame_equal(out[2], exp.as_pandas().sort_values("k").reset_index(drop=True),
                                  check_dtype=False)


def test_prefetched_compiled_map_is_the_serial_one(jax_engine):
    pdf = _frame()

    def tfn(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": cols["k"], "v2": cols["v"] * 2.0 + cols["k"]}

    def jfn(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        return {"k": cols["k"], "v2": cols["v"] * 2.0 + cols["k"]}

    out = _serial_and_prefetched(lambda e: api.transform(
        _streams(pdf)[1], tfn, schema="k:long,v2:double", engine=e).as_pandas())
    exp = fa.transform(_streams(pdf)[0], jfn, schema="k:long,v2:double", engine=jax_engine,
                       as_fugue=True)
    pd.testing.assert_frame_equal(out[2], exp.as_pandas(), check_dtype=False)


def test_prefetched_keyed_map_is_the_serial_one(jax_engine):
    rng = np.random.default_rng(9)
    pdf = pd.DataFrame({"k": np.repeat(np.arange(40), rng.integers(5, 120, 40))})
    pdf["v"] = rng.random(len(pdf))
    schema = "k:long,v:double"
    parts = [pdf.iloc[s : s + 333] for s in range(0, len(pdf), 333)]

    def tfn(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": cols["k"], "rn": go.row_number(cols), "rs": go.running_sum(cols, cols["v"])}

    def jfn(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        return {"k": cols["k"], "rn": jgo.row_number(cols), "rs": jgo.running_sum(cols, cols["v"])}

    out = _serial_and_prefetched(lambda e: api.transform(
        LocalDataFrameIterableDataFrame((PandasDataFrame(p, schema) for p in parts), schema=schema),
        tfn, schema="k:long,rn:long,rs:double", partition=PartitionSpec(by=["k"], presort="v"),
        engine=e).as_pandas())
    exp = fa.transform(JStream((JPandasDataFrame(p, schema) for p in parts), schema=schema), jfn,
                       schema="k:long,rn:long,rs:double",
                       partition=JPartitionSpec(by=["k"], presort="v"), engine=jax_engine,
                       as_fugue=True)
    # the reference's rows come out by mesh shard: compare as row sets
    pd.testing.assert_frame_equal(out[2].sort_values(["k", "rn"]).reset_index(drop=True),
                                  exp.as_pandas().sort_values(["k", "rn"]).reset_index(drop=True),
                                  check_dtype=False)


# ---- the prefetcher's contracts ---------------------------------------------


def test_producer_exception_propagates_with_original_traceback():
    def poisoned_source():
        yield 1
        yield 2
        raise ValueError("poison chunk #3")

    pf = pipeline.maybe_prefetch(poisoned_source(), depth=2)
    assert next(pf) == 1
    assert next(pf) == 2
    with pytest.raises(ValueError, match="poison chunk #3") as ei:
        next(pf)
    frames = traceback.extract_tb(ei.value.__traceback__)
    assert any(f.name == "poisoned_source" for f in frames)


def test_bounded_queue_depth_under_slow_consumer():
    produced = []

    def src():
        for i in range(40):
            produced.append(i)
            yield i

    depth = 2
    pf = pipeline.maybe_prefetch(src(), depth=depth)
    got = []
    try:
        for x in pf:
            time.sleep(0.003)  # a slow consumer: the producer must not run away
            got.append(x)
            # the queue, one handed to the consumer and one being made
            assert len(produced) <= len(got) + depth + 2
    finally:
        pf.close()
    assert got == list(range(40))


def test_serial_mode_is_threadless_passthrough():
    it = pipeline.maybe_prefetch(iter([1, 2, 3]), depth=0)
    assert isinstance(it, pipeline._SerialChunks)
    assert list(it) == [1, 2, 3]
    it.close()  # no-op, must not raise


def test_abandoned_consumer_stops_producer():
    def src():
        for i in range(10_000):
            yield i

    pf = pipeline.maybe_prefetch(src(), depth=2)
    assert next(pf) == 0
    pf.close()  # the consumer leaves mid-stream
    deadline = time.time() + 5
    while pf._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not pf._thread.is_alive(), "the producer thread must end"


def test_abandoned_stream_result_stops_its_producer():
    """A consumer that reads one chunk of a streamed map and drops it: the
    generator's ``finally`` closes the prefetcher and its thread ends."""
    import gc
    import threading

    e = TorchExecutionEngine(device="cpu", conf=_conf(2))

    def fn(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"v": cols["v"]}

    out = api.transform(_streams(_frame())[1], fn, schema="v:double", engine=e)
    next(iter(out.native))
    del out
    gc.collect()
    deadline = time.time() + 5
    while (any(t.name.startswith("fugue-torch-prefetch") for t in threading.enumerate())
           and time.time() < deadline):
        time.sleep(0.01)
    assert not any(t.name.startswith("fugue-torch-prefetch") for t in threading.enumerate())


def test_pipeline_stats_measures_overlap():
    stats = pipeline.PipelineStats()

    def slow_src():
        for i in range(20):
            time.sleep(0.004)  # host decode stand-in
            yield i

    pf = pipeline.maybe_prefetch(slow_src(), depth=2, stats=stats, verb="x")
    try:
        for _ in pf:
            time.sleep(0.004)  # device work stand-in
    finally:
        pf.close()
    run = stats.last_run
    assert run["verb"] == "x"
    assert run["chunks_prefetched"] == 20
    assert run["producer_busy_s"] > 0
    # both sides busy ~80 ms each, the wall well under 160 ms
    assert 0.0 < run["overlap_fraction"] <= 1.0
    total = stats.as_dict()
    assert total["runs"] == 1 and total["chunks_prefetched"] == 20
    assert total["last_run"]["verb"] == "x" and total["by_verb"]["x"]["runs"] == 1


def test_default_depth_follows_the_device():
    assert pipeline.default_prefetch_depth(torch.device("cuda", 0)) == pipeline.DEFAULT_PREFETCH_DEPTH
    e = TorchExecutionEngine(device="cpu", conf={FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH: "0"})
    assert pipeline.prefetch_depth(e.conf, e.device) == 0


def test_staging_pads_a_short_chunk_with_zeros():
    stager = pipeline.HostToDevice(torch.device("cpu"), capacity=8)
    a = np.arange(5, dtype=np.int64)
    a.setflags(write=False)  # pandas may hand out read-only arrays
    t = stager.put({"k": a, "b": np.ones(5, dtype=bool)}, 5).tensors()
    assert t["k"].tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    assert t["b"].tolist() == [True] * 5 + [False] * 3
