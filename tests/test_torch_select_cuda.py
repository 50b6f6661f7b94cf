"""The row-local verbs on a CUDA card against the port's own CPU run on the
same inputs. Without a card every test here skips. This file imports no
JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_select_cuda.py

Exact: schema, row sets, keys, counts, NULLs and every projected or
filtered value (the device evaluator computes in the dtypes the CPU run
does). Sums of an aggregate: ``rtol=1e-5`` (atomics on the card add in
another order).
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import SelectColumns, col, lit
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frame(n=1 << 16, seed=0) -> pa.Table:
    rng = np.random.default_rng(seed)
    d = rng.integers(18000, 18800, n).astype(np.int32)
    return pa.table({
        "k": rng.integers(0, 6, n),
        "i": rng.integers(-20, 20, n).astype(np.int32),
        "a": pa.array(rng.integers(-5, 5, n), mask=rng.random(n) < 0.2),
        "f": pa.array(np.where(rng.random(n) < 0.1, np.nan, rng.standard_normal(n) * 3)),
        "g": (rng.standard_normal(n) * 2).astype(np.float32),
        "b": rng.random(n) < 0.5,
        "s": pa.array(rng.choice(["apple", "fig", "pear", "plum"], n).tolist(), mask=rng.random(n) < 0.1),
        "d": pa.array(d, mask=rng.random(n) < 0.1).cast(pa.date32()),
    })


def _sorted(tbl: pa.Table) -> pd.DataFrame:
    pdf = tbl.replace_schema_metadata(None).to_pandas()
    return pdf.sort_values(list(pdf.columns), na_position="last").reset_index(drop=True)


VERBS = {
    "filter": lambda e, d: e.filter(d, (col("f") > 0) & (col("s") == "fig") & (col("d") >= "2019-06-01")),
    "filter_kleene": lambda e, d: e.filter(d, (col("a") > 0) | (col("g") > 1) | col("s").is_null()),
    "project": lambda e, d: e.select(d, SelectColumns(
        col("k"), (col("i") + 1).alias("x"), (col("g") * 2.5).alias("y"), (col("f") / col("i")).alias("z"),
        col("f").cast("int").alias("c"), col("s"))),
    "where_grouped": lambda e, d: e.select(d, SelectColumns(
        col("k"), ff.sum(col("g")).alias("sg"), ff.count(col("*")).alias("n")), where=col("b")),
    "where_global": lambda e, d: e.select(d, SelectColumns(ff.sum(col("f") * col("g")).alias("p")),
                                          where=col("k") > 2),
    "having": lambda e, d: e.select(d, SelectColumns(col("s"), ff.sum(col("i")).alias("si")),
                                    where=col("g") > 0, having=ff.sum(col("i")) > 0),
    "assign": lambda e, d: e.assign(d, [(col("g") * 2).alias("g"), lit(1).alias("one")]),
    "dropna": lambda e, d: e.dropna(d, thresh=3, subset=["a", "f", "s", "d"]),
    "fillna": lambda e, d: e.fillna(d, {"a": 7, "f": -1.5}),
    "min_max_bool": lambda e, d: e.aggregate(d, PartitionSpec(by=["k"]), [
        ff.min(col("b")).alias("lo"), ff.max(col("b")).alias("hi")]),
    "aggregate_no_keys": lambda e, d: e.aggregate(d, None, [ff.avg(col("g")).alias("m")]),
}


@pytest.mark.parametrize("verb", list(VERBS))
def test_verb_on_the_card_equals_the_cpu(cuda_device, verb):
    data = _frame()
    out = []
    for dev in ("cpu", cuda_device):
        e = TorchExecutionEngine(device=dev)
        out.append(VERBS[verb](e, e.to_df(data)))
    cpu, card = out
    assert isinstance(card, TorchDataFrame) and card.device.type == "cuda"
    assert str(card.schema) == str(cpu.schema)
    g, c = _sorted(card.as_arrow()), _sorted(cpu.as_arrow())
    if verb in ("where_grouped", "where_global", "having", "aggregate_no_keys"):
        pd.testing.assert_frame_equal(g, c, rtol=1e-5)
    else:
        pd.testing.assert_frame_equal(g, c, check_exact=True)
    for name, t in card.device_cols.items():
        assert t.device.type == "cuda", name


def test_b1_launches_under_a_filters_mask(cuda_device):
    """A float32 SUM over a filtered frame takes the dense route with the
    filter's mask: B1 once a float32 SUM column, and the masked rows add
    nothing."""
    rng = np.random.default_rng(3)
    n = 1 << 20
    pdf = pd.DataFrame({"k": rng.integers(0, 100, n), "v": rng.random(n).astype(np.float32),
                        "w": rng.random(n).astype(np.float32)})
    e = TorchExecutionEngine(device=cuda_device)
    tdf = e.to_df(pdf)
    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    res = e.select(tdf, SelectColumns(col("k"), ff.sum(col("v")).alias("s"), ff.avg(col("w")).alias("m")),
                   where=col("w") < 0.5)
    torch.cuda.synchronize()
    assert bg.LAUNCHES["bin_sum"] == 2
    got = res.as_pandas().sort_values("k").reset_index(drop=True)
    sub = pdf[pdf["w"] < np.float32(0.5)]
    exp = sub.groupby("k").agg(s=("v", "sum"), m=("w", "mean")).reset_index()
    assert (got["k"].to_numpy() == exp["k"].to_numpy()).all()
    assert np.allclose(got["s"], exp["s"], rtol=1e-4) and np.allclose(got["m"], exp["m"], rtol=1e-4)


def test_device_where_stays_on_the_card(cuda_device):
    """The filter and the projection leave every tensor on the card and
    copy nothing to the host: no ``fugue::to_host`` in a trace."""
    e = TorchExecutionEngine(device=cuda_device)
    tdf = e.to_df(_frame())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        res = api.select(tdf, "k", (col("g") * 2).alias("x"), where=(col("s") == "fig") & (col("f") > 0),
                         engine=e)
        torch.cuda.synchronize()
    names = {ev.key for ev in prof.key_averages()}
    assert "fugue::filter" in names and "fugue::project" in names and "fugue::to_host" not in names
    assert res.valid_mask is not None and res.valid_mask.device.type == "cuda"
