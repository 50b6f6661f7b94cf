"""The set verbs, ``sample`` and ``take`` on a CUDA card against the port's
own CPU run on the same inputs. Without a card every test here skips.
This file imports no JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_setops_cuda.py

Exact: schema, row sets, keys, NULLs, the rows a seeded ``sample`` keeps
and the random bits behind them.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from fugue_tpu_torch.column import col
from fugue_tpu_torch.ops.random import uniform
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frame(n=1 << 16, seed=0) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 6, n),
        "i": rng.integers(-20, 20, n).astype(np.int32),
        "a": pa.array(rng.integers(-5, 5, n), mask=rng.random(n) < 0.2),
        "f": pa.array(np.where(rng.random(n) < 0.1, np.nan, rng.integers(-8, 8, n) / 4)),
        "b": rng.random(n) < 0.5,
        "s": pa.array(rng.choice(["apple", "fig", "pear", "plum"], n).tolist(), mask=rng.random(n) < 0.1),
        "d": pa.array(rng.integers(18000, 18010, n).astype(np.int32), mask=rng.random(n) < 0.1).cast(pa.date32()),
        "u": rng.permutation(n).astype(np.int64),
    })


def _pandas(df) -> pd.DataFrame:
    return df.as_arrow().replace_schema_metadata(None).to_pandas()


def _sorted(pdf: pd.DataFrame) -> pd.DataFrame:
    return pdf.sort_values(list(pdf.columns), na_position="last").reset_index(drop=True)


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3, -1])
def test_uniform_on_the_card_is_the_cpus(cuda_device, seed):
    for start, count in ((0, (1 << 20) + 3), (10**9, 4099)):
        got = uniform(seed, start, count, cuda_device)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu().view(torch.int64), uniform(seed, start, count, torch.device("cpu")).view(torch.int64))


PLAIN = ["k", "i", "b", "u"]
VERBS = {
    "distinct": (lambda e, d: e.distinct(d[["k", "a", "f", "b", "s", "d"]]), False),
    "distinct_plain": (lambda e, d: e.distinct(d[["k", "i", "b"]]), False),
    "union": (lambda e, d: e.union(d[["k", "s", "d"]], e.filter(d, col("i") > 0)[["k", "s", "d"]]), False),
    "subtract": (lambda e, d: e.subtract(d[PLAIN[:3]], e.filter(d, col("i") > 5)[PLAIN[:3]]), False),
    "intersect": (lambda e, d: e.intersect(d[PLAIN[:3]], e.filter(d, col("k") > 2)[PLAIN[:3]]), False),
    "sample": (lambda e, d: e.sample(d, frac=0.01, seed=20261017), True),
    "sample_filtered": (lambda e, d: e.sample(e.filter(d, col("i") > 0), frac=0.3, seed=5), True),
    "take": (lambda e, d: e.take(d, 100, presort="f desc, u"), True),
    "take_strings": (lambda e, d: e.take(d, 50, presort="s desc, d, u"), True),
    "take_filtered": (lambda e, d: e.take(e.filter(d, col("k") == 3), 4096, presort="a, u desc"), True),
}


@pytest.mark.parametrize("name", list(VERBS))
def test_verbs_on_the_card_equal_the_cpu(cuda_device, name):
    tbl = _frame()
    fn, ordered = VERBS[name]
    got = fn(TorchExecutionEngine(device=cuda_device), TorchDataFrame(tbl, device=cuda_device))
    exp = fn(TorchExecutionEngine(device="cpu"), TorchDataFrame(tbl, device="cpu"))
    assert isinstance(got, TorchDataFrame) and got.device.type == "cuda" and got.host_table is None
    assert str(got.schema) == str(exp.schema)
    g, e = _pandas(got), _pandas(exp)
    if not ordered:
        g, e = _sorted(g), _sorted(e)
    pd.testing.assert_frame_equal(g, e, check_exact=True)
    assert got.count() > 0
