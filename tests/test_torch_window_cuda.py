"""Window functions and repartition on a CUDA card against the port's own
CPU run on the same inputs. Without a card every test here skips. This
file imports no JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_window_cuda.py

The pandas evaluator is poisoned for the card's runs, so the device plan
(``torch/window.py``) answers there. Exact: column names, keys, ranks and
counts; floats ``rtol=1e-9`` (prefix sums and scans add in another order
on the card).
"""

import unittest.mock as mock

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import chip_smoke
import fugue_tpu_torch.column.window as host_window
from fugue_tpu_torch import api
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine

pytestmark = pytest.mark.cuda

_PARTITIONED = "PARTITION BY k ORDER BY o, r"
CASES = {
    "ranks": f"SELECT k, o, ROW_NUMBER() OVER ({_PARTITIONED}) AS rn, RANK() OVER (PARTITION BY k ORDER BY o) AS rk, "
             "DENSE_RANK() OVER (PARTITION BY k ORDER BY o) AS dr FROM df",
    "desc": "SELECT k, f, RANK() OVER (PARTITION BY k ORDER BY f DESC) AS rk, "
            "SUM(v) OVER (PARTITION BY k ORDER BY f DESC) AS s FROM df",
    "lag_lead": f"SELECT k, o, r, LAG(v) OVER ({_PARTITIONED}) AS l1, LAG(v, 2, -1.0) OVER ({_PARTITIONED}) AS l2, "
                f"LEAD(o, 1, 999) OVER ({_PARTITIONED}) AS f2 FROM df",
    "running": f"SELECT k, o, r, SUM(v) OVER ({_PARTITIONED} ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS rs, "
               f"MIN(v) OVER ({_PARTITIONED} ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS rmin, "
               "AVG(v) OVER (PARTITION BY k ORDER BY o) AS pa, COUNT(v) OVER (PARTITION BY k) AS c FROM df",
    "bounded": f"SELECT k, o, r, SUM(v) OVER ({_PARTITIONED} ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING) AS s, "
               f"MAX(v) OVER ({_PARTITIONED} ROWS BETWEEN 3 PRECEDING AND CURRENT ROW) AS hi FROM df",
    "range_offsets": "SELECT k, f, SUM(iv) OVER (PARTITION BY k ORDER BY f RANGE BETWEEN 2.5 PRECEDING AND "
                     "1.0 FOLLOWING) AS rv, MIN(v) OVER (PARTITION BY k ORDER BY f RANGE BETWEEN 1.0 PRECEDING "
                     "AND CURRENT ROW) AS lo FROM df",
    "global": "SELECT o, r, RANK() OVER (ORDER BY o) AS rk, SUM(v) OVER (ORDER BY o) AS s, "
              "COUNT(v) OVER (ORDER BY o RANGE BETWEEN 2 PRECEDING AND CURRENT ROW) AS near, "
              "MIN(v) OVER () AS lo FROM df WHERE o > 3",
    "strings_nullable": "SELECT g, m, DENSE_RANK() OVER (PARTITION BY g ORDER BY m DESC) AS dr, "
                        "SUM(m) OVER (PARTITION BY g ORDER BY m DESC) AS sm FROM df",
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frame(n: int = 3_000, seed: int = 3) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    v = rng.random(n)
    v[rng.random(n) < 0.1] = np.nan
    m = pd.array(np.where(rng.random(n) < 0.2, None, rng.integers(-9, 9, n)), dtype="Int64")
    return pd.DataFrame({"k": rng.integers(0, 40, n), "o": rng.integers(0, 60, n),
                         "r": rng.permutation(n).astype("int64"), "f": np.round(rng.random(n) * 30, 2),
                         "iv": rng.integers(-50, 50, n), "v": v, "m": m,
                         "g": rng.choice(["x", "yy", "zzz"], n)})


def _boom(*a, **k):
    raise AssertionError("the pandas window evaluator ran on the card")


def _same(got: pd.DataFrame, exp: pd.DataFrame) -> None:
    cols = list(exp.columns)
    assert list(got.columns) == cols
    pd.testing.assert_frame_equal(got.sort_values(cols).reset_index(drop=True),
                                  exp.sort_values(cols).reset_index(drop=True), rtol=1e-9)


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_cases_on_the_card(cuda_device, case):
    pdf = _frame()
    with mock.patch.object(host_window, "eval_window", _boom):
        got = api.fugue_sql(CASES[case], df=pdf, engine=TorchExecutionEngine(), as_fugue=True)
    assert isinstance(got, TorchDataFrame) and got.device.type == "cuda"
    exp = api.fugue_sql(CASES[case], df=pdf, engine=TorchExecutionEngine(device="cpu"), as_fugue=True)
    _same(got.as_pandas(), exp.as_pandas())


def test_window_path_cells_on_the_card(cuda_device):
    """chip_smoke.py's window cells on a small lineitem frame against their
    numpy oracles, through the device route."""
    tbl, _ = chip_smoke.make_lineitem(np, pa, 0, 20_000)
    engine = TorchExecutionEngine()
    tdf = engine.to_df(tbl)
    oracles = chip_smoke.window_path_oracles(np, chip_smoke.window_path_arrays(np, tbl))
    for cell, query in chip_smoke.window_path_queries().items():
        with mock.patch.object(host_window, "eval_window", _boom):
            res = api.fugue_sql(query, lineitem=tdf, engine=engine, as_fugue=True)
        chip_smoke.check_window(torch, np, res, oracles[cell], cell)


def test_repartition_on_the_card(cuda_device):
    """Every algo returns the frame's own tensors; a per-row transform on
    the card equals the host engine's."""
    engine = TorchExecutionEngine()
    pdf = _frame(200)[["k", "v"]]
    tdf = engine.to_df(pdf)
    for spec in ({"by": ["k"], "algo": "hash"}, {"algo": "even"}, {"algo": "rand", "num": 3}, "per_row"):
        res = api.repartition(tdf, spec, engine=engine)
        assert all(res.device_cols[c].data_ptr() == tdf.device_cols[c].data_ptr() for c in tdf.schema.names)

    def size(df: pd.DataFrame) -> pd.DataFrame:
        return df.assign(n=len(df))

    got = api.transform(tdf, size, schema="*,n:long", partition="per_row", engine=engine)
    assert got.device.type == "cuda"
    exp = api.transform(pdf, size, schema="*,n:long", partition="per_row", engine="native")
    _same(got.as_pandas(), exp)
