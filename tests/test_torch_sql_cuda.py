"""FugueSQL and the workflow on a CUDA card against the port's own CPU run
on the same inputs. Without a card every test here skips. This file
imports no JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_sql_cuda.py

Exact: column names, keys and counts. Sums and averages: ``rtol=1e-5``
(atomics on the card add in another order).
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch import workflow as twf
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _same(got: pd.DataFrame, exp: pd.DataFrame, keys) -> None:
    assert list(got.columns) == list(exp.columns)
    got = got.sort_values(keys).reset_index(drop=True) if keys else got
    exp = exp.sort_values(keys).reset_index(drop=True) if keys else exp
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), exp[c].to_numpy(), rtol=1e-5)
        else:
            assert got[c].tolist() == exp[c].tolist(), c


def test_sql_path_cells_on_the_card(cuda_device):
    """sql_path's lineitem cells on the card and on the CPU; the shipmode
    aggregate launches B1 twice, as its select_path twin does."""
    tbl, _ = chip_smoke.make_lineitem(np, pa, 0, 16_000)
    cuda, cpu = TorchExecutionEngine(), TorchExecutionEngine(device="cpu")
    on_card, on_cpu = cuda.to_df(tbl), cpu.to_df(tbl)
    for cell, (query, _) in chip_smoke.sql_path_queries().items():
        for k in bg.LAUNCHES:
            bg.LAUNCHES[k] = 0
        got = api.fugue_sql(query, lineitem=on_card, engine=cuda, as_fugue=True)
        launches = dict(bg.LAUNCHES)
        assert isinstance(got, TorchDataFrame) and got.device.type == "cuda"
        exp = api.fugue_sql(query, lineitem=on_cpu, engine=cpu, as_fugue=True)
        keys = [c for c in exp.schema.names if c.startswith("l_")]
        _same(got.as_pandas(), exp.as_pandas(), keys if cell != "sql-q1" else None)
        assert launches["bin_sum"] == (2 if cell == "sql-shipmode-where" else 0)


def test_sql_pipeline_on_the_card(cuda_device, tmp_path):
    """BASELINE config #2 as bench.py writes it, on the card: the pandas
    oracle's rows, the result on the card."""
    pdf = chip_smoke.sql_pipeline_frame(np, pd, 100_000)
    path = str(tmp_path / "bench.parquet")
    pq.write_table(pa.Table.from_pandas(pdf, preserve_index=False), path)
    sql = chip_smoke.sql_pipeline_text(path)

    def rescale(df: pd.DataFrame) -> pd.DataFrame:
        df["s"] = df["s"] / df["s"].max()
        return df

    got = api.fugue_sql(sql, rescale=rescale, engine="torch", as_fugue=True)
    assert isinstance(got, TorchDataFrame) and got.device.type == "cuda"
    chip_smoke.check_sql_pipeline(np, got.as_pandas(), chip_smoke.sql_pipeline_oracle(pdf))


def test_concurrent_tasks_use_the_engine_stream(cuda_device):
    """With ``fugue.workflow.concurrency`` 4 each task runs in a pool
    thread on the engine's device and on the stream the run started on."""
    seen = []
    side = torch.cuda.Stream()

    def probe(df: pd.DataFrame) -> pd.DataFrame:
        seen.append((torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream))
        return df

    dag = twf.FugueWorkflow({"fugue.workflow.concurrency": 4})
    outs = [dag.df([[i]], "a:long").transform(probe, schema="*") for i in range(4)]
    outs[0].union(*outs[1:], distinct=False).yield_dataframe_as("u", as_local=True)
    with torch.cuda.stream(side):
        dag.run(TorchExecutionEngine())
    assert sorted(r[0] for r in dag.yields["u"].result.as_array()) == [0, 1, 2, 3]
    assert seen and all(s == (0, side.cuda_stream) for s in seen)
