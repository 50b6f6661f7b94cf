"""``api.transform`` on a CUDA card against the port's own CPU run on the
same inputs. Without a card every test here skips. This file imports no
JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_compiled_map_cuda.py

Both devices sort stably, so even the sorted plan gives the same row order
on both: rows are compared in place. Exact: keys, row order, decoded
strings, integers, MIN/MAX and NULL placement. Float sums and the values
built on them (means, running sums, the ridge solve): ``rtol=1e-9``, the
order of the card's atomic adds and of its prefix sum being free, and
``atol=1e-9``: a running sum is a prefix sum over the whole frame less the
prefix at its group's start (the JAX package's construction), so its
error is that of a prefix of up to ~5·10^5 at 2^20 rows, ~1e-10, however
small the running sum itself.
"""

from typing import Dict

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch.torch import TorchExecutionEngine, frame_from_numpy
from fugue_tpu_torch.torch import group_ops as go

pytestmark = pytest.mark.cuda

ROWS = 32 * 32768
UDFS = chip_smoke.transform_udfs(torch, go)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _both(cuda_device, data, udf, schema, partition=None):
    """(the CPU result, the card's result) as frames of the port."""
    res = []
    for dev in ("cpu", cuda_device):
        e = TorchExecutionEngine(device=dev)
        tdf = data(dev) if callable(data) else e.to_df(data)
        res.append(api.transform(tdf, udf, schema=schema, partition=partition, engine=e,
                                 as_fugue=True))
    assert res[1].device.type == "cuda"
    return res[0], res[1]


def _same(cpu, card) -> None:
    pd.testing.assert_frame_equal(card.as_pandas(), cpu.as_pandas(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("cell", sorted(chip_smoke.TRANSFORM_CELLS))
def test_transform_path_cells(cuda_device, cell):
    kind, udf, schema, partition, plan = chip_smoke.TRANSFORM_CELLS[cell]
    cols, frame_schema, aux = chip_smoke.transform_frame(np, kind, ROWS, 0)

    def frame(dev):
        return frame_from_numpy(cols, frame_schema, nan_cols=(), device=dev)

    cpu, card = _both(cuda_device, frame, UDFS[udf], schema, partition)
    _same(cpu, card)
    chip_smoke.check_transform(np, cell, card.as_arrow(), cols, aux)


def _demean(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    m = go.mean(cols, cols["v"])
    return {"k": cols["k"], "v": cols["v"], "d": cols["v"] - go.per_row(cols, m)}


def _extremes(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"k": cols["k"], "lo": go.per_row(cols, go.segment_min(cols, cols["v"])),
            "hi": go.per_row(cols, go.segment_max(cols, cols["v"])),
            "n": go.per_row(cols, go.segment_count(cols, dtype=torch.int64)),
            "rmin": go.running_min(cols, cols["v"]) if go.SPANS_SHARDS not in cols else cols["v"],
            "ld": go.lead(cols, cols["v"], 2) if go.SPANS_SHARDS not in cols else cols["v"]}


def _frame(n=200_000, seed=5):
    rng = np.random.default_rng(seed)
    v = rng.random(n)
    v[rng.random(n) < 0.05] = np.nan
    k = np.array(["osaka", "lima", "oslo", "pune"], dtype=object)[rng.integers(0, 4, n)]
    k[rng.random(n) < 0.1] = None
    return pd.DataFrame({"k": pd.Series(k, dtype="str"), "i": rng.integers(-5, 5, n),
                         "t": rng.permutation(n), "v": v})


@pytest.mark.parametrize(
    "udf, schema, partition",
    [
        (_demean, "k:str,v:double,d:double", {"by": ["k"]}),
        (_demean, "k:str,v:double,d:double", {"by": ["k"], "presort": "t desc"}),
        (_extremes, "k:long,lo:double,hi:double,n:long,rmin:double,ld:double", {"by": ["k"]}),
        (_extremes, "k:long,lo:double,hi:double,n:long,rmin:double,ld:double",
         {"by": ["k"], "presort": "v desc, t"}),
    ],
    ids=["string_key_dense", "string_key_sorted", "nan_values_dense", "nan_presort_first"],
)
def test_keyed_plans_match_the_cpu(cuda_device, udf, schema, partition):
    pdf = _frame()
    if schema.startswith("k:long"):
        pdf = pdf.assign(k=pdf["i"]).drop(columns=["i"])
    else:
        pdf = pdf.drop(columns=["i"])
    cpu, card = _both(cuda_device, pdf, udf, schema, partition)
    _same(cpu, card)


def test_padding_rows_stay_out(cuda_device):
    n = 1000
    valid = np.arange(n) % 7 != 3

    def frame(dev):
        rng = np.random.default_rng(1)
        return frame_from_numpy({"k": rng.integers(0, 10, n), "t": rng.permutation(n),
                                 "v": rng.random(n)}, "k:long,t:long,v:double", valid=valid,
                                device=dev)

    for partition in ({"by": ["k"]}, {"by": ["k"], "presort": "t"}):
        cpu, card = _both(cuda_device, frame, _demean, "k:long,v:double,d:double", partition)
        _same(cpu, card)
        assert card.count() == valid.sum()
