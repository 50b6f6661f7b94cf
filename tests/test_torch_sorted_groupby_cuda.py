"""The sorted groupby (``fugue_tpu_torch/ops/segment.py``) and the engine's
partials route on a CUDA card, against the port's own CPU run on the same
inputs. Without a card every test here skips. This file imports no JAX,
so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_sorted_groupby_cuda.py

Exact: keys, counts, MIN/MAX, NULL placement. Sums accumulated in float64
on both devices (float32 and float64 columns on the sorted route):
``rtol=1e-9``, the order of the card's atomic adds being free. float32
sums through the binned-sum kernel (the dense route):
``rtol=1e-5, atol=1e-3``.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.ops import segment as seg
from fugue_tpu_torch.torch import TorchExecutionEngine

pytestmark = pytest.mark.cuda

N = 1 << 20
SPECS = [("s32", "sum", "v32", True), ("n32", "count", "v32", True), ("lo32", "min", "v32", True),
         ("hi32", "max", "v32", True), ("s64", "sum", "v64", True), ("si", "sum", "i", False),
         ("loi", "min", "i", False), ("hil", "max", "l", False)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(case, seed):
    rng = np.random.default_rng(seed)
    v32 = (rng.random(N) * 100).astype(np.float32)
    v32[rng.random(N) < 0.1] = np.nan
    v64 = rng.random(N) * 1e6
    v64[rng.random(N) < 0.05] = np.nan
    vals = {"v32": v32, "v64": v64, "i": rng.integers(-1000, 1000, N).astype(np.int32),
            "l": rng.integers(-(1 << 40), 1 << 40, N)}
    if case == "two_keys":
        keys = {"a": rng.integers(0, 7, N).astype(np.int32), "b": rng.integers(-3, 3, N)}
    elif case == "three_keys":
        keys = {"a": rng.integers(0, 3, N).astype(np.int8), "b": rng.random(N) < 0.5,
                "c": rng.integers(0, 5, N) * (1 << 38)}
    elif case == "nan_float_keys":
        f = rng.integers(0, 6, N) / 4.0
        f[rng.random(N) < 0.001] = np.nan
        keys = {"f": f}
    elif case == "signed_zero_keys":
        f = rng.integers(-2, 3, N).astype(np.float32)
        f[(f == 0) & (rng.random(N) < 0.5)] = -0.0
        keys = {"f": f}
    elif case == "bool_key":
        keys = {"b": rng.random(N) < 0.3}
    elif case == "wide_int64":
        keys = {"k": rng.integers(-(1 << 62), 1 << 62, 1000)[rng.integers(0, 1000, N)]}
    elif case == "many_groups":
        keys = {"k": rng.integers(0, 1 << 40, N)}
    elif case == "mask_key":
        m = rng.random(N) < 0.25
        keys = {"k": np.where(m, 0, rng.integers(0, 4, N)), "__null__k": m}
    else:
        raise KeyError(case)
    valid = rng.random(N) > 0.05
    return keys, vals, valid


def _partials(keys, vals, valid, dev):
    t = {c: torch.from_numpy(a).to(dev) for c, a in {**keys, **vals}.items()}
    aggs = [(n, a, t[c], nl) for n, a, c, nl in SPECS]
    parts = seg.device_groupby_partials({k: t[k] for k in keys}, aggs, torch.from_numpy(valid).to(dev))
    merged = seg.merge_partials(parts, list(keys), [(n, a) for n, a, _, _ in SPECS])
    return merged.sort_values(list(keys), na_position="last", kind="stable").reset_index(drop=True)


@pytest.mark.parametrize("case", ["two_keys", "three_keys", "nan_float_keys", "signed_zero_keys",
                                  "bool_key", "wide_int64", "many_groups", "mask_key"])
def test_sorted_route_matches_the_cpu(cuda_device, case):
    keys, vals, valid = _inputs(case, len(case))
    cpu = _partials(keys, vals, valid, torch.device("cpu"))
    gpu = _partials(keys, vals, valid, cuda_device)
    assert list(gpu.columns) == list(cpu.columns) and len(gpu) == len(cpu) > 0
    for c in gpu.columns:
        g, e = gpu[c].to_numpy(), cpu[c].to_numpy()
        assert g.dtype == e.dtype, c
        if c in ("s32", "s64"):
            assert np.allclose(g, e, rtol=1e-9, atol=0, equal_nan=True), c
        else:
            assert np.array_equal(g, e, equal_nan=g.dtype.kind == "f"), c
    if case == "signed_zero_keys":
        zero = gpu[gpu["f"] == 0]["f"]
        assert len(zero) == 1 and np.signbit(zero.iloc[0]) == np.signbit(cpu[cpu["f"] == 0]["f"].iloc[0])


def test_all_rows_invalid_and_empty(cuda_device):
    keys, vals, _ = _inputs("two_keys", 1)
    assert len(_partials(keys, vals, np.zeros(N, dtype=bool), cuda_device)) == 0
    empty = {c: a[:0] for c, a in {**keys, **vals}.items()}
    parts = _partials({k: empty[k] for k in keys}, {c: empty[c] for c in vals},
                      np.zeros(0, dtype=bool), cuda_device)
    assert len(parts) == 0


def test_float32_sum_of_one_large_group(cuda_device):
    # 2**25 ones in one group: exact, where a float32 running total stops at 2**24
    n = 1 << 25
    parts = seg.device_groupby_partials(
        {"k": torch.zeros(n, dtype=torch.int64, device=cuda_device),
         "j": torch.ones(n, dtype=torch.bool, device=cuda_device)},
        [("s", "sum", torch.ones(n, device=cuda_device), False)],
        torch.ones(n, dtype=torch.bool, device=cuda_device),
    )
    assert parts["s"].tolist() == [float(n)]


def _frame(seed):
    rng = np.random.default_rng(seed)
    v = (rng.random(N) * 10).astype(np.float32)
    v[rng.random(N) < 0.05] = np.nan
    days = rng.integers(18_000, 18_020, N).astype(np.int32)
    return pa.table({
        "s": pa.array(rng.choice(np.array(["x", "", "yy", "ü", None], dtype=object), N).tolist(), pa.string()),
        "t": pa.array(rng.choice(np.array(["b", "a", None], dtype=object), N).tolist(), pa.string()),
        "k": pa.array(rng.integers(-5, 5, N), pa.int64(), mask=rng.random(N) < 0.1),
        "d": pa.array(days, pa.int32(), mask=rng.random(N) < 0.05).cast(pa.date32()),
        "w": rng.integers(0, 1 << 40, N),
        "v": v,
        "x": pa.array((1 << 62) + rng.integers(-9, 9, N), pa.int64(), mask=rng.random(N) < 0.2),
    })


@pytest.mark.parametrize("by", [["s"], ["s", "k"], ["d"], ["w"], ["k", "t"]])
def test_engine_partials_route_matches_the_cpu(cuda_device, by):
    tbl = _frame(len(by))
    aggs = [ff.sum(col("v")).alias("sv"), ff.avg(col("v")).alias("av"), ff.min(col("t")).alias("mt"),
            ff.max(col("t")).alias("xt"), ff.count(col("*")).alias("c"), ff.sum(col("x")).alias("sx"),
            ff.max(col("x")).alias("xx")]
    out = {}
    for dev in ("cpu", cuda_device):
        e = TorchExecutionEngine(device=dev)
        res = e.aggregate(e.to_df(tbl), PartitionSpec(by=by), aggs)
        out[str(dev)] = res.as_arrow().sort_by([(k, "ascending") for k in by])
    g, e = out[str(cuda_device)], out["cpu"]
    assert g.schema.equals(e.schema) and g.num_rows == e.num_rows > 0
    dense = by == ["s"]  # one small dictionary key: the binned-sum kernel sums v
    for c in g.column_names:
        gv, ev = g.column(c).to_pylist(), e.column(c).to_pylist()
        if c in ("sv", "av"):
            assert [x is None for x in gv] == [x is None for x in ev]
            gf, ef = (np.array([np.nan if x is None else x for x in a]) for a in (gv, ev))
            rtol, atol = (1e-5, 1e-3) if dense else (1e-9, 0)
            assert np.allclose(gf, ef, rtol=rtol, atol=atol, equal_nan=True), c
        else:
            assert gv == ev, c
