"""The hand kernels of fugue_tpu_torch/ops/bin_groupby.py against their plain
PyTorch versions, on a CUDA card. Without one every test here skips: a CUDA
kernel has no CPU build. This file imports no JAX, so it also runs where
JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_bin_groupby_cuda.py

Tolerances: sums ``rtol=1e-5, atol=1e-3`` (float32 atomics fix no order of
summation); counts exact.
"""

import numpy as np
import pytest
import torch

from fugue_tpu_torch.ops import bin_groupby as bg

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    return torch.device("cuda", 0)


def _inputs(seed, n, buckets, dev):
    rng = np.random.default_rng(seed)
    # Zipf-skewed keys reaching one below and two above the table: clipped
    keys = ((rng.zipf(1.3, n) - 1) % (buckets + 3) - 1).astype(np.int32)
    vals = rng.random(n, dtype=np.float32)
    valid = rng.random(n) > 0.1
    return [torch.from_numpy(a).to(dev) for a in (keys, vals, valid)]


@pytest.mark.parametrize("buckets", [2, 5, 130, 1024, 12_289, 1 << 18])
def test_kernel_matches_plain(cuda_device, buckets):
    keys, vals, valid = _inputs(buckets, (1 << 16) + 37, buckets, cuda_device)
    before = dict(bg.LAUNCHES)
    s, c = bg.bin_sum_count(keys, vals, valid, buckets)
    s1 = bg.bin_sum(keys, vals, valid, buckets)
    torch.cuda.synchronize()
    assert bg.LAUNCHES["bin_sum_count"] == before["bin_sum_count"] + 1
    assert bg.LAUNCHES["bin_sum"] == before["bin_sum"] + 1
    rs, rc = bg.bin_sum_count_ref(keys, vals, valid, buckets)
    assert c.dtype == torch.int32 and torch.equal(c, rc)
    assert torch.allclose(s, rs, rtol=1e-5, atol=1e-3)
    assert torch.allclose(s1, rs, rtol=1e-5, atol=1e-3)


def test_inf_and_nan_stay_in_their_bucket(cuda_device):
    keys, vals, valid = _inputs(3, 10_000, 64, cuda_device)
    keys[:4] = torch.tensor([3, 7, 9, 11], dtype=torch.int32)
    vals[:4] = torch.tensor([float("inf"), float("-inf"), float("nan"), float("nan")])
    valid[:3] = True
    valid[3] = False  # NaN in an invalid row adds nothing
    s = bg.bin_sum(keys, vals, valid, 64)
    r = bg.bin_sum_ref(keys, vals, valid, 64)
    torch.cuda.synchronize()
    assert torch.isposinf(s[3]) and torch.isneginf(s[7]) and torch.isnan(s[9])
    fin = torch.ones(64, dtype=torch.bool, device=cuda_device)
    fin[[3, 7, 9]] = False
    assert torch.isfinite(s[fin]).all() and torch.allclose(s[fin], r[fin], rtol=1e-5, atol=1e-3)


def test_cuda_tensors_never_take_the_plain_version(cuda_device):
    keys, vals, valid = _inputs(5, 1000, 16, cuda_device)
    with pytest.raises(TypeError):
        bg.bin_sum(keys, vals.double(), valid, 16)
    with pytest.raises(ValueError):
        bg.bin_sum(keys, vals.cpu(), valid, 16)
    before = bg.LAUNCHES["bin_sum"]
    bg.bin_sum_idx(keys.clamp(0, 15), vals, 16)
    assert bg.LAUNCHES["bin_sum"] == before + 1
