"""The hand kernels of fugue_tpu_torch/ops/bin_groupby.py against their plain
PyTorch versions, on a CUDA card. Without one every test here skips: a CUDA
kernel has no CPU build. This file imports no JAX, so it also runs where
JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_bin_groupby_cuda.py

Tolerances: sums ``rtol=1e-5, atol=1e-3`` (float32 atomics fix no order of
summation); counts exact. The kernel's routes (one block's table; a cache
of claimed buckets in front of global atomics) are each held against the
plain version,
with inputs that start off 16-byte alignment, short and ragged lengths, and
all rows in one bucket; a 10**7-row bucket is held against a float64 sum.
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


# one table per route on the card: one block's, then global atomics at the
# dense path's largest table and beyond it
ROUTE_BUCKETS = [1024, 1 << 18, (1 << 20) + 3]


def _offset(t, k):
    """``t`` copied to start ``k`` elements into a fresh buffer."""
    return torch.cat([t.new_zeros(k), t])[k:]


def _check_both(keys, vals, valid, buckets):
    s, c = bg.bin_sum_count(keys, vals, valid, buckets)
    s1 = bg.bin_sum(keys, vals, valid, buckets)
    rs, rc = bg.bin_sum_count_ref(keys, vals, valid, buckets)
    torch.cuda.synchronize()
    assert c.dtype == torch.int32 and torch.equal(c, rc)
    assert torch.allclose(s, rs, rtol=1e-5, atol=1e-3)
    assert torch.allclose(s1, rs, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("with_count", [False, True])
@pytest.mark.parametrize("edge", ["shared_max", "global_min"])
def test_route_edges_match_plain(cuda_device, edge, with_count):
    largest = bg._largest_shared(with_count, bg.smem_optin(cuda_device))
    buckets, kind = {"shared_max": (largest, "shared"), "global_min": (largest + 1, "global")}[edge]
    assert bg.route_of(buckets, with_count, cuda_device).kind == kind
    keys, vals, valid = _inputs(len(edge), (1 << 14) + 37, buckets, cuda_device)
    _check_both(keys, vals, valid, buckets)


@pytest.mark.parametrize("buckets", ROUTE_BUCKETS)
@pytest.mark.parametrize(
    "key_off,val_off,mask_off",
    [(0, 0, 0), (1, 1, 1), (3, 3, 3), (1, 0, 0), (0, 2, 0), (0, 0, 3), (3, 1, 2)],
)
def test_misaligned_starts_match_plain(cuda_device, buckets, key_off, val_off, mask_off):
    # equal offsets keep the 16-byte loads after a head of scalar rows;
    # unequal ones read every row with scalar loads
    keys, vals, valid = _inputs(key_off + 4 * val_off, (1 << 16) + 37, buckets, cuda_device)
    keys, vals, valid = _offset(keys, key_off), _offset(vals, val_off), _offset(valid, mask_off)
    _check_both(keys, vals, valid, buckets)
    _check_both(keys, vals, None, buckets)


@pytest.mark.parametrize("buckets", ROUTE_BUCKETS)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 4, 5, (1 << 16) + 37])
def test_short_and_ragged_lengths_match_plain(cuda_device, buckets, offset, n):
    keys, vals, valid = _inputs(n + offset, n, buckets, cuda_device)
    keys, vals, valid = _offset(keys, offset), _offset(vals, offset), _offset(valid, offset)
    _check_both(keys, vals, valid, buckets)


@pytest.mark.parametrize("buckets", ROUTE_BUCKETS)
def test_all_rows_in_one_bucket_match_plain(cuda_device, buckets):
    keys, vals, valid = _inputs(17, (1 << 16) + 37, buckets, cuda_device)
    keys.fill_(buckets // 3)
    _check_both(keys, vals, valid, buckets)


@pytest.mark.parametrize("buckets", [1, 1 << 18, (1 << 20) + 3])
def test_one_bucket_of_ten_million_rows_vs_float64(cuda_device, buckets):
    n = 10**7
    rng = np.random.default_rng(23)
    vals = rng.random(n, dtype=np.float32)
    valid = rng.random(n) > 0.1
    keys = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    tv, tm = torch.from_numpy(vals).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    s, c = bg.bin_sum_count(keys, tv, tm, buckets)
    s1 = bg.bin_sum(keys, tv, tm, buckets)
    torch.cuda.synchronize()
    exp = float(vals[valid].astype(np.float64).sum())
    assert int(c[0]) == int(valid.sum()) and int(c[1:].sum()) == 0
    for got in (s, s1):
        assert abs(float(got[0]) - exp) <= 1e-4 * exp
        assert not got[1:].any()
