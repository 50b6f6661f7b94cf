"""The port's binned reductions (fugue_tpu_torch/ops/bin_groupby.py) against
the JAX package's (fugue_tpu/ops/pallas_groupby.py): the Pallas kernels in
interpret mode and the chunked one-hot XLA version, on the same numpy inputs.

Tolerances: sums ``atol=1e-3``, the JAX package's own for float32 binned
sums (tests/jax_engine/test_pallas_groupby.py); counts exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fugue_tpu.ops.pallas_groupby import (
    bin_sum_count_pallas,
    bin_sum_count_xla,
    bin_sum_pallas,
)
from fugue_tpu_torch.ops import bin_groupby as bg

BUCKETS = [2, 5, 130, 200, 256, 1024]


def _oracle(keys, vals, valid, buckets):
    """float64 numpy oracle, keys clipped as both contracts do."""
    k = np.clip(keys, 0, buckets - 1)
    s = np.zeros(buckets, np.float64)
    c = np.zeros(buckets, np.int64)
    np.add.at(s, k[valid], vals[valid].astype(np.float64))
    np.add.at(c, k[valid], 1)
    return s, c


@pytest.fixture(scope="module")
def data():
    # 5,000 rows (not a multiple of 1024), ~10% invalid, keys reaching below
    # 0 and above every bucket count so the clipping is exercised
    rng = np.random.default_rng(7)
    n = 5_000
    return (
        rng.integers(-20, 1100, n).astype(np.int32),
        rng.random(n).astype(np.float32),
        rng.random(n) > 0.1,
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("buckets", BUCKETS)
def test_sum_count_ref_matches_pallas_and_xla(data, buckets):
    keys, vals, valid = data
    exp_s, exp_c = _oracle(keys, vals, valid, buckets)
    s, c = bg.bin_sum_count_ref(_t(keys), _t(vals), _t(valid), buckets)
    assert s.dtype == torch.float32 and c.dtype == torch.int32
    ps, pc = bin_sum_count_pallas(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid), buckets, interpret=True
    )
    xs, xc = bin_sum_count_xla(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid), buckets
    )
    for ref_s, ref_c in ((np.asarray(ps), np.asarray(pc)), (np.asarray(xs), np.asarray(xc))):
        assert np.allclose(s.numpy(), ref_s, atol=1e-3)
        assert (c.numpy() == ref_c).all()
    assert np.allclose(s.numpy(), exp_s, atol=1e-3)
    assert (c.numpy() == exp_c).all()


@pytest.mark.parametrize("buckets", BUCKETS)
def test_sum_ref_matches_sum_only_pallas(data, buckets):
    keys, vals, valid = data
    s = bg.bin_sum_ref(_t(keys), _t(vals), _t(valid), buckets)
    ps = bin_sum_pallas(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid), buckets, interpret=True
    )
    assert np.allclose(s.numpy(), np.asarray(ps), atol=1e-3)
    assert np.allclose(s.numpy(), _oracle(keys, vals, valid, buckets)[0], atol=1e-3)


@pytest.mark.parametrize("buckets", [5, 256])
def test_cpu_wrappers_take_the_plain_version(data, buckets):
    keys, vals, valid = data
    before = dict(bg.LAUNCHES)
    s, c = bg.bin_sum_count(_t(keys), _t(vals), _t(valid), buckets)
    rs, rc = bg.bin_sum_count_ref(_t(keys), _t(vals), _t(valid), buckets)
    assert torch.equal(s, rs) and torch.equal(c, rc)
    assert torch.equal(bg.bin_sum(_t(keys), _t(vals), _t(valid), buckets), rs)
    # int64 keys are clipped before the int32 cast, so none wraps
    wide = _t(keys.astype(np.int64) + (1 << 33) * (keys % 2 == 0))
    exp = bg.bin_sum_ref(wide.clamp(0, buckets - 1).to(torch.int32), _t(vals), None, buckets)
    assert torch.equal(bg.bin_sum(wide, _t(vals), None, buckets), exp)
    # no kernel launches on the CPU
    assert bg.LAUNCHES == before


def test_bin_sum_idx_equals_index_add(data):
    keys, vals, valid = data
    buckets = 256
    idx = _t(np.where(valid, np.clip(keys, 0, buckets - 2), buckets - 1).astype(np.int32))
    masked = torch.where(_t(valid), _t(vals), 0.0)
    scatter = torch.zeros(buckets).index_add_(0, idx, masked)
    assert np.allclose(bg.bin_sum_idx(idx, masked, buckets).numpy(), scatter.numpy(), atol=1e-3)


@pytest.mark.parametrize(
    "bad",
    [
        dict(values=np.zeros(8, np.float64)),
        dict(keys=np.zeros(8, np.int16)),
        dict(valid=np.zeros(8, np.uint8)),
        dict(keys=np.zeros((2, 4), np.int32), values=np.zeros((2, 4), np.float32)),
        dict(values=np.zeros(9, np.float32)),
        dict(buckets=0),
    ],
)
def test_wrappers_reject_bad_inputs(bad):
    args = dict(
        keys=np.zeros(8, np.int32),
        values=np.zeros(8, np.float32),
        valid=np.ones(8, np.bool_),
        buckets=4,
    )
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        bg.bin_sum_count(_t(args["keys"]), _t(args["values"]), _t(args["valid"]), args["buckets"])


def test_wrappers_reject_non_contiguous():
    keys = torch.zeros(16, dtype=torch.int32)[::2]
    with pytest.raises(ValueError):
        bg.bin_sum(keys, torch.zeros(8), None, 4)


def test_inf_and_nan_land_only_in_their_own_bucket():
    # the port's documented answer: selection, not multiplication, so an
    # inf or NaN in a valid row stays in its bucket and a NaN in an invalid
    # row contributes nothing. The JAX package's one-hot product spreads
    # NaN over every bucket of the chunk (ROADMAP.md C1).
    rng = np.random.default_rng(11)
    n, buckets = 3_000, 64
    keys = rng.integers(0, buckets, n).astype(np.int32)
    vals = rng.random(n).astype(np.float32)
    valid = np.ones(n, np.bool_)
    keys[[10, 20, 30, 40]] = [3, 7, 9, 11]
    vals[[10, 20, 30, 40]] = [np.inf, -np.inf, np.nan, np.nan]
    valid[40] = False  # NaN in an invalid row
    exp_s, exp_c = _oracle(keys, vals, valid, buckets)
    assert np.isposinf(exp_s[3]) and np.isneginf(exp_s[7]) and np.isnan(exp_s[9])
    assert np.isfinite(np.delete(exp_s, [3, 7, 9])).all()

    s, c = bg.bin_sum_count(_t(keys), _t(vals), _t(valid), buckets)
    assert np.allclose(s.numpy(), exp_s, atol=1e-3, equal_nan=True)
    assert (c.numpy() == exp_c).all()
    s_only = bg.bin_sum(_t(keys), _t(vals), _t(valid), buckets)
    assert np.allclose(s_only.numpy(), exp_s, atol=1e-3, equal_nan=True)

    ps, _ = bin_sum_count_pallas(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid), buckets, interpret=True
    )
    ps = np.asarray(ps)
    clean = np.setdiff1d(np.arange(buckets), [3, 7, 9])
    assert np.isnan(ps[clean]).all()  # the reference's fault, pinned
