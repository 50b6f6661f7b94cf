"""``fugue_tpu_torch.ops.random.uniform`` against ``jax.random.uniform``
under x64 (as the JAX package runs it), bit for bit: the float64 values
the JAX engine's ``sample`` compares with ``frac``. ``tests/conftest.py``
runs JAX on the CPU; x64 is set here as ``fugue_tpu/jax/__init__.py``
sets it."""

import jax
import numpy as np
import pytest
import torch

import fugue_tpu.jax  # noqa: F401 - sets jax_enable_x64, as the JAX engine runs
from fugue_tpu_torch.ops.random import prng_key, threefry2x32, uniform

SEEDS = [0, 1, 7, 2**31 - 2, 2**40 + 3, -1]
CPU = torch.device("cpu")


def _jax_uniform(seed: int, n: int) -> np.ndarray:
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,)))


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int64)


def test_the_reference_draws_float64_with_partitionable_threefry():
    """The premises of the port's copy: x64 is on, so the draw is
    float64, and row i's value does not depend on the length drawn."""
    assert jax.config.jax_enable_x64 and jax.config.jax_threefry_partitionable
    short, long = _jax_uniform(7, 10), _jax_uniform(7, 16)
    assert short.dtype == np.float64
    np.testing.assert_array_equal(_bits(short), _bits(long[:10]))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_the_reference(seed):
    assert prng_key(seed) == tuple(int(x) for x in np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))


@pytest.mark.parametrize("n", [0, 1, 5, 1000, 65_539])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_is_bit_for_bit_the_reference(seed, n):
    got = uniform(seed, 0, n, CPU)
    assert got.dtype == torch.float64 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(_jax_uniform(seed, n)))


@pytest.mark.parametrize("seed", [3, 2**40 + 3, -1])
def test_a_window_far_from_row_zero(seed):
    start, count = 10**6, 4099
    exp = _jax_uniform(seed, start + count)[start:]
    np.testing.assert_array_equal(_bits(uniform(seed, start, count, CPU).numpy()), _bits(exp))


def test_threefry_known_answer():
    """Threefry-2x32 with 20 rounds, key and counter all zero: the known
    answer of the Random123 suite, which ``jax.random`` also reproduces."""
    zero = torch.zeros(1, dtype=torch.int64)
    x0, x1 = threefry2x32((0, 0), zero, zero)
    assert (int(x0), int(x1)) == (0x6B200159, 0x99BA4EFE)
    from jax._src import prng as jprng

    exp = jprng.threefry_2x32(np.uint32([0, 0]), np.uint32([0, 0]))
    assert [int(x) for x in np.asarray(exp)] == [0x6B200159, 0x99BA4EFE]


def test_values_lie_in_the_unit_interval_and_spread():
    u = uniform(20261017, 0, 1 << 16, CPU).numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01
