"""The random draw of the JAX engine's ``sample``, on torch tensors.

``JaxExecutionEngine.sample`` (``fugue_tpu/jax/execution_engine.py``
:3250) keeps row ``i`` where ``jax.random.uniform(jax.random.PRNGKey(seed),
(n,))[i] < frac``. The JAX package runs with ``jax_enable_x64`` (set in
``fugue_tpu/jax/__init__.py``), so the draw is float64, and with
``jax_threefry_partitionable``, so row ``i``'s draw depends on ``i`` alone,
never on ``n``. This module computes the same float64 values, bit for bit,
from the algorithm:

- the key of ``PRNGKey(seed)``: the seed as an int64, its high and low 32
  bits;
- Threefry-2x32 with 20 rounds (Salmon et al., "Parallel random numbers:
  as easy as 1, 2, 3", SC 2011) over the counter pair ``(hi, lo)`` of the
  flat index ``i``;
- 64 random bits ``(x0 << 32) | x1`` of its output pair;
- their top 52 bits under the exponent of 1.0, as a float in [1, 2),
  minus 1.0.

Words live in int64 tensors masked to 32 bits, so the same code runs on
the CPU and on the card.
"""

from typing import Tuple

import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # the key schedule's parity constant
_ONE_BITS = 0x3FF0000000000000  # float64 1.0


def prng_key(seed: int) -> Tuple[int, int]:
    """The two 32-bit words of ``jax.random.PRNGKey(seed)`` under x64: the
    seed's int64 bits, high word first."""
    bits = int(seed) & ((1 << 64) - 1)
    return bits >> 32, bits & _MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(
    key: Tuple[int, int], x0: torch.Tensor, x1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, of the counter words ``(x0, x1)`` (int64
    tensors holding 32-bit values) under ``key``."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        # key injection after every 4 rounds
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK32
    return x0, x1


def uniform(seed: int, start: int, count: int, device: torch.device) -> torch.Tensor:
    """``jax.random.uniform(jax.random.PRNGKey(seed), (n,))[start:start +
    count]`` under x64, for any ``n >= start + count``: ``count`` float64
    values in [0, 1) on ``device``."""
    i = torch.arange(start, start + count, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(prng_key(seed), i >> 32, i & _MASK32)
    # the top 52 of the 64 bits (b0 << 32 | b1) are b0's 32 and b1's top 20
    mantissa = (b0 << 20) | (b1 >> 12)
    return (mantissa | _ONE_BITS).view(torch.float64) - 1.0
