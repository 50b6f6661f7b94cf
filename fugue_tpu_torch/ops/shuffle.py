"""The row hash of the device shuffle, the port of ``_hash_cols`` and
``jax_bitcast_u64`` in ``fugue_tpu/ops/shuffle.py``.

Only the hash is ported: the joins sort and probe by it. The exchange
between devices (``compute_dest``, ``exchange_rows``) is ROADMAP.md A.7.

PyTorch's ``uint64`` has no right shift and no ``searchsorted`` on the
CPU, so the hash lives in ``int64``, bit for bit the JAX package's
``uint64``: multiplication wraps the same way in both, each ``>> s`` is
made logical by masking off the ``s`` bits an arithmetic shift copies
from the sign, and the two multipliers are written as their signed
images. ``unsigned_order`` turns the bits into an ``int64`` whose signed
order is the unsigned order of the hash, for sorting and searching.
"""

from typing import List

import torch

_INT64_MIN = -(1 << 63)


def _signed(u: int) -> int:
    """The int64 whose bits are the uint64 ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


# splitmix64 multipliers — the standard 64-bit finalizer mix
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical ``x >> s`` of the uint64 bits held in int64 ``x``."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def bitcast_u64(c: torch.Tensor) -> torch.Tensor:
    """The float64 bits of float ``c`` (any width, widened first), as
    int64."""
    return c.to(torch.float64).view(torch.int64)


def _hash_cols(cols: List[torch.Tensor]) -> torch.Tensor:
    """Combine columns into a well-mixed row hash: the uint64 bits of the
    JAX package's ``_hash_cols``, held in an int64 tensor."""
    h = torch.zeros(cols[0].shape, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        if c.is_floating_point():
            # bitcast so equal keys hash equally; normalize -0.0 to +0.0
            x = bitcast_u64(torch.where(c == 0, torch.zeros_like(c), c))
        else:
            # sign-extends as XLA's integer → uint64 convert does
            x = c.to(torch.int64)
        x = (x ^ _shr(x, 30)) * _MIX1
        x = (x ^ _shr(x, 27)) * _MIX2
        x = x ^ _shr(x, 31)
        h = h * 31 + x
    return h


def unsigned_order(h: torch.Tensor) -> torch.Tensor:
    """The int64 whose signed order is the unsigned order of the uint64
    bits ``h`` (the top bit flipped); its own inverse."""
    return h ^ _INT64_MIN
