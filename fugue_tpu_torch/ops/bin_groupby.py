"""Binned (dense groupby) float32 reductions: per-bucket SUM, and
optionally the COUNT of valid rows, of values routed by bucket id.

The port of ``fugue_tpu/ops/pallas_groupby.py``. Each function has one
contract and two implementations:

- a kernel written by hand for Hopper, ``csrc/bin_groupby.cu``, built by
  ``ops/_build.py`` and called through its C interface with ``ctypes``.
  It replaces the Pallas TPU kernels ``_sum_kernel`` (``bin_sum_pallas``)
  and ``_bin_kernel`` (``bin_sum_count_pallas``). It is bound by memory:
  about 8 bytes a row (int32 key, float32 value), 9 with the valid flag,
  read once, against ~1 add a row.
- a plain PyTorch version (``*_ref``) that mirrors ``bin_sum_count_xla``:
  rows in chunks of 1024, a one-hot selection per chunk, float32 sums
  accumulated across chunks.

The wrappers (:func:`bin_sum`, :func:`bin_sum_count`, :func:`bin_sum_idx`)
take the plain version for tensors on the CPU, and launch the kernel for
tensors on a CUDA device, with no fall back: a CUDA tensor the kernel does
not take raises. Each launch adds one to ``LAUNCHES[<wrapper's kernel>]``.

Two differences from the JAX package's kernels, in both implementations:

- **Masking by selection.** An invalid row is selected out, never multiplied
  by 0, so an ``inf`` or ``NaN`` in a valid row lands only in its own bucket
  and a ``NaN`` in an invalid row contributes nothing. The one-hot product
  of the JAX package (``onehot * m`` then ``v @ onehot``) turns one ``inf``
  into ``NaN`` in every other bucket of its 1024-row chunk.
- **Exact counts.** Counts are integers throughout (int32 atomics in the
  kernel), exact up to 2**31 - 1 rows per bucket; the JAX package's float32
  count table is exact only up to 2**24.

Keys are clipped to ``[0, buckets)`` as in the JAX package. Float32 atomics
fix no order of summation, so the kernel's sums differ from the plain
version's (and from run to run) in the last bits.

The kernel has two routes by table size, chosen here by :func:`_route` (so
the CPU tests see the choice) and passed to the C entry, which checks the
layout and launches: ``shared`` (the table fits one block's shared memory)
and ``global`` (larger: each warp's hottest buckets in registers and a
shared-memory cache of claimed buckets in front of global atomics). The
source's header says why.
"""

import ctypes
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

CHUNK = 1024  # rows per one-hot chunk of the plain version
# bound on the elements of one one-hot block of the plain version: chunks
# are batched up to it, so the loop runs ~n*buckets/2**26 times, not n/1024
_ONEHOT_ELEMS = 1 << 26

# kernel launches by wrapper kernel, counted where the kernel is launched;
# the lock keeps the count exact when several sessions launch at once
LAUNCHES: Dict[str, int] = {"bin_sum": 0, "bin_sum_count": 0}
_LAUNCHES_LOCK = threading.Lock()


def _count_launch(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1

# the global route's claimed-bucket cache slots (csrc/bin_groupby.cu
# kCacheSlots): 128 KB of shared memory with sums, 192 KB with counts
CACHE_SLOTS = 16384
_ROUTE_IDS = {"shared": 0, "global": 1}


class Route(NamedTuple):
    """How the kernel reduces one table: ``kind`` is ``shared`` (the table
    in one block's shared memory) or ``global`` (a cache of claimed buckets
    in front of global atomics); ``smem_bytes`` is the dynamic shared memory
    of each block."""

    kind: str
    smem_bytes: int


def _route(buckets: int, with_count: bool, smem_optin: int) -> Route:
    """The route for a table of ``buckets`` sums (and counts, if
    ``with_count``) on a card whose blocks may opt in to ``smem_optin`` bytes
    of shared memory: one block's table if it fits, else the global route."""
    per_bucket = 8 if with_count else 4
    if buckets * per_bucket <= smem_optin:
        return Route("shared", buckets * per_bucket)
    return Route("global", CACHE_SLOTS * (4 + per_bucket))


def _largest_shared(with_count: bool, smem_optin: int) -> int:
    """The largest table (in buckets) of the shared route: one bucket more
    takes the global route."""
    return smem_optin // (8 if with_count else 4)


def _onehot_sums(
    keys: torch.Tensor,
    values: torch.Tensor,
    valid: Optional[torch.Tensor],
    buckets: int,
    with_count: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    n = keys.shape[0]
    dev = keys.device
    k = keys.clamp(0, buckets - 1).to(torch.int32)
    v = values.to(torch.float32)
    m = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid.to(torch.bool)
    pad = (-n) % CHUNK
    if pad > 0:
        k = torch.cat([k, k.new_zeros(pad)])
        v = torch.cat([v, v.new_zeros(pad)])
        m = torch.cat([m, m.new_zeros(pad)])  # padding rows are invalid
    kc, vc, mc = k.view(-1, CHUNK), v.view(-1, CHUNK), m.view(-1, CHUNK)
    iota = torch.arange(buckets, dtype=torch.int32, device=dev)
    group = max(1, _ONEHOT_ELEMS // (CHUNK * buckets))
    sums = torch.zeros(buckets, dtype=torch.float32, device=dev)
    counts = torch.zeros(buckets, dtype=torch.int64, device=dev) if with_count else None
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(0, kc.shape[0], group):
        # (chunks, CHUNK, buckets) selection: row r of a chunk is in bucket b
        hit = (kc[s : s + group, :, None] == iota) & mc[s : s + group, :, None]
        sums += torch.where(hit, vc[s : s + group, :, None], zero).sum(dim=1).sum(dim=0)
        if counts is not None:
            counts += hit.sum(dim=(0, 1))
    return sums, (None if counts is None else counts.to(torch.int32))


def bin_sum_ref(
    keys: torch.Tensor, values: torch.Tensor, valid: Optional[torch.Tensor], buckets: int
) -> torch.Tensor:
    """Plain version of :func:`bin_sum` (``valid=None``: every row valid)."""
    return _onehot_sums(keys, values, valid, buckets, False)[0]


def bin_sum_count_ref(
    keys: torch.Tensor, values: torch.Tensor, valid: Optional[torch.Tensor], buckets: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bin_sum_count`."""
    sums, counts = _onehot_sums(keys, values, valid, buckets, True)
    assert counts is not None
    return sums, counts


def _check(
    keys: torch.Tensor,
    values: torch.Tensor,
    valid: Optional[torch.Tensor],
    buckets: int,
) -> torch.Tensor:
    """Validate the inputs; return the keys as int32 (int64 keys are
    clipped to ``[0, buckets)`` first, so no key wraps in the cast)."""
    if not 1 <= buckets < 2**31:
        raise ValueError(f"buckets must be in [1, 2**31), got {buckets}")
    tensors = [keys, values] + ([] if valid is None else [valid])
    for t in tensors:
        if t.dim() != 1:
            raise ValueError(f"expected 1-D tensors, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
        if t.device != keys.device:
            raise ValueError(f"tensors on {t.device} and {keys.device}")
        if t.shape[0] != keys.shape[0]:
            raise ValueError(f"lengths {t.shape[0]} and {keys.shape[0]} differ")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {values.dtype}")
    if valid is not None and valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if keys.dtype == torch.int64:
        return keys.clamp(0, buckets - 1).to(torch.int32)
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32 or int64, got {keys.dtype}")
    return keys


def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("bin_groupby")
    fn = lib.fugue_bin_sum_count
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        fn.argtypes = [vp, vp, vp, i64, i32, vp, vp, ctypes.c_int, i64, vp]
        fn.restype = ctypes.c_int
        lib.fugue_smem_optin.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.fugue_smem_optin.restype = ctypes.c_int
        lib.fugue_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fugue_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fugue_cuda_error_string(rc).decode()
        raise RuntimeError(f"bin_groupby {what} failed: {msg} ({rc})")


_SMEM_OPTIN: Dict[int, int] = {}


def smem_optin(device: torch.device) -> int:
    """The opt-in shared memory per block of a CUDA ``device``, in bytes."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SMEM_OPTIN:
        lib = _lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            _raise_on(lib, lib.fugue_smem_optin(ctypes.byref(out)), "device query")
        _SMEM_OPTIN[index] = out.value
    return _SMEM_OPTIN[index]


def route_of(buckets: int, with_count: bool, device: torch.device) -> Route:
    """The route the kernel takes for this table on a CUDA ``device``."""
    return _route(buckets, with_count, smem_optin(device))


def _launch(
    keys: torch.Tensor,
    values: torch.Tensor,
    valid: Optional[torch.Tensor],
    buckets: int,
    sums: torch.Tensor,
    counts: Optional[torch.Tensor],
) -> None:
    lib = _lib()
    route = route_of(buckets, counts is not None, keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = lib.fugue_bin_sum_count(
            keys.data_ptr(),
            values.data_ptr(),
            None if valid is None else valid.data_ptr(),
            keys.shape[0],
            buckets,
            sums.data_ptr(),
            None if counts is None else counts.data_ptr(),
            _ROUTE_IDS[route.kind],
            route.smem_bytes,
            stream,
        )
    _raise_on(lib, rc, "kernel launch")


def bin_sum(
    keys: torch.Tensor, values: torch.Tensor, valid: Optional[torch.Tensor], buckets: int
) -> torch.Tensor:
    """Per-bucket float32 SUM of ``values`` over the rows where ``valid``
    (``None``: every row), routed by ``keys`` clipped to ``[0, buckets)``.
    Replaces ``bin_sum_pallas`` (``fugue_tpu/ops/pallas_groupby.py``)."""
    keys = _check(keys, values, valid, buckets)
    if keys.device.type == "cpu":
        return bin_sum_ref(keys, values, valid, buckets)
    sums = torch.zeros(buckets, dtype=torch.float32, device=keys.device)
    if keys.shape[0] > 0:
        _launch(keys, values, valid, buckets, sums, None)
        _count_launch("bin_sum")
    return sums


def bin_sum_count(
    keys: torch.Tensor, values: torch.Tensor, valid: Optional[torch.Tensor], buckets: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`bin_sum` plus the int32 count of valid rows per bucket.
    Replaces ``bin_sum_count_pallas``."""
    keys = _check(keys, values, valid, buckets)
    if keys.device.type == "cpu":
        return bin_sum_count_ref(keys, values, valid, buckets)
    sums = torch.zeros(buckets, dtype=torch.float32, device=keys.device)
    counts = torch.zeros(buckets, dtype=torch.int32, device=keys.device)
    if keys.shape[0] > 0:
        _launch(keys, values, valid, buckets, sums, counts)
        _count_launch("bin_sum_count")
    return sums, counts


def bin_sum_idx(idx: torch.Tensor, values: torch.Tensor, buckets: int) -> torch.Tensor:
    """Per-bucket SUM of pre-masked float32 ``values`` routed by bucket id
    ``idx`` (invalid rows carry 0 and any in-range id): the dense groupby's
    drop-in for ``zeros(buckets).index_add_(0, idx, values)``, as
    ``bin_sum_idx`` is in the JAX package."""
    return bin_sum(idx, values, None, buckets)
