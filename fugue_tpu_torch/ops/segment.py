"""Device groupby aggregation: the dense (sort-free) path.

The port of the dense half of ``fugue_tpu/ops/segment.py``. When one
integer key's range fits a table of ``buckets`` slots, every row goes to
bucket ``key - kmin`` and each aggregate is a scatter into that table:

- float32 SUM goes through the hand kernel (``ops/bin_groupby.py``,
  replacing the Pallas ``_sum_kernel``) — always, on the card, with no
  switch and no fall back;
- every other SUM and the int64 presence count are ``index_add_``;
- MIN/MAX are ``scatter_reduce_`` with ``"amin"``/``"amax"``.

The JAX package runs this body as one jitted ``shard_map`` program and
merges the shards' tables with psum/pmin/pmax; on one device the merge is
the identity, so here it is one eager function. The sorted path (several
keys, wide key ranges) is not ported yet (ROADMAP.md A.2).
"""

from typing import Any, Dict, List, Sequence, Tuple

import torch

from .bin_groupby import bin_sum_idx

# max bucket table size for the dense (sort-free) groupby path
_DENSE_MAX_RANGE = 1 << 18


def _max_of(dt: torch.dtype) -> Any:
    return float("inf") if dt.is_floating_point else torch.iinfo(dt).max


def _min_of(dt: torch.dtype) -> Any:
    return float("-inf") if dt.is_floating_point else torch.iinfo(dt).min


def _agg_outputs(
    specs: Sequence[Tuple[str, str, int, bool]],
    values: Sequence[torch.Tensor],
    valid: torch.Tensor,
    sum_of: Any,
    min_of: Any,
    max_of: Any,
    count_all: Any = None,
) -> List[torch.Tensor]:
    """Per-group aggregate tables with NaN-as-NULL semantics.

    ``sum_of``/``min_of``/``max_of`` inject the reduction primitive: they map
    a masked full-length row tensor to a per-group tensor. ``count_all`` is an
    optional precomputed per-group count of valid rows (the dense path's
    presence table), reused for NaN-free columns.

    NaN in a nullable float column IS null: excluded from every aggregate,
    and all-null groups come out NaN (NULL). Masked values, non-null counts
    and aggregates are memoized per value column — AVG decomposes to SUM and
    COUNT of one column, and must not launch the SUM twice.
    """

    def _null_of(vidx: int) -> bool:
        nullable = any(s[2] == vidx and s[3] for s in specs)
        return nullable and values[vidx].dtype.is_floating_point

    ev_cache: Dict[int, torch.Tensor] = {}
    nn_cache: Dict[int, torch.Tensor] = {}
    agg_cache: Dict[Tuple[str, int], torch.Tensor] = {}

    def _ev(vidx: int) -> torch.Tensor:
        if vidx not in ev_cache:
            v = values[vidx]
            ev_cache[vidx] = (valid & ~torch.isnan(v)) if _null_of(vidx) else valid
        return ev_cache[vidx]

    def _nn(vidx: int) -> torch.Tensor:
        key = vidx if _null_of(vidx) else -1  # NaN-free columns share one count
        if key not in nn_cache:
            if key == -1 and count_all is not None:
                nn_cache[key] = count_all
            else:
                nn_cache[key] = sum_of(_ev(vidx).to(torch.int64))
        return nn_cache[key]

    def _one(agg: str, vidx: int) -> torch.Tensor:
        ckey = (agg, vidx)
        if ckey in agg_cache:
            return agg_cache[ckey]
        v = values[vidx]
        ev = _ev(vidx)
        may_null = _null_of(vidx)
        # masking by selection (where), never by multiplying: an inf in a
        # valid row stays in its own group
        if agg == "sum":
            part = sum_of(torch.where(ev, v, torch.zeros((), dtype=v.dtype, device=v.device)))
            if may_null:
                part = torch.where(_nn(vidx) > 0, part, float("nan"))  # all-null → NULL
        elif agg == "count":
            part = _nn(vidx)
        elif agg == "min":
            part = min_of(torch.where(ev, v, _max_of(v.dtype)))
            if may_null:
                part = torch.where(_nn(vidx) > 0, part, float("nan"))
        elif agg == "max":
            part = max_of(torch.where(ev, v, _min_of(v.dtype)))
            if may_null:
                part = torch.where(_nn(vidx) > 0, part, float("nan"))
        else:  # pragma: no cover
            raise NotImplementedError(agg)
        agg_cache[ckey] = part
        return part

    return [_one(agg, vidx) for _, agg, vidx, _ in specs]


def _dense_kernel(
    buckets: int,
    agg_sig: Tuple[Tuple[str, str, int, bool], ...],
    k: torch.Tensor,
    kmin: int,
    values: Sequence[torch.Tensor],
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """``(present, *aggregate tables)`` of the dense groupby: the body of
    the JAX package's ``_get_compiled_dense`` as one eager function."""
    # invalid rows go to the top bucket, which no real key reaches
    # (dense_buckets is strictly greater than the key range)
    idx = torch.where(valid, k.to(torch.int64) - kmin, buckets - 1).to(torch.int32)
    present = torch.zeros(buckets, dtype=torch.int64, device=k.device).index_add_(
        0, idx, valid.to(torch.int64)
    )
    idx64: List[torch.Tensor] = []  # scatter_reduce_ takes int64 ids only

    def _idx64() -> torch.Tensor:
        if not idx64:
            idx64.append(idx.to(torch.int64))
        return idx64[0]

    def sum_of(a: torch.Tensor) -> torch.Tensor:
        if a.dtype == torch.float32:
            return bin_sum_idx(idx, a, buckets)
        return torch.zeros(buckets, dtype=a.dtype, device=a.device).index_add_(0, idx, a)

    def min_of(a: torch.Tensor) -> torch.Tensor:
        fill = torch.full((buckets,), _max_of(a.dtype), dtype=a.dtype, device=a.device)
        return fill.scatter_reduce_(0, _idx64(), a, "amin")

    def max_of(a: torch.Tensor) -> torch.Tensor:
        fill = torch.full((buckets,), _min_of(a.dtype), dtype=a.dtype, device=a.device)
        return fill.scatter_reduce_(0, _idx64(), a, "amax")

    outs = _agg_outputs(
        agg_sig,
        values,
        valid,
        sum_of=sum_of,
        min_of=min_of,
        max_of=max_of,
        count_all=present,
    )
    return (present,) + tuple(outs)


def _dedupe_cols(
    agg_cols: Sequence[Tuple[Any, ...]]
) -> Tuple[Tuple[Tuple[str, str, int, bool], ...], List[Any]]:
    """Dedupe value tensors by identity → (specs with column indexes, tensors).

    ``agg_cols`` entries are ``(name, agg, arr)`` or ``(name, agg, arr,
    nullable)``; the same tensor referenced by several aggs (avg → sum+count)
    is passed to the kernel once.
    """
    uniq: Dict[int, int] = {}
    arrays: List[Any] = []
    specs: List[Tuple[str, str, int, bool]] = []
    for entry in agg_cols:
        name, agg, arr = entry[0], entry[1], entry[2]
        nullable = bool(entry[3]) if len(entry) > 3 else True
        if id(arr) not in uniq:
            uniq[id(arr)] = len(arrays)
            arrays.append(arr)
        specs.append((name, agg, uniq[id(arr)], nullable))
    return tuple(specs), arrays


def dense_buckets(rng: int) -> int:
    """Bucket count for a dense plan over a key range of ``rng`` distinct
    slots: the next power of two STRICTLY greater than ``rng``, so the
    top bucket is free for invalid rows (real keys occupy ``[0, rng)`` and
    never reach it)."""
    return 1 << rng.bit_length()


def dense_kernel_parts(
    agg_cols: List[Tuple[Any, ...]], buckets: int
) -> "Tuple[Any, List[Any], Tuple[Tuple[str, str, int, bool], ...]]":
    """The callable ``kernel(k, kmin, values, valid)`` + deduped value
    tensors + signature of the dense-bucket kernel — exposed so callers can
    compose the kernel with further device work (the engine's finish)."""
    agg_sig, arrays = _dedupe_cols(agg_cols)

    def kernel(k: torch.Tensor, kmin: int, values: Sequence[torch.Tensor], valid: torch.Tensor):
        return _dense_kernel(buckets, agg_sig, k, kmin, values, valid)

    return kernel, arrays, agg_sig


def device_dense_groupby(
    key_arr: torch.Tensor,
    agg_cols: List[Tuple[Any, ...]],
    valid: torch.Tensor,
    kmin: int,
    buckets: int,
) -> "Tuple[torch.Tensor, List[Tuple[str, torch.Tensor]]]":
    """Dense-bucket groupby that STAYS on the device.

    Returns ``(present, [(name, table), ...])`` — per-bucket presence
    counts and aggregate tables, with NaN marking NULL (all-NULL groups)."""
    kernel, arrays, agg_sig = dense_kernel_parts(agg_cols, buckets)
    outs = kernel(key_arr, kmin, arrays, valid)
    return outs[0], [(spec[0], arr) for spec, arr in zip(agg_sig, outs[1:])]
