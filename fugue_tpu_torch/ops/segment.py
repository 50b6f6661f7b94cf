"""Device groupby aggregation, the port of ``fugue_tpu/ops/segment.py``.

Two routes, chosen by ``device_groupby_partials`` as the JAX package
chooses them:

- **dense** (sort-free): when one integer key's range fits a table of
  ``buckets`` slots, every row goes to bucket ``key - kmin`` and each
  aggregate is a scatter into that table. float32 SUM goes through the
  hand kernel (``ops/bin_groupby.py``, replacing the Pallas
  ``_sum_kernel``) — always, on the card, with no switch and no fall back;
  every other SUM and the int64 presence count are ``index_add_``;
  MIN/MAX are ``scatter_reduce_`` with ``"amin"``/``"amax"``;
- **sorted**: any number of keys of any range. Rows are sorted
  lexicographically by (not valid, keys...), change flags give segment
  ids by a cumulative sum, each aggregate is a segment reduction, and each
  segment's key is packed to the front.

Both return per-group *partials* for the host merge (``merge_partials``),
the contract of the JAX package's two-phase aggregate. The JAX package
runs the device phase as one jitted ``shard_map`` program per mesh shard;
here one device is one shard, and the body is eager PyTorch. The number
of segments is the sorted route's one data-dependent shape: it is read
from the device once per aggregate.
"""

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from .bin_groupby import bin_sum_idx

# max bucket table size for the dense (sort-free) groupby path
_DENSE_MAX_RANGE = 1 << 18


def _max_of(dt: torch.dtype) -> Any:
    return float("inf") if dt.is_floating_point else torch.iinfo(dt).max


def _min_of(dt: torch.dtype) -> Any:
    return float("-inf") if dt.is_floating_point else torch.iinfo(dt).min


def _norm_specs(
    agg_specs: Sequence[Tuple[Any, ...]]
) -> Tuple[Tuple[Tuple[str, str, int, bool], ...], int]:
    """Normalize agg specs to (name, agg, value_idx, nullable).

    Short forms: ``(name, agg)`` → one distinct value column per spec,
    nullable; ``(name, agg, vidx)`` → nullable. ``nullable`` means the
    (float) column may contain NaN — NaN-as-NULL handling is skipped for
    columns the caller proved null-free. Returns (normalized_specs,
    num_value_columns)."""
    norm: List[Tuple[str, str, int, bool]] = []
    for i, spec in enumerate(agg_specs):
        if len(spec) == 2:
            norm.append((spec[0], spec[1], i, True))
        elif len(spec) == 3:
            norm.append((spec[0], spec[1], spec[2], True))
        else:
            norm.append(tuple(spec))  # type: ignore[arg-type]
    num_vals = max(s[2] for s in norm) + 1 if len(norm) > 0 else 0
    return tuple(norm), num_vals


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
            # bool sums as int64: index_add_ on bool saturates (an OR), and
            # AVG divides this sum by a count
            if v.dtype == torch.bool:
                v = v.to(torch.int64)
            part = sum_of(torch.where(ev, v, torch.zeros((), dtype=v.dtype, device=v.device)))
            if may_null:
                part = torch.where(_nn(vidx) > 0, part, float("nan"))  # all-null → NULL
        elif agg == "count":
            part = _nn(vidx)
        elif agg in ("min", "max"):
            # bools reduce as uint8: CUDA's scatter min/max have no bool
            # kernel (ROADMAP.md C9)
            u = v.to(torch.uint8) if v.dtype == torch.bool else v
            if agg == "min":
                part = min_of(torch.where(ev, u, _max_of(u.dtype)))
            else:
                part = max_of(torch.where(ev, u, _min_of(u.dtype)))
            part = part.to(torch.bool) if v.dtype == torch.bool else part
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


_INT_OF_FLOAT = {torch.float16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}


def _sort_image(k: torch.Tensor) -> torch.Tensor:
    """An integer tensor that sorts as ``lax.sort`` orders ``k``.

    XLA's comparator orders floats as -inf < ... < inf < NaN, with 0.0 and
    -0.0 equal and every NaN equal to every other. Here -0.0 becomes 0.0
    and each NaN one positive NaN, and the bits turn into an integer of the
    same width whose order is that of the floats, so the same stable
    integer sort runs on the CPU and the card. bool sorts as uint8."""
    if k.dtype == torch.bool:
        return k.to(torch.uint8)
    if not k.is_floating_point():
        return k
    canon = torch.where(torch.isnan(k), float("nan"), k + 0.0)  # -0.0 + 0.0 = 0.0
    bits = canon.view(_INT_OF_FLOAT[k.dtype])
    # negative floats: flip every bit but the sign, so larger magnitudes sort lower
    return bits ^ ((bits >> (bits.element_size() * 8 - 1)) & torch.iinfo(bits.dtype).max)


def _order_by(images: Iterable[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts rows by (not valid, images...), ties in
    row order: one stable sort per integer image, ``images`` given from
    the least significant to the most (an iterable, so one image lives at a
    time), then one by validity."""
    perm = torch.arange(valid.shape[0], device=valid.device)
    for image in images:
        perm = perm[torch.sort(image[perm], stable=True).indices]
    invalid = torch.logical_not(valid)[perm].to(torch.uint8)
    return perm[torch.sort(invalid, stable=True).indices]


def _lex_order(keys: Sequence[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts rows by (not valid, keys...), as
    ``lax.sort`` orders them (NaN last), ties in row order."""
    return _order_by((_sort_image(k) for k in reversed(keys)), valid)


def _keyed_image(key: torch.Tensor, ascending: bool) -> torch.Tensor:
    """An integer image of one sort column of the JAX package's keyed map
    (``_compiled_keyed_map``). Unlike the groupby's, a float column puts NaN
    FIRST, ascending or descending (the JAX package's leading ``¬isnan``
    operand): NaN rows take the image's minimum, below the image of
    ``-inf``, so one sort a column does it. A descending column is reversed
    by negation (float), ``~`` (int) or ``logical_not`` (bool)."""
    if key.is_floating_point():
        isnan = torch.isnan(key)
        filled = torch.where(isnan, 0.0, key)
        image = _sort_image(filled if ascending else -filled)
        return torch.where(isnan, torch.iinfo(image.dtype).min, image)
    if ascending:
        return _sort_image(key)
    return _sort_image(torch.logical_not(key) if key.dtype == torch.bool else ~key)


def _keyed_order(
    sort_items: Sequence[Tuple[str, bool]], cols: Dict[str, torch.Tensor], valid: torch.Tensor
) -> torch.Tensor:
    """The permutation that sorts rows as the JAX package's keyed map sorts
    them: by (not valid, then each ``(name, ascending)`` item), ties in row
    order."""
    return _order_by((_keyed_image(cols[n], asc) for n, asc in reversed(list(sort_items))), valid)


def keyed_segments(keys: Sequence[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """int32 segment ids of rows sorted by ``_keyed_order``: a new segment
    where any partition key changes (the presort does not count), and every
    invalid row a segment of its own."""
    change = torch.logical_not(valid)
    change[:1] = True
    for k in keys:
        change[1:] |= k[1:] != k[:-1]
    return torch.cumsum(change, 0, dtype=torch.int32) - 1


def _shard_kernel(num_keys: int, agg_specs: Sequence[Tuple[Any, ...]]):
    """The sorted groupby of one shard: ``kernel(*keys, *values, valid)``
    → ``(nseg, packed_keys..., aggs...)``, each output ``nseg`` long.

    ``aggs[i][j]`` is the reduction of segment j and ``packed_keys[i][j]``
    its key (the key of the segment's first row). Value columns are
    deduplicated by index (``_norm_specs``) so identical reductions run
    once. float32 SUMs accumulate in float64: one group may hold tens of
    millions of rows, past where a float32 running total stops moving.
    """
    specs, num_vals = _norm_specs(agg_specs)

    def kernel(*args: torch.Tensor):
        keys = args[:num_keys]
        values = args[num_keys : num_keys + num_vals]
        valid = args[num_keys + num_vals]
        n = valid.shape[0]
        perm = _lex_order(keys, valid)
        s_keys = [k[perm] for k in keys]
        s_valid = valid[perm]
        s_values = [v[perm] for v in values]
        change = torch.zeros(n, dtype=torch.bool, device=valid.device)
        change[:1] = True
        for k in s_keys:
            change[1:] |= k[1:] != k[:-1]  # NaN != NaN: each NaN key its own segment
        change &= s_valid
        # the one device→host read of the route: the number of segments
        starts = torch.nonzero(change).squeeze(1)
        nseg = starts.shape[0]
        # invalid rows (sorted last) go to a spare segment, dropped below
        seg_id = torch.where(s_valid, torch.cumsum(change, 0) - 1, nseg)

        def sum_of(a: torch.Tensor) -> torch.Tensor:
            acc = torch.float64 if a.dtype == torch.float32 else a.dtype
            out = torch.zeros(nseg + 1, dtype=acc, device=a.device)
            return out.index_add_(0, seg_id, a.to(acc))[:nseg]

        def min_of(a: torch.Tensor) -> torch.Tensor:
            out = torch.full((nseg + 1,), _max_of(a.dtype), dtype=a.dtype, device=a.device)
            return out.scatter_reduce_(0, seg_id, a, "amin")[:nseg]

        def max_of(a: torch.Tensor) -> torch.Tensor:
            out = torch.full((nseg + 1,), _min_of(a.dtype), dtype=a.dtype, device=a.device)
            return out.scatter_reduce_(0, seg_id, a, "amax")[:nseg]

        outs = _agg_outputs(specs, s_values, s_valid, sum_of=sum_of, min_of=min_of, max_of=max_of)
        return (nseg,) + tuple(k[starts] for k in s_keys) + tuple(outs)

    return kernel


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


def minmax_probe(k: torch.Tensor, valid: torch.Tensor) -> Tuple[int, int]:
    """``(min, max)`` of integer tensor ``k`` over the valid rows, in one
    device→host read; with no valid rows ``(iinfo.max, iinfo.min)``, so
    emptiness is ``hi < lo``."""
    ii = torch.iinfo(k.dtype)
    if k.shape[0] == 0:
        return ii.max, ii.min
    lo = torch.where(valid, k, ii.max).min()
    hi = torch.where(valid, k, ii.min).max()
    lo_h, hi_h = torch.stack([lo, hi]).tolist()
    return int(lo_h), int(hi_h)


def _is_int(t: torch.Tensor) -> bool:
    return not t.is_floating_point() and t.dtype != torch.bool


def _dense_groupby_partials(
    key_name: str,
    key_arr: torch.Tensor,
    agg_cols: List[Tuple[Any, ...]],
    valid: torch.Tensor,
    kmin: int,
    buckets: int,
) -> pd.DataFrame:
    """The dense route's partials: one row per present bucket."""
    present_t, named = device_dense_groupby(key_arr, agg_cols, valid, kmin, buckets)
    present = present_t.cpu().numpy()
    # presence counts only valid rows, so the top bucket (invalid rows)
    # and empty buckets drop out
    (idx,) = np.nonzero(present > 0)
    data: Dict[str, Any] = {key_name: idx.astype(np.int64) + kmin}
    for name, arr in named:
        data[name] = arr.cpu().numpy()[idx]
    return pd.DataFrame(data)


class PartialsTooLarge(Exception):
    """The group count is too high for the O(groups) host transfer."""


def device_groupby_partials(
    key_cols: Dict[str, torch.Tensor],
    agg_cols: List[Tuple[Any, ...]],
    valid_mask: torch.Tensor,
    max_partial_rows: Optional[int] = None,
    range_hint: Optional[Tuple[int, int]] = None,
) -> pd.DataFrame:
    """Run the device phase; return a host pandas frame of per-group
    partials. One integer key with a small range takes the dense route (no
    sort); everything else the sorted route. Only O(groups) rows come to
    the host either way.

    ``agg_cols`` entries are ``(name, agg, arr)`` or ``(name, agg, arr,
    nullable)`` — ``nullable=False`` marks a float column proved NaN-free.
    ``range_hint`` is the caller's cached (min, max) of the single key
    (``TorchDataFrame.key_range``); without it the route probes the key.
    """
    key_names = list(key_cols.keys())
    if len(key_names) == 1 and _is_int(key_cols[key_names[0]]):
        karr = key_cols[key_names[0]]
        kmin, kmax = range_hint if range_hint is not None else minmax_probe(karr, valid_mask)
        rng = kmax - kmin + 1
        if 0 < rng <= _DENSE_MAX_RANGE:
            return _dense_groupby_partials(
                key_names[0], karr, agg_cols, valid_mask, kmin, dense_buckets(rng)
            )
    agg_sig, arrays = _dedupe_cols(agg_cols)
    kernel = _shard_kernel(len(key_names), agg_sig)
    nseg, *outs = kernel(*key_cols.values(), *arrays, valid_mask)
    if max_partial_rows is not None and nseg > max_partial_rows:
        raise PartialsTooLarge(f"{nseg} partial rows > limit {max_partial_rows}")
    if nseg == 0:
        return pd.DataFrame({n: [] for n in key_names + [s[0] for s in agg_sig]})
    names = key_names + [s[0] for s in agg_sig]
    return pd.DataFrame({n: a.cpu().numpy() for n, a in zip(names, outs)})


def merge_partials(
    partials: pd.DataFrame, key_names: List[str], agg_specs: List[Tuple[str, str]]
) -> pd.DataFrame:
    """Host phase: combine partials into final aggregates.

    NaN partials mean "this group slice was all-NULL" — min/max use
    pandas' skipna merge, and sum uses ``min_count=1`` so a group that is
    all-NULL in every partial stays NULL instead of becoming 0.
    """
    sum_cols: List[str] = []
    agg_map: Dict[str, Any] = {}
    for name, agg in agg_specs:
        if agg == "sum":
            sum_cols.append(name)
        elif agg == "count":
            agg_map[name] = "sum"
        elif agg in ("min", "max"):
            agg_map[name] = agg
        else:  # pragma: no cover
            raise NotImplementedError(agg)
    grouped = partials.groupby(key_names, dropna=False, sort=False)
    pieces = []
    if len(sum_cols) > 0:
        # vectorized (no per-group python) NULL-preserving sum
        pieces.append(grouped[sum_cols].sum(min_count=1))
    if len(agg_map) > 0:
        pieces.append(grouped.agg(agg_map))
    merged = pieces[0] if len(pieces) == 1 else pieces[0].join(pieces[1])
    # restore the caller's column order
    return merged[[n for n, _ in agg_specs]].reset_index()
