"""Device hash joins, the port of ``fugue_tpu/ops/join.py`` for one device.

- keys (one or many, int/float/bool) are mixed into the JAX package's
  64-bit row hash (``ops/shuffle.py``); the right side is sorted by hash,
  the left probes with ``searchsorted`` and verifies REAL key equality on
  the gathered row, so a hash collision can only send the join down the
  expansion path (duplicate hashes on the right are detected at prep),
  never give a wrong match;
- join types map onto the frame's validity mask: ``inner``/``semi`` AND
  the match in, ``anti`` ANDs its negation, ``left_outer`` keeps every
  left row and fills the gathered values on a miss;
- duplicate right keys take the 1:N/N:M expansion, which materialises one
  output row per (left row, candidate) pair.

The JAX package's ``shard_map`` programs run here as eager PyTorch on one
device: its broadcast strategy, with the right side whole and the left
rows in place. On one device its ``copartition`` moves no row and computes
the same thing, so the shuffle strategy (the exchange, ROADMAP.md A.7) is
not ported. Hashes are held as int64 images whose signed order is the
hash's unsigned order (``unsigned_order``), because PyTorch has no
``searchsorted`` over ``uint64``.

NULL keys never match (SQL semantics): NaN float keys are excluded from
both sides' match sets.
"""

from typing import Any, Dict, List, Optional, Tuple

import torch

from .segment import _order_by
from .shuffle import _hash_cols, unsigned_order

# right sides larger than this take the shuffle strategy in the JAX
# package; the port's cross join hands them to its host engine
MAX_BROADCAST_ROWS = 1 << 20
# output-slot budget of the 1:N expansion join on one device
MAX_EXPAND_ROWS = 1 << 22
# the hash image of invalid right rows: the unsigned maximum
_PINNED = torch.iinfo(torch.int64).max

Values = List[Tuple[str, torch.Tensor, Any]]


def _key_hash_and_valid(
    key_cols: List[torch.Tensor], valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row hash in unsigned order, validity excluding NaN keys) for a set
    of key columns."""
    kv = valid
    for c in key_cols:
        if c.is_floating_point():
            kv = kv & ~torch.isnan(c)
    return unsigned_order(_hash_cols(key_cols)), kv


def _probe_body(
    how: str,
    fk_cols: Tuple[torch.Tensor, ...],
    f_valid: torch.Tensor,
    rk_sorted_hash: torch.Tensor,
    r_order: torch.Tensor,
    r_nvalid: torch.Tensor,
    rk_cols: Tuple[torch.Tensor, ...],
    r_values: Tuple[torch.Tensor, ...],
    fills: Tuple[Any, ...] = (),
) -> Tuple[torch.Tensor, ...]:
    """Shared probe: left hashes against the hash-sorted right side.

    ``fills`` (one per value array) are the left_outer miss values: NaN for
    floats, −1 for dictionary codes, True for null masks, 0 for plain ints
    whose misses get a generated null mask from the returned match flags.
    """
    fh, fkv = _key_hash_and_valid(list(fk_cols), f_valid)
    idx = torch.searchsorted(rk_sorted_hash, fh)
    idx_c = idx.clamp(0, rk_sorted_hash.shape[0] - 1)
    cand = (rk_sorted_hash[idx_c] == fh) & (idx < r_nvalid) & fkv
    src = r_order[idx_c]
    # verify true key equality on the candidate row (collision safety)
    eq = cand
    for fk, rk in zip(fk_cols, rk_cols):
        eq = eq & (rk[src] == fk)
    if how == "inner":
        return (f_valid & eq,) + tuple(rv[src] for rv in r_values)
    if how == "left_outer":
        miss = ~eq
        gathered = tuple(rv[src].masked_fill(miss, fill) for rv, fill in zip(r_values, fills))
        return (f_valid,) + gathered + (eq,)  # match flags: generated null masks
    if how == "semi":
        return (f_valid & eq,)
    if how == "anti":
        return (f_valid & ~eq,)
    raise NotImplementedError(how)


def right_prep(
    valid: torch.Tensor, key_cols: List[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash and sort the right side: ``(sorted hash, order, valid count,
    duplicate flag)``, all on the device.

    Rows sort by (not valid, hash), ties in row order, as the JAX
    package's ``lax.sort((inv, h, iota), num_keys=2)``: a stable sort by
    hash, then a stable sort by validity. The flag marks duplicate hashes
    among valid rows. Invalid rows sit at the tail with their hashes
    pinned to the maximum, so the array stays sorted for ``searchsorted``
    (the ``idx < nv`` guard keeps them unmatchable)."""
    h, kv = _key_hash_and_valid(key_cols, valid)
    order = _order_by([h], kv)
    s_h = h[order]
    s_inv = ~kv[order]
    nv = kv.sum()
    dup = ((s_h[1:] == s_h[:-1]) & ~s_inv[1:] & ~s_inv[:-1]).any()
    return s_h.masked_fill(s_inv, _PINNED), order, nv, dup


def _pad_empty_right(
    right_keys: List[torch.Tensor], right_valid: torch.Tensor, right_values: Values
) -> Tuple[List[torch.Tensor], torch.Tensor, Values]:
    """An empty right side as one invalid row, so every gather has a row to
    read (the JAX package's frames are padded; the port's are not)."""
    if right_valid.shape[0] > 0:
        return right_keys, right_valid, right_values
    return (
        [k.new_zeros(1) for k in right_keys],
        right_valid.new_zeros(1),
        [(n, a.new_zeros(1), f) for n, a, f in right_values],
    )


def _broadcast_only(strategy: str) -> None:
    if strategy != "broadcast":
        raise NotImplementedError(
            f"join strategy {strategy!r}: the port joins on one device, with the "
            "right side whole; the exchange is not ported (ROADMAP.md A.7)"
        )


def device_hash_join(
    how: str,
    left_cols: Dict[str, torch.Tensor],
    left_valid: torch.Tensor,
    left_key_names: List[str],
    right_keys: List[torch.Tensor],
    right_valid: torch.Tensor,
    right_values: Values,
    strategy: str = "broadcast",
) -> Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor, Optional[torch.Tensor]]]:
    """Join the left payload against the right side's arrays, whose keys
    are unique.

    - ``left_cols`` is the FULL left payload (columns, null masks, prepared
      probe keys — any row-aligned tensors); ``left_key_names`` picks the
      probe keys out of it;
    - ``right_keys`` are the prepared right key tensors (dictionary codes
      remapped, masked keys as NaN float views — the caller aligns
      representations across frames);
    - ``right_values`` entries are ``(out_name, tensor, miss_fill)`` — the
      fill is the left_outer NULL for that tensor's representation (NaN /
      −1 code / True mask / 0 plain).

    Returns ``(new_cols, new_valid, match)``: left rows stay in place, and
    ``match`` (left_outer only) flags the rows that found a partner — the
    caller derives generated null masks for plain columns from it. None
    when the right side has duplicate keys (or a hash collision): the
    caller takes :func:`device_expand_join`. The duplicate flag is the
    one read from the device."""
    _broadcast_only(strategy)
    right_keys, right_valid, right_values = _pad_empty_right(right_keys, right_valid, right_values)
    s_h, order, nv, dup = right_prep(right_valid, right_keys)
    if bool(dup):
        return None
    fills = tuple(f for _, _, f in right_values) if how == "left_outer" else ()
    outs = _probe_body(
        how,
        tuple(left_cols[k] for k in left_key_names),
        left_valid,
        s_h,
        order,
        nv,
        tuple(right_keys),
        tuple(a for _, a, _ in right_values),
        fills,
    )
    new_cols = dict(left_cols)
    match = None
    if how in ("inner", "left_outer"):
        for (name, _, _), arr in zip(right_values, outs[1:]):
            new_cols[name] = arr
    if how == "left_outer":
        match = outs[-1]
    return new_cols, outs[0], match


def expand_count(
    f_valid: torch.Tensor,
    s_h: torch.Tensor,
    nv: torch.Tensor,
    fk: List[torch.Tensor],
    miss_slot: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase A of the 1:N expansion: ``(cand, lo, off, slots)`` — each left
    row's candidate count (its hash's run in the sorted right side), the
    run's start, the row's exclusive offset into the output and its slot
    count (one more for a left_outer miss)."""
    fh, fkv = _key_hash_and_valid(fk, f_valid)
    lo = torch.searchsorted(s_h, fh)
    hi = torch.minimum(torch.searchsorted(s_h, fh, right=True), nv)
    lo = torch.minimum(lo, hi)
    cand = torch.where(f_valid & fkv, hi - lo, 0)
    slots = cand + f_valid.to(torch.int64) if miss_slot else cand
    off = torch.cumsum(slots, 0) - slots  # exclusive
    return cand, lo, off, slots


def expand_rows(
    how: str,
    mt: int,
    cand: torch.Tensor,
    lo: torch.Tensor,
    off: torch.Tensor,
    slots: torch.Tensor,
    f_valid: torch.Tensor,
    order: torch.Tensor,
    fk: List[torch.Tensor],
    lp: List[torch.Tensor],
    rk: List[torch.Tensor],
    rv: List[torch.Tensor],
    fills: Tuple[Any, ...],
) -> Tuple[torch.Tensor, ...]:
    """Phase B: one output row per (left row, candidate) pair in ``mt``
    slots (exactly the slot total: the port's shapes are dynamic, so the
    JAX package's power-of-two capacity has nothing to spare). Collisions
    and left_outer misses become masked slots, never wrong rows.

    Returns ``(valid,)`` for semi/anti (left rows in place), else ``(valid,
    *left payload, *right values[, match flags])``."""
    n = f_valid.shape[0]
    nr = order.shape[0]
    row = torch.repeat_interleave(
        torch.arange(n, device=f_valid.device), slots, output_size=mt
    )
    within = torch.arange(mt, device=f_valid.device) - off[row]
    is_cand = within < cand[row]
    src = order[(lo[row] + within).clamp(0, nr - 1)]
    eq = is_cand & f_valid[row]
    for k_, r_ in zip(fk, rk):
        eq = eq & (r_[src] == k_[row])
    matched = (
        torch.zeros(n, dtype=torch.int32, device=f_valid.device)
        .scatter_reduce_(0, row, eq.to(torch.int32), "amax")
        > 0
    )
    if how in ("semi", "anti"):
        return (f_valid & (matched if how == "semi" else ~matched),)
    louts = tuple(a[row] for a in lp)
    if how == "left_outer":
        miss = (within == cand[row]) & f_valid[row] & ~matched[row]
        routs = tuple(a[src].masked_fill(~eq, f) for a, f in zip(rv, fills))
        return (eq | miss,) + louts + routs + (eq,)
    return (eq,) + louts + tuple(a[src] for a in rv)


def device_expand_join(
    how: str,
    left_cols: Dict[str, torch.Tensor],
    left_valid: torch.Tensor,
    left_key_names: List[str],
    right_keys: List[torch.Tensor],
    right_valid: torch.Tensor,
    right_values: Values,
    strategy: str = "broadcast",
) -> Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor, Optional[torch.Tensor]]]:
    """1:N / N:M device join — duplicate right keys allowed.

    Same contract as :func:`device_hash_join`, but the output is an
    EXPANDED frame: one row per (left row, matching right row), and the
    left's probe keys are not in it. The one read from the device is the
    slot total. For ``semi``/``anti`` the left frame keeps its rows and only
    the validity mask changes. None when the output would pass
    ``MAX_EXPAND_ROWS`` slots (the JAX package then joins on its host)."""
    _broadcast_only(strategy)
    right_keys, right_valid, right_values = _pad_empty_right(right_keys, right_valid, right_values)
    s_h, order, nv, _dup = right_prep(right_valid, right_keys)
    fk = [left_cols[k] for k in left_key_names]
    cand, lo, off, slots = expand_count(left_valid, s_h, nv, fk, miss_slot=how == "left_outer")
    mt = int(slots.sum())
    if mt > MAX_EXPAND_ROWS:
        return None
    left_payload_names = [k for k in left_cols if k not in left_key_names]
    fills = tuple(f for _, _, f in right_values) if how == "left_outer" else ()
    outs = expand_rows(
        how,
        mt,
        cand,
        lo,
        off,
        slots,
        left_valid,
        order,
        fk,
        [left_cols[k] for k in left_payload_names],
        right_keys,
        [a for _, a, _ in right_values],
        fills,
    )
    if how in ("semi", "anti"):
        return dict(left_cols), outs[0], None
    new_cols = dict(zip(left_payload_names, outs[1 : 1 + len(left_payload_names)]))
    vi = 1 + len(left_payload_names)
    for (name, _, _), arr in zip(right_values, outs[vi : vi + len(right_values)]):
        new_cols[name] = arr
    return new_cols, outs[0], outs[-1] if how == "left_outer" else None


def device_broadcast_inner_join(
    fact_cols: Dict[str, torch.Tensor],
    fact_valid: torch.Tensor,
    key_name: str,
    dim_cols: Dict[str, torch.Tensor],
    dim_valid: torch.Tensor,
) -> Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """Single-key INNER wrapper over :func:`device_hash_join`."""
    values = [(n, a, float("nan")) for n, a in dim_cols.items() if n != key_name]
    res = device_hash_join(
        "inner", fact_cols, fact_valid, [key_name], [dim_cols[key_name]], dim_valid, values
    )
    if res is None:
        return None
    new_cols, new_valid, _ = res
    return new_cols, new_valid
