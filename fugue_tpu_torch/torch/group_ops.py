"""Per-group reduction helpers for compiled keyed transformers, the port of
``fugue_tpu/jax/group_ops.py``.

A torch-annotated transformer with ``partition_by`` receives the frame's
columns as ``Dict[str, torch.Tensor]`` plus reserved tensors describing
the grouping. The engine picks one of two physical plans:

- **dense** (no presort, integer keys with a bounded value range): segment
  ids are dense bucket ids over the keys' spans; rows stay in place, in
  input order, so a group's rows are scattered over the frame;
- **sorted** (everything else): rows are sorted by (validity, keys,
  presort), segment ids are contiguous, and each group's rows are in
  order.

These helpers encode the plan difference ONCE so the same transformer runs
correctly under either plan: reduce through ``group_ops``, never with raw
``index_add_``/``scatter_reduce_`` (a raw reduction does not mask the
invalid rows, and under the JAX package's dense plan it under-merges
across shards). The plan is visible through reserved dict keys.

Example (demean per group)::

    from fugue_tpu_torch.torch import group_ops as go

    def demean(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        mean = go.mean(cols, cols["v"])
        return {"k": cols["k"], "v": cols["v"],
                "d": cols["v"] - go.per_row(cols, mean)}

String (dictionary-encoded) partition keys are admitted: the UDF sees
their int32 CODES (-1 = NULL), which group exactly; treat them as opaque
— pass them through to the output unchanged and the engine reattaches
the dictionary. Interpreting code values inside the UDF is undefined.

On one device a group's table is whole once it is reduced: the JAX
package's cross-shard merge (``psum``/``pmin``/``pmax`` under the dense
plan) is the identity here. Group reductions are ``index_add_`` and
``scatter_reduce_`` into a table filled with the reduction's identity, so
an empty segment holds 0, ``inf`` or ``-inf`` as ``jax.ops.segment_*``
gives. The running (window) helpers need the sorted plan.
"""

from typing import Any, Callable, Dict, Optional

import torch

from ..exceptions import FugueInvalidOperation

SEGMENTS = "__segments__"
VALID = "__valid__"
# dense-plan markers (present in cols only under the dense plan)
SEGMENT_SPACE = "__segment_space__"  # dummy tensor; shape[0] = id space size
SPANS_SHARDS = "__segments_span_shards__"


def num_segments(cols: Dict[str, Any]) -> int:
    """Upper bound of the segment-id space (the size of a group table)."""
    if SEGMENT_SPACE in cols:
        return cols[SEGMENT_SPACE].shape[0]
    return cols[SEGMENTS].shape[0]


def _merge(cols: Dict[str, Any], table: torch.Tensor) -> torch.Tensor:
    """The dense plan's cross-shard merge: the identity on one device. A
    frame spread over several processes is ROADMAP.md A.7 work, so a
    process group of more than one rank is refused rather than merged
    partially."""
    if SPANS_SHARDS in cols:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError(
                "group tables merged across processes are not ported "
                "(ROADMAP.md A.7 multi-device layout)"
            )
    return table


def _masked(cols: Dict[str, Any], x: torch.Tensor, fill: Any) -> torch.Tensor:
    return torch.where(cols[VALID], x, torch.full((), fill, dtype=x.dtype, device=x.device))


def segment_sum(cols: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Per-group sum of ``x`` (padding/invalid rows excluded) — returns the
    group table (index with ``per_row`` to broadcast back)."""
    xv = _masked(cols, x, 0)
    table = torch.zeros(num_segments(cols), dtype=x.dtype, device=x.device)
    return _merge(cols, table.index_add_(0, cols[SEGMENTS], xv))


def segment_count(cols: Dict[str, Any], dtype: Any = None) -> torch.Tensor:
    """Per-group count of valid rows."""
    dt = dtype if dtype is not None else torch.float64
    return segment_sum(cols, cols[VALID].to(dt))


def _segment_extreme(cols: Dict[str, Any], x: torch.Tensor, kind: str) -> torch.Tensor:
    ident = _minmax_identity(x.dtype, kind)
    table = torch.full((num_segments(cols),), ident, dtype=x.dtype, device=x.device)
    # scatter_reduce_ takes int64 ids only
    seg = cols[SEGMENTS].to(torch.int64)
    return table.scatter_reduce_(0, seg, _masked(cols, x, ident), "a" + kind, include_self=True)


def segment_min(cols: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    return _merge(cols, _segment_extreme(cols, x, "min"))


def segment_max(cols: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    return _merge(cols, _segment_extreme(cols, x, "max"))


def mean(cols: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Per-group mean of ``x`` over valid rows."""
    s = segment_sum(cols, x)
    c = segment_count(cols, dtype=x.dtype)
    return s / torch.clamp(c, min=1)


def per_row(cols: Dict[str, Any], table: torch.Tensor) -> torch.Tensor:
    """Broadcast a group table back to rows (``table[segment_id]``)."""
    return table[cols[SEGMENTS]]


def _require_ordered(cols: Dict[str, Any], what: str) -> None:
    if SPANS_SHARDS in cols:
        raise FugueInvalidOperation(
            f"{what} needs ordered, shard-complete groups (the sorted plan);"
            " the dense plan leaves groups spanning shards in input order."
            " Add a presort to the partition spec to force the sorted plan."
        )


def _segment_starts(cols: Dict[str, Any]) -> torch.Tensor:
    """True at the first row of each (contiguous) segment."""
    seg = cols[SEGMENTS]
    start = torch.ones_like(seg, dtype=torch.bool)
    start[1:] = seg[1:] != seg[:-1]
    return start


def running_sum(cols: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Per-row RUNNING sum of ``x`` within its group, in sort order — the
    ``SUM(...) OVER (PARTITION BY k ORDER BY ... ROWS UNBOUNDED PRECEDING)``
    window kernel. Sorted-plan only (groups must be contiguous + ordered);
    invalid/padding rows contribute 0. Row-aligned output."""
    _require_ordered(cols, "running_sum")
    # accumulate in the widest type: a global f32/i32 prefix sum would
    # leak the frame's absolute rounding/overflow into every group's
    # c - base subtraction; the result casts back at the end
    acc_dt = torch.float64 if x.is_floating_point() else torch.int64
    xv = _masked(cols, x, 0).to(acc_dt)
    c = torch.cumsum(xv, 0)
    first = _segment_first_row(cols)  # -> the cumsum base to subtract
    run = torch.where(cols[VALID], c - (c[first] - xv[first]), 0)
    return run.to(x.dtype)


def _segment_first_row(cols: Dict[str, Any]) -> torch.Tensor:
    """Per row, the index of its segment's first row (segments are
    contiguous under the sorted plan). The JAX package takes a
    ``segment_min`` of the row index; here each segment's first row stores
    its index into the segment's slot, with no atomics (on rows sorted by
    segment, every atomic of a segment would go to one address), and the
    other rows store into spare slots past the table, spread over 1,024 of
    them, whose values are never read."""
    seg = cols[SEGMENTS].to(torch.int64)
    n = seg.shape[0]
    idx = torch.arange(n, device=seg.device)
    slot = torch.where(_segment_starts(cols), seg, n + (idx & 1023))
    table = torch.empty(n + 1024, dtype=torch.int64, device=seg.device)
    return table.scatter_(0, slot, idx)[seg]


def row_number(cols: Dict[str, Any], dtype: Any = None) -> torch.Tensor:
    """Per-row 1-based position within its group, in sort order — the
    ``ROW_NUMBER() OVER (PARTITION BY k ORDER BY ...)`` window kernel.
    Sorted-plan only. Row-aligned output."""
    _require_ordered(cols, "row_number")
    dt = dtype if dtype is not None else torch.int64
    return running_sum(cols, cols[VALID].to(dt))


def _minmax_identity(dtype: torch.dtype, kind: str) -> Any:
    """The min/max identity for ``dtype`` (shared by segment_* and
    running_* kernels)."""
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    if dtype == torch.bool:
        return kind == "min"
    ii = torch.iinfo(dtype)
    return ii.max if kind == "min" else ii.min


def _segmented_scan(
    cols: Dict[str, Any], x: torch.Tensor, combine: Callable, identity: Any, span: Optional[int] = None
) -> torch.Tensor:
    """Generic inclusive per-group scan, as a log-step (Hillis–Steele) scan
    in place of the JAX package's ``lax.associative_scan``: ⌈log2 n⌉
    passes, pass i combining each row with the row 2^i earlier when both
    are in the same segment (segments are contiguous under the sorted
    plan, so that row's partial result lies wholly inside the group). NaN
    inputs (the device NULL) are masked to the identity, matching the
    engine's SQL window semantics (NULLs are skipped, not propagated).
    ``span``, the length of the longest segment where the caller knows it,
    cuts the passes to ⌈log2 span⌉."""
    seg = cols[SEGMENTS]
    mask = cols[VALID]
    is_float = x.is_floating_point()
    if is_float:
        mask = mask & torch.logical_not(torch.isnan(x))
    out = torch.where(mask, x, torch.full((), identity, dtype=x.dtype, device=x.device))
    seen = mask  # any non-NULL value seen so far in the group
    n, d = out.shape[0], 1
    limit = n if span is None else min(n, span)
    while d < limit:
        same = seg[d:] == seg[:-d]
        out = torch.cat([out[:d], torch.where(same, combine(out[:-d], out[d:]), out[d:])])
        seen = torch.cat([seen[:d], seen[d:] | (same & seen[:-d])])
        d *= 2
    if is_float:
        # a frame with no non-NULL values yet is NULL (SQL), not the
        # scan identity — e.g. the leading NULL row's own running MIN
        out = torch.where(seen, out, float("nan"))
    return torch.where(cols[VALID], out, torch.full((), identity, dtype=x.dtype, device=x.device))


def running_min(cols: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Per-row running MIN within its group, in sort order (the
    ``MIN(...) OVER (... ROWS UNBOUNDED PRECEDING)`` kernel); NaN (NULL)
    inputs are skipped, SQL-style. Sorted-plan only."""
    _require_ordered(cols, "running_min")
    return _segmented_scan(cols, x, torch.minimum, _minmax_identity(x.dtype, "min"))


def running_max(cols: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Per-row running MAX within its group, in sort order; NaN (NULL)
    inputs are skipped, SQL-style. Sorted-plan only."""
    _require_ordered(cols, "running_max")
    return _segmented_scan(cols, x, torch.maximum, _minmax_identity(x.dtype, "max"))


def _shift(cols: Dict[str, Any], x: torch.Tensor, n: int, fill: Any, forward: bool) -> torch.Tensor:
    """Shared LAG/LEAD body: shift ``x`` by ``n`` rows within its group."""
    if not (isinstance(n, int) and n >= 1):
        raise FugueInvalidOperation(f"lag/lead offset must be an int >= 1, got {n!r}")
    if fill is None:
        if not x.is_floating_point():
            raise FugueInvalidOperation(
                "lag/lead over a non-float column needs an explicit fill "
                "value (there is no integer NULL on this path; a silent 0 "
                "would be indistinguishable from data)"
            )
        fill = float("nan")
    seg = cols[SEGMENTS]
    pad_v = torch.full((n,), fill, dtype=x.dtype, device=x.device)
    pad_s = torch.full((n,), -1, dtype=seg.dtype, device=seg.device)
    if forward:  # lag: value from n rows EARLIER
        shifted = torch.cat([pad_v, x[:-n]])
        seg_shift = torch.cat([pad_s, seg[:-n]])
    else:  # lead: value from n rows LATER
        shifted = torch.cat([x[n:], pad_v])
        seg_shift = torch.cat([seg[n:], pad_s])
    ok = (seg_shift == seg) & cols[VALID]
    return torch.where(ok, shifted, pad_v[:1])


def lag(cols: Dict[str, Any], x: torch.Tensor, n: int = 1, fill: Any = None) -> torch.Tensor:
    """Value of ``x`` ``n`` rows EARLIER within the same group (SQL
    ``LAG(x, n)``); rows with no predecessor get ``fill`` (NaN for floats
    when unset; non-float columns require an explicit fill).
    Sorted-plan only."""
    _require_ordered(cols, "lag")
    return _shift(cols, x, n, fill, forward=True)


def lead(cols: Dict[str, Any], x: torch.Tensor, n: int = 1, fill: Any = None) -> torch.Tensor:
    """Value of ``x`` ``n`` rows LATER within the same group (SQL
    ``LEAD(x, n)``); non-float columns require an explicit fill.
    Sorted-plan only."""
    _require_ordered(cols, "lead")
    return _shift(cols, x, n, fill, forward=False)
