"""Window functions on the device, the port of ``fugue_tpu/jax/window.py``.

``func(...) OVER (PARTITION BY ... ORDER BY ...)`` over a
``TorchDataFrame``: one lexicographic sort of the rows by (validity,
partition keys, order keys), then every window column of a SELECT from
the sorted rows in one pass, with prefix sums, segmented scans and
binary searches; the frame never goes to the host.

Covered, as in the JAX package: ROW_NUMBER, RANK, DENSE_RANK, LAG and
LEAD (literal offset and default), and SUM/AVG/MIN/MAX/COUNT/FIRST/LAST
over

- the whole partition (no ORDER BY, or UNBOUNDED .. UNBOUNDED),
- the running ROWS UNBOUNDED PRECEDING .. CURRENT ROW,
- RANGE UNBOUNDED PRECEDING .. CURRENT ROW (peers share the running
  value; the default frame with an ORDER BY),
- bounded ROWS frames (prefix-sum differences, a sparse table for
  MIN/MAX) and RANGE frames with value offsets over one numeric order key
  (a binary search per row).

``plan_device_windows`` is the gate: it decides from the frame's schema,
encodings and masks alone whether the plan covers a SELECT, before any
device work, and ``run_device_windows`` then always answers. Where the
gate declines, the SQL executor runs the pandas evaluator
(``column/window.py``) exactly where the JAX engine does.

NULL semantics are the host evaluator's: NaN is the device NULL, null
masks mark NULLs of int and bool columns, aggregates skip NULLs, running
aggregates are NULL until the first non-NULL, a whole-partition SUM of
NULLs is 0, FIRST/LAST are positional, NULL order keys sort last.

On one device a partition is whole: the JAX package's hash exchange
before the sort (``engine.repartition(..., algo="hash")``, and
``_repartition_single`` for a global OVER) returns the frame itself.
SUM of a nullable int64 is exact in int64 (wrapping as pandas' cumsum
does), where the JAX package splits it into float64 halves and declines
above 2^21 rows a shard.
"""

from typing import Any, Dict, List, Optional, Tuple

import pyarrow as pa
import torch

from ..collections.partition import PartitionSpec
from ..column.expressions import _LitColumnExpr, _NamedColumnExpr, _UnaryOpExpr, _WindowExpr
from ..ops.segment import _order_by, _sort_image
from ..schema import Schema
from .dataframe import TorchDataFrame, is_wide_unsigned
from .group_ops import SEGMENTS, VALID, _segmented_scan

_AGGS = {"SUM", "AVG", "MIN", "MAX", "COUNT", "FIRST", "LAST"}
_RANKS = {"ROW_NUMBER", "RANK", "DENSE_RANK"}
_NO_LIT = object()
_DECLARED_CASTS = {
    pa.int8(): torch.int8, pa.int16(): torch.int16, pa.int32(): torch.int32, pa.int64(): torch.int64,
    pa.uint8(): torch.uint8, pa.bool_(): torch.bool, pa.float32(): torch.float32,
}


def _norm_frame(expr: _WindowExpr) -> Optional[Tuple]:
    """An aggregate's frame as a plan tag, or None where the plan does not
    cover it."""
    if len(expr.order_by) == 0:
        return ("whole",)
    kind, start, end = expr.frame if expr.frame is not None else ("range", "unb_prec", "current")
    if start == "unb_prec" and end == "unb_foll":
        return ("whole",)
    if kind == "rows" and start == "unb_prec" and end == "current":
        return ("running",)
    if kind == "range" and start == "unb_prec" and end == "current":
        return ("peers",)
    if expr.func not in ("SUM", "COUNT", "AVG", "MIN", "MAX"):
        return None

    def off(b: Any) -> Any:
        if b == "current":
            return 0
        if isinstance(b, tuple):
            return -b[1] if b[0] == "prec" else b[1]
        return None  # unbounded: to the segment's edge

    # RANGE offsets, 0 included, come from a binary search over the one
    # order key: value equality is the peer group
    return ("rows_bounded" if kind == "rows" else "range_bounded", off(start), off(end))


def _lit_value(a: Any) -> Any:
    if isinstance(a, _LitColumnExpr):
        return a.value
    # "-1.0" parses as the negation of a literal
    if (
        isinstance(a, _UnaryOpExpr)
        and a.op == "-"
        and isinstance(a.col, _LitColumnExpr)
        and isinstance(a.col.value, (int, float))
    ):
        return -a.col.value
    return _NO_LIT


def _plan_items(
    tdf: TorchDataFrame, items: List[Tuple[str, _WindowExpr]]
) -> Optional[Tuple[Tuple, List[str], List[Tuple[str, bool]]]]:
    """The gates of ``jax/window.py`` ``_plan_items``: ``(specs, pkeys,
    order_items)``, or None where the plan does not cover the items."""
    if len(items) == 0:
        return None
    pkeys = list(items[0][1].partition_by)
    # an empty pkeys is the GLOBAL window: one segment of every row
    # one physical sort serves every item whose ORDER BY is a PREFIX of the
    # longest; peers are found per item, on its own keys
    order_items: List[Tuple[str, bool]] = []
    for _, expr in items:
        oi = [(n, bool(a)) for n, a in expr.order_by]
        if len(oi) > len(order_items):
            if order_items != oi[: len(order_items)]:
                return None
            order_items = oi
        elif oi != order_items[: len(oi)]:
            return None
    cols = tdf.device_cols
    # the unsigned types above uint8 live widened (``torch/dataframe.py``):
    # their windows run on the pandas evaluator
    unsigned = {f.name for f in tdf.schema.fields if is_wide_unsigned(f.type)}

    def plain(c: str) -> bool:
        return c in cols and c not in tdf.encodings and c not in tdf.null_masks and c not in unsigned

    def groupable(c: str) -> bool:
        """A partition or order key: plain, or a SORTED dictionary (codes
        group exactly, code order is value order, -1 is NULL)."""
        enc = tdf.encodings.get(c)
        return plain(c) or (
            c in cols and c not in tdf.null_masks and enc is not None
            and enc.get("kind") == "dict" and bool(enc.get("sorted"))
        )

    def masked(c: str) -> bool:
        """A plain column with a null mask (nullable int or bool)."""
        return c in cols and c in tdf.null_masks and c not in tdf.encodings and c not in unsigned

    if not all(groupable(k) and not tdf.maybe_nan(k) for k in pkeys):
        return None
    if not all(groupable(n) or masked(n) for n, _ in order_items):
        return None
    specs: List[Tuple] = []
    for out_name, expr in items:
        if list(expr.partition_by) != pkeys:
            return None  # partitions differ between items
        func, n_ord = expr.func, len(expr.order_by)
        if func in _RANKS:
            if func != "ROW_NUMBER" and n_ord == 0:
                return None
            specs.append((out_name, func, n_ord))
            continue
        if func in ("LAG", "LEAD"):
            if len(expr.args) < 1 or not isinstance(expr.args[0], _NamedColumnExpr):
                return None
            arg = expr.args[0].name
            if not plain(arg):
                return None
            offset, default = 1, None
            if len(expr.args) > 1:
                off_v = _lit_value(expr.args[1])
                if off_v is _NO_LIT or int(off_v) < 0:  # a negative offset flips direction
                    return None
                offset = int(off_v)
            if len(expr.args) > 2:
                default = _lit_value(expr.args[2])
                if default is _NO_LIT or (default is not None and not isinstance(default, (int, float, bool))):
                    return None
            dt = cols[arg].dtype
            # a NULL fill makes the result float64, where the host keeps
            # the argument's type; float16 has no arrow type on the way out
            if (default is None and dt != torch.float64) or dt == torch.float16:
                return None
            specs.append((out_name, func, arg, offset, default))
            continue
        if func not in _AGGS:
            return None
        if len(expr.args) != 1 or not isinstance(expr.args[0], _NamedColumnExpr):
            return None
        arg = expr.args[0].name
        masked_arg = masked(arg)
        if not plain(arg) and not masked_arg:
            return None
        tag = _norm_frame(expr)
        if tag is None:
            return None
        bounded = tag[0] in ("rows_bounded", "range_bounded")
        dt = cols[arg].dtype
        if func in ("FIRST", "LAST") and (masked_arg or tdf.maybe_nan(arg) or dt == torch.float16):
            return None  # positional semantics against NULLs; float16 out
        if not bounded and func not in ("COUNT", "FIRST", "LAST") and not masked_arg and dt != torch.float64:
            # float64 accumulation would change the host's declared type
            # (long, float) and lose ints past 2^53. Masked arguments and
            # bounded frames are exempt: the host computes those in
            # float64 and casts back to the declared type
            return None
        # the host is exact over nullable 64-bit ints (int64 on the device)
        exact = not bounded and masked_arg and func not in ("COUNT", "FIRST", "LAST") and dt == torch.int64
        if tag[0] == "range_bounded":
            # value offsets need ONE plain, NaN-free, numeric order key
            if n_ord != 1:
                return None
            okey = expr.order_by[0][0]
            if not plain(okey) or tdf.maybe_nan(okey) or cols[okey].dtype == torch.bool:
                return None
            if not all(o is None or isinstance(o, (int, float)) for o in tag[1:]):
                return None
        out_cast: Any = None
        if exact:
            out_cast = "int64_exact"
        elif (masked_arg or bounded) and func in ("SUM", "MIN", "MAX", "AVG"):
            # the host declares the argument's type (int/long/float/bool)
            # and computes in float64: cast back to it
            out_cast = _DECLARED_CASTS.get(expr.infer_type(tdf.schema))
        specs.append((out_name, func, arg, tag, n_ord, out_cast))
    return tuple(specs), pkeys, order_items


def plan_device_windows(
    tdf: Any, items: List[Tuple[str, _WindowExpr]], keep: List[str]
) -> Optional[Tuple]:
    """The gate, run BEFORE the WHERE filter: an opaque plan for
    :func:`run_device_windows`, or None where the host evaluator runs.
    ``keep`` names the frame's columns the SELECT's projection reads."""
    if not isinstance(tdf, TorchDataFrame) or tdf.host_table is not None:
        return None
    if len(tdf.device_cols) != len(tdf.schema):
        return None
    planned = _plan_items(tdf, items)
    if planned is None:
        return None
    return planned + ([n for n in tdf.schema.names if n in set(keep)],)


def _order_images(tdf: TorchDataFrame, name: str, asc: bool) -> List[torch.Tensor]:
    """The integer images one order key sorts by, most significant first,
    in ``lax.sort``'s order of the JAX package's operands: NULLs (NaN, a
    null mask, the dictionary's -1) last, a descending key reversed by
    negation, ``~`` or ``logical_not``. Equal images are peers."""
    key = tdf.device_cols[name]
    mask = tdf.null_masks.get(name)
    if mask is not None:  # nullable int/bool: the mask sorts first, then the filled value
        key = torch.where(mask, torch.zeros((), dtype=key.dtype, device=key.device), key)
        if not asc:
            key = torch.logical_not(key) if key.dtype == torch.bool else ~key
        return [mask.to(torch.uint8), _sort_image(key)]
    if key.is_floating_point():
        # the canonical NaN's image lies above +inf's, ascending or not
        return [_sort_image(key if asc else -key)]
    if name in tdf.encodings:
        image = key if asc else ~key
        return [torch.where(key < 0, torch.iinfo(torch.int32).max, image)]
    if asc:
        return [_sort_image(key)]
    return [_sort_image(torch.logical_not(key) if key.dtype == torch.bool else ~key)]


def _runs(change: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted rows split into runs where ``change`` is True (``change[0]``
    is): per row its run's index, and per run its first and last row."""
    rid = torch.cumsum(change, 0) - 1
    starts = torch.nonzero(change).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_full((1,), change.shape[0])]) - 1
    return rid, starts, ends


def _bsearch(kv: torch.Tensor, targets: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
             steps: int, right: bool) -> torch.Tensor:
    """Per row, the first index of ``[lo, hi)`` of the sorted ``kv`` where
    ``kv >= target`` (``> target`` when ``right``): a fixed number of
    halving steps, each row searching its own segment (``jax/window.py``
    ``bsearch``)."""
    n = kv.shape[0]
    for _ in range(steps):
        ok = lo < hi
        mid = (lo + hi) // 2
        km = kv[mid.clamp(0, n - 1)]
        go = (km <= targets) if right else (km < targets)
        lo, hi = torch.where(ok & go, mid + 1, lo), torch.where(ok & torch.logical_not(go), mid, hi)
    return lo


def run_device_windows(engine: Any, tdf: TorchDataFrame, plan: Tuple) -> TorchDataFrame:
    """Every window column of ``plan`` over ``tdf``: a frame of the
    projection's columns (``keep``) and one column per item, its rows in
    the sorted order, invalid rows last."""
    specs, pkeys, order_items, keep = plan
    if len(pkeys) > 0:
        tdf = engine.repartition(tdf, PartitionSpec(algo="hash", by=pkeys))
    else:
        tdf = engine._repartition_single(tdf)
    valid = tdf.device_valid_mask()
    n = valid.shape[0]
    key_images = [_sort_image(tdf.device_cols[k]) for k in pkeys]
    order_images = [_order_images(tdf, name, asc) for name, asc in order_items]
    flat = key_images + [im for ims in order_images for im in ims]
    perm = _order_by(reversed(flat), valid)
    sv = valid[perm]
    iota = torch.arange(n, device=valid.device)

    def changed(image: torch.Tensor) -> torch.Tensor:
        s = image[perm]
        out = torch.zeros(n, dtype=torch.bool, device=s.device)
        out[1:] = s[1:] != s[:-1]
        return out

    seg_change = torch.logical_not(sv)
    for image in key_images:
        seg_change |= changed(image)
    seg_change[:1] = True
    del key_images
    # peer runs per ORDER BY prefix length: level 0 is the segments
    levels = {0: seg_change}
    for j, ims in enumerate(order_images):
        change = levels[j].clone()
        for image in ims:
            change |= changed(image)
        levels[j + 1] = change
    needed = set(keep) | {s[2] for s in specs if s[1] not in _RANKS}
    sc = {c: tdf.device_cols[c][perm] for c in needed}
    sm = {c: tdf.null_masks[c][perm] for c in needed if c in tdf.null_masks}
    del order_images, flat, perm
    runs: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    def run(j: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if j not in runs:
            runs[j] = _runs(levels[j])
        return runs[j]

    seg_id, starts, ends = run(0)
    seg_start, seg_end = starts[seg_id], ends[seg_id]
    del starts, ends
    span_memo: List[int] = []

    def span() -> int:
        """The longest segment's length (one read on the host)."""
        if len(span_memo) == 0:
            span_memo.append(int((seg_end - seg_start).max()) + 1 if n > 0 else 1)
        return span_memo[0]

    seg_cols = {SEGMENTS: seg_id, VALID: sv}
    global_window = len(pkeys) == 0

    def scan(x: torch.Tensor, op: Any, identity: Any) -> torch.Tensor:
        return _segmented_scan(seg_cols, x, op, identity, span=span())

    def rel_sum(x: torch.Tensor) -> torch.Tensor:
        """The inclusive prefix sum of ``x`` within each segment: a plain
        cumsum over one segment and for integers (exact, wrapping), a
        segmented scan for floats, whose error stays that of its segment."""
        if global_window:
            return torch.cumsum(x, 0)
        if not x.is_floating_point():
            c = torch.cumsum(x, 0)
            return c - (c[seg_start] - x[seg_start])
        return scan(x, torch.add, 0.0)

    outs: Dict[str, torch.Tensor] = {}
    out_masks: Dict[str, torch.Tensor] = {}
    tables: Dict[Tuple[str, str], Tuple] = {}

    def counts(arg: str) -> Tuple:
        """(non-NULL flags, their segment prefix count)."""
        if (arg, "n") not in tables:
            nn = sv.clone()
            if sc[arg].is_floating_point():
                nn &= torch.logical_not(torch.isnan(sc[arg]))
            if arg in sm:
                nn &= torch.logical_not(sm[arg])
            tables[(arg, "n")] = (nn, rel_sum(nn.to(torch.int64)))
        return tables[(arg, "n")]

    def sums(arg: str) -> Tuple:
        """(float64 values with NULLs as 0, their segment prefix sum)."""
        if (arg, "s") not in tables:
            xm = torch.where(counts(arg)[0], sc[arg].to(torch.float64), 0.0)
            tables[(arg, "s")] = (xm, rel_sum(xm))
        return tables[(arg, "s")]

    for spec in specs:
        out_name, func = spec[0], spec[1]
        if func == "ROW_NUMBER":
            outs[out_name] = iota - seg_start + 1
            continue
        if func == "RANK":
            rid, starts, _ = run(spec[2])
            outs[out_name] = starts[rid] - seg_start + 1
            continue
        if func == "DENSE_RANK":
            pid = run(spec[2])[0]
            outs[out_name] = pid - pid[seg_start] + 1
            continue
        if func in ("LAG", "LEAD"):
            _, _, arg, offset, default = spec
            x = sc[arg]
            idx = iota - offset if func == "LAG" else iota + offset
            ok = (idx >= seg_start) & (idx <= seg_end)
            val = x[idx.clamp(0, n - 1)]
            fill = float("nan") if default is None else default
            outs[out_name] = torch.where(ok, val, torch.tensor(fill, device=x.device).to(x.dtype))
            continue
        _, _, arg, tag, n_ord, out_cast = spec
        if tag[0] == "whole":
            at = seg_end
        elif tag[0] == "peers":
            rid, _, ends = run(n_ord)
            at = ends[rid]
        else:
            at = iota
        if out_cast == "int64_exact":
            # a nullable int64 over running/peer/whole frames: exact in int64
            x = sc[arg]
            nn = sv & torch.logical_not(sm[arg])
            count = rel_sum(nn.to(torch.int64))[at]
            if func == "AVG":
                s = rel_sum(torch.where(nn, x, 0))[at]
                outs[out_name] = torch.where(count > 0, s.to(torch.float64) / count.clamp(min=1), float("nan"))
                continue
            if func == "SUM":
                outs[out_name] = rel_sum(torch.where(nn, x, 0))[at]
            else:
                op, fill = (torch.minimum, torch.iinfo(torch.int64).max) if func == "MIN" else (
                    torch.maximum, torch.iinfo(torch.int64).min)
                outs[out_name] = scan(torch.where(nn, x, fill), op, fill)[at]
            out_masks[out_name] = count == 0
            continue
        if func == "FIRST":
            res = sc[arg][seg_start]
        elif func == "LAST":  # the value at the frame's end
            res = sc[arg][at]
        elif tag[0] in ("whole", "running", "peers"):
            nn, n_rel = counts(arg)
            count = n_rel[at]
            if func == "COUNT":
                res = count
            elif func == "SUM":
                # a whole partition of NULLs sums to 0, as pandas' transform
                c_rel = sums(arg)[1]
                res = c_rel[at] if tag[0] == "whole" else torch.where(count > 0, c_rel[at], float("nan"))
            elif func == "AVG":
                res = torch.where(count > 0, sums(arg)[1][at] / count.clamp(min=1), float("nan"))
            else:
                op, fill = (torch.minimum, float("inf")) if func == "MIN" else (torch.maximum, float("-inf"))
                xs = torch.where(nn, sc[arg].to(torch.float64), fill)
                res = torch.where(count > 0, scan(xs, op, fill)[at], float("nan"))
        else:
            res = _bounded(func, tag, sc[arg], *counts(arg), lambda arg=arg: sums(arg), seg_start, seg_end,
                           iota, span(), sc, order_items, global_window)
        if out_cast is not None and func != "COUNT":
            # computed in float64 with NaN as NULL: the declared type back,
            # with a null mask where it has no NaN
            if out_cast == torch.float32:
                res = res.to(torch.float32)
            else:
                isnull = torch.isnan(res)
                out_masks[out_name] = isnull
                res = torch.where(isnull, 0.0, res).to(out_cast)
        outs[out_name] = res

    fields = []
    for spec in specs:
        arr = outs[spec[0]]
        fields.append(pa.field(spec[0], pa.from_numpy_dtype(torch.empty(0, dtype=arr.dtype).numpy().dtype)))
    schema = Schema(list(tdf.schema.extract(keep).fields) + fields)
    nan_cols = None
    if tdf._nan_cols is not None:
        nan_cols = {c for c in keep if c in tdf._nan_cols} | {
            s[0] for s in specs if outs[s[0]].is_floating_point()}
    return TorchDataFrame(
        _internal=dict(
            device=tdf.device,
            device_cols={**{c: sc[c] for c in keep}, **outs},
            host_tbl=None,
            row_count=tdf._row_count,
            valid_mask=sv,
            nan_cols=nan_cols,
            encodings={c: e for c, e in tdf.encodings.items() if c in keep},
            null_masks={**{c: m for c, m in sm.items() if c in keep}, **out_masks},
            schema=schema,
        )
    )


def _bounded(func: str, tag: Tuple, x: torch.Tensor, nn: torch.Tensor, n_rel: torch.Tensor, sums: Any,
             seg_start: torch.Tensor, seg_end: torch.Tensor, iota: torch.Tensor, span: int,
             sc: Dict[str, torch.Tensor], order_items: List[Tuple[str, bool]], global_window: bool) -> torch.Tensor:
    """A bounded ROWS or RANGE frame of the argument ``x`` (``nn`` its
    non-NULL flags, ``n_rel`` their segment prefix count, ``sums()`` its
    prefix sums): per row the inclusive ``[lo, hi]`` of sorted rows, then
    prefix-sum differences (SUM/COUNT/AVG) or a sparse table's two
    overlapping ranges (MIN/MAX). An unbounded side is the segment's edge."""
    n = iota.shape[0]
    lo_off, hi_off = tag[1], tag[2]
    if tag[0] == "rows_bounded":
        lo = seg_start if lo_off is None else torch.maximum(seg_start, iota + lo_off)
        hi = seg_end if hi_off is None else torch.minimum(seg_end, iota + hi_off)
    else:  # value distances on the one order key, in its ascending view
        name, asc = order_items[0]
        kv = sc[name].to(torch.float64)
        if not asc:
            kv = -kv

        def search(offset: float, right: bool) -> torch.Tensor:
            targets = kv + float(offset)
            if global_window:
                # one segment: the valid rows are a sorted prefix
                nvalid = int(seg_end[0]) + 1 if n > 0 else 0
                side = "right" if right else "left"
                found = torch.searchsorted(kv[:nvalid], targets, side=side)
                return found
            return _bsearch(kv, targets, seg_start.clone(), seg_end + 1, span.bit_length(), right)

        lo = seg_start if lo_off is None else search(lo_off, right=False)
        hi = seg_end if hi_off is None else search(hi_off, right=True) - 1
    empty = hi < lo
    lo_c, hi_c = lo.clamp(0, n - 1), hi.clamp(0, n - 1)
    count = torch.where(empty, 0, n_rel[hi_c] - n_rel[lo_c] + nn[lo_c].to(torch.int64))
    if func == "COUNT":
        return count
    if func in ("SUM", "AVG"):
        xm, c_rel = sums()
        s = c_rel[hi_c] - c_rel[lo_c] + xm[lo_c]
        if func == "AVG":
            s = s / count.clamp(min=1)
        return torch.where(count > 0, s, float("nan"))
    op, fill = (torch.minimum, float("inf")) if func == "MIN" else (torch.maximum, float("-inf"))
    xs = torch.where(nn, x.to(torch.float64), fill)
    # levels cover the longest window: a segment at most, or the ROWS width
    max_len = span
    if tag[0] == "rows_bounded" and lo_off is not None and hi_off is not None:
        max_len = min(span, max(1, hi_off - lo_off + 1))
    levels = max(1, (max_len - 1).bit_length())
    table = [xs]
    for j in range(levels):
        step, prev = 1 << j, table[-1]
        table.append(op(prev, torch.cat([prev[step:], prev.new_full((min(step, n),), fill)])))
    st = torch.stack(table)
    length = (hi - lo + 1).clamp(min=1)
    k = torch.zeros_like(length)
    for j in range(1, levels + 1):
        k += length >= (1 << j)
    second = (hi - (torch.ones_like(k) << k) + 1).clamp(0, n - 1)
    res = op(st[k, lo_c], st[k, second])
    return torch.where(count > 0, res, float("nan"))
