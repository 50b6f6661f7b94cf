"""Window functions on pandas, copied from ``fugue_tpu/column/window.py``.

``eval_window`` computes one ``func(...) OVER (...)`` column of a pandas
frame: ``ROW_NUMBER/RANK/DENSE_RANK/LAG/LEAD`` and the windowed aggregates
``SUM/AVG/MIN/MAX/COUNT/FIRST/LAST`` over ``PARTITION BY`` groups with
``ORDER BY``, in the input's row order (SQL semantics). The host engine's
windowed SELECT runs it (``sql/executor.py``), and so does the device
engine's wherever the device plan (``torch/window.py``) declines.

Aggregates WITH an ORDER BY are running aggregates over the SQL default
frame (``RANGE UNBOUNDED PRECEDING .. CURRENT ROW``: peers share the
running value) or the frame given; without ORDER BY they cover the whole
partition. NULL order keys rank last; aggregates skip NULLs.
"""

from typing import Any, List

import numpy as np
import pandas as pd

from ..exceptions import FugueSQLSyntaxError
from .expressions import _WindowExpr

_WINDOW_AGGS = {"SUM": "sum", "AVG": "mean", "MIN": "min", "MAX": "max",
                "COUNT": "count", "FIRST": "first", "LAST": "last"}


def eval_window(pdf: pd.DataFrame, expr: _WindowExpr) -> pd.Series:
    from .eval import evaluate

    work = pdf.reset_index(drop=True)
    order_names = [n for n, _ in expr.order_by]
    asc = [a for _, a in expr.order_by]
    if len(order_names) > 0:
        ordered = work.sort_values(order_names, ascending=asc, kind="stable")
    else:
        ordered = work
    if len(expr.partition_by) > 0:
        grouped = ordered.groupby(expr.partition_by, dropna=False, sort=False)
    else:
        grouped = None
    func = expr.func

    def _arg_series(frame: pd.DataFrame) -> pd.Series:
        v = evaluate(frame, expr.args[0])
        if not isinstance(v, pd.Series):
            v = pd.Series([v] * len(frame), index=frame.index)
        return v

    if func == "ROW_NUMBER":
        res = (
            grouped.cumcount() + 1
            if grouped is not None
            else pd.Series(np.arange(1, len(ordered) + 1), index=ordered.index)
        )
    elif func in ("RANK", "DENSE_RANK"):
        if len(order_names) == 0:
            raise FugueSQLSyntaxError(f"{func} requires an ORDER BY")
        # composite ranks from the stable-sorted frame: a rank group starts
        # wherever any order column differs from the previous row WITHIN the
        # partition; NULL order keys compare equal to each other
        if len(ordered) == 0:
            return pd.Series([], dtype="int64")
        okeys = ordered[order_names]
        if grouped is not None:
            pkeys = [ordered[c] for c in expr.partition_by]
            prev = okeys.groupby(pkeys, dropna=False).shift()
            pos = grouped.cumcount()
        else:
            prev = okeys.shift()
            pos = pd.Series(np.arange(len(ordered)), index=ordered.index)
        # fillna(False): eq() over nullable extension dtypes yields pd.NA
        # for value-vs-NULL comparisons, and NA would pass .all() as True
        equal_prev = (
            okeys.eq(prev).fillna(False).astype(bool)
            | (okeys.isna() & prev.isna())
        ).all(axis=1)
        changed = ~equal_prev | (pos == 0)
        if func == "DENSE_RANK":
            res = (
                changed.groupby(pkeys, dropna=False).cumsum()
                if grouped is not None
                else changed.cumsum()
            )
        else:
            start_pos = pos.where(changed)
            res = (
                start_pos.groupby(pkeys, dropna=False).ffill()
                if grouped is not None
                else start_pos.ffill()
            ) + 1
        res = res.astype("int64")
    elif func in ("LAG", "LEAD"):
        def _scalar_arg(i: int) -> Any:
            # offset/default may be literals or constant expressions (-1.0)
            v = evaluate(ordered.head(1), expr.args[i])
            return v.iloc[0] if isinstance(v, pd.Series) else v

        offset = int(_scalar_arg(1)) if len(expr.args) > 1 else 1
        default = _scalar_arg(2) if len(expr.args) > 2 else None
        shift = offset if func == "LAG" else -offset
        v = _arg_series(ordered)
        # mark in-partition positions so the default only fills positions
        # whose offset falls OUTSIDE the partition (genuine NULLs pass through)
        marker = pd.Series(True, index=ordered.index)
        if grouped is not None:
            keys = [ordered[c] for c in expr.partition_by]
            res = v.groupby(keys, dropna=False).shift(shift)
            inpart = marker.groupby(keys, dropna=False).shift(shift)
        else:
            res = v.shift(shift)
            inpart = marker.shift(shift)
        if default is not None:
            res = res.where(inpart.notna(), default)
    elif func in _WINDOW_AGGS:
        v = _arg_series(ordered)
        keys = (
            [ordered[c] for c in expr.partition_by] if grouped is not None else None
        )
        frame = getattr(expr, "frame", None)
        if len(order_names) > 0:
            # SQL default frame with ORDER BY: RANGE UNBOUNDED PRECEDING ..
            # CURRENT ROW (peer rows share the running value)
            if frame is None:
                frame = ("range", "unb_prec", "current")
            kind, start, end = frame
            if start == "unb_prec" and end == "unb_foll":
                res = _whole_partition_agg(v, keys, func, ordered)
            elif kind == "rows" and start == "unb_prec" and end == "current":
                res = _running_agg(v, keys, func)
            elif kind == "range" and start == "unb_prec" and end == "current":
                run = _running_agg(v, keys, func)
                # broadcast each peer group's LAST running value (positional)
                pk = (keys or []) + [ordered[c] for c in order_names]
                res = run.groupby(pk, dropna=False).transform(
                    lambda x: x.iloc[-1]
                )
            else:
                res = _bounded_frame_agg(
                    ordered, v, keys, order_names, asc, func, frame
                )
        elif keys is not None:
            if func == "FIRST":
                res = v.groupby(keys, dropna=False).transform(lambda x: x.iloc[0])
            elif func == "LAST":
                res = v.groupby(keys, dropna=False).transform(lambda x: x.iloc[-1])
            else:
                res = v.groupby(keys, dropna=False).transform(_WINDOW_AGGS[func])
        else:
            if func == "FIRST":
                agg = v.iloc[0] if len(v) > 0 else None
            elif func == "LAST":
                agg = v.iloc[-1] if len(v) > 0 else None
            elif func == "COUNT":
                agg = v.notna().sum()
            else:
                agg = getattr(v, _WINDOW_AGGS[func])()
            res = pd.Series([agg] * len(ordered), index=ordered.index)
    else:
        raise FugueSQLSyntaxError(f"unsupported window function {func}")
    # restore the original row order
    return res.reindex(work.index)


def _whole_partition_agg(
    v: pd.Series, keys: Any, func: str, ordered: pd.DataFrame
) -> pd.Series:
    """UNBOUNDED PRECEDING .. UNBOUNDED FOLLOWING — the whole partition."""
    if keys is not None:
        g = v.groupby(keys, dropna=False)
        if func == "FIRST":
            return g.transform(lambda x: x.iloc[0])
        if func == "LAST":
            return g.transform(lambda x: x.iloc[-1])
        return g.transform(_WINDOW_AGGS[func])
    if func == "FIRST":
        agg = v.iloc[0] if len(v) > 0 else None
    elif func == "LAST":
        agg = v.iloc[-1] if len(v) > 0 else None
    elif func == "COUNT":
        agg = v.notna().sum()
    else:
        agg = getattr(v, _WINDOW_AGGS[func])()
    return pd.Series([agg] * len(v), index=v.index)


def _bound_offsets(start: Any, end: Any) -> Any:
    """Normalize bounds to (lo_off, hi_off) where None = unbounded; offsets
    are signed relative positions/values (preceding negative). The parser
    rejects UNBOUNDED FOLLOWING starts / UNBOUNDED PRECEDING ends."""

    def off(b: Any) -> Any:
        if b in ("unb_prec", "unb_foll"):
            return None
        if b == "current":
            return 0
        tag, n = b
        return -n if tag == "prec" else n

    return off(start), off(end)


def _bounded_frame_agg(
    ordered: pd.DataFrame,
    v: pd.Series,
    keys: Any,
    order_names: List[str],
    asc: List[bool],
    func: str,
    frame: Any,
) -> pd.Series:
    """Explicit ROWS/RANGE frames with numeric bounds.

    ROWS offsets are row positions; RANGE offsets are order-key value
    distances (single numeric ORDER BY key required). Per partition the
    window [lo, hi) per row comes from positions / ``searchsorted`` over
    the ordered keys; aggregates skip NULLs (SQL semantics).
    """
    if func in ("FIRST", "LAST"):
        raise FugueSQLSyntaxError(
            f"{func} does not support explicit window frames"
        )
    kind, start, end = frame
    lo_off, hi_off = _bound_offsets(start, end)
    if start == "unb_prec":
        lo_off = None
    range_offsets = kind == "range" and (
        lo_off not in (None, 0) or hi_off not in (None, 0)
    )
    if range_offsets and len(order_names) != 1:
        raise FugueSQLSyntaxError(
            "RANGE with offsets requires exactly one ORDER BY key"
        )

    out = np.full(len(v), np.nan, dtype=np.float64)
    vals = v.to_numpy(dtype=np.float64, na_value=np.nan)
    okeys = ordered[order_names] if kind == "range" else None
    if keys is not None:
        # positional locations per partition, in sorted (frame) order
        group_iter = [
            np.sort(np.asarray(g))
            for g in ordered.groupby(
                [k for k in keys], dropna=False, sort=False
            ).indices.values()
        ]
    else:
        group_iter = [np.arange(len(ordered))]
    for gpos in group_iter:
        n = len(gpos)
        if n == 0:  # empty frame (keys=None path): nothing to window
            continue
        gv = vals[gpos]
        if kind == "rows":
            lo = (
                np.zeros(n, dtype=np.int64)
                if lo_off is None
                else np.clip(np.arange(n) + lo_off, 0, n)
            )
            hi = (
                np.full(n, n, dtype=np.int64)
                if hi_off is None
                else np.clip(np.arange(n) + hi_off + 1, 0, n)
            )
        elif range_offsets:
            okey = ordered[order_names[0]].to_numpy(dtype=np.float64)[gpos]
            sign = 1.0 if asc[0] else -1.0
            k = sign * okey  # ascending view
            lo = (
                np.zeros(n, dtype=np.int64)
                if lo_off is None
                else np.searchsorted(k, k + lo_off, side="left")
            )
            hi = (
                np.full(n, n, dtype=np.int64)
                if hi_off is None
                else np.searchsorted(k, k + hi_off, side="right")
            )
        else:
            # RANGE with CURRENT ROW bounds: peer-group (tied order keys)
            # boundaries computed WITHIN the partition — the global sort
            # interleaves partitions, so row-to-previous-row comparison
            # there would merge peers whose global neighbors happen to tie.
            # fillna(False): eq() over nullable extension dtypes yields
            # pd.NA for value-vs-NULL comparisons, and NA would pass
            # .all() as True
            gk = okeys.iloc[gpos]
            eq_prev = (
                gk.eq(gk.shift()).fillna(False).astype(bool)
                | (gk.isna() & gk.shift().isna())
            ).all(axis=1)
            changed = (~eq_prev).to_numpy().copy()
            changed[0] = True
            gid = np.cumsum(changed) - 1
            starts = np.flatnonzero(changed)
            ends = np.append(starts[1:], n)
            lo = (
                np.zeros(n, dtype=np.int64)
                if lo_off is None
                else starts[gid]  # CURRENT ROW → first peer
            )
            hi = (
                np.full(n, n, dtype=np.int64)
                if hi_off is None
                else ends[gid]  # CURRENT ROW → last peer
            )
        for i in range(n):
            w = gv[lo[i] : hi[i]]
            w = w[~np.isnan(w)]
            if func == "COUNT":
                out[gpos[i]] = len(w)
            elif len(w) == 0:
                out[gpos[i]] = np.nan
            elif func == "SUM":
                out[gpos[i]] = w.sum()
            elif func == "AVG":
                out[gpos[i]] = w.mean()
            elif func == "MIN":
                out[gpos[i]] = w.min()
            elif func == "MAX":
                out[gpos[i]] = w.max()
            else:  # pragma: no cover
                raise FugueSQLSyntaxError(f"unsupported frame aggregate {func}")
    res = pd.Series(out, index=ordered.index)  # positional over `ordered`
    if func == "COUNT":
        res = res.fillna(0).astype("int64")
    return res


def _running_agg(v: pd.Series, keys: Any, func: str) -> pd.Series:
    """SQL aggregates skip NULLs: cumulative ops run over null-filled values
    and positions with zero preceding non-null rows stay NULL."""

    def _grp(s: pd.Series) -> Any:
        return s.groupby(keys, dropna=False) if keys is not None else s

    nn = v.notna()
    n = _grp(nn).cumsum() if keys is not None else nn.cumsum()
    if func == "COUNT":
        return n.astype("int64")
    if func in ("SUM", "MIN", "MAX", "AVG"):
        attr = {"SUM": "cumsum", "AVG": "cumsum", "MIN": "cummin", "MAX": "cummax"}[func]
        cs = getattr(_grp(v), attr)() if keys is not None else getattr(v, attr)()
        # pandas cum* skip NaN but leave NaN AT null positions; SQL carries
        # the previous running value — ffill (dtype-preserving, works for
        # datetimes too) and mask positions with zero preceding non-nulls
        cs = cs.groupby(keys, dropna=False).ffill() if keys is not None else cs.ffill()
        res = cs / n if func == "AVG" else cs
        return res.where(n > 0)
    if func == "FIRST":
        # FIRST_VALUE = the first ROW's value, nulls included
        if keys is not None:
            return v.groupby(keys, dropna=False).transform(lambda x: x.iloc[0])
        return pd.Series([v.iloc[0]] * len(v), index=v.index)
    if func == "LAST":  # running last = the current row's value
        return v
    raise FugueSQLSyntaxError(f"unsupported running window aggregate {func}")
