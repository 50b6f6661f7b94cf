"""The pandas evaluator of the column-expression IR, copied from
``fugue_tpu/column/eval.py``: ``evaluate``, the scalar functions,
``eval_filter``, ``eval_select`` (WHERE → projection or aggregate →
HAVING → DISTINCT) and ``eval_agg``, ``rewrite_having_aggs`` and the
vectorized ``_fast_grouped_agg``. The host engine's ``select``,
``filter``, ``assign`` and ``aggregate`` run through it, as the JAX
package's do; the device evaluator is ``column/torch_eval.py``."""

from typing import Any, Dict, List, Optional

import numpy as np
import pandas as pd
import pyarrow as pa

from .._utils.assertion import assert_or_throw
from ..exceptions import FugueSQLError
from ..schema import Schema
from .expressions import (
    ColumnExpr,
    _BinaryOpExpr,
    _CaseWhenExpr,
    _FuncExpr,
    _InExpr,
    _LikeExpr,
    _LitColumnExpr,
    _NamedColumnExpr,
    _UnaryOpExpr,
)

# scalar SQL functions on pandas series
_SCALAR_FUNCS = {
    "ABS": lambda s: s.abs(),
    "UPPER": lambda s: s.str.upper(),
    "LOWER": lambda s: s.str.lower(),
    "LENGTH": lambda s: s.str.len().astype("int64"),
    "TRIM": lambda s: s.str.strip(),
    "FLOOR": lambda s: np.floor(s),
    "CEIL": lambda s: np.ceil(s),
    "CEILING": lambda s: np.ceil(s),
    "ROUND": lambda s, *a: s.round(int(a[0]) if a else 0),
    "SQRT": lambda s: np.sqrt(s),
    "EXP": lambda s: np.exp(s),
    "LN": lambda s: np.log(s),
    "LOG": lambda s: np.log(s),
    # SQL MOD: the result sign follows the DIVIDEND (unlike python %)
    "MOD": lambda s, d: np.sign(s) * (abs(s) % abs(d)),
    # SQL POWER returns double (negative int exponents are legal)
    "POWER": lambda s, e: np.power(s.astype("float64"), e),
    "POW": lambda s, e: np.power(s.astype("float64"), e),
    "SIGN": lambda s: np.sign(s),
    "REPLACE": lambda s, old, new: s.str.replace(old, new, regex=False),
    # SQL LPAD/RPAD: multi-char pads allowed; result truncated to width
    "LPAD": lambda s, w, c=" ": s.map(
        lambda x: None if x is None else (str(c) * int(w) + x)[-int(w):]
        if len(x) < int(w) else x[: int(w)]
    ),
    "RPAD": lambda s, w, c=" ": s.map(
        lambda x: None if x is None else (x + str(c) * int(w))[: int(w)]
    ),
    "SUBSTRING": lambda s, start, length=None: s.str.slice(
        int(start) - 1, int(start) - 1 + int(length) if length is not None else None
    ),
    "SUBSTR": lambda s, start, length=None: s.str.slice(
        int(start) - 1, int(start) - 1 + int(length) if length is not None else None
    ),
    "CONCAT": None,  # special-cased (multi-arg)
}
from .sql import SelectColumns


def _cast_series(s: pd.Series, tp: pa.DataType) -> pd.Series:
    arr = pa.Array.from_pandas(s)
    return arr.cast(tp, safe=False).to_pandas()


def evaluate(pdf: pd.DataFrame, expr: ColumnExpr) -> Any:
    """Evaluate a non-aggregate expression to a Series (or scalar literal)."""
    res = _eval(pdf, expr)
    if expr.as_type is not None and isinstance(res, pd.Series):
        res = _cast_series(res, expr.as_type)
    elif expr.as_type is not None:
        res = _cast_series(pd.Series([res]), expr.as_type).iloc[0]
    return res


def _eval(pdf: pd.DataFrame, expr: ColumnExpr) -> Any:
    if isinstance(expr, _NamedColumnExpr):
        return pdf[expr.name]
    if isinstance(expr, _LitColumnExpr):
        return expr.value
    if isinstance(expr, _UnaryOpExpr):
        v = evaluate(pdf, expr.col)
        if expr.op == "IS_NULL":
            return v.isna()
        if expr.op == "NOT_NULL":
            return v.notna()
        if expr.op == "~":
            if isinstance(v, pd.Series) and v.dtype == object:
                return v.map(lambda x: None if x is None else not x)
            return ~v
        if expr.op == "-":
            return -v
        raise NotImplementedError(f"unary op {expr.op}")
    if isinstance(expr, _BinaryOpExpr):
        l = evaluate(pdf, expr.left)
        r = evaluate(pdf, expr.right)
        op = expr.op
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            return l / r
        if op == "<":
            return l < r
        if op == "<=":
            return l <= r
        if op == ">":
            return l > r
        if op == ">=":
            return l >= r
        if op == "==":
            return l == r
        if op == "!=":
            return l != r
        if op == "&":
            return _as_bool(l) & _as_bool(r)
        if op == "|":
            return _as_bool(l) | _as_bool(r)
        raise NotImplementedError(f"binary op {op}")
    if isinstance(expr, _CaseWhenExpr):
        # positional (numpy) evaluation: input frames from groupby carry
        # non-default indexes, so label alignment would silently misalign
        n = len(pdf)
        result = np.empty(n, dtype=object)
        decided = np.zeros(n, dtype=bool)
        for c, v in expr.cases:
            cond = _as_bool(evaluate(pdf, c))
            cond_np = (
                cond.to_numpy() if isinstance(cond, pd.Series) else np.full(n, bool(cond))
            )
            val = evaluate(pdf, v)
            val_np = val.to_numpy() if isinstance(val, pd.Series) else None
            pick = cond_np & ~decided
            result[pick] = val_np[pick] if val_np is not None else val
            decided |= cond_np
        dval = evaluate(pdf, expr.default)
        dval_np = dval.to_numpy() if isinstance(dval, pd.Series) else None
        result[~decided] = dval_np[~decided] if dval_np is not None else dval
        return pd.Series(result, index=pdf.index).infer_objects()
    if isinstance(expr, _InExpr):
        v = evaluate(pdf, expr.col)
        if not isinstance(v, pd.Series):
            v = pd.Series([v] * len(pdf))
        res = v.isin(expr.values)
        # SQL three-valued logic: NULL never satisfies IN or NOT IN
        return res if expr.positive else (~res & v.notna())
    if isinstance(expr, _LikeExpr):
        import re as _re

        v = evaluate(pdf, expr.col)
        if not isinstance(v, pd.Series):
            v = pd.Series([v] * len(pdf))
        pat = _re.escape(expr.pattern).replace("%", ".*").replace("_", ".")
        res = v.str.match(f"^{pat}$", na=False)
        return res if expr.positive else (~res & v.notna())
    if isinstance(expr, _FuncExpr) and not expr.is_agg:
        fname = expr.func.upper()
        if fname == "CONCAT":
            args = [evaluate(pdf, a) for a in expr.args]
            res = None
            for a in args:
                part = a.astype(str) if isinstance(a, pd.Series) else str(a)
                res = part if res is None else res + part
            return res
        if fname in _SCALAR_FUNCS and _SCALAR_FUNCS[fname] is not None:
            args = [evaluate(pdf, a) for a in expr.args]
            first = args[0]
            if not isinstance(first, pd.Series):
                first = pd.Series([first] * len(pdf))
            return _SCALAR_FUNCS[fname](first, *args[1:])
        if expr.func.upper() == "COALESCE":
            args = [evaluate(pdf, a) for a in expr.args]
            res = None
            for a in args:
                if res is None:
                    res = a if isinstance(a, pd.Series) else pd.Series([a] * len(pdf))
                else:
                    fill = a if not isinstance(a, pd.Series) else a
                    res = res.where(res.notna(), fill)
            return res
        raise NotImplementedError(f"function {expr.func} not supported on pandas")
    raise NotImplementedError(f"can't evaluate {type(expr)}")


def _as_bool(v: Any) -> Any:
    if isinstance(v, pd.Series):
        if v.dtype == bool:
            return v
        return v.astype("boolean").fillna(False).astype(bool)
    return bool(v)


def eval_agg(pdf: pd.DataFrame, expr: _FuncExpr) -> Any:
    """Evaluate an aggregate function over a whole frame → scalar."""
    func = expr.func.upper()
    arg = expr.args[0] if len(expr.args) > 0 else None
    v = evaluate(pdf, arg) if arg is not None else None
    if not isinstance(v, pd.Series):
        v = pd.Series([v] * len(pdf))
    if expr.is_distinct:
        v = v.drop_duplicates()
    if func == "COUNT":
        return int(v.notna().sum())
    if func == "MIN":
        nn = v.dropna()
        return None if len(nn) == 0 else nn.min()
    if func == "MAX":
        nn = v.dropna()
        return None if len(nn) == 0 else nn.max()
    if func == "SUM":
        nn = v.dropna()
        return None if len(nn) == 0 else nn.sum()
    if func == "AVG":
        nn = v.dropna()
        return None if len(nn) == 0 else nn.mean()
    if func == "FIRST":
        nn = v.dropna()
        return nn.iloc[0] if len(nn) > 0 else None
    if func == "LAST":
        nn = v.dropna()
        return nn.iloc[-1] if len(nn) > 0 else None
    raise NotImplementedError(f"aggregation {func} not supported")


def eval_filter(pdf: pd.DataFrame, condition: ColumnExpr) -> pd.DataFrame:
    mask = evaluate(pdf, condition)
    mask = _as_bool(mask)
    if not isinstance(mask, pd.Series):
        return pdf if mask else pdf.head(0)
    return pdf[mask].reset_index(drop=True)


def eval_select(
    pdf: pd.DataFrame,
    input_schema: Schema,
    columns: SelectColumns,
    where: Optional[ColumnExpr] = None,
    having: Optional[ColumnExpr] = None,
) -> pd.DataFrame:
    """Full SELECT semantics on pandas: where → project/aggregate → having
    → distinct."""
    sc = columns.replace_wildcard(input_schema).assert_all_with_names()
    if where is not None:
        pdf = eval_filter(pdf, where)
    if not sc.has_agg:
        data = {}
        for c in sc.all_cols:
            v = evaluate(pdf, c)
            if not isinstance(v, pd.Series):
                v = pd.Series([v] * len(pdf), dtype=object if v is None else None)
            data[c.output_name] = v.reset_index(drop=True)
        res = pd.DataFrame(data) if len(pdf) > 0 else pd.DataFrame(
            {k: pd.Series(dtype=v.dtype) for k, v in data.items()}
        )
        assert_or_throw(having is None, FugueSQLError("having requires aggregation"))
        if sc.is_distinct:
            res = res.drop_duplicates().reset_index(drop=True)
        return res

    group_keys = list(sc.group_keys)
    group_key_ids = {id(c) for c in group_keys}
    if len(group_keys) == 0:
        row = {}
        for c in sc.all_cols:
            if isinstance(c, _LitColumnExpr):
                row[c.output_name] = evaluate(pdf, c)
            else:
                row[c.output_name] = _agg_one(pdf, c)
        res = pd.DataFrame([row], columns=[c.output_name for c in sc.all_cols])
    else:
        key_names = []
        kdf = pd.DataFrame(index=pdf.index)
        for k in group_keys:
            kv = evaluate(pdf, k)
            if not isinstance(kv, pd.Series):
                kv = pd.Series([kv] * len(pdf))
            kdf[k.output_name] = kv
            key_names.append(k.output_name)
        work = pd.concat([pdf.reset_index(drop=True), kdf.reset_index(drop=True).add_prefix("__key_")], axis=1)
        out_rows: List[dict] = []
        grouped = work.groupby(
            [f"__key_{k}" for k in key_names], dropna=False, sort=False
        )
        fast = _fast_grouped_agg(
            grouped, list(pdf.columns), sc, key_names, group_key_ids
        )
        if fast is not None:
            if having is not None:
                fast = _eval_having_filter(fast, sc, having)
            if sc.is_distinct:
                fast = fast.drop_duplicates().reset_index(drop=True)
            return fast
        for kv, sub in grouped:
            if not isinstance(kv, tuple):
                kv = (kv,)
            row = {}
            for name, val in zip(key_names, kv):
                row[name] = None if _is_na(val) else val
            sub_orig = sub[[c for c in pdf.columns]]
            for c in sc.all_cols:
                if id(c) in group_key_ids:
                    continue
                row[c.output_name] = _agg_one(sub_orig, c)
            out_rows.append(row)
        cols_order = [c.output_name for c in sc.all_cols]
        res = pd.DataFrame(out_rows, columns=cols_order) if len(out_rows) > 0 else pd.DataFrame(columns=cols_order)
    if having is not None:
        res = _eval_having_filter(res, sc, having)
    if sc.is_distinct:
        res = res.drop_duplicates().reset_index(drop=True)
    return res


def substitute_exprs(expr: ColumnExpr, mapping: Dict[str, str]) -> ColumnExpr:
    """Replace every subtree whose structural uuid (alias ignored; cast
    kept, with a cast-stripped second probe so ``CAST(expr AS t)`` matches
    ``expr`` and keeps the cast) appears in ``mapping`` with a reference
    to the mapped column name —
    used by GROUP BY-expression materialization to point projections and
    HAVING at the computed helper columns. Unknown node types pass
    through unchanged (no substitution inside them)."""
    from .expressions import col as _named_col, structural_key

    def _finish(out: ColumnExpr, e: ColumnExpr) -> ColumnExpr:
        """Restore the original node's cast/alias onto a rebuilt node."""
        if e.as_type is not None and out.as_type is None:
            out = out.cast(e.as_type)
        if e.output_name != "" and out.output_name != e.output_name:
            out = out.alias(e.output_name)
        return out

    def rw(e: ColumnExpr) -> ColumnExpr:
        key = structural_key(e)
        if key in mapping:
            return _finish(_named_col(mapping[key]), e)
        if e.as_type is not None:
            # CAST(<mapped expr> AS t) matches the bare expr and keeps the
            # cast — the cast-KEPT first probe only prevents CAST(x) from
            # silently COLLIDING with plain x when naming helpers
            bare_key = structural_key(e.cast(None))
            if bare_key in mapping:
                return _finish(_named_col(mapping[bare_key]).cast(e.as_type), e)
        if isinstance(e, _FuncExpr) and e.is_agg:
            # aggregate subtrees stay UNTOUCHED: their args evaluate over
            # pre-group rows, and rebuilding would downgrade the agg
            # subclass to a plain _FuncExpr (losing is_agg)
            return e
        if isinstance(e, _BinaryOpExpr):
            return _finish(_BinaryOpExpr(e.op, rw(e.left), rw(e.right)), e)
        if isinstance(e, _UnaryOpExpr):
            return _finish(_UnaryOpExpr(e.op, rw(e.col)), e)
        if isinstance(e, _FuncExpr):
            return _finish(
                _FuncExpr(
                    e.func,
                    *[rw(a) for a in e.args],
                    arg_distinct=e.is_distinct,
                ),
                e,
            )
        if isinstance(e, _InExpr):
            return _finish(_InExpr(rw(e.col), e.values, e.positive), e)
        if isinstance(e, _LikeExpr):
            return _finish(_LikeExpr(rw(e.col), e.pattern, e.positive), e)
        if isinstance(e, _CaseWhenExpr):
            return _finish(
                _CaseWhenExpr(
                    [(rw(c), rw(v)) for c, v in e.cases], rw(e.default)
                ),
                e,
            )
        return e

    return rw(expr)


def rewrite_having_aggs(
    having: ColumnExpr, agg_cols: List[ColumnExpr]
) -> ColumnExpr:
    """Replace aggregate subtrees in HAVING that structurally match a SELECT
    aggregate (ignoring alias/cast) with references to its output column —
    the rewritten predicate evaluates over the aggregated frame with the
    plain evaluator. Shared by the oracle and the device engine."""
    from .expressions import col as _named_col
    from .functions import is_agg

    agg_map: Dict[str, str] = {}
    for c in agg_cols:
        if is_agg(c):
            agg_map[c.alias("").cast(None).__uuid__()] = c.output_name

    def rw(e: ColumnExpr) -> ColumnExpr:
        if isinstance(e, _FuncExpr) and e.is_agg:
            key = e.alias("").cast(None).__uuid__()
            if key not in agg_map:
                raise FugueSQLError(
                    f"HAVING aggregate {e!r} does not appear in the SELECT list"
                )
            out: ColumnExpr = _named_col(agg_map[key])
            if e.as_type is not None:
                out = out.cast(e.as_type)
            return out
        if not is_agg(e):
            return e
        if isinstance(e, _BinaryOpExpr):
            return _BinaryOpExpr(e.op, rw(e.left), rw(e.right))
        if isinstance(e, _UnaryOpExpr):
            return _UnaryOpExpr(e.op, rw(e.col))
        if isinstance(e, _FuncExpr):
            return _FuncExpr(
                e.func, *[rw(a) for a in e.args], arg_distinct=e.is_distinct
            )
        if isinstance(e, _InExpr):
            return _InExpr(rw(e.col), e.values, e.positive)
        if isinstance(e, _LikeExpr):
            return _LikeExpr(rw(e.col), e.pattern, e.positive)
        if isinstance(e, _CaseWhenExpr):
            return _CaseWhenExpr(
                [(rw(c), rw(v)) for c, v in e.cases], rw(e.default)
            )
        raise NotImplementedError(f"unsupported HAVING expression {e!r}")

    return rw(having)


def _eval_having_filter(
    res: pd.DataFrame, sc: SelectColumns, having: ColumnExpr
) -> pd.DataFrame:
    """HAVING over the aggregated frame: rewrite aggregate subtrees to read
    their computed output columns, then filter normally."""
    from .functions import is_agg

    aggs = [c for c in sc.all_cols if is_agg(c)]
    return eval_filter(res, rewrite_having_aggs(having, aggs))


def _fast_grouped_agg(
    grouped: Any,
    input_cols: List[str],
    sc: SelectColumns,
    key_names: List[str],
    group_key_ids: Any,
) -> Optional[pd.DataFrame]:
    """Vectorized (cython) grouped aggregation for the common SELECT shape
    where every non-key output is a plain ``FUNC(column)`` (or COUNT(*)) —
    the per-group Python loop below costs ~1s/M rows; this path is ~50x
    faster and preserves the same NULL semantics (SUM/MIN/MAX/AVG of an
    all-NULL group is NULL via skipna + ``min_count``; FIRST/LAST skip
    NULLs like the scalar evaluator). Returns None when any output needs
    the general per-group evaluator."""
    plans: List[Any] = []
    for c in sc.all_cols:
        if id(c) in group_key_ids:
            continue
        if not isinstance(c, _FuncExpr) or not c.is_agg or c.is_distinct:
            return None
        func = c.func.upper()
        if len(c.args) != 1:
            return None
        a = c.args[0]
        if func == "COUNT" and (
            (isinstance(a, _LitColumnExpr) and a.value is not None)
            or (isinstance(a, _NamedColumnExpr) and a.name == "*")
        ):
            plans.append((c.output_name, "size", None, c.as_type))
            continue
        if (
            func not in ("SUM", "COUNT", "MIN", "MAX", "AVG", "FIRST", "LAST")
            or not isinstance(a, _NamedColumnExpr)
            or a.name not in input_cols
        ):
            return None
        plans.append((c.output_name, func, a.name, c.as_type))
    pieces: Dict[str, pd.Series] = {}
    for name, kind, src, as_type in plans:
        if (
            kind in ("MIN", "MAX")
            and src is not None
            and grouped.obj[src].dtype == object
        ):
            # cython groupby min/max raises on object columns holding None
            # (str-vs-None comparison); the general per-group path below
            # drops NULLs first — same semantics, just slower
            return None
        if kind == "size":
            s = grouped.size()
        elif kind == "SUM":
            s = grouped[src].sum(min_count=1)
        elif kind == "COUNT":
            s = grouped[src].count()
        elif kind == "MIN":
            s = grouped[src].min()
        elif kind == "MAX":
            s = grouped[src].max()
        elif kind == "AVG":
            s = grouped[src].mean()
        elif kind == "FIRST":
            s = grouped[src].first()
        else:
            s = grouped[src].last()
        if as_type is not None:
            cast = _cast_series(s, as_type)  # returns a fresh RangeIndex
            cast.index = s.index  # re-align to the group keys
            s = cast
        pieces[name] = s
    if len(pieces) > 0:
        res = pd.DataFrame(pieces).reset_index()
    else:  # SELECT of group keys only
        res = grouped.size().reset_index().drop(columns=[0])
    res.columns = [
        (c[len("__key_"):] if isinstance(c, str) and c.startswith("__key_") else c)
        for c in res.columns
    ]
    return res.reindex(columns=[c.output_name for c in sc.all_cols])


def _is_na(v: Any) -> bool:
    try:
        return v is None or (isinstance(v, float) and np.isnan(v)) or v is pd.NA or v is pd.NaT
    except Exception:
        return False


def _agg_one(pdf: pd.DataFrame, c: ColumnExpr) -> Any:
    """Evaluate one select column that contains aggregation(s)."""
    if isinstance(c, _FuncExpr) and c.is_agg:
        v = eval_agg(pdf, c)
        if c.as_type is not None:
            v = _cast_series(pd.Series([v]), c.as_type).iloc[0]
        return v
    # expression over aggregates, e.g. sum(a) + 1: substitute agg nodes
    return _eval_scalar_expr(pdf, c)


def _eval_scalar_expr(pdf: pd.DataFrame, c: ColumnExpr) -> Any:
    if isinstance(c, _FuncExpr) and c.is_agg:
        return eval_agg(pdf, c)
    if isinstance(c, _LitColumnExpr):
        return c.value
    if isinstance(c, _BinaryOpExpr):
        l = _eval_scalar_expr(pdf, c.left)
        r = _eval_scalar_expr(pdf, c.right)
        return {
            "+": lambda: l + r,
            "-": lambda: l - r,
            "*": lambda: l * r,
            "/": lambda: l / r,
        }[c.op]()
    if isinstance(c, _UnaryOpExpr) and c.op == "-":
        return -_eval_scalar_expr(pdf, c.col)
    raise NotImplementedError(f"can't evaluate scalar expression {c!r}")
