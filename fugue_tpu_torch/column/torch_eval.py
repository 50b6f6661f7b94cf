"""The device evaluator of the column-expression IR: the port of
``fugue_tpu/column/jax_eval.py``, as eager torch ops on the tensors' device.

- ``evaluate_torch`` (``evaluate_jnp`` :32) evaluates a projection;
- ``evaluate_torch_3v`` (``evaluate_jnp_3v`` :173) evaluates a predicate
  with SQL three-valued logic into ``(value, isnull)``: NULL is a null
  mask, a NaN float or a negative dictionary code, AND/OR are Kleene's;
- ``plan_dict_lookups``, ``_epoch_of``, ``_rewrite_datetime_literals``,
  ``device_predicate_plan`` and ``can_evaluate_on_device`` are the JAX
  module's planners, copied with the same gates: a string predicate runs
  once on the host over a column's dictionary, and the device gathers its
  result by code; a date or timestamp literal becomes the column's epoch.

**Types.** The JAX package runs with ``jax_enable_x64``, and its answers
follow JAX's promotion, not torch's: a Python int or float literal is
*weakly typed* (``int32 + 1`` is int32, ``float32 >= 0.05`` compares in
float32), an integer with a Python float gives float64 (torch: float32),
``int64 + float32`` gives float32, true division of bool/int8/int16/int32
gives float32 and of int64 float64, and a cast of a float to an integer
saturates with NaN as 0. Torch's own promotion is never relied on:
``_join`` computes JAX's result type on its lattice, both operands are
cast to it, and the op runs in that one dtype. A weakly typed tensor (the
result of ``bool + 1`` or ``int32 + 0.5``) is carried as ``_Weak``.

**Unsigned types.** uint16, uint32 and uint64 columns live widened on the
device (``torch/dataframe.py``). :func:`typed_columns` hands them to the
evaluator as ``_Uns``: the value in int32 (uint16) or int64 (uint32), or
uint64's int64 bits. Arithmetic runs in the storage dtype and wraps to the
type's width, as JAX's does in the type; comparisons of uint64 flip the
top bit; a conversion to float reads uint64's bits as unsigned.
:func:`to_column` turns a result into a column of its declared type.

A null flag is a bool tensor or a Python bool (``False``: never NULL),
so a column with no NULL source costs no pass."""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from ..exceptions import FugueInvalidOperation
from .expressions import (
    ColumnExpr,
    _BinaryOpExpr,
    _CaseWhenExpr,
    _FuncExpr,
    _LitColumnExpr,
    _NamedColumnExpr,
    _UnaryOpExpr,
)



def pa_type_to_np_dtype(tp: pa.DataType) -> Any:
    if pa.types.is_boolean(tp):
        return np.bool_
    return tp.to_pandas_dtype()


# ---- JAX's type promotion (jax._src.dtypes, x64) -----------------------------

# the lattice: each type and the types just above it; "i*" and "f*" are the
# weak int and float of a Python literal (int64 and float64 under x64)
_UP = {
    "b1": ("i*",), "i*": ("u8", "i8"), "u8": ("u16", "i16"), "u16": ("u32", "i32"),
    "u32": ("u64", "i64"), "u64": ("f*",), "i8": ("i16",), "i16": ("i32",), "i32": ("i64",),
    "i64": ("f*",), "f*": ("f16", "bf16"), "f16": ("f32",), "bf16": ("f32",), "f32": ("f64",),
    "f64": (),
}
_NODE = {
    torch.bool: "b1", torch.uint8: "u8", torch.int8: "i8", torch.int16: "i16",
    torch.int32: "i32", torch.int64: "i64", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.float32: "f32", torch.float64: "f64",
}
_DTYPE = {n: d for d, n in _NODE.items()}
_DTYPE.update({"i*": torch.int64, "f*": torch.float64})
_WEAK = ("i*", "f*")
# the unsigned nodes above u8: each one's storage dtype and width
_U_STORE = {"u16": torch.int32, "u32": torch.int64, "u64": torch.int64}
_U_MASK = {"u16": 0xFFFF, "u32": 0xFFFFFFFF}
_U_OF_ARROW = {"uint16": "u16", "uint32": "u32", "uint64": "u64"}
_ARROW_OF_U = {n: getattr(pa, a)() for a, n in _U_OF_ARROW.items()}
_FLIP = -(1 << 63)  # uint64 columns live as their bits with this bit flipped


def _above(n: str) -> frozenset:
    out = {n}
    for m in _UP[n]:
        out |= _above(m)
    return frozenset(out)


_ABOVE = {n: _above(n) for n in _UP}


def _join(a: str, b: str) -> str:
    """The least upper bound of two types on JAX's lattice."""
    common = _ABOVE[a] & _ABOVE[b]
    return next(n for n in common if _ABOVE[n] >= common)


def _inexact(n: str) -> str:
    """The float type true division promotes an integer type to."""
    if n == "i*":
        return "f*"
    if n in ("i64", "u64"):
        return "f64"
    if n in ("b1", "u8", "i8", "i16", "u16", "i32", "u32"):
        return "f32"
    return n


class _Weak:
    """A tensor of a weak type (``i*`` or ``f*``)."""

    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        self.t = t


class _Uns:
    """A tensor of an unsigned node ``n`` (``u16``, ``u32``, ``u64``): the
    values in int32 or int64, uint64 as its int64 bits."""

    __slots__ = ("t", "n")

    def __init__(self, t: torch.Tensor, n: str):
        self.t = t
        self.n = n


def typed_columns(cols: Dict[str, torch.Tensor], schema: Any) -> Dict[str, Any]:
    """``cols`` as the evaluator takes them: the columns of an unsigned type
    of ``schema`` (uint16/32/64) as ``_Uns``, uint64's flipped storage
    turned back into its bits."""
    out: Dict[str, Any] = dict(cols)
    for name, t in cols.items():
        n = _U_OF_ARROW.get(str(schema[name].type)) if name in schema else None
        if n is not None:
            out[name] = _Uns(t ^ _FLIP if n == "u64" else t, n)
    return out


def to_column(v: Any, tp: Optional[pa.DataType]) -> Tuple[Any, Optional[pa.DataType]]:
    """An evaluated value as a column of arrow type ``tp`` (None: the
    value's own): ``(tensor or scalar, type)``. An unsigned result becomes
    the storage of ``tp`` (an unsigned ``tp``: wrapped to its width, uint64
    flipped; another: the value converted, uint64's bits as int64)."""
    if not isinstance(v, _Uns):
        return v, tp
    if tp is None:
        tp = _ARROW_OF_U[v.n]
    n = _U_OF_ARROW.get(str(tp))
    if n is not None:
        t = _to_node(v, n, v.t.device)
        return (t ^ _FLIP if n == "u64" else t), tp
    return _tensor(v, _np_to_torch_dtype(pa_type_to_np_dtype(tp)), v.t.device), tp


def _node(v: Any) -> str:
    if isinstance(v, _Uns):
        return v.n
    if isinstance(v, _Weak):
        return "f*" if v.t.is_floating_point() else "i*"
    if isinstance(v, torch.Tensor):
        if v.dtype not in _NODE:
            raise NotImplementedError(f"{v.dtype} has no device arithmetic in the port")
        return _NODE[v.dtype]
    if isinstance(v, (bool, np.bool_)):
        return "b1"
    if isinstance(v, int):
        return "i*"
    if isinstance(v, float):
        return "f*"
    raise NotImplementedError(f"{v!r} has no device type")


def _is_scalar(v: Any) -> bool:
    return not isinstance(v, (torch.Tensor, _Weak, _Uns))


def _tensor(v: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``v`` as a tensor of ``dtype``; a Python int wraps and a Python float
    rounds as JAX converts a weak literal."""
    if isinstance(v, _Uns):
        if v.n == "u64" and dtype.is_floating_point:
            # the bits read as unsigned: a negative int64 is 2**64 more
            f = v.t.to(torch.float64)
            return torch.where(v.t < 0, f + 18446744073709551616.0, f).to(dtype)
        if dtype == torch.bool:
            return v.t != 0
        return v.t.to(dtype)  # values of u16/u32; u64's bits (wrapping) in ints
    if isinstance(v, _Weak):
        v = v.t
    if isinstance(v, torch.Tensor):
        return v if v.dtype == dtype else v.to(dtype)
    if isinstance(v, (bool, np.bool_)):
        src = torch.bool
    elif isinstance(v, int):
        src = torch.int64
    else:
        src = torch.float64
    return torch.tensor(v, dtype=src, device=device).to(dtype)


def _to_node(v: Any, n: str, device: torch.device) -> torch.Tensor:
    """``v`` in node ``n``'s representation: an unsigned node's storage
    (an integer wrapped to its width), else a tensor of ``n``'s dtype."""
    if n not in _U_STORE:
        return _tensor(v, _DTYPE[n], device)
    if isinstance(v, _Uns) and v.n == n:
        return v.t
    x = _tensor(v, torch.int64, device)
    if n == "u64":
        return x
    return (x & _U_MASK[n]).to(_U_STORE[n])


def _wrap(t: torch.Tensor, n: str) -> Any:
    if n in _U_STORE:
        return _Uns(t if n == "u64" else t & _U_MASK[n], n)
    return _Weak(t) if n in _WEAK else t


def _strong(v: Any) -> Any:
    return v.t if isinstance(v, (_Weak, _Uns)) else v


def _device_of(*vs: Any) -> torch.device:
    """The device of the first tensor among ``vs`` (the CPU if none is one)."""
    for v in vs:
        if isinstance(v, (_Weak, _Uns)):
            return v.t.device
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


_ARITH = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
}
_CMP = {
    "<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge, "==": torch.eq, "!=": torch.ne,
}
_PY_CMP = {
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b, ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b, "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
}


def _binary(op: str, l: Any, r: Any) -> Any:
    """``l op r`` for ``+ - * /`` and the comparisons, in JAX's result type."""
    if _is_scalar(l) and _is_scalar(r):
        return _ARITH[op](l, r) if op in _ARITH else _PY_CMP[op](l, r)
    n = _join(_node(l), _node(r))
    if op == "/":
        n = _inexact(n)
    elif op == "-" and n == "b1":
        raise TypeError("subtract does not accept dtype bool")
    dev = _device_of(l, r)
    a, b = _to_node(l, n, dev), _to_node(r, n, dev)
    if op in _CMP:
        if n == "u64":  # unsigned order: the bits with the top one flipped
            a, b = a ^ _FLIP, b ^ _FLIP
        return _CMP[op](a, b)
    if n == "b1":  # JAX adds bools as OR and multiplies them as AND
        return torch.logical_or(a, b) if op == "+" else torch.logical_and(a, b)
    return _wrap(_ARITH[op](a, b), n)


def _truth(v: Any) -> Any:
    """``v != 0`` (NaN is true), as ``jnp.asarray(v, dtype=bool)``."""
    v = _strong(v)
    if isinstance(v, torch.Tensor):
        return v if v.dtype == torch.bool else v.to(torch.bool)
    return bool(v)


def _logical_not(v: Any) -> Any:
    v = _truth(v)
    return torch.logical_not(v) if isinstance(v, torch.Tensor) else (not v)


def _logical(op: str, l: Any, r: Any) -> Any:
    a, b = _truth(l), _truth(r)
    if isinstance(a, bool) and isinstance(b, bool):
        return (a and b) if op == "&" else (a or b)
    if isinstance(a, bool):
        a, b = b, a
    if isinstance(b, bool):  # a tensor with a constant
        if op == "&":
            return a if b else torch.zeros_like(a)
        return torch.ones_like(a) if b else a
    return torch.logical_and(a, b) if op == "&" else torch.logical_or(a, b)


def _neg(v: Any) -> Any:
    if _node(v) == "b1":
        raise TypeError("negative does not accept dtype bool")
    if isinstance(v, _Weak):
        return _Weak(-v.t)
    if isinstance(v, _Uns):
        return _wrap(-v.t, v.n)
    return -v


def _isnan(v: Any) -> Any:
    v = _strong(v)
    if isinstance(v, torch.Tensor):
        return torch.isnan(v) if v.is_floating_point() else torch.zeros_like(v, dtype=torch.bool)
    return isinstance(v, float) and v != v


def _where(cond: Any, x: Any, y: Any) -> Any:
    """``jnp.where(cond, x, y)``: the condition as truth, the result in the
    join of the two branches' types."""
    c = _truth(cond)
    n = _join(_node(x), _node(y))
    if isinstance(c, bool):
        pick = x if c else y
        if _is_scalar(pick) and n in ("b1", "i*", "f*"):
            return {"b1": bool, "i*": int, "f*": float}[n](pick)
        return _wrap(_to_node(pick, n, _device_of(x, y)), n)
    dev = c.device
    return _wrap(torch.where(c, _to_node(x, n, dev), _to_node(y, n, dev)), n)


def _np_to_torch_dtype(dt: Any) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dt))).dtype


def _cast(v: Any, tp: pa.DataType, device: torch.device) -> torch.Tensor:
    """``jnp.asarray(v).astype(tp)``: a float cast to an integer saturates,
    NaN as 0, as XLA converts; an integer cast to an unsigned type wraps."""
    n = _U_OF_ARROW.get(str(tp))
    if n is not None:
        return _cast_unsigned(v, n, device)
    dtype = _np_to_torch_dtype(np.dtype(pa_type_to_np_dtype(tp)))
    if isinstance(v, _Uns):
        return _tensor(v, dtype, device)
    v = _strong(v)
    if not isinstance(v, torch.Tensor):
        v = _tensor(v, _DTYPE[_node(v)], device)
    if v.is_floating_point() and not (dtype.is_floating_point or dtype == torch.bool):
        info = torch.iinfo(dtype)
        top = float(info.max) + 1.0  # 2**bits, exact in float64
        out = v.to(dtype)
        out = torch.where(v >= top, info.max, out)
        out = torch.where(v < float(info.min), info.min, out)
        return torch.where(torch.isnan(v), 0, out).to(dtype)
    return v.to(dtype)


def _cast_unsigned(v: Any, n: str, device: torch.device) -> _Uns:
    """A cast to unsigned node ``n``: a float saturates to ``[0, max]``,
    NaN as 0; an integer wraps."""
    if isinstance(v, _Uns) or _node(v) not in ("f*", "f16", "bf16", "f32", "f64"):
        return _Uns(_to_node(v, n, device), n)
    f = _tensor(v, torch.float64, device)
    f = torch.where(torch.isnan(f), 0.0, f).clamp(min=0.0)
    if n != "u64":
        return _Uns(f.clamp(max=float(_U_MASK[n])).to(_U_STORE[n]), n)
    top = 9223372036854775808.0  # 2**63
    big = f >= top
    bits = torch.where(big, f - top, f).clamp(max=top - 1024).to(torch.int64)
    bits = torch.where(big, bits ^ _FLIP, bits)
    return _Uns(torch.where(f >= 2 * top, -1, bits), n)


def evaluate_torch(cols: Dict[str, Any], expr: ColumnExpr) -> Any:
    """Evaluate a non-aggregate expression over the tensors ``cols`` (see
    :func:`typed_columns`): a tensor, a Python scalar where the expression
    is one, or an unsigned result for :func:`to_column`."""
    v = _eval_node(cols, expr, _device_of(*cols.values()))
    return v if isinstance(v, _Uns) else _strong(v)


def _eval_node(cols: Dict[str, torch.Tensor], expr: ColumnExpr, dev: torch.device) -> Any:
    res = _eval(cols, expr, dev)
    if expr.as_type is not None:
        res = _cast(res, expr.as_type, dev)
    return res


def _eval(cols: Dict[str, torch.Tensor], expr: ColumnExpr, dev: torch.device) -> Any:
    if isinstance(expr, _NamedColumnExpr):
        if expr.name not in cols:
            raise FugueInvalidOperation(f"column {expr.name} is not on device")
        return cols[expr.name]
    if isinstance(expr, _LitColumnExpr):
        return expr.value
    if isinstance(expr, _UnaryOpExpr):
        v = _eval_node(cols, expr.col, dev)
        if expr.op == "IS_NULL":
            return _isnan(v)
        if expr.op == "NOT_NULL":
            return _logical_not(_isnan(v))
        if expr.op == "~":
            return _logical_not(v)
        if expr.op == "-":
            return _neg(v)
        raise NotImplementedError(expr.op)
    if isinstance(expr, _BinaryOpExpr):
        l = _eval_node(cols, expr.left, dev)
        r = _eval_node(cols, expr.right, dev)
        if expr.op in ("&", "|"):
            return _logical(expr.op, l, r)
        if expr.op in _ARITH or expr.op in _CMP:
            return _binary(expr.op, l, r)
        raise NotImplementedError(expr.op)
    if isinstance(expr, _CaseWhenExpr):
        # a reversed where chain: the FIRST matching case wins
        res = _eval_node(cols, expr.default, dev)
        for c, v in reversed(expr.cases):
            res = _where(_eval_node(cols, c, dev), _eval_node(cols, v, dev), res)
        return res
    if isinstance(expr, _FuncExpr) and not expr.is_agg:
        if expr.func.upper() == "COALESCE":
            args = [_eval_node(cols, a, dev) for a in expr.args]
            res = args[0]
            for a in args[1:]:
                res = _where(_isnan(res), a, res)
            return res
        raise NotImplementedError(f"function {expr.func} not supported on device")
    raise NotImplementedError(f"can't evaluate {type(expr)} on device")


# ---------------------------------------------------------------------------
# three-valued (SQL NULL) evaluation over encoded device frames
# ---------------------------------------------------------------------------


def _or(a: Any, b: Any) -> Any:
    if isinstance(a, bool):
        a, b = b, a
    if isinstance(b, bool):
        return True if b else a
    return a | b


def _and(a: Any, b: Any) -> Any:
    if isinstance(a, bool):
        a, b = b, a
    if isinstance(b, bool):
        return a if b else False
    return a & b


def _not(a: Any) -> Any:
    return (not a) if isinstance(a, bool) else torch.logical_not(a)


def _contains_null_ops(expr: ColumnExpr) -> bool:
    """Whether the subtree consumes NULL flags (IS_NULL/NOT_NULL/COALESCE) —
    such subtrees must NOT evaluate over the dictionary (which has no
    nulls); the three-valued evaluator handles them with code<0."""
    if isinstance(expr, _UnaryOpExpr) and expr.op in ("IS_NULL", "NOT_NULL"):
        return True
    if isinstance(expr, _FuncExpr) and expr.func.upper() == "COALESCE":
        return True
    return any(_contains_null_ops(c) for c in expr.children)


def _dict_subtree_col(expr: ColumnExpr, encodings: Dict[str, dict]) -> Optional[str]:
    """If the subtree references exactly ONE dict-encoded column (and any
    literals) and consumes no NULL flags, return its name — the whole
    subtree can evaluate over the dictionary on host. None otherwise."""
    names: set = set()

    def walk(e: ColumnExpr) -> bool:
        if isinstance(e, _NamedColumnExpr):
            if e.wildcard:
                return False
            names.add(e.name)
            return True
        if isinstance(e, _LitColumnExpr):
            return True
        return all(walk(c) for c in e.children)

    if not walk(expr) or _contains_null_ops(expr):
        return None
    if len(names) == 1:
        n = next(iter(names))
        if n in encodings and encodings[n]["kind"] == "dict":
            return n
    return None


def _eval_over_dictionary(expr: ColumnExpr, name: str, dictionary: Any) -> Any:
    """Evaluate the subtree on the host over the dictionary values → a
    numpy table of len(dictionary) results."""
    import pandas as pd

    from .eval import evaluate as eval_pd

    pdf = pd.DataFrame({name: dictionary.to_pandas()})
    res = eval_pd(pdf, expr)
    if not isinstance(res, pd.Series):
        res = pd.Series([res] * len(pdf))
    return np.asarray(res.to_numpy())


def evaluate_torch_3v(
    cols: Dict[str, torch.Tensor],
    masks: Dict[str, torch.Tensor],
    dict_tables: Dict[str, Any],
    expr: ColumnExpr,
    code_cols: Any = frozenset(),
) -> Tuple[Any, Any]:
    """Evaluate with SQL NULL semantics → ``(value, isnull)``.

    ``dict_tables`` maps a dict subtree's uuid to ``(column name, lookup
    table)`` as :func:`plan_dict_lookups` plans them, the table as a tensor
    on the columns' device. ``code_cols`` are dictionary-encoded column
    names whose raw value is the int32 code (NULL = −1): the planner only
    lets them appear where just the null flag is consumed."""
    dev = _device_of(*cols.values())

    def ev(e: ColumnExpr) -> Tuple[Any, Any]:
        # casts apply at EVERY node: `CAST(x AS int) > 0` compares the cast value
        v, nl = _ev3(e)
        if e.as_type is not None:
            v = _cast(v, e.as_type, dev)
        return v, nl

    def _ev3(e: ColumnExpr) -> Tuple[Any, Any]:
        key = e.__uuid__()
        if key in dict_tables:
            name, table = dict_tables[key]
            code = cols[name]
            if table.shape[0] == 0:
                return torch.zeros_like(code, dtype=table.dtype), code < 0
            return table[code.clamp(0, table.shape[0] - 1).long()], code < 0
        if isinstance(e, _NamedColumnExpr):
            v = cols[e.name]
            if e.name in code_cols:
                return v, v < 0  # only the null flag is meaningful
            if e.name in masks:
                return v, masks[e.name]
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                return v, torch.isnan(v)
            return v, False
        if isinstance(e, _LitColumnExpr):
            return e.value, False
        if isinstance(e, _UnaryOpExpr):
            v, nl = ev(e.col)
            if e.op == "IS_NULL":
                return nl, False
            if e.op == "NOT_NULL":
                return _not(nl), False
            if e.op == "~":
                return _logical_not(v), nl
            if e.op == "-":
                return _neg(v), nl
            raise NotImplementedError(e.op)
        if isinstance(e, _BinaryOpExpr):
            lv, ln = ev(e.left)
            rv, rn = ev(e.right)
            op = e.op
            if op in ("&", "|"):
                lb, rb = _truth(lv), _truth(rv)
                if op == "&":
                    # Kleene AND: FALSE dominates NULL
                    val = _logical("&", lb, rb)
                    known = _or(_and(_not(ln), _not(lb)), _and(_not(rn), _not(rb)))
                else:
                    # Kleene OR: TRUE dominates NULL
                    val = _logical("|", lb, rb)
                    known = _or(_and(_not(ln), lb), _and(_not(rn), rb))
                return val, _and(_or(ln, rn), _not(known))
            if op in _ARITH or op in _CMP:
                return _binary(op, lv, rv), _or(ln, rn)
            raise NotImplementedError(op)
        if isinstance(e, _FuncExpr) and not e.is_agg:
            if e.func.upper() == "COALESCE":
                parts = [ev(a) for a in e.args]
                val, nul = parts[-1]
                for pv, pn in reversed(parts[:-1]):
                    val = _where(pn, val, pv)
                    nul = _and(pn, nul)
                return val, nul
            raise NotImplementedError(f"function {e.func} not supported on device")
        if isinstance(e, _CaseWhenExpr):
            # first matching case wins; a NULL condition falls through
            val, nul = ev(e.default)
            for c, v in reversed(e.cases):
                cv, cn = ev(c)
                vv, vn = ev(v)
                take = _and(_truth(cv), _not(cn))
                val = _where(take, vv, val)
                nul = _where(take, vn, nul)
            return val, nul
        raise NotImplementedError(f"can't evaluate {type(e)} on device")

    v, nl = ev(expr)
    # the two closures reference each other (and ``cols``): clear the cells,
    # or the columns live until the cyclic GC runs (a stream held a chunk
    # more a chunk on the device until it did)
    ev = _ev3 = None  # type: ignore[assignment]  # noqa: F841
    return _strong(v), nl


def plan_dict_lookups(
    expr: ColumnExpr, encodings: Dict[str, dict]
) -> Optional[Dict[str, Any]]:
    """Find maximal dict-column subtrees and precompute their host lookup
    tables. Returns {subtree_uuid: (col_name, np table)} or None when the
    expression cannot run on device (a dict column used outside a
    host-evaluable subtree)."""
    tables: Dict[str, Any] = {}

    def plan(e: ColumnExpr, under_null: bool = False) -> bool:
        name = _dict_subtree_col(e, encodings)
        if name is not None and not isinstance(e, _NamedColumnExpr):
            try:
                table = _eval_over_dictionary(e, name, encodings[name]["dictionary"])
            except Exception:
                return False
            if table.dtype == object:
                return False  # string-valued result has no device type
            tables[e.__uuid__()] = (name, table)
            return True
        if isinstance(e, _NamedColumnExpr):
            # a bare dict column produces no device VALUE — it is only
            # allowed where just its null flag is consumed
            if e.name in encodings and encodings[e.name]["kind"] == "dict":
                return under_null
            return True
        if isinstance(e, _LitColumnExpr):
            return True
        if isinstance(e, _UnaryOpExpr) and e.op in ("IS_NULL", "NOT_NULL"):
            return plan(e.col, under_null=True)
        return all(plan(c) for c in e.children)

    return tables if plan(expr) else None


def _epoch_of(value: Any, tp: Any) -> Optional[int]:
    """Convert a datetime-like literal to the epoch int of the column's
    arrow storage (timestamp unit / date32 days). None = not convertible."""
    import pandas as pd

    try:
        ts = pd.Timestamp(value)
    except Exception:
        return None
    if pa.types.is_date32(tp):
        return (ts - pd.Timestamp("1970-01-01")).days
    if pa.types.is_timestamp(tp):
        ns = ts.value  # nanoseconds since epoch
        div = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}[tp.unit]
        return ns // div
    return None


def _rewrite_datetime_literals(
    expr: ColumnExpr, encodings: Dict[str, dict]
) -> Any:
    """Rewrite comparisons between epoch-encoded datetime columns and
    datetime-like literals into integer comparisons. Returns
    (rewritten_expr, names of datetime columns now usable as plain ints),
    or (expr, empty set) when nothing applies."""
    import datetime as _dt

    allowed: set = set()

    def is_dt_col(e: ColumnExpr) -> bool:
        return (
            isinstance(e, _NamedColumnExpr)
            and encodings.get(e.name, {}).get("kind") == "datetime"
        )

    def rw(e: ColumnExpr) -> ColumnExpr:
        if isinstance(e, _BinaryOpExpr):
            if e.op in ("<", "<=", ">", ">=", "==", "!="):
                l, r = e.left, e.right
                for a, b, flip in ((l, r, False), (r, l, True)):
                    if is_dt_col(a) and isinstance(b, _LitColumnExpr):
                        if not isinstance(b.value, (str, _dt.date, _dt.datetime)):
                            continue
                        epoch = _epoch_of(b.value, encodings[a.name]["type"])
                        if epoch is None:
                            continue
                        allowed.add(a.name)
                        lit_e = _LitColumnExpr(epoch)
                        return (
                            _BinaryOpExpr(e.op, lit_e, a)
                            if flip
                            else _BinaryOpExpr(e.op, a, lit_e)
                        )
            return _BinaryOpExpr(e.op, rw(e.left), rw(e.right))
        if isinstance(e, _UnaryOpExpr):
            if e.op in ("IS_NULL", "NOT_NULL") and is_dt_col(e.col):
                allowed.add(e.col.name)
                return e
            return _UnaryOpExpr(e.op, rw(e.col))
        return e

    return rw(expr), allowed


def device_predicate_plan(
    expr: ColumnExpr, device_cols: Any, encodings: Dict[str, dict]
) -> Optional[Tuple[Dict[str, Any], ColumnExpr]]:
    """Gate + plan for three-valued device evaluation of a predicate.

    Returns ``(dict_lookup_tables, rewritten_expr)`` when the expression
    can run on device with :func:`evaluate_torch_3v`, else None. Dict-encoded
    columns are allowed only inside host-reducible subtrees; datetime
    columns are allowed where a literal comparison rewrote to epoch ints
    or under IS_NULL/NOT_NULL.
    """
    from .functions import is_agg

    if is_agg(expr):
        return None
    expr, dt_allowed = _rewrite_datetime_literals(expr, encodings)
    tables = plan_dict_lookups(expr, encodings)
    if tables is None:
        return None

    def ok(e: ColumnExpr, under_null: bool = False) -> bool:
        if e.__uuid__() in tables:
            return True
        if e.as_type is not None and not (
            pa.types.is_integer(e.as_type)
            or pa.types.is_floating(e.as_type)
            or pa.types.is_boolean(e.as_type)
        ):
            return False
        if isinstance(e, _NamedColumnExpr):
            if e.wildcard or e.name not in device_cols:
                return False
            if e.name in encodings:
                kind = encodings[e.name]["kind"]
                if kind == "dict":
                    return under_null  # only the null flag is usable
                if kind == "datetime":
                    # usable where a literal comparison rewrote to epoch
                    # ints, or under IS_NULL/NOT_NULL
                    return under_null or e.name in dt_allowed
                return False
            return True
        if isinstance(e, _LitColumnExpr):
            return e.value is not None and isinstance(e.value, (int, float, bool))
        if isinstance(e, _UnaryOpExpr):
            if e.op in ("IS_NULL", "NOT_NULL"):
                return ok(e.col, under_null=True)
            return e.op in ("~", "-") and ok(e.col)
        if isinstance(e, _BinaryOpExpr):
            return e.op in (
                "+", "-", "*", "/", "<", "<=", ">", ">=", "==", "!=", "&", "|"
            ) and ok(e.left) and ok(e.right)
        if isinstance(e, _FuncExpr):
            return (
                not e.is_agg
                and e.func.upper() == "COALESCE"
                and all(ok(a) for a in e.args)
            )
        if isinstance(e, _CaseWhenExpr):
            # lowered as a where chain in evaluate_torch_3v; every
            # condition/value/default must itself be device-evaluable
            # (a None default fails the literal rule above)
            return all(ok(c) for c in e.children)
        return False

    fits = ok(expr)
    # ``ok`` references itself (and ``device_cols``): clear the cell, or the
    # frame's columns live until the cyclic GC runs
    ok = None  # type: ignore[assignment]  # noqa: F841
    return (tables, expr) if fits else None


def can_evaluate_on_device(
    expr: ColumnExpr, device_cols: Any, check_agg: bool = True
) -> bool:
    """Whether the expression only references device columns and device ops."""
    from .functions import is_agg

    if check_agg and is_agg(expr):
        return False
    if expr.as_type is not None and not (
        pa.types.is_integer(expr.as_type)
        or pa.types.is_floating(expr.as_type)
        or pa.types.is_boolean(expr.as_type)
    ):
        # device tensors can't hold strings/binary/nested → host
        return False
    if isinstance(expr, _NamedColumnExpr):
        return expr.name in device_cols and not expr.wildcard
    if isinstance(expr, _LitColumnExpr):
        # None (null) has no device representation → host
        return expr.value is not None and isinstance(expr.value, (int, float, bool))
    if isinstance(expr, _FuncExpr):
        if expr.is_agg or expr.func.upper() != "COALESCE":
            return False
    elif isinstance(expr, _CaseWhenExpr):
        # lowered as a where chain; a None default/value has no device
        # representation (same rule as bare literals below)
        pass
    elif not isinstance(expr, (_NamedColumnExpr, _LitColumnExpr, _BinaryOpExpr, _UnaryOpExpr)):
        # unknown node types (IN/LIKE/...) have no device lowering
        return False
    return all(
        can_evaluate_on_device(c, device_cols, check_agg=False) for c in expr.children
    )
