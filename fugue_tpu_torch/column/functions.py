"""Built-in column functions, copied from ``fugue_tpu/column/functions.py``:
the aggregates (SUM, COUNT, COUNT DISTINCT, AVG, MIN, MAX, FIRST, LAST),
``coalesce`` and ``is_agg``. The output types are the JAX package's: SUM
of an integer is ``long`` and of a float ``double``, COUNT is ``long``,
AVG is ``double``, MIN/MAX/FIRST/LAST keep their input's type."""

from typing import Any, Optional

import pyarrow as pa

from ..schema import Schema
from .expressions import ColumnExpr, _FuncExpr, _to_col, function


def coalesce(*args: Any) -> ColumnExpr:
    return function("COALESCE", *[_to_col(a) for a in args])


def min(col: ColumnExpr) -> ColumnExpr:  # noqa: A001
    return _SameTypeUnaryAggFuncExpr("MIN", col)


def max(col: ColumnExpr) -> ColumnExpr:  # noqa: A001
    return _SameTypeUnaryAggFuncExpr("MAX", col)


def count(col: ColumnExpr) -> ColumnExpr:
    return _UnaryAggFuncExpr("COUNT", col)


def count_distinct(col: ColumnExpr) -> ColumnExpr:
    return _UnaryAggFuncExpr("COUNT", col, arg_distinct=True)


def avg(col: ColumnExpr) -> ColumnExpr:
    return _UnaryAggFuncExpr("AVG", col)


def mean(col: ColumnExpr) -> ColumnExpr:
    return avg(col)


def sum(col: ColumnExpr) -> ColumnExpr:  # noqa: A001
    return _UnaryAggFuncExpr("SUM", col)


def first(col: ColumnExpr) -> ColumnExpr:
    return _SameTypeUnaryAggFuncExpr("FIRST", col)


def last(col: ColumnExpr) -> ColumnExpr:
    return _SameTypeUnaryAggFuncExpr("LAST", col)


def is_agg(column: Any) -> bool:
    """Whether the expression tree contains an aggregation
    (reference ``fugue/column/functions.py:314``)."""
    if isinstance(column, _FuncExpr):
        if column.is_agg:
            return True
    if isinstance(column, ColumnExpr):
        return any(is_agg(c) for c in column.children)
    return False


class _UnaryAggFuncExpr(_FuncExpr):
    def __init__(self, func: str, col: Any, arg_distinct: bool = False):
        super().__init__(func, _to_col(col), arg_distinct=arg_distinct, is_agg=True)

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self.as_type is not None:
            return self.as_type
        f = self.func.upper()
        if f == "COUNT":
            return pa.int64()
        if f == "AVG":
            return pa.float64()
        if f == "SUM":
            t = self.args[0].infer_type(schema)
            if t is None:
                return None
            if pa.types.is_integer(t):
                return pa.int64()
            if pa.types.is_floating(t):
                return pa.float64()
            return t
        return None


class _SameTypeUnaryAggFuncExpr(_UnaryAggFuncExpr):
    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self.as_type is not None:
            return self.as_type
        return self.args[0].infer_type(schema)
