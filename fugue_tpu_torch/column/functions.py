"""Aggregate column functions, copied from ``fugue_tpu/column/functions.py``
and trimmed to the aggregates the dense device path computes. The output
types are the JAX package's: SUM of an integer is ``long`` and of a float
``double``, COUNT is ``long``, AVG is ``double``, MIN/MAX keep their
input's type."""

from typing import Any, Optional

import pyarrow as pa

from ..schema import Schema
from .expressions import ColumnExpr, _FuncExpr, _to_col


def min(col: ColumnExpr) -> ColumnExpr:  # noqa: A001
    return _SameTypeUnaryAggFuncExpr("MIN", col)


def max(col: ColumnExpr) -> ColumnExpr:  # noqa: A001
    return _SameTypeUnaryAggFuncExpr("MAX", col)


def count(col: ColumnExpr) -> ColumnExpr:
    return _UnaryAggFuncExpr("COUNT", col)


def avg(col: ColumnExpr) -> ColumnExpr:
    return _UnaryAggFuncExpr("AVG", col)


def mean(col: ColumnExpr) -> ColumnExpr:
    return avg(col)


def sum(col: ColumnExpr) -> ColumnExpr:  # noqa: A001
    return _UnaryAggFuncExpr("SUM", col)


class _UnaryAggFuncExpr(_FuncExpr):
    def __init__(self, func: str, col: Any, arg_distinct: bool = False):
        super().__init__(func, _to_col(col), arg_distinct=arg_distinct, is_agg=True)

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
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
        return self.args[0].infer_type(schema)
