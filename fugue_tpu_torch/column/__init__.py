from . import functions
from .expressions import ColumnExpr, all_cols, col, function, lit, null
from .sql import SelectColumns, SQLExpressionGenerator

__all__ = [
    "ColumnExpr",
    "SelectColumns",
    "SQLExpressionGenerator",
    "all_cols",
    "col",
    "function",
    "functions",
    "lit",
    "null",
]
