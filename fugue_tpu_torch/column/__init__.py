from . import functions
from .expressions import ColumnExpr, all_cols, col, function, lit, null
from .sql import SelectColumns

__all__ = [
    "ColumnExpr",
    "SelectColumns",
    "all_cols",
    "col",
    "function",
    "functions",
    "lit",
    "null",
]
