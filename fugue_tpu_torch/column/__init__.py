from . import functions
from .expressions import ColumnExpr, col, function, lit

__all__ = ["ColumnExpr", "col", "function", "functions", "lit"]
