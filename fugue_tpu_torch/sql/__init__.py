from .dialect import DialectProfile, register_dialect, transpile
from .executor import SQLExecutor
from .fsql import FugueSQLWorkflow, fill_sql_template, fugue_sql, fugue_sql_flow
from .local_sql import LocalSQLEngine
from .parser import SQLParser

fsql = fugue_sql_flow  # the name the original fugue gives it

__all__ = [
    "DialectProfile",
    "FugueSQLWorkflow",
    "LocalSQLEngine",
    "SQLExecutor",
    "SQLParser",
    "fill_sql_template",
    "fsql",
    "fugue_sql",
    "fugue_sql_flow",
    "register_dialect",
    "transpile",
]
