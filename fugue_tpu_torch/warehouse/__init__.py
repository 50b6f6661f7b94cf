"""The warehouse: the engine's verbs pushed down to sqlite over DB-API,
and the hybrid that runs its maps on the card (``fugue_tpu/warehouse``).
The engine names ``sqlite`` and ``sqlite_torch``, a ``sqlite3.Connection``
as an engine, and the inference from a ``WarehouseDataFrame`` resolve in
``execution/factory.py``; ``CONNECT sqlite`` in ``RunSQLSelect``."""

from .dataframe import WarehouseDataFrame
from .execution_engine import (
    SQLiteExecutionEngine,
    WarehouseExecutionEngine,
    WarehouseMapEngine,
    WarehouseSQLEngine,
)
from .hybrid import WarehouseTorchExecutionEngine, WarehouseTorchMapEngine

__all__ = [
    "WarehouseDataFrame",
    "WarehouseExecutionEngine",
    "WarehouseTorchExecutionEngine",
    "WarehouseTorchMapEngine",
    "WarehouseMapEngine",
    "WarehouseSQLEngine",
    "SQLiteExecutionEngine",
]
