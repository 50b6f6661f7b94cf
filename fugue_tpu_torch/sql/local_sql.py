"""The in-tree SQL engine facet, copied from ``fugue_tpu/sql/local_sql.py``
(:24-74): a statement parses to a logical plan (``parser.py``) and runs
through the PARENT engine's verbs (``executor.py``), so the same SQL runs
on the card under ``TorchExecutionEngine`` and on the host under
``NativeExecutionEngine``.

Tables (the ``storage_type="table"`` checkpoints and ``yield_table_as``)
are parquet files in a directory under the workflow's checkpoint path."""

import os
import tempfile
from typing import Any, Optional

from torch.profiler import record_function

from ..collections.sql import StructuredRawSQL
from ..constants import FUGUE_CONF_WORKFLOW_CHECKPOINT_PATH
from ..dataframe import DataFrame, DataFrames
from ..execution.execution_engine import SQLEngine
from .executor import SQLExecutor
from .parser import SQLParser


class LocalSQLEngine(SQLEngine):
    """Dialect: the Spark-like subset ``parser.py`` reads."""

    @property
    def dialect(self) -> Optional[str]:
        return "spark"

    def select(self, dfs: DataFrames, statement: StructuredRawSQL) -> DataFrame:
        """Parse ``statement`` and run it over ``dfs``; the whole of it
        (parse, plan and the verbs) under the span ``fugue::sql_select``."""
        with record_function("fugue::sql_select"):
            sql = statement.construct(dialect=self.dialect, log=self.log)
            plan = SQLParser(sql).parse_full()
            return SQLExecutor(self.execution_engine, dict(dfs)).run(plan)

    # -- table storage ------------------------------------------------------
    def _table_dir(self) -> str:
        base = self.conf.get(FUGUE_CONF_WORKFLOW_CHECKPOINT_PATH, "")
        if base == "":
            base = os.path.join(tempfile.gettempdir(), "fugue_tpu_torch_tables")
        path = os.path.join(base, "_tables")
        os.makedirs(path, exist_ok=True)
        return path

    def _table_path(self, table: str) -> str:
        return os.path.join(self._table_dir(), table + ".parquet")

    def table_exists(self, table: str) -> bool:
        return os.path.exists(self._table_path(table))

    def save_table(
        self, df: DataFrame, table: str, mode: str = "overwrite", partition_spec: Any = None,
        **kwargs: Any,
    ) -> None:
        self.execution_engine.save_df(
            df, self._table_path(table), format_hint="parquet", mode=mode, **kwargs
        )

    def load_table(self, table: str, **kwargs: Any) -> DataFrame:
        return self.execution_engine.load_df(self._table_path(table), format_hint="parquet")
