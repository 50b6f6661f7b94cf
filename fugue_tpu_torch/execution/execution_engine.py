"""ExecutionEngine ABC, trimmed from ``fugue_tpu/execution/execution_engine.py``
to the verbs the port has: ``to_df``, ``persist`` and ``aggregate``."""

from abc import ABC, abstractmethod
from typing import Any, List, Optional

from ..collections.partition import PartitionSpec
from ..column.expressions import ColumnExpr
from ..dataframe import DataFrame


class ExecutionEngine(ABC):
    """The contract every engine of the port implements."""

    @abstractmethod
    def to_df(self, df: Any, schema: Any = None) -> DataFrame:
        """Convert a pandas frame, an arrow table or a frame of this engine
        to this engine's frame."""
        raise NotImplementedError

    @abstractmethod
    def persist(self, df: DataFrame, lazy: bool = False, **kwargs: Any) -> DataFrame:
        """Materialize ``df`` in the engine's memory; unless ``lazy``,
        return only when it is there."""
        raise NotImplementedError

    @abstractmethod
    def aggregate(
        self,
        df: DataFrame,
        partition_spec: Optional[PartitionSpec],
        agg_cols: List[ColumnExpr],
    ) -> DataFrame:
        """Group ``df`` by the spec's keys and compute ``agg_cols``."""
        raise NotImplementedError
