"""ExecutionEngine and MapEngine ABCs, trimmed from
``fugue_tpu/execution/execution_engine.py`` to the verbs the port has:
``to_df``, ``persist``, ``aggregate``, ``join``, ``union`` and the map
behind ``transform``."""

from abc import ABC, abstractmethod
from typing import Any, Callable, List, Optional

from ..collections.partition import PartitionSpec
from ..column.expressions import ColumnExpr
from ..dataframe import DataFrame


class MapEngine(ABC):
    """Runs a transformer over the partitions of a frame. The port's map
    takes the transformer itself (no function-wrapper runner, no
    ``on_init``, no format hint): only device-compiled functions run."""

    def __init__(self, execution_engine: "ExecutionEngine"):
        self._execution_engine = execution_engine

    @property
    def execution_engine(self) -> "ExecutionEngine":
        return self._execution_engine

    @abstractmethod
    def map_dataframe(
        self,
        df: DataFrame,
        map_func: Callable,
        output_schema: Any,
        partition_spec: PartitionSpec,
    ) -> DataFrame:
        """Apply ``map_func`` to ``df`` grouped by ``partition_spec``; the
        result has ``output_schema``."""
        raise NotImplementedError


class ExecutionEngine(ABC):
    """The contract every engine of the port implements."""

    @property
    @abstractmethod
    def map_engine(self) -> MapEngine:
        """The engine's map, behind ``transform``."""
        raise NotImplementedError

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

    @abstractmethod
    def join(
        self,
        df1: DataFrame,
        df2: DataFrame,
        how: str,
        on: Optional[List[str]] = None,
    ) -> DataFrame:
        """Join ``df1`` with ``df2`` (``how``: inner, left_outer,
        right_outer, full_outer, left_semi, left_anti or cross, or an alias)
        on the keys ``on`` (default: the columns they share)."""
        raise NotImplementedError

    @abstractmethod
    def union(self, df1: DataFrame, df2: DataFrame, distinct: bool = True) -> DataFrame:
        """The rows of ``df1`` and of ``df2``; without repeats if
        ``distinct``."""
        raise NotImplementedError
