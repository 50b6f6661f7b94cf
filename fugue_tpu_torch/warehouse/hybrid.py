"""The warehouse and the card in one engine, the port of
``fugue_tpu/warehouse/hybrid.py`` (engine name ``sqlite_torch``, the JAX
package's ``sqlite_jax``).

- The relational verbs run in the warehouse over DB-API (inherited from
  :class:`SQLiteExecutionEngine`).
- ``map_dataframe`` hands the frame to the torch engine in one arrow
  fetch: a ``Dict[str, torch.Tensor]`` UDF runs compiled on the engine's
  device (``TorchMapEngine``), a pandas UDF through the torch engine's
  host path (``_host`` → pandas → ``_back``), and the result goes back
  into the warehouse in one ingest.

The bridge runs in one ``warehouse.map`` span (the rows it fetched, the
type and device of the torch engine's result), around the fetch's, the
torch map's (``engine.transform``) and the ingest's spans.

A FugueSQL pipeline of SELECT, then TRANSFORM, then SELECT runs on this
one engine: the SQL in sqlite, the maps on the card. No map moves to the
CPU in the card's place: with no card and no ``device`` the engine
raises, as ``TorchExecutionEngine`` does.
"""

from typing import Any, Callable, Optional

from ..collections.partition import PartitionCursor, PartitionSpec
from ..dataframe import ArrowDataFrame, DataFrame, LocalDataFrame
from ..execution.execution_engine import ExecutionEngine, MapEngine
from ..obs import get_tracer
from .execution_engine import SQLiteExecutionEngine


class WarehouseTorchMapEngine(MapEngine):
    """The map facet that bridges warehouse tables onto the torch engine."""

    @property
    def is_distributed(self) -> bool:
        return True

    @property
    def map_handles_repartition(self) -> bool:
        # the torch map engine groups the frame itself
        return True

    def map_dataframe(
        self,
        df: DataFrame,
        map_func: Callable[[PartitionCursor, LocalDataFrame], LocalDataFrame],
        output_schema: Any,
        partition_spec: PartitionSpec,
        on_init: Optional[Callable[[int, DataFrame], Any]] = None,
        map_func_format_hint: Optional[str] = None,
    ) -> DataFrame:
        eng: "WarehouseTorchExecutionEngine" = self.execution_engine  # type: ignore
        wdf = eng.to_df(df)
        with get_tracer().span("warehouse.map", cat="warehouse", annotate=True) as sp:
            # one warehouse → arrow fetch; the torch engine moves it to its device
            arrow = ArrowDataFrame(eng.fetch_arrow(wdf.table, wdf.schema))
            res = eng.torch_engine.map_engine.map_dataframe(
                arrow,
                map_func=map_func,
                output_schema=output_schema,
                partition_spec=partition_spec,
                on_init=on_init,
                map_func_format_hint=map_func_format_hint,
            )
            sp.set(rows=arrow.native.num_rows, frame=type(res).__name__,
                   device=str(getattr(res, "device", None)))
            # one device → arrow copy back into the warehouse
            return eng.ingest(res)


class WarehouseTorchExecutionEngine(SQLiteExecutionEngine):
    """SQL in the warehouse, maps on ``device`` (``cuda:0`` unless given;
    with no card, pass ``device="cpu"``). ``conf["fugue.sqlite.path"]``
    selects the database file, as for the plain sqlite engine."""

    def __init__(self, conf: Any = None, connection: Any = None, device: Any = None):
        from ..torch.execution_engine import TorchExecutionEngine

        # the device engine first: with no card it raises before a
        # connection is opened
        self._torch_engine = TorchExecutionEngine(device=device, conf=conf)
        super().__init__(conf, connection=connection)

    @property
    def torch_engine(self) -> ExecutionEngine:
        """The device side, which runs the maps."""
        return self._torch_engine

    @property
    def device(self) -> Any:
        """The torch engine's device."""
        return self._torch_engine.device

    @property
    def is_distributed(self) -> bool:
        return True

    def create_default_map_engine(self) -> MapEngine:
        return WarehouseTorchMapEngine(self)

    def get_current_parallelism(self) -> int:
        return self._torch_engine.get_current_parallelism()

    def stop_engine(self) -> None:
        self._torch_engine.stop()
        super().stop_engine()
