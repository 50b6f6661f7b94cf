"""``WarehouseDataFrame``, copied from ``fugue_tpu/warehouse/dataframe.py``:
a frame whose rows live in a SQL warehouse (a DB-API connection; sqlite3
here), fetched only on demand. The frame is a (engine, table, schema)
triple: every column verb is one SQL statement into a new temp table of
the engine's connection, and every row view is one fetch into arrow."""

from typing import Any, Dict, Iterable, List, Optional

import pyarrow as pa

from .._utils.assertion import assert_or_throw
from ..dataframe import ArrowDataFrame, DataFrame, LocalBoundedDataFrame
from ..exceptions import FugueDataFrameEmptyError, FugueDataFrameOperationError
from ..schema import Schema


class WarehouseDataFrame(DataFrame):
    """A lazy frame over a warehouse table."""

    def __init__(self, engine: Any, table: str, schema: Any, snapshot: bool = True):
        self._wh_engine = engine
        self._table = table
        # snapshot=False for frames bound to persistent NAMED tables
        # (load_table): those can be overwritten underneath the frame, so
        # count() must not be memoized for them
        self._snapshot = snapshot
        self._count: Optional[int] = None
        super().__init__(schema if isinstance(schema, Schema) else Schema(schema))

    @property
    def table(self) -> str:
        """The warehouse-side table name holding this frame's rows."""
        return self._table

    @property
    def native(self) -> "WarehouseDataFrame":
        """The frame itself: a lazy pointer into the warehouse; raw access
        is ``.table`` on the engine's connection."""
        return self

    @property
    def is_local(self) -> bool:
        return False

    @property
    def is_bounded(self) -> bool:
        return True

    @property
    def num_partitions(self) -> int:
        return 1

    @property
    def empty(self) -> bool:
        return self.count() == 0

    def count(self) -> int:
        # a temp frame is an immutable snapshot of its table, so its count
        # is read once; a named-table frame (snapshot=False) re-reads it
        if self._count is None or not self._snapshot:
            cur = self._wh_engine.connection.execute(
                f"SELECT COUNT(*) FROM {self._wh_engine.encode_name(self._table)}"
            )
            self._count = int(cur.fetchone()[0])
        return self._count

    def peek_array(self) -> List[Any]:
        arr = self.head(1).as_array()
        assert_or_throw(len(arr) > 0, FugueDataFrameEmptyError("empty dataframe"))
        return arr[0]

    def as_local_bounded(self) -> LocalBoundedDataFrame:
        return ArrowDataFrame(self._wh_engine.fetch_arrow(self._table, self.schema))

    def as_arrow(self) -> pa.Table:
        return self._wh_engine.fetch_arrow(self._table, self.schema)

    def as_array(self, columns: Optional[List[str]] = None, type_safe: bool = False) -> List[Any]:
        return self.as_local_bounded().as_array(columns, type_safe=type_safe)

    def as_array_iterable(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> Iterable[Any]:
        return self.as_local_bounded().as_array_iterable(columns, type_safe=type_safe)

    def _select_cols(self, cols: List[str]) -> DataFrame:
        e = self._wh_engine
        sel = ", ".join(e.encode_name(c) for c in cols)
        tbl = e.materialize(f"SELECT {sel} FROM {e.encode_name(self._table)}")
        return e.temp_frame(tbl, self.schema.extract(cols))

    def rename(self, columns: Dict[str, str]) -> DataFrame:
        try:
            new_schema = self.schema.rename(columns)
        except Exception as e:
            raise FugueDataFrameOperationError(str(e)) from e
        eng = self._wh_engine
        sel = ", ".join(
            f"{eng.encode_name(n)} AS {eng.encode_name(columns.get(n, n))}"
            for n in self.schema.names
        )
        tbl = eng.materialize(f"SELECT {sel} FROM {eng.encode_name(self._table)}")
        return eng.temp_frame(tbl, new_schema)

    def alter_columns(self, columns: Any) -> DataFrame:
        new_schema = Schema(self.schema).alter(columns)
        if new_schema == self.schema:
            return self
        # the casts run through arrow on the host, exactly, and the result
        # goes back into the warehouse so the frame stays there
        local = ArrowDataFrame(self.as_arrow().cast(new_schema.pa_schema))
        return self._wh_engine.ingest(local)

    def head(self, n: int, columns: Optional[List[str]] = None) -> LocalBoundedDataFrame:
        # straight off a cursor: a temp table only to read n rows would
        # hold a copy until the connection closes
        e = self._wh_engine
        cols = columns if columns is not None else self.schema.names
        sel = ", ".join(e.encode_name(c) for c in cols)
        return ArrowDataFrame(
            e.fetch_arrow_query(
                f"SELECT {sel} FROM {e.encode_name(self._table)} LIMIT {int(n)}",
                self.schema.extract(cols),
            )
        )
