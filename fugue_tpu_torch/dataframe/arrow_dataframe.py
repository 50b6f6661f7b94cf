"""ArrowDataFrame, copied from ``fugue_tpu/dataframe/arrow_dataframe.py``
(:45): a local frame over a ``pa.Table``, built from a table, a record
batch, a pandas frame, another frame, or rows with a schema."""

from typing import Any, Iterable, List, Optional

import pandas as pd
import pyarrow as pa

from .._utils.arrow import pa_table_to_pandas
from ..exceptions import FugueDataFrameInitError
from ..schema import Schema
from .dataframe import DataFrame, LocalBoundedDataFrame


def build_arrow_table(df: Any, schema: Optional[Schema]) -> pa.Table:
    """A ``pa.Table`` of ``schema`` (None: the data's own) from a table, a
    record batch, a pandas frame or an iterable of rows (``None``: an empty
    table of ``schema``)."""
    if df is None:
        if schema is None:
            raise FugueDataFrameInitError("schema is required")
        return schema.create_empty_arrow_table()
    if isinstance(df, pa.RecordBatch):
        df = pa.Table.from_batches([df])
    if isinstance(df, pa.Table):
        return df if schema is None or df.schema.equals(schema.pa_schema) else df.cast(schema.pa_schema)
    if isinstance(df, pd.DataFrame):
        s = Schema(df) if schema is None else schema
        return pa.Table.from_pandas(df, schema=s.pa_schema, preserve_index=False, safe=False)
    if isinstance(df, Iterable):
        if schema is None:
            raise FugueDataFrameInitError("schema is required")
        rows = [dict(zip(schema.names, row)) for row in df]
        if len(rows) == 0:
            return schema.create_empty_arrow_table()
        try:
            return pa.Table.from_pylist(rows, schema=schema.pa_schema)
        except pa.lib.ArrowTypeError:
            # strings for date and timestamp columns ("2020-01-01"), as the
            # JAX package takes them: built loose, then cast
            arrays = []
            for f in schema.pa_schema:
                vals = [r.get(f.name) for r in rows]
                if pa.types.is_date(f.type) or pa.types.is_timestamp(f.type):
                    arr = pa.array(vals)
                    if pa.types.is_string(arr.type):
                        arr = arr.cast(pa.timestamp("us"))
                    arr = arr.cast(f.type)
                else:
                    arr = pa.array(vals, type=f.type)
                arrays.append(arr)
            return pa.Table.from_arrays(arrays, schema=schema.pa_schema)
    raise FugueDataFrameInitError(f"can't build ArrowDataFrame from {type(df)}")


class ArrowDataFrame(LocalBoundedDataFrame):
    """A frame over a ``pa.Table`` (``schema``: cast to it; ``df=None``: an
    empty table of ``schema``)."""

    def __init__(self, df: Any = None, schema: Any = None):
        s = None if schema is None else (schema if isinstance(schema, Schema) else Schema(schema))
        if isinstance(df, DataFrame):
            df = df.as_arrow()
        tbl = build_arrow_table(df, s)
        self._native = tbl
        super().__init__(Schema(tbl.schema))

    @property
    def native(self) -> pa.Table:
        return self._native

    @property
    def empty(self) -> bool:
        return self._native.num_rows == 0

    def count(self) -> int:
        return self._native.num_rows

    def as_arrow(self) -> pa.Table:
        return self._native

    def as_pandas(self) -> pd.DataFrame:
        return pa_table_to_pandas(self._native)

    def peek_array(self) -> List[Any]:
        self.assert_not_empty()
        return list(self._native.slice(0, 1).to_pylist()[0].values())

    def as_array(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> List[List[Any]]:
        tbl = self._native if columns is None else self._native.select(columns)
        return [list(row.values()) for row in tbl.to_pylist()]

    def as_array_iterable(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> Iterable[List[Any]]:
        tbl = self._native if columns is None else self._native.select(columns)
        for batch in tbl.to_batches():
            for row in batch.to_pylist():
                yield list(row.values())
