"""ArrayDataFrame, copied from ``fugue_tpu/dataframe/array_dataframe.py``
(:14): a local frame over a list of rows with no type enforcement; its
``type_safe`` views go through arrow."""

from typing import Any, Iterable, List, Optional

from ..exceptions import FugueDataFrameInitError
from ..schema import Schema
from .dataframe import DataFrame, LocalBoundedDataFrame


class ArrayDataFrame(LocalBoundedDataFrame):
    def __init__(self, df: Any = None, schema: Any = None):
        if df is None:
            if schema is None:
                raise FugueDataFrameInitError("schema is required")
            data: List[List[Any]] = []
            s = schema if isinstance(schema, Schema) else Schema(schema)
        elif isinstance(df, DataFrame):
            s = schema if schema is not None else df.schema
            s = s if isinstance(s, Schema) else Schema(s)
            data = df.as_array(columns=s.names if schema is not None else None)
        elif isinstance(df, Iterable):
            if schema is None:
                raise FugueDataFrameInitError("schema is required")
            s = schema if isinstance(schema, Schema) else Schema(schema)
            data = [list(row) for row in df]
        else:
            raise FugueDataFrameInitError(f"can't build ArrayDataFrame from {type(df)}")
        self._data = data
        super().__init__(s)

    @property
    def native(self) -> List[List[Any]]:
        return self._data

    @property
    def empty(self) -> bool:
        return len(self._data) == 0

    def count(self) -> int:
        return len(self._data)

    def peek_array(self) -> List[Any]:
        self.assert_not_empty()
        return list(self._data[0])

    def as_arrow(self) -> Any:
        from .arrow_dataframe import build_arrow_table

        return build_arrow_table(self._data, self.schema)

    def as_array(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> List[List[Any]]:
        if type_safe:
            from .arrow_dataframe import ArrowDataFrame

            return ArrowDataFrame(self.as_arrow()).as_array(columns)
        if columns is None:
            return self._data
        idx = [self.schema.index_of_key(c) for c in columns]
        return [[row[i] for i in idx] for row in self._data]
