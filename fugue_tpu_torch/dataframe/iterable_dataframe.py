"""IterableDataFrame, copied from ``fugue_tpu/dataframe/iterable_dataframe.py``
(:16) and trimmed to what the transformers use: a one-pass stream of rows
(the output of an ``Iterable[List[Any]]`` or ``Iterable[Dict[str, Any]]``
transformer), read once."""

from typing import Any, Iterable, List, Optional

from .._utils.iter import EmptyAwareIterable, make_empty_aware
from ..exceptions import FugueDataFrameInitError
from ..schema import Schema
from .array_dataframe import ArrayDataFrame
from .dataframe import DataFrame, LocalBoundedDataFrame, LocalUnboundedDataFrame


class IterableDataFrame(LocalUnboundedDataFrame):
    def __init__(self, df: Any = None, schema: Any = None):
        if schema is None and not isinstance(df, DataFrame):
            raise FugueDataFrameInitError("schema is required")
        if isinstance(df, DataFrame):
            s = schema if schema is not None else df.schema
            s = s if isinstance(s, Schema) else Schema(s)
            it: Iterable[Any] = df.as_array_iterable(columns=s.names if schema is not None else None)
        elif df is None or isinstance(df, Iterable):
            s = schema if isinstance(schema, Schema) else Schema(schema)
            it = [] if df is None else df
        else:
            raise FugueDataFrameInitError(f"can't build IterableDataFrame from {type(df)}")
        self._native: EmptyAwareIterable[List[Any]] = make_empty_aware(it)
        super().__init__(s)

    @property
    def native(self) -> EmptyAwareIterable[List[Any]]:
        return self._native

    @property
    def empty(self) -> bool:
        return self._native.empty

    def peek_array(self) -> List[Any]:
        self.assert_not_empty()
        return list(self._native.peek())

    def as_local_bounded(self) -> LocalBoundedDataFrame:
        return ArrayDataFrame(list(self._native), self.schema)

    def as_arrow(self) -> Any:
        return self.as_local_bounded().as_arrow()

    def as_array(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> List[List[Any]]:
        return self.as_local_bounded().as_array(columns, type_safe=type_safe)

    def as_array_iterable(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> Iterable[List[Any]]:
        if columns is None and not type_safe:
            yield from self._native
        else:
            yield from self.as_array(columns, type_safe=type_safe)
