"""LocalDataFrameIterableDataFrame, copied from
``fugue_tpu/dataframe/dataframe_iterable_dataframe.py`` (:23) and trimmed
to what the streaming paths use: one pass over local frames."""

import itertools
from typing import Any, Iterable, Iterator

import pandas as pd
import pyarrow as pa

from ..exceptions import FugueDataFrameInitError
from ..schema import Schema
from .arrow_dataframe import ArrowDataFrame
from .dataframe import LocalBoundedDataFrame, LocalDataFrame, LocalUnboundedDataFrame
from .pandas_dataframe import PandasDataFrame


class LocalDataFrameIterableDataFrame(LocalUnboundedDataFrame):
    """A one-pass stream of local frames: ``df`` is an iterable of
    ``LocalDataFrame``, ``pd.DataFrame`` or ``pa.Table`` chunks (a pandas
    or arrow chunk is cast to ``schema``). Without ``schema`` the first
    chunk's is taken, and the iterable must not be empty. ``native`` is
    the iterator of chunks; reading it consumes the stream."""

    def __init__(self, df: Any = None, schema: Any = None):
        if df is not None and not isinstance(df, Iterable):
            raise FugueDataFrameInitError(
                f"can't build LocalDataFrameIterableDataFrame from {type(df)}"
            )
        s = None if schema is None else (schema if isinstance(schema, Schema) else Schema(schema))
        it: Iterator[LocalDataFrame] = self._wrap([] if df is None else df, s)
        if s is None:
            first = next(it, None)
            if first is None:
                raise FugueDataFrameInitError("schema is required when the iterable can be empty")
            s = first.schema
            it = itertools.chain([first], it)
        self._native = it
        super().__init__(s)

    @staticmethod
    def _wrap(it: Iterable[Any], schema: Any) -> Iterator[LocalDataFrame]:
        for x in it:
            if isinstance(x, LocalDataFrame):
                yield x
            elif isinstance(x, pd.DataFrame):
                yield PandasDataFrame(x, schema)
            elif isinstance(x, pa.Table):
                yield ArrowDataFrame(x, schema)
            else:
                raise FugueDataFrameInitError(f"invalid chunk type {type(x)}")

    @property
    def native(self) -> Iterator[LocalDataFrame]:
        return self._native

    def as_local_bounded(self) -> LocalBoundedDataFrame:
        """The rest of the stream as one frame (this consumes it)."""
        chunks = [f for f in self._native if f.count() > 0]
        if len(chunks) == 0:
            return ArrowDataFrame(None, self.schema)
        if all(isinstance(f, PandasDataFrame) and f.schema == self.schema for f in chunks):
            return PandasDataFrame(
                pd.concat([f.native for f in chunks], ignore_index=True), self.schema
            )
        target = self.schema.pa_schema
        tables = [f.as_arrow() for f in chunks]
        return ArrowDataFrame(
            pa.concat_tables([t if t.schema.equals(target) else t.cast(target) for t in tables])
        )

    def as_pandas(self) -> pd.DataFrame:
        return self.as_local_bounded().as_pandas()

    def as_arrow(self) -> pa.Table:
        return self.as_local_bounded().as_arrow()
