"""LocalDataFrameIterableDataFrame, copied from
``fugue_tpu/dataframe/dataframe_iterable_dataframe.py`` (:23): a one-pass
stream of local frames, with the pandas and arrow streams of the
transformers' ``Iterable[pd.DataFrame]`` and ``Iterable[pa.Table]``
outputs (:202, :207)."""

import itertools
from typing import Any, Iterable, Iterator, List, Optional

import pandas as pd
import pyarrow as pa

from .._utils.iter import EmptyAwareIterable, make_empty_aware
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
    the chunks, empty-aware; reading it consumes the stream."""

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
        self._native: EmptyAwareIterable[LocalDataFrame] = make_empty_aware(it)
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
    def native(self) -> EmptyAwareIterable[LocalDataFrame]:
        return self._native

    @property
    def empty(self) -> bool:
        # as in the reference, only the head chunk is looked at (one pass)
        return self._native.empty or self._native.peek().empty

    def peek_array(self) -> List[Any]:
        self.assert_not_empty()
        return self._native.peek().peek_array()

    def as_local_bounded(self) -> LocalBoundedDataFrame:
        """The rest of the stream as one frame (this consumes it)."""
        chunks = [f for f in self._native if f.count() > 0]
        if len(chunks) == 0:
            return ArrowDataFrame(None, self.schema)
        if all(isinstance(f, PandasDataFrame) and f.schema == self.schema for f in chunks):
            return PandasDataFrame(
                pd.concat([f.native for f in chunks], ignore_index=True),
                self.schema,
                pandas_df_wrapper=True,
            )
        target = self.schema.pa_schema
        tables = [f.as_arrow() for f in chunks]
        return ArrowDataFrame(
            pa.concat_tables([t if t.schema.equals(target) else t.cast(target) for t in tables])
        )

    def as_array_iterable(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> Iterable[List[Any]]:
        for f in self._native:
            yield from f.as_array_iterable(columns, type_safe=type_safe)

    def as_array(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> List[List[Any]]:
        return list(self.as_array_iterable(columns, type_safe=type_safe))

    def as_pandas(self) -> pd.DataFrame:
        return self.as_local_bounded().as_pandas()

    def as_arrow(self) -> pa.Table:
        return self.as_local_bounded().as_arrow()


class IterablePandasDataFrame(LocalDataFrameIterableDataFrame):
    """A stream of pandas chunks."""


class IterableArrowDataFrame(LocalDataFrameIterableDataFrame):
    """A stream of arrow chunks."""
