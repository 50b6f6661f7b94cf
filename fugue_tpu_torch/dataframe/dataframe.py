"""DataFrame ABC, copied from ``fugue_tpu/dataframe/dataframe.py`` and
trimmed to what the port's frames and its transformers use: a schema, a
row count, metadata, columnar conversions to arrow and pandas, the row
views a list-annotated transformer reads (``as_array``,
``as_array_iterable``, ``as_dicts``, ``as_dict_iterable``, ``peek_array``,
``peek_dict``), the column verbs of the workflow (``rename``,
``alter_columns``, ``drop``, ``df[cols]``), ``head``, ``show`` and
``_repr_html_`` through the display chain (``DataFrameDisplay``, the
text table; ``dataset/dataset.py``), the local frame classes (:179-207)
and ``YieldedDataFrame`` (:209).

The column verbs' generic forms go through arrow and return an
``ArrowDataFrame``; a frame that can do better (pandas, the device's
``TorchDataFrame``) overrides them.

A frame that is not local (the device's ``TorchDataFrame``) reaches every
row view through ``as_local_bounded``: one copy to the host, whose frame
then answers."""

from abc import ABC, abstractmethod
from typing import Any, Dict, Iterable, List, Optional

import pandas as pd
import pyarrow as pa

from .._utils.arrow import pa_table_to_pandas
from .._utils.params import ParamDict
from .._utils.assertion import assert_or_throw
from ..collections.yielded import Yielded
from ..dataset.dataset import DatasetDisplay, get_dataset_display, register_dataset_display
from ..exceptions import (
    FugueDataFrameEmptyError,
    FugueDataFrameOperationError,
    FugueInvalidOperation,
)
from ..schema import Schema, type_to_expression


class DataFrame(ABC):
    """Abstract schema-carrying dataframe."""

    def __init__(self, schema: Any):
        s = schema if isinstance(schema, Schema) else Schema(schema)
        s.assert_not_empty().set_readonly()
        self._schema = s
        self._metadata: Optional[ParamDict] = None

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def native(self) -> Any:
        """The object this frame wraps (itself where it wraps none)."""
        return self

    @property
    def metadata(self) -> ParamDict:
        if self._metadata is None:
            self._metadata = ParamDict()
        return self._metadata

    @property
    def has_metadata(self) -> bool:
        return self._metadata is not None and len(self._metadata) > 0

    def reset_metadata(self, metadata: Any) -> None:
        self._metadata = ParamDict(metadata) if metadata is not None else None

    @property
    def is_local(self) -> bool:
        return False

    @property
    def is_bounded(self) -> bool:
        return True

    @property
    def num_partitions(self) -> int:
        """The physical partitions: 1, for a local frame and for a frame
        on one device."""
        return 1

    @property
    def empty(self) -> bool:
        return self.count() == 0

    def assert_not_empty(self) -> None:
        if self.empty:
            raise FugueDataFrameEmptyError("dataframe is empty")

    @abstractmethod
    def count(self) -> int:
        """The number of rows."""
        raise NotImplementedError

    @abstractmethod
    def as_arrow(self) -> pa.Table:
        raise NotImplementedError

    def as_pandas(self) -> pd.DataFrame:
        return pa_table_to_pandas(self.as_arrow())

    @abstractmethod
    def as_local_bounded(self) -> "LocalBoundedDataFrame":
        """This frame's rows as a local frame of known length."""
        raise NotImplementedError

    def as_local(self) -> "LocalDataFrame":
        return self.as_local_bounded()

    def peek_array(self) -> List[Any]:
        """The first row as a list; raises when the frame is empty."""
        return self.as_local_bounded().peek_array()

    def peek_dict(self) -> Dict[str, Any]:
        return dict(zip(self.schema.names, self.peek_array()))

    def as_array(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> List[List[Any]]:
        return self.as_local_bounded().as_array(columns, type_safe=type_safe)

    def as_array_iterable(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> Iterable[List[Any]]:
        return self.as_local_bounded().as_array_iterable(columns, type_safe=type_safe)

    def as_dicts(self, columns: Optional[List[str]] = None) -> List[Dict[str, Any]]:
        names = columns or self.schema.names
        return [dict(zip(names, row)) for row in self.as_array(columns, type_safe=True)]

    def as_dict_iterable(self, columns: Optional[List[str]] = None) -> Iterable[Dict[str, Any]]:
        names = columns or self.schema.names
        for row in self.as_array_iterable(columns, type_safe=True):
            yield dict(zip(names, row))

    # ---- column verbs (``fugue_tpu/dataframe/dataframe.py`` :85-160) ----------
    def drop(self, columns: List[str]) -> "DataFrame":
        """The frame without ``columns`` (each must be there, and one
        column must stay)."""
        assert_or_throw(len(columns) > 0, FugueDataFrameOperationError("columns can't be empty"))
        missing = [c for c in columns if c not in self.schema]
        assert_or_throw(
            len(missing) == 0,
            lambda: FugueDataFrameOperationError(f"columns {missing} not in {self.schema}"),
        )
        assert_or_throw(
            len(columns) < len(self.schema),
            FugueDataFrameOperationError("can't drop all columns"),
        )
        return self._select_cols([n for n in self.schema.names if n not in columns])

    def __getitem__(self, columns: List[Any]) -> "DataFrame":
        """The frame's ``columns``, in that order."""
        assert_or_throw(
            isinstance(columns, list) and len(columns) > 0,
            FugueDataFrameOperationError("columns must be a non-empty list"),
        )
        missing = [c for c in columns if c not in self.schema]
        assert_or_throw(
            len(missing) == 0,
            lambda: FugueDataFrameOperationError(f"columns {missing} not in {self.schema}"),
        )
        return self._select_cols(columns)

    def _select_cols(self, cols: List[str]) -> "DataFrame":
        from .arrow_dataframe import ArrowDataFrame

        return ArrowDataFrame(self.as_arrow().select(cols))

    def rename(self, columns: Dict[str, str]) -> "DataFrame":
        """The frame with its columns renamed by ``columns`` (old → new)."""
        from .arrow_dataframe import ArrowDataFrame

        new_schema = self.schema.rename(columns)
        return ArrowDataFrame(self.as_arrow().rename_columns(new_schema.names))

    def alter_columns(self, columns: Any) -> "DataFrame":
        """The frame with the columns of ``columns`` (schema-like) cast to
        their new types."""
        from .arrow_dataframe import ArrowDataFrame

        new_schema = self.schema.alter(columns)
        if new_schema == self.schema:
            return self
        try:
            return ArrowDataFrame(self.as_arrow().cast(new_schema.pa_schema))
        except pa.ArrowInvalid as e:
            raise FugueDataFrameOperationError(str(e)) from e

    def head(self, n: int, columns: Optional[List[str]] = None) -> "LocalBoundedDataFrame":
        """The first ``n`` rows (of ``columns``) as a local frame."""
        from .arrow_dataframe import ArrowDataFrame

        tbl = self.as_arrow()
        if columns is not None:
            tbl = tbl.select(columns)
        return ArrowDataFrame(tbl.slice(0, n))

    def show(self, n: int = 10, with_count: bool = False, title: Optional[str] = None) -> None:
        """Print the first ``n`` rows as a table under the column names and
        types, through the display chain (``DataFrameDisplay``)."""
        get_dataset_display(self).show(n=n, with_count=with_count, title=title)

    def _repr_html_(self) -> str:
        """The notebooks' rich rendering, through the display chain."""
        return get_dataset_display(self).repr_html()

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.schema})"


class DataFrameDisplay(DatasetDisplay):
    """A frame as text: its first rows under the column names and types
    (``fugue_tpu`` ``DataFrameDisplay``)."""

    @property
    def df(self) -> DataFrame:
        return self._ds

    def show(self, n: int = 10, with_count: bool = False, title: Optional[str] = None) -> None:
        rows = self.df.head(n).as_array(type_safe=True)
        lines: List[str] = [] if title is None else [title]
        headers = [f"{f.name}:{type_to_expression(f.type)}" for f in self.df.schema.fields]
        widths = [
            max(len(h), *(len(_cell(r[i])) for r in rows)) if len(rows) > 0 else len(h)
            for i, h in enumerate(headers)
        ]
        lines.append("|".join(h.ljust(w) for h, w in zip(headers, widths)))
        lines.append("+".join("-" * w for w in widths))
        for r in rows:
            lines.append("|".join(_cell(v).ljust(w) for v, w in zip(r, widths)))
        if with_count:
            lines.append(f"Total count: {self.df.count()}")
        print("\n".join(lines))


@register_dataset_display(lambda ds: isinstance(ds, DataFrame), priority=0.1)
def _default_dataframe_display(ds: DataFrame) -> DataFrameDisplay:
    return DataFrameDisplay(ds)


def _cell(v: Any) -> str:
    if v is None:
        return "NULL"
    s = str(v)
    return s if len(s) <= 40 else s[:37] + "..."


class YieldedDataFrame(Yielded):
    """A frame yielded out of a workflow run (``yield_dataframe_as``)."""

    def __init__(self, yid: str):
        super().__init__(yid)
        self._df: Optional[DataFrame] = None

    @property
    def is_set(self) -> bool:
        return self._df is not None

    def set_value(self, df: DataFrame) -> None:
        self._df = df

    @property
    def result(self) -> DataFrame:
        assert_or_throw(self.is_set, FugueInvalidOperation("value is not set"))
        return self._df  # type: ignore


class LocalDataFrame(DataFrame):
    """A frame held whole in the host process, or a stream of such frames."""

    @property
    def is_local(self) -> bool:
        return True


class LocalBoundedDataFrame(LocalDataFrame):
    """A local frame of known length. Each one implements the row views
    itself."""

    def as_local_bounded(self) -> "LocalBoundedDataFrame":
        return self

    @abstractmethod
    def peek_array(self) -> List[Any]:
        raise NotImplementedError

    @abstractmethod
    def as_array(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> List[List[Any]]:
        raise NotImplementedError

    def as_array_iterable(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> Iterable[List[Any]]:
        yield from self.as_array(columns, type_safe=type_safe)


class LocalUnboundedDataFrame(LocalDataFrame):
    """A local frame whose length is known only once it is read."""

    @property
    def is_bounded(self) -> bool:
        return False

    def count(self) -> int:
        raise FugueInvalidOperation("can't count an unbounded dataframe")
