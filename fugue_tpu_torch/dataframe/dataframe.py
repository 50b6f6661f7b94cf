"""DataFrame ABC, copied from ``fugue_tpu/dataframe/dataframe.py`` and
trimmed to what the port's frames and its transformers use: a schema, a
row count, metadata, columnar conversions to arrow and pandas, the row
views a list-annotated transformer reads (``as_array``,
``as_array_iterable``, ``as_dicts``, ``as_dict_iterable``, ``peek_array``,
``peek_dict``), and the local frame classes (:179-207).

A frame that is not local (the device's ``TorchDataFrame``) reaches every
row view through ``as_local_bounded``: one copy to the host, whose frame
then answers."""

from abc import ABC, abstractmethod
from typing import Any, Dict, Iterable, List, Optional

import pandas as pd
import pyarrow as pa

from .._utils.arrow import pa_table_to_pandas
from .._utils.params import ParamDict
from ..exceptions import FugueDataFrameEmptyError, FugueInvalidOperation
from ..schema import Schema


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

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.schema})"


class LocalDataFrame(DataFrame):
    """A frame held whole in the host process, or a stream of such frames."""

    @property
    def is_local(self) -> bool:
        return True

    def as_local(self) -> "LocalDataFrame":
        return self


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
