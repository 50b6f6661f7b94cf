"""DataFrame ABC, copied from ``fugue_tpu/dataframe/dataframe.py`` and
trimmed to what the port's frames implement: a schema, a row count, and
columnar conversions to arrow and pandas; with the local frame classes
(:179-207) the streaming paths build on."""

from abc import ABC, abstractmethod
from typing import Any

import pandas as pd
import pyarrow as pa

from .._utils.arrow import pa_table_to_pandas
from ..exceptions import FugueInvalidOperation
from ..schema import Schema


class DataFrame(ABC):
    """Abstract schema-carrying dataframe."""

    def __init__(self, schema: Any):
        s = schema if isinstance(schema, Schema) else Schema(schema)
        s.assert_not_empty().set_readonly()
        self._schema = s

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def empty(self) -> bool:
        return self.count() == 0

    @abstractmethod
    def count(self) -> int:
        """The number of rows."""
        raise NotImplementedError

    @abstractmethod
    def as_arrow(self) -> pa.Table:
        raise NotImplementedError

    def as_pandas(self) -> pd.DataFrame:
        return pa_table_to_pandas(self.as_arrow())


class LocalDataFrame(DataFrame):
    """A frame held whole in the host process, or a stream of such frames."""


class LocalBoundedDataFrame(LocalDataFrame):
    """A local frame of known length."""

    def as_local_bounded(self) -> "LocalBoundedDataFrame":
        return self


class LocalUnboundedDataFrame(LocalDataFrame):
    """A local frame whose length is known only once it is read."""

    def count(self) -> int:
        raise FugueInvalidOperation("can't count an unbounded dataframe")
