"""DataFrame ABC, copied from ``fugue_tpu/dataframe/dataframe.py`` and
trimmed to what the port's frame implements: a schema, a row count, and
columnar conversions to arrow and pandas."""

from abc import ABC, abstractmethod
from typing import Any

import pandas as pd
import pyarrow as pa

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
        return self.as_arrow().to_pandas(use_threads=False)
