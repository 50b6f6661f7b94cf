"""ArrowDataFrame, copied from ``fugue_tpu/dataframe/arrow_dataframe.py``
(:77) and trimmed to what the streaming paths use: a ``pa.Table``."""

from typing import Any

import pandas as pd
import pyarrow as pa

from .._utils.arrow import pa_table_to_pandas
from ..exceptions import FugueDataFrameInitError
from ..schema import Schema
from .dataframe import LocalBoundedDataFrame


class ArrowDataFrame(LocalBoundedDataFrame):
    """A frame over a ``pa.Table`` (``schema``: cast to it; ``df=None``: an
    empty table of ``schema``)."""

    def __init__(self, df: Any = None, schema: Any = None):
        s = None if schema is None else (schema if isinstance(schema, Schema) else Schema(schema))
        if df is None:
            if s is None:
                raise FugueDataFrameInitError("schema is required")
            tbl = s.create_empty_arrow_table()
        elif isinstance(df, pa.Table):
            tbl = df if s is None or df.schema.equals(s.pa_schema) else df.cast(s.pa_schema)
        else:
            raise FugueDataFrameInitError(f"can't build ArrowDataFrame from {type(df)}")
        self._native = tbl
        super().__init__(Schema(tbl.schema))

    @property
    def native(self) -> pa.Table:
        return self._native

    def count(self) -> int:
        return self._native.num_rows

    def as_arrow(self) -> pa.Table:
        return self._native

    def as_pandas(self) -> pd.DataFrame:
        return pa_table_to_pandas(self._native)
