"""PandasDataFrame, copied from ``fugue_tpu/dataframe/pandas_dataframe.py``
(:77) and trimmed to what the streaming paths use: a ``pd.DataFrame``
coerced to its schema."""

from typing import Any

import numpy as np
import pandas as pd
import pyarrow as pa

from .._utils.arrow import pa_table_to_pandas
from ..exceptions import FugueDataFrameInitError
from ..schema import Schema
from .dataframe import LocalBoundedDataFrame


def _numpy_dtype(tp: pa.DataType) -> Any:
    """The numpy dtype pandas holds a NULL-free column of ``tp`` in, or
    None for the types it holds otherwise (strings, nested, dates)."""
    if pa.types.is_integer(tp) or pa.types.is_floating(tp) or pa.types.is_boolean(tp):
        return np.dtype(tp.to_pandas_dtype())
    return None


def _enforce_type(pdf: pd.DataFrame, schema: Schema) -> pd.DataFrame:
    """``pdf`` coerced to ``schema``: as it is when every column already
    has its numeric dtype (no copy), otherwise through arrow (``safe=False``,
    as the JAX package's arrow path converts)."""
    if list(pdf.columns) == schema.names and all(
        _numpy_dtype(f.type) is not None and pdf[f.name].dtype == _numpy_dtype(f.type)
        for f in schema.fields
    ):
        return pdf
    tbl = pa.Table.from_pandas(
        pdf[schema.names], schema=schema.pa_schema, preserve_index=False, safe=False
    )
    return pa_table_to_pandas(tbl)


class PandasDataFrame(LocalBoundedDataFrame):
    """A frame over a ``pd.DataFrame`` (``schema``: cast to it; None: the
    frame's own; ``df=None``: an empty frame of ``schema``)."""

    def __init__(self, df: Any = None, schema: Any = None):
        s = None if schema is None else (schema if isinstance(schema, Schema) else Schema(schema))
        if df is None:
            if s is None:
                raise FugueDataFrameInitError("schema is required")
            pdf = pa_table_to_pandas(s.create_empty_arrow_table())
        elif isinstance(df, pd.DataFrame):
            idx = df.index
            clean = isinstance(idx, pd.RangeIndex) and idx.start == 0 and idx.step == 1
            pdf = df if clean else df.reset_index(drop=True)
            if s is None:
                s = Schema(pdf)
            missing = [c for c in s.names if c not in pdf.columns]
            if len(missing) > 0:
                raise FugueDataFrameInitError(
                    f"columns {missing} in schema {s} not in data {list(pdf.columns)}"
                )
            pdf = _enforce_type(pdf, s)
        else:
            raise FugueDataFrameInitError(f"can't build PandasDataFrame from {type(df)}")
        self._native = pdf
        super().__init__(s)

    @property
    def native(self) -> pd.DataFrame:
        return self._native

    def count(self) -> int:
        return len(self._native)

    def as_pandas(self) -> pd.DataFrame:
        return self._native

    def as_arrow(self) -> pa.Table:
        return pa.Table.from_pandas(
            self._native, schema=self.schema.pa_schema, preserve_index=False, safe=False
        )
