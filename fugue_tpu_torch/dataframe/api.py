"""Frame conversions, copied from ``fugue_tpu/dataframe/api.py`` and
trimmed to ``as_fugue_df`` and ``get_native_as_df``, with no plugin
dispatch: the port's frames, pandas frames and arrow tables."""

from typing import Any

import pandas as pd
import pyarrow as pa

from .arrow_dataframe import ArrowDataFrame
from .dataframe import DataFrame
from .pandas_dataframe import PandasDataFrame


def as_fugue_df(df: Any, **kwargs: Any) -> DataFrame:
    """``df`` as a frame: a frame as it is, a pandas frame as a
    ``PandasDataFrame`` and an arrow table or record batch as an
    ``ArrowDataFrame`` (``kwargs`` go to their constructors)."""
    if isinstance(df, DataFrame):
        return df
    if isinstance(df, pd.DataFrame):
        return PandasDataFrame(df, **kwargs)
    if isinstance(df, (pa.Table, pa.RecordBatch)):
        return ArrowDataFrame(df, **kwargs)
    raise NotImplementedError(f"can't convert {type(df)} to a fugue DataFrame")


def get_native_as_df(df: Any) -> Any:
    """The object a frame wraps (a pandas frame, an arrow table, a list of
    rows), or ``df`` itself when it is not a frame."""
    return df.native if isinstance(df, DataFrame) else df
