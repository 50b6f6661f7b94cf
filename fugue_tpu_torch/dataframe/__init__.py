from .array_dataframe import ArrayDataFrame
from .arrow_dataframe import ArrowDataFrame
from .dataframe import (
    DataFrame,
    LocalBoundedDataFrame,
    LocalDataFrame,
    LocalUnboundedDataFrame,
    YieldedDataFrame,
)
from .dataframe_iterable_dataframe import (
    IterableArrowDataFrame,
    IterablePandasDataFrame,
    LocalDataFrameIterableDataFrame,
)
from .dataframes import DataFrames
from .iterable_dataframe import IterableDataFrame
from .pandas_dataframe import PandasDataFrame

__all__ = [
    "ArrayDataFrame",
    "ArrowDataFrame",
    "DataFrame",
    "DataFrames",
    "IterableArrowDataFrame",
    "IterableDataFrame",
    "IterablePandasDataFrame",
    "LocalBoundedDataFrame",
    "LocalDataFrame",
    "LocalDataFrameIterableDataFrame",
    "LocalUnboundedDataFrame",
    "PandasDataFrame",
    "YieldedDataFrame",
]
