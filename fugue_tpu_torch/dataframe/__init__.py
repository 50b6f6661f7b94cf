from .arrow_dataframe import ArrowDataFrame
from .dataframe import DataFrame, LocalBoundedDataFrame, LocalDataFrame, LocalUnboundedDataFrame
from .dataframe_iterable_dataframe import LocalDataFrameIterableDataFrame
from .pandas_dataframe import PandasDataFrame

__all__ = [
    "ArrowDataFrame",
    "DataFrame",
    "LocalBoundedDataFrame",
    "LocalDataFrame",
    "LocalDataFrameIterableDataFrame",
    "LocalUnboundedDataFrame",
    "PandasDataFrame",
]
