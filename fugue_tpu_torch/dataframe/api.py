"""The frame functions, copied from ``fugue_tpu/dataframe/api.py`` (:34-148)
with no plugin dispatch: they take the port's frames (a ``TorchDataFrame``
too), pandas frames and arrow tables, and call the frame's own methods.
A function that returns a frame returns the input's kind unless
``as_fugue``: a frame for a frame, else what the result wraps."""

from typing import Any, Dict, Iterable, List, Optional, Tuple

import pandas as pd
import pyarrow as pa

from ..schema import Schema
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


def is_df(df: Any) -> bool:
    """Whether ``df`` is a frame or converts to one."""
    try:
        return isinstance(df, DataFrame) or as_fugue_df(df) is not None
    except NotImplementedError:
        return False


def get_native_as_df(df: Any) -> Any:
    """The object a frame wraps (a pandas frame, an arrow table, a list of
    rows), or ``df`` itself when it is not a frame."""
    return df.native if isinstance(df, DataFrame) else df


def get_schema(df: Any) -> Schema:
    return as_fugue_df(df).schema


def get_column_names(df: Any) -> List[Any]:
    return get_schema(df).names


def rename(df: Any, columns: Dict[str, Any], as_fugue: bool = False) -> Any:
    if len(columns) == 0:
        return as_fugue_df(df) if as_fugue else df
    return _adjust(df, as_fugue_df(df).rename(columns), as_fugue)


def drop_columns(df: Any, columns: List[str], as_fugue: bool = False) -> Any:
    return _adjust(df, as_fugue_df(df).drop(columns), as_fugue)


def select_columns(df: Any, columns: List[Any], as_fugue: bool = False) -> Any:
    return _adjust(df, as_fugue_df(df)[columns], as_fugue)


def alter_columns(df: Any, columns: Any, as_fugue: bool = False) -> Any:
    return _adjust(df, as_fugue_df(df).alter_columns(columns), as_fugue)


def head(df: Any, n: int, columns: Optional[List[str]] = None, as_fugue: bool = False) -> Any:
    return _adjust(df, as_fugue_df(df).head(n, columns=columns), as_fugue)


def peek_array(df: Any) -> List[Any]:
    return as_fugue_df(df).peek_array()


def peek_dict(df: Any) -> Dict[str, Any]:
    return as_fugue_df(df).peek_dict()


def as_array(df: Any, columns: Optional[List[str]] = None, type_safe: bool = False) -> List[List[Any]]:
    return as_fugue_df(df).as_array(columns=columns, type_safe=type_safe)


def as_array_iterable(
    df: Any, columns: Optional[List[str]] = None, type_safe: bool = False
) -> Iterable[List[Any]]:
    return as_fugue_df(df).as_array_iterable(columns=columns, type_safe=type_safe)


def as_dicts(df: Any, columns: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    return as_fugue_df(df).as_dicts(columns=columns)


def as_dict_iterable(df: Any, columns: Optional[List[str]] = None) -> Iterable[Dict[str, Any]]:
    return as_fugue_df(df).as_dict_iterable(columns=columns)


def as_pandas(df: Any) -> pd.DataFrame:
    return as_fugue_df(df).as_pandas()


def as_arrow(df: Any) -> pa.Table:
    return as_fugue_df(df).as_arrow()


def as_local(df: Any, as_fugue: bool = False) -> Any:
    res = as_fugue_df(df).as_local()
    return res if as_fugue else get_native_as_df(res)


def as_local_bounded(df: Any, as_fugue: bool = False) -> Any:
    res = as_fugue_df(df).as_local_bounded()
    return res if as_fugue else get_native_as_df(res)


def normalize_column_names(df: Any) -> Tuple[Any, Dict[str, str]]:
    """``df`` with each column whose name is not an identifier renamed
    ``_<position>``, and the map back to the old names."""
    fdf = as_fugue_df(df)
    rename_map: Dict[str, str] = {}
    inverse: Dict[str, str] = {}
    for i, name in enumerate(fdf.schema.names):
        if not name.isidentifier():
            rename_map[name] = f"_{i}"
            inverse[f"_{i}"] = name
    if len(rename_map) == 0:
        return df, {}
    return fdf.rename(rename_map), inverse


def _adjust(original: Any, result: DataFrame, as_fugue: bool) -> Any:
    if as_fugue or isinstance(original, DataFrame):
        return result
    return get_native_as_df(result)
