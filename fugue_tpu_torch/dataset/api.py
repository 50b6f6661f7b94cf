"""The dataset functions, copied from ``fugue_tpu/dataset/api.py`` (:13-43)
with no plugin dispatch: a ``Dataset`` (a bag) is itself, anything else
converts with ``as_fugue_df``, and each function reads the result. The
frame functions are imported at call time: ``dataframe/dataframe.py``
imports this package for its display."""

from typing import Any, Optional

from .dataset import Dataset


def as_fugue_dataset(data: Any, **kwargs: Any) -> Any:
    if isinstance(data, Dataset):
        return data
    from ..dataframe.api import as_fugue_df

    return as_fugue_df(data, **kwargs)


def count(data: Any) -> int:
    return as_fugue_dataset(data).count()


def is_empty(data: Any) -> bool:
    return as_fugue_dataset(data).empty


def is_local(data: Any) -> bool:
    return as_fugue_dataset(data).is_local


def is_bounded(data: Any) -> bool:
    return as_fugue_dataset(data).is_bounded


def get_num_partitions(data: Any) -> int:
    """1 for a local frame and for a frame on one device."""
    return as_fugue_dataset(data).num_partitions


def show(data: Any, n: int = 10, with_count: bool = False, title: Optional[str] = None) -> None:
    as_fugue_dataset(data).show(n=n, with_count=with_count, title=title)
