"""The dataset functions, copied from ``fugue_tpu/dataset/api.py`` (:13-43)
with no plugin dispatch: the port's frames are its datasets, so each
function converts with ``as_fugue_df`` and reads the frame."""

from typing import Any, Optional

from ..dataframe import DataFrame
from ..dataframe.api import as_fugue_df


def as_fugue_dataset(data: Any, **kwargs: Any) -> DataFrame:
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
