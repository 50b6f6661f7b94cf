"""DataFrames, copied from ``fugue_tpu/dataframe/dataframes.py`` (:9): an
ordered, named collection of frames, read-only once built (``_0``,
``_1``, ... for frames given without names; ``has_key`` when any was
given a name). A processor, an outputter or a cotransformer takes its
inputs in one, and the zip keeps its names."""

from typing import Any, Dict

from .._utils.params import IndexedOrderedDict
from ..exceptions import FugueDataFrameInitError
from .dataframe import DataFrame


class DataFrames(IndexedOrderedDict):
    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__()
        self._has_dict_key = False
        for a in args:
            self._append(a)
        for k, v in kwargs.items():
            self[k] = v
        self.set_readonly()

    def _append(self, obj: Any) -> None:
        if obj is None:
            return
        if isinstance(obj, DataFrame):
            self[f"_{len(self)}"] = obj
        elif isinstance(obj, Dict):
            for k, v in obj.items():
                self[k] = v
        elif isinstance(obj, (list, tuple)):
            for x in obj:
                self._append(x)
        else:
            raise FugueDataFrameInitError(f"can't add {type(obj)} to DataFrames")

    def __setitem__(self, key: str, value: Any) -> None:
        if not isinstance(value, DataFrame):
            raise FugueDataFrameInitError(f"{key} value must be a DataFrame")
        if not key.startswith("_"):
            self._has_dict_key = True
        super().__setitem__(key, value)

    @property
    def has_key(self) -> bool:
        """Whether a frame was given by name (not ``_0``, ``_1``, ...)."""
        return self._has_dict_key

    def __getitem__(self, key: Any) -> DataFrame:  # type: ignore
        if isinstance(key, int):
            return self.get_value_by_index(key)
        return super().__getitem__(key)

    def convert(self, func: Any) -> "DataFrames":
        return DataFrames({k: func(v) for k, v in self.items()})
