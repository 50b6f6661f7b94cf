"""``ArrayBag``, copied from ``fugue_tpu/bag/array_bag.py``: a local bag
over a Python list."""

from typing import Any, Iterable, List

from ..exceptions import FugueDatasetEmptyError
from .bag import LocalBoundedBag


class ArrayBag(LocalBoundedBag):
    def __init__(self, data: Any, copy: bool = True):
        if isinstance(data, ArrayBag):
            self._data: List[Any] = list(data.native) if copy else data.native
        elif isinstance(data, list):
            self._data = list(data) if copy else data
        elif isinstance(data, Iterable):
            self._data = list(data)
        else:
            raise ValueError(f"can't build ArrayBag from {type(data)}")
        super().__init__()

    @property
    def native(self) -> List[Any]:
        return self._data

    @property
    def empty(self) -> bool:
        return len(self._data) == 0

    def count(self) -> int:
        return len(self._data)

    def peek(self) -> Any:
        if len(self._data) == 0:
            raise FugueDatasetEmptyError("bag is empty")
        return self._data[0]

    def as_array(self) -> List[Any]:
        return list(self._data)

    def head(self, n: int) -> LocalBoundedBag:
        return ArrayBag(self._data[:n])
