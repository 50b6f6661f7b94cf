"""``Bag``, copied from ``fugue_tpu/bag/bag.py``: an unordered collection
of arbitrary objects, the schemaless sibling of the frame. An engine's map
may support it (``MapEngine.map_bag``); the port's do not yet, as the JAX
package's do not."""

from abc import abstractmethod
from typing import Any, List

from ..dataset.dataset import Dataset, DatasetDisplay, register_dataset_display


class Bag(Dataset):
    @abstractmethod
    def as_local(self) -> "LocalBag":
        raise NotImplementedError

    @abstractmethod
    def peek(self) -> Any:
        raise NotImplementedError

    @abstractmethod
    def as_array(self) -> List[Any]:
        raise NotImplementedError

    @abstractmethod
    def head(self, n: int) -> "LocalBoundedBag":
        raise NotImplementedError


class LocalBag(Bag):
    @property
    def is_local(self) -> bool:
        return True

    @property
    def num_partitions(self) -> int:
        return 1


class LocalBoundedBag(LocalBag):
    @property
    def is_bounded(self) -> bool:
        return True

    def as_local(self) -> LocalBag:
        return self


class BagDisplay(DatasetDisplay):
    """A bag as text: its first items, one a line."""

    def show(self, n: int = 10, with_count: bool = False, title: Any = None) -> None:
        b = self._ds
        if title:
            print(title)
        head: List[Any] = b.as_local().head(n).as_array()
        print(f"Bag({len(head)} shown)")
        for item in head:
            print(f"  {item!r}")
        if with_count:
            print(f"Total count: {b.count()}")


@register_dataset_display(lambda ds: isinstance(ds, Bag), priority=0.1)
def _default_bag_display(ds: Dataset) -> DatasetDisplay:
    return BagDisplay(ds)
