"""``Dataset``, ``DatasetDisplay`` and ``get_dataset_display``, copied from
``fugue_tpu/dataset/dataset.py`` as far as the port's bags need them: the
root of a collection of data (metadata, locality and boundedness, a count,
a display). The port's ``DataFrame`` keeps its own base; it shares the
display chain only.

The JAX package resolves a display through its plugin registry; the port
has none, so :func:`register_dataset_display` keeps the candidates here,
and the one of the highest priority whose matcher accepts the object
renders it (the port's frames and bags register theirs at 0.1, the
notebook's HTML display at 3.0)."""

from abc import ABC, abstractmethod
from typing import Any, Callable, List, Optional, Tuple

from .._utils.hash import to_uuid
from .._utils.params import ParamDict
from ..exceptions import FugueDatasetEmptyError


class Dataset(ABC):
    """An abstract collection of data with metadata."""

    def __init__(self):
        self._metadata: Optional[ParamDict] = None

    @property
    def metadata(self) -> ParamDict:
        if self._metadata is None:
            self._metadata = ParamDict()
        return self._metadata

    @property
    def has_metadata(self) -> bool:
        return self._metadata is not None and len(self._metadata) > 0

    def reset_metadata(self, metadata: Any) -> None:
        self._metadata = ParamDict(metadata) if metadata is not None else None

    @property
    def native(self) -> Any:
        """The underlying object this dataset wraps (self if none)."""
        return self

    @property
    @abstractmethod
    def is_local(self) -> bool:
        """Whether the data fully resides in the calling process."""
        raise NotImplementedError

    @property
    @abstractmethod
    def is_bounded(self) -> bool:
        """Whether the data size is known/finite."""
        raise NotImplementedError

    @property
    @abstractmethod
    def num_partitions(self) -> int:
        """Number of physical partitions (1 for local data)."""
        raise NotImplementedError

    @property
    @abstractmethod
    def empty(self) -> bool:
        raise NotImplementedError

    @abstractmethod
    def count(self) -> int:
        raise NotImplementedError

    def assert_not_empty(self) -> None:
        if self.empty:
            raise FugueDatasetEmptyError("dataset is empty")

    def show(self, n: int = 10, with_count: bool = False, title: Optional[str] = None) -> None:
        get_dataset_display(self).show(n=n, with_count=with_count, title=title)

    def _repr_html_(self) -> str:
        """The notebooks' rich rendering, through the display chain."""
        return get_dataset_display(self).repr_html()

    def __uuid__(self) -> str:
        # object identity: an in-memory dataset is not the same across runs
        return to_uuid(str(type(self)), id(self))


class DatasetDisplay(ABC):
    """Renders a dataset for ``show`` and for the notebook."""

    def __init__(self, ds: Any):
        self._ds = ds

    @abstractmethod
    def show(self, n: int = 10, with_count: bool = False, title: Optional[str] = None) -> None:
        raise NotImplementedError

    def repr(self) -> str:
        return str(type(self._ds).__name__)

    def repr_html(self) -> str:
        return "<pre>" + self.repr() + "</pre>"


_DISPLAYS: List[Tuple[float, Callable[[Any], bool], Callable[[Any], DatasetDisplay]]] = []


def register_dataset_display(
    matcher: Callable[[Any], bool], priority: float = 1.0
) -> Callable[[Callable[[Any], DatasetDisplay]], Callable[[Any], DatasetDisplay]]:
    """Decorate a factory of a ``DatasetDisplay`` for the objects
    ``matcher`` accepts; of two that match, the higher ``priority`` wins,
    and of equal ones the later registered."""

    def deco(factory: Callable[[Any], DatasetDisplay]) -> Callable[[Any], DatasetDisplay]:
        _DISPLAYS.insert(0, (priority, matcher, factory))
        _DISPLAYS.sort(key=lambda c: -c[0])  # stable: the later first among equals
        return factory

    return deco


def get_dataset_display(ds: Any) -> DatasetDisplay:
    """The display of ``ds``: the registered candidate of the highest
    priority that matches it."""
    for _, matcher, factory in _DISPLAYS:
        if matcher(ds):
            return factory(ds)
    raise NotImplementedError(f"no display registered for {type(ds)}")
