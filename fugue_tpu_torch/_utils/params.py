"""``IndexedOrderedDict``, copied from ``fugue_tpu/_utils/params.py``: an
insertion-ordered dict with positional access and a ``readonly`` latch,
which :class:`~fugue_tpu_torch.schema.Schema` builds on."""

from typing import Any, Dict


class IndexedOrderedDict(Dict[Any, Any]):
    """Ordered dict with positional access and a readonly latch."""

    def __init__(self, *args: Any, **kwargs: Any):
        self._readonly = False
        super().__init__(*args, **kwargs)

    @property
    def readonly(self) -> bool:
        return getattr(self, "_readonly", False)

    def set_readonly(self) -> "IndexedOrderedDict":
        self._readonly = True
        return self

    def _pre_update(self) -> None:
        if self.readonly:
            raise InvalidOperationError("dict is readonly")
        # mutation counter — lets subclasses cache derived views (e.g.
        # Schema.pa_schema) and invalidate on any write
        self._version = getattr(self, "_version", 0) + 1

    def __setitem__(self, key: Any, value: Any) -> None:
        self._pre_update()
        super().__setitem__(key, value)

    def __delitem__(self, key: Any) -> None:
        self._pre_update()
        super().__delitem__(key)

    def pop(self, *args: Any, **kwargs: Any) -> Any:
        self._pre_update()
        return super().pop(*args, **kwargs)

    def clear(self) -> None:
        self._pre_update()
        super().clear()

    def get_value_by_index(self, index: int) -> Any:
        return list(self.values())[index]


class InvalidOperationError(Exception):
    """Mutation attempted on a readonly collection."""
