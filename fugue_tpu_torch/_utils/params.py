"""``ParamDict`` and ``IndexedOrderedDict``, copied from
``fugue_tpu/_utils/params.py``: a string-keyed dict with typed accessors
(an engine's conf), and an insertion-ordered dict with positional access
and a ``readonly`` latch, which :class:`~fugue_tpu_torch.schema.Schema`
builds on."""

from typing import Any, Dict, Optional, Type, TypeVar

T = TypeVar("T")

_BOOL_TRUE = {"true", "yes", "1", "on"}
_BOOL_FALSE = {"false", "no", "0", "off"}


def _convert(value: Any, expected: Type[T]) -> T:
    if value is None or expected is object or isinstance(value, expected):
        return value  # type: ignore
    if expected is bool:
        if isinstance(value, (int, float)):
            return bool(value)  # type: ignore
        s = str(value).strip().lower()
        if s in _BOOL_TRUE:
            return True  # type: ignore
        if s in _BOOL_FALSE:
            return False  # type: ignore
        raise TypeError(f"can't convert {value!r} to bool")
    if expected in (int, float, str):
        return expected(value)  # type: ignore
    raise TypeError(f"can't convert {value!r} to {expected}")


class ParamDict(Dict[str, Any]):
    """A string-keyed dict with typed accessors."""

    def __init__(self, data: Any = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[str(k)] = v

    def get(self, key: str, default: Any) -> Any:  # type: ignore[override]
        """Typed get: the value converted to ``type(default)``."""
        if key in self:
            return self[key] if default is None else _convert(self[key], type(default))
        return default

    def get_or_none(self, key: str, expected: Type[T]) -> Optional[T]:
        return _convert(self[key], expected) if key in self else None

    def get_or_throw(self, key: str, expected: Type[T]) -> T:
        if key not in self:
            raise KeyError(f"{key} not found")
        return _convert(self[key], expected)


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
