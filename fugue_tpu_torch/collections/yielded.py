"""Workflow outputs that outlive ``run()``, copied from
``fugue_tpu/collections/yielded.py``: a ``Yielded`` is named by a
deterministic uuid; a ``PhysicalYielded`` also carries where it is
stored (a file path or a table name)."""

from typing import Any

from .._utils.assertion import assert_or_throw
from .._utils.hash import to_uuid
from ..exceptions import FugueInvalidOperation


class Yielded:
    """Base class of the values a workflow run yields."""

    def __init__(self, yid: str):
        self._yid = to_uuid(yid)

    def __uuid__(self) -> str:
        return self._yid

    @property
    def is_set(self) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def __copy__(self) -> "Yielded":
        return self

    def __deepcopy__(self, memo: Any) -> "Yielded":
        return self


class PhysicalYielded(Yielded):
    """A yield kept in storage: ``storage_type`` is ``file`` or ``table``."""

    def __init__(self, yid: str, storage_type: str):
        super().__init__(yid)
        assert_or_throw(
            storage_type in ("file", "table"),
            lambda: FugueInvalidOperation(f"invalid storage type {storage_type}"),
        )
        self._name = ""
        self._storage_type = storage_type

    @property
    def is_set(self) -> bool:
        return self._name != ""

    def set_value(self, name: str) -> None:
        self._name = name

    @property
    def name(self) -> str:
        assert_or_throw(self.is_set, lambda: FugueInvalidOperation("value is not set"))
        return self._name

    @property
    def storage_type(self) -> str:
        return self._storage_type
