"""Creator conversion, copied from ``fugue_tpu/extensions/creator/convert.py``:
a ``Creator`` instance or class, a registered name, or a function (that
may take the engine, code ``e``) whose output schema comes from an
argument or a ``# schema:`` comment."""

import copy
from typing import Any, Callable, Dict, List, Optional

from ..._utils.assertion import assert_or_throw
from ..._utils.convert import get_caller_global_local_vars, to_instance
from ..._utils.hash import to_uuid
from ...dataframe import DataFrame
from ...dataframe.function_wrapper import DataFrameFunctionWrapper
from ...exceptions import FugueInterfacelessError
from ...schema import Schema
from .._shared import ExtensionRegistry, ParseHook, parse_comment_annotation, resolve_extension_object
from .creator import Creator

_CREATOR_REGISTRY = ExtensionRegistry("creator")
parse_creator = ParseHook()


def register_creator(alias: str, obj: Any, on_dup: str = "overwrite") -> None:
    _CREATOR_REGISTRY.register(alias, obj, on_dup)


def creator(schema: Any = None) -> Callable[[Callable], "_FuncAsCreator"]:
    def deco(func: Callable) -> _FuncAsCreator:
        return _FuncAsCreator.from_func(func, schema)

    return deco


def _to_creator(
    obj: Any,
    schema: Any = None,
    global_vars: Optional[Dict[str, Any]] = None,
    local_vars: Optional[Dict[str, Any]] = None,
) -> Creator:
    global_vars, local_vars = get_caller_global_local_vars(global_vars, local_vars)
    resolved = resolve_extension_object(
        parse_creator(obj), _CREATOR_REGISTRY, Creator, global_vars, local_vars
    )
    if isinstance(resolved, Creator):
        assert_or_throw(
            schema is None, FugueInterfacelessError("schema must be None for Creator instances")
        )
        return copy.copy(resolved)
    if isinstance(resolved, type) and issubclass(resolved, Creator):
        return to_instance(resolved, Creator)
    if callable(resolved):
        return _FuncAsCreator.from_func(resolved, schema)
    raise FugueInterfacelessError(f"can't convert {obj!r} to a creator")


class _FuncAsCreator(Creator):
    def create(self) -> DataFrame:
        args: List[Any] = []
        if self._engine_param:  # type: ignore
            args.append(self.execution_engine)
        return self._wrapper.run(  # type: ignore
            args, self.params, ignore_unknown=False,
            output_schema=self._output_schema_arg,  # type: ignore
        )

    def __uuid__(self) -> str:
        return to_uuid(self._wrapper.__uuid__(), str(self._output_schema_arg))  # type: ignore

    @staticmethod
    def from_func(func: Callable, schema: Any) -> "_FuncAsCreator":
        if schema is None:
            schema = parse_comment_annotation(func, "schema")
        tr = _FuncAsCreator()
        tr._wrapper = DataFrameFunctionWrapper(func, "^e?x*z?$", "^[dlspq]$")  # type: ignore
        tr._engine_param = tr._wrapper.input_code.startswith("e")  # type: ignore
        tr._output_schema_arg = None if schema is None else Schema(schema)  # type: ignore
        if tr._wrapper.need_output_schema:
            assert_or_throw(
                tr._output_schema_arg is not None,
                FugueInterfacelessError("schema is required for this output annotation"),
            )
        return tr
