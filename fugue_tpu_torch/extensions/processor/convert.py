"""Processor conversion, copied from
``fugue_tpu/extensions/processor/convert.py``: a ``Processor`` instance or
class, a registered name, or a function of frames (``DataFrames``, or one
parameter a frame; the engine first, code ``e``, if it wants it)."""

import copy
from typing import Any, Callable, Dict, List, Optional

from ..._utils.assertion import assert_or_throw
from ..._utils.convert import get_caller_global_local_vars, to_instance
from ..._utils.hash import to_uuid
from ...dataframe import DataFrame, DataFrames
from ...dataframe.function_wrapper import DataFrameFunctionWrapper
from ...exceptions import FugueInterfacelessError
from ...schema import Schema
from .._shared import ExtensionRegistry, ParseHook, parse_comment_annotation, resolve_extension_object
from .._utils import parse_validation_rules_from_comment, to_validation_rules
from .processor import Processor

_PROCESSOR_REGISTRY = ExtensionRegistry("processor")
parse_processor = ParseHook()


def register_processor(alias: str, obj: Any, on_dup: str = "overwrite") -> None:
    _PROCESSOR_REGISTRY.register(alias, obj, on_dup)


def processor(schema: Any = None, **validation_rules: Any) -> Callable[[Callable], "_FuncAsProcessor"]:
    def deco(func: Callable) -> _FuncAsProcessor:
        return _FuncAsProcessor.from_func(func, schema, to_validation_rules(validation_rules))

    return deco


def _to_processor(
    obj: Any,
    schema: Any = None,
    global_vars: Optional[Dict[str, Any]] = None,
    local_vars: Optional[Dict[str, Any]] = None,
) -> Processor:
    global_vars, local_vars = get_caller_global_local_vars(global_vars, local_vars)
    resolved = resolve_extension_object(
        parse_processor(obj), _PROCESSOR_REGISTRY, Processor, global_vars, local_vars
    )
    if isinstance(resolved, Processor):
        assert_or_throw(
            schema is None, FugueInterfacelessError("schema must be None for Processor instances")
        )
        return copy.copy(resolved)
    if isinstance(resolved, type) and issubclass(resolved, Processor):
        return to_instance(resolved, Processor)
    if callable(resolved):
        return _FuncAsProcessor.from_func(resolved, schema, validation_rules={})
    raise FugueInterfacelessError(f"can't convert {obj!r} to a processor")


class _FuncAsProcessor(Processor):
    @property
    def validation_rules(self) -> Dict[str, Any]:
        return self._validation_rules  # type: ignore

    def process(self, dfs: DataFrames) -> DataFrame:
        args: List[Any] = []
        if self._engine_param:  # type: ignore
            args.append(self.execution_engine)
        if self._dfs_input:  # type: ignore
            args.append(dfs)
        else:
            args.extend(dfs.values())
        return self._wrapper.run(  # type: ignore
            args, self.params, ignore_unknown=False,
            output_schema=self._output_schema_arg,  # type: ignore
        )

    def __uuid__(self) -> str:
        return to_uuid(
            self._wrapper.__uuid__(), str(self._output_schema_arg), self._validation_rules  # type: ignore
        )

    @staticmethod
    def from_func(func: Callable, schema: Any, validation_rules: Dict[str, Any]) -> "_FuncAsProcessor":
        if schema is None:
            schema = parse_comment_annotation(func, "schema")
        validation_rules = dict(validation_rules)
        validation_rules.update(parse_validation_rules_from_comment(func))
        tr = _FuncAsProcessor()
        tr._wrapper = DataFrameFunctionWrapper(func, "^e?(c|[dlspq]+)x*z?$", "^[dlspq]$")  # type: ignore
        tr._engine_param = tr._wrapper.input_code.startswith("e")  # type: ignore
        tr._dfs_input = "c" in tr._wrapper.input_code  # type: ignore
        tr._output_schema_arg = None if schema is None else Schema(schema)  # type: ignore
        tr._validation_rules = validation_rules  # type: ignore
        if tr._wrapper.need_output_schema:
            assert_or_throw(
                tr._output_schema_arg is not None,
                FugueInterfacelessError("schema is required for this output annotation"),
            )
        return tr
