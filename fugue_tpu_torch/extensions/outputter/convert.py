"""Outputter conversion, copied from
``fugue_tpu/extensions/outputter/convert.py``: an ``Outputter`` instance or
class, a registered name, or a function of frames that returns nothing."""

import copy
from typing import Any, Callable, Dict, List, Optional

from ..._utils.convert import get_caller_global_local_vars, to_instance
from ..._utils.hash import to_uuid
from ...dataframe import DataFrames
from ...dataframe.function_wrapper import DataFrameFunctionWrapper
from ...exceptions import FugueInterfacelessError
from .._shared import ExtensionRegistry, ParseHook, resolve_extension_object
from .._utils import parse_validation_rules_from_comment, to_validation_rules
from .outputter import Outputter

_OUTPUTTER_REGISTRY = ExtensionRegistry("outputter")
parse_outputter = ParseHook("parse_outputter")


def register_outputter(alias: str, obj: Any, on_dup: str = "overwrite") -> None:
    _OUTPUTTER_REGISTRY.register(alias, obj, on_dup)


def outputter(**validation_rules: Any) -> Callable[[Callable], "_FuncAsOutputter"]:
    def deco(func: Callable) -> _FuncAsOutputter:
        return _FuncAsOutputter.from_func(func, to_validation_rules(validation_rules))

    return deco


def _to_outputter(
    obj: Any,
    global_vars: Optional[Dict[str, Any]] = None,
    local_vars: Optional[Dict[str, Any]] = None,
) -> Outputter:
    global_vars, local_vars = get_caller_global_local_vars(global_vars, local_vars)
    resolved = resolve_extension_object(
        parse_outputter(obj), _OUTPUTTER_REGISTRY, Outputter, global_vars, local_vars
    )
    if isinstance(resolved, Outputter):
        return copy.copy(resolved)
    if isinstance(resolved, type) and issubclass(resolved, Outputter):
        return to_instance(resolved, Outputter)
    if callable(resolved):
        return _FuncAsOutputter.from_func(resolved, validation_rules={})
    raise FugueInterfacelessError(f"can't convert {obj!r} to an outputter")


class _FuncAsOutputter(Outputter):
    @property
    def validation_rules(self) -> Dict[str, Any]:
        return self._validation_rules  # type: ignore

    def process(self, dfs: DataFrames) -> None:
        args: List[Any] = []
        if self._engine_param:  # type: ignore
            args.append(self.execution_engine)
        if self._dfs_input:  # type: ignore
            args.append(dfs)
        else:
            args.extend(dfs.values())
        self._wrapper.run(args, self.params, ignore_unknown=False, output=False)  # type: ignore

    def __uuid__(self) -> str:
        return to_uuid(self._wrapper.__uuid__(), self._validation_rules)  # type: ignore

    @staticmethod
    def from_func(func: Callable, validation_rules: Dict[str, Any]) -> "_FuncAsOutputter":
        validation_rules = dict(validation_rules)
        validation_rules.update(parse_validation_rules_from_comment(func))
        tr = _FuncAsOutputter()
        tr._wrapper = DataFrameFunctionWrapper(func, "^e?(c|[dlspq]+)x*z?$", "^n$")  # type: ignore
        tr._engine_param = tr._wrapper.input_code.startswith("e")  # type: ignore
        tr._dfs_input = "c" in tr._wrapper.input_code  # type: ignore
        tr._validation_rules = validation_rules  # type: ignore
        return tr
