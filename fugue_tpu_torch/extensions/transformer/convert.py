"""Transformers from classes, functions and names, copied from
``fugue_tpu/extensions/transformer/convert.py``: the ``@transformer``,
``@output_transformer``, ``@cotransformer`` and ``@output_cotransformer``
decorators (:52-90), ``_to_transformer`` and ``_to_output_transformer``
(:92-154) with the registry of names (``register_transformer``) and the
``parse_transformer`` hooks, a name resolved in the caller's scope, and
the interfaceless wrappers whose output schema comes from an argument or
a ``# schema:`` comment, ``*`` expressions included: a function of one
frame is a ``Transformer``, a function of several frames (or of one
``DataFrames``) a ``CoTransformer``, which runs on a zipped frame. A
function with a ``Callable`` parameter after its frames gets the
transformer's RPC callback there (an ``Optional[Callable]`` one gets None
when no callback is set)."""

import copy
import inspect
from typing import Any, Callable, Dict, List, Optional, Union

from ..._utils.convert import get_caller_global_local_vars, to_instance
from ..._utils.hash import to_uuid
from ...dataframe import ArrayDataFrame, DataFrame, DataFrames, LocalDataFrame
from ...dataframe.function_wrapper import DataFrameFunctionWrapper
from ...exceptions import FugueInterfacelessError
from ...schema import Schema
from .._shared import ExtensionRegistry, ParseHook, parse_comment_annotation, resolve_extension_object
from .._utils import parse_validation_rules_from_comment, to_validation_rules
from .transformer import CoTransformer, OutputCoTransformer, OutputTransformer, Transformer

OUTPUT_TRANSFORMER_DUMMY_SCHEMA = Schema("_0:int")
# input: one frame, an optional callback, simple params, **kwargs; ``t`` is
# the port's Dict[str, torch.Tensor] (the JAX package's ``j``)
_INPUT_RE = "^[lspqt][fF]?x*z?$"
# a cotransformer's: one DataFrames, or several frames
_CO_INPUT_RE = "^(c|[lspqt]+)[fF]?x*z?$"


_TRANSFORMER_REGISTRY = ExtensionRegistry("transformer")
_OUT_TRANSFORMER_REGISTRY = ExtensionRegistry("output_transformer")
parse_transformer = ParseHook()
parse_output_transformer = ParseHook()


def register_transformer(alias: str, obj: Any, on_dup: str = "overwrite") -> None:
    """``USING alias`` (and ``transform(df, "alias")``) runs ``obj``."""
    _TRANSFORMER_REGISTRY.register(alias, obj, on_dup)


def register_output_transformer(alias: str, obj: Any, on_dup: str = "overwrite") -> None:
    _OUT_TRANSFORMER_REGISTRY.register(alias, obj, on_dup)


def transformer(schema: Any, **validation_rules: Any) -> Callable[[Callable], "_FuncAsTransformer"]:
    """A function of one frame as a transformer of output ``schema``."""

    def deco(func: Callable) -> _FuncAsTransformer:
        if _is_cotransform_func(func):
            raise FugueInterfacelessError("multi-dataframe functions must use @cotransformer")
        return _FuncAsTransformer.from_func(func, schema, to_validation_rules(validation_rules))

    return deco


def output_transformer(**validation_rules: Any) -> Callable[[Callable], "_FuncAsOutputTransformer"]:
    """A function as an output transformer."""

    def deco(func: Callable) -> _FuncAsOutputTransformer:
        return _FuncAsOutputTransformer.from_func(func, None, to_validation_rules(validation_rules))

    return deco


def cotransformer(schema: Any, **validation_rules: Any) -> Callable[[Callable], "_FuncAsCoTransformer"]:
    """A function of several frames as a cotransformer of output ``schema``."""

    def deco(func: Callable) -> _FuncAsCoTransformer:
        return _FuncAsCoTransformer.from_func(func, schema, to_validation_rules(validation_rules))

    return deco


def output_cotransformer(**validation_rules: Any) -> Callable[[Callable], "_FuncAsOutputCoTransformer"]:
    """A function of several frames as an output cotransformer."""

    def deco(func: Callable) -> _FuncAsOutputCoTransformer:
        return _FuncAsOutputCoTransformer.from_func(func, None, to_validation_rules(validation_rules))

    return deco


def _to_transformer(
    obj: Any,
    schema: Any = None,
    global_vars: Optional[Dict[str, Any]] = None,
    local_vars: Optional[Dict[str, Any]] = None,
) -> Union[Transformer, CoTransformer]:
    global_vars, local_vars = get_caller_global_local_vars(global_vars, local_vars)
    return _to_general_transformer(
        parse_transformer(obj), schema, _TRANSFORMER_REGISTRY, global_vars, local_vars,
        _FuncAsTransformer, _FuncAsCoTransformer,
    )


def _to_output_transformer(
    obj: Any,
    global_vars: Optional[Dict[str, Any]] = None,
    local_vars: Optional[Dict[str, Any]] = None,
) -> Union[Transformer, CoTransformer]:
    global_vars, local_vars = get_caller_global_local_vars(global_vars, local_vars)
    return _to_general_transformer(
        parse_output_transformer(obj), None, _OUT_TRANSFORMER_REGISTRY, global_vars, local_vars,
        _FuncAsOutputTransformer, _FuncAsOutputCoTransformer,
    )


def _to_general_transformer(
    obj: Any, schema: Any, registry: ExtensionRegistry, global_vars: Any, local_vars: Any,
    func_single: type, func_multi: type,
) -> Union[Transformer, CoTransformer]:
    obj = resolve_extension_object(obj, registry, Transformer, global_vars, local_vars)
    if isinstance(obj, (Transformer, CoTransformer)):
        if schema is not None:
            raise FugueInterfacelessError("schema must be None when using an interface class")
        return copy.copy(obj)
    if inspect.isclass(obj) and issubclass(obj, (Transformer, CoTransformer)):
        return to_instance(obj, object)
    if callable(obj):
        if _is_cotransform_func(obj):
            return func_multi.from_func(obj, schema, validation_rules={})
        return func_single.from_func(obj, schema, validation_rules={})
    raise FugueInterfacelessError(f"can't convert {obj!r} to a transformer")


def _is_cotransform_func(func: Callable) -> bool:
    try:
        code = DataFrameFunctionWrapper(func).input_code
    except FugueInterfacelessError:
        return False
    return code.startswith("c") or len([c for c in code.split("x")[0] if c in "lspq"]) > 1


class _CallbackArg:
    """A wrapped function's callback parameter (codes ``f``, required, and
    ``F``, optional, after its frames)."""

    @property
    def using_callback(self) -> bool:
        return any(c in self._wrapper.input_code for c in "fF")  # type: ignore

    def _callback_arg(self) -> List[Any]:
        """``[the RPC client]`` for the function's callback parameter (None
        for an optional one with no callback set); ``[]`` without one."""
        if not self.using_callback:
            return []
        required = "f" in self._wrapper.input_code  # type: ignore
        return [self.callback if self.has_callback or required else None]  # type: ignore


class _FuncAsTransformer(_CallbackArg, Transformer):
    """A plain function as a Transformer (reference ``:328``)."""

    @property
    def validation_rules(self) -> Dict[str, Any]:
        return self._validation_rules  # type: ignore

    def get_output_schema(self, df: DataFrame) -> Any:
        return _apply_schema_arg(df.schema, self._output_schema_arg)  # type: ignore

    def get_format_hint(self) -> Optional[str]:
        return self._wrapper.get_format_hint()  # type: ignore

    def _args(self, df: LocalDataFrame) -> List[Any]:
        return [df] + self._callback_arg()

    def transform(self, df: LocalDataFrame) -> LocalDataFrame:
        return self._wrapper.run(  # type: ignore
            self._args(df), self.params, ignore_unknown=False, output_schema=self.output_schema
        )

    def __uuid__(self) -> str:
        return to_uuid(self._wrapper.__uuid__(), str(self._output_schema_arg), self._validation_rules)  # type: ignore

    @classmethod
    def _wrap(cls, func: Callable, return_re: str, validation_rules: Dict[str, Any]) -> Any:
        tr = cls()
        tr._wrapper = DataFrameFunctionWrapper(func, _INPUT_RE, return_re)  # type: ignore
        rules = dict(validation_rules)
        rules.update(parse_validation_rules_from_comment(func))
        tr._validation_rules = rules  # type: ignore
        return tr

    @staticmethod
    def from_func(func: Callable, schema: Any, validation_rules: Dict[str, Any]) -> "_FuncAsTransformer":
        if schema is None:
            schema = parse_comment_annotation(func, "schema")
        tr = _FuncAsTransformer._wrap(func, "^[lspqt]$", validation_rules)
        if schema is None:
            # an interfaceless transformer needs its output schema before it runs
            raise FugueInterfacelessError(
                "schema is required for interfaceless transformers "
                "(pass schema=... or add a '# schema:' comment)"
            )
        tr._output_schema_arg = schema  # type: ignore
        return tr


class _FuncAsOutputTransformer(_FuncAsTransformer, OutputTransformer):
    """A plain function as an OutputTransformer (reference ``:412``)."""

    def get_output_schema(self, df: DataFrame) -> Any:
        return OUTPUT_TRANSFORMER_DUMMY_SCHEMA

    def transform(self, df: LocalDataFrame) -> LocalDataFrame:
        self._wrapper.run(self._args(df), self.params, ignore_unknown=False, output=False)  # type: ignore
        return ArrayDataFrame([], OUTPUT_TRANSFORMER_DUMMY_SCHEMA)

    @staticmethod
    def from_func(
        func: Callable, schema: Any, validation_rules: Dict[str, Any]
    ) -> "_FuncAsOutputTransformer":
        if schema is not None:
            raise FugueInterfacelessError("schema must be None for output transformers")
        tr = _FuncAsOutputTransformer._wrap(func, "^[lspnqt]$", validation_rules)
        tr._output_schema_arg = None  # type: ignore
        return tr


class _FuncAsCoTransformer(_CallbackArg, CoTransformer):
    """A plain function of several frames as a CoTransformer (reference
    ``:263``): the frames go to its parameters in the zip's order, or all
    at once to one ``DataFrames`` parameter."""

    @property
    def validation_rules(self) -> Dict[str, Any]:
        return self._validation_rules  # type: ignore

    def get_output_schema(self, dfs: DataFrames) -> Any:
        # no "*": a cotransformer has several inputs
        return Schema(self._output_schema_arg)  # type: ignore

    def get_format_hint(self) -> Optional[str]:
        return self._wrapper.get_format_hint()  # type: ignore

    def _args(self, dfs: DataFrames) -> List[Any]:
        args: List[Any] = [dfs] if self._dfs_input else list(dfs.values())  # type: ignore
        return args + self._callback_arg()

    def transform(self, dfs: DataFrames) -> LocalDataFrame:
        return self._wrapper.run(  # type: ignore
            self._args(dfs), self.params, ignore_unknown=False, output_schema=self.output_schema
        )

    def __uuid__(self) -> str:
        return to_uuid(self._wrapper.__uuid__(), str(self._output_schema_arg), self._validation_rules)  # type: ignore

    @classmethod
    def _wrap(cls, func: Callable, return_re: str, validation_rules: Dict[str, Any]) -> Any:
        if len(validation_rules) > 0 or len(parse_validation_rules_from_comment(func)) > 0:
            raise FugueInterfacelessError("cotransformers take no validation rules")
        tr = cls()
        tr._wrapper = DataFrameFunctionWrapper(func, _CO_INPUT_RE, return_re)  # type: ignore
        tr._dfs_input = tr._wrapper.input_code.startswith("c")  # type: ignore
        tr._validation_rules = {}  # type: ignore
        return tr

    @staticmethod
    def from_func(func: Callable, schema: Any, validation_rules: Dict[str, Any]) -> "_FuncAsCoTransformer":
        if schema is None:
            schema = parse_comment_annotation(func, "schema")
        tr = _FuncAsCoTransformer._wrap(func, "^[lspqt]$", validation_rules)
        if schema is None:
            raise FugueInterfacelessError("schema is required for interfaceless cotransformers")
        tr._output_schema_arg = str(schema) if isinstance(schema, Schema) else schema  # type: ignore
        return tr


class _FuncAsOutputCoTransformer(_FuncAsCoTransformer, OutputCoTransformer):
    """A plain function of several frames as an OutputCoTransformer
    (reference ``:331``)."""

    def get_output_schema(self, dfs: DataFrames) -> Any:
        return OUTPUT_TRANSFORMER_DUMMY_SCHEMA

    def transform(self, dfs: DataFrames) -> LocalDataFrame:
        self._wrapper.run(self._args(dfs), self.params, ignore_unknown=False, output=False)  # type: ignore
        return ArrayDataFrame([], OUTPUT_TRANSFORMER_DUMMY_SCHEMA)

    @staticmethod
    def from_func(
        func: Callable, schema: Any, validation_rules: Dict[str, Any]
    ) -> "_FuncAsOutputCoTransformer":
        if schema is not None:
            raise FugueInterfacelessError("schema must be None for output cotransformers")
        tr = _FuncAsOutputCoTransformer._wrap(func, "^[lspnqt]$", validation_rules)
        tr._output_schema_arg = None  # type: ignore
        return tr


def _apply_schema_arg(input_schema: Schema, schema_arg: Any) -> Schema:
    """The output schema: a Schema as it is, a callable of the input
    schema, or expressions (``*`` is the input's columns) resolved against
    the input schema."""
    if schema_arg is None:
        raise FugueInterfacelessError("output schema is required but not provided")
    if isinstance(schema_arg, Schema):
        return schema_arg
    if callable(schema_arg):
        return Schema(schema_arg(input_schema))
    if isinstance(schema_arg, (list, tuple)):
        return input_schema.transform(*schema_arg)
    return input_schema.transform(schema_arg)
