"""The interfaceless core, copied from ``fugue_tpu/dataframe/function_wrapper.py``:
each parameter and return annotation of a plain function maps to an
``AnnotatedParam`` with a one-letter code, and the codes of a function are
matched against a pattern per extension type. The codes (:454)::

    e  ExecutionEngine          c  DataFrames (several inputs)
    d  DataFrame
    l  LocalDataFrame           s  rows with no schema (List[List[Any]],
    p  pd.DataFrame, and           Iterable[List[Any]], List[Dict[str, Any]],
       Iterable[pd.DataFrame]      Iterable[Dict[str, Any]])
    q  pa.Table, and            t  Dict[str, torch.Tensor] (torch_annotations.py)
       Iterable[pa.Table]       f  Callable   F  Optional[Callable]
    x  any other parameter      z  **kwargs   n  None / no return

``t`` takes the place of the JAX package's ``j`` (``Dict[str, jax.Array]``,
``fugue_tpu/jax_annotations.py``). A function annotated with ``jax.Array``
is refused by name: the port never imports JAX to recognise it.
"""

import inspect
import re
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Type

import pandas as pd
import pyarrow as pa

from .._utils.convert import annotation_of
from .._utils.hash import to_uuid
from .._utils.iter import EmptyAwareIterable, make_empty_aware
from .._utils.params import IndexedOrderedDict
from ..exceptions import FugueInterfacelessError
from ..schema import Schema
from .array_dataframe import ArrayDataFrame
from .arrow_dataframe import ArrowDataFrame
from .dataframe import DataFrame, LocalDataFrame
from .dataframe_iterable_dataframe import (
    IterableArrowDataFrame,
    IterablePandasDataFrame,
    LocalDataFrameIterableDataFrame,
)
from .dataframes import DataFrames
from .iterable_dataframe import IterableDataFrame
from .pandas_dataframe import PandasDataFrame

_PARAM_REGISTRY: List[Any] = []  # (matcher, cls) pairs, later registrations win


def fugue_annotated_param(
    annotation: Any = None,
    code: Optional[str] = None,
    matcher: Optional[Callable[[Any], bool]] = None,
) -> Callable[[Type["AnnotatedParam"]], Type["AnnotatedParam"]]:
    """Register an ``AnnotatedParam`` class for an annotation."""

    def deco(cls: Type["AnnotatedParam"]) -> Type["AnnotatedParam"]:
        m = matcher if matcher is not None else (lambda a: a == annotation)
        if code is not None:
            cls.code = code
        _PARAM_REGISTRY.insert(0, (m, cls))
        return cls

    return deco


def _compare_iter(tp: Any) -> Callable[[Any], bool]:
    def m(a: Any) -> bool:
        return a in (Iterable[tp], Iterator[tp]) or str(a) == (
            f"typing.Generator[{tp}, NoneType, NoneType]"
        )

    return m


class AnnotatedParam:
    code = "x"

    def __init__(self, param: Optional[inspect.Parameter]):
        self.param = param

    @property
    def format_hint(self) -> Optional[str]:
        return None


class _OtherParam(AnnotatedParam):
    code = "x"


class _KeywordParam(AnnotatedParam):
    code = "z"


class _NoneParam(AnnotatedParam):
    code = "n"


class _CallableParam(AnnotatedParam):
    code = "f"


class _OptionalCallableParam(AnnotatedParam):
    code = "F"


def _is_callable_anno(a: Any) -> bool:
    return (
        a == Callable
        or a == callable
        or str(a).startswith("typing.Callable")
        or str(a).startswith("collections.abc.Callable")
    )


def _is_opt_callable_anno(a: Any) -> bool:
    s = str(a)
    return (
        a == Optional[Callable]
        or s.startswith("typing.Optional[typing.Callable")
        or s.startswith("typing.Union[typing.Callable")
        or s.startswith("typing.Optional[collections.abc.Callable")
    )


class DataFrameParam(AnnotatedParam):
    """A parameter or return that carries a frame."""

    code = "d"

    def to_input_data(self, df: DataFrame) -> Any:
        return df

    def to_output_df(self, output: Any, schema: Optional[Schema]) -> DataFrame:
        if not isinstance(output, DataFrame):
            raise FugueInterfacelessError(f"output {type(output)} is not a DataFrame")
        if schema is not None and output.schema != schema:
            raise FugueInterfacelessError(f"output schema {output.schema} != expected {schema}")
        return output

    @property
    def need_schema(self) -> Optional[bool]:
        return False


class LocalDataFrameParam(DataFrameParam):
    code = "l"

    def to_input_data(self, df: DataFrame) -> LocalDataFrame:
        return df.as_local()


class _NoSchemaParam(LocalDataFrameParam):
    """Rows with no schema attached: the output schema is required."""

    code = "s"

    @property
    def need_schema(self) -> Optional[bool]:
        return True


class _ListListParam(_NoSchemaParam):
    def to_input_data(self, df: DataFrame) -> List[List[Any]]:
        return df.as_array(type_safe=True)

    def to_output_df(self, output: Any, schema: Optional[Schema]) -> DataFrame:
        return ArrayDataFrame(output, schema)


class _IterableListParam(_NoSchemaParam):
    def to_input_data(self, df: DataFrame) -> Iterable[List[Any]]:
        return df.as_array_iterable(type_safe=True)

    def to_output_df(self, output: Any, schema: Optional[Schema]) -> DataFrame:
        return IterableDataFrame(output, schema)


class _EmptyAwareIterableListParam(_IterableListParam):
    def to_input_data(self, df: DataFrame) -> EmptyAwareIterable[List[Any]]:
        return make_empty_aware(df.as_array_iterable(type_safe=True))


class _ListDictParam(_NoSchemaParam):
    def to_input_data(self, df: DataFrame) -> List[Dict[str, Any]]:
        return df.as_local().as_dicts()

    def to_output_df(self, output: Any, schema: Optional[Schema]) -> DataFrame:
        if schema is None:
            raise FugueInterfacelessError("schema is required")
        return ArrayDataFrame([[r.get(n, None) for n in schema.names] for r in output], schema)


class _IterableDictParam(_NoSchemaParam):
    def to_input_data(self, df: DataFrame) -> Iterable[Dict[str, Any]]:
        return df.as_dict_iterable()

    def to_output_df(self, output: Any, schema: Optional[Schema]) -> DataFrame:
        if schema is None:
            raise FugueInterfacelessError("schema is required")
        names = schema.names
        return IterableDataFrame(([r.get(n, None) for n in names] for r in output), schema)


class _EmptyAwareIterableDictParam(_IterableDictParam):
    def to_input_data(self, df: DataFrame) -> EmptyAwareIterable[Dict[str, Any]]:
        return make_empty_aware(df.as_dict_iterable())


class _PandasParam(LocalDataFrameParam):
    code = "p"

    def to_input_data(self, df: DataFrame) -> pd.DataFrame:
        return df.as_pandas()

    def to_output_df(self, output: Any, schema: Optional[Schema]) -> DataFrame:
        if not isinstance(output, pd.DataFrame):
            raise FugueInterfacelessError(f"output {type(output)} is not pd.DataFrame")
        return PandasDataFrame(output, schema)

    @property
    def format_hint(self) -> Optional[str]:
        return "pandas"


class _IterablePandasParam(LocalDataFrameParam):
    code = "p"

    def to_input_data(self, df: DataFrame) -> Iterable[pd.DataFrame]:
        if isinstance(df, LocalDataFrameIterableDataFrame):
            for sub in df.native:
                yield sub.as_pandas()
        else:
            yield df.as_pandas()

    def to_output_df(self, output: Any, schema: Optional[Schema]) -> DataFrame:
        return IterablePandasDataFrame((PandasDataFrame(x, schema) for x in output), schema)

    @property
    def format_hint(self) -> Optional[str]:
        return "pandas"


class _PyArrowTableParam(LocalDataFrameParam):
    code = "q"

    def to_input_data(self, df: DataFrame) -> pa.Table:
        return df.as_arrow()

    def to_output_df(self, output: Any, schema: Optional[Schema]) -> DataFrame:
        if not isinstance(output, pa.Table):
            raise FugueInterfacelessError(f"output {type(output)} is not pa.Table")
        res = ArrowDataFrame(output)
        return res if schema is None or res.schema == schema else ArrowDataFrame(output, schema)

    @property
    def format_hint(self) -> Optional[str]:
        return "pyarrow"


class _IterableArrowParam(LocalDataFrameParam):
    code = "q"

    def to_input_data(self, df: DataFrame) -> Iterable[pa.Table]:
        if isinstance(df, LocalDataFrameIterableDataFrame):
            for sub in df.native:
                yield sub.as_arrow()
        else:
            yield df.as_arrow()

    def to_output_df(self, output: Any, schema: Optional[Schema]) -> DataFrame:
        def gen() -> Iterable[LocalDataFrame]:
            for tbl in output:
                adf = ArrowDataFrame(tbl)
                yield adf if schema is None or adf.schema == schema else ArrowDataFrame(tbl, schema)

        return IterableArrowDataFrame(gen(), schema)

    @property
    def format_hint(self) -> Optional[str]:
        return "pyarrow"


class _DataFramesParam(AnnotatedParam):
    code = "c"


def _is_jax_array_dict(a: Any) -> bool:
    """``Dict[str, jax.Array]``, known by the module of its value type."""
    args = getattr(a, "__args__", None) or ()
    return len(args) == 2 and str(getattr(args[1], "__module__", "")).split(".")[0] in (
        "jax",
        "jaxlib",
    )


class _JaxDictParam(AnnotatedParam):
    """``Dict[str, jax.Array]``: a transformer of the JAX package."""

    def __init__(self, param: Optional[inspect.Parameter]):
        raise NotImplementedError(
            "a transformer annotated Dict[str, jax.Array] runs on the JAX package's "
            "engine; on the port, annotate it Dict[str, torch.Tensor]"
        )


fugue_annotated_param(DataFrame)(DataFrameParam)
fugue_annotated_param(LocalDataFrame)(LocalDataFrameParam)
fugue_annotated_param(List[List[Any]])(_ListListParam)
fugue_annotated_param(matcher=_compare_iter(List[Any]))(_IterableListParam)
fugue_annotated_param(EmptyAwareIterable[List[Any]])(_EmptyAwareIterableListParam)
fugue_annotated_param(List[Dict[str, Any]])(_ListDictParam)
fugue_annotated_param(matcher=_compare_iter(Dict[str, Any]))(_IterableDictParam)
fugue_annotated_param(EmptyAwareIterable[Dict[str, Any]])(_EmptyAwareIterableDictParam)
fugue_annotated_param(pd.DataFrame)(_PandasParam)
fugue_annotated_param(matcher=_compare_iter(pd.DataFrame))(_IterablePandasParam)
fugue_annotated_param(pa.Table)(_PyArrowTableParam)
fugue_annotated_param(matcher=_compare_iter(pa.Table))(_IterableArrowParam)
fugue_annotated_param(DataFrames)(_DataFramesParam)
fugue_annotated_param(matcher=_is_callable_anno)(_CallableParam)
fugue_annotated_param(matcher=_is_opt_callable_anno)(_OptionalCallableParam)
fugue_annotated_param(matcher=_is_jax_array_dict)(_JaxDictParam)


def parse_annotation(
    annotation: Any, param: Optional[inspect.Parameter] = None, none_as_other: bool = True
) -> AnnotatedParam:
    if param is not None and param.kind == param.VAR_KEYWORD:
        return _KeywordParam(param)
    if param is not None and param.kind == param.VAR_POSITIONAL:
        raise FugueInterfacelessError("*args is not supported")
    if annotation is None or annotation == type(None) or annotation is inspect.Parameter.empty:
        return _OtherParam(param) if none_as_other else _NoneParam(param)
    for m, cls in _PARAM_REGISTRY:
        try:
            matched = m(annotation)
        except Exception:
            continue
        if matched:
            return cls(param)
    return _OtherParam(param)


class DataFrameFunctionWrapper:
    """A plain function whose frame parameters and return are adapted by
    their annotations; ``params_re`` and ``return_re`` are the code
    patterns it must match."""

    def __init__(self, func: Callable, params_re: str = ".*", return_re: str = ".*"):
        self._func = func
        sig = inspect.signature(func)
        self._params: IndexedOrderedDict = IndexedOrderedDict()
        for name, param in sig.parameters.items():
            anno = annotation_of(func, name)
            if anno is inspect.Parameter.empty:
                anno = param.annotation
            self._params[name] = parse_annotation(anno, param)
        rt_anno = annotation_of(func, None)
        if rt_anno is inspect.Parameter.empty:
            rt_anno = sig.return_annotation
        self._rt = parse_annotation(rt_anno, None, none_as_other=False)
        self._input_code = "".join(p.code for p in self._params.values())
        if re.match(params_re, self._input_code) is None:
            raise FugueInterfacelessError(
                f"input signature {self._input_code!r} of {func} doesn't match pattern "
                f"{params_re!r}"
            )
        if re.match(return_re, self._rt.code) is None:
            raise FugueInterfacelessError(
                f"return annotation code {self._rt.code!r} of {func} doesn't match pattern "
                f"{return_re!r}"
            )

    @property
    def func(self) -> Callable:
        return self._func

    @property
    def input_code(self) -> str:
        return self._input_code

    @property
    def output_code(self) -> str:
        return self._rt.code

    @property
    def need_output_schema(self) -> Optional[bool]:
        """Whether the return annotation needs a schema to become a frame."""
        return self._rt.need_schema if isinstance(self._rt, DataFrameParam) else None

    def __uuid__(self) -> str:
        return to_uuid(self._func, self._input_code, self._rt.code)

    def get_format_hint(self) -> Optional[str]:
        for p in list(self._params.values()) + [self._rt]:
            if p.format_hint is not None:
                return p.format_hint
        return None

    def run(
        self,
        args: List[Any],
        kwargs: Dict[str, Any],
        ignore_unknown: bool = False,
        output_schema: Any = None,
        output: bool = True,
    ) -> Any:
        """Call the function, each frame argument converted to its
        parameter's annotation, and its output to a frame of
        ``output_schema`` (``output=False``: drained and dropped)."""
        schema = None if output_schema is None else (
            output_schema if isinstance(output_schema, Schema) else Schema(output_schema)
        )
        p: Dict[str, Any] = {}
        remaining = dict(kwargs)
        i = 0
        for name, ap in self._params.items():
            if isinstance(ap, _KeywordParam):
                continue
            if i < len(args):
                p[name] = self._to_input(ap, args[i])
                i += 1
            elif name in remaining:
                p[name] = self._to_input(ap, remaining.pop(name))
            elif isinstance(ap, _OptionalCallableParam) and (
                ap.param is None or ap.param.default is inspect.Parameter.empty
            ):
                p[name] = None
        if len(remaining) > 0:
            if any(isinstance(ap, _KeywordParam) for ap in self._params.values()):
                p.update(remaining)
            elif not ignore_unknown:
                raise FugueInterfacelessError(
                    f"{list(remaining.keys())} are not acceptable by {self._func}"
                )
        result = self._func(**p)
        if not output:
            if isinstance(result, Iterable) and not isinstance(
                result, (str, bytes, list, dict, pd.DataFrame, pa.Table)
            ):
                for _ in result:  # drain a generator so its side effects happen
                    pass
            return None
        if isinstance(self._rt, DataFrameParam):
            return self._rt.to_output_df(result, schema)
        return result

    @staticmethod
    def _to_input(ap: AnnotatedParam, value: Any) -> Any:
        if isinstance(ap, DataFrameParam) and isinstance(value, DataFrame):
            return ap.to_input_data(value)
        return value
