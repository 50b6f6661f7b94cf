"""The transformer's run, copied from
``fugue_tpu/extensions/_builtins/processors.py`` and trimmed to
``RunTransformer._run_transform`` (:54) and ``_TransformerRunner`` (:120).
There is no workflow (ROADMAP.md A.11): ``api.transform`` and
``api.out_transform`` call :func:`run_transformer` directly, where the JAX
package reaches the processor through a one-task DAG
(``fugue_tpu/workflow/api.py`` :18-47)."""

from typing import Any, List, Optional, Type

from ..._utils.convert import to_type
from ..._utils.params import ParamDict
from ...collections.partition import PartitionCursor, PartitionSpec
from ...dataframe import ArrayDataFrame, DataFrame, LocalDataFrame
from ...schema import Schema
from .._utils import validate_input_schema, validate_partition_spec
from ..transformer.transformer import Transformer


def run_transformer(
    engine: Any,
    df: DataFrame,
    tf: Transformer,
    params: Any = None,
    partition_spec: Optional[PartitionSpec] = None,
    ignore_errors: Optional[List[Any]] = None,
) -> DataFrame:
    """Run transformer ``tf`` over ``df`` grouped by ``partition_spec``
    through the engine's map; an exception of a type in ``ignore_errors``
    turns its partition's output into no rows."""
    spec = partition_spec if partition_spec is not None else PartitionSpec()
    validate_partition_spec(spec, tf.validation_rules)
    tf._workflow_conf = engine.conf  # type: ignore[attr-defined]
    tf._params = ParamDict(params)  # type: ignore[attr-defined]
    tf._partition_spec = spec  # type: ignore[attr-defined]
    tf._execution_engine = engine  # type: ignore[attr-defined]
    # both map paths group inside map_dataframe: no repartition first
    validate_input_schema(df.schema, tf.validation_rules)
    schema = Schema(tf.get_output_schema(df))
    tf._output_schema = schema  # type: ignore[attr-defined]
    tf._key_schema = spec.get_key_schema(df.schema)  # type: ignore[attr-defined]
    runner = _TransformerRunner(df, tf, [to_type(x, Exception) for x in ignore_errors or []])
    fmt = tf.get_format_hint() if hasattr(tf, "get_format_hint") else None
    return engine.map_engine.map_dataframe(
        df,
        runner.run,
        output_schema=schema,
        partition_spec=spec,
        on_init=runner.on_init,
        map_func_format_hint=fmt,
    )


class _TransformerRunner:
    def __init__(self, df: DataFrame, transformer: Transformer, ignore_errors: List[Type[Exception]]):
        self.schema = df.schema
        self.metadata = df.metadata if df.has_metadata else None
        self.transformer = transformer
        self.ignore_errors = tuple(ignore_errors)

    def run(self, cursor: PartitionCursor, df: LocalDataFrame) -> LocalDataFrame:
        self.transformer._cursor = cursor  # type: ignore[attr-defined]
        df.reset_metadata(self.metadata)
        if len(self.ignore_errors) == 0:
            return self.transformer.transform(df)
        try:
            return self.transformer.transform(df).as_local_bounded()
        except self.ignore_errors:
            return ArrayDataFrame([], self.transformer.output_schema)

    def on_init(self, partition_no: int, df: DataFrame) -> None:
        s = self.transformer.partition_spec
        self.transformer._cursor = s.get_cursor(self.schema, partition_no)  # type: ignore[attr-defined]
        self.transformer.on_init(df)
