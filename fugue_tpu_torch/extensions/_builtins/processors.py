"""Built-in processors, copied from ``fugue_tpu/extensions/_builtins/processors.py``:
the implementations behind the workflow's verbs. ``RunTransformer`` runs
a transformer through :func:`run_transformer` (``_run_transform`` :54,
``_TransformerRunner`` :120), which ``api.transform`` and
``api.out_transform`` also call; a cotransformer goes to the engine's
``comap`` of a zipped frame (``_run_cotransform`` :82,
``_CoTransformerRunner`` :143), which ``Zip`` (:258) makes;
``RunSQLSelect`` (:223-255) runs a statement on the engine's SQL facet.
A transformer's ``callback`` becomes a client of the engine's RPC server
(:43-49), which the transformer hands its function."""

from typing import Any, List, Optional, Type

from ..._utils.assertion import assert_or_throw
from ..._utils.convert import to_type
from ..._utils.params import ParamDict
from ...collections.partition import PartitionCursor, PartitionSpec
from ...collections.sql import StructuredRawSQL
from ...column import SelectColumns as ColSelectColumns
from ...dataframe import ArrayDataFrame, DataFrame, DataFrames, LocalDataFrame
from ...exceptions import FugueWorkflowError
from ...obs import get_tracer
from ...rpc import EmptyRPCHandler, to_rpc_handler
from ...schema import Schema
from .._utils import validate_input_schema, validate_partition_spec
from ..processor.processor import Processor
from ..transformer.transformer import CoTransformer, Transformer


def run_transformer(
    engine: Any,
    df: DataFrame,
    tf: Transformer,
    params: Any = None,
    partition_spec: Optional[PartitionSpec] = None,
    ignore_errors: Optional[List[Any]] = None,
    callback: Any = None,
) -> DataFrame:
    """Run transformer ``tf`` over ``df`` grouped by ``partition_spec``
    through the engine's map (a cotransformer over a zipped ``df``
    through its ``comap``); an exception of a type in ``ignore_errors``
    turns its partition's output into no rows. ``callback`` (a callable or
    an ``RPCHandler``) reaches the transformer's function as a client of
    the engine's RPC server."""
    spec = partition_spec if partition_spec is not None else PartitionSpec()
    validate_partition_spec(spec, tf.validation_rules)
    tf._workflow_conf = engine.conf  # type: ignore[attr-defined]
    tf._params = ParamDict(params)  # type: ignore[attr-defined]
    tf._partition_spec = spec  # type: ignore[attr-defined]
    tf._execution_engine = engine  # type: ignore[attr-defined]
    handler = to_rpc_handler(callback)
    tf._callback = (  # type: ignore[attr-defined]
        None if isinstance(handler, EmptyRPCHandler) else engine.rpc_server.make_client(handler)
    )
    errors = [to_type(x, Exception) for x in ignore_errors or []]
    if isinstance(tf, CoTransformer):
        return _run_cotransform(engine, df, tf, spec, errors)
    # a map that groups inside map_dataframe needs no exchange first
    if not spec.empty and not engine.map_engine.map_handles_repartition:
        df = engine.repartition(df, spec)
    validate_input_schema(df.schema, tf.validation_rules)
    schema = Schema(tf.get_output_schema(df))
    tf._output_schema = schema  # type: ignore[attr-defined]
    tf._key_schema = spec.get_key_schema(df.schema)  # type: ignore[attr-defined]
    runner = _TransformerRunner(df, tf, errors)
    fmt = tf.get_format_hint() if hasattr(tf, "get_format_hint") else None
    return engine.map_engine.map_dataframe(
        df,
        runner.run,
        output_schema=schema,
        partition_spec=spec,
        on_init=runner.on_init,
        map_func_format_hint=fmt,
    )


def _run_cotransform(
    engine: Any, df: DataFrame, tf: CoTransformer, spec: PartitionSpec,
    ignore_errors: List[Type[Exception]],
) -> DataFrame:
    assert_or_throw(
        df.metadata.get("serialized", False),
        FugueWorkflowError("the input of cotransform must be a zipped dataframe"),
    )
    if spec.empty:
        keys = df.metadata.get("keys", [])
        spec = PartitionSpec(by=keys) if len(keys) > 0 else spec
    empty_dfs = DataFrames(
        {
            (df.metadata["names"][i] if df.metadata.get("serialized_has_name", False) else f"_{i}"):
            ArrayDataFrame([], s)
            for i, s in enumerate(df.metadata["schemas"])
        }
    )
    schema = Schema(tf.get_output_schema(empty_dfs))
    tf._output_schema = schema  # type: ignore[attr-defined]
    tf._key_schema = df.schema.extract(df.metadata.get("keys", []))  # type: ignore[attr-defined]
    runner = _CoTransformerRunner(tf, ignore_errors, schema)
    return engine.comap(df, runner.run, output_schema=schema, partition_spec=spec, on_init=runner.on_init)


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


class _CoTransformerRunner:
    def __init__(self, transformer: CoTransformer, ignore_errors: List[Type[Exception]], schema: Schema):
        self.transformer = transformer
        self.ignore_errors = tuple(ignore_errors)
        self.schema = schema

    def run(self, cursor: PartitionCursor, dfs: DataFrames) -> LocalDataFrame:
        self.transformer._cursor = cursor  # type: ignore[attr-defined]
        if len(self.ignore_errors) == 0:
            return self.transformer.transform(dfs)
        try:
            return self.transformer.transform(dfs).as_local_bounded()
        except self.ignore_errors:
            return ArrayDataFrame([], self.schema)

    def on_init(self, partition_no: int, dfs: DataFrames) -> None:
        self.transformer._cursor = PartitionCursor(  # type: ignore[attr-defined]
            Schema(), self.transformer.partition_spec, partition_no
        )
        self.transformer.on_init(dfs)


class RunTransformer(Processor):
    """A transformer's run as a task of the workflow (:23); the workflow
    checks the transformer's partition rules when it adds the task."""

    def process(self, dfs: DataFrames) -> DataFrame:
        return run_transformer(
            self.execution_engine,
            dfs[0],
            self.params.get_or_throw("transformer", object),
            params=self.params.get("params", dict()),
            partition_spec=self.partition_spec,
            ignore_errors=self.params.get("ignore_errors", []),
            callback=self.params.get_or_none("callback", object),
        )


class RunJoin(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        if len(dfs) == 1:
            return dfs[0]
        how = self.params.get_or_throw("how", str)
        on = self.params.get("on", [])
        df = dfs[0]
        for i in range(1, len(dfs)):
            df = self.execution_engine.join(df, dfs[i], how=how, on=on)
        return df


class RunSetOperation(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        if len(dfs) == 1:
            return dfs[0]
        how = self.params.get_or_throw("how", str)
        unique = self.params.get("distinct", True)
        ops = {
            "union": self.execution_engine.union,
            "subtract": self.execution_engine.subtract,
            "intersect": self.execution_engine.intersect,
        }
        assert_or_throw(how in ops, FugueWorkflowError(f"invalid set op {how}"))
        df = dfs[0]
        for i in range(1, len(dfs)):
            df = ops[how](df, dfs[i], distinct=unique)
        return df


class Distinct(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("distinct takes one input"))
        return self.execution_engine.distinct(dfs[0])


class Dropna(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("dropna takes one input"))
        how = self.params.get("how", "any")
        assert_or_throw(
            how in ("any", "all"), FugueWorkflowError("how' needs to be either 'any' or 'all'")
        )
        return self.execution_engine.dropna(
            dfs[0], how=how, thresh=self.params.get_or_none("thresh", int),
            subset=self.params.get_or_none("subset", list),
        )


class Fillna(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("fillna takes one input"))
        return self.execution_engine.fillna(
            dfs[0], value=self.params.get_or_none("value", object),
            subset=self.params.get_or_none("subset", list),
        )


class RunSQLSelect(Processor):
    """A SQL statement on the engine's SQL facet; with ``sql_engine`` (a
    FugueSQL ``CONNECT``), on the named one: a SQL engine of the port
    (``local``/``sql``, the in-tree SQL engine over this engine;
    ``sqlite``, the warehouse's, a private sqlite session unless this
    engine is a warehouse) or an engine of the port (``native``,
    ``torch``, ``sqlite_torch``, ...), made for the statement and stopped
    after it unless it is this engine or in a context. Another name
    raises naming ROADMAP.md A.10. A ``CONNECT`` to an engine runs in one
    ``sql.connect`` span (its engine, the result's rows)."""

    def process(self, dfs: DataFrames) -> DataFrame:
        from ...execution.factory import DEVICE_ENGINE_NAMES, is_engine_name, make_execution_engine
        from ...sql.local_sql import LocalSQLEngine

        statement = self.params.get_or_throw("statement", StructuredRawSQL)
        engine = self.execution_engine
        spec = self.params.get_or_none("sql_engine", object)
        if spec is None:
            return engine.sql_engine.select(dfs, statement)
        if isinstance(spec, str) and spec.lower() in ("local", "sql"):
            return LocalSQLEngine(engine).select(dfs, statement)
        if isinstance(spec, str) and spec.lower() == "sqlite":
            from ...warehouse import WarehouseSQLEngine

            return WarehouseSQLEngine(engine).select(dfs, statement)
        if not is_engine_name(spec):
            raise NotImplementedError(
                f"CONNECT {spec}: the port has no such engine; other engines and SQL "
                "backends are not ported (ROADMAP.md A.10)"
            )
        kw = dict(self.params.get("sql_engine_params", dict()))
        on_device = spec.lower() in DEVICE_ENGINE_NAMES
        device = getattr(engine, "device", None) if on_device else None
        with get_tracer().span("sql.connect", cat="engine", annotate=True, engine=spec.lower()) as sp:
            other = make_execution_engine(spec, device=kw.pop("device", device), conf=engine.conf)
            try:
                res = other.sql_engine.select(dfs, statement).as_local_bounded()
                sp.set(rows=res.count())
                return engine.to_df(res)
            finally:
                # the temporary engine stops once its result is detached
                if other is not engine and not other.in_context:
                    other.stop()


class Zip(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return self.execution_engine.zip(
            dfs,
            how=self.params.get("how", "inner"),
            partition_spec=self.partition_spec,
            temp_path=self.params.get_or_none("temp_path", str),
            to_file_threshold=self.params.get("to_file_threshold", -1),
        )


class Select(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("select takes one input"))
        return self.execution_engine.select(
            dfs[0], self.params.get_or_throw("columns", ColSelectColumns),
            where=self.params.get_or_none("where", object),
            having=self.params.get_or_none("having", object),
        )


class Filter(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("filter takes one input"))
        return self.execution_engine.filter(dfs[0], self.params.get_or_throw("condition", object))


class Assign(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("assign takes one input"))
        return self.execution_engine.assign(dfs[0], self.params.get_or_throw("columns", list))


class Aggregate(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("aggregate takes one input"))
        return self.execution_engine.aggregate(
            dfs[0], self.partition_spec, self.params.get_or_throw("columns", list)
        )


class Rename(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("rename takes one input"))
        return dfs[0].rename(self.params.get_or_throw("columns", dict))


class AlterColumns(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("alter_columns takes one input"))
        return dfs[0].alter_columns(self.params.get_or_throw("columns", object))


class DropColumns(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("drop takes one input"))
        columns = self.params.get_or_throw("columns", list)
        if self.params.get("if_exists", False):
            columns = [c for c in columns if c in dfs[0].schema]
        return dfs[0].drop(columns)


class SelectColumns(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("select takes one input"))
        return dfs[0][self.params.get_or_throw("columns", list)]


class Sample(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("sample takes one input"))
        return self.execution_engine.sample(
            dfs[0], n=self.params.get_or_none("n", int), frac=self.params.get_or_none("frac", float),
            replace=self.params.get("replace", False), seed=self.params.get_or_none("seed", int),
        )


class Take(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("take takes one input"))
        return self.execution_engine.take(
            dfs[0],
            n=self.params.get_or_none("n", int),  # type: ignore[arg-type]
            presort=self.params.get("presort", ""),
            na_position=self.params.get("na_position", "last"),
            partition_spec=self.partition_spec,
        )


class SaveAndUse(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("save takes one input"))
        path = self.params.get_or_throw("path", str)
        format_hint = self.params.get("fmt", "")
        engine = self.execution_engine
        engine.save_df(
            df=dfs[0], path=path, format_hint=format_hint or None,
            mode=self.params.get("mode", "overwrite"), partition_spec=self.partition_spec,
            force_single=self.params.get("single", False), **self.params.get("params", dict()),
        )
        return engine.load_df(path, format_hint=format_hint or None)
