"""User-facing functions of the port, mirroring ``fugue_tpu/api.py``: every
public name of it, from ``fugue_tpu/execution/api.py`` (the verbs and the
engine context), ``fugue_tpu/workflow/api.py`` (``transform``,
``out_transform``, ``raw_sql``), ``fugue_tpu/sql`` (``fugue_sql``,
``fugue_sql_flow``, ``fsql``), ``fugue_tpu/dataframe/api.py`` and
``fugue_tpu/dataset/api.py`` (the frame functions)::

    import fugue_tpu_torch.api as fa

    with fa.engine_context("torch"):
        res = fa.transform(df, fn, schema="*", partition={"by": ["k"]})

``engine`` is ``"torch"`` or its alias ``"cuda"`` (a new
:class:`~fugue_tpu_torch.torch.TorchExecutionEngine` on ``device``),
``"native"`` (the host engine), an engine instance, or ``None``: the
context engine, else the global engine, else the torch engine on the
device of a ``TorchDataFrame`` input, else a new torch engine on
``device`` (``cuda:0`` unless given). The names resolve in
``execution/factory.py``; nothing is registered into ``fugue_tpu``'s
plugin system. A one-pass stream
(``LocalDataFrameIterableDataFrame``, or the row stream
``IterableDataFrame``) goes to the engine as it is, never through
``to_df``, and a stream result comes back as the stream.
"""

from typing import Any, Callable, List, Optional

import pandas as pd
import pyarrow as pa

from .collections.partition import PartitionSpec
from .column import SelectColumns, col, lit
from .column.expressions import ColumnExpr
from .dataframe import DataFrame
from .dataframe.api import get_native_as_df
from .execution.execution_engine import ExecutionEngine
from .execution.factory import make_execution_engine
from .extensions._builtins.processors import run_transformer
from .extensions.transformer.convert import _to_output_transformer, _to_transformer
from .torch.streaming import is_stream_frame

from .dataframe.api import (  # noqa: F401
    alter_columns,
    as_array,
    as_array_iterable,
    as_arrow,
    as_dict_iterable,
    as_dicts,
    as_fugue_df,
    as_local,
    as_local_bounded,
    as_pandas,
    drop_columns,
    get_column_names,
    get_schema,
    head,
    is_df,
    normalize_column_names,
    peek_array,
    peek_dict,
    rename,
    select_columns,
)
from .dataset.api import (  # noqa: F401
    as_fugue_dataset,
    count,
    get_num_partitions,
    is_bounded,
    is_empty,
    is_local,
    show,
)
from .execution.api import (  # noqa: F401
    as_fugue_engine_df,
    clear_global_engine,
    engine_context,
    get_context_engine,
    get_current_conf,
    get_current_parallelism,
    run_engine_function,
    set_global_engine,
)

def aggregate(
    df: Any,
    partition_by: Any = None,
    engine: Any = None,
    device: Any = None,
    as_fugue: bool = False,
    **agg_kwcols: ColumnExpr,
) -> Any:
    """Group ``df`` by ``partition_by`` (a name or a list of names; None:
    one group of every row) and compute each keyword's aggregate, named by
    the keyword; an aggregate may sit inside an expression::

        aggregate(df, partition_by="k", engine="torch",
                  s=sum(col("v")), n=count(col("v")), r=max(col("v")) - min(col("v")))

    The result is a frame of the engine when ``as_fugue`` or when ``df`` is
    one; otherwise it has the input's type (pandas or arrow)."""
    e = make_execution_engine(engine, device, infer_by=[df])
    cols = [v.alias(k) for k, v in agg_kwcols.items()]
    spec: Optional[PartitionSpec] = (
        None
        if partition_by is None
        else PartitionSpec(by=[partition_by] if isinstance(partition_by, str) else list(partition_by))
    )
    return _adjust_result(e.aggregate(df, spec, cols), df, as_fugue)


def select(
    df: Any,
    *columns: Any,
    where: Optional[ColumnExpr] = None,
    having: Optional[ColumnExpr] = None,
    distinct: bool = False,  # noqa: A002
    engine: Any = None,
    device: Any = None,
    as_fugue: bool = False,
) -> Any:
    """SQL SELECT: ``columns`` (names or expressions; ``col("*")`` for
    every column), rows filtered by ``where``, grouped by the columns that
    hold no aggregate where any does, groups filtered by ``having``,
    without repeats if ``distinct``::

        select(df, col("k"), sum(col("v")).alias("s"), where=col("v") > 0, engine="torch")
    """
    cols = SelectColumns(*[col(c) if isinstance(c, str) else c for c in columns], arg_distinct=distinct)
    return _verb(lambda e, d: e.select(d, cols, where=where, having=having), df, engine, device, as_fugue)


def filter(df: Any, condition: ColumnExpr, engine: Any = None, device: Any = None,  # noqa: A001
           as_fugue: bool = False) -> Any:
    """The rows of ``df`` where ``condition`` is TRUE (FALSE and NULL drop)."""
    return _verb(lambda e, d: e.filter(d, condition), df, engine, device, as_fugue)


def assign(df: Any, engine: Any = None, device: Any = None, as_fugue: bool = False,
           **columns: Any) -> Any:
    """``df`` with each keyword's expression (or constant) as the column of
    its name: replacing the column of that name in place, or added after."""
    cols = [(v if isinstance(v, ColumnExpr) else lit(v)).alias(k) for k, v in columns.items()]
    return _verb(lambda e, d: e.assign(d, cols), df, engine, device, as_fugue)


def dropna(df: Any, how: str = "any", thresh: Optional[int] = None, subset: Optional[List[str]] = None,
           engine: Any = None, device: Any = None, as_fugue: bool = False) -> Any:
    """``df`` without the rows that hold a NULL (``how="any"``), that hold
    only NULLs (``"all"``), or that have fewer than ``thresh`` values, over
    ``subset`` of the columns."""
    return _verb(lambda e, d: e.dropna(d, how=how, thresh=thresh, subset=subset), df, engine, device,
                 as_fugue)


def fillna(df: Any, value: Any, subset: Optional[List[str]] = None, engine: Any = None,
           device: Any = None, as_fugue: bool = False) -> Any:
    """``df`` with its NULLs replaced by ``value`` (or a dict of column to
    value), over ``subset`` of the columns."""
    return _verb(lambda e, d: e.fillna(d, value, subset=subset), df, engine, device, as_fugue)


def repartition(df: Any, partition: Any, engine: Any = None, device: Any = None,
                as_fugue: bool = False) -> Any:
    """``df`` laid out by ``partition`` (a ``PartitionSpec``, its dict,
    ``"per_row"`` or an algo name: ``hash``, ``even``, ``rand``,
    ``coarse``). On one device no row moves: the device frame comes back
    with no copy."""
    return _verb(lambda e, d: e.repartition(d, PartitionSpec(partition)), df, engine, device, as_fugue)


def broadcast(df: Any, engine: Any = None, device: Any = None, as_fugue: bool = False) -> Any:
    """``df`` made available whole to every worker: on one device, as it is."""
    return _verb(lambda e, d: e.broadcast(d), df, engine, device, as_fugue)


def persist(df: Any, lazy: bool = False, engine: Any = None, device: Any = None,
            as_fugue: bool = False, **kwargs: Any) -> Any:
    """``df`` materialized on the engine's device (unless ``lazy``, the
    call returns once it is there)."""
    return _verb(lambda e, d: e.persist(d, lazy=lazy, **kwargs), df, engine, device, as_fugue)


def distinct(df: Any, engine: Any = None, device: Any = None, as_fugue: bool = False) -> Any:
    """The rows of ``df`` without repeats (SELECT DISTINCT; NULL equals
    NULL). A one-pass stream is deduped chunk by chunk."""
    return _verb(lambda e, d: e.distinct(d), df, engine, device, as_fugue)


def sample(df: Any, n: Optional[int] = None, frac: Optional[float] = None, replace: bool = False,
           seed: Optional[int] = None, engine: Any = None, device: Any = None,
           as_fugue: bool = False) -> Any:
    """``n`` rows, or each row with probability ``frac``, of ``df``, drawn
    with ``seed`` (TABLESAMPLE); give one of ``n`` and ``frac``."""
    return _verb(lambda e, d: e.sample(d, n=n, frac=frac, replace=replace, seed=seed), df, engine,
                 device, as_fugue)


def take(df: Any, n: int, presort: str = "", na_position: str = "last", partition: Any = None,
         engine: Any = None, device: Any = None, as_fugue: bool = False) -> Any:
    """The first ``n`` rows of ``df`` (of each group of ``partition``'s
    keys) in the order of ``presort`` (such as ``"v desc, k"``), NULLs
    ``na_position`` (ORDER BY ... LIMIT)::

        take(df, 10, presort="price desc", engine="torch")
    """
    return _verb(
        lambda e, d: e.take(d, n, presort=presort, na_position=na_position,
                            partition_spec=None if partition is None else PartitionSpec(partition)),
        df, engine, device, as_fugue,
    )


def _verb(fn: Callable[[ExecutionEngine, DataFrame], DataFrame], df: Any, engine: Any, device: Any,
          as_fugue: bool) -> Any:
    e = make_execution_engine(engine, device, infer_by=[df])
    return _adjust_result(fn(e, df if is_stream_frame(df) else e.to_df(df)), df, as_fugue)


def transform(
    df: Any,
    using: Any,
    schema: Any = None,
    params: Any = None,
    partition: Any = None,
    callback: Any = None,
    ignore_errors: Optional[List[Any]] = None,
    engine: Any = None,
    device: Any = None,
    as_fugue: bool = False,
    as_local: bool = False,
) -> Any:
    """Run the transformer ``using`` over ``df``, grouped by ``partition``
    (a dict such as ``{"by": ["k"], "presort": "t desc"}``, a
    ``PartitionSpec``, a number of partitions, or a key name or list of
    names), into a frame of ``schema`` (an expression, where ``*`` is the
    input's columns; or a ``# schema:`` comment above the function)::

        transform(pdf, demean, schema="*", partition={"by": ["k"]}, engine="torch")

    ``using`` is a function annotated with frames (``pd.DataFrame``,
    ``pa.Table``, ``List[List[Any]]``, ``List[Dict[str, Any]]``, their
    iterables, ``LocalDataFrame``), a ``@transformer`` function, a
    ``Transformer`` class or instance, or a device function annotated
    ``Dict[str, torch.Tensor] -> Dict[str, torch.Tensor]``. The device
    function runs compiled on the engine's device; any other runs on the
    engine's host engine once a partition, the frame moved to the host and
    the result back onto the device. ``params`` go to the function's other
    parameters (a compiled function refuses them, ROADMAP.md C4); an
    exception of a type in ``ignore_errors`` empties its partition's
    output. ``callback`` (a callable) reaches a function that has a
    ``Callable`` parameter after its frame, through the engine's RPC
    server, which serves it while the transform runs. The result is a
    frame of the engine (local with ``as_local``) when ``as_fugue`` or when
    ``df`` is one; otherwise it has the input's type (pandas or arrow)."""
    res = _run(df, lambda: _to_transformer(using, schema), params, partition, callback,
               ignore_errors, engine, device)
    return _adjust_result(res.as_local() if as_local else res, df, as_fugue)


def out_transform(
    df: Any,
    using: Any,
    params: Any = None,
    partition: Any = None,
    callback: Any = None,
    ignore_errors: Optional[List[Any]] = None,
    engine: Any = None,
    device: Any = None,
) -> None:
    """Run the output transformer ``using`` over ``df`` for its side
    effects (``transform``'s arguments; a function may return nothing)."""
    _run(df, lambda: _to_output_transformer(using), params, partition, callback,
         ignore_errors, engine, device, consume=True)


def load(
    path: Any, format_hint: Any = None, columns: Any = None, engine: Any = None,
    device: Any = None, **kwargs: Any,
) -> Any:
    """The files at ``path`` (parquet, csv or json; a glob, a directory or
    a list of paths), read on the host, as a frame of the engine."""
    e = make_execution_engine(engine, device)
    return e.load_df(path, format_hint=format_hint, columns=columns, **kwargs)


def save(
    df: Any, path: str, format_hint: Any = None, mode: str = "overwrite", partition: Any = None,
    force_single: bool = False, engine: Any = None, device: Any = None, **kwargs: Any,
) -> None:
    """Write ``df`` to ``path`` (parquet, csv or json; ``mode`` overwrite,
    append or error; ``partition`` keys: hive-partitioned parquet)."""
    e = make_execution_engine(engine, device, infer_by=[df])
    e.save_df(
        e.to_df(df), path, format_hint=format_hint, mode=mode,
        partition_spec=None if partition is None else _partition_spec(partition),
        force_single=force_single, **kwargs,
    )


def _run(
    df: Any, make_transformer: Callable[[], Any], params: Any, partition: Any, callback: Any,
    ignore_errors: Optional[List[Any]], engine: Any, device: Any, consume: bool = False,
) -> DataFrame:
    """The transformer's run over ``df`` as the engine holds it (the JAX
    package's workflow puts it on the device; a one-pass stream stays as
    it is), inside a start and stop of the engine's RPC server, as the JAX
    package's one-task workflow runs it. ``consume`` touches the result
    before the stop, so a lazy one runs."""
    e = make_execution_engine(engine, device, infer_by=[df])
    server = e.rpc_server
    server.start()
    try:
        res = run_transformer(
            e, df if is_stream_frame(df) else e.to_df(df), make_transformer(), params=params,
            partition_spec=_partition_spec(partition), ignore_errors=ignore_errors, callback=callback,
        )
        if consume:
            res.count() if res.is_bounded else res.as_local_bounded()
        return res
    finally:
        server.stop()


def _partition_spec(partition: Any) -> PartitionSpec:
    if partition is None:
        return PartitionSpec()
    if isinstance(partition, (PartitionSpec, dict, int)) or partition == "per_row":
        return PartitionSpec(partition)
    return PartitionSpec(by=partition)


def join(
    df1: Any,
    df2: Any,
    *dfs: Any,
    how: str = "inner",
    on: Optional[List[str]] = None,
    engine: Any = None,
    device: Any = None,
    as_fugue: bool = False,
) -> Any:
    """Join ``df1`` with ``df2``, then the result with each of ``dfs`` in
    turn, by ``how`` (inner, left_outer, right_outer, full_outer,
    left_semi, left_anti or cross, or an alias such as ``"semi"``) on the
    keys ``on`` (default: the columns the two sides share)::

        join(frame, means, how="inner", engine="torch")

    The result is a frame of the engine when ``as_fugue`` or when any input
    is one; otherwise it has the type of ``df1`` (pandas or arrow)."""
    return _fold(lambda e, a, b: e.join(a, b, how=how, on=on), [df1, df2, *dfs], engine, device,
                 as_fugue)


def semi_join(df1: Any, df2: Any, *dfs: Any, on=None, engine=None, device=None, as_fugue=False) -> Any:
    return join(df1, df2, *dfs, how="semi", on=on, engine=engine, device=device, as_fugue=as_fugue)


def anti_join(df1: Any, df2: Any, *dfs: Any, on=None, engine=None, device=None, as_fugue=False) -> Any:
    return join(df1, df2, *dfs, how="anti", on=on, engine=engine, device=device, as_fugue=as_fugue)


def inner_join(df1: Any, df2: Any, *dfs: Any, on=None, engine=None, device=None, as_fugue=False) -> Any:
    return join(df1, df2, *dfs, how="inner", on=on, engine=engine, device=device, as_fugue=as_fugue)


def left_outer_join(
    df1: Any, df2: Any, *dfs: Any, on=None, engine=None, device=None, as_fugue=False
) -> Any:
    return join(df1, df2, *dfs, how="left_outer", on=on, engine=engine, device=device,
                as_fugue=as_fugue)


def right_outer_join(
    df1: Any, df2: Any, *dfs: Any, on=None, engine=None, device=None, as_fugue=False
) -> Any:
    return join(df1, df2, *dfs, how="right_outer", on=on, engine=engine, device=device,
                as_fugue=as_fugue)


def full_outer_join(
    df1: Any, df2: Any, *dfs: Any, on=None, engine=None, device=None, as_fugue=False
) -> Any:
    return join(df1, df2, *dfs, how="full_outer", on=on, engine=engine, device=device,
                as_fugue=as_fugue)


def cross_join(df1: Any, df2: Any, *dfs: Any, engine=None, device=None, as_fugue=False) -> Any:
    return join(df1, df2, *dfs, how="cross", engine=engine, device=device, as_fugue=as_fugue)


def union(df1: Any, df2: Any, *dfs: Any, distinct: bool = True,  # noqa: A002
          engine: Any = None, device: Any = None, as_fugue: bool = False) -> Any:
    """The rows of ``df1``, ``df2`` and each of ``dfs`` (UNION; without
    repeats unless ``distinct=False``, UNION ALL)."""
    return _fold(lambda e, a, b: e.union(a, b, distinct=distinct), [df1, df2, *dfs], engine, device,
                 as_fugue)


def subtract(df1: Any, df2: Any, *dfs: Any, distinct: bool = True,  # noqa: A002
             engine: Any = None, device: Any = None, as_fugue: bool = False) -> Any:
    """The distinct rows of ``df1`` in none of ``df2`` and ``dfs``
    (EXCEPT)."""
    return _fold(lambda e, a, b: e.subtract(a, b, distinct=distinct), [df1, df2, *dfs], engine,
                 device, as_fugue)


def intersect(df1: Any, df2: Any, *dfs: Any, distinct: bool = True,  # noqa: A002
              engine: Any = None, device: Any = None, as_fugue: bool = False) -> Any:
    """The distinct rows in ``df1``, ``df2`` and each of ``dfs``
    (INTERSECT)."""
    return _fold(lambda e, a, b: e.intersect(a, b, distinct=distinct), [df1, df2, *dfs], engine,
                 device, as_fugue)


def _fold(fn: Callable[[ExecutionEngine, Any, Any], DataFrame], frames: List[Any], engine: Any,
          device: Any, as_fugue: bool) -> Any:
    """``fn`` over the frames from the left: ``fn(fn(f1, f2), f3)``..."""
    e = make_execution_engine(engine, device, infer_by=frames)
    dfs = [x if isinstance(x, DataFrame) or is_stream_frame(x) else e.to_df(x) for x in frames]
    res = fn(e, dfs[0], dfs[1])
    for x in dfs[2:]:
        res = fn(e, res, x)
    return _adjust_result(res, frames[0], as_fugue or any(isinstance(d, DataFrame) for d in frames))


def _adjust_result(res: DataFrame, df: Any, as_fugue: bool) -> Any:
    """The result is a frame of the engine when ``as_fugue`` or when ``df``
    is one; otherwise it has the input's type (pandas or arrow). A stream
    result stays the stream."""
    if as_fugue or isinstance(df, DataFrame) or is_stream_frame(res):
        return res
    if isinstance(df, pa.Table):
        return res.as_arrow()
    if isinstance(df, pd.DataFrame):
        return res.as_pandas()
    return get_native_as_df(res)


def fugue_sql(
    query: str,
    *args: Any,
    engine: Any = None,
    device: Any = None,
    engine_conf: Any = None,
    as_fugue: bool = False,
    as_local: bool = False,
    **kwargs: Any,
) -> Any:
    """Run FugueSQL and return the last statement's frame. Frames (pandas,
    arrow, the port's) in ``kwargs``, in dicts of ``args`` or in the
    caller's scope are its tables; other ``kwargs`` fill ``{{...}}``
    templates; ``USING name`` finds ``name`` among the registered
    extensions, then in the caller's scope::

        fugue_sql('''
            src = LOAD "data.parquet"
            agg = SELECT k, SUM(v) AS s FROM src WHERE w > 0.1 GROUP BY k
            TRANSFORM agg USING rescale SCHEMA k:long,s:double
        ''', engine="torch")

    The result is a frame of the engine with ``as_fugue`` (local with
    ``as_local``), else what the frame wraps."""
    from .sql.fsql import fugue_sql as _fugue_sql

    return _fugue_sql(query, *args, engine=engine, engine_conf=engine_conf, device=device,
                      as_fugue=as_fugue, as_local=as_local, **kwargs)


def fugue_sql_flow(query: str, *args: Any, **kwargs: Any) -> Any:
    """FugueSQL compiled into a workflow, to ``run(engine, conf, device=)``
    later (``fugue_sql``'s arguments, without the engine's)."""
    from .sql.fsql import fugue_sql_flow as _fugue_sql_flow

    return _fugue_sql_flow(query, *args, **kwargs)


def raw_sql(*statements: Any, engine: Any = None, device: Any = None, engine_conf: Any = None,
            as_fugue: bool = False, as_local: bool = False) -> Any:
    """A SQL statement of strings and frames, each frame a table::

        raw_sql("SELECT k, SUM(v) AS s FROM ", pdf, " GROUP BY k", engine="torch")
    """
    from .workflow.api import raw_sql as _raw_sql

    return _raw_sql(*statements, engine=engine, engine_conf=engine_conf, device=device,
                    as_fugue=as_fugue, as_local=as_local)


fsql = fugue_sql_flow  # the name the original fugue gives it
