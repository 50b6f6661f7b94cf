"""User-facing functions of the port, mirroring ``fugue_tpu/execution/api.py``.

``engine`` is ``None``, ``"torch"`` or its alias ``"cuda"`` (a new
:class:`~fugue_tpu_torch.torch.TorchExecutionEngine` on ``device`` with
``conf``), or an engine instance. The names resolve here; nothing is
registered into ``fugue_tpu``'s plugin system. A one-pass stream
(``LocalDataFrameIterableDataFrame``) goes to the engine as it is, never
through ``to_df``, and a stream result comes back as the stream.
"""

from typing import Any, Callable, List, Optional

import pandas as pd
import pyarrow as pa

from .collections.partition import PartitionSpec
from .column.expressions import ColumnExpr
from .dataframe import DataFrame
from .exceptions import FugueInvalidOperation
from .execution.execution_engine import ExecutionEngine
from .schema import Schema
from .torch.execution_engine import TorchExecutionEngine
from .torch.streaming import is_stream_frame

_ENGINE_NAMES = ("torch", "cuda")


def make_execution_engine(
    engine: Any = None, device: Any = None, conf: Any = None
) -> ExecutionEngine:
    """The engine that ``engine`` names, on ``device`` (``cuda:0`` unless
    given; with no card, pass ``device="cpu"``) with ``conf``."""
    if isinstance(engine, ExecutionEngine):
        if device is not None or conf is not None:
            raise ValueError("device and conf apply to an engine name, not an engine instance")
        return engine
    if engine is None or (isinstance(engine, str) and engine.lower() in _ENGINE_NAMES):
        return TorchExecutionEngine(device=device, conf=conf)
    raise ValueError(f"unknown engine {engine!r}: expected one of {_ENGINE_NAMES}")


def aggregate(
    df: Any,
    partition_by: Any = None,
    engine: Any = None,
    device: Any = None,
    as_fugue: bool = False,
    **agg_kwcols: ColumnExpr,
) -> Any:
    """Group ``df`` by ``partition_by`` (a name or a list of names) and
    compute each keyword's aggregate, named by the keyword::

        aggregate(df, partition_by="k", engine="torch",
                  s=sum(col("v")), n=count(col("v")))

    The result is a frame of the engine when ``as_fugue`` or when ``df`` is
    one; otherwise it has the input's type (pandas or arrow)."""
    e = make_execution_engine(engine, device)
    cols = [v.alias(k) for k, v in agg_kwcols.items()]
    spec: Optional[PartitionSpec] = (
        None
        if partition_by is None
        else PartitionSpec(by=[partition_by] if isinstance(partition_by, str) else list(partition_by))
    )
    return _adjust_result(e.aggregate(df, spec, cols), df, as_fugue)


def transform(
    df: Any,
    using: Callable,
    schema: Any = None,
    params: Any = None,
    partition: Any = None,
    engine: Any = None,
    device: Any = None,
    as_fugue: bool = False,
) -> Any:
    """Run the device transformer ``using`` (annotated ``Dict[str,
    torch.Tensor] -> Dict[str, torch.Tensor]``) over ``df``, grouped by
    ``partition`` (a dict such as ``{"by": ["k"], "presort": "t desc"}``,
    a ``PartitionSpec``, or a key name or list of names), into a frame of
    ``schema`` (an explicit schema expression)::

        transform(df, demean, schema="k:long,v:double,d:double",
                  partition={"by": ["k"]}, engine="torch")

    Any other transformer raises ``NotImplementedError`` (the JAX package
    runs it on its host engine; ROADMAP.md A.4b). ``params`` are refused:
    a compiled transformer takes its columns only (the JAX package drops
    them silently, ROADMAP.md C4). The result follows ``aggregate``'s
    rule for its type."""
    if params:
        raise FugueInvalidOperation(
            f"params {sorted(params)} given to a compiled transformer, which takes "
            "its columns only (ROADMAP.md C4)"
        )
    if schema is None or (isinstance(schema, str) and "*" in schema):
        raise NotImplementedError(
            f"output schema {schema!r}: a compiled transformer needs an explicit "
            "schema; `*` expressions are not ported (ROADMAP.md A.4b)"
        )
    e = make_execution_engine(engine, device)
    if partition is None:
        spec = PartitionSpec()
    elif isinstance(partition, (PartitionSpec, dict)):
        spec = PartitionSpec(partition)
    else:
        spec = PartitionSpec(by=partition)
    res = e.map_engine.map_dataframe(df, using, Schema(schema), spec)
    return _adjust_result(res, df, as_fugue)


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
    e = make_execution_engine(engine, device)
    frames = [df1, df2, *dfs]
    res = e.join(df1, df2, how=how, on=on)
    for x in dfs:
        res = e.join(res, x, how=how, on=on)
    return _adjust_result(res, df1, as_fugue or any(isinstance(d, DataFrame) for d in frames))


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
    return res
