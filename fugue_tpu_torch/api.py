"""User-facing functions of the port, mirroring ``fugue_tpu/execution/api.py``.

``engine`` is ``None``, ``"torch"`` or its alias ``"cuda"`` (a new
:class:`~fugue_tpu_torch.torch.TorchExecutionEngine` on ``device``), or an
engine instance. The names resolve here; nothing is registered into
``fugue_tpu``'s plugin system.
"""

from typing import Any, Optional

import pandas as pd
import pyarrow as pa

from .collections.partition import PartitionSpec
from .column.expressions import ColumnExpr
from .dataframe import DataFrame
from .execution.execution_engine import ExecutionEngine
from .torch.execution_engine import TorchExecutionEngine

_ENGINE_NAMES = ("torch", "cuda")


def make_execution_engine(engine: Any = None, device: Any = None) -> ExecutionEngine:
    """The engine that ``engine`` names, on ``device`` (``cuda:0`` unless
    given; with no card, pass ``device="cpu"``)."""
    if isinstance(engine, ExecutionEngine):
        if device is not None:
            raise ValueError("device applies to an engine name, not an engine instance")
        return engine
    if engine is None or (isinstance(engine, str) and engine.lower() in _ENGINE_NAMES):
        return TorchExecutionEngine(device=device)
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
    res = e.aggregate(e.to_df(df), spec, cols)
    if as_fugue or isinstance(df, DataFrame):
        return res
    if isinstance(df, pa.Table):
        return res.as_arrow()
    if isinstance(df, pd.DataFrame):
        return res.as_pandas()
    return res
