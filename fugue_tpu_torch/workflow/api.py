"""One-statement workflows, copied from ``fugue_tpu/workflow/api.py``
(``raw_sql`` :253): a SQL statement of strings and frames as a one-task
DAG, run, its result returned. ``api.transform`` and ``api.out_transform``
call the transformer's run directly (``extensions/_builtins/processors.py``)."""

from typing import Any, List

from ..collections.yielded import Yielded
from ..dataframe import DataFrame
from ..dataframe.api import get_native_as_df
from .workflow import FugueWorkflow


def raw_sql(
    *statements: Any,
    engine: Any = None,
    engine_conf: Any = None,
    device: Any = None,
    as_fugue: bool = False,
    as_local: bool = False,
) -> Any:
    """Run a SQL statement of strings and frames, each frame a table::

        raw_sql("SELECT SUM(a) AS s FROM ", pdf, engine="torch")

    The result is a frame of the engine when ``as_fugue`` or when a frame
    of the statement is one; otherwise what the engine's frame wraps."""
    dag = FugueWorkflow()
    parts: List[Any] = []
    raw_inputs: List[Any] = []
    for s in statements:
        if isinstance(s, str):
            parts.append(s)
        else:
            parts.append(dag.create_data(s))
            raw_inputs.append(s)
    res = dag.select(*parts)
    res.yield_dataframe_as("result", as_local=as_local)
    dag.run(engine, engine_conf, device=device)
    result = dag.yields["result"].result  # type: ignore
    dag.release_task_results()  # free the intermediates now, not at cyclic GC
    if as_fugue or any(isinstance(s, (DataFrame, Yielded)) for s in raw_inputs):
        return result
    return get_native_as_df(result)
