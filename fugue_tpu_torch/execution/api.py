"""The engine context, copied from ``fugue_tpu/execution/api.py``
(``engine_context`` :24, ``as_fugue_engine_df`` :36, ``set_global_engine``
:46, ``clear_global_engine`` :53, ``get_context_engine`` :57,
``run_engine_function`` :64, ``get_current_parallelism`` :431,
``get_current_conf`` :437). Engine names resolve in
``execution/factory.py``, with the port's ``device``::

    with engine_context("torch"):
        transform(df, fn, schema="*", partition={"by": ["k"]})

The verbs themselves are in ``fugue_tpu_torch/api.py``."""

from contextlib import contextmanager
from typing import Any, Callable, Iterator, List, Optional

from .._utils.params import ParamDict
from ..constants import _FUGUE_GLOBAL_CONF
from ..dataframe import DataFrame
from ..dataframe.api import as_fugue_df, get_native_as_df
from .execution_engine import ExecutionEngine
from .factory import make_execution_engine, try_get_context_execution_engine


@contextmanager
def engine_context(
    engine: Any = None, conf: Any = None, infer_by: Optional[List[Any]] = None, device: Any = None
) -> Iterator[ExecutionEngine]:
    """``engine`` (resolved with ``device`` and ``conf``) as the context
    engine of the block: a call inside it with ``engine=None`` runs on
    it. It stops at the end of the block unless it is the global
    engine."""
    e = make_execution_engine(engine, device=device, conf=conf, infer_by=infer_by)
    with e._as_context() as ctx:
        yield ctx


def as_fugue_engine_df(engine: ExecutionEngine, df: Any, schema: Any = None) -> DataFrame:
    """``df`` (a pandas frame, an arrow table, a frame) as ``engine``'s
    frame."""
    fdf = as_fugue_df(df) if schema is None else as_fugue_df(df, schema=schema)
    return engine.to_df(fdf)


def set_global_engine(engine: Any, conf: Any = None, device: Any = None) -> ExecutionEngine:
    """``engine`` as the process-wide engine, which ``engine=None``
    resolves to outside any context."""
    if engine is None:
        raise ValueError("engine can't be None")
    return make_execution_engine(engine, device=device, conf=conf).set_global()


def clear_global_engine() -> None:
    ExecutionEngine.clear_global()


def get_context_engine() -> ExecutionEngine:
    """The context engine, else the global engine; raises when neither is
    set."""
    e = try_get_context_execution_engine()
    if e is None:
        raise RuntimeError("no execution engine in context")
    return e


def run_engine_function(
    func: Callable[[ExecutionEngine], Any],
    engine: Any = None,
    engine_conf: Any = None,
    as_fugue: bool = False,
    as_local: bool = False,
    infer_by: Optional[List[Any]] = None,
    device: Any = None,
) -> Any:
    """``func(engine)`` with ``engine`` resolved and made the context
    engine for the call; a frame result is local with ``as_local`` and
    unwrapped unless ``as_fugue``."""
    e = make_execution_engine(engine, device=device, conf=engine_conf, infer_by=infer_by)
    with e._as_context():
        res = func(e)
        if isinstance(res, DataFrame):
            res = e.convert_yield_dataframe(res, as_local)
            if not as_fugue:
                return get_native_as_df(res)
        return res


def get_current_parallelism(engine: Any = None, engine_conf: Any = None, device: Any = None) -> int:
    """The engine's concurrency: 1 on one device and on the host engine."""
    return run_engine_function(
        lambda e: e.get_current_parallelism(), engine=engine, engine_conf=engine_conf, device=device
    )


def get_current_conf() -> ParamDict:
    """The conf of the context or global engine, else the global
    defaults."""
    e = try_get_context_execution_engine()
    return e.conf if e is not None else _FUGUE_GLOBAL_CONF
