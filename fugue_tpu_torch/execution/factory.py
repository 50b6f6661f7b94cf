"""Engine names, the port's counterpart of ``fugue_tpu/execution/factory.py``
(``make_execution_engine`` :123-163, ``try_get_context_execution_engine``
:104): the port's own engines by name, and the reference's registries
(``register_execution_engine`` by name or type, the default engine, the
SQL engines) and plugins (``parse_execution_engine``,
``infer_execution_engine``, ``_utils/registry.py``), which third-party
packages extend through the ``fugue_tpu_torch.plugins`` entry points.

The resolution order is the reference's: an engine instance is itself;
``"torch"`` or ``"cuda"`` is a new ``TorchExecutionEngine`` on ``device``
(``cuda:0`` unless given), ``"native"`` or ``"pandas"`` a new host
``NativeExecutionEngine``, ``"sqlite"`` a new host
``SQLiteExecutionEngine`` and ``"sqlite_torch"`` a new
``WarehouseTorchExecutionEngine`` (SQL in sqlite, maps on ``device``); a
``sqlite3.Connection`` is a ``SQLiteExecutionEngine`` over it (the JAX
package's ``warehouse/registry.py``). ``None`` is the context engine
(``engine_context``), then the global engine (``set_global_engine``),
then the engine ``infer_by`` implies (a ``WarehouseDataFrame``: its own
engine; a ``sqlite3.Connection``: a sqlite engine over it; a
``TorchDataFrame``: the torch engine on the frame's own device), then
the default. The default differs
from the reference's, whose last resort is its host engine: the port's
is a new ``TorchExecutionEngine`` on ``device``, because the port runs on
the card unless the caller asks for the CPU; a registered default
engine comes before it. ``device`` and ``conf`` apply to an engine the
factory makes, not to one it finds. A name registered with
``register_execution_engine`` wins over a built-in one, as in the
reference, and its factory gets ``(conf, device=...)`` when a device is
given. An unknown name raises ``FuguePluginsRegistrationError``."""

import inspect
import sqlite3
from threading import RLock
from typing import Any, Callable, Dict, List, Optional, Type, Union

from .._utils.registry import fugue_plugin
from ..exceptions import FuguePluginsRegistrationError
from .execution_engine import _CONTEXT_ENGINE, _GLOBAL_ENGINE, ExecutionEngine, SQLEngine

DEVICE_ENGINE_NAMES = ("torch", "cuda", "sqlite_torch")
HOST_ENGINE_NAMES = ("native", "pandas", "sqlite")


def try_get_context_execution_engine() -> Optional[ExecutionEngine]:
    """The context engine, else the global engine, else None."""
    e = _CONTEXT_ENGINE.get()
    return e if e is not None else _GLOBAL_ENGINE[0]


_LOCK = RLock()
_EXECUTION_ENGINE_REGISTRY: Dict[str, Callable] = {}
_EXECUTION_ENGINE_TYPE_REGISTRY: Dict[Type, Callable] = {}
_SQL_ENGINE_REGISTRY: Dict[str, Callable] = {}
_DEFAULT_EXECUTION_ENGINE: List[Optional[Callable]] = [None]
_DEFAULT_SQL_ENGINE: List[Optional[Callable]] = [None]


def _register(registry: Dict[Any, Callable], key: Any, func: Callable, on_dup: str) -> None:
    with _LOCK:
        if key in registry and on_dup == "throw":
            raise FuguePluginsRegistrationError(f"{key} already registered")
        if key in registry and on_dup == "ignore":
            return
        registry[key] = func


def register_execution_engine(
    name_or_type: Union[str, Type], func: Callable, on_dup: str = "overwrite"
) -> None:
    """Register an engine factory ``func(conf, **kwargs)`` under a name, or
    ``func(obj, conf, **kwargs)`` under a type (an engine from an object)."""
    if isinstance(name_or_type, str):
        _register(_EXECUTION_ENGINE_REGISTRY, name_or_type, func, on_dup)
    else:
        _register(_EXECUTION_ENGINE_TYPE_REGISTRY, name_or_type, func, "overwrite")


def register_default_execution_engine(func: Callable, on_dup: str = "overwrite") -> None:
    """``func(conf, **kwargs)`` makes the engine of ``engine=None`` when no
    context, global or inferred engine applies."""
    with _LOCK:
        if _DEFAULT_EXECUTION_ENGINE[0] is not None and on_dup == "throw":
            raise FuguePluginsRegistrationError("default engine already registered")
        if _DEFAULT_EXECUTION_ENGINE[0] is not None and on_dup == "ignore":
            return
        _DEFAULT_EXECUTION_ENGINE[0] = func


def register_sql_engine(name: str, func: Callable, on_dup: str = "overwrite") -> None:
    """Register ``func(execution_engine, **kwargs) -> SQLEngine`` under a name."""
    _register(_SQL_ENGINE_REGISTRY, name, func, on_dup)


def register_default_sql_engine(func: Callable, on_dup: str = "overwrite") -> None:
    with _LOCK:
        if _DEFAULT_SQL_ENGINE[0] is not None and on_dup == "throw":
            raise FuguePluginsRegistrationError("default sql engine already registered")
        if _DEFAULT_SQL_ENGINE[0] is not None and on_dup == "ignore":
            return
        _DEFAULT_SQL_ENGINE[0] = func


@fugue_plugin
def parse_execution_engine(engine: Any, conf: Any, **kwargs: Any) -> ExecutionEngine:
    """Plugin: an engine spec (a name, an engine class, a ``sqlite3``
    connection or an object of a registered type) as an engine."""
    device = kwargs.pop("device", None)
    if isinstance(engine, str):
        with _LOCK:
            func = _EXECUTION_ENGINE_REGISTRY.get(engine)
        if func is not None:
            return func(conf, **kwargs) if device is None else func(conf, device=device, **kwargs)
        return _builtin_engine(engine, device, conf)
    if isinstance(engine, sqlite3.Connection):
        if device is not None:
            raise ValueError("the host engine over a sqlite3 connection takes no device")
        from ..warehouse import SQLiteExecutionEngine

        return SQLiteExecutionEngine(conf, connection=engine)
    if inspect.isclass(engine) and issubclass(engine, ExecutionEngine):
        return engine(conf=conf, **kwargs) if device is None else engine(conf=conf, device=device, **kwargs)
    with _LOCK:
        for tp, func in _EXECUTION_ENGINE_TYPE_REGISTRY.items():
            if isinstance(engine, tp):
                return func(engine, conf, **kwargs)
    raise FuguePluginsRegistrationError(f"can't parse engine spec {engine!r}")


@fugue_plugin
def infer_execution_engine(objs: List[Any]) -> Any:
    """Plugin: an engine spec implied by input objects, or None."""
    return None


def is_pandas_or(objs: List[Any], obj_type: Any) -> bool:
    """Whether every object is a local frame (pandas, a local frame, rows)
    or of ``obj_type``: the test an inference candidate makes."""
    import pandas as pd

    from ..dataframe.dataframe import LocalDataFrame

    return all(
        isinstance(o, (pd.DataFrame, LocalDataFrame, list, tuple)) or isinstance(o, obj_type)
        for o in objs
    )


def make_execution_engine(
    engine: Any = None,
    device: Any = None,
    conf: Any = None,
    infer_by: Optional[List[Any]] = None,
    **kwargs: Any,
) -> ExecutionEngine:
    """The engine that ``engine`` names, on ``device`` (``cuda:0`` unless
    given; with no card, pass ``device="cpu"``) with ``conf``; for
    ``None``, the context or global engine, or one ``infer_by`` implies.
    A tuple ``(engine, sql_engine)`` also sets the SQL engine."""
    sql_engine_spec: Any = None
    if isinstance(engine, tuple):
        engine, sql_engine_spec = engine
    if device is not None:
        kwargs["device"] = device
    if isinstance(engine, ExecutionEngine):
        if device is not None or conf is not None:
            raise ValueError("device and conf apply to an engine name, not an engine instance")
        result = engine
    elif engine is None:
        result = _engine_for_none(conf, infer_by, kwargs)
    else:
        result = parse_execution_engine(engine, conf, **kwargs)
    if sql_engine_spec is not None:
        result.set_sql_engine(make_sql_engine(sql_engine_spec, result))
    elif _DEFAULT_SQL_ENGINE[0] is not None and result._sql_engine is None:
        try:
            result.set_sql_engine(_DEFAULT_SQL_ENGINE[0](result))
        except Exception:
            pass
    return result


def _engine_for_none(conf: Any, infer_by: Optional[List[Any]], kwargs: Dict[str, Any]) -> ExecutionEngine:
    ctx = try_get_context_execution_engine()
    if ctx is not None:
        return ctx
    if infer_by:
        inferred = infer_execution_engine(infer_by)
        if inferred is not None:
            return parse_execution_engine(inferred, conf, **kwargs)
    inferred = _infer_warehouse(infer_by)
    if isinstance(inferred, ExecutionEngine):
        return inferred
    if inferred is not None:
        return parse_execution_engine(inferred, conf, **kwargs)
    with _LOCK:
        default = _DEFAULT_EXECUTION_ENGINE[0]
    if default is not None:
        return default(conf, **kwargs)
    device = kwargs.get("device")
    if device is None:
        device = _infer_device(infer_by)
    from ..torch.execution_engine import TorchExecutionEngine

    return TorchExecutionEngine(device=device, conf=conf)


def _builtin_engine(engine: str, device: Any, conf: Any) -> ExecutionEngine:
    name = engine.lower()
    if name == "sqlite_torch":
        from ..warehouse import WarehouseTorchExecutionEngine

        return WarehouseTorchExecutionEngine(conf, device=device)
    if name in DEVICE_ENGINE_NAMES:
        from ..torch.execution_engine import TorchExecutionEngine

        return TorchExecutionEngine(device=device, conf=conf)
    if name in HOST_ENGINE_NAMES:
        if device is not None:
            raise ValueError(f"the host engine {engine!r} takes no device")
        if name == "sqlite":
            from ..warehouse import SQLiteExecutionEngine

            return SQLiteExecutionEngine(conf)
        from .native_execution_engine import NativeExecutionEngine

        return NativeExecutionEngine(conf)
    raise FuguePluginsRegistrationError(
        f"unknown engine {engine!r}: expected one of {DEVICE_ENGINE_NAMES + HOST_ENGINE_NAMES} "
        "or a registered name"
    )


def make_sql_engine(
    engine: Any = None, execution_engine: Optional[ExecutionEngine] = None, **kwargs: Any
) -> SQLEngine:
    """The SQL engine ``engine`` names (a registered name, an instance or a
    class) over ``execution_engine``; ``None`` is that engine's own."""
    if engine is None:
        if execution_engine is None:
            raise FuguePluginsRegistrationError("execution_engine is required")
        return execution_engine.sql_engine
    if isinstance(engine, SQLEngine):
        return engine
    if isinstance(engine, str):
        with _LOCK:
            func = _SQL_ENGINE_REGISTRY.get(engine)
        if func is not None:
            return func(execution_engine, **kwargs)
        raise FuguePluginsRegistrationError(f"{engine!r} is not a registered sql engine")
    if inspect.isclass(engine) and issubclass(engine, SQLEngine):
        return engine(execution_engine, **kwargs)
    raise FuguePluginsRegistrationError(f"can't parse sql engine spec {engine!r}")


def _infer_warehouse(objs: Optional[List[Any]]) -> Any:
    """The engine of the first ``WarehouseDataFrame`` among ``objs``, or
    the first ``sqlite3.Connection``; None if there is neither."""
    from ..warehouse.dataframe import WarehouseDataFrame

    for o in objs or []:
        if isinstance(o, WarehouseDataFrame):
            return o._wh_engine
        if isinstance(o, sqlite3.Connection):
            return o
    return None


def _infer_device(objs: Optional[List[Any]]) -> Any:
    """The device of the first ``TorchDataFrame`` among ``objs``."""
    from ..torch.dataframe import TorchDataFrame

    for o in objs or []:
        if isinstance(o, TorchDataFrame):
            return o.device
    return None


def is_engine_name(name: Any) -> bool:
    return isinstance(name, str) and name.lower() in DEVICE_ENGINE_NAMES + HOST_ENGINE_NAMES
