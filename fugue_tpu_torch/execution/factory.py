"""Engine names, the port's counterpart of ``fugue_tpu/execution/factory.py``
(``make_execution_engine`` :123-163, ``try_get_context_execution_engine``
:104) trimmed to the port's own engines, resolved here and registered
into nothing.

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
the card unless the caller asks for the CPU. ``device`` and ``conf``
apply to an engine the factory makes, not to one it finds."""

import sqlite3
from typing import Any, List, Optional

from .execution_engine import _CONTEXT_ENGINE, _GLOBAL_ENGINE, ExecutionEngine

DEVICE_ENGINE_NAMES = ("torch", "cuda", "sqlite_torch")
HOST_ENGINE_NAMES = ("native", "pandas", "sqlite")


def try_get_context_execution_engine() -> Optional[ExecutionEngine]:
    """The context engine, else the global engine, else None."""
    e = _CONTEXT_ENGINE.get()
    return e if e is not None else _GLOBAL_ENGINE[0]


def make_execution_engine(
    engine: Any = None, device: Any = None, conf: Any = None, infer_by: Optional[List[Any]] = None
) -> ExecutionEngine:
    """The engine that ``engine`` names, on ``device`` (``cuda:0`` unless
    given; with no card, pass ``device="cpu"``) with ``conf``; for
    ``None``, the context or global engine, or one ``infer_by`` implies."""
    if isinstance(engine, ExecutionEngine):
        if device is not None or conf is not None:
            raise ValueError("device and conf apply to an engine name, not an engine instance")
        return engine
    name = engine.lower() if isinstance(engine, str) else engine
    if name is None:
        ctx = try_get_context_execution_engine()
        if ctx is not None:
            return ctx
        inferred = _infer_warehouse(infer_by)
        if inferred is not None:
            if isinstance(inferred, ExecutionEngine):
                return inferred
            name = inferred
        elif device is None:
            device = _infer_device(infer_by)
    if isinstance(name, sqlite3.Connection):
        if device is not None:
            raise ValueError("the host engine over a sqlite3 connection takes no device")
        from ..warehouse import SQLiteExecutionEngine

        return SQLiteExecutionEngine(conf, connection=name)
    if name == "sqlite_torch":
        from ..warehouse import WarehouseTorchExecutionEngine

        return WarehouseTorchExecutionEngine(conf, device=device)
    if name is None or name in DEVICE_ENGINE_NAMES:
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
    raise ValueError(
        f"unknown engine {engine!r}: expected one of {DEVICE_ENGINE_NAMES + HOST_ENGINE_NAMES}"
    )


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
