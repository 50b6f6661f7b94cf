"""Engine names, the port's counterpart of ``fugue_tpu/execution/factory.py``
(``make_execution_engine``) trimmed to the port's own engines, resolved
here and registered into nothing: ``None``, ``"torch"`` or ``"cuda"`` is a
new ``TorchExecutionEngine`` on ``device`` (``cuda:0`` unless given);
``"native"`` or ``"pandas"`` is a new host ``NativeExecutionEngine``; an
engine instance is itself."""

from typing import Any

from .execution_engine import ExecutionEngine

DEVICE_ENGINE_NAMES = ("torch", "cuda")
HOST_ENGINE_NAMES = ("native", "pandas")


def make_execution_engine(engine: Any = None, device: Any = None, conf: Any = None) -> ExecutionEngine:
    """The engine that ``engine`` names, on ``device`` (``cuda:0`` unless
    given; with no card, pass ``device="cpu"``) with ``conf``."""
    if isinstance(engine, ExecutionEngine):
        if device is not None or conf is not None:
            raise ValueError("device and conf apply to an engine name, not an engine instance")
        return engine
    name = engine.lower() if isinstance(engine, str) else engine
    if name is None or name in DEVICE_ENGINE_NAMES:
        from ..torch.execution_engine import TorchExecutionEngine

        return TorchExecutionEngine(device=device, conf=conf)
    if name in HOST_ENGINE_NAMES:
        if device is not None:
            raise ValueError(f"the host engine {engine!r} takes no device")
        from .native_execution_engine import NativeExecutionEngine

        return NativeExecutionEngine(conf)
    raise ValueError(
        f"unknown engine {engine!r}: expected one of {DEVICE_ENGINE_NAMES + HOST_ENGINE_NAMES}"
    )


def is_engine_name(name: Any) -> bool:
    return isinstance(name, str) and name.lower() in DEVICE_ENGINE_NAMES + HOST_ENGINE_NAMES
