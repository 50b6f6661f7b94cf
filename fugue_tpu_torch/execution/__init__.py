from .execution_engine import ExecutionEngine, MapEngine
from .native_execution_engine import NativeExecutionEngine, PandasMapEngine

__all__ = ["ExecutionEngine", "MapEngine", "NativeExecutionEngine", "PandasMapEngine"]
