from .execution_engine import ExecutionEngine, MapEngine

__all__ = ["ExecutionEngine", "MapEngine"]
