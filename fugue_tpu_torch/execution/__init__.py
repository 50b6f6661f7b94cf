from .execution_engine import ExecutionEngine

__all__ = ["ExecutionEngine"]
