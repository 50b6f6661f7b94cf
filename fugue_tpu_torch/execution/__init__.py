from ..dataframe.function_wrapper import AnnotatedParam, fugue_annotated_param
from .execution_engine import ExecutionEngine, MapEngine, SQLEngine
from .native_execution_engine import NativeExecutionEngine, PandasMapEngine


# a function may take the engine it runs on (code ``e``: creators,
# processors, outputters), as in ``fugue_tpu/execution/__init__.py``
@fugue_annotated_param(
    code="e", matcher=lambda a: isinstance(a, type) and issubclass(a, ExecutionEngine)
)
class ExecutionEngineParam(AnnotatedParam):
    pass


__all__ = ["ExecutionEngine", "MapEngine", "NativeExecutionEngine", "PandasMapEngine", "SQLEngine"]
