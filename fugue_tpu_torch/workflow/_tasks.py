"""Workflow tasks, copied from ``fugue_tpu/workflow/_tasks.py``: the
``Create``/``Process``/``Output`` task specs with deterministic uuids
(:85-98), and the checkpoint → broadcast → yield handling of a result
(``set_result`` :143-152). The DAG runner is ``_workflow_context.py``.
``_setup_extension`` binds the engine's RPC server to every extension,
as the JAX package's does."""

import sys
from typing import Any, Callable, Dict, List, Optional

from .._utils.assertion import assert_or_throw
from .._utils.hash import to_uuid
from .._utils.params import ParamDict
from ..collections.partition import PartitionSpec
from ..dataframe import DataFrame, DataFrames
from ..exceptions import FugueWorkflowCompileError
from ..extensions._utils import validate_partition_spec
from ..extensions.creator.creator import Creator
from ..extensions.outputter.outputter import Outputter
from ..extensions.processor.processor import Processor
from ._checkpoint import Checkpoint

_PACKAGE = __name__.split(".")[0]


def _caller_site() -> str:
    """The user-code location where this task was defined (the first frame
    outside the package), added to a failing task's error."""
    f = sys._getframe(2)
    while f is not None:
        if not f.f_globals.get("__name__", "").startswith(_PACKAGE):
            return f"{f.f_code.co_filename}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
    return ""


class FugueTask:
    """One node of the workflow DAG."""

    def __init__(
        self,
        extension: Any,
        params: Any = None,
        partition_spec: Optional[PartitionSpec] = None,
        input_tasks: Optional[List["FugueTask"]] = None,
        input_names: Optional[List[str]] = None,
    ):
        self.extension = extension
        self.params = ParamDict(params)
        self.partition_spec = partition_spec or PartitionSpec()
        self.inputs: List["FugueTask"] = list(input_tasks or [])
        self.input_names = input_names
        self.checkpoint: Checkpoint = Checkpoint()
        self.broadcast_flag = False
        self.yield_dataframe_handler: Optional[Callable[[DataFrame], None]] = None
        self.name = ""
        self._uuid: Optional[str] = None
        self.defined_at = _caller_site()
        # compile-time validation of the partition spec against extension rules
        rules = getattr(extension, "validation_rules", {})
        if rules:
            validate_partition_spec(self.partition_spec, rules)

    @property
    def has_output(self) -> bool:
        return True

    def __uuid__(self) -> str:
        if self._uuid is None:
            self._uuid = to_uuid(
                type(self).__name__,
                getattr(self.extension, "__uuid__", lambda: to_uuid(type(self.extension).__name__))(),
                self._params_uuid(),
                self.partition_spec,
                [t.__uuid__() for t in self.inputs],
            )
        return self._uuid

    def _params_uuid(self) -> str:
        import pandas as pd
        import pyarrow as pa

        safe: Dict[str, Any] = {}
        for k, v in self.params.items():
            if isinstance(v, (pd.DataFrame, pa.Table)):
                # raw frames hash by identity: never cross-run deterministic,
                # so a deterministic checkpoint can't false-hit on different
                # data that shares column names
                safe[k] = to_uuid(repr(type(v)), id(v))
            else:
                try:
                    safe[k] = to_uuid(v)
                except Exception:
                    safe[k] = repr(v)
        return to_uuid(safe)

    def clone_with(
        self,
        extension: Any = None,
        params: Any = None,
        input_tasks: Optional[List["FugueTask"]] = None,
    ) -> "FugueTask":
        """Shallow clone for the plan optimizer (reference ``:111``): same
        checkpoint, yield, broadcast and name, optionally another
        extension, params or inputs, and a fresh uuid. The original task
        is never changed."""
        import copy

        c = copy.copy(self)
        if extension is not None:
            c.extension = extension
        if params is not None:
            c.params = ParamDict(params)
        if input_tasks is not None:
            c.inputs = list(input_tasks)
        c._uuid = None
        return c

    def set_checkpoint(self, checkpoint: Checkpoint) -> None:
        assert_or_throw(
            checkpoint.is_null or self.has_output,
            FugueWorkflowCompileError("output tasks can't have checkpoints"),
        )
        self.checkpoint = checkpoint
        self._uuid = None

    def set_yield_dataframe_handler(self, handler: Callable[[DataFrame], None]) -> None:
        self.yield_dataframe_handler = handler

    def _setup_extension(self, ctx: Any) -> None:
        ext = self.extension
        ext._params = self.params
        ext._workflow_conf = ctx.execution_engine.conf
        ext._execution_engine = ctx.execution_engine
        ext._partition_spec = self.partition_spec
        ext._rpc_server = ctx.execution_engine.rpc_server

    def execute(self, ctx: Any, inputs: List[DataFrame]) -> Optional[DataFrame]:
        raise NotImplementedError

    def set_result(self, ctx: Any, df: DataFrame) -> DataFrame:
        """checkpoint → broadcast → yield (reference ``:143-152``)."""
        df = self.checkpoint.run(df, ctx.checkpoint_path)
        if self.broadcast_flag:
            df = ctx.execution_engine.broadcast(df)
        if self.yield_dataframe_handler is not None:
            self.yield_dataframe_handler(df)
        return df


class CreateTask(FugueTask):
    """0-input creation (reference ``Create:214``)."""

    def __init__(self, creator: Creator, params: Any = None):
        super().__init__(creator, params=params)

    def execute(self, ctx: Any, inputs: List[DataFrame]) -> Optional[DataFrame]:
        self._setup_extension(ctx)
        return self.extension.create()


class ProcessTask(FugueTask):
    """n-input → 1-output (reference ``Process:243``)."""

    def __init__(
        self,
        processor: Processor,
        input_tasks: List[FugueTask],
        params: Any = None,
        partition_spec: Optional[PartitionSpec] = None,
        input_names: Optional[List[str]] = None,
    ):
        super().__init__(
            processor,
            params=params,
            partition_spec=partition_spec,
            input_tasks=input_tasks,
            input_names=input_names,
        )

    def execute(self, ctx: Any, inputs: List[DataFrame]) -> Optional[DataFrame]:
        self._setup_extension(ctx)
        if self.input_names is not None:
            dfs = DataFrames(dict(zip(self.input_names, inputs)))
        else:
            dfs = DataFrames(inputs)
        return self.extension.process(dfs)


class OutputTask(FugueTask):
    """n-input → 0-output sink (reference ``Output:297``)."""

    def __init__(
        self,
        outputter: Outputter,
        input_tasks: List[FugueTask],
        params: Any = None,
        partition_spec: Optional[PartitionSpec] = None,
        input_names: Optional[List[str]] = None,
    ):
        super().__init__(
            outputter,
            params=params,
            partition_spec=partition_spec,
            input_tasks=input_tasks,
            input_names=input_names,
        )

    @property
    def has_output(self) -> bool:
        return False

    def execute(self, ctx: Any, inputs: List[DataFrame]) -> Optional[DataFrame]:
        self._setup_extension(ctx)
        if self.input_names is not None:
            dfs = DataFrames(dict(zip(self.input_names, inputs)))
        else:
            dfs = DataFrames(inputs)
        self.extension.process(dfs)
        return None
