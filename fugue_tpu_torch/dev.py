"""Everything needed to develop and extend the port, in one import, copied
from ``fugue_tpu/dev.py``: the engine contract, the annotated-parameter
machinery, the raw SQL and partition collections, RPC, serving and the
workflow internals, each the port's own object. The user-facing surface
is ``fugue_tpu_torch.api``; the plugin hooks are ``fugue_tpu_torch.plugins``.
"""

# flake8: noqa

from .bag.bag import BagDisplay
from .collections.partition import PartitionCursor, PartitionSpec
from .collections.sql import StructuredRawSQL, TempTableName, transpile_sql
from .collections.yielded import PhysicalYielded, Yielded
from .dataframe.function_wrapper import (
    AnnotatedParam,
    DataFrameFunctionWrapper,
    DataFrameParam,
    LocalDataFrameParam,
    fugue_annotated_param,
)
from .dataset import DatasetDisplay
from .execution import ExecutionEngineParam
from .execution.execution_engine import EngineFacet, ExecutionEngine, MapEngine, SQLEngine
from .execution.factory import (
    is_pandas_or,
    make_execution_engine,
    make_sql_engine,
    register_default_execution_engine,
    register_default_sql_engine,
    register_execution_engine,
    register_sql_engine,
)
from .execution.native_execution_engine import NativeExecutionEngine, PandasMapEngine
from .rpc import (
    EmptyRPCHandler,
    RPCClient,
    RPCFunc,
    RPCHandler,
    RPCServer,
    make_rpc_server,
    to_rpc_handler,
)
from .serve import EngineServer, ServeHttpClient, ServeRejected, Submission, SubmissionCanceled
from .sql.dialect import DialectProfile, register_dialect
from .warehouse.profile import WarehouseProfile
from .workflow._workflow_context import FugueWorkflowContext
from .workflow.module import module
from .workflow.workflow import FugueWorkflow, WorkflowDataFrame, WorkflowDataFrames
