from ._checkpoint import Checkpoint, StrongCheckpoint, WeakCheckpoint
from .api import raw_sql
from .factory import build_workflow, is_workflow_factory
from .module import module
from .workflow import FugueWorkflow, FugueWorkflowResult, WorkflowDataFrame, WorkflowDataFrames

__all__ = [
    "Checkpoint",
    "FugueWorkflow",
    "FugueWorkflowResult",
    "StrongCheckpoint",
    "WeakCheckpoint",
    "WorkflowDataFrame",
    "WorkflowDataFrames",
    "build_workflow",
    "is_workflow_factory",
    "module",
    "raw_sql",
]
