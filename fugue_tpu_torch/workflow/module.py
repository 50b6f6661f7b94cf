"""``@module``, copied from ``fugue_tpu/workflow/module.py``: a function
whose first argument is a ``FugueWorkflow`` or a ``WorkflowDataFrame``
adds its tasks to that workflow when called."""

import inspect
from typing import Any, Callable, Optional

from .._utils.assertion import assert_or_throw
from ..exceptions import FugueWorkflowCompileError
from .workflow import FugueWorkflow, WorkflowDataFrame


def module(func: Optional[Callable] = None, as_method: bool = False, name: Optional[str] = None) -> Any:
    """Mark a function as a workflow module.

    The function must take a ``FugueWorkflow`` (or one or more
    ``WorkflowDataFrame``) and may return a ``WorkflowDataFrame``::

        @module
        def create(wf: FugueWorkflow, n: int = 1) -> WorkflowDataFrame:
            return wf.df([[n]], "a:long")

        @module
        def doubled(df: WorkflowDataFrame) -> WorkflowDataFrame:
            return df.transform(double_fn, schema="*")
    """

    def deco(fn: Callable) -> Callable:
        sig = inspect.signature(fn)
        params = list(sig.parameters.values())
        assert_or_throw(
            len(params) > 0,
            FugueWorkflowCompileError("a module needs at least one parameter"),
        )

        def wrapper(*args: Any, **kwargs: Any) -> Any:
            assert_or_throw(
                len(args) > 0
                and isinstance(args[0], (FugueWorkflow, WorkflowDataFrame)),
                FugueWorkflowCompileError(
                    "first argument of a module call must be a FugueWorkflow "
                    "or WorkflowDataFrame"
                ),
            )
            result = fn(*args, **kwargs)
            assert_or_throw(
                result is None or isinstance(result, WorkflowDataFrame),
                FugueWorkflowCompileError(
                    "a module must return a WorkflowDataFrame or None"
                ),
            )
            return result

        wrapper.__name__ = name or fn.__name__
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn  # type: ignore
        return wrapper

    if func is not None:
        return deco(func)
    return deco
