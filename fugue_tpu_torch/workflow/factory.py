"""Workflow factories, copied from ``fugue_tpu/workflow/factory.py``: a
zero-argument callable that builds a fresh ``FugueWorkflow`` each call,
or a built workflow. The view registration check
(``validate_view_factory``) belongs to the serving layer, which is not
ported (ROADMAP.md A.10)."""

from typing import Any


def is_workflow_factory(obj: Any) -> bool:
    """True for the factory form: callable, and not a built workflow
    (which carries ``_tasks``)."""
    return callable(obj) and not hasattr(obj, "_tasks")


def build_workflow(obj: Any) -> Any:
    """A runnable workflow: the factory called, or the workflow as it is."""
    return obj() if is_workflow_factory(obj) else obj
