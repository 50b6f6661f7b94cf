"""Workflow factories, copied from ``fugue_tpu/workflow/factory.py``: a
zero-argument callable that builds a fresh ``FugueWorkflow`` each call,
or a built workflow, and the standing views' registration check
(``validate_view_factory``)."""

from typing import Any, Callable


def is_workflow_factory(obj: Any) -> bool:
    """True for the factory form: callable, and not a built workflow
    (which carries ``_tasks``)."""
    return callable(obj) and not hasattr(obj, "_tasks")


def build_workflow(obj: Any) -> Any:
    """A runnable workflow: the factory called, or the workflow as it is."""
    return obj() if is_workflow_factory(obj) else obj


def validate_view_factory(factory: Callable[[], Any]) -> None:
    """Registration gate for a standing view's factory: it must be a
    zero-arg factory (not a built dag), must cloudpickle (it outlives
    this process via the WAL), must build without error, and the built
    workflow must yield at least one dataframe (a view with nothing to
    publish is a misregistration, not a quiet no-op). Raises
    ``ValueError`` with the specific reason."""
    if not callable(factory):
        raise ValueError("view factory is not callable")
    if not is_workflow_factory(factory):
        raise ValueError(
            "view factory is a built workflow; register the zero-arg "
            "factory so each generation rebuilds against the live source"
        )
    try:
        import cloudpickle

        cloudpickle.loads(cloudpickle.dumps(factory))
    except Exception as ex:
        raise ValueError(
            f"view factory does not survive cloudpickle "
            f"({type(ex).__name__}: {ex}); a standing view's factory is "
            f"journaled and replayed across replica restarts"
        ) from ex
    try:
        dag = factory()
    except Exception as ex:
        raise ValueError(
            f"view factory raised while building its workflow "
            f"({type(ex).__name__}: {ex})"
        ) from ex
    if not hasattr(dag, "_tasks"):
        raise ValueError(
            f"view factory returned {type(dag).__name__}, not a "
            f"FugueWorkflow"
        )
    if not getattr(dag, "yields", None):
        raise ValueError(
            "view factory's workflow yields nothing — a view must "
            "yield_dataframe_as(...) the frames it publishes"
        )
