"""Every extensible plugin hook in one namespace, copied from
``fugue_tpu/plugins.py``: backends and user libraries register candidates
on these hooks (``@parse_outputter.candidate(...)``), each the port's own
object."""

from typing import Any, Callable

from .collections.sql import transpile_sql  # noqa: F401
from .dataframe.api import as_fugue_df, get_native_as_df  # noqa: F401
from .dataframe.function_wrapper import fugue_annotated_param  # noqa: F401
from .dataset.api import as_fugue_dataset  # noqa: F401
from .dataset.dataset import get_dataset_display  # noqa: F401
from .execution.factory import (  # noqa: F401
    infer_execution_engine,
    parse_execution_engine,
    register_default_execution_engine,
    register_default_sql_engine,
    register_execution_engine,
    register_sql_engine,
)
from .extensions.creator.convert import parse_creator, register_creator  # noqa: F401
from .extensions.outputter.convert import parse_outputter, register_outputter  # noqa: F401
from .extensions.processor.convert import parse_processor, register_processor  # noqa: F401
from .extensions.transformer.convert import (  # noqa: F401
    parse_output_transformer,
    parse_transformer,
    register_output_transformer,
    register_transformer,
)


def namespace_candidate(namespace: str, matcher: Callable[[str], bool]) -> Callable[..., bool]:
    """A matcher for namespaced string extensions such as ``"viz:bar"``:
    true where the text before the first ``:`` is ``namespace`` and
    ``matcher`` takes the rest."""

    def _m(obj: Any, *args: Any, **kwargs: Any) -> bool:
        if not isinstance(obj, str) or ":" not in obj:
            return False
        ns, expr = obj.split(":", 1)
        return ns == namespace and matcher(expr)

    return _m
