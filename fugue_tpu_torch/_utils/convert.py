"""Name and annotation helpers, copied from ``fugue_tpu/_utils/convert.py``
and trimmed to what the transformer layer uses: types from objects or
dotted or builtin names (``ignore_errors``), instances of extension
classes, and a function's resolved annotations."""

import builtins
import importlib
import inspect
from typing import Any, Callable, Optional, Type, get_type_hints


def _resolve_name(name: str) -> Any:
    if "." in name:
        mod_name, _, attr = name.rpartition(".")
        try:
            return getattr(importlib.import_module(mod_name), attr)
        except (ImportError, AttributeError):
            pass
    if hasattr(builtins, name):
        return getattr(builtins, name)
    raise ValueError(f"can't resolve {name!r}")


def to_type(obj: Any, base: Type = object) -> Type:
    if isinstance(obj, str):
        obj = _resolve_name(obj)
    if inspect.isclass(obj):
        if not issubclass(obj, base):
            raise TypeError(f"{obj} is not a subclass of {base}")
        return obj
    if isinstance(obj, base):
        return type(obj)
    raise TypeError(f"can't convert {obj!r} to a type of {base}")


def to_instance(obj: Any, base: Type = object) -> Any:
    if isinstance(obj, base) and not inspect.isclass(obj):
        return obj
    return to_type(obj, base)()


def annotation_of(func: Callable, param: Optional[str]) -> Any:
    """The resolved annotation of parameter ``param`` of ``func`` (of its
    return when ``param`` is None)."""
    try:
        hints = get_type_hints(func)
    except Exception:
        hints = getattr(func, "__annotations__", {}) or {}
    return hints.get("return" if param is None else param, inspect.Parameter.empty)
