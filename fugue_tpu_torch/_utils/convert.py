"""Name and annotation helpers, copied from ``fugue_tpu/_utils/convert.py``:
the caller's globals and locals (what ``USING name`` and a transformer
named by a string resolve against), types, functions and instances from
objects or names, and a function's resolved annotations."""

import builtins
import importlib
import inspect
from typing import Any, Callable, Dict, Optional, Tuple, Type, get_type_hints

_PACKAGE = __name__.split(".")[0]


def get_caller_global_local_vars(
    global_vars: Optional[Dict[str, Any]] = None,
    local_vars: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``global_vars`` and ``local_vars`` when either is given; else the
    globals and locals of the first frame up the stack outside this
    package: the user's code, however many of the package's calls lie
    between (``api.fugue_sql`` → ``sql.fugue_sql_flow`` → here)."""
    if global_vars is not None or local_vars is not None:
        return global_vars or {}, local_vars or {}
    g: Dict[str, Any] = {}
    loc: Dict[str, Any] = {}
    frame = inspect.currentframe()
    try:
        f = frame.f_back if frame is not None else None
        while f is not None:
            mod = f.f_globals.get("__name__", "")
            if mod != _PACKAGE and not mod.startswith(_PACKAGE + "."):
                g = dict(f.f_globals)
                loc = dict(f.f_locals)
                break
            f = f.f_back
    finally:
        del frame
    return g, loc


def _resolve_name(
    name: str,
    global_vars: Optional[Dict[str, Any]] = None,
    local_vars: Optional[Dict[str, Any]] = None,
) -> Any:
    if local_vars is not None and name in local_vars:
        return local_vars[name]
    if global_vars is not None and name in global_vars:
        return global_vars[name]
    if "." in name:
        mod_name, _, attr = name.rpartition(".")
        try:
            return getattr(importlib.import_module(mod_name), attr)
        except (ImportError, AttributeError):
            pass
    if hasattr(builtins, name):
        return getattr(builtins, name)
    raise ValueError(f"can't resolve {name!r}")


def to_type(
    obj: Any,
    base: Type = object,
    global_vars: Optional[Dict[str, Any]] = None,
    local_vars: Optional[Dict[str, Any]] = None,
) -> Type:
    if isinstance(obj, str):
        obj = _resolve_name(obj, global_vars, local_vars)
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


def to_function(
    obj: Any,
    global_vars: Optional[Dict[str, Any]] = None,
    local_vars: Optional[Dict[str, Any]] = None,
) -> Callable:
    if isinstance(obj, str):
        obj = _resolve_name(obj, global_vars, local_vars)
    if inspect.isclass(obj):
        raise TypeError(f"{obj} is a class, not a function")
    if callable(obj):
        return obj
    raise TypeError(f"{obj!r} is not callable")


def annotation_of(func: Callable, param: Optional[str]) -> Any:
    """The resolved annotation of parameter ``param`` of ``func`` (of its
    return when ``param`` is None)."""
    try:
        hints = get_type_hints(func)
    except Exception:
        hints = getattr(func, "__annotations__", {}) or {}
    return hints.get("return" if param is None else param, inspect.Parameter.empty)
