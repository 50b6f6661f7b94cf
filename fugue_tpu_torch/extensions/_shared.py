"""Machinery shared by the extension converters, copied from
``fugue_tpu/extensions/_shared.py``: ``# schema:`` comments
(``comment_block_above``, ``parse_comment_annotation``), the registry of
extension names (``register_transformer("name", f)``), the ``parse_*``
hooks, and the resolution of a name against the registry and the
caller's scope (``USING rescale``).

A ``parse_*`` hook is the JAX package's ``fugue_plugin``
(``fugue_tpu/_utils/registry.py``) trimmed to what the converters use: its
candidates, tried newest first, each a matcher and a function."""

import inspect
import re
from typing import Any, Callable, Dict, List, Optional, Type

from .._utils.convert import get_caller_global_local_vars, to_function, to_type
from ..exceptions import FugueInterfacelessError


def comment_block_above(func: Callable) -> List[str]:
    """The contiguous comment lines directly above a function's ``def``
    (decorators skipped), without their ``#``."""
    try:
        lines, start = inspect.findsource(func)
    except (OSError, TypeError):
        return []
    i = start - 1
    while i >= 0 and lines[i].strip().startswith("@"):
        i -= 1
    block: List[str] = []
    while i >= 0:
        stripped = lines[i].strip()
        if stripped.startswith("#"):
            block.insert(0, stripped[1:].strip())
        elif stripped != "":
            break
        i -= 1
    return block


def parse_comment_annotation(func: Callable, annotation: str = "schema") -> Optional[str]:
    """The value of ``# schema: ...`` (or another annotation) directly above
    a function; the last one wins."""
    pattern = re.compile(r"^" + annotation + r"\s*:(.*)$")
    result: Optional[str] = None
    for line in comment_block_above(func):
        m = pattern.match(line)
        if m is not None:
            result = m.group(1).strip()
    return result


class ExtensionRegistry:
    """Name → extension object or function, for one extension type."""

    def __init__(self, name: str):
        self._name = name
        self._registry: Dict[str, Any] = {}

    def register(self, name: str, extension: Any, on_dup: str = "overwrite") -> None:
        if name in self._registry and on_dup == "throw":
            raise KeyError(f"{name} is already registered as a {self._name}")
        if name in self._registry and on_dup == "ignore":
            return
        self._registry[name] = extension

    def get(self, name: str) -> Optional[Any]:
        return self._registry.get(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._registry


class ParseHook:
    """``hook(obj)``: the first candidate whose matcher takes ``obj``
    turns it into an extension spec; with none, ``obj`` as it is.
    ``@hook.candidate(matcher)`` registers one."""

    def __init__(self) -> None:
        self._candidates: List[Any] = []

    def candidate(self, matcher: Callable[..., bool]) -> Callable[[Callable], Callable]:
        def deco(func: Callable) -> Callable:
            self._candidates.insert(0, (matcher, func))
            return func

        return deco

    def __call__(self, obj: Any) -> Any:
        for matcher, func in self._candidates:
            try:
                ok = matcher(obj)
            except Exception:
                ok = False
            if ok:
                return func(obj)
        return obj


def resolve_extension_object(
    obj: Any,
    registry: ExtensionRegistry,
    base_class: Type,
    global_vars: Optional[Dict[str, Any]],
    local_vars: Optional[Dict[str, Any]],
) -> Any:
    """A name as the registered extension, or the function or class of
    that name in the caller's scope (or a dotted import path); anything
    else as it is."""
    if isinstance(obj, str):
        reg = registry.get(obj)
        if reg is not None:
            return reg
        global_vars, local_vars = get_caller_global_local_vars(global_vars, local_vars)
        try:
            return to_function(obj, global_vars, local_vars)
        except Exception:
            pass
        try:
            return to_type(obj, base_class, global_vars, local_vars)
        except Exception:
            pass
        raise FugueInterfacelessError(f"can't resolve {obj!r}")
    return obj
