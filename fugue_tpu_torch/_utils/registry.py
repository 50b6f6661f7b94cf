"""Conditional-dispatch plugins, copied from ``fugue_tpu/_utils/registry.py``.

A *plugin* is a function with registered *candidates*: ``(matcher,
priority, impl)`` triples. Calling the plugin tries the matchers in
priority order (highest first, the later registration wins a tie) and
runs the first that matches; if none does, the decorated default body
runs. The converters' ``parse_*`` hooks (``extensions/_shared.py``
``ParseHook``) and the engine factory's ``parse_execution_engine`` /
``infer_execution_engine`` are such plugins.

Third-party distributions that expose the entry-point group
``fugue_tpu_torch.plugins`` are loaded on the first call of any plugin,
with no explicit import. The group is the port's own: loading the JAX
package's ``fugue_tpu.plugins`` group would import what third parties
registered for that package.
"""

import inspect
from typing import Any, Callable, List, NamedTuple, Optional

from ..exceptions import FuguePluginsRegistrationError

__all__ = [
    "ENTRY_POINT_GROUP",
    "ConditionalDispatcher",
    "fugue_plugin",
    "load_entry_point_plugins",
    "run_at_def",
]

ENTRY_POINT_GROUP = "fugue_tpu_torch.plugins"

_EP_STATE = {"loaded": False}


class _PluginLoadResult(List[str]):
    """Names that loaded this call; per-plugin failures on ``.errors``."""

    def __init__(self, loaded: List[str], errors: List[Any]):
        super().__init__(loaded)
        self.errors = errors


def load_entry_point_plugins(reload: bool = False) -> List[str]:
    """Load every ``fugue_tpu_torch.plugins`` entry point (once).

    Each entry point is imported and, if it resolves to a callable that is
    not a module, called with no arguments. Returns the names that loaded;
    failures are collected on the result's ``.errors`` rather than raised:
    one broken third-party plugin must not take the host down."""
    if _EP_STATE["loaded"] and not reload:
        return _PluginLoadResult([], [])
    _EP_STATE["loaded"] = True  # first: plugin code may call a plugin again
    from importlib.metadata import entry_points

    loaded: List[str] = []
    errors: List[Any] = []
    for ep in entry_points(group=ENTRY_POINT_GROUP):
        try:
            obj = ep.load()
            if callable(obj) and not inspect.ismodule(obj):
                obj()
            loaded.append(ep.name)
        except Exception as e:  # pragma: no cover - depends on bad plugins
            errors.append((ep.name, e))
    return _PluginLoadResult(loaded, errors)


class _Candidate(NamedTuple):
    priority: float
    serial: int
    matcher: Callable[..., bool]
    func: Callable


class ConditionalDispatcher:
    def __init__(self, default_func: Callable, name: Optional[str] = None):
        self._default = default_func
        self._name = name or default_func.__name__
        self._candidates: List[_Candidate] = []
        self._serial = 0
        self.__doc__ = default_func.__doc__
        self.__name__ = self._name
        self.__wrapped__ = default_func

    def candidate(
        self, matcher: Callable[..., bool], priority: float = 1.0
    ) -> Callable[[Callable], Callable]:
        """Register an implementation guarded by ``matcher``."""

        def deco(func: Callable) -> Callable:
            self._serial += 1
            self._candidates.append(_Candidate(priority, self._serial, matcher, func))
            # stable: higher priority first, then the latest registration
            self._candidates.sort(key=lambda c: (-c.priority, -c.serial))
            return func

        return deco

    def register(self, func: Callable, matcher: Callable[..., bool], priority: float = 1.0) -> None:
        self.candidate(matcher, priority)(func)

    def _matches(self, *args: Any, **kwargs: Any):
        if not _EP_STATE["loaded"]:
            load_entry_point_plugins()
        for c in self._candidates:
            try:
                ok = c.matcher(*args, **kwargs)
            except Exception:
                ok = False
            if ok:
                yield c.func

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        for f in self._matches(*args, **kwargs):
            return f(*args, **kwargs)
        return self._default(*args, **kwargs)

    def run_all(self, *args: Any, **kwargs: Any) -> List[Any]:
        """Run every matching candidate and then the default; their results."""
        res = [f(*args, **kwargs) for f in self._matches(*args, **kwargs)]
        res.append(self._default(*args, **kwargs))
        return res

    def has_match(self, *args: Any, **kwargs: Any) -> bool:
        for _ in self._matches(*args, **kwargs):
            return True
        return False


def fugue_plugin(func: Callable) -> ConditionalDispatcher:
    """Declare an extensible hook (the decorated body is the fallback)."""
    if not inspect.isfunction(func):
        raise FuguePluginsRegistrationError(f"{func} is not a function")
    return ConditionalDispatcher(func)


def run_at_def(run_func: Optional[Callable] = None, **kwargs: Any) -> Callable:
    """Run the decorated function once, when it is defined."""

    def deco(func: Callable) -> Callable:
        func(**kwargs)
        return func

    if run_func is None:
        return deco
    return deco(run_func)
