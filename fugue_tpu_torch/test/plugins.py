"""Test-harness plugins, copied from ``fugue_tpu/test/plugins.py``:
backends register a session factory; a suite binds to one with
``@fugue_test_suite("name")``; a single test runs over several with
``@with_backend("native", "torch")``.

The backends are ``native``, ``pandas`` and ``torch`` (in place of the
reference's ``jax``). ``torch`` runs on ``cuda:0`` unless its
``session_conf`` names a device (``{"device": "cpu"}`` on a machine with
no card), which goes to the engine as its ``device``, not its conf.
No pytest plugin is registered for this module: a caller that wants one
marker per backend invokes :func:`pytest_configure` itself.
"""

from contextlib import contextmanager
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterator, List

import pytest

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..execution.execution_engine import ExecutionEngine

_TEST_BACKENDS: Dict[str, "FugueTestBackend"] = {}
_PYTEST_CONFIG: List[Any] = [None]


def _register_marker(name: str) -> None:
    config = _PYTEST_CONFIG[0]
    if config is not None:
        config.addinivalue_line(
            "markers", f"{name}: tests bound to the {name!r} fugue_tpu_torch backend"
        )


def pytest_configure(config: Any) -> None:
    """Register one marker a backend; the config is kept, so backends
    registered later get their markers too."""
    _PYTEST_CONFIG[0] = config
    for name in _TEST_BACKENDS:
        _register_marker(name)


def _make_engine(name: str, session_conf: Dict[str, Any]) -> "ExecutionEngine":
    from ..execution.factory import make_execution_engine

    conf = dict(session_conf)
    device = conf.pop("device", None)
    return make_execution_engine(name, device=device, conf=conf)


class FugueTestBackend:
    """Subclass and register to expose a backend to the test harness."""

    name = ""
    session_conf: Dict[str, Any] = {}

    @classmethod
    @contextmanager
    def session_context(cls) -> Iterator[Any]:
        """A live session object (the engine spec) for the backend."""
        yield cls.name

    @classmethod
    @contextmanager
    def engine_context(cls) -> Iterator["ExecutionEngine"]:
        with cls.session_context() as session:
            engine = _make_engine(session, cls.session_conf)
            try:
                yield engine
            finally:
                engine.stop()


def fugue_test_backend(cls: type) -> type:
    """Class decorator registering a :class:`FugueTestBackend`."""
    assert issubclass(cls, FugueTestBackend) and cls.name != ""
    _TEST_BACKENDS[cls.name] = cls  # type: ignore
    _register_marker(cls.name)
    return cls


def get_test_backend(name: str) -> "FugueTestBackend":
    if name not in _TEST_BACKENDS:
        raise KeyError(f"test backend {name!r} is not registered; have {sorted(_TEST_BACKENDS)}")
    return _TEST_BACKENDS[name]  # type: ignore


def fugue_test_suite(backend: str, mark_test: bool = False) -> Callable[[type], type]:
    """Bind a test-suite class to a backend: adds ``make_engine`` and
    ``backend``."""

    def deco(cls: type) -> type:
        backend_cls = get_test_backend(backend)

        def make_engine(self: Any) -> "ExecutionEngine":
            return _make_engine(backend, backend_cls.session_conf)

        cls.make_engine = make_engine  # type: ignore
        cls.backend = backend  # type: ignore
        if mark_test:
            cls = pytest.mark.__getattr__(backend)(cls)
        return cls

    return deco


def with_backend(*backends: str) -> Callable:
    """Run one test over engines: the test receives ``backend_engine``."""

    def deco(func: Callable) -> Callable:
        @pytest.mark.parametrize("fugue_backend_name", list(backends))
        def wrapper(*args: Any, fugue_backend_name: str, **kwargs: Any) -> Any:
            backend_cls = get_test_backend(fugue_backend_name)
            with backend_cls.engine_context() as engine:
                return func(*args, backend_engine=engine, **kwargs)

        wrapper.__name__ = func.__name__
        return wrapper

    return deco


@fugue_test_backend
class NativeTestBackend(FugueTestBackend):
    name = "native"


@fugue_test_backend
class PandasTestBackend(FugueTestBackend):
    name = "pandas"


@fugue_test_backend
class TorchTestBackend(FugueTestBackend):
    """The torch engine on ``cuda:0``, or on the device its conf names."""

    name = "torch"
