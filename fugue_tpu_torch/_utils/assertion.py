"""Assertion helper, copied from ``fugue_tpu/_utils/assertion.py``."""

from typing import Any, Callable, Union


def assert_or_throw(
    cond: bool, exc: Union[None, str, Exception, Callable[[], Any]] = None
) -> None:
    """Raise when ``cond`` is falsy.

    ``exc`` may be a message (→ ``AssertionError``), an exception instance,
    or a zero-arg callable producing either (lazily evaluated so building the
    message is free on the happy path).
    """
    if cond:
        return
    if callable(exc):
        exc = exc()
    if exc is None:
        raise AssertionError()
    if isinstance(exc, Exception):
        raise exc
    raise AssertionError(str(exc))
