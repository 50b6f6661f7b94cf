"""Empty-aware one-pass iterables, copied from ``fugue_tpu/_utils/iter.py``
and trimmed to ``EmptyAwareIterable`` and ``make_empty_aware``: a one-pass
transformer input or output can be asked whether it is empty, and its
first item peeked, without consuming it. Unlike the JAX package's, the
first item is read only when it is asked for, so wrapping a generator
starts no work (a stream's device work runs as it is read)."""

from typing import Any, Generic, Iterable, Iterator, TypeVar

T = TypeVar("T")


class EmptyAwareIterable(Generic[T], Iterable[T]):
    def __init__(self, it: Iterable[T]):
        self._iter = iter(it)
        self._peeked: Any = None
        self._state = "unread"  # "unread", "peeked" or "done"

    def _fill(self) -> None:
        if self._state == "unread":
            try:
                self._peeked = next(self._iter)
                self._state = "peeked"
            except StopIteration:
                self._state = "done"

    @property
    def empty(self) -> bool:
        self._fill()
        return self._state == "done"

    def peek(self) -> T:
        if self.empty:
            raise StopIteration("iterable is empty")
        return self._peeked

    def __iter__(self) -> Iterator[T]:
        try:
            while True:
                self._fill()
                if self._state == "done":
                    return
                item, self._peeked, self._state = self._peeked, None, "unread"
                yield item
        except GeneratorExit:
            # a reader that leaves early closes the source, as it would
            # close a generator it read directly
            close = getattr(self._iter, "close", None)
            if close is not None:
                close()
            raise


def make_empty_aware(it: Iterable[T]) -> EmptyAwareIterable[T]:
    return it if isinstance(it, EmptyAwareIterable) else EmptyAwareIterable(it)
