"""RPC: the worker→caller callback channel, copied from
``fugue_tpu/rpc/base.py``.

``RPCHandler`` wraps the calling process's callables; ``RPCServer`` hands out
``RPCClient`` stubs that call back into the calling process. ``NativeRPCServer`` is
the in-process implementation, the engine's default (``make_rpc_server``);
``http.py``'s ``HttpRPCServer`` serves the same over HTTP.
"""

import pickle
import uuid
from threading import RLock
from typing import Any, Callable, Dict, Optional

from .._utils.assertion import assert_or_throw
from .._utils.convert import to_type
from .._utils.hash import to_uuid
from .._utils.params import ParamDict
from ..exceptions import FugueInvalidOperation


class RPCClient:
    """Stub callable on workers; routes back to a handler in the calling process."""

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError


class RPCHandler(RPCClient):
    """A callback handler of the calling process, with a start/stop lifecycle."""

    def __init__(self):
        self._lock = RLock()
        self._running = 0

    @property
    def running(self) -> bool:
        return self._running > 0

    def __uuid__(self) -> str:
        return to_uuid(str(type(self)), id(self))

    def start_handler(self) -> None:
        """Subclass hook."""

    def stop_handler(self) -> None:
        """Subclass hook."""

    def start(self) -> "RPCHandler":
        with self._lock:
            if self._running == 0:
                self.start_handler()
            self._running += 1
        return self

    def stop(self) -> None:
        with self._lock:
            if self._running == 1:
                self.stop_handler()
            self._running = max(0, self._running - 1)

    def __enter__(self) -> "RPCHandler":
        assert_or_throw(
            self._running > 0,
            FugueInvalidOperation("use RPCHandler.start() before entering"),
        )
        return self

    def __exit__(self, exc_type: Any, exc_val: Any, exc_tb: Any) -> None:
        self.stop()

    def __getstate__(self) -> Any:
        raise pickle.PicklingError(f"{self} is not serializable")


class EmptyRPCHandler(RPCHandler):
    """The handler representing "no callback"."""

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        raise FugueInvalidOperation("no RPC callback was set")


class RPCFunc(RPCHandler):
    """Wrap a plain callable as a handler (reference ``:197``)."""

    def __init__(self, func: Callable):
        super().__init__()
        assert_or_throw(callable(func), FugueInvalidOperation(f"{func} is not callable"))
        self._func = func

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self._func(*args, **kwargs)


def to_rpc_handler(obj: Any) -> RPCHandler:
    if obj is None:
        return EmptyRPCHandler()
    if isinstance(obj, RPCHandler):
        return obj
    if callable(obj):
        return RPCFunc(obj)
    raise ValueError(f"can't convert {obj} to RPCHandler")


class RPCServer(RPCHandler):
    """Manages handlers and creates worker-side clients (reference ``:105``)."""

    def __init__(self, conf: Any = None):
        super().__init__()
        self._conf = ParamDict(conf)
        self._handlers: Dict[str, RPCHandler] = {}
        self._server_lock = RLock()

    @property
    def conf(self) -> ParamDict:
        return self._conf

    def invoke(self, key: str, *args: Any, **kwargs: Any) -> Any:
        with self._server_lock:
            handler = self._handlers[key]
        return handler(*args, **kwargs)

    def register(self, handler: Any) -> str:
        with self._server_lock:
            key = "_" + str(uuid.uuid4()).split("-")[-1]
            assert_or_throw(key not in self._handlers, FugueInvalidOperation(key))
            self._handlers[key] = to_rpc_handler(handler).start()
            return key

    def make_client(self, handler: Any) -> RPCClient:
        key = self.register(handler)
        return self.create_client(key)

    def create_client(self, key: str) -> RPCClient:
        """Create the serializable stub for a registered handler."""
        raise NotImplementedError

    def start_server(self) -> None:
        """Subclass hook."""

    def stop_server(self) -> None:
        """Subclass hook."""

    def start_handler(self) -> None:
        self.start_server()

    def stop_handler(self) -> None:
        self.stop_server()
        with self._server_lock:
            for h in self._handlers.values():
                h.stop()
            self._handlers.clear()


class NativeRPCClient(RPCClient):
    """In-process client; holds only the key, resolves through the server."""

    def __init__(self, server: "NativeRPCServer", key: str):
        self._key = key
        self._server = server

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self._server.invoke(self._key, *args, **kwargs)

    def __getstate__(self) -> Any:
        raise pickle.PicklingError(f"{self} is not serializable")


class NativeRPCServer(RPCServer):
    """In-process RPC server (reference ``:221``)."""

    def create_client(self, key: str) -> RPCClient:
        return NativeRPCClient(self, key)


def make_rpc_server(conf: Any = None) -> RPCServer:
    """Build the configured RPC server (conf key ``fugue.rpc.server``, a
    class or its dotted name; the in-process server when unset)."""
    conf = ParamDict(conf)
    tp = conf.get_or_none("fugue.rpc.server", object)
    t_server = NativeRPCServer if tp is None else to_type(tp, RPCServer)
    return t_server(conf)  # type: ignore
