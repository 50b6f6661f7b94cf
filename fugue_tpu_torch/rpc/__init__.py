"""The RPC channel of transformer callbacks (``base.py``, and ``http.py``'s
HTTP server), copied from ``fugue_tpu/rpc``."""

from .base import (
    EmptyRPCHandler,
    NativeRPCClient,
    NativeRPCServer,
    RPCClient,
    RPCFunc,
    RPCHandler,
    RPCServer,
    make_rpc_server,
    to_rpc_handler,
)

__all__ = [
    "EmptyRPCHandler",
    "NativeRPCClient",
    "NativeRPCServer",
    "RPCClient",
    "RPCFunc",
    "RPCHandler",
    "RPCServer",
    "make_rpc_server",
    "to_rpc_handler",
]
