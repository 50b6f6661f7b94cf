"""ExtensionContext, copied from ``fugue_tpu/extensions/context.py``: what
a transformer reads while it runs (its params, the engine and its conf,
the output and key schemas, the partition spec and the cursor), and the
RPC callback the engine's server made for it (``fugue_tpu_torch/rpc``)."""

from typing import Any, Dict

from .._utils.params import ParamDict
from ..collections.partition import PartitionCursor, PartitionSpec
from ..rpc import EmptyRPCHandler, RPCClient
from ..schema import Schema


class ExtensionContext:
    @property
    def params(self) -> ParamDict:
        return getattr(self, "_params", ParamDict())

    @property
    def workflow_conf(self) -> ParamDict:
        return getattr(self, "_workflow_conf", ParamDict())

    @property
    def execution_engine(self) -> Any:
        ee = getattr(self, "_execution_engine", None)
        assert ee is not None, "execution_engine is not set"
        return ee

    @property
    def output_schema(self) -> Schema:
        s = getattr(self, "_output_schema", None)
        assert s is not None, "output_schema is not set"
        return s

    @property
    def key_schema(self) -> Schema:
        s = getattr(self, "_key_schema", None)
        assert s is not None, "key_schema is not set"
        return s

    @property
    def partition_spec(self) -> PartitionSpec:
        return getattr(self, "_partition_spec", PartitionSpec())

    @property
    def cursor(self) -> PartitionCursor:
        c = getattr(self, "_cursor", None)
        assert c is not None, "cursor is not set"
        return c

    @property
    def has_callback(self) -> bool:
        cb = getattr(self, "_callback", None)
        return cb is not None and not isinstance(cb, EmptyRPCHandler)

    @property
    def callback(self) -> RPCClient:
        cb = getattr(self, "_callback", None)
        assert cb is not None, "callback is not set"
        return cb

    @property
    def rpc_server(self) -> Any:
        return getattr(self, "_rpc_server", None)

    @property
    def validation_rules(self) -> Dict[str, Any]:
        return {}
