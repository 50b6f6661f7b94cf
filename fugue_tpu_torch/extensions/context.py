"""ExtensionContext, copied from ``fugue_tpu/extensions/context.py``: what
a transformer reads while it runs (its params, the engine and its conf,
the output and key schemas, the partition spec and the cursor). The RPC
callback is not ported (ROADMAP.md A.10): ``has_callback`` is False."""

from typing import Any, Dict

from .._utils.params import ParamDict
from ..collections.partition import PartitionCursor, PartitionSpec
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
        return False

    @property
    def validation_rules(self) -> Dict[str, Any]:
        return {}
