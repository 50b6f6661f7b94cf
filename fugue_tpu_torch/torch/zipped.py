"""The device zip, copied from ``fugue_tpu/jax/zipped.py``: a zipped frame
that holds its input frames on the device instead of arrow IPC blobs.

The blob protocol of the base engine (``execution/execution_engine.py``
``zip``) serializes every key partition of every input into a row. The
JAX engine replaces it by layout: each input is hash-exchanged by the
zip keys, so a key's rows sit on one shard of every frame. On one card
every key's rows are already together, so ``ZippedTorchDataFrame`` holds
the input frames as they are, with the blob protocol's schema and
metadata (and ``"device_zip": True``), and ``comap`` reads them
(``TorchExecutionEngine.comap``). Anything else that reads the frame
builds the blob form once, through the port's host engine
(``_materialize``)."""

from typing import Any, Dict, List, Optional

import pyarrow as pa

from ..collections.partition import PartitionSpec
from ..dataframe import DataFrames, LocalBoundedDataFrame
from ..schema import Schema
from .dataframe import TorchDataFrame

_BLOB_PREFIX = "__fugue_blob__"


class ZippedTorchDataFrame(TorchDataFrame):
    """The result of the device ``zip``: the input frames on the device,
    their names, ``how``, the keys, their schemas and the zip-time
    presort, under the blob protocol's schema (the keys and one binary
    column an input) and metadata."""

    def __init__(
        self,
        frames: List[TorchDataFrame],
        names: List[str],
        named: bool,
        how: str,
        keys: List[str],
        schemas: List[Schema],
        device: Any,
        presort: Optional[Dict[str, bool]] = None,
    ):
        blob_fields = ",".join(f"{_BLOB_PREFIX}{i}:binary" for i in range(len(frames)))
        blob_schema = (
            Schema(str(schemas[0].extract(keys)) + "," + blob_fields)
            if len(keys) > 0
            else Schema(blob_fields)
        )
        super().__init__(
            _internal=dict(device=device, device_cols={}, host_tbl=None, row_count=-1, schema=blob_schema)
        )
        self._zip_frames = frames
        self._zip_names = names
        self._zip_named = named
        self._zip_how = how
        self._zip_keys = keys
        self._zip_schemas = schemas
        # the blob protocol sorts each partition before it serializes it,
        # so the comap replays this order within each key
        self._zip_presort: Dict[str, bool] = dict(presort or {})
        self._mat: Optional[LocalBoundedDataFrame] = None
        self.reset_metadata(
            {
                "serialized": True,
                "serialized_cols": [f"{_BLOB_PREFIX}{i}" for i in range(len(frames))],
                "schemas": [str(s) for s in schemas],
                "serialized_has_name": named,
                "names": names,
                "how": how,
                "keys": keys,
                "device_zip": True,
            }
        )

    @property
    def zip_frames(self) -> List[TorchDataFrame]:
        return self._zip_frames

    def _materialize(self) -> LocalBoundedDataFrame:
        """The blob form, built once by the host engine's zip."""
        if self._mat is None:
            from ..execution.native_execution_engine import NativeExecutionEngine

            local = [f.as_local_bounded() for f in self._zip_frames]
            dfs = DataFrames(dict(zip(self._zip_names, local)) if self._zip_named else local)
            res = NativeExecutionEngine().zip(
                dfs,
                how=self._zip_how,
                partition_spec=PartitionSpec(by=self._zip_keys, presort=self._zip_presort)
                if len(self._zip_keys) > 0
                else None,
            )
            mat = res.as_local_bounded()
            mat.reset_metadata(self.metadata)
            self._mat = mat
        return self._mat

    def count(self) -> int:
        return self._materialize().count()

    @property
    def empty(self) -> bool:
        return all(f.empty for f in self._zip_frames)

    def as_arrow(self) -> pa.Table:
        return self._materialize().as_arrow()

    def as_local_bounded(self) -> LocalBoundedDataFrame:
        return self._materialize()

    def peek_array(self) -> List[Any]:
        return self._materialize().peek_array()

    def __repr__(self) -> str:
        return f"ZippedTorchDataFrame({self._zip_how}, keys={self._zip_keys}, device={self.device})"
