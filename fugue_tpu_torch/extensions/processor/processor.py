"""Processor, copied from ``fugue_tpu/extensions/processor/processor.py``:
an extension of n input frames and one output frame, run on the driver."""

from ...dataframe import DataFrame, DataFrames
from ..context import ExtensionContext


class Processor(ExtensionContext):
    def process(self, dfs: DataFrames) -> DataFrame:
        raise NotImplementedError
