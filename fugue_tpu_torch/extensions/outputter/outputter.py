"""Outputter, copied from ``fugue_tpu/extensions/outputter/outputter.py``:
an extension of n input frames and no output, run on the driver."""

from ...dataframe import DataFrames
from ..context import ExtensionContext


class Outputter(ExtensionContext):
    def process(self, dfs: DataFrames) -> None:
        raise NotImplementedError
