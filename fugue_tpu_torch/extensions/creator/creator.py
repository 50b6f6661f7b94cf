"""Creator, copied from ``fugue_tpu/extensions/creator/creator.py``: an
extension with no input frame and one output frame."""

from ...dataframe import DataFrame
from ..context import ExtensionContext


class Creator(ExtensionContext):
    def create(self) -> DataFrame:
        raise NotImplementedError
