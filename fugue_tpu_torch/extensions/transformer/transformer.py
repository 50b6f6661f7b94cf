"""Transformer, OutputTransformer, CoTransformer and OutputCoTransformer,
copied from ``fugue_tpu/extensions/transformer/transformer.py`` (:12, :30,
:48, :64): the logic that runs once a logical partition, or once a key
of a zipped frame (``zip``, then ``comap``)."""

from typing import Any

from ...dataframe import ArrayDataFrame, DataFrame, DataFrames, LocalDataFrame
from ..context import ExtensionContext


class Transformer(ExtensionContext):
    """A transformation of each logical partition: ``get_output_schema``
    once on the whole input, ``on_init`` once before the first partition,
    ``transform`` once a partition."""

    def get_output_schema(self, df: DataFrame) -> Any:
        raise NotImplementedError

    def on_init(self, df: DataFrame) -> None:
        pass

    def transform(self, df: LocalDataFrame) -> LocalDataFrame:
        raise NotImplementedError

    @property
    def validation_rules(self) -> dict:
        return {}


class OutputTransformer(Transformer):
    """A transformer run for its side effects: ``process`` once a
    partition, and no output."""

    def get_output_schema(self, df: DataFrame) -> Any:
        from .convert import OUTPUT_TRANSFORMER_DUMMY_SCHEMA

        return OUTPUT_TRANSFORMER_DUMMY_SCHEMA

    def process(self, df: LocalDataFrame) -> None:
        raise NotImplementedError

    def transform(self, df: LocalDataFrame) -> LocalDataFrame:
        self.process(df)
        return ArrayDataFrame([], self.get_output_schema(df))


class CoTransformer(ExtensionContext):
    """A transformation of each key of a zipped frame: ``transform`` gets
    the key's frames, one an input of the zip (an empty frame for a side
    an outer zip leaves without rows)."""

    def get_output_schema(self, dfs: DataFrames) -> Any:
        raise NotImplementedError

    def on_init(self, dfs: DataFrames) -> None:
        pass

    def transform(self, dfs: DataFrames) -> LocalDataFrame:
        raise NotImplementedError

    @property
    def validation_rules(self) -> dict:
        return {}


class OutputCoTransformer(CoTransformer):
    """A cotransformer run for its side effects: ``process`` once a key,
    and no output."""

    def get_output_schema(self, dfs: DataFrames) -> Any:
        from .convert import OUTPUT_TRANSFORMER_DUMMY_SCHEMA

        return OUTPUT_TRANSFORMER_DUMMY_SCHEMA

    def process(self, dfs: DataFrames) -> None:
        raise NotImplementedError

    def transform(self, dfs: DataFrames) -> LocalDataFrame:
        self.process(dfs)
        return ArrayDataFrame([], self.get_output_schema(dfs))
