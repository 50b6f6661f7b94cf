"""Built-in creators, copied from ``fugue_tpu/extensions/_builtins/creators.py``:
``Load`` (the engine's ``load_df``) and ``CreateData`` (data, a frame or a
yield as a frame of the engine)."""

from ...collections.yielded import Yielded
from ...dataframe import DataFrame
from ..creator.creator import Creator


class Load(Creator):
    def create(self) -> DataFrame:
        kwargs = self.params.get("params", dict())
        path = self.params.get_or_throw("path", str)
        format_hint = self.params.get("fmt", "")
        columns = self.params.get_or_none("columns", object)
        return self.execution_engine.load_df(
            path=path, format_hint=format_hint or None, columns=columns, **kwargs
        )


class CreateData(Creator):
    def create(self) -> DataFrame:
        data = self.params.get_or_throw("data", object)
        schema = self.params.get_or_none("schema", object)
        if isinstance(data, Yielded):
            return self.execution_engine.load_yielded(data)
        if isinstance(data, DataFrame) and data.is_local and not data.is_bounded and schema is None:
            # a one-pass stream enters the DAG as it is: the verbs that
            # stream (aggregate, join, the keyless compiled map, take,
            # distinct) read it chunk by chunk, any other reads it whole
            return data
        return self.execution_engine.to_df(data, schema=schema)
