"""Built-in outputters, copied from ``fugue_tpu/extensions/_builtins/outputters.py``:
``Show``, ``AssertEqual``, ``AssertNotEqual`` and ``Save``."""

from ..._utils.assertion import assert_or_throw
from ...dataframe import DataFrames
from ...dataframe.utils import _df_eq
from ...exceptions import FugueWorkflowError
from ..outputter.outputter import Outputter


class Show(Outputter):
    def process(self, dfs: DataFrames) -> None:
        n = self.params.get("n", 10)
        with_count = self.params.get("with_count", False)
        title = self.params.get_or_none("title", str)
        for i, df in enumerate(dfs.values()):
            df.show(n=n, with_count=with_count, title=title if i == 0 else None)


class AssertEqual(Outputter):
    def process(self, dfs: DataFrames) -> None:
        assert_or_throw(len(dfs) >= 2, FugueWorkflowError("assert_eq requires 2+ inputs"))
        expected = dfs[0]
        for i in range(1, len(dfs)):
            _df_eq(expected, dfs[i], throw=True, **self.params)


class AssertNotEqual(Outputter):
    def process(self, dfs: DataFrames) -> None:
        assert_or_throw(len(dfs) >= 2, FugueWorkflowError("assert_ne requires 2+ inputs"))
        expected = dfs[0]
        for i in range(1, len(dfs)):
            assert_or_throw(
                not _df_eq(expected, dfs[i], **self.params), AssertionError("dataframes are equal")
            )


class Save(Outputter):
    def process(self, dfs: DataFrames) -> None:
        assert_or_throw(len(dfs) == 1, FugueWorkflowError("save takes one input"))
        self.execution_engine.save_df(
            df=dfs[0],
            path=self.params.get_or_throw("path", str),
            format_hint=self.params.get("fmt", "") or None,
            mode=self.params.get("mode", "overwrite"),
            partition_spec=self.partition_spec,
            force_single=self.params.get("single", False),
            **self.params.get("params", dict()),
        )
