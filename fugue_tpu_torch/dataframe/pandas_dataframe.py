"""PandasDataFrame, copied from ``fugue_tpu/dataframe/pandas_dataframe.py``
(:77): a local frame over a ``pd.DataFrame`` coerced to its schema, with
the zero-copy wrapper mode (``pandas_df_wrapper=True``) for a caller that
guarantees the dtypes already match (the host map's partitions)."""

from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import pandas as pd
import pyarrow as pa

from .._utils.arrow import pa_table_to_pandas
from ..exceptions import FugueDataFrameInitError
from ..schema import Schema
from .arrow_dataframe import ArrowDataFrame
from .dataframe import DataFrame, LocalBoundedDataFrame


def _enforce_type(pdf: pd.DataFrame, schema: Schema) -> pd.DataFrame:
    """``pdf`` coerced to ``schema``: as it is when every column already
    has its dtype (no copy); otherwise plain numeric and bool conversions
    from NaN-free kinds through ``astype``, and only the columns that need
    real conversion (objects, nullables, datetimes, float → int) through
    arrow (``safe=False``, as the JAX package converts)."""
    expected = schema.pandas_dtype
    names = schema.names
    if list(pdf.columns) == names and all(dt == expected[c] for c, dt in pdf.dtypes.items()):
        return pdf
    idx = pdf.index
    if not (isinstance(idx, pd.RangeIndex) and idx.start == 0 and idx.step == 1):
        pdf = pdf.reset_index(drop=True)
    cols: Dict[str, Any] = {}
    arrow_names: List[str] = []
    for c in names:
        s = pdf[c]
        et = expected[c]
        if s.dtype == et:
            cols[c] = s
        elif (
            isinstance(s.dtype, np.dtype)
            and isinstance(et, np.dtype)
            and et.kind in "iufb"
            and (s.dtype.kind in "iub" or (s.dtype.kind == "f" and et.kind == "f"))
        ):
            cols[c] = s.astype(et)
        else:
            arrow_names.append(c)
    if len(arrow_names) > 0:
        tbl = pa.Table.from_pandas(
            pdf[arrow_names],
            schema=pa.schema([schema.pa_schema.field(c) for c in arrow_names]),
            preserve_index=False,
            safe=False,
        )
        conv = pa_table_to_pandas(tbl)
        for c in arrow_names:
            cols[c] = conv[c]
    return pd.DataFrame({c: cols[c] for c in names})


class PandasDataFrame(LocalBoundedDataFrame):
    """A frame over a ``pd.DataFrame`` (``schema``: coerced to it; None:
    the frame's own; ``df=None``: an empty frame of ``schema``; another
    frame or an iterable of rows: converted)."""

    def __init__(self, df: Any = None, schema: Any = None, pandas_df_wrapper: bool = False):
        s = None if schema is None else (schema if isinstance(schema, Schema) else Schema(schema))
        if df is None:
            if s is None:
                raise FugueDataFrameInitError("schema is required")
            pdf = s.create_empty_pandas_df()
        elif isinstance(df, DataFrame):
            pdf = df.as_pandas()
            s = s or df.schema
        elif isinstance(df, pd.DataFrame):
            idx = df.index
            clean = (
                isinstance(idx, pd.RangeIndex) and (idx.start or 0) == 0 and idx.step == 1
            ) or idx.equals(pd.RangeIndex(len(df)))
            pdf = df if clean else df.reset_index(drop=True)
            if s is None:
                s = Schema(pdf)
        elif isinstance(df, Iterable):
            if s is None:
                raise FugueDataFrameInitError("schema is required")
            pdf = pa_table_to_pandas(ArrowDataFrame(df, s).native)
        else:
            raise FugueDataFrameInitError(f"can't build PandasDataFrame from {type(df)}")
        if not pandas_df_wrapper:
            missing = [c for c in s.names if c not in pdf.columns]
            if len(missing) > 0:
                raise FugueDataFrameInitError(
                    f"columns {missing} in schema {s} not in data {list(pdf.columns)}"
                )
            pdf = _enforce_type(pdf, s)
        self._native = pdf
        super().__init__(s)

    @property
    def native(self) -> pd.DataFrame:
        return self._native

    @property
    def empty(self) -> bool:
        return len(self._native) == 0

    def count(self) -> int:
        return len(self._native)

    def as_pandas(self) -> pd.DataFrame:
        return self._native

    def as_arrow(self) -> pa.Table:
        return pa.Table.from_pandas(
            self._native, schema=self.schema.pa_schema, preserve_index=False, safe=False
        )

    def _select_cols(self, cols: List[str]) -> "PandasDataFrame":
        return PandasDataFrame(self.native[cols], self.schema.extract(cols), pandas_df_wrapper=True)

    def rename(self, columns: Dict[str, str]) -> "PandasDataFrame":
        new_schema = self.schema.rename(columns)
        return PandasDataFrame(self.native.rename(columns=columns), new_schema, pandas_df_wrapper=True)

    def head(self, n: int, columns: Optional[List[str]] = None) -> "PandasDataFrame":
        """The first ``n`` rows (of ``columns``), a pandas frame as in the
        reference (``pandas_dataframe.py:195``)."""
        pdf = self._native if columns is None else self._native[columns]
        schema = self.schema if columns is None else self.schema.extract(columns)
        return PandasDataFrame(pdf.head(n), schema, pandas_df_wrapper=True)

    def peek_array(self) -> List[Any]:
        self.assert_not_empty()
        head = pa.Table.from_pandas(
            self._native.head(1), schema=self.schema.pa_schema, preserve_index=False, safe=False
        )
        return list(head.to_pylist()[0].values())

    def as_array(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> List[List[Any]]:
        # through arrow: NULLs become None and values take the schema's types
        return ArrowDataFrame(self.as_arrow()).as_array(columns)

    def as_array_iterable(
        self, columns: Optional[List[str]] = None, type_safe: bool = False
    ) -> Iterable[List[Any]]:
        yield from ArrowDataFrame(self.as_arrow()).as_array_iterable(columns)
