"""Arrow → pandas conversion that keeps 64-bit integers exact, copied from
``fugue_tpu/_utils/arrow.py``.

Plain ``Table.to_pandas`` widens integer columns holding nulls to float64,
which is lossy past 2^53. Integer columns that hold nulls convert to
pandas' nullable extension dtypes (Int64 etc.) instead; every other column
keeps the default conversion.
"""

import pandas as pd
import pyarrow as pa

_INT_DTYPES = {
    pa.int8(): pd.Int8Dtype(),
    pa.int16(): pd.Int16Dtype(),
    pa.int32(): pd.Int32Dtype(),
    pa.int64(): pd.Int64Dtype(),
    pa.uint8(): pd.UInt8Dtype(),
    pa.uint16(): pd.UInt16Dtype(),
    pa.uint32(): pd.UInt32Dtype(),
    pa.uint64(): pd.UInt64Dtype(),
}


def pa_table_to_pandas(tbl: pa.Table) -> pd.DataFrame:
    """``to_pandas`` with nullable ints kept integral."""
    null_ints = [
        f.name
        for i, f in enumerate(tbl.schema)
        if f.type in _INT_DTYPES and tbl.column(i).null_count > 0
    ]
    if len(null_ints) == 0:
        return tbl.to_pandas(use_threads=False)
    # the extension-dtype mapper applies per arrow TYPE, so null-free int
    # columns are split off first to keep their plain numpy dtypes
    plain = tbl.drop_columns(null_ints).to_pandas(use_threads=False)
    ints = tbl.select(null_ints).to_pandas(use_threads=False, types_mapper=_INT_DTYPES.get)
    out = pd.concat([plain, ints], axis=1)
    return out[[f.name for f in tbl.schema]]
