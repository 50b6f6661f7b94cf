"""Join schemas, copied from ``fugue_tpu/dataframe/utils.py``
(``parse_join_type`` :173, ``get_join_schemas`` :196) and trimmed to them."""

from typing import Iterable, Optional, Tuple

from .._utils.assertion import assert_or_throw
from ..exceptions import FugueDataFrameOperationError
from ..schema import Schema
from .dataframe import DataFrame

_ALIASES = {
    "full": "full_outer",
    "outer": "full_outer",
    "full_outer": "full_outer",
    "left": "left_outer",
    "right": "right_outer",
    "semi": "left_semi",
    "anti": "left_anti",
    "inner": "inner",
    "cross": "cross",
    "left_outer": "left_outer",
    "right_outer": "right_outer",
    "left_semi": "left_semi",
    "left_anti": "left_anti",
}


def parse_join_type(how: str) -> str:
    """The canonical name of join type ``how`` (case, spaces and aliases
    such as ``"semi"`` or ``"full"`` allowed)."""
    how = how.strip().lower().replace(" ", "_")
    assert_or_throw(
        how in _ALIASES, lambda: NotImplementedError(f"unsupported join type {how}")
    )
    return _ALIASES[how]


def get_join_schemas(
    df1: DataFrame, df2: DataFrame, how: str, on: Optional[Iterable[str]] = None
) -> Tuple[Schema, Schema]:
    """Infer (key_schema, output_schema) for a join
    (reference ``fugue/dataframe/utils.py:152``)."""
    how = parse_join_type(how)
    on = list(on) if on is not None else []
    if how == "cross":
        assert_or_throw(
            len(on) == 0, FugueDataFrameOperationError("cross join can't have keys")
        )
        overlap = set(df1.schema.names) & set(df2.schema.names)
        assert_or_throw(
            len(overlap) == 0,
            lambda: FugueDataFrameOperationError(
                f"cross join with overlapping columns {overlap}"
            ),
        )
        return Schema(), df1.schema + df2.schema
    if len(on) == 0:
        on = [n for n in df1.schema.names if n in df2.schema]
    assert_or_throw(
        len(on) > 0, FugueDataFrameOperationError("join keys can't be empty")
    )
    missing1 = [k for k in on if k not in df1.schema]
    missing2 = [k for k in on if k not in df2.schema]
    assert_or_throw(
        len(missing1) == 0 and len(missing2) == 0,
        lambda: FugueDataFrameOperationError(
            f"join keys missing: {missing1 + missing2}"
        ),
    )
    # all shared columns must be join keys
    shared = set(df1.schema.names) & set(df2.schema.names)
    assert_or_throw(
        shared == set(on),
        lambda: FugueDataFrameOperationError(
            f"shared columns {shared} must all be join keys {on}"
        ),
    )
    key_schema = df1.schema.extract(on)
    if how in ("left_semi", "left_anti"):
        return key_schema, df1.schema.copy()
    out_schema = df1.schema + (df2.schema - on)
    return key_schema, out_schema
