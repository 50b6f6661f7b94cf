"""Frame comparison, join schemas and the zip's blobs, copied from
``fugue_tpu/dataframe/utils.py`` (``_df_eq`` :24, ``serialize_df`` :112,
``deserialize_df`` :143, ``get_temp_df_path`` :154, ``parse_join_type``
:173, ``get_join_schemas`` :196) and trimmed to them."""

import os
import uuid as _uuid
from typing import Any, Iterable, List, Optional, Tuple

import pyarrow as pa

from .._utils.assertion import assert_or_throw
from ..exceptions import FugueDataFrameOperationError
from ..schema import Schema
from .dataframe import DataFrame, LocalBoundedDataFrame

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


def _df_eq(
    df: DataFrame,
    data: Any,
    schema: Any = None,
    check_order: bool = False,
    check_schema: bool = True,
    check_content: bool = True,
    throw: bool = False,
    digits: int = 5,
) -> bool:
    """Whether ``df`` holds ``data`` (a frame, or rows of ``schema``):
    integer widths and float widths count as alike, floats compare
    rounded to ``digits``, and rows in any order unless ``check_order``.
    With ``throw`` a difference raises ``AssertionError``."""
    from .array_dataframe import ArrayDataFrame

    try:
        if isinstance(data, DataFrame):
            expected = data.as_local()
            exp_schema = data.schema
        else:
            exp_schema = Schema(schema) if schema is not None else df.schema
            expected = ArrayDataFrame(data, exp_schema)
        actual = df.as_local()
        if check_schema:
            assert_or_throw(
                df.schema.is_like(
                    exp_schema, equal_groups=[[pa.types.is_integer], [pa.types.is_floating]]
                ),
                lambda: AssertionError(f"schema mismatch: {df.schema} vs {exp_schema}"),
            )
        if check_content:
            a_rows = [_norm_row(r, digits) for r in actual.as_array(type_safe=True)]
            e_rows = [
                _norm_row(r, digits)
                for r in expected.as_array(
                    columns=df.schema.names if not check_schema else None, type_safe=True
                )
            ]
            assert_or_throw(
                len(a_rows) == len(e_rows),
                lambda: AssertionError(f"row count {len(a_rows)} != {len(e_rows)}"),
            )
            if not check_order:
                a_rows = sorted(a_rows, key=repr)
                e_rows = sorted(e_rows, key=repr)
            assert_or_throw(
                a_rows == e_rows,
                lambda: AssertionError(f"content mismatch:\n{a_rows}\nvs\n{e_rows}"),
            )
        return True
    except AssertionError:
        if throw:
            raise
        return False


def _norm_row(row: List[Any], digits: int) -> List[Any]:
    return [_norm_val(v, digits) for v in row]


def _norm_val(v: Any, digits: int) -> Any:
    if isinstance(v, float):
        return round(v, digits)
    if isinstance(v, (list, tuple)):
        return tuple(_norm_val(x, digits) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _norm_val(x, digits)) for k, x in v.items()))
    return v


# ---------------------------------------------------------------------------
# partition serialization (arrow IPC), the zip's blob protocol
# ---------------------------------------------------------------------------


def serialize_df(
    df: Optional[DataFrame], threshold: int = -1, file_path: Optional[str] = None
) -> Optional[bytes]:
    """A local frame as an arrow IPC blob: ``0x00`` and the stream inline,
    or, when ``threshold >= 0`` and the blob is larger, the stream written
    to ``file_path`` and ``0x01`` and the path returned."""
    if df is None:
        return None
    tbl = df.as_arrow()
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as writer:
        writer.write_table(tbl)
    buf = sink.getvalue().to_pybytes()
    blob = b"\x00" + buf
    if threshold < 0 or len(blob) <= threshold:
        return blob
    assert_or_throw(
        file_path is not None,
        FugueDataFrameOperationError("file_path required beyond threshold"),
    )
    with open(file_path, "wb") as f:  # type: ignore[arg-type]
        f.write(buf)
    return b"\x01" + str(file_path).encode()


def deserialize_df(blob: Optional[bytes]) -> Optional[LocalBoundedDataFrame]:
    """The frame ``serialize_df`` wrote, inline or from its file."""
    from .arrow_dataframe import ArrowDataFrame

    if blob is None:
        return None
    kind, payload = blob[:1], blob[1:]
    if kind == b"\x01":
        with open(payload.decode(), "rb") as f:
            payload = f.read()
    with pa.ipc.open_stream(pa.BufferReader(payload)) as reader:
        tbl = reader.read_all()
    return ArrowDataFrame(tbl)


def get_temp_df_path(base_path: str) -> str:
    return os.path.join(base_path, str(_uuid.uuid4()) + ".arrow")
