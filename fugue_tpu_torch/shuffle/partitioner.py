"""Hash bucketing of join and group keys, copied from
``fugue_tpu/shuffle/partitioner.py`` (:52-135): each key column is
normalized to a canonical dtype shared by BOTH sides of an exchange (so
``int64 5`` and ``float64 5.0`` co-bucket exactly as they match by value
in a join), hashed with ``pd.util.hash_pandas_object`` (deterministic
across processes) and taken mod the bucket count. The ids equal the JAX
package's bit for bit: the dist tier concatenates its reduce outputs in
bucket order. The spill partitioner of the same module waits for
ROADMAP.md A.7.
"""

from typing import Any, List, Optional

import numpy as np
import pandas as pd
import pyarrow as pa

__all__ = ["canonical_key_kinds", "bucket_ids"]


def _kind_of(tp: pa.DataType) -> Optional[str]:
    if pa.types.is_dictionary(tp):
        tp = tp.value_type
    if pa.types.is_floating(tp):
        return "f"
    if pa.types.is_integer(tp) or pa.types.is_boolean(tp):
        return "i"
    if pa.types.is_string(tp) or pa.types.is_large_string(tp):
        return "s"
    if pa.types.is_timestamp(tp) or pa.types.is_date(tp):
        return "t"
    return None


def canonical_key_kinds(
    schema1: Any, schema2: Any, keys: List[str]
) -> Optional[List[str]]:
    """Per key column, the canonical hash dtype BOTH sides normalize to
    before hashing — equal-by-value keys must co-bucket even across
    dtypes (int64 ⋈ float64 matches by value in the join kernels). None
    = a key type the partitioner can't hash (decimal, binary, nested):
    the caller refuses and the legacy ladder handles the join."""
    kinds: List[str] = []
    for k in keys:
        k1, k2 = _kind_of(schema1[k].type), _kind_of(schema2[k].type)
        if k1 is None or k2 is None:
            return None
        if k1 == k2:
            kinds.append("f" if k1 == "f" else k1)
        elif {k1, k2} <= {"i", "f"}:
            kinds.append("f")  # value-equality across int/float via float64
        else:
            return None  # string vs numeric etc. — no value equality
    return kinds


def _normalize_key(col: pa.ChunkedArray, kind: str) -> pd.Series:
    """One key column → canonical pandas Series with NULLs filled to a
    fixed value (NULL keys never match, they only need a deterministic
    bucket)."""
    s = col.to_pandas()
    if kind == "f":
        s = pd.to_numeric(s, errors="coerce").astype(np.float64)
        # + 0.0 canonicalizes -0.0 → +0.0 (IEEE): the hash sees float bit
        # patterns, but the join kernels match 0.0 == -0.0 by value, so
        # both must land in the same bucket
        return s.fillna(0.0) + 0.0
    if kind == "i":
        # nullable ints arrive as Int64/object; uint64 wraps into int64
        # deterministically on both sides (bucketing needs consistency,
        # not order)
        s = s.fillna(0)
        return s.astype(np.int64, errors="ignore").astype(np.int64)
    if kind == "t":
        s = pd.to_datetime(s)
        try:
            # tz-aware → the UTC instant, so equal instants co-bucket even
            # when the two sides carry different timezones; tz-naive
            # raises TypeError and keeps its wall-clock int64 view
            s = s.dt.tz_convert("UTC").dt.tz_localize(None)
        except (AttributeError, TypeError):
            pass
        v = s.astype("int64", errors="ignore")
        if v.dtype != np.int64:  # NaT-bearing — view through float64
            return pd.to_numeric(v, errors="coerce").fillna(0.0).astype(np.float64)
        return v
    # strings
    return s.astype("object").where(~s.isna(), "").astype(str)


def bucket_ids(
    tbl: pa.Table, keys: List[str], kinds: List[str], n_buckets: int
) -> np.ndarray:
    """Per-row bucket id for one chunk (uint64 hash of the normalized key
    frame, mod P). Deterministic across processes and chunk boundaries."""
    norm = pd.DataFrame(
        {k: _normalize_key(tbl.column(k), kind) for k, kind in zip(keys, kinds)}
    )
    h = pd.util.hash_pandas_object(norm, index=False).to_numpy()
    return (h % np.uint64(n_buckets)).astype(np.int64)
