"""The callable fingerprint, copied from ``fugue_tpu/cache/fingerprint.py``
and trimmed to what the UDF analyzer (``fugue_tpu_torch/analysis``) reads:
a UDF's identity as the hash of its source (or bytecode), its default
arguments and its closure cells (``_callable_fp`` :442, ``_source_hash_of``
:415, ``_value_token`` :475), the refusal it raises where an identity
cannot be taken (``_Refused`` :68), and the ``@non_deterministic`` marker
(:57-66).

The result cache that fingerprints whole plans with them waits for
ROADMAP.md A.10: nothing here memoizes a result."""

import inspect
import textwrap
from hashlib import md5
from typing import Any, Dict, List

from .._utils.hash import to_uuid

__all__ = ["non_deterministic"]

_NON_DETERMINISTIC_ATTR = "__fugue_non_deterministic__"

# a pandas or arrow value past this many bytes has no identity taken
_MAX_BYTES = 64 * 1024 * 1024


def non_deterministic(func: Any) -> Any:
    """Mark a UDF (or extension class) as non-deterministic: the analyzer
    refuses it (reason ``non-deterministic``), so it runs as written."""
    setattr(func, _NON_DETERMINISTIC_ATTR, True)
    return func


class _Refused(Exception):
    """This callable or value has no stable identity."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


_SOURCE_HASH_CACHE: Dict[Any, str] = {}


def _source_hash_of(obj: Any) -> str:
    """Hash of an object's source (dedented, so moving a function changes
    nothing), else of its bytecode and constants (a function made by
    ``exec`` or in a REPL): an edited UDF hashes apart."""
    key = obj if isinstance(obj, type) else getattr(obj, "__code__", obj)
    try:
        cached = _SOURCE_HASH_CACHE.get(key)
        if cached is not None:
            return cached
    except TypeError:  # unhashable key
        key = None
    try:
        src = textwrap.dedent(inspect.getsource(obj))
        out = md5(src.encode()).hexdigest()
    except Exception:
        code = getattr(obj, "__code__", None)
        if code is None:
            raise _Refused(f"no source or bytecode for {obj!r}")
        out = md5(code.co_code + repr(code.co_consts).encode() + repr(code.co_names).encode()).hexdigest()
    if key is not None:
        _SOURCE_HASH_CACHE[key] = out
    return out


def _callable_fp(func: Any) -> str:
    """Source + defaults + closure-cell contents: two factory-made UDFs
    sharing source but closing over different values differ."""
    if getattr(func, _NON_DETERMINISTIC_ATTR, False):
        raise _Refused(f"{getattr(func, '__name__', func)!r} marked non-deterministic")
    parts: List[Any] = [_source_hash_of(func)]
    defaults = getattr(func, "__defaults__", None)
    if defaults:
        parts.append([_value_token(v, 0) for v in defaults])
    closure = getattr(func, "__closure__", None)
    if closure:
        parts.append([_value_token(c.cell_contents, 0) for c in closure])
    return to_uuid(parts)


def _value_token(v: Any, depth: int) -> Any:
    """A deterministic token for one value, or a refusal. The default
    ``… at 0x…`` repr is the tell of a value with no stable identity."""
    import pandas as pd
    import pyarrow as pa

    if depth > 6:
        raise _Refused("param nesting too deep")
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, pa.Table):
        return _arrow_fp(v)
    if isinstance(v, pd.DataFrame):
        return _pandas_fp(v)
    if isinstance(v, dict):
        return {str(k): _value_token(x, depth + 1) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        items = list(v)
        if isinstance(v, (set, frozenset)):
            items = sorted(items, key=repr)
        return [_value_token(x, depth + 1) for x in items]
    if hasattr(v, "__uuid__"):
        return v.__uuid__()
    if inspect.isclass(v):
        return f"{v.__module__}.{v.__qualname__}"
    if callable(v):
        return _callable_fp(v)
    r = repr(v)
    if " at 0x" in r:
        raise _Refused(f"param {type(v).__name__} has no stable identity")
    return r


def _arrow_fp(tbl: Any) -> Any:
    nbytes = int(tbl.nbytes)
    if nbytes > _MAX_BYTES:
        raise _Refused(f"table of {nbytes} bytes exceeds fingerprint_max_bytes={_MAX_BYTES}")
    h = md5()
    h.update(str(tbl.schema).encode())
    h.update(str(tbl.num_rows).encode())
    for column in tbl.columns:
        for chunk in column.chunks:
            # a sliced chunk shares its parent's buffers: offset and length
            # make the digest position-aware
            h.update(f"|{chunk.offset}:{len(chunk)}".encode())
            for buf in chunk.buffers():
                if buf is not None:
                    h.update(buf)
    return ("arrow", h.hexdigest()), nbytes


def _pandas_fp(pdf: Any) -> Any:
    import pandas as pd

    nbytes = int(pdf.memory_usage(index=False, deep=False).sum())
    if nbytes > _MAX_BYTES:
        raise _Refused(f"frame of {nbytes} bytes exceeds fingerprint_max_bytes={_MAX_BYTES}")
    h = md5()
    h.update("|".join(str(c) for c in pdf.columns).encode())
    h.update("|".join(str(t) for t in pdf.dtypes).encode())
    try:
        h.update(pd.util.hash_pandas_object(pdf, index=False).values.tobytes())
    except Exception:
        raise _Refused("pandas content not hashable")
    return ("pandas", h.hexdigest()), nbytes
