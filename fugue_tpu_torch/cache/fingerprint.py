"""Canonical plan fingerprints, the content address of a task's output,
copied from ``fugue_tpu/cache/fingerprint.py``.

A fingerprint is a recursive md5 over the optimized task DAG: the verb's
kind, its normalized params, the UDF's source, bytecode and closure, the
(inferred) output schema, and the fingerprints of every input. Two runs,
in different processes and days apart, that would compute the same bytes
get the same fingerprint: that is what lets the result cache
(``store.py``) serve one run's output to another. ``engine_kind`` (the
engine's class name) is part of it, so a cache directory shared with the
JAX package never serves one package's artifact to the other.

Soundness over coverage: whatever has no identity that can be taken
statically refuses (``None``) and poisons its consumers: a refused node is
a cache miss, never a wrong hit.

- **Load** sources fingerprint as (path, size, mtime_ns) per matched
  file; a missing path refuses.
- **CreateData** fingerprints small re-readable tables by content
  (pandas, arrow and bounded local frames up to
  ``fugue.tpu.cache.fingerprint_max_bytes``); device frames
  (``TorchDataFrame``), one-pass streams, yielded handles and oversized
  tables refuse: the identity of an object never stands in for the
  identity of its data.
- **UDFs** hash their source (else bytecode), default args and closure
  cells; a UDF marked :func:`non_deterministic`, or one with an RPC
  ``callback``, refuses.
- **Extensions** outside ``fugue_tpu_torch.*`` hash their class source; a
  param whose only representation is an ``at 0x…`` repr refuses.
- **Sample** without an explicit seed refuses; **SaveAndUse** refuses;
  output sinks are never fingerprinted.
- **Custom creators** (anything but Load and CreateData) refuse: they
  read the outside world, and nothing in the plan captures it.
"""

import glob as _glob
import inspect
import os
import textwrap
from hashlib import md5
from typing import Any, Dict, List, Optional

from .._utils.hash import to_uuid
from ..workflow._tasks import CreateTask, FugueTask, OutputTask

__all__ = [
    "FingerprintReport",
    "fingerprint_tasks",
    "non_deterministic",
    "FP_VERSION",
]

# bump to invalidate every existing cache entry on a semantic change to
# the engine or the fingerprint algorithm itself
# v2: fused/segment tasks classify under their own kinds (K_FUSED /
# K_SEGMENT instead of opaque) so delta keys can see chain structure
FP_VERSION = "fugue-tpu-cache-v2"

_NON_DETERMINISTIC_ATTR = "__fugue_non_deterministic__"


def non_deterministic(func: Any) -> Any:
    """Mark a UDF (or extension class) as non-deterministic: the result
    cache will never memoize any task that uses it, nor anything
    downstream of such a task."""
    setattr(func, _NON_DETERMINISTIC_ATTR, True)
    return func


class _Refused(Exception):
    """Internal control flow: this node can't be fingerprinted."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class FingerprintReport:
    """Per-task fingerprints of one (post-optimization) task list.

    ``fps[id(task)]`` is the fingerprint string or ``None`` (refused /
    poisoned); ``reasons`` explains every ``None``; ``source_bytes``
    records the producer-side bytes behind Load/CreateData tasks so the
    planner can report how much a cache cut skipped."""

    def __init__(self) -> None:
        self.fps: Dict[int, Optional[str]] = {}
        self.reasons: Dict[int, str] = {}
        self.source_bytes: Dict[int, int] = {}
        # delta keys: the same recursive hash with every Load's per-file
        # list replaced by its PATH — the identity of "this chain over
        # this source, whatever files it currently holds". Keys the
        # partition manifests of delta.py; None wherever the full
        # fingerprint refused.
        self.delta_fps: Dict[int, Optional[str]] = {}

    def fp(self, task: FugueTask) -> Optional[str]:
        return self.fps.get(id(task))

    def delta_fp(self, task: FugueTask) -> Optional[str]:
        return self.delta_fps.get(id(task))


def fingerprint_tasks(
    tasks: List[FugueTask], conf: Any, engine_kind: str
) -> FingerprintReport:
    """Fingerprint every task of a (post-optimization) DAG in one topo
    pass. ``engine_kind`` partitions the cache per engine class — two
    engines may produce dtype-different results for the same plan, so
    they never share entries. Never raises: refusal is a value."""
    from ..plan.ir import build_graph, infer_schemas

    salt = ""
    max_bytes = 64 * 1024 * 1024
    try:
        from ..constants import (
            FUGUE_CONF_DEFAULT_PARTITIONS,
            FUGUE_TPU_CONF_CACHE_FINGERPRINT_MAX_BYTES,
            FUGUE_TPU_CONF_CACHE_SALT,
        )

        # fugue.default.partitions changes the physical chunking an
        # UN-keyed transformer sees (per-partition UDF semantics), so it
        # is part of every fingerprint
        salt = to_uuid(
            str(conf.get(FUGUE_TPU_CONF_CACHE_SALT, "")),
            str(conf.get(FUGUE_CONF_DEFAULT_PARTITIONS, -1)),
        )
        max_bytes = int(
            conf.get(FUGUE_TPU_CONF_CACHE_FINGERPRINT_MAX_BYTES, max_bytes)
        )
    except Exception:
        pass
    rep = FingerprintReport()
    nodes = build_graph(tasks)
    schemas = infer_schemas(nodes)
    for node in nodes:
        task = node.task
        if task is None:  # synthesized nodes never appear post-emit
            continue
        if isinstance(task, OutputTask):
            rep.fps[id(task)] = None
            rep.reasons[id(task)] = "output sink (side effects run every time)"
            continue
        in_fps = [rep.fps.get(id(d)) for d in task.inputs]
        if any(f is None for f in in_fps):
            rep.fps[id(task)] = None
            rep.reasons[id(task)] = "poisoned by unfingerprintable input"
            continue
        in_delta = [rep.delta_fps.get(id(d)) for d in task.inputs]
        try:
            fp, dfp = _task_fp(
                task,
                node.kind,
                in_fps,  # type: ignore[arg-type]
                None if any(f is None for f in in_delta) else in_delta,
                schemas.get(id(node)),
                salt,
                engine_kind,
                max_bytes,
                rep,
            )
            rep.fps[id(task)] = fp
            rep.delta_fps[id(task)] = dfp
        except _Refused as r:
            rep.fps[id(task)] = None
            rep.reasons[id(task)] = r.reason
        except Exception as ex:  # fingerprinting must never fail a run
            rep.fps[id(task)] = None
            rep.reasons[id(task)] = f"fingerprint error: {type(ex).__name__}"
    return rep


# ---------------------------------------------------------------------------
# per-task fingerprint
# ---------------------------------------------------------------------------


def _task_fp(
    task: FugueTask,
    kind: str,
    in_fps: List[str],
    in_delta_fps: Optional[List[str]],
    schema_names: Optional[List[str]],
    salt: str,
    engine_kind: str,
    max_bytes: int,
    rep: FingerprintReport,
) -> "Any":
    """(full fingerprint, delta key or None). The delta key differs from
    the full fingerprint in exactly one way: every Load source hashes by
    its PATH instead of its per-file (path, size, mtime) list, and inputs
    chain delta keys instead of full fingerprints — so a grown directory
    keeps its delta key while its full fingerprint changes."""
    from ..extensions._builtins import creators as bc
    from ..plan.ir import K_SAMPLE
    from ..plan.passes import _PrunedCreator

    ext = task.extension
    wrapper_cols: Optional[List[str]] = None
    if isinstance(ext, _PrunedCreator):
        # the column-pruning pass wraps the creator; the pruned column
        # list is part of the output's identity (a [k,v] projection and a
        # [s,v] projection of the same table are different results)
        wrapper_cols = list(ext.pruned_columns)
        ext = ext._inner
    if getattr(ext, _NON_DETERMINISTIC_ATTR, False) or getattr(
        type(ext), _NON_DETERMINISTIC_ATTR, False
    ):
        raise _Refused("extension marked non-deterministic")
    common: List[Any] = [
        FP_VERSION,
        engine_kind,
        salt,
        type(task).__name__,
        kind,
        wrapper_cols,
        task.partition_spec,
        schema_names,
        _extension_fp(ext),
    ]
    parts: List[Any] = list(common) + [in_fps]
    delta_parts: Optional[List[Any]] = (
        None if in_delta_fps is None else list(common) + [in_delta_fps]
    )

    def both(token: Any) -> None:
        parts.append(token)
        if delta_parts is not None:
            delta_parts.append(token)

    if isinstance(task, CreateTask):
        if isinstance(ext, bc.Load):
            parts.append(_load_fp(task, rep))
            if delta_parts is not None:
                delta_parts.append(
                    ("delta-source", task.params.get_or_none("path", object))
                )
            both(_params_fp(task, max_bytes, skip=("path",)))
        elif isinstance(ext, bc.CreateData):
            data = task.params.get_or_none("data", object)
            digest, nbytes = _data_fp(data, max_bytes)
            rep.source_bytes[id(task)] = nbytes
            both(digest)
            both(_params_fp(task, max_bytes, skip=("data",)))
        else:
            # arbitrary creators read the OUTSIDE WORLD (files, services,
            # RNGs) — Load and CreateData are the content-addressable
            # creation paths; everything else refuses by design
            raise _Refused(
                f"opaque creator {type(ext).__name__} (external input is "
                "not content-addressable)"
            )
    elif kind == K_SAMPLE:
        if task.params.get_or_none("seed", int) is None:
            raise _Refused("sample without an explicit seed")
        both(_params_fp(task, max_bytes))
    else:
        from ..extensions._builtins import processors as bp

        if isinstance(ext, bp.SaveAndUse):
            raise _Refused("save_and_use writes storage (raw side effect)")
        if isinstance(ext, bp.RunTransformer):
            if task.params.get_or_none("callback", object) is not None:
                raise _Refused("transformer uses an RPC callback")
            both(_udf_fp(task.params.get_or_throw("transformer", object)))
            both(_params_fp(task, max_bytes, skip=("transformer", "callback")))
        else:
            both(_params_fp(task, max_bytes))
    h = md5()
    _feed_safe(h, parts, max_bytes)
    dfp: Optional[str] = None
    if delta_parts is not None:
        dh = md5()
        _feed_safe(dh, ["delta"] + delta_parts, max_bytes)
        dfp = dh.hexdigest()
    return h.hexdigest(), dfp


def _extension_fp(ext: Any) -> str:
    """Identity of the extension CODE plus its instance state (via
    ``__uuid__`` where defined). The port's own extensions are versioned
    by FP_VERSION + class path; anything else hashes its class source so
    an edited user extension invalidates its entries."""
    cls = type(ext)
    base = f"{cls.__module__}.{cls.__qualname__}"
    inst = ""
    if hasattr(cls, "__uuid__"):
        try:
            inst = ext.__uuid__()
        except Exception:
            inst = ""
    if cls.__module__.split(".")[0] in ("fugue_tpu_torch",):
        return to_uuid(base, inst)
    return to_uuid(base, inst, _source_hash_of(cls))


# ---------------------------------------------------------------------------
# sources: Load files and CreateData content
# ---------------------------------------------------------------------------


def _load_fp(task: FugueTask, rep: FingerprintReport) -> List[Any]:
    path = task.params.get_or_none("path", object)
    if not isinstance(path, str) or path == "":
        raise _Refused("load path is not a plain string")
    files: List[str] = []
    if _glob.has_magic(path):
        files = sorted(_glob.glob(path))
    elif os.path.isdir(path):
        for root, _dirs, names in os.walk(path):
            files.extend(os.path.join(root, n) for n in sorted(names))
        files.sort()
    elif os.path.exists(path):
        files = [path]
    if len(files) == 0:
        raise _Refused(f"load source {path} does not exist (yet)")
    out: List[Any] = []
    total = 0
    for f in files:
        st = os.stat(f)
        total += int(st.st_size)
        out.append((f, int(st.st_size), int(st.st_mtime_ns)))
    rep.source_bytes[id(task)] = total
    return out


def _data_fp(data: Any, max_bytes: int) -> Any:
    """Content digest of a CreateData payload, or refusal. Only types
    that can be re-read without consuming them are hashed — identity of
    a one-pass stream or a device frame is NOT identity of its data."""
    import pandas as pd
    import pyarrow as pa

    from ..collections.yielded import Yielded
    from ..dataframe import DataFrame
    from ..dataframe.array_dataframe import ArrayDataFrame
    from ..dataframe.arrow_dataframe import ArrowDataFrame
    from ..dataframe.pandas_dataframe import PandasDataFrame

    if data is None:
        return ("none", 0)
    if isinstance(data, Yielded):
        raise _Refused("yielded handle (depends on another run)")
    if isinstance(data, pa.Table):
        return _arrow_fp(data, max_bytes)
    if isinstance(data, pd.DataFrame):
        return _pandas_fp(data, max_bytes)
    if isinstance(data, DataFrame):
        if data.is_local and not data.is_bounded:
            raise _Refused("one-pass stream input (hashing would consume it)")
        if isinstance(data, ArrowDataFrame):
            return _arrow_fp(data.native, max_bytes)
        if isinstance(data, PandasDataFrame):
            return _pandas_fp(data.native, max_bytes)
        if isinstance(data, ArrayDataFrame):
            return (
                to_uuid(str(data.schema), data.native),
                len(data.native) * max(1, len(data.schema)) * 16,
            )
        raise _Refused(
            f"{type(data).__name__} input (no content digest; identity-of-"
            "object is refused)"
        )
    if isinstance(data, (list, tuple)):
        return (to_uuid(data), len(data) * 16)
    raise _Refused(f"{type(data).__name__} create input")


def _arrow_fp(tbl: "Any", max_bytes: int) -> Any:
    nbytes = int(tbl.nbytes)
    if nbytes > max_bytes:
        raise _Refused(
            f"table of {nbytes} bytes exceeds fingerprint_max_bytes={max_bytes}"
        )
    h = md5()
    h.update(str(tbl.schema).encode())
    h.update(str(tbl.num_rows).encode())
    for col in tbl.columns:
        for chunk in col.chunks:
            # a sliced chunk shares its parent's buffers: offset+length
            # make the digest position-aware (worst case a spurious miss,
            # never a false hit)
            h.update(f"|{chunk.offset}:{len(chunk)}".encode())
            for buf in chunk.buffers():
                if buf is not None:
                    h.update(buf)
    return ("arrow", h.hexdigest()), nbytes


def _pandas_fp(pdf: "Any", max_bytes: int) -> Any:
    import pandas as pd

    nbytes = int(pdf.memory_usage(index=False, deep=False).sum())
    if nbytes > max_bytes:
        raise _Refused(
            f"frame of {nbytes} bytes exceeds fingerprint_max_bytes={max_bytes}"
        )
    h = md5()
    h.update(("|".join(str(c) for c in pdf.columns)).encode())
    h.update(("|".join(str(t) for t in pdf.dtypes)).encode())
    try:
        hashed = pd.util.hash_pandas_object(pdf, index=False)
        h.update(hashed.values.tobytes())
    except Exception:
        raise _Refused("pandas content not hashable")
    return ("pandas", h.hexdigest()), nbytes


# ---------------------------------------------------------------------------
# UDFs and generic params
# ---------------------------------------------------------------------------

_SOURCE_HASH_CACHE: Dict[Any, str] = {}


def _source_hash_of(obj: Any) -> str:
    """Hash of an object's SOURCE (dedented, so moving a function doesn't
    invalidate), falling back to bytecode + consts for callables defined
    in a REPL/exec. The task-uuid layer hashes module+qualname only —
    stable across edits — so this is what makes an EDITED udf miss."""
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
        out = md5(
            code.co_code + repr(code.co_consts).encode() + repr(code.co_names).encode()
        ).hexdigest()
    if key is not None:
        _SOURCE_HASH_CACHE[key] = out
    return out


def _callable_fp(func: Any) -> str:
    """Source + defaults + closure-cell contents: two factory-made UDFs
    sharing source but closing over different values must differ."""
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


def _udf_fp(tf: Any) -> str:
    """Transformer identity: its declared uuid (schema arg + wiring) AND
    the actual code behind it."""
    func = getattr(getattr(tf, "_wrapper", None), "_func", None)
    if func is not None and getattr(func, _NON_DETERMINISTIC_ATTR, False):
        raise _Refused("transformer function marked non-deterministic")
    parts: List[Any] = []
    try:
        parts.append(tf.__uuid__())
    except Exception:
        parts.append(f"{type(tf).__module__}.{type(tf).__qualname__}")
    if func is not None:
        parts.append(_callable_fp(func))
    else:
        parts.append(_source_hash_of(type(tf)))
    return to_uuid(parts)


def _value_token(v: Any, depth: int) -> Any:
    """A deterministic token for one param value, or a refusal. The
    default-object ``… at 0x…`` repr is the tell that a value has no
    stable representation."""
    import pandas as pd
    import pyarrow as pa

    if depth > 6:
        raise _Refused("param nesting too deep")
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, (pd.DataFrame, pa.Table)):
        return _data_fp(v, 64 * 1024 * 1024)
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


def _params_fp(task: FugueTask, max_bytes: int, skip: Any = ()) -> Any:
    out: Dict[str, Any] = {}
    for k, v in task.params.items():
        if k in skip:
            continue
        out[str(k)] = _value_token(v, 0)
    return out


def _feed_safe(h: Any, obj: Any, max_bytes: int) -> None:
    """Feed the (already-tokenized) component list into the digest via
    the deterministic ``to_uuid`` encoding."""
    h.update(to_uuid(obj).encode())
