"""Streaming (out-of-core) device execution, the port of
``fugue_tpu/jax/streaming.py``.

A ``TorchDataFrame`` holds every column on the device, which caps a frame
at the card's memory. These paths take a one-pass stream of local frames
(``LocalDataFrameIterableDataFrame`` of pandas or arrow chunks, or
:func:`stream_parquet`) through the device chunk by chunk, so the device
holds O(chunk) rows whatever the stream's length:

- **aggregate**, :func:`streaming_dense_aggregate`: each chunk runs the
  dense groupby kernel (``ops/segment.py``); its tables fold into device
  accumulators, and one O(buckets) transfer finishes on the host;
- **join**, :func:`streaming_hash_join`: a stream against a frame held
  whole; the sorted build keys stay on the device, each chunk's key is
  probed with ``torch.searchsorted``, and payloads are gathered on the
  host (any type, NULLs kept);
- **transform**, :func:`streaming_compiled_map`: a keyless
  ``Dict[str, torch.Tensor]`` UDF per fixed-capacity chunk, its output
  back on the host chunk by chunk, as a one-pass stream;
- **keyed transform**, :func:`streaming_keyed_compiled_map`: keyed UDFs
  over key-clustered streams, re-batched at key boundaries;
- **take**, :func:`streaming_take`, and **distinct**,
  :func:`streaming_distinct`: running top-``n`` and distinct buffers over
  pandas chunks, as in the JAX package (a take with no presort stops
  reading after ``n`` rows).

Chunks of ``fugue.tpu.stream.chunk_rows`` rows (default 2^20) come through
the ingest pipeline (``torch/pipeline.py``). Inside a workflow's run scope
the engine's tuner (``fugue_tpu_torch/tuning``) may resolve a stream's
chunk size from what earlier runs of the plan observed
(:func:`_tuned_chunk_rows`); a learned size also merges undersized source
chunks up to it (:func:`_maybe_coalesce`). ``last_run_stats`` holds the
chunks, rows and peak device bytes of the most recent streaming run: on
CUDA ``torch.cuda.max_memory_allocated`` since the stream started, on the
CPU the bytes of the tensors the stream held at its fullest.

- **zip and comap**, :func:`streaming_zip`, :func:`streaming_comap`:
  key-sorted streams (and bounded frames, sorted on the host) cut into
  batches at the least last key the open inputs have read, each batch
  through the engine's ``zip`` and ``comap``.

- **plan segments** (``plan/lowering.py``): :func:`streaming_fused_steps`
  runs a fused chain inside the chunk producer;
  :func:`plan_streaming_lowered_aggregate` stages each chunk's raw needed
  columns to the device once and runs the chain's predicate and
  projections, the dense kernel and the fold on them;
  :func:`plan_lowered_steps_stream` runs the chain on the device a chunk
  at a time for a take, a distinct or a join probe.

A row stream (``IterableDataFrame``) streams as batches of
``chunk_rows`` rows.
"""

from itertools import islice
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import torch
from torch.profiler import record_function

from .._utils.assertion import assert_or_throw
from ..collections.partition import parse_presort_exp
from ..constants import FUGUE_TPU_CONF_STREAM_CHUNK_ROWS, FUGUE_TPU_CONF_STREAM_KEY_RANGE
from ..dataframe import (
    ArrayDataFrame,
    ArrowDataFrame,
    DataFrame,
    IterableDataFrame,
    LocalBoundedDataFrame,
    LocalDataFrame,
    LocalDataFrameIterableDataFrame,
    PandasDataFrame,
)
from ..exceptions import FugueInvalidOperation
from ..execution.native_execution_engine import _drop_duplicates
from ..schema import Schema
from .dataframe import from_storage, is_wide_unsigned, storage_dtype, to_storage
from .pipeline import HostToDevice, _torch_dtype, engine_prefetcher, stream_depth

DEFAULT_CHUNK_ROWS = 1 << 20

# chunks, rows and peak device bytes of the most recent streaming run
last_run_stats: Dict[str, Any] = {}


def is_stream_frame(df: Any) -> bool:
    """Whether ``df`` is a one-pass stream, of frames or of rows (which
    must not be materialized)."""
    return isinstance(df, (IterableDataFrame, LocalDataFrameIterableDataFrame))


def stream_parquet(
    path: Any, columns: Optional[List[str]] = None, chunk_rows: int = DEFAULT_CHUNK_ROWS
) -> LocalDataFrameIterableDataFrame:
    """Parquet file(s) as a one-pass stream of arrow chunks of at most
    ``chunk_rows`` rows."""
    import pyarrow.parquet as pq

    paths = [path] if isinstance(path, str) else list(path)
    schema = pq.ParquetFile(paths[0]).schema_arrow
    if columns is not None:
        schema = pa.schema([schema.field(c) for c in columns])

    def gen() -> Iterator[LocalDataFrame]:
        for p in paths:
            for batch in pq.ParquetFile(p).iter_batches(batch_size=chunk_rows, columns=columns):
                yield ArrowDataFrame(pa.Table.from_batches([batch]))

    return LocalDataFrameIterableDataFrame(gen(), schema=Schema(schema))


# --------------------------------------------------------------------------
# chunks: a stream frame -> local frames -> numpy columns
# --------------------------------------------------------------------------


def _iter_local_frames(df: Any, chunk_rows: int) -> Iterator[LocalDataFrame]:
    """A stream's local frames; a row stream's rows in batches of
    ``chunk_rows``."""
    if isinstance(df, LocalDataFrameIterableDataFrame):
        yield from df.native
    elif isinstance(df, IterableDataFrame):
        it = iter(df.native)
        while True:
            rows = list(islice(it, chunk_rows))
            if len(rows) == 0:
                return
            yield ArrayDataFrame(rows, df.schema)
    elif isinstance(df, LocalBoundedDataFrame):
        yield df
    else:
        raise FugueInvalidOperation(f"can't stream from {type(df)}")


def _rechunk(frames: Iterable[LocalDataFrame], capacity: int) -> Iterator[LocalDataFrame]:
    """Split oversized chunks so that none exceeds ``capacity`` rows; empty
    chunks drop out, short ones pass."""
    for f in frames:
        n = f.count()
        if n <= capacity:
            if n > 0:
                yield f
            continue
        if isinstance(f, ArrowDataFrame):
            for s in range(0, n, capacity):
                yield ArrowDataFrame(f.native.slice(s, min(capacity, n - s)))
        else:
            pdf = f.as_pandas()
            for s in range(0, n, capacity):
                yield PandasDataFrame(pdf.iloc[s : s + capacity], f.schema)


def _chunk_columns(
    f: LocalDataFrame, names: List[str]
) -> Tuple[int, Dict[str, np.ndarray], Dict[str, int]]:
    """``(rows, {name: numpy}, {name: null count})`` of one chunk. Float
    NULLs come out as NaN (the device NULL); the NULL counts of the other
    columns let the caller refuse them (a streaming plan has no mask)."""
    cols: Dict[str, np.ndarray] = {}
    nulls: Dict[str, int] = {}
    if isinstance(f, ArrowDataFrame):
        tbl = f.native
        for name in names:
            c = tbl.column(name)
            nulls[name] = c.null_count
            cols[name] = np.asarray(c.to_numpy(zero_copy_only=False))
        return tbl.num_rows, cols, nulls
    pdf = f.as_pandas()
    for name in names:
        s = pdf[name]
        # plain numpy columns hold no NULL but NaN, the device's NULL
        plain = isinstance(s.dtype, np.dtype) and s.dtype.kind in "iubf"
        nulls[name] = 0 if plain else int(s.isna().sum())
        cols[name] = s.to_numpy()
    return len(pdf), cols, nulls


def _closing(chunks_it: Any) -> Iterator[Any]:
    """Consume a (possibly prefetched) chunk iterator, stopping its
    producer at the end, on an error, or when the consumer is abandoned."""
    try:
        yield from chunks_it
    finally:
        chunks_it.close()


def _prefetched_pandas_chunks(
    engine: Any, df: Any, verb: str, chunk_rows: Optional[int] = None, tune: Any = None
) -> Any:
    """Chunks decoded to pandas on the producer's thread, for the paths
    whose work starts downstream (the keyed map, take, distinct). The
    chunk size is resolved here unless the caller resolved it."""
    if chunk_rows is None:
        chunk_rows, tune = _tuned_chunk_rows(engine, verb)
    frames = _maybe_coalesce(_iter_local_frames(df, chunk_rows), chunk_rows, tune)
    return engine_prefetcher(engine, (f.as_pandas() for f in frames), verb)


def _tuned_chunk_rows(engine: Any, verb: str) -> Tuple[int, Any]:
    """One stream's chunk size (reference :219): ``fugue.tpu.stream.
    chunk_rows``, or what the tuner learned for this stream of this plan
    inside an enabled run scope. The handle (None outside a scope or with
    tuning off) reaches ``engine_prefetcher`` under the same ``verb``."""
    static = max(int(engine.conf.get(FUGUE_TPU_CONF_STREAM_CHUNK_ROWS, DEFAULT_CHUNK_ROWS)), 1)
    h = engine.tuner.stream_params(verb, static)
    if h is None:
        return static, None
    return max(int(h.chunk_rows), 1), h


def _maybe_coalesce(
    frames: Iterator[LocalDataFrame], target_rows: int, tune: Any
) -> Iterator[LocalDataFrame]:
    """Merge undersized source chunks up to ``target_rows`` where a
    LEARNED chunk size asks for it (reference :240): ``_rechunk`` only
    splits, so a source chunked finer than the learned size would keep
    its per-chunk cost. The static path never merges: its chunks are the
    ones the tuner-less engine made."""
    if tune is None or not tune.coalesce or target_rows <= 0:
        yield from frames
        return
    buf: List[LocalDataFrame] = []
    have = 0
    for f in frames:
        n = f.count()
        if n <= 0:
            continue
        if n >= target_rows and not buf:
            yield f
            continue
        buf.append(f)
        have += n
        if have >= target_rows:
            yield _concat_local(buf)
            buf, have = [], 0
    if buf:
        yield buf[0] if len(buf) == 1 else _concat_local(buf)


def _concat_local(frames: List[LocalDataFrame]) -> LocalDataFrame:
    """One frame from one stream's chunks (one schema)."""
    if all(isinstance(f, ArrowDataFrame) for f in frames):
        return ArrowDataFrame(pa.concat_tables([f.native for f in frames]))
    return PandasDataFrame(
        pd.concat([f.as_pandas() for f in frames], ignore_index=True), frames[0].schema
    )


def _stager(engine: Any, capacity: int, tune: Any = None) -> HostToDevice:
    return HostToDevice(engine.device, capacity, slots=stream_depth(engine, tune) + 1)


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _device_peak_bytes(device: torch.device, held: Iterable[torch.Tensor]) -> int:
    """On CUDA the device's peak since the stream's ``_reset_peak``; on the
    CPU the bytes of ``held``, the tensors the stream holds now."""
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return sum(t.nbytes for t in held)


def _valid_masks(device: torch.device, capacity: int) -> Callable[[int], torch.Tensor]:
    """``valid_for(n)``: the mask of a chunk's first ``n`` of ``capacity``
    rows. Full chunks share one all-valid mask."""
    full: List[torch.Tensor] = []

    def valid_for(n: int) -> torch.Tensor:
        if n < capacity:
            return torch.arange(capacity, device=device) < n
        if not full:
            full.append(torch.ones(capacity, dtype=torch.bool, device=device))
        return full[0]

    return valid_for


# --------------------------------------------------------------------------
# streaming dense aggregate
# --------------------------------------------------------------------------


def _fold_dense_acc(agg_sig: Tuple, acc: Tuple, outs: Tuple) -> Tuple:
    """Merge one chunk's dense tables into the running accumulators: NaN is
    the merge identity of a nullable float (an all-NULL or absent bucket),
    plain adds, min and max otherwise."""
    new = [acc[0] + outs[0]]  # presence counts
    for (_, agg, _, nullable), a, b in zip(agg_sig, acc[1:], outs[1:]):
        if agg == "count":
            new.append(a + b)
        elif agg == "sum":
            if nullable:
                new.append(torch.where(torch.isnan(a), b, torch.where(torch.isnan(b), a, a + b)))
            else:
                new.append(a + b)
        elif agg == "min":
            new.append(torch.fmin(a, b) if nullable else torch.minimum(a, b))
        elif agg == "max":
            new.append(torch.fmax(a, b) if nullable else torch.maximum(a, b))
        else:  # pragma: no cover - the plan admits no other
            raise AssertionError(agg)
    return tuple(new)


def _widen(outs: Tuple) -> Tuple:
    """The first chunk's tables as accumulators: float32 sums (B1's tables)
    accumulate across chunks in float64, as the sorted route sums float32
    (ROADMAP.md C2); the finish casts back to the declared type."""
    return tuple(t.to(torch.float64) if t.dtype == torch.float32 else t for t in outs)


def _finish_dense_host(
    engine: Any, acc: Tuple, agg_sig: Tuple, key: str, key_np: np.dtype, kmin: int, plan: dict
) -> DataFrame:
    """One host transfer of the merged O(buckets) tables, then the host
    finish: the present groups only, avg = sum/count, the declared types."""
    host = [a.cpu().numpy() for a in acc]
    (idx,) = np.nonzero(host[0] > 0)
    merged: Dict[str, Any] = {key: idx.astype(np.int64) + kmin}
    for (name, _, _, _), table in zip(agg_sig, host[1:]):
        merged[name] = table[idx]
    mdf = pd.DataFrame(merged)
    out = pd.DataFrame({key: from_storage(mdf[key].to_numpy().astype(key_np), plan["schema"][key].type)})
    for spec in plan["post"]:
        out[spec["name"]] = spec["fn"](mdf)
    tbl = pa.Table.from_pandas(out, schema=plan["schema"].pa_schema, preserve_index=False, safe=False)
    return engine.to_df(tbl)


def _parse_key_range(conf: Any) -> Optional[Tuple[int, int]]:
    raw = conf.get_or_none(FUGUE_TPU_CONF_STREAM_KEY_RANGE, str)
    if raw is None or raw == "":
        return None
    try:
        lo, hi = (int(x) for x in str(raw).split(","))
    except ValueError:
        raise FugueInvalidOperation(
            f"{FUGUE_TPU_CONF_STREAM_KEY_RANGE} must be 'lo,hi' ints, got {raw!r}"
        )
    assert_or_throw(lo <= hi, ValueError(f"empty key range {raw!r}"))
    return lo, hi


def streaming_dense_aggregate(
    engine: Any, df: Any, partition_spec: Any, agg_cols: List[Any]
) -> Optional[DataFrame]:
    """A keyed aggregate over a one-pass stream with device accumulators.

    Eligibility is decided from the schema alone, before any chunk is
    read: one plain integer key (an unsigned one in its device form),
    numeric values (an unsigned one in its storage; its SUM and AVG
    finish on the host as the in-memory aggregate's do),
    SUM/COUNT/AVG/MIN/MAX. Otherwise this returns None, and the caller
    materializes the stream. The key range comes from
    ``fugue.tpu.stream.key_range`` or the first chunk; a key outside it,
    and a NULL key or int value, raise ``FugueInvalidOperation``."""
    from ..ops.segment import _DENSE_MAX_RANGE, _dense_kernel, dense_buckets
    from .dataframe import TorchDataFrame
    from .execution_engine import _lowerable_posts, _np_dtype, _plain_virtual_array, _plan_device_agg

    keys = list(partition_spec.partition_by) if partition_spec is not None else []
    if len(keys) != 1:
        return None
    device = engine.device
    capacity, tune = _tuned_chunk_rows(engine, "aggregate")
    # the plan of an empty frame of the stream's schema: nothing is read
    tdf0 = TorchDataFrame(Schema(df.schema).create_empty_arrow_table(), device=device)
    plan = _plan_device_agg(tdf0, keys, agg_cols)
    if plan is None or plan["dict_srcs"] or plan["masked_srcs"] or not _lowerable_posts(plan):
        return None
    key = keys[0]
    key_np = _np_dtype(tdf0.device_cols[key].dtype)
    key_type = tdf0.schema[key].type
    if key_np.kind not in ("i", "u"):
        return None
    virtual = plan["virtual"]
    srcs = sorted({virtual[s][1] if s in virtual else s for _, _, s in plan["aggs"]})
    src_np = {s: _np_dtype(tdf0.device_cols[s].dtype) for s in srcs}
    src_type = {s: tdf0.schema[s].type for s in srcs}
    if any(dt.kind not in ("i", "u", "f") for dt in src_np.values()):
        return None
    avals = sorted({s for _, _, s in plan["aggs"]})
    float_val = {s: s not in virtual and src_np[s].kind == "f" for s in avals}
    del tdf0
    key_range = _parse_key_range(engine.conf)
    if key_range is not None and not (0 < key_range[1] - key_range[0] + 1 <= _DENSE_MAX_RANGE):
        return None  # a declared range too wide for the dense plan
    if key_range is not None and is_wide_unsigned(key_type):
        # the declared values in the key's device form (order kept)
        lo, hi = to_storage(np.array(key_range, dtype=np.uint64), key_type).tolist()
        key_range = (int(lo), int(hi))

    # ---- the stream is read from here on: failures raise ----------------
    frames = _rechunk(_maybe_coalesce(_iter_local_frames(df, capacity), capacity, tune), capacity)
    first = next(frames, None)
    if first is None:  # an empty stream: no groups, the declared schema
        return engine.to_df(plan["schema"].create_empty_arrow_table())
    n0, cols0, nulls0 = _chunk_columns(first, [key] + srcs)
    assert_or_throw(
        nulls0[key] == 0,
        FugueInvalidOperation(f"streaming aggregate: NULL in key column {key!r}"),
    )
    # an unsigned key in its device form: its range, buckets and tables
    # are in the storage's order (``torch/dataframe.py`` ``to_storage``)
    cols0[key] = to_storage(cols0[key], key_type)
    probed = key_range is None
    if probed:
        key_range = (int(cols0[key].min()), int(cols0[key].max()))
    kmin, kmax = key_range
    if not (0 < kmax - kmin + 1 <= _DENSE_MAX_RANGE):
        raise FugueInvalidOperation(
            f"streaming aggregate: first-chunk key range [{kmin},{kmax}] exceeds the "
            f"dense plan bound ({_DENSE_MAX_RANGE}); set {FUGUE_TPU_CONF_STREAM_KEY_RANGE} "
            "or pre-bucket the key"
        )
    buckets = dense_buckets(kmax - kmin + 1)
    # value columns dedupe by source; floats are always NaN-aware here: a
    # later chunk may hold NaN where the first did not
    vidx = {s: i for i, s in enumerate(avals)}
    agg_sig = tuple((name, agg, vidx[src], float_val[src]) for name, agg, src in plan["aggs"])
    stager = _stager(engine, capacity, tune)
    valid_for = _valid_masks(device, capacity)

    def put_chunk(n: int, cols: Dict[str, np.ndarray], nulls: Dict[str, int]) -> Any:
        assert_or_throw(
            nulls[key] == 0,
            FugueInvalidOperation(f"streaming aggregate: NULL in key column {key!r}"),
        )
        ck = cols[key]
        lo, hi = int(ck.min()), int(ck.max())
        if lo < kmin or hi > kmax:
            hint = (
                f"probed from the first chunk as [{kmin},{kmax}]; set "
                f"{FUGUE_TPU_CONF_STREAM_KEY_RANGE}='lo,hi' to cover the full stream"
                if probed
                else f"conf {FUGUE_TPU_CONF_STREAM_KEY_RANGE} was [{kmin},{kmax}]"
            )
            raise FugueInvalidOperation(
                f"streaming aggregate: key {key!r} value outside range ([{lo},{hi}] seen): {hint}"
            )
        staged = {key: ck.astype(key_np, copy=False)}
        for s in srcs:
            if src_np[s].kind != "f":
                assert_or_throw(
                    nulls[s] == 0,
                    FugueInvalidOperation(
                        f"streaming aggregate: NULL in non-float column {s!r} (the first "
                        "chunk established a null-free int contract)"
                    ),
                )
            if s != key:  # the key is in its storage already
                staged[s] = to_storage(cols[s], src_type[s]).astype(src_np[s], copy=False)
        return stager.put(staged, n)

    def produce() -> Iterator[Tuple[int, Any]]:
        nonlocal cols0, nulls0, first
        yield n0, put_chunk(n0, cols0, nulls0)
        cols0 = nulls0 = first = None  # drop the head chunk's host copy
        for f in frames:
            n, cols, nulls = _chunk_columns(f, [key] + srcs)
            cols[key] = to_storage(cols[key], key_type)
            yield n, put_chunk(n, cols, nulls)

    def step(t: Dict[str, torch.Tensor], n: int) -> Tuple[torch.Tensor, ...]:
        vals = dict(t)
        for vname, (tag, src) in virtual.items():
            vals[vname] = _plain_virtual_array(tag, t[src], src_type[src])
        return _dense_kernel(buckets, agg_sig, t[key], kmin, [vals[s] for s in avals], valid_for(n))

    return _fold_dense_stream(
        engine, produce(), step, agg_sig, key, key_np, kmin, plan, "aggregate"
    )


def _fold_dense_stream(
    engine: Any,
    chunks: Iterator[Tuple[int, Any]],
    step: Callable[[Dict[str, torch.Tensor], int], Tuple[torch.Tensor, ...]],
    agg_sig: Tuple,
    key: str,
    key_np: np.dtype,
    kmin: int,
    plan: dict,
    verb: str,
) -> DataFrame:
    """The consumer of a streaming dense aggregate: each staged chunk's
    dense tables (``step``) fold into the device accumulators, then one
    O(buckets) transfer finishes on the host. ``last_run_stats`` gets the
    chunks, rows and peak device bytes."""
    device = engine.device
    stats = {"chunks": 0, "rows": 0, "peak_device_bytes": 0}
    _reset_peak(device)
    acc: Any = None
    pending: List[Any] = []  # events of chunks whose kernels may still run
    for n, chunk in _closing(engine_prefetcher(engine, chunks, verb)):
        t = chunk.tensors()
        outs = step(t, n)
        acc = _widen(outs) if acc is None else _fold_dense_acc(agg_sig, acc, outs)
        stats["chunks"] += 1
        stats["rows"] += n
        stats["peak_device_bytes"] = max(
            stats["peak_device_bytes"], _device_peak_bytes(device, [*acc, *t.values()])
        )
        if device.type == "cuda":
            # nothing here reads the device, so bound the chunks in flight
            # on the stream, not only those in the queue
            pending.append(torch.cuda.Event())
            pending[-1].record()
            if len(pending) > 2:
                pending.pop(0).synchronize()
        del t, outs, chunk
    res = _finish_dense_host(engine, acc, agg_sig, key, key_np, kmin, plan)
    stats["peak_device_bytes"] = max(
        stats["peak_device_bytes"], _device_peak_bytes(device, acc)
    )
    global last_run_stats
    last_run_stats = dict(stats, verb=verb)
    return res


# --------------------------------------------------------------------------
# streaming broadcast-hash join
# --------------------------------------------------------------------------


def _key_image(a: np.ndarray) -> np.ndarray:
    """A key array ``torch.searchsorted`` takes, in the same order: uint64
    as its int64 bits with the top bit flipped (``ops/shuffle.py``
    ``unsigned_order``), the narrower unsigned types widened to int64."""
    if a.dtype.kind != "u":
        return a
    if a.dtype.itemsize < 8:
        return a.astype(np.int64)
    return np.ascontiguousarray(a).view(np.int64) ^ np.int64(-(1 << 63))


def streaming_hash_join(
    engine: Any, df1: Any, df2: Any, how: str, on: Optional[List[str]] = None
) -> Optional[DataFrame]:
    """A one-pass stream joined with a frame held whole (the build side),
    with a bounded device working set.

    The build side is sorted by its key, and the sorted key goes to the
    device. Each stream chunk's key goes to the device (through the ingest
    pipeline) and is probed with ``torch.searchsorted``; ``(hit, pos)``
    come back, and the payloads of both sides are gathered on the host
    with pandas, so they keep any type and their NULLs. NULL and NaN
    stream keys never match, and stay on an outer join.

    Eligible: exactly one side is a stream; the join is inner, or the
    outer side is the stream; one numeric key of one type on both sides;
    unique, non-NULL build keys. Otherwise this returns None and the caller
    materializes the stream."""
    from ..dataframe.utils import get_join_schemas, parse_join_type

    jt = parse_join_type(how)
    s1, s2 = is_stream_frame(df1), is_stream_frame(df2)
    if s1 == s2:
        return None
    stream_df, build_df = (df1, df2) if s1 else (df2, df1)
    if not (jt == "inner" or (jt == "left_outer" and s1) or (jt == "right_outer" and s2)):
        return None
    key_schema, out_schema = get_join_schemas(df1, df2, how=jt, on=on)
    if len(key_schema) != 1:
        return None
    key = key_schema.names[0]
    ktype = stream_df.schema[key].type
    if not (pa.types.is_integer(ktype) or pa.types.is_floating(ktype)):
        return None
    if build_df.schema[key].type != ktype:
        # a cast of the probe key (float -> int) would truncate values into
        # false matches; equality across types is the general path's
        return None
    outer = jt != "inner"
    bpdf = build_df.as_pandas()
    if len(bpdf) > 0 and bpdf[key].isna().any():
        return None  # NULL build keys: the general path's
    key_np = np.dtype(ktype.to_pandas_dtype())
    bkeys = bpdf[key].to_numpy().astype(key_np, copy=False)
    order = np.argsort(bkeys, kind="stable")
    bsorted = bkeys[order]
    if len(bsorted) > 1 and (bsorted[1:] == bsorted[:-1]).any():
        return None  # duplicates need the 1:N expansion
    n_build = len(bkeys)
    payload_names = [n for n in build_df.schema.names if n != key]
    device = engine.device
    capacity, tune = _tuned_chunk_rows(engine, "join")

    if n_build == 0 and not outer:
        # inner with an empty build side: empty, and the stream stays unread
        return engine.to_df(out_schema.create_empty_arrow_table())

    # the sorted payload on the host; nullable dtypes on an outer join, so
    # the misses' NULLs keep their declared types
    bs = bpdf.iloc[order].reset_index(drop=True)
    if outer:
        bs = pd.DataFrame({n: bs[n].convert_dtypes() for n in payload_names})
    bk_dev = torch.from_numpy(np.ascontiguousarray(_key_image(bsorted))).to(device)

    def produce(stager: HostToDevice) -> Iterator[Tuple[int, Any]]:
        for f in _rechunk(
            _maybe_coalesce(_iter_local_frames(stream_df, capacity), capacity, tune), capacity
        ):
            pf = f.as_pandas().reset_index(drop=True)
            n = len(pf)
            if n_build == 0:  # outer with an empty build side: no probe
                yield n, pf, None
                continue
            s = pf[key]
            knull = s.isna().to_numpy()
            cols = {"k": _key_image((s.fillna(0) if knull.any() else s).to_numpy(dtype=key_np))}
            if knull.any():
                cols["valid"] = ~knull
            yield n, pf, stager.put(cols, n)

    def gen() -> Iterator[LocalDataFrame]:
        stats = {"chunks": 0, "rows": 0, "peak_device_bytes": 0}
        _reset_peak(device)
        valid_for = _valid_masks(device, capacity)
        chunks = engine_prefetcher(engine, produce(_stager(engine, capacity, tune)), "join")
        for n, pf, chunk in _closing(chunks):
            stats["chunks"] += 1
            stats["rows"] += n
            if chunk is None:
                data = {
                    nm: pf[nm] if nm in pf.columns else pd.Series([pd.NA] * n).convert_dtypes()
                    for nm in out_schema.names
                }
                yield PandasDataFrame(pd.DataFrame(data), out_schema)
                continue
            t = chunk.tensors()
            pk = t["k"]
            valid = t["valid"] if "valid" in t else valid_for(n)
            idx = torch.searchsorted(bk_dev, pk).clamp_(0, n_build - 1)
            hit_d = (bk_dev[idx] == pk) & valid  # NaN keys never match
            hit = hit_d[:n].cpu().numpy()
            pos = idx[:n].cpu().numpy()
            stats["peak_device_bytes"] = max(
                stats["peak_device_bytes"],
                _device_peak_bytes(device, [bk_dev, *t.values(), valid, idx, hit_d]),
            )
            del t, pk, valid, idx, hit_d, chunk
            data = {}
            if outer:
                hit_s = pd.Series(hit)
                for nm in out_schema.names:
                    if nm in pf.columns:
                        data[nm] = pf[nm]
                    else:
                        data[nm] = bs[nm].take(pos).reset_index(drop=True).where(hit_s)
            elif hit.all():
                # every row hit (the dimension-table norm): rows pass as they are
                for nm in out_schema.names:
                    data[nm] = pf[nm] if nm in pf.columns else bs[nm].take(pos).reset_index(drop=True)
            else:
                (sel,) = np.nonzero(hit)
                for nm in out_schema.names:
                    if nm in pf.columns:
                        data[nm] = pf[nm].take(sel).reset_index(drop=True)
                    else:
                        data[nm] = bs[nm].take(pos[sel]).reset_index(drop=True)
            yield PandasDataFrame(pd.DataFrame(data), out_schema)
        global last_run_stats
        last_run_stats = dict(stats, verb="join")

    return LocalDataFrameIterableDataFrame(gen(), schema=out_schema)


# --------------------------------------------------------------------------
# streaming compiled map
# --------------------------------------------------------------------------


def _stream_np_dtypes(schema: Schema, what: str) -> Dict[str, np.dtype]:
    """The numpy dtype of each column, which must be numeric or bool."""
    out: Dict[str, np.dtype] = {}
    for f in schema.fields:
        if not (pa.types.is_integer(f.type) or pa.types.is_floating(f.type)
                or pa.types.is_boolean(f.type)):
            raise FugueInvalidOperation(
                f"{what} needs numeric/bool columns; {f.name} is {f.type} "
                "(use a pandas-annotated transformer)"
            )
        out[f.name] = np.dtype(f.type.to_pandas_dtype())
    return out


def streaming_compiled_map(
    engine: Any, df: Any, fn: Callable, output_schema: Schema
) -> DataFrame:
    """A keyless ``Dict[str, torch.Tensor]`` UDF over a one-pass stream,
    chunk by chunk.

    Each chunk is padded to a fixed capacity with ``__valid__`` marking its
    rows (the contract of the in-memory keyless map; full chunks share one
    all-valid mask); each output chunk comes back to the host, so the
    result is a one-pass ``LocalDataFrameIterableDataFrame`` and the device
    holds O(chunk) rows end to end."""
    from .execution_engine import _select_output
    from .group_ops import VALID

    device = engine.device
    capacity, tune = _tuned_chunk_rows(engine, "map")
    np_dtypes = _stream_np_dtypes(Schema(df.schema), "streaming compiled map")
    names = list(np_dtypes)
    out_schema = Schema(output_schema)
    out_np = {f.name: np.dtype(f.type.to_pandas_dtype()) for f in out_schema.fields}

    def produce(stager: HostToDevice) -> Iterator[Tuple[int, Any]]:
        for f in _rechunk(_maybe_coalesce(_iter_local_frames(df, capacity), capacity, tune), capacity):
            n, cols, nulls = _chunk_columns(f, names)
            for c in names:
                if np_dtypes[c].kind != "f":
                    assert_or_throw(
                        nulls[c] == 0,
                        FugueInvalidOperation(f"streaming compiled map: NULL in non-float column {c!r}"),
                    )
            yield n, stager.put({c: cols[c].astype(np_dtypes[c], copy=False) for c in names}, n)

    def gen() -> Iterator[LocalDataFrame]:
        stats = {"chunks": 0, "rows": 0, "peak_device_bytes": 0}
        _reset_peak(device)
        valid_for = _valid_masks(device, capacity)
        chunks = engine_prefetcher(engine, produce(_stager(engine, capacity, tune)), "map")
        for n, chunk in _closing(chunks):
            cols = dict(chunk.tensors())
            cols[VALID] = valid_for(n)
            with record_function("fugue::udf"):
                out = _select_output(fn(cols), out_schema, exclude=(VALID,))
            assert_or_throw(
                all(v.shape[0] == capacity for v in out.values()),
                FugueInvalidOperation(
                    "streaming compiled transformers must return row-aligned arrays "
                    "(padding preserved; reductions must mask with __valid__)"
                ),
            )
            host = {c: out[c][:n].cpu().numpy().astype(out_np[c], copy=False) for c in out_np}
            stats["chunks"] += 1
            stats["rows"] += n
            stats["peak_device_bytes"] = max(
                stats["peak_device_bytes"],
                _device_peak_bytes(device, [*cols.values(), *out.values()]),
            )
            del cols, out, chunk
            yield PandasDataFrame(pd.DataFrame(host), out_schema)
        global last_run_stats
        last_run_stats = dict(stats, verb="map")

    return LocalDataFrameIterableDataFrame(gen(), schema=out_schema)


# --------------------------------------------------------------------------
# streaming keyed compiled map
# --------------------------------------------------------------------------


def streaming_keyed_compiled_map(
    engine: Any, df: Any, fn: Callable, output_schema: Schema, partition_spec: Any
) -> DataFrame:
    """A keyed ``Dict[str, torch.Tensor]`` UDF over a key-clustered
    one-pass stream.

    The rows of one key must be contiguous in the stream. Chunks re-batch
    at key boundaries (the trailing key's rows carry into the next batch,
    so no group is split), and each batch of at most the chunk capacity
    runs the in-memory keyed map (``TorchMapEngine._compiled_keyed_map``).
    A key that comes back after its batch closed raises, as do a run of
    one key longer than the capacity, a NULL/NaN key and a column that is
    not numeric or bool."""
    from .dataframe import frame_from_numpy

    keys = list(partition_spec.partition_by)
    in_schema = Schema(df.schema)
    np_dtypes = _stream_np_dtypes(in_schema, "streaming keyed compiled map")
    device = engine.device
    capacity, tune = _tuned_chunk_rows(engine, "keyed_map")
    out_schema = Schema(output_schema)
    map_engine = engine.map_engine
    names = list(in_schema.names)

    def run_batch(batch: pd.DataFrame, closed: set) -> Tuple[pd.DataFrame, int]:
        uk = set(map(tuple, batch[keys].drop_duplicates().itertuples(index=False, name=None)))
        overlap = uk & closed
        assert_or_throw(
            len(overlap) == 0,
            FugueInvalidOperation(
                "streaming keyed map: the stream is not key-clustered — key(s) "
                f"{sorted(overlap)[:3]} reappeared after their rows were already "
                f"processed. Sort/cluster the stream by {keys} first."
            ),
        )
        closed |= uk
        k = len(batch)
        assert_or_throw(
            k <= capacity,
            FugueInvalidOperation(
                f"streaming keyed map: a contiguous key run ({k} rows) exceeds the chunk "
                f"capacity ({capacity}); raise {FUGUE_TPU_CONF_STREAM_CHUNK_ROWS}"
            ),
        )
        cols: Dict[str, np.ndarray] = {}
        for c in names:
            s = batch[c]
            assert_or_throw(
                np_dtypes[c].kind == "f" or not s.isna().any(),
                FugueInvalidOperation(f"streaming keyed map: NULL in non-float column {c!r}"),
            )
            cols[c] = s.to_numpy().astype(np_dtypes[c])
        tdf = frame_from_numpy(cols, in_schema, device=device)
        res = map_engine._compiled_keyed_map(tdf, fn, out_schema, partition_spec)
        # the input and output batches are both alive here
        peak = _device_peak_bytes(
            device, [*tdf.device_cols.values(), *res.device_cols.values()]
        )
        return res.as_pandas(), peak

    def gen() -> Iterator[LocalDataFrame]:
        stats = {"chunks": 0, "rows": 0, "peak_device_bytes": 0}
        _reset_peak(device)
        carry: Optional[pd.DataFrame] = None
        closed: set = set()

        def emit(batch: pd.DataFrame) -> Iterator[LocalDataFrame]:
            for sub in _key_aligned_splits(batch, keys, capacity):
                out, peak = run_batch(sub, closed)
                stats["peak_device_bytes"] = max(stats["peak_device_bytes"], peak)
                yield PandasDataFrame(out, out_schema)

        for pf in _closing(_prefetched_pandas_chunks(engine, df, "keyed_map", capacity, tune)):
            stats["chunks"] += 1
            stats["rows"] += len(pf)
            merged = pf if carry is None or len(carry) == 0 else pd.concat(
                [carry, pf], ignore_index=True
            )
            if len(merged) == 0:
                carry = None
                continue
            assert_or_throw(
                not merged[keys].isna().any().any(),
                FugueInvalidOperation(
                    "streaming keyed map: NULL/NaN partition keys are not supported (NaN "
                    "breaks key-run detection); filter or fill the key column first"
                ),
            )
            eq_last = (merged[keys] == merged[keys].iloc[-1].values).all(axis=1).to_numpy()
            if eq_last.all():
                # one key so far: keep it, but fail once the run cannot fit
                assert_or_throw(
                    len(merged) <= capacity,
                    FugueInvalidOperation(
                        f"streaming keyed map: a contiguous key run ({len(merged)}+ rows) "
                        f"exceeds the chunk capacity ({capacity}); raise "
                        f"{FUGUE_TPU_CONF_STREAM_CHUNK_ROWS}"
                    ),
                )
                carry = merged
                continue
            tail = int(np.argmin(eq_last[::-1]))  # the trailing run's length
            carry = merged.iloc[len(merged) - tail :].reset_index(drop=True)
            yield from emit(merged.iloc[: len(merged) - tail])
        if carry is not None and len(carry) > 0:
            yield from emit(carry)
        global last_run_stats
        last_run_stats = dict(stats, verb="keyed_map")

    return LocalDataFrameIterableDataFrame(gen(), schema=out_schema)


# --------------------------------------------------------------------------
# streaming take / distinct
# --------------------------------------------------------------------------


def streaming_take(
    engine: Any, df: Any, n: int, presort: Any, na_position: str = "last", partition_spec: Any = None
) -> DataFrame:
    """``take`` over a one-pass stream with a bounded working set, as the
    JAX package's (``jax/streaming.py`` :1514):

    - no presort, no keys: read until ``n`` rows, then stop (the stream's
      tail is never read; closing the pipeline stops its read-ahead);
    - a presort: a running top-``n`` buffer, merged a chunk at a time;
    - partition keys: a running head of ``n`` rows a key.

    Rows move in host pandas a chunk at a time: a take's output is
    O(n × keys)."""
    sorts = parse_presort_exp(presort) if presort else (
        partition_spec.presort if partition_spec is not None else {}
    )
    keys = list(partition_spec.partition_by) if partition_spec is not None else []
    names, asc = list(sorts.keys()), list(sorts.values())
    schema = Schema(df.schema)
    buf: Optional[pd.DataFrame] = None
    stats = {"chunks": 0, "rows": 0, "peak_device_bytes": 0}
    chunks_it = _prefetched_pandas_chunks(engine, df, "take")
    try:
        for pf in chunks_it:
            stats["chunks"] += 1
            stats["rows"] += len(pf)
            buf = pf if buf is None else pd.concat([buf, pf], ignore_index=True)
            if len(names) > 0:
                buf = buf.sort_values(names, ascending=asc, na_position=na_position, kind="stable")
            if len(keys) == 0:
                buf = buf.head(n)
                if len(names) == 0 and len(buf) >= n:
                    break  # the rest of the stream is moot
            else:
                buf = buf.groupby(keys, dropna=False, sort=False).head(n)
            buf = buf.reset_index(drop=True)
    finally:
        chunks_it.close()  # stops the producer's read-ahead too
    global last_run_stats
    last_run_stats = dict(stats, verb="take")
    out = buf if buf is not None else pd.DataFrame(columns=schema.names)
    return engine.to_df(PandasDataFrame(out, schema))


def streaming_distinct(engine: Any, df: Any) -> DataFrame:
    """DISTINCT over a one-pass stream (``jax/streaming.py`` :1602): each
    chunk deduped against the running distinct rows, NaN equal to NaN as
    in the engines; memory O(distinct rows + chunk), whatever the
    stream's length."""
    schema = Schema(df.schema)
    buf: Optional[pd.DataFrame] = None
    stats = {"chunks": 0, "rows": 0, "peak_device_bytes": 0}
    for pf in _closing(_prefetched_pandas_chunks(engine, df, "distinct")):
        stats["chunks"] += 1
        stats["rows"] += len(pf)
        buf = _drop_duplicates(pf if buf is None else pd.concat([buf, pf], ignore_index=True))
    global last_run_stats
    last_run_stats = dict(stats, verb="distinct")
    out = buf if buf is not None else pd.DataFrame(columns=schema.names)
    return engine.to_df(PandasDataFrame(out, schema))


def _key_aligned_splits(
    batch: pd.DataFrame, keys: List[str], capacity: int
) -> Iterator[pd.DataFrame]:
    """``batch`` (whole groups) in pieces of at most ``capacity`` rows that
    cut no key's run (whole groups, taken greedily)."""
    if len(batch) <= capacity:
        yield batch
        return
    sizes = batch.groupby(keys, dropna=False, sort=False).size().to_numpy()
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    start = 0
    cur = 0
    for gi in range(len(sizes)):
        if bounds[gi + 1] - start > capacity:
            if bounds[gi] == start:  # one group larger than the capacity
                yield batch.iloc[start : bounds[gi + 1]]  # run_batch raises
                start = int(bounds[gi + 1])
                continue
            yield batch.iloc[start : bounds[gi]].reset_index(drop=True)
            start = int(bounds[gi])
        cur = int(bounds[gi + 1])
    if cur > start:
        yield batch.iloc[start:cur].reset_index(drop=True)


# --------------------------------------------------------------------------
# streaming zip/comap (key-sorted streams, co-batched at key horizons)
# --------------------------------------------------------------------------


class ZippedStreamDataFrame(DataFrame):
    """``zip`` of key-sorted one-pass streams, and of bounded frames that
    ride along as single-chunk streams (``jax/streaming.py`` :1849). It
    holds the streams under the blob protocol's schema and metadata
    (``"stream_zip": True``); only ``comap`` (``streaming_comap``) reads
    it, and anything else raises: a one-pass stream cannot be read
    twice."""

    def __init__(
        self,
        streams: List[Any],
        names: List[str],
        named: bool,
        how: str,
        keys: List[str],
        schemas: List[Schema],
        presort: Dict[str, bool],
    ):
        from .zipped import _BLOB_PREFIX

        blob_fields = ",".join(f"{_BLOB_PREFIX}{i}:binary" for i in range(len(streams)))
        super().__init__(Schema(str(schemas[0].extract(keys)) + "," + blob_fields))
        self.zip_streams = streams
        self.zip_names = names
        self.zip_named = named
        self.zip_how = how
        self.zip_keys = keys
        self.zip_schemas = schemas
        self.zip_presort = presort
        self.reset_metadata(
            {
                "serialized": True,
                "serialized_cols": [f"{_BLOB_PREFIX}{i}" for i in range(len(streams))],
                "schemas": [str(s) for s in schemas],
                "serialized_has_name": named,
                "names": names,
                "how": how,
                "keys": keys,
                "stream_zip": True,
            }
        )

    @property
    def is_local(self) -> bool:
        return True

    @property
    def is_bounded(self) -> bool:
        return False

    @property
    def empty(self) -> bool:
        return False

    def _no(self, what: str) -> Any:
        raise FugueInvalidOperation(
            f"{what} is not available on a zipped one-pass stream; "
            "apply a cotransformer (comap) to consume it"
        )

    def peek_array(self) -> List[Any]:
        return self._no("peek")

    def count(self) -> int:
        return self._no("count")

    def as_arrow(self) -> pa.Table:
        return self._no("as_arrow")

    def as_local_bounded(self) -> Any:
        return self._no("as_local_bounded")

    def as_array(self, columns: Any = None, type_safe: bool = False) -> Any:
        return self._no("as_array")

    def as_array_iterable(self, columns: Any = None, type_safe: bool = False) -> Any:
        return self._no("as_array_iterable")

    def drop(self, columns: Any) -> Any:
        return self._no("drop")

    def _select_cols(self, cols: Any) -> Any:
        return self._no("select")

    def rename(self, columns: Any) -> Any:
        return self._no("rename")

    def alter_columns(self, columns: Any) -> Any:
        return self._no("alter_columns")

    def head(self, n: int, columns: Any = None) -> Any:
        return self._no("head")


def streaming_zip(engine: Any, dfs: Any, how: str, partition_spec: Any) -> Optional[DataFrame]:
    """A :class:`ZippedStreamDataFrame` when a zip input is a one-pass
    stream (``jax/streaming.py`` :1952): a zip that is not cross, by keys
    given or shared, with no NULL key in a bounded input (a NULL group
    needs the blob protocol; streams are checked chunk by chunk). Bounded
    inputs are sorted by the keys on the host; streams must come sorted.
    None otherwise: the engine then reads the streams whole."""
    if how.lower() == "cross":
        return None
    keys = list(partition_spec.partition_by) if partition_spec is not None else []
    if len(keys) == 0 and len(dfs) > 0:
        keys = [n for n in dfs[0].schema.names if all(n in d.schema for d in dfs.values())]
    if len(keys) == 0:
        return None
    inputs: List[Any] = []
    for d in dfs.values():
        if is_stream_frame(d):
            inputs.append(d)
            continue
        pf = d.as_pandas()
        if len(pf) > 0 and pf[keys].isna().any().any():
            return None
        inputs.append(
            PandasDataFrame(pf.sort_values(keys, kind="stable").reset_index(drop=True), Schema(d.schema))
        )
    return ZippedStreamDataFrame(
        streams=inputs,
        names=list(dfs.keys()),
        named=dfs.has_key,
        how=how.lower(),
        keys=keys,
        schemas=[Schema(d.schema) for d in dfs.values()],
        presort=dict(partition_spec.presort) if partition_spec is not None else {},
    )


def _key_view(frame: pd.DataFrame, keys: List[str]) -> Any:
    """The keys, comparable in order: the numpy column of one key, a
    MultiIndex of several."""
    if len(keys) == 1:
        return frame[keys[0]].to_numpy()
    return pd.MultiIndex.from_frame(frame[keys])


def _is_sorted(kv: Any) -> bool:
    if isinstance(kv, pd.MultiIndex):
        return kv.is_monotonic_increasing
    return bool(np.all(kv[1:] >= kv[:-1])) if len(kv) > 1 else True


def _split_below(b: pd.DataFrame, keys: List[str], horizon: Tuple) -> int:
    """The first row of the sorted ``b`` whose key is at or above
    ``horizon``."""
    kv = _key_view(b, keys)
    if isinstance(kv, pd.MultiIndex):
        lo, hi = 0, len(kv)
        while lo < hi:
            mid = (lo + hi) // 2
            if tuple(kv[mid]) < horizon:
                lo = mid + 1
            else:
                hi = mid
        return lo
    return int(np.searchsorted(kv, horizon[0], side="left"))


def streaming_comap(
    engine: Any,
    zdf: ZippedStreamDataFrame,
    map_func: Callable,
    output_schema: Any,
    partition_spec: Any = None,
    on_init: Optional[Callable] = None,
) -> DataFrame:
    """The cotransform over zipped key-sorted streams in bounded memory
    (``jax/streaming.py`` :2033): each input keeps a buffer of chunks; the
    horizon is the least last key over the inputs still open; the rows
    below it are whole on every input and go through the engine's
    ``zip`` and ``comap`` as one batch; the rest wait. Memory is
    O(chunk × inputs) whatever the streams' length. A NULL key, or a
    chunk out of order within itself or after the one before, raises
    ``FugueInvalidOperation``. The result is a one-pass stream."""
    from ..collections.partition import PartitionSpec
    from ..dataframe import DataFrames

    out_schema = output_schema if isinstance(output_schema, Schema) else Schema(output_schema)
    keys = zdf.zip_keys
    chunk_rows, _ = _tuned_chunk_rows(engine, "comap")
    # a comap-time presort overrides the zip-time one, as in memory
    presort = dict(zdf.zip_presort)
    if partition_spec is not None and len(partition_spec.presort) > 0:
        presort = dict(partition_spec.presort)
    spec = (
        PartitionSpec(partition_spec, by=keys, presort=presort)
        if partition_spec is not None
        else PartitionSpec(by=keys, presort=presort)
    )

    def frames(parts: List[pd.DataFrame]) -> Any:
        pieces = [PandasDataFrame(p, s) for p, s in zip(parts, zdf.zip_schemas)]
        return DataFrames(dict(zip(zdf.zip_names, pieces)) if zdf.zip_named else pieces)

    def gen() -> Iterator[LocalDataFrame]:
        stats = {"chunks": 0, "rows": 0, "peak_device_bytes": 0}
        _reset_peak(engine.device)
        iters = [_iter_local_frames(s, chunk_rows) for s in zdf.zip_streams]
        # lists of chunks, concatenated only when a batch is cut: a hot key
        # that spans many chunks is not copied once a pull
        bufs: List[List[pd.DataFrame]] = [[] for _ in iters]
        last_key: List[Optional[Tuple]] = [None] * len(iters)
        done = [False] * len(iters)
        first = [True]

        def _nrows(i: int) -> int:
            return sum(len(c) for c in bufs[i])

        def pull(i: int) -> None:
            """One checked chunk onto input ``i``'s buffer: every chunk
            enters here, so the sorted contract is checked here only."""
            try:
                f = next(iters[i])
            except StopIteration:
                done[i] = True
                return
            pf = f.as_pandas().reset_index(drop=True)
            stats["chunks"] += 1
            stats["rows"] += len(pf)
            if len(pf) == 0:
                return
            assert_or_throw(
                not pf[keys].isna().any().any(),
                FugueInvalidOperation("streaming zip: NULL keys are not supported on the sorted-stream path"),
            )
            assert_or_throw(
                _is_sorted(_key_view(pf, keys)),
                FugueInvalidOperation(f"streaming zip: input {i} is not sorted ascending by {keys} within a chunk"),
            )
            lo = tuple(pf[keys].iloc[0])
            if last_key[i] is not None:
                assert_or_throw(
                    lo >= last_key[i],
                    FugueInvalidOperation(
                        f"streaming zip: input {i} is not sorted ascending by {keys} "
                        f"({lo!r} after {last_key[i]!r})"
                    ),
                )
            bufs[i].append(pf)
            last_key[i] = tuple(pf[keys].iloc[-1])

        def run_batch(parts: List[pd.DataFrame]) -> pd.DataFrame:
            z = engine.zip(frames(parts), how=zdf.zip_how, partition_spec=spec)
            res = engine.comap(
                z, map_func, out_schema, partition_spec=spec, on_init=on_init if first[0] else None
            )
            first[0] = False
            out = res.as_pandas()
            stats["peak_device_bytes"] = max(stats["peak_device_bytes"], _device_peak_bytes(engine.device, []))
            return out

        while True:
            for i in range(len(iters)):
                while not done[i] and _nrows(i) == 0:
                    pull(i)
            live = [i for i in range(len(iters)) if _nrows(i) > 0]
            if len(live) == 0:
                break
            # the horizon: the least last key of the inputs that may grow
            horizons = [last_key[i] for i in live if not done[i]]
            horizon = min(horizons) if len(horizons) > 0 else None
            parts: List[pd.DataFrame] = []
            any_rows = False
            for i in range(len(iters)):
                empty = pd.DataFrame(columns=zdf.zip_schemas[i].names)
                if _nrows(i) == 0 or (horizon is not None and tuple(bufs[i][0][keys].iloc[0]) >= horizon):
                    # nothing of this input below the horizon: no concat
                    parts.append(empty)
                    continue
                b = bufs[i][0] if len(bufs[i]) == 1 else pd.concat(bufs[i], ignore_index=True)
                cut = len(b) if horizon is None else _split_below(b, keys, horizon)
                parts.append(b.iloc[:cut].reset_index(drop=True))
                rest = b.iloc[cut:].reset_index(drop=True)
                bufs[i] = [rest] if len(rest) > 0 else []
                any_rows = any_rows or cut > 0
            if any_rows:
                yield PandasDataFrame(run_batch(parts), out_schema)
            elif horizon is not None:
                # nothing below the horizon: only the inputs pinned at it
                # can move it, one chunk each (the others must not grow)
                progressed = False
                for i in range(len(iters)):
                    if not done[i] and _nrows(i) > 0 and last_key[i] == horizon:
                        pull(i)
                        progressed = True
                assert_or_throw(
                    progressed, FugueInvalidOperation("streaming zip: no progress possible (internal)")
                )
        if first[0] and on_init is not None:
            # no batch ran: on_init still runs once, over empty frames
            on_init(0, frames([pd.DataFrame(columns=s.names) for s in zdf.zip_schemas]))
        global last_run_stats
        last_run_stats = dict(stats, verb="comap")

    return LocalDataFrameIterableDataFrame(gen(), schema=out_schema)


# --------------------------------------------------------------------------
# plan segments over one-pass streams (``plan/fused.py``, ``plan/lowering.py``)
# --------------------------------------------------------------------------


def streaming_fused_steps(engine: Any, df: Any, steps: Any) -> DataFrame:
    """A fused select/filter/assign chain applied inside the chunk producer
    of a one-pass stream (reference :1574): each chunk runs the chain with
    the engine's own verbs, and only the surviving rows flow on. The
    stream stays one-pass: the device holds O(chunk) rows."""
    from ..plan.fused import apply_steps_engine

    # the schema of an empty frame through the chain: what the chunks get
    out_schema = apply_steps_engine(engine, ArrayDataFrame([], df.schema), steps).schema

    def gen() -> Iterator[LocalDataFrame]:
        chunk_rows, _ = _tuned_chunk_rows(engine, "fused")
        for f in _iter_local_frames(df, chunk_rows):
            out = apply_steps_engine(engine, f, steps)
            if out.count() > 0:
                yield out.as_local_bounded()

    return LocalDataFrameIterableDataFrame(gen(), schema=out_schema)


def _np_dtype_of(tp: pa.DataType) -> Optional[np.dtype]:
    """The numpy dtype of an arrow type a raw chunk column feeds the device
    program in, else None. The unsigned types above uint8 feed it in the
    frame's storage (``torch/dataframe.py`` ``to_storage``: uint16 and
    uint32 widened, uint64 as its flipped bits)."""
    if is_wide_unsigned(tp):
        return storage_dtype(tp)
    if pa.types.is_boolean(tp):
        return np.dtype(bool)
    if pa.types.is_integer(tp) or pa.types.is_floating(tp):
        return np.dtype(tp.to_pandas_dtype())
    return None


def _plan_lowered_chain(schema: Schema, steps: Any, device: torch.device) -> Optional[dict]:
    """The chain composed over a stream's RAW columns, from the schema
    alone (reference ``_plan_lowered_chain`` :660): ``dict(pred, outputs,
    outs_by_name, need, in_np, in_schema, out_dt, schema)`` — the planned
    Kleene-AND predicate, the output expressions, the input columns read
    with their numpy dtypes (an unsigned one's storage) and their schema,
    each output's torch dtype (its storage, from a zero-row probe) and the
    chain's output schema; None when a step resists composition or the
    device evaluator. Nothing reads the stream here."""
    from ..column.torch_eval import (
        can_evaluate_on_device,
        device_predicate_plan,
        evaluate_torch,
        to_column,
        typed_columns,
    )
    from ..plan.fused import compose_steps
    from ..plan.ir import ALL, expr_columns
    from .execution_engine import _full_column, _np_dtype

    composed = compose_steps(list(schema.names), steps)
    if composed is None:
        return None
    pred, outputs = composed
    need: set = set()
    for e in outputs + ([pred] if pred is not None else []):
        cols = expr_columns(e)
        if cols is ALL:
            return None
        need |= cols
    in_np: Dict[str, np.dtype] = {}
    for name in sorted(need):
        dt = _np_dtype_of(schema[name].type) if name in schema else None
        if dt is None:
            return None
        in_np[name] = dt
    cond = None
    if pred is not None:
        p = device_predicate_plan(pred, in_np, {})
        if p is None or p[0]:
            return None  # a raw stream has no dictionary columns
        cond = p[1]
    if not all(can_evaluate_on_device(e, in_np) for e in outputs):
        return None
    in_schema = schema.extract(sorted(need))
    zcols = typed_columns(
        {n: torch.zeros(0, dtype=_torch_dtype(dt), device=device) for n, dt in in_np.items()}, in_schema
    )
    out_dt: Dict[str, torch.dtype] = {}
    outs_by_name: Dict[str, Any] = {}
    fields: List[pa.Field] = []
    for e in outputs:
        name = e.output_name
        if name == "" or name in outs_by_name:
            return None
        try:
            tp = e.infer_type(schema)
        except Exception:  # noqa: BLE001
            tp = None
        try:
            v, tp = to_column(evaluate_torch(zcols, e), tp)
            out_dt[name] = _full_column(v, 0, device).dtype
        except Exception:  # noqa: BLE001 - the reference's probe refuses alike
            return None
        fields.append(pa.field(name, tp if tp is not None else pa.from_numpy_dtype(_np_dtype(out_dt[name]))))
        outs_by_name[name] = e
    return dict(
        pred=cond,
        outputs=list(outputs),
        outs_by_name=outs_by_name,
        need=sorted(need),
        in_np=in_np,
        in_schema=in_schema,
        out_dt=out_dt,
        schema=Schema(fields),
    )


def _chain_valid(
    cols: Dict[str, torch.Tensor], cond: Any, valid: torch.Tensor
) -> torch.Tensor:
    """``valid`` AND the chain's predicate is TRUE (not FALSE, not NULL)."""
    from ..column.torch_eval import evaluate_torch_3v

    if cond is None:
        return valid
    v, nl = evaluate_torch_3v(cols, {}, {}, cond, frozenset())
    for keep in (v, (not nl) if isinstance(nl, bool) else torch.logical_not(nl)):
        if isinstance(keep, torch.Tensor):
            valid = valid & keep.to(torch.bool)
        elif not keep:
            valid = torch.zeros_like(valid)
    return valid


def plan_streaming_lowered_aggregate(
    engine: Any, df: Any, steps: Any, keys: List[str], agg_cols: List[Any], fingerprint: str
) -> Optional[Callable[[], DataFrame]]:
    """Stream → chain → dense aggregate (reference :746), planned from the
    schema alone: a runner, or None (the caller runs the segment per
    verb). The runner reads the stream once: the producer stages each
    chunk's RAW needed columns to the device (``HostToDevice``), and the
    consumer evaluates the predicate and the value expressions on them,
    runs the dense kernel (B1 ``bin_sum`` for a float32 SUM) and folds the
    tables into device accumulators; only the O(buckets) tables come back.
    Eligible as the streaming dense aggregate is, and the key must pass
    through a raw integer column. The key range and the NULL contract
    apply to the RAW chunks, as in the reference: rows the chain's filter
    would drop still count (set ``fugue.tpu.stream.key_range`` where that
    matters)."""
    from ..column.torch_eval import evaluate_torch, to_column, typed_columns
    from ..column.expressions import _NamedColumnExpr
    from ..ops.segment import _DENSE_MAX_RANGE, _dense_kernel, dense_buckets
    from .dataframe import TorchDataFrame
    from .execution_engine import (
        _full_column,
        _lowerable_posts,
        _np_dtype,
        _plain_virtual_array,
        _plan_device_agg,
    )

    if len(keys) != 1 or len(steps) == 0:
        return None
    device = engine.device
    chain = _plan_lowered_chain(Schema(df.schema), steps, device)
    if chain is None:
        return None
    tdf0 = TorchDataFrame(chain["schema"].create_empty_arrow_table(), device=device)
    plan = _plan_device_agg(tdf0, keys, agg_cols)
    # a plain unsigned SUM/AVG sums its values as int64 (the ``uval`` view)
    # and the host finish wraps it, as the in-memory aggregate does
    if plan is None or plan["dict_srcs"] or plan["masked_srcs"] or not _lowerable_posts(plan):
        return None
    key = keys[0]
    key_expr = chain["outs_by_name"].get(key)
    if not isinstance(key_expr, _NamedColumnExpr) or key_expr.wildcard or key_expr.as_type is not None:
        return None  # the group key must pass through a raw input column
    raw_key = key_expr.name
    key_np = _np_dtype(tdf0.device_cols[key].dtype)
    if key_np.kind not in ("i", "u") or chain["in_np"][raw_key].kind not in ("i", "u"):
        return None
    virtual = plan["virtual"]
    out_schema: Schema = chain["schema"]
    srcs = sorted({virtual[s][1] if s in virtual else s for _, _, s in plan["aggs"]})
    src_dt = {s: tdf0.device_cols[s].dtype for s in srcs}
    if any(dt == torch.bool for dt in src_dt.values()):
        return None
    agg_dt = {s: torch.int64 if s in virtual else src_dt[s] for _, _, s in plan["aggs"]}
    del tdf0
    key_range = _parse_key_range(engine.conf)
    if key_range is not None and not (0 < key_range[1] - key_range[0] + 1 <= _DENSE_MAX_RANGE):
        return None  # a declared range too wide for the dense plan
    raw_key_type = chain["in_schema"][raw_key].type
    if key_range is not None and is_wide_unsigned(raw_key_type):
        # the declared values in the key's storage (order kept)
        lo, hi = to_storage(np.array(key_range, dtype=np.uint64), raw_key_type).tolist()
        key_range = (int(lo), int(hi))
    cond = chain["pred"]
    needed: List[str] = chain["need"]
    in_np: Dict[str, np.dtype] = chain["in_np"]
    in_schema: Schema = chain["in_schema"]
    src_expr = {s: chain["outs_by_name"][s] for s in srcs}
    avals = sorted({s for _, _, s in plan["aggs"]})
    vidx = {s: i for i, s in enumerate(avals)}
    # floats are always NaN-aware: a later chunk may hold NaN
    agg_sig = tuple(
        (name, agg, vidx[src], agg_dt[src].is_floating_point) for name, agg, src in plan["aggs"]
    )
    label = f"segment:{fingerprint or 'anon'}"

    def run() -> DataFrame:
        # ---- the stream is read from here on: failures raise ------------
        capacity, tune = _tuned_chunk_rows(engine, label)
        frames = _rechunk(_maybe_coalesce(_iter_local_frames(df, capacity), capacity, tune), capacity)
        first = next(frames, None)
        if first is None:
            return engine.to_df(plan["schema"].create_empty_arrow_table())
        n0, cols0, nulls0 = _chunk_columns(first, needed)
        assert_or_throw(
            nulls0[raw_key] == 0,
            FugueInvalidOperation(f"lowered segment: NULL in key column {raw_key!r}"),
        )
        # an unsigned key in its storage: its range, buckets and tables are
        # in the storage's order
        cols0[raw_key] = to_storage(cols0[raw_key], raw_key_type)
        probed = key_range is None
        kmin, kmax = (int(cols0[raw_key].min()), int(cols0[raw_key].max())) if probed else key_range
        if not (0 < kmax - kmin + 1 <= _DENSE_MAX_RANGE):
            raise FugueInvalidOperation(
                f"lowered segment: first-chunk RAW key range [{kmin},{kmax}] exceeds the dense "
                f"plan bound ({_DENSE_MAX_RANGE}); set {FUGUE_TPU_CONF_STREAM_KEY_RANGE}, "
                "pre-bucket the key, or disable fugue.tpu.plan.lower_segments"
            )
        buckets = dense_buckets(kmax - kmin + 1)
        stager = _stager(engine, capacity, tune)
        valid_for = _valid_masks(device, capacity)

        def put_chunk(n: int, cols: Dict[str, np.ndarray], nulls: Dict[str, int]) -> Any:
            assert_or_throw(
                nulls[raw_key] == 0,
                FugueInvalidOperation(f"lowered segment: NULL in key column {raw_key!r}"),
            )
            ck = cols[raw_key]
            lo, hi = int(ck.min()), int(ck.max())
            if lo < kmin or hi > kmax:
                hint = (
                    f"probed from the first RAW chunk as [{kmin},{kmax}]; set "
                    f"{FUGUE_TPU_CONF_STREAM_KEY_RANGE}='lo,hi' to cover the full stream"
                    if probed
                    else f"conf {FUGUE_TPU_CONF_STREAM_KEY_RANGE} was [{kmin},{kmax}]"
                )
                raise FugueInvalidOperation(
                    f"lowered segment: key {raw_key!r} value outside range ([{lo},{hi}] seen): {hint}"
                )
            staged = {}
            for name in needed:
                if in_np[name].kind != "f":
                    assert_or_throw(
                        nulls[name] == 0,
                        FugueInvalidOperation(
                            f"lowered segment: NULL in non-float column {name!r} (RAW chunks "
                            "feed the device; rows the fused filter would drop still count)"
                        ),
                    )
                arr = ck if name == raw_key else to_storage(cols[name], in_schema[name].type)
                staged[name] = arr.astype(in_np[name], copy=False)
            return stager.put(staged, n)

        def produce() -> Iterator[Tuple[int, Any]]:
            nonlocal cols0, nulls0, first
            yield n0, put_chunk(n0, cols0, nulls0)
            cols0 = nulls0 = first = None  # drop the head chunk's host copy
            for f in frames:
                n, cols, nulls = _chunk_columns(f, needed)
                if nulls[raw_key] == 0:
                    cols[raw_key] = to_storage(cols[raw_key], raw_key_type)
                yield n, put_chunk(n, cols, nulls)

        def step(t: Dict[str, torch.Tensor], n: int) -> Tuple[torch.Tensor, ...]:
            tc = typed_columns(t, in_schema)
            valid = _chain_valid(tc, cond, valid_for(n))
            vals: Dict[str, torch.Tensor] = {}
            for s in srcs:
                v, _ = to_column(evaluate_torch(tc, src_expr[s]), out_schema[s].type)
                vals[s] = _full_column(v, capacity, device).to(src_dt[s])
            for vname, (tag, src) in virtual.items():
                vals[vname] = _plain_virtual_array(tag, vals[src], out_schema[src].type)
            return _dense_kernel(
                buckets, agg_sig, t[raw_key].to(_torch_dtype(key_np)), kmin, [vals[s] for s in avals], valid
            )

        return _fold_dense_stream(engine, produce(), step, agg_sig, key, key_np, kmin, plan, label)

    return run


def plan_lowered_steps_stream(
    engine: Any, df: Any, steps: Any, fingerprint: str
) -> Optional[Callable[[], DataFrame]]:
    """A lowered chain feeding a host-buffered terminal (take, distinct,
    broadcast-join probe), planned from the schema (reference :1018): a
    factory of the one-pass stream whose chunks each run the chain on the
    device over their raw columns, the survivors coming back to the host,
    or None. A chunk with a NULL in a non-float column runs the chain per
    verb instead (the same rows), counted in
    ``engine.plan_stats.chunks_per_verb``."""
    from ..column.torch_eval import evaluate_torch, to_column, typed_columns
    from ..plan.fused import apply_steps_engine
    from .execution_engine import _full_column

    if len(steps) == 0:
        return None
    device = engine.device
    chain = _plan_lowered_chain(Schema(df.schema), steps, device)
    if chain is None:
        return None
    out_schema: Schema = chain["schema"]
    if any(_np_dtype_of(f.type) is None for f in out_schema.fields):
        return None  # outputs must round-trip through numpy numerics
    cond = chain["pred"]
    needed: List[str] = chain["need"]
    in_np: Dict[str, np.dtype] = chain["in_np"]
    in_schema: Schema = chain["in_schema"]
    outputs = chain["outputs"]
    out_dt = chain["out_dt"]
    label = f"segment:{fingerprint or 'anon'}"

    def make_stream() -> DataFrame:
        capacity, tune = _tuned_chunk_rows(engine, label)

        def gen() -> Iterator[LocalDataFrame]:
            stager = _stager(engine, capacity, tune)
            valid_for = _valid_masks(device, capacity)
            for f in _rechunk(
                _maybe_coalesce(_iter_local_frames(df, capacity), capacity, tune), capacity
            ):
                n, cols, nulls = _chunk_columns(f, needed)
                if any(nulls[c] > 0 and in_np[c].kind != "f" for c in needed):
                    engine.plan_stats.inc("chunks_per_verb")
                    out = apply_steps_engine(engine, f, steps)
                    if out.count() > 0:
                        yield out.as_local_bounded()
                    continue
                with record_function("fugue::plan_segment_chunk"):
                    t = stager.put(
                        {c: to_storage(cols[c], in_schema[c].type).astype(in_np[c], copy=False) for c in needed}, n
                    ).tensors()
                    tc = typed_columns(t, in_schema)
                    valid = _chain_valid(tc, cond, valid_for(n))
                    idx = torch.nonzero(valid).squeeze(1)
                    data = {}
                    for e in outputs:
                        name = e.output_name
                        tp = out_schema[name].type
                        v, _ = to_column(evaluate_torch(tc, e), tp)
                        col = _full_column(v, capacity, device).to(out_dt[name]).index_select(0, idx)
                        data[name] = from_storage(col.cpu().numpy(), tp)
                if len(idx) > 0:
                    yield PandasDataFrame(pd.DataFrame(data), out_schema)

        return LocalDataFrameIterableDataFrame(gen(), schema=out_schema)

    return make_stream
