"""TorchExecutionEngine — the port of ``JaxExecutionEngine``
(``fugue_tpu/jax/execution_engine.py``) for one CUDA device.

The port has ``to_df``, ``repartition``, ``persist``, ``broadcast``, the
device ``aggregate``, the maps behind ``transform`` (``TorchMapEngine``), the
device ``join`` of every type, ``union``, ``subtract``, ``intersect``,
``distinct``, ``sample``, ``take``, the row-local verbs ``filter``,
``select``, ``assign``, ``dropna`` and ``fillna``, ``load_df``,
``save_df``, and ``zip`` and ``comap``. A one-pass stream (``LocalDataFrameIterableDataFrame``, or
the row stream ``IterableDataFrame``) given to ``aggregate``, ``join``,
``transform``, ``distinct`` or ``take`` goes through chunk by chunk
(``torch/streaming.py``) where the plan allows it, as in the JAX engine.

``aggregate`` takes any number of keys of any integer, float, bool,
string, date or timestamp column, nullable or not, with
SUM/COUNT/AVG/MIN/MAX and COUNT(*) over numeric, nullable-int, bool and
dictionary-string columns. A plain single integer key whose range fits
``2**18`` buckets takes the dense route and finishes on the device; every
other plan runs the device groupby (``ops/segment.py``) into per-group
partials, merges them on the host and comes back to the device as the
result frame, as the JAX engine does.

The row-local verbs run the column IR on the device
(``column/torch_eval.py``): ``filter`` (and ``select``'s WHERE, and
``dropna``) turns the predicate into a new validity mask, so no row
moves; ``select`` lowers a grouped aggregate of named columns to the
device ``aggregate`` and a projection to ``_device_project``; ``fillna``
fills NaN floats and masked cells in place.

The set verbs follow the JAX engine's device plans: ``distinct`` is the
device groupby of every column with one presence count, its O(groups)
keys decoded on the host; ``union`` concatenates on the device (then
``distinct``); ``subtract`` and ``intersect`` of NULL-free plain frames
are the device anti and semi joins of their distinct rows on every
column; ``sample(frac=...)`` ANDs the JAX engine's own uniform draw
(``ops/random.py``, the same bits) into the validity mask; ``take`` sorts
the rows by validity and its keys on the device and brings the first
``n`` to the host for the JAX engine's pandas step.

Like the JAX engine, it holds a host engine (``NativeExecutionEngine``,
``execution/native_execution_engine.py``) and calls it exactly where the
JAX engine calls its own: the map of any transformer that is not a
compiled ``Dict[str, torch.Tensor]`` function, the joins the device plans
decline, the unions of frames the device union declines, the aggregates
and selects the device plans decline (a global aggregate, COUNT
DISTINCT, an aggregate of an expression, a predicate or projection the
device evaluator refuses), the fills of encoded columns, the set verbs
and ``sample``/``take`` their gates decline, and ``load_df``/``save_df``.
A frame goes to the host through ``_host`` (one copy of its valid rows)
and the result comes back through ``_back``; the spans ``fugue::to_host``,
``fugue::host_map`` / ``fugue::host_join`` / ``fugue::host_union`` /
``fugue::host_select`` / ``fugue::host_distinct`` / ``fugue::host_setop``
/ ``fugue::host_sample`` / ``fugue::host_take`` and ``fugue::to_device``
name the steps in a ``torch.profiler`` trace, and ``fugue::filter``,
``fugue::project``, ``fugue::distinct``, ``fugue::sample_mask`` and
``fugue::take_sort`` the device work.

``zip`` holds its frames on the device (``torch/zipped.py``) where the
JAX engine's device zip does, and ``comap`` copies each to the host once
(``fugue::comap_to_host``) and calls the cotransformer once a key under
``fugue::comap``; the other zips take the base engine's blob protocol,
and a zip of streams ``streaming_zip``.

The unsigned types above uint8 live on the device widened
(``torch/dataframe.py``) and run every verb there as in the JAX engine:
the evaluator computes in their type, the aggregate wraps a SUM in it, and
the keys decode back on the host. A compiled map over them and a window
over them run on the host path (their device form is not theirs).

``fused_apply`` and ``lowered_segment`` run the plan optimizer's steps
(``fugue_tpu_torch/plan``): a fused chain as one device step, a lowered
segment over the raw columns with no frame between its verbs.
"""

from contextlib import contextmanager, nullcontext
from typing import Any, Callable, ContextManager, Dict, Iterator, List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import torch
from torch.profiler import record_function

from ..collections.partition import PartitionSpec
from ..column import SelectColumns
from ..column.eval import rewrite_having_aggs
from ..column.expressions import ColumnExpr, _FuncExpr, _LitColumnExpr, _NamedColumnExpr
from ..column.functions import is_agg
from ..column.torch_eval import (
    can_evaluate_on_device,
    device_predicate_plan,
    evaluate_torch,
    evaluate_torch_3v,
    to_column,
    typed_columns,
)
from ..collections.partition import parse_presort_exp
from ..constants import FUGUE_TPU_CONF_MAX_PARTIAL_ROWS
from .._utils.params import ParamDict
from ..dataframe import (
    ArrayDataFrame,
    ArrowDataFrame,
    DataFrame,
    DataFrames,
    LocalBoundedDataFrame,
    PandasDataFrame,
)
from ..dataframe.utils import get_join_schemas, parse_join_type
from ..exceptions import FugueInvalidOperation
from ..execution.execution_engine import ExecutionEngine, MapEngine
from ..execution.native_execution_engine import NativeExecutionEngine, PandasMapEngine
from ..ops.join import MAX_BROADCAST_ROWS, device_expand_join, device_hash_join
from ..obs import get_tracer, traced_verb
from ..ops.random import uniform
from ..ops.segment import (
    _DENSE_MAX_RANGE,
    PartialsTooLarge,
    _is_int,
    _keyed_order,
    _order_by,
    _sort_image,
    dense_buckets,
    dense_kernel_parts,
    device_groupby_partials,
    keyed_segments,
    merge_partials,
)
from ..parallel.device import resolve_device
from ..parallel.profiler import annotate
from ..schema import Schema
from ..shuffle.join import shuffle_spill_join, spill_repartition
from ..shuffle.partitioner import spill_dir_bytes
from ..shuffle.stats import ShuffleStats
from ..shuffle.strategy import (
    broadcast_max_rows,
    choose_join_strategy,
    device_budget_bytes,
    device_budget_info,
    estimate_frame_bytes,
    estimate_frame_rows,
    shuffle_enabled,
)
from ..torch_annotations import sniff_torch_func
from .dataframe import TorchDataFrame, from_storage, is_wide_unsigned
from .group_ops import SEGMENT_SPACE, SEGMENTS, SPANS_SHARDS, VALID
from .pipeline import PipelineStats
from .streaming import (
    ZippedStreamDataFrame,
    _finish_dense_host,
    is_stream_frame,
    streaming_compiled_map,
    streaming_dense_aggregate,
    streaming_distinct,
    streaming_hash_join,
    streaming_keyed_compiled_map,
    streaming_take,
    streaming_zip,
    streaming_comap,
)
from .zipped import ZippedTorchDataFrame

# the JAX engine's default of fugue.tpu.max_partial_rows (its distinct)
_MAX_PARTIAL_ROWS = 1 << 22
# the largest n of the device take
_TAKE_MAX_N = 4096
# the largest segment-id space of the dense keyed map: the JAX package's
# default for FUGUE_TPU_CONF_DENSE_MAP_RANGE (the port has no such knob)
_DENSE_MAP_RANGE = 1 << 20
_RESERVED = (SEGMENTS, VALID, SEGMENT_SPACE, SPANS_SHARDS)


class TorchMapEngine(MapEngine):
    """The port of ``JaxMapEngine`` (``fugue_tpu/jax/execution_engine.py``).

    ``map_func`` is a transformer runner's ``run(cursor, df)``. When the
    transformer is an interfaceless ``Dict[str, torch.Tensor]`` function of
    one parameter (format hint ``"torch"``), the raw function runs on the
    engine's device in one of the three forms the JAX package compiles:

    - **keyless** (``_compiled_map``): the whole frame in one call;
    - **keyed, dense plan** (``_try_dense_keyed_map``): integer keys of a
      bounded range map to dense segment ids; rows stay in place;
    - **keyed, sorted plan** (``_compiled_keyed_map``): rows sorted by
      (validity, keys, presort), contiguous segment ids.

    Every other transformer, and a keyless one over encoded or nullable
    columns, takes the general path (:188-204): the frame to the host
    (``_host``), the host engine's ``PandasMapEngine``, the result back to
    the device (``_back``). A one-pass stream handed to it is read whole
    on the host, as the JAX engine's ``_host`` reads it.

    On one device every group is whole: the JAX package's hash exchange
    before the sorted plan, and its cross-shard merge of group tables
    under the dense plan, have nothing to do here."""

    def __init__(self, execution_engine: "TorchExecutionEngine"):
        super().__init__(execution_engine)
        self._host_map = PandasMapEngine(
            execution_engine._host_engine, parallelism_engine=execution_engine
        )

    @traced_verb("engine.transform")
    def map_dataframe(
        self,
        df: Any,
        map_func: Callable,
        output_schema: Any,
        partition_spec: PartitionSpec,
        on_init: Optional[Callable] = None,
        map_func_format_hint: Optional[str] = None,
    ) -> DataFrame:
        engine: TorchExecutionEngine = self.execution_engine  # type: ignore[assignment]
        if not isinstance(output_schema, Schema):
            output_schema = Schema(output_schema)
        fn = sniff_torch_func(map_func) if map_func_format_hint == "torch" else None
        if fn is not None:
            res = self._compiled(engine, df, fn, map_func, output_schema, partition_spec, on_init)
            if res is not None:
                return res
        local = engine._host(df)
        with record_function("fugue::host_map"):
            local = self._host_map.map_dataframe(
                local,
                map_func,
                output_schema,
                partition_spec,
                on_init=on_init,
                map_func_format_hint=map_func_format_hint,
            )
        return engine._back(local)

    def _compiled(
        self,
        engine: "TorchExecutionEngine",
        df: Any,
        fn: Callable,
        map_func: Callable,
        output_schema: Schema,
        partition_spec: PartitionSpec,
        on_init: Optional[Callable],
    ) -> Optional[DataFrame]:
        """A compiled transformer's device plan; None for a keyless map
        over encoded, nullable or unsigned columns (above uint8: the UDF
        would see their widened device form), which takes the host path."""
        params = map_func.__self__.transformer.params
        if len(params) > 0:
            raise FugueInvalidOperation(
                f"params {sorted(params)} given to a compiled transformer, which takes "
                "its columns only (ROADMAP.md C4)"
            )
        keys = partition_spec.partition_by
        if on_init is not None:
            on_init(0, df)
        if is_stream_frame(df):
            # a one-pass stream is mapped chunk by chunk, never materialized
            if len(keys) == 0:
                return streaming_compiled_map(engine, df, fn, output_schema)
            return streaming_keyed_compiled_map(engine, df, fn, output_schema, partition_spec)
        tdf = engine.to_df(df)
        unsigned = any(is_wide_unsigned(f.type) for f in tdf.schema.fields)
        if len(keys) == 0:
            if tdf.has_encoded or unsigned:
                # the JAX package renders encoded/masked columns as real
                # values on its host engine
                return None
            # the map runs over the frame as it lies: a keyless spec (a
            # presort, an algo, a count) only lays the rows out first
            if not partition_spec.empty:
                tdf = engine.repartition(tdf, partition_spec)
            return self._compiled_map(tdf, fn, output_schema)
        # encoded/masked columns have non-plain semantics the UDF can't see.
        # The ONE exception: dictionary-encoded PARTITION keys, whose codes
        # the UDF only groups by and passes through opaquely (the engine
        # reattaches the dictionary on output).
        dict_keys_only = len(tdf.null_masks) == 0 and all(
            e.get("kind") == "dict" and c in keys for c, e in tdf.encodings.items()
        )
        # an encoded key that appears in the output must keep its declared
        # type — the dictionary is reattached to the (passed-through) codes
        enc_schema_ok = all(
            k not in output_schema or output_schema[k].type == tdf.schema[k].type
            for k in tdf.encodings
        )
        nan_key = any(
            tdf.device_cols[k].is_floating_point() and tdf.maybe_nan(k)
            for k in keys
            if k in tdf.device_cols
        )
        if not (
            all(k in tdf.device_cols for k in keys)
            and not nan_key
            and tdf.host_table is None
            and not unsigned
            and (not tdf.has_encoded or (dict_keys_only and enc_schema_ok))
        ):
            raise FugueInvalidOperation(
                "compiled keyed map unavailable for partition keys "
                f"{keys}: keys must be plain or dictionary-encoded "
                "device columns (no nullable ints/maybe-NaN "
                "floats), non-key columns must be un-encoded, and "
                "encoded keys must keep their type in the output "
                "schema. Use a pandas-annotated transformer for "
                "these shapes."
            )
        return self._compiled_keyed_map(tdf, fn, output_schema, partition_spec)

    def _compiled_keyed_map(
        self,
        tdf: TorchDataFrame,
        fn: Callable,
        output_schema: Schema,
        partition_spec: PartitionSpec,
    ) -> TorchDataFrame:
        """Keyed compiled map: groupby-apply that never leaves the device.

        The dense plan when it applies; otherwise the sorted plan: sort the
        frame by (validity, keys, presort), derive row-aligned contiguous
        ``__segments__`` ids, and call the user fn once over the sorted
        columns. The fn computes per-group results with the ``group_ops``
        reductions (tables as long as the frame) and returns a row-aligned
        dict. Invalid rows sort to the tail, each in its own segment, and
        stay masked via ``__valid__``; the output keeps the sorted mask."""
        keys = partition_spec.partition_by
        dense = self._try_dense_keyed_map(tdf, fn, output_schema, partition_spec, keys)
        if dense is not None:
            return dense
        sort_items = tuple(partition_spec.get_sorts(tdf.schema, with_partition_keys=True).items())
        valid = tdf.device_valid_mask()
        with record_function("fugue::keyed_sort"):
            perm = _keyed_order(sort_items, tdf.device_cols, valid)
            sc = {n: c[perm] for n, c in tdf.device_cols.items()}
            sv = valid[perm]
            sc[SEGMENTS] = keyed_segments([sc[k] for k in keys], sv)
            sc[VALID] = sv
        with record_function("fugue::udf"):
            out = _keyed_output(fn(sc), output_schema, sv.shape[0])
        return TorchDataFrame(
            _internal=dict(
                device=tdf.device,
                device_cols=out,
                row_count=tdf._row_count,
                valid_mask=sv,
                encodings=_keyed_out_encodings(tdf, keys, output_schema),
                schema=output_schema,
            )
        )

    def _try_dense_keyed_map(
        self,
        tdf: TorchDataFrame,
        fn: Callable,
        output_schema: Schema,
        partition_spec: PartitionSpec,
        keys: List[str],
    ) -> Optional[TorchDataFrame]:
        """Sort-free keyed map (the dense plan).

        Integer keys with a bounded range map to dense segment ids (mixed
        radix over per-key spans); rows never move. Returns None when
        ineligible (presort, non-integer keys, a range product above
        ``_DENSE_MAP_RANGE``) — the caller then runs the sorted plan."""
        if len(partition_spec.presort) > 0:
            return None  # order inside groups requires the sorted plan
        if not all(_is_int(tdf.device_cols[k]) for k in keys):
            return None
        bounds: List[int] = []
        spans: List[int] = []
        for k in keys:
            enc = tdf.encodings.get(k)
            if enc is not None:
                # dict codes are bounded by construction: [-1, len) where
                # -1 is the NULL code — static metadata, no device probe
                lo, hi = -1, len(enc["dictionary"]) - 1
            else:
                lo, hi = tdf.key_range(k)  # cached per frame (one probe ever)
            if hi < lo:  # empty frame: degenerate single-bucket space
                lo, hi = 0, 0
            bounds.append(lo)
            spans.append(hi - lo + 1)
        total = 1
        for s in spans:
            total *= s
            if total > _DENSE_MAP_RANGE:
                return None
        buckets = 1 << max(1, total.bit_length())  # ≥ total+1: padding slot
        strides: List[int] = []
        acc = 1
        for s in reversed(spans):
            strides.append(acc)
            acc *= s
        strides.reverse()
        valid = tdf.device_valid_mask()
        ids = torch.zeros(valid.shape, dtype=torch.int64, device=valid.device)
        for k, lo, st in zip(keys, bounds, strides):
            ids += (tdf.device_cols[k].to(torch.int64) - lo) * st
        # invalid rows go to the top bucket, which no real key reaches
        sc: Dict[str, torch.Tensor] = dict(tdf.device_cols)
        sc[SEGMENTS] = torch.where(valid, ids, buckets - 1).to(torch.int32)
        sc[VALID] = valid
        sc[SEGMENT_SPACE] = torch.zeros(buckets, dtype=torch.bool, device=valid.device)
        sc[SPANS_SHARDS] = sc[SEGMENT_SPACE][:1]
        with record_function("fugue::udf"):
            out = _keyed_output(fn(sc), output_schema, valid.shape[0])
        # rows never moved: validity/count carry over unchanged
        return TorchDataFrame(
            _internal=dict(
                device=tdf.device,
                device_cols=out,
                row_count=tdf._row_count,
                valid_mask=tdf.valid_mask,
                encodings=_keyed_out_encodings(tdf, keys, output_schema),
                schema=output_schema,
            )
        )

    def _compiled_map(
        self, tdf: TorchDataFrame, fn: Callable, output_schema: Schema
    ) -> TorchDataFrame:
        """The keyless map: one call of the user fn over the whole frame.

        The input dict carries a reserved ``"__valid__"`` bool tensor
        marking real rows — functions doing reductions must mask with it;
        elementwise functions may ignore it. An output as long as the input
        keeps the input's valid rows; any other length is a new frame of
        that many rows."""
        cols = dict(tdf.device_cols)
        if len(cols) == 0:
            raise FugueInvalidOperation("no device columns to map on the compiled path")
        n_in = next(iter(cols.values())).shape[0]
        cols[VALID] = tdf.device_valid_mask()
        with record_function("fugue::udf"):
            res = _select_output(fn(cols), output_schema, exclude=(VALID,))
        out = {n: res[n] for n in output_schema.names}
        lengths = {v.shape[0] for v in out.values()}
        if len(lengths) != 1:
            raise FugueInvalidOperation(
                f"compiled transformer output columns differ in length: {sorted(lengths)}"
            )
        n_out = lengths.pop()
        same_len = n_out == n_in
        return TorchDataFrame(
            _internal=dict(
                device=tdf.device,
                device_cols=out,
                row_count=tdf._row_count if same_len else n_out,
                valid_mask=tdf.valid_mask if same_len else None,
                schema=output_schema,
            )
        )


def _select_output(
    out: Any, output_schema: Schema, exclude: Tuple[str, ...]
) -> Dict[str, torch.Tensor]:
    """The output schema's columns of a transformer's result, which must be
    a dict of tensors holding every one of them."""
    if not isinstance(out, dict) or not all(isinstance(v, torch.Tensor) for v in out.values()):
        raise FugueInvalidOperation("compiled transformer must return Dict[str, torch.Tensor]")
    out = {k: v for k, v in out.items() if k not in exclude}
    missing = [n for n in output_schema.names if n not in out]
    if len(missing) > 0:
        raise FugueInvalidOperation(f"compiled transformer output missing columns {missing}")
    if any(v.dim() != 1 for v in out.values()):
        raise FugueInvalidOperation("compiled transformer must return 1-D tensors")
    return out


def _keyed_output(out: Any, output_schema: Schema, n_in: int) -> Dict[str, torch.Tensor]:
    """A keyed transformer's output columns, each row-aligned with its
    input (the sorted or in-place rows)."""
    res = _select_output(out, output_schema, exclude=_RESERVED)
    if not all(v.shape[0] == n_in for v in res.values()):
        raise FugueInvalidOperation(
            "compiled keyed transformers must return row-aligned arrays "
            "(same length as the sorted input shard)"
        )
    return {n: res[n] for n in output_schema.names}


def _keyed_out_encodings(
    tdf: TorchDataFrame, keys: List[str], output_schema: Schema
) -> Dict[str, Any]:
    """Dictionary encodings to reattach to encoded partition keys that the
    UDF passed through (by contract) into the output."""
    return {k: dict(tdf.encodings[k]) for k in keys if k in tdf.encodings and k in output_schema}


class TorchExecutionEngine(ExecutionEngine):
    """Runs verbs on one torch device: ``cuda:0`` unless ``device`` names
    another (``device="cpu"`` for a machine with no card). With no device
    given and no card present, construction raises ``RuntimeError``.
    ``conf`` takes the stream keys of ``fugue_tpu_torch/constants.py``."""

    def __init__(self, device: Any = None, conf: Any = None):
        super().__init__(conf)
        self._device = resolve_device(device)
        self._host_engine = NativeExecutionEngine(conf)
        # the host engine runs maps and joins on this engine's behalf: one
        # counter sink, so their recoveries show on the engine the user holds
        self._host_engine._resilience_stats = self.resilience_stats
        self._map_engine = TorchMapEngine(self)
        self._pipeline_stats = PipelineStats()
        # the spill ladder: its counters, the live spill directories the
        # resource sampler reads, and the device budget with the source
        # that set it (conf, cuda_mem_get_info or host_meminfo)
        self._shuffle_stats = ShuffleStats()
        self._active_spill_dirs: set = set()
        self._last_join_strategy: Optional[str] = None
        self._shuffle_stats.set_budget(*device_budget_info(self.conf, self._device))
        # per-verb roofline recording (record only): while tracing is on,
        # each traced verb's close folds its bytes/s and rows/s into this
        # engine's tuner; fugue.tpu.tuning.rooflines=false opts out
        from ..tuning import install_verb_observer

        install_verb_observer(self)

    def _stats_sources(self) -> Dict[str, Callable[[], Any]]:
        """The base sources, ``pipeline`` and ``shuffle`` (the spill
        ladder's counters). The JAX engine's ``jit_cache`` has no
        counterpart here (no jit)."""
        return {
            **super()._stats_sources(),
            "pipeline": lambda: self._pipeline_stats,
            "shuffle": lambda: self._shuffle_stats,
        }

    def _resource_probe_fns(self) -> Dict[str, Callable[[Any], float]]:
        """The base probes, the ingest pipeline's ``overlap_fraction`` and
        ``shuffle_spill_bytes`` (the live spill directories' bytes).
        Registered from the base constructor, before the attributes they
        read exist, so they read them guarded."""

        def overlap(e: Any) -> float:
            ps = getattr(e, "_pipeline_stats", None)
            return float(ps.as_dict()["overlap_fraction"]) if ps is not None else 0.0

        def spill_bytes(e: Any) -> float:
            # on the sampler's thread while joins change the set: a race
            # must not break the sampler
            try:
                dirs = getattr(e, "_active_spill_dirs", None)
                return float(spill_dir_bytes(dirs)) if dirs else 0.0
            except Exception:
                return 0.0

        return {
            **super()._resource_probe_fns(),
            "overlap_fraction": overlap,
            "shuffle_spill_bytes": spill_bytes,
        }

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def pipeline_stats(self) -> PipelineStats:
        """The ingest pipeline's counters over this engine's streams."""
        return self._pipeline_stats

    @property
    def map_engine(self) -> TorchMapEngine:
        return self._map_engine

    def __repr__(self) -> str:
        return f"TorchExecutionEngine(device={self._device})"

    @contextmanager
    def run_conf_scope(self, overlay: Any = None) -> Iterator[ParamDict]:
        """The run's conf over this engine's and over its host engine's,
        which runs the host maps and joins of the run."""
        with super().run_conf_scope(overlay) as merged, self._host_engine.run_conf_scope(overlay):
            yield merged

    def thread_scope(self) -> Callable[[], ContextManager]:
        """The device and the current stream of the thread that starts a
        run, for its task threads to enter: a new thread would otherwise
        run on the default stream of the current device."""
        if self._device.type != "cuda":
            return nullcontext
        stream = torch.cuda.current_stream(self._device)

        @contextmanager
        def scope() -> Iterator[None]:
            with torch.cuda.device(self._device), torch.cuda.stream(stream):
                yield

        return scope

    @traced_verb("engine.to_df")
    def to_df(self, df: Any, schema: Any = None) -> TorchDataFrame:
        """A pandas frame, an arrow table, a local frame, rows with a
        schema, a ``TorchDataFrame`` or another engine's frame (a
        warehouse table: one fetch) as a ``TorchDataFrame`` on this
        engine's device. A stream (``LocalDataFrameIterableDataFrame``) is
        read whole."""
        if isinstance(df, TorchDataFrame):
            if df.device == self._device and (schema is None or df.schema == Schema(schema)):
                return df
            return TorchDataFrame(df.as_arrow(), schema=schema, device=self._device)
        if isinstance(df, (list, tuple)):
            df = ArrayDataFrame(df, schema)
        if isinstance(df, DataFrame):
            df = df.as_arrow()
        if isinstance(df, (pd.DataFrame, pa.Table)):
            return TorchDataFrame(df, schema=schema, device=self._device)
        raise NotImplementedError(
            f"to_df of {type(df)} is not ported (pandas, arrow, local frames and "
            "TorchDataFrame are)"
        )

    def _host(self, df: Any) -> LocalBoundedDataFrame:
        """``df`` on the host: a device frame's valid rows in one copy, any
        other frame (a stream too) as the host engine reads it."""
        with record_function("fugue::to_host"):
            if isinstance(df, TorchDataFrame):
                return df.as_local_bounded()
            return self._host_engine.to_df(df)

    def _back(self, df: DataFrame) -> TorchDataFrame:
        """A host result back on the device, staged through pinned memory."""
        with record_function("fugue::to_device"):
            return TorchDataFrame(df.as_arrow(), device=self._device, pinned=True)

    def load_df(
        self, path: Any, format_hint: Any = None, columns: Any = None, **kwargs: Any
    ) -> TorchDataFrame:
        """The files at ``path`` (parquet, csv or json), read by the host
        engine, on the device."""
        return self.to_df(
            self._host_engine.load_df(path, format_hint=format_hint, columns=columns, **kwargs)
        )

    def save_df(
        self, df: Any, path: str, format_hint: Any = None, mode: str = "overwrite",
        partition_spec: Optional[PartitionSpec] = None, force_single: bool = False, **kwargs: Any,
    ) -> Any:
        """Write ``df`` to ``path`` through the host engine; returns ``df``."""
        self._host_engine.save_df(
            self._host(df), path, format_hint=format_hint, mode=mode,
            partition_spec=partition_spec, force_single=force_single, **kwargs,
        )
        return df

    @traced_verb("engine.persist")
    def persist(self, df: Any, lazy: bool = False, **kwargs: Any) -> TorchDataFrame:
        tdf = self.to_df(df)
        if not lazy and tdf.device.type == "cuda":
            torch.cuda.synchronize(tdf.device)
        return tdf

    @traced_verb("engine.broadcast")
    def broadcast(self, df: Any) -> TorchDataFrame:
        """On one device every frame is already whole: the same tensors,
        with the valid mask, null masks and encodings they carry."""
        return self.to_df(df)

    @traced_verb("engine.repartition")
    def repartition(self, df: Any, partition_spec: PartitionSpec) -> Any:
        """The JAX engine's exchange (``repartition`` :779) sends each row
        to the shard its ``algo`` picks: by the hash of the keys (``hash``,
        the default with keys), evenly (``even``, the default without) or
        at random (``rand``); ``coarse`` moves none. On one device each of
        them picks the one device, so the frame comes back as it lies, with
        no copy. An empty spec returns ``df`` untouched.

        The out-of-core layout (the JAX engine's :800-830): a hash spec
        with keys over a one-pass stream, or over a frame whose estimate
        passes the device budget, goes through ``spill_repartition`` while
        ``fugue.tpu.shuffle.enabled`` holds: a one-pass stream of arrow
        chunks in which each key lies in exactly one chunk, never on the
        device whole."""
        if partition_spec is None or partition_spec.empty:
            return df
        by = list(partition_spec.partition_by)
        algo = partition_spec.algo or ("hash" if by else "even")
        if algo == "hash" and by and shuffle_enabled(self.conf):
            streaming = is_stream_frame(df)
            est = None if streaming else estimate_frame_bytes(df)
            if streaming or (est is not None and est > device_budget_bytes(self.conf, self._device)):
                try:
                    num = int(partition_spec.num_partitions or "0")
                except ValueError:
                    num = 0
                res = spill_repartition(self, df, by, num=num)
                if res is not None:
                    return res
        return self.to_df(df)

    def _repartition_single(self, df: Any) -> TorchDataFrame:
        """Every row on one device: the layout of a global (no PARTITION
        BY) window, which the JAX engine builds by moving every row to
        shard 0 (:855). On one device, the frame itself."""
        return self.to_df(df)

    # ---- zip/comap (``JaxExecutionEngine`` :2367-2456, :2522-2656) ------------

    def zip(
        self,
        dfs: DataFrames,
        how: str = "inner",
        partition_spec: Optional[PartitionSpec] = None,
        temp_path: Optional[str] = None,
        to_file_threshold: int = -1,
    ) -> DataFrame:
        """The device zip: the input frames held on the device as they are
        (``torch/zipped.py``), no blob built. On one card a key's rows are
        already together, so nothing moves: the JAX engine's hash exchange
        and the union dictionary that co-locates string keys across shards
        (``_zip_repartition`` :2458) have no work here. A zip that holds a
        stream goes to ``streaming_zip``. Cross and keyless zips, frames
        with columns on the host, and keys that are nullable or may hold
        NaN (not dictionary strings, whose NULL is a code) take the base
        engine's blob protocol, exactly where the JAX engine takes it; the
        route is decided from the schema before any work."""
        spec = partition_spec if partition_spec is not None else PartitionSpec()
        if any(is_stream_frame(d) for d in dfs.values()):
            zs = streaming_zip(self, dfs, how, spec)
            if zs is not None:
                return zs
        keys = list(spec.partition_by)
        if how.lower() != "cross" and len(keys) == 0 and len(dfs) > 0:
            keys = [n for n in dfs[0].schema.names if all(n in d.schema for d in dfs.values())]
        if how.lower() != "cross" and len(keys) > 0:
            tdfs = [self.to_df(d) for d in dfs.values()]

            def _key_ok(t: TorchDataFrame, k: str) -> bool:
                if k not in t.device_cols:
                    return False
                enc = t.encodings.get(k)
                if enc is not None and enc["kind"] == "dict":
                    return True
                # NULL and NaN keys do not group across frames on the host
                return enc is None and k not in t.null_masks and not t.maybe_nan(k)

            if all(
                t.host_table is None
                and len(t.device_cols) == len(t.schema)
                and all(_key_ok(t, k) for k in keys)
                for t in tdfs
            ):
                return ZippedTorchDataFrame(
                    frames=tdfs,
                    names=list(dfs.keys()),
                    named=dfs.has_key,
                    how=how.lower(),
                    keys=keys,
                    schemas=[t.schema for t in tdfs],
                    device=self._device,
                    presort=dict(spec.presort),
                )
        return super().zip(
            dfs, how=how, partition_spec=partition_spec, temp_path=temp_path,
            to_file_threshold=to_file_threshold,
        )

    def comap(
        self,
        df: DataFrame,
        map_func: Callable,
        output_schema: Any,
        partition_spec: Optional[PartitionSpec] = None,
        on_init: Optional[Callable] = None,
    ) -> DataFrame:
        """The comap of a device zip: each frame copied to the host once
        (span ``fugue::comap_to_host``), sorted by the presort (the
        comap's over the zip's), grouped by the keys in the order they
        first appear, and ``map_func`` called once a key that ``how``
        keeps; the output back on the device. No blob is built or read.
        A zipped stream goes to ``streaming_comap``, a blob frame to the
        base engine's comap."""
        if isinstance(df, ZippedStreamDataFrame):
            return streaming_comap(
                self, df, map_func, output_schema, partition_spec=partition_spec, on_init=on_init
            )
        if not isinstance(df, ZippedTorchDataFrame):
            return super().comap(
                df, map_func, output_schema, partition_spec=partition_spec, on_init=on_init
            )
        with record_function("fugue::comap"):
            return self._comap_device(df, map_func, output_schema, partition_spec, on_init)

    def _comap_device(
        self, df: ZippedTorchDataFrame, map_func: Callable, output_schema: Any,
        partition_spec: Optional[PartitionSpec], on_init: Optional[Callable],
    ) -> TorchDataFrame:
        out_schema = output_schema if isinstance(output_schema, Schema) else Schema(output_schema)
        keys, how, schemas = df._zip_keys, df._zip_how, df._zip_schemas
        names = [df._zip_names[i] if df._zip_named else f"_{i}" for i in range(len(schemas))]
        spec = PartitionSpec(partition_spec, by=keys) if partition_spec is not None else PartitionSpec(by=keys)
        cursor = spec.get_cursor(df.schema, 0)
        if on_init is not None:
            on_init(0, DataFrames({n: ArrayDataFrame([], s) for n, s in zip(names, schemas)}))
        # a comap-time presort overrides the zip-time one, as the blob
        # protocol serializes under the effective spec
        presort = dict(spec.presort) if len(spec.presort) > 0 else dict(df._zip_presort)
        with record_function("fugue::comap_to_host"):
            frames_pd = [f.as_pandas() for f in df.zip_frames]
        if len(presort) > 0:
            # NULLs first, as the host map's presort puts them
            frames_pd = [
                p.sort_values(
                    by=[c for c in presort if c in p.columns],
                    ascending=[v for c, v in presort.items() if c in p.columns],
                    kind="mergesort",
                    na_position="first",
                )
                if len(p) > 0 and any(c in p.columns for c in presort)
                else p
                for p in frames_pd
            ]
        grouped: List[Dict[Any, pd.DataFrame]] = []
        key_order: List[Any] = []
        seen: set = set()
        for p in frames_pd:
            g: Dict[Any, pd.DataFrame] = {}
            if len(p) > 0:
                for kv, sub in p.groupby(keys, dropna=False, sort=False):
                    kt = _null_safe_key(kv)
                    g[kt] = sub
                    if kt not in seen:
                        seen.add(kt)
                        key_order.append(kt)
            grouped.append(g)
        results: List[pa.Table] = []
        for no, kt in enumerate(k for k in key_order if _zip_keeps(how, [g.get(k) for g in grouped])):
            subs = [g.get(kt) for g in grouped]
            dfs = DataFrames(
                {
                    n: PandasDataFrame(s.reset_index(drop=True), sch, pandas_df_wrapper=True)
                    if s is not None
                    else ArrayDataFrame([], sch)
                    for n, s, sch in zip(names, subs, schemas)
                }
            )
            row = list(kt) + [None] * len(schemas)
            cursor.set(lambda r=row: r, no, 0)
            results.append(map_func(cursor, dfs).as_local_bounded().as_arrow())
        with record_function("fugue::to_device"):
            if len(results) == 0:
                return self.to_df(ArrayDataFrame([], out_schema))
            return self.to_df(ArrowDataFrame(pa.concat_tables([t.cast(out_schema.pa_schema) for t in results])))

    def _host_call(
        self, verb: Callable[..., DataFrame], *dfs: Any, span: str = "fugue::host_select"
    ) -> TorchDataFrame:
        """``verb(host engine, *host copies of dfs)`` (a row-local verb by
        default: select, filter, aggregate, dropna, fillna), back on the
        device; the host engine's work under the span ``span``."""
        locals_ = [self._host(df) for df in dfs]
        with record_function(span):
            res = verb(self._host_engine, *locals_)
        return self._back(res)

    # ---- row-local verbs -------------------------------------------------------

    @traced_verb("engine.filter")
    def filter(self, df: Any, condition: ColumnExpr, _plan: Any = None) -> TorchDataFrame:
        """Device filter: the condition becomes a validity mask — no rows
        move, downstream device verbs and the way to the host honor it.

        SQL three-valued NULL semantics (a row where the predicate is NULL
        is dropped): NaN floats and null masks are NULLs, and predicates on
        dictionary strings run on the host over the dictionary into a
        lookup table the device gathers by code. ``_plan`` lets ``select``
        reuse its predicate plan. A predicate the device evaluator refuses,
        or a frame with host columns, takes the host engine's filter."""
        tdf = self.to_df(df)
        if len(tdf.device_cols) > 0 and tdf.host_table is None:
            plan = _plan if _plan is not None else device_predicate_plan(
                condition, tdf.device_cols, tdf.encodings
            )
            if plan is not None:
                with record_function("fugue::filter"):
                    return _with_mask(tdf, self._predicate_mask(tdf, plan))
        return self._host_call(lambda h, d: h.filter(d, condition), tdf)

    def _predicate_mask(self, tdf: TorchDataFrame, plan: Any) -> torch.Tensor:
        """The frame's valid rows where the planned predicate is TRUE."""
        tables, cond = plan  # datetime literals rewritten to epochs
        dict_tables = {
            u: (name, torch.from_numpy(np.require(t, requirements=["C", "W"])).to(self._device))
            for u, (name, t) in tables.items()
        }
        code_cols = frozenset(c for c, e in tdf.encodings.items() if e["kind"] == "dict")
        cols = typed_columns(tdf.device_cols, tdf.schema)
        v, nl = evaluate_torch_3v(cols, tdf.null_masks, dict_tables, cond, code_cols)
        mask = tdf.device_valid_mask()
        for keep in (v, _not_null(nl)):
            if isinstance(keep, torch.Tensor):
                mask = mask & keep.to(torch.bool)
            elif not keep:
                mask = torch.zeros_like(mask)
        return mask

    @traced_verb("engine.select")
    def select(
        self,
        df: Any,
        cols: SelectColumns,
        where: Optional[ColumnExpr] = None,
        having: Optional[ColumnExpr] = None,
    ) -> TorchDataFrame:
        """SQL SELECT as the JAX engine plans it: a WHERE the device
        evaluator takes becomes a device filter; then a grouped aggregate
        of named keys goes to the device ``aggregate`` (HAVING filters its
        groups on the host, the declared column order is restored); a
        projection of device columns runs in ``_device_project``;
        everything else (a global aggregate, DISTINCT, host columns, a
        WHERE or expression the device refuses) runs on the host engine
        over the (filtered) frame's host copy."""
        tdf = self.to_df(df)
        sc = cols.replace_wildcard(tdf.schema)
        if where is not None and len(tdf.device_cols) > 0 and tdf.host_table is None:
            where_plan = device_predicate_plan(where, tdf.device_cols, tdf.encodings)
            if where_plan is not None:
                tdf = self.filter(tdf, where, _plan=where_plan)
                where = None
        if where is None and sc.has_agg and not sc.is_distinct:
            keys = [c for c in sc.all_cols if not is_agg(c)]
            aggs = [c for c in sc.all_cols if is_agg(c)]
            if len(keys) > 0 and all(
                isinstance(k, _NamedColumnExpr) and k.as_type is None and k.as_name == ""
                for k in keys
            ):
                spec = PartitionSpec(by=[k.name for k in keys])
                if _plan_device_agg(tdf, spec.partition_by, aggs) is not None:
                    res = self.aggregate(tdf, spec, aggs)
                    if having is not None:
                        # O(groups) rows: aggregate subexpressions read their
                        # computed output columns
                        cond = rewrite_having_aggs(having, aggs)
                        res = self._host_call(lambda h, d: h.filter(d, cond), res)
                    order = [c.output_name for c in sc.all_cols]
                    return res if res.schema.names == order else res[order]
        plain_cols = {
            k: v for k, v in tdf.device_cols.items()
            if k not in tdf.encodings and k not in tdf.null_masks
        }
        if (
            where is None
            and having is None
            and not sc.has_agg
            and not sc.is_distinct
            and len(tdf.device_cols) > 0
        ):
            if all(
                _is_passthrough(c, tdf.device_cols) or can_evaluate_on_device(c, plain_cols)
                for c in sc.all_cols
            ):
                with record_function("fugue::project"):
                    return self._device_project(tdf, sc)
        return self._host_call(lambda h, d: h.select(d, cols, where=where, having=having), tdf)

    def _device_project(self, tdf: TorchDataFrame, sc: SelectColumns) -> TorchDataFrame:
        """A projection on the device: named columns pass through with
        their encodings and masks; computed ones go through
        ``evaluate_torch``. Rows, valid mask and count stay as they are."""
        schema = sc.infer_schema(tdf.schema)
        exprs = sc.all_cols
        out_encodings: Dict[str, Any] = {}
        out_masks: Dict[str, torch.Tensor] = {}
        out_cols: Dict[str, torch.Tensor] = {}
        types: Dict[str, Optional[pa.DataType]] = {}
        n = next(iter(tdf.device_cols.values())).shape[0]
        cols = typed_columns(tdf.device_cols, tdf.schema)
        for c in exprs:
            name = c.output_name
            if _is_passthrough(c, tdf.device_cols):
                out_cols[name] = tdf.device_cols[c.name]
                types[name] = tdf.schema[c.name].type
                if c.name in tdf.encodings:
                    out_encodings[name] = tdf.encodings[c.name]
                if c.name in tdf.null_masks:
                    out_masks[name] = tdf.null_masks[c.name]
                continue
            tp = schema[name].type if schema is not None else c.infer_type(tdf.schema)
            v, types[name] = to_column(evaluate_torch(cols, c), tp)
            out_cols[name] = _full_column(v, n, self._device)
        if schema is None:
            schema = Schema([
                pa.field(c.output_name, types[c.output_name]
                         or pa.from_numpy_dtype(_np_dtype(out_cols[c.output_name].dtype)))
                for c in exprs
            ])
        # pass-through named columns keep their NaN-free proof; computed
        # float expressions may hold NaN (left out of the set is only safe
        # when the set is known, so start from the source's)
        nan_cols: Optional[set] = None
        if tdf._nan_cols is not None:
            nan_cols = set()
            for c in exprs:
                if isinstance(c, _NamedColumnExpr) and c.as_type is None:
                    if c.name in tdf._nan_cols:
                        nan_cols.add(c.output_name)
                elif out_cols[c.output_name].is_floating_point():
                    nan_cols.add(c.output_name)
        return TorchDataFrame(
            _internal=dict(
                device=self._device,
                device_cols=out_cols,
                host_tbl=None,
                row_count=tdf._row_count,
                valid_mask=tdf.valid_mask,
                nan_cols=nan_cols,
                encodings=out_encodings,
                null_masks=out_masks,
                schema=schema,
            )
        )

    @traced_verb("engine.dropna")
    def dropna(
        self, df: Any, how: str = "any", thresh: Optional[int] = None,
        subset: Optional[List[str]] = None,
    ) -> TorchDataFrame:
        """Frames whose every column is on the device: a NULL (NaN float,
        masked cell, negative dictionary code) drops its row by a new
        validity mask, no data moves. Others take the host engine."""
        tdf = self.to_df(df)
        if tdf.host_table is None and len(tdf.device_cols) == len(tdf.schema):
            with record_function("fugue::filter"):
                notnull = []
                for c in subset or tdf.schema.names:
                    arr = tdf.device_cols[c]
                    nn = None
                    if arr.is_floating_point():
                        nn = ~torch.isnan(arr)
                    if c in tdf.null_masks:
                        m = ~tdf.null_masks[c]
                        nn = m if nn is None else nn & m
                    if tdf.encodings.get(c, {}).get("kind") == "dict":
                        m = arr >= 0
                        nn = m if nn is None else nn & m
                    notnull.append(torch.ones_like(tdf.device_valid_mask()) if nn is None else nn)
                stacked = torch.stack(notnull, dim=0)
                if thresh is not None:
                    keep = stacked.sum(dim=0) >= thresh
                elif how == "all":
                    keep = stacked.any(dim=0)
                else:
                    keep = stacked.all(dim=0)
                return _with_mask(tdf, tdf.device_valid_mask() & keep)
        return self._host_call(
            lambda h, d: h.dropna(d, how=how, thresh=thresh, subset=subset), tdf
        )

    @traced_verb("engine.fillna")
    def fillna(self, df: Any, value: Any, subset: Optional[List[str]] = None) -> TorchDataFrame:
        """Frames whose every column is on the device: NaN floats and
        masked cells filled on the device (filled masks clear), the value
        cast to the column's dtype. ``value`` is checked as the host engine
        checks it; fills of dictionary or datetime columns, and frames with
        host columns, take the host engine."""
        tdf = self.to_df(df)
        if tdf.host_table is None and len(tdf.device_cols) == len(tdf.schema):
            # validate the value exactly like the host engine (no data moves)
            self._host_engine.fillna(ArrowDataFrame(None, tdf.schema), value, subset=subset)
            fills = dict(value) if isinstance(value, dict) else {
                c: value for c in (subset or tdf.schema.names)
            }
            if any(c in tdf.encodings for c in fills):
                return self._host_call(lambda h, d: h.fillna(d, value, subset=subset), tdf)
            with record_function("fugue::project"):
                out = dict(tdf.device_cols)
                filled = set()
                for c, v in fills.items():
                    arr = tdf.device_cols.get(c)
                    if arr is None:
                        continue
                    if c in tdf.null_masks:
                        out[c] = torch.where(tdf.null_masks[c], _fill_value(v, arr), arr)
                        filled.add(c)
                    elif arr.is_floating_point():
                        out[c] = torch.where(torch.isnan(arr), _fill_value(v, arr), arr)
            return TorchDataFrame(
                _internal=dict(
                    device=self._device,
                    device_cols=out,
                    host_tbl=None,
                    row_count=tdf._row_count,
                    valid_mask=tdf.valid_mask,
                    # filled columns become NaN-free — unless the fill value
                    # is itself NaN (a no-op fill must not fake the proof)
                    nan_cols=(
                        None if tdf._nan_cols is None else tdf._nan_cols - {
                            c for c, v in fills.items() if not (isinstance(v, float) and v != v)
                        }
                    ),
                    encodings=dict(tdf.encodings),
                    null_masks={c: m for c, m in tdf.null_masks.items() if c not in filled},
                    schema=tdf.schema,
                )
            )
        return self._host_call(lambda h, d: h.fillna(d, value, subset=subset), tdf)

    @traced_verb("engine.aggregate")
    def aggregate(
        self,
        df: Any,
        partition_spec: Optional[PartitionSpec],
        agg_cols: List[ColumnExpr],
    ) -> TorchDataFrame:
        """Two-phase device groupby of ``df`` by the spec's keys. A stream
        runs the streaming dense aggregate where its plan allows, and is
        materialized otherwise, as in the JAX engine. A plan the device
        declines runs on the host engine (``fugue::host_select``)."""
        if is_stream_frame(df):
            res = streaming_dense_aggregate(self, df, partition_spec, agg_cols)
            if res is not None:
                return res
        tdf = self.to_df(df)
        keys = list(partition_spec.partition_by) if partition_spec is not None else []
        plan = _plan_device_agg(tdf, keys, agg_cols)
        if plan is None:
            # a global aggregate, DISTINCT, an aggregate of an expression or
            # of a column the device plan does not reduce: the host engine,
            # as in the JAX engine
            return self._host_call(lambda h, d: h.aggregate(d, partition_spec, agg_cols), tdf)
        # dict codes / epoch ints group by device identity; nullable keys add
        # their mask as an extra key so NULL is its own group
        key_cols, mask_names = _group_key_cols(tdf, keys)
        value_arrs: Dict[str, torch.Tensor] = {}
        for src in {s for _, _, s in plan["aggs"]}:
            if src in plan["virtual"]:
                value_arrs[src] = _virtual_agg_array(tdf, *plan["virtual"][src])
                continue
            arr = tdf.device_cols[src]
            if src in plan["dict_srcs"]:
                # sorted-dict codes → NaN-null float view (−1 code = NULL)
                arr = torch.where(arr < 0, float("nan"), arr.to(torch.float64))
            elif src in plan["masked_srcs"]:
                # nullable int/bool value → float64 view with NaN as NULL
                # (exact: 64-bit ints with NULLs take the hi/lo split)
                arr = torch.where(tdf.null_masks[src], float("nan"), arr.to(torch.float64))
            value_arrs[src] = arr
        # a single plain integer key: the frame's cached range probe
        range_hint = None
        if (
            len(keys) == 1
            and len(mask_names) == 0
            and key_cols[keys[0]] is tdf.device_cols[keys[0]]
            and _is_int(key_cols[keys[0]])
        ):
            range_hint = tdf.key_range(keys[0])
        agg_entries = [
            (
                name,
                agg,
                value_arrs[src],
                # virtual arrays (hi/lo/notnull/min-max fills) are
                # pre-filled plain ints — never NaN-aware
                False
                if src in plan["virtual"]
                else (
                    tdf.maybe_nan(src) or src in plan["masked_srcs"] or src in plan["dict_srcs"]
                ),
            )
            for name, agg, src in plan["aggs"]
        ]
        res = self._try_dense_device_aggregate(tdf, keys, plan, agg_entries, range_hint)
        if res is not None:
            return res
        # the spans below name the steps of the partials route in a
        # torch.profiler trace (chip_smoke.py reads their host time); they
        # record nothing unless a profiler runs
        with record_function("fugue::device_groupby_partials"):
            partials = device_groupby_partials(
                key_cols, agg_entries, tdf.device_valid_mask(), range_hint=range_hint
            )
        with record_function("fugue::merge_partials"):
            merged = merge_partials(
                partials,
                keys + list(mask_names.values()),
                [(n, a) for n, a, _ in plan["aggs"]],
            )
        with record_function("fugue::decode"):
            merged = _decode_partial_keys(tdf, merged, mask_names)
            # finalize: avg = sum/count; restore declared output order and names
            out = pd.DataFrame()
            for k in keys:
                out[k] = merged[k]
            for spec in plan["post"]:
                out[spec["name"]] = spec["fn"](merged)
            tbl = pa.Table.from_pandas(
                out, schema=plan["schema"].pa_schema, preserve_index=False, safe=False
            )
        with record_function("fugue::to_device"):
            return self.to_df(tbl)

    def _try_dense_device_aggregate(
        self,
        tdf: TorchDataFrame,
        keys: List[str],
        plan: dict,
        agg_entries: List[Any],
        range_hint: Optional[Tuple[int, int]],
    ) -> Optional[TorchDataFrame]:
        """Finish a dense-plan aggregate ON THE DEVICE: ``key = kmin +
        arange``, ``valid = present > 0``, avg = sum/count, dtype casts to
        the declared schema. The result frame keeps its columns on the
        device with an explicit valid mask and a lazy row count.

        Returns None where the JAX engine's device finish declines (the
        caller then runs the partials route): no plain single integer key,
        a dictionary, masked or hi/lo value, a key range outside
        ``(0, 2**18]``, or a cast that could lose a NULL."""
        if range_hint is None:
            return None
        if plan["dict_srcs"] or plan["masked_srcs"]:
            return None
        if any(tag != "ones" for tag, _ in plan["virtual"].values()):
            # hi/lo/fill virtuals need the host-merge finish; the COUNT(*)
            # ones column is a plain int input the dense kernel handles
            return None
        if any(p.get("kind") not in ("pass", "avg") for p in plan["post"]):
            return None
        kmin, kmax = range_hint
        rng = kmax - kmin + 1
        if not (0 < rng <= _DENSE_MAX_RANGE):
            return None
        # predict kernel output dtypes; decline any cast a NULL could break
        predicted: Dict[str, np.dtype] = {
            name: np.dtype(np.int64) if agg == "count" else _np_dtype(arr.dtype)
            for name, agg, arr, _ in agg_entries
        }
        key_dt = _np_numeric_dtype(tdf.schema[keys[0]].type)
        if key_dt is None:
            return None
        spec_rows = _dense_finish_spec(plan, predicted)
        if spec_rows is None:
            return None
        buckets = dense_buckets(rng)
        outs = self._run_dense_fused(
            tdf.device_cols[keys[0]], tdf.device_valid_mask(), agg_entries, kmin, buckets,
            spec_rows, key_dt.str,
        )
        return _dense_frame(tdf.device, keys[0], outs, spec_rows, plan["schema"])

    def _run_dense_fused(
        self,
        key_arr: torch.Tensor,
        valid: torch.Tensor,
        agg_entries: List[Any],
        kmin: int,
        buckets: int,
        spec_rows: Tuple[Any, ...],
        key_dtype: str,
    ) -> Tuple[torch.Tensor, ...]:
        """Dense kernel, then the finish: one eager function in place of
        the JAX engine's one jitted program."""
        kernel, arrays, agg_sig = dense_kernel_parts(agg_entries, buckets)
        fin = self._make_dense_finish(
            buckets, tuple(s[0] for s in agg_sig), spec_rows, key_dtype
        )
        outs = kernel(key_arr, kmin, arrays, valid)
        return fin(kmin, outs[0], *outs[1:])

    @staticmethod
    def _make_dense_finish(
        buckets: int,
        arr_names: Tuple[str, ...],
        spec_rows: Tuple[Tuple[str, str, Tuple[str, ...], str], ...],
        key_dtype: str,
    ):
        """The finish that turns the dense kernel's tables into (key, valid,
        *outs) columns. One device means no padding to a row-shard
        multiple."""

        def fin(kmin: int, present: torch.Tensor, *aggs: torch.Tensor):
            named = dict(zip(arr_names, aggs))
            key = (torch.arange(buckets, dtype=torch.int64, device=present.device) + kmin).to(
                _torch_dtype(key_dtype)
            )
            valid = present > 0
            outs = []
            for kind, _, ins, tgt in spec_rows:
                if kind == "avg":
                    s = named[ins[0]].to(torch.float64)
                    c = named[ins[1]].to(torch.float64)
                    a = s / torch.where(c == 0, float("nan"), c)
                else:
                    a = named[ins[0]]
                outs.append(a.to(_torch_dtype(tgt)))
            return (key, valid, *outs)

        return fin

    # ---- plan verbs (``fugue_tpu_torch/plan``) ---------------------------------

    @traced_verb("engine.fused", annotate=False)
    def fused_apply(self, df: Any, steps: Any) -> DataFrame:
        """A fused chain of row-local verbs (``plan/fused.py``):

        - a one-pass stream applies the steps per chunk inside the chunk
          producer (``streaming_fused_steps``), and stays one-pass;
        - a frame whose every column is on the device runs the composed
          chain at once (``_try_fused_device``): the Kleene-AND of every
          filter as one validity mask, every projection under it, no frame
          between the verbs;
        - anything else applies the steps one verb at a time, which is
          what the unfused chain runs."""
        from .streaming import streaming_fused_steps

        with annotate("engine.fused"):
            if is_stream_frame(df):
                return streaming_fused_steps(self, df, steps)
            tdf = self.to_df(df)
            res = self._try_fused_device(tdf, steps)
            return res if res is not None else super().fused_apply(tdf, steps)

    def _try_fused_device(self, tdf: TorchDataFrame, steps: Any) -> Optional[TorchDataFrame]:
        """The composed chain on the device (reference ``_try_fused_device``
        :1042): the predicate as one validity mask, then the projection
        (``_device_project``); None where a step resists composition or the
        device evaluator (the caller then runs the steps one by one)."""
        from ..plan.fused import compose_steps

        if len(tdf.device_cols) == 0 or tdf.host_table is not None:
            return None
        composed = compose_steps(list(tdf.schema.names), steps)
        if composed is None:
            return None
        pred, outputs = composed
        plain_cols = {
            k: v for k, v in tdf.device_cols.items()
            if k not in tdf.encodings and k not in tdf.null_masks
        }
        if not all(_is_passthrough(c, tdf.device_cols) or can_evaluate_on_device(c, plain_cols) for c in outputs):
            return None
        if pred is not None:
            plan = device_predicate_plan(pred, tdf.device_cols, tdf.encodings)
            if plan is None:
                return None
            tdf = _with_mask(tdf, self._predicate_mask(tdf, plan))
        return self._device_project(tdf, SelectColumns(*outputs))

    def lowered_segment(
        self,
        dfs: List[Any],
        steps: Any,
        terminal: Any,
        partition_spec: Optional[PartitionSpec],
        fingerprint: str = "",
    ) -> DataFrame:
        """A lowered plan segment (``plan/lowering.py``), run over the raw
        columns where the gates of the reference's ``lowered_segment``
        (:1179) pass:

        - device frame → chain → dense aggregate: predicate, projections,
          the dense kernel (B1 ``bin_sum`` for a float32 SUM) and the
          finish on the device, with no frame between them;
        - stream → chain → dense aggregate: each chunk's raw needed
          columns go to the device once, and the same work folds into
          device accumulators;
        - stream → chain → take / distinct / broadcast-join probe: the
          chain runs on the device a chunk at a time, and the survivors
          feed the terminal.

        A segment the gates refuse runs per verb (``fused_apply``, then the
        terminal verb), counted in ``plan_stats.segments_fallback``; that
        path is the device verbs too. An error in planning is raised."""
        terminal = tuple(terminal)
        runner = self._plan_lowered_segment(dfs, list(steps), terminal, partition_spec, fingerprint)
        if runner is None:
            self.plan_stats.inc("segments_fallback")
            return super().lowered_segment(dfs, steps, terminal, partition_spec, fingerprint)
        with annotate("plan.segment"), get_tracer().span(
            "plan.segment",
            cat="plan",
            segment=fingerprint,
            terminal=terminal[0],
            steps=len(steps),
        ):
            res = runner()
        self.plan_stats.inc("segments_executed")
        return res

    def _plan_lowered_segment(
        self,
        dfs: List[Any],
        steps: List[Any],
        terminal: Tuple,
        partition_spec: Optional[PartitionSpec],
        fingerprint: str,
    ) -> Optional[Callable[[], DataFrame]]:
        """A zero-argument runner where the segment lowers, else None.
        Planning reads no stream data (reference :1242)."""
        from .streaming import (
            plan_lowered_steps_stream,
            plan_streaming_lowered_aggregate,
        )

        if len(steps) == 0:
            return None
        kind = terminal[0]
        if kind == "aggregate":
            keys = list(partition_spec.partition_by) if partition_spec is not None else []
            if is_stream_frame(dfs[0]):
                return plan_streaming_lowered_aggregate(
                    self, dfs[0], steps, keys, list(terminal[1]), fingerprint
                )
            return self._plan_lowered_bounded_aggregate(dfs[0], steps, keys, list(terminal[1]))
        probe = terminal[3] if kind == "join" else 0
        df = dfs[probe]
        if not is_stream_frame(df) or (kind == "join" and is_stream_frame(dfs[1 - probe])):
            return None
        mk = plan_lowered_steps_stream(self, df, steps, fingerprint)
        if mk is None:
            return None
        if kind == "take":
            return lambda: streaming_take(
                self, mk(), terminal[1], terminal[2], terminal[3], partition_spec
            )
        if kind == "distinct":
            return lambda: streaming_distinct(self, mk())
        if kind == "join":

            def run_join() -> DataFrame:
                ldf = mk()
                d1, d2 = (ldf, dfs[1 - probe]) if probe == 0 else (dfs[1 - probe], ldf)
                return self.join(d1, d2, how=terminal[1], on=list(terminal[2]))

            return run_join
        return None

    def _plan_lowered_bounded_aggregate(
        self, df: Any, steps: List[Any], keys: List[str], agg_cols: List[ColumnExpr]
    ) -> Optional[Callable[[], DataFrame]]:
        """Chain → dense aggregate over a frame on the device (reference
        :1314): the gates of ``_try_dense_device_aggregate``, with the key
        a raw plain integer column passed through the chain and every value
        a plain column or a device expression over plain columns. The
        runner evaluates the predicate and the value expressions over the
        raw columns and hands them to the dense kernel and its finish."""
        from ..plan.fused import compose_steps

        if len(keys) != 1:
            return None
        tdf = self.to_df(df)
        if len(tdf.device_cols) == 0 or tdf.host_table is not None:
            return None
        composed = compose_steps(list(tdf.schema.names), steps)
        if composed is None:
            return None
        pred, outputs = composed
        outs_by_name = {e.output_name: e for e in outputs}
        if len(outs_by_name) != len(outputs):
            return None
        plain_cols = {
            k: v for k, v in tdf.device_cols.items()
            if k not in tdf.encodings and k not in tdf.null_masks
        }
        zcols = typed_columns({k: v[:0] for k, v in plain_cols.items()}, tdf.schema)
        passthrough_ids = {id(e) for e in outputs if _is_passthrough(e, tdf.device_cols)}
        fields: List[pa.Field] = []
        out_dt: Dict[str, torch.dtype] = {}
        for e in outputs:
            name = e.output_name
            if id(e) in passthrough_ids:
                fields.append(pa.field(name, tdf.schema[e.name].type))
                continue
            if not can_evaluate_on_device(e, plain_cols):
                return None
            try:
                v, t = to_column(evaluate_torch(zcols, e), e.infer_type(tdf.schema))
            except Exception:  # noqa: BLE001 - the reference's probe refuses alike
                return None
            out_dt[name] = _full_column(v, 0, self._device).dtype
            fields.append(pa.field(name, t if t is not None else pa.from_numpy_dtype(_np_dtype(out_dt[name]))))
        tdf0 = TorchDataFrame(Schema(fields).create_empty_arrow_table(), device=self._device)
        plan = _plan_device_agg(tdf0, keys, agg_cols)
        if plan is None or plan["dict_srcs"] or plan["masked_srcs"] or not _lowerable_posts(plan):
            return None
        # a plain unsigned SUM/AVG sums its values as int64 and finishes on
        # the host, as the in-memory aggregate does (``_unsigned_sum_post``)
        host_finish = bool(plan["virtual"])
        key_expr = outs_by_name.get(keys[0])
        if key_expr is None or id(key_expr) not in passthrough_ids or key_expr.name not in plain_cols:
            return None
        raw_key = key_expr.name
        key_arr = tdf.device_cols[raw_key]
        if not _is_int(key_arr):
            return None
        key_dt = _np_numeric_dtype(tdf.schema[raw_key].type)
        virtual = plan["virtual"]
        srcs = sorted({virtual[s][1] if s in virtual else s for _, _, s in plan["aggs"]})
        actual: Dict[str, torch.dtype] = {}
        for s in srcs:
            e = outs_by_name.get(s)
            if e is None:
                return None
            if id(e) in passthrough_ids:
                if e.name not in plain_cols:
                    return None  # a masked or encoded source would lose its NULLs
                actual[s] = tdf.device_cols[e.name].dtype
            else:
                actual[s] = out_dt[s]
            if actual[s] == torch.bool:
                return None
        # the range of the RAW key (a superset of the filtered one: more
        # buckets at most, and the frame's probe is cached)
        kmin, kmax = tdf.key_range(raw_key)
        rng = kmax - kmin + 1
        if key_dt is None or not (0 < rng <= _DENSE_MAX_RANGE):
            return None
        spec_rows: Any = None
        if not host_finish:
            predicted = {
                name: np.dtype(np.int64) if agg == "count" else _np_dtype(actual[src])
                for name, agg, src in plan["aggs"]
            }
            spec_rows = _dense_finish_spec(plan, predicted)
            if spec_rows is None:
                return None
        pplan = None
        if pred is not None:
            pplan = device_predicate_plan(pred, tdf.device_cols, tdf.encodings)
            if pplan is None:
                return None
        buckets = dense_buckets(rng)
        n = key_arr.shape[0]
        probe_schema = Schema(fields)

        def run() -> DataFrame:
            valid = self._predicate_mask(tdf, pplan) if pplan is not None else tdf.device_valid_mask()
            cols = typed_columns(tdf.device_cols, tdf.schema)
            vals: Dict[str, torch.Tensor] = {}
            for s in srcs:
                e = outs_by_name[s]
                if id(e) in passthrough_ids:
                    vals[s] = tdf.device_cols[e.name]
                else:
                    v, _ = to_column(evaluate_torch(cols, e), probe_schema[s].type)
                    vals[s] = _full_column(v, n, self._device).to(actual[s])
            for vname, (tag, src) in virtual.items():
                vals[vname] = _plain_virtual_array(tag, vals[src], probe_schema[src].type)
            # floats are NaN-aware: a computed column may make NaN
            entries = [
                (name, agg, vals[src], vals[src].is_floating_point())
                for name, agg, src in plan["aggs"]
            ]
            if host_finish:
                kernel, arrays, agg_sig = dense_kernel_parts(entries, buckets)
                outs = kernel(key_arr, kmin, arrays, valid)
                return _finish_dense_host(self, outs, agg_sig, keys[0], _np_dtype(key_arr.dtype), kmin, plan)
            outs = self._run_dense_fused(key_arr, valid, entries, kmin, buckets, spec_rows, key_dt.str)
            return _dense_frame(self._device, keys[0], outs, spec_rows, plan["schema"])

        return run

    # ---- joins -------------------------------------------------------------

    def join(self, df1: Any, df2: Any, how: str, on: Optional[List[str]] = None) -> DataFrame:
        """One ``engine.join`` span (reference :1583) over :meth:`_join_impl`,
        its ``strategy`` attribute naming the plan that ran."""
        with annotate("engine.join"), get_tracer().span("engine.join", cat="engine") as sp:
            return self._join_impl(df1, df2, how, on, sp)

    def _join_impl(self, df1: Any, df2: Any, how: str, on: Optional[List[str]], sp: Any) -> DataFrame:
        """The JAX engine's ladder (:1586-1680) without its device_exchange
        rung, which needs a mesh. A one-pass stream takes the streaming join
        first (``streaming_hash_join``: a stream of the result); a stream
        the streaming plan refuses spills (``shuffle_spill_join``) rather
        than being read whole; it is read whole only where the spill
        refuses too (the shuffle off, a cross join, keys it cannot hash). Bounded sides go to ``choose_join_strategy`` with their
        estimates (and the sizes the tuner learned where an estimate is
        unknown): past the device budget they spill, bucket pair by bucket
        pair on the device; under it the device join runs. The span's
        ``strategy`` and ``reason`` are the reference's.

        The device join (``ops/join.py``): inner / left_outer / left_semi /
        left_anti by a probe of the hash-sorted right side when its keys
        are unique, by the 1:N/N:M expansion when they are not; right_outer
        mirrors left_outer; full_outer is left_outer ∪ the NULL-extended
        anti of the right side; cross runs through the expansion on a
        constant key. On one card ``broadcast`` and ``copartition`` both
        run it in the broadcast form: the right side whole and the left
        rows in place; the span names the one the reference's rule picks
        (``broadcast`` up to ``fugue.tpu.join.broadcast_max_rows`` right
        rows).

        Where the JAX engine joins on its host engine (keys it cannot align,
        host columns whose rows would move, expansions past
        ``MAX_EXPAND_ROWS``, a cross join past ``MAX_BROADCAST_ROWS``) the
        host engine joins the two frames' host copies, and the result comes
        back to the device (``fugue::host_join``)."""
        self._last_join_strategy = None
        tuner = self.tuner
        if is_stream_frame(df1) or is_stream_frame(df2):
            tune = tuner.join_params(None, None, None)[3]
            res = streaming_hash_join(self, df1, df2, how, on)
            if res is not None:
                sp.set(strategy="stream")
                return res
            if shuffle_enabled(self.conf):
                res = shuffle_spill_join(self, df1, df2, how, on, tune=tune)
                if res is not None:
                    sp.set(strategy="shuffle_spill", reason="stream ineligible for the streaming join plan")
                    return res
            self.log.warning("streaming join ineligible for this plan; materializing the stream")
        else:
            est_l, est_r, est_rr, tune = tuner.join_params(
                estimate_frame_bytes(df1), estimate_frame_bytes(df2), estimate_frame_rows(df2)
            )
            dec = choose_join_strategy(self.conf, est_l, est_r, est_rr, n_shards=1, device=self._device)
            if dec.strategy == "shuffle_spill" and shuffle_enabled(self.conf):
                res = shuffle_spill_join(self, df1, df2, how, on, tune=tune)
                if res is not None:
                    sp.set(strategy="shuffle_spill", reason=dec.reason)
                    return res
        jt = parse_join_type(how)
        j1, j2 = self.to_df(df1), self.to_df(df2)
        if jt in _KERNEL_HOW:
            res = self._join_device(j1, j2, _KERNEL_HOW[jt], on)
        elif jt == "right_outer":
            # mirrored left_outer, columns re-ordered to the contract schema
            res = self._join_device(j2, j1, "left_outer", on)
            _, out_schema = get_join_schemas(j1, j2, how="right_outer", on=on)
            if res is not None and res.schema.names != out_schema.names:
                res = res[out_schema.names]
        elif jt == "full_outer":
            res = self._full_outer_device(j1, j2, on)
        else:
            res = self._cross_device(j1, j2, on)
        if res is not None:
            sp.set(strategy="broadcast" if jt == "cross" else self._last_join_strategy or "device")
            return res
        sp.set(strategy="host")
        local1, local2 = self._host(j1), self._host(j2)
        with record_function("fugue::host_join"):
            local = self._host_engine.join(local1, local2, how=how, on=on)
        return self._back(local)

    def _full_outer_device(
        self, j1: TorchDataFrame, j2: TorchDataFrame, on: Optional[List[str]]
    ) -> Optional[TorchDataFrame]:
        """full_outer = left_outer(L,R) ∪ (anti(R,L) with NULL left
        values) — composed from device verbs, so it inherits all their
        representations (dictionaries, epochs, masks)."""
        _, out_schema = get_join_schemas(j1, j2, how="full_outer", on=on)
        left_part = self._join_device(j1, j2, "left_outer", on)
        if left_part is None:
            return None
        right_only = self._join_device(j2, j1, "anti", on)
        if right_only is None:
            return None
        ext = self._null_extend(right_only, out_schema, j1)
        if ext is None:
            return None
        lp = left_part if left_part.schema.names == out_schema.names else left_part[out_schema.names]
        res = self._union_device(lp, ext)
        if res is None:
            # the parts differ in column types or encodings: the JAX
            # engine's union concatenates them on its host engine
            local1, local2 = self._host(lp), self._host(ext)
            with record_function("fugue::host_union"):
                local = self._host_engine.union(local1, local2, distinct=False)
            res = self._back(local)
        return res

    def _null_extend(
        self, jr: TorchDataFrame, out_schema: Schema, j1: TorchDataFrame
    ) -> Optional[TorchDataFrame]:
        """Extend right-only rows to the full join schema: absent (left-
        side) columns become NULL in each dtype's device representation.
        None where a side has host columns (the JAX engine's host join)."""
        if jr.host_table is not None:
            return None
        n = next(iter(jr.device_cols.values())).shape[0]
        dev = jr.device
        cols: Dict[str, torch.Tensor] = {}
        encodings: Dict[str, Any] = dict(jr.encodings)
        null_masks: Dict[str, torch.Tensor] = dict(jr.null_masks)
        nan_new = set()
        for name in out_schema.names:
            if name in jr.device_cols:
                cols[name] = jr.device_cols[name]
                continue
            if name not in j1.device_cols:
                return None
            enc = j1.encodings.get(name)
            dt = j1.device_cols[name].dtype
            if enc is not None and enc["kind"] == "dict":
                cols[name] = torch.full((n,), -1, dtype=dt, device=dev)
                encodings[name] = dict(enc)
            elif dt.is_floating_point and enc is None:
                cols[name] = torch.full((n,), float("nan"), dtype=dt, device=dev)
                nan_new.add(name)
            else:
                cols[name] = torch.zeros(n, dtype=dt, device=dev)
                if enc is not None:
                    encodings[name] = dict(enc)
                null_masks[name] = torch.ones(n, dtype=torch.bool, device=dev)
        return TorchDataFrame(
            _internal=dict(
                device=dev,
                device_cols=cols,
                row_count=jr._row_count,
                valid_mask=jr.valid_mask,
                nan_cols=None if jr._nan_cols is None else set(jr._nan_cols) | nan_new,
                encodings=encodings,
                null_masks=null_masks,
                schema=out_schema,
            )
        )

    def _cross_device(
        self, j1: TorchDataFrame, j2: TorchDataFrame, on: Optional[List[str]]
    ) -> Optional[TorchDataFrame]:
        """Cross join via the expansion over a constant synthetic key
        (every left row matches every right row). ``on`` is not read, as in
        the JAX engine, except in the error of overlapping columns. None
        (the host join) for host columns, more than ``MAX_BROADCAST_ROWS``
        right rows or an expansion past ``MAX_EXPAND_ROWS``."""
        if any(c in j1.schema for c in j2.schema.names):
            get_join_schemas(j1, j2, how="cross", on=on)  # raises the join's own error
        for side, j in (("left", j1), ("right", j2)):
            if j.host_table is not None:
                return None
        n_right = next(iter(j2.device_cols.values())).shape[0]
        if n_right > MAX_BROADCAST_ROWS:
            return None
        mp = _safe_prefix("__mask__", j1.schema.names, j2.schema.names)
        lmp = _safe_prefix("__lmask__", j1.schema.names)
        kp = _safe_prefix("__xkey", j1.schema.names, j2.schema.names)
        n_left = next(iter(j1.device_cols.values())).shape[0]
        left_cols = dict(j1.device_cols)
        for c, m in j1.null_masks.items():
            left_cols[f"{lmp}{c}"] = m
        left_cols[f"{kp}0"] = torch.zeros(n_left, dtype=torch.int8, device=j1.device)
        right_entries: List[Any] = [(v, j2.device_cols[v], 0) for v in j2.schema.names]
        right_entries += [(f"{mp}{v}", m, True) for v, m in j2.null_masks.items()]
        with record_function("fugue::join_expand"):
            res = device_expand_join(
                "inner",
                left_cols,
                j1.device_valid_mask(),
                [f"{kp}0"],
                [torch.zeros(n_right, dtype=torch.int8, device=j2.device)],
                j2.device_valid_mask(),
                right_entries,
            )
        if res is None:
            return None
        new_cols, new_valid, _ = res
        null_masks = {c: new_cols.pop(f"{lmp}{c}") for c in j1.null_masks}
        null_masks.update({v: new_cols.pop(f"{mp}{v}") for v in j2.null_masks})
        out_schema = Schema(list(j1.schema.fields) + list(j2.schema.fields))
        return TorchDataFrame(
            _internal=dict(
                device=self._device,
                device_cols={n: new_cols[n] for n in out_schema.names},
                row_count=-1,
                valid_mask=new_valid,
                nan_cols=(
                    None
                    if j1._nan_cols is None or j2._nan_cols is None
                    else set(j1._nan_cols) | set(j2._nan_cols)
                ),
                encodings={**j1.encodings, **j2.encodings},
                null_masks=null_masks,
                schema=out_schema,
            )
        )

    def _prepare_join_keys(
        self, j1: TorchDataFrame, j2: TorchDataFrame, keys: List[str]
    ) -> Optional[Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]]:
        """Align the two frames' key representations for hashing/equality:
        ``(left key tensors by mangled name, right key tensors)``.

        Dictionary keys remap the right side's codes into the left's code
        space (host-side unification of the small dictionaries; NULLs get
        −1 left / −2 right so they never match); nullable numeric keys
        become float64 NaN views on both sides; epoch datetimes compare
        directly when the arrow types agree; plain keys of two dtypes meet
        in their common type. None where the JAX engine declines (and joins
        on its host engine)."""
        kp = _safe_prefix("__key", j1.schema.names)
        left_keys: Dict[str, torch.Tensor] = {}
        right_keys: List[torch.Tensor] = []
        for i, k in enumerate(keys):
            lenc, renc = j1.encodings.get(k), j2.encodings.get(k)
            lm, rm = j1.null_masks.get(k), j2.null_masks.get(k)
            la, ra = j1.device_cols[k], j2.device_cols[k]
            aligned = True
            if lenc is None and renc is None:
                if lm is None and rm is None:
                    lk, rk = la, ra
                    if la.dtype != ra.dtype:
                        # cross-dtype keys match by VALUE via the common
                        # type (pandas/SQL coercion semantics — the host
                        # oracle does the same; int64 past 2^53 matches
                        # inexactly there too)
                        if la.is_floating_point() or ra.is_floating_point():
                            lk, rk = la.to(torch.float64), ra.to(torch.float64)
                        else:
                            lk, rk = la.to(torch.int64), ra.to(torch.int64)
                elif la.is_floating_point() or (la.element_size() < 8 and ra.element_size() < 8):
                    lk, rk = _nullview(la, lm), _nullview(ra, rm)
                else:
                    aligned = False  # a 64-bit int with NULLs is inexact as a float64 view
            elif lenc is not None and renc is not None and lenc["kind"] == renc["kind"] == "dict":
                lk, rk = la, _remap_dict_codes(lenc, renc, ra)
            elif (
                lenc is not None
                and renc is not None
                and lenc["kind"] == renc["kind"] == "datetime"
                and lenc["type"] == renc["type"]
            ):
                if lm is not None or rm is not None:
                    aligned = False  # a date or timestamp with NULLs (a 64-bit masked key)
                else:
                    lk, rk = la, ra
            else:
                aligned = False  # the two types have no common device representation
            if not aligned:
                return None
            left_keys[f"{kp}{i}__"] = lk
            right_keys.append(rk)
        return left_keys, right_keys

    def _join_device(
        self, j1: TorchDataFrame, j2: TorchDataFrame, kernel_how: str, on: Any
    ) -> Optional[TorchDataFrame]:
        """The device hash join of ``j2`` onto ``j1`` for one of the four
        kernel types: the unique probe, and the expansion when the right
        keys repeat. None where the JAX engine joins on its host: a key type
        it does not join on its device, uint64 against another type (past
        2^63 it would wrap under an int64 cast), keys the preparers cannot
        align, host columns on the right, or on the left when the rows move,
        and an expansion past ``MAX_EXPAND_ROWS``."""
        key_schema, out_schema = get_join_schemas(
            j1, j2, how=_SCHEMA_HOW[kernel_how], on=on
        )
        keys = key_schema.names
        if not all(_is_join_key_type(f.type) for f in key_schema.fields):
            return None
        for k in keys:
            t1, t2 = j1.schema[k].type, j2.schema[k].type
            if t1 != t2 and pa.uint64() in (t1, t2):
                return None
        if j2.host_table is not None:
            return None
        with record_function("fugue::join_prep"):
            prepared = self._prepare_join_keys(j1, j2, keys)
            if prepared is None:
                return None
            left_key_arrs, right_key_arrs = prepared
            # the strategy the reference's rule names for this right side
            n_right = next(iter(j2.device_cols.values())).shape[0] if j2.device_cols else j2.count()
            self._last_join_strategy = (
                "broadcast" if n_right <= broadcast_max_rows(self.conf) else "copartition"
            )
            value_names = [n for n in j2.schema.names if n not in keys and n in out_schema]
            # value entries: (out_name, tensor, left_outer miss fill); masked
            # columns ship their mask as an extra gathered tensor (miss = True)
            mp = _safe_prefix("__mask__", j1.schema.names, j2.schema.names)
            lmp = _safe_prefix("__lmask__", j1.schema.names)
            right_entries: List[Any] = []
            out_value_encodings: Dict[str, Any] = {}
            gen_mask_names: List[str] = []  # plain non-floats: mask = ~match
            for v in value_names:
                arr = j2.device_cols[v]
                enc = j2.encodings.get(v)
                if enc is not None and enc["kind"] == "dict":
                    right_entries.append((v, arr, -1))
                    out_value_encodings[v] = enc
                elif arr.is_floating_point():
                    right_entries.append((v, arr, float("nan")))
                else:
                    right_entries.append((v, arr, 0))
                    if enc is not None:
                        out_value_encodings[v] = enc
                    if kernel_how == "left_outer" and v not in j2.null_masks:
                        gen_mask_names.append(v)
                if v in j2.null_masks:
                    right_entries.append((f"{mp}{v}", j2.null_masks[v], True))
            # the broadcast form: left rows stay in place, so the left's host
            # columns, encodings and masks ride along
            left_cols = dict(j1.device_cols)
            left_cols.update(left_key_arrs)
            left_valid = j1.device_valid_mask()
            right_valid = j2.device_valid_mask()
        host_tbl = j1.host_table
        nan_cols = j1._nan_cols
        encodings = dict(j1.encodings)
        null_masks = dict(j1.null_masks)
        probe_keys = list(left_key_arrs)
        with record_function("fugue::join_probe"):
            res = device_hash_join(
                kernel_how, left_cols, left_valid, probe_keys, right_key_arrs, right_valid,
                right_entries,
            )
        expanded = False
        if res is None:
            # duplicate right keys: the 1:N/N:M expansion. semi/anti keep row
            # alignment (mask-only); inner/left_outer materialize (left row,
            # match) pairs — rows move, host columns can't follow
            if kernel_how in ("inner", "left_outer"):
                if j1.host_table is not None:
                    return None
                # the left masks ride along with the gathered rows
                for c, m in j1.null_masks.items():
                    left_cols[f"{lmp}{c}"] = m
                host_tbl = None
                null_masks = {}
            with record_function("fugue::join_expand"):
                res = device_expand_join(
                    kernel_how, left_cols, left_valid, probe_keys, right_key_arrs,
                    right_valid, right_entries,
                )
            if res is None:
                return None
            expanded = True
        new_cols, new_valid, match = res
        # reassemble: pop probe keys, split off mask arrays
        for mk in probe_keys:
            new_cols.pop(mk, None)
        if expanded:
            for c in j1.null_masks:
                m = new_cols.pop(f"{lmp}{c}", None)
                if m is not None:
                    null_masks[c] = m
        for v in value_names:
            m = new_cols.pop(f"{mp}{v}", None)
            if m is not None:
                null_masks[v] = m
        if nan_cols is not None:
            # gathered float values may be NaN-filled on misses (left_outer),
            # and carry the right side's NaN (its NULLs) along: the JAX
            # package leaves the latter out on an inner join, so a NULL
            # comes out as a NaN value (ROADMAP.md C6)
            nan_cols = set(nan_cols) | {
                v
                for v in value_names
                if j2.device_cols[v].is_floating_point()
                and (kernel_how == "left_outer" or j2.maybe_nan(v))
            }
        if len(gen_mask_names) > 0:
            miss = torch.logical_not(match)
            for v in gen_mask_names:
                null_masks[v] = miss
        encodings.update(out_value_encodings)
        return TorchDataFrame(
            _internal=dict(
                device=self._device,
                device_cols={n: new_cols[n] for n in out_schema.names if n in new_cols},
                host_tbl=host_tbl,
                row_count=-1,
                valid_mask=new_valid,
                nan_cols=nan_cols,
                encodings={k: v for k, v in encodings.items() if k in out_schema},
                null_masks={k: v for k, v in null_masks.items() if k in out_schema},
                schema=out_schema,
            )
        )

    # ---- union and the set verbs ---------------------------------------------

    @traced_verb("engine.union")
    def union(self, df1: Any, df2: Any, distinct: bool = True) -> TorchDataFrame:
        """Device union: both frames' rows, one after the other, then the
        device ``distinct`` when ``distinct``. Dictionary columns unify into
        one sorted union dictionary with both sides' codes remapped; null
        masks concatenate with their columns; epoch datetimes concatenate
        when the arrow types agree. Frames whose schemas, column types or
        encodings differ, or with host columns, are unioned by the host
        engine (``fugue::host_union``), as in the JAX engine."""
        j1, j2 = self.to_df(df1), self.to_df(df2)
        res = self._union_device(j1, j2)
        if res is not None:
            return self.distinct(res) if distinct else res
        return self._host_call(
            lambda h, a, b: h.union(a, b, distinct=distinct), j1, j2, span="fugue::host_union"
        )

    @traced_verb("engine.subtract")
    def subtract(self, df1: Any, df2: Any, distinct: bool = True) -> TorchDataFrame:
        """EXCEPT: with ``distinct`` over two NULL-free plain frames, the
        device anti join of their distinct rows on every column; otherwise
        the host engine (``fugue::host_setop``), which refuses EXCEPT ALL."""
        return self._set_op(df1, df2, distinct, "anti", "subtract")

    @traced_verb("engine.intersect")
    def intersect(self, df1: Any, df2: Any, distinct: bool = True) -> TorchDataFrame:
        """INTERSECT: with ``distinct`` over two NULL-free plain frames, the
        device semi join of their distinct rows on every column; otherwise
        the host engine (``fugue::host_setop``)."""
        return self._set_op(df1, df2, distinct, "semi", "intersect")

    def _set_op(self, df1: Any, df2: Any, distinct: bool, kernel_how: str, verb: str) -> TorchDataFrame:
        j1, j2 = self.to_df(df1), self.to_df(df2)
        if distinct and _setop_device_ok(j1) and _setop_device_ok(j2):
            # set semantics treat NULL = NULL where the join kernels match
            # no NULL key: only provably NULL-free frames take the device.
            # The distinct right side has the unique keys of the probe.
            d1, d2 = self.distinct(j1), self.distinct(j2)
            res = self._join_device(d1, d2, kernel_how, on=list(j1.schema.names))
            if res is not None:
                return res
        return self._host_call(
            lambda h, a, b: getattr(h, verb)(a, b, distinct=distinct), j1, j2, span="fugue::host_setop"
        )

    @traced_verb("engine.distinct")
    def distinct(self, df: Any) -> TorchDataFrame:
        """SELECT DISTINCT. A frame whose every column is on the device
        runs the device groupby of all its columns with one presence count:
        the keys of the O(groups) partials are the distinct rows.
        Dictionary codes, epoch ints and null masks group by their device
        identity (a mask and a maybe-NaN float's ``isnan`` as extra keys:
        NULL = NULL, NaN = NaN, NULL != NaN) and decode on the host. Above
        ``fugue.tpu.max_partial_rows`` groups, and for frames with host
        columns, the host engine (``fugue::host_distinct``). A one-pass
        stream dedupes chunk by chunk (``streaming_distinct``)."""
        if is_stream_frame(df):
            return streaming_distinct(self, df)
        tdf = self.to_df(df)
        if tdf.host_table is None and len(tdf.device_cols) > 0:
            res = self._distinct_device(tdf)
            if res is not None:
                return res
        return self._host_call(lambda h, d: h.distinct(d), tdf, span="fugue::host_distinct")

    def _distinct_device(self, tdf: TorchDataFrame) -> Optional[TorchDataFrame]:
        """The distinct rows as the keys of the device groupby's partials,
        or None past ``fugue.tpu.max_partial_rows`` groups."""
        with record_function("fugue::distinct"):
            key_cols, mask_names = _group_key_cols(tdf, tdf.schema.names)
            count_name = "__n__"
            while count_name in tdf.schema:  # never shadow a user column
                count_name = "_" + count_name
            try:
                partials = device_groupby_partials(
                    key_cols,
                    [(count_name, "count", next(iter(key_cols.values())))],
                    tdf.device_valid_mask(),
                    max_partial_rows=self.conf.get(FUGUE_TPU_CONF_MAX_PARTIAL_ROWS, _MAX_PARTIAL_ROWS),
                )
            except PartialsTooLarge:
                return None  # near-unique rows: the O(groups) transfer stops paying off
            res = partials.drop(columns=[count_name]).drop_duplicates(ignore_index=True)
            res = _decode_partial_keys(tdf, res, mask_names)
        return self.to_df(PandasDataFrame(res[tdf.schema.names], tdf.schema))

    @traced_verb("engine.sample")
    def sample(
        self, df: Any, n: Optional[int] = None, frac: Optional[float] = None,
        replace: bool = False, seed: Optional[int] = None,
    ) -> TorchDataFrame:
        """TABLESAMPLE. ``frac`` alone, without replacement: row ``i``
        stays where the JAX engine's draw ``jax.random.uniform(PRNGKey(seed),
        ...)[i]`` is below ``frac`` (``ops/random.py``, the same float64
        bits), ANDed into the validity mask; no row moves, and a seed keeps
        the JAX engine's rows. ``n`` rows, or with replacement: the host
        engine (``fugue::host_sample``)."""
        tdf = self.to_df(df)
        if frac is not None and n is None and not replace:
            if tdf.host_table is None and len(tdf.device_cols) > 0:
                if seed is None:
                    seed = int(np.random.default_rng().integers(0, 2**31 - 1))
                with record_function("fugue::sample_mask"):
                    valid = tdf.device_valid_mask()
                    draw = uniform(seed, 0, valid.shape[0], valid.device)
                    return _with_mask(tdf, valid & (draw < float(frac)))
        return self._host_call(
            lambda h, d: h.sample(d, n=n, frac=frac, replace=replace, seed=seed), tdf,
            span="fugue::host_sample",
        )

    @traced_verb("engine.take")
    def take(
        self, df: Any, n: int, presort: str, na_position: str = "last",
        partition_spec: Optional[PartitionSpec] = None,
    ) -> TorchDataFrame:
        """ORDER BY ... LIMIT ``n``. With no partition keys, a presort,
        ``na_position="last"``, sort keys that order like their values
        (plain, datetime epochs, sorted dictionary codes) and ``n <=
        4096``: one lexicographic sort of the rows by ``(not valid,
        (isnull, key) for each sort key, row index)`` on the device, as the
        JAX engine's ``lax.sort`` orders them (DESC negates floats and
        inverts ints and bools; NaN and NULL last), then the first ``n``
        rows to the host for the JAX engine's pandas step (decode, sort,
        head). Everything else takes the host engine
        (``fugue::host_take``). A one-pass stream keeps running top-``n``
        buffers (``streaming_take``)."""
        if is_stream_frame(df):
            return streaming_take(self, df, n, presort, na_position, partition_spec)
        tdf = self.to_df(df)
        sorts = parse_presort_exp(presort) if presort else (
            partition_spec.presort if partition_spec is not None else {}
        )
        if (
            (partition_spec is None or len(partition_spec.partition_by) == 0)
            and len(sorts) > 0
            and na_position == "last"
            and 0 < n <= _TAKE_MAX_N
        ):
            if tdf.host_table is None and all(_sortable(tdf, c) for c in sorts):
                return self._take_device(tdf, n, list(sorts.items()))
        return self._host_call(
            lambda h, d: h.take(d, n, presort, na_position=na_position, partition_spec=partition_spec),
            tdf, span="fugue::host_take",
        )

    def _take_device(self, tdf: TorchDataFrame, n: int, sort_items: List[Tuple[str, bool]]) -> TorchDataFrame:
        """The device take: the first ``min(n, rows)`` rows of the sort to
        the host, then the JAX engine's pandas step over them."""
        with record_function("fugue::take_sort"):
            valid = tdf.device_valid_mask()

            def images():
                # least significant first: each key, then its NULL flag
                for name, asc in reversed(sort_items):
                    key = tdf.device_cols[name]
                    isnull = _take_isnull(tdf, name)
                    if not asc:
                        if key.is_floating_point():
                            key = -key if isnull is None else torch.where(isnull, key, -key)
                        elif key.dtype == torch.bool:
                            key = torch.logical_not(key)
                        else:
                            key = ~key  # a monotone reversal
                    yield _sort_image(key)
                    if isnull is not None:
                        yield isnull.to(torch.uint8)

            perm = _order_by(images(), valid)[: min(n, valid.shape[0])]
            host = {c: a[perm].cpu().numpy() for c, a in tdf.device_cols.items()}
            masks = {c: m[perm].cpu().numpy() for c, m in tdf.null_masks.items()}
            keep = valid[perm].cpu().numpy()
        pdf = pd.DataFrame({c: a[keep] for c, a in host.items()})
        for c, m in masks.items():
            pdf[c] = pdf[c].mask(m[keep])
        # decode codes and epochs, so the host sorts and returns VALUES
        pdf = _decode_partial_keys(tdf, pdf, {})
        pdf = pdf.sort_values(
            [c for c, _ in sort_items], ascending=[a for _, a in sort_items], na_position="last"
        ).head(n)
        return self.to_df(PandasDataFrame(pdf[tdf.schema.names].reset_index(drop=True), tdf.schema))

    def _union_device(self, j1: TorchDataFrame, j2: TorchDataFrame) -> Optional[TorchDataFrame]:
        """The device union of two frames, or None where the JAX engine
        takes its host engine."""
        if not _union_compatible(j1, j2):
            return None
        names = j1.schema.names
        cols1, cols2 = dict(j1.device_cols), dict(j2.device_cols)
        encodings: Dict[str, Any] = {}
        for c in names:
            enc1, enc2 = j1.encodings.get(c), j2.encodings.get(c)
            if enc1 is None:
                continue
            if enc1["kind"] == "datetime":
                encodings[c] = enc1
                continue
            # sorted union dictionary + remapped codes on both sides (the
            # NULL code −1 is preserved by the remap)
            union_dict = _sorted_union_dictionary([enc1["dictionary"], enc2["dictionary"]])
            for cols, enc in ((cols1, enc1), (cols2, enc2)):
                table = torch.from_numpy(_dict_mapping(enc["dictionary"], union_dict)).to(
                    self._device
                )
                cd = cols[c]
                cols[c] = torch.where(cd < 0, -1, table[cd.clamp(0, table.shape[0] - 1)])
            encodings[c] = {
                "kind": "dict", "dictionary": union_dict, "type": enc1["type"], "sorted": True,
            }
        # null masks travel with their columns; a side without a mask for
        # the column contributes all-False
        null_masks = {}
        for c in set(j1.null_masks) | set(j2.null_masks):
            null_masks[c] = torch.cat([_mask_or_false(j1, c), _mask_or_false(j2, c)])
        return TorchDataFrame(
            _internal=dict(
                device=self._device,
                device_cols={c: torch.cat([cols1[c], cols2[c]]) for c in names},
                row_count=-1,
                valid_mask=torch.cat([j1.device_valid_mask(), j2.device_valid_mask()]),
                nan_cols=(
                    None
                    if j1._nan_cols is None or j2._nan_cols is None
                    else set(j1._nan_cols) | set(j2._nan_cols)
                ),
                encodings=encodings,
                null_masks=null_masks,
                schema=j1.schema,
            )
        )


def _null_safe_key(kv: Any) -> tuple:
    """A group key as a tuple, every NULL (None, NaN, NaT) as None: NaN
    hashes by identity, so two frames' NaN keys would never meet
    (``JaxExecutionEngine`` :4068)."""
    out = []
    for v in kv if isinstance(kv, tuple) else (kv,):
        try:
            isna = pd.isna(v)
        except (TypeError, ValueError):
            isna = False
        out.append(None if isna is True else v)
    return tuple(out)


def _zip_keeps(how: str, subs: List[Any]) -> bool:
    """Whether a key with these sides (None: no rows) reaches the comap."""
    if how == "inner":
        return all(s is not None for s in subs)
    if how == "left_outer":
        return subs[0] is not None
    if how == "right_outer":
        return subs[-1] is not None
    return True


def _setop_device_ok(tdf: TorchDataFrame) -> bool:
    """Whether the JAX engine's EXCEPT/INTERSECT takes its device: a plain
    frame (no encoding, no null mask) proved NaN-free, every column on the
    device."""
    return (
        tdf.host_table is None
        and not tdf.has_encoded
        and tdf._nan_cols is not None
        and len(tdf._nan_cols) == 0
        and len(tdf.schema) > 0
    )


def _sortable(tdf: TorchDataFrame, name: str) -> bool:
    """A device column whose values order as its device tensor does:
    plain, an epoch datetime, or sorted dictionary codes."""
    if name not in tdf.device_cols:
        return False
    enc = tdf.encodings.get(name)
    return enc is None or enc["kind"] == "datetime" or (enc["kind"] == "dict" and enc.get("sorted", False))


def _take_isnull(tdf: TorchDataFrame, name: str) -> Optional[torch.Tensor]:
    """The NULL flag of sort key ``name`` as the JAX engine's take builds
    it (null mask, NaN, negative dictionary code), or None where no row can
    be NULL (an all-False flag does not move a row)."""
    key = tdf.device_cols[name]
    flags = []
    if name in tdf.null_masks:
        flags.append(tdf.null_masks[name])
    if key.is_floating_point() and tdf.maybe_nan(name):
        flags.append(torch.isnan(key))
    if tdf.encodings.get(name, {}).get("kind") == "dict":
        flags.append(key < 0)
    if len(flags) == 0:
        return None
    out = flags[0]
    for f in flags[1:]:
        out = out | f
    return out


def _union_compatible(j1: TorchDataFrame, j2: TorchDataFrame) -> bool:
    """Whether the JAX engine unions the two frames on its device: one
    schema, every column on the device, the same dtypes and encoding kinds
    (schema equality already forces matching arrow types, timestamp units
    included)."""
    return (
        j1.schema == j2.schema
        and len(j1.schema) > 0
        and j1.host_table is None
        and j2.host_table is None
        and all(j1.device_cols[c].dtype == j2.device_cols[c].dtype for c in j1.device_cols)
        and all(
            j1.encodings.get(c, {}).get("kind") == j2.encodings.get(c, {}).get("kind")
            for c in j1.schema.names
        )
    )


# join type → the kernel's name for it; and back, for the join schemas
_KERNEL_HOW = {"inner": "inner", "left_outer": "left_outer", "left_semi": "semi", "left_anti": "anti"}
_SCHEMA_HOW = {v: k for k, v in _KERNEL_HOW.items()}


def _safe_prefix(base: str, *name_sets: Any) -> str:
    """Internal payload-column prefix guaranteed not to shadow a user column
    (a user column may literally be named ``__mask__x``): prepend ``_`` until
    no provided name starts with the prefix."""
    p = base
    while any(any(str(n).startswith(p) for n in ns) for ns in name_sets):
        p = "_" + p
    return p


def _is_join_key_type(t: pa.DataType) -> bool:
    """The key types the JAX engine joins on its device."""
    return (
        pa.types.is_integer(t)
        or pa.types.is_floating(t)
        or pa.types.is_boolean(t)
        or pa.types.is_string(t)
        or pa.types.is_large_string(t)
        or pa.types.is_timestamp(t)
        or pa.types.is_date(t)
    )


def _nullview(arr: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """A float64 view of a key, NaN (never matching) where ``mask`` is set."""
    if mask is None:
        return arr.to(torch.float64)
    return torch.where(mask, float("nan"), arr.to(torch.float64))


def _remap_dict_codes(lenc: dict, renc: dict, right_codes: torch.Tensor) -> torch.Tensor:
    """Map right-side dictionary codes into the left's code space.

    Right values absent from the left dictionary get out-of-range codes
    (≥ len(left dict)) so they never match; NULL codes map −1 → −2 so
    NULL never equals NULL (SQL semantics)."""
    idx = pc.index_in(renc["dictionary"], value_set=lenc["dictionary"])
    n_left = len(lenc["dictionary"])
    mapped = idx.to_numpy(zero_copy_only=False)
    if len(mapped) == 0:  # an all-NULL right column: every code is −1
        return torch.full_like(right_codes, -2)
    mapped = np.where(np.isnan(mapped), n_left + np.arange(len(mapped)), mapped).astype(np.int32)
    table = torch.from_numpy(mapped).to(right_codes.device)
    return torch.where(
        right_codes < 0, -2, table[right_codes.clamp(0, table.shape[0] - 1)]
    ).to(torch.int32)


def _sorted_union_dictionary(pieces: List[pa.Array]) -> pa.Array:
    """Distinct sorted union of dictionary arrays, so code order ==
    lexicographic order stays true."""
    u = pa.concat_arrays(pieces).unique().drop_null()
    return u.take(pc.sort_indices(u))


def _dict_mapping(local_dict: pa.Array, union_dict: pa.Array) -> np.ndarray:
    """Index table from local dictionary positions to union positions.

    Apply as ``code >= 0 ? table[code] : -1`` (−1 is the NULL code). An
    empty local dictionary yields a single ``-1`` placeholder so device
    gathers stay in-bounds."""
    mapped = np.asarray(
        pc.index_in(local_dict, value_set=union_dict).to_numpy(zero_copy_only=False)
    )
    if mapped.size == 0:
        mapped = np.asarray([-1])
    return mapped.astype(np.int32)


def _mask_or_false(tdf: TorchDataFrame, name: str) -> torch.Tensor:
    """Column ``name``'s null mask, or all-False as long as the frame."""
    if name in tdf.null_masks:
        return tdf.null_masks[name]
    n = next(iter(tdf.device_cols.values())).shape[0]
    return torch.zeros(n, dtype=torch.bool, device=tdf.device)


def _torch_dtype(np_dtype_str: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np.dtype(np_dtype_str))).dtype


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def _np_numeric_dtype(tp: pa.DataType) -> Optional[np.dtype]:
    """The numpy dtype of a numeric arrow type's device tensor (an
    unsigned type's storage), else None."""
    if is_wide_unsigned(tp):
        return np.dtype(np.int32 if str(tp) == "uint16" else np.int64)
    if pa.types.is_integer(tp) or pa.types.is_floating(tp):
        return np.dtype(tp.to_pandas_dtype())
    return None


def _dense_finish_spec(
    plan: dict, predicted: Dict[str, np.dtype]
) -> Optional[Tuple[Tuple[str, str, Tuple[str, ...], str], ...]]:
    """(kind, name, input table names, target dtype) rows driving the
    on-device dense finish, or None when any declared-schema cast could
    corrupt a NULL. ``predicted`` maps each kernel output name to its
    actual table dtype."""
    spec_rows: List[Tuple[str, str, Tuple[str, ...], str]] = []
    for p, field_name in zip(plan["post"], plan["schema"].names[1:]):
        tgt = _np_numeric_dtype(plan["schema"][field_name].type)
        if tgt is None:
            return None
        if p["kind"] == "avg":
            ins: Tuple[str, ...] = (f"{p['name']}__sum", f"{p['name']}__cnt")
            src_dt = np.dtype(np.float64)
        else:
            ins = (p["name"],)
            src_dt = predicted[p["name"]]
        if src_dt.kind == "f" and tgt.kind != "f":
            return None  # NaN (NULL) would not survive the cast
        if src_dt.kind not in ("i", "u", "f") or tgt.kind not in ("i", "u", "f"):
            return None
        spec_rows.append((p["kind"], p["name"], ins, tgt.str))
    return tuple(spec_rows)


def _group_key_cols(
    tdf: TorchDataFrame, names: List[str]
) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """``(key tensors for the groupby, {key: its mask key's name})``.

    A nullable column adds its null mask as an extra key, so NULL forms its
    own group apart from the fill value. A float key that may hold NaN
    becomes (NaN → 0, isnan) the same way: NaN != NaN would otherwise split
    every NULL key into a group of its own."""
    key_cols: Dict[str, torch.Tensor] = {}
    mask_names: Dict[str, str] = {}

    def _mangled(c: str) -> str:
        mn = f"__null__{c}"
        while mn in tdf.schema:
            mn = "_" + mn
        return mn

    for c in names:
        arr = tdf.device_cols[c]
        if c in tdf.null_masks:
            key_cols[c] = arr
            mask_names[c] = _mangled(c)
            key_cols[mask_names[c]] = tdf.null_masks[c]
        elif arr.is_floating_point() and tdf.maybe_nan(c):
            isnan = torch.isnan(arr)
            key_cols[c] = torch.where(isnan, 0.0, arr)
            mask_names[c] = _mangled(c)
            key_cols[mask_names[c]] = isnan
        else:
            key_cols[c] = arr
    return key_cols, mask_names


def _from_storage_series(s: pd.Series, tp: pa.DataType, na: Optional[np.ndarray] = None) -> pd.Series:
    """Device values of arrow type ``tp`` as the host's: an unsigned type's
    storage (``torch/dataframe.py``) back to a nullable unsigned series, NA
    where ``na`` (or ``s``) says; other integers as nullable ``Int64`` where
    ``na`` is given; anything else (a float view of a masked value) as it
    is."""
    if s.dtype.kind == "f" or (na is None and not is_wide_unsigned(tp)):
        return s
    if not is_wide_unsigned(tp):
        return s.astype("Int64").mask(na)
    isna = s.isna().to_numpy() if na is None else (na | s.isna().to_numpy())
    vals = from_storage(s.fillna(0).to_numpy().astype(np.int64), tp)
    return pd.Series(pd.arrays.IntegerArray(vals, isna), index=s.index)


def _unsigned_sum_post(name: str, tp: pa.DataType, avg: bool) -> Callable[[pd.DataFrame], pd.Series]:
    """The finish of SUM/AVG of an unsigned column: the int64 sum wrapped to
    ``tp``'s width (uint64: its bits), NULL for a group with no value; AVG
    the wrapped sum read as unsigned over the count."""
    bits = tp.bit_width

    def fn(m: pd.DataFrame) -> pd.Series:
        total = m[f"{name}__sum"].to_numpy().astype(np.int64)
        if bits < 64:
            total = total & ((1 << bits) - 1)
        nn = m[f"{name}__nn"].to_numpy()
        if avg:
            with np.errstate(invalid="ignore", divide="ignore"):
                return pd.Series(total.view(np.uint64).astype(np.float64) / np.where(nn > 0, nn, np.nan),
                                 index=m.index)
        return pd.Series(pd.arrays.IntegerArray(total, nn <= 0), index=m.index)

    return fn


def _decode_partial_keys(
    tdf: TorchDataFrame, partials: pd.DataFrame, mask_names: Dict[str, str]
) -> pd.DataFrame:
    """Restore the keys' meaning on the host partials: dictionary codes →
    values, epoch ints → dates and timestamps, unsigned storage → values,
    masked cells → NA."""
    res = partials
    for c in res.columns:
        if c in tdf.schema and is_wide_unsigned(tdf.schema[c].type):
            na = res[mask_names[c]].astype(bool).to_numpy() if c in mask_names else None
            res[c] = _from_storage_series(res[c], tdf.schema[c].type, na)
    for c, mn in mask_names.items():
        res[c] = res[c].mask(res[mn].astype(bool))
        res = res.drop(columns=[mn])
    for c, enc in tdf.encodings.items():
        if c not in res.columns:
            continue
        if enc["kind"] == "dict":
            codes = res[c].to_numpy()
            valid = codes >= 0
            decoded = enc["dictionary"].take(
                pa.array(np.where(valid, codes, 0).astype(np.int64), mask=~valid)
            )
            res[c] = decoded.to_pandas()
        elif enc["kind"] == "datetime":
            ints = res[c]
            na = ints.isna()
            # through the storage type: arrow casts int32, not int64, to
            # date32 (the JAX engine's direct cast raises, ROADMAP.md C3)
            storage = pa.int32() if pa.types.is_date32(enc["type"]) else pa.int64()
            arr = pa.array(
                ints.fillna(0).to_numpy().astype(np.int64),
                mask=na.to_numpy() if na.any() else None,
            ).cast(storage).cast(enc["type"])
            res[c] = arr.to_pandas()
    return res


def _virtual_agg_array(tdf: TorchDataFrame, tag: str, src: Optional[str]) -> torch.Tensor:
    """A derived aggregation input:

    - ``ones``: COUNT(*)'s input, a ones column as long as the frame's
      device columns (the groupby masks invalid rows);
    - for a null-masked 64-bit int column, views the float64 NaN view
      cannot give exactly: ``hi``/``lo``, the NULL → 0 value split into
      32-bit halves, so SUM = Σhi·2³² + Σlo stays exact at any magnitude;
      ``minfill``/``maxfill``, NULLs as the dtype's extreme (the identity
      of min/max); ``notnull``, 1 where the value is not NULL (every row
      of a plain column); a uint64's halves are those of its value;
    - ``uval``: a plain unsigned column's values as int64, uint64's bits.
    """
    if tag == "ones":
        probe = next(iter(tdf.device_cols.values()))
        return torch.ones(probe.shape[0], dtype=torch.int64, device=probe.device)
    assert src is not None
    a, m = tdf.device_cols[src], tdf.null_masks.get(src)
    u64 = str(tdf.schema[src].type) == "uint64"
    if tag == "uval":
        # a plain unsigned column's values as int64 (uint64: its bits)
        return a ^ (-(1 << 63)) if u64 else a.to(torch.int64)
    if tag == "notnull":
        return torch.ones_like(a, dtype=torch.int64) if m is None else torch.logical_not(m).to(torch.int64)
    if tag in ("hi", "lo") and u64:
        # uint64: the halves of its value, from its bits
        bits = torch.where(m, 0, a ^ (-(1 << 63)))
        return (bits >> 32) & 0xFFFFFFFF if tag == "hi" else bits & 0xFFFFFFFF
    filled = torch.where(m, 0, a)
    if tag == "hi":
        return filled >> 32  # arithmetic shift: negative values keep their sign
    if tag == "lo":
        return filled & 0xFFFFFFFF
    ii = torch.iinfo(a.dtype)
    return torch.where(m, ii.max if tag == "minfill" else ii.min, a)


def _lowerable_posts(plan: dict) -> bool:
    """Whether a lowered segment's dense plan finishes its outputs: each
    a pass-through or an average (the finish on the device), or a plain
    unsigned SUM/AVG, whose only views are ``uval`` and ``notnull`` (the
    finish on the host)."""
    if any(tag not in ("uval", "notnull") for tag, _ in plan["virtual"].values()):
        return False
    return all(p.get("kind") in ("pass", "avg", "unsigned_sum") for p in plan["post"])


def _plain_virtual_array(tag: str, a: torch.Tensor, tp: pa.DataType) -> torch.Tensor:
    """``_virtual_agg_array``'s ``uval`` and ``notnull`` views of a plain
    (never NULL) column ``a`` of arrow type ``tp`` in its storage."""
    if tag == "notnull":
        return torch.ones_like(a, dtype=torch.int64)
    return a ^ (-(1 << 63)) if str(tp) == "uint64" else a.to(torch.int64)


def _is_passthrough(c: ColumnExpr, device_cols: Any) -> bool:
    """A bare (possibly renamed) named column over a device column — copies
    tensors and metadata without evaluation, so any encoding is fine."""
    return (
        isinstance(c, _NamedColumnExpr)
        and not c.wildcard
        and c.as_type is None
        and c.name in device_cols
    )


def _dense_frame(
    device: torch.device, key: str, outs: Tuple[torch.Tensor, ...], spec_rows: Tuple[Any, ...],
    schema: Schema,
) -> TorchDataFrame:
    """The dense finish's ``(key, valid, *outs)`` as the result frame: one
    row a bucket, the present ones valid, the row count lazy."""
    device_cols = {key: outs[0]}
    for (_, name, _, _), arr in zip(spec_rows, outs[2:]):
        device_cols[name] = arr
    return TorchDataFrame(
        _internal=dict(
            device=device, device_cols=device_cols, row_count=-1, valid_mask=outs[1], schema=schema
        )
    )


def _full_column(v: Any, n: int, device: torch.device) -> torch.Tensor:
    """An evaluated projection as a column of ``n`` rows: a Python literal
    fills as JAX fills it (bool, int64, float64), a 0-d tensor expands."""
    if not isinstance(v, torch.Tensor):
        dt = torch.bool if isinstance(v, bool) else (torch.int64 if isinstance(v, int) else torch.float64)
        return torch.full((n,), v, dtype=dt, device=device)
    if v.dim() == 0:
        return v.to(device).expand(n).clone()
    return v


def _not_null(nl: Any) -> Any:
    return torch.logical_not(nl) if isinstance(nl, torch.Tensor) else not nl


def _with_mask(tdf: TorchDataFrame, mask: torch.Tensor) -> TorchDataFrame:
    """``tdf``'s tensors under a new validity mask; the row count is
    computed lazily from it."""
    return TorchDataFrame(
        _internal=dict(
            device=tdf.device,
            device_cols=dict(tdf.device_cols),
            host_tbl=None,
            row_count=-1,
            valid_mask=mask,
            nan_cols=tdf._nan_cols,
            encodings=dict(tdf.encodings),
            null_masks=dict(tdf.null_masks),
            schema=tdf.schema,
        )
    )


def _fill_value(v: Any, arr: torch.Tensor) -> torch.Tensor:
    """``v`` in ``arr``'s dtype, as ``jnp.asarray(v, arr.dtype)``."""
    return torch.tensor(v, dtype=arr.dtype, device=arr.device)


def _plan_device_agg(
    tdf: TorchDataFrame, keys: List[str], agg_cols: List[ColumnExpr]
) -> Optional[dict]:
    """The device-aggregation plan of the JAX engine, or None where the
    JAX engine's is None (its host aggregate): ``aggs`` (name, agg, source
    column), ``post`` (how each output is finished, ``fn`` over the merged
    partials), the output ``schema``, and the sources that need a view:
    ``dict_srcs`` (dictionary codes), ``masked_srcs`` (nullable int/bool)
    and ``virtual`` (``{name: (tag, real source)}``).

    A plain uint16/32/64 source's SUM and AVG wrap in its type, as the JAX
    package's do (the ``uval`` view, ``_unsigned_sum_post``)."""
    if len(keys) == 0 or not all(k in tdf.device_cols for k in keys):
        return None
    aggs: List[Any] = []
    post: List[dict] = []
    virtual: Dict[str, Any] = {}  # vname -> (tag, real src)
    masked_srcs: set = set()
    dict_srcs: set = set()
    fields: List[pa.Field] = [tdf.schema[k] for k in keys]
    for c in agg_cols:
        if not isinstance(c, _FuncExpr) or not c.is_agg or c.is_distinct or len(c.args) != 1:
            return None
        name = c.output_name
        func = c.func.upper()
        arg = c.args[0]
        if func == "COUNT" and (
            (isinstance(arg, _LitColumnExpr) and arg.value is not None)  # COUNT(NULL) is 0
            or (isinstance(arg, _NamedColumnExpr) and arg.name == "*")
        ):
            # COUNT(*) / COUNT(1): every row in the group counts, NULLs
            # included — a ones column summed under the validity mask
            if name == "":
                return None
            virtual["__ones__"] = ("ones", None)
            aggs.append((name, "sum", "__ones__"))
            post.append({"name": name, "kind": "pass", "fn": (lambda m, _n=name: m[_n])})
            tp = c.infer_type(tdf.schema)
            fields.append(pa.field(name, tp if tp is not None else pa.int64()))
            continue
        if not isinstance(arg, _NamedColumnExpr):
            return None
        src = arg.name
        if src not in tdf.device_cols:
            return None
        enc = tdf.encodings.get(src)
        if enc is not None:
            # sorted-dictionary strings: code order == value order, so
            # MIN/MAX/COUNT reduce over codes (as NaN-null float views) and
            # the min/max code decodes back to its string
            if not (enc["kind"] == "dict" and enc.get("sorted") and func in ("MIN", "MAX", "COUNT")):
                return None
            dict_srcs.add(src)
        src_type = tdf.schema[src].type
        if is_wide_unsigned(src_type) and func in ("SUM", "AVG") and name != "" and src not in tdf.null_masks:
            # the JAX package sums a plain unsigned column in its type,
            # wrapping at its width: the values (uint64's bits) summed as
            # int64 keep the low bits, and the post wraps them; AVG divides
            # the wrapped sum read as unsigned. A nullable one takes the
            # masked views below, as there
            uv, nn = f"{src}__uval__", f"{name}__nn"
            virtual[uv] = ("uval", src)
            virtual[f"{src}__nn__"] = ("notnull", src)
            aggs.append((f"{name}__sum", "sum", uv))
            aggs.append((nn, "sum", f"{src}__nn__"))
            post.append({"name": name, "kind": "unsigned_sum",
                         "fn": _unsigned_sum_post(name, src_type, func == "AVG")})
            tp = c.infer_type(tdf.schema)
            fields.append(pa.field(name, tp if tp is not None else pa.float64()))
            continue
        big_int_masked = False
        if src in tdf.null_masks:
            if tdf.device_cols[src].dtype == torch.int64:
                # int64 with NULLs: the float64 NaN view loses exactness
                # past 2^53 — SUM/AVG split into hi/lo 32-bit halves
                # (exact), MIN/MAX fill NULLs with dtype extremes, counts
                # come from the null mask
                big_int_masked = True
            else:
                masked_srcs.add(src)
        if name == "" or func not in ("SUM", "AVG", "MIN", "MAX", "COUNT"):
            return None
        tp = c.infer_type(tdf.schema)
        if big_int_masked:
            nn = f"{name}__nn"
            virtual[f"{src}__nn__"] = ("notnull", src)
            if func in ("SUM", "AVG"):
                virtual[f"{src}__hi__"] = ("hi", src)
                virtual[f"{src}__lo__"] = ("lo", src)
                aggs.append((f"{name}__hi", "sum", f"{src}__hi__"))
                aggs.append((f"{name}__lo", "sum", f"{src}__lo__"))
                aggs.append((nn, "sum", f"{src}__nn__"))
                if func == "SUM":
                    # exact int64 reassembly; SUM over an all-NULL group is NULL
                    fn: Any = lambda m, _n=name: (  # noqa: E731
                        (m[f"{_n}__hi"].astype("int64") * (1 << 32) + m[f"{_n}__lo"].astype("int64"))
                        .astype("Int64")
                        .where(m[f"{_n}__nn"] > 0)
                    )
                else:
                    fn = lambda m, _n=name: (  # noqa: E731
                        (m[f"{_n}__hi"].astype("float64") * (1 << 32) + m[f"{_n}__lo"].astype("float64"))
                        / m[f"{_n}__nn"].where(m[f"{_n}__nn"] > 0)
                    )
                post.append({"name": name, "fn": fn})
            elif func in ("MIN", "MAX"):
                tag = "minfill" if func == "MIN" else "maxfill"
                virtual[f"{src}__{tag}__"] = (tag, src)
                aggs.append((name, func.lower(), f"{src}__{tag}__"))
                aggs.append((nn, "sum", f"{src}__nn__"))
                # Int64 extension keeps <NA> exact (a float NaN detour would
                # corrupt values past 2^53)
                post.append({
                    "name": name,
                    "fn": (lambda m, _n=name, _t=src_type: _from_storage_series(
                        m[_n], _t, (m[f"{_n}__nn"] <= 0).to_numpy())),
                })
            else:  # COUNT
                aggs.append((name, "sum", f"{src}__nn__"))
                post.append({"name": name, "fn": (lambda m, _n=name: m[_n])})
            fields.append(pa.field(name, tp if tp is not None else pa.float64()))
            continue
        if src in dict_srcs and func in ("MIN", "MAX"):
            dictionary = enc["dictionary"]  # type: ignore[index]

            def _decode(m: Any, _n: str = name, _d: Any = dictionary) -> Any:
                codes = m[_n]
                na = codes.isna()
                arr = pa.array(
                    codes.fillna(0).to_numpy().astype(np.int64),
                    mask=na.to_numpy() if na.any() else None,
                )
                return _d.take(arr).to_pandas()

            aggs.append((name, func.lower(), src))
            post.append({"name": name, "fn": _decode})
        elif func in ("SUM", "MIN", "MAX"):
            aggs.append((name, func.lower(), src))
            post.append({"name": name, "kind": "pass",
                         "fn": (lambda m, _n=name, _t=src_type: _from_storage_series(m[_n], _t))})
        elif func == "COUNT":
            aggs.append((name, "count", src))
            post.append({"name": name, "kind": "pass", "fn": (lambda m, _n=name: m[_n])})
        else:  # AVG
            aggs.append((f"{name}__sum", "sum", src))
            aggs.append((f"{name}__cnt", "count", src))
            post.append({
                "name": name,
                "kind": "avg",
                "fn": (lambda m, _n=name: m[f"{_n}__sum"] / m[f"{_n}__cnt"]),
            })
        fields.append(pa.field(name, tp if tp is not None else pa.float64()))
    return {
        "aggs": aggs,
        "post": post,
        "schema": Schema(fields),
        "masked_srcs": masked_srcs,
        "dict_srcs": dict_srcs,
        "virtual": virtual,
    }
