"""TorchExecutionEngine — the port of ``JaxExecutionEngine``
(``fugue_tpu/jax/execution_engine.py``) for one CUDA device.

The port has ``to_df``, ``persist``, the device ``aggregate`` and the
compiled maps behind ``transform`` (``TorchMapEngine``).

``aggregate`` takes any number of keys of any integer, float, bool,
string, date or timestamp column, nullable or not, with
SUM/COUNT/AVG/MIN/MAX and COUNT(*) over numeric, nullable-int, bool and
dictionary-string columns. A plain single integer key whose range fits
``2**18`` buckets takes the dense route and finishes on the device; every
other plan runs the device groupby (``ops/segment.py``) into per-group
partials, merges them on the host and comes back to the device as the
result frame, as the JAX engine does.

There is no host fallback: a plan that the JAX engine hands to its host
engine raises ``NotImplementedError`` here, naming its ROADMAP.md item.
"""

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import torch
from torch.profiler import record_function

from ..collections.partition import PartitionSpec
from ..column.expressions import ColumnExpr, _FuncExpr, _LitColumnExpr, _NamedColumnExpr
from ..exceptions import FugueInvalidOperation
from ..execution.execution_engine import ExecutionEngine, MapEngine
from ..ops.segment import (
    _DENSE_MAX_RANGE,
    _is_int,
    _keyed_order,
    dense_buckets,
    dense_kernel_parts,
    device_groupby_partials,
    keyed_segments,
    merge_partials,
)
from ..parallel.device import resolve_device
from ..schema import Schema
from ..torch_annotations import torch_dict_udf
from .dataframe import TorchDataFrame
from .group_ops import SEGMENT_SPACE, SEGMENTS, SPANS_SHARDS, VALID

_ENCODED = "ROADMAP.md A.3 encoded columns"
_VERBS = "ROADMAP.md A.8 remaining verbs"
_HOST_UDFS = "ROADMAP.md A.4b host transformers"
# the largest segment-id space of the dense keyed map: the JAX package's
# default for FUGUE_TPU_CONF_DENSE_MAP_RANGE (the port has no such knob)
_DENSE_MAP_RANGE = 1 << 20
_RESERVED = (SEGMENTS, VALID, SEGMENT_SPACE, SPANS_SHARDS)


class TorchMapEngine(MapEngine):
    """The port of ``JaxMapEngine`` (``fugue_tpu/jax/execution_engine.py``):
    a ``Dict[str, torch.Tensor]`` transformer runs on the engine's device in
    one of the three forms the JAX package compiles:

    - **keyless** (``_compiled_map``): the whole frame in one call;
    - **keyed, dense plan** (``_try_dense_keyed_map``): integer keys of a
      bounded range map to dense segment ids; rows stay in place;
    - **keyed, sorted plan** (``_compiled_keyed_map``): rows sorted by
      (validity, keys, presort), contiguous segment ids.

    The JAX package sends every other transformer to its host engine; the
    port has none and raises ``NotImplementedError`` (ROADMAP.md A.4b).
    On one device every group is whole: the JAX package's hash exchange
    before the sorted plan, and its cross-shard merge of group tables
    under the dense plan, have nothing to do here."""

    def map_dataframe(
        self,
        df: Any,
        map_func: Callable,
        output_schema: Any,
        partition_spec: PartitionSpec,
    ) -> TorchDataFrame:
        engine: TorchExecutionEngine = self.execution_engine  # type: ignore[assignment]
        if not isinstance(output_schema, Schema):
            output_schema = Schema(output_schema)
        fn = torch_dict_udf(map_func)
        tdf = engine.to_df(df)
        keys = partition_spec.partition_by
        if len(keys) == 0:
            if len(partition_spec.presort) > 0:
                raise NotImplementedError(
                    "a presort without partition keys orders the frame through a "
                    "repartition, which is not ported (ROADMAP.md A.7 repartition)"
                )
            if tdf.has_encoded:
                # the JAX package renders encoded/masked columns as real
                # values on its host engine
                raise NotImplementedError(
                    "a keyless map over encoded or nullable columns runs on the JAX "
                    f"package's host engine, which is not ported ({_HOST_UDFS})"
                )
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
            and (not tdf.has_encoded or (dict_keys_only and enc_schema_ok))
        ):
            raise FugueInvalidOperation(
                "compiled keyed map unavailable for partition keys "
                f"{keys}: keys must be plain or dictionary-encoded "
                "device columns (no nullable ints/maybe-NaN "
                "floats), non-key columns must be un-encoded, and "
                "encoded keys must keep their type in the output "
                "schema. Use a pandas-annotated transformer for "
                f"these shapes (on the JAX package: {_HOST_UDFS})."
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
    given and no card present, construction raises ``RuntimeError``."""

    def __init__(self, device: Any = None):
        self._device = resolve_device(device)
        self._map_engine = TorchMapEngine(self)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def map_engine(self) -> TorchMapEngine:
        return self._map_engine

    def __repr__(self) -> str:
        return f"TorchExecutionEngine(device={self._device})"

    def to_df(self, df: Any, schema: Any = None) -> TorchDataFrame:
        """A pandas frame, an arrow table or a ``TorchDataFrame`` as a
        ``TorchDataFrame`` on this engine's device."""
        if isinstance(df, TorchDataFrame):
            if df.device == self._device and (schema is None or df.schema == Schema(schema)):
                return df
            return TorchDataFrame(df.as_arrow(), schema=schema, device=self._device)
        if isinstance(df, (pd.DataFrame, pa.Table)):
            return TorchDataFrame(df, schema=schema, device=self._device)
        raise NotImplementedError(
            f"to_df of {type(df)} is not ported (pandas, arrow and TorchDataFrame are)"
        )

    def persist(self, df: Any, lazy: bool = False, **kwargs: Any) -> TorchDataFrame:
        tdf = self.to_df(df)
        if not lazy and tdf.device.type == "cuda":
            torch.cuda.synchronize(tdf.device)
        return tdf

    def aggregate(
        self,
        df: Any,
        partition_spec: Optional[PartitionSpec],
        agg_cols: List[ColumnExpr],
    ) -> TorchDataFrame:
        """Two-phase device groupby of ``df`` by the spec's keys."""
        tdf = self.to_df(df)
        keys = list(partition_spec.partition_by) if partition_spec is not None else []
        if len(keys) == 0:
            raise NotImplementedError(
                f"aggregate by 0 keys (a global aggregate) is not ported ({_VERBS})"
            )
        plan = _plan_device_agg(tdf, keys, agg_cols)
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
            tdf, keys[0], agg_entries, kmin, buckets, spec_rows, key_dt.str
        )
        device_cols = {keys[0]: outs[0]}
        for (_, name, _, _), arr in zip(spec_rows, outs[2:]):
            device_cols[name] = arr
        return TorchDataFrame(
            _internal=dict(
                device=tdf.device,
                device_cols=device_cols,
                row_count=-1,
                valid_mask=outs[1],
                schema=plan["schema"],
            )
        )

    def _run_dense_fused(
        self,
        tdf: TorchDataFrame,
        key: str,
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
        outs = kernel(tdf.device_cols[key], kmin, arrays, tdf.device_valid_mask())
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


def _torch_dtype(np_dtype_str: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np.dtype(np_dtype_str))).dtype


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def _np_numeric_dtype(tp: pa.DataType) -> Optional[np.dtype]:
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


def _decode_partial_keys(
    tdf: TorchDataFrame, partials: pd.DataFrame, mask_names: Dict[str, str]
) -> pd.DataFrame:
    """Restore the keys' meaning on the host partials: dictionary codes →
    values, epoch ints → dates and timestamps, masked cells → NA."""
    res = partials
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
      of min/max); ``notnull``, 1 where the value is not NULL.
    """
    if tag == "ones":
        probe = next(iter(tdf.device_cols.values()))
        return torch.ones(probe.shape[0], dtype=torch.int64, device=probe.device)
    assert src is not None
    a, m = tdf.device_cols[src], tdf.null_masks[src]
    if tag == "notnull":
        return torch.logical_not(m).to(torch.int64)
    filled = torch.where(m, 0, a)
    if tag == "hi":
        return filled >> 32  # arithmetic shift: negative values keep their sign
    if tag == "lo":
        return filled & 0xFFFFFFFF
    ii = torch.iinfo(a.dtype)
    return torch.where(m, ii.max if tag == "minfill" else ii.min, a)


def _not_on_device(tdf: TorchDataFrame, name: str, what: str) -> Exception:
    if name not in tdf.schema:
        return KeyError(f"{what} {name!r} not in {tdf.schema}")
    return NotImplementedError(
        f"{what} {name!r} of type {tdf.schema[name].type} stays on the host; an "
        f"aggregate over it is not ported ({_ENCODED})"
    )


def _plan_device_agg(
    tdf: TorchDataFrame, keys: List[str], agg_cols: List[ColumnExpr]
) -> dict:
    """The device-aggregation plan of the JAX engine: ``aggs`` (name, agg,
    source column), ``post`` (how each output is finished, ``fn`` over the
    merged partials), the output ``schema``, and the sources that need a
    view: ``dict_srcs`` (dictionary codes), ``masked_srcs`` (nullable
    int/bool) and ``virtual`` (``{name: (tag, real source)}``).

    Where the JAX engine hands the plan to its host engine, this raises
    ``NotImplementedError`` naming the ROADMAP.md item that would port it."""
    for k in keys:
        if k not in tdf.device_cols:
            raise _not_on_device(tdf, k, "key")
    aggs: List[Any] = []
    post: List[dict] = []
    virtual: Dict[str, Any] = {}  # vname -> (tag, real src)
    masked_srcs: set = set()
    dict_srcs: set = set()
    fields: List[pa.Field] = [tdf.schema[k] for k in keys]
    for c in agg_cols:
        if not isinstance(c, _FuncExpr) or not c.is_agg:
            raise NotImplementedError(
                f"{c!r} is not an aggregate function; expressions over "
                f"aggregates are not ported ({_VERBS})"
            )
        if c.is_distinct or len(c.args) != 1:
            raise NotImplementedError(
                f"{c!r}: DISTINCT and multi-argument aggregates are not ported ({_VERBS})"
            )
        name = c.output_name
        if name == "":
            raise ValueError(f"{c!r} needs an alias")
        func = c.func.upper()
        arg = c.args[0]
        if func == "COUNT" and (
            (isinstance(arg, _LitColumnExpr) and arg.value is not None)  # COUNT(NULL) is 0
            or (isinstance(arg, _NamedColumnExpr) and arg.name == "*")
        ):
            # COUNT(*) / COUNT(1): every row in the group counts, NULLs
            # included — a ones column summed under the validity mask
            virtual["__ones__"] = ("ones", None)
            aggs.append((name, "sum", "__ones__"))
            post.append({"name": name, "kind": "pass", "fn": (lambda m, _n=name: m[_n])})
            tp = c.infer_type(tdf.schema)
            fields.append(pa.field(name, tp if tp is not None else pa.int64()))
            continue
        if not isinstance(arg, _NamedColumnExpr):
            raise NotImplementedError(
                f"{c!r}: aggregates of expressions are not ported ({_VERBS})"
            )
        src = arg.name
        if src not in tdf.device_cols:
            raise _not_on_device(tdf, src, "column")
        enc = tdf.encodings.get(src)
        if enc is not None:
            # sorted-dictionary strings: code order == value order, so
            # MIN/MAX/COUNT reduce over codes (as NaN-null float views) and
            # the min/max code decodes back to its string
            if not (enc["kind"] == "dict" and enc.get("sorted") and func in ("MIN", "MAX", "COUNT")):
                raise NotImplementedError(
                    f"{c!r}: {func} over a {enc['type']} column is not ported ({_ENCODED})"
                )
            dict_srcs.add(src)
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
        tp = c.infer_type(tdf.schema)
        if func not in ("SUM", "AVG", "MIN", "MAX", "COUNT"):
            raise NotImplementedError(f"aggregate {func} is not ported ({_VERBS})")
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
                    "fn": (lambda m, _n=name: m[_n].astype("Int64").where(m[f"{_n}__nn"] > 0)),
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
            post.append({"name": name, "kind": "pass", "fn": (lambda m, _n=name: m[_n])})
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
