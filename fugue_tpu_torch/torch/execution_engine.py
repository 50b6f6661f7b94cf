"""TorchExecutionEngine — the port of ``JaxExecutionEngine``
(``fugue_tpu/jax/execution_engine.py``) for one CUDA device.

This slice ports ``to_df``, ``persist`` and the device ``aggregate``:
any number of keys of any integer, float, bool, string, date or timestamp
column, nullable or not, with SUM/COUNT/AVG/MIN/MAX and COUNT(*) over
numeric, nullable-int, bool and dictionary-string columns. A plain single
integer key whose range fits ``2**18`` buckets takes the dense route and
finishes on the device; every other plan runs the device groupby
(``ops/segment.py``) into per-group partials, merges them on the host
and comes back to the device as the result frame, as the JAX engine does.

There is no host fallback: a plan that the JAX engine hands to its host
engine raises ``NotImplementedError`` here, naming its ROADMAP.md item.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import torch
from torch.profiler import record_function

from ..collections.partition import PartitionSpec
from ..column.expressions import ColumnExpr, _FuncExpr, _LitColumnExpr, _NamedColumnExpr
from ..execution.execution_engine import ExecutionEngine
from ..ops.segment import (
    _DENSE_MAX_RANGE,
    _is_int,
    dense_buckets,
    dense_kernel_parts,
    device_groupby_partials,
    merge_partials,
)
from ..parallel.device import resolve_device
from ..schema import Schema
from .dataframe import TorchDataFrame

_ENCODED = "ROADMAP.md A.3 encoded columns"
_VERBS = "ROADMAP.md A.8 remaining verbs"


class TorchExecutionEngine(ExecutionEngine):
    """Runs verbs on one torch device: ``cuda:0`` unless ``device`` names
    another (``device="cpu"`` for a machine with no card). With no device
    given and no card present, construction raises ``RuntimeError``."""

    def __init__(self, device: Any = None):
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._device

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
