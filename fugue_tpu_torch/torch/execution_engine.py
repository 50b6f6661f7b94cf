"""TorchExecutionEngine — the port of ``JaxExecutionEngine``
(``fugue_tpu/jax/execution_engine.py``) for one CUDA device.

This slice ports ``to_df``, ``persist`` and the dense device
``aggregate``: one integer key whose range fits ``2**18`` buckets, with
SUM/COUNT/AVG/MIN/MAX over numeric columns. The result stays on the device
with a valid mask, as the JAX engine's device-resident aggregate does.

There is no host fallback: a plan the slice does not cover raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import torch

from ..collections.partition import PartitionSpec
from ..column.expressions import ColumnExpr, _FuncExpr, _NamedColumnExpr
from ..execution.execution_engine import ExecutionEngine
from ..ops.segment import _DENSE_MAX_RANGE, dense_buckets, dense_kernel_parts
from ..parallel.device import resolve_device
from ..schema import Schema
from .dataframe import TorchDataFrame

_SORTED = "ROADMAP.md A.2 sorted groupby"


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
        """Dense device groupby of ``df`` by its one integer key."""
        tdf = self.to_df(df)
        keys = list(partition_spec.partition_by) if partition_spec is not None else []
        if len(keys) != 1:
            raise NotImplementedError(
                f"aggregate by {len(keys)} keys is not ported: the dense path "
                f"takes exactly one key ({_SORTED})"
            )
        plan = _plan_device_agg(tdf, keys, agg_cols)
        key_dt = _np_numeric_dtype(tdf.schema[keys[0]].type)
        if key_dt is None or key_dt.kind not in ("i", "u"):
            raise NotImplementedError(
                f"aggregate by key {keys[0]!r} of type {tdf.schema[keys[0]].type}: "
                f"only integer keys take the dense path ({_SORTED})"
            )
        agg_entries = [
            (name, agg, tdf.device_cols[src], tdf.maybe_nan(src))
            for name, agg, src in plan["aggs"]
        ]
        return self._try_dense_device_aggregate(
            tdf, keys[0], key_dt, plan, agg_entries, tdf.key_range(keys[0])
        )

    def _try_dense_device_aggregate(
        self,
        tdf: TorchDataFrame,
        key: str,
        key_dt: np.dtype,
        plan: dict,
        agg_entries: List[Any],
        range_hint: Tuple[int, int],
    ) -> TorchDataFrame:
        """Finish a dense-plan aggregate ON THE DEVICE: ``key = kmin +
        arange``, ``valid = present > 0``, avg = sum/count, dtype casts to
        the declared schema. The result frame keeps its columns on the
        device with an explicit valid mask and a lazy row count."""
        kmin, kmax = range_hint
        if kmax < kmin:  # no valid rows
            return self.to_df(plan["schema"].create_empty_arrow_table())
        rng = kmax - kmin + 1
        if rng > _DENSE_MAX_RANGE:
            raise NotImplementedError(
                f"key range {rng} exceeds the dense table's {_DENSE_MAX_RANGE} "
                f"buckets ({_SORTED})"
            )
        # predict kernel output dtypes; refuse any cast a NULL could break
        predicted: Dict[str, np.dtype] = {
            name: np.dtype(np.int64) if agg == "count" else _np_dtype(arr.dtype)
            for name, agg, arr, _ in agg_entries
        }
        spec_rows = _dense_finish_spec(plan, predicted)
        if spec_rows is None:
            raise NotImplementedError(
                f"aggregate to schema {plan['schema']} needs a cast that would "
                f"lose NULLs ({_SORTED})"
            )
        buckets = dense_buckets(rng)
        outs = self._run_dense_fused(
            tdf, key, agg_entries, kmin, buckets, spec_rows, key_dt.str
        )
        device_cols = {key: outs[0]}
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


def _plan_device_agg(
    tdf: TorchDataFrame, keys: List[str], agg_cols: List[ColumnExpr]
) -> dict:
    """The device-aggregation plan: ``aggs`` (name, agg, source column),
    ``post`` (how each output is finished) and the output ``schema``.
    Raises ``NotImplementedError`` for an aggregate the slice does not
    cover."""
    for k in keys:
        if k not in tdf.device_cols:
            raise KeyError(f"key {k!r} not in {tdf.schema}")
    aggs: List[Any] = []
    post: List[dict] = []
    fields: List[pa.Field] = [tdf.schema[k] for k in keys]
    for c in agg_cols:
        if not isinstance(c, _FuncExpr) or not c.is_agg:
            raise NotImplementedError(
                f"{c!r} is not an aggregate function; expressions over "
                "aggregates are not ported (ROADMAP.md A.8 remaining verbs)"
            )
        if c.is_distinct or len(c.args) != 1 or not isinstance(c.args[0], _NamedColumnExpr):
            raise NotImplementedError(
                f"{c!r}: only SUM/COUNT/AVG/MIN/MAX of one named column are "
                "ported (ROADMAP.md A.8 remaining verbs)"
            )
        src = c.args[0].name
        func = c.func.upper()
        if src == "*":
            raise NotImplementedError(f"{c!r}: COUNT(*) is not ported (ROADMAP.md A.8)")
        if src not in tdf.device_cols:
            raise KeyError(f"column {src!r} not in {tdf.schema}")
        name = c.output_name
        if name == "":
            raise ValueError(f"{c!r} needs an alias")
        tp = c.infer_type(tdf.schema)
        if func in ("SUM", "MIN", "MAX"):
            aggs.append((name, func.lower(), src))
            post.append({"name": name, "kind": "pass"})
        elif func == "COUNT":
            aggs.append((name, "count", src))
            post.append({"name": name, "kind": "pass"})
        elif func == "AVG":
            aggs.append((f"{name}__sum", "sum", src))
            aggs.append((f"{name}__cnt", "count", src))
            post.append({"name": name, "kind": "avg"})
        else:
            raise NotImplementedError(f"aggregate {func} is not ported (ROADMAP.md A.8)")
        fields.append(pa.field(name, tp if tp is not None else pa.float64()))
    return {"aggs": aggs, "post": post, "schema": Schema(fields)}
