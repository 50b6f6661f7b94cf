"""TorchDataFrame — a frame whose columns are tensors on one device.

The port of ``JaxDataFrame`` (``fugue_tpu/jax/dataframe.py``) for the dense
aggregate slice:

- numeric and bool columns live on the device, one 1-D tensor each; float
  columns carry NULL as NaN (the JAX package's device convention);
- ``row_count`` is the logical length, and an optional bool tensor marks
  the valid rows. Rows it marks invalid (the JAX frame's padding, or rows a
  device op dropped) are skipped by device ops and dropped on conversion
  back to arrow or pandas;
- ``key_range`` caches one min/max probe of an integer column over the
  valid rows.

Columns the device cannot hold as one plain tensor — strings, nullable
ints and bools, dates, nested and binary types — are not ported yet
(ROADMAP.md A.3) and raise ``NotImplementedError``. Ingestion is eager:
the frame is on the device once it is built.
"""

from typing import Any, Dict, Iterable, Optional, Set, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import torch

from ..dataframe import DataFrame
from ..exceptions import FugueDataFrameInitError
from ..parallel.device import resolve_device
from ..schema import Schema

# arrow type name → numpy dtype of the device tensor. The unsigned types
# beyond uint8 are left out: PyTorch has no arithmetic for them.
_DEVICE_DTYPES = {
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "uint8": np.uint8,
    "halffloat": np.float16,
    "float": np.float32,
    "double": np.float64,
    "bool": np.bool_,
}


def _unported(name: str, tp: pa.DataType, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"column {name!r} of type {tp}: {why} are not ported to the torch "
        "engine yet (ROADMAP.md A.3 dictionary-encoded strings and null masks)"
    )


def _encode_column(col: pa.ChunkedArray, f: pa.Field) -> Tuple[np.ndarray, bool]:
    """One arrow column → (numpy array for the device, may it hold NaN)."""
    if str(f.type) not in _DEVICE_DTYPES:
        raise _unported(f.name, f.type, "non-numeric columns")
    floating = pa.types.is_floating(f.type)
    if col.null_count > 0 and not floating:
        raise _unported(f.name, f.type, "nullable int and bool columns")
    # arrow float → numpy turns nulls into NaN — the device NULL. Arrow's
    # buffers are read-only: copy where numpy shares them, so a CPU tensor
    # owns its memory
    arr = np.require(col.to_numpy(), _DEVICE_DTYPES[str(f.type)], ["C", "W"])
    return arr, bool(floating and np.isnan(arr).any())


class TorchDataFrame(DataFrame):
    """A frame on one torch device (``cuda:0`` unless ``device`` says
    otherwise).

    ``df`` is a ``pa.Table``, a ``pd.DataFrame`` or another
    ``TorchDataFrame``; ``schema`` (optional) casts the input to it.
    """

    def __init__(
        self,
        df: Any = None,
        schema: Any = None,
        device: Any = None,
        _internal: Optional[dict] = None,
    ):
        if _internal is not None:
            self._device = torch.device(_internal["device"])
            self._cols: Dict[str, torch.Tensor] = _internal["device_cols"]
            self._row_count: int = _internal["row_count"]
            self._valid_mask: Optional[torch.Tensor] = _internal.get("valid_mask")
            # None = unknown → treat every float column as possibly-NaN
            self._nan_cols: Optional[Set[str]] = _internal.get("nan_cols")
            super().__init__(_internal["schema"])
            return
        if isinstance(df, TorchDataFrame):
            df = df.as_arrow()
        elif isinstance(df, pd.DataFrame):
            df = pa.Table.from_pandas(df, preserve_index=False)
        elif not isinstance(df, pa.Table):
            raise FugueDataFrameInitError(f"can't build a TorchDataFrame from {type(df)}")
        s = Schema(df.schema) if schema is None else (
            schema if isinstance(schema, Schema) else Schema(schema)
        )
        tbl = df if df.schema.equals(s.pa_schema) else df.cast(s.pa_schema)
        self._device = resolve_device(device)
        self._cols = {}
        self._nan_cols = set()
        for f in s.fields:
            arr, nan = _encode_column(tbl.column(f.name), f)
            self._cols[f.name] = torch.from_numpy(arr).to(self._device)
            if nan:
                self._nan_cols.add(f.name)
        self._row_count = tbl.num_rows
        self._valid_mask = None
        super().__init__(s)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def device_cols(self) -> Dict[str, torch.Tensor]:
        return self._cols

    def maybe_nan(self, name: str) -> bool:
        """Whether float column ``name`` may contain NaN (i.e. NULL).

        False only when ingestion proved the column NaN-free; unknown
        provenance is conservatively True."""
        if self._nan_cols is None:
            return True
        return name in self._nan_cols

    def device_valid_mask(self) -> torch.Tensor:
        """A bool tensor marking valid rows (built from the row count when
        no explicit mask exists). Memoized — frames are immutable."""
        if self._valid_mask is not None:
            return self._valid_mask
        cached = getattr(self, "_tail_mask_cache", None)
        if cached is None:
            n = next(iter(self._cols.values())).shape[0]
            cached = torch.arange(n, device=self._device) < self._row_count
            self._tail_mask_cache = cached
        return cached

    def key_range(self, name: str) -> Tuple[int, int]:
        """Cached ``(min, max)`` of integer column ``name`` over valid rows —
        the probe behind dense-plan eligibility, one device→host read per
        (frame, column). With no valid rows it returns
        ``(iinfo(dtype).max, iinfo(dtype).min)``, so emptiness is ``hi < lo``."""
        cache = self.__dict__.setdefault("_key_range_cache", {})
        if name not in cache:
            k = self._cols[name]
            ii = torch.iinfo(k.dtype)
            if k.shape[0] == 0:
                cache[name] = (ii.max, ii.min)
            else:
                valid = self.device_valid_mask()
                lo = torch.where(valid, k, ii.max).min()
                hi = torch.where(valid, k, ii.min).max()
                cache[name] = tuple(int(x) for x in torch.stack([lo, hi]).tolist())
        return cache[name]

    def count(self) -> int:
        if self._row_count < 0:
            assert self._valid_mask is not None
            self._row_count = int(self._valid_mask.sum())
        return self._row_count

    def as_arrow(self) -> pa.Table:
        mask: Optional[np.ndarray] = None
        if self._valid_mask is not None:
            mask = self._valid_mask.cpu().numpy()
        arrays = []
        for f in self.schema.fields:
            host = self._cols[f.name].cpu().numpy()
            host = host[mask] if mask is not None else host[: self._row_count]
            nulls = None
            if np.issubdtype(host.dtype, np.floating) and self.maybe_nan(f.name):
                nulls = np.isnan(host)  # device convention: NaN IS NULL
            arrays.append(pa.array(host, mask=nulls).cast(f.type, safe=False))
        return pa.Table.from_arrays(arrays, schema=self.schema.pa_schema)

    def __repr__(self) -> str:
        return f"TorchDataFrame({self.schema}, device={self._device})"


def frame_from_numpy(
    columns: Dict[str, np.ndarray],
    schema: Any,
    valid: Optional[np.ndarray] = None,
    nan_cols: Optional[Iterable[str]] = None,
    device: Any = None,
) -> TorchDataFrame:
    """A ``TorchDataFrame`` from device state handed over as numpy arrays —
    the carry-across from a ``JaxDataFrame``:
    ``{c: np.asarray(jdf.device_cols[c])}`` and
    ``np.asarray(jdf.device_valid_mask())``.

    ``columns`` hold every row, padding included; ``valid`` marks the rows
    that belong to the frame (None: all of them). ``nan_cols`` names the
    float columns that may hold NaN (None: any float column may)."""
    s = schema if isinstance(schema, Schema) else Schema(schema)
    dev = resolve_device(device)
    if set(columns) != set(s.names):
        raise FugueDataFrameInitError(f"columns {sorted(columns)} don't match schema {s}")
    lengths = {len(a) for a in columns.values()}
    if len(lengths) != 1 or (valid is not None and len(valid) not in lengths):
        raise FugueDataFrameInitError("columns and valid mask differ in length")
    cols: Dict[str, torch.Tensor] = {}
    for f in s.fields:
        if str(f.type) not in _DEVICE_DTYPES:
            raise _unported(f.name, f.type, "non-numeric columns")
        arr = np.require(columns[f.name], _DEVICE_DTYPES[str(f.type)], ["C", "W"])
        cols[f.name] = torch.from_numpy(arr).to(dev)
    mask = None
    if valid is not None:
        mask = torch.from_numpy(np.require(valid, np.bool_, ["C", "W"])).to(dev)
    return TorchDataFrame(
        _internal=dict(
            device=dev,
            device_cols=cols,
            row_count=lengths.pop() if mask is None else -1,
            valid_mask=mask,
            nan_cols=None if nan_cols is None else set(nan_cols),
            schema=s,
        )
    )
