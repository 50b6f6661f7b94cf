"""TorchDataFrame — a frame whose columns are tensors on one device.

The port of ``JaxDataFrame`` (``fugue_tpu/jax/dataframe.py``):

- numeric and bool columns live on the device, one 1-D tensor each; float
  columns carry NULL as NaN (the JAX package's device convention);
- string columns are DICTIONARY-ENCODED: int32 codes on the device (−1 =
  NULL) into a sorted host ``pa.Array`` dictionary, so code order is
  value order and MIN/MAX over codes is MIN/MAX over the strings;
- nullable int and bool columns carry a bool null mask beside a value
  tensor whose NULLs are filled (0 or False); dates and timestamps live as
  epoch ints, with a mask where NULLs exist, and get their arrow type back
  on conversion;
- the unsigned types above uint8, for which PyTorch has no arithmetic,
  live widened: uint16 as int32 and uint32 as int64, holding their values;
  uint64 as int64 with the top bit flipped (``x ^ 2**63``), so that signed
  order is unsigned order (``ops/shuffle.py`` ``unsigned_order``). The
  schema keeps the unsigned type, which ``as_arrow`` gives back, and the
  evaluator (``column/torch_eval.py``) computes in it;
- every other type (decimal, binary, list, struct) stays in a host arrow
  table aligned with the device rows by position;
- ``row_count`` is the logical length, and an optional bool tensor marks
  the valid rows. Rows it marks invalid (the JAX frame's padding, or rows a
  device op dropped) are skipped by device ops and dropped on conversion
  back to arrow or pandas;
- ``key_range`` caches one min/max probe of an integer column over the
  valid rows, on the device;
- a transform's output frame holds the UDF's tensors as it returned them,
  with the input's dictionary put back on passed-through keys and the
  input's (or the sorted) valid mask; ``as_arrow`` casts each column to
  its schema type unchecked, as ``JaxDataFrame.as_arrow`` does (an int32
  tensor declared ``long`` comes out as int64).

Ingestion is eager: the frame is on the device once it is built.
``as_local_bounded`` is the way to the host engine (the JAX engine's
``_host``): one copy of the valid rows to the host, dictionary strings,
epochs and NULL masks rendered as arrow values, as ``as_arrow`` does. The
way back (``pinned=True``) stages each column through pinned host memory
on a CUDA device.
"""

from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..dataframe import ArrowDataFrame, DataFrame
from ..exceptions import FugueDataFrameInitError
from ..ops.segment import minmax_probe
from ..parallel.device import resolve_device
from ..schema import Schema, _pandas_to_pa_schema

# arrow type name → numpy dtype of the device tensor; the unsigned types
# above uint8 live widened (``to_storage``)
_DEVICE_DTYPES = {
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "uint8": np.uint8,
    "uint16": np.int32,
    "uint32": np.int64,
    "uint64": np.int64,
    "halffloat": np.float16,
    "float": np.float32,
    "double": np.float64,
    "bool": np.bool_,
}


# the top bit of int64: uint64 ``x`` lives as ``x ^ _FLIP`` (signed order is
# then unsigned order)
_FLIP = np.int64(-(1 << 63))
# numpy dtype of each unsigned type above uint8
_UNSIGNED = {"uint16": np.uint16, "uint32": np.uint32, "uint64": np.uint64}


def is_wide_unsigned(tp: pa.DataType) -> bool:
    """uint16, uint32 or uint64: a type that lives widened on the device."""
    return str(tp) in _UNSIGNED


def storage_dtype(tp: pa.DataType) -> np.dtype:
    """The numpy dtype of a uint16, uint32 or uint64 column's device form."""
    return np.dtype(_DEVICE_DTYPES[str(tp)])


def to_storage(arr: np.ndarray, tp: pa.DataType) -> np.ndarray:
    """The device form of values of arrow type ``tp`` (numpy, any integer
    dtype): uint64 flipped into int64, uint16 and uint32 widened; other
    types as they are."""
    name = str(tp)
    if name not in _UNSIGNED:
        return arr
    if name == "uint64":
        return np.ascontiguousarray(arr).astype(np.uint64, copy=False).view(np.int64) ^ _FLIP
    return arr.astype(_DEVICE_DTYPES[name], copy=False)


def from_storage(arr: np.ndarray, tp: pa.DataType) -> np.ndarray:
    """The inverse of :func:`to_storage`: numpy values of ``tp``'s dtype."""
    name = str(tp)
    if name not in _UNSIGNED:
        return arr
    if name == "uint64":
        return (np.ascontiguousarray(arr).astype(np.int64, copy=False) ^ _FLIP).view(np.uint64)
    return arr.astype(_UNSIGNED[name])


def _to_numpy(col: pa.Array) -> np.ndarray:
    # may share arrow's read-only buffers: ``_to_device`` copies them
    return col.to_numpy(zero_copy_only=False)


def _encode_column(col: pa.Array, f: pa.Field) -> Tuple[Optional[np.ndarray], dict]:
    """Encode ONE arrow column for the device: ``(arr, extra)``.

    ``arr`` is the numpy array for the device, or None when the column
    stays on the host. ``extra`` holds ``nan`` (a float column that may
    hold NaN), ``encoding`` (``{"kind": "dict"|"datetime", "dictionary":
    pa.Array|None, "type": pa.DataType}``) and ``null_mask`` (np bool,
    True = NULL)."""
    t = f.type
    if str(t) in _DEVICE_DTYPES:
        if col.null_count == 0 or pa.types.is_floating(t):
            # arrow float → numpy turns nulls into NaN — the device NULL
            arr = _to_numpy(col)
            arr = to_storage(arr, t) if is_wide_unsigned(t) else arr.astype(_DEVICE_DTYPES[str(t)], copy=False)
            nan = arr.dtype.kind == "f" and (col.null_count > 0 or bool(np.isnan(arr).any()))
            return arr, ({"nan": True} if nan else {})
        # nullable int/bool: value array + null mask
        mask = _to_numpy(col.is_null())
        fill = False if pa.types.is_boolean(t) else 0
        return to_storage(_to_numpy(col.fill_null(fill)), t), {"null_mask": mask}
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        d = col.dictionary_encode()
        codes = _to_numpy(d.indices.fill_null(-1)).astype(np.int32)
        # SORT the dictionary so code order == lexicographic order: MIN/MAX
        # on the codes are then exact. The codes are the JAX package's.
        dictionary = d.dictionary.cast(t)
        if len(dictionary) > 1:
            order = _to_numpy(pc.sort_indices(dictionary))
            dictionary = dictionary.take(pa.array(order))
            inverse = np.empty(len(order), dtype=np.int32)
            inverse[order] = np.arange(len(order), dtype=np.int32)
            codes = np.where(codes >= 0, inverse[np.clip(codes, 0, None)], -1).astype(np.int32)
        return codes, {
            "encoding": {"kind": "dict", "dictionary": dictionary, "type": t, "sorted": True}
        }
    if pa.types.is_timestamp(t) or pa.types.is_date(t):
        ints = col.cast(pa.int32() if pa.types.is_date32(t) else pa.int64())
        extra: Dict[str, Any] = {"encoding": {"kind": "datetime", "dictionary": None, "type": t}}
        if col.null_count > 0:
            extra["null_mask"] = _to_numpy(col.is_null())
            ints = ints.fill_null(0)
        return _to_numpy(ints), extra
    return None, {}  # host-resident


def _to_device(arr: np.ndarray, device: torch.device, pinned: bool) -> torch.Tensor:
    """``arr`` as a tensor on ``device``. With ``pinned`` and a CUDA device
    the copy is staged through pinned host memory, which also reads the
    read-only arrays that pandas 3 and arrow hand out without a writable
    copy first."""
    if pinned and device.type == "cuda":
        buf = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0].copy()).dtype, pin_memory=True)
        buf.numpy()[...] = arr
        return buf.to(device, non_blocking=True)
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(device)


def encode_arrow_for_device(tbl: pa.Table) -> Tuple[Dict[str, np.ndarray], Optional[pa.Table], dict]:
    """Encode an arrow table for the device: ``(device_cols, host_tbl,
    meta)``, ``meta`` holding ``nan_cols`` (float columns that may hold
    NaN), ``encodings`` and ``null_masks`` (np bool arrays, True = NULL)."""
    device_cols: Dict[str, np.ndarray] = {}
    host_names: List[str] = []
    meta: Dict[str, Any] = {"nan_cols": set(), "encodings": {}, "null_masks": {}}
    for i, f in enumerate(tbl.schema):
        arr, extra = _encode_column(tbl.column(i).combine_chunks(), f)
        if arr is None:
            host_names.append(f.name)
            continue
        device_cols[f.name] = arr
        if extra.get("nan"):
            meta["nan_cols"].add(f.name)
        if "encoding" in extra:
            meta["encodings"][f.name] = extra["encoding"]
        if "null_mask" in extra:
            meta["null_masks"][f.name] = extra["null_mask"]
    host_tbl = tbl.select(host_names) if len(host_names) > 0 else None
    return device_cols, host_tbl, meta


class TorchDataFrame(DataFrame):
    """A frame on one torch device (``cuda:0`` unless ``device`` says
    otherwise).

    ``df`` is a ``pa.Table``, a ``pd.DataFrame`` or another
    ``TorchDataFrame``; ``schema`` (optional) casts the input to it;
    ``pinned`` stages the copy to a CUDA device through pinned memory.
    """

    def __init__(
        self,
        df: Any = None,
        schema: Any = None,
        device: Any = None,
        pinned: bool = False,
        _internal: Optional[dict] = None,
    ):
        if _internal is not None:
            self._device = torch.device(_internal["device"])
            self._cols: Dict[str, torch.Tensor] = _internal["device_cols"]
            self._host_tbl: Optional[pa.Table] = _internal.get("host_tbl")
            self._row_count: int = _internal["row_count"]
            self._valid_mask: Optional[torch.Tensor] = _internal.get("valid_mask")
            # None = unknown → treat every float column as possibly-NaN
            self._nan_cols: Optional[Set[str]] = _internal.get("nan_cols")
            self._encodings: Dict[str, dict] = _internal.get("encodings") or {}
            self._null_masks: Dict[str, torch.Tensor] = _internal.get("null_masks") or {}
            super().__init__(_internal["schema"])
            return
        if isinstance(df, TorchDataFrame):
            df = df.as_arrow()
        elif isinstance(df, pd.DataFrame):
            # a column of only NULLs infers arrow's ``null``; pandas frames
            # take the host engine's schema (``null`` → ``str``), as the
            # JAX frame does through its host engine
            if schema is None:
                schema = Schema(_pandas_to_pa_schema(df))
            df = pa.Table.from_pandas(df, preserve_index=False)
        elif not isinstance(df, pa.Table):
            raise FugueDataFrameInitError(f"can't build a TorchDataFrame from {type(df)}")
        s = Schema(df.schema) if schema is None else (
            schema if isinstance(schema, Schema) else Schema(schema)
        )
        tbl = df if df.schema.equals(s.pa_schema) else df.cast(s.pa_schema)
        self._device = resolve_device(device)
        device_cols, self._host_tbl, meta = encode_arrow_for_device(tbl)
        self._cols = {c: _to_device(a, self._device, pinned) for c, a in device_cols.items()}
        self._null_masks = {
            c: _to_device(m, self._device, pinned) for c, m in meta["null_masks"].items()
        }
        self._nan_cols = meta["nan_cols"]
        self._encodings = meta["encodings"]
        self._row_count = tbl.num_rows
        self._valid_mask = None
        super().__init__(s)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def device_cols(self) -> Dict[str, torch.Tensor]:
        return self._cols

    @property
    def device_nbytes(self) -> int:
        """The frame's resident bytes, for the result cache's accounting:
        its device columns, NULL masks and validity mask, plus the arrow
        bytes of the columns kept on the host."""
        total = sum(int(t.nbytes) for t in self._cols.values())
        total += sum(int(t.nbytes) for t in self._null_masks.values())
        if self._valid_mask is not None:
            total += int(self._valid_mask.nbytes)
        if self._host_tbl is not None:
            total += int(self._host_tbl.nbytes)
        return total

    @property
    def host_table(self) -> Optional[pa.Table]:
        """The columns that stay on the host, aligned with the device rows
        by position; None when every column is on the device."""
        return self._host_tbl

    @property
    def encodings(self) -> Dict[str, dict]:
        """Per-column internal device representations (dict/datetime)."""
        return self._encodings

    @property
    def null_masks(self) -> Dict[str, torch.Tensor]:
        """Per-column device null masks (True = NULL) for nullable columns."""
        return self._null_masks

    @property
    def has_encoded(self) -> bool:
        """True when any device column is not plainly typed (encoded or
        masked): device paths that assume plain semantics gate on this."""
        return len(self._encodings) > 0 or len(self._null_masks) > 0

    @property
    def valid_mask(self) -> Optional[torch.Tensor]:
        """The explicit device validity mask, or None: rows
        ``[0, row_count)`` are valid."""
        return self._valid_mask

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
        """Cached ``(min, max)`` of integer device column ``name`` over
        valid rows — the probe behind dense-plan eligibility, one
        device→host read per (frame, column). It reads the device column
        as it is: dictionary codes with −1 for NULL, and the fill value of
        a masked column. With no valid rows it returns
        ``(iinfo(dtype).max, iinfo(dtype).min)``, so emptiness is ``hi < lo``."""
        cache = self.__dict__.setdefault("_key_range_cache", {})
        if name not in cache:
            cache[name] = minmax_probe(self._cols[name], self.device_valid_mask())
        return cache[name]

    def count(self) -> int:
        if self._row_count < 0:
            assert self._valid_mask is not None
            self._row_count = int(self._valid_mask.sum())
        return self._row_count

    def _decode_device_col(
        self, f: pa.Field, host: np.ndarray, nulls: Optional[np.ndarray]
    ) -> pa.Array:
        """A row-filtered host view of a device column back to its arrow
        form: NaN → NULL, dictionary codes → values, epochs → dates and
        timestamps."""
        enc = self._encodings.get(f.name)
        if enc is None and is_wide_unsigned(f.type):
            return pa.array(from_storage(host, f.type), mask=nulls, type=f.type)
        if enc is None:
            if host.dtype.kind == "f" and self.maybe_nan(f.name):
                nn = np.isnan(host)  # device convention: NaN IS NULL
                nulls = nn if nulls is None else (nulls | nn)
            arr = pa.array(host, mask=nulls)
        elif enc["kind"] == "dict":
            # codes → dictionary values; −1 = NULL
            arr = enc["dictionary"].take(pa.array(host.astype(np.int64), mask=host < 0))
        elif enc["kind"] == "datetime":
            arr = pa.array(host, mask=nulls).cast(enc["type"])
        else:  # pragma: no cover
            raise NotImplementedError(enc["kind"])
        return arr.cast(f.type, safe=False)

    def as_arrow(self) -> pa.Table:
        """The valid rows as an arrow table of the schema. Each device
        column's valid rows are gathered on the device first, so only
        they cross to the host."""
        mask: Optional[np.ndarray] = None
        idx: Optional[torch.Tensor] = None
        if self._valid_mask is not None:
            idx = torch.nonzero(self._valid_mask).squeeze(1)
            if self._host_tbl is not None:
                mask = self._valid_mask.cpu().numpy()

        def rows(a: torch.Tensor) -> np.ndarray:
            sel = a.index_select(0, idx) if idx is not None else a[: self._row_count]
            return sel.cpu().numpy()

        arrays = []
        for f in self.schema.fields:
            if f.name in self._cols:
                nulls = rows(self._null_masks[f.name]) if f.name in self._null_masks else None
                arrays.append(self._decode_device_col(f, rows(self._cols[f.name]), nulls))
            else:
                assert self._host_tbl is not None
                col = self._host_tbl.column(f.name)
                if self._valid_mask is not None:
                    col = col.filter(pa.array(mask[: len(col)]))
                else:
                    col = col.slice(0, self._row_count)
                arrays.append(col.combine_chunks())
        return pa.Table.from_arrays(arrays, schema=self.schema.pa_schema)

    def as_local_bounded(self) -> ArrowDataFrame:
        return ArrowDataFrame(self.as_arrow())

    def _select_cols(self, cols: List[str]) -> "TorchDataFrame":
        """The columns ``cols``, in that order, over the same rows: their
        encodings, null masks and host columns come along, and the valid
        mask is shared (``JaxDataFrame._select_cols``)."""
        schema = self.schema.extract(cols)
        dc = {k: v for k, v in self._cols.items() if k in schema}
        keep_host = [n for n in schema.names if n not in dc]
        return TorchDataFrame(
            _internal=dict(
                device=self._device,
                device_cols=dc,
                host_tbl=self._host_tbl.select(keep_host) if len(keep_host) > 0 else None,
                row_count=self._row_count,
                valid_mask=self._valid_mask,
                nan_cols=self._nan_cols,
                encodings={k: v for k, v in self._encodings.items() if k in dc},
                null_masks={k: v for k, v in self._null_masks.items() if k in dc},
                schema=schema,
            )
        )

    def rename(self, columns: Dict[str, str]) -> "TorchDataFrame":
        """The same tensors under new names (``JaxDataFrame.rename``)."""
        schema = self.schema.rename(columns)

        def names(d: Dict[str, Any]) -> Dict[str, Any]:
            return {columns.get(k, k): v for k, v in d.items()}

        ht = self._host_tbl
        return TorchDataFrame(
            _internal=dict(
                device=self._device,
                device_cols=names(self._cols),
                host_tbl=None if ht is None else ht.rename_columns(
                    [columns.get(n, n) for n in ht.column_names]),
                row_count=self._row_count,
                valid_mask=self._valid_mask,
                nan_cols=None if self._nan_cols is None else {columns.get(n, n) for n in self._nan_cols},
                encodings=names(self._encodings),
                null_masks=names(self._null_masks),
                schema=schema,
            )
        )

    def alter_columns(self, columns: Any) -> "TorchDataFrame":
        """The columns of ``columns`` cast to their new types, through
        arrow and back onto the device (``JaxDataFrame.alter_columns``)."""
        if self.schema.alter(columns) == self.schema:
            return self
        return TorchDataFrame(ArrowDataFrame(self.as_arrow()).alter_columns(columns).as_arrow(),
                              device=self._device)

    def __repr__(self) -> str:
        return f"TorchDataFrame({self.schema}, device={self._device})"


def frame_from_numpy(
    columns: Dict[str, np.ndarray],
    schema: Any,
    valid: Optional[np.ndarray] = None,
    nan_cols: Optional[Iterable[str]] = None,
    encodings: Optional[Dict[str, dict]] = None,
    null_masks: Optional[Dict[str, np.ndarray]] = None,
    host_table: Optional[pa.Table] = None,
    device: Any = None,
) -> TorchDataFrame:
    """A ``TorchDataFrame`` from device state handed over as numpy arrays —
    the carry-across from a ``JaxDataFrame`` ``jdf``:
    ``{c: np.asarray(a) for c, a in jdf.device_cols.items()}``,
    ``np.asarray(jdf.device_valid_mask())``, ``jdf.encodings``,
    ``{c: np.asarray(m) for c, m in jdf.null_masks.items()}`` and
    ``jdf.host_table``.

    ``columns`` hold every row, padding included (an unsigned column in its
    own dtype, as the JAX package holds it); ``valid`` marks the rows that
    belong to the frame (None: all of them). ``nan_cols`` names the
    float columns that may hold NaN (None: any float column may). The
    schema's other columns come from ``host_table``, whose rows line up
    with the device rows by position."""
    s = schema if isinstance(schema, Schema) else Schema(schema)
    dev = resolve_device(device)
    encodings = dict(encodings or {})
    null_masks = null_masks or {}
    host_names = [] if host_table is None else list(host_table.column_names)
    if set(columns) | set(host_names) != set(s.names) or set(columns) & set(host_names):
        raise FugueDataFrameInitError(
            f"device columns {sorted(columns)} and host columns {host_names} don't match schema {s}"
        )
    lengths = {len(a) for a in columns.values()} | {len(m) for m in null_masks.values()}
    if len(lengths) > 1 or (valid is not None and len(valid) not in lengths):
        raise FugueDataFrameInitError("columns, null masks and valid mask differ in length")
    cols: Dict[str, torch.Tensor] = {}
    for name, arr in columns.items():
        tp = s[name].type
        if name not in encodings and str(tp) not in _DEVICE_DTYPES:
            raise FugueDataFrameInitError(f"column {name!r} of type {tp} cannot live on the torch device")
        if name not in encodings and is_wide_unsigned(tp):
            arr = to_storage(arr, tp)
        dt = arr.dtype if name in encodings else _DEVICE_DTYPES[str(tp)]
        cols[name] = torch.from_numpy(np.require(arr, dt, ["C", "W"])).to(dev)
    masks = {
        c: torch.from_numpy(np.require(m, np.bool_, ["C", "W"])).to(dev)
        for c, m in null_masks.items()
    }
    mask = None
    if valid is not None:
        mask = torch.from_numpy(np.require(valid, np.bool_, ["C", "W"])).to(dev)
    return TorchDataFrame(
        _internal=dict(
            device=dev,
            device_cols=cols,
            host_tbl=host_table,
            row_count=(lengths.pop() if lengths else 0) if mask is None else -1,
            valid_mask=mask,
            nan_cols=None if nan_cols is None else set(nan_cols),
            encodings=encodings,
            null_masks=masks,
            schema=s,
        )
    )
