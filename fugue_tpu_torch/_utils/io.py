"""File IO, copied from ``fugue_tpu/_utils/io.py`` and trimmed to parquet,
csv and json on the local file system: the format from the suffix or a
hint, globs, directories and lists of paths on load; overwrite, append and
error modes, and hive-partitioned parquet, on save."""

import glob as _glob
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Union

import pandas as pd
import pyarrow as pa
import pyarrow.json as pajson
import pyarrow.parquet as pq

from ..exceptions import FugueDataFrameInitError, FugueInvalidOperation
from ..schema import Schema

_FORMAT_MAP: Dict[str, str] = {
    ".parquet": "parquet",
    ".pq": "parquet",
    ".csv": "csv",
    ".tsv": "csv",
    ".json": "json",
    ".ndjson": "json",
}
# records the exact schema of a partitioned save, whose hive discovery
# would otherwise read the partition keys back as int32, last
_SCHEMA_SIDECAR = "_fugue_schema"


class FileParser:
    """A path and its format (``format_hint``, else from its suffix)."""

    def __init__(self, path: str, format_hint: Optional[str] = None):
        self.path = path
        self.has_glob = any(c in path for c in "*?[")
        if format_hint is not None:
            if format_hint not in ("parquet", "csv", "json"):
                raise NotImplementedError(f"invalid format {format_hint}")
            self.file_format = format_hint
        else:
            suffix = os.path.splitext(path.rstrip("/"))[1].lower()
            if suffix not in _FORMAT_MAP:
                raise NotImplementedError(f"can't infer format from {path}, provide format_hint")
            self.file_format = _FORMAT_MAP[suffix]

    def find_files(self) -> List[str]:
        if self.has_glob:
            return sorted(_glob.glob(self.path))
        if os.path.isdir(self.path):
            return [
                os.path.join(self.path, f)
                for f in sorted(os.listdir(self.path))
                if not f.startswith((".", "_"))
            ]
        return [self.path]


def load_df(
    path: Union[str, List[str]], format_hint: Optional[str] = None, columns: Any = None, **kwargs: Any
) -> pa.Table:
    """One or more files as one arrow table; ``columns`` is a list of names
    or a schema to cast to."""
    tables: List[pa.Table] = []
    for p in path if isinstance(path, list) else [path]:
        parser = FileParser(p, format_hint)
        if parser.file_format == "parquet" and not parser.has_glob:
            # pyarrow reads directories and hive partitions itself
            tbl = _load_parquet(p, columns, kwargs)
            sidecar = os.path.join(p, _SCHEMA_SIDECAR)
            if columns is None and os.path.isdir(p) and os.path.exists(sidecar):
                with open(sidecar) as f:
                    saved = Schema(f.read().strip())
                tbl = tbl.select(saved.names).cast(saved.pa_schema)
            tables.append(tbl)
        else:
            for f in parser.find_files():
                tables.append(_LOADERS[parser.file_format](f, columns, kwargs))
    if len(tables) == 0:
        raise FugueDataFrameInitError(f"no files found at {path}")
    return pa.concat_tables(tables) if len(tables) > 1 else tables[0]


def save_df(
    df: pa.Table,
    path: str,
    format_hint: Optional[str] = None,
    mode: str = "overwrite",
    partition_cols: Optional[List[str]] = None,
    **kwargs: Any,
) -> None:
    parser = FileParser(path, format_hint)
    if mode not in ("overwrite", "append", "error"):
        raise NotImplementedError(f"invalid save mode {mode}")
    if partition_cols and parser.file_format != "parquet":
        raise NotImplementedError("partitioned saves support parquet only")
    if os.path.exists(path):
        if mode == "error":
            raise FugueInvalidOperation(f"{path} already exists")
        if mode == "overwrite":
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
    if partition_cols:
        pq.write_to_dataset(df, path, partition_cols=partition_cols, **kwargs)
        with open(os.path.join(path, _SCHEMA_SIDECAR), "w") as f:
            f.write(str(Schema(df.schema)))
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _SAVERS[parser.file_format](df, path, mode, kwargs)


def _apply_schema(tbl: pa.Table, schema: Schema) -> pa.Table:
    tbl = tbl.select(schema.names)
    return tbl if Schema(tbl.schema) == schema else tbl.cast(schema.pa_schema)


def _load_parquet(p: str, columns: Any, kwargs: Dict[str, Any]) -> pa.Table:
    tbl = pq.read_table(p, columns=columns if isinstance(columns, list) else None, **kwargs)
    if columns is not None and not isinstance(columns, list):
        tbl = _apply_schema(tbl, Schema(columns))
    return tbl


def _load_csv(p: str, columns: Any, kwargs: Dict[str, Any]) -> pa.Table:
    kw = dict(kwargs)
    header = kw.pop("header", True)
    infer_schema = kw.pop("infer_schema", False)
    if isinstance(header, str):
        header = header.lower() == "true"
    if isinstance(infer_schema, str):
        infer_schema = infer_schema.lower() == "true"
    schema = Schema(columns) if columns is not None and not isinstance(columns, list) else None
    sep = kw.pop("sep", "\t" if p.endswith(".tsv") else ",")
    dtype = None if infer_schema else str
    if header:
        pdf = pd.read_csv(p, sep=sep, header=0, dtype=dtype, **kw)
    else:
        names = schema.names if schema is not None else columns
        if names is None:
            raise FugueDataFrameInitError("columns required for headerless csv")
        pdf = pd.read_csv(p, sep=sep, header=None, names=names, dtype=dtype, **kw)
    if schema is not None:
        pdf = pdf[schema.names]
        if infer_schema:
            return pa.Table.from_pandas(pdf, schema=schema.pa_schema, preserve_index=False, safe=False)
        # every column was read as str: a cast of the string table parses
        # the values into the declared types
        return pa.Table.from_pandas(pdf, preserve_index=False).cast(schema.pa_schema)
    if isinstance(columns, list):
        pdf = pdf[columns]
    return pa.Table.from_pandas(pdf, preserve_index=False)


def _load_json(p: str, columns: Any, kwargs: Dict[str, Any]) -> pa.Table:
    tbl = pajson.read_json(p)
    if isinstance(columns, list):
        return tbl.select(columns)
    return tbl if columns is None else _apply_schema(tbl, Schema(columns))


def _save_parquet(df: pa.Table, p: str, mode: str, kwargs: Dict[str, Any]) -> None:
    if mode == "append" and os.path.exists(p):
        raise NotImplementedError("append mode is not supported for single parquet files")
    pq.write_table(df, p, **kwargs)


def _save_csv(df: pa.Table, p: str, mode: str, kwargs: Dict[str, Any]) -> None:
    kw = dict(kwargs)
    header = kw.pop("header", False)
    if isinstance(header, str):
        header = header.lower() == "true"
    df.to_pandas(use_threads=False).to_csv(
        p, index=False, header=header, mode="a" if mode == "append" else "w", **kw
    )


def _save_json(df: pa.Table, p: str, mode: str, kwargs: Dict[str, Any]) -> None:
    df.to_pandas(use_threads=False).to_json(
        p, orient="records", lines=True, mode="a" if mode == "append" else "w", **kwargs
    )


_LOADERS: Dict[str, Callable] = {"parquet": _load_parquet, "csv": _load_csv, "json": _load_json}
_SAVERS: Dict[str, Callable] = {"parquet": _save_parquet, "csv": _save_csv, "json": _save_json}
