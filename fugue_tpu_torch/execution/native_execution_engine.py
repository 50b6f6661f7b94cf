"""NativeExecutionEngine, the single-process pandas engine, copied from
``fugue_tpu/execution/native_execution_engine.py`` and trimmed to what the
device engine hands to its host engine, as ``JaxExecutionEngine`` does
(its ``_host_engine``), and the relational verbs around them:

- ``PandasMapEngine.map_dataframe`` (:101-200): one sort, one reorder
  into group-clustered order, then one call per logical partition over a
  zero-copy slice. Groups keep NULL keys (``dropna=False``), and sorts put
  NULLs first. With ``fugue.tpu.map.parallelism`` above 1 the partitions
  run in the supervised fork pool of ``parallel_map.py`` (``_pool_workers``
  :56, ``_run_forked`` :202); the auto size is 1 on one card, so the map
  is serial unless the conf asks;
- ``join`` (:345) with SQL NULL semantics (a NULL key matches nothing),
  ``union``, ``subtract``, ``intersect``, ``distinct``, ``dropna``,
  ``fillna``, ``sample``, ``take``, ``repartition`` (the frame itself:
  the map partitions logically), ``broadcast``, ``persist``,
  ``load_df`` and ``save_df``;
- ``select``, ``filter``, ``assign`` and ``aggregate`` from the base
  class: the column IR evaluated over pandas (``column/eval.py``), and
  the base class's SQL engine (``sql/local_sql.py``) over these verbs."""

import os
from typing import Any, Callable, List, Optional, Union

import numpy as np
import pandas as pd
import pyarrow as pa

from .._utils.io import load_df as _io_load_df
from .._utils.io import save_df as _io_save_df
from ..collections.partition import (
    KEYWORD_CONCURRENCY,
    KEYWORD_ROWCOUNT,
    PartitionCursor,
    PartitionSpec,
    parse_presort_exp,
)
from ..constants import (
    FUGUE_TPU_CONF_MAP_CHUNK_TIMEOUT,
    FUGUE_TPU_CONF_MAP_PARALLEL_MIN_ROWS,
    FUGUE_TPU_CONF_MAP_PARALLELISM,
)
from ..dataframe import (
    ArrayDataFrame,
    ArrowDataFrame,
    DataFrame,
    LocalBoundedDataFrame,
    LocalDataFrame,
    LocalDataFrameIterableDataFrame,
    PandasDataFrame,
)
from ..dataframe.api import as_fugue_df
from ..dataframe.utils import get_join_schemas, parse_join_type
from ..exceptions import FugueInvalidOperation
from ..schema import Schema
from .execution_engine import ExecutionEngine, MapEngine


class PandasMapEngine(MapEngine):
    """Sort + groupby-apply over pandas, with a fork pool over the logical
    partitions. ``parallelism_engine`` answers ``CONCURRENCY`` in a
    partition number and sizes the auto pool: the device engine that hands
    its map here passes itself."""

    def __init__(self, execution_engine: ExecutionEngine, parallelism_engine: Any = None):
        super().__init__(execution_engine)
        self._parallelism_engine = parallelism_engine or execution_engine

    def _pool_workers(self, map_func: Callable, n_rows: int, n_parts: int) -> int:
        """Process-pool size for this map call; ≤1 = run serial."""
        from .parallel_map import fork_available, map_func_parallel_safe

        workers = int(self.conf.get(FUGUE_TPU_CONF_MAP_PARALLELISM, -1))
        if workers < 0:
            # auto: the pool runs host pandas, so the engine's parallelism
            # is capped by the host's cores (1 on one card)
            workers = min(int(self._parallelism_engine.get_current_parallelism()), os.cpu_count() or 1)
        min_rows = int(self.conf.get(FUGUE_TPU_CONF_MAP_PARALLEL_MIN_ROWS, 100_000))
        if (
            workers <= 1
            or n_parts <= 1
            or n_rows < min_rows
            or not fork_available()
            or not map_func_parallel_safe(map_func)
        ):
            return 1
        return workers

    def map_dataframe(
        self,
        df: DataFrame,
        map_func: Callable[[PartitionCursor, LocalDataFrame], LocalDataFrame],
        output_schema: Any,
        partition_spec: PartitionSpec,
        on_init: Optional[Callable[[int, DataFrame], Any]] = None,
        map_func_format_hint: Optional[str] = None,
    ) -> DataFrame:
        output_schema = output_schema if isinstance(output_schema, Schema) else Schema(output_schema)
        input_df = self.to_df(df).as_local_bounded()
        if input_df.empty:
            return PandasDataFrame(None, output_schema)
        cursor = partition_spec.get_cursor(input_df.schema, 0)
        if on_init is not None:
            on_init(0, input_df)
        keys = partition_spec.partition_by
        pdf = input_df.as_pandas()
        sorts = partition_spec.get_sorts(input_df.schema, with_partition_keys=len(keys) > 0)
        if len(sorts) > 0:
            pdf = pdf.sort_values(
                list(sorts.keys()), ascending=list(sorts.values()), na_position="first"
            ).reset_index(drop=True)
        schema = input_df.schema
        if len(keys) == 0:
            num = partition_spec.get_num_partitions(
                **{
                    KEYWORD_ROWCOUNT: lambda: len(pdf),
                    KEYWORD_CONCURRENCY: self._parallelism_engine.get_current_parallelism,
                }
            )
            if num <= 1:
                part = PandasDataFrame(pdf, schema, pandas_df_wrapper=True)
                cursor.set(lambda: part.peek_array(), 0, 0)
                return _to_output(map_func(cursor, part), output_schema)
            # no keys but a partition count: even contiguous chunks (the
            # input is not empty, so none of them is)
            bounds = np.linspace(0, len(pdf), min(num, len(pdf)) + 1).astype(np.int64)
        else:
            # ONE reorder into group-clustered order; each logical partition
            # is then a contiguous zero-copy slice
            gid = pdf.groupby(keys, dropna=False, sort=False).ngroup().to_numpy()
            counts = np.bincount(gid)
            counts = counts[counts > 0]
            if not (len(counts) == len(gid) or (np.diff(gid) >= 0).all()):
                pdf = pdf.take(np.argsort(gid, kind="stable")).reset_index(drop=True)
            bounds = np.concatenate([[0], np.cumsum(counts)])
        groups = [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]
        workers = self._pool_workers(map_func, len(pdf), len(groups))
        if workers > 1:
            return self._run_forked(pdf, schema, groups, map_func, cursor, output_schema, workers)
        results: List[LocalDataFrame] = []
        for no, sl in enumerate(groups):
            part = _wrap_pandas_part(pdf.iloc[sl].reset_index(drop=True), schema)
            cursor.set(lambda p=part: p.peek_array(), no, 0)
            results.append(map_func(cursor, part).as_local_bounded())
        return _to_output(LocalDataFrameIterableDataFrame(iter(results), output_schema), output_schema)

    def _run_forked(
        self,
        pdf: pd.DataFrame,
        schema: Schema,
        groups: List[Any],
        map_func: Callable,
        cursor: PartitionCursor,
        output_schema: Schema,
        workers: int,
    ) -> DataFrame:
        """The partitions in the supervised fork pool, under the engine's
        ``fugue.tpu.retry.*`` policy, fault plan and chunk deadline; the
        recoveries count in its ``resilience_stats``."""
        from ..resilience import FaultInjector, RetryPolicy
        from .parallel_map import run_partitions_forked

        engine = self.execution_engine
        tables = run_partitions_forked(
            pdf,
            schema,
            groups,
            map_func,
            cursor,
            output_schema,
            workers,
            wrap_df=_wrap_pandas_part,
            to_arrow=_result_to_arrow,
            chunk_timeout=float(engine.conf.get(FUGUE_TPU_CONF_MAP_CHUNK_TIMEOUT, 0.0)),
            policy=RetryPolicy.from_conf(engine.conf),
            # a fresh injector a map call: fault budgets ("kill one worker")
            # are per map, not per process
            injector=FaultInjector.from_conf(engine.conf),
            stats=engine.resilience_stats,
        )
        tables = [t for t in tables if t.num_rows > 0]
        if len(tables) == 0:
            return PandasDataFrame(None, output_schema)
        target = output_schema.pa_schema
        tables = [t if t.schema == target else t.cast(target) for t in tables]
        return ArrowDataFrame(pa.concat_tables(tables), output_schema)


def _wrap_pandas_part(sub: pd.DataFrame, schema: Schema) -> PandasDataFrame:
    return PandasDataFrame(sub, schema, pandas_df_wrapper=True)


def _result_to_arrow(res: DataFrame, output_schema: Schema) -> Any:
    """One partition's result as arrow, in a pool worker. A pandas result
    converts on the worker's thread: the default conversion starts and
    joins a thread pool a call, which costs more than a partition's
    conversion does, 8 workers at a time."""
    res = _to_output(res, output_schema)
    if isinstance(res, PandasDataFrame):
        return pa.Table.from_pandas(
            res.native, schema=output_schema.pa_schema, preserve_index=False, safe=False, nthreads=1
        )
    return res.as_arrow()


def _to_output(out: DataFrame, output_schema: Schema) -> LocalBoundedDataFrame:
    res = out.as_local_bounded()
    if res.schema != output_schema:
        raise FugueInvalidOperation(f"map output schema {res.schema} != declared {output_schema}")
    return res


class NativeExecutionEngine(ExecutionEngine):
    """The host engine: local frames and pandas, one process."""

    def __init__(self, conf: Any = None):
        super().__init__(conf)
        self._map_engine = PandasMapEngine(self)

    @property
    def map_engine(self) -> PandasMapEngine:
        return self._map_engine

    def __repr__(self) -> str:
        return "NativeExecutionEngine"

    def to_df(self, df: Any, schema: Any = None) -> LocalBoundedDataFrame:
        """Any frame (the device's too: one copy to the host), a pandas
        frame, an arrow table or a list of rows as a local frame."""
        if isinstance(df, DataFrame):
            res = df.as_local_bounded()
            if schema is not None and res.schema != Schema(schema):
                res = ArrowDataFrame(res.as_arrow(), Schema(schema))
            if df.has_metadata:
                res.reset_metadata(df.metadata)
            return res
        if isinstance(df, (list, tuple)):
            return ArrayDataFrame(df, schema)
        fdf = as_fugue_df(df) if schema is None else as_fugue_df(df, schema=schema)
        return fdf.as_local_bounded()

    def repartition(self, df: DataFrame, partition_spec: PartitionSpec) -> DataFrame:
        # one process: the map partitions logically (map_dataframe)
        return df

    def broadcast(self, df: DataFrame) -> DataFrame:
        return df

    def persist(self, df: DataFrame, lazy: bool = False, **kwargs: Any) -> DataFrame:
        res = self.to_df(df)
        if df.has_metadata:
            res.reset_metadata(df.metadata)
        return res

    def join(self, df1: DataFrame, df2: DataFrame, how: str, on: Optional[List[str]] = None) -> DataFrame:
        how = parse_join_type(how)
        key_schema, output_schema = get_join_schemas(df1, df2, how=how, on=on)
        keys = key_schema.names
        d1 = self.to_df(df1).as_pandas()
        d2 = self.to_df(df2).as_pandas()
        if how == "cross":
            return PandasDataFrame(d1.merge(d2, how="cross"), output_schema)
        # SQL semantics: a NULL key matches nothing
        d1nn = d1.dropna(subset=keys)
        d2nn = d2.dropna(subset=keys)
        if how == "inner":
            res = d1nn.merge(d2nn, how="inner", on=keys)
        elif how == "left_outer":
            res = d1.merge(d2nn, how="left", on=keys)
        elif how == "right_outer":
            res = d1nn.merge(d2, how="right", on=keys)
        elif how == "full_outer":
            parts = [d1nn.merge(d2nn, how="outer", on=keys)]
            parts += [d[d[keys].isna().any(axis=1)] for d in (d1, d2)]
            parts = [parts[0]] + [p for p in parts[1:] if len(p) > 0]
            res = pd.concat(parts, ignore_index=True) if len(parts) > 1 else parts[0]
        elif how == "left_semi":
            res = d1.merge(d2nn[keys].drop_duplicates(), how="inner", on=keys)
        else:  # left_anti
            merged = d1.merge(d2nn[keys].drop_duplicates(), how="left", on=keys, indicator=True)
            res = merged[merged["_merge"] == "left_only"].drop(columns=["_merge"])
        res = res.reindex(columns=output_schema.names)
        return PandasDataFrame(res.reset_index(drop=True), output_schema)

    def _same_schema(self, df1: DataFrame, df2: DataFrame) -> None:
        if df1.schema != df2.schema:
            raise FugueInvalidOperation(f"schema mismatch {df1.schema} vs {df2.schema}")

    def union(self, df1: DataFrame, df2: DataFrame, distinct: bool = True) -> DataFrame:
        self._same_schema(df1, df2)
        res = pd.concat([self.to_df(df1).as_pandas(), self.to_df(df2).as_pandas()], ignore_index=True)
        return PandasDataFrame(_drop_duplicates(res) if distinct else res, df1.schema)

    def subtract(self, df1: DataFrame, df2: DataFrame, distinct: bool = True) -> DataFrame:
        self._same_schema(df1, df2)
        if not distinct:
            raise NotImplementedError("EXCEPT ALL is not supported")
        d1 = _drop_duplicates(self.to_df(df1).as_pandas())
        d2 = self.to_df(df2).as_pandas()
        merged = d1.merge(d2.drop_duplicates(), how="left", on=list(d1.columns), indicator=True)
        res = merged[merged["_merge"] == "left_only"].drop(columns=["_merge"])
        return PandasDataFrame(res.reset_index(drop=True), df1.schema)

    def intersect(self, df1: DataFrame, df2: DataFrame, distinct: bool = True) -> DataFrame:
        self._same_schema(df1, df2)
        if not distinct:
            raise NotImplementedError("INTERSECT ALL is not supported")
        d1 = _drop_duplicates(self.to_df(df1).as_pandas())
        d2 = _drop_duplicates(self.to_df(df2).as_pandas())
        res = d1.merge(d2, how="inner", on=list(d1.columns))
        return PandasDataFrame(res.reset_index(drop=True), df1.schema)

    def distinct(self, df: DataFrame) -> DataFrame:
        return PandasDataFrame(_drop_duplicates(self.to_df(df).as_pandas()), df.schema)

    def dropna(
        self, df: DataFrame, how: str = "any", thresh: Optional[int] = None,
        subset: Optional[List[str]] = None,
    ) -> DataFrame:
        kw: dict = dict(subset=subset)
        if thresh is not None:
            kw["thresh"] = thresh
        else:
            kw["how"] = how
        res = self.to_df(df).as_pandas().dropna(**kw)
        return PandasDataFrame(res.reset_index(drop=True), df.schema)

    def fillna(self, df: DataFrame, value: Any, subset: Optional[List[str]] = None) -> DataFrame:
        if isinstance(value, list) or value is None:
            raise FugueInvalidOperation("fillna value can't be None or a list")
        if isinstance(value, dict):
            if len(value) == 0 or any(v is None for v in value.values()):
                raise FugueInvalidOperation("fillna dict can't contain None values")
            mapping = value
        else:
            mapping = {c: value for c in (subset or df.schema.names)}
        return PandasDataFrame(self.to_df(df).as_pandas().fillna(mapping), df.schema)

    def sample(
        self, df: DataFrame, n: Optional[int] = None, frac: Optional[float] = None,
        replace: bool = False, seed: Optional[int] = None,
    ) -> DataFrame:
        if (n is None) == (frac is None):
            raise FugueInvalidOperation("one and only one of n and frac should be set")
        res = self.to_df(df).as_pandas().sample(n=n, frac=frac, replace=replace, random_state=seed)
        return PandasDataFrame(res.reset_index(drop=True), df.schema)

    def take(
        self, df: DataFrame, n: int, presort: str, na_position: str = "last",
        partition_spec: Optional[PartitionSpec] = None,
    ) -> DataFrame:
        if not isinstance(n, int):
            raise FugueInvalidOperation("n needs to be an integer")
        spec = partition_spec or PartitionSpec()
        pdf = self.to_df(df).as_pandas()
        sorts = parse_presort_exp(presort) if presort else spec.presort
        if len(sorts) > 0:
            pdf = pdf.sort_values(
                list(sorts.keys()), ascending=list(sorts.values()), na_position=na_position
            )
        if len(spec.partition_by) == 0:
            res = pdf.head(n)
        else:
            res = pdf.groupby(spec.partition_by, dropna=False, sort=False).head(n)
        return PandasDataFrame(res.reset_index(drop=True), df.schema)

    def load_df(
        self, path: Union[str, List[str]], format_hint: Any = None, columns: Any = None,
        **kwargs: Any,
    ) -> DataFrame:
        return ArrowDataFrame(_io_load_df(path, format_hint=format_hint, columns=columns, **kwargs))

    def save_df(
        self, df: DataFrame, path: str, format_hint: Any = None, mode: str = "overwrite",
        partition_spec: Optional[PartitionSpec] = None, force_single: bool = False, **kwargs: Any,
    ) -> DataFrame:
        partition_cols = (
            list(partition_spec.partition_by)
            if partition_spec is not None and len(partition_spec.partition_by) > 0
            else None
        )
        _io_save_df(
            self.to_df(df).as_arrow(), path, format_hint=format_hint, mode=mode,
            partition_cols=partition_cols, **kwargs,
        )
        return df


def _drop_duplicates(pdf: pd.DataFrame) -> pd.DataFrame:
    """``drop_duplicates`` with NaN equal to NaN (SQL DISTINCT)."""
    try:
        return pdf.drop_duplicates(ignore_index=True)
    except TypeError:  # unhashable cells (lists, dicts)
        key = pdf.apply(lambda r: repr(list(r)), axis=1)
        return pdf[~key.duplicated()].reset_index(drop=True)
