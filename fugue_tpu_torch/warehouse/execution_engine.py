"""The warehouse engine, copied from ``fugue_tpu/warehouse/execution_engine.py``:
the engine's verbs pushed down to a SQL database over DB-API, with
sqlite3 (the standard library's) as the warehouse.

- ``WarehouseSQLEngine`` runs raw SELECT text in the warehouse. On an
  engine that is not a warehouse it opens a private sqlite session, which
  is what FugueSQL's ``CONNECT sqlite`` runs on.
- ``WarehouseMapEngine`` maps through the local host engine
  (``NativeExecutionEngine``): the frame is fetched, mapped on the host
  and ingested back.
- ``WarehouseExecutionEngine`` lowers every relational verb to one SQL
  statement over temp tables of its connection, keeps the exact schema of
  persistent tables in a meta table, and drops a temp table when its
  frame is released (``track_temp_table``).
- ``SQLiteExecutionEngine`` reads ``fugue.sqlite.path`` (default: in
  memory).

The generated SQL goes through ``column/sql.py``'s generator with casts
lowered to the warehouse's storage classes; the declared arrow type rides
the recorded schema, so a fetch rebuilds the exact logical type (a
``float`` column comes back float32 though sqlite stores it as REAL).

Rows move through Python: ``ingest`` builds one tuple a row for
``executemany`` and ``fetch_arrow`` one Python value a cell, as in the
JAX package; that is the warehouse's own cost, a few microseconds a row.

While tracing is on, the data movement and the statements run in spans
of category ``warehouse``: ``warehouse.load`` (a LOAD, its ingest
included), ``warehouse.ingest`` and ``warehouse.fetch`` (with the rows
they move and the table they write or read whole) and
``warehouse.materialize`` (one statement into a temp table, named by
``table``; its rows are not counted, which would take one more query)
and ``warehouse.drop`` (a released frame's temp table dropped).
"""

import datetime
import itertools
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import pyarrow as pa

from .._utils.assertion import assert_or_throw
from .._utils.io import load_df as _io_load_df
from .._utils.io import save_df as _io_save_df
from ..collections.partition import PartitionCursor, PartitionSpec, parse_presort_exp
from ..collections.sql import StructuredRawSQL
from ..column import ColumnExpr, SelectColumns
from ..column.sql import SQLExpressionGenerator
from ..dataframe import ArrowDataFrame, DataFrame, DataFrames, LocalDataFrame
from ..dataframe.utils import get_join_schemas
from ..exceptions import FugueInvalidOperation
from ..execution.execution_engine import ExecutionEngine, MapEngine, SQLEngine
from ..execution.native_execution_engine import NativeExecutionEngine
from ..obs import get_tracer
from ..schema import Schema
from .dataframe import WarehouseDataFrame
from .profile import _SCHEMA_META_TABLE

_TEMP_TABLE_NAMES = (f"_fugue_temp_table_{i:d}" for i in itertools.count())
_ROWNUM_COL = "__fugue_wh_rn__"


class _StorageCastGenerator(SQLExpressionGenerator):
    """Column-IR → SQL with casts lowered to the warehouse's STORAGE
    classes (sqlite cast targets are TEXT/INTEGER/REAL/BLOB, not logical
    type names) — the declared arrow type still rides the recorded frame
    schema, so fetch reconstructs the exact logical type."""

    def __init__(self, profile: Any = None) -> None:
        super().__init__(enable_cast=True)
        from .profile import get_profile

        self._profile = get_profile(profile)

    def type_to_sql_type(self, tp: pa.DataType) -> str:
        return self._profile.storage_type(tp)


class WarehouseSQLEngine(SQLEngine):
    """SQL facet: raw SELECT statements run in the warehouse.

    Also a secondary SQL engine on an engine that is not a warehouse
    (FugueSQL ``CONNECT sqlite``): the frames then move into a private
    sqlite session for the statement."""

    def __init__(self, execution_engine: ExecutionEngine):
        super().__init__(execution_engine)
        self._wh: "WarehouseExecutionEngine" = (
            execution_engine
            if isinstance(execution_engine, WarehouseExecutionEngine)
            else SQLiteExecutionEngine(execution_engine.conf)
        )

    @property
    def is_distributed(self) -> bool:
        return False

    @property
    def dialect(self) -> Optional[str]:
        # raw SELECT text (usually FugueSQL's spark-flavored dialect)
        # transpiles to the warehouse database's dialect before execution
        return self._wh._profile.name

    def encode_name(self, name: str) -> str:
        return self._wh.encode_name(name)

    def select(self, dfs: DataFrames, statement: StructuredRawSQL) -> DataFrame:
        eng = self._wh
        name_map: Dict[str, str] = {}
        for k, v in dfs.items():
            wdf = eng.to_df(v)
            # temp table names are identifier-safe by construction; they
            # pass through the dialect transpile as bare identifiers
            name_map[k] = wdf.table
        sql = statement.construct(
            name_map=name_map, dialect=self.dialect, log=self.log
        )
        tbl = eng.materialize(sql)
        schema: Optional[Schema] = None
        probe = eng.connection.execute(
            f"SELECT 1 FROM {eng.encode_name(tbl)} LIMIT 1"
        ).fetchone()
        if probe is None:
            # EMPTY result: nothing to sample, so decltype-less computed
            # columns would degrade to string — infer the schema statically
            # from the projected expression IR over the input schemas
            # instead (parsed in the statement's own dialect text)
            from ..sql.infer import infer_output_schema

            pre = statement.construct(log=None)
            inferred = infer_output_schema(
                pre, {k: v.schema for k, v in dfs.items()}
            )
            if inferred is not None:
                actual_cols = [
                    n for n, _ in eng._profile.table_info(eng.connection, tbl)
                ]
                if list(inferred.names) == actual_cols:
                    schema = inferred
                    eng.record_schema(tbl, schema)
        if schema is None:
            schema = eng.infer_table_schema(tbl)
        return eng.track_temp_table(WarehouseDataFrame(eng, tbl, schema))

    def table_exists(self, table: str) -> bool:
        eng = self._wh
        cur = eng.connection.execute(
            eng._profile.table_exists_sql(views=True), (table,)
        )
        return cur.fetchone() is not None

    def save_table(
        self,
        df: DataFrame,
        table: str,
        mode: str = "overwrite",
        partition_spec: Optional[PartitionSpec] = None,
        **kwargs: Any,
    ) -> None:
        eng = self._wh
        if self.table_exists(table):
            assert_or_throw(
                mode == "overwrite",
                FugueInvalidOperation(f"table {table} exists, mode must be overwrite"),
            )
            eng.connection.execute(f"DROP TABLE {eng.encode_name(table)}")
        wdf = eng.to_df(df)
        eng.connection.execute(
            f"CREATE TABLE {eng.encode_name(table)} AS "
            f"SELECT * FROM {eng.encode_name(wdf.table)}"
        )
        eng.record_schema(table, wdf.schema, persistent=True)
        eng.connection.commit()

    def load_table(self, table: str, **kwargs: Any) -> DataFrame:
        eng = self._wh
        assert_or_throw(
            self.table_exists(table),
            FugueInvalidOperation(f"table {table} doesn't exist"),
        )
        return WarehouseDataFrame(
            eng, table, eng.infer_table_schema(table), snapshot=False
        )


class WarehouseMapEngine(MapEngine):
    """Map facet: per-partition UDFs roundtrip through the local engine."""

    @property
    def is_distributed(self) -> bool:
        return False

    def map_dataframe(
        self,
        df: DataFrame,
        map_func: Callable[[PartitionCursor, LocalDataFrame], LocalDataFrame],
        output_schema: Any,
        partition_spec: PartitionSpec,
        on_init: Optional[Callable[[int, DataFrame], Any]] = None,
        map_func_format_hint: Optional[str] = None,
    ) -> DataFrame:
        eng: "WarehouseExecutionEngine" = self.execution_engine  # type: ignore
        local = eng.to_df(df).as_local_bounded()
        res = eng.local_engine.map_engine.map_dataframe(
            local,
            map_func=map_func,
            output_schema=output_schema,
            partition_spec=partition_spec,
            on_init=on_init,
            map_func_format_hint=map_func_format_hint,
        )
        return eng.ingest(res.as_local_bounded())


class WarehouseExecutionEngine(ExecutionEngine):
    """Engine verbs lowered to warehouse SQL.

    ``connection`` is a DB-API connection; sqlite3 is the stdlib-provided
    warehouse this repo ships with (:class:`SQLiteExecutionEngine`).
    Frames are temp tables in that connection; every relational verb is a
    single SQL statement over them, so the data never leaves the
    warehouse except for ``map_dataframe`` (local roundtrip) and
    ``as_*`` fetches.
    """

    def __init__(
        self,
        conf: Any = None,
        connection: Any = None,
        path: str = ":memory:",
        profile: Any = None,
    ):
        super().__init__(conf)
        import sqlite3

        from .profile import get_profile

        self._profile = get_profile(profile)
        self._own_connection = connection is None
        self._connection = (
            connection
            if connection is not None
            else sqlite3.connect(path, check_same_thread=False)
        )
        if self._own_connection:
            # engines created as private sessions (e.g. CONNECT sqlite's
            # WarehouseSQLEngine) have no stop() caller — close the owned
            # connection when the engine is released. Frames keep the
            # engine alive, so a finalized engine has no live frames.
            import weakref

            weakref.finalize(self, _close_quietly, self._connection)
        self._schemas: Dict[str, Schema] = {}
        self._local_engine = NativeExecutionEngine(conf)
        # delegated map/fallback work reports recovery counters on THIS
        # engine (``resilience/``)
        self._local_engine._resilience_stats = self.resilience_stats
        self._log = logging.getLogger("fugue_tpu_torch.warehouse")
        self._gen = _StorageCastGenerator(self._profile)
        self._map_engine: Optional[MapEngine] = None

    # ---- base wiring ------------------------------------------------------
    @property
    def log(self) -> logging.Logger:
        return self._log

    @property
    def is_distributed(self) -> bool:
        return False

    @property
    def connection(self) -> Any:
        return self._connection

    @property
    def local_engine(self) -> ExecutionEngine:
        """The host engine handling the work beyond SQL."""
        return self._local_engine

    def create_default_map_engine(self) -> MapEngine:
        return WarehouseMapEngine(self)

    @property
    def map_engine(self) -> MapEngine:
        if self._map_engine is None:
            with self._rlock:
                if self._map_engine is None:
                    self._map_engine = self.create_default_map_engine()
        return self._map_engine

    def create_default_sql_engine(self) -> SQLEngine:
        return WarehouseSQLEngine(self)

    def get_current_parallelism(self) -> int:
        return 1

    def stop_engine(self) -> None:
        if self._own_connection:
            self._connection.close()

    def encode_name(self, name: str) -> str:
        return self._profile.quote(name)

    def convert_yield_dataframe(self, df: DataFrame, as_local: bool) -> DataFrame:
        # warehouse frames die with the connection: results yielded past
        # the engine's lifetime must be local copies.
        # ctx_count <= 1 = the top-level (per-run) context — the engine
        # stops when it exits, so the yield must not reference it
        if as_local or (self._own_connection and self._ctx_count <= 1):
            return df.as_local() if isinstance(df, WarehouseDataFrame) else df
        return df

    # ---- data movement ----------------------------------------------------
    def to_df(self, df: Any, schema: Any = None) -> WarehouseDataFrame:
        if isinstance(df, WarehouseDataFrame):
            assert_or_throw(
                schema is None or Schema(schema) == df.schema,
                FugueInvalidOperation("schema must match the warehouse frame"),
            )
            return df
        local = self._local_engine.to_df(df, schema)
        return self.ingest(local)

    def temp_frame(self, tbl: str, schema: Schema) -> WarehouseDataFrame:
        """Wrap a materialized temp table, recording its schema and its
        drop-on-release lifecycle."""
        self.record_schema(tbl, schema)
        return self.track_temp_table(WarehouseDataFrame(self, tbl, schema))

    def track_temp_table(self, frame: WarehouseDataFrame) -> WarehouseDataFrame:
        """Register ``frame``'s temp table for DROP when the frame is
        garbage-collected — chained pipelines would otherwise hold a full
        copy of every intermediate result for the connection's lifetime."""
        import weakref

        weakref.finalize(frame, _drop_table_quietly, self._connection, frame.table)
        return frame

    def ingest(self, df: DataFrame) -> WarehouseDataFrame:
        """Write a local frame into a warehouse temp table."""
        tbl = next(_TEMP_TABLE_NAMES)
        schema = df.schema
        with get_tracer().span("warehouse.ingest", cat="warehouse", annotate=True, table=tbl) as sp:
            self._connection.execute(
                self._profile.create_temp_table_sql(tbl, schema)
            )
            arrow = df.as_arrow() if not isinstance(df, ArrowDataFrame) else df.native
            rows = _arrow_to_storage_rows(arrow, schema)
            self._connection.executemany(
                self._profile.insert_sql(tbl, len(schema.fields)), rows
            )
            sp.set(rows=len(rows))
        self.record_schema(tbl, schema)
        return self.track_temp_table(WarehouseDataFrame(self, tbl, schema))

    def materialize(self, sql: str) -> str:
        """Run ``sql`` into a fresh temp table; return the table name."""
        tbl = next(_TEMP_TABLE_NAMES)
        with get_tracer().span("warehouse.materialize", cat="warehouse", annotate=True, table=tbl):
            self._connection.execute(
                self._profile.create_temp_table_as_sql(tbl, sql)
            )
        return tbl

    def record_schema(
        self, table: str, schema: Schema, persistent: bool = False
    ) -> None:
        self._schemas[table] = schema
        if persistent:
            # schema fidelity across engine instances over the same DB file:
            # sqlite's storage classes can't round-trip bool/datetime/int
            # widths, so the exact Fugue schema rides in a meta table
            self._connection.execute(self._profile.meta_create_sql())
            self._connection.execute(
                self._profile.meta_upsert_sql(), (table, str(schema))
            )

    def infer_table_schema(self, table: str) -> Schema:
        """Schema of a warehouse table: recorded if known, else inferred
        from sqlite column decltypes + value sampling (the price of a
        dynamically-typed warehouse; recorded schemas are authoritative).

        Known degradation: a raw-SQL SELECT whose computed columns carry
        no decltype AND whose result set is empty has nothing to sample,
        so those columns fall back to string (a plain DB-API cursor
        carries no types of its own). Recorded schemas — every table
        produced by ingest/temp_frame/save_table — never hit this path.
        """
        if table in self._schemas:
            return self._schemas[table]
        cur = self._connection.execute(
            self._profile.meta_select_sql(), (table,)
        ) if self._meta_exists() else None
        row = cur.fetchone() if cur is not None else None
        if row is not None:
            schema = Schema(row[1])
            self._schemas[table] = schema
            return schema
        fields: List[pa.Field] = []
        for name, decltype in self._profile.table_info(self._connection, table):
            tp = self._profile.decl_to_arrow(decltype)
            if tp is None:
                tp = self._sample_type(table, name)
            fields.append(pa.field(name, tp))
        schema = Schema(fields)
        self._schemas[table] = schema
        return schema

    def _meta_exists(self) -> bool:
        cur = self._connection.execute(
            self._profile.table_exists_sql(views=False), (_SCHEMA_META_TABLE,)
        )
        return cur.fetchone() is not None

    def _sample_type(self, table: str, col: str) -> pa.DataType:
        cur = self._connection.execute(
            f"SELECT typeof({self.encode_name(col)}) FROM "
            f"{self.encode_name(table)} WHERE {self.encode_name(col)} "
            "IS NOT NULL LIMIT 1"
        )
        row = cur.fetchone()
        kind = row[0] if row is not None else None
        return {
            "integer": pa.int64(),
            "real": pa.float64(),
            "text": pa.string(),
            "blob": pa.binary(),
        }.get(kind, pa.string())

    def fetch_arrow(self, table: str, schema: Schema) -> pa.Table:
        return self.fetch_arrow_query(
            "SELECT "
            + ", ".join(self.encode_name(n) for n in schema.names)
            + f" FROM {self.encode_name(table)}",
            schema,
            table=table,
        )

    def fetch_arrow_query(
        self, sql: str, schema: Schema, table: Optional[str] = None
    ) -> pa.Table:
        """Run ``sql`` and build its rows into an arrow table of ``schema``;
        ``table`` names, in the span, the table the query reads whole."""
        with get_tracer().span(
            "warehouse.fetch", cat="warehouse", annotate=True, table=table
        ) as sp:
            cur = self._connection.execute(sql)
            rows = cur.fetchall()
            cols = list(zip(*rows)) if len(rows) > 0 else [[] for _ in schema.fields]
            arrays = [
                _storage_to_arrow(list(vals), f.type)
                for vals, f in zip(cols, schema.fields)
            ]
            sp.set(rows=len(rows))
            return pa.Table.from_arrays(arrays, schema=schema.pa_schema)

    # ---- literals for generated SQL ---------------------------------------
    def lit_sql(self, value: Any) -> str:
        if value is None:
            return "NULL"
        if isinstance(value, bool):
            return "1" if value else "0"
        if isinstance(value, float):
            import math

            if math.isnan(value):
                return "NULL"  # SQL has no NaN literal; NULL is its storage
            if math.isinf(value):
                # sqlite parses out-of-range literals to ±Infinity
                return "9e999" if value > 0 else "-9e999"
            return repr(value)
        if isinstance(value, int):
            return repr(value)
        if isinstance(value, bytes):
            return "X'" + value.hex() + "'"
        if isinstance(value, datetime.datetime):
            return "'" + value.isoformat(sep=" ") + "'"
        if isinstance(value, datetime.date):
            return "'" + value.isoformat() + "'"
        return "'" + str(value).replace("'", "''") + "'"

    # ---- distribution primitives (single warehouse: metadata no-ops) ------
    def repartition(self, df: DataFrame, partition_spec: PartitionSpec) -> DataFrame:
        self.log.warning("%s doesn't respect repartition", self)
        return df

    def broadcast(self, df: DataFrame) -> DataFrame:
        return df

    def persist(self, df: DataFrame, lazy: bool = False, **kwargs: Any) -> DataFrame:
        return self.to_df(df)  # frames are materialized tables already

    # ---- relational verbs as warehouse SQL --------------------------------
    def join(
        self,
        df1: DataFrame,
        df2: DataFrame,
        how: str,
        on: Optional[List[str]] = None,
    ) -> DataFrame:
        d1, d2 = self.to_df(df1), self.to_df(df2)
        key_schema, end_schema = get_join_schemas(d1, d2, how=how, on=on)
        keys = key_schema.names
        a, b = self.encode_name(d1.table), self.encode_name(d2.table)
        how_l = how.lower().replace("_", "").replace(" ", "")
        # plain = (not null-safe IS): NULL join keys never match, matching
        # the suites' join semantics on every engine
        on_clause = " AND ".join(
            f"a.{self.encode_name(k)} = b.{self.encode_name(k)}" for k in keys
        )

        def _sel(key_side: str, coalesce_keys: bool = False) -> str:
            """Projection in end-schema order: key columns read from
            ``key_side`` (COALESCEd across sides for full outer), non-key
            columns from the side that owns them."""
            cols = []
            for n in end_schema.names:
                en = self.encode_name(n)
                if n in keys:
                    other = "b" if key_side == "a" else "a"
                    cols.append(
                        f"COALESCE({key_side}.{en}, {other}.{en}) AS {en}"
                        if coalesce_keys
                        else f"{key_side}.{en} AS {en}"
                    )
                else:
                    side = "a" if n in d1.schema else "b"
                    cols.append(f"{side}.{en} AS {en}")
            return ", ".join(cols)

        if how_l == "cross":
            sql = f"SELECT {_sel('a')} FROM {a} AS a CROSS JOIN {b} AS b"
        elif how_l == "inner":
            sql = f"SELECT {_sel('a')} FROM {a} AS a JOIN {b} AS b ON {on_clause}"
        elif how_l == "leftouter":
            sql = f"SELECT {_sel('a')} FROM {a} AS a LEFT JOIN {b} AS b ON {on_clause}"
        elif how_l == "rightouter":
            # mirrored left join; the right side owns the key values
            sql = (
                f"SELECT {_sel('b')} FROM {b} AS b "
                f"LEFT JOIN {a} AS a ON {on_clause}"
            )
        elif how_l == "fullouter":
            if self._profile.supports_full_outer_join:
                sql = (
                    f"SELECT {_sel('a', coalesce_keys=True)} FROM {a} AS a "
                    f"FULL OUTER JOIN {b} AS b ON {on_clause}"
                )
            else:
                # emulation for databases without FULL OUTER JOIN (sqlite
                # < 3.39): left join ∪ right rows with NO left match.
                # ``a.rowid IS NULL`` (not a payload column) detects the
                # no-match case even when every a-column is legitimately
                # NULL; NULL-keyed b rows never match so they land in the
                # anti part with their own key values
                sql = (
                    f"SELECT {_sel('a', coalesce_keys=True)} FROM {a} AS a "
                    f"LEFT JOIN {b} AS b ON {on_clause} "
                    f"UNION ALL "
                    f"SELECT {_sel('b')} FROM {b} AS b "
                    f"LEFT JOIN {a} AS a ON {on_clause} WHERE a.rowid IS NULL"
                )
        elif how_l in ("semi", "leftsemi"):
            cond = " AND ".join(
                f"b.{self.encode_name(k)} = a.{self.encode_name(k)}" for k in keys
            )
            sql = (
                f"SELECT * FROM {a} AS a WHERE EXISTS "
                f"(SELECT 1 FROM {b} AS b WHERE {cond})"
            )
        elif how_l in ("anti", "leftanti"):
            cond = " AND ".join(
                f"b.{self.encode_name(k)} = a.{self.encode_name(k)}" for k in keys
            )
            sql = (
                f"SELECT * FROM {a} AS a WHERE NOT EXISTS "
                f"(SELECT 1 FROM {b} AS b WHERE {cond})"
            )
        else:
            raise FugueInvalidOperation(f"{how} is not a valid join type")
        return self.temp_frame(self.materialize(sql), end_schema)

    def union(self, df1: DataFrame, df2: DataFrame, distinct: bool = True) -> DataFrame:
        return self._set_op("UNION" if distinct else "UNION ALL", df1, df2)

    def subtract(
        self, df1: DataFrame, df2: DataFrame, distinct: bool = True
    ) -> DataFrame:
        if distinct:
            return self._set_op("EXCEPT", df1, df2)
        return self._bag_set_op("EXCEPT", df1, df2)

    def intersect(
        self, df1: DataFrame, df2: DataFrame, distinct: bool = True
    ) -> DataFrame:
        if distinct:
            return self._set_op("INTERSECT", df1, df2)
        return self._bag_set_op("INTERSECT", df1, df2)

    def _set_op(self, op: str, df1: DataFrame, df2: DataFrame) -> DataFrame:
        d1, d2 = self.to_df(df1), self.to_df(df2)
        assert_or_throw(
            d1.schema == d2.schema,
            FugueInvalidOperation(f"schema mismatch {d1.schema} vs {d2.schema}"),
        )
        cols = ", ".join(self.encode_name(n) for n in d1.schema.names)
        sql = (
            f"SELECT {cols} FROM {self.encode_name(d1.table)} {op} "
            f"SELECT {cols} FROM {self.encode_name(d2.table)}"
        )
        return self.temp_frame(self.materialize(sql), d1.schema)

    def _bag_set_op(self, op: str, df1: DataFrame, df2: DataFrame) -> DataFrame:
        """Bag (``ALL``) semantics for EXCEPT/INTERSECT, which sqlite only
        offers as distinct: number duplicate rows on both sides, apply the
        distinct op over (row, duplicate-index), then drop the index."""
        d1, d2 = self.to_df(df1), self.to_df(df2)
        assert_or_throw(
            d1.schema == d2.schema,
            FugueInvalidOperation(f"schema mismatch {d1.schema} vs {d2.schema}"),
        )
        names = d1.schema.names
        cols = ", ".join(self.encode_name(n) for n in names)
        part = ", ".join(self.encode_name(n) for n in names)
        rn = self.encode_name(_ROWNUM_COL)

        def _numbered(tbl: str) -> str:
            return (
                f"SELECT {cols}, ROW_NUMBER() OVER (PARTITION BY {part}) AS {rn} "
                f"FROM {self.encode_name(tbl)}"
            )

        sql = (
            f"SELECT {cols} FROM ({_numbered(d1.table)} {op} "
            f"{_numbered(d2.table)})"
        )
        return self.temp_frame(self.materialize(sql), d1.schema)

    def distinct(self, df: DataFrame) -> DataFrame:
        d = self.to_df(df)
        cols = ", ".join(self.encode_name(n) for n in d.schema.names)
        return self.temp_frame(
            self.materialize(
                f"SELECT DISTINCT {cols} FROM {self.encode_name(d.table)}"
            ),
            d.schema,
        )

    def dropna(
        self,
        df: DataFrame,
        how: str = "any",
        thresh: Optional[int] = None,
        subset: Optional[List[str]] = None,
    ) -> DataFrame:
        d = self.to_df(df)
        names = subset if subset is not None else d.schema.names
        assert_or_throw(
            all(n in d.schema for n in names),
            FugueInvalidOperation(f"{names} not a subset of {d.schema}"),
        )
        assert_or_throw(
            how in ("any", "all"), ValueError(f"how must be 'any' or 'all', got {how!r}")
        )
        nn = [f"({self.encode_name(n)} IS NOT NULL)" for n in names]
        if thresh is not None:
            assert_or_throw(
                how == "any", ValueError("when thresh is set, how must be 'any'")
            )
            cond = " + ".join(nn) + f" >= {int(thresh)}"
        elif how == "any":
            cond = " AND ".join(nn)
        else:  # "all": keep rows with at least one non-null
            cond = " OR ".join(nn)
        return self.temp_frame(
            self.materialize(
                f"SELECT * FROM {self.encode_name(d.table)} WHERE {cond}"
            ),
            d.schema,
        )

    def fillna(
        self, df: DataFrame, value: Any, subset: Optional[List[str]] = None
    ) -> DataFrame:
        d = self.to_df(df)
        if isinstance(value, dict):
            assert_or_throw(
                all(v is not None for v in value.values()),
                ValueError("fillna value can not be None or contain None"),
            )
            vd = value
        else:
            assert_or_throw(value is not None, ValueError("fillna value can not be None"))
            names = subset if subset is not None else d.schema.names
            vd = {n: value for n in names}
        cols = []
        for n in d.schema.names:
            if n in vd:
                cols.append(
                    f"COALESCE({self.encode_name(n)}, {self.lit_sql(vd[n])}) "
                    f"AS {self.encode_name(n)}"
                )
            else:
                cols.append(self.encode_name(n))
        return self.temp_frame(
            self.materialize(
                f"SELECT {', '.join(cols)} FROM {self.encode_name(d.table)}"
            ),
            d.schema,
        )

    def sample(
        self,
        df: DataFrame,
        n: Optional[int] = None,
        frac: Optional[float] = None,
        replace: bool = False,
        seed: Optional[int] = None,
    ) -> DataFrame:
        assert_or_throw(
            (n is None) != (frac is None),
            ValueError("one and only one of n and frac should be non-negative"),
        )
        assert_or_throw(
            not replace,
            NotImplementedError("warehouse sample doesn't support replacement"),
        )
        d = self.to_df(df)
        cols = ", ".join(self.encode_name(c) for c in d.schema.names)
        if seed is not None:
            # deterministic seeded sample: a golden-ratio multiplicative
            # hash of a generated row number mixed with the seed stands in
            # for random() — same seed + same table contents = same
            # sample, matching the other engines' reproducibility contract
            # (consecutive row numbers step by ~0.618 * 2^32 mod 2^32, the
            # Weyl equidistribution). ROW_NUMBER() rather than rowid: a
            # user column named "rowid" shadows sqlite's, and views have
            # none. The pre-multiply % 2^31 keeps the product inside
            # sqlite's signed 64-bit INTEGER (2^31 * 2654435761 < 2^63)
            # even for billion-row tables / huge seeds; the hash pattern
            # repeats past 2^31 rows, which sampling tolerates.
            rn = "__ft_rn"
            while rn in d.schema.names:
                rn = "_" + rn
            h = (
                f"((({rn} + {int(seed) & 0x7FFFFFFF}) % 2147483648) "
                "* 2654435761 % 4294967296)"
            )
            src = (
                f"(SELECT {cols}, ROW_NUMBER() OVER () AS {rn} "
                f"FROM {self.encode_name(d.table)})"
            )
            if frac is not None:
                sql = (
                    f"SELECT {cols} FROM {src} "
                    f"WHERE ({h} / 4294967296.0) < {float(frac)}"
                )
            else:
                sql = f"SELECT {cols} FROM {src} ORDER BY {h} LIMIT {int(n)}"
        elif frac is not None:
            # random() is a signed 64-bit int; map onto [0, 1)
            sql = (
                f"SELECT {cols} FROM {self.encode_name(d.table)} "
                f"WHERE (random() / 18446744073709551616.0 + 0.5) < {float(frac)}"
            )
        else:
            sql = (
                f"SELECT {cols} FROM {self.encode_name(d.table)} "
                f"ORDER BY random() LIMIT {int(n)}"
            )
        return self.temp_frame(self.materialize(sql), d.schema)

    def take(
        self,
        df: DataFrame,
        n: int,
        presort: str,
        na_position: str = "last",
        partition_spec: Optional[PartitionSpec] = None,
    ) -> DataFrame:
        assert_or_throw(isinstance(n, int), ValueError("n needs to be an integer"))
        partition_spec = partition_spec or PartitionSpec()
        d = self.to_df(df)
        _presort = (
            parse_presort_exp(presort)
            if presort is not None and presort != ""
            else partition_spec.presort
        )
        sorts: List[str] = []
        for k, asc in _presort.items():
            s = self.encode_name(k) + (" ASC" if asc else " DESC")
            s += " NULLS FIRST" if na_position == "first" else " NULLS LAST"
            sorts.append(s)
        order_by = ("ORDER BY " + ", ".join(sorts)) if len(sorts) > 0 else ""
        cols = ", ".join(self.encode_name(c) for c in d.schema.names)
        if len(partition_spec.partition_by) == 0:
            sql = f"SELECT * FROM {self.encode_name(d.table)} {order_by} LIMIT {n}"
        else:
            pcols = ", ".join(
                self.encode_name(c) for c in partition_spec.partition_by
            )
            rn = self.encode_name(_ROWNUM_COL)
            sql = (
                f"SELECT {cols} FROM ("
                f"SELECT {cols}, ROW_NUMBER() OVER (PARTITION BY {pcols} "
                f"{order_by}) AS {rn} FROM {self.encode_name(d.table)}"
                f") WHERE {rn} <= {n}"
            )
        return self.temp_frame(self.materialize(sql), d.schema)

    # ---- column-IR pushdown ------------------------------------------------
    def select(
        self,
        df: DataFrame,
        cols: SelectColumns,
        where: Optional[ColumnExpr] = None,
        having: Optional[ColumnExpr] = None,
    ) -> DataFrame:
        """Column-IR SELECT generated as SQL and run in the warehouse; the
        base class would evaluate it over pandas on the host instead."""
        d = self.to_df(df)
        schema = cols.replace_wildcard(d.schema).infer_schema(d.schema)
        if schema is None:
            # some expression type can't be statically inferred — fall back
            # to the base (host-side) evaluation for exactness
            return super().select(df, cols, where=where, having=having)
        sql = self._gen.select(
            cols, self.encode_name(d.table), where=where, having=having
        )
        return self.temp_frame(self.materialize(sql), schema)

    # ---- IO ----------------------------------------------------------------
    def load_df(
        self,
        path: Any,
        format_hint: Any = None,
        columns: Any = None,
        **kwargs: Any,
    ) -> DataFrame:
        with get_tracer().span("warehouse.load", cat="warehouse", annotate=True) as sp:
            tbl = _io_load_df(path, format_hint=format_hint, columns=columns, **kwargs)
            sp.set(rows=tbl.num_rows)
            return self.ingest(ArrowDataFrame(tbl))

    def save_df(
        self,
        df: DataFrame,
        path: str,
        format_hint: Any = None,
        mode: str = "overwrite",
        partition_spec: Optional[PartitionSpec] = None,
        force_single: bool = False,
        **kwargs: Any,
    ) -> None:
        partition_cols = (
            list(partition_spec.partition_by)
            if partition_spec is not None and len(partition_spec.partition_by) > 0
            else None
        )
        _io_save_df(
            self.to_df(df).as_arrow(),
            path,
            format_hint=format_hint,
            mode=mode,
            partition_cols=partition_cols,
            **kwargs,
        )


class SQLiteExecutionEngine(WarehouseExecutionEngine):
    """The stdlib-backed concrete warehouse (sqlite3) — registered as
    engine name ``"sqlite"``. ``conf["fugue.sqlite.path"]`` selects a DB
    file; default is in-memory."""

    def __init__(self, conf: Any = None, connection: Any = None, **kwargs: Any):
        from .._utils.params import ParamDict

        # a malformed path must fail loudly — silently opening :memory:
        # would let save_table writes vanish with the process
        path = ParamDict(conf).get_or_none("fugue.sqlite.path", str) or ":memory:"
        super().__init__(conf, connection=connection, path=path)


# ---- storage conversion helpers ------------------------------------------


def _arrow_to_storage_rows(tbl: pa.Table, schema: Schema) -> List[Tuple]:
    """Arrow table → python rows in sqlite storage form (bool→int,
    datetime→ISO text); exact for int64 (python ints are unbounded)."""
    converters: List[Optional[Callable[[Any], Any]]] = []
    for f in schema.fields:
        if pa.types.is_boolean(f.type):
            converters.append(lambda v: None if v is None else int(v))
        elif pa.types.is_timestamp(f.type):
            converters.append(
                lambda v: None if v is None else v.isoformat(sep=" ")
            )
        elif pa.types.is_date(f.type):
            converters.append(lambda v: None if v is None else v.isoformat())
        else:
            converters.append(None)
    cols = [tbl.column(f.name).to_pylist() for f in schema.fields]
    out: List[Tuple] = []
    for row in zip(*cols) if len(cols) > 0 else []:
        out.append(
            tuple(
                v if c is None else c(v) for v, c in zip(row, converters)
            )
        )
    return out


def _storage_to_arrow(values: List[Any], tp: pa.DataType) -> pa.Array:
    """Sqlite storage values → arrow array of the declared type."""
    if pa.types.is_boolean(tp):
        values = [None if v is None else bool(v) for v in values]
        return pa.array(values, type=tp)
    if pa.types.is_timestamp(tp):
        values = [
            None if v is None else datetime.datetime.fromisoformat(str(v))
            for v in values
        ]
        return pa.array(values, type=tp)
    if pa.types.is_date(tp):
        values = [
            None if v is None else datetime.date.fromisoformat(str(v))
            for v in values
        ]
        return pa.array(values, type=tp)
    if pa.types.is_floating(tp):
        # sqlite may hand back ints for REAL columns holding whole numbers
        values = [None if v is None else float(v) for v in values]
        return pa.array(values, type=tp)
    return pa.array(values, type=tp)


def _close_quietly(connection: Any) -> None:
    """weakref-finalizer body: best-effort close of an owned connection."""
    try:
        connection.close()
    except Exception:
        pass


def _drop_table_quietly(connection: Any, table: str) -> None:
    """weakref-finalizer body: best-effort DROP of a released temp table
    (the connection may already be closed at interpreter shutdown)."""
    try:
        with get_tracer().span("warehouse.drop", cat="warehouse", table=table):
            connection.execute('DROP TABLE IF EXISTS "' + table.replace('"', '""') + '"')
    except Exception:
        pass
