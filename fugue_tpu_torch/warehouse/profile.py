"""Warehouse database profiles, copied from ``fugue_tpu/warehouse/profile.py``:
the per-database half of the DB-API layer. Everything database-specific
(identifier quoting, storage type names, DDL shapes, introspection
queries, bind-parameter style, the upsert spelling of the schema meta
table) lives in a :class:`WarehouseProfile`; the warehouse engine
(``execution_engine.py``) is written against this interface and portable
SQL, transpiled to the profile's dialect by ``sql/dialect.py``.

Two profiles: :class:`SQLiteProfile` (live: sqlite3 is in the standard
library) and :class:`PostgresProfile` (emission only: its SQL text is
held against known-good postgres syntax in the tests; no server needed).
"""

from typing import Any, List, Optional, Tuple

import pyarrow as pa

from ..exceptions import FugueInvalidOperation
from ..schema import Schema

_SCHEMA_META_TABLE = "__fugue_schemas__"


class WarehouseProfile:
    """Database-specific SQL construction + introspection for one database."""

    #: profile name AND the transpile-target dialect (``sql/dialect.py``)
    name: str = ""
    #: DB-API paramstyle: "qmark" (?) or "format" (%s)
    paramstyle: str = "qmark"

    @property
    def supports_full_outer_join(self) -> bool:
        """Whether the database executes FULL OUTER JOIN natively; when
        False the engine emulates it (left join ∪ right-anti rows)."""
        return True

    # -- identifiers / parameters ------------------------------------------
    def quote(self, name: str) -> str:
        return '"' + name.replace('"', '""') + '"'

    def placeholder(self, index: int) -> str:
        return "?" if self.paramstyle == "qmark" else "%s"

    def placeholders(self, n: int) -> str:
        return ", ".join(self.placeholder(i) for i in range(n))

    # -- types --------------------------------------------------------------
    def storage_type(self, tp: pa.DataType) -> str:
        """Column type name for CREATE TABLE; raise for unstorable types."""
        raise NotImplementedError

    # -- DDL / DML ----------------------------------------------------------
    def create_temp_table_sql(self, table: str, schema: Schema) -> str:
        cols = ", ".join(
            f"{self.quote(f.name)} {self.storage_type(f.type)}"
            for f in schema.fields
        )
        return f"CREATE TEMP TABLE {self.quote(table)} ({cols})"

    def insert_sql(self, table: str, n_cols: int) -> str:
        return (
            f"INSERT INTO {self.quote(table)} "
            f"VALUES ({self.placeholders(n_cols)})"
        )

    def create_temp_table_as_sql(self, table: str, select_sql: str) -> str:
        return f"CREATE TEMP TABLE {self.quote(table)} AS {select_sql}"

    def drop_table_sql(self, table: str) -> str:
        return f"DROP TABLE IF EXISTS {self.quote(table)}"

    # -- schema meta table (exact fugue schemas across engine instances) ----
    def meta_create_sql(self) -> str:
        return (
            f"CREATE TABLE IF NOT EXISTS {_SCHEMA_META_TABLE} "
            "(tbl TEXT PRIMARY KEY, schema TEXT)"
        )

    def meta_upsert_sql(self) -> str:
        raise NotImplementedError

    def meta_select_sql(self) -> str:
        return (
            f"SELECT tbl, schema FROM {_SCHEMA_META_TABLE} "
            f"WHERE tbl = {self.placeholder(0)}"
        )

    # -- introspection -------------------------------------------------------
    def table_exists_sql(self, views: bool = True) -> str:
        """One bind param: the table name. Returns ≥1 row iff it exists."""
        raise NotImplementedError

    def table_info(self, connection: Any, table: str) -> List[Tuple[str, str]]:
        """[(column_name, declared_type)] for an existing table."""
        raise NotImplementedError

    def decl_to_arrow(self, decl: str) -> Optional[pa.DataType]:
        """Declared column type → arrow type; None = needs value sampling."""
        raise NotImplementedError


class SQLiteProfile(WarehouseProfile):
    name = "sqlite"
    paramstyle = "qmark"

    @property
    def supports_full_outer_join(self) -> bool:
        # FULL/RIGHT OUTER JOIN arrived in sqlite 3.39 (2022-06); older
        # baked-in libs (e.g. 3.34) need the emulated form
        import sqlite3

        ver = tuple(int(x) for x in sqlite3.sqlite_version.split(".")[:2])
        return ver >= (3, 39)

    _STORAGE: List[Tuple[Any, str]] = [
        (pa.types.is_boolean, "INTEGER"),
        (pa.types.is_integer, "INTEGER"),
        (pa.types.is_floating, "REAL"),
        (pa.types.is_string, "TEXT"),
        (pa.types.is_large_string, "TEXT"),
        (pa.types.is_binary, "BLOB"),
        (pa.types.is_large_binary, "BLOB"),
        (pa.types.is_timestamp, "TEXT"),
        (pa.types.is_date, "TEXT"),
    ]

    def storage_type(self, tp: pa.DataType) -> str:
        for pred, st in self._STORAGE:
            if pred(tp):
                return st
        raise FugueInvalidOperation(
            f"type {tp} has no {self.name} storage mapping (nested/decimal "
            "columns are not supported by the warehouse engine)"
        )

    def meta_upsert_sql(self) -> str:
        return f"INSERT OR REPLACE INTO {_SCHEMA_META_TABLE} VALUES (?, ?)"

    def table_exists_sql(self, views: bool = True) -> str:
        kinds = "('table','view')" if views else "('table')"
        return (
            "SELECT name FROM sqlite_master "
            f"WHERE type IN {kinds} AND name = ?"
        )

    def table_info(self, connection: Any, table: str) -> List[Tuple[str, str]]:
        rows = connection.execute(
            f"PRAGMA table_info({self.quote(table)})"
        ).fetchall()
        return [(name, decl or "") for _, name, decl, *_rest in rows]

    def decl_to_arrow(self, decl: str) -> Optional[pa.DataType]:
        decl = (decl or "").upper()
        if "INT" in decl:
            return pa.int64()
        if decl in ("REAL", "FLOAT", "DOUBLE"):
            return pa.float64()
        if "CHAR" in decl or "TEXT" in decl:
            return pa.string()
        if "BLOB" in decl:
            return pa.binary()
        return None  # dynamic typing: sample values


class PostgresProfile(WarehouseProfile):
    """Emission profile for PostgreSQL (psycopg-style DB-API).

    Golden tests pin every SQL string the engine would send; no server is
    needed. The mappings follow postgres documentation syntax:
    ``information_schema`` introspection, ``%s`` placeholders,
    ``ON CONFLICT`` upsert, real column types (no storage-class collapse,
    so ``decl_to_arrow`` never needs value sampling)."""

    name = "postgres"
    paramstyle = "format"

    _STORAGE: List[Tuple[Any, str]] = [
        (pa.types.is_boolean, "BOOLEAN"),
        (lambda t: pa.types.is_integer(t) and t.bit_width <= 16, "SMALLINT"),
        (lambda t: pa.types.is_integer(t) and t.bit_width <= 32, "INTEGER"),
        (pa.types.is_integer, "BIGINT"),
        (lambda t: pa.types.is_floating(t) and t.bit_width <= 32, "REAL"),
        (pa.types.is_floating, "DOUBLE PRECISION"),
        (pa.types.is_string, "TEXT"),
        (pa.types.is_large_string, "TEXT"),
        (pa.types.is_binary, "BYTEA"),
        (pa.types.is_large_binary, "BYTEA"),
        (pa.types.is_timestamp, "TIMESTAMP"),
        (pa.types.is_date, "DATE"),
    ]

    def storage_type(self, tp: pa.DataType) -> str:
        for pred, st in self._STORAGE:
            if pred(tp):
                return st
        raise FugueInvalidOperation(
            f"type {tp} has no {self.name} storage mapping (nested/decimal "
            "columns are not supported by the warehouse engine)"
        )

    def create_temp_table_sql(self, table: str, schema: Schema) -> str:
        cols = ", ".join(
            f"{self.quote(f.name)} {self.storage_type(f.type)}"
            for f in schema.fields
        )
        return f"CREATE TEMPORARY TABLE {self.quote(table)} ({cols})"

    def create_temp_table_as_sql(self, table: str, select_sql: str) -> str:
        return f"CREATE TEMPORARY TABLE {self.quote(table)} AS {select_sql}"

    def meta_upsert_sql(self) -> str:
        return (
            f"INSERT INTO {_SCHEMA_META_TABLE} VALUES (%s, %s) "
            "ON CONFLICT (tbl) DO UPDATE SET schema = EXCLUDED.schema"
        )

    def table_exists_sql(self, views: bool = True) -> str:
        if views:
            return (
                "SELECT table_name FROM information_schema.tables "
                "WHERE table_name = %s"
            )
        return (
            "SELECT table_name FROM information_schema.tables "
            "WHERE table_type = 'BASE TABLE' AND table_name = %s"
        )

    def table_info(self, connection: Any, table: str) -> List[Tuple[str, str]]:
        cur = connection.execute(
            "SELECT column_name, data_type FROM information_schema.columns "
            "WHERE table_name = %s ORDER BY ordinal_position",
            (table,),
        )
        return [(name, decl or "") for name, decl in cur.fetchall()]

    def decl_to_arrow(self, decl: str) -> Optional[pa.DataType]:
        decl = (decl or "").upper()
        mapping = {
            "BOOLEAN": pa.bool_(),
            "SMALLINT": pa.int16(),
            "INTEGER": pa.int32(),
            "BIGINT": pa.int64(),
            "REAL": pa.float32(),
            "DOUBLE PRECISION": pa.float64(),
            "TEXT": pa.string(),
            "CHARACTER VARYING": pa.string(),
            "BYTEA": pa.binary(),
            "TIMESTAMP": pa.timestamp("us"),
            "TIMESTAMP WITHOUT TIME ZONE": pa.timestamp("us"),
            "DATE": pa.date32(),
        }
        return mapping.get(decl)


PROFILES = {
    "sqlite": SQLiteProfile,
    "postgres": PostgresProfile,
}


def get_profile(name: Any) -> WarehouseProfile:
    if isinstance(name, WarehouseProfile):
        return name
    key = str(name or "sqlite").lower()
    if key not in PROFILES:
        raise FugueInvalidOperation(
            f"unknown warehouse profile {name!r}; known: {sorted(PROFILES)}"
        )
    return PROFILES[key]()
