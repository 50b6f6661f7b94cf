"""The port's warehouse (``fugue_tpu_torch/warehouse``) against the JAX
package's (``fugue_tpu/warehouse``), on the CPU.

Each case of ``tests/warehouse/test_sqlite_engine.py`` and
``test_profiles.py`` is written once over a namespace of either package
(``J`` the reference, ``T`` the port), runs on both packages'
``SQLiteExecutionEngine`` over the same inputs (made with numpy where
they are not the reference's literals), and the two answers are held
equal: rows (sorted where the verb has no order), schemas, frame types,
raised errors and the SQL text the profiles and the expression generator
emit. Both engines run the same SQL on the same sqlite, so every value is
compared exactly.

Also: C26 (a ``CONNECT`` to an engine name stops the temporary engine it
made, once, and never the running engine), the engine names ``sqlite``
and ``sqlite_torch``, a ``sqlite3.Connection`` as an engine, and
``CONNECT sqlite``.
"""

import sqlite3
import unittest.mock as mock
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu.api as fa
import fugue_tpu.column.sql as jcolsql
import fugue_tpu.warehouse.execution_engine as jwee
import fugue_tpu.warehouse.profile as jprofile
from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.collections.sql import StructuredRawSQL as JStructuredRawSQL
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.column import lit as jlit
from fugue_tpu.dataframe import DataFrames as JDataFrames
from fugue_tpu.exceptions import FugueInvalidOperation as JFugueInvalidOperation
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.execution.factory import infer_execution_engine as jinfer_execution_engine
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu.warehouse import SQLiteExecutionEngine as JSQLiteExecutionEngine
from fugue_tpu.warehouse import WarehouseDataFrame as JWarehouseDataFrame

import fugue_tpu_torch.column.sql as tcolsql
import fugue_tpu_torch.warehouse.execution_engine as twee
import fugue_tpu_torch.warehouse.profile as tprofile
from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.collections.sql import StructuredRawSQL
from fugue_tpu_torch.column import col, lit
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.dataframe import DataFrames
from fugue_tpu_torch.exceptions import FugueInvalidOperation
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.execution.execution_engine import ExecutionEngine
from fugue_tpu_torch.execution.factory import make_execution_engine
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from fugue_tpu_torch.warehouse import (
    SQLiteExecutionEngine,
    WarehouseDataFrame,
    WarehouseTorchExecutionEngine,
)

J = SimpleNamespace(
    name="ref", Engine=JSQLiteExecutionEngine, WDF=JWarehouseDataFrame, PS=JPartitionSpec,
    col=jcol, lit=jlit, ff=jff, DataFrames=JDataFrames, SQL=JStructuredRawSQL, Schema=JSchema,
    Invalid=JFugueInvalidOperation, fugue_sql=fa.fugue_sql, transform=fa.transform,
    as_fugue_df=fa.as_fugue_df, wee=jwee, profile=jprofile, colsql=jcolsql,
)
T = SimpleNamespace(
    name="port", Engine=SQLiteExecutionEngine, WDF=WarehouseDataFrame, PS=PartitionSpec,
    col=col, lit=lit, ff=ff, DataFrames=DataFrames, SQL=StructuredRawSQL, Schema=Schema,
    Invalid=FugueInvalidOperation, fugue_sql=api.fugue_sql, transform=api.transform,
    as_fugue_df=api.as_fugue_df, wee=twee, profile=tprofile, colsql=tcolsql,
)

BASE = {"k": [1, 2, 1, 3, 2], "v": [1.0, 2.0, 3.0, 4.0, 5.0], "s": ["a", "b", "c", "d", "e"]}


def _both(case):
    """``case(M, eng)`` on a fresh sqlite engine of each package; the two
    answers (or the two raised error types) must be equal."""
    out = {}
    for M in (J, T):
        eng = M.Engine()
        try:
            out[M.name] = case(M, eng)
        except Exception as e:  # the same error class name on both
            out[M.name] = ("raised", type(e).__name__)
        finally:
            eng.stop_engine()
    assert out["port"] == out["ref"], out
    return out["port"]


def _rows(df):
    return sorted(df.as_array(), key=repr)


def _desc(df):
    """What a case compares of a frame: its class name, schema, arrow
    types and its rows in order."""
    return type(df).__name__, str(df.schema), [str(t) for t in df.as_arrow().schema.types], df.as_array()


# ---- tests/warehouse/test_sqlite_engine.py -------------------------------------


def test_ingest_fetch_roundtrip():
    def case(M, eng):
        wdf = eng.to_df(pd.DataFrame(BASE))
        assert isinstance(wdf, M.WDF) and not wdf.is_local and wdf.is_bounded
        assert wdf.peek_array() == [1, 1.0, "a"]
        return _desc(wdf), wdf.count()

    got = _both(case)
    assert got[0][1] == "k:long,v:double,s:str" and got[1] == 5


def test_nulls_and_types_roundtrip():
    def case(M, eng):
        pdf = pd.DataFrame({
            "b": pd.array([True, False, None], dtype="boolean"),
            "i": pd.array([1, None, 3], dtype="Int64"),
            "f": [1.5, None, 2.5],
            "f32": pd.array([0.25, None, -1.5], dtype="Float32"),
            "s": ["x", None, "z"],
            "bin": [b"ab", None, b"cd"],
            "ts": pd.to_datetime(["2024-01-01 10:00:00", None, "2025-02-03 04:05:06.123456"], format="mixed"),
        })
        back = eng.to_df(pdf).as_arrow()
        assert back.schema.field("f32").type == pa.float32()  # REAL in sqlite, float32 again
        return str(back.schema), back.to_pylist()

    _both(case)


def test_nested_types_rejected():
    def case(M, eng):
        with pytest.raises(M.Invalid):
            eng.to_df(M.as_fugue_df(pd.DataFrame({"a": [[1, 2], [3]]}), schema="a:[long]"))
        return True

    _both(case)


def test_select_filter_assign_aggregate_pushdown():
    def case(M, eng):
        wdf = eng.to_df(pd.DataFrame(BASE))
        agg = eng.aggregate(wdf, M.PS(by=["k"]), [M.ff.sum(M.col("v")).alias("sv"),
                                                  M.ff.count(M.col("v")).alias("n")])
        f = eng.filter(wdf, M.col("v") > 2.0)
        a = eng.assign(f, [(M.col("v") * 2).alias("v")])
        sel = eng.select(wdf, M.colsql.SelectColumns(M.col("k"), (M.col("v") + M.lit(1)).cast("float").alias("w")),
                         where=M.col("s") != "b")
        for r in (agg, f, a, sel):
            assert isinstance(r, M.WDF)  # generated SQL in the warehouse
        return [(str(r.schema), _rows(r)) for r in (agg, f, a, sel)]

    got = _both(case)
    assert got[0][1] == [[1, 4.0, 2], [2, 7.0, 2], [3, 4.0, 1]]
    assert sorted(r[1] for r in got[2][1]) == [6.0, 8.0, 10.0]


@pytest.mark.parametrize("how", ["inner", "left_outer", "right_outer", "full_outer", "semi", "anti", "cross"])
def test_joins(how):
    def case(M, eng):
        wdf = eng.to_df(pd.DataFrame(BASE))
        if how == "cross":
            c1 = eng.to_df(pd.DataFrame({"a": [1, 2]}))
            r = eng.join(c1, eng.to_df(pd.DataFrame({"b": [3, 4]})), "cross")
        else:
            r = eng.join(wdf, eng.to_df(pd.DataFrame({"k": [1, 2, 9], "w": ["x", "y", "z"]})), how, on=["k"])
        return str(r.schema), _rows(r)

    got = _both(case)
    keys = {"inner": [1, 1, 2, 2], "right_outer": [1, 1, 2, 2, 9], "full_outer": [1, 1, 2, 2, 3, 9],
            "semi": [1, 1, 2, 2], "anti": [3]}
    if how in keys:
        assert sorted(r[0] for r in got[1]) == keys[how]
    if how == "cross":
        assert len(got[1]) == 4


def test_set_ops_and_distinct():
    def case(M, eng):
        d1 = eng.to_df(pd.DataFrame({"x": [1, 1, 1, 2]}))
        d2 = eng.to_df(pd.DataFrame({"x": [1, 3]}))
        return [_rows(r) for r in (
            eng.union(d1, d2, distinct=True), eng.union(d1, d2, distinct=False),
            eng.subtract(d1, d2), eng.subtract(d1, d2, distinct=False),
            eng.intersect(d1, d2), eng.intersect(d1, d2, distinct=False), eng.distinct(d1))]

    got = _both(case)
    assert got == [[[1], [2], [3]], [[1], [1], [1], [1], [2], [3]], [[2]], [[1], [1], [2]], [[1]], [[1]],
                   [[1], [2]]]


def test_dropna_fillna():
    def case(M, eng):
        d = eng.to_df(pd.DataFrame({"a": [1.0, None, 3.0], "b": [None, None, "x"]}))
        counts = [eng.dropna(d, how="any").count(), eng.dropna(d, how="all").count(),
                  eng.dropna(d, how="any", thresh=1).count(), eng.dropna(d, how="any", subset=["a"]).count()]
        filled = eng.fillna(d, {"a": 0.0, "b": "?"}).as_array()
        with pytest.raises(ValueError):
            eng.fillna(d, None)
        return counts, filled

    assert _both(case) == ([1, 2, 2, 2], [[1.0, "?"], [0.0, "?"], [3.0, "x"]])


def test_take_and_sample():
    def case(M, eng):
        wdf = eng.to_df(pd.DataFrame(BASE))
        t = eng.take(wdf, 1, presort="v desc", partition_spec=M.PS(by=["k"]))
        t2 = eng.take(wdf, 2, presort="v")
        s = eng.sample(wdf, frac=0.5)
        assert 0 <= s.count() <= 5
        with pytest.raises(NotImplementedError):
            eng.sample(wdf, n=2, replace=True)
        return _rows(t), t2.as_array(), eng.sample(wdf, n=3).count()

    got = _both(case)
    assert got[0] == [[1, 3.0, "c"], [2, 5.0, "e"], [3, 4.0, "d"]] and [r[1] for r in got[1]] == [1.0, 2.0]


def test_frame_ops():
    def case(M, eng):
        wdf = eng.to_df(pd.DataFrame(BASE))
        r = wdf.rename({"v": "value"})
        d = r.drop(["s"])
        h = wdf.head(2)
        alt = wdf.alter_columns("k:int")
        sub = wdf[["s", "k"]]
        assert h.is_local and isinstance(d, M.WDF) and isinstance(alt, M.WDF)
        return [_desc(x) for x in (r, d, h, alt, sub)]

    got = _both(case)
    assert got[0][1] == "k:long,value:double,s:str" and got[3][2][0] == "int32"


def test_save_load_table_schema_fidelity(tmp_path):
    def case(M, eng):
        path = str(tmp_path / f"wh_{M.name}.db")
        e1 = M.Engine({"fugue.sqlite.path": path})
        e2 = M.Engine({"fugue.sqlite.path": path})
        try:
            w = e1.to_df(pd.DataFrame({
                "b": pd.array([True, None], dtype="boolean"),
                "i": pd.array([5, None], dtype="Int32"),
                "ts": pd.to_datetime(["2024-06-01 01:02:03", None]),
            }))
            e1.sql_engine.save_table(w, "t1")
            assert e1.sql_engine.table_exists("t1")
            # a new engine over the same file recovers the exact schema
            back = e2.sql_engine.load_table("t1")
            return str(w.schema), _desc(back)
        finally:
            e1.stop_engine()
            e2.stop_engine()

    got = _both(case)
    assert got[1][1] == got[0]


def test_raw_sql_select():
    def case(M, eng):
        wdf = eng.to_df(pd.DataFrame(BASE))
        stmt = M.SQL([(False, "SELECT k, SUM(v) AS s FROM"), (True, "t"), (False, "GROUP BY k")])
        res = eng.sql_engine.select(M.DataFrames(t=wdf), stmt)
        return type(res).__name__, str(res.schema), _rows(res)

    assert _both(case)[2] == [[1, 4.0], [2, 7.0], [3, 4.0]]


def test_transform_api_roundtrip():
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"k": rng.integers(0, 4, 40), "v": rng.random(40)})

    def demean(d: pd.DataFrame) -> pd.DataFrame:
        d["v"] = d["v"] - d["v"].mean()
        return d

    got = {}
    for M in (J, T):
        out = M.transform(df, demean, schema="*", partition=M.PS(by=["k"]), engine="sqlite")
        got[M.name] = out.sort_values(["k", "v"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(got["port"], got["ref"], check_exact=True)
    exp = df.copy()
    exp["v"] = exp["v"] - exp.groupby("k")["v"].transform("mean")
    exp = exp.sort_values(["k", "v"]).reset_index(drop=True)
    assert np.allclose(got["port"]["v"], exp["v"]) and (got["port"]["k"] == exp["k"]).all()


def test_fugue_sql_on_sqlite():
    df = pd.DataFrame({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]})
    got = {M.name: M.fugue_sql("SELECT k, SUM(v) AS s FROM df GROUP BY k", df=df, engine="sqlite")
           for M in (J, T)}
    assert type(got["port"]) is type(got["ref"])
    assert sorted(got["port"].to_pylist(), key=repr) == sorted(got["ref"].to_pylist(), key=repr)
    assert sorted(pd.DataFrame(got["port"].to_pylist()).values.tolist()) == [[1, 4.0], [2, 2.0]]


def test_engine_inference_from_warehouse_frame():
    for M, infer in ((J, lambda objs: jinfer_execution_engine(objs)),
                     (T, lambda objs: make_execution_engine(None, infer_by=objs))):
        eng = M.Engine()
        wdf = eng.to_df(pd.DataFrame(BASE))
        assert infer([wdf]) is eng
        eng.stop_engine()


def test_sqlite_connection_as_engine_spec():
    df = pd.DataFrame({"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]})
    got = {}
    for M in (J, T):
        con = sqlite3.connect(":memory:", check_same_thread=False)
        res = M.fugue_sql("SELECT k, COUNT(*) AS n FROM df GROUP BY k", df=df, engine=con)
        # not its connection: the result stays a warehouse frame
        got[M.name] = type(res).__name__, _rows(res)
        con.close()
    assert got["port"] == got["ref"] == ("WarehouseDataFrame", [[1, 2], [2, 1]])
    con = sqlite3.connect(":memory:", check_same_thread=False)
    e = make_execution_engine(con)
    assert isinstance(e, SQLiteExecutionEngine) and e.connection is con
    e.stop()  # not its connection: left open
    assert con.execute("SELECT 1").fetchone() == (1,)
    inferred = make_execution_engine(None, infer_by=[con])
    assert isinstance(inferred, SQLiteExecutionEngine) and inferred.connection is con
    with pytest.raises(ValueError, match="no device"):
        make_execution_engine(con, device="cpu")
    con.close()


@pytest.mark.parametrize("running", ["native", "torch"])
def test_fsql_connect_sqlite_engine_switch(running):
    """CONNECT sqlite runs the statement in a private sqlite session while
    the workflow stays on its engine, the reference's from its host
    engine."""
    df = pd.DataFrame({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]})
    q = "CONNECT sqlite SELECT k, SUM(v) AS s FROM df GROUP BY k"
    ref = fa.fugue_sql(q, df=df, engine="native", as_fugue=True)
    engine = NativeExecutionEngine() if running == "native" else TorchExecutionEngine(device="cpu")
    got = api.fugue_sql(q, df=df, engine=engine, as_fugue=True)
    assert type(got).__name__ == type(ref).__name__ == "WarehouseDataFrame"
    assert str(got.schema) == str(ref.schema) and _rows(got) == _rows(ref) == [[1, 4.0], [2, 2.0]]
    q2 = """
    a = CONNECT sqlite SELECT k, SUM(v) AS s FROM df GROUP BY k
    SELECT k, s + 1 AS s1 FROM a ORDER BY k
    """
    got2 = api.fugue_sql(q2, df=df, engine=engine, as_fugue=True)
    ref2 = fa.fugue_sql(q2, df=df, engine="native", as_fugue=True)
    assert got2.as_array() == ref2.as_array() == [[1, 5.0], [2, 3.0]]
    if running == "torch":
        assert isinstance(got2, TorchDataFrame) and got2.device == torch.device("cpu")


def test_warehouse_to_device_interop():
    """A warehouse frame into the torch engine: one fetch, then the device
    aggregate, as the reference's into its JAX engine."""
    eng = SQLiteExecutionEngine()
    wdf = eng.to_df(pd.DataFrame(BASE))
    te = TorchExecutionEngine(device="cpu")
    tdf = te.to_df(wdf)
    assert isinstance(tdf, TorchDataFrame) and str(tdf.schema) == str(wdf.schema)
    r = te.aggregate(tdf, PartitionSpec(by=["k"]), [ff.sum(col("v")).alias("sv")])
    assert sorted(r.as_pandas()[["k", "sv"]].values.tolist()) == [[1, 4.0], [2, 7.0], [3, 4.0]]
    eng.stop_engine()


def test_load_save_df_files(tmp_path):
    def case(M, eng):
        wdf = eng.to_df(pd.DataFrame(BASE))
        p = str(tmp_path / f"out_{M.name}.parquet")
        eng.save_df(wdf, p)
        back = eng.load_df(p)
        assert isinstance(back, M.WDF)
        return str(back.schema), _rows(back) == _rows(wdf)

    assert _both(case)[1]


def test_seeded_sample_is_deterministic():
    """The seeded sample is a hash in SQL: the same rows in both packages."""
    pdf = pd.DataFrame({"a": np.arange(200), "b": np.arange(200) * 0.5})

    def case(M, eng):
        d = eng.to_df(pdf)
        s1 = eng.sample(d, frac=0.3, seed=42).as_pandas().sort_values("a")
        s2 = eng.sample(d, frac=0.3, seed=42).as_pandas().sort_values("a")
        pd.testing.assert_frame_equal(s1.reset_index(drop=True), s2.reset_index(drop=True))
        assert 20 < len(s1) < 100
        s3 = eng.sample(d, frac=0.3, seed=7).as_pandas()
        assert set(s3["a"]) != set(s1["a"])
        n1 = eng.sample(d, n=17, seed=5).as_pandas().sort_values("a")
        return s1["a"].tolist(), sorted(s3["a"]), n1["a"].tolist()

    assert len(_both(case)[2]) == 17


def test_count_memoized_single_query():
    def case(M, eng):
        wdf = eng.to_df(pd.DataFrame(BASE))
        calls = []
        eng.connection.set_trace_callback(calls.append)
        try:
            assert wdf.count() == 5 and wdf.count() == 5 and not wdf.empty
        finally:
            eng.connection.set_trace_callback(None)
        return len([s for s in calls if "COUNT(*)" in s])

    assert _both(case) <= 1


def test_seeded_sample_with_rowid_column_and_load_table_count():
    def case(M, eng):
        d = eng.to_df(pd.DataFrame({"rowid": [f"r{i}" for i in range(100)], "v": range(100)}))
        s = eng.sample(d, frac=0.3, seed=42).as_pandas()
        assert 10 < len(s) < 60 and set(s.columns) == {"rowid", "v"}
        n = eng.sample(d, n=10, seed=1).as_pandas()
        assert len(n) == 10 and sorted(n["v"]) != list(range(10))
        sql_eng = eng.sql_engine
        sql_eng.save_table(eng.to_df(pd.DataFrame({"a": [1, 2, 3]})), "t_mut")
        f = sql_eng.load_table("t_mut")
        c1 = f.count()
        sql_eng.save_table(eng.to_df(pd.DataFrame({"a": [1, 2, 3, 4, 5]})), "t_mut")
        return sorted(s["v"]), sorted(n["v"]), c1, f.count()

    got = _both(case)
    assert got[2:] == (3, 5)


def test_temp_tables_dropped_with_their_frames():
    """A released frame's temp table is dropped (``track_temp_table``), and
    ``stop()`` closes an owned connection."""
    import gc

    def case(M, eng):
        con = eng.connection
        tables = lambda: sorted(r[0] for r in con.execute(  # noqa: E731
            "SELECT name FROM sqlite_temp_master WHERE type='table'").fetchall())
        wdf = eng.to_df(pd.DataFrame(BASE))
        f = eng.filter(wdf, M.col("v") > 2.0)
        n_live = len(tables())
        del wdf, f
        gc.collect()
        return n_live, tables()

    assert _both(case) == (2, [])
    eng = SQLiteExecutionEngine()
    con = eng.connection
    eng.stop()
    with pytest.raises(sqlite3.ProgrammingError):
        con.execute("SELECT 1")


# ---- tests/warehouse/test_profiles.py -------------------------------------------

SCHEMA_EXPR = "a:long,b:double,c:str,d:bool,e:datetime,f:bytes,g:int,h:float"
PROFILE_CALLS = {
    "create_temp_table_sql": lambda M, p: p.create_temp_table_sql("t1", M.Schema(SCHEMA_EXPR)),
    "insert_sql": lambda M, p: p.insert_sql("t1", 3),
    "create_temp_table_as_sql": lambda M, p: p.create_temp_table_as_sql("t2", "SELECT 1 AS x"),
    "drop_table_sql": lambda M, p: p.drop_table_sql('we"ird'),
    "table_exists_sql": lambda M, p: (p.table_exists_sql(views=True), p.table_exists_sql(views=False)),
    "meta": lambda M, p: (p.meta_create_sql(), p.meta_upsert_sql(), p.meta_select_sql()),
    "decl_to_arrow": lambda M, p: [str(p.decl_to_arrow(d)) for d in (
        "BIGINT", "INTEGER", "REAL", "DOUBLE PRECISION", "TEXT", "VARCHAR(3)", "BLOB", "BYTEA",
        "BOOLEAN", "TIMESTAMP WITHOUT TIME ZONE", "DATE", "")],
    "quote": lambda M, p: (p.quote('a"b'), p.placeholders(3), p.paramstyle, p.supports_full_outer_join),
    "unstorable": lambda M, p: p.storage_type(pa.list_(pa.int64())),
}


@pytest.mark.parametrize("profile", ["sqlite", "postgres"])
@pytest.mark.parametrize("call", sorted(PROFILE_CALLS))
def test_profile_sql_text(profile, call):
    got = {}
    for M in (J, T):
        try:
            got[M.name] = PROFILE_CALLS[call](M, M.profile.get_profile(profile))
        except Exception as e:
            got[M.name] = ("raised", type(e).__name__)
    assert got["port"] == got["ref"], got


def test_sqlite_and_postgres_golden_sql():
    schema = Schema("a:long,b:double,c:str,d:bool,e:datetime,f:bytes,g:int")
    assert tprofile.SQLiteProfile().create_temp_table_sql("t1", schema) == (
        'CREATE TEMP TABLE "t1" ("a" INTEGER, "b" REAL, "c" TEXT, '
        '"d" INTEGER, "e" TEXT, "f" BLOB, "g" INTEGER)')
    assert tprofile.PostgresProfile().create_temp_table_sql("t1", schema) == (
        'CREATE TEMPORARY TABLE "t1" ("a" BIGINT, "b" DOUBLE PRECISION, '
        '"c" TEXT, "d" BOOLEAN, "e" TIMESTAMP, "f" BYTEA, "g" INTEGER)')
    assert tprofile.PostgresProfile().meta_upsert_sql() == (
        "INSERT INTO __fugue_schemas__ VALUES (%s, %s) "
        "ON CONFLICT (tbl) DO UPDATE SET schema = EXCLUDED.schema")


def test_profile_lookup_and_errors():
    for M in (J, T):
        assert M.profile.get_profile(None).name == "sqlite"
        assert M.profile.get_profile("postgres").name == "postgres"
        p = M.profile.SQLiteProfile()
        assert M.profile.get_profile(p) is p
        with pytest.raises(M.Invalid):
            M.profile.get_profile("oracle9i")


class _FakeCursor:
    def __init__(self, rows):
        self._rows = rows

    def fetchone(self):
        return self._rows[0] if self._rows else None

    def fetchall(self):
        return list(self._rows)


class _FakePostgresConn:
    """Records every statement the engine sends (``test_profiles.py``)."""

    def __init__(self):
        self.statements = []

    def execute(self, sql, params=None):
        self.statements.append(sql)
        return _FakeCursor([])

    def executemany(self, sql, rows):
        self.statements.append(sql)

    def commit(self):
        pass

    def close(self):
        pass


def test_engine_ingest_speaks_postgres():
    got = {}
    for M in (J, T):
        conn = _FakePostgresConn()
        eng = M.wee.WarehouseExecutionEngine(connection=conn, profile="postgres")
        assert eng.encode_name("a b") == '"a b"'
        wdf = eng.ingest(eng._local_engine.to_df(pd.DataFrame({"a": [1], "b": [0.5]})))
        assert eng.infer_table_schema(wdf.table) == wdf.schema  # the recorded schema wins
        got[M.name] = ([s.replace(wdf.table, "T") for s in conn.statements], str(wdf.schema))
    assert got["port"] == got["ref"]
    assert 'CREATE TEMPORARY TABLE "T" ("a" BIGINT, "b" DOUBLE PRECISION)' in got["port"][0]


@pytest.mark.parametrize("where", ["v > 100.0", "k > 100"])
def test_empty_raw_sql_result_schema(where):
    """An empty result's schema: inferred from the expression IR, or, for
    text the parser cannot read, sampled from the table."""

    def case(M, eng):
        src = eng.to_df(pd.DataFrame({"k": [1, 2], "v": [0.5, 1.5], "s": ["a", "b"]}))
        text = ("SELECT k, SUM(v) AS total, COUNT(*) AS n, s FROM <tmpdf:src> "
                f"WHERE {where} GROUP BY k, s") if where.startswith("v") else f"SELECT k FROM <tmpdf:src> WHERE {where}"
        res = eng.sql_engine.select(M.DataFrames(src=src), M.SQL.from_expr(text, dialect="fugue"))
        return res.count(), str(res.schema)

    assert _both(case) in [(0, "k:long,total:double,n:long,s:str"), (0, "k:long")]


# ---- column/sql.py SQLExpressionGenerator --------------------------------------

GEN_CASES = {
    "named": lambda M: M.col("a"),
    "alias_cast": lambda M: (M.col("a") + 1).cast("double").alias("x"),
    "literals": lambda M: M.colsql.SelectColumns(M.lit(None).alias("n"), M.lit(True).alias("t"),
                                                 M.lit("it's").alias("s"), M.lit(1.5).alias("f")),
    "unary": lambda M: (~(M.col("a") > 1)) | M.col("b").is_null() | M.col("c").not_null(),
    "neg": lambda M: -M.col("a"),
    "binary": lambda M: ((M.col("a") == 1) & (M.col("b") != 2)) | (M.col("c") >= M.col("d") * 3),
    "agg": lambda M: M.colsql.SelectColumns(M.col("k"), M.ff.sum(M.col("v")).alias("s"),
                                            M.ff.count_distinct(M.col("w")).alias("d")),
    "cast_types": lambda M: M.colsql.SelectColumns(*[M.col("a").cast(t).alias(f"c{i}") for i, t in enumerate(
        ["int8", "short", "int", "long", "float", "double", "bool", "str", "bytes", "date", "datetime"])]),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
@pytest.mark.parametrize("storage", [False, True], ids=["generic", "sqlite_storage"])
def test_sql_expression_generator_text(case, storage):
    got = {}
    for M in (J, T):
        gen = M.wee._StorageCastGenerator("sqlite") if storage else M.colsql.SQLExpressionGenerator()
        e = GEN_CASES[case](M)
        try:
            if isinstance(e, M.colsql.SelectColumns):
                got[M.name] = gen.select(e, "tbl", where=M.col("a") > 0,
                                         having=M.ff.sum(M.col("v")) > 1 if e.has_agg else None)
            else:
                got[M.name] = (gen.generate(e), gen.where(e, "tbl") if e.as_name == "" else None)
        except Exception as ex:
            got[M.name] = ("raised", type(ex).__name__)
    assert got["port"] == got["ref"], got


# ---- C26: CONNECT <engine> stops its temporary engine ----------------------------


def _stop_spy(cls):
    stopped = []
    orig = cls.stop

    def stop(self):
        stopped.append(self)
        return orig(self)

    return mock.patch.object(cls, "stop", stop), stopped


def test_connect_stops_its_temporary_engine():
    """C26: the port's ``CONNECT torch`` from ``TorchExecutionEngine(device=
    "cpu")`` makes one engine and stops it once after its select; the
    reference's ``CONNECT jax`` from its host engine does the same. The
    running engine is stopped by neither."""
    from fugue_tpu.execution.execution_engine import ExecutionEngine as JExecutionEngine

    pdf = pd.DataFrame({"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]})
    seen = {}
    for name, base, run in (
        ("ref", JExecutionEngine, lambda e: fa.fugue_sql(
            "CONNECT jax SELECT k, SUM(v) AS s FROM pdf GROUP BY k", pdf=pdf, engine=e, as_fugue=True)),
        ("port", ExecutionEngine, lambda e: api.fugue_sql(
            "CONNECT torch SELECT k, SUM(v) AS s FROM pdf GROUP BY k", pdf=pdf, engine=e, as_fugue=True)),
    ):
        running = JNativeExecutionEngine() if name == "ref" else TorchExecutionEngine(device="cpu")
        patch, stopped = _stop_spy(base)
        with patch:
            res = run(running)
        assert sorted(res.as_array()) == [[1, 3.0], [2, 3.0]]
        assert running not in stopped
        assert len(stopped) == 1 and len(set(map(id, stopped))) == 1
        seen[name] = type(stopped[0]).__name__
    assert seen == {"ref": "JaxExecutionEngine", "port": "TorchExecutionEngine"}


def test_connect_stops_the_hybrid_and_its_device_engine():
    """``CONNECT sqlite_torch`` takes the engine-name route: the hybrid it
    makes is stopped after its select, which closes its connection and
    stops its torch engine; it lands on the running engine's device."""
    pdf = pd.DataFrame({"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]})
    made = []
    orig = WarehouseTorchExecutionEngine.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        made.append(self)

    running = TorchExecutionEngine(device="cpu")
    with mock.patch.object(WarehouseTorchExecutionEngine, "__init__", init):
        res = api.fugue_sql("CONNECT sqlite_torch SELECT k, SUM(v) AS s FROM pdf GROUP BY k",
                            pdf=pdf, engine=running, as_fugue=True)
    assert sorted(res.as_array()) == [[1, 3.0], [2, 3.0]] and isinstance(res, TorchDataFrame)
    assert len(made) == 1 and made[0]._stopped and made[0].torch_engine._stopped
    assert made[0].device == torch.device("cpu") and not running._stopped
    with pytest.raises(sqlite3.ProgrammingError):
        made[0].connection.execute("SELECT 1")


def test_connect_refusals_name_the_roadmap():
    pdf = pd.DataFrame({"k": [1]})
    for spec in ("jax", "duckdb"):
        with pytest.raises(NotImplementedError, match="A.10"):
            api.fugue_sql(f"CONNECT {spec} SELECT k FROM pdf", pdf=pdf, engine="native")


# ---- engine names -----------------------------------------------------------------


def test_engine_names():
    e = make_execution_engine("sqlite")
    assert type(e) is SQLiteExecutionEngine
    e.stop()
    h = make_execution_engine("sqlite_torch", device="cpu")
    assert type(h) is WarehouseTorchExecutionEngine and h.device == torch.device("cpu")
    h.stop()
    assert h.torch_engine._stopped
    with pytest.raises(ValueError, match="takes no device"):
        make_execution_engine("sqlite", device="cpu")
    conf_path = {"fugue.sqlite.path": ":memory:"}
    assert make_execution_engine("SQLite", conf=conf_path).conf["fugue.sqlite.path"] == ":memory:"


def test_sqlite_torch_without_a_card_raises(monkeypatch):
    """With no card and no device, ``sqlite_torch`` raises as ``torch``
    does, before it opens a connection."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opened = []
    real = sqlite3.connect
    monkeypatch.setattr(sqlite3, "connect", lambda *a, **k: opened.append(1) or real(*a, **k))
    for name in ("sqlite_torch", "torch"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_execution_engine(name)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WarehouseTorchExecutionEngine()
    assert opened == []
