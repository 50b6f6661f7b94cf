"""The port's ``WarehouseTorchExecutionEngine`` (``sqlite_torch``: SQL in
sqlite, maps on the torch engine) on the CPU, against the JAX package's
``WarehouseJaxExecutionEngine`` (``sqlite_jax``, its maps on the 8-device
CPU mesh).

- the cases of ``tests/warehouse/test_hybrid_engine.py``: the facets (SQL
  verbs give warehouse frames, a ``Dict[str, torch.Tensor]`` UDF's map
  gives a ``TorchDataFrame`` where the reference's gives a
  ``JaxDataFrame``), the mixed pipeline, the engine name;
- the mixed pipeline of ``chip_smoke.py``'s ``warehouse_path`` at 2,000
  rows over 10 keys: LOAD → SELECT WHERE in sqlite → TRANSFORM with a
  keyed torch UDF → ``CONNECT torch`` SUM/COUNT → SELECT ORDER BY, held
  against ``sqlite_jax`` running the same text with the JAX UDF and
  against a float64 pandas oracle (keys and counts exact, sums
  ``rtol=1e-4, atol=1e-3``, the float32 binned-sum tolerance of
  ``tests/jax_engine/test_pallas_groupby.py``); ``z`` stays float32
  through sqlite;
- the cases of ``fugue_tpu_test/execution_suite.py`` that
  ``WarehouseSuiteOverrides`` keeps, written once over either package and
  run on both port engines (``sqlite`` and ``sqlite_torch``) against the
  reference's two: frame types, schemas and rows equal;
- ``CONNECT sqlite`` and ``CONNECT torch`` from the hybrid, and engine
  inference from a hybrid's frame.

One layout difference is recorded, not repaired: the reference asserts a
parallelism above 1 on its 8-device mesh; the port's is its torch
engine's (1 on one device), and the test holds that equality.
"""

import os
from datetime import datetime
from types import SimpleNamespace
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import fugue_tpu.api as fa
from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.column import SelectColumns as JSelectColumns
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.column import lit as jlit
from fugue_tpu.dataframe import ArrayDataFrame as JArrayDataFrame
from fugue_tpu.dataframe import DataFrames as JDataFrames
from fugue_tpu.execution.api import engine_context as jengine_context
from fugue_tpu.jax import group_ops as jgo
from fugue_tpu.warehouse import SQLiteExecutionEngine as JSQLiteExecutionEngine
from fugue_tpu.warehouse import WarehouseDataFrame as JWarehouseDataFrame
from fugue_tpu.warehouse import WarehouseJaxExecutionEngine

from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import SelectColumns, col, lit
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.dataframe import ArrayDataFrame, DataFrames
from fugue_tpu_torch.execution.api import engine_context
from fugue_tpu_torch.execution.factory import make_execution_engine
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from fugue_tpu_torch.torch import group_ops as tgo
from fugue_tpu_torch.warehouse import (
    SQLiteExecutionEngine,
    WarehouseDataFrame,
    WarehouseTorchExecutionEngine,
    WarehouseTorchMapEngine,
)

J = SimpleNamespace(name="ref", PS=JPartitionSpec, col=jcol, lit=jlit, ff=jff, SC=JSelectColumns,
                    ADF=JArrayDataFrame, DataFrames=JDataFrames, WDF=JWarehouseDataFrame)
T = SimpleNamespace(name="port", PS=PartitionSpec, col=col, lit=lit, ff=ff, SC=SelectColumns,
                    ADF=ArrayDataFrame, DataFrames=DataFrames, WDF=WarehouseDataFrame)
ENGINES = {
    "sqlite": (lambda: JSQLiteExecutionEngine(dict(test=True)), lambda: SQLiteExecutionEngine(dict(test=True))),
    "sqlite_torch": (lambda: WarehouseJaxExecutionEngine(dict(test=True)),
                     lambda: WarehouseTorchExecutionEngine(dict(test=True), device="cpu")),
}
RTOL, ATOL = 1e-4, 1e-3  # float32 binned sums vs a float64 oracle
MIXED_ROWS, MIXED_KEYS = 2_000, 10


@pytest.fixture()
def eng():
    e = WarehouseTorchExecutionEngine(device="cpu")
    yield e
    e.stop()


def _rows(df):
    return sorted(df.as_array(type_safe=True), key=repr)


# ---- tests/warehouse/test_hybrid_engine.py ----------------------------------------


def test_engine_composition(eng):
    assert isinstance(eng.map_engine, WarehouseTorchMapEngine)
    assert eng.is_distributed and eng.map_engine.is_distributed
    assert isinstance(eng.torch_engine, TorchExecutionEngine) and eng.device == torch.device("cpu")
    # the reference asserts > 1 on its 8-device mesh; one device here
    assert eng.get_current_parallelism() == eng.torch_engine.get_current_parallelism()


def _facets(M, e, plus, frame_of):
    """The facets of one hybrid engine: each verb's frame type, the torch
    (or JAX) map engine's result type, the rows."""
    pdf = pd.DataFrame({"k": [1, 2, 1, 3], "v": [1.0, 2.0, 3.0, 4.0]})
    wdf = e.to_df(pdf)
    filtered = e.filter(wdf, M.col("v") > 1.0)
    agg = e.aggregate(filtered, M.PS(by=["k"]), [M.ff.sum(M.col("v")).alias("s")])
    calls = []
    inner = frame_of(e).map_engine
    orig = inner.map_dataframe

    def spy(*a, **k):
        res = orig(*a, **k)
        calls.append(type(res).__name__)
        return res

    inner.map_dataframe = spy
    try:
        transform = fa.transform if M is J else api.transform
        out = transform(wdf, plus, schema="k:long,v:double", engine=e, as_fugue=True)
    finally:
        inner.map_dataframe = orig
    direct = e.map_engine.map_dataframe(wdf, lambda cursor, local: local, wdf.schema, M.PS(by=["k"]))
    return {"types": [type(x).__name__ for x in (wdf, filtered, agg, out, direct)], "calls": calls,
            "agg": _rows(agg), "out": sorted(r[1] for r in out.as_array()), "direct": direct.count()}


def test_sql_stays_in_warehouse_map_runs_on_device(eng):
    def plus_j(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        return {"k": cols["k"], "v": cols["v"] + 10.0}

    def plus_t(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": cols["k"], "v": cols["v"] + 10.0}

    ref = WarehouseJaxExecutionEngine()
    with jengine_context(ref):
        exp = _facets(J, ref, plus_j, lambda e: e.jax_engine)
    with engine_context(eng):
        got = _facets(T, eng, plus_t, lambda e: e.torch_engine)
    assert exp["calls"] == ["JaxDataFrame"] and got["calls"] == ["TorchDataFrame"]
    assert got["types"] == exp["types"] == ["WarehouseDataFrame"] * 5
    assert {k: v for k, v in got.items() if k != "calls"} == {k: v for k, v in exp.items() if k != "calls"}
    assert got["out"] == [11.0, 12.0, 13.0, 14.0] and got["direct"] == 4


def test_mixed_sql_transform_pipeline_one_engine(eng):
    def demean(pdf: pd.DataFrame) -> pd.DataFrame:
        pdf["v"] = pdf["v"] - pdf["v"].mean()
        return pdf

    q = """
    src = CREATE [[1,1.0],[1,2.0],[2,3.0],[2,4.0],[3,5.0]] SCHEMA k:long,v:double
    big = SELECT * FROM src WHERE v > 1.5
    centered = TRANSFORM big PREPARTITION BY k USING demean SCHEMA k:long,v:double
    SELECT k, COUNT(*) AS n FROM centered GROUP BY k
    """
    got = api.fugue_sql(q, demean=demean, engine=eng, as_fugue=True)
    exp = fa.fugue_sql(q, demean=demean, engine=WarehouseJaxExecutionEngine(), as_fugue=True)
    assert type(got).__name__ == type(exp).__name__
    assert str(got.schema) == str(exp.schema) and _rows(got) == _rows(exp) == [[1, 1], [2, 2], [3, 1]]


def test_engine_name_registration():
    e = make_execution_engine("sqlite_torch", device="cpu")
    try:
        assert isinstance(e, WarehouseTorchExecutionEngine)
    finally:
        e.stop()
    with engine_context("sqlite_torch", device="cpu") as ctx:
        assert isinstance(ctx, WarehouseTorchExecutionEngine)
        r = api.fugue_sql("SELECT k, SUM(v) AS s FROM df GROUP BY k",
                          df=pd.DataFrame({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]}), as_fugue=True)
        assert sorted(r.as_array()) == [[1, 4.0], [2, 2.0]]
    assert ctx._stopped and ctx.torch_engine._stopped


# ---- the mixed pipeline of chip_smoke.py's warehouse_path ---------------------------

MIXED_TEXT = """
src = LOAD "{path}"
big = SELECT k, v, w FROM src WHERE w > 0.1
centered = TRANSFORM big PREPARTITION BY k USING {udf} SCHEMA k:long,z:float,w:double
"""
MIXED_TAIL = """
sums = CONNECT {dev} SELECT k, SUM(z) AS s, COUNT(*) AS n FROM centered GROUP BY k
SELECT k, s, n FROM sums ORDER BY k
"""


def _mixed_frame():
    rng = np.random.default_rng(11)
    return pd.DataFrame({"k": rng.integers(0, MIXED_KEYS, MIXED_ROWS), "v": rng.random(MIXED_ROWS),
                         "w": rng.random(MIXED_ROWS)})


def _mixed_oracle(pdf):
    f = pdf[pdf["w"] > 0.1]
    z = ((f["v"] - f.groupby("k")["v"].transform("mean")) * f["w"]).astype(np.float32).astype(np.float64)
    return f.assign(z=z).groupby("k").agg(s=("z", "sum"), n=("z", "size")).reset_index()


def demean_j(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    z = ((cols["v"] - jgo.per_row(cols, jgo.mean(cols, cols["v"]))) * cols["w"]).astype(jnp.float32)
    return {"k": cols["k"], "z": z, "w": cols["w"]}


def demean_t(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    z = ((cols["v"] - tgo.per_row(cols, tgo.mean(cols, cols["v"]))) * cols["w"]).float()
    return {"k": cols["k"], "z": z, "w": cols["w"]}


def test_mixed_pipeline_against_sqlite_jax_and_pandas(tmp_path, eng):
    pdf = _mixed_frame()
    path = str(tmp_path / "mixed.parquet")
    pdf.to_parquet(path)
    exp = _mixed_oracle(pdf)
    head, jhead = MIXED_TEXT.format(path=path, udf="demean_t"), MIXED_TEXT.format(path=path, udf="demean_j")
    ref = WarehouseJaxExecutionEngine()

    # the TRANSFORM's result: z float32 after the sqlite round trip, and
    # the torch map engine's own result a TorchDataFrame on the engine's device
    calls = []
    orig = eng.torch_engine.map_engine.map_dataframe

    def spy(*a, **k):
        res = orig(*a, **k)
        calls.append(res)
        return res

    eng.torch_engine.map_engine.map_dataframe = spy
    try:
        centered = api.fugue_sql(head, engine=eng, as_fugue=True)
    finally:
        eng.torch_engine.map_engine.map_dataframe = orig
    assert len(calls) == 1 and isinstance(calls[0], TorchDataFrame) and calls[0].device == eng.device
    centered_ref = fa.fugue_sql(jhead, engine=ref, as_fugue=True)
    assert str(centered.schema) == str(centered_ref.schema) == "k:long,z:float,w:double"
    assert centered.as_arrow().schema.types == centered_ref.as_arrow().schema.types
    assert str(centered.as_arrow().schema.field("z").type) == "float"

    got = api.fugue_sql(head + MIXED_TAIL.format(dev="torch"), engine=eng, as_fugue=True)
    want = fa.fugue_sql(jhead + MIXED_TAIL.format(dev="jax"), engine=ref, as_fugue=True)
    ref.stop()
    assert str(got.schema) == str(want.schema)
    g, w = got.as_pandas(), want.as_pandas()
    assert g["k"].tolist() == sorted(g["k"].tolist())  # ORDER BY
    assert g["k"].tolist() == w["k"].tolist() == exp["k"].tolist()
    assert g["n"].tolist() == w["n"].tolist() == exp["n"].tolist()
    np.testing.assert_allclose(g["s"], exp["s"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w["s"], exp["s"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g["s"], w["s"], rtol=RTOL, atol=ATOL)


def test_traced_mixed_pipeline_records_the_warehouse_spans(tmp_path):
    """With tracing on, the mixed pipeline's steps are spans: the LOAD (its
    ingest inside), each statement with its table, the map bridge with
    the rows it fetched and its result's type and device around the
    fetch, the torch map and the ingest back, the CONNECT with its engine
    and rows, and the drop of the LOAD's released table; the span
    metrics count them. Off, nothing is
    recorded. The result equals the untraced run's (the result cache is
    off, so both runs compute)."""
    from fugue_tpu_torch.obs import get_span_metrics, get_tracer

    pdf = _mixed_frame()
    path = str(tmp_path / "mixed.parquet")
    pdf.to_parquet(path)
    text = MIXED_TEXT.format(path=path, udf="demean_t") + MIXED_TAIL.format(dev="torch")
    tracer = get_tracer()
    tracer.clear()
    eng = WarehouseTorchExecutionEngine({"fugue.tpu.cache.enabled": False}, device="cpu")
    try:
        plain = api.fugue_sql(text, engine=eng, as_fugue=True).as_pandas()
        assert tracer.records() == []
        tracer.enable()
        try:
            traced = api.fugue_sql(text, engine=eng, as_fugue=True).as_pandas()
        finally:
            tracer.disable()
    finally:
        eng.stop()
    recs = tracer.records()
    tracer.clear()
    pd.testing.assert_frame_equal(traced, plain)
    by_id = {r["id"]: r for r in recs}
    named = {}
    for r in recs:
        named.setdefault(r["name"], []).append(r)
    kept = int((pdf["w"] > 0.1).sum())
    (load,) = named["warehouse.load"]
    assert load["cat"] == "warehouse" and load["args"]["rows"] == MIXED_ROWS
    ingests = named["warehouse.ingest"]
    (loaded,) = [i for i in ingests if i["args"]["rows"] == MIXED_ROWS]
    assert by_id[loaded["parent"]]["name"] == "warehouse.load"
    # the LOAD's table is dropped inside the run, once its consumers are done
    assert loaded["args"]["table"] in {r["args"]["table"] for r in named["warehouse.drop"]}
    (bridge,) = named["warehouse.map"]
    assert bridge["args"] == {"rows": kept, "frame": "TorchDataFrame", "device": "cpu"}
    inside = sorted(r["name"] for r in recs if r["parent"] == bridge["id"])
    assert inside == ["engine.transform", "warehouse.fetch", "warehouse.ingest"]
    fetched = {r["args"]["table"]: r["args"]["rows"] for r in named["warehouse.fetch"]}
    tables = [r["args"]["table"] for r in named["warehouse.materialize"]]
    assert len(tables) == 2 and fetched[tables[0]] == kept and fetched[tables[1]] == MIXED_KEYS
    (connect,) = named["sql.connect"]
    assert connect["args"] == {"engine": "torch", "rows": MIXED_KEYS}
    summary = get_span_metrics().summary()
    assert all(summary[n]["count"] >= 1 for n in ("warehouse.load", "warehouse.map", "sql.connect"))


def test_hybrid_temp_tables_and_stop(tmp_path):
    """After the pipeline and its frames are gone, the connection holds no
    temp table; ``stop()`` closes it and stops the torch engine. The
    engine's result cache is off: a cached frame keeps its table, in
    either package."""
    import gc
    import sqlite3

    pdf = _mixed_frame()
    path = str(tmp_path / "mixed.parquet")
    pdf.to_parquet(path)
    e = WarehouseTorchExecutionEngine({"fugue.tpu.cache.enabled": False}, device="cpu")
    res = api.fugue_sql(MIXED_TEXT.format(path=path, udf="demean_t") + MIXED_TAIL.format(dev="torch"),
                        engine=e, as_fugue=True)
    assert res.count() == MIXED_KEYS
    del res
    gc.collect()
    con = e.connection
    left = con.execute("SELECT name FROM sqlite_temp_master WHERE type='table'").fetchall()
    assert left == []
    e.stop()
    assert e.torch_engine._stopped
    with pytest.raises(sqlite3.ProgrammingError):
        con.execute("SELECT 1")


# ---- CONNECT from the hybrid, inference -------------------------------------------


def test_connect_from_the_hybrid(eng):
    pdf = pd.DataFrame({"k": [1, 2, 1], "v": np.array([1.0, 2.0, 3.0], np.float32)})
    ref = WarehouseJaxExecutionEngine()
    for spec, jspec in (("torch", "jax"), ("sqlite", "sqlite"), ("native", "native")):
        q = f"""
        a = CONNECT {{}} SELECT k, SUM(v) AS s FROM pdf GROUP BY k
        SELECT k, s FROM a ORDER BY k
        """
        got = api.fugue_sql(q.format(spec), pdf=pdf, engine=eng, as_fugue=True)
        exp = fa.fugue_sql(q.format(jspec), pdf=pdf, engine=ref, as_fugue=True)
        assert type(got).__name__ == type(exp).__name__
        assert str(got.schema) == str(exp.schema) and got.as_array() == exp.as_array() == [[1, 4.0], [2, 2.0]]
    ref.stop()


def _plus_one(df: pd.DataFrame) -> pd.DataFrame:
    return df.assign(k=df["k"] + 1)


def test_inference_from_a_hybrid_frame(eng):
    wdf = eng.to_df(pd.DataFrame({"k": [1, 2]}))
    assert make_execution_engine(None, infer_by=[wdf]) is eng
    calls = []
    orig = eng.torch_engine.map_engine.map_dataframe

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    eng.torch_engine.map_engine.map_dataframe = spy
    out = api.transform(wdf, _plus_one, schema="*", as_fugue=True)  # on the frame's engine
    assert calls == [1] and isinstance(out, WarehouseDataFrame) and sorted(out.as_array()) == [[2], [3]]


# ---- fugue_tpu_test/execution_suite.py under WarehouseSuiteOverrides -----------------


def _rowset(df, type_safe=True):
    return str(df.schema), sorted(df.as_array(type_safe=type_safe), key=repr)


def _map(M, e, data, schema, fn, out_schema, spec):
    return e.map_engine.map_dataframe(e.to_df(data, schema), fn, out_schema, spec)


SUITE = {
    "to_df": lambda M, e, tmp: [_rowset(e.to_df([[1, "a"]], "a:long,b:str")),
                                _rowset(e.to_df(pd.DataFrame({"a": [1], "b": ["a"]}))),
                                _rowset(e.to_df(M.ADF([[1, "a"]], "a:long,b:str")))],
    "map_no_partition": lambda M, e, tmp: _rowset(_map(
        M, e, [[i] for i in range(7)], "a:long",
        lambda c, df: M.ADF([[len(df.as_array(type_safe=True))]], "ct:long"), "ct:long", M.PS())),
    "map_with_keys": lambda M, e, tmp: _rowset(_map(
        M, e, [[1, "x"], [2, "y"], [1, "z"], [None, "w"]], "a:double,b:str",
        lambda c, df: M.ADF([[c.key_value_dict["a"], len(df.as_array())]], "a:double,ct:long"),
        "a:double,ct:long", M.PS(by=["a"]))),
    "map_with_presort": lambda M, e, tmp: _rowset(_map(
        M, e, [[1, 3], [1, 1], [2, 5], [2, 9]], "a:long,b:long",
        lambda c, df: M.ADF([df.peek_array()], c.row_schema), "a:long,b:long", M.PS(by=["a"], presort="b desc"))),
    "map_empty_input": lambda M, e, tmp: _rowset(_map(M, e, [], "a:long", lambda c, df: df, "a:long",
                                                      M.PS(by=["a"]))),
    "map_with_special_values": lambda M, e, tmp: _rowset(_map(
        M, e, [[1, "a", datetime(2020, 1, 1), b"\x00"], [2, None, None, None]],
        "a:long,b:str,c:datetime,d:bytes", lambda c, df: df, "a:long,b:str,c:datetime,d:bytes", M.PS())),
    "map_per_row": lambda M, e, tmp: _rowset(_map(
        M, e, [[1], [2], [3]], "a:long", lambda c, df: M.ADF([[df.as_array()[0][0] * 10]], "a:long"), "a:long",
        M.PS("per_row"))),
    "joins": lambda M, e, tmp: [
        _rowset(e.join(e.to_df([[1, "a"], [2, "b"], [None, "c"]], "x:double,y:str"),
                       e.to_df([[1, 10.0], [3, 30.0], [None, 40.0]], "x:double,z:double"), how=how, on=["x"]))
        for how in ("inner", "left_outer", "right_outer", "full_outer", "semi", "anti")],
    "cross_and_multi_key_join": lambda M, e, tmp: [
        _rowset(e.join(e.to_df([[1], [2]], "x:long"), e.to_df([["p"], ["q"], ["r"]], "y:str"), how="cross")),
        _rowset(e.join(e.to_df([[1, 1, "a"], [1, 2, "b"]], "x:long,y:long,v:str"),
                       e.to_df([[1, 1, "c"]], "x:long,y:long,w:str"), how="inner", on=["x", "y"]))],
    "join_duplicate_keys": lambda M, e, tmp: [
        _rowset(e.join(e.to_df([[1, 10.0], [2, 20.0], [3, 30.0]], "x:long,a:double"),
                       e.to_df([[1, 1.0], [1, 2.0], [2, 3.0], [9, 9.0]], "x:long,b:double"), how=how, on=["x"]))
        for how in ("inner", "left_outer", "left_semi", "left_anti")],
    "set_ops": lambda M, e, tmp: [
        _rowset(op(e.to_df([[1, "x"], [None, "y"], [None, "y"], [2, None]], "a:double,b:str"),
                   e.to_df([[None, "y"], [2, None]], "a:double,b:str"), **kw))
        for op in (e.union, e.subtract, e.intersect) for kw in ({}, {"distinct": False})],
    "distinct": lambda M, e, tmp: _rowset(e.distinct(e.to_df([[1, None], [1, None], [2, "x"]], "a:long,b:str"))),
    "dropna": lambda M, e, tmp: [e.dropna(e.to_df([[1, "a"], [None, "b"], [None, None]], "a:double,b:str"),
                                          **kw).count()
                                 for kw in ({}, {"how": "all"}, {"subset": ["a"]}, {"thresh": 1})],
    "fillna": lambda M, e, tmp: [_rowset(e.fillna(e.to_df([[1.0, "a"], [None, None]], "a:double,b:str"), **kw))
                                 for kw in ({"value": 0, "subset": ["a"]}, {"value": dict(a=0.0, b="?")})],
    "sample_seeded": lambda M, e, tmp: [_rowset(e.sample(e.to_df([[i] for i in range(100)], "a:long"), **kw))
                                        for kw in ({"n": 10, "seed": 0}, {"frac": 0.1, "seed": 0})],
    "take": lambda M, e, tmp: [
        _rowset(e.take(e.to_df([[1, 5], [1, 3], [2, 9], [2, 2], [None, 1]], "a:double,b:long"), 1,
                       presort="b desc", partition_spec=M.PS(by=["a"]))),
        e.take(e.to_df([[1, 5], [1, 3], [2, 9], [2, 2], [None, 1]], "a:double,b:long"), 2,
               presort="b").as_array(type_safe=True),
        e.take(e.to_df([[1.0], [None], [3.0]], "a:double"), 1, presort="a", na_position="first").as_array()],
    "zip_comap": lambda M, e, tmp: [_rowset(e.comap(
        e.zip(M.DataFrames(e.to_df([[1, "a"], [1, "b"], [2, "c"]], "k:long,v:str"),
                           e.to_df([[1, 10.0], [3, 30.0]], "k:long,w:double")),
              how=how, partition_spec=M.PS(by=["k"])),
        lambda c, dfs: M.ADF([[c.key_value_array[0], dfs[0].count(), dfs[1].count()]], "k:long,n1:long,n2:long"),
        "k:long,n1:long,n2:long")) for how in ("inner", "left_outer")],
    "select_filter_assign": lambda M, e, tmp: [
        _rowset(e.select(e.to_df([[1, 10.0], [2, 20.0], [2, 5.0]], "a:long,b:double"),
                         M.SC(M.col("a"), (M.col("b") * M.lit(2)).cast(float).alias("bb")))),
        _rowset(e.filter(e.to_df([[1, 10.0], [2, None]], "a:long,b:double"), M.col("b").not_null())),
        _rowset(e.assign(e.to_df([[1, "x"]], "a:long,b:str"),
                         [M.lit(5).alias("c"), (M.col("a") + 1).cast("long").alias("a")])),
        _rowset(e.select(e.to_df([[1]], "a:long"), M.SC(M.col("a").cast("str").alias("s"))))],
    "aggregate": lambda M, e, tmp: [
        _rowset(e.aggregate(e.to_df([[1, 10.0], [1, 20.0], [2, 5.0]], "a:long,b:double"), M.PS(by=["a"]),
                            [M.ff.sum(M.col("b")).alias("s"), M.ff.count(M.col("b")).alias("n")])),
        _rowset(e.aggregate(e.to_df([[1, 10.0], [1, 20.0]], "a:long,b:double"), None,
                            [M.ff.max(M.col("b")).alias("m")]))],
    "save_load": lambda M, e, tmp: [_save_load(M, e, tmp, fmt) for fmt in ("parquet", "csv", "json")],
    "persist_broadcast": lambda M, e, tmp: [
        _rowset(f(e.to_df([[1]], "a:long"))) for f in (e.persist, e.broadcast,
                                                      lambda d: e.repartition(d, M.PS(num=2)))],
    "union_schema_mismatch_raises": lambda M, e, tmp: e.union(e.to_df([[1]], "a:long"), e.to_df([["x"]], "a:str")),
}


def _save_load(M, e, tmp, fmt):
    path = os.path.join(tmp, f"{M.name}_{fmt}.{fmt}")
    kw = dict(header=True) if fmt == "csv" else {}
    e.save_df(e.to_df([[1, "a"], [2, "b"]], "a:long,b:str"), path, **kw)
    res = e.load_df(path, columns="a:long,b:str", **(dict(header=True, infer_schema=True) if fmt == "csv" else {}))
    return type(res).__name__, _rowset(res)


@pytest.mark.parametrize("kind", sorted(ENGINES))
@pytest.mark.parametrize("case", sorted(SUITE))
def test_suite_case(kind, case, tmp_path):
    out = {}
    for M, make in zip((J, T), ENGINES[kind]):
        e = make()
        try:
            out[M.name] = SUITE[case](M, e, str(tmp_path))
        except Exception as ex:  # the same error class name on both
            out[M.name] = ("raised", type(ex).__name__)
        finally:
            e.stop()
    assert out["port"] == out["ref"], out
    assert out["port"][0] != "raised" or case == "union_schema_mismatch_raises"


def test_chip_smoke_warehouse_path_on_the_cpu():
    """``chip_smoke.phase_warehouse_path`` at small size on the CPU, in a
    subprocess that loads no JAX, with the CUDA calls stubbed: both cells
    run and pass their gates (config #2 against its oracle, the torch
    UDF's map not on the host path, ``z`` float32 after sqlite, the
    CONNECT engine stopped, the mixed sums against the float64 oracle),
    every step of the split is timed, and no temp table is left."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = f"""
import sys, torch
sys.path.insert(0, {str(root)!r})
import chip_smoke
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
torch.cuda.memory_allocated = lambda *a, **k: 0
import numpy as np, pandas as pd, pyarrow as pa
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import group_ops as go
out = chip_smoke.phase_warehouse_path(torch, np, pd, pa, bg, go, "cpu", rows=40_000, mixed_rows=20_000,
                                      twin={{"ms": 1.0, "first_call_s": 1.0}})
p, m = out["cells"]["hybrid-pipeline-4m"], out["cells"]["hybrid-mixed-1m"]
assert p["step_calls"]["load_ingest"] == 1 and p["host_maps"] == 1 and p["step_rows"]["sqlite"] == [1000], p
assert m["step_calls"]["connect"] == 1 and m["host_maps"] == 0 and m["connect_engines_stopped"] == [True], m
assert all(m["split_ms"][s] > 0 for s in chip_smoke.WH_STEPS), m["split_ms"]
assert m["centered_schema"].splitlines()[1] == "z: float", m["centered_schema"]
assert out["memory"]["temp_tables_left"] == 0
assert not list(__import__("pathlib").Path({str(root)!r}).glob(".warehouse_path_*"))
assert "jax" not in sys.modules
print("OK")
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip().endswith("OK"), p.stdout[-3000:] + p.stderr[-3000:]
