"""FugueSQL and the SQL engine of the port against the JAX package's.

Every case of ``tests/core/test_sql.py`` runs through both packages on the
same inputs (frames made with numpy, and the same seeded random frames):
the reference side on ``fugue_tpu``'s ``NativeExecutionEngine`` and
``JaxExecutionEngine`` (the 8-device CPU mesh), the port's side on its
``NativeExecutionEngine`` and ``TorchExecutionEngine(device="cpu")``, as
the pairs ``native`` and ``device``. Then:

- a windowed SELECT (``TestWindowFunctions``, ``TestWindowFrames``,
  ``TestWindowFrameEdges``) answers as on the reference, through the
  pandas evaluator exactly where the reference uses its own (or raises the
  same exception class, or the same syntax error), and ``CONNECT`` to an
  engine the port lacks names A.10;
- a parser differential: every SQL text of this file parsed by both
  parsers, the plan trees compared by a structural dump;
- chip_smoke.py's sql_path texts at ~64k lineitem rows against the JAX
  engine and the smoke's oracles.

Rows and column names exact (in order where the query orders them); a
float within 1e-5 of the other, relative to its size (the rounding to 5
digits of the reference's comparator ``_df_eq``).
"""

import dataclasses
import os
import unittest.mock as mock
from typing import Any, List

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import chip_smoke
from fugue_tpu.collections.sql import StructuredRawSQL as JStructuredRawSQL
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.dataframe import DataFrames as JDataFrames
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu.sql import fugue_sql as jfugue_sql
from fugue_tpu.sql import fugue_sql_flow as jfugue_sql_flow
from fugue_tpu.sql import parser as jparser
from fugue_tpu.workflow import raw_sql as jraw_sql
from fugue_tpu_torch import api
from fugue_tpu_torch.collections.sql import StructuredRawSQL
from fugue_tpu_torch.dataframe import DataFrames
from fugue_tpu_torch.exceptions import FugueSQLSyntaxError
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.sql import parser as tparser
from fugue_tpu_torch.torch import TorchExecutionEngine

FLOAT_TOL = 1e-5


# the JAX package's result cache (fugue_tpu/cache) would serve a DAG it ran
# before without running its tasks; the port has none (ROADMAP.md A.10)
REF_CONF = {"fugue.tpu.cache.enabled": False}


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine(REF_CONF)
    yield e
    e.stop()


@pytest.fixture(scope="module", params=["native", "device"])
def pair(request, jax_engine):
    """(reference engine, port engine)."""
    if request.param == "native":
        return JNativeExecutionEngine(REF_CONF), NativeExecutionEngine()
    return jax_engine, TorchExecutionEngine(device="cpu")


def _rows(df: Any) -> List[tuple]:
    pdf = df if isinstance(df, pd.DataFrame) else df.as_pandas()
    return [tuple(None if _isnull(v) else (v.item() if hasattr(v, "item") else v) for v in row)
            for row in pdf.itertuples(index=False, name=None)]


def _isnull(v: Any) -> bool:
    try:
        return bool(pd.isna(v))
    except (TypeError, ValueError):
        return False


def _close(a: Any, b: Any) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        return abs(a - b) <= FLOAT_TOL * max(1.0, abs(a), abs(b))
    return a == b


def _same(port: Any, ref: Any, ordered: bool = False) -> None:
    """The port's result holds the reference's rows under its column names."""
    pcols = list(port.columns) if isinstance(port, pd.DataFrame) else port.schema.names
    rcols = list(ref.columns) if isinstance(ref, pd.DataFrame) else ref.schema.names
    assert pcols == rcols
    p, r = _rows(port), _rows(ref)
    if not ordered:
        p, r = sorted(p, key=repr), sorted(r, key=repr)
    assert len(p) == len(r), (p, r)
    for x, y in zip(p, r):
        assert len(x) == len(y) and all(_close(a, b) for a, b in zip(x, y)), (p, r)


def _both_raise(port_call, ref_call, match: Any = None) -> None:
    """Both calls raise, with the same exception class name."""
    with pytest.raises(Exception, match=match) as ref_err:
        ref_call()
    with pytest.raises(Exception, match=match) as port_err:
        port_call()
    assert type(port_err.value).__name__ == type(ref_err.value).__name__


# ---- TestStandardSQL: the SQL engine facet ------------------------------------


def _standard_frames(kind: str) -> dict:
    if kind == "fixed":
        k = np.array([1, 2, 1, 3])
        s = np.array(["x", "y", "z", None], dtype=object)
        v = np.array([10.0, 20.0, 5.0, np.nan])
        bk, bt = np.array([1, 3]), np.array(["A", "C"], dtype=object)
    else:
        rng = np.random.default_rng(20261017)
        n = 300
        k = rng.integers(0, 6, n)
        s = np.where(rng.random(n) < 0.2, None, rng.choice(["x", "y", "z", "xa"], n)).astype(object)
        v = np.where(rng.random(n) < 0.15, np.nan, rng.integers(0, 40, n).astype(float))
        bk, bt = np.array([1, 3, 4]), np.array(["A", "C", "D"], dtype=object)
    return {
        "a": (pd.DataFrame({"k": k, "s": s, "v": v}), "k:long,s:str,v:double"),
        "b": (pd.DataFrame({"k": bk, "t": bt}), "k:long,t:str"),
    }


STANDARD = [
    ("projection_filter", "SELECT k, v*2 AS vv FROM a WHERE v >= 10", False),
    ("group_by", "SELECT k, SUM(v) AS s, COUNT(*) AS n FROM a GROUP BY k ORDER BY k", True),
    ("having", "SELECT k, COUNT(*) AS n FROM a GROUP BY k HAVING n > 1", False),
    ("join_inner", "SELECT a.k, s, t FROM a INNER JOIN b ON a.k = b.k ORDER BY s", True),
    ("join_left", "SELECT a.k, s, t FROM a LEFT JOIN b ON a.k = b.k", False),
    ("union", "SELECT k FROM a UNION SELECT k FROM b ORDER BY k", True),
    ("except", "SELECT k FROM a EXCEPT SELECT k FROM b ORDER BY k", True),
    ("case_in", "SELECT k, CASE WHEN v >= 10 THEN 'hi' ELSE 'lo' END AS c "
                "FROM a WHERE k IN (1, 2) ORDER BY k, c", True),
    ("like_between", "SELECT k FROM a WHERE s LIKE 'x%' OR k BETWEEN 3 AND 3 ORDER BY k", True),
    ("subquery_distinct_limit",
     "SELECT DISTINCT k FROM (SELECT k FROM a WHERE v IS NOT NULL) t ORDER BY k LIMIT 2", True),
    ("scalar_functions", "SELECT UPPER(s) AS u FROM a WHERE s IS NOT NULL ORDER BY u", True),
]


def _select(engine, frames: dict, sql: str, jax_side: bool):
    dfs = {n: engine.to_df(pdf, schema) for n, (pdf, schema) in frames.items()}
    if jax_side:
        return engine.sql_engine.select(JDataFrames(dfs), JStructuredRawSQL([(False, sql)], dialect="spark"))
    return engine.sql_engine.select(DataFrames(dfs), StructuredRawSQL([(False, sql)], dialect="spark"))


@pytest.mark.parametrize("data", ["fixed", "random"])
@pytest.mark.parametrize("name,sql,ordered", STANDARD, ids=[c[0] for c in STANDARD])
def test_standard_sql(pair, data, name, sql, ordered):
    ref_engine, engine = pair
    frames = _standard_frames(data)
    # ties under ORDER BY keep no order of their own: the fixed frames have none
    _same(_select(engine, frames, sql, False), _select(ref_engine, frames, sql, True),
          ordered=ordered and data == "fixed")


@pytest.mark.parametrize("sql", ["SELEC k FROM a", "SELECT * FROM nope"], ids=["syntax", "missing_table"])
def test_standard_sql_errors(pair, sql):
    ref_engine, engine = pair
    frames = _standard_frames("fixed")
    _both_raise(lambda: _select(engine, frames, sql, False), lambda: _select(ref_engine, frames, sql, True))


def test_raw_sql(pair):
    ref_engine, engine = pair
    pdf = pd.DataFrame({"a": np.arange(1, 4)})
    got = api.raw_sql("SELECT SUM(a) AS s FROM ", pdf, engine=engine)
    exp = jraw_sql("SELECT SUM(a) AS s FROM ", pdf, engine=ref_engine)
    assert isinstance(exp, pd.DataFrame) == isinstance(got, pd.DataFrame)
    _same(got if isinstance(got, pd.DataFrame) else got.as_pandas(),
          exp if isinstance(exp, pd.DataFrame) else exp.as_pandas())
    assert _rows(api.raw_sql("SELECT SUM(a) AS s FROM ", pdf, engine=engine, as_fugue=True)) == [(6,)]


# ---- TestFugueSQL and TestFugueSQLStatements ----------------------------------


def test_capture_local_var(pair):
    ref_engine, engine = pair
    src = pd.DataFrame({"k": np.array([1, 1, 2]), "v": np.array([1.0, 2.0, 3.0])})
    q = "SELECT k, SUM(v) AS s FROM src GROUP BY k ORDER BY k"
    _same(api.fugue_sql(q, engine=engine, as_fugue=True), jfugue_sql(q, engine=ref_engine, as_fugue=True),
          ordered=True)


def test_multi_statement_transform(pair):
    ref_engine, engine = pair
    src = pd.DataFrame({"k": np.array([1, 2]), "v": np.array([1.0, 2.0])})

    def double(df: pd.DataFrame) -> pd.DataFrame:
        df["v"] = df["v"] * 2
        return df

    q = """
    a = SELECT * FROM src WHERE v > 1
    TRANSFORM a USING double SCHEMA *
    """
    _same(api.fugue_sql(q, engine=engine, as_fugue=True), jfugue_sql(q, engine=ref_engine, as_fugue=True))


def test_create_take_print(pair, capsys):
    ref_engine, engine = pair
    q = """
    x = CREATE [[0,"a"],[1,"b"],[2,"c"]] SCHEMA n:long,s:str
    PRINT 2 ROWS FROM x TITLE "demo"
    TAKE 2 ROWS FROM x PRESORT n DESC
    """
    exp = jfugue_sql(q, engine=ref_engine, as_fugue=True)
    ref_out = capsys.readouterr().out
    got = api.fugue_sql(q, engine=engine, as_fugue=True)
    assert capsys.readouterr().out == ref_out and "demo" in ref_out
    _same(got, exp, ordered=True)


def test_save_load(pair, tmp_path):
    ref_engine, engine = pair
    for side, (flow, sql, eng) in {"port": (api.fugue_sql_flow, api.fugue_sql, engine),
                                   "ref": (jfugue_sql_flow, jfugue_sql, ref_engine)}.items():
        path = os.path.join(str(tmp_path), f"{side}.parquet")
        flow(f"""
            a = CREATE [[1,"x"],[2,"y"]] SCHEMA id:long,s:str
            SAVE a OVERWRITE PARQUET "{path}"
            """).run(eng)
        res = sql(f"""
            b = LOAD PARQUET "{path}"
            SELECT * FROM b WHERE id = 2
            """, engine=eng, as_fugue=True)
        if side == "port":
            got = res
        else:
            _same(got, res)
    assert _rows(got) == [(2, "y")]


def test_yields(pair):
    ref_engine, engine = pair
    q = """
    a = CREATE [[1],[2]] SCHEMA z:long
    YIELD DATAFRAME AS out
    """
    got = api.fugue_sql_flow(q).run(engine).yields["out"].result
    exp = jfugue_sql_flow(q).run(ref_engine).yields["out"].result
    _same(got, exp, ordered=True)
    assert got.as_array() == [[1], [2]]


def test_jinja_template(pair):
    ref_engine, engine = pair
    src = pd.DataFrame({"a": np.array([1, 2, 3])})
    q = "SELECT * FROM src WHERE a > {{threshold}}"
    _same(api.fugue_sql(q, threshold=1, engine=engine, as_fugue=True),
          jfugue_sql(q, threshold=1, engine=ref_engine, as_fugue=True))


@pytest.mark.parametrize("q", [
    "DROP ROWS IF ANY NULL FROM src",
    "FILL NULLS PARAMS a:0 FROM src",
    "RENAME COLUMNS a:aa FROM src",
    "ALTER COLUMNS a:str FROM src",
    "DROP COLUMNS b FROM src",
    "DROP COLUMNS b, nope IF EXISTS FROM src",
    "DROP ROWS IF ALL NULLS ON a, b FROM src",
], ids=["dropna", "fillna", "rename", "alter", "drop_columns", "drop_if_exists", "dropna_all_on"])
def test_drop_fill_rename_alter(pair, q):
    ref_engine, engine = pair
    src = pd.DataFrame({"a": np.array([1.0, np.nan, 3.0]), "b": np.array(["x", "y", None], dtype=object)})
    got = api.fugue_sql(q, engine=engine, as_fugue=True)
    exp = jfugue_sql(q, engine=ref_engine, as_fugue=True)
    assert str(got.schema) == str(exp.schema)
    _same(got, exp)


def _make_df_for_fsql(n: int = 3) -> pd.DataFrame:
    return pd.DataFrame({"a": np.arange(n)})


def test_create_using(pair):
    ref_engine, engine = pair
    q = "CREATE USING _make_df_for_fsql(n=5)"
    _same(api.fugue_sql(q, engine=engine, as_fugue=True), jfugue_sql(q, engine=ref_engine, as_fugue=True))


def test_process_output(pair):
    ref_engine, engine = pair

    def double(df: pd.DataFrame) -> pd.DataFrame:
        df["a"] = df["a"] * 2
        return df

    seen: List[int] = []

    def sink(df: pd.DataFrame) -> None:
        seen.append(len(df))

    q = """
    x = CREATE USING _make_df_for_fsql(n=4)
    y = PROCESS x USING double SCHEMA a:long
    OUTPUT y USING sink
    SELECT * FROM y WHERE a > 2
    """
    got = api.fugue_sql(q, engine=engine, as_fugue=True)
    exp = jfugue_sql(q, engine=ref_engine, as_fugue=True)
    assert seen == [4, 4]
    _same(got, exp)


def test_outtransform_prepartition(pair):
    ref_engine, engine = pair
    counts: List[int] = []

    def tally(df: pd.DataFrame) -> None:
        counts.append(len(df))

    q = """
    x = CREATE [[1],[1],[2]] SCHEMA k:long
    OUTTRANSFORM x PREPARTITION BY k USING tally
    """
    jfugue_sql_flow(q).run(ref_engine)
    ref_counts, counts[:] = sorted(counts), []
    api.fugue_sql_flow(q).run(engine)
    assert sorted(counts) == ref_counts == [1, 2]


def test_transform_presort(pair):
    ref_engine, engine = pair

    def first_row(df: pd.DataFrame) -> pd.DataFrame:
        return df.head(1)

    q = """
    x = CREATE [[1,5],[1,9],[2,3]] SCHEMA k:long,v:long
    TRANSFORM x PREPARTITION BY k PRESORT v DESC USING first_row SCHEMA *
    """
    _same(api.fugue_sql(q, engine=engine, as_fugue=True), jfugue_sql(q, engine=ref_engine, as_fugue=True))


def test_sample_statement(pair):
    ref_engine, engine = pair
    q = """
    x = CREATE USING _make_df_for_fsql(n=100)
    SAMPLE 10 ROWS SEED 42 FROM x
    """
    got = api.fugue_sql(q, engine=engine, as_fugue=True)
    assert got.count() == jfugue_sql(q, engine=ref_engine, as_fugue=True).count() == 10
    frac = "x = CREATE USING _make_df_for_fsql(n=1000)\nSAMPLE 10 PERCENT SEED 7 FROM x"
    if isinstance(engine, TorchExecutionEngine):  # the device's draw is the JAX engine's, bit for bit
        _same(api.fugue_sql(frac, engine=engine, as_fugue=True),
              jfugue_sql(frac, engine=ref_engine, as_fugue=True))


def test_yield_file(pair, tmp_path):
    ref_engine, engine = pair
    q = """
    x = CREATE [[7]] SCHEMA z:long
    YIELD FILE AS saved
    """
    fresh = NativeExecutionEngine() if isinstance(engine, NativeExecutionEngine) else TorchExecutionEngine(
        device="cpu")
    res = api.fugue_sql_flow(q).run(fresh, {"fugue.workflow.checkpoint.path": str(tmp_path / "ck")})
    assert res.yields["saved"].storage_type == "file"
    assert os.path.exists(res.yields["saved"].name)
    assert _rows(fresh.load_df(res.yields["saved"].name)) == [(7,)]
    ref = jfugue_sql_flow(q).run(ref_engine.__class__(REF_CONF) if isinstance(ref_engine, JNativeExecutionEngine)
                                 else ref_engine, {"fugue.workflow.checkpoint.path": str(tmp_path / "rk")})
    assert ref.yields["saved"].storage_type == "file"


def test_print_without_title(pair, capsys):
    ref_engine, engine = pair
    q = "x = CREATE [[1]] SCHEMA z:long\nPRINT x"
    jfugue_sql_flow(q).run(ref_engine)
    ref_out = capsys.readouterr().out
    api.fugue_sql_flow(q).run(engine)
    out = capsys.readouterr().out
    assert out == ref_out and "None" not in out and "z:long" in out


def test_fsql_on_the_device_engine(jax_engine):
    """``test_fsql_on_jax_engine``: the native result of the device engine
    is the device frame, on either package."""
    src = pd.DataFrame({"k": np.array([1, 1, 2]), "v": np.array([1.0, 2.0, 3.0])})
    q = "SELECT k, SUM(v) AS s FROM src GROUP BY k ORDER BY k"
    got = api.fugue_sql(q, device="cpu", as_fugue=True)
    assert type(got).__name__ == "TorchDataFrame"
    _same(got, jfugue_sql(q, engine=jax_engine, as_fugue=True), ordered=True)
    assert got.as_pandas()["s"].tolist() == [3.0, 3.0]


# ---- windows, and CONNECT's refusals -------------------------------------------

_WDF = {"k": [1, 1, 1, 2, 2], "v": [10.0, 30.0, 20.0, 5.0, 15.0]}
WINDOW_CASES = [
    ("row_number", _WDF, "SELECT k, v, ROW_NUMBER() OVER (PARTITION BY k ORDER BY v DESC) AS rn "
                         "FROM t ORDER BY k, rn"),
    ("rank_dense_rank", {"s": [10, 10, 5]}, "SELECT s, RANK() OVER (ORDER BY s DESC) AS r, "
                                            "DENSE_RANK() OVER (ORDER BY s DESC) AS dr FROM t ORDER BY s DESC"),
    ("lag_lead", _WDF, "SELECT k, v, LAG(v, 1, -1.0) OVER (PARTITION BY k ORDER BY v) AS prev "
                       "FROM t ORDER BY k, v"),
    ("windowed_aggregate", _WDF, "SELECT k, v, SUM(v) OVER (PARTITION BY k) AS total FROM t ORDER BY k, v"),
    ("where_before_window", _WDF, "SELECT k, ROW_NUMBER() OVER (PARTITION BY k ORDER BY v) AS rn "
                                  "FROM t WHERE v > 10 ORDER BY k, rn"),
    ("nested_window", _WDF, "SELECT SUM(v) OVER (PARTITION BY k) + 1 AS x FROM t"),
    ("window_with_groupby", _WDF, "SELECT k, ROW_NUMBER() OVER (ORDER BY k) AS rn FROM t GROUP BY k"),
    ("running_aggregate", {"k": [1, 1, 1], "v": [1.0, 2.0, 3.0]},
     "SELECT v, SUM(v) OVER (PARTITION BY k ORDER BY v) AS s FROM t ORDER BY v"),
    ("lag_default", {"id": [1, 2, 3], "v": [10.0, None, 20.0]},
     "SELECT id, LAG(v, 1, -1.0) OVER (ORDER BY id) AS p FROM t ORDER BY id"),
    ("rank_null_order_key", {"s": [10.0, None, 5.0]}, "SELECT s, RANK() OVER (ORDER BY s) AS r FROM t ORDER BY r"),
    ("running_agg_skips_nulls", {"id": [1, 2, 3], "v": [1.0, None, 2.0]},
     "SELECT id, SUM(v) OVER (ORDER BY id) AS s FROM t ORDER BY id"),
    ("multi_column_rank", {"a": [1, 1, 2], "b": [5, 5, 1]},
     "SELECT RANK() OVER (ORDER BY a, b) AS r, DENSE_RANK() OVER (ORDER BY a, b) AS dr FROM t ORDER BY r"),
    ("first_value", {"k": [1, 1], "id": [1, 2], "v": [None, 5.0]},
     "SELECT FIRST(v) OVER (PARTITION BY k ORDER BY id) AS f FROM t"),
    ("rank_interleaved", {"k": ["A", "B", "A", "B"], "v": [1, 1, 2, 2]},
     "SELECT k, v, RANK() OVER (PARTITION BY k ORDER BY v) AS r FROM t ORDER BY k, v"),
    ("empty_input", {"a": [1.0]}, "SELECT RANK() OVER (ORDER BY a) AS r FROM t WHERE a > 5"),
    ("default_range_peers", {"k": [1, 1, 1], "o": [1, 2, 2], "v": [1.0, 2.0, 4.0]},
     "SELECT o, SUM(v) OVER (PARTITION BY k ORDER BY o) AS s FROM t"),
    ("rows_frame", {"k": [1, 1, 1], "o": [1, 2, 2], "v": [1.0, 2.0, 4.0]},
     "SELECT o, SUM(v) OVER (PARTITION BY k ORDER BY o ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) "
     "AS s FROM t"),
    ("rows_sliding", {"o": [1, 2, 3, 4, 5], "v": [1.0, 2.0, 3.0, 4.0, 5.0]},
     "SELECT o, AVG(v) OVER (ORDER BY o ROWS 2 PRECEDING) AS m FROM t ORDER BY o"),
    ("range_value", {"o": [1, 2, 4, 7, 8], "v": [1.0] * 5},
     "SELECT o, COUNT(v) OVER (ORDER BY o RANGE BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS n FROM t ORDER BY o"),
    ("frames_min_max", {"o": [1, 2, 3, 4], "v": [3.0, None, 1.0, 2.0]},
     "SELECT o, MIN(v) OVER (ORDER BY o ROWS 1 PRECEDING) AS lo, "
     "MAX(v) OVER (ORDER BY o ROWS 1 PRECEDING) AS hi FROM t ORDER BY o"),
    ("range_current_row_keys", {"a": [1, 1, 1], "b": [1, 2, 2], "v": [1.0, 2.0, 4.0]},
     "SELECT b, SUM(v) OVER (ORDER BY a, b RANGE BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) AS s "
     "FROM t ORDER BY b, s"),
    ("range_string_key", {"s": ["x", "x", "y"], "v": [1.0, 2.0, 3.0]},
     "SELECT s, SUM(v) OVER (ORDER BY s RANGE BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) AS c "
     "FROM t ORDER BY s, c"),
]
WINDOW_SYNTAX_ERRORS = [
    ("distinct_in_window", {"k": [1], "v": [1.0]}, "SELECT SUM(DISTINCT v) OVER (PARTITION BY k) AS s FROM t"),
    ("unbounded_following_start", {"a": [1.0]},
     "SELECT SUM(a) OVER (ORDER BY a ROWS BETWEEN UNBOUNDED FOLLOWING AND CURRENT ROW) AS s FROM t"),
    ("unbounded_preceding_end", {"a": [1.0]},
     "SELECT SUM(a) OVER (ORDER BY a ROWS BETWEEN CURRENT ROW AND UNBOUNDED PRECEDING) AS s FROM t"),
]


@pytest.mark.parametrize("name,data,sql", WINDOW_CASES, ids=[c[0] for c in WINDOW_CASES])
def test_windowed_selects_are_refused(pair, name, data, sql):
    """Every windowed SELECT of the reference's window tests (once refused
    here, hence the name) answers on both port engines as on the
    reference's, or raises the same exception class where it raises
    (``nested_window``, ``window_with_groupby``). The pandas evaluator
    (``column/window.py`` ``eval_window``) runs on the port exactly where it
    runs on the reference: always on the native pair, where the device plan
    declines on the device pair."""
    import fugue_tpu.column.window as jwindow
    import fugue_tpu_torch.column.window as twindow

    ref_engine, engine = pair
    t = pd.DataFrame(data)
    if name in ("nested_window", "window_with_groupby"):
        _both_raise(lambda: api.fugue_sql(sql, engine=engine), lambda: jfugue_sql(sql, engine=ref_engine))
        return
    calls = {}

    def spy(module, key):
        real = module.eval_window

        def wrapped(*args, **kwargs):
            calls[key] = calls.get(key, 0) + 1
            return real(*args, **kwargs)

        return mock.patch.object(module, "eval_window", wrapped)

    with spy(jwindow, "ref"):
        ref = jfugue_sql(sql, engine=ref_engine, as_fugue=True)
    with spy(twindow, "port"):
        got = api.fugue_sql(sql, engine=engine, as_fugue=True)
    _same(got, ref)
    assert ("port" in calls) == ("ref" in calls), calls


@pytest.mark.parametrize("name,data,sql", WINDOW_SYNTAX_ERRORS, ids=[c[0] for c in WINDOW_SYNTAX_ERRORS])
def test_window_syntax_errors(pair, name, data, sql):
    ref_engine, engine = pair
    t = pd.DataFrame(data)
    with pytest.raises(FugueSQLSyntaxError):
        api.fugue_sql(sql, engine=engine)
    _both_raise(lambda: api.fugue_sql(sql, engine=engine), lambda: jfugue_sql(sql, engine=ref_engine))


def test_connect(pair):
    """``TestConnectStatement``: CONNECT to an engine the port lacks raises
    naming A.10; CONNECT local (the in-tree SQL engine) and to the port's
    own engines run; CONNECT needs a SELECT."""
    ref_engine, engine = pair
    t = pd.DataFrame({"k": np.array([1, 1, 2]), "v": np.array([1.0, 2.0, 3.0])})
    with pytest.raises(NotImplementedError, match="A.10"):
        api.fugue_sql("""
            a = CONNECT jax SELECT k, SUM(v) AS s FROM t GROUP BY k
            SELECT k, s + 1 AS s1 FROM a ORDER BY k
            """, engine=engine)
    q = "CONNECT local SELECT k FROM t ORDER BY k"
    _same(api.fugue_sql(q, engine=engine, as_fugue=True), jfugue_sql(q, engine=ref_engine, as_fugue=True),
          ordered=True)
    q2 = """
    a = CONNECT native SELECT k, SUM(v) AS s FROM t GROUP BY k
    SELECT k, s + 1 AS s1 FROM a ORDER BY k
    """
    assert _rows(api.fugue_sql(q2, engine=engine, as_fugue=True)) == [(1, 4.0), (2, 4.0)]
    with pytest.raises(NotImplementedError, match="A.10"):
        api.fugue_sql("CONNECT no_such_engine SELECT k FROM t", engine=engine)
    _both_raise(lambda: api.fugue_sql("CONNECT jax PRINT FROM t", engine=engine),
                lambda: jfugue_sql("CONNECT jax PRINT FROM t", engine=ref_engine))


def test_compile_dialect_is_refused(jax_engine):
    """Named for the refusal it pinned before the dialect transpiler was
    ported: a FugueSQL compile dialect other than spark now transpiles to
    the in-tree dialect before parsing, and the query answers as on the
    reference (rows exact)."""
    from fugue_tpu.sql import FugueSQLWorkflow as JFugueSQLWorkflow
    from fugue_tpu_torch.sql.fsql import FugueSQLWorkflow

    t = pd.DataFrame({"a": np.array([1, 2, 3]), "b c": np.array([0.5, 1.5, 2.5])})
    q = 'SELECT a, CAST("b c" AS DOUBLE PRECISION) AS x FROM t WHERE a > 1 YIELD DATAFRAME AS out'
    for ref_engine, engine in [(jax_engine, TorchExecutionEngine(device="cpu")),
                               (JNativeExecutionEngine(REF_CONF), NativeExecutionEngine())]:
        dag = FugueSQLWorkflow({"fugue.sql.compile.dialect": "postgres"})
        dag(q, t=t)
        dag.run(engine)
        jdag = JFugueSQLWorkflow({"fugue.sql.compile.dialect": "postgres", **REF_CONF})
        jdag(q, t=t)
        jdag.run(ref_engine)
        _same(dag.yields["out"].result, jdag.yields["out"].result)
        assert _rows(dag.yields["out"].result) == [(2, 1.5), (3, 2.5)]
    assert api.fugue_sql_flow("SELECT a FROM t") is not None


# ---- the remaining classes: scalar functions, GROUP BY, joins, subqueries -----

FSQL_CASES = [
    # TestScalarFunctions
    ("modulo", {"t": {"a": [1, 2, 3, 4]}}, "SELECT a FROM t WHERE a % 2 = 0", False),
    ("mod", {"t": {"a": [1, 2, 3, 4]}}, "SELECT MOD(a, 3) AS m FROM t", False),
    ("power", {"t": {"a": [1, 2, 3, 4]}}, "SELECT POWER(a, 2) AS p FROM t", False),
    ("replace", {"t": {"s": ["ab", "cd", "ef", "gh"]}}, "SELECT REPLACE(s, 'a', 'x') AS r FROM t", False),
    # TestGroupByDecoupled
    ("key_not_projected", {"t": {"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]}},
     "SELECT SUM(v) AS s FROM t GROUP BY k ORDER BY s", True),
    ("transformed_key", {"t": {"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]}},
     "SELECT k + 100 AS kk, SUM(v) AS s FROM t GROUP BY k ORDER BY kk", True),
    ("superset_of_projection", {"t": {"k": [1, 1, 2], "k2": [1, 2, 3], "v": [1.0, 2.0, 3.0]}},
     "SELECT k, SUM(v) AS s FROM t GROUP BY k, k2 ORDER BY s", True),
    ("pure_grouping", {"t": {"k": [1, 1, 2], "k2": [5, 5, 6]}}, "SELECT k FROM t GROUP BY k, k2 ORDER BY k", True),
    ("expression_over_aggregates", {"t": {"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]}},
     "SELECT SUM(v) / COUNT(v) AS m FROM t GROUP BY k ORDER BY m", True),
    ("having_decoupled", {"t": {"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]}},
     "SELECT SUM(v) AS s FROM t GROUP BY k HAVING COUNT(v) > 1", False),
    ("having_in_over_aggregate", {"t": {"k": [1, 1, 2], "v": [1, 2, 3]}},
     "SELECT k, COUNT(v) AS n FROM t GROUP BY k HAVING COUNT(v) IN (2)", False),
    # TestNonEquiJoins
    ("theta_join", {"lo": {"a": [1, 5, 9]}, "hi": {"b": [4, 6]}},
     "SELECT a, b FROM lo JOIN hi ON lo.a < hi.b ORDER BY a, b", True),
    ("equi_plus_residual", {"t1": {"k": [1, 1, 2], "v": [1.0, 5.0, 2.0]}, "t2": {"k": [1, 2], "w": [3.0, 1.0]}},
     "SELECT k, v, w FROM t1 INNER JOIN t2 ON t1.k = t2.k AND v > w ORDER BY k, v", True),
    # TestSubqueries
    ("scalar_subquery_where", {"t": {"k": [1, 2, 3, 4], "v": [10.0, 20.0, 30.0, 40.0]}},
     "SELECT k FROM t WHERE v > (SELECT AVG(v) FROM t) ORDER BY k", True),
    ("scalar_subquery_projection", {"t": {"v": [1.0, 2.0, 3.0]}},
     "SELECT v, (SELECT MAX(v) FROM t) AS mx FROM t", False),
    ("scalar_subquery_no_from", {"t": {"v": [5.0, 7.0]}}, "SELECT (SELECT SUM(v) FROM t) AS s", False),
    ("in_subquery", {"t": {"k": [1, 2, 3, 4]}, "good": {"k": [2, 4, 9]}},
     "SELECT k FROM t WHERE k IN (SELECT k FROM good) ORDER BY k", True),
    ("not_in_subquery", {"t": {"k": [1, 2, 3, 4]}, "good": {"k": [2, 4, 9]}},
     "SELECT k FROM t WHERE k NOT IN (SELECT k FROM good) ORDER BY k", True),
    ("exists_correlated", {"t": {"k": [1, 2, 3, 4]}, "good": {"k": [2, 4, 9], "w": [1.0, 2.0, 3.0]}},
     "SELECT k FROM t WHERE EXISTS (SELECT * FROM good WHERE good.k = t.k) ORDER BY k", True),
    ("not_exists_correlated", {"t": {"k": [1, 2, 3, 4]}, "good": {"k": [2, 4, 9], "w": [1.0, 2.0, 3.0]}},
     "SELECT k FROM t WHERE NOT EXISTS (SELECT * FROM good WHERE good.k = t.k) ORDER BY k", True),
    ("correlated_scalar", {"t": {"k": [1, 2, 3]}, "g": {"k": [1, 1, 2], "w": [1.0, 2.0, 5.0]}},
     "SELECT k, (SELECT SUM(w) FROM g WHERE g.k = t.k) AS sw FROM t ORDER BY k", True),
    ("grouping_sets", {"t": {"a": [1, 1, 2], "b": [1, 2, 2], "v": [1.0, 2.0, 3.0]}},
     "SELECT a, b, SUM(v) AS s FROM t GROUP BY GROUPING SETS ((a, b), (a), ())", False),
    ("rollup", {"t": {"a": [1, 1, 2], "b": [1, 2, 2], "v": [1.0, 2.0, 3.0]}},
     "SELECT a, b, SUM(v) AS s FROM t GROUP BY ROLLUP (a, b)", False),
    ("order_by_unprojected", {"t": {"id": [3, 1, 2], "v": [30.0, 10.0, 20.0]}}, "SELECT v FROM t ORDER BY id", True),
    ("union_all_intersect", {"t": {"k": [1, 2, 2]}, "u": {"k": [2, 3]}},
     "SELECT k FROM t UNION ALL SELECT k FROM u INTERSECT SELECT k FROM u", False),
    ("cross_join_limit", {"t": {"k": [1, 2]}, "u": {"j": [7, 8, 9]}},
     "SELECT k, j FROM t CROSS JOIN u ORDER BY k, j LIMIT 4", True),
    ("semi_anti", {"t": {"k": [1, 2, 3]}, "u": {"k": [2, 5]}},
     "SELECT k FROM t LEFT SEMI JOIN u ON t.k = u.k UNION ALL SELECT k FROM t ANTI JOIN u ON t.k = u.k", False),
]


def _scope(frames: dict) -> dict:
    return {n: pd.DataFrame({c: np.array(v) for c, v in cols.items()}) for n, cols in frames.items()}


@pytest.mark.parametrize("name,frames,sql,ordered", FSQL_CASES, ids=[c[0] for c in FSQL_CASES])
def test_fugue_sql_cases(pair, name, frames, sql, ordered):
    ref_engine, engine = pair
    dfs = _scope(frames)
    _same(api.fugue_sql(sql, engine=engine, as_fugue=True, **dfs),
          jfugue_sql(sql, engine=ref_engine, as_fugue=True, **dfs), ordered=ordered)


FSQL_ERRORS = [
    ("ungrouped_column", {"t": {"k": [1], "v": [1.0]}}, "SELECT v, SUM(v) AS s FROM t GROUP BY k", "GROUP BY"),
    ("non_equi_outer", {"t1": {"k": [1], "v": [1.0]}, "t2": {"k": [1], "w": [2.0]}},
     "SELECT * FROM t1 LEFT JOIN t2 ON t1.k = t2.k AND v > w", None),
    ("scalar_subquery_multirow", {"t": {"v": [1.0, 2.0]}}, "SELECT (SELECT v FROM t) AS s", "one row|one column"),
]


@pytest.mark.parametrize("name,frames,sql,match", FSQL_ERRORS, ids=[c[0] for c in FSQL_ERRORS])
def test_fugue_sql_errors(pair, name, frames, sql, match):
    ref_engine, engine = pair
    dfs = _scope(frames)
    _both_raise(lambda: api.fugue_sql(sql, engine=engine, **dfs),
                lambda: jfugue_sql(sql, engine=ref_engine, **dfs), match=match)


# the module-level cases of test_sql.py: GROUP BY and ORDER BY expressions
_GB = pd.DataFrame({"s": ["apple", "avocado", "banana", "blueberry"], "v": [1.0, 2.0, 3.0, 4.0]})
_GB2 = pd.DataFrame({"k": [1, 1, 2, 2, 2], "x": [1.0, 2.0, 3.0, 4.0, 10.0]})
_OB = pd.DataFrame({"s": ["bb", "za", "ccc"], "v": [1.0, 2.0, 3.0], "x": ["10", "2", "1"]})
_OB2 = pd.DataFrame({"k": [1, 1, 2], "x": [1.0, 3.0, 4.0]})
EXPRESSION_CASES = [
    ("gb_substring", "SELECT SUBSTRING(s,1,1) AS c, SUM(v) AS t FROM df GROUP BY SUBSTRING(s,1,1)", False),
    ("gb_mixed_where_having", "SELECT k, x > 2.5 AS hi, COUNT(*) AS n FROM df2 WHERE x < 9 "
                              "GROUP BY k, x > 2.5 HAVING COUNT(*) > 1", False),
    ("gb_having_grouped_expr", "SELECT SUBSTRING(s,1,1) AS c, SUM(v) AS t FROM df "
                               "GROUP BY SUBSTRING(s,1,1) HAVING SUBSTRING(s,1,1) <> 'a'", False),
    ("gb_unaliased", "SELECT SUBSTRING(s,1,1), SUM(v) AS t FROM df GROUP BY SUBSTRING(s,1,1)", False),
    ("gb_star_computed_key", "SELECT * FROM df2 GROUP BY k, x, x > 2.5", False),
    ("ob_substring_desc", "SELECT s FROM ob ORDER BY SUBSTRING(s,2,1) DESC", True),
    ("ob_negated", "SELECT s FROM ob ORDER BY v * -1", True),
    ("ob_mixed", "SELECT s, v FROM ob ORDER BY SUBSTRING(s,1,1), v DESC", True),
    ("ob_over_aggregate", "SELECT s, SUM(v) AS t FROM ob GROUP BY s ORDER BY t * -1", True),
    ("ob_ordinal", "SELECT s, v FROM ob ORDER BY 2 DESC", True),
    ("ob_cast", "SELECT x FROM ob ORDER BY CAST(x AS int)", True),
    ("gb_compound_aliases", "SELECT k + 1 AS k1, x > 2.5 AS hi, COUNT(*) AS n FROM ob2 GROUP BY k + 1, x > 2.5",
     False),
    ("gb_cast_grouped", "SELECT CAST(k+1 AS int) AS k1, COUNT(*) AS n FROM ob2 GROUP BY k+1", False),
]


@pytest.mark.parametrize("name,sql,ordered", EXPRESSION_CASES, ids=[c[0] for c in EXPRESSION_CASES])
def test_group_and_order_by_expressions(pair, name, sql, ordered):
    ref_engine, engine = pair
    dfs = {"df": _GB, "df2": _GB2, "ob": _OB, "ob2": _OB2}
    got = api.fugue_sql(sql, engine=engine, as_fugue=True, **dfs)
    exp = jfugue_sql(sql, engine=ref_engine, as_fugue=True, **dfs)
    assert str(got.schema) == str(exp.schema)
    _same(got, exp, ordered=ordered)


EXPRESSION_ERRORS = [
    ("ob_constant", "SELECT s FROM ob ORDER BY 'q'", "constant"),
    ("ob_out_of_range", "SELECT s FROM ob ORDER BY 5", "out of range"),
    ("ob_dropped_in_aggregate", "SELECT s, SUM(v) AS t FROM ob GROUP BY s ORDER BY v * 2", "order by projected"),
    ("ob_hidden_helper_ordinal", "SELECT s FROM ob ORDER BY v, 2", "out of range"),
    ("ob_alias_and_dropped", "SELECT v AS w, s FROM ob ORDER BY w * x", "mixes projection aliases"),
]


@pytest.mark.parametrize("name,sql,match", EXPRESSION_ERRORS, ids=[c[0] for c in EXPRESSION_ERRORS])
def test_order_by_errors(pair, name, sql, match):
    ref_engine, engine = pair
    _both_raise(lambda: api.fugue_sql(sql, engine=engine, ob=_OB),
                lambda: jfugue_sql(sql, engine=ref_engine, ob=_OB), match=match)


# ---- TestTokenizerParity and the parser differential -----------------------------

EDGE_INPUTS = [
    "SELECT 1e5, 2E+3, 3e-2 FROM t",
    "SELECT 1e FROM t",
    "SELECT 2e+ FROM t",
    "SELECT .5e2, 1.5e, x FROM t",
    "SELECT a1e2 FROM t",
    "SELECT 'it''s', `odd col` FROM t WHERE a <> 1 AND b != 2",
    "SELECT * FROM t -- comment\nWHERE a >= 1 /* block */ OR b <= 2",
]
CORPUS = (
    [c[1] for c in STANDARD] + [c[2] for c in WINDOW_CASES] + [c[2] for c in FSQL_CASES]
    + [c[1] for c in EXPRESSION_CASES] + [c[1] for c in EXPRESSION_ERRORS] + [c[2] for c in FSQL_ERRORS]
    + [q for q, _ in chip_smoke.sql_path_queries().values()]
    + ["SELECT agg.k, s FROM agg WHERE w > 0.1 GROUP BY k",
       "SELECT a.k FROM a RIGHT OUTER JOIN b USING (k)",
       "SELECT k FROM a FULL OUTER JOIN b ON a.k = b.k",
       "SELECT k, CASE k WHEN 1 THEN 'one' WHEN 2 THEN 'two' END AS w FROM a",
       "SELECT CAST(v AS VARCHAR(10)) AS c, CAST(v AS DECIMAL(10,2)) AS d FROM a",
       "SELECT k FROM a WHERE s NOT LIKE '%x' AND v NOT BETWEEN 1 AND 2 AND s IS NULL",
       "SELECT COUNT(DISTINCT k) AS n, MEAN(v) AS m, FIRST(s) AS f, LAST(s) AS l FROM a",
       "SELECT a, b, SUM(v) AS s FROM t GROUP BY CUBE (a, b)",
       "(SELECT k FROM a) UNION ALL (SELECT k FROM b) ORDER BY k DESC LIMIT 3"]
)


def test_python_digitless_exponent():
    toks = tparser._tokenize_py("1e")
    assert [(t.kind, t.value) for t in toks[:2]] == [("NUMBER", "1"), ("IDENT", "e")]
    toks = tparser._tokenize_py("2e+")
    assert [(t.kind, t.value) for t in toks[:3]] == [("NUMBER", "2"), ("IDENT", "e"), ("OP", "+")]


@pytest.mark.parametrize("sql", EDGE_INPUTS + CORPUS)
def test_tokens_match_the_reference(sql):
    assert [(t.kind, t.value, t.pos) for t in tparser.tokenize(sql)] == [
        (t.kind, t.value, t.pos) for t in jparser._tokenize_py(sql)
    ]


def _dump(x: Any) -> Any:
    """A structural dump of a plan tree (either package's): dataclass nodes
    by type and fields, expressions by type, uuid, text, SQL qualifier,
    subquery plan and children."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple((f.name, _dump(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, (list, tuple)):
        return tuple(_dump(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _dump(v)) for k, v in x.items()))
    if hasattr(x, "__uuid__") and hasattr(x, "children"):
        return (type(x).__name__, x.__uuid__(), repr(x), getattr(x, "_sql_qualifier", ""),
                _dump(getattr(x, "plan", None)), tuple(_dump(c) for c in x.children))
    return repr(x)


@pytest.mark.parametrize("sql", CORPUS)
def test_plans_match_the_reference(sql):
    try:
        ref = jparser.SQLParser(sql).parse_full()
    except Exception as e:
        with pytest.raises(type(e).__name__ == "FugueSQLSyntaxError" and FugueSQLSyntaxError or Exception):
            tparser.SQLParser(sql).parse_full()
        return
    assert _dump(tparser.SQLParser(sql).parse_full()) == _dump(ref)


# ---- chip_smoke.py's sql_path texts at ~64k lineitem rows ---------------------


def test_sql_path_cells_match_the_jax_engine(jax_engine):
    """The three lineitem cells of the smoke's sql_path, on the port's device
    engine and on the JAX engine, against each other and the oracles of
    their select_path twins; Q1 as TPC-H writes it (SUM over an
    expression) gives the same answer."""
    engine = TorchExecutionEngine(device="cpu")
    tbl, aux = chip_smoke.make_lineitem(np, pa, 0, 16_000)
    lineitem = engine.to_df(tbl)
    jlineitem = jax_engine.to_df(JArrowDataFrame(tbl))
    oracles = chip_smoke.select_path_oracles(np, pd, tbl, aux)
    for cell, (query, twin) in chip_smoke.sql_path_queries().items():
        got = api.fugue_sql(query, lineitem=lineitem, engine=engine, as_fugue=True)
        exp = jfugue_sql(query, lineitem=jlineitem, engine=jax_engine, as_fugue=True)
        _same(got, exp, ordered=cell == "sql-q1")
        if twin == "q6-select":
            assert np.isclose(got.as_pandas()["revenue"][0], oracles[twin]["revenue"][0],
                              rtol=chip_smoke.Q6_RTOL, atol=0)
        else:
            res = got.as_pandas()
            chip_smoke.check_lineitem(np, res, oracles[twin], [c for c in res.columns if c.startswith("l_")], cell)
    as_written = chip_smoke.sql_path_queries()["sql-q1"][0].replace(
        "SUM(disc_price)", "SUM(l_extendedprice * (1 - l_discount))").replace(
        "(SELECT *, l_extendedprice * (1 - l_discount) AS disc_price FROM lineitem) AS li", "lineitem")
    got = api.fugue_sql(as_written, lineitem=lineitem, engine=engine, as_fugue=True)
    chip_smoke.check_lineitem(np, got.as_pandas(), oracles["q1-select"], ["l_returnflag", "l_linestatus"], "q1")


def test_sql_pipeline_matches_bench_and_the_oracle(jax_engine, tmp_path):
    """BASELINE config #2 as bench.py writes it, at 40,000 rows: the port's
    device and host engines, the JAX engine and the pandas oracle agree."""
    import pyarrow.parquet as pq

    pdf = chip_smoke.sql_pipeline_frame(np, pd, 40_000)
    path = str(tmp_path / "bench.parquet")
    pq.write_table(pa.Table.from_pandas(pdf, preserve_index=False), path)
    sql = chip_smoke.sql_pipeline_text(path)

    def rescale(df: pd.DataFrame) -> pd.DataFrame:
        df["s"] = df["s"] / df["s"].max()
        return df

    exp = chip_smoke.sql_pipeline_oracle(pdf)
    ref = jfugue_sql(sql, rescale=rescale, engine=jax_engine, as_fugue=True)
    for engine in (TorchExecutionEngine(device="cpu"), NativeExecutionEngine()):
        got = api.fugue_sql(sql, rescale=rescale, engine=engine, as_fugue=True)
        assert str(got.schema) == "k:long,s:double,n:long"
        chip_smoke.check_sql_pipeline(np, got.as_pandas(), exp)
        _same(got, ref)


# ---- sql/infer.py: a SELECT's output schema from its inputs' ------------------


@pytest.mark.parametrize("name,sql,ordered", STANDARD, ids=[c[0] for c in STANDARD])
def test_inferred_schemas_match_the_reference(name, sql, ordered):
    from fugue_tpu.schema import Schema as JSchema
    from fugue_tpu.sql.infer import infer_output_schema as jinfer
    from fugue_tpu_torch.schema import Schema
    from fugue_tpu_torch.sql.infer import infer_output_schema

    schemas = {n: s for n, (_, s) in _standard_frames("fixed").items()}
    got = infer_output_schema(sql, {n: Schema(s) for n, s in schemas.items()})
    exp = jinfer(sql, {n: JSchema(s) for n, s in schemas.items()})
    assert str(got) == str(exp)


def test_set_sql_engine():
    """An engine's SQL facet can be replaced (``set_sql_engine``): FugueSQL's
    SELECTs then run on it."""
    from fugue_tpu_torch.sql import LocalSQLEngine

    seen = []

    class Recording(LocalSQLEngine):
        def select(self, dfs, statement):
            seen.append(statement.construct())
            return super().select(dfs, statement)

    engine = NativeExecutionEngine()
    engine.set_sql_engine(Recording(engine))
    t = pd.DataFrame({"a": np.array([1, 2])})
    assert _rows(api.fugue_sql("SELECT a FROM t WHERE a > 1", engine=engine, as_fugue=True)) == [(2,)]
    assert len(seen) == 1 and "WHERE a > 1" in seen[0]


_SQL_PATH_ON_THE_CPU = """
import json, numpy as np, pandas as pd, pyarrow as pa, torch
import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
engine = TorchExecutionEngine(device="cpu")
tbl, aux = chip_smoke.make_lineitem(np, pa, 0, 16_000)
oracles = chip_smoke.select_path_oracles(np, pd, tbl, aux)
tdf = engine.persist(engine.to_df(tbl))
sel = chip_smoke.phase_select_path(torch, np, bg, api, ff, col, engine, tdf, oracles)
out = chip_smoke.phase_sql_path(torch, np, pd, bg, api, engine, tdf, oracles, sel["cells"], pipeline_rows=40_000)
print("RESULT", json.dumps({c: {k: v for k, v in l.items() if "profile" not in k} for c, l in out["cells"].items()}))
"""


def test_chip_smoke_sql_path_on_the_cpu():
    """The phase at ~64k lineitem rows and a 40,000-row parquet file, each
    cell through its oracle, one line each, in a process that loads no JAX;
    the temporary directory is gone after."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", _SQL_PATH_ON_THE_CPU], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith('{"phase": "sql_path"')]
    assert [ln["cell"] for ln in lines] == ["sql-q1", "sql-q6", "sql-shipmode-where", "sql-pipeline-4m"]
    for ln in lines:
        assert ln["launches"] == {"bin_sum": 0, "bin_sum_count": 0} and ln["ms"] > 0 and ln["compile_ms"] > 0
        assert "fugue::sql_select" in ln["profile"]["host_spans_ms"]
    assert [ln.get("twin") for ln in lines] == ["q1-select", "q6-select", "shipmode-where", None]
    assert "fugue::host_map" in lines[3]["profile"]["host_spans_ms"]
    assert "fugue::to_host" not in lines[0]["profile"]["host_spans_ms"]  # Q1 stays on the device
    assert not list(root.glob(".sql_path_*")) and "jax" not in res.stdout
