"""The port's ``NativeExecutionEngine`` (``fugue_tpu_torch/execution``)
against ``fugue_tpu``'s, verb by verb, on the same inputs made from a seed
with numpy: the joins of every type with NULL keys, the set operations,
``distinct``, ``dropna``, ``fillna``, a seeded ``sample``, ``take``,
``select``/``filter``/``assign``/``aggregate`` (the column IR over
pandas), ``broadcast``, ``persist``, and ``load_df``/``save_df`` round
trips in parquet, csv and json; then the device engine's
``load_df``/``save_df`` and ``api.load``/``api.save``.

The two engines run the same pandas code, so results are compared exactly
(schema, rows in order, NULLs), floats included, except where a verb's
row order is not part of its contract (the joins and the set operations:
compared after sorting by every column).
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.column import SelectColumns as JSelectColumns
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.execution import NativeExecutionEngine as JNative
from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import SelectColumns, col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.dataframe import ArrayDataFrame
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine

HOWS = ["inner", "left_outer", "right_outer", "full_outer", "left_semi", "left_anti", "cross"]


@pytest.fixture(scope="module")
def engines():
    return JNative(), NativeExecutionEngine()


def _left(n: int = 60, seed: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    k = pd.array(np.where(rng.random(n) < 0.15, None, rng.integers(0, 8, n)), dtype="Int64")
    s = np.array(["ant", "bee", None], dtype=object)[rng.integers(0, 3, n)]
    v = np.where(rng.random(n) < 0.1, np.nan, rng.integers(0, 4, n).astype(np.float64))
    return pd.DataFrame({"k": k, "s": s, "v": v})


def _right(n: int = 20, seed: int = 1) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    k = pd.array(np.where(rng.random(n) < 0.2, None, rng.integers(0, 10, n)), dtype="Int64")
    return pd.DataFrame({"k": k, "w": rng.random(n)})


def _same(got, exp, ordered: bool = True) -> None:
    assert str(got.schema) == str(exp.schema)
    g, e = got.as_pandas(), exp.as_pandas()
    if not ordered:
        g = g.sort_values(list(g.columns)).reset_index(drop=True)
        e = e.sort_values(list(e.columns)).reset_index(drop=True)
    pd.testing.assert_frame_equal(g, e)


@pytest.mark.parametrize("how", HOWS)
def test_join_with_null_keys(engines, how):
    je, te = engines
    left, right = _left(), _right()
    if how == "cross":
        right = right.rename(columns={"k": "j"}).head(5)
    exp = je.join(je.to_df(left), je.to_df(right), how=how)
    got = te.join(te.to_df(left), te.to_df(right), how=how)
    _same(got, exp, ordered=False)
    if how == "inner":  # a NULL key matches nothing, not even a NULL
        assert not got.as_pandas()["k"].isna().any()


@pytest.mark.parametrize("verb", ["union", "subtract", "intersect"])
@pytest.mark.parametrize("distinct", [True, False])
def test_set_operations(engines, verb, distinct):
    je, te = engines
    a, b = _left(40, 2), _left(40, 3)
    if verb != "union" and not distinct:
        for e in engines:
            with pytest.raises(NotImplementedError):
                getattr(e, verb)(e.to_df(a), e.to_df(b), distinct=False)
        return
    exp = getattr(je, verb)(je.to_df(a), je.to_df(b), distinct=distinct)
    got = getattr(te, verb)(te.to_df(a), te.to_df(b), distinct=distinct)
    _same(got, exp, ordered=False)


def test_union_refuses_two_schemas(engines):
    for e in engines:
        with pytest.raises(Exception, match="schema mismatch"):
            e.union(e.to_df(_left()), e.to_df(_right()))


def test_distinct_treats_null_as_equal(engines):
    je, te = engines
    _same(te.distinct(te.to_df(_left())), je.distinct(je.to_df(_left())))


@pytest.mark.parametrize("kw", [{}, {"how": "all"}, {"thresh": 3}, {"subset": ["k"]}])
def test_dropna(engines, kw):
    je, te = engines
    _same(te.dropna(te.to_df(_left()), **kw), je.dropna(je.to_df(_left()), **kw))


@pytest.mark.parametrize("value,subset", [(0, ["k", "v"]), ({"k": 9, "s": "zz"}, None)])
def test_fillna(engines, value, subset):
    je, te = engines
    _same(te.fillna(te.to_df(_left()), value, subset=subset),
          je.fillna(je.to_df(_left()), value, subset=subset))
    for e in engines:
        with pytest.raises(Exception, match="fillna"):
            e.fillna(e.to_df(_left()), None)


@pytest.mark.parametrize("kw", [{"n": 10, "seed": 7}, {"frac": 0.3, "seed": 3}, {"n": 80, "replace": True, "seed": 1}])
def test_seeded_sample(engines, kw):
    je, te = engines
    _same(te.sample(te.to_df(_left()), **kw), je.sample(je.to_df(_left()), **kw))


@pytest.mark.parametrize("presort,by,na", [("v desc", None, "last"), ("v", ["s"], "first"), ("", ["k"], "last")])
def test_take(engines, presort, by, na):
    je, te = engines
    exp = je.take(je.to_df(_left()), 2, presort, na_position=na,
                  partition_spec=None if by is None else JPartitionSpec(by=by))
    got = te.take(te.to_df(_left()), 2, presort, na_position=na,
                  partition_spec=None if by is None else PartitionSpec(by=by))
    _same(got, exp)


def test_to_df_of_rows_and_of_a_device_frame(engines):
    _, te = engines
    rows = te.to_df([[1, "a"], [2, None]], "k:long,s:str")
    assert isinstance(rows, ArrayDataFrame) and rows.as_array() == [[1, "a"], [2, None]]
    device = TorchExecutionEngine(device="cpu").to_df(_left())
    pd.testing.assert_frame_equal(te.to_df(device).as_pandas(), device.as_pandas())


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json"])
def test_load_and_save_round_trips(engines, tmp_path, fmt):
    je, te = engines
    pdf = _left().dropna(subset=["k"]).reset_index(drop=True)
    schema = "k:long,s:str,v:double"
    kw = {"header": True} if fmt == "csv" else {}
    for name, e in (("jax", je), ("torch", te)):
        e.save_df(e.to_df(pdf), str(tmp_path / f"{name}.{fmt}"), **kw)
    columns = schema if fmt != "parquet" else None
    exp = je.load_df(str(tmp_path / f"jax.{fmt}"), columns=columns, **kw)
    got = te.load_df(str(tmp_path / f"torch.{fmt}"), columns=columns, **kw)
    _same(got, exp)
    # each engine reads the other's file alike
    _same(te.load_df(str(tmp_path / f"jax.{fmt}"), columns=columns, **kw), exp)


def test_partitioned_parquet_and_save_modes(engines, tmp_path):
    je, te = engines
    pdf = _left().dropna(subset=["k"]).reset_index(drop=True)
    for name, e, spec in (("jax", je, JPartitionSpec(by=["k"])), ("torch", te, PartitionSpec(by=["k"]))):
        e.save_df(e.to_df(pdf), str(tmp_path / f"{name}.parquet"), partition_spec=spec)
        with pytest.raises(Exception, match="exists"):
            e.save_df(e.to_df(pdf), str(tmp_path / f"{name}.parquet"), mode="error")
    _same(te.load_df(str(tmp_path / "torch.parquet")), je.load_df(str(tmp_path / "jax.parquet")),
          ordered=False)


def test_device_engine_loads_onto_its_device_and_saves_from_it(tmp_path):
    e = TorchExecutionEngine(device="cpu")
    path = str(tmp_path / "f.parquet")
    # no NULL ints: the csv writer (the reference's) widens them to floats
    pa_tbl = pa.Table.from_pandas(_left().dropna(subset=["k"]), preserve_index=False)
    api.save(pa_tbl, path, engine=e)
    got = api.load(path, engine=e)
    assert isinstance(got, TorchDataFrame) and got.device == e.device
    pd.testing.assert_frame_equal(got.as_pandas(), e.to_df(pa_tbl).as_pandas())
    assert e.save_df(got, str(tmp_path / "g.csv"), header=True) is got
    back = api.load(str(tmp_path / "g.csv"), columns="k:long,s:str,v:double", header=True, engine=e)
    assert back.count() == got.count()


def _row_local(c, f, SC, PS):
    return {
        "select": lambda e, d: e.select(d, SC(c("s"), (c("v") * 2 + c("k")).alias("x")), where=c("v") > 0),
        "select_grouped": lambda e, d: e.select(d, SC(c("s"), f.sum(c("v")).alias("sv"), f.count(c("k")).alias("n")),
                                                having=f.count(c("k")) > 1),
        "filter": lambda e, d: e.filter(d, c("k").is_null() | (c("s") == "bee")),
        "assign": lambda e, d: e.assign(d, [(c("v") + 1).alias("v"), c("k").cast("double").alias("kd")]),
        "aggregate": lambda e, d: e.aggregate(d, PS(by=["s"]), [f.avg(c("v")).alias("m"), f.max(c("k")).alias("mk")]),
        "aggregate_no_keys": lambda e, d: e.aggregate(d, None, [(f.max(c("v")) - f.min(c("v"))).alias("r")]),
        "broadcast": lambda e, d: e.broadcast(d),
        "persist": lambda e, d: e.persist(d),
    }


@pytest.mark.parametrize("verb", list(_row_local(col, ff, SelectColumns, PartitionSpec)))
def test_row_local_verbs(engines, verb):
    """The host forms of the row-local verbs: the same pandas evaluator
    (``column/eval.py``) on both sides."""
    je, te = engines
    left = _left()
    exp = _row_local(jcol, jff, JSelectColumns, JPartitionSpec)[verb](je, je.to_df(left))
    got = _row_local(col, ff, SelectColumns, PartitionSpec)[verb](te, te.to_df(left))
    _same(got, exp, ordered=verb not in ("select_grouped", "aggregate"))
