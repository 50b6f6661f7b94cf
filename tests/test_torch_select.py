"""``TorchExecutionEngine(device="cpu")``'s row-local verbs — ``select``,
``filter``, ``assign``, ``aggregate`` (any keys, 0 keys, expressions,
COUNT DISTINCT), ``dropna``, ``fillna``, ``broadcast``, ``persist`` — and
``fugue_tpu_torch.api``'s, against ``JaxExecutionEngine`` (the 8-device
CPU mesh) on the same inputs.

The cases are those of ``fugue_tpu_test/execution_suite.py``
(``test_select`` :347, ``test_filter`` :356, ``test_assign`` :361,
``test_aggregate`` :366, ``test_aggregate_no_keys`` :378, ``test_dropna``
:276, ``test_fillna`` :283, ``test_select_with_cast`` :579,
``test_persist_broadcast`` :538),
of ``tests/jax_engine/test_encoded_columns.py`` :115-:160 and :246, the
filtered-frame cases of ``test_nested_and_edges.py:107``,
``test_device_resident_agg.py:80`` and ``test_advice_r2.py:63``, a matrix
of selects over a frame of every encoding, the filter's mask in every
later verb, the routing (each case spies on both host engines: the port's
is called exactly where the JAX engine's is), the A.3 refusals, and
``chip_smoke.py``'s select_path cells at small size.

Exact: schema, arrow types, row sets, keys, counts, NULL placement and
every projected value (both engines compute in the same dtypes). Sums and
averages of an aggregate: ``rtol=1e-5`` (pandas' default, as the
reference's tests compare), since they add in another order.
"""

import contextlib
import datetime
import json
import subprocess
import sys
import unittest.mock as mock
from pathlib import Path
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import chip_smoke
import fugue_tpu.api as fa
from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.column import SelectColumns as JSelectColumns
from fugue_tpu.column import all_cols as jall_cols
from fugue_tpu.column import col as jcol
from fugue_tpu.column import expressions as jexpr
from fugue_tpu.column import functions as jff
from fugue_tpu.column import lit as jlit
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.jax import JaxDataFrame, JaxExecutionEngine
from fugue_tpu.jax import group_ops as jgo
from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import SelectColumns, all_cols, col, lit
from fugue_tpu_torch.column import expressions as texpr
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from fugue_tpu_torch.torch import group_ops as tgo
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

ROOT = Path(__file__).resolve().parent.parent
HOST_VERBS = ("select", "filter", "aggregate", "dropna", "fillna")


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine()
    yield e
    e.stop()


@pytest.fixture(scope="module")
def engine():
    return TorchExecutionEngine(device="cpu")


class _NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


# the two packages' IR and specs, so one case builds both expressions
J = _NS(col=jcol, lit=jlit, ff=jff, x=jexpr, SC=JSelectColumns, PS=JPartitionSpec, all=jall_cols)
T = _NS(col=col, lit=lit, ff=ff, x=texpr, SC=SelectColumns, PS=PartitionSpec, all=all_cols)


def _sorted(pdf: pd.DataFrame) -> pd.DataFrame:
    return pdf.sort_values(list(pdf.columns), na_position="last").reset_index(drop=True)


def _same(got, exp, rtol=None) -> None:
    """The port's frame (on its device) against the JAX engine's: schema,
    arrow types, and rows after sorting by every column."""
    assert isinstance(got, TorchDataFrame), type(got)
    assert got.device == torch.device("cpu")
    assert str(got.schema) == str(exp.schema)
    g, e = got.as_arrow(), exp.as_arrow()
    assert g.schema.types == e.schema.types and g.column_names == e.column_names
    assert g.num_rows == e.num_rows
    gp = _sorted(g.replace_schema_metadata(None).to_pandas())
    ep = _sorted(e.replace_schema_metadata(None).to_pandas())
    if rtol is None:
        pd.testing.assert_frame_equal(gp, ep, check_exact=True)
    else:
        pd.testing.assert_frame_equal(gp, ep, rtol=rtol)


@contextlib.contextmanager
def _spies(host):
    with contextlib.ExitStack() as stack:
        yield {v: stack.enter_context(mock.patch.object(host, v, wraps=getattr(host, v)))
               for v in HOST_VERBS}


def _both(jax_engine, engine, data, jfn, tfn, rtol=None):
    """``jfn(jax_engine, frame)`` and ``tfn(engine, frame)`` over the same
    arrow table; the same host-engine calls on both sides, the same answer
    (or the same exception class). Returns (port result, its host calls)."""
    jdf, tdf = jax_engine.to_df(JArrowDataFrame(data)), engine.to_df(data)
    with _spies(jax_engine._host_engine) as js:
        try:
            exp = jfn(jax_engine, jdf)
        except Exception as e:  # noqa: BLE001 - the port raises as the reference does
            with pytest.raises(Exception) as err:
                tfn(engine, tdf)
            assert type(err.value).__name__ == type(e).__name__
            return None, None
        jcalls = {v: s.call_count for v, s in js.items()}
    with _spies(engine._host_engine) as ts:
        got = tfn(engine, tdf)
        tcalls = {v: s.call_count for v, s in ts.items()}
    assert tcalls == jcalls
    _same(got, exp, rtol=rtol)
    return got, tcalls


def _table(rows, schema: str) -> pa.Table:
    from fugue_tpu_torch.schema import Schema

    s = Schema(schema)
    return pa.Table.from_pylist([dict(zip(s.names, r)) for r in rows], schema=s.pa_schema)


def _mixed(n=600, seed=0) -> pa.Table:
    """A frame of every device encoding: int keys, int32, a nullable int,
    a float with NaN/NULL, float32, bool, a dictionary string with NULLs,
    a date and a timestamp with NULLs."""
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.15
    d = rng.integers(18000, 18800, n).astype(np.int32)
    return pa.table({
        "k": rng.integers(0, 6, n),
        "i": rng.integers(-20, 20, n).astype(np.int32),
        "a": pa.array(rng.integers(-5, 5, n), mask=rng.random(n) < 0.2),
        "f": pa.array(np.where(rng.random(n) < 0.1, np.nan, rng.standard_normal(n) * 3), mask=nulls),
        "g": (rng.standard_normal(n) * 2).astype(np.float32),
        "b": rng.random(n) < 0.5,
        "s": pa.array(rng.choice(["apple", "fig", "pear", "plum"], n).tolist(), mask=rng.random(n) < 0.1),
        "d": pa.array(d, mask=rng.random(n) < 0.1).cast(pa.date32()),
        "t": pa.array(d.astype(np.int64) * 86_400_000_000 + rng.integers(0, 86_400, n) * 1_000_000,
                      pa.int64()).cast(pa.timestamp("us")),
    })


# ---- the cases of fugue_tpu_test/execution_suite.py -------------------------


def test_suite_select(jax_engine, engine):
    data = _table([[1, 10.0], [2, 20.0], [2, 5.0]], "a:long,b:double")

    def sel(M):
        return lambda e, d: e.select(d, M.SC(M.col("a"), (M.col("b") * M.lit(2)).cast(float).alias("bb")))

    got, calls = _both(jax_engine, engine, data, sel(J), sel(T))
    assert got.as_arrow().to_pylist() == [{"a": 1, "bb": 20.0}, {"a": 2, "bb": 40.0}, {"a": 2, "bb": 10.0}]
    assert sum(calls.values()) == 0  # the device projection


def test_suite_filter(jax_engine, engine):
    data = _table([[1, 10.0], [2, None]], "a:long,b:double")
    got, calls = _both(jax_engine, engine, data, lambda e, d: e.filter(d, jcol("b").not_null()),
                       lambda e, d: e.filter(d, col("b").not_null()))
    assert got.as_arrow().to_pylist() == [{"a": 1, "b": 10.0}] and sum(calls.values()) == 0
    assert got.valid_mask is not None and got.count() == 1


def test_suite_assign(jax_engine, engine):
    data = _table([[1, "x"]], "a:long,b:str")

    def asg(M):
        return lambda e, d: e.assign(d, [M.lit(5).alias("c"), (M.col("a") + 1).cast("long").alias("a")])

    got, _ = _both(jax_engine, engine, data, asg(J), asg(T))
    assert str(got.schema) == "a:long,b:str,c:long"
    assert got.as_arrow().to_pylist() == [{"a": 2, "b": "x", "c": 5}]


def test_suite_aggregate(jax_engine, engine):
    data = _table([[1, 10.0], [1, 20.0], [2, 5.0]], "a:long,b:double")

    def agg(M):
        return lambda e, d: e.aggregate(d, M.PS(by=["a"]), [M.ff.sum(M.col("b")).alias("s"),
                                                          M.ff.count(M.col("b")).alias("n")])

    got, calls = _both(jax_engine, engine, data, agg(J), agg(T), rtol=1e-5)
    assert sum(calls.values()) == 0


def test_suite_aggregate_no_keys(jax_engine, engine):
    data = _table([[1, 10.0], [1, 20.0]], "a:long,b:double")
    got, calls = _both(jax_engine, engine, data,
                       lambda e, d: e.aggregate(d, None, [jff.max(jcol("b")).alias("m")]),
                       lambda e, d: e.aggregate(d, None, [ff.max(col("b")).alias("m")]))
    assert got.as_arrow().to_pylist() == [{"m": 20.0}]
    assert calls["aggregate"] == 1 and calls["select"] == 1  # the host engine, as the JAX engine's


@pytest.mark.parametrize("kw", [{}, {"how": "all"}, {"subset": ["a"]}, {"thresh": 1}],
                         ids=["any", "all", "subset", "thresh"])
def test_suite_dropna(jax_engine, engine, kw):
    data = _table([[1, "a"], [None, "b"], [None, None]], "a:double,b:str")
    got, calls = _both(jax_engine, engine, data, lambda e, d: e.dropna(d, **kw),
                       lambda e, d: e.dropna(d, **kw))
    assert got.count() == {"any": 1, "how": 2, "subset": 1, "thresh": 2}[next(iter(kw), "any")]
    assert sum(calls.values()) == 0  # a mask on the device


@pytest.mark.parametrize("case", ["subset", "dict_with_string", "none"])
def test_suite_fillna(jax_engine, engine, case):
    data = _table([[1.0, "a"], [None, None]], "a:double,b:str")
    kw = {"subset": dict(value=0, subset=["a"]), "dict_with_string": dict(value=dict(a=0.0, b="?")),
          "none": dict(value=None)}[case]
    got, calls = _both(jax_engine, engine, data, lambda e, d: e.fillna(d, **kw),
                       lambda e, d: e.fillna(d, **kw))
    if case == "none":
        assert got is None  # both raise
        return
    exp = {"subset": [[1.0, "a"], [0.0, None]], "dict_with_string": [[1.0, "a"], [0.0, "?"]]}[case]
    assert [list(r.values()) for r in got.as_arrow().to_pylist()] == exp
    # the value is checked by the host engine on an empty frame; a fill of
    # an encoded (string) column then goes to the host engine, as in the JAX engine
    assert calls["fillna"] == (2 if case == "dict_with_string" else 1)


def test_suite_select_with_cast(jax_engine, engine):
    data = _table([[1]], "a:long")
    got, calls = _both(jax_engine, engine, data,
                       lambda e, d: e.select(d, JSelectColumns(jcol("a").cast("str").alias("s"))),
                       lambda e, d: e.select(d, SelectColumns(col("a").cast("str").alias("s"))))
    assert got.as_arrow().to_pylist() == [{"s": "1"}] and calls["select"] == 1


def test_suite_persist_broadcast(jax_engine, engine):
    data = _table([[1]], "a:long")
    for verb in ("persist", "broadcast"):
        got, _ = _both(jax_engine, engine, data, lambda e, d: getattr(e, verb)(d),
                       lambda e, d: getattr(e, verb)(d))
        assert got.as_arrow().to_pylist() == [{"a": 1}]
    got, _ = _both(jax_engine, engine, data, lambda e, d: e.repartition(d, JPartitionSpec(num=2)),
                   lambda e, d: e.repartition(d, PartitionSpec(num=2)))
    assert got.as_arrow().to_pylist() == [{"a": 1}]


# ---- tests/jax_engine/test_encoded_columns.py -------------------------------


def test_string_filter_on_device(jax_engine, engine):
    """:115: string predicates through the dictionary's lookup table."""
    data = pa.table({"s": pa.array(["apple", "banana", None, "grape"]), "v": [1.0, 2.0, 3.0, 4.0]})
    for jc, tc in (
        (jcol("s") == "apple", col("s") == "apple"),
        (jexpr._LikeExpr(jcol("s"), "ap%"), texpr._LikeExpr(col("s"), "ap%")),
        (jcol("s").is_null(), col("s").is_null()),
        (jexpr._LikeExpr(jcol("s"), "%p%") & (jcol("v") > 1), texpr._LikeExpr(col("s"), "%p%") & (col("v") > 1)),
        (jexpr._InExpr(jcol("s"), ["grape", "fig"], positive=False), texpr._InExpr(col("s"), ["grape", "fig"], False)),
    ):
        got, calls = _both(jax_engine, engine, data, lambda e, d: e.filter(d, jc), lambda e, d: e.filter(d, tc))
        assert sum(calls.values()) == 0


def test_filter_nullable_int_on_device(jax_engine, engine):
    """:141: NULL semantics of a null-masked int: comparisons, IS_NULL,
    COALESCE, Kleene OR."""
    data = pa.table({"a": pa.array([1, None, 3, 4, None, 6], pa.int64()), "v": np.arange(6, dtype=np.float64)})
    cases = [
        (jcol("a") > 2, col("a") > 2),
        (jcol("a").is_null(), col("a").is_null()),
        (jff.coalesce(jcol("a"), jlit(0)) == 0, ff.coalesce(col("a"), lit(0)) == 0),
        ((jcol("a") >= 3) | jcol("a").is_null(), (col("a") >= 3) | col("a").is_null()),
    ]
    for jc, tc in cases:
        got, calls = _both(jax_engine, engine, data, lambda e, d: e.filter(d, jc), lambda e, d: e.filter(d, tc))
        assert sum(calls.values()) == 0
    assert got.as_pandas()["v"].tolist() == [1.0, 2.0, 3.0, 4.0, 5.0]


def test_aggregate_nullable_int_values(jax_engine, engine):
    data = pa.table({"k": [1, 1, 2, 2, 3], "a": pa.array([10, None, None, None, 5], pa.int32())})

    def agg(M):
        return lambda e, d: e.aggregate(d, M.PS(by=["k"]), [
            M.ff.sum(M.col("a")).alias("s"), M.ff.count(M.col("a")).alias("n"), M.ff.max(M.col("a")).alias("m")])

    _both(jax_engine, engine, data, agg(J), agg(T))


def test_groupby_nullable_int_key(jax_engine, engine):
    data = pa.table({"k": pa.array([1, 1, None, None, 2], pa.int64()), "v": [1.0, 2.0, 3.0, 4.0, 5.0]})

    def agg(M):
        return lambda e, d: e.aggregate(d, M.PS(by=["k"]), [M.ff.sum(M.col("v")).alias("s")])

    _both(jax_engine, engine, data, agg(J), agg(T), rtol=1e-5)


def test_datetime_filter_on_device(jax_engine, engine):
    """:246: date and timestamp literals rewritten to epochs; NULL drops."""
    t = pa.array([datetime.datetime(2020, 1, 1), datetime.datetime(2020, 6, 15), None,
                  datetime.datetime(2021, 2, 2)], pa.timestamp("ns"))
    data = pa.table({"t": t, "v": [1.0, 2.0, 3.0, 4.0]})
    cases = [
        (jcol("t") > "2020-03-01", col("t") > "2020-03-01"),
        ((jcol("t") >= datetime.date(2020, 1, 1)) & (jcol("t") < datetime.datetime(2021, 1, 1)),
         (col("t") >= datetime.date(2020, 1, 1)) & (col("t") < datetime.datetime(2021, 1, 1))),
        (jcol("t").is_null(), col("t").is_null()),
    ]
    for jc, tc in cases:
        got, calls = _both(jax_engine, engine, data, lambda e, d: e.filter(d, jc), lambda e, d: e.filter(d, tc))
        assert sum(calls.values()) == 0


# ---- a matrix of selects over a frame of every encoding ---------------------


def _cases(M) -> Dict[str, Any]:
    c, l, f, x = M.col, M.lit, M.ff, M.x

    def sel(*cols, where=None, having=None, distinct=False):
        return lambda e, d: e.select(d, M.SC(*cols, arg_distinct=distinct), where=where, having=having)

    return {
        "project": sel(c("k"), (c("i") + 1).alias("x"), (c("g") * 2.5).alias("y"), (c("f") / c("i")).alias("z"),
                       (c("b") & (c("k") > 2)).alias("w"), (c("i") / 2).alias("h"), (-c("g")).alias("ng")),
        "project_casts": sel((c("g") * 2).cast("double").alias("x"), c("i").cast("long").alias("y"),
                             c("f").cast("int").alias("z"), c("b").cast("float").alias("w")),
        "passthrough_renames": sel(c("s").alias("s2"), c("d"), c("a"), c("t").alias("when"), c("k")),
        "literals": sel(c("k"), l(1).alias("one"), l(0.1).alias("tenth"), l(True).alias("yes"),
                        (l(3) + l(0.2)).alias("sum"), l(7).cast("int").alias("seven")),
        "coalesce_plain": sel(f.coalesce(c("f"), 0.0).alias("x"), f.coalesce(c("f"), c("g")).alias("y")),
        "coalesce_masked": sel(f.coalesce(c("a"), 0).alias("x")),
        "case_when": sel(x.case_when((c("k") > 2, c("f")), (c("b"), 1), default=c("g")).alias("cw")),
        "string_function": sel(M.x.function("UPPER", c("s")).alias("u"), c("k")),
        "where_project": sel(c("k"), (c("g") * 2).alias("x"), where=(c("f") > 0) & (c("s") == "fig")),
        "where_wildcard": sel(c("*"), where=c("a").not_null() & (c("d") < "2020-06-01")),
        "where_like_host": sel(c("k"), c("s"), where=x._LikeExpr(c("s"), "p%") & (c("s") != "plum")),
        "where_in": sel(c("*"), where=x._InExpr(c("k"), [1, 3])),
        "where_case": sel(c("k"), where=x.case_when((c("i") > 0, c("f")), default=c("g")) > 0),
        "where_kleene": sel(c("k"), c("a"), where=(c("a") > 0) | (c("f") > 1) | ~c("b")),
        "where_false": sel(c("k"), where=l(False)),
        "grouped": sel(c("k"), f.sum(c("f")).alias("sf"), f.avg(c("g")).alias("ag"), f.count(c("*")).alias("n"),
                       f.min(c("i")).alias("lo"), f.max(c("s")).alias("ms")),
        "grouped_where": sel(c("k"), f.sum(c("g")).alias("sg"), f.count(c("a")).alias("na"),
                             where=(c("t") >= "2019-06-01") & c("b")),
        "grouped_having": sel(c("k"), f.sum(c("i")).alias("si"), where=c("g") > -1,
                              having=(f.sum(c("i")) > 0) & (c("k") > 1)),
        "grouped_string_keys": sel(c("s"), c("b"), f.sum(c("i")).alias("si"), f.avg(c("a")).alias("aa")),
        "grouped_timestamp_key": sel(c("t"), f.count(c("*")).alias("n"), f.max(c("f")).alias("mf")),
        "grouped_declared_order": sel(f.count(c("*")).alias("n"), c("k"), f.sum(c("g")).alias("sg")),
        "grouped_expression": sel(c("k"), f.sum(c("i") * c("g")).alias("p"), (f.max(c("f")) - f.min(c("f"))).alias("r")),
        "grouped_expression_key": sel((c("k") * 2).alias("kk"), f.sum(c("g")).alias("sg")),
        "grouped_count_distinct": sel(c("k"), f.count_distinct(c("s")).alias("ds")),
        "grouped_first_last": sel(c("k"), f.first(c("i")).alias("fi")),
        "global": sel(f.sum(c("f") * c("g")).alias("sp"), f.count(c("s")).alias("ns"), f.avg(c("i")).alias("ai"),
                      f.min(c("d")).alias("md"), where=c("k") < 4),
        "distinct": sel(c("k"), c("b"), distinct=True),
        "grouped_distinct": sel(c("k"), f.sum(c("i")).alias("si"), distinct=True),
        "filter_verb": lambda e, d: e.filter(d, (c("a") > 0) & (c("s") >= "fig")),
        "assign_replace_and_add": lambda e, d: e.assign(d, [(c("i") * 2).alias("i"), (c("f") + c("g")).alias("fg")]),
        "assign_string_literal": lambda e, d: e.assign(d, [l("x").alias("tag")]),
        "aggregate_keys": lambda e, d: e.aggregate(d, M.PS(by=["k", "b"]), [f.sum(c("g")).alias("sg"),
                                                                          f.max(c("t")).alias("mt")]),
        "aggregate_no_keys": lambda e, d: e.aggregate(d, None, [f.avg(c("f")).alias("af"), f.count(c("a")).alias("na")]),
        "aggregate_expression": lambda e, d: e.aggregate(d, M.PS(by=["k"]), [(f.sum(c("g")) * 2).alias("s2")]),
        "dropna_any": lambda e, d: e.dropna(d),
        "dropna_subset_thresh": lambda e, d: e.dropna(d, thresh=2, subset=["a", "f", "s", "d"]),
        "dropna_all": lambda e, d: e.dropna(d, how="all", subset=["a", "f"]),
        "fillna_numbers": lambda e, d: e.fillna(d, {"a": 7, "f": -1.5, "g": 0}),
        "fillna_value": lambda e, d: e.fillna(d, 1.7, subset=["a", "f", "i"]),
        "fillna_nan": lambda e, d: e.fillna(d, float("nan"), subset=["f"]),
        "fillna_string": lambda e, d: e.fillna(d, {"s": "none", "a": 0}),
    }


CASES = list(_cases(T))


@pytest.mark.parametrize("case", CASES)
def test_select_matrix(jax_engine, engine, case):
    rtol = 1e-5 if case.startswith(("grouped", "global", "aggregate")) else None
    got, calls = _both(jax_engine, engine, _mixed(), _cases(J)[case], _cases(T)[case], rtol=rtol)
    if got is not None and sum(calls.values()) == 0:
        # a device route: the result's columns are on the device, none on its host
        assert got.host_table is None


def test_project_keeps_the_jax_dtypes_and_the_nan_proof(engine):
    """Computed columns hold JAX's dtypes under the declared schema (an
    int32 column plus a literal stays int32, declared long), and a filled
    float column is NaN-free unless the fill is NaN."""
    tdf = engine.to_df(_mixed())
    res = engine.select(tdf, SelectColumns(col("k"), (col("i") + 1).alias("x"), (col("g") * 2.5).alias("y")))
    assert res.device_cols["x"].dtype == torch.int32 and str(res.schema["x"].type) == "int64"
    assert res.device_cols["y"].dtype == torch.float32 and str(res.schema["y"].type) == "double"
    assert not res.maybe_nan("k") and res.maybe_nan("y")
    filled = engine.fillna(tdf, 0.0, subset=["f"])
    assert not filled.maybe_nan("f") and engine.fillna(tdf, float("nan"), subset=["f"]).maybe_nan("f")
    masked = engine.fillna(tdf, 3, subset=["a"])
    assert "a" not in masked.null_masks and "a" in tdf.null_masks


# ---- the filter's mask in every later verb ----------------------------------


def _pair(body):
    def jax_udf(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        return body(jgo, cols, jnp)

    def torch_udf(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return body(tgo, cols, torch)

    return jax_udf, torch_udf


def _demean(go, cols, xp):
    m = go.mean(cols, cols["v"])
    return {"k": cols["k"], "v": cols["v"], "d": cols["v"] - go.per_row(cols, m)}


def _keyless(go, cols, xp):
    return {"k": cols["k"], "v": cols["v"] * 2 + 1}


def _downstream(M, name):
    c, f = M.col, M.ff
    right = pa.table({"k": np.arange(0, 40, 2, dtype=np.int64), "w": np.arange(20, dtype=np.float64)})
    if name == "dense_aggregate":
        return lambda e, d: e.aggregate(d, M.PS(by=["k"]), [f.sum(c("g")).alias("s"), f.count(c("*")).alias("n")])
    if name == "sorted_groupby":
        return lambda e, d: e.aggregate(d, M.PS(by=["s"]), [f.avg(c("v")).alias("m"), f.max(c("g")).alias("x")])
    if name in ("join_left", "join_right"):
        def run(e, d):
            r = e.to_df(right if M is T else JArrowDataFrame(right))
            return e.join(d, r, how="inner", on=["k"]) if name == "join_left" else e.join(r, d, "left_outer", on=["k"])
        return run
    if name == "union":
        return lambda e, d: e.union(d, d, distinct=False)
    if name in ("map_keyless", "map_dense", "map_sorted"):
        body = _keyless if name == "map_keyless" else _demean
        udf = _pair(body)[0 if M is J else 1]
        part = {"map_keyless": None, "map_dense": {"by": ["k"]}, "map_sorted": {"by": ["k"], "presort": "v"}}[name]
        schema = "k:long,v:double" if name == "map_keyless" else "k:long,v:double,d:double"

        def run(e, d):
            d = e.select(d, M.SC(c("k"), c("v")))
            if M is J:
                return fa.transform(d, udf, schema=schema, partition=part, engine=e, as_fugue=True)
            return api.transform(d, udf, schema=schema, partition=part, engine=e, as_fugue=True)
        return run
    if name == "host_map":
        def pandas_udf(df: pd.DataFrame) -> pd.DataFrame:
            return df.assign(n=len(df))

        def run(e, d):
            d = e.select(d, M.SC(c("k"), c("v")))
            t = fa.transform if M is J else api.transform
            return t(d, pandas_udf, schema="k:long,v:double,n:long", partition={"by": ["k"]}, engine=e, as_fugue=True)
        return run
    if name == "as_arrow":
        return lambda e, d: d
    raise ValueError(name)


DOWNSTREAM = ["dense_aggregate", "sorted_groupby", "join_left", "join_right", "union", "map_keyless",
              "map_dense", "map_sorted", "host_map", "as_arrow"]


@pytest.mark.parametrize("name", DOWNSTREAM)
def test_filters_mask_reaches_every_later_verb(jax_engine, engine, name):
    rng = np.random.default_rng(9)
    n = 3000
    data = pa.table({"k": rng.integers(0, 40, n), "v": rng.random(n), "g": rng.random(n).astype(np.float32),
                     "s": pa.array(rng.choice(["x", "y", "z"], n).tolist())})

    def run(M):
        down = _downstream(M, name)
        return lambda e, d: down(e, e.filter(d, (M.col("v") > 0.3) & (M.col("s") != "y")))

    rtol = 1e-5 if name in ("dense_aggregate", "sorted_groupby", "map_dense", "map_sorted") else None
    _both(jax_engine, engine, data, run(J), run(T), rtol=rtol)


def test_fully_filtered_frame_ops(jax_engine, engine):
    """``test_nested_and_edges.py:107``: a filter that keeps no row, then
    an aggregate, a join, a union, a ``distinct`` and a ``take``, each the
    JAX engine's answer."""
    data = pa.table({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]})
    left = pa.table({"k": [1, 2], "w": [5.0, 6.0]})
    empty = engine.filter(engine.to_df(data), col("v") > lit(100.0))
    assert empty.count() == 0
    jempty = jax_engine.filter(jax_engine.to_df(JArrowDataFrame(data)), jcol("v") > jlit(100.0))
    _same(engine.aggregate(empty, PartitionSpec(by=["k"]), [ff.sum(col("v")).alias("s")]),
          jax_engine.aggregate(jempty, JPartitionSpec(by=["k"]), [jff.sum(jcol("v")).alias("s")]))
    _same(engine.aggregate(empty, None, [ff.sum(col("v")).alias("s")]),
          jax_engine.aggregate(jempty, None, [jff.sum(jcol("v")).alias("s")]))
    for how in ("left_anti", "inner", "left_outer"):
        _same(engine.join(engine.to_df(left), empty, how=how, on=["k"]),
              jax_engine.join(jax_engine.to_df(JArrowDataFrame(left)), jempty, how=how, on=["k"]))
    assert engine.union(empty, empty, distinct=False).count() == 0
    _same(engine.distinct(empty), jax_engine.distinct(jempty))
    _same(engine.take(empty, 5, presort="v"), jax_engine.take(jempty, 5, presort="v"))
    assert engine.distinct(empty).count() == 0 and engine.take(empty, 5, presort="v").count() == 0


def test_aggregate_of_filtered_frame_then_downstream_filter(jax_engine, engine):
    """``test_device_resident_agg.py:80``: the dense aggregate of a
    filtered frame stays on the device and filters again there."""
    pdf = pd.DataFrame({"k": np.arange(100) % 7, "v": np.arange(100, dtype=float)})

    def run(M):
        def go(e, d):
            f = e.filter(d, M.col("v") < 50)
            r = e.aggregate(f, M.PS(by=["k"]), [M.ff.count(M.col("v")).alias("n"), M.ff.sum(M.col("v")).alias("s")])
            assert r.host_table is None
            return e.filter(r, M.col("s") > 100.0)
        return go

    got, calls = _both(jax_engine, engine, pa.Table.from_pandas(pdf, preserve_index=False), run(J), run(T))
    assert sum(calls.values()) == 0
    exp = pdf.query("v<50").groupby("k").agg(n=("v", "count"), s=("v", "sum")).reset_index().query("s>100")
    assert sorted(got.as_pandas()["k"].tolist()) == exp["k"].tolist()


def test_broadcast_preserves_filter_mask(jax_engine, engine):
    """``test_advice_r2.py:63``."""
    data = pa.table({"a": [1, 2, 3, 4, 5, 6, 7, 8]})
    flt = engine.filter(engine.to_df(data), col("a") > lit(4))
    assert flt.valid_mask is not None
    b = api.broadcast(flt, engine=engine)
    assert isinstance(b, TorchDataFrame) and b.valid_mask is flt.valid_mask
    assert sorted(b.as_pandas()["a"].tolist()) == [5, 6, 7, 8] and b.count() == 4
    jb = jax_engine.broadcast(jax_engine.filter(jax_engine.to_df(JArrowDataFrame(data)), jcol("a") > jlit(4)))
    _same(b, jb)


# ---- routing ------------------------------------------------------------------


def test_device_where_moves_no_row(engine):
    """A WHERE the device planner takes is a new validity mask: the frame's
    tensors are the same objects, and a trace of it has no copy to the host."""
    tdf = engine.to_df(_mixed())
    where = (col("f") > 0) & (col("s") == "fig") & (col("d") >= "2019-01-01")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = engine.select(tdf, SelectColumns(col("k"), col("f")), where=where)
    names = {e.key for e in prof.key_averages()}
    assert "fugue::filter" in names and "fugue::project" in names
    assert "fugue::to_host" not in names and "fugue::host_select" not in names
    assert res.device_cols["f"] is tdf.device_cols["f"] and res.valid_mask is not None


def test_host_select_is_traced(engine):
    tdf = engine.to_df(_mixed())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.select(tdf, SelectColumns(ff.sum(col("f")).alias("s")), where=col("k") > 1)
    names = {e.key for e in prof.key_averages()}
    assert {"fugue::filter", "fugue::to_host", "fugue::host_select", "fugue::to_device"} <= names


UINT_CASES = {
    "filter": lambda e, d: e.filter(d, col("u") > 1),
    "select_where": lambda e, d: e.select(d, SelectColumns(col("k")), where=col("u") > 1),
    "project": lambda e, d: e.select(d, SelectColumns(col("k"), (col("u") * 2).alias("x"))),
    "passthrough": lambda e, d: e.select(d, SelectColumns(col("u"))),
    "grouped": lambda e, d: e.select(d, SelectColumns(col("u"), ff.sum(col("v")).alias("s"))),
    "aggregate_value": lambda e, d: e.aggregate(d, PartitionSpec(by=["k"]), [ff.sum(col("u")).alias("s")]),
    "dropna": lambda e, d: e.dropna(d),
    "fillna": lambda e, d: e.fillna(d, 0),
}


JUINT_CASES = {
    "filter": lambda e, d: e.filter(d, jcol("u") > 1),
    "select_where": lambda e, d: e.select(d, JSelectColumns(jcol("k")), where=jcol("u") > 1),
    "project": lambda e, d: e.select(d, JSelectColumns(jcol("k"), (jcol("u") * 2).alias("x"))),
    "passthrough": lambda e, d: e.select(d, JSelectColumns(jcol("u"))),
    "grouped": lambda e, d: e.select(d, JSelectColumns(jcol("u"), jff.sum(jcol("v")).alias("s"))),
    "aggregate_value": lambda e, d: e.aggregate(d, JPartitionSpec(by=["k"]), [jff.sum(jcol("u")).alias("s")]),
    "dropna": lambda e, d: e.dropna(d),
    "fillna": lambda e, d: e.fillna(d, 0),
}


@pytest.mark.parametrize("case", list(UINT_CASES))
@pytest.mark.parametrize("dt", [np.uint16, np.uint32, np.uint64])
def test_unsigned_columns_raise_where_the_reference_runs_on_its_device(jax_engine, engine, case, dt):
    """Named for the refusal it pinned before the unsigned types above
    uint8 lived on the port's device: both engines run the verb on their
    device (the same host-engine calls: none but fillna's check), with the same answer, values
    at the type's top included (a doubled value and a SUM wrap in the
    type, as JAX computes them). Exact."""
    top = int(np.iinfo(dt).max)
    data = pa.table({"k": [1, 2, 1, 2], "u": pa.array(np.array([1, 2, top, top - 1], dt)),
                     "v": [1.0, 2.0, 3.0, 4.0]})
    jdf = jax_engine.to_df(JArrowDataFrame(data))
    assert jdf.host_table is None and "u" in jdf.device_cols
    got, calls = _both(jax_engine, engine, data, JUINT_CASES[case], UINT_CASES[case])
    # fillna checks its value on both engines by a host call over no rows
    assert sum(calls.values()) == (1 if case == "fillna" else 0)


def test_unsigned_columns_on_the_host_route_answer(jax_engine, engine):
    """Where the JAX engine's own plan goes to its host (a global aggregate,
    a projection it cannot evaluate), the port's host answers the same."""
    data = pa.table({"k": [1, 2, 1], "u": pa.array([1, 2, 3], pa.uint16()), "v": [1.0, 2.0, 3.0]})
    _both(jax_engine, engine, data, lambda e, d: e.aggregate(d, None, [jff.sum(jcol("u")).alias("s")]),
          lambda e, d: e.aggregate(d, None, [ff.sum(col("u")).alias("s")]))
    _both(jax_engine, engine, data,
          lambda e, d: e.select(d, JSelectColumns(jcol("u").cast("str").alias("x"))),
          lambda e, d: e.select(d, SelectColumns(col("u").cast("str").alias("x"))))


# ---- the API ------------------------------------------------------------------


def test_api_verbs(jax_engine, engine):
    pdf = _mixed().to_pandas()
    got = api.select(pdf, "k", (col("g") * 2).alias("x"), where=col("b"), engine=engine)
    exp = fa.select(pdf, "k", (jcol("g") * 2).alias("x"), where=jcol("b"), engine=jax_engine, as_fugue=True)
    assert isinstance(got, pd.DataFrame)
    pd.testing.assert_frame_equal(_sorted(got), _sorted(exp.as_pandas()))
    got = api.select(pdf, "k", ff.sum(col("i")).alias("si"), having=ff.sum(col("i")) > 0, engine=engine,
                     as_fugue=True)
    exp = fa.select(pdf, "k", jff.sum(jcol("i")).alias("si"), having=jff.sum(jcol("i")) > 0, engine=jax_engine,
                    as_fugue=True)
    _same(got, exp)
    _same(api.select(pdf, "k", "b", distinct=True, engine=engine, as_fugue=True),
          fa.select(pdf, "k", "b", distinct=True, engine=jax_engine, as_fugue=True))
    _same(api.filter(pdf, col("s") == "fig", engine=engine, as_fugue=True),
          fa.filter(pdf, jcol("s") == "fig", engine=jax_engine, as_fugue=True))
    _same(api.assign(pdf, engine=engine, as_fugue=True, x=col("i") * 3, c=1),
          fa.assign(pdf, engine=jax_engine, as_fugue=True, x=jcol("i") * 3, c=1))
    _same(api.aggregate(pdf, engine=engine, as_fugue=True, s=ff.sum(col("g")), r=ff.max(col("i")) - ff.min(col("i"))),
          fa.aggregate(pdf, engine=jax_engine, as_fugue=True, s=jff.sum(jcol("g")), r=jff.max(jcol("i")) - jff.min(jcol("i"))),
          rtol=1e-5)
    _same(api.dropna(pdf, how="all", subset=["a", "f"], engine=engine, as_fugue=True),
          fa.dropna(pdf, how="all", subset=["a", "f"], engine=jax_engine, as_fugue=True))
    _same(api.fillna(pdf, 0, subset=["f"], engine=engine, as_fugue=True),
          fa.fillna(pdf, 0, subset=["f"], engine=jax_engine, as_fugue=True))
    _same(api.broadcast(pdf, engine=engine, as_fugue=True), fa.broadcast(pdf, engine=jax_engine, as_fugue=True))
    _same(api.persist(pdf, engine=engine, as_fugue=True), fa.persist(pdf, engine=jax_engine, as_fugue=True))
    out = api.filter(pa.Table.from_pandas(pdf, preserve_index=False), col("k") > 2, device="cpu")
    assert isinstance(out, pa.Table)


# ---- chip_smoke.py's select_path cells, at small size -------------------------


def test_select_path_cells_match_the_jax_engine(jax_engine, engine):
    """The three cells of the smoke's select_path against the JAX engine,
    each written with the JAX package's API on the same lineitem frame."""
    tbl, aux = chip_smoke.make_lineitem(np, pa, 0, 3000)
    tdf = engine.to_df(tbl)
    jdf = jax_engine.to_df(JArrowDataFrame(tbl))
    tcells = chip_smoke.select_path_cells(api, ff, col, engine)
    jcells = chip_smoke.select_path_cells(fa, jff, jcol, jax_engine)
    oracles = chip_smoke.select_path_oracles(np, pd, tbl, aux)
    for name, (tfn, _, keys, _) in tcells.items():
        got, exp = tfn(tdf), jcells[name][0](jdf)
        # float32 averages: the port sums float32 in float64, the JAX package in float32
        _same(got, exp, rtol=1e-9 if name == "q6-select" else 1e-5)
        if name != "q6-select":
            chip_smoke.check_lineitem(np, got.as_pandas(), oracles[name], keys, name)


def test_select_path_oracles_reject_wrong_answers(engine):
    """Q6's oracle compares l_discount in float32, as both engines do: a
    float64 comparison drops the rows at 0.07 (float32(0.07) > 0.07), and
    its revenue is outside the check's tolerance. A wrong count fails Q1."""
    tbl, aux = chip_smoke.make_lineitem(np, pa, 0, 3000)
    oracles = chip_smoke.select_path_oracles(np, pd, tbl, aux)
    d = tbl.column("l_discount").to_numpy()
    assert (d == np.float32(0.07)).any() and float(np.float32(0.07)) > 0.07
    ship, q = tbl.column("l_shipdate").to_numpy(), tbl.column("l_quantity").to_numpy()
    p = tbl.column("l_extendedprice").to_numpy()
    m64 = ((ship >= np.datetime64("1994-01-01")) & (ship < np.datetime64("1995-01-01"))
           & (d.astype(np.float64) >= 0.05) & (d.astype(np.float64) <= 0.07) & (q < 24))
    wrong = (p[m64] * d[m64]).sum()
    assert not np.isclose(wrong, oracles["q6-select"]["revenue"][0], rtol=chip_smoke.Q6_RTOL, atol=0)
    got = chip_smoke.select_path_cells(api, ff, col, engine)["q6-select"][0](engine.to_df(tbl)).as_pandas()
    assert np.isclose(got["revenue"][0], oracles["q6-select"]["revenue"][0], rtol=chip_smoke.Q6_RTOL, atol=0)
    q1 = oracles["q1-select"].copy()
    q1.loc[0, "count_order"] += 1
    tcells = chip_smoke.select_path_cells(api, ff, col, engine)
    res = tcells["q1-select"][0](engine.to_df(tbl)).as_pandas()
    with pytest.raises(RuntimeError):
        chip_smoke.check_lineitem(np, res, q1, ["l_returnflag", "l_linestatus"], "q1-select")


_SELECT_PATH_ON_THE_CPU = """
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
out = chip_smoke.phase_select_path(torch, np, bg, api, ff, col, engine, engine.persist(engine.to_df(tbl)),
                                   oracles)
print("RESULT", json.dumps({c: {k: v for k, v in l.items() if "profile" not in k}
                            for c, l in out["cells"].items()}))
"""


def test_chip_smoke_select_path_on_the_cpu():
    """The three cells at ~64k rows, each through its oracle, one line each,
    in a process that loads no JAX; B1 is not launched on the CPU."""
    res = subprocess.run([sys.executable, "-c", _SELECT_PATH_ON_THE_CPU], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith('{"phase": "select_path"')]
    assert [ln["cell"] for ln in lines] == ["q1-select", "q6-select", "shipmode-where"]
    for ln in lines:
        assert ln["launches"] == {"bin_sum": 0, "bin_sum_count": 0}
        assert ln["bound_ms"] > 0 and ln["ms"] > 0 and "fugue::filter" in ln["filter_profile"]["host_spans_ms"]
    assert "fugue::to_host" not in lines[0]["profile"]["host_spans_ms"]
    assert "fugue::host_select" in lines[1]["profile"]["host_spans_ms"]
    assert "project_profile" in lines[0]
    assert "jax" not in res.stdout


# ---- a differential over edge frames ------------------------------------------


def _edge_keys(n: int, rng) -> Dict[str, pa.Array]:
    return {
        "int": pa.array(rng.integers(0, 3, n)),
        "int_null": pa.array(rng.integers(0, 3, n), mask=rng.random(n) < 0.3),
        "all_null": pa.array([None] * n, pa.int64()),
        "float_nan": pa.array(np.where(rng.random(n) < 0.3, np.nan, rng.integers(0, 3, n).astype(float))),
        "bool": pa.array(rng.random(n) < 0.5),
        "bool_null": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.3),
        "date": pa.array(rng.integers(18000, 18003, n).astype(np.int32)).cast(pa.date32()),
        "timestamp": pa.array(rng.integers(0, 3, n) * 10**6, pa.int64()).cast(pa.timestamp("us")),
        "string_null": pa.array(rng.choice(["a", "b"], n).tolist(), mask=rng.random(n) < 0.3),
    }


def _edge_runs(M) -> Dict[str, Any]:
    c, f = M.col, M.ff

    def demean(df: pd.DataFrame) -> pd.DataFrame:
        return df.assign(v=df["v"] - df["v"].mean())

    transform = fa.transform if M is J else api.transform
    return {
        "aggregate": lambda e, d: e.aggregate(d, M.PS(by=["k"]), [
            f.sum(c("v")).alias("s"), f.count(c("w")).alias("n"), f.avg(c("x")).alias("m"),
            f.min(c("w")).alias("lo"), f.max(c("v")).alias("hi"), f.count(c("*")).alias("c")]),
        "aggregate_no_keys": lambda e, d: e.aggregate(d, None, [
            f.sum(c("v")).alias("s"), f.min(c("k")).alias("mk"), f.count(c("k")).alias("n")]),
        "min_max_of_the_key": lambda e, d: e.aggregate(d, M.PS(by=["w"]), [
            f.min(c("k")).alias("mk"), f.max(c("k")).alias("xk")]),
        "host_transform": lambda e, d: transform(d, demean, schema="*", partition={"by": ["k"]}, engine=e,
                                                 as_fugue=True),
        "filter": lambda e, d: e.filter(d, c("k").not_null() & (c("v") > 0.5)),
        "dropna": lambda e, d: e.dropna(d),
    }


@pytest.mark.parametrize("kind", list(_edge_keys(0, np.random.default_rng(0))))
def test_edge_frame_differential(jax_engine, engine, kind):
    """Aggregates, a host transform, a filter and dropna by a key of each
    kind (NULLs, NaN, bool, date, timestamp, strings) over frames of 0, 1,
    7 and 50 rows: the JAX engine's answer. Where the JAX engine raises,
    a fault of the reference (ROADMAP.md C3: a date key; C9: MIN/MAX over
    bool), the port gives the host engine's answer."""
    from fugue_tpu_torch.execution.native_execution_engine import NativeExecutionEngine

    rng = np.random.default_rng(1)
    native = NativeExecutionEngine()
    for n in (0, 1, 7, 50):
        data = pa.table({"k": _edge_keys(n, rng)[kind],
                         "v": pa.array(np.where(rng.random(n) < 0.2, np.nan, rng.random(n))),
                         "w": pa.array(rng.integers(-5, 5, n), mask=rng.random(n) < 0.2),
                         "x": pa.array(rng.random(n).astype(np.float32))})
        for name, tfn in _edge_runs(T).items():
            jfn = _edge_runs(J)[name]
            try:
                exp = jfn(jax_engine, jax_engine.to_df(JArrowDataFrame(data)))
            except Exception:  # noqa: BLE001 - a fault of the reference
                assert (kind, name) in (("date", "aggregate"), ("bool", "min_max_of_the_key"),
                                        ("bool_null", "min_max_of_the_key")), (kind, name, n)
                got = tfn(engine, engine.to_df(data))
                want = tfn(native, native.to_df(data))
                assert str(got.schema) == str(want.schema)
                g, w = (_sorted(x.as_arrow().replace_schema_metadata(None).to_pandas()) for x in (got, want))
                pd.testing.assert_frame_equal(g, w, rtol=1e-5)
                continue
            _same(tfn(engine, engine.to_df(data)), exp, rtol=1e-5)


def test_global_count_star_raises_in_both(jax_engine, engine):
    """ROADMAP.md C10, a fault of the reference the port carries: COUNT(*)
    with no keys goes to the host evaluator, whose ``eval_agg`` evaluates
    the column ``*`` (``fugue_tpu/column/eval.py:210``) and raises
    ``KeyError``; ``column/eval.py`` is copied as it is. COUNT(1) answers."""
    data = pa.table({"k": [1, 2, 2], "v": [1.0, None, 3.0]})
    got, _ = _both(jax_engine, engine, data, lambda e, d: e.aggregate(d, None, [jff.count(jcol("*")).alias("n")]),
                   lambda e, d: e.aggregate(d, None, [ff.count(col("*")).alias("n")]))
    assert got is None
    with pytest.raises(KeyError):
        engine.aggregate(engine.to_df(data), None, [ff.count(col("*")).alias("n")])
    got, _ = _both(jax_engine, engine, data, lambda e, d: e.aggregate(d, None, [jff.count(jlit(1)).alias("n")]),
                   lambda e, d: e.aggregate(d, None, [ff.count(lit(1)).alias("n")]))
    assert got.as_arrow().to_pylist() == [{"n": 3}]
