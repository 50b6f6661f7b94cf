"""The port's workflow (``fugue_tpu_torch.workflow``) against the JAX
package's, case by case.

``fugue_tpu_test/builtin_suite.py`` cannot be subclassed for the port: it
imports ``fugue_tpu``'s ``FugueWorkflow``, frames and ``PartitionSpec``,
and the port's engine takes only its own objects (ROADMAP.md A.8's note).
So each case the slice covers is written once over a namespace of either
package's classes, built as a DAG of that package, run on
``JaxExecutionEngine`` (the 8-device CPU mesh) and on the port's
``TorchExecutionEngine(device="cpu")`` and ``NativeExecutionEngine``, and
its yields compared: rows exact, floats within 1e-5 relative (the
reference comparator's 5 digits). The DAGs' own ``assert_eq`` tasks run
on each side too.

Zip and cotransform cases answer as the reference's; callbacks and the
conf keys of the workflow services the port lacks raise, naming ROADMAP.md
A.10. Then what the port adds: concurrent task threads,
the run-scoped conf, ``@module`` and the extension registry.
"""

import os
from types import SimpleNamespace
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import fugue_tpu
import fugue_tpu.api as fa
import fugue_tpu.column as jcolumn
import fugue_tpu.exceptions as jexc
import fugue_tpu.extensions as jext
import fugue_tpu.plugins as jplugins
from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.dataframe import LocalDataFrame as JLocalDataFrame
from fugue_tpu.jax import JaxExecutionEngine
import fugue_tpu_torch.column as tcolumn
import fugue_tpu_torch.exceptions as texc
import fugue_tpu_torch.extensions as text
from fugue_tpu_torch import api
from fugue_tpu_torch import dataframe as tdf
from fugue_tpu_torch import workflow as twf
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.execution import ExecutionEngine, NativeExecutionEngine
from fugue_tpu_torch.torch import TorchExecutionEngine

from test_torch_sql import _rows, _same
from torch_dist_common import PORT as PORT_SIDE
from torch_dist_common import REF as REF_SIDE
from torch_dist_common import dist_section

REF = SimpleNamespace(
    FugueWorkflow=fugue_tpu.FugueWorkflow, Transformer=fugue_tpu.Transformer,
    ArrayDataFrame=fugue_tpu.ArrayDataFrame, DataFrame=fugue_tpu.DataFrame, DataFrames=fugue_tpu.DataFrames,
    LocalDataFrame=JLocalDataFrame, PandasDataFrame=fugue_tpu.PandasDataFrame, PartitionSpec=JPartitionSpec,
    col=jcolumn.col, lit=jcolumn.lit, ff=jcolumn.functions, exc=jexc,
    ExecutionEngine=fugue_tpu.execution.ExecutionEngine,
)
PORT = SimpleNamespace(
    FugueWorkflow=twf.FugueWorkflow, Transformer=text.Transformer,
    ArrayDataFrame=tdf.ArrayDataFrame, DataFrame=tdf.DataFrame, DataFrames=tdf.DataFrames,
    LocalDataFrame=tdf.LocalDataFrame, PandasDataFrame=tdf.PandasDataFrame, PartitionSpec=PartitionSpec,
    col=tcolumn.col, lit=tcolumn.lit, ff=tcolumn.functions, exc=texc, ExecutionEngine=ExecutionEngine,
)


# the JAX package's result cache (fugue_tpu/cache) would serve a DAG it ran
# before without running its tasks; the port has none (ROADMAP.md A.10)
REF_CONF = {"fugue.tpu.cache.enabled": False}


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine(REF_CONF)
    yield e
    e.stop()


@pytest.fixture(params=["device", "native"])
def port_engine(request):
    return TorchExecutionEngine(device="cpu") if request.param == "device" else NativeExecutionEngine()


def _run(case, ns, engine, tmpdir: str) -> Dict[str, Any]:
    dag = ns.FugueWorkflow()
    outs = case(ns, dag, tmpdir) or {}
    for name, wdf in outs.items():
        wdf.yield_dataframe_as(name, as_local=True)
    dag.run(engine)
    return {n: dag.yields[n].result for n in outs}


def _check(case, jax_engine, port_engine, tmp_path, ordered: bool = False) -> None:
    ref = _run(case, REF, jax_engine, str(tmp_path / "ref"))
    got = _run(case, PORT, port_engine, str(tmp_path / "port"))
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert str(got[name].schema) == str(ref[name].schema), name
        _same(got[name], ref[name], ordered=ordered)


def _string_ref_transformer(df: pd.DataFrame) -> pd.DataFrame:
    return df


# ---- the cases, each written once over either package (``ns``) ---------------------


def case_create_process_output(ns, dag, tmpdir):
    def double(df: pd.DataFrame) -> pd.DataFrame:
        df["a"] = df["a"] * 2
        return df

    collected: List[Any] = []

    def sink(df: pd.DataFrame) -> None:
        collected.append(df["a"].tolist())

    a = dag.df([[1], [2]], "a:long")
    a.show()
    b = dag.process(a, using=double, schema="a:long")
    dag.output(b, using=sink)
    b.assert_eq(dag.df([[2], [4]], "a:long"))
    return {"b": b}


def case_creator_interfaceless(ns, dag, tmpdir):
    def make() -> pd.DataFrame:
        return pd.DataFrame({"a": [1, 2]})

    # schema: a:long
    def make2() -> List[List[Any]]:
        return [[5]]

    def make3(e: ns.ExecutionEngine) -> pd.DataFrame:
        # one device against the JAX engine's 8: the parallelism differs
        return pd.DataFrame({"a": [int(e.get_current_parallelism() >= 1)]})

    x, y = dag.create(make), dag.create(make2)
    x.assert_eq(dag.df([[1], [2]], "a:long"))
    y.assert_eq(dag.df([[5]], "a:long"))
    return {"x": x, "y": y, "z": dag.create(make3)}


def case_transform_annotation_forms(ns, dag, tmpdir):
    def f_pandas(df: pd.DataFrame) -> pd.DataFrame:
        return df

    def f_arrow(df: pa.Table) -> pa.Table:
        return df

    def f_iter_list(rows: Iterable[List[Any]]) -> Iterable[List[Any]]:
        for r in rows:
            yield r

    def f_list_dict(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return rows

    def f_ldf(df: ns.LocalDataFrame) -> ns.LocalDataFrame:
        return df

    def chunks(dfs: Iterable[pd.DataFrame]) -> Iterable[pd.DataFrame]:
        for c in dfs:
            yield c

    src = dag.df([[1, "a"], [2, "b"]], "a:long,b:str")
    out = {}
    for fn in [f_pandas, f_arrow, f_ldf, f_iter_list, f_list_dict, chunks]:
        out[fn.__name__] = src.transform(fn, schema="*")
        out[fn.__name__].assert_eq(src)
    return out


def case_transform_schema_expressions(ns, dag, tmpdir):
    def with_col(df: pd.DataFrame) -> pd.DataFrame:
        df["c"] = 1
        return df

    def drop_col(rows: Iterable[List[Any]]) -> Iterable[List[Any]]:
        for r in rows:
            yield r[:-1]

    # schema: a:long,n:long
    def counter(df: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"a": [df["a"].iloc[0]], "n": [len(df)]})

    src = dag.df([[1, "a"]], "a:long,b:str")
    keyed = dag.df([[1], [1], [2]], "a:long")
    return {"with": src.transform(with_col, schema="*,c:long"), "drop": src.transform(drop_col, schema="*,-b"),
            "comment": keyed.partition_by("a").transform(counter)}


def case_transform_by_string_name(ns, dag, tmpdir):
    src = dag.df([[1]], "a:long")
    res = src.transform("_string_ref_transformer", schema="a:long")
    res.assert_eq(src)
    return {"res": res}


def case_transformer_class(ns, dag, tmpdir):
    class MyTransformer(ns.Transformer):
        def get_output_schema(self, df):
            return df.schema + "n:long"

        def transform(self, df):
            rows = [r + [len(r)] for r in df.as_array()]
            return ns.ArrayDataFrame(rows, self.output_schema)

    class _Mock:
        # schema: *
        def t1(self, df: pd.DataFrame) -> pd.DataFrame:
            return df

        def t2(self, df: pd.DataFrame) -> pd.DataFrame:
            return df

    m = _Mock()
    a = dag.df([[0], [1]], "a:int")
    b = a.transform(m.t1).transform(m.t2, schema="*")
    b.assert_eq(a)
    return {"cls": dag.df([[1, "a"]], "a:long,b:str").transform(MyTransformer), "methods": b}


def case_transform_ignore_errors_per_row(ns, dag, tmpdir):
    def fail_on_2(df: pd.DataFrame) -> pd.DataFrame:
        if df["a"].iloc[0] == 2:
            raise NotImplementedError("boom")
        return df

    def f(df: pd.DataFrame, cb: Any = None) -> pd.DataFrame:
        return df

    src = dag.df([[1], [2], [3]], "a:long")
    return {
        "ignored": src.partition_by("a").transform(fail_on_2, schema="*", ignore_errors=[NotImplementedError]),
        "params": src.transform(f, schema="*", params={"cb": None}),
    }


def case_relational_ops(ns, dag, tmpdir):
    a = dag.df([[1, "a"], [2, "b"], [2, "b"]], "x:long,y:str")
    b = dag.df([[2, "b"]], "x:long,y:str")
    return {
        "distinct": a.distinct(), "drop": a.drop(["y"]), "rename": a.rename({"x": "xx"}),
        "alter": a.alter_columns("x:double"), "cols": a[["y"]], "union_all": a.union(b, distinct=False),
        "union": a.union(b), "subtract": a.subtract(b), "intersect": a.intersect(b),
        "inner": a.inner_join(dag.df([[1, 5.0]], "x:long,z:double")),
        "left": a.left_outer_join(dag.df([[1, 5.0]], "x:long,z:double")),
        "semi": a.semi_join(b), "anti": a.anti_join(b),
        "take": a.take(1, presort="y desc"),
        "take_by": a.partition_by("x").take(1, presort="y"),
    }


def case_dropna_fillna_sample(ns, dag, tmpdir):
    a = dag.df([[1.0, "a"], [None, None]], "x:double,y:str")
    s = dag.df([[i] for i in range(50)], "x:long").sample(n=5, seed=0)
    return {"dropna": a.dropna(), "fillna": a.fillna(0.0, subset=["x"]), "fill_all": a.fillna({"x": 2.0, "y": "z"}),
            "n": s.select(ns.ff.count(ns.col("x")).alias("n"))}


def case_yields_and_save_load(ns, dag, tmpdir):
    path = os.path.join(tmpdir, "wf.parquet")
    os.makedirs(tmpdir, exist_ok=True)
    a = dag.df([[1, "a"]], "a:long,b:str")
    a.save(path)
    used = a.save_and_use(os.path.join(tmpdir, "used.parquet"))
    return {"used": used}


def case_datetime(ns, dag, tmpdir):
    import datetime

    # schema: a:date,b:datetime
    def t1(df: pd.DataFrame) -> pd.DataFrame:
        df["b"] = "2020-01-02"
        df["b"] = pd.to_datetime(df["b"])
        return df

    class T2(ns.Transformer):
        def get_output_schema(self, df):
            return df.schema

        def transform(self, df):
            return ns.PandasDataFrame(df.as_pandas())

    a = dag.df([["2020-01-01"]], "a:date").transform(t1)
    b = dag.df([[datetime.date(2020, 1, 1), datetime.datetime(2020, 1, 2)]], "a:date,b:datetime")
    b.assert_eq(a)
    c = dag.df([["2020-01-01", "2020-01-01 00:00:00"]], "a:date,b:datetime")
    return {"a": a, "c": c.transform(T2), "cp": c.partition(by=["a"]).transform(T2)}


def case_df_select_filter_assign(ns, dag, tmpdir):
    col, lit, ff = ns.col, ns.lit, ns.ff
    a = dag.df([[1, 10], [2, 20], [3, 30]], "x:long,y:long")
    c = dag.df([[1, 10], [2, 20], [1, 10]], "x:long,y:long")
    e = dag.df([[1, 10], [1, 20], [3, 35], [3, 40]], "x:long,y:long")
    return {
        "star": a.select("*"),
        "computed": a.select("*", (col("x") + col("y")).cast("int64").alias("c"), lit("x", "d")),
        "distinct": c.select("*", distinct=True),
        "agg": e.select("x", ff.sum(col("y")).alias("z").cast("int64"), where=col("y") < 40,
                        having=ff.sum(col("y")) > 30),
        "filter": a.filter((col("y") > 15) & (col("y") < 25)),
        "assign": a.assign(y="x"),
        "assign2": a.assign(lit("x").alias("y"), z=(col("y") + 1).cast(float)),
        "aggregate": e.partition_by("x").aggregate(s=ff.sum(col("y")), n=ff.count(col("y"))),
    }


def case_col_ops(ns, dag, tmpdir):
    a = dag.df([[1, 10, "x"]], "a:long,b:long,c:str")
    return {"rename": a.rename({"a": "aa"}), "drop": a.drop(["c"]), "drop_if": a.drop(["c", "nope"], if_exists=True),
            "cols": a[["b", "c"]], "alter": a.alter_columns("b:str")}


def case_sql_select(ns, dag, tmpdir):
    a = dag.df([[1, 10], [2, 20], [1, 30]], "k:long,v:long")
    b = dag.df([[1, "one"]], "k:long,n:str")
    return {"sql": dag.select("SELECT a.k, SUM(v) AS s, n FROM ", a, " AS a INNER JOIN ", b,
                              " AS b ON a.k = b.k GROUP BY a.k, n")}


CASES = [
    case_create_process_output, case_creator_interfaceless, case_transform_annotation_forms,
    case_transform_schema_expressions, case_transform_by_string_name, case_transformer_class,
    case_transform_ignore_errors_per_row, case_relational_ops, case_dropna_fillna_sample,
    case_yields_and_save_load, case_datetime, case_df_select_filter_assign, case_col_ops, case_sql_select,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_builtin_cases(case, jax_engine, port_engine, tmp_path):
    _check(case, jax_engine, port_engine, tmp_path)


def test_assert_eq_fails_on_both(jax_engine, port_engine):
    for ns, engine in ((REF, jax_engine), (PORT, port_engine)):
        dag = ns.FugueWorkflow()
        dag.df([[0]], "a:long").assert_eq(dag.df([[1]], "a:long"))
        with pytest.raises(AssertionError):
            dag.run(engine)
        dag = ns.FugueWorkflow()
        dag.df([[0]], "a:long").assert_not_eq(dag.df([[1]], "a:long"))
        dag.run(engine)


def test_errors_on_both(jax_engine, port_engine):
    """A failing transformer, a partition rule and an input rule raise the
    same error classes on both packages."""

    def fail_on_2(df: pd.DataFrame) -> pd.DataFrame:
        if df["a"].iloc[0] == 2:
            raise NotImplementedError("boom")
        return df

    # partitionby_has: a
    def need_a(df: pd.DataFrame) -> pd.DataFrame:
        return df

    # input_has: a
    def need_col(df: pd.DataFrame) -> pd.DataFrame:
        return df

    for ns, engine in ((REF, jax_engine), (PORT, port_engine)):
        dag = ns.FugueWorkflow()
        dag.df([[2]], "a:long").partition_by("a").transform(fail_on_2, schema="*").show()
        with pytest.raises(NotImplementedError):
            dag.run(engine)
        dag = ns.FugueWorkflow()
        dag.df([[1, 2]], "a:long,b:long").partition_by("a").transform(need_a, schema="*")
        with pytest.raises(ns.exc.FugueWorkflowCompileValidationError):
            dag.df([[1, 2]], "a:long,b:long").partition_by("b").transform(need_a, schema="*")
        dag.run(engine)
        dag = ns.FugueWorkflow()
        dag.df([[1]], "x:long").transform(need_col, schema="*")
        with pytest.raises(ns.exc.FugueWorkflowRuntimeValidationError):
            dag.run(engine)


def test_out_transform_and_single_op_api(jax_engine, port_engine):
    counts: Dict[str, List[int]] = {"ref": [], "port": []}

    def sink(side):
        def f(df: pd.DataFrame) -> None:
            counts[side].append(len(df))

        return f

    for side, ns, engine in (("ref", REF, jax_engine), ("port", PORT, port_engine)):
        dag = ns.FugueWorkflow()
        dag.df([[1], [1], [2]], "a:long").partition_by("a").out_transform(sink(side))
        dag.run(engine)
    assert sorted(counts["port"]) == sorted(counts["ref"]) == [1, 2]

    def f(df: pd.DataFrame) -> pd.DataFrame:
        df["b"] = 1
        return df

    exp = fa.transform(pd.DataFrame({"a": [1, 2]}), f, schema="*,b:long", engine=jax_engine)
    res = api.transform(pd.DataFrame({"a": [1, 2]}), f, schema="*,b:long", engine=port_engine)
    assert res.values.tolist() == exp.values.tolist() == [[1, 1], [2, 1]]


def test_create_df_equivalence(port_engine):
    ndf = port_engine.to_df(pd.DataFrame([[0]], columns=["a"]))
    dag1, dag2 = twf.FugueWorkflow(), twf.FugueWorkflow()
    dag1.df(ndf).show()
    dag2.create(ndf).show()
    assert dag1.spec_uuid() == dag2.spec_uuid()
    dag1.run(port_engine)
    dag2.run(port_engine)


def test_workflows_and_yields(jax_engine, port_engine, tmp_path):
    """Two DAGs on one engine; a yielded file read by a second DAG."""
    for side, ns, engine in (("ref", REF, jax_engine), ("port", PORT, port_engine)):
        a, b = ns.FugueWorkflow(), ns.FugueWorkflow()
        a.df([[0]], "a:long").yield_dataframe_as("x", as_local=True)
        b.df([[1]], "a:long").yield_dataframe_as("x", as_local=True)
        assert a.run(engine).yields["x"].result.as_array() == [[0]]
        assert b.run(engine).yields["x"].result.as_array() == [[1]]
        dag = ns.FugueWorkflow({"fugue.workflow.checkpoint.path": str(tmp_path / side)})
        dag.df([[1]], "a:long").yield_file_as("x")
        res = dag.run(engine)
        dag2 = ns.FugueWorkflow()
        dag2.df(res.yields["x"]).assert_eq(dag2.df([[1]], "a:long"))
        dag2.run(engine)


def test_checkpoints(port_engine, tmp_path):
    """The five checkpoint cases of builtin_suite.py, on the port."""
    dag = twf.FugueWorkflow()
    dag.df([[0]], "a:long").checkpoint()
    with pytest.raises(texc.FugueWorkflowError):
        dag.run(port_engine)

    conf = {"fugue.workflow.checkpoint.path": str(tmp_path / "ck")}
    dag = twf.FugueWorkflow(conf)
    a = dag.df([[0]], "a:long").checkpoint()
    dag.df([[0]], "a:long").assert_eq(a)
    dag.run(port_engine)

    temp_file = str(tmp_path / "t.parquet")

    def mock_create(dummy: int = 1) -> pd.DataFrame:
        return pd.DataFrame(np.random.rand(3, 2), columns=["a", "b"])

    dag = twf.FugueWorkflow(conf)
    dag.create(mock_create).strong_checkpoint().save(temp_file)
    dag.run(port_engine)
    dag = twf.FugueWorkflow(conf)
    a = dag.create(mock_create).strong_checkpoint()
    dag.load(temp_file).assert_not_eq(a)
    dag.run(port_engine)
    ids = []
    for spec, params, same in ((None, None, None), (None, None, True), (PartitionSpec(num=2), None, True),
                               (None, {"dummy": 2}, False)):
        dag = twf.FugueWorkflow(conf)
        a = dag.create(mock_create, params=params).deterministic_checkpoint(partition=spec)
        ids.append(a.spec_uuid())
        if same is None:
            a.save(temp_file)
        elif same:
            dag.load(temp_file).assert_eq(a)
        else:
            dag.load(temp_file).assert_not_eq(a)
        dag.run(port_engine)
    assert ids[0] == ids[1] == ids[2] != ids[3]

    calls: List[str] = []

    def src_a() -> pd.DataFrame:
        calls.append("a")
        return pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]})

    def src_b() -> pd.DataFrame:
        calls.append("b")
        return pd.DataFrame({"k": [1, 2], "w": [10.0, 20.0]})

    def build(storage: str) -> Any:
        dag = twf.FugueWorkflow(conf)
        a = dag.create(src_a).deterministic_checkpoint(storage_type=storage)
        b = dag.create(src_b).deterministic_checkpoint()
        a.inner_join(b).deterministic_checkpoint().yield_dataframe_as("res", as_local=True)
        return dag

    for storage in ("file", "table"):
        calls.clear()
        r1 = build(storage).run(port_engine).yields["res"].result.as_array()
        n1 = len(calls)
        r2 = build(storage).run(port_engine).yields["res"].result.as_array()
        assert sorted(r1) == sorted(r2) and len(calls) == n1  # every creator resumed


def test_any_column_name(jax_engine, port_engine, tmp_path):
    """Names with spaces and symbols through join, transform, select,
    rename, save and load (builtin_suite ``test_any_column_name``)."""

    # schema: *,`c *`:long
    def tr(df: pd.DataFrame) -> pd.DataFrame:
        return df.assign(**{"c *": 2})

    df1 = pd.DataFrame([[0, 1], [2, 3]], columns=["a b", " "])
    df2 = pd.DataFrame([[0, 10], [20, 3]], columns=["a b", "d"])
    outs = {}
    for side, mod, column, engine in (("ref", fa, jcolumn, jax_engine), ("port", api, tcolumn, port_engine)):
        r = mod.inner_join(df1, df2, engine=engine, as_fugue=True)
        r = mod.transform(r, tr, engine=engine, as_fugue=True)
        col = column.col
        r = mod.select(r, col("a b").alias("a b "), col(" ").alias("x y"), col("d"), col("c *"), engine=engine,
                       as_fugue=True)
        r = r.rename({"a b ": "a b"})
        path = str(tmp_path / f"{side}.parquet")
        mod.save(r, path, engine=engine)
        outs[side] = (r, mod.load(path, columns=["x y", "d", "c *"], engine=engine))
    assert str(outs["port"][0].schema) == str(outs["ref"][0].schema) == "`a b`:long,`x y`:long,d:long,`c *`:long"
    _same(outs["port"][1], outs["ref"][1])
    assert _rows(outs["port"][1]) == [(1, 10, 2)]


# ---- the refusals ------------------------------------------------------------------


def case_zip_cotransform(ns, dag, tmpdir):
    def merge(d1: pd.DataFrame, d2: pd.DataFrame) -> pd.DataFrame:
        k = d1["k"].iloc[0] if len(d1) else d2["k"].iloc[0]
        return pd.DataFrame({"k": [k], "n1": [len(d1)], "n2": [len(d2)]})

    a = dag.df([[1, "a"], [1, "b"], [2, "c"]], "k:long,v:str")
    b = dag.df([[1, 1.0], [3, 2.0]], "k:long,w:double")
    return {
        "by_dag": dag.zip(a, b, partition={"by": ["k"]}).transform(merge, schema="k:long,n1:long,n2:long"),
        "by_frame": a.zip(b, how="full_outer").transform(merge, schema="k:long,n1:long,n2:long"),
    }


def test_cotransform_zip_and_callbacks_are_refused(jax_engine, port_engine, tmp_path):
    """``dag.zip`` and ``WorkflowDataFrame.zip`` answer as the JAX
    package's, and a cotransformer of a frame that is not zipped raises
    what the reference raises; a transformer's callback reaches its
    function once a partition, with what the JAX package sends it (the
    test keeps its name from when the port refused them all)."""
    _check(case_zip_cotransform, jax_engine, port_engine, tmp_path)

    def merge(d1: pd.DataFrame, d2: pd.DataFrame) -> pd.DataFrame:
        return d1

    errs = []
    for ns, eng in ((REF, jax_engine), (PORT, port_engine)):
        dag = ns.FugueWorkflow()
        dag.df([[1, "a"]], "k:long,v:str").transform(merge, schema="k:long,v:str").show()
        with pytest.raises(ns.exc.FugueWorkflowError, match="must be a zipped dataframe") as err:
            dag.run(eng)
        errs.append(type(err.value).__name__)
    assert errs[0] == errs[1]
    def report(df: pd.DataFrame, cb: callable) -> pd.DataFrame:
        cb(len(df))
        return df

    def optional(df: pd.DataFrame, cb: Optional[Callable] = None) -> pd.DataFrame:
        return df.assign(has=cb is not None)

    seen: Dict[str, List[int]] = {}
    results = {}
    for ns, eng in ((REF, jax_engine), (PORT, port_engine)):
        calls: List[int] = []
        dag = ns.FugueWorkflow()
        a = dag.df([[1, "a"], [1, "b"], [2, "c"]], "k:long,v:str")
        a.partition_by("k").transform(report, schema="*", callback=calls.append).yield_dataframe_as(
            "r", as_local=True)
        a.transform(optional, schema="*,has:bool").yield_dataframe_as("o", as_local=True)
        dag.run(eng)
        seen[ns is PORT] = sorted(calls)
        results[ns is PORT] = {n: dag.yields[n].result for n in ("r", "o")}
    assert seen[True] == seen[False] == [1, 2]
    for n in ("r", "o"):
        _same(results[True][n], results[False][n])
    # per_row answers now: one row a partition, an even repartition
    spec = twf.FugueWorkflow().df([[1, "a"]], "k:long,v:str").per_row().partition_spec
    assert (spec.algo, spec.num_partitions) == ("even", "ROWCOUNT")


DIST_CONF = {"fugue.tpu.cache.enabled": False, "fugue.tpu.tuning.enabled": False, "fugue.tpu.dist.poll_s": 0.01,
             "fugue.tpu.dist.workflow_timeout_s": 15,
             "fugue.tpu.dist.buckets": 2}


def _dist_run(ns, engine, key: str, root: str, value: Any) -> tuple:
    """A load ⋈ load → aggregate DAG with ``key`` set to ``value`` (under
    the board key: the board's path for ``True``, unset for ``False``),
    run over one worker of ``ns``'s package on the board: its explain's
    distributed section (the board written ``<board>``), its result and
    its workflow jobs."""
    import threading

    dist = (REF_SIDE if ns is REF else PORT_SIDE).dist
    for side in ("a", "b"):
        os.makedirs(os.path.join(root, side), exist_ok=True)
        pd.DataFrame({"k": [1, 2, 3, 3], side: [1.0, 2.0, 3.0, 4.0]}).to_parquet(os.path.join(root, side, "p.parquet"))
    board = os.path.join(root, "board")
    dag = ns.FugueWorkflow({key: (board if value else "") if key.endswith("board") else value})
    (dag.load(os.path.join(root, "a"), fmt="parquet").join(dag.load(os.path.join(root, "b"), fmt="parquet"),
                                                           how="inner", on=["k"])
     .partition_by("k").aggregate(ns.ff.sum(ns.col("a") * ns.col("b")).alias("s")).yield_dataframe_as("r"))
    section = dist_section(dag.explain(conf=DIST_CONF), board)
    w = dist.DistWorker(board, "w0", conf=DIST_CONF, start_http=False).start()
    t = threading.Thread(target=w.serve_forever, kwargs={"stop_file": os.path.join(board, "_stop")}, daemon=True)
    t.start()
    try:
        dag.run(engine, conf=DIST_CONF)
    finally:
        open(os.path.join(board, "_stop"), "w").close()
        t.join(10)
        w.stop()
    jobs = engine.stats().get("dist", {}).get("workflow_jobs", 0) if key.endswith("board") and value else 0
    return section, dag.yields["r"].result, jobs


@pytest.mark.parametrize("key", ["fugue.tpu.dist.board", "fugue.tpu.dist.enabled"])
def test_a10_workflow_services_are_refused(key, jax_engine, port_engine, tmp_path):
    """The distributed pass's two keys, refused before the pass was
    ported, now answer as the JAX package's: with a board the join runs as
    a fragment on the board's worker; ``enabled`` alone, or either key
    off, leaves the planner inert. The explain's distributed section and
    the result equal the reference's."""
    for value in (True, False):
        ref = _dist_run(REF, jax_engine, key, str(tmp_path / f"ref-{value}"), value)
        got = _dist_run(PORT, port_engine, key, str(tmp_path / f"port-{value}"), value)
        assert got[0] == ref[0]
        assert str(got[1].schema) == str(ref[1].schema)
        _same(got[1], ref[1])
        assert got[2] == (1 if key.endswith("board") and value else 0)


RETRY_KNOBS = {"fugue.tpu.retry.attempts": ("max_attempts", 5), "fugue.tpu.retry.base": ("base_delay", 0.5),
               "fugue.tpu.retry.multiplier": ("multiplier", 3.0),
               "fugue.tpu.retry.max_backoff": ("max_delay", 7.0), "fugue.tpu.retry.jitter": ("jitter", 0.3)}


def _report_k(df: pd.DataFrame) -> pd.DataFrame:
    return df.assign(n=len(df))


@pytest.mark.parametrize("key", sorted(RETRY_KNOBS))
def test_a10_retry_knobs_are_refused(key, port_engine, monkeypatch):
    """The pool's retry knobs (refused, under this name, until the pool was
    ported) reach the ``RetryPolicy`` of the host map's fork pool, set on
    the workflow or on the engine; the task's own knob of the same name
    still reaches the task's policy."""
    from fugue_tpu_torch.execution import parallel_map as pm

    attr, value = RETRY_KNOBS[key]
    seen = []
    real = pm.run_partitions_forked

    def spy(*a, **k):
        seen.append(getattr(k["policy"], attr))
        return real(*a, **k)

    monkeypatch.setattr(pm, "run_partitions_forked", spy)
    pool = {"fugue.tpu.map.parallelism": 2, "fugue.tpu.map.parallel_min_rows": 0}
    pdf = pd.DataFrame({"k": [1, 1, 2, 3], "v": [1.0, 2.0, 3.0, 4.0]})
    for dag, eng in ((twf.FugueWorkflow({key: value, **pool}), port_engine),
                     (twf.FugueWorkflow(), NativeExecutionEngine({key: value, **pool}))):
        dag.df(pdf).partition_by("k").transform(_report_k, schema="*,n:long").yield_dataframe_as(
            "r", as_local=True)
        dag.run(eng)
        assert sorted(dag.yields["r"].result.as_array()) == [[1, 1.0, 2], [1, 2.0, 2], [2, 3.0, 1], [3, 4.0, 1]]
    assert seen == [value, value]
    task_key = key.replace("fugue.tpu.retry.", "fugue.tpu.retry.task.")
    ok = twf.FugueWorkflow({task_key: 1})
    ok.df([[1]], "a:long").yield_dataframe_as("r", as_local=True)
    assert ok.run(port_engine)["r"].result.as_array() == [[1]]


# ---- what the port adds: threads, run-scoped conf, modules, the registry -----------


@pytest.mark.parametrize("concurrency", [1, 4])
def test_concurrent_tasks_match_serial(concurrency, port_engine):
    """With ``fugue.workflow.concurrency`` 4 the independent branches run in
    pool threads (each entering the engine's thread scope), with the
    answers of a serial run; the workflow conf stays out of the engine's."""
    import threading

    threads = set()

    def tag(df: pd.DataFrame) -> pd.DataFrame:
        threads.add(threading.get_ident())
        return df.assign(t=1)

    dag = twf.FugueWorkflow({"fugue.workflow.concurrency": concurrency, "my.key": 1})
    outs = []
    for i in range(6):
        b = dag.df([[i, float(i)]], "k:long,v:double").transform(tag, schema="*,t:long")
        outs.append(b.select(tcolumn.col("k"), (tcolumn.col("v") * 2).alias("v2")))
    u = outs[0].union(*outs[1:], distinct=False)
    u.yield_dataframe_as("u", as_local=True)
    dag.run(port_engine)
    assert sorted(_rows(dag.yields["u"].result)) == [(i, 2.0 * i) for i in range(6)]
    # serial: every task on this thread; concurrent: every task on a pool thread
    assert (threading.get_ident() in threads) == (concurrency == 1)
    assert "my.key" not in port_engine.conf and "fugue.workflow.concurrency" not in port_engine.conf


def test_run_conf_is_scoped(port_engine):
    seen = {}

    def probe(e: ExecutionEngine) -> pd.DataFrame:
        seen["conf"] = dict(e.conf)
        return pd.DataFrame({"a": [1]})

    dag = twf.FugueWorkflow({"x.y": 5})
    dag.create(probe)
    dag.run(port_engine)
    assert seen["conf"]["x.y"] == 5 and "x.y" not in port_engine.conf


def test_module_and_factory(port_engine):
    @twf.module
    def create(wf: twf.FugueWorkflow, n: int = 1) -> twf.WorkflowDataFrame:
        return wf.df([[n]], "a:long")

    def double_a(df: pd.DataFrame) -> pd.DataFrame:
        return df.assign(a=df["a"] * 2)

    @twf.module()
    def doubled(df: twf.WorkflowDataFrame) -> twf.WorkflowDataFrame:
        return df.transform(double_a, schema="*")

    def factory() -> twf.FugueWorkflow:
        dag = twf.FugueWorkflow()
        doubled(create(dag, n=3)).yield_dataframe_as("x", as_local=True)
        return dag

    assert twf.is_workflow_factory(factory) and not twf.is_workflow_factory(factory())
    dag = twf.build_workflow(factory)
    assert dag.run(port_engine).yields["x"].result.as_array() == [[6]]
    with pytest.raises(texc.FugueWorkflowCompileError):
        create(1)


def test_extension_registry(jax_engine, port_engine):
    """Names resolve through the registry (``register_*``) and the parse
    hooks, as the JAX package's ``fugue_tpu.plugins`` candidates do."""

    @jplugins.parse_creator.candidate(lambda obj, **kw: isinstance(obj, str) and obj == "_reg_creator")
    def _pc(obj: str):
        def _make() -> pd.DataFrame:
            return pd.DataFrame({"a": [7]})

        return _make

    @text.parse_creator.candidate(lambda obj: isinstance(obj, str) and obj == "_reg_creator")
    def _tpc(obj: str):
        def _make() -> pd.DataFrame:
            return pd.DataFrame({"a": [7]})

        return _make

    def _double(df: pd.DataFrame) -> pd.DataFrame:
        return df.assign(a=df["a"] * 2)

    text.register_transformer("_reg_double", _double)
    jext.register_transformer("_reg_double", _double)
    res = {}
    for side, ns, engine in (("ref", REF, jax_engine), ("port", PORT, port_engine)):
        dag = ns.FugueWorkflow()
        a = dag.create("_reg_creator", params=dict())
        a.assert_eq(dag.df([[7]], "a:long"))
        a.transform("_reg_double", schema="*").yield_dataframe_as("x", as_local=True)
        dag.run(engine)
        res[side] = dag.yields["x"].result
    _same(res["port"], res["ref"])
    assert _rows(res["port"]) == [(14,)]
