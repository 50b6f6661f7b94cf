"""Zip and comap with cotransformers on the port, against the JAX package.

Two pairs run the same inputs, made from a seed with numpy:
``JaxExecutionEngine`` (the 8-device CPU mesh) against the port's
``TorchExecutionEngine(device="cpu")``, and ``fugue_tpu``'s
``NativeExecutionEngine`` against the port's. Each case is written once
over a namespace of either package's classes. Outputs compare as row
sets with NULLs in their places: keys, counts and strings exact, float
sums within 1e-5 relative (``test_torch_sql._same``); the order of the
output keys follows the reference mesh's shard layout, so it is not
compared.

The cases: ``fugue_tpu_test/execution_suite.py`` ``test_zip_comap``
:314, ``_left`` :329, ``test_comap_multiple_frames`` :586; every zip type;
string, NULL and NaN keys; presorts at zip and at comap time; every
cotransformer annotation form; output cotransformers;
``fugue_tpu_test/builtin_suite.py``'s four cotransform cases; FugueSQL
``TRANSFORM a, b``; ``tests/jax_engine/test_cosharded_zip.py`` and
``test_advice_r2.py:35`` with the port's ``_PartitionSerializer.run``
poisoned where the reference's tests poison ``_serialize_by_partition``;
and the sorted streams of ``tests/jax_engine/test_streaming.py``
:850-933 with their errors.
"""

import decimal
from types import SimpleNamespace
from typing import Any, Dict, Iterable, List

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import fugue_tpu
import fugue_tpu.api as fa
import fugue_tpu.exceptions as jexc
from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.dataframe import DataFrames as JDataFrames
from fugue_tpu.dataframe import LocalDataFrame as JLocalDataFrame
from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu.jax import streaming as jstreaming
import fugue_tpu_torch.exceptions as texc
import fugue_tpu_torch.extensions as text
from fugue_tpu_torch import api
from fugue_tpu_torch import dataframe as tdf
from fugue_tpu_torch import workflow as twf
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.execution import execution_engine as base_engine
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.torch import streaming as tstreaming
from fugue_tpu_torch.torch.zipped import ZippedTorchDataFrame

from test_torch_sql import _rows, _same
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

REF = SimpleNamespace(
    FugueWorkflow=fugue_tpu.FugueWorkflow, DataFrames=JDataFrames, PartitionSpec=JPartitionSpec,
    ArrayDataFrame=fugue_tpu.ArrayDataFrame, PandasDataFrame=fugue_tpu.PandasDataFrame,
    LocalDataFrame=JLocalDataFrame, Stream=JStream, CoTransformer=fugue_tpu.CoTransformer,
    OutputCoTransformer=fugue_tpu.OutputCoTransformer, cotransformer=fugue_tpu.cotransformer,
    output_cotransformer=fugue_tpu.output_cotransformer, exc=jexc, api=fa, streaming=jstreaming,
)
PORT = SimpleNamespace(
    FugueWorkflow=twf.FugueWorkflow, DataFrames=tdf.DataFrames, PartitionSpec=PartitionSpec,
    ArrayDataFrame=tdf.ArrayDataFrame, PandasDataFrame=tdf.PandasDataFrame,
    LocalDataFrame=tdf.LocalDataFrame, Stream=tdf.LocalDataFrameIterableDataFrame,
    CoTransformer=text.CoTransformer, OutputCoTransformer=text.OutputCoTransformer,
    cotransformer=text.cotransformer, output_cotransformer=text.output_cotransformer, exc=texc,
    api=api, streaming=tstreaming,
)
# the JAX package's result cache would skip a DAG it ran before
REF_CONF = {"fugue.tpu.cache.enabled": False}
CHUNK = "fugue.tpu.stream.chunk_rows"


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine(REF_CONF)
    yield e
    e.stop()


@pytest.fixture(params=["device", "native"])
def pair(request, jax_engine):
    """(reference engine, port engine) of one pair."""
    if request.param == "device":
        return jax_engine, TorchExecutionEngine(device="cpu")
    return JNativeExecutionEngine(REF_CONF), NativeExecutionEngine()


@pytest.fixture
def no_blobs(monkeypatch):
    """The port's blob protocol poisoned: a zip that builds a blob row
    raises."""

    def _no_blobs(*args: Any, **kwargs: Any) -> Any:
        raise AssertionError("blob serialization used on the device zip path")

    monkeypatch.setattr(base_engine._PartitionSerializer, "run", _no_blobs)


def _both(case, pair, **kw) -> None:
    """``case(ns, engine)`` on the reference and the port: the same rows."""
    ref_engine, port_engine = pair
    ref = case(REF, ref_engine, **kw)
    got = case(PORT, port_engine, **kw)
    assert str(got.schema) == str(ref.schema)
    _same(got, ref)


def _frames(seed: int = 0, n1: int = 300, n2: int = 200, keys: int = 9) -> List[pd.DataFrame]:
    rng = np.random.default_rng(seed)
    a = pd.DataFrame({"k": rng.integers(0, keys, n1), "v": rng.random(n1)})
    b = pd.DataFrame({"k": rng.integers(2, keys + 3, n2), "w": rng.random(n2)})
    return [a, b]


def _count_sides(cursor: Any, dfs: Any) -> Any:
    """One row a key: the key, each side's rows and its value sum (NULL
    for no rows)."""
    a, b = dfs[0].as_pandas(), dfs[1].as_pandas()
    k = cursor.key_value_array[0]
    return _row_frame(dfs, [[k, len(a), len(b), float(a["v"].sum()) if len(a) else None]])


def _row_frame(dfs: Any, rows: List[List[Any]]) -> Any:
    ns = PORT if isinstance(dfs, tdf.DataFrames) else REF
    return ns.ArrayDataFrame(rows, "k:long,n1:long,n2:long,sv:double")


# ---- the engine's zip and comap (execution_suite) ------------------------------------


def case_zip_comap(ns, e, how="inner"):
    df1 = e.to_df(ns.ArrayDataFrame([[1, "a"], [1, "b"], [2, "c"]], "k:long,v:str"))
    df2 = e.to_df(ns.ArrayDataFrame([[1, 10.0], [3, 30.0]], "k:long,w:double"))
    z = e.zip(ns.DataFrames(df1, df2), how=how, partition_spec=ns.PartitionSpec(by=["k"]))

    def cm(cursor, dfs):
        k = cursor.key_value_array[0]
        return ns.ArrayDataFrame([[k, dfs[0].count(), dfs[1].count()]], "k:long,n1:long,n2:long")

    return e.comap(z, cm, "k:long,n1:long,n2:long")


def case_comap_multiple_frames(ns, e):
    d1 = e.to_df(ns.ArrayDataFrame([[1, "a"]], "k:long,v:str"))
    d2 = e.to_df(ns.ArrayDataFrame([[1, 1.0], [1, 2.0]], "k:long,w:double"))
    d3 = e.to_df(ns.ArrayDataFrame([[1, True]], "k:long,b:bool"))
    z = e.zip(ns.DataFrames(d1, d2, d3), how="inner", partition_spec=ns.PartitionSpec(by=["k"]))

    def cm(cursor, dfs):
        assert len(dfs) == 3
        return ns.ArrayDataFrame(
            [[cursor.key_value_array[0], dfs[0].count(), dfs[1].count(), dfs[2].count()]],
            "k:long,a:long,b:long,c:long",
        )

    return e.comap(z, cm, "k:long,a:long,b:long,c:long")


@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_zip_comap(how, pair):
    _both(case_zip_comap, pair, how=how)
    rows = {"inner": [(1, 2, 1)], "left_outer": [(1, 2, 1), (2, 1, 0)]}[how]
    assert sorted(_rows(case_zip_comap(PORT, pair[1], how=how))) == rows


def test_comap_multiple_frames(pair):
    _both(case_comap_multiple_frames, pair)
    assert _rows(case_comap_multiple_frames(PORT, pair[1])) == [(1, 1, 2, 1)]


def case_zip_how(ns, e, how, keys):
    a, b = _frames(1, 120, 90, keys=6)
    if keys == "str":
        a["k"], b["k"] = a["k"].map(lambda x: f"s{x}"), b["k"].map(lambda x: f"s{x}")
    z = e.zip(
        ns.DataFrames(e.to_df(a), e.to_df(b)), how=how,
        partition_spec=None if how == "cross" else ns.PartitionSpec(by=["k"]),
    )

    def cm(cursor, dfs):
        a, b = dfs[0].as_pandas(), dfs[1].as_pandas()
        k = str(sorted(set(a["k"]) | set(b["k"]))) if how == "cross" else str(cursor.key_value_array[0])
        return ns.ArrayDataFrame([[k, len(a), len(b), float(a["v"].sum())]], "k:str,n1:long,n2:long,sv:double")

    return e.comap(z, cm, "k:str,n1:long,n2:long,sv:double")


@pytest.mark.parametrize("how", ["inner", "left_outer", "right_outer", "full_outer", "cross"])
@pytest.mark.parametrize("keys", ["int", "str"])
def test_zip_types(how, keys, pair):
    _both(case_zip_how, pair, how=how, keys=keys)


def case_nullable_keys(ns, e, kind, how):
    """NULL keys group together across frames (the blob protocol, or the
    device zip's dictionary codes for strings)."""
    rng = np.random.default_rng(5)
    ka, kb = rng.integers(0, 4, 60).astype(float), rng.integers(1, 5, 40).astype(float)
    ka[rng.random(60) < 0.2] = np.nan
    kb[rng.random(40) < 0.2] = np.nan
    if kind == "str":
        tp = pa.string()
        ka = [None if np.isnan(x) else f"s{int(x)}" for x in ka]
        kb = [None if np.isnan(x) else f"s{int(x)}" for x in kb]
    elif kind == "int":
        tp = pa.int64()
        ka = [None if np.isnan(x) else int(x) for x in ka]
        kb = [None if np.isnan(x) else int(x) for x in kb]
    else:  # a NaN float key
        tp = pa.float64()
        ka, kb = [float(x) for x in ka], [float(x) for x in kb]
    a = pa.table({"k": pa.array(ka, tp, from_pandas=True), "v": pa.array(rng.random(60))})
    b = pa.table({"k": pa.array(kb, tp, from_pandas=True), "w": pa.array(rng.random(40))})
    z = e.zip(ns.DataFrames(e.to_df(a), e.to_df(b)), how=how, partition_spec=ns.PartitionSpec(by=["k"]))

    def cm(cursor, dfs):
        a, b = dfs[0].as_pandas(), dfs[1].as_pandas()
        return ns.ArrayDataFrame([[len(a), len(b), float(a["v"].sum())]], "n1:long,n2:long,sv:double")

    return e.comap(z, cm, "n1:long,n2:long,sv:double")


@pytest.mark.parametrize("how", ["inner", "full_outer"])
@pytest.mark.parametrize("kind", ["str", "int", "nan"])
def test_null_and_nan_keys(kind, how, pair):
    _both(case_nullable_keys, pair, kind=kind, how=how)


def test_key_routes_are_decided_from_the_schema():
    """The torch engine's device zip takes plain and dictionary keys; a
    nullable integer key, a float key that may hold NaN, a cross or a
    keyless zip and a frame with a host column take the blob protocol, as
    the JAX engine's ``_key_ok`` decides."""
    e = TorchExecutionEngine(device="cpu")
    a = pa.table({"k": [1, 2], "s": ["x", None], "f": [1.0, float("nan")], "n": pa.array([1, None]),
                  "u": pa.array([1, 2], pa.uint32()), "d": pa.array([decimal.Decimal(1), None]),
                  "v": [1.0, 2.0]})

    def zipped(by, cols=("k", "s", "f", "n", "v"), how="inner"):
        t = e.to_df(a.select(list(cols)))
        return e.zip(tdf.DataFrames(t, t), how=how, partition_spec=PartitionSpec(by=by) if by else None)

    assert isinstance(zipped(["k"]), ZippedTorchDataFrame)
    assert isinstance(zipped(["s"]), ZippedTorchDataFrame)
    assert isinstance(zipped(["k", "s"]), ZippedTorchDataFrame)
    # a uint32 key and column live on the device, as on the JAX engine's
    assert isinstance(zipped(["u"], cols=("k", "u")), ZippedTorchDataFrame)
    for z in (zipped(["f"]), zipped(["n"]), zipped(None, how="cross"), zipped(["k"], cols=("k", "d"))):
        assert not isinstance(z, ZippedTorchDataFrame) and z.metadata["serialized"] is True


# ---- presorts ------------------------------------------------------------------------


def case_presort(ns, e, at):
    """The blob protocol sorts every input by the presort, so each input
    holds its columns."""
    a = pd.DataFrame({"k": [1, 1, 1, 2, 2, 2], "v": [3.0, 1.0, None, 9.0, 5.0, 7.0]})
    b = pd.DataFrame({"k": [1, 2, 2], "v": [10.0, 20.0, 30.0]})
    spec = ns.PartitionSpec(by=["k"], presort="v desc") if at == "zip" else ns.PartitionSpec(by=["k"])
    z = e.zip(ns.DataFrames(e.to_df(a), e.to_df(b)), partition_spec=spec)

    def first(cursor, dfs):
        d1, d2 = dfs[0].as_pandas(), dfs[1].as_pandas()
        return ns.ArrayDataFrame(
            [[int(d1["k"].iloc[0]), str(d1["v"].tolist()), str(d2["v"].tolist())]], "k:long,vs:str,ws:str"
        )

    comap_spec = ns.PartitionSpec(presort="v") if at == "comap" else None
    return e.comap(z, first, "k:long,vs:str,ws:str", partition_spec=comap_spec)


@pytest.mark.parametrize("at", ["zip", "comap"])
def test_presort_at_zip_and_comap_time(at, pair):
    """A comap-time presort overrides the zip's on the device zips; the
    blob protocol checks it against the blob frame's schema, and raises
    on both (C15, carried)."""
    if at == "comap" and isinstance(pair[1], NativeExecutionEngine):
        errs = []
        for ns, e in ((REF, pair[0]), (PORT, pair[1])):
            with pytest.raises(Exception, match="presort key v not in") as err:
                case_presort(ns, e, at=at)
            errs.append(type(err.value).__name__)
        assert errs == ["PartitionSpecError"] * 2
        return
    _both(case_presort, pair, at=at)
    got = dict((r[0], r[1:]) for r in _rows(case_presort(PORT, pair[1], at=at)))
    if at == "zip":  # NULLs first, then descending
        assert got[1][0] == "[nan, 3.0, 1.0]" and got[2] == ("[9.0, 7.0, 5.0]", "[30.0, 20.0]")
    else:
        assert got[1][0] == "[nan, 1.0, 3.0]" and got[2] == ("[5.0, 7.0, 9.0]", "[20.0, 30.0]")


def test_comap_presort_device_path(no_blobs):
    """``test_advice_r2.py:35`` on the port: the device zip replays the
    zip-time presort inside each key."""
    e = TorchExecutionEngine(device="cpu")
    a = pd.DataFrame({"k": [1, 1, 1, 2, 2], "v": [3.0, 1.0, 2.0, 9.0, 5.0]})
    b = pd.DataFrame({"k": [1, 2], "w": [10.0, 20.0]})
    z = e.zip(tdf.DataFrames([e.to_df(a), e.to_df(b)]), partition_spec=PartitionSpec(by=["k"], presort="v desc"))
    assert isinstance(z, ZippedTorchDataFrame)
    seen = {}

    def first_v(cursor, dfs):
        d1 = dfs[0].as_pandas()
        k = int(d1["k"].iloc[0])
        seen[k] = d1["v"].tolist()
        return tdf.PandasDataFrame(pd.DataFrame({"k": [k], "first_v": [d1["v"].iloc[0]]}), "k:long,first_v:double")

    res = e.comap(z, first_v, "k:long,first_v:double").as_pandas()
    assert seen[1] == [3.0, 2.0, 1.0] and seen[2] == [9.0, 5.0]
    assert dict(zip(res["k"], res["first_v"])) == {1: 3.0, 2: 9.0}


# ---- the cotransformer's forms ---------------------------------------------------------


def _forms(ns) -> Dict[str, Any]:
    """The same cotransformer in each annotation form: pandas, arrow, a
    list of lists, a list of dicts, local frames, one ``DataFrames``, an
    iterable of pandas frames, a ``@cotransformer`` and a class."""

    def pandas_form(a: pd.DataFrame, b: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"k": [a["k"].iloc[0]], "n1": [len(a)], "n2": [len(b)], "sv": [a["v"].sum()]})

    def arrow_form(a: pa.Table, b: pa.Table) -> pa.Table:
        return pa.table({"k": [a["k"][0].as_py()], "n1": [a.num_rows], "n2": [b.num_rows],
                         "sv": [float(pa.compute.sum(a["v"]).as_py())]})

    def list_form(a: List[List[Any]], b: List[List[Any]]) -> List[List[Any]]:
        return [[a[0][0], len(a), len(b), float(sum(r[1] for r in a))]]

    def dict_form(a: List[Dict[str, Any]], b: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return [{"k": a[0]["k"], "n1": len(a), "n2": len(b), "sv": float(sum(r["v"] for r in a))}]

    def local_form(a: ns.LocalDataFrame, b: ns.LocalDataFrame) -> pd.DataFrame:
        return pandas_form(a.as_pandas(), b.as_pandas())

    def frames_form(dfs: ns.DataFrames) -> pd.DataFrame:
        return pandas_form(dfs[0].as_pandas(), dfs[1].as_pandas())

    def iter_form(a: pd.DataFrame, b: pd.DataFrame) -> Iterable[pd.DataFrame]:
        yield pandas_form(a, b)

    @ns.cotransformer("k:long,n1:long,n2:long,sv:double")
    def deco_form(a: pd.DataFrame, b: pd.DataFrame) -> pd.DataFrame:
        return pandas_form(a, b)

    class ClassForm(ns.CoTransformer):
        def get_output_schema(self, dfs):
            return "k:long,n1:long,n2:long,sv:double"

        def transform(self, dfs):
            return ns.PandasDataFrame(pandas_form(dfs[0].as_pandas(), dfs[1].as_pandas()),
                                      "k:long,n1:long,n2:long,sv:double")

    return dict(pandas=pandas_form, arrow=arrow_form, list=list_form, dict=dict_form, local=local_form,
                frames=frames_form, iter=iter_form, deco=deco_form, cls=ClassForm)


FORMS = ["pandas", "arrow", "list", "dict", "local", "frames", "iter", "deco", "cls"]


def case_form(ns, e, form):
    a, b = _frames(2, 150, 80, keys=5)
    dag = ns.FugueWorkflow()
    fn = _forms(ns)[form]
    schema = None if form in ("deco", "cls") else "k:long,n1:long,n2:long,sv:double"
    dag.zip(dag.df(a), dag.df(b), partition={"by": ["k"]}).transform(fn, schema=schema).yield_dataframe_as(
        "r", as_local=True
    )
    dag.run(e)
    return dag.yields["r"].result


@pytest.mark.parametrize("form", FORMS)
def test_cotransformer_forms(form, pair):
    _both(case_form, pair, form=form)


# ---- the workflow (builtin_suite) ------------------------------------------------------


def _merge(d1: pd.DataFrame, d2: pd.DataFrame) -> pd.DataFrame:
    return pd.DataFrame({"k": [d1["k"].iloc[0]], "n1": [len(d1)], "n2": [len(d2)]})


def case_cotransform(ns, e, how):
    dag = ns.FugueWorkflow()
    rows = [[1, "a"], [1, "b"], [2, "c"]] if how == "inner" else [[1, "a"], [2, "c"]]
    a = dag.df(rows, "k:long,v:str")
    b = dag.df([[1, 1.0]], "k:long,w:double")
    exp = [[1, 2, 1]] if how == "inner" else [[1, 1, 1], [2, 1, 0]]
    r = dag.zip(a, b, how=how, partition={"by": ["k"]}).transform(_merge, schema="k:long,n1:long,n2:long")
    r.assert_eq(dag.df(exp, "k:long,n1:long,n2:long"))
    r.yield_dataframe_as("r", as_local=True)
    dag.run(e)
    return dag.yields["r"].result


def case_cotransform_named_inputs(ns, e):
    def merge(dfs: ns.DataFrames) -> pd.DataFrame:
        left, right = dfs["left"], dfs["right"]
        return pd.DataFrame({"k": [left.as_array()[0][0]], "n": [left.count() + right.count()]})

    dag = ns.FugueWorkflow()
    a = dag.df([[1, "x"], [1, "y"], [2, "z"]], "k:long,v:str")
    b = dag.df([[1, 9.0], [2, 8.0]], "k:long,w:double")
    dag.zip({"left": a, "right": b}, partition={"by": ["k"]}).transform(merge, schema="k:long,n:long")\
        .yield_dataframe_as("out", as_local=True)
    dag.run(e)
    return dag.yields["out"].result


@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_cotransform(how, pair):
    _both(case_cotransform, pair, how=how)


def test_cotransform_named_inputs(pair):
    _both(case_cotransform_named_inputs, pair)
    assert sorted(_rows(case_cotransform_named_inputs(PORT, pair[1]))) == [(1, 3), (2, 2)]


def case_out_cotransform(ns, e):
    hits: List[str] = []

    def t1(df: pd.DataFrame, df2: pd.DataFrame) -> pd.DataFrame:
        hits.append("t1")
        return df

    def t2(dfs: ns.DataFrames) -> None:
        hits.append("t2")

    @ns.cotransformer("a:double,b:long")
    def t4(df: pd.DataFrame, df2: pd.DataFrame) -> pd.DataFrame:
        hits.append("t4")
        return df

    class T6(ns.CoTransformer):
        def get_output_schema(self, dfs):
            return dfs[0].schema

        def transform(self, dfs):
            hits.append("T6")
            return dfs[0]

    class T7(ns.OutputCoTransformer):
        def process(self, dfs):
            hits.append("T7")

    @ns.output_cotransformer()
    def t5(df: List[List[Any]], df2: List[Dict[str, Any]]) -> None:
        hits.append("t5")

    def t8(df: pd.DataFrame, df2: pd.DataFrame) -> pd.DataFrame:
        hits.append("t8")
        raise NotImplementedError

    dag = ns.FugueWorkflow()
    a0 = dag.df([[1.0, 2], [3.0, 4]], "a:double,b:long")
    a1 = dag.df([[1.0, 2], [3.0, 4]], "aa:double,b:long")
    a = a0.zip(a1)
    for t in (t1, t2, t4, T6, T7, t5):
        a.out_transform(t)
    a.out_transform(t8, ignore_errors=[NotImplementedError])
    dag.run(e)
    return sorted(hits)


def test_out_cotransform(pair):
    ref, port = case_out_cotransform(REF, pair[0]), case_out_cotransform(PORT, pair[1])
    assert port == ref
    assert set(port) == {"t1", "t2", "t4", "T6", "T7", "t5", "t8"}


def test_a_cotransformer_of_one_frame_raises_as_in_the_reference(pair):
    """``processors.py:88``: the input of a cotransform must be zipped,
    through the workflow and through ``api.transform``."""

    def two(a: pd.DataFrame, b: pd.DataFrame) -> pd.DataFrame:
        return a

    errs = []
    for ns, e in ((REF, pair[0]), (PORT, pair[1])):
        dag = ns.FugueWorkflow()
        dag.df([[1, "a"]], "k:long,v:str").transform(two, schema="k:long,v:str").show()
        with pytest.raises(ns.exc.FugueWorkflowError, match="must be a zipped dataframe") as e1:
            dag.run(e)
        with pytest.raises(ns.exc.FugueWorkflowError, match="must be a zipped dataframe") as e2:
            ns.api.transform(pd.DataFrame({"k": [1]}), two, schema="*", engine=e)
        errs.append((type(e1.value).__name__, type(e2.value).__name__))
    assert errs[0] == errs[1]


# ---- FugueSQL ------------------------------------------------------------------------


_SQL = """
r = TRANSFORM a, b {prepartition} USING merge_sql SCHEMA k:long,n1:long,n2:long,sv:double
OUTTRANSFORM a, b {prepartition} USING out_sql
SELECT * FROM r
"""
_OUT_HITS: List[int] = []


def merge_sql(a: pd.DataFrame, b: pd.DataFrame) -> pd.DataFrame:
    k = a["k"].iloc[0] if len(a) else b["k"].iloc[0]
    return pd.DataFrame({"k": [k], "n1": [len(a)], "n2": [len(b)], "sv": [a["v"].sum()]})


def out_sql(a: pd.DataFrame, b: pd.DataFrame) -> None:
    _OUT_HITS.append(len(a) + len(b))


def _sql(ns, e, prepartition):
    a, b = _frames(3, 90, 70, keys=6)
    _OUT_HITS.clear()
    res = ns.api.fugue_sql(_SQL.format(prepartition=prepartition), a=a, b=b, engine=e, as_fugue=True)
    return res.as_local_bounded(), sorted(_OUT_HITS)


def test_fugue_sql_transform_of_two_frames(pair):
    """``TRANSFORM a, b USING f`` zips by the shared columns and runs the
    cotransformer; ``OUTTRANSFORM a, b`` runs the output one."""
    (ref, ref_hits), (got, got_hits) = _sql(REF, pair[0], ""), _sql(PORT, pair[1], "")
    _same(got, ref)
    assert got_hits == ref_hits and len(got_hits) > 0


def test_fugue_sql_prepartition_where_the_reference_raises(pair):
    """C14 (ROADMAP.md): with ``PREPARTITION BY k`` the reference's
    cotransformer runner builds its ``on_init`` cursor over an empty schema
    with the keys ``k`` (``processors.py:159``, ``partition.py:331``) and
    raises ``KeyError``; the port's cursor finds the keys when they are
    read, and answers as without the PREPARTITION."""
    with pytest.raises(KeyError, match="k"):
        _sql(REF, pair[0], "PREPARTITION BY k")
    got, got_hits = _sql(PORT, pair[1], "PREPARTITION BY k")
    ref, ref_hits = _sql(REF, pair[0], "")
    _same(got, ref)
    assert got_hits == ref_hits


# ---- the device route (test_cosharded_zip.py) ----------------------------------------


@pytest.fixture
def engine():
    return TorchExecutionEngine(device="cpu")


def test_zip_device_frames_produces_cosharded(engine):
    a = pd.DataFrame({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]})
    b = pd.DataFrame({"k": [2, 3, 4], "w": [20.0, 30.0, 40.0]})
    z = engine.zip(tdf.DataFrames([engine.to_df(a), engine.to_df(b)]), partition_spec=PartitionSpec(by=["k"]))
    assert isinstance(z, ZippedTorchDataFrame)
    assert z.metadata["device_zip"] is True and z.metadata["keys"] == ["k"]
    assert sorted(z.zip_frames[0].as_pandas()["k"].tolist()) == [1, 2, 3]
    assert sorted(z.zip_frames[1].as_pandas()["k"].tolist()) == [2, 3, 4]


def test_comap_matches_oracle(engine, jax_engine, no_blobs):
    rng = np.random.default_rng(0)
    a = pd.DataFrame({"k": rng.integers(0, 10, 200), "v": rng.random(200)})
    b = pd.DataFrame({"k": rng.integers(0, 12, 150), "w": rng.random(150)})

    def merge_stats(df1: pd.DataFrame, df2: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"k": [df1["k"].iloc[0]], "sv": [df1["v"].sum()], "sw": [df2["w"].sum()]})

    def run(ns, eng):
        dag = ns.FugueWorkflow()
        dag.df(a).zip(dag.df(b), partition=dict(by=["k"])).transform(
            merge_stats, schema="k:long,sv:double,sw:double"
        ).yield_dataframe_as("r", as_local=True)
        return dag.run(eng).yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True)

    exp = run(REF, jax_engine)
    pd.testing.assert_frame_equal(run(PORT, engine), exp, check_dtype=False)


def test_comap_outer_semantics(engine, no_blobs):
    a = pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]})
    b = pd.DataFrame({"k": [2, 3], "w": [20.0, 30.0]})

    def count_sides(df1: pd.DataFrame, df2: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"n1": [len(df1)], "n2": [len(df2)]})

    for how, expected in [
        ("inner", [(1, 1)]),
        ("left_outer", [(1, 0), (1, 1)]),
        ("right_outer", [(0, 1), (1, 1)]),
        ("full_outer", [(0, 1), (1, 0), (1, 1)]),
    ]:
        z = engine.zip(tdf.DataFrames([engine.to_df(a), engine.to_df(b)]), how=how,
                       partition_spec=PartitionSpec(by=["k"]))
        assert isinstance(z, ZippedTorchDataFrame), how
        dag = twf.FugueWorkflow()
        dag.df(a).zip(dag.df(b), how=how, partition=dict(by=["k"])).transform(
            count_sides, schema="n1:int,n2:int"
        ).yield_dataframe_as("r", as_local=True)
        res = dag.run(engine).yields["r"].result.as_pandas()
        assert sorted(map(tuple, res[["n1", "n2"]].to_numpy().tolist())) == sorted(expected), how


def test_zip_nanable_float_keys_fall_back_to_blob_protocol(engine):
    a = pa.table({"k": pa.array([1.0, float("nan")], pa.float64()), "v": pa.array([1.0, 2.0], pa.float64())})
    b = pd.DataFrame({"k": [1.0, 2.0], "w": [3.0, 4.0]})
    z = engine.zip(tdf.DataFrames([engine.to_df(a), engine.to_df(b)]), partition_spec=PartitionSpec(by=["k"]))
    assert not isinstance(z, ZippedTorchDataFrame)
    assert z.metadata["serialized"] is True


def test_zipped_frame_materializes_for_non_comap_use(engine, jax_engine):
    a = pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]})
    b = pd.DataFrame({"k": [1, 2], "w": [3.0, 4.0]})
    z = engine.zip(tdf.DataFrames([engine.to_df(a), engine.to_df(b)]), partition_spec=PartitionSpec(by=["k"]))
    assert isinstance(z, ZippedTorchDataFrame)
    tbl = z.as_arrow()  # the blob form, built once
    assert tbl.num_rows == 4 and z.count() == 4
    rz = jax_engine.zip(JDataFrames([jax_engine.to_df(a), jax_engine.to_df(b)]),
                        partition_spec=JPartitionSpec(by=["k"]))
    assert tbl.column_names == rz.as_arrow().column_names
    assert z.metadata == dict(rz.metadata)


def test_zip_string_keys_on_device(engine, no_blobs):
    a = pd.DataFrame({"s": ["x", "y", "z", None, "x"], "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    b = pd.DataFrame({"s": ["y", "w", None, "x"], "w": [20.0, 40.0, 60.0, 10.0]})

    def stats(df1: pd.DataFrame, df2: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"s": [df1["s"].iloc[0] if len(df1) else df2["s"].iloc[0]],
                             "n1": [len(df1)], "n2": [len(df2)]})

    dag = twf.FugueWorkflow()
    dag.df(a).zip(dag.df(b), how="full_outer", partition=dict(by=["s"])).transform(
        stats, schema="s:str,n1:int,n2:int"
    ).yield_dataframe_as("r", as_local=True)
    res = dag.run(engine).yields["r"].result.as_pandas()
    got = {(None if pd.isna(r["s"]) else r["s"]): (r["n1"], r["n2"]) for _, r in res.iterrows()}
    assert got == {"x": (2, 1), "y": (1, 1), "z": (1, 0), "w": (0, 1), None: (1, 1)}


def test_device_comap_output_and_on_init(engine, no_blobs):
    """``on_init`` runs once over empty frames; the output is a frame of
    the engine."""
    a, b = _frames(4, 50, 40, keys=4)
    inits = []

    class Counted(text.CoTransformer):
        def get_output_schema(self, dfs):
            return "k:long,n1:long,n2:long,sv:double"

        def on_init(self, dfs):
            inits.append([d.count() for d in dfs.values()])

        def transform(self, dfs):
            return _count_sides(self.cursor, dfs)

    dag = twf.FugueWorkflow()
    dag.zip(dag.df(a), dag.df(b), partition={"by": ["k"]}).transform(Counted).yield_dataframe_as("r")
    res = dag.run(engine).yields["r"].result
    assert inits == [[0, 0]]
    ka, kb = set(a["k"]), set(b["k"])
    assert sorted(r[0] for r in _rows(res)) == sorted(ka & kb)


# ---- sorted streams (test_streaming.py :850-933) -----------------------------------


def _sorted_stream(ns, pdf, schema, step):
    def gen():
        for s in range(0, len(pdf), step):
            yield ns.PandasDataFrame(pdf.iloc[s : s + step], schema)

    return ns.Stream(gen(), schema=schema)


def _zip_merge():
    def merge(d1: pd.DataFrame, d2: pd.DataFrame) -> pd.DataFrame:
        k = int(d1["k"].iloc[0]) if len(d1) else int(d2["k"].iloc[0])
        return pd.DataFrame({"k": [k], "n1": [len(d1)], "n2": [len(d2)],
                             "sv": [float(d1["v"].sum()) if len(d1) else 0.0]})

    return merge


def _stream_engines(jax_chunk: int, chunk: int):
    return (JaxExecutionEngine({**REF_CONF, CHUNK: jax_chunk}),
            TorchExecutionEngine(device="cpu", conf={CHUNK: chunk}))


def case_stream(ns, e, a, b, how, steps):
    dag = ns.FugueWorkflow()
    za = dag.df(_sorted_stream(ns, a, "k:long,v:double", steps[0]))
    zb = dag.df(_sorted_stream(ns, b, "k:long,w:double", steps[1]) if steps[1] else b)
    res = dag.zip(za, zb, how=how, partition={"by": ["k"]}).transform(
        _zip_merge(), schema="k:long,n1:long,n2:long,sv:double"
    )
    res.yield_dataframe_as("r", as_local=True)
    dag.run(e)
    return dag.yields["r"].result


@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_streaming_zip_comap(how):
    rng = np.random.default_rng(11)
    a = pd.DataFrame({"k": np.sort(rng.integers(0, 30, 900)), "v": rng.random(900)})
    b = pd.DataFrame({"k": np.sort(rng.integers(5, 35, 400)), "w": rng.random(400)})
    ref_e, port_e = _stream_engines(128, 128)
    ref = case_stream(REF, ref_e, a, b, how, (97, 61))
    got = case_stream(PORT, port_e, a, b, how, (97, 61))
    _same(got, ref)
    exp_keys = sorted(set(a["k"]) & set(b["k"])) if how == "inner" else sorted(set(a["k"]))
    assert sorted(r[0] for r in _rows(got)) == exp_keys
    assert tstreaming.last_run_stats["verb"] == "comap"
    assert tstreaming.last_run_stats["chunks"] >= 10


@pytest.mark.parametrize("case", ["unsorted", "force_drain", "null_key"])
def test_streaming_zip_errors(case):
    """An unsorted stream, within a chunk or across chunks (also through
    the drain of an input pinned at the horizon), and a NULL key raise
    ``FugueInvalidOperation`` on both."""
    if case == "unsorted":
        a = pd.DataFrame({"k": [3, 1, 2], "v": [1.0, 2.0, 3.0]})
        b = pd.DataFrame({"k": [1, 2], "w": [1.0, 2.0]})
        chunk, steps, match = 2, (2, 2), "not sorted ascending"
    elif case == "force_drain":
        a = pd.DataFrame({"k": [2, 2, 5, 5, 5, 2, 9], "v": [1.0] * 7})
        b = pd.DataFrame({"k": [2, 5, 9], "w": [1.0] * 3})
        chunk, steps, match = 2, (2, 1), "not sorted ascending"
    else:
        a = pd.DataFrame({"k": pd.array([1, 2, None, 4], dtype="Int64"), "v": [1.0] * 4})
        b = pd.DataFrame({"k": [1, 2, 4], "w": [1.0] * 3})
        chunk, steps, match = 2, (2, 2), "NULL keys"
    errs = []
    for ns, e in zip((REF, PORT), _stream_engines(chunk, chunk)):
        with pytest.raises(Exception, match=match) as err:
            case_stream(ns, e, a, b, "inner", steps)
        errs.append(type(err.value).__name__)
    assert errs[0] == errs[1] == "FugueInvalidOperation"


def test_streaming_zip_bounded_dim_any_order():
    """A bounded input needs no sorting: it is sorted on the host."""
    rng = np.random.default_rng(3)
    a = pd.DataFrame({"k": np.sort(rng.integers(0, 10, 200)), "v": rng.random(200)})
    dim = pd.DataFrame({"k": [3, 1, 2, 7], "w": [1.0, 2.0, 3.0, 4.0]})
    ref_e, port_e = _stream_engines(32, 32)
    ref = case_stream(REF, ref_e, a, dim, "inner", (37, None))
    got = case_stream(PORT, port_e, a, dim, "inner", (37, None))
    _same(got, ref)
    assert sorted(r[0] for r in _rows(got)) == sorted(set(a["k"]) & set(dim["k"]))


# ---- chip_smoke.py's cogroup_path phase, at small size --------------------------------


# the phase with the torch.cuda calls it makes as no-ops, in a process of
# its own that loads no JAX, as chip_smoke.py runs on the card
_COGROUP_PATH_ON_THE_CPU = """
import json, sys, numpy as np, pandas as pd, torch
import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine, frame_from_numpy
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
out = chip_smoke.phase_cogroup_path(torch, np, pd, bg, api, ff, col, frame_from_numpy,
                                    TorchExecutionEngine(device="cpu"), 0, rows=16_000, b_rows=2_000,
                                    stream_rows=6_000, stream_chunk=1_000, stream_keys=300, ctx_rows=20_000)
print("RESULT", json.dumps({c: [r["rows_out"], r["launches"]] for c, r in out["cells"].items()}))
print("JAX", "jax" in sys.modules or "fugue_tpu" in sys.modules)
"""


def test_chip_smoke_cogroup_path_on_the_cpu():
    """The phase's three cells and the engine-context check pass their
    oracles at small size, with no binned-sum launch, and load no JAX."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _COGROUP_PATH_ON_THE_CPU], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines() if line.startswith(("RESULT", "JAX")))
    cells = json.loads(lines["RESULT"])
    zero = {"bin_sum": 0, "bin_sum_count": 0}
    # the phase checked each cell's keys against its oracle: 2,000 rows of b
    # hold 833 of a's 1,000 keys
    assert cells == {"cogroup-uniform-1k": [833, zero], "sql-cogroup-uniform-1k": [833, zero],
                     "stream-cogroup": [300, zero]}
    assert lines["JAX"] == "False"
