"""The rest of the user API (``fugue_tpu_torch.api``) against ``fugue_tpu.api``.

The port's ``api`` exports every public name of the reference's. Each
frame function is held against the reference's on the same inputs, made
from a seed with numpy: a pandas frame on both, and a device frame (the
port's ``TorchDataFrame`` on the CPU, the reference's ``JaxDataFrame`` on
the 8-device CPU mesh). The engine context follows
``tests/core/test_api_facade.py:69-96`` and ``fugue_tpu_test/
execution_suite.py`` ``test_engine_context_api`` :547 on both packages,
and the tutorial's §2 block (``docs/tutorial.md:46-51``) runs inside
``engine_context`` with verbs called with no engine.
"""

import contextlib
import io
from typing import Any, Callable, Dict

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import fugue_tpu.api as fa
import fugue_tpu.column as jcolumn
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu_torch import api
from fugue_tpu_torch import column as tcolumn
from fugue_tpu_torch import workflow as twf
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.execution.factory import make_execution_engine
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine

from test_torch_sql import _same
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

REF_CONF = {"fugue.tpu.cache.enabled": False}


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine(REF_CONF)
    yield e
    e.stop()


@pytest.fixture(autouse=True)
def no_global_engine():
    """Each test starts and ends with no global engine on either package."""
    api.clear_global_engine()
    fa.clear_global_engine()
    yield
    api.clear_global_engine()
    fa.clear_global_engine()


def test_public_names_include_the_reference():
    ref = {n for n in dir(fa) if not n.startswith("_")}
    port = {n for n in dir(api) if not n.startswith("_")}
    assert ref - port == set()
    for name in ref:
        assert callable(getattr(api, name)), name


# ---- the frame functions ------------------------------------------------------------


def _pdf(seed: int = 0, n: int = 12) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame(
        {
            "a": rng.integers(0, 5, n),
            "b": np.round(rng.random(n), 3),
            "c": np.array(["x", "y", None], dtype=object)[rng.integers(0, 3, n)],
        }
    )


def _input(kind: str, side: str, jax_engine: Any) -> Any:
    pdf = _pdf()
    if kind == "pandas":
        return pdf
    if side == "ref":
        return jax_engine.to_df(pdf)
    return TorchDataFrame(pdf, device="cpu")


def _frame_result(res: Any) -> Any:
    """A frame result, as its type's name and its rows under its names."""
    if isinstance(res, pd.DataFrame):
        return res
    return res.to_pandas() if isinstance(res, pa.Table) else res.as_pandas()


# each function, the call, and how its results compare
FRAME_FUNCTIONS: Dict[str, Callable[[Any, Any], Any]] = {
    "as_pandas": lambda m, df: m.as_pandas(df),
    "as_arrow": lambda m, df: m.as_arrow(df).to_pandas(),
    "as_array": lambda m, df: m.as_array(df, type_safe=True),
    "as_array_iterable": lambda m, df: list(m.as_array_iterable(df, columns=["c", "a"], type_safe=True)),
    "as_dicts": lambda m, df: m.as_dicts(df),
    "as_dict_iterable": lambda m, df: list(m.as_dict_iterable(df, columns=["b"])),
    "as_local": lambda m, df: m.as_local(df, as_fugue=True).as_pandas(),
    "as_local_bounded": lambda m, df: m.as_local_bounded(df, as_fugue=True).as_pandas(),
    "as_fugue_df": lambda m, df: m.as_fugue_df(df).as_pandas(),
    "as_fugue_dataset": lambda m, df: m.as_fugue_dataset(df).count(),
    "peek_array": lambda m, df: m.peek_array(df),
    "peek_dict": lambda m, df: m.peek_dict(df),
    "head": lambda m, df: _frame_result(m.head(df, 5, columns=["a", "c"])),
    "count": lambda m, df: m.count(df),
    "is_df": lambda m, df: (m.is_df(df), m.is_df([1, 2])),
    "is_empty": lambda m, df: m.is_empty(df),
    "is_local": lambda m, df: m.is_local(df),
    "is_bounded": lambda m, df: m.is_bounded(df),
    "rename": lambda m, df: _frame_result(m.rename(df, {"a": "aa", "c": "cc"})),
    "alter_columns": lambda m, df: _frame_result(m.alter_columns(df, "a:double")),
    "drop_columns": lambda m, df: _frame_result(m.drop_columns(df, ["b"])),
    "select_columns": lambda m, df: _frame_result(m.select_columns(df, ["c", "a"])),
    "get_schema": lambda m, df: str(m.get_schema(df)),
    "get_column_names": lambda m, df: m.get_column_names(df),
    "normalize_column_names": lambda m, df: (
        lambda r: (_frame_result(r[0]).columns.tolist(), r[1])
    )(m.normalize_column_names(m.rename(df, {"a": "a b"}))),
    "show": lambda m, df: _shown(m, df),
}


def _shown(m: Any, df: Any) -> bool:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert m.show(df, n=3, with_count=True, title="t") is None
    return all(name in out.getvalue() for name in ("a", "b", "c"))


def _equal(got: Any, exp: Any) -> None:
    if isinstance(exp, pd.DataFrame):
        _same(got, exp, ordered=True)
    else:
        assert repr(got) == repr(exp)


@pytest.mark.parametrize("kind", ["pandas", "device"])
@pytest.mark.parametrize("name", sorted(FRAME_FUNCTIONS))
def test_frame_function(name, kind, jax_engine):
    fn = FRAME_FUNCTIONS[name]
    exp = fn(fa, _input(kind, "ref", jax_engine))
    got = fn(api, _input(kind, "port", jax_engine))
    _equal(got, exp)


FRAME_RESULTS = {
    "head": lambda m, df: m.head(df, 5),
    "rename": lambda m, df: m.rename(df, {"a": "x"}),
    "alter_columns": lambda m, df: m.alter_columns(df, "a:double"),
    "drop_columns": lambda m, df: m.drop_columns(df, ["b"]),
    "select_columns": lambda m, df: m.select_columns(df, ["b"]),
    "as_local": lambda m, df: m.as_local(df),
    "as_local_bounded": lambda m, df: m.as_local_bounded(df),
}


@pytest.mark.parametrize("name", sorted(FRAME_RESULTS))
def test_frame_functions_return_the_reference_native_type(name):
    """A pandas input gives back the native type the reference's gives
    (C13: ``head`` gave an arrow table)."""
    call = FRAME_RESULTS[name]
    assert type(call(api, _pdf())) is type(call(fa, _pdf()))


@pytest.mark.parametrize("kind", ["pandas", "device"])
def test_frame_functions_keep_the_input_kind(kind, jax_engine):
    """A function that returns a frame returns a frame for a frame, and
    what the result wraps otherwise."""
    for m, side in ((fa, "ref"), (api, "port")):
        df = _input(kind, side, jax_engine)
        res = m.rename(df, {"a": "x"})
        assert isinstance(res, pd.DataFrame) == (kind == "pandas")
        assert m.rename(df, {}) is df


def test_get_num_partitions(jax_engine):
    """1 for a pandas frame on both; a device frame has one partition on
    one card, where the reference's has one a device of its mesh."""
    assert api.get_num_partitions(_pdf()) == fa.get_num_partitions(_pdf()) == 1
    assert api.get_num_partitions(TorchDataFrame(_pdf(), device="cpu")) == 1
    assert fa.get_num_partitions(jax_engine.to_df(_pdf())) == len(jax_engine.to_df(_pdf()).mesh.devices.flat)


def test_as_local_reads_a_stream_whole():
    """``as_local`` of a one-pass stream is its rows in one local frame,
    as in the reference (C12)."""
    from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
    from fugue_tpu.dataframe import PandasDataFrame as JPandas
    from fugue_tpu_torch.dataframe import LocalDataFrameIterableDataFrame, PandasDataFrame

    pdf = _pdf()
    ref = JStream(iter([JPandas(pdf.iloc[:5]), JPandas(pdf.iloc[5:])]), schema="a:long,b:double,c:str")
    got = LocalDataFrameIterableDataFrame(iter([PandasDataFrame(pdf.iloc[:5]), PandasDataFrame(pdf.iloc[5:])]),
                                          schema="a:long,b:double,c:str")
    r, g = fa.as_local(ref, as_fugue=True), api.as_local(got, as_fugue=True)
    assert r.is_bounded and g.is_bounded
    _same(g, r, ordered=True)


# ---- the engine context --------------------------------------------------------------


@pytest.mark.parametrize("m", [fa, api], ids=["ref", "port"])
def test_engine_context_nesting(m):
    with m.engine_context("native") as e1:
        with m.engine_context("pandas") as e2:
            assert m.get_context_engine() is e2
        assert m.get_context_engine() is e1
    with pytest.raises(Exception):
        m.get_context_engine()


@pytest.mark.parametrize("m", [fa, api], ids=["ref", "port"])
def test_global_engine(m):
    e = m.set_global_engine("native")
    try:
        assert m.get_context_engine() is e and e.is_global
        with m.engine_context("pandas") as inner:
            assert m.get_context_engine() is inner
        assert m.get_context_engine() is e
    finally:
        m.clear_global_engine()
    assert not e.is_global


@pytest.mark.parametrize("m", [fa, api], ids=["ref", "port"])
def test_parallelism(m):
    assert m.get_current_parallelism(engine="native") == 1


def test_parallelism_of_the_device_engine():
    assert api.get_current_parallelism(engine="torch", device="cpu") == 1


@pytest.mark.parametrize("make", [lambda: TorchExecutionEngine(device="cpu"), NativeExecutionEngine],
                         ids=["device", "native"])
def test_engine_context_api(make):
    """``execution_suite.py`` ``test_engine_context_api`` :547."""
    with api.engine_context(make()) as e:
        assert api.get_context_engine() is e
        assert api.get_current_conf() is e.conf
    assert api.get_current_conf()["fugue.workflow.concurrency"] == fa.get_current_conf()[
        "fugue.workflow.concurrency"
    ]


def test_engine_none_resolves_to_the_context_then_the_frame():
    """``engine=None``: the context engine, else the global one, else the
    torch engine on a ``TorchDataFrame`` input's own device; a workflow
    with no engine runs on the context engine."""
    e = TorchExecutionEngine(device="cpu")
    with api.engine_context(e):
        assert make_execution_engine() is e
        assert make_execution_engine(device="cpu") is e  # device applies to a new engine only
        dag = twf.FugueWorkflow()
        dag.df(_pdf()).yield_dataframe_as("r")
        dag.run()
        assert dag._last_engine is e
        assert isinstance(dag.yields["r"].result, TorchDataFrame)
    g = api.set_global_engine("native")
    assert make_execution_engine() is g
    api.clear_global_engine()
    tdf = TorchDataFrame(_pdf(), device="cpu")
    inferred = make_execution_engine(infer_by=[_pdf(), tdf])
    assert isinstance(inferred, TorchExecutionEngine) and inferred.device == tdf.device
    res = api.distinct(tdf)
    assert isinstance(res, TorchDataFrame) and res.device.type == "cpu"


def test_run_engine_function_and_as_fugue_engine_df(jax_engine):
    e = TorchExecutionEngine(device="cpu")
    got = api.run_engine_function(lambda x: api.as_fugue_engine_df(x, _pdf()), engine=e, as_fugue=True)
    exp = fa.run_engine_function(lambda x: fa.as_fugue_engine_df(x, _pdf()), engine=jax_engine, as_fugue=True)
    assert isinstance(got, TorchDataFrame)
    _same(got, exp)
    assert api.run_engine_function(lambda x: x.to_df(_pdf()).count(), engine=e) == 12
    assert api.run_engine_function(lambda x: 5, engine="native") == 5


def test_tutorial_block_in_an_engine_context(tmp_path, jax_engine, monkeypatch):
    """``docs/tutorial.md:46-51`` with the port's engine as the context
    engine: every verb, called with no engine, runs on it; the output
    equals the reference's in its own context."""
    rng = np.random.default_rng(7)
    src = tmp_path / "data.parquet"
    pd.DataFrame({"k": rng.integers(0, 9, 500), "v": rng.random(500)}).to_parquet(src)
    e = TorchExecutionEngine(device="cpu")
    calls = []
    real = e.aggregate
    monkeypatch.setattr(e, "aggregate", lambda *a, **k: calls.append(1) or real(*a, **k))

    def block(m, col, f, engine, out):
        with m.engine_context(engine):
            big = m.load(str(src))
            flt = m.filter(big, col("v") > 0.5)
            agg = m.aggregate(flt, partition_by="k", s=f.sum(col("v")))
            m.save(agg, str(out), partition={"by": ["k"]})
        return pd.read_parquet(out)

    got = block(api, tcolumn.col, tcolumn.functions, e, tmp_path / "port.parquet")
    exp = block(fa, jcolumn.col, jcolumn.functions, jax_engine, tmp_path / "ref.parquet")
    assert calls == [1]
    cols = ["k", "s"]
    got = got[cols].assign(k=got["k"].astype(int)).sort_values("k").reset_index(drop=True)
    exp = exp[cols].assign(k=exp["k"].astype(int)).sort_values("k").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, exp, check_dtype=False)
