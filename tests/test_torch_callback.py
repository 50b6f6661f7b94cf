"""Transformer callbacks (``fugue_tpu_torch/rpc``) against the JAX package's.

A transformer whose function takes a ``Callable`` after its frame gets a
client of the engine's RPC server (the in-process ``NativeRPCServer``),
which calls the callback the caller passed. Each case runs the same
function over the same seeded frames through ``api.transform``,
``api.out_transform``, a workflow, a cotransformer, FugueSQL's
``CALLBACK``, a streamed transform and a frame already on the device, on
``TorchExecutionEngine(device="cpu")`` and on ``JaxExecutionEngine`` (the
8-device CPU mesh, result cache off), and holds the number of calls and
what each call received equal, and the results equal. A callback an
analyzable UDF carries keeps it interpreted (reason ``callback``); the HTTP
server (ROADMAP.md A.10) raises ``NotImplementedError``.
"""

import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import fugue_tpu.api as fa
from fugue_tpu import FugueWorkflow as JFugueWorkflow
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
from fugue_tpu.jax import JaxExecutionEngine

from fugue_tpu_torch import api
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.rpc import NativeRPCServer, RPCFunc, make_rpc_server
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

REF_CONF = {"fugue.tpu.cache.enabled": False, "fugue.tpu.stream.chunk_rows": 256}
PORT_CONF = {"fugue.tpu.stream.chunk_rows": 256}


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine(REF_CONF)
    yield e
    e.stop()


@pytest.fixture(params=["device", "native"])
def engine(request):
    if request.param == "device":
        return TorchExecutionEngine(device="cpu", conf=PORT_CONF)
    return NativeExecutionEngine(PORT_CONF)


def _frame(n: int = 1000, keys: int = 13, seed: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, keys, n), "v": rng.random(n)})


class Recorder:
    """A callback that records what each call receives (calls may come
    from several threads)."""

    def __init__(self) -> None:
        self.calls: List[Any] = []
        self._lock = threading.Lock()

    def __call__(self, *args: Any) -> int:
        with self._lock:
            self.calls.append(args)
            return len(self.calls)

    @property
    def sorted(self) -> List[Any]:
        return sorted(self.calls)


def report(df: pd.DataFrame, cb: Callable) -> pd.DataFrame:
    # the key, the rows and their sum, once a partition
    cb(int(df["k"].iloc[0]) if len(df) else -1, len(df), round(float(df["v"].sum()), 9))
    return df.assign(n=len(df))


def optional_report(df: pd.DataFrame, cb: Optional[Callable] = None) -> pd.DataFrame:
    if cb is not None:
        cb(len(df))
    return df.assign(has=cb is not None)


def sink(df: pd.DataFrame, cb: Callable) -> None:
    cb(len(df), round(float(df["v"].sum()), 9))


def udf_translatable(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"] * 2.0
    return df


def _sorted_rows(pdf: pd.DataFrame) -> List[List[Any]]:
    return pdf.sort_values(list(pdf.columns)).values.tolist()


def test_api_transform_partitioned(jax_engine, engine):
    got_cb, exp_cb = Recorder(), Recorder()
    exp = fa.transform(_frame(), report, schema="*,n:long", partition={"by": ["k"]}, callback=exp_cb,
                       engine=jax_engine)
    got = api.transform(_frame(), report, schema="*,n:long", partition={"by": ["k"]}, callback=got_cb,
                        engine=engine)
    assert got_cb.sorted == exp_cb.sorted and len(got_cb.calls) == 13
    assert _sorted_rows(got) == _sorted_rows(exp)


def test_api_transform_optional_callback(jax_engine, engine):
    """An ``Optional[Callable]`` parameter gets the client when a callback
    is set and None when not, as on the JAX engine."""
    for callback in (None, Recorder()):
        exp_cb = Recorder() if callback is not None else None
        exp = fa.transform(_frame(), optional_report, schema="*,has:bool", callback=exp_cb, engine=jax_engine)
        got = api.transform(_frame(), optional_report, schema="*,has:bool", callback=callback, engine=engine)
        assert _sorted_rows(got) == _sorted_rows(exp)
        if callback is not None:
            assert callback.sorted == exp_cb.sorted


def test_api_out_transform(jax_engine, engine):
    got_cb, exp_cb = Recorder(), Recorder()
    fa.out_transform(_frame(), sink, partition={"by": ["k"]}, callback=exp_cb, engine=jax_engine)
    api.out_transform(_frame(), sink, partition={"by": ["k"]}, callback=got_cb, engine=engine)
    assert got_cb.sorted == exp_cb.sorted and sum(c[0] for c in got_cb.calls) == 1000


def test_required_callback_missing_raises(engine):
    """A function that requires a callback and is given none calls the
    unset client, which raises, as the JAX package's does."""
    with pytest.raises(Exception):
        api.transform(_frame(), report, schema="*,n:long", engine=engine)


def _workflow_case(m: Any, dag: Any, pdf: pd.DataFrame, cb: Recorder, out_cb: Recorder) -> None:
    a = dag.df(pdf)
    a.partition_by("k").transform(report, schema="*,n:long", callback=cb).yield_dataframe_as("r", as_local=True)
    a.partition_by("k").out_transform(sink, callback=out_cb)


def test_workflow(jax_engine, engine):
    res = {}
    for wf, eng in ((JFugueWorkflow, jax_engine), (FugueWorkflow, engine)):
        cb, out_cb = Recorder(), Recorder()
        dag = wf()
        _workflow_case(None, dag, _frame(), cb, out_cb)
        dag.run(eng)
        res[wf] = (cb.sorted, out_cb.sorted, _sorted_rows(dag.yields["r"].result.as_pandas()))
    assert res[FugueWorkflow] == res[JFugueWorkflow]
    assert len(res[FugueWorkflow][0]) == len(res[FugueWorkflow][1]) == 13


def merge_report(a: pd.DataFrame, b: pd.DataFrame, cb: Callable) -> pd.DataFrame:
    cb(int(a["k"].iloc[0]) if len(a) else int(b["k"].iloc[0]), len(a), len(b))
    return pd.DataFrame({"k": [a["k"].iloc[0] if len(a) else b["k"].iloc[0]], "na": [len(a)], "nb": [len(b)]})


def test_cotransformer(jax_engine, engine):
    """A cotransformer over a zipped frame gets the callback too, once a
    key, with what the JAX engine sends it."""
    res = {}
    for wf, eng in ((JFugueWorkflow, jax_engine), (FugueWorkflow, engine)):
        cb = Recorder()
        dag = wf()
        a, b = dag.df(_frame(300, 7, seed=1)), dag.df(_frame(200, 9, seed=2))
        (dag.zip(a, b, partition={"by": ["k"]}, how="full_outer")
         .transform(merge_report, schema="k:long,na:long,nb:long", callback=cb).yield_dataframe_as("r", as_local=True))
        dag.run(eng)
        res[wf] = (cb.sorted, _sorted_rows(dag.yields["r"].result.as_pandas()))
    assert res[FugueWorkflow] == res[JFugueWorkflow] and len(res[FugueWorkflow][0]) == 9


def test_server_runs_for_the_workflow_only(engine):
    """The engine's server starts for a run and stops after it: the
    handlers a run registered are gone, as in the JAX package."""
    cb = Recorder()
    dag = FugueWorkflow()
    _workflow_case(None, dag, _frame(200), cb, Recorder())
    dag.run(engine)
    server = engine.rpc_server
    assert isinstance(server, NativeRPCServer) and not server.running and server._handlers == {}
    assert len(cb.calls) == 13


def test_fugue_sql_callback(jax_engine, engine):
    """FugueSQL's ``CALLBACK <name>`` resolves the name in the caller's
    scope and hands it to the transformer."""
    pdf = _frame()
    sql = """
    r = TRANSFORM t PREPARTITION BY k USING report SCHEMA *,n:long CALLBACK recorder
    YIELD DATAFRAME AS r
    """
    recorder = Recorder()
    exp = fa.fugue_sql(sql, t=pdf, engine=jax_engine, as_fugue=True).as_pandas()
    exp_calls = recorder.sorted
    recorder.calls.clear()
    got = api.fugue_sql(sql, t=pdf, engine=engine, as_fugue=True).as_pandas()
    assert recorder.sorted == exp_calls and len(exp_calls) == 13
    assert _sorted_rows(got) == _sorted_rows(exp)


def _streams(pdf: pd.DataFrame, step: int = 256):
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)
    parts = [tbl.slice(s, step) for s in range(0, tbl.num_rows, step)]
    j = JStream((JArrowDataFrame(p) for p in parts), schema=JArrowDataFrame(tbl).schema)
    t = LocalDataFrameIterableDataFrame((ArrowDataFrame(p) for p in parts), schema=ArrowDataFrame(tbl).schema)
    return j, t


def test_streamed_transform(jax_engine):
    """A keyless transform of a one-pass stream calls the function, and
    so the callback, with the rows the JAX engine sends it."""
    pdf = _frame(1000)
    res = {}
    for wf, eng, src in ((JFugueWorkflow, jax_engine, _streams(pdf)[0]),
                         (FugueWorkflow, TorchExecutionEngine(device="cpu", conf=PORT_CONF), _streams(pdf)[1])):
        cb = Recorder()
        dag = wf()
        (dag.df(src).transform(optional_report, schema="*,has:bool", callback=cb).partition_by("has")
         .aggregate(n=_count(wf)).yield_dataframe_as("r", as_local=True))
        dag.run(eng)
        res[wf] = (cb.sorted, dag.yields["r"].result.as_pandas().values.tolist())
    assert res[FugueWorkflow] == res[JFugueWorkflow]
    assert sum(c[0] for c in res[FugueWorkflow][0]) == 1000


def _count(wf: Any) -> Any:
    if wf is JFugueWorkflow:
        from fugue_tpu.column import col, functions
    else:
        from fugue_tpu_torch.column import col, functions
    return functions.count(col("k"))


def test_device_frame(jax_engine):
    """A frame already on the device goes to the host once a partition's
    call, with the rows the JAX engine sends."""
    eng = TorchExecutionEngine(device="cpu")
    tdf = eng.persist(eng.to_df(_frame()))
    assert isinstance(tdf, TorchDataFrame)
    got_cb, exp_cb = Recorder(), Recorder()
    got = api.transform(tdf, report, schema="*,n:long", partition={"by": ["k"]}, callback=got_cb, engine=eng,
                        as_fugue=True)
    exp = fa.transform(jax_engine.to_df(_frame()), report, schema="*,n:long", partition={"by": ["k"]},
                       callback=exp_cb, engine=jax_engine, as_fugue=True)
    assert isinstance(got, TorchDataFrame)
    assert got_cb.sorted == exp_cb.sorted
    assert _sorted_rows(got.as_pandas()) == _sorted_rows(exp.as_pandas())


def test_callback_keeps_the_udf_interpreted():
    """The analyzer refuses a transform that carries a callback (reason
    ``callback``, as the reference's) where it would translate the UDF
    otherwise: the UDF runs as written. (A function that takes the
    callback refuses earlier, with ``signature``.)"""
    from fugue_tpu.analysis import analyze_transform_task as janalyze

    from fugue_tpu_torch.analysis import analyze_transform_task

    verdicts = []
    for wf, analyze in ((JFugueWorkflow, janalyze), (FugueWorkflow, analyze_transform_task)):
        dag = wf()
        dag.df(_frame(100)).transform(udf_translatable, schema="*,z:double", callback=print).show()
        task = [t for t in dag._tasks if t.params.get_or_none("transformer", object) is not None][0]
        a = analyze(task)
        verdicts.append((a.code, a.reason, a.steps))
    assert verdicts[0] == verdicts[1] and verdicts[1][0] == "callback"
    eng = TorchExecutionEngine(device="cpu")
    dag = FugueWorkflow()
    dag.df(_frame(100)).transform(udf_translatable, schema="*,z:double", callback=Recorder()).yield_dataframe_as(
        "r")
    dag.run(eng)
    assert eng.analysis_stats.as_dict()["refused"] == {"callback": 1}
    assert dag.last_plan_report.udfs_translated == 0 and dag.lint().udfs[0].status == "callback"


def test_rpc_server_from_conf():
    """``fugue.rpc.server`` unset gives the in-process server; a class
    name resolves. The port's HTTP server (``rpc/http.py``) builds from its
    name, and the engine binds itself to it; the JAX package's class is
    not a server of the port, and is refused."""
    from fugue_tpu_torch.rpc.http import HttpRPCServer

    assert isinstance(make_rpc_server(), NativeRPCServer)
    assert isinstance(make_rpc_server({"fugue.rpc.server": NativeRPCServer}), NativeRPCServer)
    name = "fugue_tpu_torch.rpc.http.HttpRPCServer"
    assert isinstance(make_rpc_server({"fugue.rpc.server": name}), HttpRPCServer)
    bound = TorchExecutionEngine(device="cpu", conf={"fugue.rpc.server": name})
    assert isinstance(bound.rpc_server, HttpRPCServer) and bound.rpc_server._metrics_engine() is bound
    for conf in ({"fugue.rpc.server": "fugue_tpu.rpc.http.HttpRPCServer"},):
        with pytest.raises(TypeError, match="not a subclass"):
            make_rpc_server(conf)
        with pytest.raises(TypeError, match="not a subclass"):
            TorchExecutionEngine(device="cpu", conf=conf).rpc_server
    server = NativeRPCServer()
    with server.start():
        client = server.make_client(RPCFunc(lambda a, b: a + b))
        assert client(2, 3) == 5
    assert not server.running and server._handlers == {}
    # an engine's server may be set: the transform's callback goes through it
    eng = TorchExecutionEngine(device="cpu")
    eng.set_rpc_server(server)
    cb = Recorder()
    api.transform(_frame(100), report, schema="*,n:long", callback=cb, engine=eng)
    assert eng.rpc_server is server and len(cb.calls) == 1 and not server.running
