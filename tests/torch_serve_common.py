"""The two packages side by side for the serving and view parity tests.

``Pkg("ref")`` is the JAX package on its ``NativeExecutionEngine`` (the
engine of ``tests/serve`` and ``tests/views``); ``Pkg("native")`` and
``Pkg("torch")`` are the port on its ``NativeExecutionEngine`` and on
``TorchExecutionEngine(device="cpu")``. A case is written once against a
``Pkg`` and returns what it observed (results, rejection reasons, counter
values, execution order, HTTP statuses, generations); a test runs it
through the reference and the port and compares the two.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace
from typing import Any

import pandas as pd


class Pkg(SimpleNamespace):
    def __init__(self, name: str):
        super().__init__(name=name)
        if name == "ref":
            import fugue_tpu.constants as constants
            import fugue_tpu.serve as serve
            import fugue_tpu.views as views
            from fugue_tpu import FugueWorkflow
            from fugue_tpu.cache.store import ArtifactStore
            from fugue_tpu.column import col, functions
            from fugue_tpu.dist import heartbeat, lease
            from fugue_tpu.execution import NativeExecutionEngine
            from fugue_tpu.execution.factory import try_get_context_execution_engine
            from fugue_tpu.obs import events, get_sampler, get_span_metrics, get_tracer
            from fugue_tpu.obs.metrics import run_labels
            from fugue_tpu.resilience import InjectedFaultError

            self.make_engine = lambda conf=None: NativeExecutionEngine(conf)
            self.http_server = "fugue_tpu.rpc.http.HttpRPCServer"
        else:
            import fugue_tpu_torch.constants as constants
            import fugue_tpu_torch.serve as serve
            import fugue_tpu_torch.views as views
            from fugue_tpu_torch.cache.store import ArtifactStore
            from fugue_tpu_torch.column import col, functions
            from fugue_tpu_torch.dist import heartbeat, lease
            from fugue_tpu_torch.execution import NativeExecutionEngine
            from fugue_tpu_torch.execution.factory import try_get_context_execution_engine
            from fugue_tpu_torch.obs import events, get_sampler, get_span_metrics, get_tracer
            from fugue_tpu_torch.obs.metrics import run_labels
            from fugue_tpu_torch.resilience import InjectedFaultError
            from fugue_tpu_torch.torch import TorchExecutionEngine
            from fugue_tpu_torch.workflow import FugueWorkflow

            if name == "native":
                self.make_engine = lambda conf=None: NativeExecutionEngine(conf)
            else:
                self.make_engine = lambda conf=None: TorchExecutionEngine(device="cpu", conf=conf)
            self.http_server = "fugue_tpu_torch.rpc.http.HttpRPCServer"
        self.c = constants
        self.serve = serve
        self.views = views
        self.FugueWorkflow = FugueWorkflow
        self.ArtifactStore = ArtifactStore
        self.col = col
        self.ff = functions
        self.heartbeat = heartbeat
        self.lease = lease
        self.events = events
        self.get_sampler = get_sampler
        self.get_span_metrics = get_span_metrics
        self.get_tracer = get_tracer
        self.run_labels = run_labels
        self.InjectedFaultError = InjectedFaultError
        self.context_engine = try_get_context_execution_engine

    def __repr__(self) -> str:  # the test ids
        return self.name

    def __reduce__(self):  # a factory sent over HTTP carries its Pkg by name
        return Pkg, (self.name,)


REF = Pkg("ref")
PORTS = ["native", "torch"]


class Gate:
    """A submission whose execution blocks until released: the knob that
    makes queue states deterministic."""

    def __init__(self, pkg: Pkg) -> None:
        self.pkg = pkg
        self.release = threading.Event()
        self.entered = threading.Event()

    def dag(self) -> Any:
        gate = self

        def make() -> pd.DataFrame:
            gate.entered.set()
            assert gate.release.wait(30), "gate never released"
            return pd.DataFrame({"a": [1]})

        dag = self.pkg.FugueWorkflow()
        dag.create(make, schema="a:long").yield_dataframe_as("g", as_local=True)
        return dag


def agg_dag(pkg: Pkg, seed: int = 0, rows: int = 64, as_local: bool = True) -> Any:
    col, ff = pkg.col, pkg.ff
    dag = pkg.FugueWorkflow()
    (
        dag.df(pd.DataFrame({"k": [i % 4 for i in range(rows)], "v": [float(i + seed) for i in range(rows)]}))
        .partition_by("k")
        .aggregate(ff.sum(col("v")).alias("s"), ff.count(col("v")).alias("n"))
        .yield_dataframe_as("r", as_local=as_local)
    )
    return dag


def agg_factory(pkg: Pkg, seed: int = 0, rows: int = 64):
    return lambda: agg_dag(pkg, seed, rows)


def frame(result: Any, name: str = "r") -> pd.DataFrame:
    """A yielded frame as plain pandas, sorted by ``k``, in numpy dtypes."""
    df = result.yields[name].result.as_pandas()
    return plain(df.sort_values("k").reset_index(drop=True))


def plain(df: pd.DataFrame) -> pd.DataFrame:
    out = df.copy()
    for c in out.columns:
        if str(out[c].dtype) in ("Int64", "Int32"):
            out[c] = out[c].astype("int64")
        elif str(out[c].dtype) in ("Float64", "Float32"):
            out[c] = out[c].astype("float64")
    return out


def http_get(rpc: Any, path: str) -> tuple:
    url = f"http://{rpc.host}:{rpc.port}{path}"
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def expire_lease(path: str) -> None:
    """Age a lease or claim file past its lease, as time would: the
    holder's ``ts`` moved back, nothing else changed."""
    with open(path) as f:
        holder = json.load(f)
    holder["ts"] = time.time() - float(holder.get("lease_s", 0.0)) - 60.0
    with open(path, "w") as f:
        json.dump(holder, f)


def wait_for(cond, timeout: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True
