"""The two packages side by side for the dist tier's parity tests.

``Side("ref")`` is the JAX package, ``Side("port")`` the port. Each holds
the names a case needs (the tier, the workflow, the planner, the tracer,
the resilience taxonomy); its engines come from ``make_engine(kind,
conf)``: ``"native"`` is the package's ``NativeExecutionEngine``,
``"device"`` the reference's ``JaxExecutionEngine`` on the CPU mesh or the
port's ``TorchExecutionEngine(device="cpu")``. A case is written once
against a ``Side`` and returns what it observed; a test runs it through
both packages and compares.
"""

import os
import threading
from types import SimpleNamespace
from typing import Any

import pandas as pd


class Side(SimpleNamespace):
    def __init__(self, name: str):
        super().__init__(name=name)
        if name == "ref":
            import fugue_tpu.dist as dist
            import fugue_tpu.resilience as resilience
            from fugue_tpu import FugueWorkflow
            from fugue_tpu._utils.params import ParamDict
            from fugue_tpu.cache.store import ArtifactStore
            from fugue_tpu.column import col, functions
            from fugue_tpu.exceptions import FugueWorkflowError
            from fugue_tpu.execution import NativeExecutionEngine
            from fugue_tpu.obs import get_event_log, get_tracer, read_events, read_spools
            from fugue_tpu.plan import optimize_tasks, plan_distribution
            from fugue_tpu.shuffle.partitioner import bucket_ids, canonical_key_kinds

            def device(conf):
                from fugue_tpu.jax import JaxExecutionEngine

                return JaxExecutionEngine(conf)
        else:
            import fugue_tpu_torch.dist as dist
            import fugue_tpu_torch.resilience as resilience
            from fugue_tpu_torch._utils.params import ParamDict
            from fugue_tpu_torch.cache.store import ArtifactStore
            from fugue_tpu_torch.column import col, functions
            from fugue_tpu_torch.exceptions import FugueWorkflowError
            from fugue_tpu_torch.execution import NativeExecutionEngine
            from fugue_tpu_torch.obs import get_event_log, get_tracer, read_events, read_spools
            from fugue_tpu_torch.plan import optimize_tasks, plan_distribution
            from fugue_tpu_torch.shuffle.partitioner import bucket_ids, canonical_key_kinds
            from fugue_tpu_torch.workflow import FugueWorkflow

            def device(conf):
                from fugue_tpu_torch.torch import TorchExecutionEngine

                return TorchExecutionEngine(device="cpu", conf=conf)

        self.dist = dist
        self.resilience = resilience
        self.FugueWorkflow = FugueWorkflow
        self.ParamDict = ParamDict
        self.ArtifactStore = ArtifactStore
        self.col = col
        self.ff = functions
        self.FugueWorkflowError = FugueWorkflowError
        self.get_tracer = get_tracer
        self.read_events = read_events
        self.read_spools = read_spools
        self.get_event_log = get_event_log
        self.optimize_tasks = optimize_tasks
        self.plan_distribution = plan_distribution
        self.bucket_ids = bucket_ids
        self.canonical_key_kinds = canonical_key_kinds
        self.make_engine = lambda kind, conf=None: (
            NativeExecutionEngine(dict(conf or {})) if kind == "native" else device(dict(conf or {})))

    def __repr__(self) -> str:
        return self.name


REF, PORT = Side("ref"), Side("port")


class WorkerPool:
    """N in-process workers of ``side`` draining ``board`` on daemon
    threads (the reference tests' pool)."""

    def __init__(self, side: Side, board: Any, n: int, conf: dict, start_http: bool = False):
        os.makedirs(str(board), exist_ok=True)
        self.stop_file = os.path.join(str(board), "_stop")
        self.workers = [side.dist.DistWorker(str(board), f"w{i}", conf=dict(conf), start_http=start_http).start()
                        for i in range(n)]
        self.threads = [threading.Thread(target=w.serve_forever, kwargs={"stop_file": self.stop_file}, daemon=True)
                        for w in self.workers]
        for t in self.threads:
            t.start()

    def close(self) -> None:
        with open(self.stop_file, "w") as f:
            f.write("stop")
        for t in self.threads:
            t.join(timeout=10)
        for w in self.workers:
            w.stop()

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def dist_section(text: str, board: str) -> str:
    """The ``== distributed workflows`` section of an explain, its board
    path written as ``<board>``."""
    sec = text[text.index("== distributed workflows"):]
    end = sec.find("\n\n")
    for stop in ("\n== ", "\nAdaptive tuning"):
        at = sec.find(stop, 1)
        if at >= 0 and (end < 0 or at < end):
            end = at
    return (sec if end < 0 else sec[:end]).replace(board, "<board>")


def canon(pdf: pd.DataFrame) -> pd.DataFrame:
    """Rows sorted by every column, columns by name, numpy dtypes."""
    out = pdf.copy()
    for c in out.columns:
        if str(out[c].dtype) in ("Int64", "Int32"):
            out[c] = out[c].astype("int64")
        elif str(out[c].dtype) in ("Float64", "Float32"):
            out[c] = out[c].astype("float64")
    return out.sort_values(list(out.columns)).reset_index(drop=True).reindex(sorted(out.columns), axis=1)
