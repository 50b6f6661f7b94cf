"""The DAG runner, copied from ``fugue_tpu/workflow/_workflow_context.py``
(``_run_graph`` :182): binds the engine and the checkpoint path, and runs
the tasks in the order they were added, which is topological. With
``fugue.workflow.concurrency`` above 1 (default 1) the tasks whose inputs
are done run in a thread pool; each pool thread enters the engine's
``thread_scope`` (its device and stream) and a copy of the starting
context (the run's conf scope).

A task whose deterministic checkpoint exists loads it instead of running
(resume). The plan optimizer may run clones of the compiled tasks:
``result_aliases`` maps a compiled task to the task that computes its
result, and the handle of a result the rewrites removed raises
(``fugue_tpu/workflow/_workflow_context.py`` :67, :111-120). Not ported (ROADMAP.md A.10): the result cache, the distributed
pass, task retries and fault injection (:45-57, :120-160), the tracer's
spans and the RPC server; ``FugueWorkflow.run`` refuses the conf keys that
turn them on."""

import contextvars
import uuid as _uuid
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Set

from ..constants import FUGUE_CONF_WORKFLOW_CONCURRENCY
from ..dataframe import DataFrame
from ..exceptions import FugueWorkflowError, FugueWorkflowRuntimeError
from ..execution.execution_engine import ExecutionEngine
from ._checkpoint import CheckpointPath, StrongCheckpoint
from ._tasks import FugueTask


class FugueWorkflowContext:
    def __init__(self, execution_engine: ExecutionEngine, conf: Any = None):
        # conf: the run's merge of the engine's conf and the workflow's
        conf = conf if conf is not None else execution_engine.conf
        self._engine = execution_engine
        self._conf = conf
        self._checkpoint_path = CheckpointPath(execution_engine, conf=conf)
        self._results: Dict[int, DataFrame] = {}
        self._aliases: Dict[int, FugueTask] = {}
        self._removed: Set[int] = set()

    @property
    def execution_engine(self) -> ExecutionEngine:
        return self._engine

    @property
    def checkpoint_path(self) -> CheckpointPath:
        return self._checkpoint_path

    def get_result(self, task: FugueTask) -> DataFrame:
        t = self._aliases.get(id(task), task)
        if id(t) not in self._results and id(task) in self._removed:
            raise FugueWorkflowError(
                "this task's intermediate result was optimized away by the "
                "plan optimizer (fused into a neighbor or repositioned by "
                "filter pushdown); pin it with persist()/checkpoint()/"
                "yield_dataframe_as(), or disable the optimizer with "
                "fugue.tpu.plan.optimize=false"
            )
        return self._results[id(t)]

    def has_result(self, task: FugueTask) -> bool:
        return id(self._aliases.get(id(task), task)) in self._results

    def run(
        self,
        tasks: List[FugueTask],
        result_aliases: Optional[Dict[int, FugueTask]] = None,
        removed_results: Optional[Set[int]] = None,
    ) -> None:
        self._aliases = result_aliases or {}
        self._removed = removed_results or set()
        self._checkpoint_path.init_temp_path(str(_uuid.uuid4()))
        # a one-pass stream consumed by more than one task is read whole
        # once, or the second consumer would find it exhausted
        self._consumers: Dict[int, int] = {}
        for t in tasks:
            for d in t.inputs:
                self._consumers[id(d)] = self._consumers.get(id(d), 0) + 1
        # the RPC server's start/stop is counted (RPCHandler._running), so
        # concurrent runs on one engine share one live server and the last
        # to finish stops it
        rpc_server = self._engine.rpc_server
        rpc_server.start()
        try:
            self._run_graph(tasks)
        finally:
            rpc_server.stop()
            self._checkpoint_path.remove_temp_path()

    def _run_graph(self, tasks: List[FugueTask]) -> None:
        concurrency = int(self._conf.get(FUGUE_CONF_WORKFLOW_CONCURRENCY, 1))
        if concurrency <= 1:
            for t in tasks:
                self._run_task(t)
            return
        thread_scope = self._engine.thread_scope()

        def in_thread(t: FugueTask) -> None:
            with thread_scope():
                self._run_task(t)

        remaining = {id(t): t for t in tasks}
        done: Set[int] = set()
        running: Dict[Future, int] = {}
        first_error: List[BaseException] = []
        with ThreadPoolExecutor(max_workers=concurrency) as pool:
            while (remaining or running) and not first_error:
                ready = [t for t in list(remaining.values()) if all(id(d) in done for d in t.inputs)]
                for t in ready:
                    del remaining[id(t)]
                    running[pool.submit(contextvars.copy_context().run, in_thread, t)] = id(t)
                if not running:
                    if remaining:
                        raise FugueWorkflowRuntimeError("workflow graph has a cycle")
                    break
                finished, _ = wait(list(running.keys()), return_when=FIRST_COMPLETED)
                for f in finished:
                    tid = running.pop(f)
                    exc = f.exception()
                    if exc is not None:
                        first_error.append(exc)
                    else:
                        done.add(tid)
        if first_error:
            raise first_error[0]

    def _run_task(self, task: FugueTask) -> None:
        try:
            self._run_task_once(task)
        except Exception as ex:
            if task.defined_at and hasattr(ex, "add_note"):
                ex.add_note(f"[fugue-tpu-torch] failing task defined at {task.defined_at}")
            raise

    def _run_task_once(self, task: FugueTask) -> None:
        cp = task.checkpoint
        if isinstance(cp, StrongCheckpoint):
            tid = task.__uuid__()
            cp.set_id(tid)
            if cp.exists(self._checkpoint_path, tid):
                df = cp.load(self._checkpoint_path)
                if task.broadcast_flag:
                    df = self._engine.broadcast(df)
                if task.yield_dataframe_handler is not None:
                    task.yield_dataframe_handler(df)
                self._results[id(task)] = df
                return
        inputs = [self._results[id(d)] for d in task.inputs]
        result = task.execute(self, inputs)
        if result is not None:
            result = task.set_result(self, result)
            if self._consumers.get(id(task), 0) > 1 and result.is_local and not result.is_bounded:
                result = result.as_local_bounded()
            self._results[id(task)] = result
