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
(``fugue_tpu/workflow/_workflow_context.py`` :67, :111-120).

Resilience and spans (:20-55, :240-300, :367): the run's fault plan
(``fugue.tpu.fault.plan``, one budget for the whole run) fires at
``task.execute`` before each task body, and each task runs under the
task ``RetryPolicy`` (``fugue.tpu.retry.task.*``, one attempt unless set):
a failure that is not deterministic is retried, and each attempt first
re-reads the task's strong checkpoint, so work that reached storage
replays (``workflow.checkpoint_replays``) instead of running again. Each
task is one ``workflow.task`` span, parented explicitly on the
``workflow.run`` span so the tasks of pool threads nest under it too.
Not ported (ROADMAP.md A.10): the result cache and the distributed pass
(:120-160); ``FugueWorkflow.run`` refuses the conf keys that turn them
on."""

import contextvars
import time
import uuid as _uuid
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Set

from ..constants import FUGUE_CONF_WORKFLOW_CONCURRENCY
from ..dataframe import DataFrame
from ..exceptions import FugueWorkflowError, FugueWorkflowRuntimeError
from ..execution.execution_engine import ExecutionEngine
from ..obs import get_tracer
from ..resilience import SITE_TASK_EXECUTE, FaultInjector, RetryPolicy, classify_failure
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
        # the fault budgets span the run: `error@1` fails one task once,
        # not once an attempt
        self._injector = FaultInjector.from_conf(conf)
        self._task_policy = RetryPolicy.from_conf(
            conf, prefix="fugue.tpu.retry.task", default_attempts=1
        )
        self._trace_root: Optional[str] = None

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
        # the workflow.run span of this thread: tasks on pool threads, whose
        # span stacks are empty, parent on it explicitly
        self._trace_root = get_tracer().current_span_id()
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
        """One task under the task retry policy. A deterministic (POISON)
        failure is never retried: the same inputs fail the same way."""
        policy = self._task_policy
        attempts = 0
        with get_tracer().span(
            "workflow.task",
            cat="workflow",
            parent=self._trace_root,
            task=task.name or type(task).__name__,
        ) as sp:
            while True:
                try:
                    self._run_task_once(task)
                    sp.set(attempts=attempts + 1)
                    return
                except Exception as ex:
                    cat = classify_failure(ex)
                    attempts += 1
                    if not policy.should_retry(cat, attempts):
                        sp.set(attempts=attempts)
                        if task.defined_at and hasattr(ex, "add_note"):
                            ex.add_note(
                                f"[fugue-tpu-torch] failing task defined at {task.defined_at}"
                            )
                        raise
                    self._engine.resilience_stats.inc("workflow.task_retries")
                    self._engine.log.warning(
                        "task %s failed with %s [%s]; retry %d/%d",
                        task.name or type(task).__name__,
                        type(ex).__name__,
                        cat.value,
                        attempts,
                        policy.max_attempts - 1,
                    )
                    time.sleep(policy.delay(attempts, seed=task.__uuid__()))

    def _run_task_once(self, task: FugueTask) -> None:
        cp = task.checkpoint
        if isinstance(cp, StrongCheckpoint):
            tid = task.__uuid__()
            cp.set_id(tid)
            if cp.exists(self._checkpoint_path, tid):
                self._engine.resilience_stats.inc("workflow.checkpoint_replays")
                with get_tracer().span("task.checkpoint_replay", cat="workflow", task_uuid=tid):
                    df = cp.load(self._checkpoint_path)
                    if task.broadcast_flag:
                        df = self._engine.broadcast(df)
                    if task.yield_dataframe_handler is not None:
                        task.yield_dataframe_handler(df)
                    self._results[id(task)] = df
                return
        inputs = [self._results[id(d)] for d in task.inputs]
        self._injector.fire(SITE_TASK_EXECUTE)
        result = task.execute(self, inputs)
        if result is not None:
            result = task.set_result(self, result)
            if self._consumers.get(id(task), 0) > 1 and result.is_local and not result.is_bounded:
                result = result.as_local_bounded()
            self._results[id(task)] = result
