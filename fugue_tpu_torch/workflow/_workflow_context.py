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

The result cache (:120-135, :305-430; ``fugue_tpu_torch/cache``): with
the engine's cache and the run's conf both on, ``run`` fingerprints the
optimized DAG, cuts it at the deepest cached frontier and loads the
frontier frames (``plan_cache``); tasks upstream of the cut never run. A
hit is one ``task.cache_hit`` span, a grown source's partial hit one
``task.delta_recompute`` span over the new partitions only, and every
finished bounded result is published under its fingerprint
(``cache.publish`` span), with the delta manifest kept up to date.

The distributed pass (:137-160, :342-365; ``plan/distribute.py``): with
``fugue.tpu.dist.board`` set, ``run`` plans after the cache cut, and each
distributable fragment runs as leased map and reduce tasks on the
board's workers (host engines); its interior tasks never run here, and
only the fragment's combined frame lands, through ``engine.to_df`` (on
the card for a ``TorchExecutionEngine``), under a
``dist.workflow_fragment`` span. Every task downstream of that point
runs on this engine."""

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
        self._cache_plan: Any = None
        self._dist_plan: Any = None
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
        plan = self._cache_plan
        if id(t) not in self._results and plan is not None and id(t) in plan.skipped:
            raise FugueWorkflowError(
                "this task was never executed: a downstream result-cache "
                "hit cut the plan above it (fugue_tpu_torch/cache); pin it "
                "with persist()/checkpoint()/yield_dataframe_as() to keep it "
                "addressable, or disable the cache with "
                "fugue.tpu.cache.enabled=false"
            )
        dp = self._dist_plan
        if id(t) not in self._results and dp is not None and id(t) in dp.interior_ids:
            raise FugueWorkflowError(
                "this task executed REMOTELY as a leased board task inside a "
                "distributed workflow fragment (fugue_tpu_torch/plan/"
                "distribute.py); its intermediate frame never materialized "
                "in this process. Pin it with persist()/checkpoint()/"
                "yield_dataframe_as() to keep it local, or set "
                "fugue.tpu.dist.enabled=false"
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
        # the result cache: fingerprint the optimized DAG, cut it at the
        # deepest cached frontier and load the frontier frames; tasks
        # upstream of the cut never run. Off (the engine's
        # fugue.tpu.cache.enabled=false), this is one boolean check
        self._cache_plan = None
        cache = self._engine.result_cache
        if cache.enabled:
            from ..cache import plan_cache

            self._cache_plan = plan_cache(tasks, self._engine, cache, self._checkpoint_path)
        # the distributed pass: with fugue.tpu.dist.board set, the
        # distributable fragments run on the board's workers and their
        # interior tasks never run here. A planning error must never fail
        # a run: it runs wholly local, with a warning
        self._dist_plan = None
        try:
            from ..plan import plan_distribution

            dp = plan_distribution(tasks, self._conf, self._cache_plan)
            if dp.active and dp.fragments:
                self._dist_plan = dp
        except Exception as ex:  # pragma: no cover - defensive degrade
            self._engine.log.warning(
                "distributed-workflow planning failed (%s: %s); running fully local",
                type(ex).__name__,
                ex,
            )
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
        # tasks a cache hit cut away count as done: a consumer that needed
        # one would not have been cut
        cut = set(self._cache_plan.skipped) if self._cache_plan is not None else set()
        if self._dist_plan is not None:
            # a fragment's interior runs on the workers; its result task
            # is intercepted in _run_task_once
            cut |= self._dist_plan.interior_ids
        if concurrency <= 1:
            for t in tasks:
                if id(t) not in cut:
                    self._run_task(t)
            return
        thread_scope = self._engine.thread_scope()

        def in_thread(t: FugueTask) -> None:
            with thread_scope():
                self._run_task(t)

        remaining = {id(t): t for t in tasks if id(t) not in cut}
        done: Set[int] = set(cut)
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
        tid = task.__uuid__()
        plan = self._cache_plan
        cp = task.checkpoint
        if isinstance(cp, StrongCheckpoint):
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
                # one artifact, two indexes: the replayed checkpoint file
                # gets a cache ref, so later runs also cut above this task
                self._maybe_cache_publish(task, df)
                return
        if plan is not None and id(task) in plan.hits:
            # served from the result cache: the frame was loaded at plan
            # time; the checkpoint, broadcast and yield contracts still run
            with get_tracer().span(
                "task.cache_hit", cat="cache", task_uuid=tid, tier=plan.hit_tier.get(id(task), "")
            ):
                self._results[id(task)] = task.set_result(self, plan.hits[id(task)])
            return
        if plan is not None and id(task) in plan.delta_hits:
            # partition-level delta recompute (cache/delta.py): the cached
            # partitions were loaded at plan time; only the new partitions
            # go through the chain here, then merge
            from ..cache.delta import execute_delta

            hit = plan.delta_hits[id(task)]
            with get_tracer().span(
                "task.delta_recompute",
                cat="cache",
                task_uuid=tid,
                partitions=f"{hit.matched_parts}/{hit.total_parts}",
                bytes_skipped=hit.bytes_matched,
            ):
                result = task.set_result(self, execute_delta(self, task, hit))
                self._results[id(task)] = result
            # the merged result under the new full fingerprint (a later
            # exact run takes the whole-task path), and the fresh segment
            # or partial appended to the manifest
            self._maybe_cache_publish(task, result, delta_hit=hit)
            return
        dp = self._dist_plan
        if dp is not None and id(task) in dp.results:
            # a fragment's result: its loads, row-local chains, shuffle,
            # terminal and tail ran as leased board tasks; only the
            # combined frame lands here, through set_result, so the
            # checkpoint, broadcast, yield and cache contracts hold as for
            # a frame computed here
            from ..plan import execute_fragment

            frag = dp.results[id(task)]
            with get_tracer().span(
                "dist.workflow_fragment",
                cat="dist",
                task=task.name or type(task.extension).__name__,
                keys=",".join(frag.keys),
                buckets=frag.buckets,
            ):
                pdf = execute_fragment(frag, self._engine, self._conf)
                result = task.set_result(self, self._engine.to_df(pdf))
                self._results[id(task)] = result
            self._maybe_cache_publish(task, result)
            return
        inputs = [self._results[id(d)] for d in task.inputs]
        self._injector.fire(SITE_TASK_EXECUTE)
        result = task.execute(self, inputs)
        if result is not None:
            result = task.set_result(self, result)
            if self._consumers.get(id(task), 0) > 1 and result.is_local and not result.is_bounded:
                result = result.as_local_bounded()
            self._results[id(task)] = result
            self._maybe_cache_publish(task, result, inputs=inputs)

    def _maybe_cache_publish(
        self,
        task: FugueTask,
        result: DataFrame,
        inputs: Optional[List[DataFrame]] = None,
        delta_hit: Any = None,
    ) -> None:
        """Publish a finished bounded result under its plan fingerprint. A
        permanent file checkpoint is indexed by reference, not written
        again. A delta-eligible task (``cache/delta.py``) also keeps its
        source's partition manifest, so the next run over a grown source
        recomputes only the new partitions."""
        plan = self._cache_plan
        if plan is None:
            return
        fp = plan.fp(task)
        if fp is None or (result.is_local and not result.is_bounded):
            return  # publishing would consume a one-pass stream
        ref = None
        cp = task.checkpoint
        if isinstance(cp, StrongCheckpoint) and cp.storage_type == "file" and cp.permanent:
            try:
                ref = cp._file_path(self._checkpoint_path)
            except Exception:
                ref = None
        with get_tracer().span(
            "cache.publish", cat="cache", task=task.name or type(task.extension).__name__, fp=fp[:12]
        ) as sp:
            info = self._engine.result_cache.publish(
                fp, result, self._engine, str(result.schema), ref_path=ref
            )
            sp.set(**info)
        from ..cache.delta import publish_manifest_after

        publish_manifest_after(self, task, result, inputs=inputs, hit=delta_hit)
