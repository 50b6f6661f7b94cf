"""FugueWorkflow, copied from ``fugue_tpu/workflow/workflow.py``: every
operation *describes* a task, and ``run(engine)`` executes the graph on
an engine of the port. ``WorkflowDataFrame`` mirrors the frame's API
lazily and adds partitioning hints, checkpoints, yields, persist,
broadcast, joins, set operations, zips and SQL.

``run`` keeps the workflow's conf to the run (``run_conf_scope``): it
never leaks into the engine's conf. Before anything runs, the plan
optimizer (``fugue_tpu_torch/plan``) rewrites the DAG: filter pushdown,
column pruning, verb fusion and segment lowering, each giving the result
of the DAG as compiled; ``fugue.tpu.plan.optimize=false`` turns it off,
``explain()`` shows what it would do and ``last_plan_report`` what it
did.

While the tracer (``fugue_tpu_torch/obs``) is on, a run is one
``workflow.run`` span in a trace scope of its own, after a
``plan.optimize`` span, and its span metrics carry ``workflow`` and
``run`` labels; ``fugue.tpu.trace.dir`` writes one Chrome trace file a
run, and ``timeline()`` renders the run's recovery events.

A run goes through the engine's result cache (``fugue_tpu_torch/cache``,
on by default: ``fugue.tpu.cache.enabled=false`` turns it off) and, inside
``run_scope``, the engine's tuner (``fugue_tpu_torch/tuning``, on by
default: ``fugue.tpu.tuning.enabled=false``) keyed by the optimized
plan's fingerprint. ``explain()`` renders the cache's would-be cut and
the tuner's settings after the plan; ``last_cache_plan`` and
``last_plan_fingerprint`` describe the last run."""

import hashlib
import os
import uuid as _uuid
from contextlib import nullcontext
from typing import Any, Dict, List, Optional


from .._utils.assertion import assert_or_throw
from .._utils.convert import get_caller_global_local_vars
from .._utils.params import ParamDict
from ..collections.partition import PartitionSpec
from ..collections.sql import StructuredRawSQL
from ..collections.yielded import PhysicalYielded, Yielded
from ..column import ColumnExpr
from ..column import SelectColumns as ColSelectColumns
from ..constants import (
    FUGUE_CONF_WORKFLOW_AUTO_PERSIST,
    FUGUE_CONF_WORKFLOW_AUTO_PERSIST_VALUE,
    FUGUE_TPU_CONF_EVENTS_DIR,
    FUGUE_TPU_CONF_TELEMETRY_WORKFLOW,
    FUGUE_TPU_CONF_TRACE_DIR,
)
from ..dataframe import DataFrame, YieldedDataFrame
from ..exceptions import FugueWorkflowCompileError, FugueWorkflowError
from ..execution.execution_engine import ExecutionEngine
from ..execution.factory import make_execution_engine
from ..extensions._builtins import creators as bc
from ..extensions._builtins import outputters as bo
from ..extensions._builtins import processors as bp
from ..extensions.creator.convert import _to_creator
from ..extensions.outputter.convert import _to_outputter
from ..extensions.outputter.outputter import Outputter as _OutputterBase
from ..extensions.processor.convert import _to_processor
from ..extensions.transformer.convert import _to_output_transformer, _to_transformer
from ._checkpoint import StrongCheckpoint, WeakCheckpoint
from ._tasks import CreateTask, FugueTask, OutputTask, ProcessTask
from ._workflow_context import FugueWorkflowContext



class FugueWorkflowResult:
    """The outcome of ``FugueWorkflow.run`` — holds the yields."""

    def __init__(self, yields: Dict[str, Yielded]):
        self._yields = dict(yields)

    @property
    def yields(self) -> Dict[str, Any]:
        return self._yields

    def __getitem__(self, name: str) -> Any:
        return self._yields[name]


class WorkflowDataFrame:
    """Lazy handle to a dataframe inside the DAG (reference ``workflow.py:88``)."""

    def __init__(
        self,
        workflow: "FugueWorkflow",
        task: FugueTask,
        pre_partition: Optional[PartitionSpec] = None,
    ):
        self._workflow = workflow
        self._task = task
        self._pre_partition = pre_partition

    @property
    def workflow(self) -> "FugueWorkflow":
        return self._workflow

    @property
    def partition_spec(self) -> PartitionSpec:
        return self._pre_partition or PartitionSpec()

    def spec_uuid(self) -> str:
        return self._task.__uuid__()

    @property
    def name(self) -> str:
        return self._task.name

    # -- partition hints ----------------------------------------------------
    def partition(self, *args: Any, **kwargs: Any) -> "WorkflowDataFrame":
        return WorkflowDataFrame(self._workflow, self._task, PartitionSpec(*args, **kwargs))

    def partition_by(self, *keys: str, **kwargs: Any) -> "WorkflowDataFrame":
        return self.partition(by=list(keys), **kwargs)

    def per_partition_by(self, *keys: str) -> "WorkflowDataFrame":
        return self.partition(by=list(keys), algo="even")

    def per_row(self) -> "WorkflowDataFrame":
        return self.partition("per_row")

    # -- transforms ---------------------------------------------------------
    def transform(
        self,
        using: Any,
        schema: Any = None,
        params: Any = None,
        pre_partition: Any = None,
        ignore_errors: Optional[List[Any]] = None,
        callback: Any = None,
    ) -> "WorkflowDataFrame":
        _g, _l = get_caller_global_local_vars()
        return self._workflow.transform(
            self,
            using=using,
            schema=schema,
            params=params,
            pre_partition=pre_partition or self._pre_partition,
            ignore_errors=ignore_errors or [],
            callback=callback,
            global_vars=_g,
            local_vars=_l,
        )

    def out_transform(
        self,
        using: Any,
        params: Any = None,
        pre_partition: Any = None,
        ignore_errors: Optional[List[Any]] = None,
        callback: Any = None,
    ) -> None:
        _g, _l = get_caller_global_local_vars()
        self._workflow.out_transform(
            self,
            using=using,
            params=params,
            pre_partition=pre_partition or self._pre_partition,
            ignore_errors=ignore_errors or [],
            callback=callback,
            global_vars=_g,
            local_vars=_l,
        )

    def process(
        self,
        using: Any,
        schema: Any = None,
        params: Any = None,
        pre_partition: Any = None,
    ) -> "WorkflowDataFrame":
        _g, _l = get_caller_global_local_vars()
        return self._workflow.process(
            self,
            using=using,
            schema=schema,
            params=params,
            pre_partition=pre_partition or self._pre_partition,
            global_vars=_g,
            local_vars=_l,
        )

    def output(self, using: Any, params: Any = None, pre_partition: Any = None) -> None:
        _g, _l = get_caller_global_local_vars()
        self._workflow.output(
            self,
            using=using,
            params=params,
            pre_partition=pre_partition or self._pre_partition,
            global_vars=_g,
            local_vars=_l,
        )

    # -- column/relational ops ---------------------------------------------
    def _simple_process(self, processor: Any, params: Any = None, pre_partition: Any = None) -> "WorkflowDataFrame":
        return self._workflow.add_process_task(
            processor, [self], params=params, pre_partition=pre_partition
        )

    def rename(self, *args: Any, **kwargs: Any) -> "WorkflowDataFrame":
        columns: Dict[str, str] = {}
        for a in args:
            columns.update(a)
        columns.update(kwargs)
        return self._simple_process(bp.Rename(), params=dict(columns=columns))

    def alter_columns(self, columns: Any) -> "WorkflowDataFrame":
        return self._simple_process(bp.AlterColumns(), params=dict(columns=str(columns)))

    def drop(self, columns: List[str], if_exists: bool = False) -> "WorkflowDataFrame":
        return self._simple_process(
            bp.DropColumns(), params=dict(columns=columns, if_exists=if_exists)
        )

    def __getitem__(self, columns: List[Any]) -> "WorkflowDataFrame":
        return self._simple_process(bp.SelectColumns(), params=dict(columns=columns))

    def distinct(self) -> "WorkflowDataFrame":
        return self._simple_process(bp.Distinct())

    def dropna(
        self, how: str = "any", thresh: Optional[int] = None, subset: Optional[List[str]] = None
    ) -> "WorkflowDataFrame":
        params: Dict[str, Any] = dict(how=how)
        if thresh is not None:
            params["thresh"] = thresh
        if subset is not None:
            params["subset"] = subset
        return self._simple_process(bp.Dropna(), params=params)

    def fillna(self, value: Any, subset: Optional[List[str]] = None) -> "WorkflowDataFrame":
        params: Dict[str, Any] = dict(value=value)
        if subset is not None:
            params["subset"] = subset
        return self._simple_process(bp.Fillna(), params=params)

    def sample(
        self,
        n: Optional[int] = None,
        frac: Optional[float] = None,
        replace: bool = False,
        seed: Optional[int] = None,
    ) -> "WorkflowDataFrame":
        params: Dict[str, Any] = dict(replace=replace)
        if n is not None:
            params["n"] = n
        if frac is not None:
            params["frac"] = frac
        if seed is not None:
            params["seed"] = seed
        return self._simple_process(bp.Sample(), params=params)

    def take(self, n: int, presort: str = "", na_position: str = "last") -> "WorkflowDataFrame":
        return self._workflow.add_process_task(
            bp.Take(),
            [self],
            params=dict(n=n, presort=presort, na_position=na_position),
            pre_partition=self._pre_partition,
        )

    def select(self, *columns: Any, where: Any = None, having: Any = None, distinct: bool = False) -> "WorkflowDataFrame":
        from ..column import col as _col

        cols = ColSelectColumns(
            *[(_col(c) if isinstance(c, str) else c) for c in columns],
            arg_distinct=distinct,
        )
        params: Dict[str, Any] = dict(columns=cols)
        if where is not None:
            params["where"] = where
        if having is not None:
            params["having"] = having
        return self._simple_process(bp.Select(), params=params)

    def filter(self, condition: ColumnExpr) -> "WorkflowDataFrame":
        return self._simple_process(bp.Filter(), params=dict(condition=condition))

    def assign(self, *args: ColumnExpr, **kwargs: Any) -> "WorkflowDataFrame":
        from ..column import lit

        cols = list(args) + [
            (v if isinstance(v, ColumnExpr) else lit(v)).alias(k)
            for k, v in kwargs.items()
        ]
        return self._simple_process(bp.Assign(), params=dict(columns=cols))

    def aggregate(self, *agg_cols: ColumnExpr, **kw_agg_cols: ColumnExpr) -> "WorkflowDataFrame":
        cols = list(agg_cols) + [v.alias(k) for k, v in kw_agg_cols.items()]
        return self._workflow.add_process_task(
            bp.Aggregate(),
            [self],
            params=dict(columns=cols),
            pre_partition=self._pre_partition,
        )

    # -- joins & set ops ----------------------------------------------------
    def join(self, *dfs: "WorkflowDataFrame", how: str, on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self._workflow.join(self, *dfs, how=how, on=on)

    def inner_join(self, *dfs: "WorkflowDataFrame", on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="inner", on=on)

    def semi_join(self, *dfs: "WorkflowDataFrame", on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="semi", on=on)

    def left_semi_join(self, *dfs: "WorkflowDataFrame", on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="left_semi", on=on)

    def anti_join(self, *dfs: "WorkflowDataFrame", on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="anti", on=on)

    def left_anti_join(self, *dfs: "WorkflowDataFrame", on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="left_anti", on=on)

    def left_outer_join(self, *dfs: "WorkflowDataFrame", on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="left_outer", on=on)

    def right_outer_join(self, *dfs: "WorkflowDataFrame", on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="right_outer", on=on)

    def full_outer_join(self, *dfs: "WorkflowDataFrame", on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="full_outer", on=on)

    def cross_join(self, *dfs: "WorkflowDataFrame") -> "WorkflowDataFrame":
        return self.join(*dfs, how="cross")

    def union(self, *dfs: "WorkflowDataFrame", distinct: bool = True) -> "WorkflowDataFrame":
        return self._workflow.set_op("union", self, *dfs, distinct=distinct)

    def subtract(self, *dfs: "WorkflowDataFrame", distinct: bool = True) -> "WorkflowDataFrame":
        return self._workflow.set_op("subtract", self, *dfs, distinct=distinct)

    def intersect(self, *dfs: "WorkflowDataFrame", distinct: bool = True) -> "WorkflowDataFrame":
        return self._workflow.set_op("intersect", self, *dfs, distinct=distinct)

    # -- zip ----------------------------------------------------------------
    def zip(
        self,
        *dfs: "WorkflowDataFrame",
        how: str = "inner",
        partition: Any = None,
        temp_path: Optional[str] = None,
        to_file_threshold: int = -1,
    ) -> "WorkflowDataFrame":
        return self._workflow.zip(
            self,
            *dfs,
            how=how,
            partition=partition or self._pre_partition,
            temp_path=temp_path,
            to_file_threshold=to_file_threshold,
        )

    # -- checkpoints, persist, broadcast, yields ----------------------------
    def checkpoint(self, storage_type: str = "file") -> "WorkflowDataFrame":
        self._task.set_checkpoint(StrongCheckpoint(storage_type=storage_type))
        return self

    def weak_checkpoint(self, lazy: bool = False, **kwargs: Any) -> "WorkflowDataFrame":
        self._task.set_checkpoint(WeakCheckpoint(lazy=lazy, **kwargs))
        return self

    def strong_checkpoint(
        self,
        storage_type: str = "file",
        lazy: bool = False,
        partition: Any = None,
        single: bool = False,
        **kwargs: Any,
    ) -> "WorkflowDataFrame":
        self._task.set_checkpoint(
            StrongCheckpoint(
                storage_type=storage_type,
                deterministic=False,
                lazy=lazy,
                partition=partition,
                single=single,
                **kwargs,
            )
        )
        return self

    def deterministic_checkpoint(
        self,
        storage_type: str = "file",
        lazy: bool = False,
        partition: Any = None,
        single: bool = False,
        namespace: Any = None,
        **kwargs: Any,
    ) -> "WorkflowDataFrame":
        self._task.set_checkpoint(
            StrongCheckpoint(
                storage_type=storage_type,
                deterministic=True,
                lazy=lazy,
                partition=partition,
                single=single,
                namespace=namespace,
                **kwargs,
            )
        )
        return self

    def persist(self) -> "WorkflowDataFrame":
        return self.weak_checkpoint(lazy=False)

    def broadcast(self) -> "WorkflowDataFrame":
        self._task.broadcast_flag = True
        return self

    def yield_file_as(self, name: str) -> None:
        cp = StrongCheckpoint(storage_type="file", deterministic=True, permanent=True)
        cp.yielded = PhysicalYielded(self._task.__uuid__(), "file")
        self._task.set_checkpoint(cp)
        self._workflow._register_yield(name, cp.yielded)

    def yield_table_as(self, name: str) -> None:
        cp = StrongCheckpoint(storage_type="table", deterministic=True, permanent=True)
        cp.yielded = PhysicalYielded(self._task.__uuid__(), "table")
        self._task.set_checkpoint(cp)
        self._workflow._register_yield(name, cp.yielded)

    def yield_dataframe_as(self, name: str, as_local: bool = False) -> None:
        yielded = YieldedDataFrame(self._task.__uuid__())
        self._workflow._register_yield(name, yielded)
        # weakref: a strong workflow ref here would close the cycle
        # workflow → tasks → handler → workflow, deferring the release of
        # every result frame (device memory!) to cyclic GC instead of
        # refcounting. The handler only fires during run(), when the
        # workflow is necessarily alive.
        import weakref

        wf_ref = weakref.ref(self._workflow)

        def handler(df: DataFrame) -> None:
            wf = wf_ref()
            e = wf._last_engine if wf is not None else None
            out = e.convert_yield_dataframe(df, as_local) if e is not None else df
            yielded.set_value(out)

        self._task.set_yield_dataframe_handler(handler)

    # -- io & sinks ----------------------------------------------------------
    def save(
        self,
        path: str,
        fmt: str = "",
        mode: str = "overwrite",
        partition: Any = None,
        single: bool = False,
        **kwargs: Any,
    ) -> None:
        self._workflow.add_output_task(
            bo.Save(),
            [self],
            params=dict(path=path, fmt=fmt, mode=mode, single=single, params=kwargs),
            pre_partition=partition or self._pre_partition,
        )

    def save_and_use(
        self,
        path: str,
        fmt: str = "",
        mode: str = "overwrite",
        partition: Any = None,
        single: bool = False,
        **kwargs: Any,
    ) -> "WorkflowDataFrame":
        return self._workflow.add_process_task(
            bp.SaveAndUse(),
            [self],
            params=dict(path=path, fmt=fmt, mode=mode, single=single, params=kwargs),
            pre_partition=partition or self._pre_partition,
        )

    def show(
        self,
        n: int = 10,
        with_count: bool = False,
        title: Optional[str] = None,
    ) -> None:
        self._workflow.show(self, n=n, with_count=with_count, title=title)

    def assert_eq(self, *dfs: Any, **params: Any) -> None:
        self._workflow.assert_eq(self, *dfs, **params)

    def assert_not_eq(self, *dfs: Any, **params: Any) -> None:
        self._workflow.assert_not_eq(self, *dfs, **params)

    # -- run-time access -----------------------------------------------------
    @property
    def result(self) -> DataFrame:
        return self._workflow.get_result(self)

    def compute(self, *args: Any, **kwargs: Any) -> DataFrame:
        self._workflow.run(*args, **kwargs)
        return self.result


class FugueWorkflow:
    """The lazy DAG builder (reference ``workflow.py:1499``)."""

    def __init__(self, compile_conf: Any = None):
        self._tasks: List[FugueTask] = []
        self._conf = ParamDict(compile_conf)
        self._yields: Dict[str, Yielded] = {}
        self._last_context: Optional[FugueWorkflowContext] = None
        self._last_engine = None
        self._graph_uuid: Optional[str] = None

    @property
    def conf(self) -> ParamDict:
        return self._conf

    @property
    def yields(self) -> Dict[str, Yielded]:
        return self._yields

    def __enter__(self) -> "FugueWorkflow":
        return self

    def __exit__(self, exc_type: Any, exc_val: Any, exc_tb: Any) -> None:
        pass

    def _register_yield(self, name: str, yielded: Yielded) -> None:
        assert_or_throw(
            name not in self._yields,
            FugueWorkflowCompileError(f"yield name {name} already exists"),
        )
        self._yields[name] = yielded

    # -- task plumbing -------------------------------------------------------
    def _add(self, task: FugueTask) -> WorkflowDataFrame:
        self._tasks.append(task)
        self._graph_uuid = None
        return WorkflowDataFrame(self, task)

    def add_process_task(
        self,
        processor: Any,
        inputs: List[WorkflowDataFrame],
        params: Any = None,
        pre_partition: Any = None,
        input_names: Optional[List[str]] = None,
    ) -> WorkflowDataFrame:
        task = ProcessTask(
            processor,
            [d._task for d in inputs],
            params=params,
            partition_spec=None if pre_partition is None else PartitionSpec(pre_partition),
            input_names=input_names,
        )
        return self._add(task)

    def add_output_task(
        self,
        outputter: Any,
        inputs: List[WorkflowDataFrame],
        params: Any = None,
        pre_partition: Any = None,
        input_names: Optional[List[str]] = None,
    ) -> None:
        task = OutputTask(
            outputter,
            [d._task for d in inputs],
            params=params,
            partition_spec=None if pre_partition is None else PartitionSpec(pre_partition),
            input_names=input_names,
        )
        self._add(task)

    # -- creation ------------------------------------------------------------
    def create(
        self, using: Any, schema: Any = None, params: Any = None
    ) -> WorkflowDataFrame:
        import pandas as _pd
        import pyarrow as _pa

        if isinstance(
            using, (DataFrame, WorkflowDataFrame, _pd.DataFrame, _pa.Table)
        ):
            # a dataframe: identical task spec to ``df()`` so the two
            # spellings share one deterministic uuid (reference
            # test_create_df_equivalence — checkpoint identity depends on
            # it). Anything else — Creator instances/classes, callables,
            # registered names — goes through the creator conversion
            assert_or_throw(
                params is None,
                FugueWorkflowCompileError("params must be None for dataframes"),
            )
            return self.create_data(using, schema)
        _g, _l = get_caller_global_local_vars()
        creator = _to_creator(using, schema, global_vars=_g, local_vars=_l)
        return self._add(CreateTask(creator, params=ParamDict(params)))

    def df(self, data: Any, schema: Any = None) -> WorkflowDataFrame:
        return self.create_data(data, schema)

    def create_data(self, data: Any, schema: Any = None) -> WorkflowDataFrame:
        if isinstance(data, WorkflowDataFrame):
            assert_or_throw(
                data.workflow is self,
                FugueWorkflowCompileError("dataframe belongs to another workflow"),
            )
            assert_or_throw(
                schema is None,
                FugueWorkflowCompileError("schema must be None for WorkflowDataFrame"),
            )
            return data
        task = CreateTask(
            bc.CreateData(),
            params=dict(data=data, schema=None if schema is None else str(schema)),
        )
        return self._add(task)

    def load(
        self, path: str, fmt: str = "", columns: Any = None, **kwargs: Any
    ) -> WorkflowDataFrame:
        return self._add(
            CreateTask(
                bc.Load(),
                params=dict(path=path, fmt=fmt, columns=columns, params=kwargs),
            )
        )

    # -- generic extensions ---------------------------------------------------
    def process(
        self,
        *dfs: Any,
        using: Any,
        schema: Any = None,
        params: Any = None,
        pre_partition: Any = None,
        global_vars: Any = None,
        local_vars: Any = None,
    ) -> WorkflowDataFrame:
        global_vars, local_vars = get_caller_global_local_vars(global_vars, local_vars)
        processor = _to_processor(using, schema, global_vars=global_vars, local_vars=local_vars)
        inputs, names = self._to_dfs(dfs)
        return self.add_process_task(
            processor,
            inputs,
            params=ParamDict(params),
            pre_partition=pre_partition,
            input_names=names,
        )

    def output(
        self,
        *dfs: Any,
        using: Any,
        params: Any = None,
        pre_partition: Any = None,
        global_vars: Any = None,
        local_vars: Any = None,
    ) -> None:
        global_vars, local_vars = get_caller_global_local_vars(global_vars, local_vars)
        outputter = _to_outputter(using, global_vars=global_vars, local_vars=local_vars)
        inputs, names = self._to_dfs(dfs)
        self.add_output_task(
            outputter,
            inputs,
            params=ParamDict(params),
            pre_partition=pre_partition,
            input_names=names,
        )

    def transform(
        self,
        *dfs: Any,
        using: Any,
        schema: Any = None,
        params: Any = None,
        pre_partition: Any = None,
        ignore_errors: Optional[List[Any]] = None,
        callback: Any = None,
        global_vars: Any = None,
        local_vars: Any = None,
    ) -> WorkflowDataFrame:
        global_vars, local_vars = get_caller_global_local_vars(global_vars, local_vars)
        inputs, _ = self._to_dfs(dfs)
        assert_or_throw(
            len(inputs) == 1,
            NotImplementedError("transform supports only one dataframe; use zip+transform for multiple"),
        )
        tf = _to_transformer(using, schema, global_vars=global_vars, local_vars=local_vars)
        from ..extensions._utils import validate_partition_spec

        validate_partition_spec(
            PartitionSpec(pre_partition) if pre_partition is not None else PartitionSpec(),
            tf.validation_rules,
        )
        return self.add_process_task(
            bp.RunTransformer(),
            inputs,
            params=dict(
                transformer=tf,
                ignore_errors=ignore_errors or [],
                params=ParamDict(params),
                callback=callback,
            ),
            pre_partition=pre_partition,
        )

    def out_transform(
        self,
        *dfs: Any,
        using: Any,
        params: Any = None,
        pre_partition: Any = None,
        ignore_errors: Optional[List[Any]] = None,
        callback: Any = None,
        global_vars: Any = None,
        local_vars: Any = None,
    ) -> None:
        global_vars, local_vars = get_caller_global_local_vars(global_vars, local_vars)
        inputs, _ = self._to_dfs(dfs)
        assert_or_throw(
            len(inputs) == 1,
            NotImplementedError("out_transform supports only one dataframe"),
        )
        tf = _to_output_transformer(using, global_vars=global_vars, local_vars=local_vars)
        res = self.add_process_task(
            bp.RunTransformer(),
            inputs,
            params=dict(
                transformer=tf,
                ignore_errors=ignore_errors or [],
                params=ParamDict(params),
                callback=callback,
            ),
            pre_partition=pre_partition,
        )
        # force materialization: consume as a sink
        self.add_output_task(_NoOpOutputter(), [res])

    # -- joins/set ops/zip -----------------------------------------------------
    def join(
        self, *dfs: Any, how: str, on: Optional[List[str]] = None
    ) -> WorkflowDataFrame:
        inputs, _ = self._to_dfs(dfs)
        return self.add_process_task(
            bp.RunJoin(), inputs, params=dict(how=how, on=on or [])
        )

    def set_op(self, how: str, *dfs: Any, distinct: bool = True) -> WorkflowDataFrame:
        inputs, _ = self._to_dfs(dfs)
        return self.add_process_task(
            bp.RunSetOperation(), inputs, params=dict(how=how, distinct=distinct)
        )

    def union(self, *dfs: Any, distinct: bool = True) -> WorkflowDataFrame:
        return self.set_op("union", *dfs, distinct=distinct)

    def subtract(self, *dfs: Any, distinct: bool = True) -> WorkflowDataFrame:
        return self.set_op("subtract", *dfs, distinct=distinct)

    def intersect(self, *dfs: Any, distinct: bool = True) -> WorkflowDataFrame:
        return self.set_op("intersect", *dfs, distinct=distinct)

    def zip(
        self,
        *dfs: Any,
        how: str = "inner",
        partition: Any = None,
        temp_path: Optional[str] = None,
        to_file_threshold: int = -1,
    ) -> WorkflowDataFrame:
        """The frames co-partitioned by ``partition``'s keys (default: the
        columns they share), for a cotransformer to ``transform``;
        ``how``: inner, left_outer, right_outer, full_outer or cross.
        Frames given in a dict keep their names."""
        inputs, names = self._to_dfs(dfs)
        return self.add_process_task(
            bp.Zip(),
            inputs,
            params=dict(how=how, temp_path=temp_path, to_file_threshold=to_file_threshold),
            pre_partition=partition,
            input_names=names,
        )

    def select(
        self,
        *statements: Any,
        sql_engine: Any = None,
        sql_engine_params: Any = None,
        dialect: str = "spark",
    ) -> WorkflowDataFrame:
        """Raw SQL select over workflow frames; pieces may be strings or
        WorkflowDataFrames (reference ``workflow.py`` raw-sql path).
        ``sql_engine`` runs this one select on a specific SQL engine (name,
        class, or an execution-engine name whose SQL facet is used)."""
        parts: List[Any] = []
        inputs: List[WorkflowDataFrame] = []
        names: List[str] = []
        seen: Dict[int, str] = {}
        for s in statements:
            if isinstance(s, str):
                parts.append((False, s))
            elif isinstance(s, WorkflowDataFrame):
                # the SAME frame referenced multiple times (e.g. a
                # correlated subquery's qualifier) must keep ONE table
                # name, or correlation analysis sees unrelated aliases
                if id(s) in seen:
                    parts.append((True, seen[id(s)]))
                    continue
                name = f"_{len(inputs)}"
                seen[id(s)] = name
                parts.append((True, name))
                inputs.append(s)
                names.append(name)
            else:
                raise FugueWorkflowCompileError(f"invalid select statement piece {s}")
        statement = StructuredRawSQL(parts, dialect=dialect)
        params: Dict[str, Any] = dict(statement=statement)
        if sql_engine is not None:
            params["sql_engine"] = sql_engine
            params["sql_engine_params"] = dict(sql_engine_params or {})
        return self.add_process_task(
            bp.RunSQLSelect(),
            inputs,
            params=params,
            input_names=names if len(names) > 0 else None,
        )

    # -- sinks -----------------------------------------------------------------
    def show(
        self,
        *dfs: Any,
        n: int = 10,
        with_count: bool = False,
        title: Optional[str] = None,
    ) -> None:
        inputs, _ = self._to_dfs(dfs)
        self.add_output_task(
            bo.Show(), inputs, params=dict(n=n, with_count=with_count, title=title)
        )

    def assert_eq(self, *dfs: Any, **params: Any) -> None:
        inputs, _ = self._to_dfs(dfs)
        self.add_output_task(bo.AssertEqual(), inputs, params=params)

    def assert_not_eq(self, *dfs: Any, **params: Any) -> None:
        inputs, _ = self._to_dfs(dfs)
        self.add_output_task(bo.AssertNotEqual(), inputs, params=params)

    # -- run -------------------------------------------------------------------
    def run(self, engine: Any = None, conf: Any = None, device: Any = None) -> FugueWorkflowResult:
        """Run the DAG on ``engine`` (an engine, or a name that
        ``execution/factory.py`` resolves, with ``device`` and ``conf``;
        ``None``: the context or global engine, or the one the DAG's data
        implies), the workflow's conf bound over the engine's for this run
        only, the engine the context engine of the run. ``conf`` with an
        engine instance goes into its conf, as in the JAX package."""
        if isinstance(engine, ExecutionEngine):
            e = make_execution_engine(engine, device=device)
            e.conf.update(ParamDict(conf))
        else:
            e = make_execution_engine(engine, device=device, conf=conf, infer_by=self._collect_raw_inputs())
        plan_conf = ParamDict(e.conf)
        plan_conf.update(self._conf)
        self._last_engine = e
        ctx = FugueWorkflowContext(e, conf=plan_conf)
        self._last_context = ctx
        self._apply_auto_persist(e, plan_conf)
        from ..obs import current_trace_id, get_tracer, run_labels, trace_scope
        from ..parallel.profiler import annotate
        from ..plan import optimize_tasks

        tracer = get_tracer()
        with annotate("fugue::plan_optimize"), tracer.span(
            "plan.optimize", cat="plan", tasks=len(self._tasks)
        ) as psp:
            run_tasks, aliases, removed, report = optimize_tasks(
                self._tasks, plan_conf, stats=e.plan_stats, analysis_stats=e.analysis_stats
            )
            psp.set(**report.span_attrs())
        self._last_plan_report = report
        # while tracing is on, every span-metric sample of the run carries
        # its workflow and run labels (the workflow's: a hash of the task
        # uuids, the same across runs of one DAG, unless the conf names
        # one), and the run is one trace: a new id, or the one of an
        # enclosing trace scope
        run_attrs: Dict[str, Any] = {}
        run_ctx: Any = nullcontext()
        trace_ctx: Any = nullcontext()
        if tracer.enabled:
            wf_label = str(plan_conf.get(FUGUE_TPU_CONF_TELEMETRY_WORKFLOW, "")) or (
                "wf-"
                + hashlib.sha1("|".join(t.__uuid__() for t in self._tasks).encode()).hexdigest()[:8]
            )
            run_attrs = {"workflow": wf_label, "run": _uuid.uuid4().hex[:8]}
            run_ctx = run_labels(**run_attrs)
            self._last_trace_id = current_trace_id() or _uuid.uuid4().hex[:16]
            run_attrs["trace"] = self._last_trace_id
            trace_ctx = trace_scope(self._last_trace_id)
        # adaptive execution: this run's telemetry is keyed by the
        # optimized plan's fingerprint, so the tuner's learned settings
        # apply to, and learn from, this plan; plan_conf carries a
        # workflow's tuning switch without touching the engine's conf
        from ..tuning import plan_fingerprint, run_scope

        self._last_plan_fingerprint = plan_fingerprint(run_tasks)
        try:
            with e.run_conf_scope(self._conf), e._as_context(borrowed=True):
                with trace_ctx, run_ctx, tracer.span(
                    "workflow.run", cat="workflow", tasks=len(run_tasks), **run_attrs
                ), run_scope(e, self._last_plan_fingerprint, plan_conf):
                    ctx.run(run_tasks, result_aliases=aliases, removed_results=removed)
        finally:
            self._maybe_export_trace(e, tracer, plan_conf)
        return FugueWorkflowResult(self._yields)

    def _maybe_export_trace(self, engine: Any, tracer: Any, conf: ParamDict) -> None:
        """With the tracer on and ``fugue.tpu.trace.dir`` set in the run's
        conf, write the tracer's spans there as one Chrome trace file."""
        trace_dir = conf.get(FUGUE_TPU_CONF_TRACE_DIR, "")
        if not tracer.enabled or trace_dir == "":
            return
        from ..obs import write_chrome_trace

        try:
            path = os.path.join(trace_dir, f"fugue_trace_{_uuid.uuid4().hex[:8]}.json")
            write_chrome_trace(path, tracer.records())
            engine.log.info("workflow trace exported to %s", path)
        except Exception as ex:  # an export never fails the run
            engine.log.warning("trace export failed: %s", ex)

    def timeline(self, events_dir: Optional[str] = None, conf: Any = None) -> str:
        """The recovery events of the last run (``obs/events.py``), merged
        from every process's event file under ``events_dir`` (default: the
        FUGUE_TPU_EVENTS_DIR environment variable, then the run conf's
        ``fugue.tpu.events.dir``) and filtered to the run's trace id."""
        from ..obs import read_events, render_timeline

        if events_dir is None:
            events_dir = os.environ.get("FUGUE_TPU_EVENTS_DIR", "")
            if not events_dir:
                merged = self._merged_plan_conf(conf, getattr(self, "_last_engine", None))
                events_dir = str(merged.get(FUGUE_TPU_CONF_EVENTS_DIR, ""))
        if not events_dir:
            return "(no events dir configured — set fugue.tpu.events.dir)"
        return render_timeline(read_events(events_dir), trace=getattr(self, "_last_trace_id", None))

    def plan_report(self, conf: Any = None, engine: Any = None) -> Any:
        """The ``PlanReport`` of what the plan optimizer would do to this
        DAG, nothing run: the conf is ``engine``'s (if given), then this
        workflow's, then ``conf``, as ``run`` merges them."""
        from ..plan import optimize_tasks
        from ..plan.ir import build_graph
        from ..plan.optimizer import _render_nodes

        _, _, _, report = optimize_tasks(self._tasks, self._merged_plan_conf(conf, engine))
        if not report.before:
            report.before = _render_nodes(build_graph(self._tasks))
        return report

    def explain(self, conf: Any = None, engine: Any = None, lint: bool = False) -> str:
        """``plan_report`` rendered: the logical plan, the optimized plan
        with each pass's counters (cols_pruned, filters_pushed,
        verbs_fused, segments_lowered, verbs_absorbed, udfs_translated,
        bytes_skipped estimate), a line for each lowered segment
        (``lowered segment <fingerprint>: steps -> terminal``) and the
        notes: every UDF's analyzer verdict (``udf <name>[<fp>]:
        translated ...`` or ``interpreted -- <reason>``), refusals, and
        the passes that are not ported. Then the result cache's would-be
        cut over the optimized plan (which tasks hit, which are
        uncacheable and why, which producers a warm run skips, which
        grown sources recompute only their new partitions), the
        distributed pass's fragments and refusals, and the tuner's
        settings for the plan. Nothing runs; ``engine`` (if given)
        lends its live cache tiers and tuned store. ``lint=True`` appends
        the structured static-check section (:meth:`lint`)."""
        from ..cache import describe_cache
        from ..plan import describe_distribution, optimize_tasks
        from ..plan.ir import build_graph
        from ..plan.optimizer import _render_nodes
        from ..tuning import describe_tuning, plan_fingerprint

        merged = self._merged_plan_conf(conf, engine)
        run_tasks, _, _, report = optimize_tasks(self._tasks, merged)
        if not report.before:
            report.before = _render_nodes(build_graph(self._tasks))
        eng = engine if isinstance(engine, ExecutionEngine) else None
        lines = [report.render()]
        lines.extend(
            describe_cache(
                run_tasks,
                merged,
                cache=None if eng is None else eng.result_cache,
                engine_kind="any" if eng is None else type(eng).__name__,
            )
        )
        # the distributed pass: which fragments would route through the
        # board's workers and why the rest refuse
        lines.extend(describe_distribution(run_tasks, merged))
        lines.extend(describe_tuning(merged, plan_fingerprint(run_tasks), engine=eng))
        if lint:
            lines.append(self.lint(conf=conf, engine=engine).render())
        return "\n".join(lines)

    def lint(self, conf: Any = None, engine: Any = None) -> Any:
        """No-execution static check pass: runs the UDF analyzer plus the
        plan machinery over this workflow and returns a ``LintReport``
        (``fugue_tpu_torch/analysis/lint.py``) of structured diagnostics:
        per-UDF verdict and refusal reason, predicted lowered segments,
        and every optimizer note. Nothing executes and the compiled tasks
        are never mutated."""
        from ..analysis import lint_tasks

        return lint_tasks(self._tasks, self._merged_plan_conf(conf, engine))

    def _merged_plan_conf(self, conf: Any, engine: Any) -> ParamDict:
        """The conf ``run`` would optimize with: ``engine``'s (if given),
        then this workflow's, then ``conf``."""
        merged = ParamDict(engine.conf if isinstance(engine, ExecutionEngine) else None)
        merged.update(self._conf)
        merged.update(ParamDict(conf))
        return merged

    @property
    def last_plan_report(self) -> Any:
        """The ``PlanReport`` of the last ``run()`` (None before the first)."""
        return getattr(self, "_last_plan_report", None)

    @property
    def last_plan_fingerprint(self) -> Optional[str]:
        """The plan fingerprint of the last ``run()``: the key the tuner
        keeps its learned settings under (None before the first run or
        for a plan with no fingerprint)."""
        return getattr(self, "_last_plan_fingerprint", None)

    @property
    def last_cache_plan(self) -> Any:
        """The ``CachePlan`` of the last ``run()``: fingerprints, frontier
        hits and the skipped upstream tasks (None before the first run or
        with the cache off)."""
        ctx = getattr(self, "_last_context", None)
        return None if ctx is None else ctx._cache_plan

    def _collect_raw_inputs(self) -> List[Any]:
        """The data the DAG's ``df``/``create_data`` tasks hold."""
        return [t.params["data"] for t in self._tasks if isinstance(t, CreateTask) and "data" in t.params]

    def release_task_results(self) -> None:
        """Drop the per-task result frames held by the last run's context.

        The workflow graph contains inherent reference cycles
        (WorkflowDataFrame ↔ workflow), so a dropped workflow frees its
        (possibly device-resident) intermediates only at the next cyclic
        GC pass — measurably late for multi-GB frames. Single-shot API
        wrappers (transform/raw_sql/fugue_sql) extract their yields and
        then call this so intermediates free by refcount immediately.
        After calling, ``get_result``/``WorkflowDataFrame.result`` raise
        KeyError — yields are unaffected (they hold their own refs)."""
        if self._last_context is not None:
            self._last_context._results.clear()

    def get_result(self, df: WorkflowDataFrame) -> DataFrame:
        assert_or_throw(
            self._last_context is not None,
            FugueWorkflowError("workflow has not been run"),
        )
        return self._last_context.get_result(df._task)  # type: ignore

    def spec_uuid(self) -> str:
        from .._utils.hash import to_uuid

        if self._graph_uuid is None:
            self._graph_uuid = to_uuid([t.__uuid__() for t in self._tasks])
        return self._graph_uuid

    # -- helpers ---------------------------------------------------------------
    def _to_dfs(self, dfs: Any) -> Any:
        inputs: List[WorkflowDataFrame] = []
        names: Optional[List[str]] = None
        flat: List[Any] = []
        for d in dfs:
            if isinstance(d, dict):
                names = names or []
                for k, v in d.items():
                    flat.append((k, v))
            else:
                flat.append((None, d))
        for k, d in flat:
            wdf = d if isinstance(d, WorkflowDataFrame) else self.create_data(d)
            inputs.append(wdf)
            if k is not None:
                assert names is not None
                names.append(k)
        if names is not None and len(names) != len(inputs):
            raise FugueWorkflowCompileError("can't mix named and unnamed inputs")
        return inputs, names

    def _apply_auto_persist(self, engine: Any, conf: Any = None) -> None:
        # conf is the run-scoped merge (engine conf + workflow conf) —
        # workflow conf is no longer written into the engine, so reading
        # engine.conf here would miss a workflow-level auto_persist
        conf = conf if conf is not None else engine.conf
        if not conf.get(FUGUE_CONF_WORKFLOW_AUTO_PERSIST, False):
            return
        consumers: Dict[int, int] = {}
        for t in self._tasks:
            for d in t.inputs:
                consumers[id(d)] = consumers.get(id(d), 0) + 1
        value = conf.get(FUGUE_CONF_WORKFLOW_AUTO_PERSIST_VALUE, "")
        for t in self._tasks:
            if consumers.get(id(t), 0) > 1 and t.checkpoint.is_null and t.has_output:
                t.set_checkpoint(
                    WeakCheckpoint() if value == "" else WeakCheckpoint(value=value)
                )


class _NoOpOutputter(_OutputterBase):
    def process(self, dfs: Any) -> None:
        for df in dfs.values():
            # touch the frame so lazy engines materialize it
            df.count() if df.is_bounded else df.as_local_bounded()
