"""ExecutionEngine, MapEngine and SQLEngine ABCs, copied from
``fugue_tpu/execution/execution_engine.py`` and trimmed to the verbs the
port's engines have: ``to_df``, ``repartition``, ``persist``,
``broadcast``, the map behind ``transform`` (``MapEngine.map_dataframe``
:276, with ``on_init`` and the format hint), ``select``, ``filter``, ``assign``, ``aggregate``, ``join``,
the set operations, ``distinct``, ``dropna``, ``fillna``, ``sample``,
``take``, ``load_df``, ``save_df``, and ``zip`` and ``comap``.

``select``, ``filter``, ``assign`` and ``aggregate`` have their host
forms here, as in the JAX package (:716-806): the frame on the host, the
column IR evaluated over pandas (``column/eval.py``). A verb an engine
does not implement raises ``NotImplementedError``: the host engine
(``NativeExecutionEngine``) and the device engine
(``TorchExecutionEngine``) have all of them.

``zip`` and ``comap`` (:806-930) are the arrow-IPC blob protocol: each
logical partition of each input becomes one row holding its rows as an
IPC blob (``_PartitionSerializer``), the blob frames are unioned, and
``comap`` regroups them by key and rebuilds the frames (``_Comap``). The
host engine answers every zip with it; the device engine where the JAX
engine does (``torch/execution_engine.py``).

The engine context (:299-372): ``_as_context`` makes an engine the
context engine of the current context (a ``ContextVar``, so the
workflow's pool threads inherit it through ``copy_context``) and stops it
at the last exit unless it is the global engine; ``set_global`` and
``clear_global`` hold the process-wide one. ``execution/factory.py``
resolves ``engine=None`` to them.

For the workflow: the ``SQLEngine`` facet (:124) and ``sql_engine``,
``create_default_sql_engine`` and ``set_sql_engine`` (:267-297), the
yields (:932-943), and ``run_conf_scope`` (:238), which binds a run's
conf over the engine's for the current context only, so a workflow's
conf never leaks into the engine's.

Observability (:192-215, :417-540): construction applies the trace,
telemetry and event conf (``fugue_tpu_torch/obs``) and registers the
engine's resource probes (``result_cache_mem_bytes``,
``result_cache_mem_entries``); ``metrics`` is one ``MetricsRegistry``
over the engine's stats sources (``resilience``, ``plan``, ``analysis``,
``cache``, ``tuning``, and the process-wide ``latency`` and
``telemetry``), read by ``stats()``, zeroed by ``reset_stats()`` and
rendered by ``report()``.

The result cache and the tuner (:570-603): ``result_cache`` is the
engine's ``ResultCache`` (``fugue_tpu_torch/cache``; its memory tier
holds this engine's frames, on its device), ``tuner`` its ``Tuner``
(``fugue_tpu_torch/tuning``). Both are made at first use from the
engine's own conf, never from a run's scoped view of it: a workflow's
conf switches either off for its run (``fugue.tpu.cache.enabled``,
``fugue.tpu.tuning.enabled``) without becoming the engine's."""

import logging
from abc import ABC, abstractmethod
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from threading import RLock
from typing import Any, Callable, ContextManager, Dict, Iterator, List, Optional

from .._utils.params import ParamDict
from ..collections.partition import PartitionCursor, PartitionSpec
from .._utils.assertion import assert_or_throw
from ..column import SelectColumns, all_cols, col
from ..collections.sql import StructuredRawSQL
from ..collections.yielded import PhysicalYielded, Yielded
from ..column.expressions import ColumnExpr
from ..dataframe import (
    ArrayDataFrame,
    ArrowDataFrame,
    DataFrame,
    DataFrames,
    LocalBoundedDataFrame,
    LocalDataFrame,
    PandasDataFrame,
    YieldedDataFrame,
)
from ..dataframe.utils import deserialize_df, get_temp_df_path, serialize_df
from ..exceptions import FugueBug, FugueInvalidOperation
from ..schema import Schema

_VERBS = "ROADMAP.md A.8 remaining verbs"
_FUGUE_BLOB_PREFIX = "__fugue_blob_"

# the context engine of the current context (``engine_context``, a
# workflow run); task threads inherit it through ``copy_context``
_CONTEXT_ENGINE: ContextVar[Optional["ExecutionEngine"]] = ContextVar(
    "fugue_tpu_torch_context_engine", default=None
)
_GLOBAL_ENGINE_LOCK = RLock()
_GLOBAL_ENGINE: List[Optional["ExecutionEngine"]] = [None]

# (engine id, merged conf) of the run scopes entered in this context;
# task threads inherit it through ``contextvars.copy_context``
_RUN_CONF: ContextVar[tuple] = ContextVar("fugue_tpu_torch_run_conf", default=())


class MapEngine(ABC):
    """Runs a function over the logical partitions of a frame."""

    def __init__(self, execution_engine: "ExecutionEngine"):
        self._execution_engine = execution_engine

    @property
    def execution_engine(self) -> "ExecutionEngine":
        return self._execution_engine

    @property
    def conf(self) -> ParamDict:
        return self._execution_engine.conf

    def to_df(self, df: Any, schema: Any = None) -> DataFrame:
        return self._execution_engine.to_df(df, schema)

    @property
    def map_handles_repartition(self) -> bool:
        """Whether ``map_dataframe`` groups the frame itself, so that a
        transform needs no ``repartition`` first (``run_transformer``).
        Both maps of the port do: the host map sorts and slices, the
        device map sorts or buckets by the keys."""
        return True

    @abstractmethod
    def map_dataframe(
        self,
        df: DataFrame,
        map_func: Callable[[PartitionCursor, LocalDataFrame], LocalDataFrame],
        output_schema: Any,
        partition_spec: PartitionSpec,
        on_init: Optional[Callable[[int, DataFrame], Any]] = None,
        map_func_format_hint: Optional[str] = None,
    ) -> DataFrame:
        """Apply ``map_func(cursor, partition)`` to each logical partition
        of ``df`` under ``partition_spec``; the result has
        ``output_schema``. ``on_init(0, df)`` runs once first."""
        raise NotImplementedError

    def map_bag(
        self,
        bag: Any,
        map_func: Callable,
        partition_spec: PartitionSpec,
        on_init: Optional[Callable] = None,
    ) -> Any:
        """Apply ``map_func`` to the partitions of a bag
        (``fugue_tpu_torch/bag``). No map of the port supports bags yet,
        as none of the JAX package's does (``fugue_tpu`` :170)."""
        raise NotImplementedError(f"{type(self)} doesn't support bags")


class SQLEngine(ABC):
    """SQL over a dict of named frames, bound to an execution engine
    (``fugue_tpu`` ``SQLEngine`` :124)."""

    def __init__(self, execution_engine: "ExecutionEngine"):
        self._execution_engine = execution_engine

    @property
    def execution_engine(self) -> "ExecutionEngine":
        return self._execution_engine

    @property
    def execution_engine_constraint(self) -> type:
        """The engine type this facet requires (``set_sql_engine`` checks)."""
        return ExecutionEngine

    @property
    def conf(self) -> ParamDict:
        return self._execution_engine.conf

    @property
    def log(self) -> logging.Logger:
        return self._execution_engine.log

    @property
    def dialect(self) -> Optional[str]:
        return None

    @abstractmethod
    def select(self, dfs: DataFrames, statement: StructuredRawSQL) -> DataFrame:
        raise NotImplementedError

    def table_exists(self, table: str) -> bool:
        raise NotImplementedError(f"{type(self)} doesn't support tables")

    def save_table(
        self, df: DataFrame, table: str, mode: str = "overwrite",
        partition_spec: Optional[PartitionSpec] = None, **kwargs: Any,
    ) -> None:
        raise NotImplementedError(f"{type(self)} doesn't support tables")

    def load_table(self, table: str, **kwargs: Any) -> DataFrame:
        raise NotImplementedError(f"{type(self)} doesn't support tables")


class ExecutionEngine(ABC):
    """The contract every engine of the port implements. ``conf`` takes
    the keys of ``fugue_tpu_torch/constants.py``."""

    def __init__(self, conf: Any = None):
        self._conf = ParamDict(conf)
        self._rlock = RLock()
        self._sql_engine: Optional[SQLEngine] = None
        self._ctx_count = 0
        self._is_global = False
        self._stopped = False
        self._plan_stats: Any = None
        self._analysis_stats: Any = None
        self._resilience_stats: Any = None
        self._result_cache: Any = None
        self._tuner: Any = None
        self._metrics: Any = None
        self._rpc_server: Any = None
        # the trace switches (fugue.tpu.trace.* / FUGUE_TPU_TRACE), the
        # resource sampler's (fugue.tpu.telemetry.* / FUGUE_TPU_TELEMETRY)
        # and the event log's (fugue.tpu.events.*), then this engine's
        # probes on the sampler
        from ..obs import (
            configure_events_from_conf,
            configure_from_conf,
            configure_sampler_from_conf,
        )

        configure_from_conf(self._conf)
        configure_sampler_from_conf(self._conf)
        configure_events_from_conf(self._conf)
        self._register_resource_probes()

    @property
    def conf(self) -> ParamDict:
        """The engine's conf, or the innermost run scope's view of it."""
        me = id(self)
        for eng_id, view in reversed(_RUN_CONF.get()):
            if eng_id == me:
                return view
        return self._conf

    @contextmanager
    def run_conf_scope(self, overlay: Any = None) -> Iterator[ParamDict]:
        """Bind ``overlay`` over this engine's conf for the current context
        (and the threads it starts through ``copy_context``): ``conf``
        reads see it, and writes land in the scoped view and vanish at
        exit. Nestable."""
        if not overlay:
            yield self.conf
            return
        merged = ParamDict(self.conf)
        merged.update(overlay)
        token = _RUN_CONF.set(_RUN_CONF.get() + ((id(self), merged),))
        try:
            yield merged
        finally:
            _RUN_CONF.reset(token)

    @property
    def log(self) -> logging.Logger:
        return logging.getLogger(type(self).__name__)

    @property
    def plan_stats(self) -> Any:
        """Cumulative plan-optimizer counters of the workflows run on this
        engine (``fugue_tpu_torch/plan/optimizer.py`` ``PlanStats``): what
        the passes did, and how many lowered segments ran over the raw
        columns or took the per-verb path."""
        if self._plan_stats is None:
            with self._rlock:
                if self._plan_stats is None:
                    from ..plan import PlanStats

                    self._plan_stats = PlanStats()
        return self._plan_stats

    # ---- observability ----------------------------------------------------
    @property
    def metrics(self) -> Any:
        """The engine's :class:`~fugue_tpu_torch.obs.MetricsRegistry` — one
        surface over every stats object (resilience, plan and analysis on
        every engine; pipeline on the torch engine)."""
        if self._metrics is None:
            with self._rlock:
                if self._metrics is None:
                    from ..obs import MetricsRegistry, get_sampler, get_span_metrics

                    reg = MetricsRegistry()
                    for name, source in self._stats_sources().items():
                        reg.register(name, source)
                    # process-wide, like the tracer feeding them, but mounted
                    # here so stats() carries them and reset_stats() zeroes
                    # their observations (series and probes stay)
                    reg.register("latency", get_span_metrics)
                    reg.register("telemetry", get_sampler)
                    self._metrics = reg
        return self._metrics

    def _stats_sources(self) -> Dict[str, Callable[[], Any]]:
        """Name → zero-arg provider of each of this engine's stats sources
        (resolved at every read, so lazy sources stay lazy); subclasses
        extend."""
        return {
            "resilience": lambda: self.resilience_stats,
            "plan": lambda: self.plan_stats,
            "analysis": lambda: self.analysis_stats,
            "cache": lambda: self.result_cache.stats,
            "tuning": lambda: self.tuner,
        }

    def _register_resource_probes(self) -> None:
        """Register this engine's probes on the process's resource sampler.
        A probe binds the engine through a ``weakref``: once the engine is
        collected it raises ``ProbeGone`` and the sampler drops it; a newer
        engine's probe of the same name replaces an older one's."""
        import weakref

        from ..obs import get_sampler
        from ..obs.sampler import ProbeGone

        ref = weakref.ref(self)

        def _bound(fn: Callable[["ExecutionEngine"], float]) -> Callable[[], float]:
            def probe() -> float:
                e = ref()
                if e is None:
                    raise ProbeGone()
                return fn(e)

            return probe

        sampler = get_sampler()
        for name, fn in self._resource_probe_fns().items():
            sampler.register_probe(name, _bound(fn))

    def _resource_probe_fns(self) -> Dict[str, Callable[["ExecutionEngine"], float]]:
        """Name → (engine → value) probe map; subclasses extend. A probe
        runs on the sampler's thread and must not create what it reads:
        the result-cache probes read 0 until the cache exists."""

        def _rc(attr: str) -> Callable[["ExecutionEngine"], float]:
            def fn(e: "ExecutionEngine") -> float:
                rc = getattr(e, "_result_cache", None)
                return float(getattr(rc.mem, attr)) if rc is not None else 0.0

            return fn

        return {
            "result_cache_mem_bytes": _rc("bytes"),
            "result_cache_mem_entries": _rc("entries"),
        }

    def stats(self) -> Dict[str, Any]:
        """Every registered stats source as one dict."""
        return self.metrics.as_dict()

    def reset_stats(self) -> None:
        """Reset every registered stats source: counters and observations
        to zero; histogram series, sampler probes and the sampler's thread
        stay."""
        self.metrics.reset()

    def report(self, top_n: int = 15) -> str:
        """Plain-text report: the top spans of the process's tracer by
        total wall, with p50/p95/p99 from the span-latency histograms,
        this engine's stats, and the tuner's verb rooflines where the
        tuner exists (the report does not make it)."""
        from ..obs import get_span_metrics, get_tracer, render_report

        rooflines = None
        if self._tuner is not None:
            try:
                rooflines = self._tuner.roofline.snapshot() or None
            except Exception:
                rooflines = None
        return render_report(
            get_tracer().records(),
            self.stats(),
            top_n=top_n,
            span_metrics=get_span_metrics(),
            rooflines=rooflines,
        )

    @property
    def resilience_stats(self) -> Any:
        """Recovery counters (``fugue_tpu_torch/resilience``
        ``ResilienceStats``): each task retry and checkpoint replay of a
        workflow run on this engine counts here. Alias of
        ``engine.stats()["resilience"]``."""
        if self._resilience_stats is None:
            with self._rlock:
                if self._resilience_stats is None:
                    from ..resilience import ResilienceStats

                    self._resilience_stats = ResilienceStats()
        return self._resilience_stats

    @property
    def analysis_stats(self) -> Any:
        """Cumulative UDF static-analyzer counters of the workflows run on
        this engine (``fugue_tpu_torch/analysis`` ``AnalysisStats``):
        udfs_analyzed / udfs_translated / udfs_refused by reason code."""
        if self._analysis_stats is None:
            with self._rlock:
                if self._analysis_stats is None:
                    from ..analysis import AnalysisStats

                    self._analysis_stats = AnalysisStats()
        return self._analysis_stats

    @property
    def tuner(self) -> Any:
        """This engine's ``Tuner`` (``fugue_tpu_torch/tuning``): a stream's
        chunk size and prefetch depth learned from the engine's own
        pipeline telemetry, keyed by plan fingerprint and persisted across
        restarts. Decisions and counters are ``engine.stats()["tuning"]``;
        ``reset_stats()`` zeroes the counters and keeps what was learned."""
        if self._tuner is None:
            with self._rlock:
                if self._tuner is None:
                    from ..tuning import Tuner

                    self._tuner = Tuner(self._conf, device=getattr(self, "device", None))
        return self._tuner

    @property
    def result_cache(self) -> Any:
        """This engine's ``ResultCache`` (``fugue_tpu_torch/cache``): the
        memory tier holds this engine's result frames (a device frame on
        its card), the disk tier is shared by every engine whose conf
        names the same ``fugue.tpu.cache.dir``. Counters are
        ``engine.stats()["cache"]``; ``reset_stats()`` zeroes them and
        evicts nothing."""
        if self._result_cache is None:
            with self._rlock:
                if self._result_cache is None:
                    from ..cache import ResultCache

                    self._result_cache = ResultCache(self._conf, log=self.log)
        return self._result_cache

    @property
    def rpc_server(self) -> Any:
        """The server that hands transformer callbacks their clients, built
        from conf on first use (``fugue.rpc.server``; the in-process
        ``NativeRPCServer`` by default, ``fugue_tpu_torch/rpc``). A server
        with telemetry routes (``HttpRPCServer``'s ``/metrics``,
        ``/stats``) is bound to this engine."""
        if self._rpc_server is None:
            with self._rlock:
                if self._rpc_server is None:
                    from ..rpc import make_rpc_server

                    server = make_rpc_server(self.conf)
                    self._bind_rpc_metrics(server)
                    self._rpc_server = server
        return self._rpc_server

    def set_rpc_server(self, server: Any) -> None:
        with self._rlock:
            self._rpc_server = server
        self._bind_rpc_metrics(server)

    def _bind_rpc_metrics(self, server: Any) -> None:
        if hasattr(server, "bind_engine"):
            server.bind_engine(self)

    def thread_scope(self) -> Callable[[], ContextManager]:
        """Called on the thread that starts a workflow run: a factory of
        the context a task thread of that run enters, so the task uses
        this engine's device state. Nothing to carry on the host."""
        return nullcontext

    # ---- the engine context (``fugue_tpu`` :299-372) -----------------------
    @property
    def in_context(self) -> bool:
        return self._ctx_count > 0

    @property
    def is_global(self) -> bool:
        return self._is_global

    @contextmanager
    def _as_context(self, borrowed: bool = False) -> Iterator["ExecutionEngine"]:
        """This engine as the context engine until exit; the last exit
        stops it unless it is the global engine or ``borrowed`` (a
        workflow run borrows the engine it is given)."""
        with self._rlock:
            self._ctx_count += 1
        token = _CONTEXT_ENGINE.set(self)
        try:
            yield self
        finally:
            _CONTEXT_ENGINE.reset(token)
            with self._rlock:
                self._ctx_count -= 1
                if self._ctx_count == 0 and not self._is_global and not borrowed:
                    self.stop()

    def set_global(self) -> "ExecutionEngine":
        """Make this engine the process-wide one; the one it replaces is
        stopped unless it is in a context."""
        with _GLOBAL_ENGINE_LOCK:
            old = _GLOBAL_ENGINE[0]
            if old is not None and old is not self:
                with old._rlock:
                    old._is_global = False
                if not old.in_context:
                    old.stop()
            with self._rlock:
                self._is_global = True
            _GLOBAL_ENGINE[0] = self
        return self

    @staticmethod
    def clear_global() -> None:
        with _GLOBAL_ENGINE_LOCK:
            old = _GLOBAL_ENGINE[0]
            if old is not None:
                old._is_global = False
                if not old.in_context:
                    old.stop()
            _GLOBAL_ENGINE[0] = None

    def stop(self) -> None:
        with self._rlock:
            if not self._stopped:
                self._stopped = True
                self.stop_engine()

    def stop_engine(self) -> None:
        """What an engine releases when it stops: nothing on the port's
        engines, whose tensors free with their frames."""

    # ---- SQL (``fugue_tpu`` :267-297) --------------------------------------
    def create_default_sql_engine(self) -> SQLEngine:
        """The in-tree SQL engine over this engine's verbs."""
        from ..sql.local_sql import LocalSQLEngine

        return LocalSQLEngine(self)

    @property
    def sql_engine(self) -> SQLEngine:
        if self._sql_engine is None:
            with self._rlock:
                if self._sql_engine is None:
                    self._sql_engine = self.create_default_sql_engine()
        return self._sql_engine

    def set_sql_engine(self, engine: SQLEngine) -> None:
        assert_or_throw(
            isinstance(self, engine.execution_engine_constraint),
            lambda: FugueInvalidOperation(
                f"{type(engine)} requires {engine.execution_engine_constraint}"
            ),
        )
        with self._rlock:
            self._sql_engine = engine

    # ---- yields (``fugue_tpu`` :932-943) -----------------------------------
    def convert_yield_dataframe(self, df: DataFrame, as_local: bool) -> DataFrame:
        return df.as_local() if as_local else df

    def load_yielded(self, df: Yielded) -> DataFrame:
        if isinstance(df, YieldedDataFrame):
            return self.to_df(df.result)
        if isinstance(df, PhysicalYielded):
            if df.storage_type == "file":
                return self.load_df(df.name)
            return self.sql_engine.load_table(df.name)
        raise FugueBug(f"unknown yield type {type(df)}")

    def get_current_parallelism(self) -> int:
        """The engine's concurrency (``CONCURRENCY`` in a partition number):
        1 for the host engine and for one device."""
        return 1

    @property
    @abstractmethod
    def map_engine(self) -> MapEngine:
        """The engine's map, behind ``transform``."""
        raise NotImplementedError

    @abstractmethod
    def to_df(self, df: Any, schema: Any = None) -> DataFrame:
        """Convert a pandas frame, an arrow table or a frame to this
        engine's frame."""
        raise NotImplementedError

    def _missing(self, verb: str) -> NotImplementedError:
        return NotImplementedError(f"{verb} is not ported to {type(self).__name__} ({_VERBS})")

    @abstractmethod
    def repartition(self, df: DataFrame, partition_spec: PartitionSpec) -> DataFrame:
        """``df`` laid out by ``partition_spec``: its ``algo`` (``hash``
        by the keys, ``even``, ``rand``, ``coarse``) and ``num``."""
        raise NotImplementedError

    def persist(self, df: DataFrame, lazy: bool = False, **kwargs: Any) -> DataFrame:
        """Materialize ``df`` in the engine's memory; unless ``lazy``,
        return only when it is there."""
        raise self._missing("persist")

    def broadcast(self, df: DataFrame) -> DataFrame:
        """``df`` made available whole to every worker of the engine."""
        raise self._missing("broadcast")

    def select(
        self, df: DataFrame, cols: SelectColumns, where: Optional[ColumnExpr] = None,
        having: Optional[ColumnExpr] = None,
    ) -> DataFrame:
        """SQL SELECT over ``df``: WHERE, then the projection or the
        aggregate (grouped by the columns that are not aggregates), then
        HAVING and DISTINCT. The host form evaluates the IR over pandas."""
        from ..column.eval import eval_select

        local = self.to_df(df).as_local_bounded()
        res = eval_select(local.as_pandas(), local.schema, cols, where, having)
        schema = cols.replace_wildcard(local.schema).infer_schema(local.schema)
        return self.to_df(PandasDataFrame(res, schema))

    def filter(self, df: DataFrame, condition: ColumnExpr) -> DataFrame:
        """The rows of ``df`` where ``condition`` is TRUE (not FALSE, not NULL)."""
        return self.select(df, SelectColumns(all_cols()), where=condition)

    def assign(self, df: DataFrame, columns: List[ColumnExpr]) -> DataFrame:
        """``df`` with ``columns`` (each with an output name) replacing the
        columns of their names, in place, or added after them."""
        assert_or_throw(
            all(c.output_name != "" for c in columns),
            FugueInvalidOperation("all assignments must have output names"),
        )
        replaced = {c.output_name: c for c in columns}
        sel: List[ColumnExpr] = []
        for name in df.schema.names:
            # a replaced column takes the NEW expression's type
            sel.append(replaced.pop(name) if name in replaced else col(name))
        sel.extend(replaced.values())
        return self.select(df, SelectColumns(*sel))

    def fused_apply(self, df: DataFrame, steps: List[Any]) -> DataFrame:
        """Execute a fused chain of row-local verbs (``plan/fused.py``). The
        default interprets the steps with this engine's own verbs — the
        unfused task chain; the torch engine overrides it."""
        from ..plan.fused import apply_steps_engine

        return apply_steps_engine(self, df, steps)

    def lowered_segment(
        self,
        dfs: List[DataFrame],
        steps: List[Any],
        terminal: Any,
        partition_spec: Optional[PartitionSpec],
        fingerprint: str = "",
    ) -> DataFrame:
        """Execute a plan segment (``plan/lowering.py``): a row-local verb
        chain flowing into a terminal aggregate / take / distinct / join.
        The default runs it per verb — ``fused_apply``, then the terminal
        with this engine's own verb, as the unlowered task pair runs; the
        torch engine overrides it."""
        from ..plan.lowering import apply_terminal_engine

        return apply_terminal_engine(self, dfs, steps, tuple(terminal), partition_spec)

    def aggregate(
        self, df: DataFrame, partition_spec: Optional[PartitionSpec], agg_cols: List[ColumnExpr]
    ) -> DataFrame:
        """Group ``df`` by the spec's keys (none: one group of every row)
        and compute ``agg_cols``, each an expression with an aggregate."""
        from ..column.functions import is_agg

        assert_or_throw(len(agg_cols) > 0, FugueInvalidOperation("agg_cols is empty"))
        assert_or_throw(
            all(is_agg(c) for c in agg_cols),
            FugueInvalidOperation("all agg_cols must contain aggregation"),
        )
        keys: List[ColumnExpr] = []
        if partition_spec is not None and len(partition_spec.partition_by) > 0:
            keys = [col(k) for k in partition_spec.partition_by]
        return self.select(df, SelectColumns(*keys, *agg_cols))

    def join(self, df1: DataFrame, df2: DataFrame, how: str, on: Optional[List[str]] = None) -> DataFrame:
        """Join ``df1`` with ``df2`` (``how``: inner, left_outer,
        right_outer, full_outer, left_semi, left_anti or cross, or an alias)
        on the keys ``on`` (default: the columns they share), NULL keys
        matching nothing."""
        raise self._missing("join")

    def union(self, df1: DataFrame, df2: DataFrame, distinct: bool = True) -> DataFrame:
        """The rows of ``df1`` and of ``df2`` (UNION ALL); without repeats
        if ``distinct`` (UNION, NULL equal to NULL). The two schemas must
        be the same."""
        raise self._missing("union")

    def subtract(self, df1: DataFrame, df2: DataFrame, distinct: bool = True) -> DataFrame:
        """The distinct rows of ``df1`` that are not in ``df2`` (EXCEPT,
        NULL equal to NULL); ``distinct=False`` (EXCEPT ALL) raises."""
        raise self._missing("subtract")

    def intersect(self, df1: DataFrame, df2: DataFrame, distinct: bool = True) -> DataFrame:
        """The distinct rows in both ``df1`` and ``df2`` (INTERSECT, NULL
        equal to NULL); ``distinct=False`` (INTERSECT ALL) raises."""
        raise self._missing("intersect")

    def distinct(self, df: DataFrame) -> DataFrame:
        """The rows of ``df`` without repeats (NULL equals NULL)."""
        raise self._missing("distinct")

    def dropna(
        self, df: DataFrame, how: str = "any", thresh: Optional[int] = None,
        subset: Optional[List[str]] = None,
    ) -> DataFrame:
        """``df`` without the rows with NULLs: ``how`` any or all, or fewer
        than ``thresh`` non-NULL values, over ``subset`` of the columns."""
        raise self._missing("dropna")

    def fillna(self, df: DataFrame, value: Any, subset: Optional[List[str]] = None) -> DataFrame:
        """``df`` with NULLs replaced by ``value`` (a value, or a dict of
        column to value), over ``subset`` of the columns."""
        raise self._missing("fillna")

    def sample(
        self, df: DataFrame, n: Optional[int] = None, frac: Optional[float] = None,
        replace: bool = False, seed: Optional[int] = None,
    ) -> DataFrame:
        """``n`` rows of ``df``, or each row with probability ``frac``
        (one of the two), drawn with ``seed``, with or without
        ``replace``ment (TABLESAMPLE)."""
        raise self._missing("sample")

    def take(
        self, df: DataFrame, n: int, presort: str, na_position: str = "last",
        partition_spec: Optional[PartitionSpec] = None,
    ) -> DataFrame:
        """The first ``n`` rows of ``df`` (of each partition of
        ``partition_spec``'s keys) in the order of ``presort`` (or the
        spec's), NULLs ``na_position`` (ORDER BY ... LIMIT)."""
        raise self._missing("take")

    def load_df(
        self, path: Any, format_hint: Any = None, columns: Any = None, **kwargs: Any
    ) -> DataFrame:
        """The files at ``path`` (parquet, csv or json) as a frame."""
        raise self._missing("load_df")

    def save_df(
        self, df: DataFrame, path: str, format_hint: Any = None, mode: str = "overwrite",
        partition_spec: Optional[PartitionSpec] = None, force_single: bool = False, **kwargs: Any,
    ) -> DataFrame:
        """Write ``df`` to ``path``; returns ``df``."""
        raise self._missing("save_df")

    # ---- zip/comap: the blob protocol (``fugue_tpu`` :806-930) --------------
    def zip(
        self,
        dfs: DataFrames,
        how: str = "inner",
        partition_spec: Optional[PartitionSpec] = None,
        temp_path: Optional[str] = None,
        to_file_threshold: int = -1,
    ) -> DataFrame:
        """Co-partition ``dfs`` by the spec's keys (default: the columns
        they all share) into one frame: each logical partition of each
        input is one row of the keys and an arrow IPC blob of its rows,
        the rows of every input unioned, their schemas, names, ``how``
        (inner, left_outer, right_outer, full_outer or cross) and keys in
        the metadata. A blob above ``to_file_threshold`` bytes goes to a
        file under ``temp_path``."""
        assert_or_throw(len(dfs) > 0, FugueInvalidOperation("dfs is empty"))
        how = how.lower()
        assert_or_throw(
            how in ("inner", "left_outer", "right_outer", "full_outer", "cross"),
            lambda: FugueInvalidOperation(f"invalid zip type {how}"),
        )
        spec = partition_spec or PartitionSpec()
        keys = list(spec.partition_by)
        if how == "cross":
            assert_or_throw(len(keys) == 0, FugueInvalidOperation("cross zip can't have keys"))
        elif len(keys) == 0:
            keys = [n for n in dfs[0].schema.names if all(n in d.schema for d in dfs.values())]
            assert_or_throw(
                len(keys) > 0, FugueInvalidOperation("can't infer zip keys: no common columns")
            )
        serialized: List[DataFrame] = []
        schemas: List[str] = []
        names: List[str] = []
        n = len(dfs)
        for i, (name, df) in enumerate(dfs.items()):
            sub_spec = PartitionSpec(spec, by=keys) if len(keys) > 0 else PartitionSpec()
            serialized.append(
                self._serialize_by_partition(
                    df, sub_spec, df_index=i, df_count=n, temp_path=temp_path,
                    to_file_threshold=to_file_threshold,
                )
            )
            schemas.append(str(df.schema))
            names.append(name)
        res = serialized[0]
        for s in serialized[1:]:
            res = self.union(res, s, distinct=False)
        res.reset_metadata(
            {
                "serialized": True,
                "serialized_cols": [f"{_FUGUE_BLOB_PREFIX}{i}" for i in range(n)],
                "schemas": schemas,
                "serialized_has_name": dfs.has_key,
                "names": names,
                "how": how,
                "keys": keys,
            }
        )
        return res

    def _serialize_by_partition(
        self,
        df: DataFrame,
        partition_spec: PartitionSpec,
        df_index: int,
        df_count: int,
        temp_path: Optional[str] = None,
        to_file_threshold: int = -1,
    ) -> DataFrame:
        keys = list(partition_spec.partition_by)
        serializer = _PartitionSerializer(df_index, df_count, keys, temp_path, to_file_threshold)
        return self.map_engine.map_dataframe(
            df, serializer.run, _blob_schema(df.schema, keys, df_count), partition_spec
        )

    def comap(
        self,
        df: DataFrame,
        map_func: Callable[[PartitionCursor, DataFrames], LocalDataFrame],
        output_schema: Any,
        partition_spec: Optional[PartitionSpec] = None,
        on_init: Optional[Callable[[int, DataFrames], Any]] = None,
    ) -> DataFrame:
        """``map_func(cursor, frames)`` once a key of a zipped ``df``, its
        frames rebuilt from their blobs; a key that an inner (or left or
        right outer) zip leaves out is skipped, a missing side is an empty
        frame. ``on_init(0, empty frames)`` runs once first."""
        assert_or_throw(
            df.metadata.get("serialized", False),
            FugueInvalidOperation("df is not serialized (run zip first)"),
        )
        meta = dict(df.metadata)
        keys = list(meta.get("keys", []))
        spec = partition_spec or PartitionSpec()
        if len(keys) > 0:
            spec = PartitionSpec(spec, by=keys)
        out_schema = output_schema if isinstance(output_schema, Schema) else Schema(output_schema)
        runner = _Comap(meta, map_func, on_init, out_schema)
        return self.map_engine.map_dataframe(df, runner.run, out_schema, spec, on_init=runner.on_init)


def _blob_schema(schema: Schema, keys: List[str], df_count: int) -> Schema:
    """The zip's row: the keys, then one binary blob column an input."""
    blob_fields = ",".join(f"{_FUGUE_BLOB_PREFIX}{i}:binary" for i in range(df_count))
    return Schema(str(schema.extract(keys)) + "," + blob_fields) if len(keys) > 0 else Schema(blob_fields)


class _PartitionSerializer:
    """One logical partition into one blob row (``fugue_tpu`` :954)."""

    def __init__(
        self, df_index: int, df_count: int, keys: List[str], temp_path: Optional[str],
        to_file_threshold: int,
    ):
        self.df_index = df_index
        self.df_count = df_count
        self.keys = keys
        self.temp_path = temp_path
        self.to_file_threshold = to_file_threshold

    def run(self, cursor: PartitionCursor, df: LocalDataFrame) -> LocalDataFrame:
        file_path = get_temp_df_path(self.temp_path) if self.temp_path is not None else None
        blob = serialize_df(df.as_local_bounded(), self.to_file_threshold, file_path)
        row: List[Any] = list(cursor.key_value_array) if len(self.keys) > 0 else []
        blobs: List[Any] = [None] * self.df_count
        blobs[self.df_index] = blob
        row.extend(blobs)
        return ArrayDataFrame([row], _blob_schema(cursor.row_schema, self.keys, self.df_count))


class _Comap:
    """The frames of one key rebuilt from its blob rows, and the
    cotransform run over them (``fugue_tpu`` :997-1068)."""

    def __init__(
        self, meta: Dict[str, Any], func: Callable, on_init: Optional[Callable], output_schema: Schema
    ):
        self.schemas = [Schema(s) for s in meta["schemas"]]
        self.output_schema = output_schema
        self.named = meta.get("serialized_has_name", False)
        self.names = meta.get("names", [])
        self.how = meta.get("how", "inner")
        self.keys = meta.get("keys", [])
        self.func = func
        self._on_init = on_init

    def on_init(self, partition_no: int, df: DataFrame) -> None:
        if self._on_init is None:
            return
        empty = DataFrames({self._name(i): ArrayDataFrame([], s) for i, s in enumerate(self.schemas)})
        self._on_init(partition_no, empty)

    def _name(self, i: int) -> str:
        if self.named and i < len(self.names):
            return self.names[i]
        return f"_{i}"

    def run(self, cursor: PartitionCursor, df: LocalDataFrame) -> LocalDataFrame:
        import pyarrow as pa

        data = df.as_local_bounded().as_array()
        blob_idx = [df.schema.index_of_key(f"{_FUGUE_BLOB_PREFIX}{i}") for i in range(len(self.schemas))]
        frames: List[Optional[LocalBoundedDataFrame]] = []
        for i in range(len(self.schemas)):
            tables = [deserialize_df(row[blob_idx[i]]).native for row in data if row[blob_idx[i]] is not None]
            frames.append(ArrowDataFrame(pa.concat_tables(tables)) if len(tables) > 0 else None)
        if self.how == "inner" and any(f is None for f in frames):
            return ArrayDataFrame([], self.output_schema)
        if self.how == "left_outer" and frames[0] is None:
            return ArrayDataFrame([], self.output_schema)
        if self.how == "right_outer" and frames[-1] is None:
            return ArrayDataFrame([], self.output_schema)
        dfs = DataFrames(
            {
                self._name(i): f if f is not None else ArrayDataFrame([], self.schemas[i])
                for i, f in enumerate(frames)
            }
        )
        return self.func(cursor, dfs)
