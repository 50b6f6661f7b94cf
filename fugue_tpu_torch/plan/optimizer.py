"""Plan optimizer orchestration: conf gates, report, metrics, explain,
copied from ``fugue_tpu/plan/optimizer.py``.

``optimize_tasks`` is the single entry point ``FugueWorkflow.run`` calls
before execution. Everything is gated by ``fugue.tpu.plan.optimize``
(default ON) with per-pass switches; the unoptimized path is always one
conf key away.

``annotate_join_strategies`` runs first: it marks every join with the
strategy the engine's ladder (``shuffle/strategy.py``, the same decision
function) picks for the plan-time size estimates. The UDF analyzer's pass
(``fugue_tpu_torch/analysis``) runs next, gated by
``fugue.tpu.plan.analyze_udfs`` and ``.translate_udfs``. The last pass,
``annotate_delta_eligibility``, marks the verbs the delta cache
(``fugue_tpu_torch/cache/delta.py``) can serve incrementally.
Annotations change no result.
"""

import threading
from typing import Any, Dict, List, Optional, Set, Tuple

from ..constants import (
    FUGUE_TPU_CONF_PLAN_ANALYZE_UDFS,
    FUGUE_TPU_CONF_PLAN_FUSE,
    FUGUE_TPU_CONF_PLAN_LOWER_SEGMENTS,
    FUGUE_TPU_CONF_PLAN_OPTIMIZE,
    FUGUE_TPU_CONF_PLAN_PRUNE,
    FUGUE_TPU_CONF_PLAN_PUSHDOWN,
    FUGUE_TPU_CONF_PLAN_TRANSLATE_UDFS,
)
from ..workflow._tasks import FugueTask
from .ir import (
    K_CREATE,
    K_DISTINCT,
    K_DROP,
    K_DROPNA,
    K_FILLNA,
    K_FILTER,
    K_JOIN,
    K_LOAD,
    K_PROJECT,
    K_RENAME,
    K_SAMPLE,
    K_SELECT,
    K_TAKE,
    LNode,
    build_graph,
)
from .lowering import lower_segments
from .passes import emit, fuse_verbs, prune_columns, pushdown_filters

__all__ = ["PlanReport", "PlanStats", "optimize_tasks"]

class PlanStats:
    """Engine-level optimizer counters (``engine.plan_stats``). Locked:
    workflows on several threads may share one engine."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.runs = 0
            self.cols_pruned = 0
            self.filters_pushed = 0
            self.verbs_fused = 0
            self.bytes_skipped = 0
            self.segments_lowered = 0
            self.verbs_absorbed = 0
            # execution-side counters (``inc`` from engine.lowered_segment):
            # a lowered segment ran over the raw columns / took the per-verb
            # path — together they make the "one step per segment" claim
            # checkable from stats alone
            self.segments_executed = 0
            self.segments_fallback = 0
            # chunks of a lowered stream that ran the chain per verb (a
            # NULL in a non-float column)
            self.chunks_per_verb = 0

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def absorb(self, report: "PlanReport") -> None:
        with self._lock:
            self.runs += 1
            self.cols_pruned += report.cols_pruned
            self.filters_pushed += report.filters_pushed
            self.verbs_fused += report.verbs_fused
            self.bytes_skipped += report.bytes_skipped
            self.segments_lowered += report.segments_lowered
            self.verbs_absorbed += report.verbs_absorbed

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return {
                "runs": self.runs,
                "cols_pruned": self.cols_pruned,
                "filters_pushed": self.filters_pushed,
                "verbs_fused": self.verbs_fused,
                "bytes_skipped": self.bytes_skipped,
                "segments_lowered": self.segments_lowered,
                "verbs_absorbed": self.verbs_absorbed,
                "segments_executed": self.segments_executed,
                "segments_fallback": self.segments_fallback,
                "chunks_per_verb": self.chunks_per_verb,
            }


class PlanReport:
    """What one optimization run did — rendered by ``workflow.explain()``
    and attached (as attrs) to the ``plan.optimize`` span."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.cols_pruned = 0
        self.filters_pushed = 0
        self.verbs_fused = 0
        self.bytes_skipped = 0
        self.segments_lowered = 0
        self.verbs_absorbed = 0
        # UDF static analysis (fugue_tpu_torch/analysis): per-run counters
        # plus the structured per-UDF diagnostics workflow.lint() folds in
        self.udfs_analyzed = 0
        self.udfs_translated = 0
        self.udfs_refused = 0
        self.udf_diags: List[Dict[str, Any]] = []
        # plan-time join strategy per join node (annotate_join_strategies)
        self.join_strategies: List[Dict[str, Any]] = []
        self.segments: List[str] = []
        self.notes: List[str] = []
        self.before: List[str] = []
        self.after: List[str] = []

    def note(self, msg: str) -> None:
        if msg not in self.notes:
            self.notes.append(msg)

    def span_attrs(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "cols_pruned": self.cols_pruned,
            "filters_pushed": self.filters_pushed,
            "verbs_fused": self.verbs_fused,
            "bytes_skipped": self.bytes_skipped,
            "segments_lowered": self.segments_lowered,
            "verbs_absorbed": self.verbs_absorbed,
            "udfs_translated": self.udfs_translated,
        }

    @property
    def changed(self) -> bool:
        return (
            self.cols_pruned
            + self.filters_pushed
            + self.verbs_fused
            + self.segments_lowered
            + self.udfs_translated
        ) > 0

    def render(self) -> str:
        lines = ["== logical plan =="]
        lines.extend("  " + s for s in self.before)
        if not self.enabled:
            lines.append("== optimizer disabled (fugue.tpu.plan.optimize=false) ==")
            return "\n".join(lines)
        lines.append(
            "== optimized plan (cols_pruned=%d filters_pushed=%d "
            "verbs_fused=%d segments_lowered=%d verbs_absorbed=%d "
            "udfs_translated=%d/%d bytes_skipped~%d) =="
            % (
                self.cols_pruned,
                self.filters_pushed,
                self.verbs_fused,
                self.segments_lowered,
                self.verbs_absorbed,
                self.udfs_translated,
                self.udfs_analyzed,
                self.bytes_skipped,
            )
        )
        lines.extend("  " + s for s in self.after)
        if self.notes:
            lines.append("== notes ==")
            lines.extend("  " + s for s in self.notes)
        return "\n".join(lines)


def _render_nodes(nodes: List[LNode]) -> List[str]:
    idx = {id(n): i for i, n in enumerate(nodes)}
    out = []
    for i, n in enumerate(nodes):
        ins = ",".join(f"t{idx[id(x)]}" for x in n.inputs if id(x) in idx)
        label = n.kind
        if n.task is not None:
            label += f"<{type(n.task.extension).__name__}>"
        ann = (" -- " + "; ".join(n.annotations)) if n.annotations else ""
        pin = " [pinned]" if n.pinned else ""
        out.append(f"t{i}: {label}({ins}){pin}{ann}")
    return out


def _flag(conf: Any, key: str, default: bool = True) -> bool:
    try:
        return bool(conf.get(key, default))
    except Exception:
        return default


# kinds whose output is never larger than their (first) input: a size
# estimate flows through them toward the nearest create or load source
_SIZE_PASSTHROUGH_KINDS = {
    K_PROJECT,
    K_DROP,
    K_RENAME,
    K_FILTER,
    K_SELECT,
    K_DISTINCT,
    K_DROPNA,
    K_FILLNA,
    K_SAMPLE,
    K_TAKE,
}


def _estimate_node_size(
    n: LNode, memo: Dict[int, Tuple[Optional[int], Optional[int], bool]]
) -> Tuple[Optional[int], Optional[int], bool]:
    """A static (bytes, rows, is_stream) upper-bound estimate of one plan
    node: concrete created data and parquet metadata are the sources;
    verbs that shrink rows pass the estimate through; everything else is
    unknown (None), and the run time checks the live sizes again."""
    if id(n) in memo:
        return memo[id(n)]
    est: Tuple[Optional[int], Optional[int], bool] = (None, None, False)
    if n.kind == K_CREATE:
        data = n.info.get("data")
        if n.info.get("is_stream"):
            est = (None, None, True)
        else:
            try:
                import pandas as pd
                import pyarrow as pa

                from ..dataframe import DataFrame
                from ..shuffle.strategy import estimate_frame_bytes, estimate_frame_rows

                if isinstance(data, pa.Table):
                    est = (int(data.nbytes), int(data.num_rows), False)
                elif isinstance(data, pd.DataFrame):
                    est = (int(data.memory_usage(index=False, deep=False).sum()), int(len(data)), False)
                elif isinstance(data, DataFrame):
                    est = (estimate_frame_bytes(data), estimate_frame_rows(data), False)
                elif isinstance(data, list):
                    est = (None, len(data), False)
            except Exception:
                est = (None, None, False)
    elif n.kind == K_LOAD:
        path, fmt = n.info.get("path"), n.info.get("fmt") or ""
        try:
            from .._utils.io import FileParser

            if isinstance(path, str) and FileParser(path, fmt or None).file_format == "parquet":
                import pyarrow.parquet as pq

                meta = pq.ParquetFile(path).metadata
                nbytes = sum(meta.row_group(i).total_byte_size for i in range(meta.num_row_groups))
                est = (int(nbytes), int(meta.num_rows), False)
        except Exception:
            est = (None, None, False)
    elif n.kind in _SIZE_PASSTHROUGH_KINDS and len(n.inputs) >= 1:
        est = _estimate_node_size(n.inputs[0], memo)
    memo[id(n)] = est
    return est


def annotate_join_strategies(
    nodes: List[LNode], conf: Any, report: "PlanReport", device: Any = None
) -> None:
    """Mark every join node with the strategy the engine's ladder (the same
    ``choose_join_strategy``) picks for the plan-time size estimates on
    ``device``, and note it in the report, so ``workflow.explain()`` shows
    broadcast / copartition / shuffle_spill before anything runs. Only an
    annotation: the run-time decision over the live sizes is the one that
    holds. Plan time counts one shard, the port's one card."""
    from ..shuffle.strategy import choose_join_strategy, default_mesh_shards

    n_shards = default_mesh_shards()
    memo: Dict[int, Tuple[Optional[int], Optional[int], bool]] = {}
    idx = {id(n): i for i, n in enumerate(nodes)}
    for n in nodes:
        if n.kind != K_JOIN or len(n.inputs) != 2:
            continue
        how = n.info.get("how", "")
        lb, _lr, ls = _estimate_node_size(n.inputs[0], memo)
        rb, rr, rs = _estimate_node_size(n.inputs[1], memo)
        if how == "cross":
            strategy, reason = "broadcast", "cross join (constant-key expansion)"
        elif ls or rs:
            strategy, reason = (
                "stream",
                "one-pass side: streaming join plan, spill shuffle if ineligible",
            )
        else:
            dec = choose_join_strategy(conf, lb, rb, rr, n_shards=n_shards, device=device)
            strategy, reason = dec.strategy, dec.reason
        n.annotations.append(f"strategy={strategy}")
        report.join_strategies.append(
            {"node": f"t{idx[id(n)]}", "how": how, "strategy": strategy, "reason": reason}
        )
        report.note("join t%d (%s): strategy=%s -- %s" % (idx[id(n)], how, strategy, reason))


def annotate_delta_eligibility(nodes: List[LNode], report: "PlanReport") -> None:
    """Mark every verb the partition-level delta cache
    (``cache/delta.py``) can serve incrementally: row-local verbs split
    at any partition boundary; sum/count/avg/min/max aggregates maintain
    a partial accumulator. Everything unmarked takes the whole-task path
    — ``workflow.explain()``'s cache section shows the per-task refusal
    reason."""
    from .ir import node_delta_row_local

    marked = 0
    for n in nodes:
        try:
            if n.kind == K_LOAD:
                n.annotations.append("delta:source")
            elif node_delta_row_local(n):
                n.annotations.append("delta:row-local")
            elif n.kind in ("aggregate", "segment"):
                from ..cache.delta import _DeltaRefused, parse_agg_spec

                # a segment synthesized THIS pass keeps its terminal/task
                # on node attributes; a re-classified segment task carries
                # them in info/params
                origin = n.task if n.task is not None else n.tail_origin
                if n.kind == "segment":
                    terminal = n.info.get("terminal") or n.terminal or ("?",)
                    if terminal[0] != "aggregate":
                        continue
                    cols = list(terminal[1])
                else:
                    cols = list(
                        origin.params.get("columns", [])
                        if origin is not None
                        else []
                    )
                keys = (
                    list(origin.partition_spec.partition_by)
                    if origin is not None
                    else []
                )
                try:
                    parse_agg_spec(keys, cols)
                except _DeltaRefused:
                    continue
                n.annotations.append("delta:accumulator")
            else:
                continue
            marked += 1
        except Exception:  # annotation must never fail planning
            continue
    if marked:
        report.note(
            "%d verb(s) delta-eligible (partition-level incremental "
            "recompute)" % marked
        )


def optimize_tasks(
    tasks: List[FugueTask],
    conf: Any,
    stats: Optional[PlanStats] = None,
    analysis_stats: Any = None,
    device: Any = None,
) -> Tuple[List[FugueTask], Dict[int, FugueTask], Set[int], PlanReport]:
    """Rewrite the task DAG. Returns (tasks to execute, result-alias map
    {id(original task): executed task}, ids of original tasks whose
    intermediate result is no longer computed anywhere (fused interiors,
    producers a filter commuted past), report). With the optimizer off
    the ORIGINAL list round-trips untouched. ``device`` is the engine's,
    whose memory is the join strategies' budget where the conf sets
    none."""
    enabled = _flag(conf, FUGUE_TPU_CONF_PLAN_OPTIMIZE, True)
    report = PlanReport(enabled)
    if not enabled or len(tasks) == 0:
        return tasks, {}, set(), report
    nodes = build_graph(tasks)
    report.before = _render_nodes(nodes)
    annotate_join_strategies(nodes, conf, report, device)
    if _flag(conf, FUGUE_TPU_CONF_PLAN_ANALYZE_UDFS, True):
        # UDF static analysis FIRST: translated UDFs become plain plan
        # nodes every later pass (pushdown/prune/fuse/lower) composes
        # with; analyzed-but-refused ones carry exact column facts
        from ..analysis import expand_udf_transforms

        diags = expand_udf_transforms(
            nodes,
            report,
            translate=_flag(conf, FUGUE_TPU_CONF_PLAN_TRANSLATE_UDFS, True),
        )
        if analysis_stats is not None and diags:
            analysis_stats.absorb(diags)
    if _flag(conf, FUGUE_TPU_CONF_PLAN_PUSHDOWN, True):
        pushdown_filters(nodes, report)
    if _flag(conf, FUGUE_TPU_CONF_PLAN_PRUNE, True):
        prune_columns(nodes, report)
    if _flag(conf, FUGUE_TPU_CONF_PLAN_FUSE, True):
        fuse_verbs(nodes, report)
    if _flag(conf, FUGUE_TPU_CONF_PLAN_LOWER_SEGMENTS, True):
        lower_segments(nodes, report)
    annotate_delta_eligibility(nodes, report)
    report.after = _render_nodes(nodes)
    if not report.changed:
        return tasks, {}, set(), report
    new_tasks, aliases = emit(nodes)
    removed = {id(t) for t in tasks if id(t) not in aliases}
    if removed:
        report.note(
            "%d intermediate result(s) optimized away; pin with "
            "persist()/yield to keep them addressable" % len(removed)
        )
    if stats is not None:
        stats.absorb(report)
    return new_tasks, aliases, removed, report
