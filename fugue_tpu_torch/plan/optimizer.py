"""Plan optimizer orchestration: conf gates, report, metrics, explain,
copied from ``fugue_tpu/plan/optimizer.py``.

``optimize_tasks`` is the single entry point ``FugueWorkflow.run`` calls
before execution. Everything is gated by ``fugue.tpu.plan.optimize``
(default ON) with per-pass switches; the unoptimized path is always one
conf key away.

The UDF analyzer's pass (``fugue_tpu_torch/analysis``) runs first, gated
by ``fugue.tpu.plan.analyze_udfs`` and ``.translate_udfs``. The last
pass, ``annotate_delta_eligibility``, marks the verbs the delta cache
(``fugue_tpu_torch/cache/delta.py``) can serve incrementally. The
reference's join-strategy annotation (``annotate_join_strategies``, over
``shuffle/strategy.py``) waits for ROADMAP.md A.7, and the report notes
it once. Annotations change no result.
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
from .ir import K_LOAD, LNode, build_graph
from .lowering import lower_segments
from .passes import emit, fuse_verbs, prune_columns, pushdown_filters

__all__ = ["PlanReport", "PlanStats", "optimize_tasks"]

# what the report says of the pass that waits for its layer
_WAITING = ("join strategies not annotated: the shuffle ladder is ROADMAP.md A.7",)


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
) -> Tuple[List[FugueTask], Dict[int, FugueTask], Set[int], PlanReport]:
    """Rewrite the task DAG. Returns (tasks to execute, result-alias map
    {id(original task): executed task}, ids of original tasks whose
    intermediate result is no longer computed anywhere (fused interiors,
    producers a filter commuted past), report). With the optimizer off
    the ORIGINAL list round-trips untouched."""
    enabled = _flag(conf, FUGUE_TPU_CONF_PLAN_OPTIMIZE, True)
    report = PlanReport(enabled)
    if not enabled or len(tasks) == 0:
        return tasks, {}, set(), report
    nodes = build_graph(tasks)
    report.before = _render_nodes(nodes)
    for msg in _WAITING:
        report.note(msg)
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
