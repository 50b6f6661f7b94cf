"""Distributed workflow execution, copied from
``fugue_tpu/plan/distribute.py``: partition the task DAG into board jobs.

The planner pass that routes ``workflow.run`` through the fault-tolerant
dist tier (``fugue_tpu_torch/dist``). After optimization (and after the cache
planner cut), it scans the task DAG for *fragments* — subgraphs of the
canonical distributed shape::

    Load ──(row-local steps)──┐
                              ├── equi-JOIN / keyed AGGREGATE /
    Load ──(row-local steps)──┘    bucket-local SQL SELECT
                                        │
                              (row-local tail, ≤1 keyed aggregate)
                                        │
                                   result task

and hands each one to :meth:`DistSupervisor.run_workflow_job`: the Load
roots become leased map tasks whose bodies are the fused row-local step
chains (interpreted with the same engine verbs the local path uses), the
shuffle between map and reduce is the network-partitioned fragment
exchange, and each bucket's reduce publishes a content-addressed partial
to the shared store. The ENTIRE recovery ladder — lease steal on
stale heartbeat, categorized TRANSIENT/WORKER_LOST re-dispatch,
orphaned-fragment invalidation, speculative straggler twins, supervisor
restart resume — applies to the workflow for free.

The refusal ladder (every rung readable in ``workflow.explain()``):
anything the planner cannot PROVE safe degrades that subgraph to local
execution with the reason recorded — non-parquet or partitioned sources,
non-row-local interior verbs (UDF transforms, distinct, take, ...),
pinned or multi-consumer interiors, cross joins, global aggregates,
tail aggregates whose keys don't cover the shuffle keys, SQL shapes that
are not bucket-local (DISTINCT, ORDER BY/LIMIT, set ops, subqueries,
grouping sets, group keys not covering the join keys), cache-served
subgraphs (a warm local cut always wins), and shuffle keys with no
canonical hashable dtype. ``fugue.tpu.dist.enabled=false`` (or an unset
``fugue.tpu.dist.board``) leaves the planner inert — the local path runs
bit-identically, by construction rather than by equivalence testing.

Correctness argument for bucket-local execution: rows are hash-bucketed
by the shuffle keys on BOTH sides, so every join match and every group
whose keys cover the shuffle keys is contained in one bucket — running
the reduce body per bucket and concatenating in bucket order is exact
(the same argument the hand-written ``plan_join_job`` jobs rely on).
Warm reruns delta-skip at two tiers: the local result cache cuts served
subgraphs before this planner sees them, and the board's
content-addressed task ids reuse done records for unchanged partitions
(``workflow_partitions_delta_skipped``).
"""

import functools
import os
from typing import Any, Dict, List, Optional, Set, Tuple

import pandas as pd

from ..workflow._tasks import FugueTask

__all__ = [
    "DistributePlan",
    "plan_distribution",
    "execute_fragment",
    "describe_distribution",
]

# load-source extensions the worker tier's read_source_paths can read
# with the SAME semantics as the engine loader (plain parquet files;
# csv/json engine loads carry header/dtype conf the workers don't mirror)
_DIST_SOURCE_EXTS = (".parquet", ".pq")


class _Refuse(Exception):
    """Planner-internal: this candidate fragment cannot distribute."""


class Fragment:
    """One distributable subgraph, resolved to a board-job recipe."""

    def __init__(
        self,
        label: str,
        result_task: FugueTask,
        covered_ids: Set[int],
        sides: List[Dict[str, Any]],
        keys: List[str],
        buckets: int,
        terminal: Tuple,
        tail_ops: List[Tuple],
        reduce_token: str,
    ):
        self.label = label
        self.result_task = result_task
        self.covered_ids = covered_ids
        self.interior_ids = covered_ids - {id(result_task)}
        self.sides = sides
        self.keys = keys
        self.buckets = buckets
        self.terminal = terminal
        self.tail_ops = tail_ops
        self.reduce_token = reduce_token

    def describe(self) -> List[str]:
        t = self.terminal
        if t[0] == "join":
            head = f"join how={t[1]} on={list(self.keys)}"
        elif t[0] == "aggregate":
            head = f"aggregate keys={list(self.keys)}"
        else:
            head = f"sql {t[2]} keys={list(self.keys)}"
        lines = [
            f"fragment -> {self.label}: {head} buckets={self.buckets} "
            f"covers {len(self.covered_ids)} task(s)"
        ]
        for s in self.sides:
            steps = " | ".join(_op_token(st) for st in s["steps"])
            lines.append(
                f"  map[{s['name']}]: {len(s['paths'])} file(s)"
                + (f" | {steps}" if steps else "")
            )
        for op in self.tail_ops:
            if op[0] == "steps":
                lines.append(
                    "  tail: " + " | ".join(_op_token(st) for st in op[1])
                )
            else:
                lines.append(f"  tail: aggregate keys={list(op[1])}")
        return lines


class DistributePlan:
    """The pass output: fragments to route, refusals to explain."""

    def __init__(self, board: str, enabled: bool):
        self.board = board
        self.enabled = enabled
        self.fragments: List[Fragment] = []
        self.refusals: List[Tuple[str, str]] = []
        self.results: Dict[int, Fragment] = {}
        self.interior_ids: Set[int] = set()

    @property
    def active(self) -> bool:
        return bool(self.board) and self.enabled


# ---------------------------------------------------------------------------
# worker-side bodies (module-level: cloudpickled by reference, the same
# package import on every worker — and shared VERBATIM by the serial
# kill-switch path, so bit-identity is by construction)
# ---------------------------------------------------------------------------

_WORKER_ENGINE: Any = None


def _worker_engine() -> Any:
    """Module-cached host NativeExecutionEngine for step interpretation
    (cache and tuning off: map/reduce bodies must be pure functions of
    their input rows — the dist tier owns caching via content addresses).
    It never touches a card: the fragment's combined frame enters the
    driving engine (the card's, for a ``TorchExecutionEngine``) only in
    the workflow context, after the job."""
    global _WORKER_ENGINE
    if _WORKER_ENGINE is None:
        from ..constants import (
            FUGUE_TPU_CONF_CACHE_ENABLED,
            FUGUE_TPU_CONF_TUNING_ENABLED,
        )
        from ..execution import NativeExecutionEngine

        _WORKER_ENGINE = NativeExecutionEngine(
            {
                FUGUE_TPU_CONF_CACHE_ENABLED: False,
                FUGUE_TPU_CONF_TUNING_ENABLED: False,
            }
        )
    return _WORKER_ENGINE


def _apply_ext_steps(engine: Any, df: Any, steps: List[Tuple]) -> Any:
    """Interpret the extended step grammar: the fused-verbs grammar via
    ``apply_steps_engine`` plus ``("dropna", how, thresh, subset)`` and
    ``("fillna", value, subset)`` via the matching engine verbs."""
    from .fused import apply_steps_engine

    plain: List[Tuple] = []
    for st in steps:
        if st[0] in ("dropna", "fillna"):
            if plain:
                df = apply_steps_engine(engine, df, plain)
                plain = []
            if st[0] == "dropna":
                df = engine.dropna(df, how=st[1], thresh=st[2], subset=st[3])
            else:
                df = engine.fillna(df, value=st[1], subset=st[2])
        else:
            plain.append(st)
    if plain:
        df = apply_steps_engine(engine, df, plain)
    return df


def _map_body(pdf: pd.DataFrame, *, steps: List[Tuple]) -> pd.DataFrame:
    """One map task's body: the side's row-local step chain."""
    if not steps:
        return pdf
    eng = _worker_engine()
    return _apply_ext_steps(eng, eng.to_df(pdf), steps).as_pandas()


def _reduce_body(
    *pdfs: pd.DataFrame, terminal: Tuple, tail_ops: List[Tuple]
) -> pd.DataFrame:
    """One bucket's reduce: the fragment terminal (join / keyed aggregate
    / whole SQL statement) followed by the tail ops — all via the same
    engine verbs the local path uses."""
    from ..collections.partition import PartitionSpec

    eng = _worker_engine()
    kind = terminal[0]
    if kind == "join":
        df = eng.join(
            eng.to_df(pdfs[0]),
            eng.to_df(pdfs[1]),
            how=terminal[1],
            on=list(terminal[2]),
        )
    elif kind == "aggregate":
        df = eng.aggregate(
            eng.to_df(pdfs[0]),
            PartitionSpec(by=list(terminal[1])),
            list(terminal[2]),
        )
    elif kind == "sql":
        from ..dataframe import DataFrames

        statement, names = terminal[1], terminal[2]
        dfs = DataFrames(
            {n: eng.to_df(p) for n, p in zip(names, pdfs)}
        )
        df = eng.sql_engine.select(dfs, statement)
    else:  # pragma: no cover - planner emits only the three kinds
        raise ValueError(f"unknown fragment terminal {kind!r}")
    for op in tail_ops:
        if op[0] == "steps":
            df = _apply_ext_steps(eng, df, op[1])
        else:
            df = eng.aggregate(df, PartitionSpec(by=list(op[1])), list(op[2]))
    return df.as_pandas()


# ---------------------------------------------------------------------------
# step extraction + tokens
# ---------------------------------------------------------------------------


def _steps_of(n: Any) -> Optional[List[Tuple]]:
    """A node's row-local step list in the extended grammar, or None when
    it has no step form (the refusal reason is the node's kind)."""
    from .ir import (
        K_ASSIGN,
        K_DROP,
        K_DROPNA,
        K_FILLNA,
        K_FILTER,
        K_FUSED,
        K_PROJECT,
        K_RENAME,
        K_SELECT,
    )

    t = n.task
    if n.kind == K_FUSED:
        return list(n.info.get("steps", []))
    if n.kind == K_PROJECT:
        return [("project", tuple(n.info["columns"]))]
    if n.kind == K_DROP:
        return [("drop", tuple(n.info["columns"]), bool(n.info["if_exists"]))]
    if n.kind == K_RENAME:
        return [("rename", dict(n.info["columns"]))]
    if n.kind == K_FILTER:
        return [("filter", n.info["condition"])]
    if n.kind == K_ASSIGN:
        return [("assign", tuple(n.info["columns"]))]
    if n.kind == K_SELECT:
        sc = n.info["columns"]
        if sc.has_agg or sc.is_distinct or n.info.get("having") is not None:
            return None
        steps: List[Tuple] = []
        if n.info.get("where") is not None:
            steps.append(("filter", n.info["where"]))
        steps.append(("select", sc))
        return steps
    if n.kind == K_DROPNA and t is not None:
        return [
            (
                "dropna",
                t.params.get("how", "any"),
                t.params.get_or_none("thresh", int),
                t.params.get_or_none("subset", list),
            )
        ]
    if n.kind == K_FILLNA and t is not None:
        return [
            (
                "fillna",
                t.params.get_or_none("value", object),
                t.params.get_or_none("subset", list),
            )
        ]
    return None


def _op_token(st: Tuple) -> str:
    """Deterministic description of one step — the content-address token
    fed into board task ids (NOT a pickle: cloudpickle blobs are not
    stable across processes, ``describe_step`` renderings are)."""
    from .fused import describe_step

    if st[0] == "dropna":
        return f"dropna[how={st[1]},thresh={st[2]},subset={st[3]}]"
    if st[0] == "fillna":
        return f"fillna[value={st[1]!r},subset={st[2]}]"
    return describe_step(st)


def _steps_token(steps: List[Tuple]) -> str:
    return " | ".join(_op_token(s) for s in steps)


def _terminal_token(terminal: Tuple, tail_ops: List[Tuple]) -> str:
    kind = terminal[0]
    if kind == "join":
        head = f"join[{terminal[1]},on={list(terminal[2])}]"
    elif kind == "aggregate":
        head = (
            f"aggregate[keys={list(terminal[1])},"
            f"cols={[repr(c) for c in terminal[2]]}]"
        )
    else:
        head = f"sql[{terminal[1].construct(dialect='spark')!r},names={terminal[2]}]"
    parts = [head]
    for op in tail_ops:
        if op[0] == "steps":
            parts.append(_steps_token(op[1]))
        else:
            parts.append(
                f"aggregate[keys={list(op[1])},"
                f"cols={[repr(c) for c in op[2]]}]"
            )
    return " ;; ".join(parts)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def plan_distribution(
    tasks: List[FugueTask],
    conf: Any,
    cache_plan: Any = None,
) -> DistributePlan:
    """Scan the (post-optimization) task list for distributable fragments.
    Never raises: every obstacle is a recorded refusal and the subgraph
    stays local. ``cache_plan`` (when present) blocks fragments whose
    tasks the local cache already serves — a warm local cut always wins."""
    from ..constants import (
        FUGUE_TPU_CONF_DIST_BOARD,
        FUGUE_TPU_CONF_DIST_BUCKETS,
        FUGUE_TPU_CONF_DIST_ENABLED,
    )

    board = str(conf.get(FUGUE_TPU_CONF_DIST_BOARD, "") or "")
    enabled = bool(conf.get(FUGUE_TPU_CONF_DIST_ENABLED, True))
    plan = DistributePlan(board, enabled)
    if not plan.active:
        return plan
    buckets = int(conf.get(FUGUE_TPU_CONF_DIST_BUCKETS, 8))
    from .ir import K_AGGREGATE, K_JOIN, K_SEGMENT, classify

    ln = {id(t): classify(t) for t in tasks}
    cons: Dict[int, int] = {}
    for t in tasks:
        for d in t.inputs:
            cons[id(d)] = cons.get(id(d), 0) + 1
    blocked: Set[int] = set()
    if cache_plan is not None:
        blocked |= set(cache_plan.hits) | set(cache_plan.delta_hits)
        blocked |= set(cache_plan.skipped) | set(cache_plan.checkpoint_hits)
    used: Set[int] = set()
    for i, t in enumerate(tasks):
        if id(t) in used:
            continue
        n = ln[id(t)]
        is_sql = _is_plain_sql(t)
        # a lowered segment is itself a shuffle-point candidate when its
        # terminal is a join or a KEYED aggregate (the lowering pass runs
        # before this one, so segments are what joins/aggregates with
        # row-local chains look like post-optimization)
        is_seg = False
        if n.kind == K_SEGMENT:
            term_spec = n.info.get("terminal") or (None,)
            is_seg = term_spec[0] == "join" or (
                term_spec[0] == "aggregate"
                and list(t.partition_spec.partition_by)
            )
        if not (
            n.kind == K_JOIN
            or (n.kind == K_AGGREGATE and n.info.get("keys"))
            or is_seg
            or is_sql
        ):
            continue
        label = f"t{i} {type(t.extension).__name__}" + (
            f" ({t.name})" if t.name else ""
        )
        try:
            frag = _build_fragment(
                t, label, ln, cons, blocked, used, buckets, is_sql, is_seg
            )
        except _Refuse as r:
            plan.refusals.append((label, str(r)))
            continue
        plan.fragments.append(frag)
        used |= frag.covered_ids
        plan.results[id(frag.result_task)] = frag
        plan.interior_ids |= frag.interior_ids
    return plan


def _is_plain_sql(t: FugueTask) -> bool:
    from ..extensions._builtins.processors import RunSQLSelect

    return isinstance(t.extension, RunSQLSelect)


def _check_interior(t: FugueTask, cons: Dict[int, int], blocked: Set[int],
                    used: Set[int], what: str) -> None:
    from .ir import task_pinned

    if id(t) in used:
        raise _Refuse(f"{what} is already claimed by another fragment")
    if id(t) in blocked:
        raise _Refuse(
            f"{what} is served by the local result cache (warm cut wins)"
        )
    if task_pinned(t):
        raise _Refuse(
            f"{what} is pinned (checkpoint/yield/broadcast must "
            "materialize locally)"
        )
    if cons.get(id(t), 0) != 1:
        raise _Refuse(
            f"{what} feeds {cons.get(id(t), 0)} consumers (its intermediate "
            "frame must materialize locally)"
        )


def _expand_load(t: FugueTask, n: Any) -> Tuple[List[str], List[Tuple]]:
    """A Load root → (worker-readable file list, projection step prefix);
    refuses anything ``read_source_paths`` cannot reproduce byte-for-byte
    semantically (non-parquet, load kwargs, schema coercion, partitioned
    directory datasets, sidecar schemas)."""
    from .._utils.io import FileParser

    path = n.info.get("path")
    if not isinstance(path, str):
        raise _Refuse("load path is not a plain string")
    if dict(t.params.get("params", {})):
        raise _Refuse("load carries reader kwargs workers don't mirror")
    try:
        parser = FileParser(path, n.info.get("fmt") or None)
        fmt = parser.file_format
        files = parser.find_files()
    except Exception as e:
        raise _Refuse(f"load source not resolvable at plan time ({e})")
    if fmt != "parquet":
        raise _Refuse(
            f"{fmt} sources don't distribute (engine reader semantics — "
            "header/dtype conf — are not mirrored by workers)"
        )
    if not files:
        raise _Refuse("load matched no files")
    for f in files:
        if os.path.isdir(f):
            raise _Refuse("partitioned (hive) dataset directories stay local")
        if os.path.splitext(f)[1].lower() not in _DIST_SOURCE_EXTS:
            raise _Refuse(f"unsupported source extension on {f!r}")
    if os.path.isdir(path) and os.path.exists(
        os.path.join(path, "_fugue_schema")
    ):
        raise _Refuse("dataset carries a _fugue_schema sidecar (stays local)")
    cols = n.info.get("columns")
    if cols is None:
        return files, []
    if isinstance(cols, list) and all(isinstance(c, str) for c in cols):
        return files, [("project", tuple(cols))]
    raise _Refuse("load with schema coercion (non name-list columns)")


def _side_chain(
    t: FugueTask,
    ln: Dict[int, Any],
    cons: Dict[int, int],
    blocked: Set[int],
    used: Set[int],
) -> Tuple[List[str], List[Tuple], Set[int]]:
    """Walk from a terminal input down to its Load root, converting every
    interior node to row-local steps. Returns (paths, steps, covered)."""
    from .ir import K_LOAD

    rev: List[Tuple[FugueTask, Any]] = []
    cur = t
    while True:
        n = ln[id(cur)]
        if n.kind == K_LOAD:
            _check_interior(cur, cons, blocked, used, f"load {_tlabel(cur)}")
            paths, prefix = _expand_load(cur, n)
            steps = list(prefix)
            covered = {id(cur)}
            for task, node in reversed(rev):
                steps.extend(_steps_of(node) or [])
                covered.add(id(task))
            return paths, steps, covered
        _check_interior(cur, cons, blocked, used, _tlabel(cur))
        if _steps_of(n) is None:
            raise _Refuse(
                f"{_tlabel(cur)} ({n.kind}) is not row-local-distributable"
            )
        if len(cur.inputs) != 1:
            raise _Refuse(f"{_tlabel(cur)} has {len(cur.inputs)} inputs")
        rev.append((cur, n))
        cur = cur.inputs[0]


def _tlabel(t: FugueTask) -> str:
    return t.name or type(t.extension).__name__


def _has_window_expr(e: Any) -> bool:
    from ..column.expressions import _WindowExpr

    if isinstance(e, _WindowExpr):
        return True
    return any(_has_window_expr(c) for c in getattr(e, "children", ()) or ())


def _sql_terminal(t: FugueTask) -> Tuple[Tuple, List[str], List[int]]:
    """Validate a RunSQLSelect statement as bucket-local and return
    ``(("sql", statement, scan_names), shuffle_keys, input_positions)``.
    Accepted shapes: two-table equi-join (optional row-local residual /
    WHERE / HAVING, group keys covering the join keys) and single-table
    keyed GROUP BY. Everything else refuses with the specific rung."""
    from ..column.expressions import _NamedColumnExpr
    from ..column.functions import is_agg
    from ..sql.parser import JoinNode, Scan, SelectNode, SQLParser

    if t.params.get_or_none("sql_engine", object) is not None:
        raise _Refuse("engine-specific SQL (CONNECT) stays local")
    statement = t.params.get_or_throw("statement", object)
    raw = statement.construct(dialect="spark")  # mirror LocalSQLEngine
    if raw.lower().count("select") > 1:
        raise _Refuse("nested SELECT (subquery/CTE/set op) is not bucket-local")
    try:
        node = SQLParser(raw).parse_full()
    except Exception as e:
        raise _Refuse(f"SQL not parseable at plan time ({e})")
    if not isinstance(node, SelectNode):
        raise _Refuse(
            f"{type(node).__name__} (ORDER BY/LIMIT/set op) is not "
            "bucket-local"
        )
    if node.distinct:
        raise _Refuse("SELECT DISTINCT is not bucket-local")
    if node.grouping_sets:
        raise _Refuse("GROUPING SETS/ROLLUP/CUBE are not bucket-local")
    for e in list(node.projections) + (
        [node.where] if node.where is not None else []
    ) + ([node.having] if node.having is not None else []):
        if _has_window_expr(e):
            raise _Refuse("window functions are not bucket-local")
    group_names: List[str] = []
    for g in node.group_by:
        if not isinstance(g, _NamedColumnExpr) or g.wildcard:
            raise _Refuse("non-column GROUP BY expressions stay local")
        group_names.append(g.name)
    child = node.child
    if isinstance(child, JoinNode):
        if not isinstance(child.left, Scan) or not isinstance(
            child.right, Scan
        ):
            raise _Refuse("only two-table FROM a JOIN b distributes")
        if child.how == "cross" or not child.on:
            raise _Refuse("cross/non-equi joins are not bucket-local")
        if child.condition is not None and child.how != "inner":
            raise _Refuse("residual ON predicates distribute for INNER only")
        keys = list(child.on)
        names = [child.left.name, child.right.name]
        if names[0] == names[1]:
            raise _Refuse("self-joins stay local")
        if group_names:
            if not set(group_names) >= set(keys):
                raise _Refuse(
                    f"GROUP BY {group_names} does not cover the join keys "
                    f"{keys} (groups would span buckets)"
                )
        elif any(is_agg(p) for p in node.projections):
            raise _Refuse("global (ungrouped) aggregates span buckets")
        return ("sql", statement, names), keys, _scan_positions(t, names)
    if isinstance(child, Scan):
        if not group_names:
            raise _Refuse(
                "single-table SELECT has no shuffle point (no GROUP BY keys)"
            )
        names = [child.name]
        return ("sql", statement, names), group_names, _scan_positions(
            t, names
        )
    raise _Refuse(
        f"FROM {type(child).__name__ if child else 'nothing'} is not "
        "distributable"
    )


def _scan_positions(t: FugueTask, names: List[str]) -> List[int]:
    in_names = list(t.input_names or [])
    pos = []
    for name in names:
        if name not in in_names:
            raise _Refuse(
                f"SQL table {name!r} is not a direct workflow input "
                f"(inputs: {in_names})"
            )
        pos.append(in_names.index(name))
    return pos


def _build_fragment(
    term: FugueTask,
    label: str,
    ln: Dict[int, Any],
    cons: Dict[int, int],
    blocked: Set[int],
    used: Set[int],
    buckets: int,
    is_sql: bool,
    is_seg: bool = False,
) -> Fragment:
    from .ir import K_AGGREGATE, task_pinned

    n = ln[id(term)]
    if id(term) in blocked:
        raise _Refuse("terminal is served by the local result cache")
    # a lowered segment's own row-local chain applies to ONE side (the
    # probe side for joins, the only side for aggregates) AFTER that
    # side's upstream steps
    seg_steps: List[Tuple] = []
    seg_side = 0
    # terminal shape → (terminal tuple, shuffle keys, side input tasks)
    if is_sql:
        terminal, keys, positions = _sql_terminal(term)
        side_tasks = [term.inputs[p] for p in positions]
    elif is_seg:
        spec = tuple(n.info["terminal"])
        seg_steps = list(n.info.get("steps", []))
        if spec[0] == "join":
            how_raw = spec[1]
            if how_raw.lower().replace("_", "") == "cross" or not spec[2]:
                raise _Refuse("cross/non-equi joins are not bucket-local")
            if len(term.inputs) != 2:
                raise _Refuse("segment join without two inputs")
            keys = list(spec[2])
            terminal = ("join", how_raw, keys)
            seg_side = int(spec[3])
            side_tasks = list(term.inputs)
        else:  # keyed aggregate segment
            keys = list(term.partition_spec.partition_by)
            terminal = ("aggregate", keys, list(spec[1]))
            if len(term.inputs) != 1:
                raise _Refuse("segment aggregate without a single input")
            side_tasks = [term.inputs[0]]
    elif n.kind == K_AGGREGATE:
        keys = list(n.info["keys"])
        terminal = ("aggregate", keys, list(n.info["columns"]))
        if len(term.inputs) != 1:
            raise _Refuse("aggregate with multiple inputs")
        side_tasks = [term.inputs[0]]
    else:  # join
        how_raw = term.params.get_or_throw("how", str)
        if n.info["how"] == "cross":
            raise _Refuse("cross joins are not bucket-local")
        if len(term.inputs) != 2:
            raise _Refuse(
                f"{len(term.inputs)}-way join chains stay local "
                "(only binary joins distribute)"
            )
        keys = list(n.info["on"])  # may be empty: inferred from probe below
        terminal = ("join", how_raw, keys)
        side_tasks = list(term.inputs)
    # side chains
    sides: List[Dict[str, Any]] = []
    covered: Set[int] = {id(term)}
    for name, st in zip(("left", "right"), side_tasks):
        paths, steps, side_cov = _side_chain(st, ln, cons, blocked, used)
        if side_cov & covered:
            raise _Refuse("sides share an input chain (self-join) — stays local")
        covered |= side_cov
        sides.append({"name": name, "paths": paths, "steps": steps})
    if seg_steps:
        sides[seg_side]["steps"] = list(sides[seg_side]["steps"]) + seg_steps
    for s in sides:
        s["token"] = _steps_token(s["steps"])
    # tail extension: row-local steps and at most one keyed aggregate
    # whose keys cover the shuffle keys (bucket-local ⇒ exact). A pinned
    # node may end the tail (it materializes as the fragment result);
    # interiors must stay unpinned and single-consumer.
    tail_ops: List[Tuple] = []
    pending: List[Tuple] = []
    seen_tail_agg = False

    def _extend(result: FugueTask) -> FugueTask:
        nonlocal seen_tail_agg
        while True:
            if task_pinned(result) or cons.get(id(result), 0) != 1:
                return result
            nxt = _single_consumer(result, ln)
            if nxt is None or id(nxt) in blocked or id(nxt) in used:
                return result
            m = ln[id(nxt)]
            st = _steps_of(m)
            if st is not None:
                pending.extend(st)
            elif (
                m.kind == K_AGGREGATE
                and m.info.get("keys")
                and not seen_tail_agg
                and set(m.info["keys"]) >= set(keys or [])
                and len(nxt.inputs) == 1
            ):
                if pending:
                    tail_ops.append(("steps", list(pending)))
                    pending.clear()
                tail_ops.append(
                    ("aggregate", list(m.info["keys"]), list(m.info["columns"]))
                )
                seen_tail_agg = True
            else:
                return result
            covered.add(id(nxt))
            result = nxt

    result = _extend(term)
    if pending:
        tail_ops.append(("steps", list(pending)))
    # probe: run the whole fragment over ≤16 head rows per side with the
    # SAME bodies the workers execute — any failure is a plan-time
    # refusal, never a distributed POISON surprise; also infers empty
    # join keys and proves the keys co-bucketable
    keys, buckets = _probe_fragment(sides, terminal, tail_ops, keys, buckets)
    return Fragment(
        label=label,
        result_task=result,
        covered_ids=covered,
        sides=sides,
        keys=keys,
        buckets=buckets,
        terminal=terminal,
        tail_ops=tail_ops,
        reduce_token=_terminal_token(terminal, tail_ops),
    )


def _single_consumer(t: FugueTask, ln: Dict[int, Any]) -> Optional[FugueTask]:
    for node in ln.values():
        task = node.task
        if task is not None and any(d is t for d in task.inputs):
            return task
    return None


def _probe_fragment(
    sides: List[Dict[str, Any]],
    terminal: Tuple,
    tail_ops: List[Tuple],
    keys: List[str],
    buckets: int,
) -> Tuple[List[str], int]:
    from ..dist.worker import read_source_paths
    from ..shuffle.partitioner import canonical_key_kinds

    import pyarrow as pa

    mapped: List[pd.DataFrame] = []
    for s in sides:
        try:
            pdf = read_source_paths(s["paths"][:1]).head(16)
            mapped.append(_map_body(pdf, steps=s["steps"]))
        except Exception as e:
            raise _Refuse(f"map[{s['name']}] probe failed: {e}")
    if terminal[0] == "join" and not keys:
        left_cols = list(mapped[0].columns)
        right_cols = set(mapped[1].columns)
        keys = [c for c in left_cols if c in right_cols]
        if not keys:
            raise _Refuse("join has no common columns to infer keys from")
        terminal_keys = terminal[2]
        terminal_keys.extend(keys)
    for s, pdf in zip(sides, mapped):
        missing = [k for k in keys if k not in pdf.columns]
        if missing:
            raise _Refuse(
                f"shuffle keys {missing} missing from map[{s['name']}] output"
            )
    schemas = [
        pa.Table.from_pandas(p.head(0), preserve_index=False).schema
        for p in mapped
    ]
    fields = [
        {nm: sc.field(nm) for nm in sc.names} for sc in schemas
    ]
    if canonical_key_kinds(fields[0], fields[-1], list(keys)) is None:
        raise _Refuse(
            f"shuffle keys {list(keys)} have no canonical hashable dtype "
            "(the exchange cannot co-bucket them)"
        )
    try:
        _reduce_body(*mapped, terminal=terminal, tail_ops=tail_ops)
    except Exception as e:
        raise _Refuse(f"reduce probe failed: {e}")
    return list(keys), buckets


# ---------------------------------------------------------------------------
# execution (called from the workflow context per result task)
# ---------------------------------------------------------------------------


def _supervisor_for(engine: Any, root: str, conf: Any) -> Any:
    """One cached DistSupervisor per engine+board: its DistStats registers
    as ``engine.stats()["dist"]`` once and accumulates across runs (the
    registry reset contract zeroes it like every other source)."""
    from ..dist.supervisor import DistSupervisor

    sup = getattr(engine, "_wf_dist_supervisor", None)
    if sup is None or os.path.abspath(str(sup.board.root)) != os.path.abspath(
        root
    ):
        sup = DistSupervisor(root, engine=engine, conf=dict(conf))
        engine._wf_dist_supervisor = sup
    return sup


def execute_fragment(frag: Fragment, engine: Any, conf: Any) -> pd.DataFrame:
    """Run one fragment through ``DistSupervisor.run_workflow_job``. The
    supervisor's kill-switch serial path never runs here — the planner is
    inert when ``fugue.tpu.dist.enabled=false`` — but stays wired so a
    conf flip between plan and run still degrades safely."""
    from ..constants import (
        FUGUE_TPU_CONF_DIST_BOARD,
        FUGUE_TPU_CONF_DIST_WORKFLOW_TIMEOUT_S,
    )

    root = str(conf.get(FUGUE_TPU_CONF_DIST_BOARD, ""))
    sup = _supervisor_for(engine, root, conf)
    timeout = float(conf.get(FUGUE_TPU_CONF_DIST_WORKFLOW_TIMEOUT_S, 0.0))
    left = frag.sides[0]
    right = frag.sides[1] if len(frag.sides) > 1 else None

    def side_fn(s: Optional[Dict[str, Any]]) -> Any:
        if s is None or not s["steps"]:
            return None
        return functools.partial(_map_body, steps=list(s["steps"]))

    return sup.run_workflow_job(
        list(left["paths"]),
        None if right is None else list(right["paths"]),
        list(frag.keys),
        functools.partial(
            _reduce_body, terminal=frag.terminal, tail_ops=list(frag.tail_ops)
        ),
        map_left=side_fn(left),
        map_right=side_fn(right),
        buckets=frag.buckets,
        tokens={
            "left": left["token"],
            **({"right": right["token"]} if right is not None else {}),
            "reduce": frag.reduce_token,
        },
        timeout=timeout if timeout > 0 else None,
    )


# ---------------------------------------------------------------------------
# explain rendering
# ---------------------------------------------------------------------------


def describe_distribution(tasks: List[FugueTask], conf: Any) -> List[str]:
    """The board plan for ``workflow.explain()``: every fragment with its
    map/reduce recipe, every refusal with its rung. Dry run — no board
    writes, no cache consultation (warm local cuts are shown by the cache
    section above; at run time they additionally block fragments)."""
    from ..constants import FUGUE_TPU_CONF_DIST_BOARD, FUGUE_TPU_CONF_DIST_ENABLED

    board = str(conf.get(FUGUE_TPU_CONF_DIST_BOARD, "") or "")
    if not board:
        return [
            "== distributed workflows: off (set fugue.tpu.dist.board to a "
            "shared dir to enable) =="
        ]
    if not bool(conf.get(FUGUE_TPU_CONF_DIST_ENABLED, True)):
        return [
            "== distributed workflows: disabled "
            "(fugue.tpu.dist.enabled=false) =="
        ]
    try:
        plan = plan_distribution(tasks, conf, cache_plan=None)
    except Exception as e:  # planning must never break explain
        return [f"== distributed workflows: planner error ({e}) =="]
    lines = [
        f"== distributed workflows (board={board}, "
        f"{len(plan.fragments)} fragment(s), {len(plan.refusals)} refused) =="
    ]
    for f in plan.fragments:
        lines.extend("  " + ln for ln in f.describe())
    for label, why in plan.refusals:
        lines.append(f"  not distributed {label}: {why}")
    if not plan.fragments and not plan.refusals:
        lines.append(
            "  no shuffle points (joins / keyed aggregates / bucket-local "
            "SQL) found — everything runs locally"
        )
    return lines
