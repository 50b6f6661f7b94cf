"""The three plan rewrites: column pruning, filter pushdown, verb fusion,
copied from ``fugue_tpu/plan/passes.py``.

Each pass mutates the LNode graph (``ir.py``) and records
what it did on a :class:`PlanReport` (``optimizer.py``). The emitter at
the bottom turns the rewritten graph back into ``FugueTask`` objects,
REUSING every untouched original task (an unoptimizable DAG round-trips
to the identical task list) and cloning only what changed. Original
tasks never mutate — their uuids, checkpoints and yield handlers are
undisturbed, and a result-alias map keeps
``WorkflowDataFrame.result`` working for every task that still executes.
"""

from typing import Any, Dict, List, Optional, Set, Tuple

from .._utils.params import ParamDict
from ..column.expressions import ColumnExpr, _NamedColumnExpr, col as _col
from ..workflow._tasks import FugueTask, ProcessTask
from .fused import FusedVerbs, _inline, describe_step
from .ir import (
    ALL,
    FUSABLE_KINDS,
    K_ASSIGN,
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
    K_SELECT,
    K_FUSED,
    K_SEGMENT,
    K_TRANSFORM,
    LNode,
    compute_demand,
    consumers_map,
    estimate_load_bytes,
    expr_columns,
    infer_schemas,
)

def _rename_refs(e: ColumnExpr, mapping: Dict[str, str]) -> Optional[ColumnExpr]:
    """Rewrite named references through ``mapping`` (identity default)."""
    state = {n: _col(mapping.get(n, n)) for n in (expr_columns(e) or set())}
    refs = expr_columns(e)
    if refs is ALL:
        return None
    return _inline(e, state)


# ---------------------------------------------------------------------------
# pass 1: filter pushdown
# ---------------------------------------------------------------------------


def pushdown_filters(nodes: List[LNode], report: Any) -> None:
    """Hoist each Filter toward its producer through row-local verbs and
    one side of inner/cross/semi/anti joins. Every hop is a provably
    result-identical commute; anything else refuses loudly into the
    report. Single-consumer edges only (otherwise the un-filtered branch
    would have to recompute)."""
    for _ in range(len(nodes) * len(nodes) + 1):
        cons = consumers_map(nodes)
        schemas = infer_schemas(nodes)
        moved = False
        for f in list(nodes):
            if f.kind != K_FILTER or f.pinned or len(f.inputs) != 1:
                continue
            p = f.inputs[0]
            if p.pinned or cons[id(p)] != [f]:
                continue
            if _push_once(f, p, nodes, cons, schemas, report):
                moved = True
                break
        if not moved:
            return


def _push_once(
    f: LNode,
    p: LNode,
    nodes: List[LNode],
    cons: Dict[int, List[LNode]],
    schemas: Dict[int, Optional[List[str]]],
    report: Any,
) -> bool:
    cond = f.info["condition"]
    refs = expr_columns(cond)
    if refs is ALL:
        return False

    def swap(new_cond: Optional[ColumnExpr] = None) -> None:
        # X -> P -> F -> C   becomes   X -> F -> P -> C
        if new_cond is not None:
            f.info["condition"] = new_cond
            f.param_override = {"condition": new_cond}
        f.inputs = list(p.inputs)
        p.inputs = [f]
        for c in cons[id(f)]:
            c.inputs = [p if i is f else i for i in c.inputs]
        # the pair's output now materializes at P (the new tail) and is
        # identical to what F produced before the commute; P's own
        # intermediate (and F's new, earlier one) are no longer computed
        p.result_of = f.result_of
        f.result_of = []
        # emission order follows dependencies, but keep the list sane
        fi, pi = nodes.index(f), nodes.index(p)
        if fi > pi:
            nodes[fi], nodes[pi] = nodes[pi], nodes[fi]
        f.annotations.append("pushed")
        report.filters_pushed += 1

    if p.kind in (K_PROJECT, K_DROP, K_DISTINCT, K_DROPNA, K_FILTER):
        swap()
        return True
    if p.kind == K_RENAME:
        inv = {v: k for k, v in p.info["columns"].items()}
        new_cond = _rename_refs(cond, inv)
        if new_cond is None:
            report.note(f"pushdown refused: condition not rewritable through rename")
            return False
        swap(new_cond)
        return True
    if p.kind == K_FILLNA:
        filled = set(p.info.get("subset") or []) | set(p.info.get("value_keys") or [])
        if filled and not (refs & filled):
            swap()
            return True
        report.note("pushdown refused: filter reads fillna-modified columns")
        return False
    if p.kind == K_ASSIGN:
        assigned = {c.output_name for c in p.info["columns"]}
        if not (refs & assigned):
            swap()
            return True
        report.note("pushdown refused: filter reads assigned columns (fusion handles)")
        return False
    if p.kind == K_SELECT:
        sc = p.info["columns"]
        if sc.has_agg or sc.is_distinct or p.info.get("having") is not None:
            report.note("pushdown refused: select aggregates/distincts")
            return False
        # only through pass-through named outputs (computed outputs are
        # the fusion pass's job); wildcard-carried names map to themselves
        mapping: Dict[str, str] = {}
        computed: Set[str] = set()
        has_wildcard = False
        for c in sc.all_cols:
            if isinstance(c, _NamedColumnExpr) and c.wildcard:
                has_wildcard = True
            elif isinstance(c, _NamedColumnExpr) and c.as_type is None:
                mapping[c.output_name] = c.name
            else:
                computed.add(c.output_name)
        if any(
            r in computed or (r not in mapping and not has_wildcard) for r in refs
        ):
            report.note("pushdown refused: filter reads computed select columns")
            return False
        new_cond = _rename_refs(cond, mapping)
        if new_cond is None:
            return False
        swap(new_cond)
        return True
    if p.kind == K_JOIN and len(p.inputs) == 2:
        how = p.info["how"]
        s1, s2 = (schemas[id(i)] for i in p.inputs)
        side = None
        if how in ("semi", "leftsemi", "anti", "leftanti"):
            side = 0  # output schema IS the left side
        elif how in ("inner", "cross"):
            if s1 is not None and refs <= set(s1):
                side = 0
            elif s2 is not None and refs <= set(s2):
                side = 1
        else:
            report.note(f"pushdown refused: {how} join null-extends rows")
            return False
        if side is None:
            report.note("pushdown refused: join side schemas unknown or mixed refs")
            return False
        x = p.inputs[side]
        f.inputs = [x]
        new_inputs = list(p.inputs)
        new_inputs[side] = f
        p.inputs = new_inputs
        for c in cons[id(f)]:
            c.inputs = [p if i is f else i for i in c.inputs]
        # same transfer as swap(): the join output now equals the original
        # post-join filter result; the unfiltered join is gone
        p.result_of = f.result_of
        f.result_of = []
        fi, pi = nodes.index(f), nodes.index(p)
        if fi > pi:
            nodes[fi], nodes[pi] = nodes[pi], nodes[fi]
        f.annotations.append(f"pushed below {how} join ({'left' if side == 0 else 'right'})")
        report.filters_pushed += 1
        return True
    if p.kind == K_TRANSFORM:
        # a filter commutes below an analyzed UDF transformer when the
        # analyzer (fugue_tpu_torch/analysis) proves the UDF row-local,
        # pure and deterministic (dropping rows first changes nothing
        # row-wise), under a '*' schema (names/dtypes of the filtered
        # columns pass through unchanged), and the filter reads no written
        # column
        a = p.info.get("analysis")
        if (
            a is not None
            and a.row_local
            and a.deterministic
            and a.star
            and a.schema_ok
            and a.writes is not None
            and not (refs & (a.writes | a.new_names))
        ):
            swap()
            return True
        report.note(
            "pushdown refused: UDF transformer not provably row-local/"
            "pure or filter reads UDF-written columns"
        )
        return False
    if p.kind in (K_CREATE, K_LOAD):
        return False  # already at the producer
    report.note(f"pushdown stopped at {p.kind} (no commuting rule)")
    return False


# ---------------------------------------------------------------------------
# pass 2: column pruning
# ---------------------------------------------------------------------------


def prune_columns(nodes: List[LNode], report: Any) -> None:
    """Backward demand analysis, then push a projection into every
    create/load whose consumers read a strict subset of its columns —
    the pruned columns are never decoded or H2D-transferred (lazy-ingest
    frames drop them BEFORE device transfer; streams drop them per
    chunk inside the producer)."""
    schemas = infer_schemas(nodes)
    demand = compute_demand(nodes, schemas)
    for n in nodes:
        if n.kind not in (K_CREATE, K_LOAD) or n.pinned:
            continue
        schema = schemas[id(n)]
        d = demand.get(id(n), ALL)
        if schema is None or d is ALL:
            if n.kind in (K_CREATE, K_LOAD) and d is ALL:
                report.note(
                    f"pruning skipped at {n.kind}: a consumer demands all columns"
                )
            continue
        keep = [c for c in schema if c in d]
        if len(keep) == 0:
            keep = [schema[0]]  # preserve row count
        if len(keep) >= len(schema):
            continue
        dropped = [c for c in schema if c not in keep]
        if n.kind == K_LOAD:
            if n.info.get("columns") is not None:
                continue
            n.param_override = dict(n.task.params)
            n.param_override["columns"] = keep
            report.bytes_skipped += estimate_load_bytes(
                n.info.get("path"), dropped
            )
        else:
            n.extension_override = _PrunedCreator(n.task.extension, keep)
            report.bytes_skipped += _estimate_bytes(n.info.get("data"), dropped)
        n.annotations.append(f"pruned {len(dropped)} cols: {','.join(dropped)}")
        report.cols_pruned += len(dropped)


def _estimate_bytes(data: Any, dropped: List[str]) -> int:
    import pandas as pd
    import pyarrow as pa

    try:
        if isinstance(data, pa.Table):
            return int(sum(data.column(c).nbytes for c in dropped))
        if isinstance(data, pd.DataFrame):
            usage = data.memory_usage(index=False, deep=False)
            return int(sum(int(usage[c]) for c in dropped))
        from ..dataframe import DataFrame

        if isinstance(data, DataFrame) and data.is_bounded:
            # rough: rows x 8 bytes per dropped column
            return int(data.count() * 8 * len(dropped))
    except Exception:
        pass
    return 0


class _PrunedCreator:
    """Wraps a Creator so its result keeps only the demanded columns.

    Bounded frames select their columns; one-pass streams wrap the
    generator and select per chunk inside the producer, so the pruned
    columns of a chunk are never copied to the device."""

    def __init__(self, inner: Any, columns: List[str]):
        self._inner = inner
        self._columns = list(columns)

    @property
    def pruned_columns(self) -> List[str]:
        return self._columns

    def __uuid__(self) -> str:
        from .._utils.hash import to_uuid

        inner_uuid = getattr(
            self._inner, "__uuid__", lambda: to_uuid(type(self._inner).__name__)
        )()
        return to_uuid("_PrunedCreator", inner_uuid, self._columns)

    def create(self) -> Any:
        for a in ("_params", "_workflow_conf", "_execution_engine", "_partition_spec", "_rpc_server"):
            if hasattr(self, a):
                setattr(self._inner, a, getattr(self, a))
        _prune_create_data(self._inner, self._columns)
        df = self._inner.create()
        return prune_frame(df, self._columns)


def _prune_create_data(creator: Any, columns: List[str]) -> None:
    """A ``CreateData`` over a pandas or arrow table with no schema takes
    only ``columns`` of it, so the others never reach the device (the
    reference's lazy ingest drops them the same way)."""
    import pandas as pd
    import pyarrow as pa

    from ..extensions._builtins.creators import CreateData

    params = getattr(creator, "_params", None)
    if not isinstance(creator, CreateData) or params is None or params.get_or_none("schema", object) is not None:
        return
    data = params.get_or_none("data", object)
    if isinstance(data, pd.DataFrame):
        keep = [c for c in data.columns if c in columns]
        pruned: Any = data[keep]
    elif isinstance(data, pa.Table):
        pruned = data.select([c for c in data.column_names if c in columns])
    else:
        return
    params = ParamDict(params)
    params["data"] = pruned
    creator._params = params


def prune_frame(df: Any, columns: List[str]) -> Any:
    """Project a created frame down to ``columns`` without materializing:
    streams select per chunk; bounded frames use the frame's (lazy where
    available) column selection."""
    keep = [c for c in df.schema.names if c in columns]
    if len(keep) == len(df.schema.names):
        return df
    if df.is_local and not df.is_bounded:
        from ..dataframe import LocalDataFrameIterableDataFrame

        schema = df.schema.extract(keep)
        if isinstance(df, LocalDataFrameIterableDataFrame):
            frames = df.native
        else:
            frames = iter([df])

        return LocalDataFrameIterableDataFrame((f[keep] for f in frames), schema=schema)
    return df[keep]


# ---------------------------------------------------------------------------
# pass 3: verb fusion
# ---------------------------------------------------------------------------


def fuse_verbs(nodes: List[LNode], report: Any) -> None:
    """Collapse maximal single-consumer chains of row-local verbs into
    one FusedVerbs task (length >= 2 anywhere; a single verb directly
    above a one-pass stream create also fuses so the step runs inside
    the chunk producer)."""
    cons = consumers_map(nodes)
    visited: Set[int] = set()
    for start in list(nodes):
        if id(start) in visited or not _fusable(start):
            continue
        # walk down to the head of the chain
        head = start
        while (
            len(head.inputs) == 1
            and _fusable(head.inputs[0])
            and cons[id(head.inputs[0])] == [head]
        ):
            head = head.inputs[0]
        # walk up collecting the chain
        chain = [head]
        while cons[id(chain[-1])] and len(cons[id(chain[-1])]) == 1:
            nxt = cons[id(chain[-1])][0]
            if not _fusable(nxt) or len(nxt.inputs) != 1:
                break
            chain.append(nxt)
        for c in chain:
            visited.add(id(c))
        # interior nodes must be fully unpinned; the tail may carry
        # yield/broadcast (transferred onto the fused task)
        if any(c.pinned for c in chain[:-1]):
            continue
        tail = chain[-1]
        # a synthesized node (e.g. a translated UDF's tail) carries its
        # origin task on tail_origin — same identity rules as a real task
        tail_task = tail.tail_origin if tail.tail_origin is not None else tail.task
        if tail_task is not None and not tail_task.checkpoint.is_null:
            continue
        stream_src = (
            len(head.inputs) == 1
            and head.inputs[0].kind == K_CREATE
            and head.inputs[0].info.get("is_stream", False)
        )
        if len(chain) < 2 and not stream_src:
            continue
        steps: List[Tuple] = []
        for c in chain:
            steps.extend(_node_steps(c))
        fused = LNode(None, K_FUSED)
        fused.steps = steps
        fused.tail_origin = tail_task
        # the fused task's output IS the chain tail's output; interior
        # results are fused away (their handles get a descriptive error)
        fused.result_of = list(tail.result_of)
        fused.inputs = list(head.inputs)
        fused.annotations.append(
            "fused " + " | ".join(describe_step(s) for s in steps)
        )
        for c in cons[id(tail)]:
            c.inputs = [fused if i is tail else i for i in c.inputs]
        pos = nodes.index(tail)
        nodes[pos] = fused
        for c in chain[:-1]:
            nodes.remove(c)
        report.verbs_fused += len(chain)
        cons = consumers_map(nodes)


def _fusable(n: LNode) -> bool:
    if n.kind not in FUSABLE_KINDS or len(n.inputs) != 1:
        return False
    if n.kind == K_SELECT:
        sc = n.info["columns"]
        if sc.has_agg or sc.is_distinct or n.info.get("having") is not None:
            return False
    return True


def _node_steps(n: LNode) -> List[Tuple]:
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
        steps: List[Tuple] = []
        if n.info.get("where") is not None:
            steps.append(("filter", n.info["where"]))
        steps.append(("select", n.info["columns"]))
        return steps
    raise AssertionError(f"not fusable: {n.kind}")  # pragma: no cover


# ---------------------------------------------------------------------------
# emission: LNode graph -> task list (+ result aliases)
# ---------------------------------------------------------------------------


def emit(nodes: List[LNode]) -> Tuple[List[FugueTask], Dict[int, FugueTask]]:
    made: Dict[int, FugueTask] = {}
    aliases: Dict[int, FugueTask] = {}
    tasks: List[FugueTask] = []
    remaining = list(nodes)
    while remaining:
        progressed = False
        for n in list(remaining):
            if any(id(i) not in made for i in n.inputs):
                continue
            in_tasks = [made[id(i)] for i in n.inputs]
            t = _emit_node(n, in_tasks)
            made[id(n)] = t
            tasks.append(t)
            # aliases follow RESULT identity, not node identity: a
            # pushdown-repositioned filter's original handle resolves to
            # the new chain tail (whose output is provably the same
            # frame), never to the interior clone
            for orig in n.result_of:
                aliases[id(orig)] = t
            remaining.remove(n)
            progressed = True
        if not progressed:  # pragma: no cover - graph invariant
            raise AssertionError("optimized plan has a cycle")
    return tasks, aliases


def _emit_node(n: LNode, in_tasks: List[FugueTask]) -> FugueTask:
    if n.kind == K_SEGMENT:
        from .lowering import LoweredSegment, segment_fingerprint

        steps = list(n.steps or [])
        terminal = tuple(n.terminal or ())
        t = ProcessTask(
            LoweredSegment(),
            in_tasks,
            params=dict(
                steps=steps,
                terminal=terminal,
                fingerprint=segment_fingerprint(steps, terminal),
            ),
            partition_spec=(
                None if n.tail_origin is None else n.tail_origin.partition_spec
            ),
        )
        if n.tail_origin is not None:
            t.name = n.tail_origin.name
            t.broadcast_flag = n.tail_origin.broadcast_flag
            if n.tail_origin.yield_dataframe_handler is not None:
                t.set_yield_dataframe_handler(
                    n.tail_origin.yield_dataframe_handler
                )
            t.defined_at = n.tail_origin.defined_at
        return t
    if n.kind == K_FUSED:
        t = ProcessTask(
            FusedVerbs(),
            in_tasks,
            params=dict(steps=list(n.steps or [])),
            partition_spec=(
                None if n.tail_origin is None else n.tail_origin.partition_spec
            ),
        )
        if n.tail_origin is not None:
            t.name = n.tail_origin.name
            t.broadcast_flag = n.tail_origin.broadcast_flag
            if n.tail_origin.yield_dataframe_handler is not None:
                t.set_yield_dataframe_handler(
                    n.tail_origin.yield_dataframe_handler
                )
            t.defined_at = n.tail_origin.defined_at
        return t
    if n.task is None:
        # a synthesized plain verb (translated-UDF expansion,
        # fugue_tpu_torch/analysis/expand.py): emit a real builtin-processor
        # task; the chain tail carries the origin transform's identity
        t = _emit_synth_plain(n, in_tasks)
        if t is not None:
            return t
    assert n.task is not None
    unchanged = (
        n.param_override is None
        and n.extension_override is None
        and len(in_tasks) == len(n.task.inputs)
        and all(a is b for a, b in zip(in_tasks, n.task.inputs))
    )
    if unchanged:
        return n.task
    return n.task.clone_with(
        extension=n.extension_override,
        params=n.param_override,
        input_tasks=in_tasks,
    )


def _emit_synth_plain(n: LNode, in_tasks: List[FugueTask]) -> Optional[FugueTask]:
    """Task for a synthesized plain-verb node (no originating task). The
    same extension/params a workflow-built verb would carry, so the task
    executes and classifies exactly like a hand-written one."""
    from ..extensions._builtins import processors as bp

    if n.kind == K_FILTER:
        ext: Any = bp.Filter()
        params: Dict[str, Any] = {"condition": n.info["condition"]}
    elif n.kind == K_ASSIGN:
        ext = bp.Assign()
        params = {"columns": list(n.info["columns"])}
    elif n.kind == K_SELECT:
        ext = bp.Select()
        params = {"columns": n.info["columns"]}
        if n.info.get("where") is not None:
            params["where"] = n.info["where"]
        if n.info.get("having") is not None:
            params["having"] = n.info["having"]
    elif n.kind == K_PROJECT:
        ext = bp.SelectColumns()
        params = {"columns": list(n.info["columns"])}
    elif n.kind == K_DROP:
        ext = bp.DropColumns()
        params = {"columns": list(n.info["columns"]), "if_exists": bool(n.info.get("if_exists", False))}
    elif n.kind == K_RENAME:
        ext = bp.Rename()
        params = {"columns": dict(n.info["columns"])}
    else:
        return None
    t = ProcessTask(ext, in_tasks, params=params, partition_spec=None)
    if n.tail_origin is not None:
        t.name = n.tail_origin.name
        t.broadcast_flag = n.tail_origin.broadcast_flag
        if n.tail_origin.yield_dataframe_handler is not None:
            t.set_yield_dataframe_handler(n.tail_origin.yield_dataframe_handler)
        t.defined_at = n.tail_origin.defined_at
    return t
