"""Logical IR over the workflow task DAG, copied from ``fugue_tpu/plan/ir.py``.

The optimizer (``optimizer.py``) never executes anything —
it inspects the ``FugueTask`` graph built by ``FugueWorkflow``, classifies
every task into a small set of logical kinds (HiFrames-style dataframe
plan nodes: create/project/filter/select/join/aggregate/...), and exposes
the two analyses the passes need:

- forward **schema inference**: the output column NAMES of each node,
  where derivable (creates over concrete data, projections, joins, ...);
  ``None`` means unknown;
- backward **column demand**: which input columns each node actually
  reads given what its consumers demand. ``ALL`` (``None``) is the
  conservative top — UDF transformers, distinct, raw SQL and any
  unrecognized extension demand everything (the "can't infer column
  usage" no-op guard).

Nodes are lightweight wrappers (``LNode``); passes mutate the wrapper
graph (rewire inputs, override params, collapse chains) and the emitter
in ``passes.py`` turns the result back into tasks, cloning only what
changed.

A transformer's column usage comes from the UDF analyzer
(``fugue_tpu_torch/analysis``), attached to its node as
``info["analysis"]``: exact read/write sets, the declared output names and
the row-local verdict. Where the analyzer refuses, a transformer demands
every column and its output names are unknown. ``node_delta_row_local``
classifies the nodes the delta cache (``fugue_tpu_torch/cache/delta.py``)
may split at a partition boundary.
"""

from typing import Any, Dict, List, Optional, Set, Tuple

from ..column.expressions import (
    ColumnExpr,
    _FuncExpr,
    _LitColumnExpr,
    _NamedColumnExpr,
    _WindowExpr,
)
from ..column.sql import SelectColumns
from ..schema import Schema
from ..workflow._tasks import CreateTask, FugueTask, OutputTask

# the conservative top of the column-demand lattice: "all columns"
ALL = None

# logical node kinds
K_CREATE = "create"  # CreateData over concrete data
K_LOAD = "load"  # Load from storage
K_CREATE_OPAQUE = "create?"  # any other creator
K_PROJECT = "project"  # SelectColumns (name list)
K_DROP = "drop"
K_RENAME = "rename"
K_FILTER = "filter"
K_SELECT = "select"  # column-IR select
K_ASSIGN = "assign"
K_AGGREGATE = "aggregate"
K_DISTINCT = "distinct"
K_DROPNA = "dropna"
K_FILLNA = "fillna"
K_SAMPLE = "sample"
K_TAKE = "take"
K_JOIN = "join"
K_SETOP = "setop"
K_TRANSFORM = "transform"  # UDF transformer: column usage from the analyzer, else unknown
K_OUTPUT = "output"  # sink
K_OPAQUE = "opaque"  # anything else: zip, SQL, save_and_use, ...
K_FUSED = "fused"  # synthesized by the fusion pass
K_SEGMENT = "segment"  # synthesized by the segment-lowering pass


# kinds whose row-local semantics allow fusion into one per-chunk step
FUSABLE_KINDS = {K_PROJECT, K_DROP, K_RENAME, K_FILTER, K_SELECT, K_ASSIGN}

# kinds a device-resident segment may terminate in (lowering.py): the verb
# that consumes the fused row-local chain inside ONE compiled program
SEGMENT_TERMINAL_KINDS = {K_AGGREGATE, K_TAKE, K_DISTINCT, K_JOIN}

# kinds whose output rows each depend on exactly ONE input row — the
# precondition for partition-level delta recompute (cache/delta.py):
# f(old ++ new) == f(old) ++ f(new). dropna/fillna are row-local but not
# fusable (they have no per-chunk step form); distinct/take/sample are NOT
# (row identity / position spans partitions).
DELTA_ROW_LOCAL_KINDS = FUSABLE_KINDS | {K_DROPNA, K_FILLNA, K_FUSED}


def node_delta_row_local(n: "LNode") -> bool:
    """Whether this node provably computes each output row from one input
    row (delta recompute may split its input at any partition boundary).
    Mirrors the fusion pass's K_SELECT guard: an aggregating / distinct /
    HAVING select reads the whole frame. A UDF transformer qualifies when
    the static analyzer (``fugue_tpu_torch/analysis``) proves it
    row-local, pure and deterministic — every analysis failure is False."""
    if n.kind == K_TRANSFORM:
        if n.task is None:
            return False
        a = n.info.get("analysis")
        if a is not None:
            return bool(a.row_local and a.deterministic)
        from ..analysis import transform_row_local

        return transform_row_local(n.task)
    if n.kind not in DELTA_ROW_LOCAL_KINDS:
        return False
    if n.kind == K_SELECT:
        sc = n.info["columns"]
        if sc.has_agg or sc.is_distinct or n.info.get("having") is not None:
            return False
    return True


class LNode:
    """One logical node. ``task`` is the originating FugueTask (None for
    synthesized nodes); ``info`` holds the parsed params the passes read;
    overrides make the emitter clone instead of reuse."""

    __slots__ = (
        "task",
        "kind",
        "info",
        "inputs",
        "pinned",
        "param_override",
        "extension_override",
        "steps",
        "terminal",
        "tail_origin",
        "result_of",
        "annotations",
    )

    def __init__(self, task: Optional[FugueTask], kind: str, info: Optional[dict] = None):
        self.task = task
        self.kind = kind
        self.info = info or {}
        self.inputs: List["LNode"] = []
        self.pinned = False if task is None else task_pinned(task)
        self.param_override: Optional[dict] = None
        self.extension_override: Any = None
        self.steps: Optional[List[Tuple]] = None  # K_FUSED / K_SEGMENT
        self.terminal: Optional[Tuple] = None  # K_SEGMENT only
        self.tail_origin: Optional[FugueTask] = None  # K_FUSED / K_SEGMENT
        # the ORIGINAL tasks whose result this node's output is provably
        # identical to. Rewrites that reposition a node (filter pushdown)
        # or collapse a chain (fusion) transfer this set to the node that
        # now computes that value; a node left representing nothing means
        # the original task's intermediate result is no longer computed
        # anywhere (get_result raises a descriptive error for it).
        self.result_of: List[FugueTask] = [] if task is None else [task]
        self.annotations: List[str] = []

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"LNode({self.kind})"


def task_pinned(task: FugueTask) -> bool:
    """Whether the task's result is externally observable beyond the DAG
    edges: checkpoints (storage identity is uuid-keyed), yields and
    broadcasts. Pinned nodes demand all their columns and are never
    removed or rewritten."""
    return (
        not task.checkpoint.is_null
        or task.yield_dataframe_handler is not None
        or task.broadcast_flag
    )


def expr_columns(
    expr: ColumnExpr, ignore_count_star: bool = False
) -> Optional[Set[str]]:
    """Column names referenced by an expression tree; ``ALL`` (None) when
    a wildcard or an unrecognized node makes the set unknowable.
    ``ignore_count_star`` treats ``COUNT(*)``/``COUNT(lit)`` as reading no
    columns (it only needs row existence)."""
    out: Set[str] = set()

    def walk(e: ColumnExpr) -> bool:
        if isinstance(e, _NamedColumnExpr):
            if e.wildcard:
                return False
            out.add(e.name)
            return True
        if isinstance(e, _LitColumnExpr):
            return True
        if isinstance(e, _WindowExpr):
            out.update(e.partition_by)
            for ob in e.order_by:
                try:
                    out.add(ob[0])
                except Exception:
                    return False
            return all(walk(a) for a in e.args)
        if (
            ignore_count_star
            and isinstance(e, _FuncExpr)
            and e.is_agg
            and e.func.upper() == "COUNT"
            and len(e.args) == 1
            and (
                isinstance(e.args[0], _LitColumnExpr)
                or (
                    isinstance(e.args[0], _NamedColumnExpr)
                    and e.args[0].wildcard
                )
            )
        ):
            return True
        return all(walk(c) for c in e.children)

    return out if walk(expr) else ALL


def _exprs_columns(
    exprs: List[ColumnExpr], ignore_count_star: bool = False
) -> Optional[Set[str]]:
    out: Set[str] = set()
    for e in exprs:
        cols = expr_columns(e, ignore_count_star=ignore_count_star)
        if cols is ALL:
            return ALL
        out.update(cols)
    return out


def _union(a: Optional[Set[str]], b: Optional[Set[str]]) -> Optional[Set[str]]:
    if a is ALL or b is ALL:
        return ALL
    return a | b


# ---------------------------------------------------------------------------
# task -> LNode classification
# ---------------------------------------------------------------------------


def classify(task: FugueTask) -> LNode:
    from ..extensions._builtins import creators as bc
    from ..extensions._builtins import processors as bp

    ext = task.extension
    if isinstance(task, OutputTask):
        return LNode(task, K_OUTPUT)
    # synthesized optimizer tasks (a post-optimization list classified
    # again): recover their logical kind from the carried params
    from .fused import FusedVerbs
    from .lowering import LoweredSegment

    if isinstance(ext, FusedVerbs):
        return LNode(
            task, K_FUSED, {"steps": list(task.params.get("steps", []))}
        )
    if isinstance(ext, LoweredSegment):
        return LNode(
            task,
            K_SEGMENT,
            {
                "steps": list(task.params.get("steps", [])),
                "terminal": tuple(task.params.get_or_throw("terminal", object)),
            },
        )
    if isinstance(task, CreateTask):
        if isinstance(ext, bc.CreateData):
            data = task.params.get_or_none("data", object)
            info: Dict[str, Any] = {"data": data}
            schema_str = task.params.get_or_none("schema", object)
            if schema_str is not None:
                info["schema"] = schema_str
            info["is_stream"] = _is_stream_data(data)
            return LNode(task, K_CREATE, info)
        if isinstance(ext, bc.Load):
            return LNode(
                task,
                K_LOAD,
                {
                    "columns": task.params.get_or_none("columns", object),
                    "path": task.params.get_or_none("path", object),
                    "fmt": task.params.get("fmt", ""),
                },
            )
        return LNode(task, K_CREATE_OPAQUE)
    if isinstance(ext, bp.SelectColumns):
        cols = task.params.get("columns", [])
        if all(isinstance(c, str) for c in cols):
            return LNode(task, K_PROJECT, {"columns": list(cols)})
        return LNode(task, K_OPAQUE)
    if isinstance(ext, bp.DropColumns):
        return LNode(
            task,
            K_DROP,
            {
                "columns": list(task.params.get("columns", [])),
                "if_exists": task.params.get("if_exists", False),
            },
        )
    if isinstance(ext, bp.Rename):
        return LNode(task, K_RENAME, {"columns": dict(task.params.get("columns", {}))})
    if isinstance(ext, bp.Filter):
        return LNode(
            task, K_FILTER, {"condition": task.params.get_or_throw("condition", object)}
        )
    if isinstance(ext, bp.Select):
        return LNode(
            task,
            K_SELECT,
            {
                "columns": task.params.get_or_throw("columns", SelectColumns),
                "where": task.params.get_or_none("where", object),
                "having": task.params.get_or_none("having", object),
            },
        )
    if isinstance(ext, bp.Assign):
        return LNode(task, K_ASSIGN, {"columns": list(task.params.get("columns", []))})
    if isinstance(ext, bp.Aggregate):
        return LNode(
            task,
            K_AGGREGATE,
            {
                "columns": list(task.params.get("columns", [])),
                "keys": list(task.partition_spec.partition_by),
            },
        )
    if isinstance(ext, bp.Distinct):
        return LNode(task, K_DISTINCT)
    if isinstance(ext, bp.Dropna):
        return LNode(task, K_DROPNA, {"subset": task.params.get_or_none("subset", list)})
    if isinstance(ext, bp.Fillna):
        value = task.params.get_or_none("value", object)
        return LNode(
            task,
            K_FILLNA,
            {
                "subset": task.params.get_or_none("subset", list),
                "value_keys": list(value.keys()) if isinstance(value, dict) else [],
            },
        )
    if isinstance(ext, bp.Sample):
        return LNode(task, K_SAMPLE)
    if isinstance(ext, bp.Take):
        presort = task.params.get("presort", "") or ""
        presort_cols = [
            p.strip().split(" ")[0] for p in presort.split(",") if p.strip() != ""
        ]
        return LNode(
            task,
            K_TAKE,
            {
                "presort_cols": presort_cols,
                "keys": list(task.partition_spec.partition_by),
            },
        )
    if isinstance(ext, bp.RunJoin):
        return LNode(
            task,
            K_JOIN,
            {
                "how": task.params.get_or_throw("how", str).lower().replace("_", ""),
                "on": list(task.params.get("on", [])),
            },
        )
    if isinstance(ext, bp.RunSetOperation):
        return LNode(
            task,
            K_SETOP,
            {
                "how": task.params.get_or_throw("how", str),
                "distinct": task.params.get("distinct", True),
            },
        )
    if isinstance(ext, bp.RunTransformer):
        return LNode(task, K_TRANSFORM)
    return LNode(task, K_OPAQUE)


def _is_stream_data(data: Any) -> bool:
    from ..dataframe import DataFrame

    return isinstance(data, DataFrame) and data.is_local and not data.is_bounded


def build_graph(tasks: List[FugueTask]) -> List[LNode]:
    """Classify every task and wire LNode inputs (tasks appear in
    construction = topological order)."""
    by_id: Dict[int, LNode] = {}
    nodes: List[LNode] = []
    for t in tasks:
        n = classify(t)
        n.inputs = [by_id[id(d)] for d in t.inputs if id(d) in by_id]
        # a task referencing an input OUTSIDE the given list would break
        # rewiring invariants — treat the whole node as opaque+pinned
        if len(n.inputs) != len(t.inputs):
            n.kind = K_OPAQUE
            n.pinned = True
        by_id[id(t)] = n
        nodes.append(n)
    return nodes


def consumers_map(nodes: List[LNode]) -> Dict[int, List[LNode]]:
    out: Dict[int, List[LNode]] = {id(n): [] for n in nodes}
    for n in nodes:
        for i in n.inputs:
            out[id(i)].append(n)
    return out


# ---------------------------------------------------------------------------
# forward schema (column names) inference
# ---------------------------------------------------------------------------


def infer_schemas(nodes: List[LNode]) -> Dict[int, Optional[List[str]]]:
    """Output column names per node, None = unknown. Purely static — no
    data access beyond reading column names off concrete create inputs."""
    schemas: Dict[int, Optional[List[str]]] = {}
    for n in nodes:
        schemas[id(n)] = _node_schema(n, [schemas[id(i)] for i in n.inputs])
    return schemas


def _node_schema(
    n: LNode, in_schemas: List[Optional[List[str]]]
) -> Optional[List[str]]:
    first = in_schemas[0] if len(in_schemas) > 0 else None
    if n.kind == K_CREATE:
        schema_str = n.info.get("schema")
        if schema_str is not None:
            try:
                return list(Schema(schema_str).names)
            except Exception:
                return None
        return _data_columns(n.info.get("data"))
    if n.kind == K_LOAD:
        cols = n.info.get("columns")
        if isinstance(cols, list) and all(isinstance(c, str) for c in cols):
            return list(cols)
        if isinstance(cols, str):
            try:
                return list(Schema(cols).names)
            except Exception:
                return None
        # no explicit columns: sniff the file metadata (memoized — the
        # pushdown loop re-runs inference many times)
        if "sniffed_schema" not in n.info:
            n.info["sniffed_schema"] = sniff_load_columns(
                n.info.get("path"), n.info.get("fmt") or ""
            )
        return n.info["sniffed_schema"]
    if n.kind == K_PROJECT:
        return list(n.info["columns"])
    if n.kind == K_DROP:
        if first is None:
            return None
        dropped = set(n.info["columns"])
        return [c for c in first if c not in dropped]
    if n.kind == K_RENAME:
        if first is None:
            return None
        m = n.info["columns"]
        return [m.get(c, c) for c in first]
    if n.kind in (K_FILTER, K_SAMPLE, K_TAKE, K_DISTINCT, K_DROPNA, K_FILLNA):
        return first
    if n.kind == K_ASSIGN:
        if first is None:
            return None
        new = [c.output_name for c in n.info["columns"]]
        return list(first) + [c for c in new if c not in first]
    if n.kind == K_SELECT:
        sc: SelectColumns = n.info["columns"]
        out: List[str] = []
        for c in sc.all_cols:
            if isinstance(c, _NamedColumnExpr) and c.wildcard:
                if first is None:
                    return None
                out.extend([x for x in first if x not in out])
            else:
                name = c.output_name
                if name == "":
                    return None
                out.append(name)
        return out
    if n.kind == K_AGGREGATE:
        out = list(n.info["keys"])
        for c in n.info["columns"]:
            name = c.infer_alias().output_name
            if name == "":
                return None
            out.append(name)
        return out
    if n.kind == K_JOIN:
        if len(in_schemas) != 2 or any(s is None for s in in_schemas):
            return None
        s1, s2 = in_schemas
        how = n.info["how"]
        if how in ("semi", "leftsemi", "anti", "leftanti"):
            return list(s1)
        return list(s1) + [c for c in s2 if c not in s1]
    if n.kind == K_SETOP:
        return first
    if n.kind == K_TRANSFORM:
        # the analyzer knows the declared output schema of analyzed
        # plain-function UDFs
        a = n.info.get("analysis")
        if a is not None and a.schema_ok:
            declared = [x for x, _ in a.declared]
            if not a.star:
                return declared
            if first is not None:
                return list(first) + [c for c in declared if c not in first]
        return None
    if n.kind in (K_FUSED, K_SEGMENT):
        return None  # no pass runs after fusion/lowering
    return None  # opaque / output


def sniff_load_columns(path: Any, fmt: str) -> Optional[List[str]]:
    """Column names of a Load source, read from file METADATA only (no
    row data is decoded). Restricted to plain parquet files: directory
    datasets go through the sidecar/hive-restore path whose column order
    and types change once an explicit column list is passed, and globs
    may span files with differing schemas — both refuse with None."""
    import os

    if not isinstance(path, str):
        return None
    try:
        from .._utils.io import FileParser

        parser = FileParser(path, fmt or None)
        if (
            parser.file_format != "parquet"
            or parser.has_glob
            or os.path.isdir(path)
        ):
            return None
        import pyarrow.parquet as pq

        return list(pq.read_schema(path).names)
    except Exception:
        return None


def estimate_load_bytes(path: Any, dropped: List[str]) -> int:
    """Compressed bytes the pruned load will no longer read, from parquet
    column-chunk metadata (0 when unknown)."""
    try:
        import pyarrow.parquet as pq

        meta = pq.ParquetFile(path).metadata
        total = 0
        wanted = set(dropped)
        for rg in range(meta.num_row_groups):
            g = meta.row_group(rg)
            for ci in range(g.num_columns):
                c = g.column(ci)
                if c.path_in_schema.split(".")[0] in wanted:
                    total += int(c.total_compressed_size)
        return total
    except Exception:
        return 0


def _data_columns(data: Any) -> Optional[List[str]]:
    import pandas as pd
    import pyarrow as pa

    from ..dataframe import DataFrame

    if isinstance(data, DataFrame):
        try:
            return list(data.schema.names)
        except Exception:
            return None
    if isinstance(data, pd.DataFrame):
        return [str(c) for c in data.columns]
    if isinstance(data, pa.Table):
        return list(data.column_names)
    return None


# ---------------------------------------------------------------------------
# backward column demand
# ---------------------------------------------------------------------------


def input_requirements(
    n: LNode,
    required_out: Optional[Set[str]],
    in_schemas: List[Optional[List[str]]],
) -> List[Optional[Set[str]]]:
    """For each input of ``n``: the set of its columns ``n`` reads, given
    that consumers read ``required_out`` of ``n``'s output. ``ALL`` is the
    conservative answer everywhere something is not statically known."""
    d = required_out
    if n.kind in (K_CREATE, K_LOAD, K_CREATE_OPAQUE):
        return []
    if n.kind == K_PROJECT:
        return [set(n.info["columns"])]
    if n.kind == K_DROP:
        # the drop still validates/removes its columns, so they must exist
        return [_union(d, set(n.info["columns"]))]
    if n.kind == K_RENAME:
        if d is ALL:
            return [ALL]
        inv = {v: k for k, v in n.info["columns"].items()}
        return [{inv.get(c, c) for c in d}]
    if n.kind == K_FILTER:
        return [_union(d, expr_columns(n.info["condition"]))]
    if n.kind == K_SELECT:
        exprs = list(n.info["columns"].all_cols)
        if n.info.get("where") is not None:
            exprs.append(n.info["where"])
        if n.info.get("having") is not None:
            exprs.append(n.info["having"])
        return [_exprs_columns(exprs, ignore_count_star=True)]
    if n.kind == K_ASSIGN:
        new_names = {c.output_name for c in n.info["columns"]}
        refs = _exprs_columns(n.info["columns"])
        if d is ALL or refs is ALL:
            return [ALL]
        return [(d - new_names) | refs]
    if n.kind == K_AGGREGATE:
        refs = _exprs_columns(n.info["columns"], ignore_count_star=True)
        return [_union(set(n.info["keys"]), refs)]
    if n.kind == K_DISTINCT:
        return [ALL]  # row identity is ALL columns
    if n.kind == K_DROPNA:
        subset = n.info.get("subset")
        if subset:
            return [_union(d, set(subset))]
        return [ALL]  # the null predicate reads every column
    if n.kind == K_FILLNA:
        extra = set(n.info.get("subset") or []) | set(n.info.get("value_keys") or [])
        return [_union(d, extra)]
    if n.kind == K_SAMPLE:
        return [d]
    if n.kind == K_TAKE:
        return [_union(d, set(n.info["presort_cols"]) | set(n.info["keys"]))]
    if n.kind == K_JOIN and len(n.inputs) == 2:
        s1, s2 = in_schemas
        how = n.info["how"]
        on = n.info["on"]
        if not on:
            if s1 is None or s2 is None:
                return [ALL, ALL]
            on = [c for c in s1 if c in s2]
        keys = set(on)
        if how in ("semi", "leftsemi", "anti", "leftanti"):
            return [_union(d, keys), set(keys)]
        if d is ALL:
            return [ALL, ALL]
        left = _union(keys, set(d) & set(s1)) if s1 is not None else ALL
        right = _union(keys, set(d) & set(s2)) if s2 is not None else ALL
        return [left, right]
    if n.kind == K_SETOP:
        if n.info["distinct"]:
            return [ALL for _ in n.inputs]
        return [d for _ in n.inputs]
    if n.kind in (K_FUSED, K_SEGMENT):
        return [ALL for _ in n.inputs]
    if n.kind == K_TRANSFORM and len(n.inputs) == 1:
        # exact column facts from the static analyzer: the UDF reads R,
        # writes W, and its declared schema decides what passes through —
        # so pruning commutes through analyzed UDF transformers
        a = n.info.get("analysis")
        if a is not None and a.facts_ok and a.schema_ok and a.pure:
            req = set(a.reads) | set(a.required_extra)
            if a.star:
                if d is ALL:
                    return [ALL]
                # demanded passthrough outputs must exist on the input
                # (declared new names are produced by the UDF itself)
                return [req | (set(d) - a.new_names)]
            # explicit schema: enforcement selects every declared column
            # from the returned frame; unwritten ones come from the input
            return [req | ({x for x, _ in a.declared} - set(a.writes))]
        return [ALL]
    # transform the analyzer refused (column usage unknown), output sinks,
    # opaque
    return [ALL for _ in n.inputs]


def compute_demand(
    nodes: List[LNode], schemas: Dict[int, Optional[List[str]]]
) -> Dict[int, Optional[Set[str]]]:
    """Backward walk: what each node's OUTPUT must contain. Pinned nodes
    and dangling results (no consumer) demand everything."""
    cons = consumers_map(nodes)
    demand: Dict[int, Optional[Set[str]]] = {}
    for n in reversed(nodes):
        if n.pinned or len(cons[id(n)]) == 0:
            demand[id(n)] = ALL
        elif id(n) not in demand:
            demand[id(n)] = set()
    for n in reversed(nodes):
        d = demand.get(id(n), ALL)
        reqs = input_requirements(n, d, [schemas[id(i)] for i in n.inputs])
        for i, r in zip(n.inputs, reqs):
            if demand.get(id(i), set()) is not ALL:
                demand[id(i)] = _union(demand.get(id(i), set()), r)
    return demand
