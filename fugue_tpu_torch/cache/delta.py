"""Partition-level incremental recompute, copied from
``fugue_tpu/cache/delta.py``.

The whole-task result cache is all-or-nothing: appending one file to a
loaded directory changes the Load fingerprint and invalidates the whole
downstream subtree, so a 1% delta would pay a 100% recompute. This module
refines the cut to the *delta* frontier:

- every Load-rooted chain of provably row-local verbs (filter / project /
  rename / assign / fused chains / dropna / fillna) — or such a chain
  ending in a sum/count/avg/min/max aggregate (plain or a lowered
  segment) — gets a **delta key**: the chain fingerprint with the Load's
  per-file list replaced by its path (``fingerprint.py``);
- a run that publishes such a task's result also publishes a **partition
  manifest** under the delta key: the source partitions (per-file
  ``(path, size, mtime_ns)``; a content digest and row count for an
  appendable single csv/json file) the artifact covers;
- a warm run whose full fingerprint misses reads the manifest: if the
  cached partitions are an order-preserving prefix of the current source
  (new files sort after the cached ones, or a grown csv/json file whose
  stored digest matches its old prefix), only the new partitions are
  loaded and pushed through the chain:

  * **row-local chains**: ``chain(old ++ new) == chain(old) ++
    chain(new)``, so the fresh rows concatenate after the cached
    artifact(s);
  * **aggregates**: the cached *partial accumulator* (the finished
    per-group table, ``avg`` split into sum and count) merges with the
    fresh partitions' partial as ``torch/streaming.py``'s
    ``_fold_dense_acc`` does (sum and count add, min and max meet, NULL
    is the identity), then ``avg`` is finished as sum/count. The fresh
    partial is the port's ``lowered_segment`` or ``aggregate`` over the
    new rows only: on the card its float32 SUM is the binned-sum kernel.

Whatever this module cannot prove refuses (``_DeltaRefused``) and the task
takes the whole-task path: a delta miss is never a wrong hit.
``workflow.explain()`` renders each refusal.
"""

import glob as _glob
import os
from hashlib import md5
from typing import Any, Dict, List, Optional, Tuple

from .._utils.hash import to_uuid
from ..workflow._tasks import FugueTask

__all__ = [
    "DeltaTemplate",
    "DeltaHit",
    "build_delta_templates",
    "match_manifest",
    "execute_delta",
    "publish_manifest_after",
    "MANIFEST_VERSION",
]

MANIFEST_VERSION = 1

# formats where appending rows appends bytes (the stored-digest grown-file
# path); parquet's footer lives at the end, so a "grown" parquet file is a
# rewrite, never an append
_APPENDABLE_FORMATS = ("csv", "json")


class _DeltaRefused(Exception):
    """This task cannot be delta-served; degrade to whole-task semantics.
    ``had_manifest`` distinguishes a real refusal (a manifest existed but
    could not be applied) from the ordinary first-run state."""

    def __init__(self, reason: str, had_manifest: bool = False):
        super().__init__(reason)
        self.reason = reason
        self.had_manifest = had_manifest


# ---------------------------------------------------------------------------
# source partition discovery
# ---------------------------------------------------------------------------


def _token(path: str) -> Dict[str, Any]:
    st = os.stat(path)
    return {"path": path, "size": int(st.st_size), "mtime_ns": int(st.st_mtime_ns)}


def _digest_prefix(path: str, nbytes: int) -> str:
    h = md5()
    left = int(nbytes)
    with open(path, "rb") as f:
        while left > 0:
            chunk = f.read(min(left, 4 * 1024 * 1024))
            if not chunk:
                break
            h.update(chunk)
            left -= len(chunk)
    return h.hexdigest()


def list_source_partitions(path: Any, fmt: str) -> Tuple[List[Dict[str, Any]], str, bool]:
    """(partition tokens in LOAD order, resolved format, is_single_file).

    The list mirrors what the loader (``_utils/io.py``) will actually
    read, in the order it reads it — refusing every layout where
    per-file loading is not provably equivalent to the whole-source load
    (hive/nested datasets, schema sidecars)."""
    from .._utils.io import FileParser

    if not isinstance(path, str) or path == "":
        raise _DeltaRefused("load path is not a plain string")
    try:
        parser = FileParser(path, fmt or None)
    except Exception as ex:
        raise _DeltaRefused(f"unparseable load path ({type(ex).__name__})")
    file_format = parser.file_format
    if file_format == "avro":
        raise _DeltaRefused("avro sources are not delta-eligible")
    if parser.has_glob:
        files = sorted(_glob.glob(path))
        if any(os.path.isdir(f) for f in files):
            raise _DeltaRefused("glob matches a directory (dataset layout)")
    elif os.path.isdir(path):
        names = sorted(os.listdir(path))
        files = []
        for n in names:
            full = os.path.join(path, n)
            if os.path.isdir(full):
                raise _DeltaRefused(
                    "nested directory (hive/partitioned dataset layout)"
                )
            if n.startswith((".", "_")):
                # the loaders skip hidden files, but a schema sidecar
                # changes the whole-directory load's column order/types
                # in a way per-file delta loads cannot reproduce
                if n == "_fugue_schema":
                    raise _DeltaRefused(
                        "directory carries a _fugue_schema sidecar "
                        "(dataset load semantics)"
                    )
                continue
            files.append(full)
    elif os.path.exists(path):
        files = [path]
    else:
        raise _DeltaRefused(f"load source {path} does not exist")
    if len(files) == 0:
        raise _DeltaRefused(f"load source {path} holds no files")
    return [_token(f) for f in files], file_format, (
        len(files) == 1 and os.path.isfile(path)
    )


# ---------------------------------------------------------------------------
# aggregate delta spec: partial / combine / finish
# ---------------------------------------------------------------------------


class AggSpec:
    """How a sum/count/avg/min/max aggregate decomposes into a partial
    frame (the accumulator image), a combine pass and a finish.

    ``partial_cols`` is ``[(name, combine_op)]`` — the partial frame's
    non-key columns in order with the operation that merges two partials
    (count combines by SUM; NULL is the identity throughout, mirroring
    ``_fold_dense_acc``). ``finish`` is ``[(out_name, kind)]`` where kind
    is ``pass`` or ``avg`` (out = ``<out>__dsum / <out>__dcnt``)."""

    def __init__(self) -> None:
        self.keys: List[str] = []
        self.partial_exprs: List[Any] = []
        self.partial_cols: List[Tuple[str, str]] = []
        self.finish: List[Tuple[str, str]] = []
        self.has_avg = False


def parse_agg_spec(keys: List[str], agg_cols: List[Any]) -> AggSpec:
    from ..column import col as _col
    from ..column import functions as ff
    from ..column.expressions import (
        _FuncExpr,
        _LitColumnExpr,
        _NamedColumnExpr,
    )

    spec = AggSpec()
    spec.keys = list(keys)
    seen: set = set(keys)
    builders = {"SUM": ff.sum, "MIN": ff.min, "MAX": ff.max, "COUNT": ff.count}
    combine_of = {"SUM": "sum", "MIN": "min", "MAX": "max", "COUNT": "sum"}
    for c in agg_cols:
        if not isinstance(c, _FuncExpr) or not c.is_agg or c.is_distinct:
            raise _DeltaRefused(
                f"aggregate column {c!r} has no accumulator form"
            )
        func = c.func.upper()
        if func not in ("SUM", "COUNT", "AVG", "MIN", "MAX") or len(c.args) != 1:
            raise _DeltaRefused(
                f"aggregate {func} is not incrementally maintainable"
            )
        name = c.output_name
        if name == "" or name in seen:
            raise _DeltaRefused("unnamed or duplicate aggregate output")
        seen.add(name)
        arg = c.args[0]
        count_star = func == "COUNT" and (
            (isinstance(arg, _LitColumnExpr) and arg.value is not None)
            or (isinstance(arg, _NamedColumnExpr) and arg.wildcard)
        )
        if not count_star and not (
            isinstance(arg, _NamedColumnExpr) and not arg.wildcard
        ):
            raise _DeltaRefused(
                f"aggregate {func} over a computed expression is not "
                "delta-eligible"
            )
        if func == "AVG":
            spec.has_avg = True
            spec.partial_exprs.append(ff.sum(_col(arg.name)).alias(f"{name}__dsum"))
            spec.partial_exprs.append(ff.count(_col(arg.name)).alias(f"{name}__dcnt"))
            spec.partial_cols.append((f"{name}__dsum", "sum"))
            spec.partial_cols.append((f"{name}__dcnt", "sum"))
            spec.finish.append((name, "avg"))
        else:
            if count_star:
                # reuse the original COUNT(*)/COUNT(lit) expression shape,
                # re-aliased; its cast (if any) is re-applied at finish
                expr = ff.count(_col("*")).alias(name)
            else:
                expr = builders[func](_col(arg.name)).alias(name)
            spec.partial_exprs.append(expr)
            spec.partial_cols.append((name, combine_of[func]))
            spec.finish.append((name, "pass"))
    if len(spec.partial_cols) == 0:
        raise _DeltaRefused("aggregate has no aggregation columns")
    return spec


def _combine_exprs(spec: AggSpec) -> List[Any]:
    """The merge pass over a (cached ++ fresh) partial union — the
    frame-level image of ``_fold_dense_acc`` (torch/streaming.py): sums and
    counts ADD, min/max MEET, NULL is the merge identity."""
    from ..column import col as _col
    from ..column import functions as ff

    ops = {"sum": ff.sum, "min": ff.min, "max": ff.max}
    return [ops[op](_col(n)).alias(n) for n, op in spec.partial_cols]


def _combine_partials(
    engine: Any, cached: Any, fresh: Any, spec: AggSpec, partial_schema: str
) -> Any:
    """Combine two partial frames through the ENGINE's own aggregate, so
    the merged frame comes back in exactly the group order that engine's
    whole-input aggregate would produce (key-sorted on the dense device
    path, first-appearance on host paths — and cached rows precede fresh
    rows in the union, which is the appearance order of old-then-new
    data). The union is normalized to one host frame with the manifest's
    partial schema first, so every delta generation presents the combine
    with one layout."""
    import pandas as pd

    from ..dataframe.pandas_dataframe import PandasDataFrame
    from ..schema import Schema

    schema = Schema(partial_schema)
    uni = pd.concat(
        [cached.as_pandas(), fresh.as_pandas()], ignore_index=True
    )[schema.names]
    from ..collections.partition import PartitionSpec

    uni_df = engine.to_df(PandasDataFrame(uni, schema))
    combined = engine.aggregate(
        uni_df, PartitionSpec(by=list(spec.keys)), _combine_exprs(spec)
    )
    return engine.to_df(combined, schema=partial_schema)


def _finish_partial(engine: Any, combined: Any, spec: AggSpec, out_schema: str) -> Any:
    """avg = sum/count, declared dtypes and column order — the frame-level
    image of ``_finish_dense_host`` (torch/streaming.py)."""
    from ..dataframe.pandas_dataframe import PandasDataFrame
    from ..schema import Schema

    schema = Schema(out_schema)
    if not spec.has_avg:
        return engine.to_df(combined, schema=str(schema))
    import pandas as pd

    pdf = combined.as_pandas()
    out = pd.DataFrame()
    for k in spec.keys:
        out[k] = pdf[k]
    for name, kind in spec.finish:
        if kind == "pass":
            out[name] = pdf[name]
        else:
            cnt = pdf[f"{name}__dcnt"].astype("float64")
            out[name] = pdf[f"{name}__dsum"].astype("float64") / cnt.where(cnt > 0)
    return engine.to_df(PandasDataFrame(out[schema.names], schema))


# ---------------------------------------------------------------------------
# delta templates: static eligibility over the post-optimization DAG
# ---------------------------------------------------------------------------


class DeltaTemplate:
    """One task's delta shape: its single Load root, the row-local tasks
    between them (in execution order; for ``frame`` mode the task itself
    is the last entry), and — for ``acc`` mode — the segment steps plus
    the parsed aggregate spec."""

    def __init__(self) -> None:
        self.task: Optional[FugueTask] = None
        self.mode = "frame"  # or "acc"
        self.load_task: Optional[FugueTask] = None
        self.apply_tasks: List[FugueTask] = []
        self.steps: List[Any] = []  # segment chain (acc-from-segment only)
        self.is_segment = False
        self.agg: Optional[AggSpec] = None
        self.delta_key = ""
        self.path = ""
        self.fmt = ""
        self.partitions: List[Dict[str, Any]] = []
        self.file_format = ""
        self.single_file = False


def _load_params(load_task: FugueTask) -> Tuple[str, str, Any, Dict[str, Any]]:
    p = load_task.params
    return (
        p.get_or_throw("path", str),
        p.get("fmt", ""),
        p.get_or_none("columns", object),
        dict(p.get("params", dict())),
    )


def build_delta_templates(
    tasks: List[FugueTask], fpr: Any
) -> Tuple[Dict[int, DeltaTemplate], Dict[int, str]]:
    """Classify every fingerprintable task as delta-eligible (template) or
    not (reason). Never raises — eligibility is a value, like refusal in
    the fingerprint layer."""
    from ..plan.ir import (
        K_AGGREGATE,
        K_LOAD,
        K_SEGMENT,
        build_graph,
        node_delta_row_local,
    )

    templates: Dict[int, DeltaTemplate] = {}
    reasons: Dict[int, str] = {}
    nodes = build_graph(tasks)
    by_id = {id(n.task): n for n in nodes if n.task is not None}
    part_memo: Dict[int, Any] = {}

    def partitions_of(load_task: FugueTask) -> Tuple[List[Dict[str, Any]], str, bool]:
        if id(load_task) not in part_memo:
            path, fmt, _cols, _kw = _load_params(load_task)
            try:
                part_memo[id(load_task)] = list_source_partitions(path, fmt)
            except _DeltaRefused as r:
                part_memo[id(load_task)] = r
        memo = part_memo[id(load_task)]
        if isinstance(memo, _DeltaRefused):
            raise memo
        return memo

    for node in nodes:
        task = node.task
        if task is None:
            continue
        dfp = fpr.delta_fp(task)
        if dfp is None:
            continue  # the fingerprint layer already carries the reason
        try:
            tpl = DeltaTemplate()
            tpl.task = task
            tpl.delta_key = dfp
            if node.kind == K_LOAD:
                tpl.mode = "frame"
                load_node = node
            elif node_delta_row_local(node):
                tpl.mode = "frame"
                load_node = None
            elif node.kind == K_AGGREGATE:
                tpl.mode = "acc"
                tpl.agg = parse_agg_spec(
                    list(task.partition_spec.partition_by),
                    list(task.params.get("columns", [])),
                )
                load_node = None
            elif node.kind == K_SEGMENT:
                terminal = node.info.get("terminal") or ("?",)
                if terminal[0] != "aggregate":
                    raise _DeltaRefused(
                        f"segment terminal {terminal[0]!r} is not "
                        "incrementally maintainable"
                    )
                tpl.mode = "acc"
                tpl.steps = list(node.info.get("steps", []))
                tpl.is_segment = True
                tpl.agg = parse_agg_spec(
                    list(task.partition_spec.partition_by), list(terminal[1])
                )
                load_node = None
            else:
                raise _DeltaRefused(
                    f"verb {node.kind!r} is not row-local and has no "
                    "accumulator form"
                )
            # walk down the producer chain to the single Load root
            chain: List[FugueTask] = []
            cur = node
            while load_node is None:
                if len(cur.inputs) != 1:
                    raise _DeltaRefused(
                        "producer chain is not single-source (join/zip "
                        "upstream)"
                    )
                parent = cur.inputs[0]
                if parent.kind == K_LOAD:
                    load_node = parent
                    break
                if not node_delta_row_local(parent):
                    raise _DeltaRefused(
                        f"producer {parent.kind!r} is not row-local"
                    )
                chain.append(parent.task)
                cur = parent
            chain.reverse()
            tpl.load_task = load_node.task
            tpl.apply_tasks = list(chain)
            if tpl.mode == "frame" and task is not tpl.load_task:
                tpl.apply_tasks.append(task)
            tpl.partitions, tpl.file_format, tpl.single_file = partitions_of(
                tpl.load_task
            )
            tpl.path, tpl.fmt, _c, _k = _load_params(tpl.load_task)
            templates[id(task)] = tpl
        except _DeltaRefused as r:
            reasons[id(task)] = r.reason
        except Exception as ex:  # eligibility must never fail a run
            reasons[id(task)] = f"delta analysis error: {type(ex).__name__}"
    return templates, reasons


# ---------------------------------------------------------------------------
# manifest match
# ---------------------------------------------------------------------------


class DeltaHit:
    """A matched manifest: which partitions are served from cache, which
    are fresh, and (after the planner's eager load) the cached frames."""

    def __init__(self, template: DeltaTemplate, manifest: Dict[str, Any]):
        self.template = template
        self.manifest = manifest
        self.new_files: List[str] = []
        self.grown_rows: Optional[int] = None  # reload + slice [rows:]
        self.matched_parts = 0
        self.total_parts = 0
        self.bytes_matched = 0
        self.bytes_fresh = 0
        self.out_schema: str = manifest.get("out_schema", "")
        self.artifact_fps: List[str] = []  # to eager-load, in merge order
        self.cached_frames: List[Any] = []
        self.fresh_input_rows = 0
        self.fresh_result: Any = None  # frame mode: fresh chain output
        self.combined_partial: Any = None  # acc mode
        self.failed = False  # runtime fallback taken; skip manifest upkeep


def _tokens_equal(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    return (
        a.get("path") == b.get("path")
        and int(a.get("size", -1)) == int(b.get("size", -2))
        and int(a.get("mtime_ns", -1)) == int(b.get("mtime_ns", -2))
    )


def match_manifest(
    template: DeltaTemplate, cache: Any, repair: bool = True
) -> DeltaHit:
    """Match the published manifest against the CURRENT source partitions;
    returns a (not yet loaded) DeltaHit or raises ``_DeltaRefused``. With
    ``repair`` (the run path, not explain), a manifest referencing evicted
    artifacts is deleted so only that chain degrades."""
    m = cache.get_manifest(template.delta_key)
    if m is None:
        raise _DeltaRefused("no partition manifest published yet")
    refuse = lambda msg: _DeltaRefused(msg, had_manifest=True)  # noqa: E731
    if int(m.get("version", -1)) != MANIFEST_VERSION or m.get("mode") not in (
        "frame",
        "acc",
    ):
        raise refuse("unreadable manifest version")
    if m.get("mode") != template.mode:
        raise refuse("manifest mode mismatch (plan shape changed)")
    hit = DeltaHit(template, m)
    current = template.partitions
    old_parts = list(m.get("partitions", []))
    hit.total_parts = len(current)
    if m.get("by") == "rows":
        # single appendable file: the stored digest proves the old bytes
        # are an unchanged prefix of the grown file
        if not (template.single_file and len(current) == 1 and len(old_parts) == 1):
            raise refuse("source is no longer a single file")
        cur, old = current[0], old_parts[0]
        if cur["path"] != old.get("path"):
            raise refuse("source path changed")
        if _tokens_equal(cur, old):
            raise refuse("source unchanged (whole-task fingerprint serves it)")
        if template.file_format not in _APPENDABLE_FORMATS:
            raise refuse("format cannot grow by append")
        if int(cur["size"]) <= int(old.get("size", 0)):
            raise refuse("partition contents changed (not an append)")
        digest = old.get("digest")
        rows = old.get("rows")
        if not digest or rows is None:
            raise refuse("manifest lacks prefix digest/rows for append check")
        if _digest_prefix(cur["path"], int(old["size"])) != digest:
            raise refuse("partition contents changed (prefix digest mismatch)")
        hit.grown_rows = int(rows)
        hit.matched_parts = 1
        hit.bytes_matched = int(old["size"])
        hit.bytes_fresh = int(cur["size"]) - int(old["size"])
        hit.total_parts = 1
    else:
        if len(old_parts) > len(current):
            raise refuse("cached partitions missing from source (shrunk or rewritten)")
        for i, old in enumerate(old_parts):
            cur = current[i]
            if cur["path"] != old.get("path"):
                raise refuse(
                    "partition order changed (a new file sorts before cached "
                    "ones — not an append)"
                )
            if not _tokens_equal(cur, old):
                raise refuse("partition contents changed (not an append)")
        if len(old_parts) == len(current):
            raise refuse(
                "no new partitions (whole-task fingerprint serves exact matches)"
            )
        hit.new_files = [t["path"] for t in current[len(old_parts):]]
        hit.matched_parts = len(old_parts)
        hit.bytes_matched = sum(int(t.get("size", 0)) for t in old_parts)
        hit.bytes_fresh = sum(
            int(t.get("size", 0)) for t in current[len(old_parts):]
        )
    # every referenced artifact must still exist; a stale manifest
    # invalidates ITSELF, never the rest of the cache
    if template.mode == "frame":
        segs = list(m.get("segments", []))
        if len(segs) == 0:
            raise refuse("manifest holds no segments")
        hit.artifact_fps = [s["artifact"] for s in segs]
    else:
        partial = m.get("partial") or {}
        if not partial.get("artifact"):
            raise refuse("manifest holds no partial accumulator")
        hit.artifact_fps = [partial["artifact"]]
    missing = [fp for fp in hit.artifact_fps if cache.contains(fp) is None]
    if missing:
        if repair:
            cache.drop_manifest(template.delta_key)
        raise refuse(
            "cached partition artifact evicted (manifest entry invalidated)"
        )
    if not hit.out_schema:
        raise refuse("manifest lacks the output schema")
    return hit


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


def _load_fresh(engine: Any, hit: DeltaHit) -> Any:
    """The delta input frame: only the new partitions (or the grown
    file's appended rows) go through decode/transfer."""
    tpl = hit.template
    _path, fmt, columns, kwargs = _load_params(tpl.load_task)
    if hit.grown_rows is not None:
        full = engine.load_df(
            tpl.path, format_hint=fmt or None, columns=columns, **kwargs
        )
        hit.fresh_input_rows = max(0, full.count() - hit.grown_rows)
        try:
            tbl = full.as_arrow()
            from ..dataframe.arrow_dataframe import ArrowDataFrame

            sliced: Any = ArrowDataFrame(tbl.slice(hit.grown_rows))
        except Exception:
            import pandas as pd  # noqa: F401

            from ..dataframe.pandas_dataframe import PandasDataFrame

            pdf = full.as_pandas().iloc[hit.grown_rows:].reset_index(drop=True)
            sliced = PandasDataFrame(pdf, full.schema)
        return engine.to_df(sliced, schema=str(full.schema))
    fresh = engine.load_df(
        list(hit.new_files), format_hint=fmt or None, columns=columns, **kwargs
    )
    hit.fresh_input_rows = fresh.count()
    return fresh


def _apply_chain(ctx: Any, df: Any, tasks: List[FugueTask]) -> Any:
    for t in tasks:
        df = t.execute(ctx, [df])
    return df


def _concat_frames(engine: Any, frames: List[Any], out_schema: str) -> Any:
    """Order-preserving concatenation on the HOST, then ONE engine
    ingestion: a full recompute gives cached rows then fresh rows, and
    so does this."""
    import pyarrow as pa

    from ..dataframe.arrow_dataframe import ArrowDataFrame
    from ..schema import Schema

    pa_schema = Schema(out_schema).pa_schema
    tables = []
    for f in frames:
        t = f.as_arrow()
        if t.schema != pa_schema:
            t = t.select(pa_schema.names).cast(pa_schema)
        tables.append(t)
    merged = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
    return engine.to_df(ArrowDataFrame(merged))


def execute_delta(ctx: Any, task: FugueTask, hit: DeltaHit) -> Any:
    """Compute the task's FULL result from cached partitions + fresh
    partitions. Any failure degrades in place to a full recompute from
    the source (the chain is single-source, so no DAG inputs are needed)
    — never a wrong result."""
    engine = ctx.execution_engine
    tpl = hit.template
    try:
        fresh_in = _load_fresh(engine, hit)
        if tpl.mode == "frame":
            fresh_out = _apply_chain(ctx, fresh_in, tpl.apply_tasks)
            hit.fresh_result = engine.to_df(fresh_out)
            return _concat_frames(
                engine,
                list(hit.cached_frames) + [hit.fresh_result],
                hit.out_schema,
            )
        spec = tpl.agg
        if tpl.is_segment:
            # the new partitions through the lowered path: the chain and
            # the partial aggregate over the raw columns, the float32 SUMs
            # in the binned-sum kernel on the card
            from ..plan.lowering import segment_fingerprint

            terminal = ("aggregate", tuple(spec.partial_exprs))
            fresh_partial = engine.lowered_segment(
                [_apply_chain(ctx, fresh_in, tpl.apply_tasks)],
                list(tpl.steps),
                terminal,
                task.partition_spec,
                fingerprint=segment_fingerprint(list(tpl.steps), terminal),
            )
        else:
            chain_out = _apply_chain(ctx, fresh_in, tpl.apply_tasks)
            fresh_partial = engine.aggregate(
                chain_out, task.partition_spec, list(spec.partial_exprs)
            )
        partial_schema = hit.manifest["partial"]["schema"]
        fresh_partial = engine.to_df(fresh_partial, schema=partial_schema)
        combined = _combine_partials(
            engine, hit.cached_frames[0], fresh_partial, spec, partial_schema
        )
        hit.combined_partial = combined
        return _finish_partial(engine, combined, spec, hit.out_schema)
    except Exception as ex:
        engine.log.warning(
            "delta recompute of %s failed (%s: %s); falling back to full "
            "recompute from source",
            task.name or type(task.extension).__name__,
            type(ex).__name__,
            ex,
        )
        hit.fresh_result = None
        hit.combined_partial = None
        hit.failed = True
        # the chain is single-source: rebuild the task's input from the
        # original Load task and run the ORIGINAL tasks — exactly the
        # plain whole-task computation
        df = tpl.load_task.execute(ctx, [])
        df = _apply_chain(ctx, df, tpl.apply_tasks)
        if tpl.mode == "acc":
            df = task.execute(ctx, [df])
        return df


# ---------------------------------------------------------------------------
# manifest publishing (cold runs AND after a delta-served run)
# ---------------------------------------------------------------------------


def _partial_fp(delta_key: str, partitions: List[Dict[str, Any]]) -> str:
    return "d" + to_uuid(
        "partial", delta_key, [(t["path"], t["size"], t["mtime_ns"]) for t in partitions]
    ).replace("-", "")[:30]


def _segment_fp(delta_key: str, partitions: List[Dict[str, Any]]) -> str:
    return "d" + to_uuid(
        "segment", delta_key, [(t["path"], t["size"], t["mtime_ns"]) for t in partitions]
    ).replace("-", "")[:30]


def _enrich_single_file(
    ctx: Any, tpl: DeltaTemplate, tokens: List[Dict[str, Any]], rows: Optional[int]
) -> None:
    """Record the content digest + row count that make a single csv/json
    source append-detectable later. Skipped when the file changed since
    plan time (the artifact would not cover the new bytes)."""
    if not (
        tpl.single_file
        and len(tokens) == 1
        and tpl.file_format in _APPENDABLE_FORMATS
        and rows is not None
    ):
        return
    t = tokens[0]
    try:
        if not _tokens_equal(_token(t["path"]), t):
            return
        t["digest"] = _digest_prefix(t["path"], int(t["size"]))
        t["rows"] = int(rows)
    except OSError:
        return


def _load_rows(ctx: Any, tpl: DeltaTemplate) -> Optional[int]:
    try:
        if ctx.has_result(tpl.load_task):
            return int(ctx.get_result(tpl.load_task).count())
    except Exception:
        return None
    return None


def publish_manifest_after(
    ctx: Any,
    task: FugueTask,
    result: Any,
    inputs: Optional[List[Any]] = None,
    hit: Optional[DeltaHit] = None,
) -> None:
    """Maintain the partition manifest after a task publishes its result.

    Cold runs write the first manifest (frame mode references the task's
    own artifact; acc mode with ``avg`` additionally publishes the
    decomposed partial, computed from the task's still-live input frame).
    Delta-served runs append the fresh segment / replace the partial so
    the NEXT append only pays for its own delta. Never raises."""
    plan = getattr(ctx, "_cache_plan", None)
    if plan is None:
        return
    engine = ctx.execution_engine
    cache = engine.result_cache
    if not (cache.enabled and cache.delta_enabled):
        return
    tpl = getattr(plan, "delta_templates", {}).get(id(task))
    if tpl is None or getattr(hit, "failed", False):
        return
    fp = plan.fp(task)
    if fp is None or (result.is_local and not result.is_bounded):
        return
    try:
        if hit is None:
            _publish_cold(ctx, cache, engine, task, tpl, fp, result, inputs)
        else:
            _publish_warm(ctx, cache, engine, task, tpl, fp, result, hit)
    except Exception as ex:  # manifest upkeep must never fail the run
        engine.log.warning(
            "delta manifest publish for %s failed: %s", tpl.delta_key[:12], ex
        )


def _base_manifest(tpl: DeltaTemplate, out_schema: str, by: str) -> Dict[str, Any]:
    return {
        "version": MANIFEST_VERSION,
        "delta_key": tpl.delta_key,
        "mode": tpl.mode,
        "by": by,
        "fmt": tpl.file_format,
        "path": tpl.path,
        "out_schema": out_schema,
        "partitions": [dict(t) for t in tpl.partitions],
    }


def _publish_cold(
    ctx: Any,
    cache: Any,
    engine: Any,
    task: FugueTask,
    tpl: DeltaTemplate,
    fp: str,
    result: Any,
    inputs: Optional[List[Any]],
) -> None:
    if cache.contains(fp) is None:
        return  # the result artifact itself was not cacheable
    if tpl.single_file:
        if tpl.file_format not in _APPENDABLE_FORMATS:
            return  # a single parquet file can never grow by append
        by = "rows"
    else:
        by = "files"
    m = _base_manifest(tpl, str(result.schema), by)
    if by == "rows":
        _enrich_single_file(ctx, tpl, m["partitions"], _load_rows(ctx, tpl))
        if "rows" not in m["partitions"][0]:
            return  # source changed mid-run; no manifest
    if tpl.mode == "frame":
        if by == "rows":
            m["segments"] = [
                {"rows": [0, int(m["partitions"][0]["rows"])], "artifact": fp}
            ]
        else:
            m["segments"] = [{"upto": len(m["partitions"]), "artifact": fp}]
    else:
        spec = tpl.agg
        if not spec.has_avg:
            # the finished frame IS the accumulator (sum-of-sums == sum);
            # one artifact, two roles
            m["partial"] = {"artifact": fp, "schema": str(result.schema)}
        else:
            if not inputs or len(inputs) != 1:
                return
            src = inputs[0]
            if src.is_local and not src.is_bounded:
                return  # stream input already consumed
            chain_out = src
            if tpl.steps:
                chain_out = engine.fused_apply(chain_out, list(tpl.steps))
            partial = engine.aggregate(
                chain_out, task.partition_spec, list(spec.partial_exprs)
            )
            pfp = _partial_fp(tpl.delta_key, tpl.partitions)
            cache.publish(pfp, partial, engine, str(partial.schema))
            if cache.contains(pfp) is None:
                return
            m["partial"] = {"artifact": pfp, "schema": str(partial.schema)}
    cache.put_manifest(tpl.delta_key, m)


def _publish_warm(
    ctx: Any,
    cache: Any,
    engine: Any,
    task: FugueTask,
    tpl: DeltaTemplate,
    fp: str,
    result: Any,
    hit: DeltaHit,
) -> None:
    m = _base_manifest(tpl, hit.out_schema, hit.manifest.get("by", "files"))
    if m["by"] == "rows":
        old = hit.manifest["partitions"][0]
        _enrich_single_file(
            ctx,
            tpl,
            m["partitions"],
            int(old.get("rows", 0)) + hit.fresh_input_rows,
        )
        if "rows" not in m["partitions"][0]:
            return
    if tpl.mode == "frame":
        if hit.fresh_result is None:
            return
        seg_fp = _segment_fp(tpl.delta_key, tpl.partitions)
        cache.publish(seg_fp, hit.fresh_result, engine, str(hit.fresh_result.schema))
        if cache.contains(seg_fp) is None:
            return
        segs = list(hit.manifest.get("segments", []))
        if m["by"] == "rows":
            start = int(hit.manifest["partitions"][0].get("rows", 0))
            segs.append(
                {"rows": [start, int(m["partitions"][0]["rows"])], "artifact": seg_fp}
            )
        else:
            segs.append({"upto": len(m["partitions"]), "artifact": seg_fp})
        m["segments"] = segs
    else:
        if hit.combined_partial is None:
            return
        spec = tpl.agg
        if not spec.has_avg and cache.contains(fp) is not None:
            # the merged result was just published under the new full
            # fingerprint — reuse it as the accumulator
            m["partial"] = {"artifact": fp, "schema": str(result.schema)}
        else:
            pfp = _partial_fp(tpl.delta_key, tpl.partitions)
            cache.publish(
                pfp, hit.combined_partial, engine, str(hit.combined_partial.schema)
            )
            if cache.contains(pfp) is None:
                return
            m["partial"] = {
                "artifact": pfp,
                "schema": str(hit.combined_partial.schema),
            }
    cache.put_manifest(tpl.delta_key, m)
