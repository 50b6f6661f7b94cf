"""Expansion pass: translated UDF transforms → ordinary plan nodes, copied
from ``fugue_tpu/analysis/expand.py``.

Runs FIRST in the optimizer (before pushdown/prune/fuse/lowering), so a
translated UDF's steps are plain ``filter``/``assign``/``select`` logical
nodes that every later pass composes with natively: filters commute
around them, pruning sees their exact demand, fusion collapses them with
surrounding verbs, and segment lowering runs the whole chain as one
segment over the raw columns. Analyzed-but-untranslated transforms keep
their node, with the ``UdfAnalysis`` (``analyzer.py``) attached to
``info["analysis"]`` so demand analysis and filter pushdown can still
use the exact column facts.

A translated chain ends in a schema-shaping step that reproduces the
declared output schema (column order and dtype casts) EXACTLY as the
interpreted path's schema enforcement would — any mismatch ``_build_final_steps``
can't prove refuses back to the interpreted path.
"""

from typing import Any, Dict, List, Optional, Tuple

from ..column.expressions import col as _col
from ..column.sql import SelectColumns
from ..plan.ir import (
    K_ASSIGN,
    K_DROP,
    K_FILTER,
    K_PROJECT,
    K_RENAME,
    K_SELECT,
    K_TRANSFORM,
    LNode,
    infer_schemas,
)
from .analyzer import UdfAnalysis, analyze_transform_task

__all__ = ["expand_udf_transforms"]


def _node_for_step(st: Tuple) -> LNode:
    kind = st[0]
    if kind == "project":
        return LNode(None, K_PROJECT, {"columns": list(st[1])})
    if kind == "drop":
        return LNode(
            None, K_DROP, {"columns": list(st[1]), "if_exists": bool(st[2])}
        )
    if kind == "rename":
        return LNode(None, K_RENAME, {"columns": dict(st[1])})
    if kind == "filter":
        return LNode(None, K_FILTER, {"condition": st[1]})
    if kind == "assign":
        return LNode(None, K_ASSIGN, {"columns": list(st[1])})
    if kind == "select":
        return LNode(
            None, K_SELECT, {"columns": st[1], "where": None, "having": None}
        )
    raise AssertionError(f"untranslatable step {kind}")  # pragma: no cover


def _build_final_steps(
    a: UdfAnalysis, in_names: List[str]
) -> Tuple[Optional[List[Tuple]], Optional[str]]:
    """Append the schema-shaping step for the declared output schema, or
    (None, reason) when the translation can't be proven to reproduce the
    interpreted path's enforced schema."""
    names = list(in_names)
    for st in a.steps or []:
        kind = st[0]
        if kind == "project":
            if any(c not in names for c in st[1]):
                return None, "projects a column missing from the input"
            names = list(st[1])
        elif kind == "drop":
            if any(c not in names for c in st[1]):
                return None, "drops a column missing from the input"
            dropped = set(st[1])
            names = [c for c in names if c not in dropped]
            if not names:
                return None, "drops every column"
        elif kind == "rename":
            m = dict(st[1])
            if any(k not in names for k in m):
                return None, "renames a column missing from the input"
            names = [m.get(c, c) for c in names]
            if len(set(names)) != len(names):
                return None, "rename collides with an existing column"
        elif kind == "filter":
            pass
        elif kind == "assign":
            for e in st[1]:
                n = e.output_name
                if n not in names:
                    names.append(n)
        else:  # pragma: no cover - the tracer only emits the above
            return None, f"unexpected step {kind}"
    if a.star:
        if a.writes is None:
            return None, "write set unknown"
        for n, _ in a.declared:
            if n in in_names:
                return None, f"declares existing column {n!r} under '*'"
        overlap = sorted(a.writes & set(in_names))
        if overlap:
            # the enforced output dtype of a written passthrough column is
            # its ORIGINAL input dtype — unknowable at plan time
            return (
                None,
                f"writes passthrough column {overlap[0]!r} "
                "(dtype unknown at plan time)",
            )
        out: List[Tuple[str, Any]] = [(c, None) for c in in_names]
        out.extend(a.declared)
    else:
        out = list(a.declared)
    missing = [n for n, _ in out if n not in names]
    if missing:
        return None, f"declared column {missing[0]!r} is never produced"
    steps = list(a.steps or [])
    # schema shaping as (cast-assign, project) rather than one big select:
    # an assign only demands the columns it casts and a project demands
    # exactly its list, so downstream demand keeps narrowing through the
    # translated chain (one select would read EVERY output), and un-cast
    # passthrough columns (e.g. group keys) stay plain for lowering
    casts = [_col(n).cast(t).alias(n) for n, t in out if t is not None]
    if casts:
        steps.append(("assign", tuple(casts)))
    if names != [n for n, _ in out]:
        steps.append(("project", tuple(n for n, _ in out)))
    if not steps:
        steps = [("project", tuple(names))]
    return steps, None


def _splice(nodes: List[LNode], n: LNode, steps: List[Tuple]) -> LNode:
    from ..plan.fused import describe_step

    new_nodes = [_node_for_step(st) for st in steps]
    prev = n.inputs[0]
    for nn in new_nodes:
        nn.inputs = [prev]
        prev = nn
    tail = new_nodes[-1]
    tail.result_of = list(n.result_of)
    tail.tail_origin = n.task
    tail.pinned = n.pinned
    a: UdfAnalysis = n.info["analysis"]
    tail.annotations.append(
        "udf %s[%s] translated: %s"
        % (a.name, a.fp, " | ".join(describe_step(s) for s in steps))
    )
    for c in nodes:
        if n in c.inputs:
            c.inputs = [tail if i is n else i for i in c.inputs]
    pos = nodes.index(n)
    nodes[pos : pos + 1] = new_nodes
    return tail


def expand_udf_transforms(
    nodes: List[LNode], report: Any, translate: bool = True
) -> List[Dict[str, Any]]:
    """Analyze every transform node; attach facts; replace translatable
    ones with plain plan nodes. Returns the per-UDF diagnostics (also
    stored on ``report.udf_diags``)."""
    diags: List[Dict[str, Any]] = []
    for n in list(nodes):
        if n.kind != K_TRANSFORM or n.task is None:
            continue
        a = analyze_transform_task(n.task)
        if a is None:
            continue
        n.info["analysis"] = a
        diag: Dict[str, Any] = {
            "udf": a.name,
            "fp": a.fp,
            "verdict": a.verdict,
            "code": a.code,
            "reason": a.reason,
            "translated": False,
        }
        refusal: Optional[Tuple[str, str]] = None
        final: Optional[List[Tuple]] = None
        if a.steps is None:
            refusal = (
                a.code or "unknown-construct",
                a.reason or "unrecognized construct",
            )
        elif not translate:
            refusal = (
                "disabled",
                "translation disabled (fugue.tpu.plan.translate_udfs=false)",
            )
        elif not n.task.checkpoint.is_null:
            refusal = (
                "pinned",
                "checkpointed transform (storage identity is uuid-keyed)",
            )
        elif len(n.inputs) != 1:
            refusal = ("signature", "multi-input transform")
        else:
            # prior expansions may have changed the graph — infer fresh
            in_names = infer_schemas(nodes).get(id(n.inputs[0]))
            if in_names is None:
                refusal = (
                    "input-schema", "producer schema unknown at plan time"
                )
            else:
                final, err = _build_final_steps(a, list(in_names))
                if final is None:
                    refusal = ("schema", err or "schema mismatch")
        if refusal is not None:
            code, detail = refusal
            diag["code"], diag["reason"] = code, detail
            msg = f"udf {a.name}[{a.fp}]: interpreted -- {detail}"
            n.annotations.append(msg)
            report.note(msg)
            report.udfs_refused += 1
        else:
            assert final is not None
            _splice(nodes, n, final)
            diag["translated"] = True
            diag["verdict"] = "translated"
            diag["code"], diag["reason"] = None, None
            report.udfs_translated += 1
            report.note(
                f"udf {a.name}[{a.fp}]: translated into "
                f"{len(final)} compiled step(s)"
            )
        report.udfs_analyzed += 1
        diags.append(diag)
    report.udf_diags.extend(diags)
    return diags
