"""Verb fusion: one task for an adjacent select/filter/assign chain,
copied from ``fugue_tpu/plan/fused.py``.

The fusion pass collapses maximal single-consumer chains of row-local
verbs (project/drop/rename/filter/select/assign) into ONE
:class:`FusedVerbs` task. Execution is engine-mediated via
``engine.fused_apply(df, steps)``:

- the default (every engine) applies the steps sequentially with the
  engine's own verbs — bit-identical to the unfused chain by
  construction;
- the torch engine evaluates the whole chain on the device when every
  step is expressible in the column IR (``TorchExecutionEngine.
  fused_apply``): the three-valued predicate once, every projection under
  it, and no intermediate frame;
- stream-frame inputs apply the steps per chunk inside the chunk
  producer (``streaming_fused_steps``), so the stream stays
  one-pass/out-of-core.

A step is a plain tuple (uuid-hashable through ``ParamDict``):

- ``("project", (names...))``
- ``("drop", (names...), if_exists)``
- ``("rename", {old: new})``
- ``("filter", ColumnExpr)``
- ``("assign", (ColumnExpr...))``
- ``("select", SelectColumns)``
"""

from typing import Any, Dict, List, Optional, Tuple

from ..column.expressions import (
    ColumnExpr,
    _BinaryOpExpr,
    _CaseWhenExpr,
    _FuncExpr,
    _InExpr,
    _LikeExpr,
    _LitColumnExpr,
    _NamedColumnExpr,
    _UnaryOpExpr,
    col as _col,
)
from ..column.sql import SelectColumns
from ..exceptions import FugueWorkflowError
from ..extensions.processor.processor import Processor

__all__ = [
    "FusedVerbs",
    "apply_steps_engine",
    "compose_steps",
    "describe_step",
]


class FusedVerbs(Processor):
    """Execute a fused chain of row-local verbs as one task."""

    def process(self, dfs: Any) -> Any:
        from .._utils.assertion import assert_or_throw

        assert_or_throw(
            len(dfs) == 1, FugueWorkflowError("fused verbs take one input")
        )
        steps = self.params.get_or_throw("steps", list)
        return self.execution_engine.fused_apply(dfs[0], steps)


def apply_steps_engine(engine: Any, df: Any, steps: List[Tuple]) -> Any:
    """Sequential fallback: interpret the steps with the engine's own
    verbs — exactly what the unfused task chain would have executed."""
    df = engine.to_df(df)
    for st in steps:
        kind = st[0]
        if kind == "project":
            df = df[list(st[1])]
        elif kind == "drop":
            names = list(st[1])
            if st[2]:  # if_exists
                names = [c for c in names if c in df.schema]
            df = df.drop(names)
        elif kind == "rename":
            df = df.rename(dict(st[1]))
        elif kind == "filter":
            df = engine.filter(df, st[1])
        elif kind == "assign":
            df = engine.assign(df, list(st[1]))
        elif kind == "select":
            df = engine.select(df, st[1])
        else:  # pragma: no cover - the fusion pass only emits the above
            raise FugueWorkflowError(f"unknown fused step {kind}")
    return df


def describe_step(st: Tuple) -> str:
    kind = st[0]
    if kind == "project":
        return f"project[{','.join(st[1])}]"
    if kind == "drop":
        return f"drop[{','.join(st[1])}]"
    if kind == "rename":
        return "rename[" + ",".join(f"{k}->{v}" for k, v in st[1].items()) + "]"
    if kind == "filter":
        return f"filter[{st[1]!r}]"
    if kind == "assign":
        return "assign[" + ",".join(c.output_name for c in st[1]) + "]"
    if kind == "select":
        return "select[" + ",".join(repr(c) for c in st[1].all_cols) + "]"
    return kind


# ---------------------------------------------------------------------------
# symbolic composition: chain -> (one predicate, one projection)
# ---------------------------------------------------------------------------


def _finish(out: ColumnExpr, e: ColumnExpr) -> ColumnExpr:
    """Restore e's cast/alias onto a rebuilt node."""
    if e.as_type is not None and out.as_type != e.as_type:
        out = out.cast(e.as_type)
    if e.as_name != "" and out.as_name != e.as_name:
        out = out.alias(e.as_name)
    return out


def _inline(e: ColumnExpr, state: Dict[str, ColumnExpr]) -> Optional[ColumnExpr]:
    """Rebuild ``e`` with every named reference replaced by its defining
    expression over the ORIGINAL input columns. None = not composable."""
    if isinstance(e, _NamedColumnExpr):
        if e.wildcard or e.name not in state:
            return None
        return _finish(state[e.name], e)
    if isinstance(e, _LitColumnExpr):
        return e
    if isinstance(e, _UnaryOpExpr):
        c = _inline(e.col, state)
        return None if c is None else _finish(_UnaryOpExpr(e.op, c), e)
    if isinstance(e, _BinaryOpExpr):
        l = _inline(e.left, state)
        r = _inline(e.right, state)
        if l is None or r is None:
            return None
        return _finish(_BinaryOpExpr(e.op, l, r), e)
    if isinstance(e, _FuncExpr) and not e.is_agg:
        args = [_inline(a, state) for a in e.args]
        if any(a is None for a in args):
            return None
        return _finish(
            _FuncExpr(e.func, *args, arg_distinct=e.is_distinct), e
        )
    if isinstance(e, _InExpr):
        c = _inline(e.col, state)
        return None if c is None else _finish(_InExpr(c, e.values, e.positive), e)
    if isinstance(e, _LikeExpr):
        c = _inline(e.col, state)
        return None if c is None else _finish(_LikeExpr(c, e.pattern, e.positive), e)
    if isinstance(e, _CaseWhenExpr):
        cases = []
        for cc, vv in e.cases:
            ic, iv = _inline(cc, state), _inline(vv, state)
            if ic is None or iv is None:
                return None
            cases.append((ic, iv))
        dd = _inline(e.default, state)
        return None if dd is None else _finish(_CaseWhenExpr(cases, dd), e)
    return None  # windows / aggregates / unknown nodes don't compose


def compose_steps(
    input_names: List[str], steps: List[Tuple]
) -> Optional[Tuple[Optional[ColumnExpr], List[ColumnExpr]]]:
    """Normalize a step chain into ``(predicate, output expressions)``
    over the ORIGINAL input columns — the one-pass form. The predicate
    is the Kleene-AND of every filter (a row survives the chain iff every
    filter is TRUE on it, which is exactly sequential filtering because
    all steps are row-local). Returns None when any step resists
    composition (the caller falls back to sequential execution)."""
    state: Dict[str, ColumnExpr] = {n: _col(n) for n in input_names}
    pred: Optional[ColumnExpr] = None
    for st in steps:
        kind = st[0]
        if kind == "project":
            names = list(st[1])
            if any(n not in state for n in names):
                return None
            state = {n: state[n] for n in names}
        elif kind == "drop":
            names = set(st[1])
            if not st[2] and any(n not in state for n in names):
                return None  # sequential path raises the proper error
            state = {k: v for k, v in state.items() if k not in names}
            if len(state) == 0:
                return None
        elif kind == "rename":
            m = dict(st[1])
            if any(k not in state for k in m):
                return None
            new_state = {m.get(k, k): v for k, v in state.items()}
            if len(new_state) != len(state):
                return None
            state = new_state
        elif kind == "filter":
            c = _inline(st[1], state)
            if c is None:
                return None
            pred = c if pred is None else (pred & c)
        elif kind == "assign":
            adds: List[Tuple[str, ColumnExpr]] = []
            for e in st[1]:
                name = e.output_name
                if name == "":
                    return None
                ie = _inline(e, state)
                if ie is None:
                    return None
                adds.append((name, ie))
            # all assign expressions evaluate against the PRE-assign frame
            # (engine.assign = one select with replacements)
            for name, ie in adds:
                state[name] = ie
        elif kind == "select":
            sc: SelectColumns = st[1]
            if sc.is_distinct or sc.has_agg:
                return None
            out: Dict[str, ColumnExpr] = {}
            for c in sc.all_cols:
                if isinstance(c, _NamedColumnExpr) and c.wildcard:
                    for k, v in state.items():
                        out.setdefault(k, v)
                    continue
                name = c.output_name
                if name == "":
                    return None
                ie = _inline(c, state)
                if ie is None:
                    return None
                out[name] = ie
            if len(out) == 0:
                return None
            state = out
        else:
            return None
    outputs = [
        (e if e.output_name == name else e.alias(name))
        for name, e in state.items()
    ]
    return pred, outputs
