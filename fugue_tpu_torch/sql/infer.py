"""A SELECT's output schema from its input tables' schemas alone, copied
from ``fugue_tpu/sql/infer.py``: the statement parsed by ``parser.py`` and
``ColumnExpr.infer_type`` folded over the plan. It answers None the
moment anything is unknown (an unresolved name, an untyped expression),
so a caller falls back to what the run gives."""

from typing import Dict, List, Optional

import pyarrow as pa

from ..schema import Schema
from .parser import (
    JoinNode,
    LimitNode,
    PlanNode,
    Scan,
    SelectNode,
    SetOpNode,
    SortNode,
    SQLParser,
    Subquery,
)


def infer_output_schema(
    sql: str, schemas: Dict[str, Schema]
) -> Optional[Schema]:
    """Output schema of ``sql`` over input tables ``schemas``, or None."""
    try:
        plan = SQLParser(sql).parse_full()
    except Exception:
        return None
    try:
        return _infer(plan, schemas)
    except Exception:
        return None


def _infer(plan: Optional[PlanNode], schemas: Dict[str, Schema]) -> Optional[Schema]:
    if plan is None:
        return None
    if isinstance(plan, Scan):
        s = schemas.get(plan.name)
        return s
    if isinstance(plan, Subquery):
        return _infer(plan.child, schemas)
    if isinstance(plan, (SortNode, LimitNode)):
        return _infer(plan.child, schemas)
    if isinstance(plan, SetOpNode):
        return _infer(plan.left, schemas)
    if isinstance(plan, JoinNode):
        left = _infer(plan.left, schemas)
        right = _infer(plan.right, schemas)
        if left is None or right is None:
            return None
        on = set(plan.on)
        fields = list(left.fields) + [
            f for f in right.fields if f.name not in on
        ]
        if plan.how in ("semi", "anti", "left_semi", "left_anti"):
            fields = list(left.fields)
        return Schema(fields)
    if isinstance(plan, SelectNode):
        child = (
            _infer(plan.child, schemas)
            if plan.child is not None
            else Schema([])
        )
        if child is None:
            return None
        fields: List[pa.Field] = []
        for c in plan.projections:
            name = getattr(c, "name", None)
            if name == "*":
                fields.extend(child.fields)
                continue
            out = c.output_name
            if out == "":
                return None
            tp = c.infer_type(child)
            if tp is None:
                return None
            fields.append(pa.field(out, tp))
        return Schema(fields)
    return None
