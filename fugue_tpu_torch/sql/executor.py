"""The logical-plan executor, copied from ``fugue_tpu/sql/executor.py``:
each plan node lowers to the engine's verbs (``join`` with a non-equi
residual as a ``filter``, ``union``/``subtract``/``intersect``, ``take``
for LIMIT, ``select``/``filter``/``assign``/``aggregate``), so SQL runs
wherever those verbs run: on the card for ``TorchExecutionEngine``.
ORDER BY sorts on the host, as the JAX package does; decorrelated
subqueries, GROUPING SETS, GROUP BY expressions and the decoupled GROUP
BY are the JAX package's.

A windowed SELECT (``func(...) OVER (...)``) runs WHERE → window →
projection → DISTINCT: on ``TorchExecutionEngine`` through the device
plan (``torch/window.py``, span ``fugue::window_device``) wherever it
covers the query, as the JAX engine does, and otherwise on the host
through the pandas evaluator (``column/window.py``, span
``fugue::window_host``)."""

from typing import Any, Dict, List, Optional

import pandas as pd
from torch.profiler import record_function

from ..column import SelectColumns, col as _col
from ..column.expressions import (
    ColumnExpr,
    _LitColumnExpr,
    _NamedColumnExpr,
    _WindowExpr,
)


def _referenced_names(expr: "ColumnExpr") -> List[str]:
    """All column names referenced anywhere in the expression tree."""
    names: List[str] = []

    def walk(e: "ColumnExpr") -> None:
        if isinstance(e, _NamedColumnExpr):
            names.append(e.name)
        for c in e.children:
            walk(c)

    walk(expr)
    return names
from ..column.functions import is_agg
from ..dataframe import ArrayDataFrame, DataFrame, PandasDataFrame
from ..exceptions import FugueSQLRuntimeError, FugueSQLSyntaxError
from ..execution.execution_engine import ExecutionEngine
from .parser import (
    JoinNode,
    LimitNode,
    PlanNode,
    Scan,
    SelectNode,
    SetOpNode,
    SortNode,
    Subquery,
)


def _contains_window(expr: Any) -> bool:
    if isinstance(expr, _WindowExpr):
        return True
    return any(_contains_window(c) for c in getattr(expr, "children", []))


class SQLExecutor:
    def __init__(self, engine: ExecutionEngine, dfs: Dict[str, DataFrame]):
        self._engine = engine
        self._dfs = dict(dfs)

    def run(self, plan: PlanNode) -> DataFrame:
        return self._exec(plan)

    def _exec(self, node: PlanNode) -> DataFrame:
        e = self._engine
        if isinstance(node, Scan):
            if node.name not in self._dfs:
                raise FugueSQLRuntimeError(
                    f"table {node.name!r} not found; available: {sorted(self._dfs)}"
                )
            return self._dfs[node.name]
        if isinstance(node, Subquery):
            return self._exec(node.child)
        if isinstance(node, JoinNode):
            left = self._exec(node.left)
            right = self._exec(node.right)
            if node.condition is None:
                return e.join(left, right, how=node.how, on=node.on or None)
            # non-equi ON: equi-join (or cross product when no equi keys)
            # then filter the residual predicate over the joined output
            if node.how not in ("inner", "cross"):
                raise NotImplementedError(
                    "non-equi join conditions are supported for INNER joins only"
                )
            if len(node.on) > 0:
                res = e.join(left, right, how="inner", on=node.on)
            else:
                res = e.join(left, right, how="cross")
            return e.filter(res, node.condition)
        if isinstance(node, SetOpNode):
            left = self._exec(node.left)
            right = self._exec(node.right)
            if node.op == "union":
                return e.union(left, right, distinct=node.distinct)
            if node.op == "except":
                return e.subtract(left, right, distinct=True)
            return e.intersect(left, right, distinct=True)
        if isinstance(node, SortNode):
            child = node.child
            sort_names = [n for n, _ in node.by]
            extras: List[str] = []
            # standard SQL: ORDER BY may reference source columns that the
            # projection drops — augment the projection, sort, then drop.
            # Expression sorts whose inputs the projection drops compute
            # INSIDE the select scope the same way
            if isinstance(child, SelectNode) and child.child is not None:
                out_names = {
                    c.output_name
                    for c in child.projections
                    if c.output_name not in ("", "*")
                }
                has_wildcard = any(
                    isinstance(c, _NamedColumnExpr) and c.name == "*"
                    for c in child.projections
                )
                missing = [
                    n
                    for n in sort_names
                    if n not in node.exprs
                    and n not in out_names
                    and not has_wildcard
                ]
                alias_names = {
                    c.output_name
                    for c in child.projections
                    if c.output_name not in ("", "*")
                    and not (
                        isinstance(c, _NamedColumnExpr)
                        and c.name == c.output_name
                    )
                }
                missing_exprs = []
                for n in sort_names:
                    if n not in node.exprs or has_wildcard:
                        continue
                    refs = _referenced_names(node.exprs[n])
                    if all(r in out_names for r in refs):
                        continue  # evaluates over the select output later
                    used_aliases = [r for r in refs if r in alias_names]
                    if len(used_aliases) > 0:
                        # pre-projection scope has no aliases; the select
                        # output lacks the dropped source columns — no
                        # scope can evaluate this expression
                        raise FugueSQLSyntaxError(
                            f"ORDER BY expression {n!r} mixes projection "
                            f"aliases {used_aliases} with source columns "
                            "the projection drops"
                        )
                    missing_exprs.append(n)
                if (
                    len(missing) + len(missing_exprs) > 0
                    and len(child.group_by) == 0
                    and not child.distinct
                    and not any(is_agg(c) for c in child.projections)
                ):
                    child = SelectNode(
                        child.child,
                        list(child.projections)
                        + [_col(n) for n in missing]
                        + [node.exprs[n].alias(n) for n in missing_exprs],
                        child.where,
                        child.group_by,
                        child.having,
                        child.distinct,
                    )
                    extras = missing + missing_exprs
            df = self._exec(child)
            local = e.to_df(df).as_local_bounded()
            # ORDER BY <ordinal>: a bare int literal is SQL positional
            # ordering — resolve it against the USER-VISIBLE columns (the
            # augmented frame also carries hidden sort helpers)
            visible = [n for n in local.schema.names if n not in extras]
            for j, (n, asc) in enumerate(list(node.by)):
                ex = node.exprs.get(n)
                if isinstance(ex, _LitColumnExpr):
                    if not isinstance(ex.value, int) or isinstance(ex.value, bool):
                        raise FugueSQLSyntaxError(
                            f"can't ORDER BY the constant {ex.value!r}"
                        )
                    if not (1 <= ex.value <= len(visible)):
                        raise FugueSQLSyntaxError(
                            f"ORDER BY position {ex.value} is out of range "
                            f"(select has {len(visible)} columns)"
                        )
                    sort_names[j] = visible[ex.value - 1]
            # expression sorts not yet materialized evaluate over the
            # RESULT frame (its columns are the select outputs)
            still = [
                n
                for n in sort_names
                if n in node.exprs and n not in local.schema
            ]
            for n in still:
                bad = [
                    r
                    for r in _referenced_names(node.exprs[n])
                    if r not in local.schema
                ]
                if len(bad) > 0:
                    raise FugueSQLSyntaxError(
                        f"ORDER BY expression {n!r} references column(s) "
                        f"{bad} not in the select output "
                        f"{local.schema.names} (aggregated selects can "
                        "only order by projected columns)"
                    )
            if len(still) > 0:
                local = e.to_df(
                    e.assign(local, [node.exprs[n].alias(n) for n in still])
                ).as_local_bounded()
                extras = extras + still
            absent = [n for n in sort_names if n not in local.schema]
            if len(absent) > 0:
                raise FugueSQLSyntaxError(
                    f"ORDER BY column(s) {absent} are not in the select output "
                    f"{local.schema.names} (aggregated selects can only order "
                    "by projected columns)"
                )
            pdf = local.as_pandas().sort_values(
                sort_names,
                ascending=[a for _, a in node.by],
                na_position="first",
            )
            if len(extras) > 0:
                pdf = pdf.drop(columns=extras)
            schema = local.schema - extras if len(extras) > 0 else local.schema
            return e.to_df(
                PandasDataFrame(pdf.reset_index(drop=True), schema)
            )
        if isinstance(node, LimitNode):
            df = self._exec(node.child)
            return e.take(df, node.n, presort="")
        if isinstance(node, SelectNode):
            return self._exec_select(node)
        raise FugueSQLSyntaxError(f"unknown plan node {type(node)}")

    # -- correlated subqueries (decorrelation to joins) ---------------------

    @staticmethod
    def _conjuncts(expr: Optional[ColumnExpr]) -> List[ColumnExpr]:
        from ..column.expressions import _BinaryOpExpr

        if expr is None:
            return []
        if isinstance(expr, _BinaryOpExpr) and expr.op == "&":
            return SQLExecutor._conjuncts(expr.left) + SQLExecutor._conjuncts(
                expr.right
            )
        return [expr]

    @staticmethod
    def _rebuild_and(cs: List[ColumnExpr]) -> Optional[ColumnExpr]:
        from ..column.expressions import _BinaryOpExpr

        cur: Optional[ColumnExpr] = None
        for c in cs:
            cur = c if cur is None else _BinaryOpExpr("&", cur, c)
        return cur

    def _scan_names(self, plan: Optional[PlanNode]) -> set:
        """Table names AND aliases visible in a plan's FROM tree."""
        names: set = set()

        def walk(p: Any) -> None:
            if isinstance(p, Scan):
                names.add(p.name)
                if p.alias:
                    names.add(p.alias)
                return
            if isinstance(p, Subquery):
                # a derived table HIDES its inner tables; only the alias is
                # visible to the enclosing scope
                if p.alias:
                    names.add(p.alias)
                return
            for f in getattr(p, "__dataclass_fields__", {}):
                v = getattr(p, f)
                if isinstance(v, PlanNode):
                    walk(v)

        if plan is not None:
            walk(plan)
        return names

    def _assert_no_foreign_refs(self, plan: PlanNode) -> None:
        """Refuse to run a subplan that references tables outside its own
        FROM tree (a correlated subquery in an unsupported position):
        qualifiers are stripped from column names at parse time, so running
        such a plan would silently bind outer refs to same-named inner
        columns."""
        own = self._scan_names(plan)

        def walk_expr(e: Any) -> None:
            if isinstance(e, _NamedColumnExpr):
                q = getattr(e, "_sql_qualifier", "")
                if q and q not in own:
                    raise NotImplementedError(
                        f"correlated subquery reference {q}.{e.name} is "
                        "only supported as an equality conjunct of a top-"
                        "level WHERE EXISTS / scalar subquery"
                    )
            for c in getattr(e, "children", []):
                walk_expr(c)

        def walk(p: Any) -> None:
            if isinstance(p, SelectNode):
                for c in p.projections:
                    walk_expr(c)
                if p.where is not None:
                    walk_expr(p.where)
                if p.having is not None:
                    walk_expr(p.having)
            if isinstance(p, JoinNode) and p.condition is not None:
                walk_expr(p.condition)
            for f in getattr(p, "__dataclass_fields__", {}):
                v = getattr(p, f)
                if isinstance(v, PlanNode):
                    walk(v)

        walk(plan)

    def _exec_memo(self, plan: PlanNode) -> DataFrame:
        """Execute a subquery's FROM tree once per analysis pass."""
        memo = getattr(self, "_plan_memo", None)
        if memo is None:
            memo = self._plan_memo = {}
        key = id(plan)
        if key not in memo:
            memo[key] = self._exec(plan)
        return memo[key]

    def _refs_outer(
        self, expr: ColumnExpr, ischema: Any, outer_names: set, oschema: Any
    ) -> bool:
        def walk(c: Any) -> bool:
            if isinstance(c, _NamedColumnExpr):
                q = getattr(c, "_sql_qualifier", "")
                if q and q in outer_names:
                    return True
                if not q and c.name not in ischema and c.name in oschema:
                    return True
            return any(walk(x) for x in getattr(c, "children", []))

        return walk(expr)

    def _corr_split(self, plan: PlanNode, outer_names: set, oschema: Any):
        """Analyze a subquery plan for equality correlation against the
        outer select. Returns (inner_df, pairs[(outer,inner)], residual,
        plan) for a correlated shape, "uncorrelated", or None (shape this
        decorrelator doesn't handle → let the generic path error)."""
        from ..column.expressions import _BinaryOpExpr

        if (
            not isinstance(plan, SelectNode)
            or plan.child is None
            or len(plan.group_by) > 0
            or plan.having is not None
            or plan.grouping_sets is not None
        ):
            return None
        inner_names = self._scan_names(plan.child)
        try:
            inner_df = self._exec_memo(plan.child)
        except Exception:
            return None
        ischema = inner_df.schema
        pairs: List[Any] = []
        residual: List[ColumnExpr] = []
        for c in self._conjuncts(plan.where):
            if (
                isinstance(c, _BinaryOpExpr)
                and c.op == "=="
                and isinstance(c.left, _NamedColumnExpr)
                and isinstance(c.right, _NamedColumnExpr)
            ):
                sides = []
                for cc in (c.left, c.right):
                    q = getattr(cc, "_sql_qualifier", "")
                    if q and q in inner_names:
                        sides.append("i")
                    elif q and q in outer_names:
                        sides.append("o")
                    elif cc.name in ischema:
                        sides.append("i")
                    elif cc.name in oschema:
                        sides.append("o")
                    else:
                        sides.append("?")
                if sides == ["i", "o"]:
                    pairs.append((c.right.name, c.left.name))
                    continue
                if sides == ["o", "i"]:
                    pairs.append((c.left.name, c.right.name))
                    continue
            residual.append(c)
        for c in residual:
            if self._refs_outer(c, ischema, outer_names, oschema):
                return None  # non-equality correlation — unsupported
        if len(pairs) == 0:
            return "uncorrelated"
        return inner_df, pairs, self._rebuild_and(residual), plan

    def _decorrelate(self, node: SelectNode, child: DataFrame):
        """Rewrite correlated EXISTS / scalar subqueries into joins against
        ``child``. Returns (node, child), possibly unchanged. Matches the
        capability the reference gets free from its SQL backends
        (``fugue_duckdb/execution_engine.py:95-105``)."""
        import dataclasses

        from ..collections.partition import PartitionSpec
        from ..column.expressions import _UnaryOpExpr
        from .parser import _SubqueryExistsExpr, _SubqueryScalarExpr

        e = self._engine
        outer_names = self._scan_names(node.child)
        oschema = child.schema

        # --- [NOT] EXISTS as top-level WHERE conjuncts → semi/anti join ----
        kept: List[ColumnExpr] = []
        changed = False
        for c in self._conjuncts(node.where):
            positive, core = True, c
            if (
                isinstance(c, _UnaryOpExpr)
                and c.op == "~"
                and isinstance(c.col, _SubqueryExistsExpr)
            ):
                positive, core = False, c.col
            if isinstance(core, _SubqueryExistsExpr):
                cplan = core.plan
                # ORDER BY / LIMIT>=1 can't change EXISTS truth per key
                while isinstance(cplan, SortNode) or (
                    isinstance(cplan, LimitNode) and cplan.n >= 1
                ):
                    cplan = cplan.child
                info = self._corr_split(cplan, outer_names, oschema)
                if info is not None and info != "uncorrelated":
                    inner_df, pairs, residual, _ = info
                    sub = (
                        e.filter(inner_df, residual)
                        if residual is not None
                        else inner_df
                    )
                    sub = e.select(
                        sub,
                        SelectColumns(
                            *[_col(ik).alias(on) for on, ik in pairs],
                            arg_distinct=True,
                        ),
                    )
                    child = e.join(
                        child,
                        sub,
                        how="left_semi" if positive else "left_anti",
                        on=[on for on, _ in pairs],
                    )
                    changed = True
                    continue
                if info is None and self._plan_refs_outer(
                    core.plan, outer_names, oschema
                ):
                    raise NotImplementedError(
                        "only equality-correlated EXISTS subqueries are "
                        "supported"
                    )
            kept.append(c)
        if changed:
            node = dataclasses.replace(node, where=self._rebuild_and(kept))

        # --- correlated scalar subqueries → left join on grouped aggregate -
        replacements: Dict[int, ColumnExpr] = {}
        counter = [0]

        def scan_scalar(expr: Any) -> None:
            nonlocal child
            if isinstance(expr, _SubqueryScalarExpr) and id(expr) not in replacements:
                info = self._corr_split(expr.plan, outer_names, oschema)
                if info is None or info == "uncorrelated":
                    return  # generic substitution (or its error) handles it
                inner_df, pairs, residual, plan = info
                if len(plan.projections) != 1 or not is_agg(plan.projections[0]):
                    raise NotImplementedError(
                        "correlated scalar subqueries must select exactly "
                        "one aggregate"
                    )
                tmp = f"__sq{counter[0]}__"
                counter[0] += 1
                while tmp in oschema:
                    tmp = "_" + tmp
                sub = (
                    e.filter(inner_df, residual)
                    if residual is not None
                    else inner_df
                )
                agg = plan.projections[0].infer_alias().alias(tmp)
                grouped = e.aggregate(
                    sub, PartitionSpec(by=[ik for _, ik in pairs]), [agg]
                )
                renamed = e.select(
                    grouped,
                    SelectColumns(
                        *[_col(ik).alias(on) for on, ik in pairs], _col(tmp)
                    ),
                )
                child = e.join(
                    child, renamed, how="left_outer", on=[on for on, _ in pairs]
                )
                repl: ColumnExpr = _col(tmp)
                inner_agg = plan.projections[0]
                if (
                    getattr(inner_agg, "func", "").upper() == "COUNT"
                ):
                    # COUNT over zero matching rows is 0, not NULL — the
                    # left join produces NULL for unmatched outer rows
                    from ..column import lit as _lit
                    from ..column.functions import coalesce as _coalesce

                    repl = _coalesce(repl, _lit(0))
                replacements[id(expr)] = repl
            for ch in getattr(expr, "children", []):
                scan_scalar(ch)

        for p in node.projections:
            scan_scalar(p)
        if node.where is not None:
            scan_scalar(node.where)
        if replacements:
            if any(
                type(p).__name__ == "_AllColumnsExpr" or p.output_name == "*"
                for p in node.projections
            ):
                raise NotImplementedError(
                    "correlated scalar subqueries with '*' projections are "
                    "not supported"
                )
            node = dataclasses.replace(
                node,
                projections=[
                    self._apply_replacements(p, replacements)
                    for p in node.projections
                ],
                where=(
                    self._apply_replacements(node.where, replacements)
                    if node.where is not None
                    else None
                ),
            )
        return node, child

    def _plan_refs_outer(
        self, plan: Any, outer_names: set, oschema: Any
    ) -> bool:
        """Best-effort: does the subquery reference outer columns at all?"""
        if not isinstance(plan, SelectNode) or plan.child is None:
            return False
        inner_names = self._scan_names(plan.child)
        try:
            ischema = self._exec_memo(plan.child).schema
        except Exception:
            return False
        for c in self._conjuncts(plan.where):
            if self._refs_outer(c, ischema, outer_names - inner_names, oschema):
                return True
        return False

    def _apply_replacements(
        self, expr: ColumnExpr, repl: Dict[int, ColumnExpr]
    ) -> ColumnExpr:
        from .parser import _SubqueryScalarExpr

        if isinstance(expr, _SubqueryScalarExpr) and id(expr) in repl:
            out = repl[id(expr)]
            if expr.as_name:
                out = out.alias(expr.as_name)
            if expr.as_type is not None:
                out = out.cast(expr.as_type)
            return out
        from ..column.expressions import (
            _BinaryOpExpr,
            _CaseWhenExpr,
            _FuncExpr,
            _InExpr,
            _LikeExpr,
            _UnaryOpExpr,
        )

        if isinstance(expr, _BinaryOpExpr):
            l = self._apply_replacements(expr.left, repl)
            r = self._apply_replacements(expr.right, repl)
            if l is expr.left and r is expr.right:
                return expr
            out = _BinaryOpExpr(expr.op, l, r)
        elif isinstance(expr, _InExpr):
            c = self._apply_replacements(expr.col, repl)
            if c is expr.col:
                return expr
            out = _InExpr(c, expr.values, expr.positive)
        elif isinstance(expr, _LikeExpr):
            c = self._apply_replacements(expr.col, repl)
            if c is expr.col:
                return expr
            out = _LikeExpr(c, expr.pattern, expr.positive)
        elif isinstance(expr, _UnaryOpExpr):
            c = self._apply_replacements(expr.col, repl)
            if c is expr.col:
                return expr
            out = _UnaryOpExpr(expr.op, c)
        elif isinstance(expr, _FuncExpr):
            args = [self._apply_replacements(a, repl) for a in expr.args]
            if all(a is b for a, b in zip(args, expr.args)):
                return expr
            out = _FuncExpr(
                expr.func, *args, arg_distinct=expr.is_distinct, is_agg=expr.is_agg
            )
        elif isinstance(expr, _CaseWhenExpr):
            cases = [
                (
                    self._apply_replacements(c, repl),
                    self._apply_replacements(v, repl),
                )
                for c, v in expr.cases
            ]
            default = (
                self._apply_replacements(expr.default, repl)
                if expr.default is not None
                else None
            )
            if default is expr.default and all(
                c is c0 and v is v0
                for (c, v), (c0, v0) in zip(cases, expr.cases)
            ):
                return expr
            out = _CaseWhenExpr(cases, default)
        else:
            return expr
        if expr.as_name:
            out = out.alias(expr.as_name)
        if expr.as_type is not None:
            out = out.cast(expr.as_type)
        return out

    def _decorrelate_safe(self, node: SelectNode, child: DataFrame):
        """Run decorrelation only when subquery expressions are present."""
        from .parser import _SubqueryExistsExpr, _SubqueryScalarExpr

        def has_sub(expr: Any) -> bool:
            if isinstance(expr, (_SubqueryExistsExpr, _SubqueryScalarExpr)):
                return True
            return any(has_sub(c) for c in getattr(expr, "children", []))

        exprs = list(node.projections)
        if node.where is not None:
            exprs.append(node.where)
        if not any(has_sub(x) for x in exprs):
            return node, child
        return self._decorrelate(node, child)

    def _exec_grouping_sets(self, node: SelectNode, child: DataFrame) -> DataFrame:
        """ROLLUP/CUBE/GROUPING SETS = union of per-set grouped aggregates,
        grouped-out key columns NULL (the reference gets these free from
        its SQL backends)."""
        import dataclasses

        from ..column import lit as _lit

        e = self._engine
        all_keys = [
            g.name for g in node.group_by if isinstance(g, _NamedColumnExpr)
        ]
        # WHERE applies identically to every set — filter ONCE, not per set
        if node.where is not None:
            child = e.filter(child, node.where)
            node = dataclasses.replace(node, where=None)
        parts: List[DataFrame] = []
        for s in node.grouping_sets or []:
            proj: List[ColumnExpr] = []
            for c in node.projections:
                base = c
                if (
                    isinstance(base, _NamedColumnExpr)
                    and not is_agg(base)
                    and base.name in all_keys
                    and base.name not in s
                ):
                    tp = child.schema[base.name].type
                    proj.append(
                        _lit(None).cast(tp).alias(base.output_name or base.name)
                    )
                    continue
                if not is_agg(base) and any(
                    n in all_keys and n not in s
                    for n in _referenced_names(base)
                ):
                    raise NotImplementedError(
                        "expressions over grouped-out keys are not supported "
                        "in GROUPING SETS projections"
                    )
                proj.append(base)
            sub_node = dataclasses.replace(
                node,
                projections=proj,
                group_by=[_col(k) for k in s],
                grouping_sets=None,
            )
            if len(s) == 0:
                # global aggregate: no grouping keys — project aggregates
                # (and NULL key stand-ins) over the whole frame
                parts.append(
                    e.select(
                        child,
                        SelectColumns(*[p.infer_alias() for p in proj]),
                        having=sub_node.having,
                    )
                )
                continue
            parts.append(self._exec_select_on(sub_node, child))
        res = parts[0]
        for p in parts[1:]:
            res = e.union(res, p, distinct=False)
        return res

    def _exec_select_on(self, node: SelectNode, child: DataFrame) -> DataFrame:
        """Execute a SelectNode against an ALREADY-materialized child."""
        import uuid

        tmp = f"__gs_{uuid.uuid4().hex[:8]}__"
        self._dfs[tmp] = child
        try:
            import dataclasses

            return self._exec_select(
                dataclasses.replace(node, child=Scan(tmp))
            )
        finally:
            self._dfs.pop(tmp, None)

    def _exec_select(self, node: SelectNode) -> DataFrame:
        e = self._engine
        if node.child is not None:
            # memoized: correlation analysis may already have run this tree
            pre_child = self._exec_memo(node.child)
            node, pre_child = self._decorrelate_safe(node, pre_child)
        else:
            pre_child = None
        node = self._substitute_subqueries(node)
        if node.child is None:
            # SELECT <literals> with no FROM → one constant row
            row: List[Any] = []
            fields = []
            import pyarrow as pa

            for i, c in enumerate(node.projections):
                if not isinstance(c, _LitColumnExpr):
                    raise FugueSQLSyntaxError(
                        "SELECT without FROM supports only literals"
                    )
                name = c.output_name or f"_{i}"
                row.append(c.value)
                tp = c.infer_type(None) or pa.string()
                fields.append(pa.field(name, tp))
            from ..schema import Schema

            return ArrayDataFrame([row], Schema(fields))
        child = pre_child
        # window functions: computed on host after WHERE, before projection
        has_window = any(_contains_window(c) for c in node.projections)
        if has_window:
            return self._exec_windowed_select(node, child)
        if node.grouping_sets is not None:
            return self._exec_grouping_sets(node, child)
        cols = SelectColumns(
            *[c.infer_alias() for c in node.projections], arg_distinct=node.distinct
        )
        if len(node.group_by) > 0 and any(
            not isinstance(g, _NamedColumnExpr) for g in node.group_by
        ):
            # GROUP BY <expression>: materialize each computed key as a
            # helper column, group by its name, and rewrite matching
            # projection/having subexpressions to reference it
            node, child = self._materialize_groupby_exprs(node, child)
            cols = SelectColumns(
                *[c.infer_alias() for c in node.projections],
                arg_distinct=node.distinct,
            )
        if len(node.group_by) > 0:
            gb_names: List[str] = []
            for g in node.group_by:
                if not isinstance(g, _NamedColumnExpr):
                    raise NotImplementedError(
                        "GROUP BY supports plain column references or "
                        "expressions that also appear in the SELECT list"
                    )
                gb_names.append(g.name)
            expanded = cols.replace_wildcard(child.schema).all_cols
            keys_in_proj_source = {
                c.name
                for c in expanded
                if isinstance(c, _NamedColumnExpr) and not is_agg(c)
            }
            proj_keys = {c.output_name for c in expanded if not is_agg(c)}
            having_needs_agg = node.having is not None and not any(
                is_agg(c) for c in expanded
            )
            if having_needs_agg or not (
                set(gb_names) == proj_keys
                or set(gb_names) == keys_in_proj_source
            ):
                # GROUP BY decoupled from the projection: aggregate by the
                # GROUP BY keys, then project/filter over the O(groups)
                # result — also the path for aggregate HAVING over a
                # key-only projection (eval_select can't see those aggs)
                return self._exec_decoupled_groupby(node, child, gb_names)
        return e.select(child, cols, where=node.where, having=node.having)

    def _materialize_groupby_exprs(
        self, node: SelectNode, child: DataFrame
    ) -> Any:
        """GROUP BY over computed expressions (the reference gets this free
        from backend SQL): each non-named key materializes as an assigned
        helper column on the child; identical TOP-LEVEL projections (by
        structural uuid, alias/cast ignored) rewrite to the helper name so
        the grouped evaluator sees plain keys. A grouped expression only
        appearing NESTED inside a projection still raises downstream."""
        import dataclasses

        from ..column.expressions import col as _named_col

        e = self._engine
        from ..column.eval import substitute_exprs
        from ..column.expressions import derived_name as _derived_name
        from ..column.expressions import structural_key as _structural_key

        # the wildcard must expand against the ORIGINAL schema, or the
        # helper columns would leak into SELECT *
        projections = list(
            SelectColumns(
                *[c.infer_alias() for c in node.projections]
            ).replace_wildcard(child.schema).all_cols
        )
        assigns: List[ColumnExpr] = []
        repl: Dict[str, str] = {}
        new_gb: List[ColumnExpr] = []
        for i, g in enumerate(node.group_by):
            if isinstance(g, _NamedColumnExpr):
                new_gb.append(g)
                continue
            # a readable derived name (what SQL backends show for an
            # unaliased grouped expression), not an internal token
            name = _derived_name(g)
            repl[_structural_key(g)] = name
            assigns.append(g.alias(name))
            new_gb.append(_named_col(name))
        child2 = e.assign(child, assigns)
        new_proj = [substitute_exprs(c, repl) for c in projections]
        new_having = None
        if node.having is not None:
            # HAVING evaluates over the AGGREGATED frame, whose columns are
            # the projection OUTPUT names — a grouped expr that is also
            # projected must rewrite to its output alias, not the helper
            having_map = dict(repl)
            for c in projections:
                key = _structural_key(c)
                if key in repl and c.output_name != "":
                    having_map[key] = c.output_name
            new_having = substitute_exprs(node.having, having_map)
        new_node = dataclasses.replace(
            node, projections=new_proj, group_by=new_gb, having=new_having
        )
        return new_node, child2

    def _substitute_subqueries(self, node: SelectNode) -> SelectNode:
        """Evaluate uncorrelated subqueries and substitute their results:
        scalar subqueries become literals, ``IN (SELECT ...)`` becomes a
        plain IN over the subquery's first column. Correlated references
        surface as unknown-table/column errors."""
        import dataclasses

        from ..column.expressions import (
            _BinaryOpExpr,
            _CaseWhenExpr,
            _FuncExpr,
            _InExpr,
            _LikeExpr,
            _LitColumnExpr,
            _UnaryOpExpr,
        )
        from .parser import (
            _SubqueryExistsExpr,
            _SubqueryInExpr,
            _SubqueryScalarExpr,
        )

        found = [False]

        def _run(plan: PlanNode) -> pd.DataFrame:
            # a subplan referencing tables outside its own FROM is a
            # correlated subquery in a position the decorrelator doesn't
            # cover — running it would silently bind outer refs to inner
            # columns, so refuse loudly instead
            self._assert_no_foreign_refs(plan)
            ex = SQLExecutor(self._engine, self._dfs)
            # share FROM-tree materializations with the correlation
            # analysis (it may already have executed this subquery's child)
            ex._plan_memo = getattr(self, "_plan_memo", {})
            return ex.run(plan).as_pandas()

        def sub(e: Any) -> Any:
            if e is None:
                return None
            if isinstance(e, _SubqueryScalarExpr):
                found[0] = True
                res = _run(e.plan)
                if len(res.columns) != 1 or len(res) > 1:
                    raise FugueSQLRuntimeError(
                        "scalar subquery must return one column and at most "
                        f"one row; got {res.shape}"
                    )
                v = None if len(res) == 0 else res.iloc[0, 0]
                v = None if pd.isna(v) else (v.item() if hasattr(v, "item") else v)
                out: Any = _LitColumnExpr(v)
            elif isinstance(e, _SubqueryExistsExpr):
                found[0] = True
                plan = e.plan
                # ORDER BY never matters to EXISTS; LIMIT n>=1 doesn't
                # either (LIMIT 0 makes it constant-false)
                limit0 = False
                while isinstance(plan, (SortNode, LimitNode)):
                    if isinstance(plan, LimitNode) and plan.n <= 0:
                        limit0 = True
                    plan = plan.child
                if (
                    isinstance(plan, SelectNode)
                    and plan.child is not None
                    and len(plan.group_by) == 0
                    and plan.grouping_sets is None
                ):
                    # the projection is irrelevant to EXISTS (often a bare
                    # unnamed literal) — count rows, don't shape them.
                    # Grouped / FROM-less subqueries keep their projections
                    # (a '*' would be invalid there).
                    import dataclasses as _dc

                    plan = _dc.replace(
                        plan, projections=[_col("*")], distinct=False
                    )
                elif isinstance(plan, SelectNode) and plan.child is None:
                    import dataclasses as _dc

                    plan = _dc.replace(
                        plan,
                        projections=[
                            p if p.output_name else p.alias(f"_e{i}")
                            for i, p in enumerate(plan.projections)
                        ],
                    )
                exists = (not limit0) and len(_run(plan)) > 0
                out = _LitColumnExpr(exists == e.positive)
            elif isinstance(e, _SubqueryInExpr):
                found[0] = True
                res = _run(e.plan)
                if len(res.columns) != 1:
                    raise FugueSQLRuntimeError(
                        "IN subquery must return exactly one column"
                    )
                col_res = res.iloc[:, 0]
                has_null = bool(col_res.isna().any())
                vals = [
                    x.item() if hasattr(x, "item") else x
                    for x in col_res.dropna().tolist()
                ]
                if has_null:
                    # SQL three-valued logic: a NULL in the IN-set means a
                    # non-matching row compares NULL, never TRUE/FALSE —
                    #   x IN (..., NULL)     → TRUE on match, else NULL
                    #   x NOT IN (..., NULL) → FALSE on match, else NULL
                    match = _InExpr(sub(e.col), vals, True)
                    out = _CaseWhenExpr(
                        [(match, _LitColumnExpr(e.positive))],
                        _LitColumnExpr(None),
                    )
                else:
                    out = _InExpr(sub(e.col), vals, e.positive)
            elif isinstance(e, _BinaryOpExpr):
                l, r = sub(e.left), sub(e.right)
                if l is e.left and r is e.right:
                    return e  # unchanged — keep subclass identity/aliases
                out = _BinaryOpExpr(e.op, l, r)
            elif isinstance(e, _UnaryOpExpr):
                c = sub(e.col)
                if c is e.col:
                    return e
                out = _UnaryOpExpr(e.op, c)
            elif isinstance(e, _FuncExpr):
                args = [sub(a) for a in e.args]
                if all(a is b for a, b in zip(args, e.args)):
                    return e
                out = _FuncExpr(
                    e.func, *args, arg_distinct=e.is_distinct, is_agg=e.is_agg
                )
            elif isinstance(e, _InExpr):
                c = sub(e.col)
                if c is e.col:
                    return e
                out = _InExpr(c, e.values, e.positive)
            elif isinstance(e, _LikeExpr):
                c = sub(e.col)
                if c is e.col:
                    return e
                out = _LikeExpr(c, e.pattern, e.positive)
            elif isinstance(e, _CaseWhenExpr):
                cases = [(sub(c), sub(v)) for c, v in e.cases]
                default = sub(e.default)
                if default is e.default and all(
                    c is c0 and v is v0
                    for (c, v), (c0, v0) in zip(cases, e.cases)
                ):
                    return e
                out = _CaseWhenExpr(cases, default)
            else:
                return e
            if e.as_name != "":
                out = out.alias(e.as_name)
            if e.as_type is not None:
                out = out.cast(e.as_type)
            return out

        new_projections = [sub(c) for c in node.projections]
        new_where = sub(node.where)
        new_having = sub(node.having)
        if not found[0]:
            return node
        return dataclasses.replace(
            node,
            projections=new_projections,
            where=new_where,
            having=new_having,
        )

    def _exec_decoupled_groupby(
        self, node: SelectNode, child: DataFrame, gb_names: List[str]
    ) -> DataFrame:
        """``SELECT <exprs over keys + aggs> ... GROUP BY k1,...`` where the
        key set differs from the plain projection columns (keys may be
        dropped, transformed, or a superset). Two phases: an engine
        aggregate by the GROUP BY keys, then a host-side projection over
        the aggregated frame with aggregate subtrees reading their
        computed columns."""
        from ..collections.partition import PartitionSpec
        from ..column.expressions import (
            _BinaryOpExpr,
            _FuncExpr,
            _UnaryOpExpr,
        )

        e = self._engine
        if node.where is not None:
            child = e.filter(child, node.where)
        agg_map: Dict[str, str] = {}
        agg_list: List[ColumnExpr] = []

        def extract(expr: ColumnExpr) -> ColumnExpr:
            if isinstance(expr, _FuncExpr) and expr.is_agg:
                bare = expr.alias("").cast(None)
                key = bare.__uuid__()
                if key not in agg_map:
                    name = f"__agg_{len(agg_map)}__"
                    agg_map[key] = name
                    agg_list.append(bare.alias(name))
                ref: ColumnExpr = _col(agg_map[key])
                if expr.as_type is not None:
                    ref = ref.cast(expr.as_type)
                if expr.as_name != "":
                    ref = ref.alias(expr.as_name)
                return ref
            if isinstance(expr, _BinaryOpExpr):
                res: ColumnExpr = _BinaryOpExpr(
                    expr.op, extract(expr.left), extract(expr.right)
                )
            elif isinstance(expr, _UnaryOpExpr):
                res = _UnaryOpExpr(expr.op, extract(expr.col))
            elif isinstance(expr, _FuncExpr) and not expr.is_agg:
                res = _FuncExpr(
                    expr.func,
                    *[extract(a) for a in expr.args],
                    arg_distinct=expr.is_distinct,
                )
            else:
                names = _referenced_names(expr)
                bad = [n for n in names if n not in gb_names]
                if len(bad) > 0:
                    raise FugueSQLSyntaxError(
                        f"column(s) {bad} must appear in GROUP BY or inside "
                        "an aggregate function"
                    )
                return expr
            if expr.as_name != "":
                res = res.alias(expr.as_name)
            if expr.as_type is not None:
                res = res.cast(expr.as_type)
            return res

        finals = [extract(c.infer_alias()) for c in node.projections]
        having = extract(node.having) if node.having is not None else None
        if len(agg_list) > 0:
            grouped = e.aggregate(child, PartitionSpec(by=gb_names), agg_list)
        else:  # pure grouping (key superset, no aggregates) = distinct keys
            grouped = e.select(
                child,
                SelectColumns(*[_col(k) for k in gb_names], arg_distinct=True),
            )
        if having is not None:
            grouped = e.filter(grouped, having)
        return e.select(
            grouped, SelectColumns(*finals, arg_distinct=node.distinct)
        )

    def _try_device_windowed_select(
        self, node: "SelectNode", child: DataFrame
    ) -> Optional[DataFrame]:
        """The device plan of a windowed SELECT (``torch/window.py``): the
        WHERE as the device filter, every OVER column in one pass, the
        projection through the engine's column IR; the frame never goes to
        the host. None, before any device work, where the plan declines:
        another engine, or a shape the plan does not cover."""
        from ..torch.execution_engine import TorchExecutionEngine
        from ..torch.window import plan_device_windows, run_device_windows

        e = self._engine
        if not isinstance(e, TorchExecutionEngine):
            return None
        items: List[Any] = []
        projections: List[Any] = []
        for i, c in enumerate(node.projections):
            if isinstance(c, _WindowExpr):
                items.append((f"__w{i}__", c))
                sub = _col(f"__w{i}__").alias(c.output_name or f"_w{i}")
                if c.as_type is not None:
                    sub = sub.cast(c.as_type)
                projections.append(sub)
            elif _contains_window(c):
                return None  # nested windows keep the host error path
            else:
                projections.append(c)
        tdf = e.to_df(child)
        # gate BEFORE the WHERE filter: a query the plan declines pays for
        # no device work that the host path would redo
        names = [n for c in projections for n in _referenced_names(c)]
        plan = plan_device_windows(tdf, items, tdf.schema.names if "*" in names else names)
        if plan is None:
            return None
        with record_function("fugue::window_device"):
            if node.where is not None:
                tdf = e.filter(tdf, node.where)
            work = run_device_windows(e, tdf, plan)
            cols = SelectColumns(
                *[c.infer_alias() for c in projections], arg_distinct=node.distinct
            )
            return e.select(work, cols)

    def _exec_windowed_select(self, node: SelectNode, child: DataFrame) -> DataFrame:
        """SQL evaluation order: WHERE → window → projection → DISTINCT."""
        import pyarrow as pa

        from ..column.eval import eval_filter
        from ..column.window import eval_window
        from ..schema import Schema

        e = self._engine
        if len(node.group_by) > 0 or node.having is not None:
            raise NotImplementedError(
                "window functions can't be combined with GROUP BY/HAVING yet"
            )
        device = self._try_device_windowed_select(node, child)
        if device is not None:
            return device
        with record_function("fugue::window_host"):
            local = e.to_df(child).as_local_bounded()
            pdf = local.as_pandas()
            if node.where is not None:
                pdf = eval_filter(pdf, node.where)
            schema = local.schema
            projections: List[Any] = []
            extra_fields: List[Any] = []
            for i, c in enumerate(node.projections):
                # only top-level windows are supported
                if isinstance(c, _WindowExpr):
                    series = eval_window(pdf, c)
                    pdf = pdf.assign(**{f"__w{i}__": series})
                    tp = c.infer_type(schema)
                    extra_fields.append(
                        pa.field(f"__w{i}__", tp if tp is not None else pa.float64())
                    )
                    sub = _col(f"__w{i}__").alias(c.output_name or f"_w{i}")
                    if c.as_type is not None:
                        sub = sub.cast(c.as_type)
                    projections.append(sub)
                elif _contains_window(c):
                    raise NotImplementedError(
                        "window functions nested inside expressions are not supported"
                    )
                else:
                    projections.append(c)
            work_schema = Schema(list(schema.fields) + extra_fields)
            work = PandasDataFrame(pdf, work_schema)
            cols = SelectColumns(
                *[c.infer_alias() for c in projections], arg_distinct=node.distinct
            )
            return e.select(work, cols)
