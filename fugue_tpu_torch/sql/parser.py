"""The SQL tokenizer and SELECT parser, copied from
``fugue_tpu/sql/parser.py``: SQL parses into a logical plan (``Scan``,
``Subquery``, ``JoinNode``, ``SetOpNode``, ``SortNode``, ``LimitNode``,
``SelectNode``) over the column-expression IR (``fugue_tpu_torch/column``),
which ``executor.py`` runs through the engine's verbs.

Grammar (a Spark-like subset)::

    query     := select (UNION [ALL] | EXCEPT | INTERSECT) select ...
    select    := SELECT [DISTINCT] proj (, proj)*
                 [FROM source (join)*] [WHERE expr]
                 [GROUP BY expr (, expr)* | ROLLUP | CUBE | GROUPING SETS]
                 [HAVING expr] [ORDER BY expr [ASC|DESC] (, ...)*] [LIMIT n]
    source    := ident [AS alias] | ( query ) [AS alias]
    join      := [INNER|LEFT|RIGHT|FULL|CROSS|SEMI|ANTI] JOIN source
                 [ON cond | USING (names)]
    proj      := expr [AS name] | * | ident.*
    expr      := standard precedence with CASE WHEN, CAST, IN, LIKE,
                 BETWEEN, IS [NOT] NULL, functions, literals, subqueries
                 and func(...) OVER (...)

The tokenizer is the JAX package's Python one; its C++ twin
(``fugue_tpu/native``) is not ported and gives the same tokens."""

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..column import ColumnExpr, col, function, lit
from ..column.expressions import (
    derived_name,
    _BinaryOpExpr,
    _CaseWhenExpr,
    _InExpr,
    _LikeExpr,
    _NamedColumnExpr,
    _UnaryOpExpr,
)
from ..exceptions import FugueSQLSyntaxError
from ..schema import to_pa_datatype

_AGG_FUNCS = {"SUM", "COUNT", "AVG", "MEAN", "MIN", "MAX", "FIRST", "LAST"}

_KEYWORD_STOP = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "UNION", "EXCEPT",
    "INTERSECT", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "ON",
    "AS", "ASC", "DESC", "BY", "AND", "OR", "NOT", "IN", "IS", "NULL",
    "BETWEEN", "LIKE", "CASE", "WHEN", "THEN", "ELSE", "END", "DISTINCT",
    "ALL", "SEMI", "ANTI", "OUTER", "USING",
}


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------


class Token:
    """One SQL token. kinds: IDENT QIDENT STRING NUMBER OP PUNCT EOF."""

    __slots__ = ("kind", "value", "pos", "_upper")

    def __init__(self, kind: str, value: str, pos: int):
        self.kind = kind
        self.value = value
        self.pos = pos
        self._upper: Optional[str] = None

    @property
    def upper(self) -> str:
        if self._upper is None:
            self._upper = self.value.upper()
        return self._upper

    def __repr__(self) -> str:
        return f"Token({self.kind},{self.value!r},{self.pos})"


def tokenize(sql: str) -> List[Token]:
    """The tokens of ``sql``, the last one ``EOF``."""
    return _tokenize_py(sql)


def _tokenize_py(sql: str) -> List[Token]:
    tokens: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # line comment
            while i < n and sql[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":  # block comment
            j = sql.find("*/", i + 2)
            i = n if j < 0 else j + 2
            continue
        if c == "'" or c == '"':
            quote = c
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == quote:
                    if j + 1 < n and sql[j + 1] == quote:  # escaped quote
                        buf.append(quote)
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            if j >= n:
                raise FugueSQLSyntaxError(f"unterminated string at {i}")
            tokens.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if c == "`":
            j = sql.find("`", i + 1)
            if j < 0:
                raise FugueSQLSyntaxError(f"unterminated identifier at {i}")
            tokens.append(Token("QIDENT", sql[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (sql[j].isdigit() or (sql[j] == "." and not seen_dot)):
                if sql[j] == ".":
                    seen_dot = True
                j += 1
            if j < n and sql[j] in "eE":
                # only consume the exponent when a digit follows the optional
                # sign — '1e' / '2e+' must tokenize as NUMBER+IDENT, matching
                # the native tokenizer's backtracking
                k = j + 1
                if k < n and sql[k] in "+-":
                    k += 1
                if k < n and sql[k].isdigit():
                    while k < n and sql[k].isdigit():
                        k += 1
                    j = k
                    seen_dot = True
            tokens.append(Token("NUMBER", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            tokens.append(Token("IDENT", sql[i:j], i))
            i = j
            continue
        for op in ("<>", "<=", ">=", "!=", "=="):
            if sql.startswith(op, i):
                tokens.append(Token("OP", op, i))
                i += len(op)
                break
        else:
            if c in "+-*/%<>=":
                tokens.append(Token("OP", c, i))
                i += 1
            elif c in "(),.;[]{}:?":
                tokens.append(Token("PUNCT", c, i))
                i += 1
            elif c == "<":
                tokens.append(Token("OP", c, i))
                i += 1
            else:
                raise FugueSQLSyntaxError(f"unexpected character {c!r} at {i}")
    tokens.append(Token("EOF", "", n))
    return tokens


# ---------------------------------------------------------------------------
# logical plan
# ---------------------------------------------------------------------------


@dataclass
class PlanNode:
    pass


@dataclass
class Scan(PlanNode):
    name: str
    alias: str = ""


def _source_names(p: "PlanNode") -> set:
    """Visible table names/aliases of a FROM source (derived tables hide
    their inner scans — only the alias shows)."""
    out: set = set()
    if isinstance(p, Scan):
        out.add(p.name)
        if p.alias:
            out.add(p.alias)
    elif isinstance(p, Subquery):
        if p.alias:
            out.add(p.alias)
    elif isinstance(p, JoinNode):
        out |= _source_names(p.left)
        out |= _source_names(p.right)
    return out


@dataclass
class Subquery(PlanNode):
    child: PlanNode
    alias: str = ""


@dataclass
class JoinNode(PlanNode):
    left: PlanNode
    right: PlanNode
    how: str
    on: List[str] = field(default_factory=list)
    # residual (non-equi) ON predicate, applied over the joined output
    condition: Optional[ColumnExpr] = None


class _SubqueryScalarExpr(ColumnExpr):
    """``(SELECT ...)`` used as a scalar value inside an expression.

    The executor evaluates the (uncorrelated) subplan and substitutes the
    single-cell result as a literal before the outer select runs.
    """

    def __init__(self, plan: "PlanNode"):
        super().__init__()
        self.plan = plan

    def _uuid_keys(self) -> List[Any]:
        return ["subquery_scalar", repr(self.plan)]

    def __repr__(self) -> str:
        return f"(SELECT ...{type(self.plan).__name__})"


class _SubqueryExistsExpr(ColumnExpr):
    """``[NOT] EXISTS (SELECT ...)``.

    Uncorrelated: substituted as a boolean literal. Correlated by equality
    (``inner.k = outer.k`` conjuncts): decorrelated into a device semi/anti
    join when the EXISTS is a top-level WHERE conjunct.
    """

    def __init__(self, plan: "PlanNode", positive: bool = True):
        super().__init__()
        self.plan = plan
        self.positive = positive

    def _uuid_keys(self) -> List[Any]:
        return ["subquery_exists", self.positive, repr(self.plan)]

    def __repr__(self) -> str:
        return f"EXISTS (SELECT ...{type(self.plan).__name__})"


class _SubqueryInExpr(ColumnExpr):
    """``expr [NOT] IN (SELECT ...)`` — the executor evaluates the subplan
    and substitutes a plain IN over its first column's values."""

    def __init__(self, expr: Any, plan: "PlanNode", positive: bool = True):
        super().__init__()
        self.col = expr
        self.plan = plan
        self.positive = positive

    @property
    def children(self) -> List[ColumnExpr]:
        return [self.col]

    def _uuid_keys(self) -> List[Any]:
        return ["subquery_in", self.positive, repr(self.plan)]

    def __repr__(self) -> str:
        return f"{self.col!r} IN (SELECT ...)"


@dataclass
class SelectNode(PlanNode):
    child: Optional[PlanNode]
    projections: List[ColumnExpr]
    where: Optional[ColumnExpr] = None
    group_by: List[ColumnExpr] = field(default_factory=list)
    having: Optional[ColumnExpr] = None
    distinct: bool = False
    # GROUP BY ROLLUP/CUBE/GROUPING SETS: each entry is one key subset;
    # group_by holds the union of all keys
    grouping_sets: Optional[List[List[str]]] = None


@dataclass
class SetOpNode(PlanNode):
    op: str  # union | except | intersect
    left: PlanNode
    right: PlanNode
    distinct: bool = True


@dataclass
class SortNode(PlanNode):
    child: PlanNode
    by: List[Tuple[str, bool]]
    # ORDER BY <expression>: generated sort names -> their expressions
    # (materialized as helper columns at execution, dropped after the sort)
    exprs: Dict[str, ColumnExpr] = field(default_factory=dict)


@dataclass
class LimitNode(PlanNode):
    child: PlanNode
    n: int


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


class SQLParser:
    def __init__(self, sql: str):
        self._tokens = tokenize(sql)
        self._i = 0

    # -- token helpers -----------------------------------------------------
    def peek(self, offset: int = 0) -> Token:
        return self._tokens[min(self._i + offset, len(self._tokens) - 1)]

    def next(self) -> Token:
        t = self.peek()
        self._i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "IDENT" and t.upper in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            t = self.peek()
            raise FugueSQLSyntaxError(f"expected {kw}, got {t.value!r} at {t.pos}")

    def at_punct(self, p: str) -> bool:
        t = self.peek()
        return t.kind == "PUNCT" and t.value == p

    def eat_punct(self, p: str) -> bool:
        if self.at_punct(p):
            self.next()
            return True
        return False

    def expect_punct(self, p: str) -> None:
        if not self.eat_punct(p):
            t = self.peek()
            raise FugueSQLSyntaxError(f"expected {p!r}, got {t.value!r} at {t.pos}")

    # -- entry -------------------------------------------------------------
    def parse_query(self) -> PlanNode:
        plan = self._parse_query_body()
        # trailing ORDER BY / LIMIT apply to the whole set expression
        plan = self._maybe_order_limit(plan)
        return plan

    def parse_full(self) -> PlanNode:
        plan = self.parse_query()
        self.eat_punct(";")
        if self.peek().kind != "EOF":
            t = self.peek()
            raise FugueSQLSyntaxError(f"unexpected {t.value!r} at {t.pos}")
        return plan

    def _parse_query_body(self) -> PlanNode:
        left = self._parse_select()
        while True:
            if self.at_kw("UNION"):
                self.next()
                distinct = not self.eat_kw("ALL")
                self.eat_kw("DISTINCT")
                right = self._parse_select()
                left = SetOpNode("union", left, right, distinct)
            elif self.at_kw("EXCEPT"):
                self.next()
                self.eat_kw("DISTINCT")
                right = self._parse_select()
                left = SetOpNode("except", left, right, True)
            elif self.at_kw("INTERSECT"):
                self.next()
                self.eat_kw("DISTINCT")
                right = self._parse_select()
                left = SetOpNode("intersect", left, right, True)
            else:
                return left

    def _maybe_order_limit(self, plan: PlanNode) -> PlanNode:
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            by: List[Tuple[str, bool]] = []
            exprs: Dict[str, ColumnExpr] = {}
            while True:
                item = self._parse_expr()
                if (
                    isinstance(item, _NamedColumnExpr)
                    and item.as_name == ""
                    and item.as_type is None
                    and item.name != "*"
                ):
                    name = item.name
                else:
                    # ORDER BY <expression>: name it by its readable
                    # derived form (cast KEPT — CAST(x AS t) must not
                    # collide with plain x); bare int literals resolve as
                    # SQL positional ordering in the executor
                    name = derived_name(item)
                    exprs[name] = item
                asc = True
                if self.eat_kw("DESC"):
                    asc = False
                else:
                    self.eat_kw("ASC")
                by.append((name, asc))
                if not self.eat_punct(","):
                    break
            plan = SortNode(plan, by, exprs)
        if self.at_kw("LIMIT"):
            self.next()
            t = self.next()
            if t.kind != "NUMBER":
                raise FugueSQLSyntaxError(f"expected number after LIMIT at {t.pos}")
            plan = LimitNode(plan, int(t.value))
        return plan

    def _parse_select(self) -> PlanNode:
        if self.eat_punct("("):
            inner = self._parse_query_body()
            inner = self._maybe_order_limit(inner)
            self.expect_punct(")")
            return inner
        self.expect_kw("SELECT")
        distinct = self.eat_kw("DISTINCT")
        projections: List[ColumnExpr] = []
        while True:
            projections.append(self._parse_projection())
            if not self.eat_punct(","):
                break
        child: Optional[PlanNode] = None
        if self.eat_kw("FROM"):
            child = self._parse_source()
            while True:
                how = self._peek_join_type()
                if how is None:
                    break
                right = self._parse_source()
                on: List[str] = []
                residual: Optional[ColumnExpr] = None
                if self.eat_kw("ON"):
                    on, residual = self._parse_on_condition(
                        _source_names(child) | _source_names(right)
                    )
                elif self.eat_kw("USING"):
                    self.expect_punct("(")
                    while True:
                        on.append(self._parse_name())
                        if not self.eat_punct(","):
                            break
                    self.expect_punct(")")
                child = JoinNode(child, right, how, on, residual)
        where = None
        if self.eat_kw("WHERE"):
            where = self._parse_expr()
        group_by: List[ColumnExpr] = []
        grouping_sets: Optional[List[List[str]]] = None
        if self.at_kw("GROUP"):
            self.next()
            self.expect_kw("BY")
            if self.at_kw("ROLLUP") or self.at_kw("CUBE"):
                kind = self.next().upper
                keys = self._parse_name_list_parens()
                if kind == "ROLLUP":
                    grouping_sets = [keys[:i] for i in range(len(keys), -1, -1)]
                else:  # CUBE: every subset, preserving key order
                    grouping_sets = [
                        [k for j, k in enumerate(keys) if mask & (1 << j)]
                        for mask in range((1 << len(keys)) - 1, -1, -1)
                    ]
                group_by = [col(k) for k in keys]
            elif self.at_kw("GROUPING") and self.peek(1).upper == "SETS":
                self.next()
                self.next()
                self.expect_punct("(")
                grouping_sets = []
                while True:
                    grouping_sets.append(self._parse_name_list_parens())
                    if not self.eat_punct(","):
                        break
                self.expect_punct(")")
                seen: List[str] = []
                for s in grouping_sets:
                    for k in s:
                        if k not in seen:
                            seen.append(k)
                group_by = [col(k) for k in seen]
            else:
                while True:
                    group_by.append(self._parse_expr())
                    if not self.eat_punct(","):
                        break
        having = None
        if self.eat_kw("HAVING"):
            having = self._parse_expr()
        node: PlanNode = SelectNode(
            child, projections, where, group_by, having, distinct,
            grouping_sets=grouping_sets,
        )
        return self._maybe_order_limit(node)

    def _parse_name_list_parens(self) -> List[str]:
        """``( name, name, ... )`` — also accepts the empty ``()`` set."""
        self.expect_punct("(")
        names: List[str] = []
        if not self.at_punct(")"):
            while True:
                names.append(self._parse_qualified_name())
                if not self.eat_punct(","):
                    break
        self.expect_punct(")")
        return names

    def _peek_join_type(self) -> Optional[str]:
        if self.at_kw("JOIN"):
            self.next()
            return "inner"
        for kw, how in (
            ("INNER", "inner"),
            ("CROSS", "cross"),
            ("SEMI", "semi"),
            ("ANTI", "anti"),
        ):
            if self.at_kw(kw) and self.peek(1).upper == "JOIN":
                self.next()
                self.next()
                return how
        for kw, how in (
            ("LEFT", "left_outer"),
            ("RIGHT", "right_outer"),
            ("FULL", "full_outer"),
        ):
            if self.at_kw(kw):
                nxt = self.peek(1).upper
                if nxt == "JOIN":
                    self.next(); self.next()
                    return how
                if nxt == "OUTER" and self.peek(2).upper == "JOIN":
                    self.next(); self.next(); self.next()
                    return how
                if nxt in ("SEMI", "ANTI") and self.peek(2).upper == "JOIN":
                    how2 = "semi" if nxt == "SEMI" else "anti"
                    self.next(); self.next(); self.next()
                    return how2
        return None

    def _parse_source(self) -> PlanNode:
        if self.eat_punct("("):
            inner = self._parse_query_body()
            inner = self._maybe_order_limit(inner)
            self.expect_punct(")")
            alias = ""
            if self.eat_kw("AS"):
                alias = self._parse_name()
            elif self.peek().kind in ("IDENT", "QIDENT") and not self._at_clause_kw():
                alias = self._parse_name()
            return Subquery(inner, alias)
        name = self._parse_name()
        alias = ""
        if self.eat_kw("AS"):
            alias = self._parse_name()
        elif self.peek().kind in ("IDENT", "QIDENT") and not self._at_clause_kw():
            alias = self._parse_name()
        return Scan(name, alias)

    def _at_clause_kw(self) -> bool:
        t = self.peek()
        return t.kind == "IDENT" and t.upper in _KEYWORD_STOP

    def _parse_on_condition(self, local_names: Any = None) -> Any:
        """Parse a general ON predicate and split it into equi-join keys
        (``a.k = b.k`` on a shared name) and a residual (non-equi)
        condition evaluated over the joined output.

        ``local_names``: table names/aliases of the two joined sources —
        a qualifier outside this set is a correlated outer reference the
        join can't bind, and silently treating it as an equi key would
        join the wrong columns; refuse loudly instead.
        """
        from ..column.expressions import _BinaryOpExpr, _NamedColumnExpr

        cond = self._parse_expr()
        conjuncts: List[ColumnExpr] = []

        def split(e: ColumnExpr) -> None:
            if isinstance(e, _BinaryOpExpr) and e.op == "&":
                split(e.left)
                split(e.right)
            else:
                conjuncts.append(e)

        split(cond)

        def _foreign(c: _NamedColumnExpr) -> bool:
            q = getattr(c, "_sql_qualifier", "")
            return bool(q) and local_names is not None and q not in local_names

        keys: List[str] = []
        residual: Optional[ColumnExpr] = None
        for c in conjuncts:
            if (
                isinstance(c, _BinaryOpExpr)
                and c.op == "=="
                and isinstance(c.left, _NamedColumnExpr)
                and isinstance(c.right, _NamedColumnExpr)
            ):
                if _foreign(c.left) or _foreign(c.right):
                    raise FugueSQLSyntaxError(
                        "JOIN ON references a table outside the join "
                        "(correlated ON conditions are not supported)"
                    )
                if c.left.name == c.right.name:  # qualifiers stripped
                    keys.append(c.left.name)
                    continue
            residual = c if residual is None else (residual & c)
        return keys, residual

    def _parse_name(self) -> str:
        t = self.next()
        if t.kind not in ("IDENT", "QIDENT"):
            raise FugueSQLSyntaxError(f"expected name, got {t.value!r} at {t.pos}")
        return t.value

    def _parse_qualified_name(self) -> str:
        name = self._parse_name()
        while self.at_punct("."):
            self.next()
            name = self._parse_name()  # keep last segment (unqualified)
        return name

    def _parse_projection(self) -> ColumnExpr:
        t = self.peek()
        if t.kind == "OP" and t.value == "*":
            self.next()
            return col("*")
        if (
            t.kind in ("IDENT", "QIDENT")
            and self.peek(1).value == "."
            and self.peek(2).value == "*"
        ):
            self.next(); self.next(); self.next()
            return col("*")
        e = self._parse_expr()
        if self.eat_kw("AS"):
            e = e.alias(self._parse_name())
        elif self.peek().kind in ("IDENT", "QIDENT") and not self._at_clause_kw():
            e = e.alias(self._parse_name())
        return e

    # -- expressions --------------------------------------------------------
    def _parse_expr(self) -> ColumnExpr:
        return self._parse_or()

    def _parse_or(self) -> ColumnExpr:
        left = self._parse_and()
        while self.eat_kw("OR"):
            left = _BinaryOpExpr("|", left, self._parse_and())
        return left

    def _parse_and(self) -> ColumnExpr:
        left = self._parse_not()
        while self.eat_kw("AND"):
            left = _BinaryOpExpr("&", left, self._parse_not())
        return left

    def _parse_not(self) -> ColumnExpr:
        if self.eat_kw("NOT"):
            return _UnaryOpExpr("~", self._parse_not())
        return self._parse_predicate()

    def _parse_predicate(self) -> ColumnExpr:
        left = self._parse_additive()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.value in ("=", "==", "!=", "<>", "<", "<=", ">", ">="):
                self.next()
                op = {"=": "==", "<>": "!="}.get(t.value, t.value)
                left = _BinaryOpExpr(op, left, self._parse_additive())
                continue
            if self.at_kw("IS"):
                self.next()
                negate = self.eat_kw("NOT")
                self.expect_kw("NULL")
                left = _UnaryOpExpr("NOT_NULL" if negate else "IS_NULL", left)
                continue
            if self.at_kw("IN") or (self.at_kw("NOT") and self.peek(1).upper == "IN"):
                positive = not self.eat_kw("NOT")
                self.expect_kw("IN")
                self.expect_punct("(")
                if self.at_kw("SELECT"):
                    plan = self._parse_query_body()
                    plan = self._maybe_order_limit(plan)
                    self.expect_punct(")")
                    left = _SubqueryInExpr(left, plan, positive)
                    continue
                values: List[Any] = []
                while True:
                    values.append(self._parse_literal_value())
                    if not self.eat_punct(","):
                        break
                self.expect_punct(")")
                left = _InExpr(left, values, positive)
                continue
            if self.at_kw("BETWEEN") or (
                self.at_kw("NOT") and self.peek(1).upper == "BETWEEN"
            ):
                positive = not self.eat_kw("NOT")
                self.expect_kw("BETWEEN")
                lo = self._parse_additive()
                self.expect_kw("AND")
                hi = self._parse_additive()
                rng = _BinaryOpExpr("&", left >= lo, left <= hi)
                left = rng if positive else _UnaryOpExpr("~", rng)
                continue
            if self.at_kw("LIKE") or (self.at_kw("NOT") and self.peek(1).upper == "LIKE"):
                positive = not self.eat_kw("NOT")
                self.expect_kw("LIKE")
                p = self.next()
                if p.kind != "STRING":
                    raise FugueSQLSyntaxError(f"LIKE pattern must be a string at {p.pos}")
                left = _LikeExpr(left, p.value, positive)
                continue
            return left

    def _parse_additive(self) -> ColumnExpr:
        left = self._parse_mult()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.value in ("+", "-"):
                self.next()
                left = _BinaryOpExpr(t.value, left, self._parse_mult())
            else:
                return left

    def _parse_mult(self) -> ColumnExpr:
        left = self._parse_unary()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.value in ("*", "/", "%"):
                if t.value == "*" and self._looks_like_projection_star():
                    return left
                self.next()
                if t.value == "%":
                    left = function("MOD", left, self._parse_unary())
                else:
                    left = _BinaryOpExpr(t.value, left, self._parse_unary())
            else:
                return left

    def _looks_like_projection_star(self) -> bool:
        nxt = self.peek(1)
        return nxt.kind == "PUNCT" and nxt.value in (",",) or (
            nxt.kind == "IDENT" and nxt.upper == "FROM"
        )

    def _parse_unary(self) -> ColumnExpr:
        t = self.peek()
        if t.kind == "OP" and t.value == "-":
            self.next()
            return _UnaryOpExpr("-", self._parse_unary())
        if t.kind == "OP" and t.value == "+":
            self.next()
            return self._parse_unary()
        return self._parse_primary()

    def _parse_literal_value(self) -> Any:
        t = self.next()
        if t.kind == "STRING":
            return t.value
        if t.kind == "NUMBER":
            return float(t.value) if "." in t.value or "e" in t.value.lower() else int(t.value)
        if t.kind == "IDENT" and t.upper == "NULL":
            return None
        if t.kind == "IDENT" and t.upper in ("TRUE", "FALSE"):
            return t.upper == "TRUE"
        if t.kind == "OP" and t.value == "-":
            v = self._parse_literal_value()
            return -v
        raise FugueSQLSyntaxError(f"expected literal, got {t.value!r} at {t.pos}")

    def _parse_primary(self) -> ColumnExpr:
        t = self.peek()
        if t.kind == "STRING":
            self.next()
            return lit(t.value)
        if t.kind == "NUMBER":
            self.next()
            v = float(t.value) if "." in t.value or "e" in t.value.lower() else int(t.value)
            return lit(v)
        if t.kind == "PUNCT" and t.value == "(":
            self.next()
            if self.at_kw("SELECT"):  # scalar subquery
                plan = self._parse_query_body()
                plan = self._maybe_order_limit(plan)
                self.expect_punct(")")
                return _SubqueryScalarExpr(plan)
            e = self._parse_expr()
            self.expect_punct(")")
            return e
        if t.kind == "QIDENT":
            self.next()
            return col(t.value)
        if t.kind == "IDENT":
            up = t.upper
            if up == "NULL":
                self.next()
                return lit(None)
            if up in ("TRUE", "FALSE"):
                self.next()
                return lit(up == "TRUE")
            if up == "CASE":
                return self._parse_case()
            if up == "EXISTS" and self.peek(1).value == "(":
                self.next()
                self.expect_punct("(")
                plan = self._parse_query_body()
                plan = self._maybe_order_limit(plan)
                self.expect_punct(")")
                return _SubqueryExistsExpr(plan, True)
            if up == "CAST":
                self.next()
                self.expect_punct("(")
                e = self._parse_expr()
                self.expect_kw("AS")
                tp = self._parse_type_name()
                self.expect_punct(")")
                return e.cast(tp)
            if self.peek(1).value == "(":  # function call
                self.next()
                self.next()
                distinct = self.eat_kw("DISTINCT")
                args: List[ColumnExpr] = []
                if not self.at_punct(")"):
                    while True:
                        a = self.peek()
                        if a.kind == "OP" and a.value == "*":
                            self.next()
                            args.append(lit(1))  # COUNT(*)
                        else:
                            args.append(self._parse_expr())
                        if not self.eat_punct(","):
                            break
                self.expect_punct(")")
                if self.at_kw("OVER"):
                    if distinct:
                        raise FugueSQLSyntaxError(
                            "DISTINCT is not supported in window functions"
                        )
                    return self._parse_over(up, args)
                return self._make_func(up, args, distinct)
            # plain or qualified column ref — the qualifier is kept as
            # side-band metadata (correlated-subquery analysis needs it;
            # everything else sees the bare name)
            self.next()
            name = t.value
            qual = ""
            while self.at_punct(".") and self.peek(1).kind in ("IDENT", "QIDENT"):
                self.next()
                qual = name
                name = self._parse_name()
            c = col(name)
            if qual:
                c._sql_qualifier = qual  # type: ignore[attr-defined]
            return c
        raise FugueSQLSyntaxError(f"unexpected token {t.value!r} at {t.pos}")

    def _parse_type_name(self) -> Any:
        name = self._parse_name().lower()
        # SQL type names → schema expression types
        mapping = {
            "integer": "int",
            "bigint": "long",
            "smallint": "short",
            "tinyint": "byte",
            "varchar": "str",
            "text": "str",
            "string": "str",
            "real": "float",
            "boolean": "bool",
            "timestamp": "datetime",
        }
        base = mapping.get(name, name)
        if self.eat_punct("("):  # e.g. VARCHAR(10), DECIMAL(10,2)
            args = []
            while not self.at_punct(")"):
                args.append(self.next().value)
                self.eat_punct(",")
            self.expect_punct(")")
            if base == "decimal":
                return f"decimal({','.join(args)})"
        return to_pa_datatype(base)

    def _parse_case(self) -> ColumnExpr:
        self.expect_kw("CASE")
        cases: List[Tuple[ColumnExpr, ColumnExpr]] = []
        base: Optional[ColumnExpr] = None
        if not self.at_kw("WHEN"):
            base = self._parse_expr()
        while self.eat_kw("WHEN"):
            cond = self._parse_expr()
            if base is not None:
                cond = _BinaryOpExpr("==", base, cond)
            self.expect_kw("THEN")
            val = self._parse_expr()
            cases.append((cond, val))
        default = None
        if self.eat_kw("ELSE"):
            default = self._parse_expr()
        self.expect_kw("END")
        return _CaseWhenExpr(cases, default)

    def _parse_over(self, func: str, args: List[ColumnExpr]) -> ColumnExpr:
        from ..column.expressions import _WindowExpr

        self.expect_kw("OVER")
        self.expect_punct("(")
        partition_by: List[str] = []
        order_by: List[Any] = []
        if self.at_kw("PARTITION"):
            self.next()
            self.expect_kw("BY")
            while True:
                partition_by.append(self._parse_qualified_name())
                if not self.eat_punct(","):
                    break
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            while True:
                name = self._parse_qualified_name()
                asc = True
                if self.eat_kw("DESC"):
                    asc = False
                else:
                    self.eat_kw("ASC")
                order_by.append((name, asc))
                if not self.eat_punct(","):
                    break
        frame = None
        if self.at_kw("ROWS") or self.at_kw("RANGE"):
            kind = self.next().value.lower()
            if self.eat_kw("BETWEEN"):
                start = self._parse_frame_bound()
                self.expect_kw("AND")
                end = self._parse_frame_bound()
            else:
                start = self._parse_frame_bound()
                end = "current"
            if start == "unb_foll" or end == "unb_prec":
                raise FugueSQLSyntaxError(
                    "invalid window frame: the start bound cannot be "
                    "UNBOUNDED FOLLOWING and the end bound cannot be "
                    "UNBOUNDED PRECEDING"
                )
            if kind == "rows" and any(
                isinstance(b, tuple) and not isinstance(b[1], int)
                for b in (start, end)
            ):
                raise FugueSQLSyntaxError(
                    "ROWS frame offsets must be integers"
                )
            frame = (kind, start, end)
        self.expect_punct(")")
        return _WindowExpr(func, args, partition_by, order_by, frame=frame)

    def _parse_frame_bound(self) -> Any:
        if self.eat_kw("UNBOUNDED"):
            if self.eat_kw("PRECEDING"):
                return "unb_prec"
            self.expect_kw("FOLLOWING")
            return "unb_foll"
        if self.eat_kw("CURRENT"):
            self.expect_kw("ROW")
            return "current"
        t = self.next()
        if t.kind != "NUMBER":
            raise FugueSQLSyntaxError(f"invalid frame bound {t.value!r}")
        # RANGE offsets are value distances and may be fractional; keep the
        # exact number (ROWS validates integrality where the frame is built)
        v = float(t.value)
        n: Any = int(v) if v.is_integer() else v
        if self.eat_kw("PRECEDING"):
            return ("prec", n)
        self.expect_kw("FOLLOWING")
        return ("foll", n)

    def _make_func(self, name: str, args: List[ColumnExpr], distinct: bool) -> ColumnExpr:
        if name in _AGG_FUNCS:
            from ..column.functions import _SameTypeUnaryAggFuncExpr, _UnaryAggFuncExpr

            a = args[0] if len(args) > 0 else lit(1)
            fn = {"MEAN": "AVG"}.get(name, name)
            if fn in ("SUM", "COUNT", "AVG"):
                return _UnaryAggFuncExpr(fn, a, arg_distinct=distinct)
            return _SameTypeUnaryAggFuncExpr(fn, a, arg_distinct=distinct)
        return function(name, *args, arg_distinct=distinct)


def parse_select(sql: str) -> PlanNode:
    return SQLParser(sql).parse_full()
