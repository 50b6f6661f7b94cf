"""SELECT-column validation and SQL text from the expression IR, copied
from ``fugue_tpu/column/sql.py``: ``SelectColumns`` (:28-155, the
aggregate and group-key rules, the wildcard rules, unique output names,
``replace_wildcard`` and ``infer_schema``) and ``SQLExpressionGenerator``
(:157-304, the IR rendered as SQL text with casts, literals and
aggregates), which the warehouse engine (``fugue_tpu_torch/warehouse``)
subclasses to cast into its storage classes."""

from typing import Callable, Dict, List, Optional

import pyarrow as pa

from .._utils.assertion import assert_or_throw
from .._utils.hash import to_uuid
from ..exceptions import FugueSQLError
from ..schema import Schema
from .expressions import (
    ColumnExpr,
    _BinaryOpExpr,
    _FuncExpr,
    _LitColumnExpr,
    _NamedColumnExpr,
    _UnaryOpExpr,
)
from .functions import is_agg


class SelectColumns:
    """A validated set of select expressions."""

    def __init__(self, *cols: ColumnExpr, arg_distinct: bool = False):
        self._distinct = arg_distinct
        self._cols = [c.infer_alias() for c in cols]
        assert_or_throw(len(self._cols) > 0, FugueSQLError("select can't be empty"))
        self._wildcards = [
            c for c in self._cols
            if isinstance(c, _NamedColumnExpr) and c.wildcard
        ]
        assert_or_throw(
            len(self._wildcards) <= 1,
            FugueSQLError("at most one wildcard is allowed"),
        )
        names = [c.output_name for c in self._cols if c.output_name != "" and c.output_name != "*"]
        assert_or_throw(
            len(names) == len(set(names)),
            lambda: FugueSQLError(f"duplicated output names in {names}"),
        )
        self._agg_funcs = [c for c in self._cols if is_agg(c)]
        self._non_agg = [
            c for c in self._cols if not is_agg(c) and not (
                isinstance(c, _NamedColumnExpr) and c.wildcard
            )
        ]
        self._literals = [c for c in self._cols if isinstance(c, _LitColumnExpr)]
        if self.has_agg:
            assert_or_throw(
                len(self._wildcards) == 0,
                FugueSQLError("wildcard can't be used together with aggregation"),
            )

    @property
    def is_distinct(self) -> bool:
        return self._distinct

    @property
    def all_cols(self) -> List[ColumnExpr]:
        return self._cols

    @property
    def has_agg(self) -> bool:
        return len(self._agg_funcs) > 0

    @property
    def has_literals(self) -> bool:
        return len(self._literals) > 0

    @property
    def has_wildcard(self) -> bool:
        return len(self._wildcards) > 0

    @property
    def simple(self) -> bool:
        return all(
            isinstance(c, _NamedColumnExpr) and c.as_type is None for c in self._cols
        )

    @property
    def simple_cols(self) -> List[ColumnExpr]:
        return [c for c in self._cols if isinstance(c, _NamedColumnExpr)]

    @property
    def agg_funcs(self) -> List[ColumnExpr]:
        return self._agg_funcs

    @property
    def non_agg_funcs(self) -> List[ColumnExpr]:
        return [
            c for c in self._non_agg
            if not isinstance(c, (_NamedColumnExpr, _LitColumnExpr))
        ]

    @property
    def group_keys(self) -> List[ColumnExpr]:
        """Non-agg, non-literal columns — the implicit GROUP BY keys."""
        return [c for c in self._non_agg if not isinstance(c, _LitColumnExpr)]

    def assert_all_with_names(self) -> "SelectColumns":
        for c in self._cols:
            if isinstance(c, _NamedColumnExpr) and c.wildcard:
                continue
            assert_or_throw(
                c.output_name != "",
                lambda: FugueSQLError(f"{c!r} has no output name"),
            )
        return self

    def assert_no_wildcard(self) -> "SelectColumns":
        assert_or_throw(not self.has_wildcard, FugueSQLError("wildcard not allowed"))
        return self

    def assert_no_agg(self) -> "SelectColumns":
        assert_or_throw(not self.has_agg, FugueSQLError("aggregation not allowed"))
        return self

    def replace_wildcard(self, schema: Schema) -> "SelectColumns":
        """Expand ``*`` into explicit column references."""
        if not self.has_wildcard:
            return self
        explicit = {
            c.output_name for c in self._cols if c.output_name not in ("", "*")
        }
        cols: List[ColumnExpr] = []
        for c in self._cols:
            if isinstance(c, _NamedColumnExpr) and c.wildcard:
                from .expressions import col as _col

                cols.extend(_col(n) for n in schema.names if n not in explicit)
            else:
                cols.append(c)
        return SelectColumns(*cols, arg_distinct=self._distinct)

    def infer_schema(self, schema: Schema) -> Optional[Schema]:
        """Best-effort output schema; None when any type can't be inferred."""
        sc = self.replace_wildcard(schema)
        fields = []
        for c in sc.all_cols:
            tp = c.infer_type(schema)
            if tp is None or c.output_name == "":
                return None
            fields.append(pa.field(c.output_name, tp))
        return Schema(fields)

    def __uuid__(self) -> str:
        return to_uuid(self._distinct, [c.__uuid__() for c in self._cols])


class SQLExpressionGenerator:
    """Render the expression IR to SQL text.

    ``enable_cast`` controls whether ``cast`` nodes render as SQL CAST
    (engines that post-cast set it False).
    """

    def __init__(self, enable_cast: bool = True):
        self._enable_cast = enable_cast
        self._func_handlers: Dict[str, Callable[[_FuncExpr], str]] = {}

    def add_func_handler(
        self, name: str, handler: Callable[["_FuncExpr"], str]
    ) -> "SQLExpressionGenerator":
        self._func_handlers[name.upper()] = handler
        return self

    def type_to_sql_type(self, tp: pa.DataType) -> str:
        if pa.types.is_int8(tp):
            return "TINYINT"
        if pa.types.is_int16(tp):
            return "SMALLINT"
        if pa.types.is_int32(tp):
            return "INT"
        if pa.types.is_integer(tp):
            return "BIGINT"
        if pa.types.is_float32(tp):
            return "FLOAT"
        if pa.types.is_floating(tp):
            return "DOUBLE"
        if pa.types.is_boolean(tp):
            return "BOOLEAN"
        if pa.types.is_string(tp):
            return "VARCHAR"
        if pa.types.is_binary(tp):
            return "BINARY"
        if pa.types.is_date(tp):
            return "DATE"
        if pa.types.is_timestamp(tp):
            return "TIMESTAMP"
        raise NotImplementedError(f"can't convert {tp} to SQL type")

    def generate(self, expr: ColumnExpr) -> str:
        body = self._gen(expr)
        if self._enable_cast and expr.as_type is not None:
            body = f"CAST({body} AS {self.type_to_sql_type(expr.as_type)})"
        if expr.as_name != "":
            return f"{body} AS {expr.as_name}"
        return body

    def generate_no_alias(self, expr: ColumnExpr) -> str:
        body = self._gen(expr)
        if self._enable_cast and expr.as_type is not None:
            body = f"CAST({body} AS {self.type_to_sql_type(expr.as_type)})"
        return body

    def _gen(self, expr: ColumnExpr) -> str:
        if isinstance(expr, _NamedColumnExpr):
            return expr.name
        if isinstance(expr, _LitColumnExpr):
            v = expr.value
            if v is None:
                return "NULL"
            if isinstance(v, bool):
                return "TRUE" if v else "FALSE"
            if isinstance(v, str):
                escaped = v.replace("'", "''")
                return f"'{escaped}'"
            return repr(v)
        if isinstance(expr, _UnaryOpExpr):
            inner = self._wrap(expr.col)
            if expr.op == "IS_NULL":
                return f"{inner} IS NULL"
            if expr.op == "NOT_NULL":
                return f"{inner} IS NOT NULL"
            if expr.op == "~":
                return f"NOT {inner}"
            if expr.op == "-":
                return f"-{inner}"
            raise NotImplementedError(f"unary op {expr.op}")
        if isinstance(expr, _BinaryOpExpr):
            op_map = {"&": "AND", "|": "OR", "==": "=", "!=": "<>"}
            op = op_map.get(expr.op, expr.op)
            return f"{self._wrap(expr.left)} {op} {self._wrap(expr.right)}"
        if isinstance(expr, _FuncExpr):
            h = self._func_handlers.get(expr.func.upper())
            if h is not None:
                return h(expr)
            d = "DISTINCT " if expr.is_distinct else ""
            args = ",".join(self._gen_with_cast(a) for a in expr.args)
            return f"{expr.func}({d}{args})"
        raise NotImplementedError(f"can't generate SQL for {type(expr)}")

    def _gen_with_cast(self, expr: ColumnExpr) -> str:
        body = self._gen(expr)
        if self._enable_cast and expr.as_type is not None:
            body = f"CAST({body} AS {self.type_to_sql_type(expr.as_type)})"
        return body

    def _wrap(self, expr: ColumnExpr) -> str:
        s = self._gen_with_cast(expr)
        if isinstance(expr, (_BinaryOpExpr,)):
            return f"({s})"
        return s

    def where(self, condition: ColumnExpr, table: str) -> str:
        assert_or_throw(
            not is_agg(condition),
            FugueSQLError("where condition can't contain aggregation"),
        )
        return f"SELECT * FROM {table} WHERE {self.generate_no_alias(condition)}"

    def select(
        self,
        columns: SelectColumns,
        table: str,
        where: Optional[ColumnExpr] = None,
        having: Optional[ColumnExpr] = None,
    ) -> str:
        columns.assert_all_with_names()
        distinct = "DISTINCT " if columns.is_distinct else ""
        proj = ", ".join(self.generate(c) for c in columns.all_cols)
        sql = f"SELECT {distinct}{proj} FROM {table}"
        if where is not None:
            sql += f" WHERE {self.generate_no_alias(where)}"
        if columns.has_agg and len(columns.group_keys) > 0:
            keys = ", ".join(self.generate_no_alias(k) for k in columns.group_keys)
            sql += f" GROUP BY {keys}"
        if having is not None:
            assert_or_throw(
                columns.has_agg, FugueSQLError("having requires aggregation")
            )
            sql += f" HAVING {self.generate_no_alias(having)}"
        return sql

    def correct_select_schema(
        self, input_schema: Schema, select: SelectColumns, output_schema: Schema
    ) -> Optional[Schema]:
        """Compute the cast-diff between what SQL produced and what the
        expressions declare; None when nothing to correct."""
        expected = select.replace_wildcard(input_schema).infer_schema(input_schema)
        if expected is None:
            return None
        diff = [
            f for f in expected.fields
            if f.name in output_schema and output_schema[f.name].type != f.type
        ]
        return Schema(diff) if len(diff) > 0 else None
