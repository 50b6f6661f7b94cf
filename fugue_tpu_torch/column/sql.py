"""SELECT-column validation, copied from ``fugue_tpu/column/sql.py``
(``SelectColumns`` :28-155): the aggregate and group-key rules, the
wildcard rules, unique output names, ``replace_wildcard`` and
``infer_schema``. ``SQLExpressionGenerator`` (the IR rendered as SQL
text) serves the JAX package's warehouse engine (``fugue_tpu/warehouse``),
which the port does not have (ROADMAP.md A.10)."""

from typing import List, Optional

import pyarrow as pa

from .._utils.assertion import assert_or_throw
from .._utils.hash import to_uuid
from ..exceptions import FugueSQLError
from ..schema import Schema
from .expressions import ColumnExpr, _LitColumnExpr, _NamedColumnExpr
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
