"""SQL text as table-reference and literal segments, copied from
``fugue_tpu/collections/sql.py``: ``StructuredRawSQL`` keeps a statement
as ``(is_table_ref, text)`` pieces so an engine can put its own table
names in, and ``TempTableName`` is a unique reference to embed in raw SQL.

``transpile_sql`` is the JAX package's plugin without the registry: text
passes through when the two dialects are the same or either is unset, and
goes through ``sql/dialect.py`` ``transpile`` when both are registered
dialects (``fugue_tpu/sql/dialect.py`` :562-577)."""

import uuid
from typing import Any, Iterable, List, Optional, Tuple

from .._utils.hash import to_uuid


class TempTableName:
    """A unique, safely-named temp table reference embeddable in raw SQL."""

    def __init__(self):
        self.key = "_" + str(uuid.uuid4())[:5]

    @property
    def ref(self) -> str:
        return f"<tmpdf:{self.key}>"

    def __repr__(self) -> str:
        return self.ref


def transpile_sql(raw: str, from_dialect: Optional[str], to_dialect: Optional[str]) -> str:
    """``raw`` in ``to_dialect``: as it is when the dialects agree, either
    is None or either is not a registered dialect."""
    from ..sql.dialect import DIALECTS, transpile

    if (
        from_dialect is None
        or to_dialect is None
        or from_dialect == to_dialect
        or from_dialect.lower() not in DIALECTS
        or to_dialect.lower() not in DIALECTS
    ):
        return raw
    return transpile(raw, from_dialect, to_dialect)


class StructuredRawSQL:
    """An immutable sequence of ``(is_table_ref, text)`` SQL segments."""

    def __init__(self, statements: Iterable[Tuple[bool, str]], dialect: Optional[str] = None):
        self._statements = list(statements)
        self._dialect = dialect

    @property
    def dialect(self) -> Optional[str]:
        return self._dialect

    def __iter__(self):
        return iter(self._statements)

    def construct(self, name_map: Any = None, dialect: Optional[str] = None, log: Any = None) -> str:
        """The SQL, table references mapped through ``name_map`` (a dict or
        a callable), in ``dialect`` (see :func:`transpile_sql`)."""

        def _map(name: str) -> str:
            if name_map is None:
                return name
            if callable(name_map):
                return name_map(name)
            return name_map.get(name, name)

        raw = " ".join(_map(t) if is_ref else t for is_ref, t in self._statements)
        return transpile_sql(raw, self._dialect, dialect)

    @staticmethod
    def from_expr(
        sql: str, prefix: str = "<tmpdf:", suffix: str = ">", dialect: Optional[str] = None
    ) -> "StructuredRawSQL":
        """Parse raw text containing ``<tmpdf:key>`` markers into segments."""
        statements: List[Tuple[bool, str]] = []
        pos = 0
        while True:
            start = sql.find(prefix, pos)
            if start < 0:
                if pos < len(sql):
                    statements.append((False, sql[pos:]))
                break
            end = sql.find(suffix, start)
            if end < 0:
                statements.append((False, sql[pos:]))
                break
            if start > pos:
                statements.append((False, sql[pos:start]))
            statements.append((True, sql[start + len(prefix) : end]))
            pos = end + len(suffix)
        return StructuredRawSQL(statements, dialect=dialect)

    def __uuid__(self) -> str:
        return to_uuid(self._dialect, self._statements)
