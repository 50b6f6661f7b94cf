"""Column expression IR, copied from ``fugue_tpu/column/expressions.py``
and trimmed to what an aggregate needs: named columns, literals and
function calls, with ``alias``, ``output_name`` and ``infer_type``.
Operators, casts, CASE/IN/LIKE and windows are not ported yet."""

from typing import Any, List, Optional, Union

import pyarrow as pa

from .._utils.assertion import assert_or_throw
from .._utils.hash import to_uuid
from ..schema import Schema


class ColumnExpr:
    """Base of the expression tree."""

    def __init__(self):
        self._as_name = ""

    @property
    def name(self) -> str:
        return ""

    @property
    def as_name(self) -> str:
        return self._as_name

    @property
    def output_name(self) -> str:
        return self._as_name if self._as_name != "" else self.name

    def alias(self, as_name: str) -> "ColumnExpr":
        import copy

        res = copy.copy(self)
        res._as_name = as_name
        return res

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        return None

    @property
    def children(self) -> List["ColumnExpr"]:
        return []

    def __uuid__(self) -> str:
        return to_uuid(
            type(self).__name__,
            self._as_name,
            self._uuid_keys(),
            [c.__uuid__() for c in self.children],
        )

    def _uuid_keys(self) -> List[Any]:
        return []

    def __hash__(self) -> int:
        return hash(self.__uuid__())


def _to_col(obj: Any) -> ColumnExpr:
    if isinstance(obj, ColumnExpr):
        return obj
    return lit(obj)


class _NamedColumnExpr(ColumnExpr):
    def __init__(self, name: str):
        super().__init__()
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    @property
    def wildcard(self) -> bool:
        return self._name == "*"

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self.wildcard:
            return None
        return schema[self._name].type if self._name in schema else None

    def __repr__(self) -> str:
        return self._name if self.as_name == "" else f"{self._name} AS {self.as_name}"

    def _uuid_keys(self) -> List[Any]:
        return [self._name]


class _LitColumnExpr(ColumnExpr):
    def __init__(self, value: Any):
        super().__init__()
        assert_or_throw(
            value is None or isinstance(value, (int, float, bool, str, bytes)),
            lambda: NotImplementedError(f"unsupported literal {value!r}"),
        )
        self._value = value

    @property
    def value(self) -> Any:
        return self._value

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self._value is None:
            return None
        if isinstance(self._value, bool):
            return pa.bool_()
        if isinstance(self._value, int):
            return pa.int64()
        if isinstance(self._value, float):
            return pa.float64()
        if isinstance(self._value, str):
            return pa.string()
        return pa.binary()

    def __repr__(self) -> str:
        v = f"'{self._value}'" if isinstance(self._value, str) else repr(self._value)
        return v if self.as_name == "" else f"{v} AS {self.as_name}"

    def _uuid_keys(self) -> List[Any]:
        return [repr(self._value)]


class _FuncExpr(ColumnExpr):
    def __init__(
        self,
        func: str,
        *args: Any,
        arg_distinct: bool = False,
        is_agg: bool = False,
    ):
        super().__init__()
        self._func = func
        self._args = [_to_col(a) for a in args]
        self._is_distinct = arg_distinct
        self._is_agg = is_agg

    @property
    def func(self) -> str:
        return self._func

    @property
    def is_distinct(self) -> bool:
        return self._is_distinct

    @property
    def is_agg(self) -> bool:
        return self._is_agg

    @property
    def args(self) -> List[ColumnExpr]:
        return self._args

    @property
    def children(self) -> List[ColumnExpr]:
        return self._args

    def __repr__(self) -> str:
        inner = ",".join(repr(a) for a in self._args)
        d = "DISTINCT " if self._is_distinct else ""
        s = f"{self._func}({d}{inner})"
        return s if self.as_name == "" else f"{s} AS {self.as_name}"

    def _uuid_keys(self) -> List[Any]:
        return [self._func, self._is_distinct, self._is_agg]


def col(obj: Union[str, ColumnExpr], alias: str = "") -> ColumnExpr:
    """Reference a column by name (``"*"`` is the wildcard)."""
    if isinstance(obj, ColumnExpr):
        return obj.alias(alias) if alias != "" else obj
    res: ColumnExpr = _NamedColumnExpr(obj)
    return res.alias(alias) if alias != "" else res


def lit(obj: Any, alias: str = "") -> ColumnExpr:
    res: ColumnExpr = _LitColumnExpr(obj)
    return res.alias(alias) if alias != "" else res


def function(name: str, *args: Any, arg_distinct: bool = False) -> ColumnExpr:
    return _FuncExpr(name, *args, arg_distinct=arg_distinct)
