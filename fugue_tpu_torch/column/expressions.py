"""Column expression IR, copied from ``fugue_tpu/column/expressions.py``:
``col``/``lit``/``null``/``all_cols``/``function`` build an expression tree
with operators (``+ - * /``, comparisons, ``& | ~``, unary ``-``,
``is_null``/``not_null``), ``alias`` and ``cast``; ``case_when``,
``_InExpr`` and ``_LikeExpr``. One tree is evaluated on the host by
``column/eval.py`` (pandas) and on the device by ``column/torch_eval.py``.
``_WindowExpr`` (``func(args) OVER (...)``) is built by the SQL parser and
evaluated by the windowed SELECT (``torch/window.py`` on the device,
``column/window.py`` on the host)."""

from typing import Any, Iterable, List, Optional, Union

import pyarrow as pa

from .._utils.assertion import assert_or_throw
from .._utils.hash import to_uuid
from ..schema import Schema, to_pa_datatype


class ColumnExpr:
    """Base of the expression tree."""

    def __init__(self):
        self._as_name = ""
        self._as_type: Optional[pa.DataType] = None

    @property
    def name(self) -> str:
        return ""

    @property
    def as_name(self) -> str:
        return self._as_name

    @property
    def as_type(self) -> Optional[pa.DataType]:
        return self._as_type

    @property
    def output_name(self) -> str:
        return self._as_name if self._as_name != "" else self.name

    def alias(self, as_name: str) -> "ColumnExpr":
        res = self._copy()
        res._as_name = as_name
        res._as_type = self._as_type
        return res

    def cast(self, data_type: Any) -> "ColumnExpr":
        res = self._copy()
        res._as_name = self._as_name
        res._as_type = None if data_type is None else to_pa_datatype(data_type)
        return res

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        return self._as_type

    def infer_alias(self) -> "ColumnExpr":
        return self

    @property
    def children(self) -> List["ColumnExpr"]:
        return []

    def _copy(self) -> "ColumnExpr":
        import copy

        return copy.copy(self)

    # -- operators ---------------------------------------------------------
    def __add__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("+", self, other)

    def __radd__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("+", other, self)

    def __sub__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("-", self, other)

    def __rsub__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("-", other, self)

    def __mul__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("*", self, other)

    def __rmul__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("*", other, self)

    def __truediv__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("/", self, other)

    def __rtruediv__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("/", other, self)

    def __lt__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("<", self, other)

    def __le__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("<=", self, other)

    def __gt__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr(">", self, other)

    def __ge__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr(">=", self, other)

    def __eq__(self, other: Any) -> "ColumnExpr":  # type: ignore
        return _BinaryOpExpr("==", self, other)

    def __ne__(self, other: Any) -> "ColumnExpr":  # type: ignore
        return _BinaryOpExpr("!=", self, other)

    def __and__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("&", self, other)

    def __rand__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("&", other, self)

    def __or__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("|", self, other)

    def __ror__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("|", other, self)

    def __invert__(self) -> "ColumnExpr":
        return _UnaryOpExpr("~", self)

    def __neg__(self) -> "ColumnExpr":
        return _UnaryOpExpr("-", self)

    def is_null(self) -> "ColumnExpr":
        return _UnaryOpExpr("IS_NULL", self)

    def not_null(self) -> "ColumnExpr":
        return _UnaryOpExpr("NOT_NULL", self)

    def __uuid__(self) -> str:
        return to_uuid(
            type(self).__name__,
            self._as_name,
            str(self._as_type),
            self._uuid_keys(),
            [c.__uuid__() for c in self.children],
        )

    def _uuid_keys(self) -> List[Any]:
        return []

    def __hash__(self) -> int:
        return hash(self.__uuid__())

    def __bool__(self) -> bool:
        raise TypeError("ColumnExpr has no truth value; use & | ~ for logic")


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
        if self.as_type is not None:
            return self.as_type
        if self.wildcard:
            return None
        return schema[self._name].type if self._name in schema else None

    def __repr__(self) -> str:
        return self._name if self.as_name == "" else f"{self._name} AS {self.as_name}"

    def _uuid_keys(self) -> List[Any]:
        return [self._name]


class _LitColumnExpr(ColumnExpr):
    def __init__(self, value: Any):
        import datetime as _dt

        super().__init__()
        assert_or_throw(
            value is None
            or isinstance(
                value, (int, float, bool, str, bytes, _dt.date, _dt.datetime)
            ),
            lambda: NotImplementedError(f"unsupported literal {value!r}"),
        )
        self._value = value

    @property
    def value(self) -> Any:
        return self._value

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        import datetime as _dt

        if self.as_type is not None:
            return self.as_type
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
        if isinstance(self._value, _dt.datetime):
            return pa.timestamp("us")
        if isinstance(self._value, _dt.date):
            return pa.date32()
        return pa.binary()

    def __repr__(self) -> str:
        v = f"'{self._value}'" if isinstance(self._value, str) else repr(self._value)
        return v if self.as_name == "" else f"{v} AS {self.as_name}"

    def _uuid_keys(self) -> List[Any]:
        return [repr(self._value)]


class _UnaryOpExpr(ColumnExpr):
    def __init__(self, op: str, expr: ColumnExpr):
        super().__init__()
        self._op = op
        self._expr = _to_col(expr)

    @property
    def op(self) -> str:
        return self._op

    @property
    def col(self) -> ColumnExpr:
        return self._expr

    @property
    def name(self) -> str:
        return self._expr.name

    @property
    def children(self) -> List[ColumnExpr]:
        return [self._expr]

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self.as_type is not None:
            return self.as_type
        if self._op in ("IS_NULL", "NOT_NULL", "~"):
            return pa.bool_()
        if self._op == "-":
            return self._expr.infer_type(schema)
        return None

    def __repr__(self) -> str:
        s = f"{self._op}({self._expr!r})"
        return s if self.as_name == "" else f"{s} AS {self.as_name}"

    def _uuid_keys(self) -> List[Any]:
        return [self._op]


class _BinaryOpExpr(ColumnExpr):
    def __init__(self, op: str, left: Any, right: Any):
        super().__init__()
        self._op = op
        self._left = _to_col(left)
        self._right = _to_col(right)

    @property
    def op(self) -> str:
        return self._op

    @property
    def left(self) -> ColumnExpr:
        return self._left

    @property
    def right(self) -> ColumnExpr:
        return self._right

    @property
    def children(self) -> List[ColumnExpr]:
        return [self._left, self._right]

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self.as_type is not None:
            return self.as_type
        if self._op in ("<", "<=", ">", ">=", "==", "!=", "&", "|"):
            return pa.bool_()
        lt = self._left.infer_type(schema)
        rt = self._right.infer_type(schema)
        if lt is None or rt is None:
            return None
        if self._op == "/":
            return pa.float64()
        if lt == rt:
            return lt
        if pa.types.is_floating(lt) or pa.types.is_floating(rt):
            return pa.float64()
        if pa.types.is_integer(lt) and pa.types.is_integer(rt):
            return pa.int64()
        return None

    def __repr__(self) -> str:
        s = f"({self._left!r} {self._op} {self._right!r})"
        return s if self.as_name == "" else f"{s} AS {self.as_name}"

    def _uuid_keys(self) -> List[Any]:
        return [self._op]


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

    def infer_alias(self) -> ColumnExpr:
        # agg functions over a single named column default to that name
        if self.as_name == "" and len(self._args) == 1 and self._args[0].name != "":
            return self.alias(self._args[0].name)
        return self

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


def null() -> ColumnExpr:
    return lit(None)


def all_cols() -> ColumnExpr:
    return col("*")


def function(name: str, *args: Any, arg_distinct: bool = False, **kwargs: Any) -> ColumnExpr:
    return _FuncExpr(name, *args, arg_distinct=arg_distinct)


class _CaseWhenExpr(ColumnExpr):
    """CASE WHEN c1 THEN v1 [WHEN ...] ELSE d END."""

    def __init__(self, cases: List[Any], default: Any = None):
        super().__init__()
        self._cases = [(_to_col(c), _to_col(v)) for c, v in cases]
        self._default = _to_col(default) if default is not None else lit(None)

    @property
    def cases(self) -> List[Any]:
        return self._cases

    @property
    def default(self) -> ColumnExpr:
        return self._default

    @property
    def children(self) -> List[ColumnExpr]:
        res: List[ColumnExpr] = []
        for c, v in self._cases:
            res.extend([c, v])
        res.append(self._default)
        return res

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self.as_type is not None:
            return self.as_type
        return self._cases[0][1].infer_type(schema)

    def __repr__(self) -> str:
        inner = " ".join(f"WHEN {c!r} THEN {v!r}" for c, v in self._cases)
        return f"CASE {inner} ELSE {self._default!r} END"

    def _uuid_keys(self) -> List[Any]:
        return ["case_when"]


class _InExpr(ColumnExpr):
    """expr IN (literals...) (optionally negated)."""

    def __init__(self, expr: Any, values: List[Any], positive: bool = True):
        super().__init__()
        self._expr = _to_col(expr)
        self._values = list(values)
        self._positive = positive

    @property
    def col(self) -> ColumnExpr:
        return self._expr

    @property
    def values(self) -> List[Any]:
        return self._values

    @property
    def positive(self) -> bool:
        return self._positive

    @property
    def children(self) -> List[ColumnExpr]:
        return [self._expr]

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        return self.as_type if self.as_type is not None else pa.bool_()

    def __repr__(self) -> str:
        op = "IN" if self._positive else "NOT IN"
        return f"({self._expr!r} {op} {tuple(self._values)})"

    def _uuid_keys(self) -> List[Any]:
        return ["in", self._positive, repr(self._values)]


class _LikeExpr(ColumnExpr):
    """expr LIKE pattern (SQL % and _ wildcards), optionally negated."""

    def __init__(self, expr: Any, pattern: str, positive: bool = True):
        super().__init__()
        self._expr = _to_col(expr)
        self._pattern = pattern
        self._positive = positive

    @property
    def col(self) -> ColumnExpr:
        return self._expr

    @property
    def pattern(self) -> str:
        return self._pattern

    @property
    def positive(self) -> bool:
        return self._positive

    @property
    def children(self) -> List[ColumnExpr]:
        return [self._expr]

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        return self.as_type if self.as_type is not None else pa.bool_()

    def __repr__(self) -> str:
        op = "LIKE" if self._positive else "NOT LIKE"
        return f"({self._expr!r} {op} {self._pattern!r})"

    def _uuid_keys(self) -> List[Any]:
        return ["like", self._positive, self._pattern]


def case_when(*cases: Any, default: Any = None) -> ColumnExpr:
    """Build CASE WHEN from (condition, value) pairs."""
    return _CaseWhenExpr(list(cases), default=default)


def structural_key(e: "ColumnExpr") -> str:
    """Identity of an expression ignoring its output alias (cast KEPT —
    ``CAST(x AS int)`` must not match plain ``x``). The shared matching
    key for GROUP BY / ORDER BY expression materialization."""
    return e.alias("").__uuid__()


def derived_name(e: "ColumnExpr") -> str:
    """The readable derived column name of an unaliased expression (what
    SQL backends display), used to name materialized helper columns.
    Casts render explicitly — ``repr`` omits them, and ``CAST(x AS int)``
    must not collide with plain ``x``."""
    bare = e.alias("")
    if bare.as_type is not None:
        return f"CAST({repr(bare.cast(None))} AS {bare.as_type})"
    return repr(bare)


class _WindowExpr(ColumnExpr):
    """``func(args) OVER (PARTITION BY keys ORDER BY sorts)``.

    Not an aggregate: it returns one value per input row.
    """

    def __init__(
        self,
        func: str,
        args: List[Any],
        partition_by: List[str],
        order_by: List[Any],  # (name, ascending) pairs
        frame: Any = None,  # (kind, start, end); None = dialect default
    ):
        super().__init__()
        self._func = func.upper()
        self._args = [_to_col(a) for a in args]
        self._partition_by = list(partition_by)
        self._order_by = list(order_by)
        # frame: kind ∈ {"rows","range"}; bounds are "unb_prec"/"unb_foll"/
        # "current"/("prec", n)/("foll", n)
        self._frame = frame

    @property
    def func(self) -> str:
        return self._func

    @property
    def args(self) -> List[ColumnExpr]:
        return self._args

    @property
    def partition_by(self) -> List[str]:
        return self._partition_by

    @property
    def order_by(self) -> List[Any]:
        return self._order_by

    @property
    def frame(self) -> Any:
        return self._frame

    @property
    def children(self) -> List[ColumnExpr]:
        return list(self._args)

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self.as_type is not None:
            return self.as_type
        if self._func in ("ROW_NUMBER", "RANK", "DENSE_RANK", "COUNT"):
            return pa.int64()
        if self._func == "AVG":
            return pa.float64()
        if len(self._args) > 0:
            return self._args[0].infer_type(schema)
        return None

    def __repr__(self) -> str:
        inner = ",".join(repr(a) for a in self._args)
        pb = f" PARTITION BY {self._partition_by}" if self._partition_by else ""
        ob = f" ORDER BY {self._order_by}" if self._order_by else ""
        s = f"{self._func}({inner}) OVER ({pb}{ob} )"
        return s if self.as_name == "" else f"{s} AS {self.as_name}"

    def _uuid_keys(self) -> List[Any]:
        return [
            "window",
            self._func,
            self._partition_by,
            repr(self._order_by),
            repr(self._frame),
        ]
