"""Arrow-backed Schema with a compact string expression syntax.

Copied from ``fugue_tpu/schema.py`` and trimmed to what the port uses:
parse and print expressions such as ``"k:long,v:float"``, hold the
fields of a frame, derive the output types of an aggregate, the copy,
``+``, ``-`` and ``extract`` that the join schemas need, and the
``transform`` that resolves a transformer's output schema (``*``,
``-a``, ``~a``). The grammar is the JAX package's::

    schema  := pair ("," pair)*
    pair    := name ":" type
    type    := primitive | "[" type "]"           (list)
             | "{" schema "}"                     (struct)
             | "<" type "," type ">"              (map)
             | "decimal(p[,s])" | "timestamp(unit[,tz])"
    name    := identifier | `backquoted name`
"""

from typing import Any, Callable, Dict, Iterable, List, Optional

import pandas as pd
import pyarrow as pa

from ._utils.params import IndexedOrderedDict
from .exceptions import FugueDataFrameOperationError

_PRIMITIVES: Dict[str, pa.DataType] = {
    "null": pa.null(),
    "bool": pa.bool_(),
    "boolean": pa.bool_(),
    "byte": pa.int8(),
    "int8": pa.int8(),
    "short": pa.int16(),
    "int16": pa.int16(),
    "int": pa.int32(),
    "int32": pa.int32(),
    "long": pa.int64(),
    "int64": pa.int64(),
    "ubyte": pa.uint8(),
    "uint8": pa.uint8(),
    "ushort": pa.uint16(),
    "uint16": pa.uint16(),
    "uint": pa.uint32(),
    "uint32": pa.uint32(),
    "ulong": pa.uint64(),
    "uint64": pa.uint64(),
    "float16": pa.float16(),
    "float": pa.float32(),
    "float32": pa.float32(),
    "double": pa.float64(),
    "float64": pa.float64(),
    "str": pa.string(),
    "string": pa.string(),
    "date": pa.date32(),
    "datetime": pa.timestamp("us"),
    "binary": pa.binary(),
    "bytes": pa.binary(),
}

_TYPE_TO_EXPR: Dict[pa.DataType, str] = {
    pa.null(): "null",
    pa.bool_(): "bool",
    pa.int8(): "byte",
    pa.int16(): "short",
    pa.int32(): "int",
    pa.int64(): "long",
    pa.uint8(): "uint8",
    pa.uint16(): "uint16",
    pa.uint32(): "uint32",
    pa.uint64(): "uint64",
    pa.float16(): "float16",
    pa.float32(): "float",
    pa.float64(): "double",
    pa.string(): "str",
    pa.large_string(): "str",
    pa.date32(): "date",
    pa.timestamp("us"): "datetime",
    pa.binary(): "binary",
    pa.large_binary(): "binary",
}


def _split_top(s: str, sep: str) -> List[str]:
    """Split on ``sep`` at bracket depth 0, honoring backtick quoting."""
    parts: List[str] = []
    depth = 0
    quoted = False
    cur: List[str] = []
    for ch in s:
        if ch == "`":
            quoted = not quoted
            cur.append(ch)
        elif quoted:
            cur.append(ch)
        elif ch in "[{<(":
            depth += 1
            cur.append(ch)
        elif ch in "]}>)":
            depth -= 1
            cur.append(ch)
        elif ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _parse_type(expr: str) -> pa.DataType:
    s = expr.strip()
    if s == "":
        raise SyntaxError("empty type expression")
    if s.startswith("[") and s.endswith("]"):
        return pa.list_(_parse_type(s[1:-1]))
    if s.startswith("{") and s.endswith("}"):
        inner = s[1:-1].strip()
        fields = [] if inner == "" else _parse_fields(inner)
        return pa.struct(fields)
    if s.startswith("<") and s.endswith(">"):
        kv = _split_top(s[1:-1], ",")
        if len(kv) != 2:
            raise SyntaxError(f"invalid map type {expr}")
        return pa.map_(_parse_type(kv[0]), _parse_type(kv[1]))
    if s.startswith("decimal(") and s.endswith(")"):
        args = [int(x) for x in s[len("decimal(") : -1].split(",")]
        return pa.decimal128(*args)
    if s.startswith("timestamp(") and s.endswith(")"):
        args = [x.strip() for x in s[len("timestamp(") : -1].split(",")]
        return pa.timestamp(args[0], tz=args[1] if len(args) > 1 else None)
    if s in _PRIMITIVES:
        return _PRIMITIVES[s]
    raise SyntaxError(f"unknown type expression {expr!r}")


def _parse_fields(expr: str) -> List[pa.Field]:
    fields: List[pa.Field] = []
    for part in _split_top(expr, ","):
        part = part.strip()
        if part == "":
            raise SyntaxError(f"invalid schema expression {expr!r}")
        nt = _split_top(part, ":")
        if len(nt) != 2:
            raise SyntaxError(f"invalid field expression {part!r}")
        name = nt[0].strip()
        if name.startswith("`") and name.endswith("`") and len(name) >= 2:
            name = name[1:-1]
        if name == "":
            raise SyntaxError(f"empty field name in {part!r}")
        fields.append(pa.field(name, _parse_type(nt[1])))
    return fields


def expression_to_schema(expr: str) -> pa.Schema:
    return pa.schema(_parse_fields(expr))


def to_pa_datatype(obj: Any) -> pa.DataType:
    """Convert a string expression / python type / numpy dtype to arrow."""
    import datetime

    import numpy as np

    if obj is datetime.datetime:
        return pa.timestamp("us")
    if obj is datetime.date:
        return pa.date32()
    if isinstance(obj, pa.DataType):
        return obj
    if isinstance(obj, str):
        return _parse_type(obj)
    if obj is int:
        return pa.int64()
    if obj is float:
        return pa.float64()
    if obj is str:
        return pa.string()
    if obj is bool:
        return pa.bool_()
    if obj is bytes:
        return pa.binary()
    if isinstance(obj, (np.dtype, type)):
        return pa.from_numpy_dtype(obj)
    raise TypeError(f"can't convert {obj!r} to pyarrow DataType")


def type_to_expression(tp: pa.DataType) -> str:
    if tp in _TYPE_TO_EXPR:
        return _TYPE_TO_EXPR[tp]
    if pa.types.is_timestamp(tp):
        if tp.tz is None:
            return "datetime" if tp.unit == "us" else f"timestamp({tp.unit})"
        return f"timestamp({tp.unit},{tp.tz})"
    if pa.types.is_decimal(tp):
        return f"decimal({tp.precision},{tp.scale})"
    if pa.types.is_large_list(tp) or pa.types.is_list(tp):
        return f"[{type_to_expression(tp.value_type)}]"
    if pa.types.is_struct(tp):
        inner = ",".join(f"{f.name}:{type_to_expression(f.type)}" for f in tp)
        return "{" + inner + "}"
    if pa.types.is_map(tp):
        return f"<{type_to_expression(tp.key_type)},{type_to_expression(tp.item_type)}>"
    if pa.types.is_date(tp):
        return "date"
    raise NotImplementedError(f"can't convert {tp} to expression")


def _quote_name(name: str) -> str:
    if name.isidentifier():
        return name
    return f"`{name}`"


def _normalize_type(tp: pa.DataType) -> pa.DataType:
    """Canonicalize types coming from external data (large_* → plain)."""
    if pa.types.is_dictionary(tp):
        return _normalize_type(tp.value_type)
    if pa.types.is_large_string(tp):
        return pa.string()
    if pa.types.is_large_binary(tp):
        return pa.binary()
    if pa.types.is_large_list(tp) or pa.types.is_list(tp):
        return pa.list_(_normalize_type(tp.value_type))
    if pa.types.is_struct(tp):
        return pa.struct([pa.field(f.name, _normalize_type(f.type)) for f in tp])
    if pa.types.is_date(tp):
        return pa.date32()
    return tp


class Schema(IndexedOrderedDict):
    """Ordered ``name → pa.Field`` mapping.

    Accepts: expression strings, ``pa.Schema``/``pa.Field``, pandas frames,
    other Schemas, dicts, and lists/tuples of any of these.
    """

    def __init__(self, *args: Any):
        super().__init__()
        for a in args:
            self.append(a)

    def _append_field(self, field: pa.Field) -> None:
        if field.name in self:
            raise SchemaError(f"duplicated field name {field.name!r}")
        if field.name == "":
            raise SchemaError("field name can't be empty")
        field = pa.field(field.name, _normalize_type(field.type))
        self[field.name] = field

    def append(self, obj: Any) -> "Schema":
        if obj is None:
            return self
        if isinstance(obj, pa.Field):
            self._append_field(obj)
        elif isinstance(obj, str):
            for f in _parse_fields(obj):
                self._append_field(f)
        elif isinstance(obj, Schema):
            for f in obj.fields:
                self._append_field(f)
        elif isinstance(obj, pa.Schema):
            for f in obj:
                self._append_field(f)
        elif isinstance(obj, pd.DataFrame):
            self.append(_pandas_to_pa_schema(obj))
        elif isinstance(obj, Dict):
            for k, v in obj.items():
                self._append_field(pa.field(k, to_pa_datatype(v)))
        elif isinstance(obj, tuple) and len(obj) == 2 and isinstance(obj[0], str):
            self._append_field(pa.field(obj[0], to_pa_datatype(obj[1])))
        elif isinstance(obj, Iterable):
            for x in obj:
                self.append(x)
        else:
            raise SchemaError(f"can't append {obj!r} to schema")
        return self

    @property
    def names(self) -> List[str]:
        return list(self.keys())

    @property
    def fields(self) -> List[pa.Field]:
        return list(self.values())

    @property
    def types(self) -> List[pa.DataType]:
        return [f.type for f in self.values()]

    @property
    def pa_schema(self) -> pa.Schema:
        return pa.schema(self.fields)

    @property
    def pandas_dtype(self) -> Dict[str, Any]:
        """The pandas dtype each column holds when it has no NULLs
        (``object`` for strings, binaries and nested types)."""
        return {
            f.name: pd.api.types.pandas_dtype(f.type.to_pandas_dtype())
            if not pa.types.is_nested(f.type)
            and not pa.types.is_string(f.type)
            and not pa.types.is_binary(f.type)
            and not pa.types.is_null(f.type)
            else pd.api.types.pandas_dtype(object)
            for f in self.fields
        }

    def index_of_key(self, key: str) -> int:
        return self.names.index(key)

    def __getitem__(self, key: Any) -> Any:
        if isinstance(key, int):
            return self.get_value_by_index(key)
        return super().__getitem__(key)

    def __contains__(self, key: Any) -> bool:
        """A name, a ``name:type`` expression, a field, or an iterable of
        them, every one present (with its type, where one is given)."""
        if key is None:
            return False
        if isinstance(key, str):
            if ":" not in key:
                return super().__contains__(key)
            try:
                fields = _parse_fields(key)
            except Exception:
                return False
            return all(self.__contains__(f) for f in fields)
        if isinstance(key, pa.Field):
            return super().__contains__(key.name) and self[key.name].type == key.type
        if isinstance(key, Schema):
            return all(self.__contains__(f) for f in key.fields)
        if isinstance(key, Iterable):
            return all(self.__contains__(k) for k in key)
        return False

    def __eq__(self, other: Any) -> bool:
        if other is None:
            return False
        if not isinstance(other, Schema):
            try:
                other = Schema(other)
            except Exception:
                return False
        return self.names == other.names and self.types == other.types

    def __ne__(self, other: Any) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:  # needed because __eq__ is overridden
        return hash(str(self))

    def copy(self) -> "Schema":
        """A writable copy."""
        return Schema(self.fields)

    def __add__(self, other: Any) -> "Schema":
        return self.copy().append(other)

    def _field_names(self, names: Any) -> List[str]:
        """``names`` (a name or a list of names) as a list, each a field."""
        names = [names] if isinstance(names, str) else list(names)
        missing = [n for n in names if n not in self]
        if len(missing) > 0:
            raise SchemaError(f"fields {missing} not in schema {self}")
        return names

    def __sub__(self, names: Any) -> "Schema":
        """The schema without the fields named in ``names``."""
        drop = set(self._field_names(names))
        return Schema([f for f in self.fields if f.name not in drop])

    def extract(self, names: Any) -> "Schema":
        """The fields named in ``names``, in that order."""
        return Schema([self[n] for n in self._field_names(names)])

    def exclude(self, names: Any) -> "Schema":
        """The schema without the fields named in ``names`` that it has."""
        drop = {names} if isinstance(names, str) else set(names)
        return Schema([f for f in self.fields if f.name not in drop])

    def rename(self, columns: Dict[str, str]) -> "Schema":
        """The schema with the fields renamed by ``columns`` (old → new;
        each old name must be a field, and the new names must not
        collide)."""
        missing = [k for k in columns if k not in self]
        if len(missing) > 0:
            raise SchemaError(f"can't rename: {missing} not in schema")
        new_names = [columns.get(n, n) for n in self.names]
        if len(set(new_names)) != len(new_names):
            raise SchemaError(f"rename causes duplicated names: {new_names}")
        return Schema([pa.field(n, f.type) for n, f in zip(new_names, self.fields)])

    def alter(self, subschema: Any) -> "Schema":
        """The schema with the types of ``subschema``'s fields (each must
        be a field here) in place of their own."""
        if subschema is None:
            return self
        sub = subschema if isinstance(subschema, Schema) else Schema(subschema)
        missing = [n for n in sub.names if n not in self]
        if len(missing) > 0:
            raise SchemaError(f"can't alter: {missing} not in schema {self}")
        return Schema([sub[f.name] if f.name in sub else f for f in self.fields])

    def is_like(self, other: Any, equal_groups: Optional[List[List[Callable]]] = None) -> bool:
        """Equal names and types, the types of one group of
        ``equal_groups`` (such as ``[[pa.types.is_integer]]``) counting
        as equal."""
        if other is None:
            return False
        try:
            o = other if isinstance(other, Schema) else Schema(other)
        except Exception:
            return False
        if self.names != o.names:
            return False
        for a, b in zip(self.types, o.types):
            if a == b:
                continue
            if equal_groups is not None and any(
                any(c(a) for c in grp) and any(c(b) for c in grp) for grp in equal_groups
            ):
                continue
            return False
        return True

    def transform(self, *args: Any) -> "Schema":
        """A derived schema (``fugue_tpu/schema.py`` ``transform``): each
        argument is an expression, a callable of this schema, or anything
        a schema appends. In an expression, ``*`` is every column of this
        schema, ``name:type`` adds a column, ``-a,b`` drops columns (each
        must be there) and ``~a,b`` drops them where they are; a bare name
        after ``-`` or ``~`` keeps dropping until a typed field or ``*``."""
        result = Schema()
        subtract: List[str] = []
        soft_subtract: List[str] = []

        def handle_expr(expr: str) -> None:
            mode = "add"
            for part in _split_top(expr, ","):
                part = part.strip()
                if part == "":
                    continue
                if part == "*":
                    mode = "add"
                    result.append(self)
                elif part.startswith("-"):
                    mode = "sub"
                    subtract.append(part[1:].strip())
                elif part.startswith("~"):
                    mode = "soft"
                    soft_subtract.append(part[1:].strip())
                elif ":" in part:
                    mode = "add"
                    result.append(part)
                elif mode == "sub":
                    subtract.append(part)
                elif mode == "soft":
                    soft_subtract.append(part)
                else:
                    result.append(part)

        for a in args:
            if a is None:
                continue
            if callable(a) and not isinstance(a, (str, Schema)):
                result.append(a(self))
            elif isinstance(a, str):
                handle_expr(a)
            else:
                result.append(a)
        res = result
        if len(subtract) > 0:
            res = res - subtract
        if len(soft_subtract) > 0:
            res = res.exclude(soft_subtract)
        return res

    def assert_not_empty(self) -> "Schema":
        if len(self) == 0:
            raise SchemaError("schema is empty")
        return self

    def create_empty_arrow_table(self) -> pa.Table:
        return pa.Table.from_arrays(
            [pa.array([], type=f.type) for f in self.fields], schema=self.pa_schema
        )

    def create_empty_pandas_df(self) -> pd.DataFrame:
        return self.create_empty_arrow_table().to_pandas()

    def __repr__(self) -> str:
        return str(self)

    def __str__(self) -> str:
        return ",".join(
            f"{_quote_name(f.name)}:{type_to_expression(f.type)}" for f in self.fields
        )


class SchemaError(FugueDataFrameOperationError):
    """Invalid schema expression or operation."""


def _pandas_to_pa_schema(df: pd.DataFrame) -> pa.Schema:
    """Infer an arrow schema from a pandas frame, mapping object→str."""
    schema = pa.Schema.from_pandas(df, preserve_index=False)
    fields = []
    for f in schema:
        if pa.types.is_null(f.type):
            fields.append(pa.field(f.name, pa.string()))
        else:
            fields.append(pa.field(f.name, _normalize_type(f.type)))
    return pa.schema(fields)
