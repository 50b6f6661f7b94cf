"""SQL dialect profiles and a token-level transpiler, copied whole from
``fugue_tpu/sql/dialect.py`` (the sqlglot role):

- **quoting**: string vs identifier quote conventions (spark/fugue treat
  ``"x"`` as a string and `` `x` `` as an identifier; postgres/sqlite treat
  ``"x"`` as an identifier; mysql uses backticks; mssql uses ``[x]``);
- **LIMIT/TOP**: ``LIMIT n`` ↔ ``SELECT TOP n`` (mssql);
- **type names** in ``CAST(x AS t)``: fugue's canonical names map per
  dialect (``double`` → ``DOUBLE PRECISION`` on postgres, ``REAL`` on
  sqlite, …), both directions;
- **function renames**: ``SUBSTRING``/``SUBSTR``, ``STRING_AGG``/
  ``GROUP_CONCAT``, ``RANDOM``/``RAND``, ``NVL``/``IFNULL`` → ``COALESCE``,
  ``CEILING``/``CEIL``, both directions via a canonical name;
- **boolean literals**: ``TRUE``/``FALSE`` → ``1``/``0`` where the dialect
  has no boolean type (sqlite, mssql).

The pipeline is: tokenize with the SOURCE profile's quote conventions →
canonicalize names → emit with the TARGET profile's conventions. Everything
unrecognized passes through verbatim, so the transpiler never rejects a
query — it only rewrites the constructs it knows.

The port has no plugin registry: ``collections/sql.py`` ``transpile_sql``
calls :func:`transpile` when both dialects are registered and differ.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..exceptions import FugueSQLSyntaxError

# ---------------------------------------------------------------------------
# profiles
# ---------------------------------------------------------------------------

# canonical function names (the in-tree/fugue spelling) per dialect
_FUNCS_SQLITE = {
    "SUBSTRING": "SUBSTR",
    "STRING_AGG": "GROUP_CONCAT",
    "CEILING": "CEIL",
}
_FUNCS_MYSQL = {"RANDOM": "RAND", "STRING_AGG": "GROUP_CONCAT"}
# canonical spellings are already SUBSTRING/CEILING (the T-SQL ones)
_FUNCS_MSSQL = {"RANDOM": "RAND"}

# read-side aliases accepted from ANY dialect and normalized to the
# canonical spelling (same arg shapes) — SUBSTR/CEIL normalize here so a
# fugue/spark query using the short forms still emits valid SQL on
# dialects that only have the long spellings (sqlite targets re-shorten
# via their own func_map)
_READ_ALIASES = {
    "NVL": "COALESCE",
    "IFNULL": "COALESCE",
    "SUBSTR": "SUBSTRING",
    "CEIL": "CEILING",
}

# canonical type names are fugue schema-expression names (lower) plus the
# standard SQL spellings normalized onto them
_CANON_TYPES = {
    "INT": "int",
    "INTEGER": "int",
    "BIGINT": "long",
    "LONG": "long",
    "SMALLINT": "short",
    "SHORT": "short",
    "TINYINT": "byte",
    "BYTE": "byte",
    "FLOAT": "float",
    "REAL": "float",
    "DOUBLE": "double",
    "DOUBLE PRECISION": "double",
    "STR": "str",
    "STRING": "str",
    "TEXT": "str",
    "VARCHAR": "str",
    "BOOL": "bool",
    "BOOLEAN": "bool",
    "DATETIME": "datetime",
    "TIMESTAMP": "datetime",
    "DATE": "date",
    "BYTES": "bytes",
    "BLOB": "bytes",
    "BINARY": "bytes",
    "BYTEA": "bytes",
    "VARBINARY": "bytes",
}


@dataclass(frozen=True)
class DialectProfile:
    """Everything the transpiler needs to read/write one dialect."""

    name: str
    # how identifiers are quoted on OUTPUT: ('"', '"'), ('`', '`'), ('[', ']')
    ident_quote: Tuple[str, str] = ('"', '"')
    # whether a double-quoted token is a STRING (spark-style) or an identifier
    dquote_is_string: bool = False
    # whether backticks quote identifiers when READING
    backtick_idents: bool = False
    # whether [brackets] quote identifiers when READING
    bracket_idents: bool = False
    # "limit" or "top"
    limit_style: str = "limit"
    # TRUE/FALSE rendering; None = keep the keywords
    bool_literals: Optional[Tuple[str, str]] = None
    # canonical fugue type name -> dialect type name (CAST targets)
    type_map: Dict[str, str] = field(default_factory=dict)
    # canonical function name -> dialect function name
    func_map: Dict[str, str] = field(default_factory=dict)
    # dialect type name -> canonical name OVERRIDES for reading (the
    # shared _CANON_TYPES table assumes standard-SQL meanings; e.g.
    # sqlite's REAL is 8-byte and mssql's FLOAT is double precision)
    type_read_map: Dict[str, str] = field(default_factory=dict)

    def func_to_canonical(self) -> Dict[str, str]:
        return {v.upper(): k for k, v in self.func_map.items()}


DIALECTS: Dict[str, DialectProfile] = {}


def register_dialect(profile: DialectProfile) -> None:
    DIALECTS[profile.name] = profile


def get_dialect(name: Optional[str]) -> DialectProfile:
    if name is None or name == "":
        name = "fugue"
    key = name.lower()
    if key not in DIALECTS:
        raise FugueSQLSyntaxError(
            f"unknown SQL dialect {name!r}; known: {sorted(DIALECTS)}"
        )
    return DIALECTS[key]


register_dialect(
    DialectProfile(
        name="fugue",  # the in-tree dialect: spark conventions
        ident_quote=("`", "`"),
        dquote_is_string=True,
        backtick_idents=True,
    )
)
register_dialect(
    DialectProfile(
        name="spark",
        ident_quote=("`", "`"),
        dquote_is_string=True,
        backtick_idents=True,
        type_map={"str": "STRING", "datetime": "TIMESTAMP", "bytes": "BINARY"},
    )
)
register_dialect(
    DialectProfile(
        name="sqlite",
        ident_quote=('"', '"'),
        bool_literals=("1", "0"),
        # sqlite REAL is ALWAYS 8-byte; INTEGER is up to 8-byte
        type_read_map={"REAL": "double", "INTEGER": "long", "INT": "long"},
        type_map={
            "int": "INTEGER",
            "long": "INTEGER",
            "short": "INTEGER",
            "byte": "INTEGER",
            "float": "REAL",
            "double": "REAL",
            "str": "TEXT",
            "bool": "INTEGER",
            "datetime": "TEXT",
            "date": "TEXT",
            "bytes": "BLOB",
        },
        func_map=_FUNCS_SQLITE,
    )
)
register_dialect(
    DialectProfile(
        name="postgres",
        ident_quote=('"', '"'),
        type_map={
            "int": "INTEGER",
            "long": "BIGINT",
            "short": "SMALLINT",
            "byte": "SMALLINT",
            "float": "REAL",
            "double": "DOUBLE PRECISION",
            "str": "TEXT",
            "bool": "BOOLEAN",
            "datetime": "TIMESTAMP",
            "date": "DATE",
            "bytes": "BYTEA",
        },
    )
)
register_dialect(
    DialectProfile(
        name="mysql",
        ident_quote=("`", "`"),
        backtick_idents=True,
        type_map={
            "long": "BIGINT",
            "double": "DOUBLE",
            "str": "TEXT",
            "bool": "BOOLEAN",
            "datetime": "DATETIME",
            "bytes": "BLOB",
        },
        func_map=_FUNCS_MYSQL,
    )
)
register_dialect(
    DialectProfile(
        name="mssql",
        ident_quote=("[", "]"),
        bracket_idents=True,
        limit_style="top",
        bool_literals=("1", "0"),
        # T-SQL: FLOAT defaults to FLOAT(53) = double; REAL is float32
        type_read_map={
            "FLOAT": "double",
            "REAL": "float",
            "NVARCHAR": "str",
            "BIT": "bool",
            "DATETIME2": "datetime",
        },
        type_map={
            "long": "BIGINT",
            "float": "REAL",  # T-SQL: bare FLOAT means FLOAT(53) = double
            "double": "FLOAT",
            "str": "NVARCHAR(MAX)",
            "bool": "BIT",
            "datetime": "DATETIME2",
            "bytes": "VARBINARY(MAX)",
        },
        func_map=_FUNCS_MSSQL,
    )
)


# ---------------------------------------------------------------------------
# dialect-aware tokenizer (quote conventions differ per dialect, so the
# parser's spark-flavored tokenizer can't read postgres text)
# ---------------------------------------------------------------------------


@dataclass
class _Tok:
    kind: str  # IDENT QIDENT STRING NUMBER OP PUNCT
    value: str


def _tokenize(sql: str, p: DialectProfile) -> List[_Tok]:
    toks: List[_Tok] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            i = n if j < 0 else j + 2
            continue
        if c == "'" or (c == '"' and p.dquote_is_string):
            val, i = _read_quoted(sql, i, c, c)
            toks.append(_Tok("STRING", val))
            continue
        if c == '"' and not p.dquote_is_string:
            val, i = _read_quoted(sql, i, '"', '"')
            toks.append(_Tok("QIDENT", val))
            continue
        if c == "`" and p.backtick_idents:
            val, i = _read_quoted(sql, i, "`", "`")
            toks.append(_Tok("QIDENT", val))
            continue
        if c == "[" and p.bracket_idents:
            j = sql.find("]", i + 1)
            if j < 0:
                raise FugueSQLSyntaxError(f"unterminated identifier at {i}")
            toks.append(_Tok("QIDENT", sql[i + 1 : j]))
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
                k = j + 1
                if k < n and sql[k] in "+-":
                    k += 1
                if k < n and sql[k].isdigit():
                    while k < n and sql[k].isdigit():
                        k += 1
                    j = k
            toks.append(_Tok("NUMBER", sql[i:j]))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            toks.append(_Tok("IDENT", sql[i:j]))
            i = j
            continue
        matched = False
        for op in ("<>", "<=", ">=", "!=", "==", "||", "<<", ">>"):
            if sql.startswith(op, i):
                toks.append(_Tok("OP", op))
                i += len(op)
                matched = True
                break
        if matched:
            continue
        if c in "+-*/%<>=&|^~!":
            toks.append(_Tok("OP", c))
        elif c in "(),.;[]{}:?@#$":
            toks.append(_Tok("PUNCT", c))
        else:
            raise FugueSQLSyntaxError(f"unexpected character {c!r} at {i}")
        i += 1
    return toks


def _read_quoted(sql: str, i: int, open_c: str, close_c: str) -> Tuple[str, int]:
    j = i + 1
    buf: List[str] = []
    n = len(sql)
    while j < n:
        if sql[j] == close_c:
            if j + 1 < n and sql[j + 1] == close_c:  # doubled-quote escape
                buf.append(close_c)
                j += 2
                continue
            return "".join(buf), j + 1
        buf.append(sql[j])
        j += 1
    raise FugueSQLSyntaxError(f"unterminated quote at {i}")


# ---------------------------------------------------------------------------
# transpiler
# ---------------------------------------------------------------------------


def transpile(
    raw: str, from_dialect: Optional[str], to_dialect: Optional[str]
) -> str:
    """Transpile ``raw`` between two registered dialects. Identity when the
    profiles are the same object. Constructs it does not understand pass
    through verbatim."""
    src = get_dialect(from_dialect)
    dst = get_dialect(to_dialect)
    if src is dst:
        return raw
    toks = _tokenize(raw, src)
    toks = _canonicalize(toks, src)
    if src.limit_style != dst.limit_style:
        toks = _convert_limit(toks, dst.limit_style)
    return _emit(toks, dst)


def _canonicalize(toks: List[_Tok], src_profile: DialectProfile) -> List[_Tok]:
    """Rename dialect functions/types to canonical names in place."""
    to_canon = src_profile.func_to_canonical()
    out: List[_Tok] = []
    i = 0
    cast_depth: List[int] = []  # paren depths of open CAST(
    depth = 0
    while i < len(toks):
        t = toks[i]
        if t.kind == "PUNCT" and t.value == "(":
            depth += 1
        elif t.kind == "PUNCT" and t.value == ")":
            if cast_depth and cast_depth[-1] == depth:
                cast_depth.pop()
            depth -= 1
        if t.kind == "IDENT":
            up = t.value.upper()
            nxt = toks[i + 1] if i + 1 < len(toks) else None
            if up == "CAST" and nxt is not None and nxt.value == "(":
                cast_depth.append(depth + 1)
                out.append(t)
                i += 1
                continue
            if (
                cast_depth
                and cast_depth[-1] == depth
                and out
                and out[-1].kind == "IDENT"
                and out[-1].value.upper() == "AS"
            ):
                # the CAST target type: may span two words (DOUBLE PRECISION)
                words = [up]
                if (
                    nxt is not None
                    and nxt.kind == "IDENT"
                    and f"{up} {nxt.value.upper()}" in _CANON_TYPES
                ):
                    words.append(nxt.value.upper())
                    i += 1
                tname = " ".join(words)
                canon = src_profile.type_read_map.get(tname) or _CANON_TYPES.get(
                    tname
                )
                out.append(_Tok("TYPE", canon if canon is not None else t.value))
                i += 1
                # drop a parenthesized size suffix of a RECOGNIZED type —
                # VARCHAR(10) → str; the canonical types carry no modifier
                if (
                    canon is not None
                    and i < len(toks)
                    and toks[i].value == "("
                ):
                    d = 0
                    while i < len(toks):
                        if toks[i].value == "(":
                            d += 1
                        elif toks[i].value == ")":
                            d -= 1
                            if d == 0:
                                i += 1
                                break
                        i += 1
                continue
            if (
                nxt is not None
                and nxt.value == "("
                and (up in to_canon or up in _READ_ALIASES)
            ):
                out.append(
                    _Tok("IDENT", to_canon.get(up, _READ_ALIASES.get(up, up)))
                )
                i += 1
                continue
        out.append(t)
        i += 1
    return out


def _convert_limit(toks: List[_Tok], target_style: str) -> List[_Tok]:
    """LIMIT n ↔ SELECT TOP n at paren depth 0."""
    out = list(toks)
    if target_style == "top":
        # a top-level set operation makes TOP non-equivalent (it would bind
        # to the first branch, not the combined result) — leave LIMIT alone
        depth = 0
        for t in out:
            if t.value == "(":
                depth += 1
            elif t.value == ")":
                depth -= 1
            elif (
                depth == 0
                and t.kind == "IDENT"
                and t.value.upper() in ("UNION", "EXCEPT", "INTERSECT")
            ):
                return out
        # find top-level LIMIT n; move as TOP n after the first SELECT
        depth = 0
        for i, t in enumerate(out):
            if t.value == "(":
                depth += 1
            elif t.value == ")":
                depth -= 1
            elif (
                depth == 0
                and t.kind == "IDENT"
                and t.value.upper() == "LIMIT"
                and i + 1 < len(out)
                and out[i + 1].kind == "NUMBER"
            ):
                num = out[i + 1]
                del out[i : i + 2]
                for j, s in enumerate(out):
                    if s.kind == "IDENT" and s.value.upper() == "SELECT":
                        out[j + 1 : j + 1] = [_Tok("IDENT", "TOP"), num]
                        break
                break
    else:
        # SELECT TOP n ... -> ... LIMIT n
        for i, t in enumerate(out):
            if (
                t.kind == "IDENT"
                and t.value.upper() == "TOP"
                and i > 0
                and out[i - 1].value.upper() == "SELECT"
                and i + 1 < len(out)
                and out[i + 1].kind == "NUMBER"
            ):
                num = out[i + 1]
                del out[i : i + 2]
                out.extend([_Tok("IDENT", "LIMIT"), num])
                break
    return out


_NO_SPACE_BEFORE = {",", ")", ".", ";"}
_NO_SPACE_AFTER = {"(", "."}


def _emit(toks: List[_Tok], dst: DialectProfile) -> str:
    parts: List[str] = []
    prev: Optional[_Tok] = None
    for i, t in enumerate(toks):
        nxt = toks[i + 1] if i + 1 < len(toks) else None
        if t.kind == "STRING":
            text = "'" + t.value.replace("'", "''") + "'"
        elif t.kind == "QIDENT":
            o, c = dst.ident_quote
            text = o + t.value.replace(c, c + c) + c
        elif t.kind == "TYPE":
            text = dst.type_map.get(t.value, t.value)
        elif t.kind == "IDENT":
            up = t.value.upper()
            if dst.bool_literals is not None and up in ("TRUE", "FALSE"):
                text = dst.bool_literals[0 if up == "TRUE" else 1]
            elif (
                up in dst.func_map
                and nxt is not None
                and nxt.value == "("
            ):
                # only CALLS rename — a column named like a function stays
                text = dst.func_map[up]
            else:
                text = t.value
        else:
            text = t.value
        sep = " "
        if prev is None:
            sep = ""
        elif text in _NO_SPACE_BEFORE:
            sep = ""
        elif prev.value in _NO_SPACE_AFTER and prev.kind == "PUNCT":
            sep = ""
        elif prev.kind in ("IDENT", "QIDENT") and text == "(":
            # function call / CAST parens hug the name; this also joins
            # `name (` in FROM clauses, which SQL treats identically
            sep = ""
        parts.append(sep + text)
        prev = _Tok(t.kind if t.kind != "TYPE" else "IDENT", text)
    return "".join(parts)
