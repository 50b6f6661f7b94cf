"""FugueSQL, copied from ``fugue_tpu/sql/fsql.py``: the extended SQL
dialect compiled into a ``FugueWorkflow`` by a statement-oriented parser
over the tokenizer of ``parser.py``.

Supported statements (each optionally prefixed ``name =`` / ``name ?=``):

    CREATE [[...]] SCHEMA a:int,b:str
    CREATE USING ext [(params)] [SCHEMA s]
    df = LOAD [PARQUET|CSV|JSON] "path" [(params)] [COLUMNS schema_or_cols]
    SAVE [df] [PREPARTITION ...] OVERWRITE|APPEND|TO [SINGLE] "path" [(params)]
    TRANSFORM [df] [PREPARTITION BY k [PRESORT s]] USING ext [(params)] [SCHEMA s]
    OUTTRANSFORM [df] [PREPARTITION ...] USING ext [(params)]
    PROCESS [dfs] [PREPARTITION ...] USING ext [(params)] [SCHEMA s]
    OUTPUT [dfs] USING ext [(params)]
    PRINT [n ROWS] [FROM dfs] [ROWCOUNT] [TITLE "t"]
    SELECT ...                      (standard SQL; frames are table names;
                                     no FROM → previous statement's output)
    TAKE n ROW[S] [FROM df] [PREPARTITION BY ...] [PRESORT ...]
    SAMPLE [REPLACE] n ROWS|x PERCENT [SEED n] [FROM df]
    DROP ROWS IF ANY|ALL NULL[S] [ON cols] [FROM df]
    DROP COLUMNS a,b [IF EXISTS] [FROM df]
    FILL NULLS PARAMS k:v,... [FROM df]
    RENAME COLUMNS a:b,... [FROM df]
    ALTER COLUMNS a:type,... [FROM df]
    YIELD [LOCAL] DATAFRAME|FILE|TABLE AS name
    PERSIST | BROADCAST | CHECKPOINT | WEAK CHECKPOINT |
    STRONG CHECKPOINT | DETERMINISTIC CHECKPOINT

Statements separate on ``;`` or on a newline that begins a new statement
keyword / assignment. Jinja templating (``{{var}}``) fills from passed
variables and the caller's locals. A name after ``USING`` resolves in the
registry of extension names, then in the caller's scope.

A SELECT written in another dialect (``fugue.sql.compile.dialect``, e.g.
``postgres``) goes through the transpiler (``sql/dialect.py``) into the
in-tree one before parsing. ``CONNECT`` runs a SELECT on another engine
of the port (``torch``, ``sqlite_torch``, ``native``, ...) or SQL engine
(``local``, ``sqlite``; ``extensions/_builtins/processors.py``
``RunSQLSelect``); a name the port lacks raises at run time naming
ROADMAP.md A.10.
"""

import json
from typing import Any, Dict, List, Optional

from .._utils.convert import get_caller_global_local_vars
from ..collections.partition import PartitionSpec
from ..constants import FUGUE_CONF_SQL_DIALECT
from ..dataframe import DataFrame
from ..exceptions import FugueSQLSyntaxError
from ..workflow.workflow import FugueWorkflow, WorkflowDataFrame
from .parser import Token, tokenize

_STATEMENT_KEYWORDS = {
    "CREATE", "LOAD", "SAVE", "TRANSFORM", "OUTTRANSFORM", "PROCESS",
    "OUTPUT", "PRINT", "SELECT", "TAKE", "SAMPLE", "DROP", "FILL",
    "RENAME", "ALTER", "YIELD", "PERSIST", "BROADCAST", "CHECKPOINT",
    "DETERMINISTIC", "WEAK", "STRONG", "OUT",
}

_CLAUSE_KEYWORDS = {
    "USING", "SCHEMA", "PARAMS", "PREPARTITION", "PRESORT", "FROM",
    "OVERWRITE", "APPEND", "TO", "SINGLE", "COLUMNS", "CALLBACK",
    "ROWCOUNT", "TITLE", "ROWS", "ROW",
}


class _StatementSplitter:
    """Split a token stream into statements at depth-0 boundaries."""

    def __init__(self, sql: str):
        self._sql = sql
        self._tokens = tokenize(sql)

    def split(self) -> List[Any]:
        """Returns a list of (tokens, end_pos) per statement."""
        import bisect

        newlines = [i for i, ch in enumerate(self._sql) if ch == "\n"]
        statements: List[Any] = []
        cur: List[Token] = []
        depth = 0
        last_line = -1
        for idx, t in enumerate(self._tokens):
            if t.kind == "EOF":
                break
            if t.kind == "PUNCT" and t.value == "(":
                depth += 1
            elif t.kind == "PUNCT" and t.value == ")":
                depth -= 1
            if t.kind == "PUNCT" and t.value == ";" and depth == 0:
                if cur:
                    statements.append((cur, t.pos))
                    cur = []
                continue
            line = bisect.bisect_left(newlines, t.pos)
            if (
                depth == 0
                and cur
                and line > last_line
                and self._starts_statement(t, idx)
            ):
                statements.append((cur, t.pos))
                cur = []
            cur.append(t)
            last_line = line
        if cur:
            statements.append((cur, len(self._sql)))
        return statements

    def _starts_statement(self, t: Token, idx: int) -> bool:
        if t.kind != "IDENT" and t.kind != "QIDENT":
            return False
        if t.kind == "IDENT" and t.upper in _STATEMENT_KEYWORDS:
            return True
        # assignment: IDENT [?]= ...
        nxt = self._tokens[idx + 1] if idx + 1 < len(self._tokens) else None
        if nxt is not None and nxt.kind == "OP" and nxt.value in ("=",):
            return True
        if (
            nxt is not None
            and nxt.value == "?"
            and idx + 2 < len(self._tokens)
            and self._tokens[idx + 2].value == "="
        ):
            return True
        return False


class _StatementParser:
    """Cursor over one statement's tokens."""

    def __init__(self, tokens: List[Token], sql: str, end_pos: Optional[int] = None):
        self._tokens = tokens + [Token("EOF", "", -1)]
        self._sql = sql
        self._end_pos = len(sql) if end_pos is None else end_pos
        self._i = 0

    def peek(self, offset: int = 0) -> Token:
        return self._tokens[min(self._i + offset, len(self._tokens) - 1)]

    def next(self) -> Token:
        t = self.peek()
        self._i += 1
        return t

    def done(self) -> bool:
        return self.peek().kind == "EOF"

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
            raise FugueSQLSyntaxError(f"expected {kw}, got {t.value!r}")

    def text_until(self, *stop_kws: str) -> str:
        """Raw source text until a stop keyword at depth 0 (or end)."""
        start_tok = self.peek()
        if start_tok.kind == "EOF":
            return ""
        start = start_tok.pos
        depth = 0
        end = len(self._sql)
        while not self.done():
            t = self.peek()
            if t.kind == "PUNCT" and t.value == "(":
                depth += 1
            elif t.kind == "PUNCT" and t.value == ")":
                depth -= 1
            if depth == 0 and t.kind == "IDENT" and t.upper in stop_kws:
                end = t.pos
                break
            self.next()
            if self.done():
                end = self._end_pos
        return self._sql[start:end].strip()

    def parse_params(self) -> Dict[str, Any]:
        """(a=1, b="x") or PARAMS a:1,b:"x" or a JSON object."""
        params: Dict[str, Any] = {}
        if self.peek().kind == "PUNCT" and self.peek().value == "(":
            self.next()
            while not (self.peek().kind == "PUNCT" and self.peek().value == ")"):
                key = self.next().value
                t = self.next()
                if not (t.value in ("=", ":")):
                    raise FugueSQLSyntaxError(f"expected = or : after {key}")
                params[key] = self._parse_value()
                if self.peek().value == ",":
                    self.next()
            self.next()
        else:
            while True:
                key = self.next().value
                t = self.next()
                if t.value not in ("=", ":"):
                    raise FugueSQLSyntaxError(f"expected = or : after {key}")
                params[key] = self._parse_value()
                if self.peek().value == ",":
                    self.next()
                    continue
                break
        return params

    def _parse_value(self) -> Any:
        t = self.next()
        if t.kind == "STRING":
            return t.value
        if t.kind == "NUMBER":
            return float(t.value) if "." in t.value else int(t.value)
        if t.kind == "IDENT":
            if t.upper == "TRUE":
                return True
            if t.upper == "FALSE":
                return False
            if t.upper == "NULL":
                return None
            return t.value
        if t.kind == "PUNCT" and t.value == "(":  # nested tuple-ish → list
            vals = []
            while not (self.peek().kind == "PUNCT" and self.peek().value == ")"):
                vals.append(self._parse_value())
                if self.peek().value == ",":
                    self.next()
            self.next()
            return vals
        raise FugueSQLSyntaxError(f"invalid value {t.value!r}")


class FugueSQLCompiler:
    """Compile a FugueSQL script into workflow tasks."""

    def __init__(
        self,
        workflow: FugueWorkflow,
        scope_dfs: Dict[str, Any],
        global_vars: Dict[str, Any],
        local_vars: Dict[str, Any],
    ):
        self._wf = workflow
        self._scope: Dict[str, WorkflowDataFrame] = {}
        self._raw_scope = dict(scope_dfs)
        self._gv = global_vars
        self._lv = local_vars
        self._last: Optional[WorkflowDataFrame] = None

    @property
    def last(self) -> Optional[WorkflowDataFrame]:
        return self._last

    def compile(self, sql: str) -> None:
        for tokens, end_pos in _StatementSplitter(sql).split():
            self._compile_statement(_StatementParser(tokens, sql, end_pos), sql)

    # ------------------------------------------------------------------
    def _resolve_df(self, name: str) -> WorkflowDataFrame:
        if name in self._scope:
            return self._scope[name]
        if name in self._raw_scope:
            wdf = self._wf.create_data(self._raw_scope[name])
            self._scope[name] = wdf
            return wdf
        for vars_ in (self._lv, self._gv):
            if name in vars_ and _is_df_like(vars_[name]):
                wdf = self._wf.create_data(vars_[name])
                self._scope[name] = wdf
                return wdf
        raise FugueSQLSyntaxError(f"dataframe {name!r} is not defined")

    def _resolve_ext(self, name: str) -> Any:
        for vars_ in (self._lv, self._gv):
            if name in vars_:
                return vars_[name]
        return name  # registered-name / import-path resolution happens later

    def _compile_statement(self, p: _StatementParser, sql: str) -> None:
        assign: Optional[str] = None
        t0, t1 = p.peek(0), p.peek(1)
        if t0.kind in ("IDENT", "QIDENT") and (
            t0.kind == "QIDENT" or t0.upper not in _STATEMENT_KEYWORDS
        ):
            if t1.kind == "OP" and t1.value == "=":
                assign = t0.value
                p.next()
                p.next()
            elif t1.value == "?" and p.peek(2).value == "=":
                assign = t0.value  # `?=` treated as plain assignment
                p.next()
                p.next()
                p.next()
        result = self._statement_body(p, sql)
        # postfix modifiers on the produced frame
        while result is not None and not p.done():
            if p.eat_kw("PERSIST"):
                result.persist()
            elif p.eat_kw("BROADCAST"):
                result.broadcast()
            elif p.at_kw("WEAK") and p.peek(1).upper == "CHECKPOINT":
                p.next(); p.next()
                result.weak_checkpoint()
            elif p.at_kw("STRONG") and p.peek(1).upper == "CHECKPOINT":
                p.next(); p.next()
                result.strong_checkpoint()
            elif p.at_kw("DETERMINISTIC") and p.peek(1).upper == "CHECKPOINT":
                p.next(); p.next()
                result.deterministic_checkpoint()
            elif p.eat_kw("CHECKPOINT"):
                result.checkpoint()
            elif p.eat_kw("YIELD"):
                self._yield_clause(p, result)
            else:
                t = p.peek()
                raise FugueSQLSyntaxError(f"unexpected {t.value!r} in statement")
        if result is not None:
            if assign is not None:
                self._scope[assign] = result
            self._last = result

    def _yield_clause(self, p: _StatementParser, df: WorkflowDataFrame) -> None:
        local = p.eat_kw("LOCAL")
        if p.eat_kw("DATAFRAME"):
            p.expect_kw("AS")
            df.yield_dataframe_as(p.next().value, as_local=local)
        elif p.eat_kw("FILE"):
            p.expect_kw("AS")
            df.yield_file_as(p.next().value)
        elif p.eat_kw("TABLE"):
            p.expect_kw("AS")
            df.yield_table_as(p.next().value)
        else:
            raise FugueSQLSyntaxError("YIELD must be DATAFRAME, FILE or TABLE")

    # ------------------------------------------------------------------
    def _statement_body(self, p: _StatementParser, sql: str) -> Optional[WorkflowDataFrame]:
        if p.at_kw("CREATE"):
            return self._stmt_create(p)
        if p.at_kw("LOAD"):
            return self._stmt_load(p)
        if p.at_kw("SAVE"):
            self._stmt_save(p)
            return None
        if p.at_kw("TRANSFORM"):
            return self._stmt_transform(p, output=False)
        if p.at_kw("OUTTRANSFORM") or (p.at_kw("OUT") and p.peek(1).upper == "TRANSFORM"):
            if p.eat_kw("OUT"):
                pass
            return self._stmt_transform(p, output=True)
        if p.at_kw("PROCESS"):
            return self._stmt_process(p, output=False)
        if p.at_kw("OUTPUT"):
            self._stmt_process(p, output=True)
            return None
        if p.at_kw("PRINT"):
            self._stmt_print(p)
            return None
        if p.at_kw("SELECT"):
            return self._stmt_select(p, sql)
        if p.at_kw("CONNECT"):
            return self._stmt_connect(p, sql)
        if p.at_kw("TAKE"):
            return self._stmt_take(p)
        if p.at_kw("SAMPLE"):
            return self._stmt_sample(p)
        if p.at_kw("DROP"):
            return self._stmt_drop(p)
        if p.at_kw("FILL"):
            return self._stmt_fill(p)
        if p.at_kw("RENAME"):
            return self._stmt_rename(p)
        if p.at_kw("ALTER"):
            return self._stmt_alter(p)
        if p.at_kw(
            "YIELD", "PERSIST", "BROADCAST", "CHECKPOINT", "DETERMINISTIC",
            "WEAK", "STRONG",
        ):
            # modifier-only statement applies to the previous frame
            df = self._need_last()
            while not p.done():
                if p.eat_kw("YIELD"):
                    self._yield_clause(p, df)
                elif p.eat_kw("PERSIST"):
                    df.persist()
                elif p.eat_kw("BROADCAST"):
                    df.broadcast()
                elif p.at_kw("WEAK") and p.peek(1).upper == "CHECKPOINT":
                    p.next(); p.next(); df.weak_checkpoint()
                elif p.at_kw("STRONG") and p.peek(1).upper == "CHECKPOINT":
                    p.next(); p.next(); df.strong_checkpoint()
                elif p.at_kw("DETERMINISTIC") and p.peek(1).upper == "CHECKPOINT":
                    p.next(); p.next(); df.deterministic_checkpoint()
                elif p.eat_kw("CHECKPOINT"):
                    df.checkpoint()
                else:
                    raise FugueSQLSyntaxError(f"unexpected {p.peek().value!r}")
            return df
        t = p.peek()
        raise FugueSQLSyntaxError(f"unknown statement start {t.value!r}")

    def _need_last(self) -> WorkflowDataFrame:
        if self._last is None:
            raise FugueSQLSyntaxError("no previous dataframe in scope")
        return self._last

    def _opt_from_df(self, p: _StatementParser) -> WorkflowDataFrame:
        if p.eat_kw("FROM"):
            return self._resolve_df(p.next().value)
        t = p.peek()
        if t.kind in ("IDENT", "QIDENT") and t.upper not in _CLAUSE_KEYWORDS and t.upper not in _STATEMENT_KEYWORDS:
            p.next()
            return self._resolve_df(t.value)
        return self._need_last()

    def _opt_df_list(self, p: _StatementParser) -> List[WorkflowDataFrame]:
        dfs: List[WorkflowDataFrame] = []
        while True:
            t = p.peek()
            if t.kind in ("IDENT", "QIDENT") and t.upper not in _CLAUSE_KEYWORDS:
                p.next()
                dfs.append(self._resolve_df(t.value))
                if p.peek().value == ",":
                    p.next()
                    continue
            break
        if len(dfs) == 0 and self._last is not None:
            dfs.append(self._last)
        return dfs

    def _prepartition(self, p: _StatementParser) -> Optional[PartitionSpec]:
        if not p.eat_kw("PREPARTITION"):
            return None
        kwargs: Dict[str, Any] = {}
        if p.peek().kind == "NUMBER":
            kwargs["num"] = int(p.next().value)
        if p.eat_kw("BY"):
            cols = []
            while True:
                cols.append(p.next().value)
                if p.peek().value == ",":
                    p.next()
                    continue
                break
            kwargs["by"] = cols
        if p.eat_kw("PRESORT"):
            parts = []
            while True:
                name = p.next().value
                direction = ""
                if p.at_kw("ASC", "DESC"):
                    direction = " " + p.next().value
                parts.append(name + direction)
                if p.peek().value == ",":
                    p.next()
                    continue
                break
            kwargs["presort"] = ",".join(parts)
        return PartitionSpec(**kwargs)

    # -- statements ------------------------------------------------------
    def _stmt_create(self, p: _StatementParser) -> WorkflowDataFrame:
        p.expect_kw("CREATE")
        if p.eat_kw("USING"):
            ext = self._resolve_ext(p.next().value)
            params = {}
            if p.peek().value == "(":
                params = p.parse_params()
            schema = None
            if p.eat_kw("SCHEMA"):
                schema = p.text_until("PARAMS", "YIELD", "PERSIST", "BROADCAST", "CHECKPOINT")
            if p.eat_kw("PARAMS"):
                params.update(p.parse_params())
            return self._wf.create(ext, schema=schema, params=params)
        # inline data: [[...],[...]] SCHEMA s
        data_text = p.text_until("SCHEMA")
        p.expect_kw("SCHEMA")
        schema = p.text_until(
            "YIELD", "PERSIST", "BROADCAST", "CHECKPOINT", "DETERMINISTIC",
            "WEAK", "STRONG",
        )
        try:
            data = json.loads(data_text)
        except json.JSONDecodeError as e:
            raise FugueSQLSyntaxError(f"invalid inline data {data_text!r}") from e
        return self._wf.df(data, schema)

    def _stmt_load(self, p: _StatementParser) -> WorkflowDataFrame:
        p.expect_kw("LOAD")
        fmt = ""
        if p.at_kw("PARQUET", "CSV", "JSON"):
            fmt = p.next().value.lower()
        t = p.next()
        if t.kind != "STRING":
            raise FugueSQLSyntaxError("LOAD path must be a quoted string")
        params: Dict[str, Any] = {}
        if p.peek().value == "(":
            params = p.parse_params()
        columns = None
        if p.eat_kw("COLUMNS"):
            columns = p.text_until(
                "YIELD", "PERSIST", "BROADCAST", "CHECKPOINT",
            )
            if ":" not in columns:
                columns = [c.strip() for c in columns.split(",")]
        return self._wf.load(t.value, fmt=fmt, columns=columns, **params)

    def _stmt_save(self, p: _StatementParser) -> None:
        p.expect_kw("SAVE")
        df = self._opt_from_df(p)
        spec = self._prepartition(p)
        mode = "overwrite"
        if p.eat_kw("OVERWRITE"):
            mode = "overwrite"
        elif p.eat_kw("APPEND"):
            mode = "append"
        elif p.eat_kw("TO"):
            mode = "error"
        single = p.eat_kw("SINGLE")
        fmt = ""
        if p.at_kw("PARQUET", "CSV", "JSON"):
            fmt = p.next().value.lower()
        t = p.next()
        if t.kind != "STRING":
            raise FugueSQLSyntaxError("SAVE path must be a quoted string")
        params: Dict[str, Any] = {}
        if p.peek().value == "(":
            params = p.parse_params()
        df.save(t.value, fmt=fmt, mode=mode, partition=spec, single=single, **params)

    def _stmt_transform(self, p: _StatementParser, output: bool) -> Optional[WorkflowDataFrame]:
        p.next()  # TRANSFORM / OUTTRANSFORM
        dfs = self._opt_df_list(p)
        spec = self._prepartition(p)
        p.expect_kw("USING")
        ext = self._resolve_ext(p.next().value)
        params: Dict[str, Any] = {}
        if p.peek().value == "(":
            params = p.parse_params()
        schema = None
        if p.eat_kw("SCHEMA"):
            schema = p.text_until(
                "PARAMS", "CALLBACK", "YIELD", "PERSIST", "BROADCAST",
                "CHECKPOINT", "DETERMINISTIC", "WEAK", "STRONG",
            )
        if p.eat_kw("PARAMS"):
            params.update(p.parse_params())
        callback = None
        if p.eat_kw("CALLBACK"):
            callback = self._resolve_ext(p.next().value)
        src = dfs[0] if len(dfs) == 1 else self._wf.zip(*dfs, partition=spec)
        if output:
            self._wf.out_transform(
                src, using=ext, params=params,
                pre_partition=spec, callback=callback,
                global_vars=self._gv, local_vars=self._lv,
            )
            return None
        return self._wf.transform(
            src, using=ext, schema=schema, params=params,
            pre_partition=spec, callback=callback,
            global_vars=self._gv, local_vars=self._lv,
        )

    def _stmt_process(self, p: _StatementParser, output: bool) -> Optional[WorkflowDataFrame]:
        p.next()  # PROCESS / OUTPUT
        dfs = self._opt_df_list(p)
        spec = self._prepartition(p)
        p.expect_kw("USING")
        ext = self._resolve_ext(p.next().value)
        params: Dict[str, Any] = {}
        if p.peek().value == "(":
            params = p.parse_params()
        schema = None
        if p.eat_kw("SCHEMA"):
            schema = p.text_until("PARAMS", "YIELD", "PERSIST", "BROADCAST", "CHECKPOINT")
        if p.eat_kw("PARAMS"):
            params.update(p.parse_params())
        if output:
            self._wf.output(
                *dfs, using=ext, params=params, pre_partition=spec,
                global_vars=self._gv, local_vars=self._lv,
            )
            return None
        return self._wf.process(
            *dfs, using=ext, schema=schema, params=params, pre_partition=spec,
            global_vars=self._gv, local_vars=self._lv,
        )

    def _stmt_print(self, p: _StatementParser) -> None:
        p.expect_kw("PRINT")
        n = 10
        if p.peek().kind == "NUMBER":
            n = int(p.next().value)
            p.eat_kw("ROWS") or p.eat_kw("ROW")
        dfs = []
        if p.eat_kw("FROM"):
            while True:
                dfs.append(self._resolve_df(p.next().value))
                if p.peek().value == ",":
                    p.next()
                    continue
                break
        else:
            t = p.peek()
            if t.kind in ("IDENT", "QIDENT") and t.upper not in ("ROWCOUNT", "TITLE"):
                dfs.append(self._resolve_df(p.next().value))
        if len(dfs) == 0:
            dfs.append(self._need_last())
        with_count = p.eat_kw("ROWCOUNT")
        title = None
        if p.eat_kw("TITLE"):
            t = p.next()
            title = t.value
        self._wf.show(*dfs, n=n, with_count=with_count, title=title)

    def _stmt_connect(self, p: _StatementParser, sql: str) -> WorkflowDataFrame:
        """``CONNECT <engine> [PARAMS k=v,...] SELECT ...`` — run ONE select
        on a specific SQL engine (the reference's engine-specific query,
        ``fugue/sql/_visitors.py:728-760``)."""
        p.expect_kw("CONNECT")
        parts: List[str] = [p.next().value]
        while p.peek().value == "." or (
            p.peek().kind == "IDENT"
            and not p.at_kw("SELECT")
            and not p.at_kw("PARAMS")
        ):
            parts.append(p.next().value)
        engine = "".join(parts)
        params: Dict[str, Any] = {}
        if p.eat_kw("PARAMS"):
            params = p.parse_params()
        if not p.at_kw("SELECT"):
            raise FugueSQLSyntaxError("CONNECT must be followed by SELECT")
        return self._stmt_select(p, sql, sql_engine=engine, sql_engine_params=params)

    def _stmt_select(
        self,
        p: _StatementParser,
        sql: str,
        sql_engine: Any = None,
        sql_engine_params: Optional[Dict[str, Any]] = None,
    ) -> WorkflowDataFrame:
        text = p.text_until(
            "PERSIST", "BROADCAST", "CHECKPOINT", "DETERMINISTIC", "WEAK",
            "STRONG", "YIELD",
        )
        compile_dialect = str(self._wf.conf.get(FUGUE_CONF_SQL_DIALECT, "spark")).lower()
        if compile_dialect not in ("spark", "fugue"):
            # a SELECT written in a foreign dialect goes to the in-tree one
            # before parsing; an unknown dialect raises here, where a
            # passthrough would parse foreign quoting as strings
            from ..collections.sql import transpile_sql
            from .dialect import get_dialect

            get_dialect(compile_dialect)
            text = transpile_sql(text, compile_dialect, "fugue")
        # find referenced table names: parse and collect Scan nodes
        from .parser import SQLParser, Scan as ScanNode, PlanNode, JoinNode, Subquery, SelectNode, SetOpNode, SortNode, LimitNode

        plan = SQLParser(text).parse_full()
        names: List[str] = []

        def walk_expr(e: Any) -> None:
            # subquery expressions reference tables of their own
            from .parser import (
                _SubqueryExistsExpr,
                _SubqueryInExpr,
                _SubqueryScalarExpr,
            )

            if isinstance(
                e, (_SubqueryScalarExpr, _SubqueryInExpr, _SubqueryExistsExpr)
            ):
                walk(e.plan)
            for c in getattr(e, "children", []):
                walk_expr(c)

        def walk(n: PlanNode) -> None:
            if isinstance(n, ScanNode):
                if n.name not in names:
                    names.append(n.name)
            elif isinstance(n, Subquery):
                walk(n.child)
            elif isinstance(n, JoinNode):
                walk(n.left)
                walk(n.right)
            elif isinstance(n, SetOpNode):
                walk(n.left)
                walk(n.right)
            elif isinstance(n, (SortNode, LimitNode)):
                walk(n.child)
            elif isinstance(n, SelectNode):
                if n.child is not None:
                    walk(n.child)
                for c in n.projections:
                    walk_expr(c)
                if n.where is not None:
                    walk_expr(n.where)
                if n.having is not None:
                    walk_expr(n.having)

        walk(plan)
        if len(names) == 0:
            # no FROM → operate on the previous frame as table "_0"
            prev = self._need_last()
            text2 = _inject_from(text)
            return self._wf.select(
                *_interleave(text2, {"_0": prev}),
                sql_engine=sql_engine,
                sql_engine_params=sql_engine_params,
            )
        mapping = {n: self._resolve_df(n) for n in names}
        return self._wf.select(
            *_interleave(text, mapping),
            sql_engine=sql_engine,
            sql_engine_params=sql_engine_params,
        )

    def _stmt_take(self, p: _StatementParser) -> WorkflowDataFrame:
        p.expect_kw("TAKE")
        n = int(p.next().value)
        p.eat_kw("ROWS") or p.eat_kw("ROW")
        df = self._opt_from_df(p)
        spec = self._prepartition(p)
        presort = ""
        if p.eat_kw("PRESORT"):
            presort = p.text_until("YIELD", "PERSIST", "BROADCAST", "CHECKPOINT")
        if spec is not None:
            df = df.partition(spec)
        return df.take(n, presort=presort)

    def _stmt_sample(self, p: _StatementParser) -> WorkflowDataFrame:
        p.expect_kw("SAMPLE")
        replace = p.eat_kw("REPLACE")
        num = p.next()
        n: Optional[int] = None
        frac: Optional[float] = None
        if p.eat_kw("ROWS") or p.eat_kw("ROW"):
            n = int(num.value)
        elif p.eat_kw("PERCENT"):
            frac = float(num.value) / 100.0
        else:
            raise FugueSQLSyntaxError("SAMPLE needs ROWS or PERCENT")
        seed = None
        if p.eat_kw("SEED"):
            seed = int(p.next().value)
        df = self._opt_from_df(p)
        return df.sample(n=n, frac=frac, replace=replace, seed=seed)

    def _stmt_drop(self, p: _StatementParser) -> WorkflowDataFrame:
        p.expect_kw("DROP")
        if p.eat_kw("ROWS"):
            p.expect_kw("IF")
            how = "any"
            if p.eat_kw("ALL"):
                how = "all"
            else:
                p.eat_kw("ANY")
            p.eat_kw("NULLS") or p.eat_kw("NULL")
            subset = None
            if p.eat_kw("ON"):
                subset = []
                while True:
                    subset.append(p.next().value)
                    if p.peek().value == ",":
                        p.next()
                        continue
                    break
            df = self._opt_from_df(p)
            return df.dropna(how=how, subset=subset)
        p.expect_kw("COLUMNS")
        cols = []
        while True:
            cols.append(p.next().value)
            if p.peek().value == ",":
                p.next()
                continue
            break
        if_exists = False
        if p.eat_kw("IF"):
            p.expect_kw("EXISTS")
            if_exists = True
        df = self._opt_from_df(p)
        return df.drop(cols, if_exists=if_exists)

    def _stmt_fill(self, p: _StatementParser) -> WorkflowDataFrame:
        p.expect_kw("FILL")
        p.eat_kw("NULLS") or p.eat_kw("NULL")
        p.eat_kw("PARAMS")
        params = p.parse_params()
        df = self._opt_from_df(p)
        return df.fillna(dict(params))

    def _stmt_rename(self, p: _StatementParser) -> WorkflowDataFrame:
        p.expect_kw("RENAME")
        p.expect_kw("COLUMNS")
        mapping: Dict[str, str] = {}
        while True:
            old = p.next().value
            t = p.next()
            if t.value != ":":
                raise FugueSQLSyntaxError("RENAME COLUMNS uses old:new pairs")
            mapping[old] = p.next().value
            if p.peek().value == ",":
                p.next()
                continue
            break
        df = self._opt_from_df(p)
        return df.rename(mapping)

    def _stmt_alter(self, p: _StatementParser) -> WorkflowDataFrame:
        p.expect_kw("ALTER")
        p.expect_kw("COLUMNS")
        schema = p.text_until("FROM", "YIELD", "PERSIST", "BROADCAST", "CHECKPOINT")
        df = self._opt_from_df(p)
        return df.alter_columns(schema)


def _is_df_like(obj: Any) -> bool:
    import pandas as pd
    import pyarrow as pa

    from ..collections.yielded import Yielded

    return isinstance(obj, (DataFrame, pd.DataFrame, pa.Table, Yielded, WorkflowDataFrame))


def _inject_from(text: str) -> str:
    """Append ``FROM _0`` to a SELECT with no FROM clause."""
    upper = text.upper()
    for kw in (" WHERE ", " GROUP ", " HAVING ", " ORDER ", " LIMIT "):
        idx = upper.find(kw)
        if idx >= 0:
            return text[:idx] + " FROM _0 " + text[idx:]
    return text + " FROM _0"


def _interleave(sql: str, mapping: Dict[str, WorkflowDataFrame]) -> List[Any]:
    """Split SQL text into [str, WorkflowDataFrame, str, ...] pieces for
    ``FugueWorkflow.select``. Token-aware: only IDENT tokens are replaced,
    never content inside string literals or quoted identifiers."""
    if len(mapping) == 0:
        return [sql]
    parts: List[Any] = []
    pos = 0
    for t in tokenize(sql):
        if t.kind in ("IDENT", "QIDENT") and t.value in mapping:
            if t.pos > pos:
                parts.append(sql[pos : t.pos])
            parts.append(mapping[t.value])
            # QIDENT spans include the backticks in the source
            pos = t.pos + len(t.value) + (2 if t.kind == "QIDENT" else 0)
    if pos < len(sql):
        parts.append(sql[pos:])
    return parts


# ---------------------------------------------------------------------------
# public api
# ---------------------------------------------------------------------------


class FugueSQLWorkflow(FugueWorkflow):
    """FugueWorkflow with ``__call__(sql)`` compiling FugueSQL
    (reference ``fugue/sql/workflow.py:17``)."""

    def __init__(self, compile_conf: Any = None):
        super().__init__(compile_conf)
        self._sql_vars: Dict[str, Any] = {}

    def __call__(self, code: str, *args: Any, **kwargs: Any) -> None:
        global_vars, local_vars = get_caller_global_local_vars()
        variables = dict(self._sql_vars)
        for a in args:
            if isinstance(a, dict):
                variables.update(a)
        variables.update(kwargs)
        code = fill_sql_template(code, {**local_vars, **variables})
        compiler = FugueSQLCompiler(
            self,
            {k: v for k, v in variables.items() if _is_df_like(v)},
            global_vars,
            local_vars,
        )
        compiler.compile(code)
        self._sql_vars.update(
            {k: v for k, v in compiler._scope.items()}
        )


def fill_sql_template(template: str, variables: Dict[str, Any]) -> str:
    """Jinja-fill the template (reference uses the same mechanism)."""
    if "{{" not in template and "{%" not in template:
        return template
    import jinja2

    safe = {
        k: v
        for k, v in variables.items()
        if isinstance(k, str) and k.isidentifier() and not k.startswith("__")
        and not _is_df_like(v)
    }
    return jinja2.Template(template).render(safe)


def fugue_sql(
    query: str,
    *args: Any,
    engine: Any = None,
    engine_conf: Any = None,
    device: Any = None,
    as_fugue: bool = False,
    as_local: bool = False,
    **kwargs: Any,
) -> Any:
    """Run FugueSQL on ``engine`` (``device``, ``engine_conf``: see
    ``FugueWorkflow.run``) and return the LAST statement's frame: a frame
    of the engine with ``as_fugue``, else what it wraps."""
    from ..dataframe.api import get_native_as_df

    dag = fugue_sql_flow(query, *args, **kwargs)
    last = dag._last_compiled
    if last is None:
        raise FugueSQLSyntaxError("fugue_sql requires the last statement to output a dataframe")
    last.yield_dataframe_as("__fugue_sql_result__", as_local=as_local)
    dag.run(engine, engine_conf, device=device)
    result = dag.yields["__fugue_sql_result__"].result
    dag.release_task_results()  # free the intermediates now, not at cyclic GC
    return result if as_fugue else get_native_as_df(result)


def fugue_sql_flow(query: str, *args: Any, **kwargs: Any) -> "FugueSQLWorkflow":
    """Compile FugueSQL into a workflow you can run (reference ``:111``)."""
    global_vars, local_vars = get_caller_global_local_vars()
    dag = FugueSQLWorkflow()
    variables: Dict[str, Any] = {}
    for a in args:
        if isinstance(a, dict):
            variables.update(a)
    variables.update(kwargs)
    code = fill_sql_template(query, {**local_vars, **variables})
    compiler = FugueSQLCompiler(
        dag,
        {k: v for k, v in variables.items() if _is_df_like(v)},
        global_vars,
        local_vars,
    )
    compiler.compile(code)
    dag._last_compiled = compiler.last  # type: ignore
    return dag
