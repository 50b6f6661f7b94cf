"""AST trace of plain-Python pandas UDFs, copied from
``fugue_tpu/analysis/analyzer.py``.

``analyze_transform_task`` inspects the function behind a ``transform``
task and produces a :class:`UdfAnalysis`: exact column read/write sets, a
purity/determinism/row-locality verdict, and — when every statement falls
inside the recognized shape subset — a translation into the step tuples
(``("assign", ...)`` / ``("filter", ...)`` / ...) that the fusion and
segment-lowering passes already compile.

The walk degrades in tiers, never upward:

- **translatable** — every statement is a recognized row-local shape
  (column arithmetic/comparisons/masks, ``fillna``/``clip``/``where``/
  ``mask``/``isin``/``astype``/``np.where``, statically-decidable ``if``
  over bound scalar params). ``steps`` holds the translation.
  Comparisons translate where a NULL gives the same rows in both logics:
  as a filter's or a conditional's test, alone or under ``&``/``|``.
  Where pandas' two-valued answer (a NULL compares False, and ``!=``
  True) and the column IR's NULL part ways, the shape refuses as
  ``unknown-construct``: ``!=``, ``~`` over a comparison, and a
  comparison kept as a column's value.
- **pure** — recognized constructs only, but something crosses rows
  (a ``.sum()``-style reduction, a data-dependent ``if``): no steps, but
  reads/writes stay EXACT, so pruning still reaches the producer.
- **opaque** — an unrecognized construct (global reads, ``.apply``,
  loops, unknown methods, aliasing): reads/writes collapse to ALL and the
  UDF keeps today's fully conservative treatment.

Function traces are cached by the UDF fingerprint
(``fugue_tpu_torch/cache/fingerprint.py`` ``_callable_fp``: source +
defaults + closure cells) plus the bound parameter values, so an EDITED
udf or a different closure re-analyzes while repeated runs hit the cache.
"""

import ast
import inspect
import textwrap
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

from ..column.expressions import (
    ColumnExpr,
    _BinaryOpExpr,
    _InExpr,
    case_when,
    col as _col,
    function as _function,
    lit as _lit,
)
from ..schema import Schema

__all__ = [
    "AnalysisStats",
    "REASON_CODES",
    "UdfAnalysis",
    "analyze_transform_task",
    "transform_row_local",
]

# canonical refusal codes — a BOUNDED vocabulary (the keys of
# engine.analysis_stats' ``refused``; free-form detail stays in the
# human-readable reason rendered by workflow.explain()/lint())
REASON_CODES = (
    "signature",  # not a plain pandas-in/pandas-out interfaceless function
    "source",  # no retrievable source
    "globals",  # reads a module-level name (not a whitelisted module)
    "mutable-closure",  # closes over a non-scalar value
    "param",  # non-scalar / unbound extra parameter
    "reduction",  # crosses rows (.sum()/.mean()/... ) — pure, not row-local
    "conditional",  # data-dependent control flow
    "loop",  # for/while
    "apply",  # .apply/.map/lambda escape hatch
    "unknown-call",  # unrecognized function or method
    "unknown-construct",  # any other unrecognized statement/expression
    "aliasing",  # references a superseded frame variable
    "non-deterministic",  # @non_deterministic or np.random/time usage
    "callback",  # RPC callback wired in
    "ignore-errors",  # partition-dropping error swallowing
    "validation-rules",  # schema/partition validation rules attached
    "partitioned",  # non-empty partition spec (row order depends on exchange)
    "schema",  # unsupported output schema form
    "pinned",  # checkpointed task (storage identity is uuid-keyed)
    "input-schema",  # producer schema unknown at plan time
    "disabled",  # fugue.tpu.plan.translate_udfs=false
    "error",  # analyzer crashed — treated as opaque
)

_UNKNOWN = object()  # a scalar whose value is only known at run time


class _Hard(Exception):
    """Unrecognized construct: facts collapse to ALL."""

    def __init__(self, code: str, detail: str):
        super().__init__(detail)
        self.code = code
        self.detail = detail


class _Soft(Exception):
    """Recognized but untranslatable (reduction, data-dependent if):
    translation dies, exact facts survive."""

    def __init__(self, code: str, detail: str):
        super().__init__(detail)
        self.code = code
        self.detail = detail


class UdfAnalysis:
    """Per-task analysis result. ``reads``/``writes`` are ``None`` when
    unknowable (the conservative ALL); ``steps`` is the micro-step
    translation (final schema-shaping select is built by the expansion
    pass, which knows the producer's column names)."""

    __slots__ = (
        "name",
        "fp",
        "reads",
        "writes",
        "pure",
        "deterministic",
        "row_local",
        "steps",
        "star",
        "declared",
        "schema_ok",
        "reason",
        "code",
        "required_extra",
    )

    def __init__(self) -> None:
        self.name = "<udf>"
        self.fp = ""
        self.reads: Optional[Set[str]] = None
        self.writes: Optional[Set[str]] = None
        self.pure = False
        self.deterministic = False
        self.row_local = False
        self.steps: Optional[List[Tuple]] = None
        self.star = False
        self.declared: List[Tuple[str, Any]] = []
        self.schema_ok = False
        self.reason: Optional[str] = None
        self.code: Optional[str] = None
        self.required_extra: Set[str] = set()

    @property
    def facts_ok(self) -> bool:
        return self.reads is not None and self.writes is not None

    @property
    def verdict(self) -> str:
        if self.steps is not None:
            return "translatable"
        if self.pure:
            return "pure"
        return "opaque"

    @property
    def new_names(self) -> Set[str]:
        return {n for n, _ in self.declared}

    def describe(self) -> str:
        tag = f"udf {self.name}[{self.fp}]"
        if self.steps is not None:
            return f"{tag}: translatable ({len(self.steps)} step(s))"
        why = self.reason or self.code or "?"
        return f"{tag}: {self.verdict}, interpreted -- {why}"


class AnalysisStats:
    """Engine-level analyzer counters (``engine.analysis_stats``). Locked
    as ``PlanStats`` is: workflows on several threads may share one
    engine."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.udfs_analyzed = 0
            self.udfs_translated = 0
            self.udfs_refused = 0
            self.refused: Dict[str, int] = {}

    def absorb(self, diags: List[Dict[str, Any]]) -> None:
        with self._lock:
            for d in diags:
                self.udfs_analyzed += 1
                if d.get("translated"):
                    self.udfs_translated += 1
                else:
                    self.udfs_refused += 1
                    code = str(d.get("code") or "unknown-construct")
                    if code not in REASON_CODES:
                        code = "unknown-construct"
                    self.refused[code] = self.refused.get(code, 0) + 1

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "udfs_analyzed": self.udfs_analyzed,
                "udfs_translated": self.udfs_translated,
                "udfs_refused": self.udfs_refused,
                "refused": dict(self.refused),
            }


# ---------------------------------------------------------------------------
# function-level trace
# ---------------------------------------------------------------------------


class _FuncTrace:
    __slots__ = ("steps", "reads", "writes", "pure", "reason", "code")

    def __init__(self) -> None:
        self.steps: Optional[List[Tuple]] = []
        self.reads: Optional[Set[str]] = set()
        self.writes: Optional[Set[str]] = set()
        self.pure = True
        self.reason: Optional[str] = None
        self.code: Optional[str] = None


# recognized series reductions (pure, NOT row-local)
_REDUCTIONS = {"sum", "mean", "min", "max", "count", "median", "std", "var"}

# every method/function name the tracer recognizes as side-effect-free —
# the facts-only scanner keeps the purity verdict only for these
_PURE_METHODS = _REDUCTIONS | {
    "fillna", "clip", "where", "mask", "isna", "isnull", "notna",
    "notnull", "abs", "round", "isin", "astype", "copy", "reset_index",
    "rename", "drop", "assign", "sqrt", "exp", "log", "floor", "ceil",
    "isnan",
}

# pandas dtype spellings → fugue schema type expressions
_DTYPES = {
    "int": "long",
    "int64": "long",
    "int32": "int",
    "int16": "short",
    "float": "double",
    "float64": "double",
    "float32": "float",
    "bool": "bool",
    "str": "str",
}

_NP_FUNCS = {
    "abs": "ABS",
    "sqrt": "SQRT",
    "exp": "EXP",
    "log": "LN",
    "floor": "FLOOR",
    "ceil": "CEIL",
}

_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.BitAnd: lambda a, b: a & b,
    ast.BitOr: lambda a, b: a | b,
}

_CMPOPS = {
    ast.Lt: lambda a, b: a < b,
    ast.LtE: lambda a, b: a <= b,
    ast.Gt: lambda a, b: a > b,
    ast.GtE: lambda a, b: a >= b,
    ast.Eq: lambda a, b: a == b,
    ast.NotEq: lambda a, b: a != b,
}

_SCALARS = (bool, int, float, str, bytes, type(None))


def _holds_compare(e: ColumnExpr) -> bool:
    """Whether a comparison is in ``e``'s tree: over a NULL, pandas
    answers it False and the column IR NULL."""
    if isinstance(e, _BinaryOpExpr) and e.op in ("<", "<=", ">", ">=", "==", "!="):
        return True
    return any(_holds_compare(c) for c in e.children)


def _as_value(e: ColumnExpr) -> ColumnExpr:
    """``e`` where it becomes a column's values: a comparison, or ``&``
    / ``|`` over one, would hold NULL where pandas holds False."""
    if isinstance(e, _BinaryOpExpr) and e.op in ("&", "|", "<", "<=", ">", ">=", "==") and _holds_compare(e):
        raise _Soft("unknown-construct", "a comparison kept as a column: pandas' False, the IR's NULL")
    return e


class _Tracer:
    def __init__(self, func: Any, bound: Dict[str, Any]):
        self.func = func
        self.bound = bound
        self.t = _FuncTrace()
        self.env: Dict[str, Any] = {}
        # bound Series expressions (``m = df["x"] > 0``): valid only until
        # the next frame-mutating step — pandas captured the VALUES, a
        # name-based re-evaluation later would see different ones
        self.series_env: Dict[str, Tuple[int, ColumnExpr]] = {}
        self.series_gen = 0
        self.modules: Dict[str, str] = {}  # name -> "numpy" | "pandas"
        self.frame = ""  # current frame variable
        self.retired: Set[str] = set()
        self.returned = False

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> _FuncTrace:
        try:
            body = self._parse()
            self._bind()
            self._block(body)
            if not self.returned:
                raise _Hard("unknown-construct", "no plain frame return")
        except _Hard as h:
            self.t.steps = None
            self.t.reads = None
            self.t.writes = None
            self.t.pure = False
            self.t.code, self.t.reason = h.code, h.detail
        except _Soft:  # pragma: no cover - softs are absorbed per-statement
            pass
        return self.t

    def _parse(self) -> List[ast.stmt]:
        try:
            src = textwrap.dedent(inspect.getsource(self.func))
            tree = ast.parse(src)
        except Exception:
            raise _Hard("source", "source not retrievable")
        fn = tree.body[0] if tree.body else None
        if not isinstance(fn, ast.FunctionDef):
            raise _Hard("source", "not a plain function definition")
        a = fn.args
        if a.vararg is not None or a.kwarg is not None:
            raise _Hard("signature", "*args/**kwargs signature")
        names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        if len(names) == 0:
            raise _Hard("signature", "no dataframe argument")
        self.frame = names[0]
        # bind remaining parameters to their task-provided / default values
        defaults: Dict[str, Any] = {}
        try:
            for p in inspect.signature(self.func).parameters.values():
                if p.default is not inspect.Parameter.empty:
                    defaults[p.name] = p.default
        except Exception:
            pass
        for n in names[1:]:
            v = self.bound[n] if n in self.bound else defaults.get(n, _UNKNOWN)
            if v is _UNKNOWN or not isinstance(v, _SCALARS):
                raise _Hard("param", f"parameter {n!r} is not a bound scalar")
            self.env[n] = v
        return fn.body

    def _bind(self) -> None:
        code = getattr(self.func, "__code__", None)
        closure = getattr(self.func, "__closure__", None)
        if code is not None and closure:
            for name, cell in zip(code.co_freevars, closure):
                try:
                    v = cell.cell_contents
                except ValueError:
                    raise _Hard("mutable-closure", f"unbound cell {name!r}")
                if isinstance(v, _SCALARS):
                    self.env[name] = v
                elif inspect.ismodule(v) and v.__name__.split(".")[0] in (
                    "numpy",
                    "pandas",
                ):
                    self.modules[name] = v.__name__.split(".")[0]
                else:
                    raise _Hard(
                        "mutable-closure",
                        f"closes over {type(v).__name__} {name!r}",
                    )

    # -- statements --------------------------------------------------------
    def _block(self, body: List[ast.stmt]) -> None:
        for i, s in enumerate(body):
            if self.returned:
                return  # unreachable code can't affect behavior
            if (
                i == 0
                and isinstance(s, ast.Expr)
                and isinstance(s.value, ast.Constant)
                and isinstance(s.value.value, str)
            ):
                continue  # docstring
            try:
                self._stmt(s)
            except _Soft as sf:
                self._die(sf.code, sf.detail)
                self._facts_stmt(s)

    def _die(self, code: str, detail: str) -> None:
        """Translation (and row-locality) die; exact facts survive."""
        self.t.steps = None
        if self.t.code is None:
            self.t.code, self.t.reason = code, detail

    def _emit(self, step: Tuple) -> None:
        self.series_gen += 1  # any frame mutation staleness-marks bound series
        if self.t.steps is not None:
            self.t.steps.append(step)

    def _stmt(self, s: ast.stmt) -> None:
        if isinstance(s, ast.Return):
            if s.value is None:
                raise _Hard("unknown-construct", "returns nothing")
            steps = self._frame_expr(s.value)
            if steps is None:
                raise _Hard("unknown-construct", "returns a non-frame value")
            for st in steps:
                self._emit(st)
            self.returned = True
            return
        if isinstance(s, ast.Assign):
            if len(s.targets) != 1:
                raise _Hard("unknown-construct", "chained assignment")
            self._assign(s.targets[0], s.value)
            return
        if isinstance(s, ast.AnnAssign):
            if s.value is None:
                return
            self._assign(s.target, s.value)
            return
        if isinstance(s, ast.AugAssign):
            if type(s.op) not in _BINOPS:
                raise _Hard("unknown-construct", "augmented op")
            tgt_load = ast.parse(ast.unparse(s.target), mode="eval").body
            bin_ = ast.BinOp(left=tgt_load, op=s.op, right=s.value)
            ast.copy_location(bin_, s)
            ast.fix_missing_locations(bin_)
            self._assign(s.target, bin_)
            return
        if isinstance(s, ast.If):
            known, v = self._static(s.test)
            if known:
                self._block(s.body if v else s.orelse)
                return
            # data-dependent branch: translation dies; reads/writes of BOTH
            # arms (and the test) are still exact facts
            self._die("conditional", "data-dependent if")
            self._facts_node(s.test)
            for st in s.body + s.orelse:
                self._facts_stmt(st)
            return
        if isinstance(s, ast.Expr):
            raise _Hard("unknown-construct", "expression statement (no effect)")
        if isinstance(s, ast.Pass):
            return
        if isinstance(s, (ast.For, ast.While)):
            raise _Hard("loop", "loop over data")
        if isinstance(s, (ast.Global, ast.Nonlocal)):
            raise _Hard("globals", "global/nonlocal declaration")
        raise _Hard("unknown-construct", type(s).__name__.lower())

    def _assign(self, target: ast.expr, value: ast.expr) -> None:
        # df["z"] = <expr>
        if isinstance(target, ast.Subscript) and self._is_frame(target.value):
            name = self._const_str(target.slice)
            if name is None:
                raise _Hard("unknown-construct", "non-literal column target")
            e = _as_value(self._expr(value))
            if self.t.writes is not None:
                self.t.writes.add(name)
            self._emit(("assign", (e.alias(name),)))
            return
        if isinstance(target, ast.Name):
            # rebinding the frame to a transformed frame
            steps = self._frame_expr(value)
            if steps is not None:
                for st in steps:
                    self._emit(st)
                if target.id != self.frame:
                    self.retired.add(self.frame)
                    self.retired.discard(target.id)
                    self.frame = target.id
                self.series_env.pop(target.id, None)
                self.env.pop(target.id, None)
                return
            if target.id == self.frame:
                raise _Hard("aliasing", "frame variable rebound to a non-frame")
            # scalar binding (constants / arithmetic over known scalars)
            known, v = self._static(value)
            if known:
                self.env[target.id] = v
                self.series_env.pop(target.id, None)
                return
            # a bound Series expression, or a recognized reduction →
            # runtime scalar (pure, not row-local)
            try:
                e = self._expr(value)
            except _Soft as sf:
                self.env[target.id] = _UNKNOWN
                self.series_env.pop(target.id, None)
                raise sf
            self.series_env[target.id] = (self.series_gen, e)
            self.env.pop(target.id, None)
            return
        raise _Hard("unknown-construct", "assignment target")

    # -- facts-only scanning (after translation died) ----------------------
    def _facts_stmt(self, s: ast.stmt) -> None:
        try:
            if isinstance(s, (ast.Assign, ast.AugAssign)):
                if isinstance(s, ast.Assign) and len(s.targets) != 1:
                    raise _Hard("unknown-construct", "chained assignment")
                t0 = s.targets[0] if isinstance(s, ast.Assign) else s.target
                if isinstance(t0, ast.Subscript) and self._is_frame(t0.value):
                    name = self._const_str(t0.slice)
                    if name is None:
                        # unknown written column set: facts must collapse
                        raise _Hard(
                            "unknown-construct", "non-literal column target"
                        )
                    if self.t.writes is not None:
                        self.t.writes.add(name)
                    if isinstance(s, ast.AugAssign):
                        # the augmented op also READS the target
                        if self.t.reads is not None:
                            self.t.reads.add(name)
                    self._facts_node(s.value)
                    return
                if isinstance(t0, ast.Name):
                    self.env.setdefault(t0.id, _UNKNOWN)
                    self._facts_node(s.value)
                    return
                raise _Hard("unknown-construct", "assignment target form")
            if isinstance(s, ast.Return) and s.value is not None:
                self._facts_node(s.value)
                self.returned = True
                return
            if isinstance(s, ast.If):
                self._facts_node(s.test)
                for st in s.body + s.orelse:
                    self._facts_stmt(st)
                return
            self._facts_node(s)
        except _Hard as h:
            # facts themselves are unknowable
            self.t.reads = None
            self.t.writes = None
            self.t.pure = False
            if self.t.code is None:
                self.t.code, self.t.reason = h.code, h.detail

    def _facts_node(self, node: ast.AST) -> None:
        """Collect column reads; any opaque frame use collapses to ALL.
        A method call outside the recognized-pure set clears the purity
        verdict (reads stay exact — pruning is sound for impure UDFs)."""
        if isinstance(node, ast.Subscript) and self._is_frame(node.value):
            name = self._const_str(node.slice)
            if name is not None:
                if self.t.reads is not None:
                    self.t.reads.add(name)
                self._facts_node(node.slice)
                return
            self._facts_node(node.slice)
            return
        if isinstance(node, ast.Name) and self._is_frame(node):
            raise _Hard("unknown-construct", "opaque frame use")
        if isinstance(node, ast.Call):
            fn = node.func
            known = isinstance(fn, ast.Attribute) and fn.attr in _PURE_METHODS
            if not known:
                self.t.pure = False
        for child in ast.iter_child_nodes(node):
            self._facts_node(child)

    # -- helpers -----------------------------------------------------------
    def _is_frame(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Name):
            return False
        if node.id in self.retired:
            raise _Hard("aliasing", f"superseded frame variable {node.id!r}")
        return node.id == self.frame

    def _const_str(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return None

    def _module_of(self, node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Name):
            return None
        if (
            node.id in self.env
            or node.id in self.series_env
            or node.id == self.frame
            or node.id in self.retired
        ):
            return None  # locally bound names shadow any module alias
        if node.id in self.modules:
            return self.modules[node.id]
        g = getattr(self.func, "__globals__", {})
        if node.id in g and inspect.ismodule(g[node.id]):
            root = g[node.id].__name__.split(".")[0]
            if root in ("numpy", "pandas"):
                self.modules[node.id] = root
                return root
        return None

    def _static(self, node: ast.expr) -> Tuple[bool, Any]:
        """Evaluate a scalar expression over literals and bound params."""
        try:
            return True, self._static_eval(node)
        except (_Soft, _Hard, _NotStatic):
            return False, None

    def _static_eval(self, node: ast.expr) -> Any:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, _SCALARS):
                return node.value
            raise _NotStatic()
        if isinstance(node, ast.Name):
            if node.id in self.env and self.env[node.id] is not _UNKNOWN:
                return self.env[node.id]
            raise _NotStatic()
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](
                self._static_eval(node.left), self._static_eval(node.right)
            )
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            if type(node.ops[0]) not in _CMPOPS:
                raise _NotStatic()
            return _CMPOPS[type(node.ops[0])](
                self._static_eval(node.left),
                self._static_eval(node.comparators[0]),
            )
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return not self._static_eval(node.operand)
            if isinstance(node.op, ast.USub):
                return -self._static_eval(node.operand)
            raise _NotStatic()
        if isinstance(node, ast.BoolOp):
            vals = [self._static_eval(v) for v in node.values]
            if isinstance(node.op, ast.And):
                r = vals[0]
                for v in vals[1:]:
                    r = r and v
                return r
            r = vals[0]
            for v in vals[1:]:
                r = r or v
            return r
        raise _NotStatic()

    # -- frame-producing expressions (statement/return position) -----------
    def _frame_expr(self, node: ast.expr) -> Optional[List[Tuple]]:
        if self._is_frame(node):
            return []
        if isinstance(node, ast.Subscript):
            sl = node.slice
            if self._const_str(sl) is not None:
                return None  # df["c"] is a Series, not a frame
            inner = self._frame_expr(node.value)
            if inner is None:
                return None
            if isinstance(sl, ast.List):
                names = [self._const_str(e) for e in sl.elts]
                if any(n is None for n in names):
                    raise _Hard("unknown-construct", "non-literal projection")
                if self.t.reads is not None:
                    self.t.reads.update(names)  # type: ignore[arg-type]
                return inner + [("project", tuple(names))]
            cond = self._expr(sl)
            return inner + [("filter", cond)]
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            recv = node.func.value
            m = node.func.attr
            try:
                inner = self._frame_expr(recv)
            except _Hard:
                inner = None
            if inner is None:
                return None
            args, kw = node.args, {k.arg: k.value for k in node.keywords}
            if None in kw:
                raise _Hard("unknown-construct", "**kwargs call")
            if m == "copy" and not args and not kw:
                return inner
            if m == "reset_index":
                known, v = self._static(kw.get("drop", ast.Constant(False)))
                if known and v is True and not args:
                    return inner
                raise _Hard("unknown-call", "reset_index without drop=True")
            if m == "rename":
                mapping = kw.get("columns")
                if not isinstance(mapping, ast.Dict):
                    raise _Hard("unknown-call", "rename without columns=dict")
                ren: Dict[str, str] = {}
                for k, v in zip(mapping.keys, mapping.values):
                    ks = self._const_str(k) if k is not None else None
                    vs = self._const_str(v)
                    if ks is None or vs is None:
                        raise _Hard("unknown-call", "non-literal rename")
                    ren[ks] = vs
                if self.t.writes is not None:
                    self.t.writes.update(ren.keys())
                    self.t.writes.update(ren.values())
                if self.t.reads is not None:
                    self.t.reads.update(ren.keys())
                return inner + [("rename", ren)]
            if m == "drop":
                cols = kw.get("columns")
                if cols is None and len(args) == 1:
                    cols = args[0]
                if not isinstance(cols, ast.List):
                    raise _Hard("unknown-call", "drop without a column list")
                names = [self._const_str(e) for e in cols.elts]
                if any(n is None for n in names):
                    raise _Hard("unknown-call", "non-literal drop")
                if self.t.reads is not None:
                    self.t.reads.update(names)  # type: ignore[arg-type]
                return inner + [("drop", tuple(names), False)]
            if m == "assign":
                if args:
                    raise _Hard("unknown-call", "positional assign")
                exprs: List[ColumnExpr] = []
                for name, vexpr in kw.items():
                    e = _as_value(self._expr(vexpr))
                    exprs.append(e.alias(str(name)))
                    if self.t.writes is not None:
                        self.t.writes.add(str(name))
                return inner + [("assign", tuple(exprs))]
            if m in ("fillna", "dropna", "astype", "apply", "pipe"):
                code = "apply" if m in ("apply", "pipe") else "unknown-call"
                raise _Hard(code, f"frame-level .{m}()")
            return None
        return None

    # -- column expressions -------------------------------------------------
    def _expr(self, node: ast.expr) -> ColumnExpr:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, _SCALARS):
                return _lit(node.value)
            raise _Hard("unknown-construct", f"literal {node.value!r}")
        if isinstance(node, ast.Name):
            if node.id in self.series_env:
                gen, e = self.series_env[node.id]
                if gen != self.series_gen:
                    raise _Hard(
                        "aliasing", f"series variable {node.id!r} is stale"
                    )
                return e
            if node.id in self.env:
                v = self.env[node.id]
                if v is _UNKNOWN:
                    raise _Soft("reduction", f"runtime scalar {node.id!r}")
                return _lit(v)
            if self._is_frame(node):
                raise _Hard("unknown-construct", "whole-frame use in expression")
            if self._module_of(node) is not None:
                raise _Hard("unknown-construct", "module used as a value")
            raise _Hard("globals", f"reads global {node.id!r}")
        if isinstance(node, ast.Subscript) and self._is_frame(node.value):
            name = self._const_str(node.slice)
            if name is None:
                raise _Hard("unknown-construct", "non-literal column reference")
            if self.t.reads is not None:
                self.t.reads.add(name)
            return _col(name)
        if isinstance(node, ast.BinOp):
            if type(node.op) not in _BINOPS:
                raise _Hard(
                    "unknown-construct", f"operator {type(node.op).__name__}"
                )
            return _BINOPS[type(node.op)](
                self._expr(node.left), self._expr(node.right)
            )
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1 or type(node.ops[0]) not in _CMPOPS:
                raise _Hard("unknown-construct", "chained/unknown comparison")
            if isinstance(node.ops[0], ast.NotEq):
                raise _Soft("unknown-construct", "!= keeps a NULL row in pandas, not in the IR")
            return _CMPOPS[type(node.ops[0])](
                self._expr(node.left), self._expr(node.comparators[0])
            )
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Invert):
                inner = self._expr(node.operand)
                if _holds_compare(inner):
                    raise _Soft("unknown-construct", "~ over a comparison: pandas' True, the IR's NULL")
                return ~inner
            if isinstance(node.op, ast.USub):
                return -self._expr(node.operand)
            raise _Hard("unknown-construct", "not/+ on a column")
        if isinstance(node, ast.IfExp):
            known, v = self._static(node.test)
            if known:
                return self._expr(node.body if v else node.orelse)
            raise _Soft("conditional", "data-dependent ternary")
        if isinstance(node, ast.Lambda):
            raise _Hard("apply", "lambda")
        if isinstance(node, ast.Call):
            return self._call(node)
        raise _Hard("unknown-construct", type(node).__name__.lower())

    def _scalar_arg(self, node: ast.expr) -> Any:
        known, v = self._static(node)
        if not known:
            raise _Hard("unknown-call", "non-scalar argument")
        return v

    def _call(self, node: ast.Call) -> ColumnExpr:
        if not isinstance(node.func, ast.Attribute):
            if isinstance(node.func, ast.Name) and node.func.id == "abs":
                if len(node.args) == 1 and not node.keywords:
                    return _function("ABS", self._expr(node.args[0]))
            raise _Hard("unknown-call", ast.unparse(node.func))
        recv, m = node.func.value, node.func.attr
        kw = {k.arg: k.value for k in node.keywords}
        if None in kw:
            raise _Hard("unknown-construct", "**kwargs call")
        mod = self._module_of(recv)
        if mod is not None:
            return self._module_call(mod, m, node.args, kw)
        # nested module attr: np.random.xyz(...)
        if (
            isinstance(recv, ast.Attribute)
            and self._module_of(recv.value) == "numpy"
            and recv.attr == "random"
        ):
            raise _Hard("non-deterministic", f"np.random.{m}")
        r = self._expr(recv)  # the receiver series
        return self._method_call(r, m, node.args, kw)

    def _module_call(
        self, mod: str, m: str, args: List[ast.expr], kw: Dict[str, ast.expr]
    ) -> ColumnExpr:
        if mod == "numpy":
            if m == "where" and len(args) == 3 and not kw:
                c = self._expr(args[0])
                a = self._expr(args[1])
                b = self._expr(args[2])
                return case_when((c, a), default=b)
            if m in _NP_FUNCS and len(args) == 1 and not kw:
                return _function(_NP_FUNCS[m], self._expr(args[0]))
            if m == "isnan" and len(args) == 1 and not kw:
                return self._expr(args[0]).is_null()
            raise _Hard("unknown-call", f"np.{m}")
        if mod == "pandas":
            if m in ("isna", "isnull") and len(args) == 1 and not kw:
                return self._expr(args[0]).is_null()
            if m in ("notna", "notnull") and len(args) == 1 and not kw:
                return self._expr(args[0]).not_null()
            raise _Hard("unknown-call", f"pd.{m}")
        raise _Hard("unknown-call", f"{mod}.{m}")  # pragma: no cover

    def _method_call(
        self,
        r: ColumnExpr,
        m: str,
        args: List[ast.expr],
        kw: Dict[str, ast.expr],
    ) -> ColumnExpr:
        if m == "fillna" and len(args) + len(kw) == 1:
            node = args[0] if args else kw.get("value")
            if node is None:
                raise _Hard("unknown-call", "fillna(...) argument form")
            v = self._scalar_arg(node)
            if v is None:
                raise _Hard("unknown-call", "fillna(None)")
            return _function("COALESCE", r, _lit(v))
        if m == "clip":
            lo = self._scalar_arg(args[0]) if len(args) > 0 else None
            hi = self._scalar_arg(args[1]) if len(args) > 1 else None
            if "lower" in kw:
                lo = self._scalar_arg(kw["lower"])
            if "upper" in kw:
                hi = self._scalar_arg(kw["upper"])
            cases = []
            if lo is not None:
                cases.append((r < _lit(lo), _lit(lo)))
            if hi is not None:
                cases.append((r > _lit(hi), _lit(hi)))
            if not cases:
                return r
            return case_when(*cases, default=r)
        if m in ("where", "mask"):
            cnode = args[0] if args else kw.get("cond")
            if cnode is None:
                raise _Hard("unknown-call", f".{m}() without a condition")
            cond = self._expr(cnode)
            if len(args) > 1:
                other = self._expr(args[1])
            elif "other" in kw:
                other = self._expr(kw["other"])
            else:
                raise _Hard("unknown-call", f".{m}() without other=")
            if m == "where":
                return case_when((cond, r), default=other)
            return case_when((cond, other), default=r)
        if m in ("isna", "isnull") and not args and not kw:
            return r.is_null()
        if m in ("notna", "notnull") and not args and not kw:
            return r.not_null()
        if m == "abs" and not args and not kw:
            return _function("ABS", r)
        if m == "round":
            n = self._scalar_arg(args[0]) if args else 0
            return _function("ROUND", r, _lit(int(n)))
        if m == "isin" and len(args) == 1 and not kw:
            if not isinstance(args[0], ast.List):
                raise _Hard("unknown-call", "isin over a non-literal list")
            vals = [self._scalar_arg(e) for e in args[0].elts]
            return _InExpr(r, vals, True)
        if m == "astype" and len(args) == 1 and not kw:
            t = self._scalar_arg(args[0])
            if not isinstance(t, str) or t not in _DTYPES:
                raise _Hard("unknown-call", f"astype({t!r})")
            return r.cast(_DTYPES[t])
        if m in _REDUCTIONS and not args and not kw:
            raise _Soft("reduction", f".{m}() crosses rows")
        if m in ("apply", "map", "transform", "agg", "aggregate", "pipe"):
            raise _Hard("apply", f".{m}() escapes analysis")
        raise _Hard("unknown-call", f".{m}()")


class _NotStatic(Exception):
    pass


# ---------------------------------------------------------------------------
# caching + task-level analysis
# ---------------------------------------------------------------------------

_TRACE_CACHE: Dict[str, _FuncTrace] = {}
_TRACE_CACHE_MAX = 256
_TRACE_LOCK = threading.Lock()


def _trace_function(func: Any, bound: Dict[str, Any]) -> Tuple[_FuncTrace, str]:
    """Trace with a cache keyed by the callable fingerprint (source +
    defaults + closure cells) plus the bound parameter values."""
    from .._utils.hash import to_uuid
    from ..cache.fingerprint import _Refused, _callable_fp

    try:
        fp = _callable_fp(func)
    except _Refused as r:
        t = _FuncTrace()
        t.steps, t.reads, t.writes, t.pure = None, None, None, False
        t.code, t.reason = "non-deterministic", r.reason
        return t, ""
    try:
        key = to_uuid(fp, sorted((k, repr(v)) for k, v in bound.items()))
    except Exception:
        key = ""
    if key:
        with _TRACE_LOCK:
            hit = _TRACE_CACHE.get(key)
        if hit is not None:
            return hit, fp[:8]
    t = _Tracer(func, bound).run()
    if key:
        with _TRACE_LOCK:
            if len(_TRACE_CACHE) >= _TRACE_CACHE_MAX:
                _TRACE_CACHE.clear()
            _TRACE_CACHE[key] = t
    return t, fp[:8]


def _parse_schema_arg(arg: Any) -> Tuple[bool, List[Tuple[str, Any]]]:
    """(star, declared-with-dtypes) for the supported schema-arg forms:
    an explicit schema, or ``*``-prefixed append (``"*,z:double"``).
    Raises _Hard("schema") on anything else (callables, exclusions)."""
    if isinstance(arg, Schema):
        return False, [(f.name, f.type) for f in arg.fields]
    if not isinstance(arg, str):
        raise _Hard("schema", f"schema arg {type(arg).__name__}")
    s = arg.strip()
    if "*" in s:
        if not s.startswith("*") or "*" in s[1:]:
            raise _Hard("schema", f"schema form {s!r}")
        rest = s[1:].lstrip()
        if rest == "":
            return True, []
        if not rest.startswith(",") or any(ch in rest for ch in "~+-"):
            raise _Hard("schema", f"schema form {s!r}")
        try:
            return True, [(f.name, f.type) for f in Schema(rest[1:]).fields]
        except Exception:
            raise _Hard("schema", f"schema form {s!r}")
    try:
        return False, [(f.name, f.type) for f in Schema(s).fields]
    except Exception:
        raise _Hard("schema", f"schema form {s!r}")


def analyze_transform_task(task: Any) -> Optional[UdfAnalysis]:
    """Task-level analysis of a ``RunTransformer`` task (None when the
    task is not a transformer task). Never raises — every failure is a
    conservative verdict with a reason."""
    try:
        return _analyze_transform_task(task)
    except Exception as ex:  # analysis must never fail planning
        a = UdfAnalysis()
        a.code, a.reason = "error", f"analyzer error: {type(ex).__name__}"
        return a


def _refused(a: UdfAnalysis, code: str, reason: str) -> UdfAnalysis:
    a.code, a.reason = code, reason
    a.steps = None
    return a


def _analyze_transform_task(task: Any) -> Optional[UdfAnalysis]:
    from ..cache.fingerprint import _NON_DETERMINISTIC_ATTR
    from ..extensions.transformer.convert import (
        _FuncAsOutputTransformer,
        _FuncAsTransformer,
    )

    tf = task.params.get_or_none("transformer", object)
    if tf is None:
        return None
    a = UdfAnalysis()
    a.name = "<udf>"
    if isinstance(tf, _FuncAsOutputTransformer) or not isinstance(
        tf, _FuncAsTransformer
    ):
        return _refused(
            a, "signature", f"{type(tf).__name__} is not a plain function UDF"
        )
    func = getattr(getattr(tf, "_wrapper", None), "_func", None)
    if func is None:
        return _refused(a, "signature", "no wrapped function")
    a.name = getattr(func, "__name__", "<udf>")
    wrapper = tf._wrapper
    from ..dataframe.function_wrapper import _PandasParam

    params = list(wrapper._params.values())
    if (
        len(params) == 0
        or type(params[0]) is not _PandasParam
        or type(wrapper._rt) is not _PandasParam
        or any(c in wrapper.input_code for c in "fF")
    ):
        return _refused(
            a, "signature", "not a pandas-DataFrame-in/DataFrame-out function"
        )
    if task.params.get_or_none("callback", object) is not None:
        return _refused(a, "callback", "RPC callback wired in")
    if len(task.params.get("ignore_errors", []) or []) > 0:
        return _refused(a, "ignore-errors", "ignore_errors drops partitions")
    if tf.validation_rules:
        return _refused(a, "validation-rules", "validation rules attached")
    if getattr(func, _NON_DETERMINISTIC_ATTR, False) or getattr(
        tf, _NON_DETERMINISTIC_ATTR, False
    ):
        return _refused(a, "non-deterministic", "marked @non_deterministic")
    try:
        a.star, a.declared = _parse_schema_arg(tf._output_schema_arg)
        a.schema_ok = True
    except _Hard as h:
        a.code, a.reason = h.code, h.detail
    bound = dict(task.params.get("params", {}) or {})
    trace, fp = _trace_function(func, bound)
    a.fp = fp
    a.reads = None if trace.reads is None else set(trace.reads)
    a.writes = None if trace.writes is None else set(trace.writes)
    a.pure = trace.pure
    a.deterministic = trace.pure
    spec = task.partition_spec
    a.required_extra = set(spec.partition_by) | set(spec.presort.keys())
    if trace.steps is None:
        a.code = a.code or trace.code
        a.reason = a.reason or trace.reason
        a.steps = None
        return a
    # function is row-local; task-level conditions for using that fact
    if not spec.empty:
        return _refused(
            a,
            "partitioned",
            "partitioned transform (row order depends on exchange)",
        )
    a.row_local = True
    if not a.schema_ok:
        a.steps = None
        return a
    a.steps = list(trace.steps)
    return a


def transform_row_local(task: Any) -> bool:
    """Whether this transform task provably computes each output row from
    one input row (the delta cache's splitting precondition,
    ``plan/ir.py`` ``node_delta_row_local``). Conservative: any analysis
    failure is False."""
    try:
        a = analyze_transform_task(task)
        return a is not None and a.row_local and a.deterministic
    except Exception:
        return False
