"""The port's column layer against the JAX package's, on the same inputs.

- ``fugue_tpu_torch/column/eval.py`` (pandas) against
  ``fugue_tpu/column/eval.py``: equal frames, exactly;
- ``column/torch_eval.py`` against ``column/jax_eval.py`` (``jax_enable_x64``
  on, as ``fugue_tpu.jax`` sets it): ``evaluate_torch`` against
  ``evaluate_jnp`` over the promotion matrix (every pair of bool, int8,
  int32, int64, float32, float64 columns and Python int, float and bool
  literals, for every operator), ``evaluate_torch_3v`` against
  ``evaluate_jnp_3v`` (Kleene logic, null masks, NaN, dictionary codes,
  CASE WHEN, COALESCE, casts), and the planners, which must accept and
  refuse the same trees and plan the same lookup tables.

Dtypes, ints, bools and NULL flags are exact; floats ``rtol=1e-12``
(float64) and ``1e-6`` (float32).
"""

import datetime

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu.jax  # noqa: F401  (turns jax_enable_x64 on, as the JAX engine runs)
import jax.numpy as jnp
from fugue_tpu.column import col as jcol
from fugue_tpu.column import eval as jeval
from fugue_tpu.column import expressions as jexpr
from fugue_tpu.column import functions as jff
from fugue_tpu.column import jax_eval
from fugue_tpu.column import lit as jlit
from fugue_tpu.column import SelectColumns as JSelectColumns
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu_torch.column import SelectColumns, col, lit
from fugue_tpu_torch.column import eval as teval
from fugue_tpu_torch.column import expressions as texpr
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.column import torch_eval
from fugue_tpu_torch.schema import Schema

DTYPES = ["bool", "int8", "int32", "int64", "float32", "float64"]
LITERALS = {"py_int": 3, "py_float": 2.5, "py_bool": True}
BINARY = ["+", "-", "*", "/", "<", "<=", ">", ">=", "==", "!=", "&", "|"]
N = 64


class _Both:
    """One expression built twice, from the JAX package's IR and the port's."""

    def __init__(self, j, t):
        self.j, self.t = j, t

    def _bin(self, other, f):
        o = other if isinstance(other, _Both) else _Both(other, other)
        return _Both(f(self.j, o.j), f(self.t, o.t))

    def op(self, name, other):
        return self._bin(other, _OPS[name])

    def rop(self, name, other):
        return other._bin(self, _OPS[name])

    def un(self, f):
        return _Both(f(self.j), f(self.t))

    def cast(self, tp):
        return _Both(self.j.cast(tp), self.t.cast(tp))

    def alias(self, name):
        return _Both(self.j.alias(name), self.t.alias(name))


_OPS = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
    "/": lambda a, b: a / b, "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b, "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b, "&": lambda a, b: a & b, "|": lambda a, b: a | b,
}


def C(name):
    return _Both(jcol(name), col(name))


def L(v):
    return _Both(jlit(v), lit(v))


def _columns(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for dt in DTYPES:
        if dt == "bool":
            out[dt] = rng.random(N) < 0.5
        elif dt.startswith("int"):
            out[dt] = rng.integers(-5, 6, N).astype(dt)
        else:
            out[dt] = (rng.standard_normal(N) * 4).astype(dt)
    return out


def _same_value(got, exp):
    """``got`` (torch or Python) against ``exp`` (jax or Python): dtype
    exact, values exact for ints and bools, floats within their rtol."""
    if isinstance(exp, (bool, int, float)) and not isinstance(got, torch.Tensor):
        assert type(got) is type(exp) and (got == exp or (got != got and exp != exp))
        return
    e = np.asarray(exp)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.dtype == e.dtype, (g.dtype, e.dtype)
    g, e = np.broadcast_to(g, np.broadcast_shapes(g.shape, e.shape)), np.broadcast_to(e, g.shape)
    if e.dtype.kind == "f":
        rtol = 1e-12 if e.dtype.itemsize == 8 else 1e-6
        np.testing.assert_allclose(g, e, rtol=rtol, atol=0, equal_nan=True)
    else:
        np.testing.assert_array_equal(g, e)


def _both_eval(expr: _Both, cols):
    jcols = {k: jnp.asarray(v) for k, v in cols.items()}
    tcols = {k: torch.from_numpy(np.array(v)) for k, v in cols.items()}
    try:
        exp = jax_eval.evaluate_jnp(jcols, expr.j)
    except Exception as e:  # noqa: BLE001 - the port must raise the same type
        with pytest.raises(Exception) as err:
            torch_eval.evaluate_torch(tcols, expr.t)
        assert type(err.value).__name__ == type(e).__name__
        return None
    got = torch_eval.evaluate_torch(tcols, expr.t)
    _same_value(got, exp)
    return got


# ---- the promotion matrix ---------------------------------------------------


@pytest.mark.parametrize("op", BINARY)
@pytest.mark.parametrize("left", DTYPES)
def test_promotion_matrix(op, left):
    """Every right operand (a column of each dtype, and each literal kind),
    on both sides of the operator: the JAX package's dtype and values."""
    cols = _columns()
    for right in DTYPES:
        _both_eval(C(left).op(op, C(right)), cols)
    for v in LITERALS.values():
        _both_eval(C(left).op(op, L(v)), cols)
        _both_eval(C(left).rop(op, L(v)), cols)


@pytest.mark.parametrize("dt", DTYPES)
def test_unary_ops_and_null_tests(dt):
    cols = _columns(1)
    cols["float64"][::7] = np.nan
    cols["float32"][::5] = np.nan
    for f in (lambda e: -e, lambda e: ~e, lambda e: e.is_null(), lambda e: e.not_null()):
        _both_eval(C(dt).un(f), cols)


def test_weak_types_carry_through_an_expression():
    """``bool + 1`` and ``int32 + 0.5`` are weakly typed in JAX: the next
    operand decides the dtype (int8, float32), where torch would not."""
    cols = _columns(2)
    _both_eval(C("bool").op("+", L(3)).op("+", C("int8")), cols)
    _both_eval(C("int32").op("+", L(0.5)).op("*", C("float32")), cols)
    _both_eval(C("int8").op("+", L(1000)), cols)  # the literal wraps into int8
    _both_eval(L(3).op("/", L(2)), cols)
    _both_eval(L(3).op("+", L(2.5)).op("<", C("int64")), cols)


@pytest.mark.parametrize("tp", ["bool", "int8", "int", "long", "float", "double"])
def test_casts(tp):
    cols = _columns(3)
    cols["float64"][:6] = [np.nan, 1e30, -1e30, 2.7, -2.7, 300.0]
    cols["float32"][:4] = [np.nan, 3e9, -3e9, 127.9]
    for src in DTYPES:
        _both_eval(C(src).cast(tp), cols)
        _both_eval(C(src).op("*", L(2)).cast(tp).op("+", L(1)), cols)
    _both_eval(L(5).cast(tp), cols)


def test_case_when_and_coalesce():
    cols = _columns(4)
    cols["float64"][::3] = np.nan
    j = jexpr.case_when((jcol("int32") > 2, jcol("float32")), (jcol("bool"), 7), default=jcol("float64"))
    t = texpr.case_when((col("int32") > 2, col("float32")), (col("bool"), 7), default=col("float64"))
    _both_eval(_Both(j, t), cols)
    j = jexpr.case_when((jcol("float64"), 1), default=2.5)  # a NaN condition is true
    t = texpr.case_when((col("float64"), 1), default=2.5)
    _both_eval(_Both(j, t), cols)
    _both_eval(_Both(jff.coalesce(jcol("float64"), jcol("int32")), ff.coalesce(col("float64"), col("int32"))),
               cols)
    _both_eval(_Both(jff.coalesce(jcol("float64"), 0), ff.coalesce(col("float64"), 0)), cols)
    _both_eval(_Both(jff.coalesce(jcol("float32"), jcol("float64")), ff.coalesce(col("float32"), col("float64"))),
               cols)


def test_missing_column_raises_as_the_reference():
    _both_eval(C("nope").op("+", L(1)), _columns())


# ---- three-valued evaluation ------------------------------------------------


def _frame_state(seed=5):
    """Device state of a frame with a null-masked int, a NaN float, a
    dictionary string (codes, −1 = NULL) and a date column, as both
    engines encode it."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-3, 4, N).astype(np.int64)
    amask = rng.random(N) < 0.2
    f = rng.standard_normal(N).astype(np.float32)
    f[rng.random(N) < 0.2] = np.nan
    words = pa.array(["apple", "fig", "pear", "plum"])
    codes = rng.integers(-1, 4, N).astype(np.int32)
    days = rng.integers(18000, 18800, N).astype(np.int32)
    cols = {"a": a, "f": f, "s": codes, "d": days, "b": rng.random(N) < 0.5}
    masks = {"a": amask}
    encodings = {
        "s": {"kind": "dict", "dictionary": words, "type": pa.string(), "sorted": True},
        "d": {"kind": "datetime", "dictionary": None, "type": pa.date32()},
    }
    return cols, masks, encodings


PREDICATES = {
    "cmp": lambda c, l: c("a") > 0,
    "and": lambda c, l: (c("a") > 0) & (c("f") < 0.5),
    "or": lambda c, l: (c("a") > 0) | (c("f") < 0.5),
    "not": lambda c, l: ~((c("a") > 0) & c("b")),
    "is_null": lambda c, l: c("a").is_null() | c("f").is_null(),
    "not_null_dict": lambda c, l: c("s").not_null() & (c("f") >= -1),
    "dict_eq": lambda c, l: c("s") == "pear",
    "dict_and_num": lambda c, l: (c("s") >= "fig") & (c("a") != 1),
    "date": lambda c, l: (c("d") >= "2020-01-01") & (c("d") < datetime.date(2021, 1, 1)),
    "date_flip": lambda c, l: l("2020-06-01") <= c("d"),
    "arith": lambda c, l: (c("a") * 2 + c("f")) > 1,
    "cast": lambda c, l: c("f").cast("int") > 0,
    "lit_true": lambda c, l: l(True),
    "kleene_null_or_true": lambda c, l: c("a").is_null() | (c("f") > 10) | (c("a") >= 0),
}


def _coalesce_pred(mod):
    return lambda c, l: mod.coalesce(c("a"), 0) == 0


def _case_pred(mod):
    return lambda c, l: mod.case_when((c("f") > 0, c("a")), default=-1) >= 0


def _jax_3v(expr, cols, masks, encodings):
    plan = jax_eval.device_predicate_plan(expr, cols, encodings)
    assert plan is not None
    tables, cond = plan
    code_cols = frozenset(c for c, e in encodings.items() if e["kind"] == "dict")
    v, nl = jax_eval.evaluate_jnp_3v(
        {k: jnp.asarray(x) for k, x in cols.items()},
        {k: jnp.asarray(x) for k, x in masks.items()},
        tables, cond, code_cols)
    keep = jnp.ones(N, dtype=bool) & jnp.asarray(v, dtype=bool) & jnp.logical_not(nl)
    return tables, np.asarray(keep), np.broadcast_to(np.asarray(nl), (N,))


def _torch_3v(expr, cols, masks, encodings):
    plan = torch_eval.device_predicate_plan(expr, cols, encodings)
    assert plan is not None
    tables, cond = plan
    code_cols = frozenset(c for c, e in encodings.items() if e["kind"] == "dict")
    dt = {u: (n, torch.from_numpy(t)) for u, (n, t) in tables.items()}
    v, nl = torch_eval.evaluate_torch_3v(
        {k: torch.from_numpy(np.array(x)) for k, x in cols.items()},
        {k: torch.from_numpy(np.array(x)) for k, x in masks.items()},
        dt, cond, code_cols)
    v = torch.as_tensor(v).to(torch.bool)
    keep = torch.ones(N, dtype=torch.bool) & v & ~torch.as_tensor(nl)
    return tables, keep.numpy(), np.broadcast_to(torch.as_tensor(nl).numpy(), (N,))


@pytest.mark.parametrize("name", [*PREDICATES, "coalesce", "case_when"])
def test_three_valued_predicates(name):
    cols, masks, encodings = _frame_state()
    if name == "coalesce":
        fj, ft = _coalesce_pred(jff), _coalesce_pred(ff)
    elif name == "case_when":
        fj, ft = _case_pred(jexpr), _case_pred(texpr)
    else:
        fj = ft = PREDICATES[name]
    jtables, jkeep, jnl = _jax_3v(fj(jcol, jlit), cols, masks, encodings)
    ttables, tkeep, tnl = _torch_3v(ft(col, lit), cols, masks, encodings)
    np.testing.assert_array_equal(tkeep, jkeep)
    np.testing.assert_array_equal(tnl, jnl)
    assert sorted(v[0] for v in ttables.values()) == sorted(v[0] for v in jtables.values())
    for (jn, jt), (tn, tt) in zip(sorted(jtables.values(), key=lambda x: x[0]),
                                  sorted(ttables.values(), key=lambda x: x[0])):
        assert jt.dtype == tt.dtype
        np.testing.assert_array_equal(jt, tt)


def test_kleene_truth_tables():
    """AND/OR over every pair of TRUE, FALSE and NULL."""
    vals = np.array([1, 0, 0, 1, 0, 0, 1, 0, 0], np.int64)
    nulls = np.array([0, 0, 1, 0, 0, 1, 0, 0, 1], bool)
    other = np.array([1, 1, 1, 0, 0, 0, 0, 0, 0], np.int64)
    onull = np.array([0, 0, 0, 0, 0, 0, 1, 1, 1], bool)
    cols, masks = {"x": vals, "y": other}, {"x": nulls, "y": onull}
    for op in ("&", "|"):
        j = _OPS[op](jcol("x") == 1, jcol("y") == 1)
        t = _OPS[op](col("x") == 1, col("y") == 1)
        jv, jn = jax_eval.evaluate_jnp_3v({k: jnp.asarray(v) for k, v in cols.items()},
                                          {k: jnp.asarray(v) for k, v in masks.items()}, {}, j)
        tv, tn = torch_eval.evaluate_torch_3v({k: torch.from_numpy(v) for k, v in cols.items()},
                                              {k: torch.from_numpy(v) for k, v in masks.items()}, {}, t)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        known = ~np.asarray(jn)
        np.testing.assert_array_equal(tv.numpy()[known], np.asarray(jv)[known])


# ---- the planners -----------------------------------------------------------

PLANNED = {
    "plain": lambda c, l, m: c("a") > 1,
    "dict_value": lambda c, l, m: c("s") + c("a"),  # a string value outside a dict subtree
    "dict_upper": lambda c, l, m: m.coalesce(c("s"), l("x")) == "x",  # NULL op over a dict column
    "dict_alone": lambda c, l, m: c("s"),
    "dict_is_null": lambda c, l, m: c("s").is_null(),
    "date_lit": lambda c, l, m: c("d") > "2020-02-02",
    "date_vs_col": lambda c, l, m: c("d") > c("a"),
    "date_int_lit": lambda c, l, m: c("d") > 5,
    "host_col": lambda c, l, m: c("h") > 1,
    "null_lit": lambda c, l, m: c("a") == l(None),
    "str_lit": lambda c, l, m: c("a") == "x",
    "agg": lambda c, l, m: m.sum(c("a")) > 1,
    "cast_str": lambda c, l, m: c("a").cast("str") == "1",
    "wildcard": lambda c, l, m: c("*"),
    "coalesce": lambda c, l, m: m.coalesce(c("a"), c("f")) > 0,
    "case_null_default": lambda c, l, m: m.case_when((c("a") > 0, 1)) > 0,
}


@pytest.mark.parametrize("name", list(PLANNED))
def test_planners_accept_and_refuse_the_same_trees(name):
    cols, masks, encodings = _frame_state()
    modj = type("M", (), {"coalesce": staticmethod(jff.coalesce), "sum": staticmethod(jff.sum),
                          "case_when": staticmethod(jexpr.case_when)})
    modt = type("M", (), {"coalesce": staticmethod(ff.coalesce), "sum": staticmethod(ff.sum),
                          "case_when": staticmethod(texpr.case_when)})
    ej, et = PLANNED[name](jcol, jlit, modj), PLANNED[name](col, lit, modt)
    pj = jax_eval.device_predicate_plan(ej, cols, encodings)
    pt = torch_eval.device_predicate_plan(et, cols, encodings)
    assert (pj is None) == (pt is None)
    if pj is not None:
        assert repr(pj[1]) == repr(pt[1])
    plain = {k: v for k, v in cols.items() if k not in encodings and k not in masks}
    assert jax_eval.can_evaluate_on_device(ej, plain) == torch_eval.can_evaluate_on_device(et, plain)
    assert jax_eval.can_evaluate_on_device(ej, cols) == torch_eval.can_evaluate_on_device(et, cols)
    lj, lt = jax_eval.plan_dict_lookups(ej, encodings), torch_eval.plan_dict_lookups(et, encodings)
    assert (lj is None) == (lt is None)
    if lj is not None:
        assert [v[0] for v in lj.values()] == [v[0] for v in lt.values()]


@pytest.mark.parametrize("value,tp", [
    ("2020-03-01", pa.date32()), (datetime.date(1998, 9, 2), pa.date32()),
    (datetime.datetime(2021, 1, 1, 12, 30), pa.timestamp("us")), ("2021-01-01 00:00:01", pa.timestamp("s")),
    ("2021-01-01", pa.timestamp("ns")), ("not a date", pa.date32()), ("2020-01-01", pa.int32()),
])
def test_epoch_of(value, tp):
    assert torch_eval._epoch_of(value, tp) == jax_eval._epoch_of(value, tp)


# ---- the pandas evaluator ---------------------------------------------------


def _pdf(seed=6):
    rng = np.random.default_rng(seed)
    n = 200
    return pd.DataFrame({
        "k": rng.integers(0, 4, n),
        "a": pd.array(np.where(rng.random(n) < 0.2, None, rng.integers(-5, 5, n)), dtype="Int64"),
        "f": np.where(rng.random(n) < 0.1, np.nan, rng.standard_normal(n)),
        "s": np.where(rng.random(n) < 0.1, None, rng.choice(["apple", "fig", "pear"], n)),
    })


_SCHEMA = "k:long,a:long,f:double,s:str"


def _sel(mod_col, mod_lit, mod_ff, mod_expr):
    c, l, f = mod_col, mod_lit, mod_ff
    return {
        "project": ([c("k"), (c("a") * 2 + c("f")).alias("x"), (c("s") == "fig").alias("y"),
                     f.coalesce(c("a"), c("k")).alias("z")], None, None),
        "where": ([c("*")], (c("f") > 0) & c("s").not_null(), None),
        "global": ([f.sum(c("f")).alias("sf"), f.count(c("s")).alias("n"),
                    (f.max(c("a")) - f.min(c("a"))).alias("spread"),
                    f.count_distinct(c("s")).alias("ds")], c("k") > 0, None),
        "grouped": ([c("k"), f.avg(c("f")).alias("m"), f.first(c("s")).alias("fs")], None,
                    f.avg(c("f")) > -1),
        "grouped_expr": ([c("k"), f.sum(c("a") * c("f")).alias("p")], None, None),
        "case": ([mod_expr.case_when((c("f") > 0, "pos"), (c("f") < 0, "neg"), default="nan").alias("sign"),
                  c("k")], None, None),
        "like_in": ([c("k")], mod_expr._LikeExpr(c("s"), "%p%") | mod_expr._InExpr(c("k"), [0, 1]), None),
        "distinct": ([c("k"), (c("a") > 0).alias("pos")], None, None),
    }


@pytest.mark.parametrize("case", ["project", "where", "global", "grouped", "grouped_expr", "case",
                                  "like_in", "distinct"])
def test_pandas_evaluator_equals_the_reference(case):
    pdf = _pdf()
    jcols, jwhere, jhaving = _sel(jcol, jlit, jff, jexpr)[case]
    tcols, twhere, thaving = _sel(col, lit, ff, texpr)[case]
    distinct = case == "distinct"
    exp = jeval.eval_select(pdf.copy(), JSchema(_SCHEMA), JSelectColumns(*jcols, arg_distinct=distinct),
                            jwhere, jhaving)
    got = teval.eval_select(pdf.copy(), Schema(_SCHEMA), SelectColumns(*tcols, arg_distinct=distinct),
                            twhere, thaving)
    pd.testing.assert_frame_equal(got, exp)
    js = JSelectColumns(*jcols).replace_wildcard(JSchema(_SCHEMA)).infer_schema(JSchema(_SCHEMA))
    ts = SelectColumns(*tcols).replace_wildcard(Schema(_SCHEMA)).infer_schema(Schema(_SCHEMA))
    assert str(ts) == str(js)


def test_having_rewrite_and_its_refusal():
    aggs_j = [jff.sum(jcol("f")).alias("s")]
    aggs_t = [ff.sum(col("f")).alias("s")]
    hj = jeval.rewrite_having_aggs((jff.sum(jcol("f")) > 1) & (jcol("k") > 0), aggs_j)
    ht = teval.rewrite_having_aggs((ff.sum(col("f")) > 1) & (col("k") > 0), aggs_t)
    assert repr(ht) == repr(hj)
    from fugue_tpu_torch.exceptions import FugueSQLError

    with pytest.raises(FugueSQLError):
        teval.rewrite_having_aggs(ff.max(col("f")) > 1, aggs_t)


def test_select_columns_rules():
    from fugue_tpu_torch.exceptions import FugueSQLError

    with pytest.raises(FugueSQLError):
        SelectColumns()
    with pytest.raises(FugueSQLError):
        SelectColumns(col("*"), ff.sum(col("a")))
    with pytest.raises(FugueSQLError):
        SelectColumns(col("a"), col("b").alias("a"))
    sc = SelectColumns(col("k"), ff.sum(col("a")).alias("s"), lit(1).alias("one"))
    assert [repr(k) for k in sc.group_keys] == ["k"] and sc.has_agg and sc.has_literals
    assert texpr.derived_name(col("a").cast("int")) == jexpr.derived_name(jcol("a").cast("int"))
    assert texpr.structural_key(col("a").alias("x")) == texpr.structural_key(col("a"))


def test_three_valued_evaluation_keeps_no_column_alive():
    """ROADMAP.md C17: ``evaluate_torch_3v``'s two nested evaluators once
    referenced each other and the columns, so a filtered chunk's tensors
    lived until the cyclic GC ran (a lowered stream held one staged chunk
    more a chunk on the card). With the GC off, the columns free when the
    caller drops them."""
    import gc
    import weakref

    enabled = gc.isenabled()
    gc.disable()
    try:
        t = torch.arange(10.0)
        alive = weakref.ref(t)
        cols = {"v": t}
        v, nl = torch_eval.evaluate_torch_3v(cols, {}, {}, (col("v") > 3) & col("v").not_null(), frozenset())
        assert v.tolist() == [False] * 4 + [True] * 6
        del cols, t
        assert alive() is None
    finally:
        if enabled:
            gc.enable()


def test_device_predicate_plan_keeps_no_column_alive():
    """ROADMAP.md C18: ``device_predicate_plan``'s nested gate ``ok``
    referenced itself and the frame's columns, so every fused or lowered
    filter left a reference cycle holding the whole frame until the cyclic
    GC ran (1.6 GB of a dropped frame was still on the card when the next
    cell's peak was read). With the GC off, the columns free when the
    caller drops them."""
    import gc
    import weakref

    enabled = gc.isenabled()
    gc.disable()
    try:
        t = torch.arange(10.0)
        alive = weakref.ref(t)
        cols = {"v": t}
        planned = torch_eval.device_predicate_plan((col("v") > 3) & col("v").not_null(), cols, {})
        assert planned is not None and planned[0] == {}
        assert torch_eval.device_predicate_plan(col("u") > 3, cols, {}) is None
        del cols, t
        assert alive() is None
    finally:
        if enabled:
            gc.enable()
