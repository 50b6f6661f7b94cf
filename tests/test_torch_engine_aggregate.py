"""TorchExecutionEngine(device="cpu").aggregate against JaxExecutionEngine().aggregate
on the same frames: from pandas, and from the JAX frame's device state
carried across with ``frame_from_numpy``.

Exact: keys, row order, counts, MIN/MAX, NULL placement and schema.
Sums and averages: ``np.allclose(rtol=1e-5, atol=1e-3)`` — float32 sums
taken in another order (chunked one-hot on both CPU paths here, atomics on
the card).
"""

import zlib

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.column import col as jcol
from fugue_tpu.column import lit as jlit
from fugue_tpu.column import functions as jff
from fugue_tpu.dataframe import PandasDataFrame as JPandasDataFrame
from fugue_tpu.execution import NativeExecutionEngine
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu.ops.segment import _DENSE_SUM_BACKEND, set_dense_sum_backend
from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import col, lit
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.ops import bin_groupby
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine, frame_from_numpy

AGGS = [("s", "sum"), ("n", "count"), ("m", "avg"), ("lo", "min"), ("hi", "max")]
FLOAT_OUT = {"s", "m"}


@pytest.fixture(scope="module")
def jax_engine():
    return JaxExecutionEngine()


@pytest.fixture(scope="module")
def engine():
    return TorchExecutionEngine(device="cpu")


def _jax_aggs(v="v", aggs=AGGS):
    return [getattr(jff, f)(jcol(v)).alias(n) for n, f in aggs]


def _torch_aggs(v="v", aggs=AGGS):
    return [getattr(ff, f)(col(v)).alias(n) for n, f in aggs]


def _run_jax(jax_engine, df, aggs=AGGS, v="v"):
    res = jax_engine.aggregate(df, JPartitionSpec(by=["k"]), _jax_aggs(v, aggs))
    return res.as_pandas(), str(res.schema)


def _assert_same(got: pd.DataFrame, got_schema: str, exp: pd.DataFrame, exp_schema: str):
    assert got_schema == exp_schema
    assert list(got.columns) == list(exp.columns)
    assert len(got) == len(exp)
    for c in got.columns:
        g, e = got[c].to_numpy(), exp[c].to_numpy()
        assert g.dtype == e.dtype, c
        assert (np.isnan(g) == np.isnan(e)).all() if g.dtype.kind == "f" else True, c
        if c in FLOAT_OUT:
            assert np.allclose(g, e, rtol=1e-5, atol=1e-3, equal_nan=True), c
        else:
            assert np.array_equal(g, e, equal_nan=g.dtype.kind == "f"), c


def _frame(rng, n, keys, nan_frac=0.0, kmin=0):
    v = rng.random(n).astype(np.float32) * 10 - 3
    if nan_frac > 0:
        v[rng.random(n) < nan_frac] = np.nan
    return pd.DataFrame({"k": rng.integers(kmin, kmin + keys, n).astype(np.int64), "v": v})


# row counts are not multiples of 8, so the JAX frame on the 8-device test
# mesh holds padding rows
CASES = {
    "nan_free": lambda rng: _frame(rng, 2_003, 50),
    "nullable": lambda rng: _frame(rng, 2_005, 50, nan_frac=0.2),
    "negative_kmin": lambda rng: _frame(rng, 1_999, 40, nan_frac=0.05, kmin=-1_000),
    "single_group": lambda rng: _frame(rng, 501, 1, nan_frac=0.1, kmin=7),
    "20k_rows_1000_keys": lambda rng: _frame(rng, 20_003, 1_000, nan_frac=0.01),
}


def _gappy(rng):
    # empty groups inside the key range, and one group whose values are all NULL
    pdf = _frame(rng, 3_000, 100, nan_frac=0.1)
    pdf = pdf[pdf["k"] % 7 != 3].reset_index(drop=True)
    pdf.loc[pdf["k"] == 5, "v"] = np.nan
    return pdf.iloc[: len(pdf) - (len(pdf) % 8 == 0)]


CASES["empty_and_all_null_groups"] = _gappy


@pytest.mark.parametrize("case", sorted(CASES))
def test_aggregate_matches_jax_engine(jax_engine, engine, case):
    pdf = CASES[case](np.random.default_rng(zlib.crc32(case.encode())))
    exp, exp_schema = _run_jax(jax_engine, jax_engine.to_df(pdf))
    res = engine.aggregate(engine.to_df(pdf), PartitionSpec(by=["k"]), _torch_aggs())
    assert isinstance(res, TorchDataFrame)
    _assert_same(res.as_pandas(), str(res.schema), exp, exp_schema)
    if case == "empty_and_all_null_groups":
        row = res.as_pandas().set_index("k").loc[5]
        assert row["n"] == 0 and np.isnan(row[["s", "m", "lo", "hi"]].astype(float)).all()
        assert not (res.as_pandas()["k"] % 7 == 3).any()


@pytest.mark.parametrize("case", ["nullable", "empty_and_all_null_groups", "20k_rows_1000_keys"])
def test_aggregate_of_carried_jax_state(jax_engine, engine, case):
    pdf = CASES[case](np.random.default_rng(5))
    jdf = jax_engine.to_df(pdf)
    exp, exp_schema = _run_jax(jax_engine, jdf)
    valid = np.asarray(jdf.device_valid_mask())
    assert not valid.all()  # the 8-device mesh pads rows: they are carried too
    tdf = frame_from_numpy(
        {c: np.asarray(jdf.device_cols[c]) for c in jdf.schema.names},
        str(jdf.schema),
        valid=valid,
        nan_cols=[c for c in jdf.schema.names if jdf.maybe_nan(c)],
        device="cpu",
    )
    assert tdf.count() == len(pdf)
    res = engine.aggregate(tdf, PartitionSpec(by=["k"]), _torch_aggs())
    _assert_same(res.as_pandas(), str(res.schema), exp, exp_schema)


def test_aggregate_of_carried_filtered_state(jax_engine, engine):
    # a device filter leaves an explicit valid mask with holes mid-frame
    pdf = _frame(np.random.default_rng(9), 4_000, 300, nan_frac=0.05)
    jdf = jax_engine.filter(jax_engine.to_df(pdf), jcol("k") > 100)
    exp, exp_schema = _run_jax(jax_engine, jdf)
    tdf = frame_from_numpy(
        {c: np.asarray(jdf.device_cols[c]) for c in jdf.schema.names},
        str(jdf.schema),
        valid=np.asarray(jdf.device_valid_mask()),
        device="cpu",
    )
    res = engine.aggregate(tdf, PartitionSpec(by=["k"]), _torch_aggs())
    _assert_same(res.as_pandas(), str(res.schema), exp, exp_schema)


def test_api_aggregate_returns_input_type(jax_engine):
    pdf = _frame(np.random.default_rng(1), 1_000, 30, nan_frac=0.1)
    exp, _ = _run_jax(jax_engine, jax_engine.to_df(pdf))
    kw = {n: getattr(ff, f)(col("v")) for n, f in AGGS}
    got = api.aggregate(pdf, partition_by="k", engine="torch", device="cpu", **kw)
    assert isinstance(got, pd.DataFrame)
    _assert_same(got, "", exp, "")
    tbl = api.aggregate(pa.Table.from_pandas(pdf), "k", engine="cuda", device="cpu", **kw)
    assert isinstance(tbl, pa.Table) and tbl.num_rows == len(exp)
    fr = api.aggregate(pdf, "k", engine="torch", device="cpu", as_fugue=True, **kw)
    assert isinstance(fr, TorchDataFrame)


def test_inf_sum_matches_scatter_backend(jax_engine, engine):
    # the JAX engine's default f32 route on the CPU ("onehot") spreads inf*0
    # = NaN over the chunk (ROADMAP.md C1); its "scatter" route and the port
    # answer [1, inf, 2, 3]
    pdf = pd.DataFrame({"k": [0, 1, 2, 3], "v": np.array([1, np.inf, 2, 3], np.float32)})
    before = _DENSE_SUM_BACKEND[0]
    set_dense_sum_backend("scatter")
    try:
        exp, exp_schema = _run_jax(jax_engine, jax_engine.to_df(pdf), [("s", "sum")])
    finally:
        set_dense_sum_backend(before)
    res = engine.aggregate(engine.to_df(pdf), PartitionSpec(by=["k"]), _torch_aggs(aggs=[("s", "sum")]))
    _assert_same(res.as_pandas(), str(res.schema), exp, exp_schema)
    assert list(res.as_pandas()["s"]) == [1.0, np.inf, 2.0, 3.0]


def test_f64_column_takes_index_add(jax_engine, engine):
    # float64 SUM is exact to f64 (1e-12 survives), through index_add_
    pdf = pd.DataFrame({"k": [0, 0, 1, 2], "v": [1e-12, 1.0, 2.0, np.nan]})
    exp, exp_schema = _run_jax(jax_engine, jax_engine.to_df(pdf))
    res = engine.aggregate(engine.to_df(pdf), PartitionSpec(by=["k"]), _torch_aggs())
    got = res.as_pandas()
    _assert_same(got, str(res.schema), exp, exp_schema)
    assert got["s"][0] == 1.0 + 1e-12


def test_empty_input_gives_empty_frame(jax_engine, engine):
    pdf = _frame(np.random.default_rng(2), 10, 5).iloc[:0]
    exp, exp_schema = _run_jax(jax_engine, jax_engine.to_df(pdf))
    res = engine.aggregate(engine.to_df(pdf), PartitionSpec(by=["k"]), _torch_aggs())
    assert res.count() == 0 and res.empty
    assert str(res.schema) == exp_schema and len(exp) == 0


def test_sum_launches_once_per_aggregate_on_cpu_plain(engine):
    # on the CPU the wrapper takes the plain version: the launch counts stay
    pdf = _frame(np.random.default_rng(4), 1_000, 10, nan_frac=0.1)
    before = dict(bin_groupby.LAUNCHES)
    engine.aggregate(engine.to_df(pdf), PartitionSpec(by=["k"]), _torch_aggs())
    assert bin_groupby.LAUNCHES == before


def _same_as_jax(jax_engine, engine, pdf, by, aggs, jaggs, schema=None):
    """Both engines on one input: the same schema, and the same rows after
    sorting by the keys (sums within rtol=1e-5, atol=1e-3)."""
    jin = pdf if schema is None else JPandasDataFrame(pdf, schema)
    exp = jax_engine.aggregate(jax_engine.to_df(jin), JPartitionSpec(by=by), jaggs)
    tin = engine.to_df(pdf) if schema is None else engine.to_df(pa.Table.from_pandas(pdf), schema)
    got = engine.aggregate(tin, PartitionSpec(by=by), aggs)
    assert str(got.schema) == str(exp.schema)
    g = got.as_arrow().sort_by([(k, "ascending") for k in by])
    e = exp.as_arrow().sort_by([(k, "ascending") for k in by])
    assert g.num_rows == e.num_rows
    for c in g.column_names:
        gv, ev = g.column(c).to_pylist(), e.column(c).to_pylist()
        if pa.types.is_floating(g.schema.field(c).type):
            assert [x is None for x in gv] == [x is None for x in ev], c
            gf = np.array([np.nan if x is None else x for x in gv], dtype=float)
            ef = np.array([np.nan if x is None else x for x in ev], dtype=float)
            assert np.allclose(gf, ef, rtol=1e-5, atol=1e-3, equal_nan=True), c
        else:
            assert gv == ev, c
    return got


@pytest.mark.parametrize(
    "pdf,by,why",
    [
        (pd.DataFrame({"k": [1, 2, 1], "j": [3, 4, 3], "v": [1.0, 2.0, 4.0]}), ["k", "j"], "2 keys"),
        (pd.DataFrame({"k": ["a", "b", None, "a"], "v": [1.0, 2.0, 3.0, 4.0]}), ["k"], "non-numeric"),
        (pd.DataFrame({"k": [1.5, 2.5, 1.5], "v": [1.0, 2.0, 4.0]}), ["k"], "integer keys"),
        (pd.DataFrame({"k": [0, 1 << 20, 0], "v": [1.0, 2.0, 4.0]}), ["k"], "exceeds"),
    ],
)
def test_formerly_unported_plans_match_jax_engine(jax_engine, engine, pdf, by, why):
    # these plans raised before the sorted groupby was ported; ``why`` is
    # the message they raised with
    _same_as_jax(jax_engine, engine, pdf, by, _torch_aggs(aggs=AGGS), _jax_aggs(aggs=AGGS))


_DATES = pd.DataFrame({"k": [1, 2], "d": pd.to_datetime(["2020-01-01", "2021-01-01"]).date})


# the JAX package's form of each case's aggregates, by the case's ``why``
_JAX_AGGS = {
    "uint16": [jff.sum(jcol("v"))],
    "uint64": [jff.max(jcol("v"))],
    "0 keys": [jff.sum(jcol("v"))],
    "DISTINCT": [jff.count_distinct(jcol("v"))],
    "MIN over a date32": [jff.min(jcol("d"))],
    "not an aggregate": [jcol("v")],
    "expressions": [jff.sum(jlit(2))],
}


@pytest.mark.parametrize(
    "pdf,by,aggs,why",
    [
        (pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]}), [], [ff.sum(col("v"))], "0 keys"),
        (pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]}), ["k"], [ff.count_distinct(col("v"))], "DISTINCT"),
        (pd.DataFrame({"k": [1, 2], "v": np.array([1, 2], np.uint16)}), ["k"], [ff.sum(col("v"))], "uint16"),
        (pd.DataFrame({"k": np.array([1, 2], np.uint16), "v": [1.0, 2.0]}), ["k"], [ff.sum(col("v"))], "uint16"),
        (pd.DataFrame({"k": [1, 1], "v": pd.array([2**63 + 5, None], dtype="UInt64")}), ["k"],
         [ff.max(col("v"))], "uint64"),
        (_DATES, ["k"], [ff.min(col("d"))], "MIN over a date32"),
        (pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]}), ["k"], [col("v")], "not an aggregate"),
        (pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]}), ["k"], [ff.sum(lit(2))], "expressions"),
    ],
)
def test_unported_plans_raise(jax_engine, engine, pdf, by, aggs, why):
    """Named for the refusals it pinned before the host engine's aggregate
    and the unsigned device columns were ported: every case now gives the
    JAX engine's answer (a global aggregate, COUNT DISTINCT, MIN over a
    date and SUM of an expression on both host engines; a uint16 value or
    key and a nullable uint64 past 2**63 on both devices), or raises as
    it does. Schemas and values exact."""
    tin = engine.to_df(pdf)
    jaggs = [a.alias("s") for a in _JAX_AGGS[why]]
    try:
        exp = jax_engine.aggregate(jax_engine.to_df(pdf), JPartitionSpec(by=by), jaggs)
    except Exception as e:  # noqa: BLE001 - the port raises as the reference does
        with pytest.raises(Exception) as err:
            engine.aggregate(tin, PartitionSpec(by=by), [a.alias("s") for a in aggs])
        assert type(err.value).__name__ == type(e).__name__ == "FugueInvalidOperation"
        return
    got = engine.aggregate(tin, PartitionSpec(by=by), [a.alias("s") for a in aggs])
    assert isinstance(got, TorchDataFrame) and str(got.schema) == str(exp.schema)
    # rows as arrow values: the JAX frame hands nullable columns to pandas
    # in its extension dtypes, the port in numpy's where no NULL is left
    assert got.as_arrow().to_pylist() == exp.as_arrow().to_pylist()


def test_nullable_int_column_is_not_ported(jax_engine, engine):
    # named for the limit it pinned before nullable columns were ported:
    # now a nullable Int64 column aggregates as in the JAX engine, exactly
    pdf = pd.DataFrame({"k": [1, 2, 1, 2], "v": pd.array([1, None, 2**62, None], dtype="Int64")})
    got = _same_as_jax(jax_engine, engine, pdf, ["k"], _torch_aggs(aggs=AGGS), _jax_aggs(aggs=AGGS))
    assert got.as_arrow().sort_by("k").column("s").to_pylist() == [2**62 + 1, None]


@pytest.mark.parametrize(
    "key_dt,val_dt",
    [
        (np.int32, np.int32),
        (np.int16, np.int64),
        (np.int64, np.float64),
        (np.int8, np.float32),
        (np.uint8, np.int16),
    ],
)
def test_key_and_value_dtypes_match_jax_engine(jax_engine, engine, key_dt, val_dt):
    # SUM of an integer column is long, of a float double; MIN/MAX keep the
    # value's type; the key keeps its own — the JAX engine's output schema
    rng = np.random.default_rng(int(np.dtype(key_dt).itemsize * 10 + np.dtype(val_dt).itemsize))
    n = 3_001
    v = (rng.random(n) * 200 - 100).astype(val_dt)
    pdf = pd.DataFrame({"k": rng.integers(0, 100, n).astype(key_dt), "v": v})
    exp, exp_schema = _run_jax(jax_engine, jax_engine.to_df(pdf))
    res = engine.aggregate(engine.to_df(pdf), PartitionSpec(by=["k"]), _torch_aggs())
    _assert_same(res.as_pandas(), str(res.schema), exp, exp_schema)


def test_repeated_aggregates_reuse_the_key_range(engine):
    pdf = _frame(np.random.default_rng(8), 1_000, 20, nan_frac=0.1)
    tdf = engine.persist(engine.to_df(pdf))
    first = engine.aggregate(tdf, PartitionSpec(by=["k"]), _torch_aggs()).as_pandas()
    assert tdf._key_range_cache == {"k": (int(pdf["k"].min()), int(pdf["k"].max()))}
    again = engine.aggregate(tdf, PartitionSpec(by=["k"]), _torch_aggs()).as_pandas()
    pd.testing.assert_frame_equal(first, again)


def test_device_dense_groupby_matches_jax_ops(jax_engine):
    # ops/segment.py on its own: the same padded device state through the
    # JAX package's device_dense_groupby and the port's, table by table
    from fugue_tpu.ops.segment import device_dense_groupby as jax_dense
    from fugue_tpu_torch.ops.segment import dense_buckets, device_dense_groupby

    pdf = _gappy(np.random.default_rng(12))
    pdf["w"] = np.arange(len(pdf), dtype=np.int32) % 17 - 8
    jdf = jax_engine.to_df(pdf)
    kmin, kmax = jdf.key_range("k")
    buckets = dense_buckets(kmax - kmin + 1)
    specs = [("s", "sum", "v", True), ("n", "count", "v", True), ("lo", "min", "v", True),
             ("hi", "max", "v", True), ("ws", "sum", "w", False), ("wlo", "min", "w", False)]
    j_present, j_named = jax_dense(
        jdf.mesh, jdf.device_cols["k"],
        [(n, a, jdf.device_cols[c], nl) for n, a, c, nl in specs],
        jdf.device_valid_mask(), kmin, buckets,
    )
    tdf = frame_from_numpy(
        {c: np.asarray(jdf.device_cols[c]) for c in jdf.schema.names},
        str(jdf.schema), valid=np.asarray(jdf.device_valid_mask()), device="cpu",
    )
    t_present, t_named = device_dense_groupby(
        tdf.device_cols["k"],
        [(n, a, tdf.device_cols[c], nl) for n, a, c, nl in specs],
        tdf.device_valid_mask(), kmin, buckets,
    )
    assert np.array_equal(t_present.numpy(), np.asarray(j_present))
    for (tn, ta), (jn, ja) in zip(t_named, j_named):
        assert tn == jn
        t, j = ta.numpy(), np.asarray(ja)
        assert t.dtype == j.dtype, tn
        if tn == "s":
            assert np.allclose(t, j, rtol=1e-5, atol=1e-3, equal_nan=True)
        else:
            assert np.array_equal(t, j, equal_nan=t.dtype.kind == "f"), tn


@pytest.mark.parametrize(
    "keys", [[1, 1, 2], [1, 1, 1 << 40], ["a", "a", "b"]], ids=["dense", "wide-int", "string"]
)
def test_avg_and_sum_of_a_bool_column(jax_engine, engine, keys):
    """ROADMAP.md C7: a bool column sums as int64, so AVG divides a true
    count (a bool accumulator saturated, and AVG came out 0.5). SUM keeps
    its declared bool type, as the native engine gives it. The JAX engine
    raises on the non-nullable column (a fault of the reference, left as
    it is) and answers on the same column made nullable."""
    pdf = pd.DataFrame({"k": keys, "v": [True, True, False]})
    native = NativeExecutionEngine()
    jaggs = [jff.avg(jcol("v")).alias("a"), jff.sum(jcol("v")).alias("s")]
    exp = native.aggregate(native.to_df(pdf), JPartitionSpec(by=["k"]), jaggs)
    got = engine.aggregate(
        engine.to_df(pdf), PartitionSpec(by=["k"]),
        [ff.avg(col("v")).alias("a"), ff.sum(col("v")).alias("s")],
    )
    assert str(got.schema) == str(exp.schema)
    pd.testing.assert_frame_equal(
        got.as_pandas().sort_values("k").reset_index(drop=True),
        exp.as_pandas().sort_values("k").reset_index(drop=True),
    )
    assert got.as_pandas().sort_values("k")["a"].tolist() == [1.0, 0.0]
    with pytest.raises(TypeError, match="bool"):
        jax_engine.aggregate(jax_engine.to_df(pdf), JPartitionSpec(by=["k"]), jaggs)
    # the same column made nullable: one NULL more in the first group
    nullable = pa.table({"k": keys + keys[:1], "v": pa.array([True, True, False, None])})
    jexp = jax_engine.aggregate(jax_engine.to_df(nullable), JPartitionSpec(by=["k"]), jaggs)
    pd.testing.assert_frame_equal(
        got.as_pandas().sort_values("k").reset_index(drop=True),
        jexp.as_pandas().sort_values("k").reset_index(drop=True),
    )


@pytest.mark.parametrize("keys", [[1, 2, 1], [1, 1 << 40, 1]], ids=["dense", "sorted"])
def test_min_max_of_a_bool_column(jax_engine, engine, keys):
    """ROADMAP.md C9: MIN/MAX over a bool column. On the non-nullable
    column the JAX engine raises (``jnp.iinfo`` of bool,
    ``fugue_tpu/ops/segment.py:209``), a fault of the reference left as it
    is; the port reduces the bools as uint8 and answers as the native
    engine does. The nullable column (a float view on both) gives
    the JAX engine's answer."""
    native = NativeExecutionEngine()
    jaggs = [jff.min(jcol("b")).alias("lo"), jff.max(jcol("b")).alias("hi")]
    for b in (pa.array([True, False, False]), pa.array([True, None, False])):
        data = pa.table({"k": keys, "b": b})
        exp = native.aggregate(native.to_df(data), JPartitionSpec(by=["k"]), jaggs)
        got = engine.aggregate(engine.to_df(data), PartitionSpec(by=["k"]),
                               [ff.min(col("b")).alias("lo"), ff.max(col("b")).alias("hi")])
        assert str(got.schema) == str(exp.schema) == "k:long,lo:bool,hi:bool"
        assert got.as_arrow().sort_by("k").to_pylist() == exp.as_arrow().sort_by("k").to_pylist()
        if b.null_count == 0:
            with pytest.raises(ValueError, match="integer data type"):
                jax_engine.aggregate(jax_engine.to_df(data), JPartitionSpec(by=["k"]), jaggs)
        else:
            jexp = jax_engine.aggregate(jax_engine.to_df(data), JPartitionSpec(by=["k"]), jaggs)
            assert got.as_arrow().sort_by("k").to_pylist() == jexp.as_arrow().sort_by("k").to_pylist()
