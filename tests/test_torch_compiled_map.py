"""``fugue_tpu_torch.api.transform`` (device="cpu") against
``fugue_tpu.api.transform`` on ``JaxExecutionEngine`` (the 8-device CPU
mesh), for ``Dict[str, torch.Tensor]`` transformers in the three compiled
forms: keyless, keyed on the dense plan, keyed on the sorted plan.

The cases are the ten of ``tests/jax_engine/test_compiled_keyed.py``, plus
keyless maps, the window helpers under a presort, bench.py's demean and
ridge-HPO UDFs at small size, the choice of plan, the transformers both
packages hand to their host engines, ``*`` schemas, and the refusals. Each
UDF is written once as ``body(group_ops, cols, array module)`` and wrapped
with each package's annotation, except where ``chip_smoke.py``'s
``transform_path`` UDFs (torch only) are held against the JAX package's;
its five frames and oracles run here too, at small size.

Row order differs by design (the JAX package's sorted plan exchanges rows
between shards first; the port sorts once), so outputs are compared after
sorting by every column. Exact: schema, row count, keys, decoded string
keys and NULL placement. Floats: pandas' ``assert_frame_equal`` default
``rtol=1e-5``, as the reference's own tests compare; the ridge UDF
``atol=1e-6``, as bench.py checks it.
"""

import decimal
import unittest.mock as mock
from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import chip_smoke
import fugue_tpu.api as fa
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu.jax import group_ops as jgo
from fugue_tpu_torch import api
from fugue_tpu_torch.exceptions import FugueInvalidOperation
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine, frame_from_numpy
from fugue_tpu_torch.torch import group_ops as tgo


SMOKE_UDFS = chip_smoke.transform_udfs(torch, tgo)


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine()
    yield e
    e.stop()


@pytest.fixture(scope="module")
def engine():
    return TorchExecutionEngine(device="cpu")


def _pair(body: Callable):
    """The JAX and the torch transformer of one ``body(go, cols, xp)``."""

    def jax_udf(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        return body(jgo, cols, jnp)

    def torch_udf(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return body(tgo, cols, torch)

    return jax_udf, torch_udf


def _run_both(jax_engine, engine, data, body, schema, partition=None):
    """(the JAX package's result, the port's result) as arrow tables."""
    jax_udf, torch_udf = _pair(body) if callable(body) else body
    jin = data if not isinstance(data, tuple) else data[0]
    tin = data if not isinstance(data, tuple) else data[1]
    exp = fa.transform(jax_engine.to_df(jin), jax_udf, schema=schema, partition=partition,
                       engine=jax_engine, as_fugue=True)
    got = api.transform(tin, torch_udf, schema=schema, partition=partition, engine=engine,
                        as_fugue=True)
    assert isinstance(got, TorchDataFrame)  # stayed on the device
    return exp.as_arrow(), got.as_arrow()


def _sorted(tbl: pa.Table) -> pd.DataFrame:
    return tbl.to_pandas().sort_values(tbl.column_names).reset_index(drop=True)


def _assert_same(exp: pa.Table, got: pa.Table, **tol: Any) -> None:
    assert got.schema.equals(exp.schema), (got.schema, exp.schema)
    assert got.num_rows == exp.num_rows
    pd.testing.assert_frame_equal(_sorted(got), _sorted(exp), **tol)


def _demean(go, cols, xp):
    m = go.mean(cols, cols["v"])
    return {"k": cols["k"], "v": cols["v"], "d": cols["v"] - go.per_row(cols, m)}


def _plan(go, cols, xp):
    """Which plan the engine chose: 1 under the dense plan's markers."""
    k = next(c for n, c in cols.items() if not n.startswith("__"))
    return {"dense": k * 0 + int(go.SPANS_SHARDS in cols)}


# ---- the ten cases of tests/jax_engine/test_compiled_keyed.py ----------


def test_keyed_compiled_demean_matches_oracle(jax_engine, engine):
    rng = np.random.default_rng(5)
    pdf = pd.DataFrame({"k": rng.integers(0, 37, 10_000), "v": rng.random(10_000)})
    exp, got = _run_both(jax_engine, engine, pdf, _demean, "k:long,v:double,d:double",
                         {"by": ["k"]})
    _assert_same(exp, got)
    oracle = pdf.assign(d=pdf["v"] - pdf.groupby("k")["v"].transform("mean"))
    oracle = pa.Table.from_pandas(oracle, preserve_index=False)
    pd.testing.assert_frame_equal(_sorted(got), _sorted(oracle), check_dtype=False)


def test_keyed_compiled_wide_range_sorted_plan(jax_engine, engine):
    rng = np.random.default_rng(6)
    ks = rng.integers(0, 2**40, 17)
    pdf = pd.DataFrame({"k": np.repeat(ks, 100), "v": rng.random(1700)})
    exp, got = _run_both(jax_engine, engine, pdf, _demean, "k:long,v:double,d:double",
                         {"by": ["k"]})
    _assert_same(exp, got)


def test_keyed_compiled_multi_key_and_presort(jax_engine, engine):
    pdf = pd.DataFrame({
        "a": [1, 1, 1, 2, 2, 2, 1, 1],
        "b": [0, 0, 1, 0, 0, 1, 1, 0],
        "v": [5.0, 3.0, 9.0, 2.0, 8.0, 1.0, 7.0, 4.0],
    })

    def gap_to_max(go, cols, xp):
        mx = go.segment_max(cols, cols["v"])
        return {"a": cols["a"], "b": cols["b"], "gap": go.per_row(cols, mx) - cols["v"]}

    exp, got = _run_both(jax_engine, engine, pdf, gap_to_max, "a:long,b:long,gap:double",
                         {"by": ["a", "b"], "presort": "v desc"})
    _assert_same(exp, got)


def test_keyed_compiled_multi_key_dense(jax_engine, engine):
    rng = np.random.default_rng(7)
    pdf = pd.DataFrame({
        "a": rng.integers(0, 10, 5000),
        "b": rng.integers(100, 140, 5000),
        "v": rng.random(5000),
    })

    def demean(go, cols, xp):
        m = go.mean(cols, cols["v"])
        return {"a": cols["a"], "b": cols["b"], "d": cols["v"] - go.per_row(cols, m)}

    exp, got = _run_both(jax_engine, engine, pdf, demean, "a:long,b:long,d:double",
                         {"by": ["a", "b"]})
    _assert_same(exp, got)


@pytest.mark.parametrize("partition", [{"by": ["k"]}, {"by": ["k"], "presort": "v"}],
                         ids=["dense", "sorted"])
def test_keyed_compiled_padding_isolation(jax_engine, engine, partition):
    """10 rows over 8 shards: the JAX frame carries padding rows; carried
    into the port with its valid mask, the padding must stay out of every
    group's count under either plan."""
    pdf = pd.DataFrame({"k": [1] * 5 + [2] * 5, "v": [1.0] * 10})
    jdf = jax_engine.to_df(pdf)
    valid = np.asarray(jdf.device_valid_mask())
    assert not valid.all()
    tdf = frame_from_numpy({c: np.asarray(a) for c, a in jdf.device_cols.items()},
                           str(jdf.schema), valid=valid, device="cpu")

    def group_count(go, cols, xp):
        return {"k": cols["k"], "n": go.per_row(cols, go.segment_count(cols))}

    exp, got = _run_both(jax_engine, engine, (jdf, tdf), group_count, "k:long,n:double",
                         partition)
    _assert_same(exp, got)
    assert got.num_rows == 10
    assert got.to_pandas().groupby("k")["n"].first().tolist() == [5.0, 5.0]


def test_keyed_compiled_min_sum_helpers(jax_engine, engine):
    pdf = pd.DataFrame({"k": [1, 1, 2, 2, 2], "v": [4.0, 2.0, 10.0, 30.0, 20.0]})

    def stats(go, cols, xp):
        s = go.segment_sum(cols, cols["v"])
        lo = go.segment_min(cols, cols["v"])
        return {"k": cols["k"], "s": go.per_row(cols, s), "lo": go.per_row(cols, lo)}

    exp, got = _run_both(jax_engine, engine, pdf, stats, "k:long,s:double,lo:double",
                         {"by": ["k"]})
    _assert_same(exp, got)
    g = got.to_pandas().drop_duplicates("k").sort_values("k")
    assert g["s"].tolist() == [6.0, 60.0]
    assert g["lo"].tolist() == [2.0, 10.0]


def _str_key_frame(n=6000, nulls=False, seed=11):
    rng = np.random.default_rng(seed)
    cities = np.array(["osaka", "lima", "oslo", "pune", "kiel", "bern"])
    k = cities[rng.integers(0, len(cities), n)].astype(object)
    if nulls:
        k[rng.random(n) < 0.1] = None
    return pd.DataFrame({"k": pd.Series(k, dtype="str"), "v": rng.random(n)})


@pytest.mark.parametrize(
    "nulls, partition",
    [(False, {"by": ["k"]}), (True, {"by": ["k"], "presort": "v"})],
    ids=["dense", "sorted_plan_and_nulls"],
)
def test_keyed_compiled_string_keys(jax_engine, engine, nulls, partition):
    """Dictionary-encoded partition keys: the UDF groups by the codes and
    the engine puts the dictionary back; NULL (-1) is its own group."""
    pdf = _str_key_frame(nulls=nulls, seed=17 if nulls else 11)
    exp, got = _run_both(jax_engine, engine, pdf, _demean, "k:str,v:double,d:double", partition)
    _assert_same(exp, got)
    res = api.transform(pdf, _pair(_demean)[1], schema="k:str,v:double,d:double",
                        partition=partition, engine=engine, as_fugue=True)
    assert res.encodings["k"]["kind"] == "dict"  # put back on the codes
    assert got.column("k").null_count == pdf["k"].isna().sum()


def test_keyed_compiled_mixed_string_int_keys(jax_engine, engine):
    rng = np.random.default_rng(23)
    n = 4000
    pdf = pd.DataFrame({
        "g": pd.Series(np.array(["x", "y", "z"])[rng.integers(0, 3, n)], dtype="str"),
        "k": rng.integers(0, 11, n),
        "v": rng.random(n),
    })

    def demean(go, cols, xp):
        m = go.mean(cols, cols["v"])
        return {"g": cols["g"], "k": cols["k"], "d": cols["v"] - go.per_row(cols, m)}

    exp, got = _run_both(jax_engine, engine, pdf, demean, "g:str,k:long,d:double",
                         {"by": ["g", "k"]})
    _assert_same(exp, got, atol=1e-12)
    assert got.to_pandas().groupby(["g", "k"])["d"].mean().abs().max() < 1e-12


@pytest.mark.parametrize("case", ["encoded_non_key", "key_changes_type"])
def test_keyed_compiled_string_keys_bad_shapes_raise(jax_engine, engine, case):
    pdf = pd.DataFrame({
        "k": pd.Series(["a", "a", "b"], dtype="str"),
        "s": pd.Series(["p", "q", "r"], dtype="str"),
        "v": [1.0, 2.0, 3.0],
    })
    if case == "encoded_non_key":  # the UDF would see meaningless codes
        data, schema = pdf, "k:str,s:str,v:double"
    else:  # codes can't become longs
        data, schema = pdf[["k", "v"]], "k:long,v:double"
    jf, tf = _pair(lambda go, cols, xp: cols)
    with pytest.raises(Exception, match="compiled keyed map unavailable"):
        fa.transform(jax_engine.to_df(data), jf, schema=schema, partition={"by": ["k"]},
                     engine=jax_engine, as_fugue=True)
    with pytest.raises(FugueInvalidOperation, match="compiled keyed map unavailable"):
        api.transform(data, tf, schema=schema, partition={"by": ["k"]}, engine=engine)


# ---- keyless maps --------------------------------------------------------


def _frame(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 1000, n), "v": rng.random(n)})


def test_keyless_elementwise_map(jax_engine, engine):
    jax_udf = _pair(lambda go, cols, xp: {"k": cols["k"], "v": cols["v"] * 2 + 1})[0]
    exp, got = _run_both(jax_engine, engine, _frame(), (jax_udf, SMOKE_UDFS["map_keyless"]),
                         "k:long,v:double")
    _assert_same(exp, got)


def test_keyless_map_of_another_length(jax_engine, engine):
    """Every other row: the same rows on one device as over 8 shards of an
    even length each, so the output does not depend on the layout."""
    exp, got = _run_both(jax_engine, engine, _frame(),
                         lambda go, cols, xp: {"v": cols["v"][::2] - 1},
                         "v:double")
    _assert_same(exp, got)
    assert got.num_rows == 2048


def test_keyless_map_masks_padding_with_valid(jax_engine, engine):
    """A carried frame with padding rows: an output that zeroes the
    invalid rows keeps the input's valid rows."""
    jdf = jax_engine.to_df(_frame(n=1001))
    valid = np.asarray(jdf.device_valid_mask())
    tdf = frame_from_numpy({c: np.asarray(a) for c, a in jdf.device_cols.items()},
                           str(jdf.schema), valid=valid, device="cpu")

    def body(go, cols, xp):
        return {"k": cols["k"], "v": xp.where(cols["__valid__"], cols["v"], 0.0)}

    exp, got = _run_both(jax_engine, engine, (jdf, tdf), body, "k:long,v:double")
    _assert_same(exp, got)
    assert got.num_rows == 1001


def test_keyless_output_casts_to_the_schema(jax_engine, engine):
    """An int32 tensor declared long comes out as long; float32 declared
    double as double, as ``JaxDataFrame.as_arrow`` casts them."""
    def body(go, cols, xp):
        i32 = jnp.int32 if xp is jnp else torch.int32
        f32 = jnp.float32 if xp is jnp else torch.float32
        return {"k": cols["k"].astype(i32) if xp is jnp else cols["k"].to(i32),
                "v": cols["v"].astype(f32) if xp is jnp else cols["v"].to(f32)}

    exp, got = _run_both(jax_engine, engine, _frame(), body, "k:long,v:double")
    _assert_same(exp, got)
    assert got.schema.field("k").type == pa.int64()


# ---- window helpers, bench.py's UDFs, the plan chosen --------------------


def test_window_presort(jax_engine, engine):
    """chip_smoke.py's window-presort frame at small size: ``t`` a
    permutation, so no two rows tie on (k, t) and the order-dependent
    outputs are defined."""
    rng = np.random.default_rng(0)
    n = 3000
    pdf = pd.DataFrame({"k": rng.integers(0, 20, n), "t": rng.permutation(n), "v": rng.random(n)})

    def window(go, cols, xp):
        return {"k": cols["k"], "t": cols["t"], "rn": go.row_number(cols),
                "rs": go.running_sum(cols, cols["v"]), "rm": go.running_max(cols, cols["v"]),
                "lg": go.lag(cols, cols["v"])}

    schema = "k:long,t:long,rn:long,rs:double,rm:double,lg:double"
    udfs = (_pair(window)[0], SMOKE_UDFS["window"])
    exp, got = _run_both(jax_engine, engine, pdf, udfs, schema, {"by": ["k"], "presort": "t"})
    _assert_same(exp, got)
    s = pdf.sort_values(["k", "t"])
    g = s.groupby("k")["v"]
    oracle = pd.DataFrame({"k": s["k"], "t": s["t"], "rn": s.groupby("k").cumcount() + 1,
                           "rs": g.cumsum(), "rm": g.cummax(), "lg": g.shift(1)})
    oracle = pa.Table.from_pandas(oracle, preserve_index=False)
    pd.testing.assert_frame_equal(_sorted(got), _sorted(oracle), check_dtype=False)


@pytest.mark.parametrize("presort", ["v", "v desc", "b desc, i", "i desc"])
def test_presort_directions_and_nan_first(jax_engine, engine, presort):
    """Each sort column type in each direction, NaN first in a float
    presort either way; one NaN a group and unique ``i``, so no two rows of
    a group tie and ``row_number`` is defined."""
    rng = np.random.default_rng(4)
    n = 60
    v = rng.permutation(n).astype(np.float64)
    v[[0, 1, 2]] = np.nan  # one a group
    i = rng.permutation(n)
    pdf = pd.DataFrame({"k": np.arange(n) % 3, "v": v, "i": i, "b": i % 2 == 0})

    def rank(go, cols, xp):
        return {"k": cols["k"], "i": cols["i"], "rn": go.row_number(cols)}

    exp, got = _run_both(jax_engine, engine, pdf, rank, "k:long,i:long,rn:long",
                         {"by": ["k"], "presort": presort})
    _assert_same(exp, got)
    if presort.startswith("v"):
        first = got.to_pandas().set_index("i").loc[i[[0, 1, 2]], "rn"]
        assert (first == 1).all()


@pytest.mark.parametrize("partition", [None, {"by": ["k"]}, {"by": ["k"], "presort": "v"}],
                         ids=["keyless", "dense", "sorted"])
def test_empty_frame(jax_engine, engine, partition):
    pdf = pd.DataFrame({"k": np.array([], dtype=np.int64), "v": np.array([], dtype=np.float64)})

    def body(go, cols, xp):
        if go.SEGMENTS not in cols:
            return {"k": cols["k"], "v": cols["v"] + 1}
        return _demean(go, cols, xp)

    schema = "k:long,v:double" if partition is None else "k:long,v:double,d:double"
    exp, got = _run_both(jax_engine, engine, pdf, body, schema, partition)
    _assert_same(exp, got)
    assert got.num_rows == 0


def test_bench_demean(jax_engine, engine):
    """bench.py's ``demean_jax`` (:530) on its frame shape, 1,000 keys."""
    pdf = _frame(n=5000, seed=42)

    def demean(go, cols, xp):
        m = go.mean(cols, cols["v"])
        return {"k": cols["k"], "v": cols["v"] - go.per_row(cols, m)}

    udfs = (_pair(demean)[0], SMOKE_UDFS["demean"])
    exp, got = _run_both(jax_engine, engine, pdf, udfs, "k:long,v:double", {"by": ["k"]})
    _assert_same(exp, got)


def _hpo_frame(rows_per: int, configs: int = 32) -> pd.DataFrame:
    """bench.py's ``_make_hpo_frame`` (:588) at ``rows_per`` rows a config."""
    rng = np.random.default_rng(23)
    x = rng.random((rows_per, 4))
    y = x @ np.asarray([1.0, -2.0, 0.5, 3.0]) + rng.normal(0, 0.1, rows_per)
    frames = []
    for c in range(configs):
        f = pd.DataFrame(x, columns=[f"x{i}" for i in range(4)])
        f["y"] = y
        f["config"] = c
        f["alpha"] = 10.0 ** (c / 4 - 4)
        frames.append(f)
    return pd.concat(frames, ignore_index=True)


def ridge_fit_score_jax(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    """bench.py's ``ridge_fit_score`` (:643) as it is."""
    xs = [cols[f"x{i}"] for i in range(4)]
    y = cols["y"]
    ata = [[jgo.segment_sum(cols, xs[i] * xs[j]) for j in range(4)] for i in range(4)]
    aty = [jgo.segment_sum(cols, xs[i] * y) for i in range(4)]
    alpha_g = jgo.segment_max(cols, cols["alpha"])
    A = jnp.stack([jnp.stack(r, axis=-1) for r in ata], axis=-2)
    A = A + alpha_g[:, None, None] * jnp.eye(4, dtype=A.dtype)
    b = jnp.stack(aty, axis=-1)
    w = jnp.linalg.solve(A, b[..., None])[..., 0]
    pred = sum(jgo.per_row(cols, w[:, i]) * xs[i] for i in range(4))
    return {"config": cols["config"], "resid": y - pred}


def test_bench_ridge_hpo(jax_engine, engine):
    pdf = _hpo_frame(rows_per=100)
    exp, got = _run_both(jax_engine, engine, pdf, (ridge_fit_score_jax, SMOKE_UDFS["ridge"]),
                         "config:long,resid:double", {"by": ["config"]})
    _assert_same(exp, got, atol=1e-6)
    # bench.py's oracle: the per-config closed form
    x = pdf[[f"x{i}" for i in range(4)]].to_numpy()[:100]
    y = pdf["y"].to_numpy()[:100]
    res = got.to_pandas()
    for c in (0, 17, 31):
        w = np.linalg.solve(x.T @ x + 10.0 ** (c / 4 - 4) * np.eye(4), x.T @ y)
        np.testing.assert_allclose(np.sort(res[res["config"] == c]["resid"]), np.sort(y - x @ w),
                                   atol=1e-6)


def _plan_frames():
    rng = np.random.default_rng(9)
    n = 64
    base = {"v": rng.random(n)}
    span = 1 << 20
    return {
        "int_span_2_20": ({"k": np.resize([0, span - 1], n), **base}, None, 1),
        "int_span_over_2_20": ({"k": np.resize([0, span], n), **base}, None, 0),
        "two_keys_product_2_20": (
            {"k": np.resize([0, 1023], n), "j": np.resize([5, 5, 1028, 1028], n), **base}, None, 1),
        "two_keys_product_over": (
            {"k": np.resize([0, 1024], n), "j": np.resize([5, 5, 1028, 1028], n), **base}, None, 0),
        "uint8_key": ({"k": rng.integers(0, 255, n).astype(np.uint8), **base}, None, 1),
        "bool_key": ({"k": rng.random(n) < 0.5, **base}, None, 0),
        "float_key": ({"k": rng.integers(0, 5, n).astype(np.float64), **base}, None, 0),
        "string_key": ({"k": pd.Series(np.resize(["a", "b", None], n), dtype="str"), **base},
                       None, 1),
        "presort": ({"k": rng.integers(0, 5, n), **base}, "v", 0),
    }


@pytest.mark.parametrize("case", sorted(_plan_frames()))
def test_plan_chosen_matches_the_jax_package(jax_engine, engine, case):
    data, presort, dense = _plan_frames()[case]
    pdf = pd.DataFrame(data)
    keys = [c for c in pdf.columns if c != "v"]
    partition = {"by": keys} if presort is None else {"by": keys, "presort": presort}
    exp, got = _run_both(jax_engine, engine, pdf, _plan, "dense:long", partition)
    _assert_same(exp, got)
    assert set(got.column("dense").to_pylist()) == {dense}


@pytest.mark.parametrize("cell", sorted(chip_smoke.TRANSFORM_CELLS))
def test_chip_smoke_transform_cells_on_the_cpu(engine, cell):
    """chip_smoke.py's transform_path cells at 16,000 rows: the plan each
    takes, its float64 oracle, and that the oracle rejects a wrong answer."""
    kind, udf, schema, partition, plan = chip_smoke.TRANSFORM_CELLS[cell]
    cols, frame_schema, aux = chip_smoke.transform_frame(np, kind, 32 * 500, 0)
    tdf = frame_from_numpy(cols, frame_schema, nan_cols=(), device="cpu")
    res = api.transform(tdf, SMOKE_UDFS[udf], schema=schema, partition=partition, engine=engine)
    assert (res.valid_mask is not None) == (plan == "sorted")
    got = res.as_arrow()
    chip_smoke.check_transform(np, cell, got, cols, aux)
    last = got.column_names[-1]
    wrong = got.set_column(got.num_columns - 1, last,
                           pc.add(got.column(last), 1e-3 if plan != "sorted" else 1))
    with pytest.raises(RuntimeError, match=cell):
        chip_smoke.check_transform(np, cell, wrong, cols, aux)


# ---- refusals ------------------------------------------------------------


@pytest.mark.parametrize("case", ["maybe_nan_key", "nullable_non_key", "host_table"])
def test_refused_keyed_shapes(jax_engine, engine, case):
    if case == "maybe_nan_key":
        pdf = pd.DataFrame({"k": [1.0, np.nan, 2.0], "v": [1.0, 2.0, 3.0]})
    elif case == "nullable_non_key":
        pdf = pd.DataFrame({"k": [1, 1, 2], "v": pd.array([1, None, 3], dtype="Int64")})
    else:
        pdf = pa.table({"k": [1, 1, 2], "v": pa.array([decimal.Decimal(i) for i in range(3)])})
    jf, tf = _pair(lambda go, cols, xp: {"k": cols["k"]})
    with pytest.raises(Exception, match="compiled keyed map unavailable"):
        fa.transform(jax_engine.to_df(pdf), jf, schema="k:double", partition={"by": ["k"]},
                     engine=jax_engine, as_fugue=True)
    with pytest.raises(FugueInvalidOperation, match="compiled keyed map unavailable"):
        api.transform(pdf, tf, schema="k:double", partition={"by": ["k"]}, engine=engine)


def test_host_transformers_are_not_ported(engine, jax_engine):
    """What of the host transformers is still not ported: a function
    annotated with ``jax.Array`` (the port never imports JAX to run it)
    (the forked pool, refused here until it was ported, runs: its result
    equals the serial map's). The transformers
    both packages run on their host engines are held against each other
    in ``test_host_transformers_run_on_the_host_engine``. A callback (not
    ported before the RPC server was) runs: a device function that takes
    one never takes the compiled map, so the host calls it once a
    partition, as the JAX engine does."""
    def jax_annotated(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        return cols

    with pytest.raises(NotImplementedError, match="jax.Array"):
        api.transform(_frame(16), jax_annotated, schema="k:long,v:double", engine=engine)
    pool = TorchExecutionEngine(device="cpu", conf={"fugue.tpu.map.parallelism": 4,
                                                    "fugue.tpu.map.parallel_min_rows": 0})
    pooled = api.transform(_frame(16), _pandas_identity, schema="*", partition={"by": ["k"]}, engine=pool)
    serial = api.transform(_frame(16), _pandas_identity, schema="*", partition={"by": ["k"]}, engine=engine)
    assert sorted(map(tuple, pooled.values.tolist())) == sorted(map(tuple, serial.values.tolist()))
    assert pool.resilience_stats.as_dict()["map.chunks_ok"] >= 2
    seen = {"jax": [], "torch": []}
    fa.transform(jax_engine.to_df(_frame(16)), _pandas_counting, schema="*", partition={"by": ["k"]},
                 callback=seen["jax"].append, engine=jax_engine)
    api.transform(_frame(16), _pandas_counting, schema="*", partition={"by": ["k"]},
                  callback=seen["torch"].append, engine=engine)
    assert sorted(seen["torch"]) == sorted(seen["jax"]) and sum(seen["torch"]) == 16

    def device_counting(cols: Dict[str, torch.Tensor], cb: Callable) -> Dict[str, torch.Tensor]:
        cb(int(cols["k"].shape[0]))
        return {"k": cols["k"], "v": cols["v"] * 2}

    rows = []
    got = api.transform(_frame(16), device_counting, schema="k:long,v:double", partition={"by": ["k"]},
                        callback=rows.append, engine=engine)
    assert sorted(rows) == sorted(seen["torch"])
    assert np.allclose(got.sort_values(["k", "v"])["v"].to_numpy(),
                       _frame(16).sort_values(["k", "v"])["v"].to_numpy() * 2)


def _pandas_identity(df: pd.DataFrame) -> pd.DataFrame:
    return df


def _pandas_counting(df: pd.DataFrame, cb: Callable) -> pd.DataFrame:
    cb(len(df))
    return df


def _host_udfs(case: str):
    """The JAX package's and the port's transformer of one host case."""
    if case == "pandas_udf":
        def demean(df: pd.DataFrame) -> pd.DataFrame:
            df["v"] = df["v"] - df["v"].mean()
            return df

        return demean, demean
    if case == "two_params":
        def jax_two(cols: Dict[str, jax.Array], a: int = 1) -> Dict[str, jax.Array]:
            return {"k": cols["k"], "v": cols["v"] * a}

        def torch_two(cols: Dict[str, torch.Tensor], a: int = 1) -> Dict[str, torch.Tensor]:
            return {"k": cols["k"], "v": cols["v"] * a}

        return jax_two, torch_two
    if case == "lambda":
        return (lambda cols: cols), (lambda cols: cols)
    return _pair(lambda go, cols, xp: {"v": cols["v"] + 1})  # keyless_encoded


@pytest.mark.parametrize("case", ["pandas_udf", "two_params", "lambda", "keyless_encoded"])
def test_host_transformers_run_on_the_host_engine(jax_engine, engine, case):
    """Transformers the JAX package maps on its host engine: a pandas UDF
    grouped by key, a device-annotated function with a second parameter
    (``params`` reach it), an unannotated lambda (both refuse it alike),
    and a keyless compiled map over a dictionary-string column. The port
    maps each on its host engine and gives the JAX engine's answer, or its
    error."""
    jf, tf = _host_udfs(case)
    kw: Dict[str, Any] = {"schema": "*"}
    pdf = _frame(64)
    if case == "pandas_udf":
        kw["partition"] = {"by": ["k"]}
    elif case == "two_params":
        kw["params"] = {"a": 3}
    elif case == "keyless_encoded":
        pdf = pd.DataFrame({"s": pd.Series(["b", "a", None, "b"], dtype="str"), "v": [1.0, 2.0, 3.0, 4.0]})
        kw["schema"] = "v:double"
    if case == "lambda":
        with pytest.raises(Exception) as exp_err:
            fa.transform(jax_engine.to_df(pdf), jf, engine=jax_engine, **kw)
        with pytest.raises(Exception) as got_err:
            api.transform(pdf, tf, engine=engine, **kw)
        assert type(got_err.value).__name__ == type(exp_err.value).__name__ == "FugueInterfacelessError"
        assert "input signature 'x'" in str(got_err.value)
        return
    host = engine._host_engine.map_engine
    exp = fa.transform(jax_engine.to_df(pdf), jf, engine=jax_engine, as_fugue=True, **kw)
    with mock.patch.object(type(host), "map_dataframe", autospec=True,
                           side_effect=type(host).map_dataframe) as spy:
        got = api.transform(pdf, tf, engine=engine, as_fugue=True, **kw)
    assert spy.call_count == 1
    assert isinstance(got, TorchDataFrame)
    _assert_same(exp.as_arrow(), got.as_arrow())


@pytest.mark.parametrize("partition", [None, {"by": ["k"]}])
def test_star_schema_resolves_against_the_input(jax_engine, engine, partition):
    """A compiled transformer's ``*`` schema is the input's columns."""
    jf, tf = _pair(lambda go, cols, xp: {"k": cols["k"], "v": cols["v"] * 2})
    exp = fa.transform(jax_engine.to_df(_frame(64)), jf, schema="*,w:double,-w", partition=partition,
                       engine=jax_engine, as_fugue=True)
    got = api.transform(_frame(64), tf, schema="*,w:double,-w", partition=partition, engine=engine,
                        as_fugue=True)
    assert str(got.schema) == "k:long,v:double"
    _assert_same(exp.as_arrow(), got.as_arrow())


def test_params_are_refused_where_the_reference_drops_them(jax_engine, engine):
    """Fault C4 of the reference: ``params`` given to a compiled
    transformer are accepted and dropped. The port refuses them."""
    pdf = _frame(16)
    jf, tf = _pair(lambda go, cols, xp: {"k": cols["k"], "v": cols["v"]})
    for partition in (None, {"by": ["k"]}):
        exp = fa.transform(jax_engine.to_df(pdf), jf, schema="k:long,v:double", params={"a": 10},
                           partition=partition, engine=jax_engine, as_fugue=True)
        assert np.allclose(np.sort(exp.as_pandas()["v"]), np.sort(pdf["v"]))  # no effect
        with pytest.raises(FugueInvalidOperation, match="params"):
            api.transform(pdf, tf, schema="k:long,v:double", params={"a": 10},
                          partition=partition, engine=engine)


@pytest.mark.parametrize("case", ["not_a_dict", "missing_column", "not_row_aligned", "star_schema"])
def test_bad_outputs_raise(engine, case):
    """``star_schema``: ``*`` resolves to the input's columns (k, v), and an
    output without ``v`` lacks one of them."""
    bodies = {
        "not_a_dict": lambda go, cols, xp: [cols["v"]],
        "missing_column": lambda go, cols, xp: {"k": cols["k"]},
        "not_row_aligned": lambda go, cols, xp: {"k": cols["k"][:3], "v": cols["v"][:3]},
        "star_schema": lambda go, cols, xp: {"k": cols["k"]},
    }
    tf = _pair(bodies[case])[1]
    schema = "*" if case == "star_schema" else "k:long,v:double"
    with pytest.raises(FugueInvalidOperation):
        api.transform(_frame(16), tf, schema=schema, partition={"by": ["k"]}, engine=engine)


@pytest.mark.parametrize("kind", ["pandas", "arrow", "frame"])
def test_result_has_the_input_family(engine, kind):
    pdf = _frame(16)
    data = {"pandas": pdf, "arrow": pa.Table.from_pandas(pdf),
            "frame": engine.to_df(pdf)}[kind]
    tf = _pair(lambda go, cols, xp: {"k": cols["k"], "v": cols["v"]})[1]
    res = api.transform(data, tf, schema="k:long,v:double", partition=["k"], engine=engine)
    family = {"pandas": pd.DataFrame, "arrow": pa.Table, "frame": TorchDataFrame}[kind]
    assert isinstance(res, family)
