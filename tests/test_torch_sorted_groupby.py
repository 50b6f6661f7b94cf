"""The port's ``device_groupby_partials`` + ``merge_partials``
(``fugue_tpu_torch/ops/segment.py``) against the JAX package's on the
8-device CPU mesh. The port runs one shard, the JAX package eight, so the
partials differ and the results are compared after the merge, sorted by
key. Both get the same padded device state (the JAX frame's arrays and
valid mask, carried over as numpy).

Exact: keys (NaN where NaN), counts, MIN/MAX, NULL placement, dtypes of
keys and counts. Sums of float32: ``rtol=1e-5, atol=1e-3`` (the port
accumulates them in float64, the JAX package in float32 per shard); sums
of float64: ``rtol=1e-9``.
"""

import zlib

import numpy as np
import pandas as pd
import pytest
import torch

from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu.ops import segment as jseg
from fugue_tpu_torch.ops import segment as tseg

SPECS = [
    ("s32", "sum", "v32", True), ("n32", "count", "v32", True), ("lo32", "min", "v32", True),
    ("hi32", "max", "v32", True), ("s64", "sum", "v64", True), ("hi64", "max", "v64", True),
    ("si", "sum", "i", False), ("loi", "min", "i", False), ("hii", "max", "i", False),
    ("sl", "sum", "l", False), ("nl", "count", "l", False),
]
F32_SUMS, F64_SUMS = {"s32"}, {"s64"}


@pytest.fixture(scope="module")
def jax_engine():
    return JaxExecutionEngine()


def _values(rng, n):
    v32 = (rng.random(n) * 100 - 30).astype(np.float32)
    v32[rng.random(n) < 0.1] = np.nan
    v64 = rng.standard_normal(n) * 1e6
    v64[rng.random(n) < 0.05] = np.nan
    return {
        "v32": v32,
        "v64": v64,
        "i": rng.integers(-1000, 1000, n).astype(np.int32),
        "l": rng.integers(-(1 << 40), 1 << 40, n),
    }


def _keys(case, rng, n):
    if case == "two_keys":
        return {"a": rng.integers(0, 7, n).astype(np.int32), "b": rng.integers(-3, 3, n)}
    if case == "three_keys":
        return {"a": rng.integers(0, 3, n).astype(np.int8), "b": rng.random(n) < 0.5,
                "c": rng.integers(0, 1 << 40, n) % 5 * (1 << 38)}
    if case == "nan_float_keys":
        k = rng.integers(0, 6, n).astype(np.float64) / 4
        k[rng.random(n) < 0.2] = np.nan
        return {"f": k}
    if case == "signed_zero_keys":
        k = rng.integers(-2, 3, n).astype(np.float32)
        k[k == 0] = np.where(rng.random(int((k == 0).sum())) < 0.5, -0.0, 0.0)
        return {"f": k}
    if case == "bool_key":
        return {"b": rng.random(n) < 0.3}
    if case == "wide_int64":
        return {"k": rng.integers(-(1 << 62), 1 << 62, 40)[rng.integers(0, 40, n)]}
    if case == "wide_int32_many_groups":
        return {"k": rng.integers(0, 1 << 30, n).astype(np.int32)}
    if case == "mask_key":
        k = rng.integers(0, 4, n)
        m = rng.random(n) < 0.25
        return {"k": np.where(m, 0, k), "__null__k": m}
    if case == "small_int_range":  # the dense route, for contrast
        return {"k": rng.integers(-5, 20, n)}
    raise KeyError(case)  # pragma: no cover


CASES = ["two_keys", "three_keys", "nan_float_keys", "signed_zero_keys", "bool_key",
         "wide_int64", "wide_int32_many_groups", "mask_key", "small_int_range"]


def _both(jax_engine, pdf, key_names, valid=None):
    """Partials of the JAX package (8 shards) and of the port (the same
    padded arrays on one shard), each merged."""
    jdf = jax_engine.to_df(pdf)
    jvalid = jdf.device_valid_mask()
    if valid is not None:
        jvalid = jvalid & jax_engine_device_put(jdf, valid)
    jkeys = {k: jdf.device_cols[k] for k in key_names}
    jaggs = [(n, a, jdf.device_cols[c], nl) for n, a, c, nl in SPECS]
    jparts = jseg.device_groupby_partials(jdf.mesh, jkeys, jaggs, jvalid)
    tcols = {c: torch.from_numpy(np.array(jdf.device_cols[c])) for c in pdf.columns}
    tvalid = torch.from_numpy(np.array(jvalid))
    tkeys = {k: tcols[k] for k in key_names}
    taggs = [(n, a, tcols[c], nl) for n, a, c, nl in SPECS]
    tparts = tseg.device_groupby_partials(tkeys, taggs, tvalid)
    specs = [(n, a) for n, a, _, _ in SPECS]
    return (jseg.merge_partials(jparts, key_names, specs),
            tseg.merge_partials(tparts, key_names, specs), tparts)


def jax_engine_device_put(jdf, valid):
    import jax

    from fugue_tpu.parallel.mesh import row_sharding

    padded = np.zeros(jdf.device_valid_mask().shape[0], dtype=bool)
    padded[: len(valid)] = valid
    return jax.device_put(padded, row_sharding(jdf.mesh))


def _sorted(df, keys):
    return df.sort_values(keys, na_position="last", kind="stable").reset_index(drop=True)


def _assert_same(got, exp, keys):
    assert list(got.columns) == list(exp.columns)
    got, exp = _sorted(got, keys), _sorted(exp, keys)
    assert len(got) == len(exp)
    for c in got.columns:
        g, e = got[c].to_numpy(), exp[c].to_numpy()
        if c in F32_SUMS:
            assert np.allclose(g, e, rtol=1e-5, atol=1e-3, equal_nan=True), c
        elif c in F64_SUMS:
            assert np.allclose(g, e, rtol=1e-9, atol=0, equal_nan=True), c
        else:
            assert g.dtype == e.dtype, c
            assert np.array_equal(g, e, equal_nan=g.dtype.kind == "f"), c


@pytest.mark.parametrize("case", CASES)
def test_partials_merge_to_the_jax_result(jax_engine, case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    n = 4_003
    keys = _keys(case, rng, n)
    pdf = pd.DataFrame({**keys, **_values(rng, n)})
    exp, got, parts = _both(jax_engine, pdf, list(keys))
    _assert_same(got, exp, list(keys))
    if case == "nan_float_keys":
        assert got["f"].isna().sum() == 1  # every NaN key merges into one group
    if case == "wide_int32_many_groups":
        assert len(got) > 3_900 and len(parts) == len(got)  # one shard: one partial a group


def test_signed_zero_keys_form_one_group(jax_engine):
    # -0.0 and 0.0 are one key. The group's key is its first row's: here
    # -0.0 in both packages, as the first row of the group holds -0.0 and
    # lies in the JAX package's first shard
    f = np.array([-0.0, 1.0, 0.0, 0.0, -0.0, 1.0, 0.0, 2.0, -0.0], dtype=np.float32)
    pdf = pd.DataFrame({"f": f, **_values(np.random.default_rng(3), len(f))})
    exp, got, _ = _both(jax_engine, pdf, ["f"])
    _assert_same(got, exp, ["f"])
    zero, jzero = got[got["f"] == 0], exp[exp["f"] == 0]
    assert len(zero) == 1 and len(jzero) == 1
    assert np.signbit(zero["f"].iloc[0]) and np.signbit(jzero["f"].iloc[0])


def test_all_rows_invalid(jax_engine):
    rng = np.random.default_rng(11)
    n = 203
    pdf = pd.DataFrame({"a": rng.integers(0, 5, n), "b": rng.random(n), **_values(rng, n)})
    exp, got, parts = _both(jax_engine, pdf, ["a", "b"], valid=np.zeros(n, dtype=bool))
    assert len(parts) == 0 and len(got) == 0 and len(exp) == 0
    assert list(got.columns) == list(exp.columns)


def test_empty_input():
    # zero-length tensors: no rows, no groups, the partial columns named
    tkeys = {"a": torch.zeros(0, dtype=torch.int64), "b": torch.zeros(0)}
    taggs = [(n, a, torch.zeros(0, dtype=torch.float32), True) for n, a, _, _ in SPECS[:4]]
    parts = tseg.device_groupby_partials(tkeys, taggs, torch.zeros(0, dtype=torch.bool))
    assert len(parts) == 0 and list(parts.columns) == ["a", "b", "s32", "n32", "lo32", "hi32"]
    merged = tseg.merge_partials(parts, ["a", "b"], [(n, a) for n, a, _, _ in SPECS[:4]])
    assert len(merged) == 0


def test_single_int_key_without_a_range_hint_probes_it():
    # the dense route needs the key's range: without a hint, one probe
    k = torch.tensor([5, 7, 5, 6])
    v = torch.tensor([1.0, 2.0, 3.0, 4.0])
    parts = tseg.device_groupby_partials({"k": k}, [("s", "sum", v, False)], torch.ones(4, dtype=torch.bool))
    assert parts.to_dict("list") == {"k": [5, 6, 7], "s": [4.0, 4.0, 2.0]}
    parts = tseg.device_groupby_partials(
        {"k": k}, [("s", "sum", v, False)], torch.ones(4, dtype=torch.bool), range_hint=(5, 7)
    )
    assert parts["k"].tolist() == [5, 6, 7]


def test_partials_too_large():
    k = torch.arange(10) * (1 << 20)
    with pytest.raises(tseg.PartialsTooLarge):
        tseg.device_groupby_partials(
            {"k": k}, [("n", "count", k, False)], torch.ones(10, dtype=torch.bool), max_partial_rows=9
        )


def test_float32_sum_of_one_shard_stalls_in_the_reference_not_in_the_port():
    # fault C2 (ROADMAP.md C): the JAX package's _shard_kernel sums a
    # float32 column into a float32 running total, which stops moving once
    # it is 2**24 times the addend. One group, one shard: 2**24 then 2**20
    # ones. The reference loses every one; the port sums in float64.
    import jax
    import jax.numpy as jnp

    n = (1 << 20) + 1
    v = np.ones(n, dtype=np.float32)
    v[0] = 2.0**24
    exact = float(v.astype(np.float64).sum())
    kernel = jseg._shard_kernel(1, (("s", "sum", 0, False),))
    jout = jax.jit(kernel)(jnp.zeros(n, jnp.int32), jnp.asarray(v), jnp.ones(n, bool))
    assert int(jout[0][0]) == 1 and float(jout[2][0]) == 2.0**24 != exact
    tout = tseg._shard_kernel(1, (("s", "sum", 0, False),))(
        torch.zeros(n, dtype=torch.int32), torch.from_numpy(v), torch.ones(n, dtype=torch.bool)
    )
    assert tout[0] == 1 and tout[2].dtype == torch.float64 and tout[2].tolist() == [exact]


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_partials_equal_on_identical_partials(seed):
    rng = np.random.default_rng(seed)
    n = 500
    parts = pd.DataFrame({
        "a": rng.integers(0, 5, n), "b": rng.choice([0.5, np.nan, 2.0], n),
        "s": np.where(rng.random(n) < 0.1, np.nan, rng.random(n)),
        "c": rng.integers(0, 9, n), "lo": rng.random(n), "hi": rng.integers(0, 99, n),
    })
    specs = [("s", "sum"), ("c", "count"), ("lo", "min"), ("hi", "max")]
    exp = jseg.merge_partials(parts.copy(), ["a", "b"], specs)
    got = tseg.merge_partials(parts.copy(), ["a", "b"], specs)
    pd.testing.assert_frame_equal(got, exp)
