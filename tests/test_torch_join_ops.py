"""The port's join ops (``fugue_tpu_torch/ops/join.py``, ``ops/shuffle.py``)
against the JAX package's (``fugue_tpu/ops/join.py``, ``ops/shuffle.py``)
on the same numpy inputs, made from a seed.

The JAX package's ops run on a one-device mesh where they are
``shard_map`` programs. Exact: the row hash bit for bit (the port's int64
bits viewed as ``uint64``), the right prep's sorted hashes, order, valid
count and duplicate flag, the probe's valid mask, gathers and match flags,
and the expansion's counts and offsets. The expansion's output is compared
as a set of valid rows: the JAX package allocates a power-of-two number of
slots, the port exactly the slot total.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu.jax  # noqa: F401  (enables 64-bit types in JAX)
from fugue_tpu.ops import join as rj
from fugue_tpu.ops.shuffle import _hash_cols as ref_hash_cols
from fugue_tpu.parallel.mesh import build_mesh
from fugue_tpu_torch.ops import join as tj
from fugue_tpu_torch.ops.shuffle import _hash_cols, bitcast_u64, unsigned_order

INT_DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint8)
DTYPES = INT_DTYPES + (np.float32, np.float64, np.bool_)


@pytest.fixture(scope="module")
def mesh1():
    return build_mesh(devices=jax.devices()[:1])


def _column(rng, dtype, n: int) -> np.ndarray:
    """``n`` values of ``dtype`` with the edge cases first: the extremes of
    an integer type; -0.0, 0.0, NaN and the infinities of a float type."""
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(n) < 0.5
    if dt.kind == "f":
        edge = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 1.5, -1.5], dtype=dt)
        body = (rng.standard_normal(n) * 1e3).astype(dt)
    else:
        ii = np.iinfo(dt)
        edge = np.array([ii.min, ii.max, 0, 1, ii.max - 1], dtype=dt)
        body = rng.integers(ii.min, ii.max, n, dtype=dt, endpoint=True)
    body[: len(edge)] = edge
    return body


def _as_u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_hash_of_one_column_matches_bit_for_bit(dtype):
    c = _column(np.random.default_rng(0), dtype, 4096)
    exp = np.asarray(ref_hash_cols(jnp, [jnp.asarray(c)]))
    assert exp.dtype == np.uint64
    np.testing.assert_array_equal(_as_u64(_hash_cols([torch.from_numpy(c)])), exp)


@pytest.mark.parametrize("n_keys", [1, 2, 3])
@pytest.mark.parametrize("seed", [1, 2])
def test_hash_of_several_columns_matches_bit_for_bit(n_keys, seed):
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(DTYPES), n_keys, replace=False)
    cols = [_column(rng, DTYPES[i], 2048) for i in picks]
    exp = np.asarray(ref_hash_cols(jnp, [jnp.asarray(c) for c in cols]))
    np.testing.assert_array_equal(_as_u64(_hash_cols([torch.from_numpy(c) for c in cols])), exp)


def test_minus_zero_hashes_as_zero_and_floats_widen():
    z = _hash_cols([torch.tensor([-0.0, 0.0])])
    assert z[0] == z[1]
    f32 = torch.tensor([1.5, -2.25], dtype=torch.float32)
    assert torch.equal(bitcast_u64(f32), f32.to(torch.float64).view(torch.int64))
    assert torch.equal(_hash_cols([f32]), _hash_cols([f32.to(torch.float64)]))


def test_unsigned_order_sorts_as_uint64():
    rng = np.random.default_rng(3)
    u = rng.integers(0, np.iinfo(np.uint64).max, 1000, dtype=np.uint64, endpoint=True)
    u[:3] = [0, np.iinfo(np.uint64).max, 1 << 63]
    img = unsigned_order(torch.from_numpy(u.view(np.int64)))
    np.testing.assert_array_equal(_as_u64(unsigned_order(torch.sort(img).values)), np.sort(u))
    assert torch.equal(unsigned_order(img), torch.from_numpy(u.view(np.int64)))


def _right_side(rng, n: int, dup: bool, dtypes=(np.int64,)):
    """Right keys (unique unless ``dup``), with a tenth of the rows invalid
    and, in float keys, a NaN."""
    keys = []
    for dt in dtypes:
        if np.dtype(dt).kind == "f":
            k = rng.permutation(n).astype(dt) / 4
            k[rng.integers(0, n)] = np.nan
        else:
            k = rng.permutation(n).astype(dt) * 3
        if dup:
            k[n // 2 :] = k[: n - n // 2]
        keys.append(k)
    valid = rng.random(n) > 0.1
    return keys, valid


def _ref_prep(keys, valid):
    prep = rj._get_compiled_right_prep(None, len(keys), tuple(str(k.dtype) for k in keys), local=False)
    return prep(jnp.asarray(valid), *[jnp.asarray(k) for k in keys])


@pytest.mark.parametrize("dup", [False, True], ids=["unique", "duplicated"])
@pytest.mark.parametrize(
    "dtypes", [(np.int64,), (np.float64,), (np.int32, np.float32), (np.int8, np.bool_, np.int64)],
    ids=lambda d: "-".join(np.dtype(x).name for x in d),
)
def test_right_prep_matches(dup, dtypes):
    rng = np.random.default_rng(4)
    keys, valid = _right_side(rng, 300, dup, dtypes)
    s_h, order, nv, dflag = _ref_prep(keys, valid)
    ps, po, pn, pdup = tj.right_prep(torch.from_numpy(valid), [torch.from_numpy(k) for k in keys])
    np.testing.assert_array_equal(_as_u64(unsigned_order(ps)), np.asarray(s_h))
    np.testing.assert_array_equal(po.numpy(), np.asarray(order))
    assert int(pn) == int(np.asarray(nv)[0])
    assert bool(pdup) == bool(np.asarray(dflag)[0])
    assert bool(pdup) == dup


def _left_side(rng, n: int, rkeys):
    """Left keys: right rows' keys, the first key moved off the right's
    grid in about half the rows (a miss), NaN in 5% of a float key; a
    tenth of the rows invalid."""
    idx = rng.integers(0, len(rkeys[0]), n)
    off = rng.random(n) < 0.5
    keys = []
    for i, rk in enumerate(rkeys):
        k = rk[idx].copy()
        if i == 0:
            k[off] = (k[off] + (1 if k.dtype.kind != "f" else 0.125)).astype(k.dtype)
        if k.dtype.kind == "f":
            k[rng.random(n) < 0.05] = np.nan
        keys.append(k)
    return keys, rng.random(n) > 0.1


FILLS = {"f": math.nan, "code": -1, "mask": True, "int": 0}


def _values(rng, n: int):
    """One right value array per representation, with its left_outer fill."""
    return [
        (rng.random(n), FILLS["f"]),
        (rng.integers(-1, 5, n).astype(np.int32), FILLS["code"]),
        (rng.random(n) < 0.3, FILLS["mask"]),
        (rng.integers(-(10**12), 10**12, n), FILLS["int"]),
    ]


@pytest.mark.parametrize("how", ["inner", "left_outer", "semi", "anti"])
@pytest.mark.parametrize("dtypes", [(np.int64,), (np.float64,), (np.int32, np.float32)],
                         ids=lambda d: "-".join(np.dtype(x).name for x in d))
def test_probe_body_matches(how, dtypes):
    rng = np.random.default_rng(5)
    rkeys, rvalid = _right_side(rng, 200, False, dtypes)
    lkeys, lvalid = _left_side(rng, 1000, rkeys)
    vals = _values(rng, 200)
    fills = tuple(f for _, f in vals) if how == "left_outer" else ()
    s_h, order, nv, dup = _ref_prep(rkeys, rvalid)
    assert not bool(np.asarray(dup)[0])
    exp = rj._probe_body(
        jnp, how, tuple(jnp.asarray(k) for k in lkeys), jnp.asarray(lvalid), s_h, order,
        nv[0], tuple(jnp.asarray(k) for k in rkeys), tuple(jnp.asarray(v) for v, _ in vals), fills,
    )
    ps, po, pn, _ = tj.right_prep(torch.from_numpy(rvalid), [torch.from_numpy(k) for k in rkeys])
    got = tj._probe_body(
        how, tuple(torch.from_numpy(k) for k in lkeys), torch.from_numpy(lvalid), ps, po, pn,
        tuple(torch.from_numpy(k) for k in rkeys), tuple(torch.from_numpy(v) for v, _ in vals),
        fills,
    )
    assert len(got) == len(exp)
    valid = np.asarray(exp[0])
    np.testing.assert_array_equal(got[0].numpy(), valid)
    assert 0 < valid.sum() < lvalid.sum() or how == "left_outer"
    # gathers on the rows the frame keeps; the match flags on every row
    for g, e in zip(got[1:], exp[1:]):
        np.testing.assert_array_equal(g.numpy()[valid], np.asarray(e)[valid])
    if how == "left_outer":
        np.testing.assert_array_equal(got[-1].numpy(), np.asarray(exp[-1]))


def _valid_rows(cols: dict, valid: np.ndarray, names):
    """The valid rows of ``cols`` as a sorted list of tuples (NaN as a
    string, so it sorts and compares)."""
    arrs = [np.asarray(cols[n])[valid] for n in names]
    rows = [tuple("nan" if isinstance(x, float) and math.isnan(x) else x for x in r)
            for r in zip(*(a.tolist() for a in arrs))]
    return sorted(rows, key=repr)


@pytest.mark.parametrize("how", ["inner", "left_outer", "semi", "anti"])
@pytest.mark.parametrize("dtypes", [(np.int64,), (np.float64,), (np.int32, np.float32)],
                         ids=lambda d: "-".join(np.dtype(x).name for x in d))
def test_expansion_matches(mesh1, how, dtypes):
    rng = np.random.default_rng(6)
    rkeys, rvalid = _right_side(rng, 120, True, dtypes)
    lkeys, lvalid = _left_side(rng, 400, rkeys)
    vals = _values(rng, 120)
    kn = [f"__k{i}" for i in range(len(dtypes))]
    lpay = {"a": rng.random(400), "b": rng.integers(0, 9, 400)}
    right_values = [(f"v{i}", v, f) for i, (v, f) in enumerate(vals)]
    ref_left = {**{n: jnp.asarray(k) for n, k in zip(kn, lkeys)},
                **{n: jnp.asarray(a) for n, a in lpay.items()}}
    exp_cols, exp_valid, exp_match = rj.device_expand_join(
        mesh1, how, ref_left, jnp.asarray(lvalid), kn, [jnp.asarray(k) for k in rkeys],
        jnp.asarray(rvalid), [(n, jnp.asarray(v), f) for n, v, f in right_values],
    )
    port_left = {**{n: torch.from_numpy(k) for n, k in zip(kn, lkeys)},
                 **{n: torch.from_numpy(a) for n, a in lpay.items()}}
    got_cols, got_valid, got_match = tj.device_expand_join(
        how, port_left, torch.from_numpy(lvalid), kn, [torch.from_numpy(k) for k in rkeys],
        torch.from_numpy(rvalid), [(n, torch.from_numpy(v), f) for n, v, f in right_values],
    )
    assert sorted(got_cols) == sorted(exp_cols)
    ev, gv = np.asarray(exp_valid), got_valid.numpy()
    if how in ("semi", "anti"):
        np.testing.assert_array_equal(gv, ev)  # left rows in place
        assert got_match is None and exp_match is None
        return
    names = sorted(got_cols)
    # the port's slots are exactly the slot total; the JAX package's a power of two above it
    assert gv.shape[0] <= ev.shape[0] < 2 * max(gv.shape[0], 1)
    exp_rows = _valid_rows({**exp_cols, "__m": exp_match} if how == "left_outer" else exp_cols,
                           ev, names + (["__m"] if how == "left_outer" else []))
    got_rows = _valid_rows({**got_cols, "__m": got_match} if how == "left_outer" else got_cols,
                           gv, names + (["__m"] if how == "left_outer" else []))
    assert len(exp_rows) > 0
    assert got_rows == exp_rows


@pytest.mark.parametrize("miss_slot", [False, True])
def test_expansion_counts_and_offsets_match(mesh1, miss_slot):
    rng = np.random.default_rng(7)
    rkeys, rvalid = _right_side(rng, 150, True, (np.int64,))
    lkeys, lvalid = _left_side(rng, 500, rkeys)
    s_h, order, nv, _ = rj._get_compiled_right_prep(mesh1, 1, ("int64",), local=False)(
        jnp.asarray(rvalid), jnp.asarray(rkeys[0]))
    counter = rj._get_compiled_expand_count(mesh1, 1, ("int64",), local=False, miss_slot=miss_slot)
    cand, lo, off, total = counter(jnp.asarray(lvalid), s_h, nv, jnp.asarray(lkeys[0]))
    ps, po, pn, _ = tj.right_prep(torch.from_numpy(rvalid), [torch.from_numpy(rkeys[0])])
    gc, gl, go, gs = tj.expand_count(torch.from_numpy(lvalid), ps, pn,
                                     [torch.from_numpy(lkeys[0])], miss_slot)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(cand))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(go.numpy(), np.asarray(off))
    assert int(gs.sum()) == int(np.asarray(total)[0])
    assert int(gc.sum()) > 0


def test_expansion_past_the_budget_declines_in_both(mesh1, monkeypatch):
    """Past ``MAX_EXPAND_ROWS`` slots both return None (the JAX package then
    joins on its host engine; the port's engine raises)."""
    monkeypatch.setattr(rj, "MAX_EXPAND_ROWS", 15)
    monkeypatch.setattr(tj, "MAX_EXPAND_ROWS", 15)
    lk, rk = np.zeros(4, np.int64), np.zeros(4, np.int64)
    ones = np.ones(4, bool)
    assert rj.device_expand_join(mesh1, "inner", {"k": jnp.asarray(lk)}, jnp.asarray(ones), ["k"],
                                 [jnp.asarray(rk)], jnp.asarray(ones), []) is None
    assert tj.device_expand_join("inner", {"k": torch.from_numpy(lk)}, torch.from_numpy(ones),
                                 ["k"], [torch.from_numpy(rk)], torch.from_numpy(ones), []) is None
    monkeypatch.setattr(tj, "MAX_EXPAND_ROWS", 16)
    assert tj.device_expand_join("inner", {"k": torch.from_numpy(lk)}, torch.from_numpy(ones),
                                 ["k"], [torch.from_numpy(rk)], torch.from_numpy(ones), []) is not None


def test_hash_join_duplicates_decline_and_unique_probe_matches(mesh1):
    rng = np.random.default_rng(8)
    rkeys, rvalid = _right_side(rng, 64, True, (np.int64,))
    lkeys, lvalid = _left_side(rng, 256, rkeys)
    args = ({"k": torch.from_numpy(lkeys[0])}, torch.from_numpy(lvalid), ["k"],
            [torch.from_numpy(rkeys[0])], torch.from_numpy(rvalid), [])
    assert tj.device_hash_join("inner", *args) is None
    rkeys, rvalid = _right_side(rng, 64, False, (np.int64,))
    w = rng.random(64)
    exp = rj.device_broadcast_inner_join(
        mesh1, {"k": jnp.asarray(lkeys[0])}, jnp.asarray(lvalid), "k",
        {"k": jnp.asarray(rkeys[0]), "w": jnp.asarray(w)}, jnp.asarray(rvalid))
    got = tj.device_broadcast_inner_join(
        {"k": torch.from_numpy(lkeys[0])}, torch.from_numpy(lvalid), "k",
        {"k": torch.from_numpy(rkeys[0]), "w": torch.from_numpy(w)}, torch.from_numpy(rvalid))
    valid = np.asarray(exp[1])
    np.testing.assert_array_equal(got[1].numpy(), valid)
    np.testing.assert_array_equal(got[0]["w"].numpy()[valid], np.asarray(exp[0]["w"])[valid])


def test_empty_sides():
    """The port's frames are not padded: an empty right side is one
    invalid row, an empty left side gives empty outputs."""
    e = torch.zeros(0, dtype=torch.int64)
    k = torch.tensor([1, 2, 3])
    v3 = torch.ones(3, dtype=torch.bool)
    cols, valid, match = tj.device_hash_join(
        "left_outer", {"k": k}, v3, ["k"], [e], torch.zeros(0, dtype=torch.bool),
        [("w", torch.zeros(0), math.nan)])
    assert valid.tolist() == [True] * 3 and match.tolist() == [False] * 3
    assert torch.isnan(cols["w"]).all()
    cols, valid, _ = tj.device_expand_join(
        "inner", {"k": e}, torch.zeros(0, dtype=torch.bool), ["k"], [k], v3, [("w", k, 0)])
    assert valid.shape == (0,) and cols["w"].shape == (0,)


def test_only_the_broadcast_strategy_is_ported():
    k = torch.tensor([1])
    v = torch.ones(1, dtype=torch.bool)
    for fn in (tj.device_hash_join, tj.device_expand_join):
        with pytest.raises(NotImplementedError, match="A.7"):
            fn("inner", {"k": k}, v, ["k"], [k], v, [], strategy="shuffle")
