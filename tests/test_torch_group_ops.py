"""``fugue_tpu_torch.torch.group_ops`` against ``fugue_tpu.jax.group_ops``.

Both get the same numpy-seeded columns and reserved keys, under each
plan's markers:

- sorted plan: contiguous segment ids, invalid rows at the tail each in a
  segment of its own, tables as long as the frame (most slots empty); the
  JAX helpers run as they are;
- dense plan: segment ids scattered over a 16-slot space (some slots
  empty), invalid rows in the top slot; the JAX helpers run inside a
  ``shard_map`` over the 8-device CPU mesh, merging their tables across
  shards, and the port's on one device.

Exact: integer results (int64 sums near 2^62 included), MIN/MAX, counts,
NaN placement and the identities of empty segments. float64 sums and
means: ``rtol=1e-12``, float32 sums ``rtol=1e-5``, the order of the adds
being free.
"""

from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fugue_tpu._utils.jax_compat import shard_map
from fugue_tpu.exceptions import FugueInvalidOperation as JFugueInvalidOperation
from fugue_tpu.jax import group_ops as jgo
from fugue_tpu.parallel.mesh import ROW_AXIS, build_mesh
from fugue_tpu_torch.exceptions import FugueInvalidOperation
from fugue_tpu_torch.torch import group_ops as tgo

N, N_VALID, SPACE = 64, 56, 16


def _columns(plan: str) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(17)
    valid = np.arange(N) < N_VALID
    if plan == "sorted":
        seg = np.sort(rng.integers(0, 12, N_VALID))
        seg = np.unique(seg, return_inverse=True)[1]  # contiguous 0..g-1
        seg = np.concatenate([seg, seg.max() + 1 + np.arange(N - N_VALID)])
    else:
        seg = np.where(valid, rng.integers(0, 12, N), SPACE - 1)
    v = rng.random(N)
    v[[0, 5, 30]] = np.nan  # the first row of segment 0 is NULL
    v[N_VALID + 1] = np.nan  # a NaN in an invalid row changes nothing
    return {
        "__segments__": seg.astype(np.int32),
        "__valid__": valid,
        "v": v,
        "f": rng.random(N, dtype=np.float32),
        "i": rng.integers(2**58, 2**59, N, dtype=np.int64),
        "s": rng.integers(-100, 100, N, dtype=np.int32),
    }


# name -> (fn(go, cols, int64 dtype), output kind, float rtol)
CASES: Dict[str, Any] = {
    "segment_sum_f64": (lambda go, c, i64: go.segment_sum(c, c["v"]), "table", 1e-12),
    "segment_sum_f32": (lambda go, c, i64: go.segment_sum(c, c["f"]), "table", 1e-5),
    "segment_sum_i64_near_2_62": (lambda go, c, i64: go.segment_sum(c, c["i"]), "table", 0),
    "segment_sum_i32": (lambda go, c, i64: go.segment_sum(c, c["s"]), "table", 0),
    "segment_count": (lambda go, c, i64: go.segment_count(c), "table", 0),
    "segment_count_i64": (lambda go, c, i64: go.segment_count(c, dtype=i64), "table", 0),
    "segment_min_nan": (lambda go, c, i64: go.segment_min(c, c["v"]), "table", 0),
    "segment_max_nan": (lambda go, c, i64: go.segment_max(c, c["v"]), "table", 0),
    "segment_min_i64": (lambda go, c, i64: go.segment_min(c, c["i"]), "table", 0),
    "segment_max_i32": (lambda go, c, i64: go.segment_max(c, c["s"]), "table", 0),
    "mean": (lambda go, c, i64: go.mean(c, c["f"]), "table", 1e-5),
    "per_row_of_mean": (lambda go, c, i64: go.per_row(c, go.mean(c, c["v"])), "rows", 1e-12),
    "per_row_of_max": (lambda go, c, i64: go.per_row(c, go.segment_max(c, c["s"])), "rows", 0),
}
ORDERED: Dict[str, Any] = {
    "running_sum_f64": (lambda go, c, i64: go.running_sum(c, c["v"]), 1e-12),
    "running_sum_f32": (lambda go, c, i64: go.running_sum(c, c["f"]), 1e-6),
    "running_sum_i64": (lambda go, c, i64: go.running_sum(c, c["i"]), 0),
    "row_number": (lambda go, c, i64: go.row_number(c), 0),
    "row_number_i32": (lambda go, c, i64: go.row_number(c, dtype=c["s"].dtype), 0),
    "running_min_nan": (lambda go, c, i64: go.running_min(c, c["v"]), 0),
    "running_max_nan": (lambda go, c, i64: go.running_max(c, c["v"]), 0),
    "running_min_i32": (lambda go, c, i64: go.running_min(c, c["s"]), 0),
    "running_max_i64": (lambda go, c, i64: go.running_max(c, c["i"]), 0),
    "lag": (lambda go, c, i64: go.lag(c, c["v"]), 0),
    "lag_2": (lambda go, c, i64: go.lag(c, c["v"], 2), 0),
    "lead": (lambda go, c, i64: go.lead(c, c["f"]), 0),
    "lead_3_fill": (lambda go, c, i64: go.lead(c, c["v"], 3, fill=-1.5), 0),
    "lag_int_fill": (lambda go, c, i64: go.lag(c, c["s"], fill=-1), 0),
    "lead_int_fill": (lambda go, c, i64: go.lead(c, c["i"], 2, fill=7), 0),
}


def _run_torch(fn: Callable, cols: Dict[str, np.ndarray], plan: str) -> np.ndarray:
    c = {k: torch.from_numpy(a.copy()) for k, a in cols.items()}
    if plan == "dense":
        c[tgo.SEGMENT_SPACE] = torch.zeros(SPACE, dtype=torch.bool)
        c[tgo.SPANS_SHARDS] = c[tgo.SEGMENT_SPACE][:1]
    return fn(tgo, c, torch.int64).numpy()


def _run_jax(
    fn: Callable, cols: Dict[str, np.ndarray], plan: str, kind: str, shards: int = 8
) -> np.ndarray:
    c = {k: jnp.asarray(a) for k, a in cols.items()}
    if plan == "sorted":
        return np.asarray(fn(jgo, c, jnp.int64))

    def body(sc: Dict[str, Any], sp: Any) -> Any:
        sc = dict(sc)
        sc[jgo.SEGMENT_SPACE] = sp
        sc[jgo.SPANS_SHARDS] = sp[:1]
        return fn(jgo, sc, jnp.int64)

    mapped = shard_map(
        body,
        mesh=build_mesh(devices=jax.devices()[:shards]),
        in_specs=(P(ROW_AXIS), P()),
        out_specs=P() if kind == "table" else P(ROW_AXIS),
    )
    return np.asarray(jax.jit(mapped)(c, jnp.zeros((SPACE,), dtype=bool)))


def _assert_same(got: np.ndarray, exp: np.ndarray, rtol: float) -> None:
    assert got.shape == exp.shape
    assert got.dtype == exp.dtype, (got.dtype, exp.dtype)
    if rtol == 0:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=rtol, atol=0, equal_nan=True)
        assert (np.isnan(got) == np.isnan(exp)).all()


@pytest.mark.parametrize("plan", ["sorted", "dense"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_reductions_match_the_jax_package(name, plan):
    fn, kind, rtol = CASES[name]
    cols = _columns(plan)
    # a NaN in a MIN/MAX: the reference's cross-shard merge drops it
    # (ROADMAP.md C5), so the dense plan is held against one shard
    shards = 1 if name.endswith("_nan") and plan == "dense" else 8
    _assert_same(_run_torch(fn, cols, plan), _run_jax(fn, cols, plan, kind, shards), rtol)


@pytest.mark.parametrize("kind", ["min", "max"])
def test_nan_min_max_across_shards_of_the_reference_depends_on_the_layout(kind):
    """Fault C5 of the reference: under the dense plan a group's NaN row
    makes its MIN/MAX NaN on one shard (as ``jax.ops.segment_min`` and
    the sorted plan give), but the merge across the 8-device mesh takes
    the other shards' value. The port has one device and keeps the NaN."""
    fn = CASES[f"segment_{kind}_nan"][0]
    cols = _columns("dense")
    one = _run_jax(fn, cols, "dense", "table", shards=1)
    eight = _run_jax(fn, cols, "dense", "table", shards=8)
    nan_groups = np.unique(cols["__segments__"][np.isnan(cols["v"]) & cols["__valid__"]])
    assert np.isnan(one[nan_groups]).all()
    assert not np.isnan(eight[nan_groups]).all()
    got = _run_torch(fn, cols, "dense")
    np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("name", sorted(ORDERED))
def test_ordered_helpers_match_the_jax_package_on_the_sorted_plan(name):
    fn, rtol = ORDERED[name]
    cols = _columns("sorted")
    _assert_same(_run_torch(fn, cols, "sorted"), _run_jax(fn, cols, "sorted", "rows"), rtol)


@pytest.mark.parametrize("name", sorted(ORDERED))
def test_ordered_helpers_raise_under_the_dense_plan(name):
    fn, _ = ORDERED[name]
    cols = _columns("dense")
    with pytest.raises(FugueInvalidOperation, match="sorted plan"):
        _run_torch(fn, cols, "dense")
    jc = {k: jnp.asarray(a) for k, a in cols.items()}
    jc[jgo.SEGMENT_SPACE] = jnp.zeros((SPACE,), dtype=bool)
    jc[jgo.SPANS_SHARDS] = jc[jgo.SEGMENT_SPACE][:1]
    with pytest.raises(JFugueInvalidOperation, match="sorted plan"):
        fn(jgo, jc, jnp.int64)


@pytest.mark.parametrize(
    "call",
    [
        lambda go, c: go.lag(c, c["s"]),  # a non-float column needs a fill
        lambda go, c: go.lead(c, c["v"], 0),
        lambda go, c: go.lag(c, c["v"], 1.5),
    ],
    ids=["int_without_fill", "offset_0", "offset_float"],
)
def test_bad_shift_arguments_raise_in_both(call):
    cols = _columns("sorted")
    with pytest.raises(FugueInvalidOperation):
        call(tgo, {k: torch.from_numpy(a.copy()) for k, a in cols.items()})
    with pytest.raises(JFugueInvalidOperation):
        call(jgo, {k: jnp.asarray(a) for k, a in cols.items()})


def test_empty_segments_hold_the_identities():
    cols = {k: torch.from_numpy(a.copy()) for k, a in _columns("sorted").items()}
    last = int(cols["__segments__"][-1])
    assert tgo.num_segments(cols) == N
    assert torch.isinf(tgo.segment_min(cols, cols["v"])[last + 1 :]).all()
    assert (tgo.segment_max(cols, cols["s"])[last + 1 :] == torch.iinfo(torch.int32).min).all()
    assert (tgo.segment_sum(cols, cols["i"])[last + 1 :] == 0).all()


def test_merge_refuses_a_process_group_of_several_ranks(monkeypatch):
    cols = {k: torch.from_numpy(a.copy()) for k, a in _columns("dense").items()}
    cols[tgo.SEGMENT_SPACE] = torch.zeros(SPACE, dtype=torch.bool)
    cols[tgo.SPANS_SHARDS] = cols[tgo.SEGMENT_SPACE][:1]
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="A.7"):
        tgo.segment_sum(cols, cols["v"])
    del cols[tgo.SPANS_SHARDS]  # the sorted plan merges nothing
    assert tgo.segment_sum(cols, cols["v"]).shape == (SPACE,)
