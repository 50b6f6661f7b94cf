"""``TorchExecutionEngine(device="cpu")``'s ``distinct``, ``union``,
``subtract``, ``intersect``, ``sample`` and ``take``, and
``fugue_tpu_torch.api``'s, against ``JaxExecutionEngine`` (the 8-device
CPU mesh) on the same inputs.

The cases are those of ``tests/jax_engine/test_device_pipeline.py``
(``TestDeviceSampleTake`` :188, ``TestDeviceTake`` :217,
``TestDeviceSetOps`` :260, ``TestEncodedUnion`` :348,
``test_union_one_sided_null_mask`` :403),
``tests/jax_engine/test_encoded_columns.py`` (:97, :309-350),
``test_nested_and_edges.py:61``, ``test_scale.py:47`` and
``fugue_tpu_test/execution_suite.py`` (:210-310, :554-570), with the
routing of each (spies on both host engines: the port's is called
exactly where the JAX engine's is), the A.3 refusals, the mask of a
filter in every verb, and the layout difference of a sample of a union
(ROADMAP.md C11).

Exact throughout: schema, arrow types, row sets, NULL placement, and the
rows a seeded ``sample`` keeps. No value here goes through a sum.
"""

import contextlib
import json
import subprocess
import sys
import unittest.mock as mock
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import chip_smoke
import fugue_tpu.api as fa
from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.column import col as jcol
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.jax import JaxDataFrame, JaxExecutionEngine
from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import col
from fugue_tpu_torch.constants import FUGUE_TPU_CONF_MAX_PARTIAL_ROWS
from fugue_tpu_torch.ops.random import uniform
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine

ROOT = Path(__file__).resolve().parent.parent
HOST_VERBS = ("union", "subtract", "intersect", "distinct", "sample", "take", "join", "select")


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine()
    yield e
    e.stop()


@pytest.fixture(scope="module")
def engine():
    return TorchExecutionEngine(device="cpu")


def _sorted(pdf: pd.DataFrame) -> pd.DataFrame:
    return pdf.sort_values(list(pdf.columns), na_position="last").reset_index(drop=True)


def _pandas(df) -> pd.DataFrame:
    return df.as_arrow().replace_schema_metadata(None).to_pandas()


def _same(got, exp, ordered: bool = False) -> None:
    """The port's frame (on its device) against the JAX engine's: schema,
    arrow types and rows, sorted by every column unless ``ordered``."""
    assert isinstance(got, TorchDataFrame), type(got)
    assert got.device == torch.device("cpu")
    assert str(got.schema) == str(exp.schema)
    g, e = got.as_arrow(), exp.as_arrow()
    assert g.schema.types == e.schema.types and g.num_rows == e.num_rows
    gp, ep = _pandas(got), _pandas(exp)
    if not ordered:
        gp, ep = _sorted(gp), _sorted(ep)
    pd.testing.assert_frame_equal(gp, ep, check_exact=True)


@contextlib.contextmanager
def _spies(host):
    with contextlib.ExitStack() as stack:
        yield {v: stack.enter_context(mock.patch.object(host, v, wraps=getattr(host, v)))
               for v in HOST_VERBS}


def _both(jax_engine, engine, frames, jfn, tfn, ordered=False):
    """``jfn(jax_engine, *frames)`` and ``tfn(engine, *frames)`` over the
    same tables (arrow or pandas): the same host-engine calls on both
    sides, the same answer (or the same exception class). Returns (port
    result, its host calls)."""
    jdfs = [jax_engine.to_df(JArrowDataFrame(f) if isinstance(f, pa.Table) else f) for f in frames]
    tdfs = [engine.to_df(f) for f in frames]
    with _spies(jax_engine._host_engine) as js:
        try:
            exp = jfn(jax_engine, *jdfs)
        except Exception as e:  # noqa: BLE001 - the port raises as the reference does
            with pytest.raises(Exception) as err:
                tfn(engine, *tdfs)
            assert type(err.value).__name__ == type(e).__name__
            return None, None
        jcalls = {v: s.call_count for v, s in js.items()}
    with _spies(engine._host_engine) as ts:
        got = tfn(engine, *tdfs)
        tcalls = {v: s.call_count for v, s in ts.items()}
    assert tcalls == jcalls, (tcalls, jcalls)
    _same(got, exp, ordered=ordered)
    return got, tcalls


def _on_device(calls) -> bool:
    return sum(calls.values()) == 0


@pytest.fixture(scope="module")
def pdf():
    rng = np.random.default_rng(0)
    n = 2000
    return pd.DataFrame({"k": rng.integers(0, 10, n), "v": rng.random(n)})


# ---- sample and take: test_device_pipeline.py :188-258 -----------------------


def test_frac_sample_keeps_the_reference_rows(jax_engine, engine, pdf):
    """The mask only (the tensors are the frame's own) and exactly the
    JAX engine's rows for the seed; the same seed, the same rows."""
    got, calls = _both(jax_engine, engine, [pdf], lambda e, d: e.sample(d, frac=0.2, seed=7),
                       lambda e, d: e.sample(d, frac=0.2, seed=7), ordered=True)
    assert _on_device(calls)
    assert got.valid_mask is not None and 0.1 * len(pdf) < got.count() < 0.3 * len(pdf)
    tdf = engine.to_df(pdf)
    again = engine.sample(tdf, frac=0.2, seed=7)
    assert again.device_cols["v"] is tdf.device_cols["v"]
    assert torch.equal(again.valid_mask, got.valid_mask)
    keep = uniform(7, 0, len(pdf), torch.device("cpu")).numpy() < 0.2
    np.testing.assert_array_equal(_pandas(got)["v"].to_numpy(), pdf["v"].to_numpy()[keep])


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 2, 2**40 + 3, -1])
@pytest.mark.parametrize("frac", [0.0, 0.013, 0.5, 1.0])
def test_sample_seeds_and_fractions(jax_engine, engine, seed, frac):
    rng = np.random.default_rng(5)
    data = pa.table({"a": rng.integers(0, 100, 1037), "s": pa.array(rng.choice(["x", "y"], 1037).tolist())})
    _both(jax_engine, engine, [data], lambda e, d: e.sample(d, frac=frac, seed=seed),
          lambda e, d: e.sample(d, frac=frac, seed=seed), ordered=True)


def test_sample_after_filter(jax_engine, engine, pdf):
    got, calls = _both(jax_engine, engine, [pdf],
                       lambda e, d: e.sample(e.filter(d, jcol("v") > 0.5), frac=0.5, seed=3),
                       lambda e, d: e.sample(e.filter(d, col("v") > 0.5), frac=0.5, seed=3), ordered=True)
    assert _on_device(calls) and got.count() <= (pdf["v"] > 0.5).sum()


def test_sample_without_a_seed_draws_one(engine, pdf):
    res = engine.sample(engine.to_df(pdf), frac=0.5)
    assert 0.4 * len(pdf) < res.count() < 0.6 * len(pdf)


@pytest.mark.parametrize("kw", [dict(n=10, seed=0), dict(frac=0.1, replace=True, seed=0),
                                dict(n=10, frac=0.1)])
def test_sample_of_n_or_with_replacement_takes_the_host(jax_engine, engine, kw):
    """``execution_suite.py`` ``test_sample``: n rows, with replacement,
    and both at once (which raises) go to the host engine in both."""
    data = pa.table({"a": np.arange(100)})
    got, calls = _both(jax_engine, engine, [data], lambda e, d: e.sample(d, **kw),
                       lambda e, d: e.sample(d, **kw))
    if got is not None:
        assert calls["sample"] == 1
        if "n" in kw:
            assert got.count() == 10


def test_take_topn_device(jax_engine, engine, pdf):
    got, calls = _both(jax_engine, engine, [pdf], lambda e, d: e.take(d, 4, presort="v desc"),
                       lambda e, d: e.take(d, 4, presort="v desc"), ordered=True)
    assert _on_device(calls)
    np.testing.assert_array_equal(_pandas(got)["v"], pdf.sort_values("v", ascending=False).head(4)["v"])


def test_take_keyed_takes_the_host(jax_engine, engine, pdf):
    got, calls = _both(jax_engine, engine, [pdf],
                       lambda e, d: e.take(d, 1, presort="v desc", partition_spec=JPartitionSpec(by=["k"])),
                       lambda e, d: e.take(d, 1, presort="v desc", partition_spec=PartitionSpec(by=["k"])))
    assert calls["take"] == 1 and got.count() == pdf["k"].nunique()


@pytest.mark.parametrize("presort,n,expected", [
    ("a,b desc", 3, [[1, 9.0], [1, 3.0], [1, 1.0]]),
    ("b", 2, [[2, 0.5], [1, 1.0]]),
])
def test_multi_key_presort(jax_engine, engine, presort, n, expected):
    data = pd.DataFrame({"a": [1, 1, 2, 2, 1], "b": [9.0, 1.0, 5.0, 0.5, 3.0]})
    got, calls = _both(jax_engine, engine, [data], lambda e, d: e.take(d, n, presort=presort),
                       lambda e, d: e.take(d, n, presort=presort), ordered=True)
    assert _on_device(calls) and got.as_array() == expected


def test_large_int64_keys(jax_engine, engine):
    big = 1 << 60
    data = pd.DataFrame({"a": [big + 3, big + 1, big + 2, -big]})
    for presort in ("a desc", "a"):
        got, _ = _both(jax_engine, engine, [data], lambda e, d: e.take(d, 2, presort=presort),
                       lambda e, d: e.take(d, 2, presort=presort), ordered=True)
    assert got.as_array() == [[-big], [big + 1]]


def test_nan_fills_the_tail(jax_engine, engine):
    data = pa.table({"a": pa.array([2.0, float("nan"), 1.0, float("nan")], pa.float64())})
    for presort in ("a", "a desc"):
        got, _ = _both(jax_engine, engine, [data], lambda e, d: e.take(d, 3, presort=presort),
                       lambda e, d: e.take(d, 3, presort=presort), ordered=True)
    vals = [r[0] for r in got.as_array()]
    assert vals[:2] == [2.0, 1.0] and (vals[2] is None or vals[2] != vals[2])


def test_take_after_filter_skewed_mask(jax_engine, engine):
    data = pd.DataFrame({"a": np.arange(1000, dtype=np.int64)})
    got, calls = _both(jax_engine, engine, [data],
                       lambda e, d: e.take(e.filter(d, jcol("a") < 10), 8, presort="a desc"),
                       lambda e, d: e.take(e.filter(d, col("a") < 10), 8, presort="a desc"), ordered=True)
    assert _on_device(calls) and [r[0] for r in got.as_array()] == list(range(9, 1, -1))


@pytest.mark.parametrize("presort", ["z, i", "z desc, i desc", "z, i desc", "z desc, i"])
def test_signed_zeros_sort_as_equals(jax_engine, engine, presort):
    """``lax.sort`` canonicalizes -0.0 to 0.0 (and every NaN to one), so
    the two zeros tie and the next key orders them; the port's integer
    image of a float does the same. Each zero keeps its own sign."""
    data = pd.DataFrame({"z": [0.0, -0.0, 1.0, -0.0, 0.0, -1.0, np.nan], "i": np.arange(7)})
    for n in (1, 2, 3, 4, 7):
        got, calls = _both(jax_engine, engine, [data], lambda e, d: e.take(d, n, presort=presort),
                           lambda e, d: e.take(d, n, presort=presort), ordered=True)
        assert _on_device(calls)
        z = _pandas(got)["z"].to_numpy()
        exp = _pandas(jax_engine.take(jax_engine.to_df(data), n, presort=presort))["z"].to_numpy()
        np.testing.assert_array_equal(np.signbit(z), np.signbit(exp))


@pytest.mark.parametrize("presort", ["z", "z desc"])
def test_signed_zeros_tie_at_the_cut(jax_engine, engine, presort):
    """With the zeros the only key, a cut through them is a tie: both
    engines keep the same values in the same order, and zeros from the
    tied rows (which ones depends on the candidates each pools)."""
    data = pd.DataFrame({"z": [0.0, -0.0, 1.0, -0.0, 0.0, -1.0, np.nan], "i": np.arange(7)})
    zeros = set(np.nonzero(data["z"].to_numpy() == 0)[0])
    for n in (1, 2, 3, 4, 7):
        with _spies(engine._host_engine) as ts:
            got = _pandas(engine.take(engine.to_df(data), n, presort=presort))
        assert sum(s.call_count for s in ts.values()) == 0
        exp = _pandas(jax_engine.take(jax_engine.to_df(data), n, presort=presort))
        np.testing.assert_array_equal(got["z"].to_numpy(), exp["z"].to_numpy())  # -0.0 == 0.0
        tied = got["z"].to_numpy() == 0
        assert set(got["i"][tied]) <= zeros and set(exp["i"][tied]) <= zeros
        np.testing.assert_array_equal(got["i"][~tied], exp["i"][~tied])


def test_take_n_above_the_device_limit_takes_the_host(jax_engine, engine):
    data = pd.DataFrame({"a": np.arange(5000)[::-1].copy()})
    got, calls = _both(jax_engine, engine, [data], lambda e, d: e.take(d, 4097, presort="a"),
                       lambda e, d: e.take(d, 4097, presort="a"), ordered=True)
    assert calls["take"] == 1 and got.count() == 4097
    got, calls = _both(jax_engine, engine, [data], lambda e, d: e.take(d, 4096, presort="a"),
                       lambda e, d: e.take(d, 4096, presort="a"), ordered=True)
    assert _on_device(calls)


# ---- set operations: test_device_pipeline.py :260-420 ------------------------


def test_union_device(jax_engine, engine):
    rng = np.random.default_rng(0)
    a = pd.DataFrame({"k": rng.integers(0, 20, 300), "v": rng.integers(0, 3, 300)})
    b = pd.DataFrame({"k": rng.integers(0, 20, 200), "v": rng.integers(0, 3, 200)})
    for distinct in (True, False):
        got, calls = _both(jax_engine, engine, [a, b], lambda e, x, y: e.union(x, y, distinct=distinct),
                           lambda e, x, y: e.union(x, y, distinct=distinct))
        assert _on_device(calls)
    assert got.count() == 500


def test_union_after_filter(jax_engine, engine):
    a = pd.DataFrame({"x": np.arange(100, dtype=np.int64)})
    b = pd.DataFrame({"x": np.arange(50, 150, dtype=np.int64)})
    for distinct in (True, False):
        got, _ = _both(jax_engine, engine, [a, b],
                       lambda e, x, y: e.union(e.filter(x, jcol("x") < 30), e.filter(y, jcol("x") >= 120),
                                               distinct=distinct),
                       lambda e, x, y: e.union(e.filter(x, col("x") < 30), e.filter(y, col("x") >= 120),
                                               distinct=distinct))
        assert sorted(_pandas(got)["x"]) == list(range(30)) + list(range(120, 150))


def test_subtract_intersect_device(jax_engine, engine):
    """Both sides NULL-free and plain: the device distinct of each, then
    the device anti and semi join; no host engine on either side."""
    rng = np.random.default_rng(1)
    a = pd.DataFrame({"k": rng.integers(0, 15, 200), "v": rng.integers(0, 2, 200)})
    b = pd.DataFrame({"k": rng.integers(0, 15, 150), "v": rng.integers(0, 2, 150)})
    for verb in ("subtract", "intersect"):
        got, calls = _both(jax_engine, engine, [a, b], lambda e, x, y: getattr(e, verb)(x, y),
                           lambda e, x, y: getattr(e, verb)(x, y))
        assert _on_device(calls) and got.host_table is None
    d = engine.distinct(engine.to_df(a))
    assert d._nan_cols is not None and len(d._nan_cols) == 0


def test_set_ops_of_floats_with_nan_take_the_host(jax_engine, engine):
    """A float column that may hold NaN (a NULL) fails the set verbs'
    device gate in both engines: NULL = NULL there, never in a join."""
    a = pd.DataFrame({"k": [1.0, np.nan, 2.0, np.nan], "v": [1, 2, 3, 2]})
    b = pd.DataFrame({"k": [np.nan, 2.0], "v": [2, 3]})
    for verb in ("subtract", "intersect"):
        got, calls = _both(jax_engine, engine, [a, b], lambda e, x, y: getattr(e, verb)(x, y),
                           lambda e, x, y: getattr(e, verb)(x, y))
        assert calls[verb] == 1
    assert _pandas(got)["v"].tolist() == [2, 3]


@pytest.mark.parametrize("verb", ["subtract", "intersect"])
def test_set_ops_all_raises_on_the_host(jax_engine, engine, verb):
    a = pd.DataFrame({"k": [1, 2, 2]})
    got, calls = _both(jax_engine, engine, [a, a], lambda e, x, y: getattr(e, verb)(x, y, distinct=False),
                       lambda e, x, y: getattr(e, verb)(x, y, distinct=False))
    assert got is None
    with pytest.raises(NotImplementedError, match="ALL"):
        getattr(engine, verb)(engine.to_df(a), engine.to_df(a), distinct=False)


def test_distinct_nan_keys_group_once(jax_engine, engine):
    data = pa.table({"v": pa.array([1.0, float("nan"), float("nan"), 1.0], pa.float64())})
    got, calls = _both(jax_engine, engine, [data], lambda e, d: e.distinct(d), lambda e, d: e.distinct(d))
    assert _on_device(calls) and got.count() == 2 and _pandas(got)["v"].isna().sum() == 1


def test_distinct_nulls_of_each_kind(jax_engine, engine):
    """NULL = NULL in every kind of column, and a float's NULL is its NaN:
    a masked int, a NaN float, a NULL string code, a NULL bool, a NULL
    date, each grouped once."""
    data = pa.table({
        "i": pa.array([1, None, None, 1, 2], pa.int32()),
        "f": pa.array([np.nan, 0.5, None, np.nan, 0.5]),
        "s": pa.array(["a", None, None, "a", "b"]),
        "b": pa.array([True, None, None, True, False]),
        "t": pa.array([10**6, None, None, 10**6, 0], pa.int64()).cast(pa.timestamp("us")),
    })
    for cols in (["i", "f"], ["s", "b", "t"], ["i", "f", "s", "b", "t"]):
        got, calls = _both(jax_engine, engine, [data.select(cols)], lambda e, d: e.distinct(d),
                           lambda e, d: e.distinct(d))
        assert _on_device(calls)
    assert got.count() == 4


def test_union_string_columns_on_device(jax_engine, engine):
    """The union dictionary stays sorted, so a string take after it runs
    on the device."""
    a = pd.DataFrame({"s": ["x", "y", None], "v": [1.0, 2.0, 3.0]})
    b = pd.DataFrame({"s": ["y", "z", None], "v": [2.0, 4.0, 3.0]})
    got, calls = _both(jax_engine, engine, [a, b], lambda e, x, y: e.union(x, y, distinct=True),
                       lambda e, x, y: e.union(x, y, distinct=True))
    assert _on_device(calls) and got.host_table is None
    assert engine.union(engine.to_df(a), engine.to_df(b), distinct=False).encodings["s"]["sorted"] is True
    got, calls = _both(jax_engine, engine, [a, b],
                       lambda e, x, y: e.take(e.union(x, y, distinct=True), 2, presort="s"),
                       lambda e, x, y: e.take(e.union(x, y, distinct=True), 2, presort="s"), ordered=True)
    assert _on_device(calls) and [r[0] for r in got.as_array()] == ["x", "y"]


def test_union_nullable_and_datetime(jax_engine, engine):
    a = pd.DataFrame({"n": pd.array([1, None], dtype="Int32"), "t": pd.to_datetime(["2020-01-01", "2020-02-01"])})
    b = pd.DataFrame({"n": pd.array([None, 3], dtype="Int32"), "t": pd.to_datetime(["2020-02-01", None])})
    for distinct in (False, True):
        _, calls = _both(jax_engine, engine, [a, b], lambda e, x, y: e.union(x, y, distinct=distinct),
                         lambda e, x, y: e.union(x, y, distinct=distinct))
        assert _on_device(calls)


def test_union_one_sided_null_mask(jax_engine, engine):
    a = pd.DataFrame({"n": pd.array([1, None, 2], dtype="Int32")})
    b = pd.DataFrame({"n": pd.array([3, 4], dtype="Int32")})
    for d1, d2 in [(a, b), (b, a)]:
        got, _ = _both(jax_engine, engine, [d1, d2], lambda e, x, y: e.union(x, y, distinct=False),
                       lambda e, x, y: e.union(x, y, distinct=False))
        assert _pandas(got)["n"].isna().sum() == 1


def test_union_of_differing_frames_takes_the_host(jax_engine, engine):
    """Different encodings on the two sides (a string column against an
    all-NULL one kept on the host) and different schemas: the host
    engine's union, or its error."""
    a = pa.table({"s": pa.array(["x", "y"]), "v": [1, 2]})
    b = pa.table({"s": pa.array(["z", "x"]), "v": pa.array([1, 2], pa.int32())})
    got, calls = _both(jax_engine, engine, [a, b.cast(a.schema)], lambda e, x, y: e.union(x, y),
                       lambda e, x, y: e.union(x, y))
    assert _on_device(calls)
    got, calls = _both(jax_engine, engine, [a, b], lambda e, x, y: e.union(x, y, distinct=False),
                       lambda e, x, y: e.union(x, y, distinct=False))
    assert got is None  # the schemas differ: the host engine raises in both


# ---- encoded columns: test_encoded_columns.py :97, :309-350 -------------------


def test_distinct_with_strings_and_nulls(jax_engine, engine):
    data = pd.DataFrame({"s": ["x", "y", None, "x", None], "a": pd.array([1, 2, 3, 1, 3], dtype="Int64")})
    got, calls = _both(jax_engine, engine, [data], lambda e, d: e.distinct(d), lambda e, d: e.distinct(d))
    assert _on_device(calls) and got.count() == 3


@pytest.mark.parametrize("presort,n,expected", [
    ("s", 2, [["apple", 2.0], ["fig", 5.0]]),
    ("s desc", 2, [["zebra", 4.0], ["pear", 1.0]]),
    ("s", 5, None),
])
def test_take_with_string_presort(jax_engine, engine, presort, n, expected):
    data = pd.DataFrame({"s": ["pear", "apple", None, "zebra", "fig"], "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    got, calls = _both(jax_engine, engine, [data], lambda e, d: e.take(d, n, presort=presort),
                       lambda e, d: e.take(d, n, presort=presort), ordered=True)
    assert _on_device(calls)
    rows = got.as_array()
    assert rows == expected if expected is not None else rows[-1][0] is None


def test_take_with_nullable_int_presort(jax_engine, engine):
    data = pd.DataFrame({"a": pd.array([3, None, 1, 2], dtype="Int32"), "v": [1.0, 2.0, 3.0, 4.0]})
    got, _ = _both(jax_engine, engine, [data], lambda e, d: e.take(d, 3, presort="a"),
                   lambda e, d: e.take(d, 3, presort="a"), ordered=True)
    assert [r[0] for r in got.as_array()] == [1, 2, 3]
    got, _ = _both(jax_engine, engine, [data], lambda e, d: e.take(d, 4, presort="a desc"),
                   lambda e, d: e.take(d, 4, presort="a desc"), ordered=True)
    assert [r[0] for r in got.as_array()] == [3, 2, 1, None]


def test_take_with_datetime_presort(jax_engine, engine):
    data = pd.DataFrame({"t": pd.to_datetime(["2021-01-01", "2019-06-01", None, "2020-01-01"]),
                         "v": [1.0, 2.0, 3.0, 4.0]})
    got, calls = _both(jax_engine, engine, [data], lambda e, d: e.take(d, 2, presort="t"),
                       lambda e, d: e.take(d, 2, presort="t"), ordered=True)
    assert _on_device(calls)
    assert [str(r[0])[:10] for r in got.as_array()] == ["2019-06-01", "2020-01-01"]


def test_take_of_a_nested_frame_takes_the_host(jax_engine, engine):
    """``test_nested_and_edges.py:61``: list and struct columns stay on the
    host in both packages, so the take is the host engine's."""
    data = pa.table({"k": [1, 2, 3], "tags": pa.array([[1, 2], [], [3]]),
                     "info": pa.array([{"b": "x"}, {"b": "y"}, {"b": "z"}])})
    got, calls = _both(jax_engine, engine, [data], lambda e, d: e.take(d, 2, presort="k desc"),
                       lambda e, d: e.take(d, 2, presort="k desc"), ordered=True)
    assert calls["take"] == 1
    assert _pandas(got)["k"].tolist() == [3, 2] and _pandas(got)["tags"].tolist()[0].tolist() == [3]


@pytest.mark.parametrize("dt", [np.uint16, np.uint32, np.uint64])
def test_distinct_of_dates_where_the_reference_raises(jax_engine, engine, dt):
    """ROADMAP.md C3 also holds for the set verbs: the JAX engine decodes a
    date32 column through a cast of int64 that arrow lacks, in its
    ``distinct`` (and so its ``union``) and its device ``take``. The port
    casts through int32 and answers as its host engine does."""
    from fugue_tpu_torch.execution.native_execution_engine import NativeExecutionEngine

    data = pa.table({"d": pa.array([18000, 18001, 18000, None], pa.int32()).cast(pa.date32()),
                     "u": pa.array([1, 2, 1, 2], pa.from_numpy_dtype(dt)).cast(pa.int64())})
    native = NativeExecutionEngine()
    for fn in (lambda e, d: e.distinct(d), lambda e, d: e.take(d, 3, presort="d desc, u"),
               lambda e, d: e.union(d, d)):
        with pytest.raises(pa.ArrowNotImplementedError):
            fn(jax_engine, jax_engine.to_df(JArrowDataFrame(data)))
        got = fn(engine, engine.to_df(data))
        want = fn(native, native.to_df(JArrowDataFrame(data).as_arrow()))
        assert str(got.schema) == str(want.schema)
        pd.testing.assert_frame_equal(_sorted(_pandas(got)), _sorted(_pandas(want)))


# ---- the distinct guard: test_scale.py :47 ------------------------------------


def test_distinct_cardinality_guard(jax_engine):
    """Above ``fugue.tpu.max_partial_rows`` groups the host engine dedupes
    the frame, in both engines; below it the device does. The reference's
    own case (5,000 keys over a range of 5,000) takes the dense route,
    which has no guard, in both."""
    cases = [(np.arange(5000, dtype=np.int64) + 10**9, 100, 0),
             (np.arange(5000, dtype=np.int64) * 1000 + 10**9, 100, 1),
             (np.arange(5000, dtype=np.int64) * 1000 + 10**9, 1 << 22, 0)]
    for a, limit, host in cases:
        conf = {FUGUE_TPU_CONF_MAX_PARTIAL_ROWS: limit}
        je, te = JaxExecutionEngine(conf), TorchExecutionEngine(device="cpu", conf=conf)
        try:
            got, calls = _both(je, te, [pd.DataFrame({"a": a})], lambda e, d: e.distinct(d),
                               lambda e, d: e.distinct(d))
        finally:
            je.stop()
        assert calls["distinct"] == host and got.count() == 5000


# ---- execution_suite.py :210-310, :554-570 ------------------------------------


def _suite(rows, schema):
    from fugue_tpu_torch.schema import Schema

    return pa.Table.from_pylist([dict(zip(Schema(schema).names, r)) for r in rows], schema=Schema(schema).pa_schema)


@pytest.mark.parametrize("verb,rows1,rows2,schema,expected", [
    ("union", [[1], [2], [2]], [[2], [3]], "a:long", [[1], [2], [3]]),
    ("union_all", [[1], [2], [2]], [[2], [3]], "a:long", [[1], [2], [2], [2], [3]]),
    ("subtract", [[1], [2], [2], [3]], [[2], [4]], "a:long", [[1], [3]]),
    ("intersect", [[1], [2], [2], [3]], [[2], [4]], "a:long", [[2]]),
    ("subtract", [[1], [2], [2]], [[2]], "a:long", [[1]]),
    ("intersect", [[1], [2], [2]], [[2], [3]], "a:long", [[2]]),
    ("union", [[1, "x"], [None, "y"], [None, "y"], [2, None]], [[None, "y"], [2, None]], "a:double,b:str",
     [[1, "x"], [None, "y"], [2, None]]),
    ("subtract", [[1, "x"], [None, "y"], [None, "y"], [2, None]], [[None, "y"], [2, None]], "a:double,b:str",
     [[1, "x"]]),
    ("intersect", [[1, "x"], [None, "y"], [None, "y"], [2, None]], [[None, "y"], [2, None]], "a:double,b:str",
     [[None, "y"], [2, None]]),
])
def test_suite_set_ops(jax_engine, engine, verb, rows1, rows2, schema, expected):
    def run(e, x, y):
        return e.union(x, y, distinct=False) if verb == "union_all" else getattr(e, verb)(x, y)

    got, _ = _both(jax_engine, engine, [_suite(rows1, schema), _suite(rows2, schema)], run, run)
    assert _sorted(_pandas(got)).equals(_sorted(_pandas(TorchDataFrame(_suite(expected, schema), device="cpu"))))


def test_suite_distinct_and_take(jax_engine, engine):
    data = _suite([[1, None], [1, None], [2, "x"]], "a:long,b:str")
    got, _ = _both(jax_engine, engine, [data], lambda e, d: e.distinct(d), lambda e, d: e.distinct(d))
    assert got.count() == 2
    data = _suite([[1, 5], [1, 3], [2, 9], [2, 2], [None, 1]], "a:double,b:long")
    got, calls = _both(jax_engine, engine, [data],
                       lambda e, d: e.take(d, 1, presort="b desc", partition_spec=JPartitionSpec(by=["a"])),
                       lambda e, d: e.take(d, 1, presort="b desc", partition_spec=PartitionSpec(by=["a"])))
    assert calls["take"] == 1 and got.count() == 3
    got, calls = _both(jax_engine, engine, [data], lambda e, d: e.take(d, 2, presort="b"),
                       lambda e, d: e.take(d, 2, presort="b"), ordered=True)
    assert _on_device(calls) and got.as_array() == [[None, 1], [2.0, 2]]


def test_suite_take_na_position_first(jax_engine, engine):
    data = _suite([[1.0], [None], [3.0]], "a:double")
    got, calls = _both(jax_engine, engine, [data], lambda e, d: e.take(d, 1, presort="a", na_position="first"),
                       lambda e, d: e.take(d, 1, presort="a", na_position="first"))
    assert calls["take"] == 1 and got.as_array(type_safe=True) == [[None]]


def test_suite_union_schema_mismatch_raises(jax_engine, engine):
    got, _ = _both(jax_engine, engine, [_suite([[1]], "a:long"), _suite([["x"]], "a:str")],
                   lambda e, x, y: e.union(x, y), lambda e, x, y: e.union(x, y))
    assert got is None


# ---- masks: every verb after a filter, and a fully filtered frame --------------


VERBS = {
    "distinct": (lambda e, d: e.distinct(d), False),
    "union": (lambda e, d: e.union(d, d), False),
    "union_all": (lambda e, d: e.union(d, d, distinct=False), False),
    "subtract": (lambda e, d: e.subtract(d, d), False),
    "intersect": (lambda e, d: e.intersect(d, d), False),
    "sample": (lambda e, d: e.sample(d, frac=0.5, seed=11), True),
    "take": (lambda e, d: e.take(d, 5, presort="v desc, k"), True),
    "take_strings": (lambda e, d: e.take(d, 5, presort="s, k desc"), True),
}


@pytest.mark.parametrize("name", list(VERBS))
@pytest.mark.parametrize("bound", [0.3, 100.0])
def test_every_verb_honours_the_filters_mask(jax_engine, engine, name, bound):
    """After a filter that keeps some rows, and one that keeps none
    (``test_nested_and_edges.py:107``), each verb answers as the JAX
    engine does, on its device."""
    rng = np.random.default_rng(9)
    n = 500
    data = pa.table({"k": rng.integers(0, 6, n), "v": rng.integers(0, 1000, n) / 1000,
                     "s": pa.array(rng.choice(["x", "y", "z"], n).tolist())})
    fn, ordered = VERBS[name]
    got, calls = _both(jax_engine, engine, [data], lambda e, d: fn(e, e.filter(d, jcol("v") > bound)),
                       lambda e, d: fn(e, e.filter(d, col("v") > bound)), ordered=ordered)
    assert got.count() <= (2 if name == "union_all" else 1) * (data.column("v").to_numpy() > bound).sum()
    assert _on_device(calls) or name in ("subtract", "intersect")  # a string column: the host


@pytest.mark.parametrize("name", list(VERBS))
def test_empty_frames(jax_engine, engine, name):
    data = pa.table({"k": pa.array([], pa.int64()), "v": pa.array([], pa.float64()), "s": pa.array([], pa.string())})
    fn, ordered = VERBS[name]
    got, _ = _both(jax_engine, engine, [data], fn, fn, ordered=ordered)
    assert got.count() == 0


# ---- the union layout difference (ROADMAP.md C11) ------------------------------


def test_sample_of_a_union_depends_on_the_reference_mesh(jax_engine, engine):
    """Each JAX shard concatenates its own blocks of the two frames, so a
    row's index after a device union, and the draw a sample gives it,
    depends on the mesh. The port has one device: the rows of the first
    frame, then of the second. The same seed keeps another set of rows;
    on a frame not unioned it keeps the same."""
    a = pd.DataFrame({"x": np.arange(40, dtype=np.int64)})
    b = pd.DataFrame({"x": np.arange(100, 140, dtype=np.int64)})
    ju = jax_engine.union(jax_engine.to_df(a), jax_engine.to_df(b), distinct=False)
    tu = engine.union(engine.to_df(a), engine.to_df(b), distinct=False)
    _same(tu, ju)  # the same rows
    assert _pandas(tu)["x"].tolist() == list(range(40)) + list(range(100, 140))
    assert _pandas(ju)["x"].tolist() != _pandas(tu)["x"].tolist()  # another order
    jk = set(_pandas(jax_engine.sample(ju, frac=0.5, seed=4))["x"])
    tk = set(_pandas(engine.sample(tu, frac=0.5, seed=4))["x"])
    keep = uniform(4, 0, 80, torch.device("cpu")).numpy() < 0.5
    assert tk == set(np.concatenate([a["x"], b["x"]])[keep]) and jk != tk
    ab = pd.concat([a, b], ignore_index=True)
    _same(engine.sample(engine.to_df(ab), frac=0.5, seed=4),
          jax_engine.sample(jax_engine.to_df(ab), frac=0.5, seed=4), ordered=True)


# ---- A.3: unsigned columns above uint8 ----------------------------------------


UINT_CASES = {
    "distinct": lambda e, d: e.distinct(d),
    "union": lambda e, d: e.union(d, d, distinct=False),
    "subtract": lambda e, d: e.subtract(d, d),
    "intersect": lambda e, d: e.intersect(d, d),
    "sample": lambda e, d: e.sample(d, frac=0.5, seed=1),
    "take": lambda e, d: e.take(d, 2, presort="u desc"),
    "take_other_key": lambda e, d: e.take(d, 2, presort="k"),
}


@pytest.mark.parametrize("case", list(UINT_CASES))
@pytest.mark.parametrize("dt", [np.uint16, np.uint32, np.uint64])
def test_unsigned_columns_raise_where_the_reference_runs_on_its_device(jax_engine, engine, case, dt):
    """Named for the refusal it pinned before the unsigned types above
    uint8 lived on the port's device: both engines run the verb on their
    device (no host-engine call on either), with the same rows, values at
    the type's top included (2**63 and 2**64 - 1 for uint64, whose order
    the take's presort follows). Exact."""
    top = int(np.iinfo(dt).max)
    data = pa.table({"k": [1, 2, 1, 2, 1], "u": pa.array(np.array([1, top // 2 + 1, top, 3, top], dt))})
    jdf = jax_engine.to_df(JArrowDataFrame(data))
    assert jdf.host_table is None and "u" in jdf.device_cols
    _, calls = _both(jax_engine, engine, [data], UINT_CASES[case], UINT_CASES[case],
                     ordered=case.startswith("take"))
    assert sum(calls.values()) == 0


def test_unsigned_columns_on_the_host_route_answer(jax_engine, engine):
    """Where the JAX engine's gate sends the verb to its host, the port's
    host answers the same: a sample of n rows, a keyed take."""
    data = pa.table({"k": [1, 2, 1], "u": pa.array([1, 2, 3], pa.uint16())})
    _both(jax_engine, engine, [data], lambda e, d: e.sample(d, n=2, seed=0), lambda e, d: e.sample(d, n=2, seed=0))
    _both(jax_engine, engine, [data],
          lambda e, d: e.take(d, 1, presort="u", partition_spec=JPartitionSpec(by=["k"])),
          lambda e, d: e.take(d, 1, presort="u", partition_spec=PartitionSpec(by=["k"])))


# ---- spans --------------------------------------------------------------------


def test_device_verbs_are_traced(engine, pdf):
    tdf = engine.to_df(pdf)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.distinct(tdf[["k"]])
        engine.sample(tdf, frac=0.1, seed=1)
        engine.take(tdf, 3, presort="v")
    names = {e.key for e in prof.key_averages()}
    assert {"fugue::distinct", "fugue::sample_mask", "fugue::take_sort"} <= names
    assert "fugue::to_host" not in names


def test_host_union_is_traced(engine):
    a = engine.to_df(pa.table({"a": [1, 2], "l": pa.array([[1], []])}))
    b = engine.to_df(pa.table({"a": [3, 2], "l": pa.array([[2], []])}))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.union(a, b)
    names = {e.key for e in prof.key_averages()}
    assert {"fugue::to_host", "fugue::host_union", "fugue::to_device"} <= names


# ---- the API ------------------------------------------------------------------


def test_api_verbs(jax_engine, engine):
    rng = np.random.default_rng(2)
    a = pd.DataFrame({"k": rng.integers(0, 5, 60), "v": rng.integers(0, 3, 60)})
    b = pd.DataFrame({"k": rng.integers(0, 5, 40), "v": rng.integers(0, 3, 40)})
    c = pd.DataFrame({"k": rng.integers(2, 7, 30), "v": rng.integers(0, 3, 30)})
    _same(api.distinct(a, engine=engine, as_fugue=True), fa.distinct(a, engine=jax_engine, as_fugue=True))
    for verb in ("union", "subtract", "intersect"):
        for kw in ({}, {"distinct": False}) if verb == "union" else ({},):
            _same(getattr(api, verb)(a, b, c, engine=engine, as_fugue=True, **kw),
                  getattr(fa, verb)(a, b, c, engine=jax_engine, as_fugue=True, **kw))
    _same(api.sample(a, frac=0.3, seed=5, engine=engine, as_fugue=True),
          fa.sample(a, frac=0.3, seed=5, engine=jax_engine, as_fugue=True), ordered=True)
    _same(api.take(a, 4, presort="k desc, v", engine=engine, as_fugue=True),
          fa.take(a, 4, presort="k desc, v", engine=jax_engine, as_fugue=True))
    _same(api.take(a, 1, presort="v", partition={"by": ["k"]}, engine=engine, as_fugue=True),
          fa.take(a, 1, presort="v", partition={"by": ["k"]}, engine=jax_engine, as_fugue=True))
    assert isinstance(api.distinct(a, device="cpu"), pd.DataFrame)
    assert isinstance(api.union(pa.Table.from_pandas(a), b, device="cpu"), pa.Table)
    assert isinstance(api.intersect(a, engine.to_df(b), device="cpu"), TorchDataFrame)


def test_api_entry_points_need_a_card_unless_given_the_cpu():
    """Every verb ``api`` adds resolves its engine to ``cuda:0``: with no
    card and no ``device``, it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda:0")
    a = pd.DataFrame({"k": [1, 2]})
    for call in (lambda: api.distinct(a), lambda: api.sample(a, frac=0.5), lambda: api.take(a, 1, presort="k"),
                 lambda: api.union(a, a), lambda: api.subtract(a, a), lambda: api.intersect(a, a)):
        with pytest.raises(RuntimeError):
            call()


def test_jax_frames_are_jax_frames(jax_engine):
    """The comparisons above hold the port against the JAX engine's
    device results, not its host engine's."""
    a = pd.DataFrame({"k": [1, 2, 2]})
    assert isinstance(jax_engine.distinct(jax_engine.to_df(a)), JaxDataFrame)
    assert isinstance(jax_engine.take(jax_engine.to_df(a), 1, presort="k"), JaxDataFrame)


# ---- chip_smoke.py's setop_path, at small size --------------------------------


_SETOP_PATH_ON_THE_CPU = """
import json, numpy as np, pandas as pd, pyarrow as pa, torch
import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch.column import col
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
engine = TorchExecutionEngine(device="cpu")
tbl, aux = chip_smoke.make_lineitem(np, pa, 0, 16_000)
oracles = chip_smoke.setop_path_oracles(np, pd, pa, tbl, aux)
out = chip_smoke.phase_setop_path(torch, np, pd, pa, bg, api, col, engine, engine.persist(engine.to_df(tbl)),
                                  oracles, 0, stream_rows=200_000, stream_chunk=50_000)
"""


def test_chip_smoke_setop_path_on_the_cpu():
    """The eight in-memory cells at ~64k rows and the two streamed ones at
    2·10^5 rows in chunks of 5·10^4, each through its oracle, one line a
    cell, in a process that loads no JAX; no hand kernel launches."""
    res = subprocess.run([sys.executable, "-c", _SETOP_PATH_ON_THE_CPU], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith('{"phase": "setop_path"')]
    assert [ln["cell"] for ln in lines] == [
        "distinct-flags-mode", "distinct-qty-disc", "union-distinct-modes", "intersect-qty-disc",
        "subtract-qty-disc", "take-top-price", "take-last-ship", "sample-1pct", "stream-take", "stream-distinct"]
    for ln in lines[:8]:
        assert ln["launches"] == {"bin_sum": 0, "bin_sum_count": 0}
        assert ln["bound_ms"] > 0 and ln["ms"] > 0 and len(ln["ms_all"]) == 3
    spans = {ln["cell"]: ln["profile"]["host_spans_ms"] for ln in lines[:8]}
    assert "fugue::distinct" in spans["distinct-flags-mode"] and "fugue::to_host" not in spans["distinct-qty-disc"]
    assert "fugue::take_sort" in spans["take-top-price"] and "fugue::sample_mask" in spans["sample-1pct"]
    assert "fugue::join_probe" in spans["intersect-qty-disc"]
    assert lines[8]["early_stop"]["serial"]["chunks_made"] == 1 and lines[8]["stream_stats"]["chunks"] == 4
    assert lines[9]["stream_stats"]["verb"] == "distinct"
    assert "jax" not in res.stdout


def test_setop_path_oracles_reject_wrong_answers(engine):
    """Each oracle check fails on a wrong answer: a row missing from a
    distinct; a take with one row of another, or its rows out of order."""
    tbl, aux = chip_smoke.make_lineitem(np, pa, 0, 3000)
    oracles = chip_smoke.setop_path_oracles(np, pd, pa, tbl, aux)
    got = api.distinct(api.select(engine.to_df(tbl), "l_quantity", "l_discount", engine=engine),
                       engine=engine).as_pandas()
    chip_smoke._same_rows(np, got, oracles["distinct-qty-disc"], "distinct-qty-disc")
    with pytest.raises(RuntimeError):
        chip_smoke._same_rows(np, got.iloc[1:], oracles["distinct-qty-disc"].iloc[:-1], "distinct-qty-disc")
    keys = ["l_shipdate", "l_extendedprice"]
    res = api.take(engine.to_df(tbl), 10, presort="l_shipdate desc, l_extendedprice desc", engine=engine).as_arrow()
    exp = oracles["take-last-ship"]
    chip_smoke._same_take(res, exp, keys, "take-last-ship")
    for wrong in (pa.concat_tables([exp.slice(0, 9), tbl.slice(0, 1)]), exp.take(list(range(9, -1, -1)))):
        with pytest.raises(RuntimeError):
            chip_smoke._same_take(res, wrong, keys, "take-last-ship")


@pytest.mark.parametrize("verb", ["subtract", "intersect"])
def test_unsigned_columns_with_nulls_take_the_host_in_set_ops(jax_engine, engine, verb):
    """A uint16 column with a NULL is masked on the JAX package's device,
    which fails its set verbs' gate: both engines take their host."""
    data = pa.table({"k": [1, 2, 1], "u": pa.array([1, None, 3], pa.uint16())})
    got, calls = _both(jax_engine, engine, [data, data], lambda e, x, y: getattr(e, verb)(x, y),
                       lambda e, x, y: getattr(e, verb)(x, y))
    assert calls[verb] == 1


def test_tied_take_against_a_one_device_mesh(engine):
    """C23 (ROADMAP.md §C): which tied rows a device ``take`` keeps depends
    on the reference's mesh. After ``filter(v IS NULL OR w < 0.5)`` and
    ``select(k, i * 2 AS z)``, ``take(3, presort="z desc")`` with many rows
    tied at the top: on a one-device mesh (``fugue.tpu.mesh_shape=[1]``)
    the reference keeps the first tied rows in row order, as the port and
    a stable pandas sort do. Rows exact, in order."""
    from fugue_tpu.column import SelectColumns as JSelectColumns
    from fugue_tpu_torch.column import SelectColumns

    rng = np.random.default_rng(23)
    n = 300
    v = rng.random(n)
    v[rng.random(n) < 0.3] = np.nan
    pdf = pd.DataFrame({"k": np.arange(n), "v": v, "w": rng.random(n), "i": rng.integers(0, 9, n)})
    one = JaxExecutionEngine({"fugue.tpu.mesh_shape": [1], "fugue.tpu.cache.enabled": False})

    def top(eng, c, cols):
        df = eng.filter(eng.to_df(pdf), c("v").is_null() | (c("w") < 0.5))
        df = eng.select(df, cols(c("k"), (c("i") * 2).alias("z")))
        return eng.take(df, 3, presort="z desc")

    kept = pdf[pdf["v"].isna() | (pdf["w"] < 0.5)]
    exp = kept.assign(z=kept["i"] * 2).sort_values("z", ascending=False, kind="stable")[["k", "z"]].head(3)
    assert (kept["i"] == kept["i"].max()).sum() > 3  # the top value is tied
    got = top(engine, col, SelectColumns)
    _same(got, top(one, jcol, JSelectColumns), ordered=True)
    assert _pandas(got).values.tolist() == exp.values.tolist()
    one.stop_engine()
