"""``TorchExecutionEngine.join`` (device="cpu") and ``fugue_tpu_torch.api``'s
joins against ``JaxExecutionEngine`` (the 8-device CPU mesh) on the same
inputs.

The cases are those of ``tests/jax_engine/test_device_join.py`` and
``tests/jax_engine/test_expand_join.py`` (all but the FugueSQL one: SQL
is not ported), the API's chaining and named joins, the union, the
refusals, and ``chip_smoke.py``'s join_path cells at small size.

Results are compared after sorting by every column: exact for keys,
integers, strings, row sets and NULL placement; floats with pandas'
``assert_frame_equal`` default (``rtol=1e-5``), as the reference's own
tests compare. Where the JAX engine joins on its host engine, the port
joins on its own host engine at the same place: each such case spies on
both host engines and compares the answers.
"""

import contextlib
import decimal
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
import fugue_tpu.ops.join as oj
from fugue_tpu.execution import NativeExecutionEngine
from fugue_tpu.jax import JaxDataFrame, JaxExecutionEngine
from fugue_tpu_torch import api
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.ops import join as tj
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine, frame_from_numpy
from fugue_tpu_torch.torch import execution_engine as te


ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine()
    yield e
    e.stop()


@pytest.fixture(scope="module")
def engine():
    return TorchExecutionEngine(device="cpu")


def _sorted(pdf: pd.DataFrame) -> pd.DataFrame:
    return pdf.sort_values(list(pdf.columns)).reset_index(drop=True)


def _same(got, exp) -> None:
    assert str(got.schema) == str(exp.schema)
    pd.testing.assert_frame_equal(_sorted(got.as_pandas()), _sorted(exp.as_pandas()), check_dtype=False)


def _check(jax_engine, engine, left, right, how, on=None):
    """The port's join of ``left`` and ``right`` against the JAX engine's;
    the port's result stays on its device."""
    exp = jax_engine.join(jax_engine.to_df(left), jax_engine.to_df(right), how=how, on=on)
    got = engine.join(engine.to_df(left), engine.to_df(right), how=how, on=on)
    assert isinstance(got, TorchDataFrame) and got.host_table is None
    _same(got, exp)
    return got, exp


# ---- the cases of tests/jax_engine/test_device_join.py ---------------------


@pytest.fixture(scope="module")
def fact():
    rng = np.random.default_rng(0)
    return pd.DataFrame({"k": rng.integers(0, 50, 500), "v": rng.random(500)})


@pytest.fixture(scope="module")
def dim():
    # unique keys 0..39 → some fact keys miss
    rng = np.random.default_rng(1)
    return pd.DataFrame({"k": np.arange(40), "w": rng.random(40)})


def test_inner(jax_engine, engine, fact, dim):
    _check(jax_engine, engine, fact, dim, "inner")


def test_left_outer_float_values(jax_engine, engine, fact, dim):
    got, _ = _check(jax_engine, engine, fact, dim, "left_outer")
    assert got.count() == len(fact)


def test_left_outer_int_values(jax_engine, engine, fact):
    dim_int = pd.DataFrame({"k": np.arange(40), "w": np.arange(40)})
    got, exp = _check(jax_engine, engine, fact, dim_int, "left_outer")
    # stays on the device: int misses carry a generated null mask
    assert "w" in got.null_masks and "w" in exp.null_masks


@pytest.mark.parametrize("how", ["semi", "anti"])
def test_semi_anti(jax_engine, engine, fact, dim, how):
    _check(jax_engine, engine, fact, dim, how)


@pytest.mark.parametrize("how", ["inner", "left_outer", "semi", "anti"])
def test_multi_key(jax_engine, engine, how):
    rng = np.random.default_rng(2)
    left = pd.DataFrame(
        {"a": rng.integers(0, 6, 300), "b": rng.integers(0, 6, 300), "v": rng.random(300)}
    )
    pairs = [(a, b) for a in range(5) for b in range(5)]
    right = pd.DataFrame(
        {"a": [p[0] for p in pairs], "b": [p[1] for p in pairs], "w": np.linspace(0, 1, len(pairs))}
    )
    _check(jax_engine, engine, left, right, how)


def test_float_key_and_nan_never_matches(jax_engine, engine):
    # arrow keeps NaN as a value → device-resident float key with NaN
    left = pa.table({"k": pa.array([1.0, 2.0, np.nan, 4.0]), "v": pa.array([10.0, 20.0, 30.0, 40.0])})
    right = pa.table({"k": pa.array([1.0, np.nan, 4.0]), "w": pa.array([0.1, 0.2, 0.4])})
    got, _ = _check(jax_engine, engine, left, right, "inner")
    g = _sorted(got.as_pandas())
    # NaN keys never match (SQL NULL semantics)
    assert g["k"].tolist() == [1.0, 4.0] and g["w"].tolist() == [0.1, 0.4]


def test_non_unique_right(jax_engine, engine, fact):
    dup = pd.DataFrame({"k": [1, 1, 2], "w": [0.1, 0.2, 0.3]})
    _check(jax_engine, engine, fact, dup, "inner")


@pytest.mark.parametrize("how", ["inner", "left_outer", "semi", "anti"])
def test_shuffle_strategy(jax_engine, engine, monkeypatch, how):
    """The JAX engine's shuffle path (a tiny broadcast threshold) against
    the port's one form, the right side whole."""
    monkeypatch.setattr(oj, "MAX_BROADCAST_ROWS", 8)
    rng = np.random.default_rng(3)
    left = pd.DataFrame({"k": rng.integers(0, 200, 1000), "v": rng.random(1000)})
    right = pd.DataFrame({"k": np.arange(150), "w": rng.random(150)})
    _check(jax_engine, engine, left, right, how)


@pytest.mark.parametrize("how", ["right_outer", "full_outer"])
def test_right_and_full_outer(jax_engine, engine, fact, dim, how):
    _check(jax_engine, engine, fact, dim, how)


class TestEncodedJoins:
    """String keys (dictionary unification), encoded/nullable value columns,
    and left_outer NULL-fill for every representation."""

    def test_string_key_inner_join(self, jax_engine, engine):
        left = pd.DataFrame(
            {"s": ["apple", "pear", "fig", "apple", None], "v": [1.0, 2.0, 3.0, 4.0, 5.0]}
        )
        right = pd.DataFrame({"s": ["apple", "fig", "kiwi", None], "w": [0.1, 0.3, 0.9, 0.7]})
        _check(jax_engine, engine, left, right, "inner")

    @pytest.mark.parametrize("how", ["inner", "left_outer", "semi", "anti"])
    def test_string_key_all_types(self, jax_engine, engine, how):
        rng = np.random.default_rng(4)
        words = ["a", "bb", "ccc", "dddd", "e f", None]
        left = pd.DataFrame({"s": rng.choice(words[:5], 300).tolist(), "v": rng.random(300)})
        right = pd.DataFrame({"s": ["bb", "dddd", "zz"], "w": [1.0, 2.0, 3.0]})
        _check(jax_engine, engine, left, right, how)

    def test_left_outer_int_values_on_device(self, jax_engine, engine):
        left = pd.DataFrame({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]})
        right = pd.DataFrame({"k": [1, 3], "w": [10, 30]})  # int values
        got, _ = _check(jax_engine, engine, left, right, "left_outer")
        assert "w" in got.null_masks

    @pytest.mark.parametrize("how", ["inner", "left_outer"])
    def test_string_value_columns(self, jax_engine, engine, how):
        left = pd.DataFrame({"k": [1, 2, 3, 4], "v": [1.0, 2.0, 3.0, 4.0]})
        right = pd.DataFrame({"k": [1, 3], "name": ["one", "three"]})
        got, exp = _check(jax_engine, engine, left, right, how)
        assert got.encodings["name"]["kind"] == "dict"
        assert got.encodings["name"]["dictionary"].equals(exp.encodings["name"]["dictionary"])

    @pytest.mark.parametrize("how", ["inner", "left_outer"])
    def test_nullable_value_columns(self, jax_engine, engine, how):
        left = pd.DataFrame({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]})
        right = pd.DataFrame({"k": [1, 2], "w": pd.array([10, None], dtype="Int32")})
        got, _ = _check(jax_engine, engine, left, right, how)
        assert "w" in got.null_masks

    @pytest.mark.parametrize("how", ["inner", "left_outer", "semi", "anti"])
    def test_nullable_int_key(self, jax_engine, engine, how):
        left = pd.DataFrame({"k": pd.array([1, None, 3, 4], dtype="Int32"), "v": [1.0, 2.0, 3.0, 4.0]})
        right = pd.DataFrame({"k": pd.array([1, 4, None], dtype="Int32"), "w": [0.1, 0.4, 0.9]})
        # NULL keys never match (SQL), even NULL vs NULL
        _check(jax_engine, engine, left, right, how)

    @pytest.mark.parametrize("how", ["inner", "left_outer", "semi", "anti"])
    def test_datetime_key(self, jax_engine, engine, how):
        d = pd.to_datetime
        left = pd.DataFrame({"t": d(["2020-01-01", "2020-02-01", "2020-03-01"]), "v": [1.0, 2.0, 3.0]})
        right = pd.DataFrame({"t": d(["2020-02-01", "2020-04-01"]), "w": [0.2, 0.4]})
        _check(jax_engine, engine, left, right, how)


@pytest.mark.parametrize("case", ["float-int", "int32-int64", "float-int-left-outer"])
def test_join_mixed_key_dtypes_match_by_value(jax_engine, engine, case):
    """Cross-dtype join keys coerce to the common type (pandas/SQL
    semantics): float 2.0 matches int 2; 1.5/2.7 match nothing; int32
    joins int64 exactly."""
    big = pd.DataFrame({"k": [1.5, 2.0, 2.7], "v": [1.0, 2.0, 3.0]})
    dim = pd.DataFrame({"k": [1, 2], "w": [10.0, 20.0]})
    if case == "float-int":
        got, _ = _check(jax_engine, engine, big, dim, "inner")
        r = got.as_pandas()
        assert len(r) == 1 and r["v"].iloc[0] == 2.0 and r["w"].iloc[0] == 20.0
    elif case == "int32-int64":
        a = pd.DataFrame({"k": np.array([1, 2, 3], np.int32), "v": [1.0, 2.0, 3.0]})
        b = pd.DataFrame({"k": np.array([2, 3, 4], np.int64), "w": [5.0, 6.0, 7.0]})
        got, _ = _check(jax_engine, engine, a, b, "inner")
        assert sorted(got.as_pandas()["v"]) == [2.0, 3.0]
    else:
        got, _ = _check(jax_engine, engine, big, dim, "left_outer")
        r = got.as_pandas().sort_values("v")
        assert len(r) == 3 and list(r["w"].isna()) == [True, False, True]


# ---- the cases of tests/jax_engine/test_expand_join.py --------------------


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_semi", "left_anti"])
def test_duplicate_right_keys_all_types(jax_engine, engine, how):
    left = pd.DataFrame({"k": [1, 2, 3, 4], "a": [10.0, 20.0, 30.0, 40.0]})
    right = pd.DataFrame({"k": [1, 1, 2, 2, 2, 9], "b": [1.0, 2.0, 3.0, 4.0, 5.0, 9.0]})
    _check(jax_engine, engine, left, right, how)


@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_n_to_m_duplicates(jax_engine, engine, how):
    left = pd.DataFrame({"k": [1, 1, 1, 2, 2], "a": range(5)})
    right = pd.DataFrame({"k": [1, 1, 2, 2, 2], "b": range(10, 15)})
    _check(jax_engine, engine, left, right, how)


def test_random_large_nm(jax_engine, engine):
    rng = np.random.default_rng(0)
    left = pd.DataFrame({"k": rng.integers(0, 50, 5000), "a": rng.random(5000)})
    right = pd.DataFrame({"k": rng.integers(0, 60, 2000), "b": rng.random(2000)})
    got, _ = _check(jax_engine, engine, left, right, "inner")
    assert got.count() > 100_000  # genuinely expanded


@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_multi_key_duplicates(jax_engine, engine, how):
    left = pd.DataFrame({"x": [1, 1, 2, 2], "y": [0, 1, 0, 1], "a": [1.0, 2.0, 3.0, 4.0]})
    right = pd.DataFrame({"x": [1, 1, 2], "y": [0, 0, 1], "b": [9.0, 8.0, 7.0]})
    _check(jax_engine, engine, left, right, how)


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_anti"])
def test_null_keys_with_duplicates(jax_engine, engine, how):
    # NULL keys never match even when the right side has duplicates
    left = pd.DataFrame({"k": [1.0, np.nan, 2.0], "a": [1.0, 2.0, 3.0]})
    right = pd.DataFrame({"k": [1.0, 1.0, np.nan, np.nan], "b": [5.0, 6.0, 7.0, 8.0]})
    _check(jax_engine, engine, left, right, how)


def test_right_outer_device(jax_engine, engine):
    left = pd.DataFrame({"k": [1, 2, 3], "a": [1.0, 2.0, 3.0]})
    right = pd.DataFrame({"k": [2, 2, 4], "b": [5.0, 6.0, 7.0]})
    _check(jax_engine, engine, left, right, "right_outer")


def test_full_outer_device(jax_engine, engine):
    left = pd.DataFrame({"k": [1, 2], "s": ["a", "b"], "n": [100, 200]})
    right = pd.DataFrame({"k": [2, 3, 3], "w": [5.0, 6.0, 7.0]})
    got, _ = _check(jax_engine, engine, left, right, "full_outer")
    # right-only rows carry NULL left values in every representation
    g = got.as_pandas()
    only3 = g[g["k"] == 3]
    assert len(only3) == 2 and only3["s"].isna().all() and only3["n"].isna().all()


def test_full_outer_random(jax_engine, engine):
    rng = np.random.default_rng(7)
    left = pd.DataFrame({"k": rng.integers(0, 30, 500), "a": rng.random(500)})
    right = pd.DataFrame({"k": rng.integers(10, 40, 400), "b": rng.random(400)})
    _check(jax_engine, engine, left, right, "full_outer")


def test_cross_join_device(jax_engine, engine):
    left = pd.DataFrame({"x": [1, 2, 3], "s": ["p", "q", "r"]})
    right = pd.DataFrame({"y": [10.0, 20.0], "m": [1, 2]})
    got, _ = _check(jax_engine, engine, left, right, "cross")
    assert got.count() == 6


# ---- beyond the reference's own cases --------------------------------------


def test_full_outer_unions_two_dictionaries_and_masks(jax_engine, engine):
    """full_outer over string keys whose dictionaries differ, a nullable
    left value and a right int value that gets a generated mask."""
    left = pd.DataFrame({"s": ["b", "d", None, "a"], "n": pd.array([1, None, 3, 4], dtype="Int64")})
    right = pd.DataFrame({"s": ["c", "d", "a", "e", None], "m": [10, 20, 30, 40, 50]})
    got, _ = _check(jax_engine, engine, left, right, "full_outer")
    assert list(got.encodings["s"]["dictionary"].to_pylist()) == ["a", "b", "c", "d", "e"]


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_semi", "left_anti", "right_outer",
                                 "full_outer"])
def test_every_type_over_dates_strings_and_bools(jax_engine, engine, how):
    """Three keys of three kinds (a date, a string, a bool), duplicated on
    the right, with a left host column where rows stay in place."""
    rng = np.random.default_rng(11)
    days = pd.to_datetime(["2021-01-01", "2021-01-02", "2021-01-03"]).date
    left = pd.DataFrame({"d": rng.choice(days, 60), "s": rng.choice(["x", "y", "z"], 60).tolist(),
                         "b": rng.random(60) < 0.5, "v": rng.random(60)})
    right = pd.DataFrame({"d": rng.choice(days, 30), "s": rng.choice(["y", "z", "w"], 30).tolist(),
                          "b": rng.random(30) < 0.5, "w": rng.integers(0, 9, 30)})
    _check(jax_engine, engine, left, right, how)


def test_left_host_columns_ride_along_the_unique_probe(jax_engine, engine):
    left = pa.table({"k": [1, 2, 3, 4],
                     "dec": pa.array([decimal.Decimal(i) for i in range(4)], pa.decimal128(5, 0))})
    right = pd.DataFrame({"k": [2, 4, 6], "w": [0.2, 0.4, 0.6]})
    for how in ("inner", "left_outer", "left_semi", "left_anti"):
        exp = jax_engine.join(jax_engine.to_df(left), jax_engine.to_df(right), how=how)
        got = engine.join(engine.to_df(left), engine.to_df(right), how=how)
        assert got.host_table is not None
        _same(got, exp)


def test_empty_sides(jax_engine, engine):
    left = pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]})
    empty = pd.DataFrame({"k": np.zeros(0, np.int64), "w": np.zeros(0)})
    for how in ("inner", "left_outer", "left_anti", "right_outer", "full_outer"):
        _check(jax_engine, engine, left, empty, how)
        _check(jax_engine, engine, empty, left.rename(columns={"v": "w"}), how)


def test_float_values_of_an_inner_join_keep_their_nulls(jax_engine, engine):
    """ROADMAP.md C6: the JAX engine's inner join gives a right float
    column's NULL back as a NaN value (its frame does not list the column
    as one that may hold NaN, its device NULL); the port, like pandas,
    gives NULL. As pandas frames both read NaN."""
    left = pd.DataFrame({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]})
    right = pd.DataFrame({"k": [1, 2], "w": [np.nan, 5.0]})
    got, exp = _check(jax_engine, engine, left, right, "inner")
    assert exp.as_arrow().column("w").null_count == 0  # the reference: a NaN value
    assert got.as_arrow().column("w").null_count == 1  # the port: NULL
    native = NativeExecutionEngine()
    res = native.join(native.to_df(left), native.to_df(right), how="inner")
    assert res.as_arrow().column("w").null_count == 1


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_anti", "right_outer", "full_outer"])
def test_an_empty_string_key_dictionary(jax_engine, engine, how):
    """ROADMAP.md C8: a side whose string keys are all NULL has an empty
    dictionary. The JAX engine's remap of its codes gathers from a table of
    length 0 and raises; the port answers as the native engine does. The
    empty side is the right one, or the left one for right_outer and
    full_outer."""
    full = pa.table({"k": pa.array(["a", "b"]), "a": pa.array([1, 2], pa.int64())})
    empty = pa.table({"k": pa.array([None], pa.string()), "b": pa.array([5], pa.int64())})
    left, right = (empty, full) if how in ("right_outer", "full_outer") else (full, empty)
    native = NativeExecutionEngine()
    exp = native.join(native.to_df(left), native.to_df(right), how=how)
    got = engine.join(engine.to_df(left), engine.to_df(right), how=how)
    _same(got, exp)
    with pytest.raises(TypeError, match="gather"):
        jax_engine.join(jax_engine.to_df(left), jax_engine.to_df(right), how=how)


def test_right_outer_keeps_the_contract_column_order(jax_engine, engine):
    left = pd.DataFrame({"v": [1.0, 2.0], "k": [1, 2]})
    right = pd.DataFrame({"w": [5.0, 6.0], "k": [2, 3]})
    got, _ = _check(jax_engine, engine, left, right, "right_outer")
    assert got.schema.names == ["v", "k", "w"]


def test_union_remaps_dictionaries_and_concatenates_masks(jax_engine, engine):
    a = pd.DataFrame({"s": ["b", None, "a"], "n": pd.array([1, None, 3], dtype="Int64"), "f": [0.5, np.nan, 1.5]})
    b = pd.DataFrame({"s": ["c", "a"], "n": pd.array([4, 5], dtype="Int64"), "f": [2.5, 3.5]})
    exp = jax_engine.union(jax_engine.to_df(a), jax_engine.to_df(b), distinct=False)
    got = engine.union(engine.to_df(a), engine.to_df(b), distinct=False)
    _same(got, exp)
    assert got.encodings["s"]["dictionary"].to_pylist() == ["a", "b", "c"]
    # distinct=True: the device distinct of the device union
    _same(engine.union(engine.to_df(a), engine.to_df(b)),
          jax_engine.union(jax_engine.to_df(a), jax_engine.to_df(b)))
    # differing schemas: the host engine's union raises, in both
    b2 = b.rename(columns={"f": "g"})
    with pytest.raises(Exception) as jerr:
        jax_engine.union(jax_engine.to_df(a), jax_engine.to_df(b2), distinct=False)
    with pytest.raises(Exception) as terr:
        engine.union(engine.to_df(a), engine.to_df(b2), distinct=False)
    assert type(terr.value).__name__ == type(jerr.value).__name__


# ---- the API ---------------------------------------------------------------


def test_api_join_chains_three_frames(jax_engine):
    a = pd.DataFrame({"k": [1, 2, 3, 4], "a": [1.0, 2.0, 3.0, 4.0]})
    b = pd.DataFrame({"k": [1, 2, 2, 4], "b": [5, 6, 7, 8]})
    c = pd.DataFrame({"k": [2, 4, 5], "c": ["x", "y", "z"]})
    for how in ("inner", "left_outer", "full_outer"):
        exp = fa.join(a, b, c, how=how, engine=jax_engine, as_fugue=True)
        got = api.join(a, b, c, how=how, device="cpu", as_fugue=True)
        _same(got, exp)
    res = api.join(a, b, c, device="cpu")
    assert isinstance(res, pd.DataFrame)
    assert isinstance(api.join(pa.Table.from_pandas(a), b, device="cpu"), pa.Table)
    assert isinstance(api.join(a, TorchExecutionEngine(device="cpu").to_df(b), device="cpu"),
                      TorchDataFrame)


@pytest.mark.parametrize("name", ["semi_join", "anti_join", "inner_join", "left_outer_join",
                                  "right_outer_join", "full_outer_join", "cross_join"])
def test_api_named_joins(jax_engine, name):
    a = pd.DataFrame({"k": [1, 2, 3], "a": [1.0, 2.0, 3.0]})
    b = pd.DataFrame({"k": [2, 3, 3, 5], "b": [5, 6, 7, 8]})
    if name == "cross_join":
        b = b.rename(columns={"k": "kb"})
    exp = getattr(fa, name)(a, b, engine=jax_engine, as_fugue=True)
    got = getattr(api, name)(a, b, device="cpu", as_fugue=True)
    _same(got, exp)


def test_a_join_spans_its_steps(engine, monkeypatch):
    """The engine's spans, in the order they open, recorded by a stand-in
    for ``record_function`` (the card-only tests read them from a real
    trace)."""
    entered = []

    @contextlib.contextmanager
    def record(name):
        entered.append(name)
        yield

    monkeypatch.setattr(te, "record_function", record)
    monkeypatch.setattr(te, "annotate", record)
    left = pd.DataFrame({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]})
    engine.join(engine.to_df(left), engine.to_df(pd.DataFrame({"k": [1, 1], "w": [1.0, 2.0]})),
                how="inner")
    assert entered == ["engine.join", "fugue::join_prep", "fugue::join_probe", "fugue::join_expand"]


def test_user_errors_are_the_reference_errors(jax_engine, engine):
    left = pd.DataFrame({"k": [1], "v": [1.0]})
    right = pd.DataFrame({"k": [1], "v": [2.0]})
    for how, on in (("inner", ["k"]), ("cross", None), ("bogus", None)):
        with pytest.raises(Exception) as exp:
            jax_engine.join(jax_engine.to_df(left), jax_engine.to_df(right), how=how, on=on)
        with pytest.raises(Exception) as got:
            engine.join(engine.to_df(left), engine.to_df(right), how=how, on=on)
        assert type(got.value).__name__ == type(exp.value).__name__
        assert str(got.value) == str(exp.value)


# ---- where the JAX engine joins on its host engine ---------------------------


def _host_case(case: str):
    """``(left, right, how)`` of one case the JAX engine joins on its host."""
    if case == "uint64-key":
        return (pd.DataFrame({"k": np.array([1, 2], np.uint64), "v": [1.0, 2.0]}),
                pd.DataFrame({"k": np.array([2, 3], np.int64), "w": [5.0, 6.0]}), "inner")
    if case == "int64-key-with-nulls":
        return (pd.DataFrame({"k": pd.array([1, None, 3], dtype="Int64"), "v": [1.0, 2.0, 3.0]}),
                pd.DataFrame({"k": [1, 3], "w": [5.0, 6.0]}), "inner")
    if case == "timestamps-of-two-units":
        return (pa.table({"t": pa.array([0, 1], pa.int64()).cast(pa.timestamp("s")), "v": [1.0, 2.0]}),
                pa.table({"t": pa.array([0, 1000], pa.int64()).cast(pa.timestamp("ms")),
                          "w": [5.0, 6.0]}), "inner")
    if case == "decimal-key":
        dec = pa.decimal128(5, 0)
        return (pa.table({"k": pa.array([decimal.Decimal(1), decimal.Decimal(2)], dec), "v": [1.0, 2.0]}),
                pa.table({"k": pa.array([decimal.Decimal(2)], dec), "w": [5.0]}), "inner")
    if case == "right-host-columns":
        return (pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]}),
                pa.table({"k": [2, 3], "d": pa.array([decimal.Decimal(1)] * 2, pa.decimal128(5, 0))}),
                "inner")
    if case == "left-host-columns-expand":
        return (pa.table({"k": [1, 2], "d": pa.array([decimal.Decimal(1)] * 2, pa.decimal128(5, 0))}),
                pd.DataFrame({"k": [2, 2, 3], "w": [5.0, 6.0, 7.0]}), "inner")
    if case == "expansion-past-the-budget":
        # 5 left rows a shard of the JAX engine's 8: 20 slots a shard
        return (pd.DataFrame({"k": np.zeros(40, np.int64), "v": np.arange(40.0)}),
                pd.DataFrame({"k": np.zeros(4, np.int64), "w": np.arange(4.0)}), "inner")
    if case == "full-outer-of-two-key-dtypes":
        # the two parts' key columns differ in dtype: the device union declines
        return (pd.DataFrame({"k": np.array([1, 2], np.int32), "v": [1.0, 2.0]}),
                pd.DataFrame({"k": np.array([2, 3], np.int64), "w": [5.0, 6.0]}), "full_outer")
    if case == "cross-past-broadcast":
        return (pd.DataFrame({"x": [1, 2]}), pd.DataFrame({"y": np.arange(9)}), "cross")
    raise ValueError(case)


HOST_CASES = ["uint64-key", "int64-key-with-nulls", "timestamps-of-two-units", "decimal-key",
              "right-host-columns", "left-host-columns-expand", "expansion-past-the-budget",
              "full-outer-of-two-key-dtypes", "cross-past-broadcast"]


@pytest.mark.parametrize("case", HOST_CASES)
def test_joins_the_reference_sends_to_its_host_raise(jax_engine, engine, monkeypatch, case):
    """Each case is a join the JAX engine makes on its host engine. The
    test keeps the name it had while the port refused them: the port's
    host engine now makes each join at the same place (its spy sees the
    verb the JAX engine's spy sees), and the rows, types and NULLs that
    come back to the device are the JAX engine's."""
    # a budget of 16 slots and a broadcast limit of 8 rows: cases at small size
    monkeypatch.setattr(oj, "MAX_EXPAND_ROWS", 16)
    monkeypatch.setattr(tj, "MAX_EXPAND_ROWS", 16)
    monkeypatch.setattr(te, "MAX_BROADCAST_ROWS", 8)
    left, right, how = _host_case(case)
    # the full_outer case joins on the device and unions the two parts on the host
    verb = "union" if case == "full-outer-of-two-key-dtypes" else "join"
    host = jax_engine._host_engine
    with mock.patch.object(host, verb, wraps=getattr(host, verb)) as spy:
        if case == "cross-past-broadcast":
            monkeypatch.setattr(oj, "MAX_BROADCAST_ROWS", 8)
        exp = jax_engine.join(jax_engine.to_df(left), jax_engine.to_df(right), how=how)
        assert spy.called
    assert exp.count() > 0
    thost = engine._host_engine
    with mock.patch.object(thost, verb, wraps=getattr(thost, verb)) as tspy:
        got = engine.join(engine.to_df(left), engine.to_df(right), how=how)
        assert tspy.call_count == 1
    assert isinstance(got, TorchDataFrame) and got.device == engine.device
    _same(got, exp)


def test_unsigned_keys_stay_on_the_ports_host(jax_engine, engine):
    """Named for the refusal it pinned before the unsigned types above
    uint8 lived on the port's device: both engines join uint16, uint32 and
    uint64 keys on their device (no host join on either), inner, left
    outer, semi and anti, keys at 0 and at the type's top (for uint64
    2**63 - 1, 2**63 and 2**64 - 1), with the same rows."""
    jhost, thost = jax_engine._host_engine, engine._host_engine
    for dt in (np.uint16, np.uint32, np.uint64):
        top = int(np.iinfo(dt).max)
        keys = [0, 1, top // 2, top // 2 + 1, top - 1, top]
        left = pd.DataFrame({"k": np.array(keys + [2, top], dt), "v": np.arange(8, dtype=np.float64)})
        right = pd.DataFrame({"k": np.array([top, top // 2 + 1, 1, 3], dt), "w": [5.0, 6.0, 7.0, 8.0]})
        for how in ("inner", "left_outer", "left_semi", "left_anti"):
            with mock.patch.object(jhost, "join", wraps=jhost.join) as jspy:
                exp = jax_engine.join(jax_engine.to_df(left), jax_engine.to_df(right), how=how)
                assert isinstance(exp, JaxDataFrame) and not jspy.called
            with mock.patch.object(thost, "join", wraps=thost.join) as tspy:
                got = engine.join(engine.to_df(left), engine.to_df(right), how=how)
                assert isinstance(got, TorchDataFrame) and not tspy.called
            _same(got, exp)


# ---- chip_smoke.py's join_path cells, at small size -------------------------


# the phase with the torch.cuda calls it makes as no-ops, in a process of
# its own that loads no JAX, as chip_smoke.py runs on the card
_JOIN_PATH_ON_THE_CPU = """
import json, numpy as np, pyarrow as pa, torch
import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine, frame_from_numpy
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache", "set_sync_debug_mode"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
out = chip_smoke.phase_join_path(torch, np, pa, bg, api, ff, col, frame_from_numpy,
                                 TorchExecutionEngine(device="cpu"), 0, 64_000, 16_000, 16_000)
print("RESULT", json.dumps(out["cells"]))
"""


def test_chip_smoke_join_path_on_the_cpu():
    """The four cells at ~64k rows, each through its oracle, one line each;
    B1/B2 are not launched on this path."""
    res = subprocess.run([sys.executable, "-c", _JOIN_PATH_ON_THE_CPU], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert sum(ln.startswith('{"phase": "join_path"') for ln in res.stdout.splitlines()) == 5
    cells = json.loads(res.stdout.split("RESULT ", 1)[1])
    assert sorted(cells) == ["lineitem-orders-f/anti", "lineitem-orders-f/left_outer",
                             "lineitem-orders-inner/inner", "north-star-100m",
                             "orders-lineitem-expand"]
    for line in cells.values():
        assert line["launches"] == {"bin_sum": 0, "bin_sum_count": 0}
        assert line["bound_ms"] > 0 and line["ms"] > 0 and "profile" in line
    expand = cells["orders-lineitem-expand"]
    assert expand["plan"] == "expand" and expand["rows_out"] == expand["rows_in"][1]


@pytest.fixture(scope="module")
def lineitem_orders():
    tbl, aux = chip_smoke.make_lineitem(np, pa, 0, 4000)
    otbl, oaux = chip_smoke.make_orders(np, pa, tbl, aux, 0)
    oaux["totalprice"] = otbl.column("o_totalprice").to_numpy()
    return tbl, aux, otbl, oaux


def test_make_orders_follows_dbgen(lineitem_orders):
    tbl, aux, otbl, oaux = lineitem_orders
    assert otbl.num_rows == 4000 and len(np.unique(otbl.column("l_orderkey").to_numpy())) == 4000
    cust = otbl.column("o_custkey").to_numpy()
    assert cust.min() >= 1 and cust.max() <= 400 and not (cust % 3 == 0).any()
    status = otbl.column("o_orderstatus").to_pylist()
    line_open = np.bincount(aux["order"], weights=aux["status"], minlength=4000)
    lines = np.bincount(aux["order"], minlength=4000)
    exp = np.where(line_open == 0, "F", np.where(line_open == lines, "O", "P"))
    assert status == exp.tolist()
    assert set(otbl.column("o_orderpriority").to_pylist()) <= set(chip_smoke.ORDERPRIORITIES)
    net = tbl.column("l_extendedprice").to_numpy() * (1 - tbl.column("l_discount").to_numpy().astype(np.float64))
    np.testing.assert_allclose(np.bincount(aux["order"], weights=net), oaux["totalprice"])


@pytest.mark.parametrize("how", ["inner", "left_outer", "anti"])
def test_chip_smoke_orders_oracle_rejects_a_wrong_join(engine, lineitem_orders, how):
    """The oracle of the lineitem/orders cells passes the port's answer and
    fails another join's."""
    tbl, aux, otbl, oaux = lineitem_orders
    only_f = how != "inner"
    right = otbl.filter(pa.array(oaux["status"] == 0)) if only_f else otbl
    left = engine.to_df(tbl)
    res = api.join(left, engine.to_df(right), how=how, on=["l_orderkey"], engine=engine)
    chip_smoke.check_orders_join(np, res, how, aux, oaux, only_f=only_f)
    wrong = api.join(left, engine.to_df(otbl if only_f else right.slice(1)), how=how,
                     on=["l_orderkey"], engine=engine)
    with pytest.raises(RuntimeError, match="lineitem"):
        chip_smoke.check_orders_join(np, wrong, how, aux, oaux, only_f=only_f)


def test_chip_smoke_expand_and_north_star_oracles_reject_wrong_answers(engine, lineitem_orders):
    tbl, aux, otbl, oaux = lineitem_orders
    odf, ldf = engine.to_df(otbl), engine.to_df(tbl)
    res = api.join(odf, ldf, how="inner", on=["l_orderkey"], engine=engine)
    chip_smoke.check_expand(np, pa, res, tbl, aux, oaux)
    short = api.join(odf, engine.to_df(tbl.slice(1)), how="inner", on=["l_orderkey"], engine=engine)
    with pytest.raises(RuntimeError, match="expand"):
        chip_smoke.check_expand(np, pa, short, tbl, aux, oaux)
    cols = chip_smoke.north_star_frame(np, 5000, 0)
    steps = chip_smoke.north_star_steps(torch, api, ff, col, engine)
    tdf = frame_from_numpy(cols, "k:long,v:double", nan_cols=(), device="cpu")
    got = steps["transform"](steps["join"](tdf, steps["aggregate"](tdf))).as_arrow()
    chip_smoke.check_north_star(np, got, cols)
    with pytest.raises(RuntimeError, match="north-star"):
        chip_smoke.check_north_star(np, got.set_column(1, "d", pa.array(got.column("d").to_numpy() + 1e-3)), cols)
