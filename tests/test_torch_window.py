"""Window functions on the port against the JAX package: the cases of
``tests/jax_engine/test_device_window.py`` and
``tests/jax_engine/test_device_window_r3.py``, with
``test_nested_and_edges.py`` ``test_skewed_valid_rows_window_and_group``
and ``execution_suite.py`` ``test_sql_window_over_strings``.

Each SELECT runs on four engines with the same seeded frames: the JAX
package's ``JaxExecutionEngine`` (the 8-device CPU mesh) and
``NativeExecutionEngine``, the port's ``TorchExecutionEngine(device="cpu")``
and ``NativeExecutionEngine``. Wherever the reference test poisons
``fugue_tpu.column.window.eval_window`` for the JAX engine, the port's
``fugue_tpu_torch.column.window.eval_window`` is poisoned for the torch
engine too, so the device plan (``torch/window.py``), not pandas, answers.

The torch engine's result is held against the JAX engine's and the
native oracle's, the port's native engine's against the reference's
native engine's: rows sorted by every column, then
``pd.testing.assert_frame_equal(check_dtype=False)``, the reference
tests' comparison and tolerance (a device RANGE or ROWS frame sums by
prefix-sum differences in another order).
"""

import unittest.mock as mock

import numpy as np
import pandas as pd
import pytest
from torch.profiler import ProfilerActivity, profile

import fugue_tpu.api as fa
import fugue_tpu.column.window as jwindow
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu_torch import api
import fugue_tpu_torch.column.window as twindow
from fugue_tpu_torch.collections.sql import StructuredRawSQL
from fugue_tpu_torch.dataframe import DataFrames, PandasDataFrame
from fugue_tpu_torch.exceptions import FugueSQLSyntaxError
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.torch import TorchExecutionEngine

# the JAX package's result cache would serve a query it ran before
REF_CONF = {"fugue.tpu.cache.enabled": False}


@pytest.fixture(scope="module")
def engines():
    j = JaxExecutionEngine(REF_CONF)
    yield {"jax": j, "jnative": JNativeExecutionEngine(REF_CONF),
           "torch": TorchExecutionEngine(device="cpu"), "native": NativeExecutionEngine()}
    j.stop()


def _pd(res):
    if isinstance(res, pd.DataFrame):
        return res
    return res.to_pandas() if hasattr(res, "to_pandas") else res.as_pandas()


def _boom(*a, **k):  # pragma: no cover
    raise AssertionError("host window evaluator used on the device engine")


def _sorted(pdf: pd.DataFrame, cols) -> pd.DataFrame:
    return pdf.sort_values(list(cols)).reset_index(drop=True)


def _run_all(sql, df, engines, poison=True):
    """The SELECT on the four engines; the device engines' runs with their
    packages' ``eval_window`` poisoned when ``poison``. Returns the torch
    engine's result."""
    def device(module, run):
        if not poison:
            return _pd(run())
        with mock.patch.object(module, "eval_window", _boom):
            return _pd(run())

    ref = device(jwindow, lambda: fa.fugue_sql(sql, df=df, engine=engines["jax"], as_local=True))
    got = device(twindow, lambda: api.fugue_sql(sql, df=df, engine=engines["torch"], as_local=True))
    exp = _pd(fa.fugue_sql(sql, df=df, engine=engines["jnative"], as_local=True))
    nat = _pd(api.fugue_sql(sql, df=df, engine=engines["native"], as_local=True))
    cols = list(exp.columns)
    assert list(got.columns) == list(ref.columns) == list(nat.columns) == cols
    for a, b in ((got, ref), (got, exp), (nat, exp)):
        pd.testing.assert_frame_equal(_sorted(a, cols), _sorted(b, cols), check_dtype=False)
    return got


# ---- tests/jax_engine/test_device_window.py -----------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(13)
    n = 500
    v = rng.random(n)
    v[rng.random(n) < 0.15] = np.nan  # NULLs in the aggregate argument
    return pd.DataFrame(
        {
            "k": rng.integers(0, 9, n),
            "o": rng.integers(0, 50, n),
            # r: a unique tiebreaker: ROW_NUMBER/LAG over tied order keys
            # is legitimately nondeterministic
            "r": rng.permutation(n).astype("int64"),
            "v": v,
        }
    )


@pytest.fixture(scope="module")
def engine_data_nonan():
    rng = np.random.default_rng(14)
    n = 300
    return pd.DataFrame({"k": rng.integers(0, 7, n), "o": rng.integers(0, 40, n), "w": rng.random(n)})


def test_row_number_rank_dense(engines, data):
    _run_all("""
        SELECT k, o, v,
          ROW_NUMBER() OVER (PARTITION BY k ORDER BY o, r) AS rn,
          RANK() OVER (PARTITION BY k ORDER BY o) AS r,
          DENSE_RANK() OVER (PARTITION BY k ORDER BY o) AS dr
        FROM df
        """, data, engines)


def test_lag_lead(engines, data):
    _run_all("""
        SELECT k, o, v,
          LAG(v) OVER (PARTITION BY k ORDER BY o, r) AS l1,
          LAG(v, 2, -1.0) OVER (PARTITION BY k ORDER BY o, r) AS l2,
          LEAD(v) OVER (PARTITION BY k ORDER BY o, r) AS f1,
          LEAD(o, 1, 999) OVER (PARTITION BY k ORDER BY o, r) AS f2
        FROM df
        """, data, engines)


def test_running_aggregates(engines, data):
    frame = "PARTITION BY k ORDER BY o, r ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW"
    _run_all(f"""
        SELECT k, o, v,
          SUM(v) OVER ({frame}) AS rs, COUNT(v) OVER ({frame}) AS rc,
          MIN(v) OVER ({frame}) AS rmin, MAX(v) OVER ({frame}) AS rmax,
          AVG(v) OVER ({frame}) AS ra
        FROM df
        """, data, engines)


def test_range_peers_default_frame(engines, data):
    # ORDER BY without a frame: RANGE UNBOUNDED .. CURRENT, peers share
    _run_all("""
        SELECT k, o,
          SUM(v) OVER (PARTITION BY k ORDER BY o) AS s,
          COUNT(v) OVER (PARTITION BY k ORDER BY o) AS c
        FROM df
        """, data, engines)


def test_whole_partition_aggregates(engines, data):
    _run_all("""
        SELECT k, v,
          SUM(v) OVER (PARTITION BY k) AS s, AVG(v) OVER (PARTITION BY k) AS m,
          MIN(v) OVER (PARTITION BY k) AS lo, MAX(v) OVER (PARTITION BY k) AS hi,
          COUNT(v) OVER (PARTITION BY k) AS c
        FROM df
        """, data, engines)


def test_first_last(engines, engine_data_nonan):
    _run_all("""
        SELECT k, o, w,
          FIRST(w) OVER (PARTITION BY k ORDER BY o, w) AS fv,
          LAST(w) OVER (PARTITION BY k ORDER BY o, w
                        ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS lv
        FROM df
        """, engine_data_nonan, engines)


def test_bounded_rows_frames(engines, data):
    _run_all("""
        SELECT k, o, r, v,
          SUM(v) OVER (PARTITION BY k ORDER BY o, r ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS s3,
          AVG(v) OVER (PARTITION BY k ORDER BY o, r ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS m3,
          COUNT(v) OVER (PARTITION BY k ORDER BY o, r ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING) AS c5
        FROM df
        """, data, engines)


def test_window_after_where(engines, data):
    _run_all("SELECT k, o, ROW_NUMBER() OVER (PARTITION BY k ORDER BY o, r) AS rn FROM df WHERE o > 10",
             data, engines)


def test_desc_order_and_nan_order_keys(engines):
    rng = np.random.default_rng(15)
    n = 200
    o = rng.random(n)
    o[rng.random(n) < 0.1] = np.nan  # NULL order keys rank last
    df = pd.DataFrame({"k": rng.integers(0, 5, n), "o": o, "v": rng.random(n)})
    _run_all("""
        SELECT k, o,
          RANK() OVER (PARTITION BY k ORDER BY o DESC) AS r,
          SUM(v) OVER (PARTITION BY k ORDER BY o DESC) AS s
        FROM df
        """, df, engines)


def test_host_fallback_for_global_window(engines, data):
    _run_all("SELECT o, ROW_NUMBER() OVER (ORDER BY o, r) AS rn FROM df", data, engines, poison=False)


def test_unbounded_to_following_frame(engines, data):
    _run_all("""
        SELECT k, o, v,
          SUM(v) OVER (PARTITION BY k ORDER BY o, r ROWS BETWEEN UNBOUNDED PRECEDING AND 1 FOLLOWING) AS s,
          COUNT(v) OVER (PARTITION BY k ORDER BY o, r ROWS BETWEEN 1 PRECEDING AND UNBOUNDED FOLLOWING) AS c
        FROM df
        """, data, engines)


def test_negative_lag_offset_host_fallback(engines, data):
    # a negative offset flips direction: the device plan declines
    _run_all("SELECT k, o, LAG(v, -1, -99.0) OVER (PARTITION BY k ORDER BY o, r) AS x FROM df",
             data, engines, poison=False)


def test_int_aggregate_schema_fidelity(engines, data):
    """SUM over an int column keeps long on every engine (the device plan
    declines rather than emit double)."""
    sql = "SELECT k, SUM(o) OVER (PARTITION BY k) AS s FROM df"
    outs = {
        "jax": _pd(fa.fugue_sql(sql, df=data, engine=engines["jax"], as_local=True)),
        "jnative": _pd(fa.fugue_sql(sql, df=data, engine=engines["jnative"], as_local=True)),
        "torch": _pd(api.fugue_sql(sql, df=data, engine=engines["torch"], as_local=True)),
        "native": _pd(api.fugue_sql(sql, df=data, engine=engines["native"], as_local=True)),
    }
    assert len({str(o["s"].dtype) for o in outs.values()}) == 1
    exp = _sorted(outs["jnative"], ["k", "s"])
    for o in outs.values():
        pd.testing.assert_frame_equal(_sorted(o, ["k", "s"]), exp)


def test_string_partition_keys_device(engines):
    rng = np.random.default_rng(21)
    n = 300
    df = pd.DataFrame({"g": rng.choice(["alpha", "beta", "gamma", "delta"], n),
                       "o": rng.permutation(n).astype("int64"), "v": rng.random(n)})
    _run_all("""
        SELECT g, o,
          ROW_NUMBER() OVER (PARTITION BY g ORDER BY o) AS rn,
          SUM(v) OVER (PARTITION BY g ORDER BY o) AS rs
        FROM df
        """, df, engines)


def test_string_order_keys_with_nulls_device(engines):
    rng = np.random.default_rng(22)
    n = 200
    s = rng.choice(["a", "bb", "ccc", None], n, p=[0.3, 0.3, 0.3, 0.1])
    df = pd.DataFrame({"k": rng.integers(0, 5, n), "s": pd.array(s, dtype="str"), "v": rng.random(n)})
    _run_all("""
        SELECT k, s,
          RANK() OVER (PARTITION BY k ORDER BY s) AS r,
          DENSE_RANK() OVER (PARTITION BY k ORDER BY s) AS dr
        FROM df
        """, df, engines)


def test_string_order_desc_device(engines):
    rng = np.random.default_rng(23)
    n = 150
    s = rng.choice(["a", "bb", "ccc", None], n, p=[0.3, 0.3, 0.3, 0.1])
    df = pd.DataFrame({"k": rng.integers(0, 4, n), "s": pd.array(s, dtype="str"), "v": rng.random(n)})
    _run_all("SELECT k, s, DENSE_RANK() OVER (PARTITION BY k ORDER BY s DESC) AS dr FROM df", df, engines)


def test_nullable_int_order_key_device(engines):
    rng = np.random.default_rng(24)
    n = 200
    o = pd.array(np.where(rng.random(n) < 0.15, None, rng.integers(0, 40, n)), dtype="Int64")
    df = pd.DataFrame({"k": rng.integers(0, 5, n), "o": o, "v": rng.random(n)})
    _run_all("""
        SELECT k, o,
          RANK() OVER (PARTITION BY k ORDER BY o) AS r,
          SUM(v) OVER (PARTITION BY k ORDER BY o) AS s
        FROM df
        """, df, engines)


def test_nullable_int_aggregate_arg_device(engines):
    rng = np.random.default_rng(25)
    n = 150
    m = pd.array(np.where(rng.random(n) < 0.25, None, rng.integers(0, 100, n)), dtype="Int64")
    df = pd.DataFrame({"k": rng.integers(0, 4, n), "o": rng.permutation(n), "m": m})
    _run_all("""
        SELECT k, o,
          SUM(m) OVER (PARTITION BY k ORDER BY o) AS rs,
          COUNT(m) OVER (PARTITION BY k ORDER BY o) AS rc,
          AVG(m) OVER (PARTITION BY k) AS a
        FROM df
        """, df, engines)


def test_nullable_int_order_desc_device(engines):
    rng = np.random.default_rng(26)
    n = 160
    o = pd.array(np.where(rng.random(n) < 0.2, None, rng.integers(0, 30, n)), dtype="Int64")
    df = pd.DataFrame({"k": rng.integers(0, 4, n), "o": o, "v": rng.random(n)})
    _run_all("""
        SELECT k, o,
          DENSE_RANK() OVER (PARTITION BY k ORDER BY o DESC) AS dr,
          SUM(v) OVER (PARTITION BY k ORDER BY o DESC) AS s
        FROM df
        """, df, engines)


def test_range_current_row_nullable_order_key(engines):
    df = pd.DataFrame({"k": [1, 1, 1, 1], "o": pd.array([1, 1, None, 2], dtype="Int64"),
                       "v": [50.0, 51.0, 100.0, 1.0]})
    r = _run_all("""
        SELECT k, o, v,
          SUM(v) OVER (PARTITION BY k ORDER BY o RANGE BETWEEN CURRENT ROW AND CURRENT ROW) AS s
        FROM df
        """, df, engines, poison=False)
    got = r.sort_values("v")
    assert got[got["v"] == 100.0]["s"].iloc[0] == 100.0  # NULL is its own peer
    assert got[got["v"] == 1.0]["s"].iloc[0] == 1.0


# ---- tests/jax_engine/test_device_window_r3.py --------------------------------


@pytest.fixture(scope="module")
def data3():
    rng = np.random.default_rng(29)
    n = 400
    v = rng.random(n)
    v[rng.random(n) < 0.15] = np.nan
    return pd.DataFrame(
        {
            "k": rng.integers(0, 7, n),
            "o": rng.integers(0, 40, n),
            "f": np.round(rng.random(n) * 20, 3),  # a NaN-free float order key
            "r": rng.permutation(n).astype("int64"),
            "iv": rng.integers(-50, 50, n),
            "v": v,
        }
    )


def test_global_rank_and_running(engines, data3):
    _run_all("""
        SELECT o, r, v,
          ROW_NUMBER() OVER (ORDER BY o, r) AS rn,
          RANK() OVER (ORDER BY o) AS rk,
          DENSE_RANK() OVER (ORDER BY o) AS dr,
          SUM(v) OVER (ORDER BY o, r ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS rs,
          LAG(v) OVER (ORDER BY o, r) AS lg
        FROM df
        """, data3, engines)


def test_global_whole_frame_aggregates(engines, data3):
    _run_all("""
        SELECT o, v,
          SUM(v) OVER () AS s, COUNT(v) OVER () AS c, AVG(v) OVER () AS a,
          MIN(v) OVER () AS lo, MAX(v) OVER () AS hi
        FROM df
        """, data3, engines)


def test_global_peers_default_frame(engines, data3):
    _run_all("SELECT o, SUM(v) OVER (ORDER BY o) AS s, COUNT(v) OVER (ORDER BY o) AS c FROM df",
             data3, engines)


def test_range_numeric_offsets_sum_avg_count(engines, data3):
    _run_all("""
        SELECT k, f, v,
          SUM(v) OVER (PARTITION BY k ORDER BY f RANGE BETWEEN 2.5 PRECEDING AND CURRENT ROW) AS s,
          AVG(v) OVER (PARTITION BY k ORDER BY f RANGE BETWEEN 1.0 PRECEDING AND 1.0 FOLLOWING) AS a,
          COUNT(v) OVER (PARTITION BY k ORDER BY f RANGE BETWEEN CURRENT ROW AND 3.0 FOLLOWING) AS c
        FROM df
        """, data3, engines)


def test_range_numeric_offsets_min_max(engines, data3):
    _run_all("""
        SELECT k, f, v,
          MIN(v) OVER (PARTITION BY k ORDER BY f RANGE BETWEEN 2.0 PRECEDING AND 2.0 FOLLOWING) AS lo,
          MAX(v) OVER (PARTITION BY k ORDER BY f RANGE BETWEEN 1.5 PRECEDING AND CURRENT ROW) AS hi
        FROM df
        """, data3, engines)


def test_range_numeric_offsets_desc(engines, data3):
    _run_all("""
        SELECT k, f, v,
          MAX(v) OVER (PARTITION BY k ORDER BY f DESC RANGE BETWEEN 1.5 PRECEDING AND CURRENT ROW) AS hi,
          SUM(v) OVER (PARTITION BY k ORDER BY f DESC RANGE BETWEEN 2.0 PRECEDING AND 1.0 FOLLOWING) AS s
        FROM df
        """, data3, engines)


def test_range_offsets_int_order_key(engines, data3):
    _run_all("""
        SELECT k, o, v,
          SUM(v) OVER (PARTITION BY k ORDER BY o RANGE BETWEEN 5 PRECEDING AND CURRENT ROW) AS s,
          MAX(v) OVER (PARTITION BY k ORDER BY o RANGE BETWEEN CURRENT ROW AND 4 FOLLOWING) AS hi
        FROM df
        """, data3, engines)


def test_range_empty_windows(engines, data3):
    # frames strictly ahead of the current value can be empty: NULL / 0
    _run_all("""
        SELECT k, f, v,
          SUM(v) OVER (PARTITION BY k ORDER BY f RANGE BETWEEN 90.0 FOLLOWING AND 99.0 FOLLOWING) AS s,
          COUNT(v) OVER (PARTITION BY k ORDER BY f RANGE BETWEEN 90.0 FOLLOWING AND 99.0 FOLLOWING) AS c
        FROM df
        """, data3, engines)


def test_rows_bounded_min_max(engines, data3):
    _run_all("""
        SELECT k, o, r, v,
          MIN(v) OVER (PARTITION BY k ORDER BY o, r ROWS BETWEEN 3 PRECEDING AND CURRENT ROW) AS m1,
          MAX(v) OVER (PARTITION BY k ORDER BY o, r ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING) AS m2,
          MIN(v) OVER (PARTITION BY k ORDER BY o, r ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) AS m3,
          MAX(v) OVER (PARTITION BY k ORDER BY o, r ROWS BETWEEN 1 FOLLOWING AND 3 FOLLOWING) AS m4
        FROM df
        """, data3, engines)


def test_bounded_frames_over_int_arg(engines, data3):
    # the host computes bounded frames in float64 and casts back to long
    _run_all("""
        SELECT k, o, r, iv,
          SUM(iv) OVER (PARTITION BY k ORDER BY o, r ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS s,
          MIN(iv) OVER (PARTITION BY k ORDER BY o, r ROWS BETWEEN 3 PRECEDING AND 1 PRECEDING) AS lo,
          MAX(iv) OVER (PARTITION BY k ORDER BY o RANGE BETWEEN 2 PRECEDING AND CURRENT ROW) AS hi
        FROM df
        """, data3, engines)


def test_global_range_offsets(engines, data3):
    _run_all("""
        SELECT f, v,
          SUM(v) OVER (ORDER BY f RANGE BETWEEN 3.0 PRECEDING AND CURRENT ROW) AS s,
          MIN(v) OVER (ORDER BY f RANGE BETWEEN 1.0 PRECEDING AND 1.0 FOLLOWING) AS lo
        FROM df
        """, data3, engines)


def test_masked_arg_bounded_frames(engines):
    rng = np.random.default_rng(31)
    n = 300
    iv = rng.integers(0, 100, n).astype("float64")
    iv[rng.random(n) < 0.2] = np.nan
    df = pd.DataFrame({"k": rng.integers(0, 5, n), "o": rng.permutation(n).astype("int64"),
                       "iv": pd.array([None if np.isnan(x) else int(x) for x in iv], dtype="Int64")})
    _run_all("""
        SELECT k, o, iv,
          SUM(iv) OVER (PARTITION BY k ORDER BY o ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS s,
          MAX(iv) OVER (PARTITION BY k ORDER BY o ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS hi
        FROM df
        """, df, engines)


def test_zero_offset_range_peer_frames(engines):
    """RANGE CURRENT ROW .. CURRENT ROW is the peer group, within the
    partition: against a brute force, and across the engines."""
    rng = np.random.default_rng(47)
    n = 120
    df = pd.DataFrame({"k": rng.integers(0, 4, n), "o": rng.integers(0, 10, n),  # ties across partitions
                       "v": np.round(rng.random(n), 3)})
    got = _run_all("""
    SELECT k, o, v,
      SUM(v) OVER (PARTITION BY k ORDER BY o RANGE BETWEEN CURRENT ROW AND CURRENT ROW) AS s,
      COUNT(v) OVER (PARTITION BY k ORDER BY o RANGE BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) AS c
    FROM df
    """, df, engines)
    exp_s = df.groupby(["k", "o"])["v"].transform("sum")
    exp_c = df.apply(lambda r: int(((df["k"] == r["k"]) & (df["o"] >= r["o"])).sum()), axis=1)
    cols = ["k", "o", "v", "s", "c"]
    truth = _sorted(df.assign(s=exp_s, c=exp_c), cols)
    pd.testing.assert_frame_equal(_sorted(got, cols)[cols], truth, check_dtype=False)


def test_fractional_range_offsets_are_exact(engines):
    """2.5 PRECEDING stays 2.5: against a hand value."""
    df = pd.DataFrame({"o": [0.0, 2.4, 2.6], "v": [1.0, 10.0, 100.0]})
    got = _run_all("SELECT o, v, SUM(v) OVER (ORDER BY o RANGE BETWEEN 2.5 PRECEDING AND CURRENT ROW) AS s FROM df",
                   df, engines)
    assert {o: s for o, s in zip(got["o"], got["s"])} == {0.0: 1.0, 2.4: 11.0, 2.6: 110.0}


def test_rows_fractional_offsets_raise(engines):
    sql = ("SELECT o, SUM(v) OVER (ORDER BY o ROWS BETWEEN 1.5 PRECEDING AND CURRENT ROW) AS s "
           "FROM df YIELD LOCAL DATAFRAME AS r")
    df = pd.DataFrame({"o": [1.0], "v": [1.0]})
    for e in (engines["torch"], engines["native"]):
        with pytest.raises(FugueSQLSyntaxError):
            api.fugue_sql(sql, df=df, engine=e)


def test_bounded_int32_arg_keeps_declared_type(engines):
    """SUM over an int32 column in a bounded frame comes back int32."""
    from fugue_tpu.dataframe import PandasDataFrame as JPandasDataFrame

    df = pd.DataFrame({"k": [1, 1, 2, 2], "o": [1, 2, 1, 2], "iv": [5, 6, 7, 8]})
    sql = """
    SELECT k, o, SUM(iv) OVER (PARTITION BY k ORDER BY o ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) AS s FROM df
    """
    with mock.patch.object(jwindow, "eval_window", _boom):
        ref = fa.fugue_sql(sql, df=JPandasDataFrame(df, "k:long,o:long,iv:int"), engine=engines["jax"],
                           as_local=True, as_fugue=True)
    outs = [ref]
    with mock.patch.object(twindow, "eval_window", _boom):
        outs.append(api.fugue_sql(sql, df=PandasDataFrame(df, "k:long,o:long,iv:int"), engine=engines["torch"],
                                  as_local=True, as_fugue=True))
    outs.append(api.fugue_sql(sql, df=PandasDataFrame(df, "k:long,o:long,iv:int"), engine=engines["native"],
                              as_local=True, as_fugue=True))
    for o in outs:
        assert str(o.schema["s"].type) == "int32"
        pd.testing.assert_frame_equal(_sorted(o.as_pandas(), ["k", "o"]), _sorted(ref.as_pandas(), ["k", "o"]),
                                      check_dtype=False)


def test_zero_offset_range_on_empty_frame(engines):
    """The host peer branch on a 0-row frame; the device plan on it too."""
    df = pd.DataFrame({"o": pd.Series([], dtype="float64"), "v": pd.Series([], dtype="float64")})
    sql = ("SELECT o, SUM(v) OVER (ORDER BY o RANGE BETWEEN CURRENT ROW AND CURRENT ROW) AS s "
           "FROM df YIELD LOCAL DATAFRAME AS r")
    assert len(_pd(fa.fugue_sql(sql, df=df, engine=engines["jnative"], as_local=True))) == 0
    for e in (engines["torch"], engines["native"]):
        res = _pd(api.fugue_sql(sql, df=df, engine=e, as_local=True))
        assert len(res) == 0 and list(res.columns) == ["o", "s"]


def test_host_fallback_still_covers_nan_order_keys(engines, data3):
    # RANGE offsets over a maybe-NaN order key decline to the host
    _run_all("""
        SELECT k, fn, o,
          SUM(o) OVER (PARTITION BY k ORDER BY fn RANGE BETWEEN 1.0 PRECEDING AND CURRENT ROW) AS s
        FROM df
        """, data3.assign(fn=data3["v"]), engines, poison=False)


def test_masked_int64_running_windows_exact_at_2pow62(engines):
    """Nullable int64 running, whole and peer aggregates are exact at 2^62
    (wrapping as int64 cumsum does), the device plan proven used."""
    rng = np.random.default_rng(53)
    n = 300
    vals = np.int64(2**62) + rng.integers(-1000, 1000, n).astype(np.int64)
    m = pd.array(np.where(rng.random(n) < 0.2, None, vals), dtype="Int64")
    df = pd.DataFrame({"k": rng.integers(0, 4, n), "o": rng.permutation(n).astype("int64"),
                       "ot": rng.integers(0, 8, n), "m": m})
    got = _run_all("""
        SELECT k, o, m,
          SUM(m) OVER (PARTITION BY k ORDER BY o ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS rs,
          MIN(m) OVER (PARTITION BY k ORDER BY o ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS rmin,
          MAX(m) OVER (PARTITION BY k) AS wmax,
          AVG(m) OVER (PARTITION BY k ORDER BY o) AS ra
        FROM df
        """, df, engines)
    for k in sorted(df["k"].unique()):
        exact = sum(int(x) for x in df[df["k"] == k]["m"].dropna())
        wrapped = (exact + 2**63) % 2**64 - 2**63
        assert int(got[got["k"] == k].sort_values("o")["rs"].iloc[-1]) == wrapped


def test_masked_int64_peers_frame_exact(engines):
    rng = np.random.default_rng(59)
    n = 200
    vals = np.int64(2**62) + rng.integers(-500, 500, n).astype(np.int64)
    m = pd.array(np.where(rng.random(n) < 0.15, None, vals), dtype="Int64")
    df = pd.DataFrame({"k": rng.integers(0, 3, n), "o": rng.integers(0, 10, n), "m": m})
    _run_all("""
        SELECT k, o, m,
          SUM(m) OVER (PARTITION BY k ORDER BY o RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS ps
        FROM df
        """, df, engines)


# ---- test_nested_and_edges.py, execution_suite.py -----------------------------


def test_skewed_valid_rows_window_and_group(engines):
    """A filter empties most of the frame; the window is still exact."""
    rng = np.random.default_rng(4)
    pdf = pd.DataFrame({"k": rng.integers(0, 5, 800), "v": rng.random(800)})
    got = _run_all("SELECT k, ROW_NUMBER() OVER (PARTITION BY k ORDER BY v) AS rn FROM df WHERE v < 0.05",
                   pdf, engines)
    sub = pdf[pdf["v"] < 0.05]
    assert len(got) == len(sub)
    assert got.groupby("k")["rn"].max().sum() == len(sub)


def test_sql_window_over_strings(engines):
    """``execution_suite.py`` :683: the engine's SQL facet, string keys."""
    for e in (engines["torch"], engines["native"]):
        df = e.to_df(PandasDataFrame(pd.DataFrame({"g": ["a", "a", "b"], "v": [3.0, 1.0, 2.0]}),
                                     "g:str,v:double"))
        with mock.patch.object(twindow, "eval_window", _boom) if e is engines["torch"] else _nothing():
            res = e.sql_engine.select(DataFrames(t=df), StructuredRawSQL([
                (False, "SELECT g, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v) AS rn FROM "), (True, "t")]))
        assert sorted(res.as_array()) == [["a", 1], ["a", 2], ["b", 1]]


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---- what the port adds ----------------------------------------------------------


PROJECTIONS = [
    "SELECT t.k, RANK() OVER (ORDER BY t.v) AS r FROM df AS t",
    "SELECT x.k, x.v * 2 AS vv, SUM(x.v) OVER (PARTITION BY x.k) AS tot FROM df AS x",
    "SELECT DISTINCT k, SUM(v) OVER (PARTITION BY k) AS tot FROM df",
    "SELECT UPPER(s) AS u, ROW_NUMBER() OVER (ORDER BY v, k) AS rn FROM df WHERE s <> 'c'",
    "SELECT *, DENSE_RANK() OVER (PARTITION BY s ORDER BY v DESC) AS dr FROM df",
    "SELECT CAST(RANK() OVER (PARTITION BY k ORDER BY v) AS double) AS r, v FROM df",
]


@pytest.mark.parametrize("sql", PROJECTIONS, ids=["qualified", "alias_expr", "distinct", "string_fn", "star", "cast"])
def test_projection_shapes(engines, sql):
    """Qualified names, computed and cast columns, DISTINCT and ``*``
    around the OVER columns: the rows of the reference on both port
    engines, and the device plan on the torch engine exactly where the
    JAX engine runs its own (the device plan gathers only the columns
    the projection reads)."""
    rng = np.random.default_rng(9)
    df = pd.DataFrame({"k": rng.integers(0, 4, 40), "v": rng.permutation(40).astype(float),
                       "s": rng.choice(["a", "b", "c"], 40)})
    routes = {}
    for key, module, run in (
        ("ref", jwindow, lambda: fa.fugue_sql(sql, df=df, engine=engines["jax"], as_local=True)),
        ("port", twindow, lambda: api.fugue_sql(sql, df=df, engine=engines["torch"], as_local=True)),
    ):
        with mock.patch.object(module, "eval_window", _boom):
            try:
                run()
                routes[key] = "device"
            except AssertionError:
                routes[key] = "host"
    assert routes["port"] == routes["ref"]
    _run_all(sql, df, engines, poison=False)


@pytest.mark.parametrize("sql", [
    "SELECT k, RANK() OVER (PARTITION BY k ORDER BY v) AS r, d FROM df",
    "SELECT k, FIRST(h) OVER (PARTITION BY k ORDER BY v) AS f FROM df",
    "SELECT k, v, LAG(h, 1, 0.0) OVER (PARTITION BY k ORDER BY v) AS p FROM df",
], ids=["host_column", "float16_first", "float16_lag"])
def test_frames_the_plan_declines(engines, sql):
    """A frame with a host-resident column (decimal), and float16 results,
    which have no arrow type on the device's way out: the JAX engine
    answers on its host (its run returns None after device work for
    float16), the port's plan declines before any device work; the same
    rows, through the pandas evaluator on both."""
    import decimal

    import pyarrow as pa

    rng = np.random.default_rng(10)
    n = 30
    tbl = pa.table({"k": rng.integers(0, 3, n), "v": rng.permutation(n).astype(float),
                    "h": pa.array(rng.random(n).astype(np.float16)),
                    "d": pa.array([decimal.Decimal(i) / 4 for i in range(n)], pa.decimal128(10, 2))})
    calls = {}
    for key, module, run in (
        ("ref", jwindow, lambda: fa.fugue_sql(sql, df=tbl, engine=engines["jax"], as_fugue=True)),
        ("port", twindow, lambda: api.fugue_sql(sql, df=tbl, engine=engines["torch"], as_fugue=True)),
    ):
        real = module.eval_window

        def spy(*a, _key=key, _real=real, **k):
            calls[_key] = calls.get(_key, 0) + 1
            return _real(*a, **k)

        with mock.patch.object(module, "eval_window", spy):
            calls[key + "_rows"] = run().as_arrow()
    assert calls.get("ref", 0) > 0 and calls.get("port", 0) > 0
    got, exp = calls["port_rows"], calls["ref_rows"]
    assert got.schema.equals(exp.schema.remove_metadata() if exp.schema.metadata else exp.schema)
    cols = [c for c in got.column_names if c != "d"]

    def frame(t):  # pandas sorts no float16
        return t.to_pandas().astype({f.name: "float64" for f in t.schema if pa.types.is_float16(f.type)})

    pd.testing.assert_frame_equal(_sorted(frame(got), cols), _sorted(frame(exp), cols))


@pytest.mark.parametrize("sql,span", [
    ("SELECT k, RANK() OVER (PARTITION BY k ORDER BY v) AS r FROM df WHERE v > 0.2", "fugue::window_device"),
    ("SELECT k, LAG(v, -1, 0.0) OVER (PARTITION BY k ORDER BY v) AS x FROM df", "fugue::window_host"),
], ids=["device", "host"])
def test_route_spans(engines, sql, span):
    """Each route of the torch engine opens its span, and only its own."""
    rng = np.random.default_rng(5)
    pdf = pd.DataFrame({"k": rng.integers(0, 5, 100), "v": rng.random(100)})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.fugue_sql(sql, df=pdf, engine=engines["torch"], as_fugue=True)
    keys = {e.key for e in prof.key_averages()}
    other = "fugue::window_host" if span == "fugue::window_device" else "fugue::window_device"
    assert span in keys and other not in keys


def test_device_plan_gathers_what_the_projection_reads(engines):
    """The window frame carries the projection's columns and the window
    columns only, in the sorted order, its invalid rows last."""
    from fugue_tpu_torch.column import col
    from fugue_tpu_torch.sql.parser import parse_select
    from fugue_tpu_torch.torch.window import plan_device_windows, run_device_windows

    rng = np.random.default_rng(6)
    pdf = pd.DataFrame({"k": rng.integers(0, 3, 50), "o": rng.permutation(50), "v": rng.random(50),
                        "s": rng.choice(["x", "y"], 50)})
    e = engines["torch"]
    tdf = e.filter(e.to_df(pdf), col("v") > 0.5)
    node = parse_select("SELECT k, SUM(v) OVER (PARTITION BY k ORDER BY o) AS rs FROM t")
    items = [("__w1__", node.projections[1])]
    work = run_device_windows(e, tdf, plan_device_windows(tdf, items, ["k"]))
    assert work.schema.names == ["k", "__w1__"] and set(work.device_cols) == {"k", "__w1__"}
    valid = work.valid_mask.numpy()
    assert not valid[valid.sum():].any()
    got = work.as_pandas()
    sub = pdf[pdf["v"] > 0.5].sort_values(["k", "o"])
    assert got["k"].tolist() == sub["k"].tolist()
    assert np.allclose(got["__w1__"], sub.groupby("k")["v"].cumsum())


_WINDOW_PATH_ON_THE_CPU = """
import json, numpy as np, pandas as pd, pyarrow as pa, torch
import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
engine = TorchExecutionEngine(device="cpu")
tbl, aux = chip_smoke.make_lineitem(np, pa, 0, 16_000)
tdf = engine.persist(engine.to_df(tbl))
out = chip_smoke.phase_window_path(torch, np, pd, bg, api, engine, tdf, chip_smoke.window_path_arrays(np, tbl))
print("RESULT", json.dumps({c: {k: v for k, v in l.items() if "profile" not in k} for c, l in out["cells"].items()}))
"""


def test_chip_smoke_window_path_on_the_cpu():
    """chip_smoke.py's window_path at ~64k lineitem rows, in a process that
    loads no JAX: both cells through the device route (the pandas
    evaluator poisoned) and their numpy oracles, one line each, B1 and B2
    launched 0 times, and the repartition checks."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", _WINDOW_PATH_ON_THE_CPU], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith('{"phase": "window_path"')]
    assert [ln["cell"] for ln in lines] == ["window-per-order", "window-global"]
    for ln in lines:
        assert ln["launches"] == {"bin_sum": 0, "bin_sum_count": 0} and ln["ms"] > 0 and ln["bound_ms"] > 0
        assert "fugue::window_device" in ln["profile"]["host_spans_ms"]
        assert "fugue::window_host" not in ln["profile"]["host_spans_ms"]
    assert lines[0]["rows_out"] < lines[0]["rows"] == lines[1]["rows_out"]
    assert '"phase": "window_path_end"' in res.stdout and "jax" not in res.stdout


def test_window_path_oracles_against_the_host_engine():
    """chip_smoke.py's numpy oracles of window_path agree with the port's
    host engine (the pandas evaluator) on a small lineitem frame, so the
    card's check holds the device route to the host's semantics."""
    import pyarrow as pa

    import chip_smoke

    tbl, _ = chip_smoke.make_lineitem(np, pa, 1, 3_000)
    oracles = chip_smoke.window_path_oracles(np, chip_smoke.window_path_arrays(np, tbl))
    native = NativeExecutionEngine()
    for cell, query in chip_smoke.window_path_queries().items():
        got = _pd(api.fugue_sql(query, lineitem=tbl, engine=native, as_local=True))
        exp = pd.DataFrame(oracles[cell])
        cols = list(exp.columns)
        pd.testing.assert_frame_equal(_sorted(got, cols), _sorted(exp, cols), check_dtype=False, rtol=1e-9)
