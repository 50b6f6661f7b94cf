"""The port's streaming paths (``fugue_tpu_torch/torch/streaming.py``,
``device="cpu"``) against ``JaxExecutionEngine`` (the 8-device CPU mesh)
on the same numpy chunks, each package's chunks in its own stream frame.

The cases are the main-path ones of ``tests/jax_engine/test_streaming.py``
(aggregate, compiled map, parquet, join, keyed map), the north star's
chain at 2·10^5 rows and a bounded-memory run at 10^6 rows. Both engines
stream chunks of 4096 rows. Exact: keys, counts, MIN/MAX, row sets, NULL
placement, refusals and schemas; floats with pandas' ``assert_frame_equal``
default (``rtol=1e-5``), as the reference's tests compare (the
north-star chain's ``d`` with ``atol=1e-9``).
"""

import json
import subprocess
import sys
from pathlib import Path
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import fugue_tpu.api as fa
from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
from fugue_tpu.dataframe import PandasDataFrame as JPandasDataFrame
from fugue_tpu.exceptions import FugueInvalidOperation as JInvalid
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu.jax import group_ops as jgo
from fugue_tpu.jax import streaming as jstreaming
from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.constants import (
    FUGUE_TPU_CONF_STREAM_CHUNK_ROWS,
    FUGUE_TPU_CONF_STREAM_KEY_RANGE,
)
from fugue_tpu_torch.dataframe import (
    ArrowDataFrame,
    LocalDataFrameIterableDataFrame,
    PandasDataFrame,
)
from fugue_tpu_torch.exceptions import FugueInvalidOperation
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from fugue_tpu_torch.torch import group_ops as go
from fugue_tpu_torch.torch import streaming
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 4096
AGGS = [("sv", "sum", "v"), ("n", "count", "v"), ("m", "avg", "v"), ("lo", "min", "v"),
        ("hi", "max", "w")]


def _engines(**conf):
    """(JAX engine, port engine) with the same conf; chunks of 4096 rows."""
    conf = {FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: CHUNK, **conf}
    return JaxExecutionEngine(conf), TorchExecutionEngine(device="cpu", conf=conf)


@pytest.fixture(scope="module")
def engines():
    je, te = _engines()
    yield je, te
    je.stop_engine()


def _slices(tbl: pa.Table, n_chunks: int):
    step = max(1, (tbl.num_rows + n_chunks - 1) // n_chunks)
    return [tbl.slice(s, min(step, tbl.num_rows - s)) for s in range(0, tbl.num_rows, step)]


def _streams(pdf: pd.DataFrame, n_chunks: int):
    """The same arrow chunks as a stream of each package."""
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)
    parts = _slices(tbl, n_chunks)
    j = JStream((JArrowDataFrame(t) for t in parts), schema=JArrowDataFrame(tbl).schema)
    t = LocalDataFrameIterableDataFrame((ArrowDataFrame(t) for t in parts),
                                        schema=ArrowDataFrame(tbl).schema)
    return j, t


def _aggs(which):
    j = [getattr(jff, f)(jcol(c)).alias(n) for n, f, c in which]
    t = [getattr(ff, f)(col(c)).alias(n) for n, f, c in which]
    return j, t


def _sorted(pdf: pd.DataFrame, by=None) -> pd.DataFrame:
    return pdf.sort_values(by or list(pdf.columns)).reset_index(drop=True)


def _same(got, exp, by=None) -> None:
    assert str(got.schema) == str(exp.schema)
    pd.testing.assert_frame_equal(_sorted(got.as_pandas(), by), _sorted(exp.as_pandas(), by),
                                  check_dtype=False)


def _frame(n: int, groups: int, seed: int = 0, with_nan: bool = False) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    v = rng.random(n)
    if with_nan:
        v[rng.random(n) < 0.1] = np.nan
    return pd.DataFrame({"k": rng.integers(0, groups, n), "v": v, "w": rng.integers(-50, 50, n)})


def _aggregate(je, te, pdf, n_chunks, which=AGGS):
    js, ts = _streams(pdf, n_chunks)
    jaggs, taggs = _aggs(which)
    exp = je.aggregate(js, JPartitionSpec(by=["k"]), jaggs)
    got = te.aggregate(ts, PartitionSpec(by=["k"]), taggs)
    return got, exp


# ---- aggregate (test_streaming.py :88-163) ----------------------------------


def test_aggregate_matches_the_reference(engines):
    je, te = engines
    got, exp = _aggregate(je, te, _frame(50_000, 300, seed=1), 13)
    assert isinstance(got, TorchDataFrame)
    _same(got, exp, ["k"])
    assert streaming.last_run_stats["verb"] == "aggregate"
    assert streaming.last_run_stats["rows"] == 50_000
    assert streaming.last_run_stats["chunks"] == jstreaming.last_run_stats["chunks"] >= 13


def test_aggregate_nan_nulls(engines):
    """NaN = NULL in v: out of sum/count/avg/min; an all-NULL group is NULL."""
    je, te = engines
    pdf = _frame(20_000, 50, seed=2, with_nan=True)
    pdf.loc[pdf["k"] == 7, "v"] = np.nan
    got, exp = _aggregate(je, te, pdf, 7)
    _same(got, exp, ["k"])
    assert np.isnan(got.as_pandas().set_index("k").loc[7, "sv"])


def test_aggregate_key_range_conf_and_overflow(engines):
    je, te = engines
    pdf = pd.DataFrame({"k": [5, 6, 900, 5], "v": [1.0, 2.0, 3.0, 4.0], "w": [1, 2, 3, 4]})
    # the first chunk sees keys 5..6: the probed range misses 900
    js, ts = _streams(pdf, 4)
    jaggs, taggs = _aggs(AGGS)
    with pytest.raises(JInvalid, match="outside range"):
        je.aggregate(js, JPartitionSpec(by=["k"]), jaggs)
    with pytest.raises(FugueInvalidOperation, match="outside range"):
        te.aggregate(ts, PartitionSpec(by=["k"]), taggs)
    je2, te2 = _engines(**{FUGUE_TPU_CONF_STREAM_KEY_RANGE: "0,1000"})
    try:
        got, exp = _aggregate(je2, te2, pdf, 4)
        _same(got, exp, ["k"])
    finally:
        je2.stop_engine()


def test_aggregate_null_int_raises(engines):
    je, te = engines
    pdf = pd.DataFrame({"k": [1, 2, 1, 2], "v": [1.0, 2.0, 3.0, 4.0],
                        "w": pd.array([1, None, 3, 4], dtype="Int64")})
    js, ts = _streams(pdf, 2)
    jaggs, taggs = _aggs(AGGS)
    with pytest.raises(JInvalid):
        je.aggregate(js, JPartitionSpec(by=["k"]), jaggs)
    with pytest.raises(FugueInvalidOperation, match="NULL in non-float column 'w'"):
        te.aggregate(ts, PartitionSpec(by=["k"]), taggs)


def test_aggregate_empty_stream(engines):
    je, te = engines
    got, exp = _aggregate(je, te, _frame(10, 3).iloc[:0], 1)
    assert got.count() == exp.count() == 0
    assert str(got.schema) == str(exp.schema)
    assert got.schema.names == ["k", "sv", "n", "m", "lo", "hi"]


def test_ineligible_aggregate_materializes_the_stream(engines):
    """A string value column: both engines read the stream whole and
    aggregate it in memory (the stream was not half read by the plan)."""
    je, te = engines
    got, exp = _aggregate(je, te, pd.DataFrame({"k": [1, 1, 2], "s": ["a", "b", "c"]}), 2,
                          [("n", "count", "s")])
    _same(got, exp)
    assert got.as_pandas().sort_values("k")["n"].tolist() == [2, 1]


def test_aggregate_of_an_unported_plan_raises_before_reading(engines):
    """Named for the refusal it pinned before the unsigned types above
    uint8 lived on the port's device: a stream keyed by uint16, uint32 or
    uint64 aggregates chunk by chunk through the dense plan, as on the
    reference, with the same rows (exact keys and counts, sums within the
    file's tolerance), keys at the top of uint16 and uint32; an unsigned
    value streams too, in its storage. The reference's
    streamed plan reads uint64 keys as float64 (ROADMAP.md C16): past 2**53
    its groups merge, so keys there and across 2**63 are held against
    pandas."""
    je, te = engines
    for dt in (np.uint16, np.uint32, np.uint64):
        top = int(np.iinfo(dt).max)
        base = (1 << 53) - 64 if dt is np.uint64 else top - 49
        pdf = _frame(6_000, 50, seed=7)
        pdf["k"] = (np.uint64(base) + pdf["k"].to_numpy().astype(np.uint64)).astype(dt)
        pdf["u"] = (np.uint64(top - 6) + (pdf["w"].to_numpy() % 7).astype(np.uint64)).astype(dt)
        for which in ([("s", "sum", "v"), ("n", "count", "v")], [("hi", "max", "u"), ("lo", "min", "u")]):
            got, exp = _aggregate(je, te, pdf, 5, which)
            assert isinstance(got, TorchDataFrame)
            _same(got, exp, by=["k"])
            if which[0][1] == "sum":
                assert streaming.last_run_stats["chunks"] == 5
    pdf["k"] = np.uint64((1 << 63) - 25) + pdf["k"].to_numpy() - np.uint64(base)
    got, _ = _aggregate(je, te, pdf, 5, [("s", "sum", "v"), ("n", "count", "v")])
    exp = pdf.groupby("k", as_index=False).agg(s=("v", "sum"), n=("v", "size"))
    g = got.as_pandas().sort_values("k").reset_index(drop=True)
    assert g["k"].tolist() == exp["k"].tolist() and g["n"].tolist() == exp["n"].tolist()
    assert np.allclose(g["s"], exp["s"]) and streaming.last_run_stats["chunks"] == 5


def test_float32_sums_fold_in_float64(engines):
    """B1's float32 tables accumulate across chunks in float64 (as the
    sorted route sums float32, ROADMAP.md C2) and come back as float32."""
    je, te = engines
    pdf = _frame(30_000, 40, seed=5)
    pdf["v"] = pdf["v"].astype(np.float32)
    got, exp = _aggregate(je, te, pdf, 8, [("sv", "sum", "v"), ("m", "avg", "v")])
    _same(got, exp, ["k"])
    oracle = pdf.assign(v=pdf["v"].astype(np.float64)).groupby("k")["v"].sum()
    np.testing.assert_allclose(_sorted(got.as_pandas(), ["k"])["sv"], oracle.to_numpy(), rtol=1e-6)


def test_row_streams_are_not_ported(engines):
    """A row stream (``IterableDataFrame``) is a stream now: the streamed
    aggregate reads it in batches of ``chunk_rows`` rows, as the JAX
    engine does (more below, under take and distinct). A bare iterator is
    no frame of the port, and ``to_df`` refuses it."""
    from fugue_tpu.dataframe import IterableDataFrame as JRows

    from fugue_tpu_torch.dataframe import IterableDataFrame

    je, te = engines
    pdf = _frame(10_000, 40, seed=4)
    rows = pdf.values.tolist()
    schema = "k:long,v:double,w:long"
    assert streaming.is_stream_frame(IterableDataFrame(rows, schema))
    jaggs, taggs = _aggs(AGGS)
    exp = je.aggregate(JRows(rows, schema), JPartitionSpec(by=["k"]), jaggs)
    got = te.aggregate(IterableDataFrame(rows, schema), PartitionSpec(by=["k"]), taggs)
    _same(got, exp, by=["k"])
    assert streaming.last_run_stats["chunks"] == 3  # 10,000 rows in batches of 4,096
    with pytest.raises(NotImplementedError, match="not ported"):
        te.aggregate(iter([[1, 2.0]]), PartitionSpec(by=["k"]), [ff.sum(col("v")).alias("s")])


# ---- compiled map (:166) and parquet (:278) ---------------------------------


def _jax_map(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    return {"k": cols["k"], "y": cols["v"] * 2.0 + jnp.abs(cols["w"].astype(jnp.float64))}


def _torch_map(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"k": cols["k"], "y": cols["v"] * 2.0 + torch.abs(cols["w"].to(torch.float64))}


def test_compiled_map_matches_the_reference(engines):
    je, te = engines
    pdf = _frame(30_000, 10, seed=3)
    js, ts = _streams(pdf, 9)
    exp = fa.transform(js, _jax_map, schema="k:long,y:double", engine=je, as_fugue=True)
    got = api.transform(ts, _torch_map, schema="k:long,y:double", engine=te)
    assert isinstance(got, LocalDataFrameIterableDataFrame)
    g, e = got.as_pandas(), exp.as_pandas()
    pd.testing.assert_frame_equal(g, e, check_dtype=False)  # row order too
    assert streaming.last_run_stats["verb"] == "map"
    assert streaming.last_run_stats["chunks"] >= 8


def test_compiled_map_checks_its_output(engines):
    _, te = engines
    _, ts = _streams(_frame(100, 3), 2)

    def short(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"y": cols["v"][:10]}

    with pytest.raises(FugueInvalidOperation, match="row-aligned"):
        api.transform(ts, short, schema="y:double", engine=te).as_pandas()


def test_stream_parquet(engines, tmp_path):
    from fugue_tpu.jax.streaming import stream_parquet as jstream_parquet

    je, te = engines
    pdf = _frame(10_000, 20, seed=4)
    p = str(tmp_path / "data.parquet")
    pq.write_table(pa.Table.from_pandas(pdf, preserve_index=False), p)
    jaggs, taggs = _aggs(AGGS)
    exp = je.aggregate(jstream_parquet(p, chunk_rows=1024), JPartitionSpec(by=["k"]), jaggs)
    got = te.aggregate(streaming.stream_parquet(p, chunk_rows=1024), PartitionSpec(by=["k"]), taggs)
    _same(got, exp, ["k"])
    assert streaming.last_run_stats["chunks"] == jstreaming.last_run_stats["chunks"] >= 9


# ---- join (:317-:480) -------------------------------------------------------


def _join_frames(n_stream: int = 20_000, n_dim: int = 400, seed: int = 3):
    rng = np.random.default_rng(seed)
    big = pd.DataFrame({"k": rng.integers(0, 500, n_stream), "v": rng.random(n_stream)})
    dim = pd.DataFrame({"k": np.arange(n_dim), "w": np.arange(n_dim) * 1.5,
                        "c": np.arange(n_dim, dtype=np.int64) * 3, "flag": np.arange(n_dim) % 2 == 0})
    return big, dim


def _join(conf_chunk, stream_pdf, n_chunks, build_pdf, how, stream_left=True):
    je, te = _engines(**{FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: conf_chunk})
    try:
        js, ts = _streams(stream_pdf, n_chunks)
        if stream_left:
            exp = je.join(js, je.to_df(build_pdf), how=how)
            got = te.join(ts, te.to_df(build_pdf), how=how)
        else:
            exp = je.join(je.to_df(build_pdf), js, how=how)
            got = te.join(te.to_df(build_pdf), ts, how=how)
        return got, exp.as_pandas(), str(exp.schema)
    finally:
        je.stop_engine()


def _same_rows(got, exp_pdf, exp_schema) -> pd.DataFrame:
    assert str(got.schema) == exp_schema
    g = got.as_pandas()
    pd.testing.assert_frame_equal(_sorted(g), _sorted(exp_pdf), check_dtype=False)
    return g


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_stream_left(how):
    big, dim = _join_frames()
    got, exp, schema = _join(3000, big, 7, dim, how)
    assert isinstance(got, LocalDataFrameIterableDataFrame)
    _same_rows(got, exp, schema)
    assert streaming.last_run_stats["verb"] == "join"
    assert streaming.last_run_stats["chunks"] >= 7


def test_join_stream_right_outer():
    big, dim = _join_frames()
    got, exp, schema = _join(3000, big, 7, dim, "right", stream_left=False)
    assert isinstance(got, LocalDataFrameIterableDataFrame)
    _same_rows(got, exp, schema)


@pytest.mark.parametrize("dtype", ["float64", "Int64"])
def test_join_nan_keys_never_match(dtype):
    """NaN and NULL stream keys (a float key's NaN, an int key's NULL)."""
    big = pd.DataFrame({"k": pd.array([1, None, 2, None, 9], dtype=dtype), "v": [1.0, 2, 3, 4, 5]})
    dim = pd.DataFrame({"k": pd.array([1, 2], dtype=dtype.lower()), "w": [10.0, 20.0]})
    for how in ("inner", "left"):
        got, exp, schema = _join(4, big, 2, dim, how)
        g = _same_rows(got, exp, schema)
        if how == "inner":
            assert sorted(g["v"]) == [1.0, 3.0]
        else:
            assert list(g.sort_values("v")["w"].isna()) == [False, True, False, True, True]


def test_join_with_duplicate_build_keys_materializes():
    big = pd.DataFrame({"k": [1, 2, 2, 3], "v": [1.0, 2.0, 3.0, 4.0]})
    dup = pd.DataFrame({"k": [2, 2, 3], "w": [5.0, 6.0, 7.0]})
    got, exp, schema = _join(1000, big, 2, dup, "inner")
    assert isinstance(got, TorchDataFrame)  # the in-memory device join's answer
    _same_rows(got, exp, schema)


def test_join_empty_build_side():
    big = pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]})
    empty = pd.DataFrame({"k": pd.Series(dtype=np.int64), "w": pd.Series(dtype=np.float64)})
    for how in ("inner", "left"):
        got, exp, schema = _join(1000, big, 1, empty, how)
        g = _same_rows(got, exp, schema)
        assert len(g) == (0 if how == "inner" else 2) and g["w"].isna().all()


def test_join_string_and_nullable_payloads():
    """Payloads never touch the device: strings and nullable ints keep
    their NULLs; only the key goes to the device."""
    big = pd.DataFrame({"k": [1, 2, 3, 4, 2, 9],
                        "v": pd.array([10, None, 30, 40, 50, 60], dtype="Int64"),
                        "tag": ["a", "b", None, "d", "e", "f"]})
    dim = pd.DataFrame({"k": [1, 2, 3, 5], "name": ["one", "two", None, "five"],
                        "c": pd.array([100, None, 300, 500], dtype="Int64")})
    got, exp, schema = _join(3, big, 2, dim, "left")
    assert isinstance(got, LocalDataFrameIterableDataFrame)
    g = _same_rows(got, exp, schema)
    assert len(g) == 6
    assert streaming.last_run_stats["verb"] == "join"


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32, np.int32])
def test_join_keys_of_other_integer_types(dtype):
    """uint64 probes by its int64 image with the top bit flipped (the
    order of ``unsigned_order``), the narrower unsigned types widened."""
    rng = np.random.default_rng(7)
    base = np.array([0, 1, 5, 2**31 - 1], dtype=np.uint64)
    if dtype == np.uint64:
        base = np.concatenate([base, np.array([2**63, 2**64 - 1], np.uint64)])
    keys = base.astype(dtype)
    big = pd.DataFrame({"k": keys[rng.integers(0, len(keys), 500)], "v": rng.random(500)})
    dim = pd.DataFrame({"k": keys[::2], "w": np.arange(len(keys[::2]), dtype=np.float64)})
    for how in ("inner", "left"):
        got, exp, schema = _join(64, big, 3, dim, how)
        assert isinstance(got, LocalDataFrameIterableDataFrame)
        _same_rows(got, exp, schema)


# ---- keyed map (:580-:700) --------------------------------------------------


def _clustered_frame(n_keys: int = 40, seed: int = 9) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    pdf = pd.DataFrame({"k": np.repeat(np.arange(n_keys), rng.integers(5, 200, n_keys))})
    pdf["v"] = rng.random(len(pdf))
    return pdf


def _clustered_streams(pdf: pd.DataFrame, step: int = 333, schema: str = "k:long,v:double"):
    parts = [pdf.iloc[s : s + step] for s in range(0, len(pdf), step)]
    j = JStream((JPandasDataFrame(p, schema) for p in parts), schema=schema)
    t = LocalDataFrameIterableDataFrame((PandasDataFrame(p, schema) for p in parts), schema=schema)
    return j, t


def _jax_window(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    return {"k": cols["k"], "rn": jgo.row_number(cols), "rs": jgo.running_sum(cols, cols["v"])}


def _torch_window(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"k": cols["k"], "rn": go.row_number(cols), "rs": go.running_sum(cols, cols["v"])}


def _keyed(chunk, js, ts, schema="k:long,rn:long,rs:double"):
    """(the port's, the reference's) windowed stream read as pandas, or the
    exception each raised."""
    je, te = _engines(**{FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: chunk})
    runs = (
        lambda: api.transform(ts, _torch_window, schema=schema,
                              partition=PartitionSpec(by=["k"], presort="v"), engine=te),
        lambda: fa.transform(js, _jax_window, schema=schema,
                             partition=JPartitionSpec(by=["k"], presort="v"), engine=je,
                             as_fugue=True),
    )
    out = []
    try:
        for run in runs:
            try:
                res = run()
                assert type(res).__name__ == "LocalDataFrameIterableDataFrame"
                out.append(res.as_pandas())
            except (FugueInvalidOperation, JInvalid) as ex:
                out.append(ex)
        return out
    finally:
        je.stop_engine()


def _raised(res, exc, match: str) -> None:
    assert isinstance(res, exc) and match in str(res), res


def test_keyed_window_matches_the_reference():
    """ROW_NUMBER and running SUM over a key-clustered stream: chunks are
    cut mid-key and re-batched whole."""
    pdf = _clustered_frame()
    g, e = _keyed(512, *_clustered_streams(pdf))
    pd.testing.assert_frame_equal(_sorted(g, ["k", "rn"]), _sorted(e, ["k", "rn"]), check_dtype=False)
    sp = pdf.sort_values(["k", "v"]).reset_index(drop=True)
    assert (_sorted(g, ["k", "rn"])["rn"].to_numpy() == sp.groupby("k").cumcount().to_numpy() + 1).all()
    assert streaming.last_run_stats["verb"] == "keyed_map"
    assert streaming.last_run_stats["peak_device_bytes"] > 0


def test_keyed_map_of_a_stream_that_is_not_clustered():
    pdf = pd.DataFrame({"k": [1] * 50 + [2] * 50 + [1] * 50, "v": np.random.default_rng(1).random(150)})
    got, exp = _keyed(64, *_clustered_streams(pdf, step=60))
    _raised(exp, JInvalid, "not key-clustered")
    _raised(got, FugueInvalidOperation, "not key-clustered")


def test_keyed_map_key_run_past_the_capacity():
    pdf = pd.DataFrame({"k": [7] * 500 + [8] * 10, "v": np.random.default_rng(2).random(510)})
    got, exp = _keyed(128, *_clustered_streams(pdf, step=100))
    _raised(exp, JInvalid, "exceeds the chunk capacity")
    _raised(got, FugueInvalidOperation, "exceeds the chunk capacity")


def test_keyed_map_refuses_nan_keys_and_strings():
    nan_keys = pd.DataFrame({"k": [1.0, 1.0, np.nan, np.nan], "v": [1.0, 2, 3, 4]})
    got, exp = _keyed(64, *_clustered_streams(nan_keys, schema="k:double,v:double"),
                      schema="k:double,rn:long,rs:double")
    _raised(exp, JInvalid, "NULL/NaN partition keys")
    _raised(got, FugueInvalidOperation, "NULL/NaN partition keys")
    strs = pd.DataFrame({"k": [1, 1], "v": [1.0, 2.0], "s": ["a", "b"]})
    got, exp = _keyed(64, *_clustered_streams(strs, schema="k:long,v:double,s:str"))
    _raised(exp, JInvalid, "numeric/bool columns")
    _raised(got, FugueInvalidOperation, "numeric/bool columns")


# ---- the north star's chain, and the memory bound ---------------------------

NS_ROWS, NS_GROUPS = 200_000, 1000


def _ns_chunks():
    for i in range((NS_ROWS + CHUNK - 1) // CHUNK):
        rng = np.random.default_rng(i)
        n = min(CHUNK, NS_ROWS - i * CHUNK)
        yield pd.DataFrame({"k": rng.integers(0, NS_GROUPS, n), "v": rng.random(n)})


def test_north_star_chain_matches_the_reference():
    """bench.py's ``_north_star`` on both engines at 2·10^5 rows: the
    streamed group means, the streamed join of the means onto every row,
    and the streamed demean; ``d`` row for row within ``atol=1e-9``."""
    conf = {FUGUE_TPU_CONF_STREAM_KEY_RANGE: f"0,{NS_GROUPS - 1}"}
    je, te = _engines(**conf)
    schema = "k:long,v:double"
    try:
        jstream = lambda: JStream((JPandasDataFrame(p, schema) for p in _ns_chunks()), schema=schema)  # noqa: E731
        tstream = lambda: LocalDataFrameIterableDataFrame(  # noqa: E731
            (PandasDataFrame(p, schema) for p in _ns_chunks()), schema=schema)
        jmeans = je.aggregate(jstream(), JPartitionSpec(by=["k"]), [jff.avg(jcol("v")).alias("m")])
        tmeans = te.aggregate(tstream(), PartitionSpec(by=["k"]), [ff.avg(col("v")).alias("m")])
        _same(tmeans, jmeans, ["k"])

        def jdemean(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
            return {"k": cols["k"], "d": cols["v"] - cols["m"]}

        def tdemean(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            return {"k": cols["k"], "d": cols["v"] - cols["m"]}

        exp = fa.transform(je.join(jstream(), jmeans, how="inner"), jdemean,
                           schema="k:long,d:double", engine=je, as_fugue=True)
        got = api.transform(te.join(tstream(), tmeans, how="inner"), tdemean,
                            schema="k:long,d:double", engine=te, as_fugue=True)
        assert isinstance(got, LocalDataFrameIterableDataFrame)
        parts = [p.as_pandas() for p in got.native]
        g = pd.concat(parts, ignore_index=True)
        e = exp.as_pandas()
        assert len(g) == NS_ROWS and abs(g["d"].sum()) < 1.0
        np.testing.assert_array_equal(g["k"].to_numpy(), e["k"].to_numpy())
        np.testing.assert_allclose(g["d"].to_numpy(), e["d"].to_numpy(), rtol=0, atol=1e-9)
        stats = te.pipeline_stats.as_dict()
        assert set(stats["by_verb"]) == {"aggregate", "join", "map"}
        assert stats["by_verb"]["map"]["rows"] == NS_ROWS
    finally:
        je.stop_engine()


def test_aggregate_memory_is_bounded_by_the_chunk():
    """10^6 rows in chunks of 4096: the stream's peak device bytes stay
    below a tenth of the data's."""
    groups, rows = 1000, 1_000_000
    te = TorchExecutionEngine(device="cpu", conf={FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: CHUNK,
                                                  FUGUE_TPU_CONF_STREAM_KEY_RANGE: f"0,{groups - 1}"})

    def gen():
        for i in range(rows // 50_000):
            rng = np.random.default_rng(i)
            yield pd.DataFrame({"k": rng.integers(0, groups, 50_000), "v": rng.random(50_000),
                                "w": rng.integers(-50, 50, 50_000)})

    res = te.aggregate(LocalDataFrameIterableDataFrame(gen(), schema="k:long,v:double,w:long"),
                       PartitionSpec(by=["k"]), _aggs(AGGS)[1])
    got = res.as_pandas()
    assert len(got) == groups and int(got["n"].sum()) == rows
    assert streaming.last_run_stats["rows"] == rows
    assert streaming.last_run_stats["chunks"] == 20 * 13  # 50,000 rows: 12 full chunks, 1 short
    peak = streaming.last_run_stats["peak_device_bytes"]
    assert 0 < peak < rows * 24 / 10, peak


# ---- chip_smoke.py's stream_path, rehearsed on the CPU ----------------------

_STREAM_PATH_ON_THE_CPU = """
import json, sys
import numpy as np, pandas as pd, torch
import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
from fugue_tpu_torch.torch import TorchExecutionEngine
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
out = chip_smoke.phase_stream_path(torch, np, pd, bg, api, ff, col, "cpu", 0,
                                   rows=60_000, chunk=8_000, f32_rows=24_000, check_every=2)
assert "jax" not in sys.modules and not any(m.startswith("fugue_tpu.") for m in sys.modules)
print("RESULT", json.dumps(out["cells"]))
"""


def test_chip_smoke_stream_path_on_the_cpu():
    """The phase's two cells at small size, through their oracles, in a
    process that loads no JAX."""
    res = subprocess.run([sys.executable, "-c", _STREAM_PATH_ON_THE_CPU], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    cells = json.loads(res.stdout.split("RESULT ", 1)[1])
    assert sorted(cells) == ["f32-aggregate", "north-star"]
    ns = cells["north-star"]
    assert ns["rows"] == 60_000 and ns["chunks"] == 8
    assert ns["launches"] == {"bin_sum": 0, "bin_sum_count": 0}
    f32 = cells["f32-aggregate"]  # on the CPU, B1's wrapper takes its plain version
    assert f32["chunks"] == 3 and f32["launches"] == {"bin_sum": 0, "bin_sum_count": 0}


# ---- take and distinct (test_streaming.py :490, :525; test_pipeline.py :180) --


def test_streaming_take_variants():
    rng = np.random.default_rng(5)
    pdf = pd.DataFrame({"k": rng.integers(0, 6, 5000), "v": rng.random(5000)})
    je, te = _engines(**{FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: 700})
    try:
        # no presort: stops reading once it has n rows
        js, ts = _streams(pdf, 10)
        exp, got = je.take(js, 100, presort=""), te.take(ts, 100, presort="")
        _same(got, exp)
        assert got.count() == 100 and streaming.last_run_stats["rows"] < 5000
        # a presort: the running top-n buffer reads every chunk
        js, ts = _streams(pdf, 10)
        exp, got = je.take(js, 5, presort="v desc"), te.take(ts, 5, presort="v desc")
        pd.testing.assert_frame_equal(got.as_pandas(), exp.as_pandas(), check_dtype=False)
        np.testing.assert_array_equal(got.as_pandas()["v"], pdf.sort_values("v", ascending=False).head(5)["v"])
        assert streaming.last_run_stats == {"chunks": 10, "rows": 5000, "peak_device_bytes": 0, "verb": "take"}
        # partition keys: a running head of n rows a key
        js, ts = _streams(pdf, 10)
        exp = je.take(js, 2, presort="v", partition_spec=JPartitionSpec(by=["k"]))
        got = te.take(ts, 2, presort="v", partition_spec=PartitionSpec(by=["k"]))
        _same(got, exp)
        assert got.count() == 12 and isinstance(got, TorchDataFrame)
    finally:
        je.stop_engine()


def test_streaming_distinct():
    pdf = pd.DataFrame({"k": [1, 2, 1, 2, 3, np.nan, np.nan], "s": ["a", "b", "a", "b", "c", "d", "d"]})
    je, te = _engines(**{FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: 2})
    try:
        js, ts = _streams(pdf, 4)
        exp, got = je.distinct(js), te.distinct(ts)
        _same(got, exp)
        assert got.count() == 4  # NaN == NaN
        assert streaming.last_run_stats["verb"] == "distinct" and streaming.last_run_stats["chunks"] == 4
    finally:
        je.stop_engine()


@pytest.mark.parametrize("depth", [0, 2])
def test_take_stops_early_and_stops_the_read_ahead(depth):
    """A take with no presort pulls its first chunk and at most the
    pipeline's read-ahead more; with a presort it reads all and gives
    the same rows at any depth."""
    from fugue_tpu_torch.constants import FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH

    pdf = _frame(40_000, 50, seed=8)
    te = TorchExecutionEngine(device="cpu", conf={FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: CHUNK,
                                                  FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH: depth})
    pulled = [0]

    def counting_stream():
        def gen():
            for s in range(0, len(pdf), CHUNK):
                pulled[0] += 1
                yield PandasDataFrame(pdf.iloc[s: s + CHUNK], "k:long,v:double,w:long")

        return LocalDataFrameIterableDataFrame(gen(), schema="k:long,v:double,w:long")

    res = te.take(counting_stream(), n=7, presort="v desc")
    np.testing.assert_array_equal(res.as_pandas()["v"], pdf.sort_values("v", ascending=False).head(7)["v"])
    assert pulled[0] == 10
    pulled[0] = 0
    res = te.take(counting_stream(), n=5, presort=None)
    pd.testing.assert_frame_equal(res.as_pandas(), pdf.head(5))
    assert pulled[0] <= 1 + depth + 2


def test_row_streams_through_take_and_distinct():
    """``IterableDataFrame`` rows, batched by ``chunk_rows``, through the
    streamed take (its three forms) and distinct, against the JAX engine."""
    from fugue_tpu.dataframe import IterableDataFrame as JRows

    from fugue_tpu_torch.dataframe import IterableDataFrame

    rng = np.random.default_rng(6)
    pdf = pd.DataFrame({"k": rng.integers(0, 5, 3000), "b": rng.integers(0, 3, 3000),
                        "v": rng.integers(0, 10**6, 3000) / 7})
    rows, schema = pdf.values.tolist(), "k:long,b:long,v:double"
    je, te = _engines(**{FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: 500})
    try:
        for kw in (dict(n=10, presort=""), dict(n=10, presort="v desc, k"),
                   dict(n=2, presort="v", partition=["k"])):
            part = kw.pop("partition", None)
            exp = je.take(JRows(rows, schema), **kw,
                          partition_spec=None if part is None else JPartitionSpec(by=part))
            got = te.take(IterableDataFrame(rows, schema), **kw,
                          partition_spec=None if part is None else PartitionSpec(by=part))
            _same(got, exp)
        assert streaming.last_run_stats["chunks"] == 6
        exp = je.distinct(JRows(pdf[["k", "b"]].values.tolist(), "k:long,b:long"))
        got = te.distinct(IterableDataFrame(pdf[["k", "b"]].values.tolist(), "k:long,b:long"))
        _same(got, exp)
        assert got.count() == 15 and streaming.last_run_stats["verb"] == "distinct"
        got = api.take(IterableDataFrame(rows, schema), 3, presort="v", engine=te, as_fugue=True)
        assert isinstance(got, TorchDataFrame) and got.count() == 3
    finally:
        je.stop_engine()


# ---- C21: a keyless aggregate of a one-pass stream ---------------------------


def test_keyless_aggregate_of_a_stream(engines):
    """C21 (ROADMAP.md §C): ``aggregate(stream, no keys, [sum(v), count(v)])``
    over ``v = 1..5`` in chunks of 2. The port reads the stream once and
    answers as pandas does, ``[15.0, 5]``, through the engine verb and
    through a workflow (stream → filter → select → aggregate, the fused
    chain handing the aggregate a stream). The reference hands its keyless
    route the stream it already read, and answers ``[NULL, 0]``."""
    je, te = engines
    pdf = pd.DataFrame({"v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    exp = [float(pdf["v"].sum()), int(pdf["v"].count())]
    js, ts = _streams(pdf, 3)
    jaggs, taggs = _aggs([("s", "sum", "v"), ("n", "count", "v")])
    got = te.aggregate(ts, PartitionSpec(), taggs).as_array()
    ref = je.aggregate(js, JPartitionSpec(), jaggs).as_array()
    assert got == [exp]
    assert len(ref) == 1 and (ref[0][0] is None or np.isnan(ref[0][0])) and ref[0][1] == 0, ref

    from fugue_tpu_torch.workflow import FugueWorkflow

    dag = FugueWorkflow()
    (dag.df(_streams(pdf, 3)[1]).filter(col("v") > 0).select(col("v"))
     .aggregate(s=ff.sum(col("v")), n=ff.count(col("v"))).yield_dataframe_as("r", as_local=True))
    dag.run(te)
    assert dag.yields["r"].result.as_array() == [exp]
