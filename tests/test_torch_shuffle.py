"""The spill ladder (``fugue_tpu_torch/shuffle``, the torch engine's join and
repartition) against the JAX package's (``fugue_tpu/shuffle``, the JAX
engine on the 8-device CPU mesh), case by case.

The cases are every spill case of ``tests/jax_engine/test_shuffle.py``
(:200-552) and every case of ``tests/jax_engine/test_shuffle_pipeline.py``.
Each runs through both packages with the same confs and seeds:
``JaxExecutionEngine`` against ``TorchExecutionEngine(device="cpu")``.
Results are compared as sorted frames; the span's ``strategy``/``reason``,
``explain()``'s join strategies and the deterministic counters
(``partitions``, ``buckets``, ``rows_spilled``, ``bucket_joins``,
``joins_spill``, ``repartitions_spill``, ``spill_dirs_cleaned``) must be
equal. Peak bytes are not compared: the JAX package sums every live array
of its 8-shard padded frames, the port the tensors a pair holds.

Inputs come in two forms. ``device`` is the reference test's own:
``eng.to_df(pdf)``. There the bucket count differs by package, because it
is sized from each engine's estimate of a frame (the JAX engine estimates
a frame it has not ingested yet as rows x columns x 16 bytes, the port
counts a ``TorchDataFrame``'s tensors), so ``buckets`` and
``bucket_joins`` are compared in the ``host`` form only: the same pandas
frame handed to both engines as a host ``PandasDataFrame``, whose
estimate is its pandas bytes in both. The spill repartition's chunks are
compared chunk by chunk, in bucket order, in the ``host`` form.

The multi-device cases of ``test_shuffle.py`` (:29-115, the even/hash/rand
all-to-all exchange) and ``tests/jax_engine/test_skew_shuffle.py`` wait
for the multi-device layout (ROADMAP.md A.7): on one card the port's
``repartition`` moves no row between devices.
"""

import gc
import glob
import os
import types

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import fugue_tpu.constants as jc
import fugue_tpu.shuffle.partitioner as jpart
import fugue_tpu.shuffle.pipeline as jpipe
import fugue_tpu.tuning.tuner as jtuner
from fugue_tpu import FugueWorkflow as JFugueWorkflow
from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.dataframe import ArrowDataFrame as JArrow
from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
from fugue_tpu.dataframe import PandasDataFrame as JPandas
from fugue_tpu.exceptions import FugueTPUError as JError
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu.obs import get_tracer as jtracer
from fugue_tpu.shuffle.strategy import broadcast_max_rows as jbmax

import fugue_tpu_torch.constants as tc
import fugue_tpu_torch.shuffle.partitioner as tpart
import fugue_tpu_torch.shuffle.pipeline as tpipe
import fugue_tpu_torch.tuning.tuner as ttuner
from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame, PandasDataFrame
from fugue_tpu_torch.exceptions import FugueTPUError
from fugue_tpu_torch.obs import get_tracer
from fugue_tpu_torch.shuffle.strategy import broadcast_max_rows
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow

REF = types.SimpleNamespace(
    name="ref", c=jc, part=jpart, pipe=jpipe, tuner=jtuner, Workflow=JFugueWorkflow,
    PartitionSpec=JPartitionSpec, col=jcol, ff=jff, Arrow=JArrow, Stream=JStream, Pandas=JPandas,
    Error=JError, tracer=jtracer, bmax=jbmax, make=lambda conf=None: JaxExecutionEngine(conf or {}),
)
PORT = types.SimpleNamespace(
    name="port", c=tc, part=tpart, pipe=tpipe, tuner=ttuner, Workflow=FugueWorkflow,
    PartitionSpec=PartitionSpec, col=col, ff=ff, Arrow=ArrowDataFrame, Stream=LocalDataFrameIterableDataFrame,
    Pandas=PandasDataFrame, Error=FugueTPUError, tracer=get_tracer, bmax=broadcast_max_rows,
    make=lambda conf=None: TorchExecutionEngine(device="cpu", conf=conf or {}),
)
BOTH = (REF, PORT)

@pytest.fixture(autouse=True)
def _collect():
    """Drop each case's JAX frames before the worker's next test: the JAX
    package's own spill tests read every live array of the process as
    their device peak."""
    yield
    gc.collect()


SPILL_HOWS = ["inner", "left_outer", "left_semi", "left_anti", "right_outer", "full_outer"]
DET = ("partitions", "buckets", "rows_spilled", "bucket_joins", "joins_spill", "repartitions_spill",
       "spill_dirs_cleaned")
# the counters that do not depend on the bucket count
DET_ANY_FORM = ("partitions", "rows_spilled", "joins_spill", "repartitions_spill", "spill_dirs_cleaned")


def _engine(pkg, tmp_path, budget=20_000, bucket=5_000, **conf):
    """The reference suites' spill engine: small budgets, the spill
    directory in the test's own, the device_exchange rung off (its own
    suite is the multi-device layout's)."""
    c = pkg.c
    return pkg.make({
        c.FUGUE_TPU_CONF_SHUFFLE_DEVICE_BUDGET: budget,
        c.FUGUE_TPU_CONF_SHUFFLE_BUCKET_BYTES: bucket,
        c.FUGUE_TPU_CONF_SHUFFLE_DIR: str(tmp_path / pkg.name),
        c.FUGUE_TPU_CONF_SHUFFLE_DEVICE_EXCHANGE_ENABLED: False,
        **conf,
    })


def _in(pkg, eng, pdf, form):
    return eng.to_df(pdf) if form == "device" else pkg.Pandas(pdf)


def _join_frames(n=4000, seed=0, nulls=True, right_keys=None, key_range=None):
    """Repeated keys (the N:M expansion) and NULL keys in one pair of frames."""
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, key_range or (n // 8), n).astype(object)
    rk = rng.integers(0, right_keys or key_range or (n // 8), n).astype(object)
    if nulls:
        lk[::97] = None
        rk[::89] = None
    left = pd.DataFrame({"k": pd.array(lk, dtype="Int64"), "a": rng.normal(size=n)})
    right = pd.DataFrame({"k": pd.array(rk, dtype="Int64"), "b": rng.normal(size=n)})
    return left, right


def _norm(res):
    """Declared-schema arrow values as a sorted pandas frame."""
    tbl = res.as_arrow() if not isinstance(res, pa.Table) else res
    pdf = tbl.replace_schema_metadata(None).to_pandas()
    return pdf.sort_values(list(pdf.columns)).reset_index(drop=True)


def _same(got, exp):
    pd.testing.assert_frame_equal(got, exp[list(got.columns)])


def _counters(st, names=DET):
    return {k: st[k] for k in names}


def _no_spill_dir(tmp_path, pkg):
    return not glob.glob(os.path.join(str(tmp_path / pkg.name), "shuffle-*"))


def _stream(pkg, tbl, step):
    n = tbl.num_rows
    return pkg.Stream(
        (pkg.Arrow(tbl.slice(s, step)) for s in range(0, n, step)), schema=pkg.Arrow(tbl).schema
    )


def _legacy(pkg, left, right, how, on=("k",)):
    off = pkg.make({pkg.c.FUGUE_TPU_CONF_SHUFFLE_ENABLED: False})
    res = _norm(off.join(off.to_df(left), off.to_df(right), how=how, on=list(on)))
    assert off.stats()["shuffle"]["joins_spill"] == 0
    return res


# ===========================================================================
# tests/jax_engine/test_shuffle.py, the spill cases
# ===========================================================================


@pytest.mark.parametrize("form", ["device", "host"])
@pytest.mark.parametrize("how", SPILL_HOWS)
def test_spill_join_parity_vs_legacy(tmp_path, how, form):
    """Every join type that hash-partitions, over repeated and NULL keys:
    the spilled join equals the join without the shuffle, in each package,
    and the two packages agree on rows and counters."""
    left, right = _join_frames()
    out = {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path)
        got = _norm(eng.join(_in(pkg, eng, left, form), _in(pkg, eng, right, form), how=how, on=["k"]))
        st = eng.stats()["shuffle"]
        assert st["joins_spill"] == 1, "spill strategy not used"
        _same(got, _legacy(pkg, left, right, how))
        out[pkg.name] = (got, st)
    _same(out["port"][0], out["ref"][0])
    names = DET if form == "host" else DET_ANY_FORM
    assert _counters(out["port"][1], names) == _counters(out["ref"][1], names)


def test_spill_join_multi_key_and_cross_refusal(tmp_path):
    rng = np.random.default_rng(3)
    n = 3000
    left = pd.DataFrame({"k1": rng.integers(0, 40, n), "k2": rng.integers(0, 7, n), "a": rng.normal(size=n)})
    right = pd.DataFrame({"k1": rng.integers(0, 40, n), "k2": rng.integers(0, 7, n), "b": rng.normal(size=n)})
    exp = _norm(pa.Table.from_pandas(left.merge(right, on=["k1", "k2"]), preserve_index=False))
    stats = {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path)
        got = _norm(eng.join(pkg.Pandas(left), pkg.Pandas(right), how="inner", on=["k1", "k2"]))
        pd.testing.assert_frame_equal(got, exp)
        assert eng.stats()["shuffle"]["joins_spill"] == 1
        # a cross join cannot hash-partition: refused, the rest of the
        # ladder answers
        c = eng.join(eng.to_df(pd.DataFrame({"x": range(10)})), eng.to_df(pd.DataFrame({"y": range(7)})),
                     how="cross")
        assert c.count() == 70
        stats[pkg.name] = eng.stats()["shuffle"]
        assert stats[pkg.name]["joins_spill"] == 1  # unchanged
    assert _counters(stats["port"]) == _counters(stats["ref"])


def test_spill_join_bounded_device_memory(tmp_path):
    """Both sides ~10x the device budget; the pairs' measured peak stays
    under it. The budget gate holds in each package by its own measure."""
    budget = 1 << 20
    rng = np.random.default_rng(1)
    n = 700_000
    left = pd.DataFrame({"k": rng.integers(0, 2_000_000, n), "a": rng.normal(size=n)})
    right = pd.DataFrame({"k": rng.integers(0, 2_000_000, n), "b": rng.normal(size=n)})
    side_bytes = int(left.memory_usage(index=False).sum())
    assert side_bytes >= 10 * budget
    n_exp = len(left.merge(right, on="k"))
    stats = {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path, budget=budget, bucket=0)  # buckets sized from the budget
        got = eng.join(pkg.Pandas(left), pkg.Pandas(right), how="inner", on=["k"]).as_pandas()
        assert len(got) == n_exp
        st = stats[pkg.name] = eng.stats()["shuffle"]
        assert st["joins_spill"] == 1
        assert st["bytes_spilled"] >= 2 * side_bytes * 0.5  # both sides really spilled
    assert 0 < stats["port"]["peak_device_bytes"] < budget, stats["port"]["peak_device_bytes"]
    assert _counters(stats["port"]) == _counters(stats["ref"])


@pytest.mark.parametrize("form", ["device", "host"])
def test_spill_repartition_round_trip(tmp_path, form):
    """Hash repartition past the budget: a one-pass stream in which every
    key lies in exactly one chunk and whose union is the input; in the
    host form the chunks equal the reference's chunk by chunk."""
    rng = np.random.default_rng(5)
    n = 5000
    pdf = pd.DataFrame({"k": rng.integers(0, 61, n), "v": rng.normal(size=n)})
    chunks, stats = {}, {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path)
        res = eng.repartition(_in(pkg, eng, pdf, form), pkg.PartitionSpec(algo="hash", by=["k"]))
        assert isinstance(res, pkg.Stream)
        seen_keys, parts = set(), []
        for sub in res.native:
            tbl = sub.as_arrow()
            keys = set(tbl.column("k").to_pylist())
            assert not (keys & seen_keys), "key split across chunks"
            seen_keys |= keys
            parts.append(tbl.to_pandas())
        got = pd.concat(parts).sort_values(["k", "v"]).reset_index(drop=True)
        exp = pdf.sort_values(["k", "v"]).reset_index(drop=True)
        pd.testing.assert_frame_equal(got, exp.astype(got.dtypes.to_dict()))
        assert eng.stats()["shuffle"]["repartitions_spill"] == 1
        assert _no_spill_dir(tmp_path, pkg), "spill dir leaked"
        chunks[pkg.name], stats[pkg.name] = parts, eng.stats()["shuffle"]
    names = DET if form == "host" else DET_ANY_FORM
    assert _counters(stats["port"], names) == _counters(stats["ref"], names)
    if form == "host":
        assert len(chunks["port"]) == len(chunks["ref"])
        for a, b in zip(chunks["port"], chunks["ref"]):
            pd.testing.assert_frame_equal(a.reset_index(drop=True), b.reset_index(drop=True))


def test_spill_repartition_composes_with_map(tmp_path):
    """An aggregate over the spill layout: grouping each chunk is right
    globally because keys never split. Each spill chunk holds a disjoint
    key subset, so the streamed aggregate's key range is declared."""
    rng = np.random.default_rng(6)
    pdf = pd.DataFrame({"k": rng.integers(0, 23, 4000), "v": rng.random(4000)})
    exp = pdf.groupby("k").agg(s=("v", "sum")).reset_index()
    got = {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path, **{pkg.c.FUGUE_TPU_CONF_STREAM_KEY_RANGE: "0,22"})
        part = eng.repartition(eng.to_df(pdf), pkg.PartitionSpec(algo="hash", by=["k"]))
        res = eng.aggregate(part, pkg.PartitionSpec(by=["k"]), [pkg.ff.sum(pkg.col("v")).alias("s")])
        g = got[pkg.name] = res.as_pandas().sort_values("k").reset_index(drop=True)
        assert np.allclose(g["s"], exp["s"])
        assert eng.stats()["shuffle"]["repartitions_spill"] == 1
    assert got["port"]["k"].tolist() == got["ref"]["k"].tolist()
    assert np.allclose(got["port"]["s"], got["ref"]["s"])


def test_torn_spill_recovery(tmp_path):
    """``shuffle.spill`` faults tear single bucket publishes; the reader
    partitions only those buckets again and the join still matches; the
    spill directory is removed after."""
    left, right = _join_frames(seed=7)
    stats = {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path, **{pkg.c.FUGUE_TPU_CONF_FAULT_PLAN: "shuffle.spill=error@3"})
        got = _norm(eng.join(pkg.Pandas(left), pkg.Pandas(right), how="inner", on=["k"]))
        _same(got, _legacy(pkg, left, right, "inner"))
        st = stats[pkg.name] = eng.stats()["shuffle"]
        assert st["spill_faults"] == 3 and st["bucket_recoveries"] == 3
        assert st["spill_dirs_cleaned"] >= 1
        assert _no_spill_dir(tmp_path, pkg), "spill dir leaked"
    names = DET + ("spill_faults", "bucket_recoveries")
    assert _counters(stats["port"], names) == _counters(stats["ref"], names)


def test_poisoned_bucket_without_replay_raises_and_cleans(tmp_path):
    """A torn bucket whose source is a one-pass stream raises a clear
    error, and the spill directory is removed on that failure too."""
    for pkg in BOTH:
        pdf = pd.DataFrame({"k": np.arange(100) % 7, "v": np.arange(100, dtype=np.float64)})
        tbl = pa.Table.from_pandas(pdf, preserve_index=False)
        root = tmp_path / pkg.name
        d = pkg.part.new_spill_dir(str(root))
        side = pkg.part.spill_partition(iter([tbl]), tbl.schema, ["k"], ["i"], 4, d, "left", replay=None)
        i = next(i for i, r in enumerate(side.bucket_rows) if r > 0)
        with open(side.path(i), "r+b") as f:
            f.truncate(10)  # a torn IPC prefix
        with pytest.raises(pkg.Error, match="one-pass stream"):
            side.read_bucket(i)
        pkg.part.remove_spill_dir(d)
        # the engine's failure path removes the directory itself: a stream
        # source and every bucket publish torn
        eng = _engine(pkg, tmp_path, **{pkg.c.FUGUE_TPU_CONF_FAULT_PLAN: "shuffle.spill=error@999"})
        left, right = _join_frames(n=1000, seed=8, nulls=False)
        ltbl = pa.Table.from_pandas(left, preserve_index=False)
        with pytest.raises(pkg.Error, match="one-pass stream"):
            res = eng.join(_stream(pkg, ltbl, 200), eng.to_df(right), how="left_outer", on=["k"])
            res.as_pandas()
        assert _no_spill_dir(tmp_path, pkg), "spill dir leaked"


def test_stream_join_spill_fallback_parity(tmp_path):
    """A one-pass stream the streaming join cannot plan (repeated build
    keys) spills instead of being read whole; the result matches, and the
    stream is read once."""
    left, right = _join_frames(n=2000, seed=9, nulls=False)
    ltbl = pa.Table.from_pandas(left, preserve_index=False)
    exp = _norm(pa.Table.from_pandas(left.merge(right, on="k"), preserve_index=False))
    got, stats = {}, {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path)
        res = eng.join(_stream(pkg, ltbl, 256), pkg.Pandas(right), how="inner", on=["k"])
        g = got[pkg.name] = _norm(res)
        _same(g, exp)
        stats[pkg.name] = eng.stats()["shuffle"]
        assert stats[pkg.name]["joins_spill"] == 1
    _same(got["port"], got["ref"])
    assert _counters(stats["port"]) == _counters(stats["ref"])


def test_shuffle_conf_gates(tmp_path):
    """``fugue.tpu.shuffle.enabled=false`` keeps the ladder without the
    spill even past the budget; ``broadcast_max_rows`` comes from the conf."""
    left, right = _join_frames(n=2000, seed=10, nulls=False)
    counts = {}
    for pkg in BOTH:
        c = pkg.c
        off = pkg.make({c.FUGUE_TPU_CONF_SHUFFLE_ENABLED: False, c.FUGUE_TPU_CONF_SHUFFLE_DEVICE_BUDGET: 1})
        res = off.join(off.to_df(left), off.to_df(right), how="inner", on=["k"])
        counts[pkg.name] = res.count()
        assert counts[pkg.name] > 0
        assert off.stats()["shuffle"]["joins_spill"] == 0
        small = pkg.make({c.FUGUE_TPU_CONF_JOIN_BROADCAST_MAX_ROWS: 10})
        assert pkg.bmax(small.conf) == 10
        assert pkg.bmax(pkg.make().conf) == 1 << 20
    assert counts["port"] == counts["ref"]


def _join_spans(pkg, run):
    tr = pkg.tracer()
    tr.clear()
    tr.enable()
    try:
        run()
        return tr.records()
    finally:
        tr.disable()
        tr.clear()


def test_join_span_strategy_attr(tmp_path):
    """``engine.join`` spans carry the chosen strategy and its reason:
    ``shuffle_spill`` past the budget, ``broadcast`` under the row cap;
    the same in both packages."""
    left, right = _join_frames(n=2000, seed=11, nulls=False)
    attrs = {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path)
        recs = _join_spans(pkg, lambda: eng.join(pkg.Pandas(left), pkg.Pandas(right), how="inner",
                                                 on=["k"]).as_pandas())
        joins = [r for r in recs if r["name"] == "engine.join"]
        assert joins and joins[-1]["args"]["strategy"] == "shuffle_spill"
        sh = [r for r in recs if r["name"] == "shuffle.partition"]
        assert {r["args"]["side"] for r in sh} == {"left", "right"}
        assert any(r["name"] == "shuffle.bucket" for r in recs)
        big = pkg.make()
        recs2 = _join_spans(pkg, lambda: big.join(big.to_df(left), big.to_df(right), how="inner",
                                                  on=["k"]).as_pandas())
        joins2 = [r for r in recs2 if r["name"] == "engine.join"]
        assert joins2 and joins2[-1]["args"]["strategy"] == "broadcast"
        keep = ("strategy", "reason")
        attrs[pkg.name] = [{k: v for k, v in j["args"].items() if k in keep} for j in (joins[-1], joins2[-1])]
    assert attrs["port"] == attrs["ref"]


def _strategy_lines(text):
    return [ln.strip() for ln in text.splitlines() if "strategy=" in ln]


def test_explain_shows_join_strategy(tmp_path):
    """``workflow.explain()`` predicts each join's strategy with the same
    rule as the engine, and both packages predict the same."""
    left, right = _join_frames(n=2000, seed=12, nulls=False)
    lines = {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path)
        dag = pkg.Workflow()
        dag.df(left).inner_join(dag.df(right))
        text = dag.explain(engine=eng)
        assert "strategy=shuffle_spill" in text
        dag2 = pkg.Workflow()
        dag2.df(left).inner_join(dag2.df(right))
        text2 = dag2.explain(engine=pkg.make())
        assert "strategy=broadcast" in text2
        lines[pkg.name] = _strategy_lines(text) + _strategy_lines(text2)
    assert lines["port"] == lines["ref"]


def test_shuffle_stats_reset_and_probe(tmp_path):
    """``engine.stats()["shuffle"]`` zeroes its counters on reset and keeps
    the budget; the sampler probe reads the live spill bytes (0 once the
    stream is consumed)."""
    left, right = _join_frames(n=2000, seed=13, nulls=False)
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path)
        eng.join(pkg.Pandas(left), pkg.Pandas(right), how="inner", on=["k"]).as_pandas()
        st = eng.stats()["shuffle"]
        assert st["joins_spill"] == 1 and st["bytes_spilled"] > 0
        probes = eng._resource_probe_fns()
        assert "shuffle_spill_bytes" in probes
        assert probes["shuffle_spill_bytes"](eng) == 0.0
        eng.reset_stats()
        st = eng.stats()["shuffle"]
        assert all(v == 0 for k, v in st.items() if not k.startswith("device_budget")), st
        assert st["device_budget_bytes"] == 20_000 and st["device_budget_source"] == "conf"
    keys = set(_engine(PORT, tmp_path).stats()["shuffle"])
    assert keys == set(_engine(REF, tmp_path).stats()["shuffle"])


def test_negative_zero_keys_cobucket_and_join(tmp_path):
    """0.0 and -0.0 are equal in the join, so they hash to one bucket."""
    pz = pa.Table.from_pandas(pd.DataFrame({"k": [0.0]}), preserve_index=False)
    nz = pa.Table.from_pandas(pd.DataFrame({"k": [-0.0]}), preserve_index=False)
    left = pd.DataFrame({"k": [0.0, 1.0, 2.0], "a": [1, 2, 3]})
    right = pd.DataFrame({"k": [-0.0, 1.0, 2.0], "b": [4, 5, 6]})
    got = {}
    for pkg in BOTH:
        assert (pkg.part.bucket_ids(pz, ["k"], ["f"], 64) == pkg.part.bucket_ids(nz, ["k"], ["f"], 64)).all()
        eng = _engine(pkg, tmp_path, budget=1, **{pkg.c.FUGUE_TPU_CONF_SHUFFLE_BUCKETS: 8})
        g = got[pkg.name] = _norm(eng.join(eng.to_df(left), eng.to_df(right), how="inner", on=["k"]))
        assert eng.stats()["shuffle"]["joins_spill"] == 1
        assert len(g) == 3
        _same(g, _legacy(pkg, left, right, "inner"))
    _same(got["port"], got["ref"])


def test_tz_aware_keys_cobucket_across_timezones():
    """Equal instants in different time zones hash to one bucket; naive
    keys keep their wall-clock view. The ids equal the reference's."""
    utc = pd.DataFrame({"k": pd.to_datetime(["2026-01-01 00:00", "2026-06-01 12:34"]).tz_localize("UTC")})
    est = utc.assign(k=utc["k"].dt.tz_convert("US/Eastern"))
    tu = pa.Table.from_pandas(utc, preserve_index=False)
    te = pa.Table.from_pandas(est, preserve_index=False)
    naive = pa.Table.from_pandas(pd.DataFrame({"k": pd.to_datetime(["2026-01-01", "2026-06-01"])}),
                                 preserve_index=False)
    for pkg in BOTH:
        assert (pkg.part.bucket_ids(tu, ["k"], ["t"], 64) == pkg.part.bucket_ids(te, ["k"], ["t"], 64)).all()
        ids = pkg.part.bucket_ids(naive, ["k"], ["t"], 64)
        assert len(ids) == 2 and (ids >= 0).all()
    for t in (tu, te, naive):
        assert (tpart.bucket_ids(t, ["k"], ["t"], 64) == jpart.bucket_ids(t, ["k"], ["t"], 64)).all()


def test_recovery_casts_replayed_chunks(tmp_path):
    """Bucket recovery casts a replayed chunk to the spill schema, as the
    spill itself does."""
    pdf = pd.DataFrame({"k": (np.arange(50) % 5).astype(np.int32), "v": np.arange(50, dtype=np.float32)})
    raw = pa.Table.from_pandas(pdf, preserve_index=False)
    schema = pa.schema([("k", pa.int64()), ("v", pa.float64())])
    got = {}
    for pkg in BOTH:
        d = pkg.part.new_spill_dir(str(tmp_path / pkg.name))
        side = pkg.part.spill_partition(iter([raw]), schema, ["k"], ["i"], 4, d, "left",
                                        replay=lambda: iter([raw]))
        i = next(i for i, r in enumerate(side.bucket_rows) if r > 0)
        with open(side.path(i), "r+b") as f:
            f.truncate(10)
        tbl = got[pkg.name] = side.read_bucket(i)
        assert tbl.schema == schema and tbl.num_rows == side.bucket_rows[i]
        pkg.part.remove_spill_dir(d)
    assert got["port"].equals(got["ref"])


def test_spill_dir_bytes_tolerates_concurrent_mutation(tmp_path):
    """The sampler probe iterates the engine's live spill-dir set while
    joins change it: a raced snapshot retries; one that races always reads 0."""

    class FlakyOnce:
        def __init__(self, items):
            self.items, self.raised = items, False

        def __iter__(self):
            if not self.raised:
                self.raised = True
                raise RuntimeError("Set changed size during iteration")
            return iter(self.items)

    class AlwaysRacing:
        def __iter__(self):
            raise RuntimeError("Set changed size during iteration")

    for pkg in BOTH:
        d = pkg.part.new_spill_dir(str(tmp_path / pkg.name))
        with open(os.path.join(d, "x.arrow"), "wb") as f:
            f.write(b"abcd")
        assert pkg.part.spill_dir_bytes(FlakyOnce([d])) == 4
        assert pkg.part.spill_dir_bytes(AlwaysRacing()) == 0


# ===========================================================================
# tests/jax_engine/test_shuffle_pipeline.py
# ===========================================================================


def _ab(pkg, tmp_path, how, seed=0, on_conf=None, **frames_kw):
    """One join through the pipelined engine and the kill-switch engine:
    (normalized result, kill-switch result, pipelined stats, kill-switch
    stats)."""
    left, right = _join_frames(seed=seed, **frames_kw)
    eng = _engine(pkg, tmp_path, **(on_conf or {}))
    got = _norm(eng.join(pkg.Pandas(left), pkg.Pandas(right), how=how, on=["k"]))
    off = _engine(pkg, tmp_path, **{pkg.c.FUGUE_TPU_CONF_SHUFFLE_PIPELINE_ENABLED: False})
    ref = _norm(off.join(pkg.Pandas(left), pkg.Pandas(right), how=how, on=["k"]))
    return got, ref[list(got.columns)], eng.stats()["shuffle"], off.stats()["shuffle"]


def _ab_both(tmp_path, how, **kw):
    """``_ab`` in both packages; the results and the deterministic counters
    of either engine equal across packages."""
    out = {pkg.name: _ab(pkg, tmp_path, how, **kw) for pkg in BOTH}
    (pg, pr, ps, pso), (rg, rr, rs, rso) = out["port"], out["ref"]
    _same(pg, rg)
    _same(pr, rr)
    assert _counters(ps) == _counters(rs) and _counters(pso) == _counters(rso)
    return out


@pytest.mark.parametrize("how", SPILL_HOWS)
def test_pipeline_parity_vs_kill_switch(tmp_path, how):
    """The pipelined path (mem tier, grouping, write-behind; on by
    default) equals the serial kill switch, which touches none of it."""
    for got, ref, st, st_off in _ab_both(tmp_path, how).values():
        pd.testing.assert_frame_equal(got, ref)
        assert st["pipelined_joins"] == 1 and st["joins_spill"] == 1
        assert st_off["pipelined_joins"] == 0
        assert st_off["mem_buckets"] == 0 and st_off["group_joins"] == 0


def test_kill_switch_span_multiset_is_serial(tmp_path):
    """``pipeline.enabled=false`` gives the serial span shape: one
    ``shuffle.partition`` a side and one ``shuffle.bucket`` a bucket id,
    in order, with no ``pairs``; the bucket ids equal the reference's."""
    left, right = _join_frames(seed=3)
    ids = {}
    for pkg in BOTH:
        off = _engine(pkg, tmp_path, **{pkg.c.FUGUE_TPU_CONF_SHUFFLE_PIPELINE_ENABLED: False})
        recs = _join_spans(pkg, lambda: off.join(pkg.Pandas(left), pkg.Pandas(right), how="inner",
                                                 on=["k"]).as_pandas())
        parts = [r for r in recs if r["name"] == "shuffle.partition"]
        assert {r["args"]["side"] for r in parts} == {"left", "right"}
        buckets = [r["args"]["bucket"] for r in recs if r["name"] == "shuffle.bucket"]
        assert buckets == list(range(len(buckets))) and len(buckets) > 0
        assert all("pairs" not in r["args"] for r in recs if r["name"] == "shuffle.bucket")
        ids[pkg.name] = buckets
    assert ids["port"] == ids["ref"]


def test_mem_tier_serves_buckets_without_disk(tmp_path):
    """Under an ample ledger every bucket stays in memory: reads are mem
    hits, nothing goes through the writer, and ``bytes_spilled`` is the
    tier's bytes."""
    for got, ref, st, _ in _ab_both(tmp_path, "inner", seed=4).values():
        pd.testing.assert_frame_equal(got, ref)
        assert st["mem_buckets"] > 0 and st["mem_bucket_hits"] > 0
        assert st["mem_demotions"] == 0 and st["writebehind_batches"] == 0
        assert st["bytes_spilled"] == st["mem_bucket_bytes"] > 0


def test_mem_ledger_pressure_demotes_largest_first(tmp_path):
    """A tiny ledger forces demotions: demoted buckets take the writer's
    disk path, results stay equal, and no spill directory is left."""
    out = _ab_both(tmp_path, "inner", seed=5, on_conf={PORT.c.FUGUE_TPU_CONF_SHUFFLE_MEM_BUCKET_BYTES: 4096})
    for got, ref, st, _ in out.values():
        pd.testing.assert_frame_equal(got, ref)
        assert st["mem_demotions"] > 0 and st["writebehind_batches"] > 0
    for pkg in BOTH:
        assert _no_spill_dir(tmp_path, pkg), "spill dir leaked"


def test_mem_tier_disabled_by_negative_conf(tmp_path):
    """``mem_bucket_bytes < 0`` turns the tier off: every bucket goes
    through the writer, still pipelined, still equal."""
    out = _ab_both(tmp_path, "left_outer", seed=6, on_conf={PORT.c.FUGUE_TPU_CONF_SHUFFLE_MEM_BUCKET_BYTES: -1})
    for got, ref, st, _ in out.values():
        pd.testing.assert_frame_equal(got, ref)
        assert st["mem_buckets"] == 0 and st["mem_bucket_bytes"] == 0
        assert st["writebehind_batches"] > 0 and st["pipelined_joins"] == 1


# the grouped cases' conf: a 400,000-byte budget, 4 KiB buckets, and right
# sides past 10,000 rows kept off the broadcast rung (see the first case)
_GROUP_CONF = {
    PORT.c.FUGUE_TPU_CONF_SHUFFLE_DEVICE_BUDGET: 400_000,
    PORT.c.FUGUE_TPU_CONF_SHUFFLE_BUCKET_BYTES: 4096,
    PORT.c.FUGUE_TPU_CONF_JOIN_BROADCAST_MAX_ROWS: 10_000,
}


def test_grouped_pairs_share_kernel_launches(tmp_path):
    """With room in the budget, adjacent pairs coalesce: fewer joins
    (``group_joins``) than bucket pairs (``bucket_joins``), the result
    equal to the kill switch's and to the reference's, and the measured
    peak under the budget.

    The property is asserted on the port alone, and the two packages'
    ``group_joins`` and peaks are not compared: the group size follows the
    measured peak a pair. The JAX package samples every live array of its
    frames padded to 8 shards, with the prefetched groups in flight
    (up to 74,448 bytes a pair here against a 400,000-byte budget), so
    its groups stay at one pair and its own test fails (157 = 157); the
    port counts the tensors a pair holds, and groups.

    Both packages get ``broadcast_max_rows`` 10,000 (:data:`_GROUP_CONF`):
    the sides come as host frames of 340,000 pandas bytes each, under the
    400,000-byte budget, which the broadcast rung would take (ROADMAP.md
    C27: the reference's own test hands in frames the JAX engine has not
    ingested, which it estimates at 640,000 bytes)."""
    conf = _GROUP_CONF
    kw = dict(seed=7, n=20000, key_range=60000, on_conf=conf)  # mostly 1:1 matches
    got, ref, st, _ = _ab(PORT, tmp_path, "inner", **kw)
    pd.testing.assert_frame_equal(got, ref)
    assert st["bucket_joins"] > st["group_joins"] > 0
    assert 0 < st["peak_device_bytes"] < 400_000
    rgot, _, rst, _ = _ab(REF, tmp_path, "inner", **kw)
    _same(got, rgot)
    assert st["bucket_joins"] == rst["bucket_joins"] and st["buckets"] == rst["buckets"]


def test_dup_heavy_group_sizing_respects_budget(tmp_path):
    """8x repeated keys: the expansion's output dwarfs the input, so the
    measured pair peak keeps groups small and the budget holds (with
    :data:`_GROUP_CONF`, as the grouped case)."""
    out = _ab_both(tmp_path, "inner", seed=14, n=20000, on_conf=_GROUP_CONF)
    for got, ref, st, _ in out.values():
        pd.testing.assert_frame_equal(got, ref)
    st = out["port"][2]
    assert 0 < st["peak_device_bytes"] < 400_000, st["peak_device_bytes"]


def test_empty_side_buckets_interleave_with_groups(tmp_path):
    """Outer joins over skewed keys: buckets with rows on the left only
    (joined on the host) interleave with device groups, in bucket order."""
    for got, ref, st, _ in _ab_both(tmp_path, "left_outer", seed=8, right_keys=40).values():
        pd.testing.assert_frame_equal(got, ref)
        assert st["pipelined_joins"] == 1


def test_pair_prefetch_depth_parity(tmp_path):
    """An explicit pair-prefetch depth runs the threaded producer: equal
    results, no deadlock, the spill directory removed."""
    out = _ab_both(tmp_path, "inner", seed=9, on_conf={PORT.c.FUGUE_TPU_CONF_SHUFFLE_PREFETCH_DEPTH: 2})
    for got, ref, st, _ in out.values():
        pd.testing.assert_frame_equal(got, ref)
        assert st["pipelined_joins"] == 1
    for pkg in BOTH:
        assert _no_spill_dir(tmp_path, pkg), "spill dir leaked"


def test_writebehind_poison_tears_and_recovers(tmp_path):
    """Faults fired from the background writer (the tier off, so every
    bucket publishes through it) tear single buckets; the reader recovers
    exactly those from the source."""
    left, right = _join_frames(seed=10, nulls=False)
    got, stats = {}, {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path, **{pkg.c.FUGUE_TPU_CONF_SHUFFLE_MEM_BUCKET_BYTES: -1,
                                        pkg.c.FUGUE_TPU_CONF_FAULT_PLAN: "shuffle.spill=error@2"})
        g = got[pkg.name] = _norm(eng.join(pkg.Pandas(left), pkg.Pandas(right), how="inner", on=["k"]))
        _same(g, _legacy(pkg, left, right, "inner"))
        st = stats[pkg.name] = eng.stats()["shuffle"]
        assert st["spill_faults"] == 2 and st["bucket_recoveries"] == 2
        assert _no_spill_dir(tmp_path, pkg), "spill dir leaked"
    _same(got["port"], got["ref"])
    names = DET + ("spill_faults", "bucket_recoveries")
    assert _counters(stats["port"], names) == _counters(stats["ref"], names)


def test_mem_tier_poison_drops_and_recovers(tmp_path):
    """The tier's torn publish: a fault at retention drops the bucket and
    the reader partitions it again from the source."""
    left, right = _join_frames(seed=11, nulls=False)
    stats = {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path, **{pkg.c.FUGUE_TPU_CONF_FAULT_PLAN: "shuffle.spill=error@3"})
        got = _norm(eng.join(pkg.Pandas(left), pkg.Pandas(right), how="inner", on=["k"]))
        _same(got, _legacy(pkg, left, right, "inner"))
        st = stats[pkg.name] = eng.stats()["shuffle"]
        assert st["spill_faults"] == 3 and st["bucket_recoveries"] == 3
    names = DET + ("spill_faults", "bucket_recoveries")
    assert _counters(stats["port"], names) == _counters(stats["ref"], names)


def test_writebehind_poison_surfaces_for_one_pass_stream(tmp_path):
    """Every publish torn and the source a one-pass stream: the error
    reaches the consumer, nothing deadlocks, and no spill directory or
    tmp file is left."""
    left, right = _join_frames(n=1000, seed=12, nulls=False)
    ltbl = pa.Table.from_pandas(left, preserve_index=False)
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path, **{pkg.c.FUGUE_TPU_CONF_FAULT_PLAN: "shuffle.spill=error@999"})
        with pytest.raises(pkg.Error, match="one-pass stream"):
            res = eng.join(_stream(pkg, ltbl, 200), eng.to_df(right), how="left_outer", on=["k"])
            res.as_pandas()
        assert _no_spill_dir(tmp_path, pkg), "spill dir leaked"


def test_writer_failure_propagates_with_original_traceback(tmp_path):
    """A failure on the writer thread is raised from ``submit``/``finalize``
    with the writer's frames, removes every tmp file, and never blocks a
    submitter."""
    import traceback

    for pkg in BOTH:
        d = tmp_path / pkg.name
        d.mkdir()
        w = pkg.pipe.SpillWriter(str(d), "left", pa.schema([("x", pa.int64())]), depth=2)
        w.submit(0, object())  # not a table: write_table raises on the thread
        with pytest.raises(Exception) as ei:
            for n in range(50):
                w.submit(1, pa.table({"x": [n]}))
        frames = traceback.extract_tb(ei.value.__traceback__)
        assert any("_run" in f.name for f in frames), "writer-thread frames lost"
        assert not glob.glob(os.path.join(str(d), "*.tmp")), "tmp orphaned"
        with pytest.raises(Exception):
            w.finalize()


def test_spill_dir_bytes_excludes_tmp(tmp_path):
    """The sampler probe does not count ``*.tmp`` files."""
    for pkg in BOTH:
        d = pkg.part.new_spill_dir(str(tmp_path / pkg.name))
        with open(os.path.join(d, "left_00000.arrow"), "wb") as f:
            f.write(b"x" * 100)
        with open(os.path.join(d, "left_00001.arrow.tmp"), "wb") as f:
            f.write(b"y" * 5000)
        assert pkg.part.spill_dir_bytes([d]) == 100


def test_repartition_pipelined_keeps_keys_whole(tmp_path):
    """The pipelined spill repartition (read-ahead, mem tier) keeps one
    bucket a chunk; the chunks equal the reference's in bucket order."""
    rng = np.random.default_rng(13)
    pdf = pd.DataFrame({"k": rng.integers(0, 61, 5000), "v": rng.normal(size=5000)})
    chunks, stats = {}, {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path, **{pkg.c.FUGUE_TPU_CONF_SHUFFLE_PREFETCH_DEPTH: 2})
        res = eng.repartition(pkg.Pandas(pdf), pkg.PartitionSpec(algo="hash", by=["k"]))
        seen, parts = set(), []
        for sub in res.native:
            tbl = sub.as_arrow()
            keys = set(tbl.column("k").to_pylist())
            assert not (keys & seen), "key split across chunks"
            seen |= keys
            parts.append(tbl.to_pandas())
        got = pd.concat(parts).sort_values(["k", "v"]).reset_index(drop=True)
        exp = pdf.sort_values(["k", "v"]).reset_index(drop=True)
        pd.testing.assert_frame_equal(got, exp.astype(got.dtypes.to_dict()))
        st = stats[pkg.name] = eng.stats()["shuffle"]
        assert st["mem_bucket_hits"] > 0
        assert _no_spill_dir(tmp_path, pkg), "spill dir leaked"
        chunks[pkg.name] = parts
    assert _counters(stats["port"]) == _counters(stats["ref"])
    assert len(chunks["port"]) == len(chunks["ref"])
    for a, b in zip(chunks["port"], chunks["ref"]):
        pd.testing.assert_frame_equal(a.reset_index(drop=True), b.reset_index(drop=True))


def test_adjust_pipeline_deepens_when_consumer_starved():
    for pkg in BOTH:
        adjust = pkg.tuner.adjust_pipeline
        adj = adjust(1, 1 << 28, {"pipe_chunks": 40, "wall_s": 2.0, "pipe_producer_wait_s": 0.01,
                                  "pipe_consumer_wait_s": 1.0})
        assert adj["pair_depth"] == 2 and not adj["converged"]
        adj = adjust(2, 1 << 28, {"pipe_chunks": 40, "wall_s": 2.0, "pipe_producer_wait_s": 1.0,
                                  "pipe_consumer_wait_s": 0.01})
        assert adj["pair_depth"] == 1
        assert adjust(1, 1 << 28, {"pipe_chunks": 40, "wall_s": 0.01}) is None


def test_adjust_pipeline_mem_budget_tracks_pressure():
    for pkg in BOTH:
        t = pkg.tuner
        grown = t.adjust_pipeline(0, 1 << 27, {"pipe_chunks": 10, "wall_s": 1.0, "mem_demotions": 5,
                                               "mem_bytes_used": 1 << 27})
        assert grown["mem_bytes"] == 1 << 28
        shrunk = t.adjust_pipeline(0, 1 << 29, {"pipe_chunks": 10, "wall_s": 1.0, "mem_demotions": 0,
                                                "mem_bytes_used": 1 << 20})
        assert t.MEM_BYTES_MIN <= shrunk["mem_bytes"] < 1 << 29
        capped = t.adjust_pipeline(0, t.MEM_BYTES_MAX, {"pipe_chunks": 10, "wall_s": 1.0, "mem_demotions": 3,
                                                        "mem_bytes_used": t.MEM_BYTES_MAX})
        assert capped["mem_bytes"] == t.MEM_BYTES_MAX and capped["converged"]
    assert (ttuner.MEM_BYTES_MIN, ttuner.MEM_BYTES_MAX) == (jtuner.MEM_BYTES_MIN, jtuner.MEM_BYTES_MAX)


def test_learned_pipeline_params_resolve_and_render(tmp_path):
    """A seeded store entry gives pair_depth and mem_bytes to the next run
    of the same plan; ``describe_tuning`` renders them."""
    for pkg in BOTH:
        conf = {pkg.c.FUGUE_TPU_CONF_TUNING_PATH: os.path.join(str(tmp_path), f"{pkg.name}.json")}
        tuner = pkg.tuner.Tuner(conf)
        tuner.store.publish("planfp0000000000", lambda e: dict(
            e, joins={"join": {"pair_depth": 3, "mem_bytes": 123456, "obs": 2, "pipe_evidence": "seeded"}}))
        engine = types.SimpleNamespace(tuner=tuner, conf=conf)
        with pkg.tuner.run_scope(engine, "planfp0000000000", conf):
            handle = tuner.join_params(None, None, None)[3]
            d, m = handle.pipeline_params(conf, 0, 999)
        assert (d, m) == (3, 123456)
        text = "\n".join(pkg.tuner.describe_tuning(conf, "planfp0000000000", engine))
        assert "pair_depth=3" in text and "mem_bytes=123456" in text


# ===========================================================================
# the port's ladder: the tuner's handle, and the spill of a stream the
# streaming plan refuses
# ===========================================================================


def test_a_refused_semi_stream_join_spills_and_is_never_read_whole(tmp_path):
    """``streaming_hash_join`` refuses a semi join; the stream spills chunk
    by chunk (``engine.to_df`` never sees it), and the result, the span
    and the counters equal the reference's."""
    rng = np.random.default_rng(21)
    n = 6000
    pdf = pd.DataFrame({"k": rng.integers(0, 1000, n), "v": rng.random(n).astype(np.float32)})
    keys = pd.DataFrame({"k": np.arange(0, 1000, 2)})
    tbl = pa.Table.from_pandas(pdf, preserve_index=False)
    got, attrs, stats = {}, {}, {}
    for pkg in BOTH:
        eng = _engine(pkg, tmp_path, budget=1 << 30)
        seen = []
        to_df = eng.to_df

        def spy(df, *a, **k):
            seen.append(type(df).__name__)
            return to_df(df, *a, **k)

        eng.to_df = spy
        recs = _join_spans(pkg, lambda: got.__setitem__(
            pkg.name, _norm(eng.join(_stream(pkg, tbl, 1000), pkg.Pandas(keys), how="left_semi", on=["k"]))))
        eng.to_df = to_df
        assert not any("Iterable" in s for s in seen), seen
        (j,) = [r for r in recs if r["name"] == "engine.join"]
        attrs[pkg.name] = {k: j["args"][k] for k in ("strategy", "reason")}
        stats[pkg.name] = eng.stats()["shuffle"]
    exp = pdf[pdf["k"].isin(keys["k"])]
    assert len(got["port"]) == len(exp)
    _same(got["port"], got["ref"])
    assert attrs["port"] == attrs["ref"] == {
        "strategy": "shuffle_spill", "reason": "stream ineligible for the streaming join plan"}
    assert _counters(stats["port"]) == _counters(stats["ref"])


def test_the_tuner_calibrates_the_spill_join(tmp_path):
    """Inside a workflow run the ladder asks the tuner for the join's
    estimates and the spill's bucket count, and the handle records the
    sides and the pair peak; a second run reads them back."""
    from fugue_tpu_torch.tuning import run_scope

    left, right = _join_frames(n=2000, seed=22, nulls=False)
    eng = _engine(PORT, tmp_path, **{tc.FUGUE_TPU_CONF_TUNING_PATH: str(tmp_path / "t.json")})
    with run_scope(eng, "planfp", eng.conf):
        eng.join(PandasDataFrame(left), PandasDataFrame(right), how="inner", on=["k"]).as_pandas()
    entry = eng.tuner.store.plan_entry("planfp")["joins"]["join"]
    assert entry["left_rows"] == 2000 and entry["right_rows"] == 2000 and entry["obs"] == 1
    decisions = eng.stats()["tuning"]["last_decisions"]
    assert {"join", "shuffle", "shuffle_pipeline"} <= {d["target"] for d in decisions}
    (shuffle,) = [d for d in decisions if d["target"] == "shuffle"]
    assert shuffle["value"]["buckets"] == 7  # ceil(34,000 pandas bytes / 5,000 a bucket)
    with run_scope(eng, "planfp", eng.conf):
        l, r, rr, _ = eng.tuner.join_params(None, None, None)
    assert (l, rr) == (entry["left_bytes"], 2000)


SMOKE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, pandas as pd, pyarrow as pa, torch
import chip_smoke
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.ops import bin_groupby as bg
for name in ("synchronize", "reset_peak_memory_stats", "max_memory_allocated", "memory_allocated", "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: 0)
out = chip_smoke.phase_spill_path(torch, np, pd, pa, bg, ff, col, "cpu", 0, 60_000, stream_rows=240_000,
                                  stream_chunk=60_000, budget=1_000_000)
print(json.dumps({"jax": "jax" in sys.modules, "memory": out["memory"],
                  "cells": {c: {k: r[k] for k in ("strategy", "shuffle", "launches", "chunks", "aggregate_chunks",
                                                  "spill_dir_left", "rows_out") if k in r}
                            for c, r in out["cells"].items()}}))
"""


def test_chip_smoke_spill_path_on_the_cpu():
    """``phase_spill_path`` at a cut size (6·10^4 orders, a 10^6-byte
    budget, 2.4·10^5 streamed rows) on the CPU, in a process that loads no
    JAX: every cell's gates, and no spill directory left."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    r = subprocess.run([sys.executable, "-c", SMOKE, root], cwd=root, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["jax"] is False
    cells = last["cells"]
    assert sorted(cells) == ["spill-join-sf10", "spill-repartition-stream", "spill-stream-semi"]
    sf10 = cells["spill-join-sf10"]
    assert sf10["strategy"] == "shuffle_spill" and sf10["spill_dir_left"] == []
    assert sf10["shuffle"]["bucket_joins"] >= sf10["shuffle"]["group_joins"] > 0
    assert 0 < sf10["shuffle"]["peak_device_bytes"] <= 1_000_000
    assert cells["spill-stream-semi"]["shuffle"]["joins_spill"] == 1
    assert cells["spill-stream-semi"]["aggregate_chunks"] >= 1
    assert 1 <= cells["spill-repartition-stream"]["chunks"] <= 16
    assert all(c["launches"]["bin_sum"] == 0 for c in cells.values())  # B1 launches on a card only
    assert last["memory"]["spill_dirs_left"] == []


def test_the_peak_meter_keeps_an_outer_peak_and_opens_its_first_window(monkeypatch):
    """The CUDA peak measure of a spill join's pairs, against a model of the
    caching allocator's counters: a sample taken before the first pair's
    window (the producer ingests before the consumer opens one) reads the
    join's own rise, not an earlier peak of the process, and closing the
    meter gives an outer reader back the peak it had."""
    import torch

    from fugue_tpu_torch.shuffle.join import _PeakMeter

    class Allocator:
        cur = peak = 0

        def alloc(self, n):
            self.cur += n
            self.peak = max(self.peak, self.cur)

        def free(self, n):
            self.cur -= n

    a = Allocator()

    class Block:
        def __init__(self, n, **_):
            self.n = n
            a.alloc(n)

        def __del__(self):
            a.free(self.n)

    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda dev=None: a.peak)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: a.cur)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda dev=None: setattr(a, "peak", a.cur))
    monkeypatch.setattr(torch, "empty", Block)
    held = Block(1 << 20)
    earlier = Block(5 << 30)  # an earlier phase's peak
    del earlier
    outer = a.peak
    meter = _PeakMeter(types.SimpleNamespace(type="cuda"))
    assert meter.sample() == 0  # nothing of the join allocated yet
    pair = Block(10 << 20)
    assert meter.sample() == 10 << 20
    del pair
    meter.window()
    assert meter.sample() == 0 and meter.peak == 10 << 20
    meter.close()
    assert a.peak == outer and a.cur == 1 << 20
    del held
