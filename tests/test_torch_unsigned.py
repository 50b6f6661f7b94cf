"""uint16, uint32 and uint64 columns on the port's device against the JAX
engine (``JaxExecutionEngine`` on the 8-device CPU mesh), verb by verb.

The port widens them on its device (``torch/dataframe.py``: uint16 as
int32, uint32 as int64, uint64 as its int64 bits with the top bit flipped)
and computes in their type (``column/torch_eval.py``). Each case runs the
same seeded numpy frame, plain and nullable, with the values 0, 1 and the
type's top ones (for uint64 2**63 − 1, 2**63 and 2**64 − 1), through both
engines and compares:

- keys, counts, MIN/MAX, row sets and integer results exactly (rows as
  arrow values, sorted), schemas as strings;
- float results (AVG, a division) with ``np.allclose`` at ``rtol=1e-12``:
  the same float64 operations, in another order only across groups.

Where the reference reads uint64 through float64 (a nullable uint64 key,
a streamed uint64 key past 2**53: ROADMAP.md C16) the port is held against
pandas instead.
"""

from typing import Any, List

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.column import SelectColumns as JSelectColumns
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.dataframe import ArrowDataFrame as JArrowDataFrame
from fugue_tpu.dataframe import LocalDataFrameIterableDataFrame as JStream
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import SelectColumns, col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine

RTOL = 1e-12
TYPES = {"uint16": np.uint16, "uint32": np.uint32, "uint64": np.uint64}


@pytest.fixture(scope="module")
def engines():
    je = JaxExecutionEngine({"fugue.tpu.cache.enabled": False, "fugue.tpu.stream.chunk_rows": 16})
    yield je, TorchExecutionEngine(device="cpu", conf={"fugue.tpu.stream.chunk_rows": 16})
    je.stop_engine()


def _edges(dt: Any) -> List[int]:
    top = int(np.iinfo(dt).max)
    if dt is np.uint64:
        return [0, 1, (1 << 63) - 1, 1 << 63, top, (1 << 32) + 5]
    return [0, 1, top // 2, top // 2 + 1, top - 1, top]


def _table(name: str, nullable: bool, n: int = 48, seed: int = 0) -> pa.Table:
    dt = TYPES[name]
    rng = np.random.default_rng(seed)
    u = np.array(_edges(dt), dtype=dt)[rng.integers(0, 6, n)]
    mask = (rng.random(n) < 0.2) if nullable else None
    return pa.table({
        "k": pa.array(rng.integers(0, 4, n)),
        "u": pa.array(u, type=getattr(pa, name)(), mask=mask),
        "v": pa.array(rng.integers(-8, 8, n) / 4.0),
    })


def _rows(df: Any) -> List[tuple]:
    tbl = df.as_arrow()
    return sorted((tuple(r.values()) for r in tbl.to_pylist()), key=repr)


def _same(got: Any, exp: Any) -> None:
    assert isinstance(got, TorchDataFrame)
    assert str(got.schema) == str(exp.schema)
    g, e = _rows(got), _rows(exp)
    assert len(g) == len(e)
    for a, b in zip(g, e):
        for x, y in zip(a, b):
            if isinstance(x, float) or isinstance(y, float):
                assert (x is None) == (y is None) and (x is None or np.allclose(x, y, rtol=RTOL, equal_nan=True)), (a, b)
            else:
                assert x == y, (a, b)


def _both(engines, tables, jfn, tfn) -> None:
    """The same answer on both engines, or the same exception class."""
    je, te = engines
    try:
        exp = jfn(je, *[je.to_df(JArrowDataFrame(t)) for t in tables])
    except Exception as e:  # noqa: BLE001 - the port raises as the reference does
        with pytest.raises(Exception) as err:
            tfn(te, *[te.to_df(t) for t in tables])
        assert type(err.value).__name__ == type(e).__name__
        return
    got = tfn(te, *[te.to_df(t) for t in tables])
    _same(got, exp)


AGGS = [("s", "sum"), ("a", "avg"), ("lo", "min"), ("hi", "max"), ("n", "count")]


def _aggs(fns, c, names=AGGS):
    return [getattr(fns, f)(c("u")).alias(n) for n, f in names]


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("name", list(TYPES))
def test_aggregate_of_unsigned_values(engines, name, nullable):
    """SUM (wrapping in the type where the reference's does), AVG, MIN,
    MAX, COUNT by an int key: the dense route. The reference fails a
    nullable uint64 SUM past 2**63 (its int64 finish, ROADMAP.md C16): the
    port wraps it as its plain path does, held against Python integers."""
    t = _table(name, nullable)
    if not (nullable and name == "uint64"):
        _both(engines, [t], lambda e, d: e.aggregate(d, JPartitionSpec(by=["k"]), _aggs(jff, jcol)),
              lambda e, d: e.aggregate(d, PartitionSpec(by=["k"]), _aggs(ff, col)))
        return
    got = engines[1].aggregate(engines[1].to_df(t), PartitionSpec(by=["k"]), _aggs(ff, col))
    assert str(got.schema) == "k:long,s:long,a:double,lo:uint64,hi:uint64,n:long"
    by_k: dict = {}
    for r in t.to_pylist():
        if r["u"] is not None:
            by_k.setdefault(r["k"], []).append(r["u"])
    for r in got.as_arrow().to_pylist():
        us = by_k[r["k"]]
        wrapped = sum(us) % (1 << 64)
        assert r["s"] == (wrapped - (1 << 64) if wrapped >= 1 << 63 else wrapped)
        assert np.isclose(r["a"], sum(us) / len(us), rtol=RTOL)
        assert (r["lo"], r["hi"], r["n"]) == (min(us), max(us), len(us))


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("name", list(TYPES))
def test_aggregate_by_an_unsigned_key(engines, name, nullable):
    """An unsigned key alone (the dense route where its range fits, the
    sorted one past it) and beside an int key (the sorted groupby)."""
    t = _table(name, nullable, seed=1)
    vaggs = [("sv", "sum", "v"), ("nv", "count", "v"), ("mv", "max", "v")]
    for by in (["u"], ["k", "u"]):
        if nullable and name == "uint64":
            # the reference rounds a nullable uint64 key through float64
            # (ROADMAP.md C16): pandas is the oracle
            got = engines[1].aggregate(engines[1].to_df(t), PartitionSpec(by=by),
                                       [getattr(ff, f)(col(c)).alias(n) for n, f, c in vaggs])
            pdf = t.to_pandas(types_mapper={pa.uint64(): pd.UInt64Dtype()}.get)
            exp = pdf.groupby(by, dropna=False).agg(sv=("v", "sum"), nv=("v", "count"), mv=("v", "max"))
            exp = exp.reset_index()
            assert str(got.schema) == ",".join(
                [f"{c}:{'uint64' if c == 'u' else 'long'}" for c in by] + ["sv:double", "nv:long", "mv:double"])
            g = got.as_arrow().to_pylist()
            e = [{c: (None if pd.isna(r[c]) else int(r[c]) if c in ("u", "k", "nv") else r[c]) for c in r}
                 for r in exp.to_dict("records")]
            assert sorted(map(repr, g)) == sorted(map(repr, e))
            continue
        _both(engines, [t],
              lambda e, d, by=by: e.aggregate(d, JPartitionSpec(by=by),
                                              [getattr(jff, f)(jcol(c)).alias(n) for n, f, c in vaggs]),
              lambda e, d, by=by: e.aggregate(d, PartitionSpec(by=by),
                                              [getattr(ff, f)(col(c)).alias(n) for n, f, c in vaggs]))


def _threshold(name: str) -> int:
    return (1 << 63) - 1 if name == "uint64" else int(np.iinfo(TYPES[name]).max) // 2


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("name", list(TYPES))
def test_filter_and_select(engines, name, nullable):
    """A comparison at the type's middle (2**63 for uint64), arithmetic
    that wraps in the type, a true division, a cast, a WHERE."""
    t = _table(name, nullable, seed=2)
    th = _threshold(name)
    _both(engines, [t], lambda e, d: e.filter(d, jcol("u") >= th), lambda e, d: e.filter(d, col("u") >= th))
    _both(engines, [t],
          lambda e, d: e.select(d, JSelectColumns(jcol("k"), jcol("u"), (jcol("u") * 2).alias("x"),
                                                  (jcol("u") + 1).alias("y"), (jcol("u") / 2).alias("d"),
                                                  (jcol("u") < th).alias("lt"))),
          lambda e, d: e.select(d, SelectColumns(col("k"), col("u"), (col("u") * 2).alias("x"),
                                                 (col("u") + 1).alias("y"), (col("u") / 2).alias("d"),
                                                 (col("u") < th).alias("lt"))))
    _both(engines, [t],
          lambda e, d: e.select(d, JSelectColumns(jcol("u"), jcol("v")), where=jcol("u") < th),
          lambda e, d: e.select(d, SelectColumns(col("u"), col("v")), where=col("u") < th))
    _both(engines, [t],
          lambda e, d: e.select(d, JSelectColumns(jcol("k"), jcol("v").cast(getattr(pa, name)()).alias("c"))),
          lambda e, d: e.select(d, SelectColumns(col("k"), col("v").cast(getattr(pa, name)()).alias("c"))))


@pytest.mark.parametrize("name", list(TYPES))
def test_joins_by_an_unsigned_key(engines, name):
    """Each join type by an unsigned key at the type's edges."""
    left = _table(name, False, seed=3)
    edges = np.array(_edges(TYPES[name]), dtype=TYPES[name])
    right = pa.table({"u": pa.array(edges[[5, 3, 1]]), "w": pa.array([1.5, 2.5, 3.5])})
    for how in ("inner", "left_outer", "right_outer", "full_outer", "left_semi", "left_anti"):
        _both(engines, [left, right], lambda e, a, b, how=how: e.join(a, b, how=how, on=["u"]),
              lambda e, a, b, how=how: e.join(a, b, how=how, on=["u"]))


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("name", list(TYPES))
def test_set_verbs_take_and_sample(engines, name, nullable):
    t = _table(name, nullable, seed=4).select(["k", "u"])
    t2 = _table(name, nullable, seed=5).select(["k", "u"])
    cases = [
        lambda e, a, b: e.distinct(a),
        lambda e, a, b: e.union(a, b, distinct=True),
        lambda e, a, b: e.union(a, b, distinct=False),
        lambda e, a, b: e.subtract(a, b),
        lambda e, a, b: e.intersect(a, b),
        lambda e, a, b: e.take(a, 5, presort="u desc, k"),
        lambda e, a, b: e.take(a, 5, presort="u, k"),
        lambda e, a, b: e.sample(a, frac=0.5, seed=3),
    ]
    rows = [tuple(r.values()) for r in t.to_pylist()]
    for i, fn in enumerate(cases):
        if nullable and name == "uint64" and i in (0, 1, 5):
            # the reference's distinct and its host take read a nullable
            # uint64 through float64 (ROADMAP.md C16): Python rows instead
            got = _rows(fn(engines[1], engines[1].to_df(t), engines[1].to_df(t2)))
            if i == 5:  # u descending, NULLs last, then k
                order = sorted(rows, key=lambda r: (r[1] is None, -(r[1] or 0), r[0]))
                assert got == sorted(order[:5], key=repr)
                continue
            want = set(rows) | (set(tuple(r.values()) for r in t2.to_pylist()) if i == 1 else set())
            assert got == sorted(want, key=repr)
            continue
        _both(engines, [t, t2], fn, fn)


@pytest.mark.parametrize("name", list(TYPES))
def test_streamed_aggregate_and_join(name):
    """A stream keyed by an unsigned column through the streamed dense
    aggregate and the streamed broadcast join; uint64 keys below 2**53
    against the reference, and across 2**63 against pandas (C16)."""
    dt = TYPES[name]
    rng = np.random.default_rng(6)
    base = (1 << 53) - 40 if dt is np.uint64 else int(np.iinfo(dt).max) - 20
    # the streamed dense plan probes its key range on the first chunk
    # unless the conf declares it
    conf = {"fugue.tpu.stream.chunk_rows": 16, "fugue.tpu.stream.key_range": f"{base},{base + 19}"}
    je = JaxExecutionEngine({"fugue.tpu.cache.enabled": False, **conf})
    te = TorchExecutionEngine(device="cpu", conf=conf)
    keys = (np.uint64(base) + rng.integers(0, 20, 80).astype(np.uint64)).astype(dt)
    tbl = pa.table({"u": pa.array(keys), "v": pa.array(rng.random(80))})
    dim = pa.table({"u": pa.array(np.unique(keys)[::2]), "w": pa.array(np.arange(len(np.unique(keys)[::2])) * 1.0)})

    def streams(t):
        parts = [t.slice(s, 16) for s in range(0, t.num_rows, 16)]
        return (JStream((JArrowDataFrame(p) for p in parts), schema=JArrowDataFrame(t).schema),
                LocalDataFrameIterableDataFrame((ArrowDataFrame(p) for p in parts), schema=ArrowDataFrame(t).schema))

    js, ts = streams(tbl)
    exp = je.aggregate(js, JPartitionSpec(by=["u"]), [jff.sum(jcol("v")).alias("s"), jff.count(jcol("v")).alias("n")])
    got = te.aggregate(ts, PartitionSpec(by=["u"]), [ff.sum(col("v")).alias("s"), ff.count(col("v")).alias("n")])
    _same(got, exp)
    js, ts = streams(tbl)
    exp = je.join(js, je.to_df(JArrowDataFrame(dim)), how="inner", on=["u"])
    got = te.join(ts, te.to_df(dim), how="inner", on=["u"])
    assert sorted(map(repr, got.as_arrow().to_pylist())) == sorted(map(repr, exp.as_arrow().to_pylist()))
    if dt is np.uint64:
        far = pa.table({"u": pa.array(keys - np.uint64(base) + np.uint64((1 << 63) - 10)), "v": tbl.column("v")})
        _, ts = streams(far)
        te = TorchExecutionEngine(device="cpu", conf={"fugue.tpu.stream.chunk_rows": 16,
                                                      "fugue.tpu.stream.key_range": f"{(1 << 63) - 10},{(1 << 63) + 9}"})
        got = te.aggregate(ts, PartitionSpec(by=["u"]), [ff.count(col("v")).alias("n")]).as_pandas()
        exp = far.to_pandas().groupby("u").size()
        assert dict(zip(got["u"].tolist(), got["n"].tolist())) == {int(k): int(n) for k, n in exp.items()}
        assert int(got["u"].min()) < (1 << 63) <= int(got["u"].max())


@pytest.mark.parametrize("step", ["filter", "select"])
@pytest.mark.parametrize("rows", [4, 0])
def test_uint64_key_after_a_device_step(engines, step, rows):
    """C22 (ROADMAP.md §C): a uint64 key through a device ``filter`` or
    ``select``, then an aggregate by it. The port gives pandas' exact
    groups (Python integers); the reference's key range over a masked or
    computed frame fills with ``iinfo(uint64).max``, which its jitted call
    cannot parse: ``OverflowError``, with 0 rows too."""
    je, te = engines
    keys = [7, 7, 2**63 + 7, 2**62 + 7][:rows]
    vals = [1.0, 2.0, 3.0, 0.5][:rows]
    tbl = pa.table({"k": pa.array(keys, pa.uint64()), "v": pa.array(vals, pa.float64())})

    def chain(eng, c, f, cols, spec):
        df = eng.to_df(tbl)
        if step == "filter":
            df = eng.filter(df, c("v") > 0)
        else:
            df = eng.select(df, cols(c("k"), (c("v") * 2).alias("v")))
        return eng.aggregate(df, spec(by=["k"]), [f.sum(c("v")).alias("s"), f.count(c("v")).alias("n")])

    got = _rows(chain(te, col, ff, SelectColumns, PartitionSpec))
    scale = 1.0 if step == "filter" else 2.0
    pdf = pd.DataFrame({"k": pd.array(keys, dtype="UInt64"), "v": np.array(vals, dtype=np.float64) * scale})
    exp = sorted(((int(k), float(g["v"].sum()), int(g["v"].count())) for k, g in pdf.groupby("k")), key=repr)
    assert got == exp
    with pytest.raises(OverflowError):
        chain(je, jcol, jff, JSelectColumns, JPartitionSpec)
