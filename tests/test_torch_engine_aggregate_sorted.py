"""``TorchExecutionEngine(device="cpu").aggregate`` against
``JaxExecutionEngine().aggregate`` on the plans that go past the dense
route: several keys; string, float (NaN), bool, date, timestamp and
nullable keys; wide integer keys; COUNT(*); dictionary MIN/MAX; nullable
and int64-with-NULL values. The cases are those of
``tests/jax_engine/test_device_resident_agg.py``, ``test_int64_null_agg.py``
and the aggregate cases of ``test_encoded_columns.py``, plus the three
aggregates of ``chip_smoke.py``'s ``sorted_path`` phase on its lineitem
generator at 20k rows.

Exact: schema, keys, counts, MIN/MAX, NULL placement, and every integer
(int64 sums at 2^62 included). Sums and averages of float32 columns:
``rtol=1e-5, atol=1e-3`` (the port sums them in float64 on the sorted
route, the JAX engine in float32 per shard); of float64 columns
``rtol=1e-9``.
"""


import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import chip_smoke
from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.column import lit as jlit
from fugue_tpu.dataframe import PandasDataFrame as JPandasDataFrame
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu_torch import api
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.column import col, lit
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.ops import bin_groupby
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine, frame_from_numpy

F32_RTOL, F32_ATOL = 1e-5, 1e-3
F64_RTOL = 1e-9


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine()
    yield e
    e.stop()


@pytest.fixture(scope="module")
def engine():
    return TorchExecutionEngine(device="cpu")


def _aggs(pkg, spec):
    """``spec``: (alias, function, column or "*" or a literal)."""
    c, f, lt = (jcol, jff, jlit) if pkg == "jax" else (col, ff, lit)
    return [getattr(f, fn)(lt(src) if isinstance(src, int) else c(src)).alias(name)
            for name, fn, src in spec]


def _compare(got_tbl, exp_tbl, by, f32_cols=()):
    g = got_tbl.sort_by([(k, "ascending") for k in by])
    e = exp_tbl.sort_by([(k, "ascending") for k in by])
    assert g.schema.equals(e.schema), (g.schema, e.schema)
    assert g.num_rows == e.num_rows
    for c in g.column_names:
        gv, ev = g.column(c).to_pylist(), e.column(c).to_pylist()
        if pa.types.is_floating(g.schema.field(c).type) and c not in by:
            assert [x is None for x in gv] == [x is None for x in ev], c
            gf = np.array([np.nan if x is None else x for x in gv], dtype=float)
            ef = np.array([np.nan if x is None else x for x in ev], dtype=float)
            rtol, atol = (F32_RTOL, F32_ATOL) if c in f32_cols else (F64_RTOL, 0)
            assert np.allclose(gf, ef, rtol=rtol, atol=atol, equal_nan=True), c
        else:
            same = [(x == y) or (x != x and y != y) for x, y in zip(gv, ev)]
            assert all(same), (c, [(x, y) for x, y, s in zip(gv, ev, same) if not s][:5])


def _run_both(jax_engine, engine, data, by, spec, schema=None, f32_cols=()):
    jin = data if schema is None else JPandasDataFrame(data, schema)
    exp = jax_engine.aggregate(jax_engine.to_df(jin), JPartitionSpec(by=by), _aggs("jax", spec))
    tin = data
    if schema is not None:
        tin = pa.Table.from_pandas(data, schema=JPandasDataFrame(data, schema).schema.pa_schema,
                                   preserve_index=False)
    got = engine.aggregate(engine.to_df(tin), PartitionSpec(by=by), _aggs("torch", spec))
    assert isinstance(got, TorchDataFrame)
    _compare(got.as_arrow(), exp.as_arrow(), by, f32_cols)
    return got


FIVE = [("s", "sum", "v"), ("n", "count", "v"), ("m", "avg", "v"), ("lo", "min", "v"), ("hi", "max", "v")]
I64_AGGS = [("s", "sum", "v"), ("m", "avg", "v"), ("lo", "min", "v"), ("hi", "max", "v"), ("c", "count", "v")]


def _int64_nulls(rng, n, base, keys):
    vals = base + rng.integers(-1000, 1000, n).astype(np.int64)
    v = pd.array(np.where(rng.random(n) < 0.2, None, vals), dtype="Int64")
    pdf = pd.DataFrame({"k": rng.integers(0, keys, n), "v": v})
    extra = pd.DataFrame({"k": [keys, keys], "v": pd.array([None, None], dtype="Int64")})
    return pd.concat([pdf, extra], ignore_index=True)  # one all-NULL group


def _case(name, rng):
    """(data, by, spec, schema, f32_cols) of one case."""
    if name == "resident_dense":  # test_device_resident_agg.py
        return pd.DataFrame({"k": rng.integers(0, 500, 50_000), "v": rng.random(50_000)}), ["k"], FIVE, None, ()
    if name == "resident_all_null_group_sparse_range":
        pdf = pd.DataFrame({"k": np.array([5, 5, 900, 900, 42], dtype=np.int32),
                            "v": [1.0, 2.0, np.nan, np.nan, 7.0]})
        return pdf, ["k"], [("s", "sum", "v"), ("m", "avg", "v")], None, ()
    if name == "resident_int_sum_min_max":
        pdf = pd.DataFrame({"k": np.arange(20) % 3, "x": np.arange(20)})
        return pdf, ["k"], [("s", "sum", "x"), ("lo", "min", "x"), ("hi", "max", "x")], None, ()
    if name == "resident_masked_int_2pow62":
        pdf = pd.DataFrame({"k": [0, 0, 1, 1], "x": pd.array([1 << 62, 3, None, None], dtype="Int64")})
        return pdf, ["k"], [("s", "sum", "x")], None, ()
    if name == "int64_null_exact_at_2pow62":  # test_int64_null_agg.py
        return _int64_nulls(rng, 5_000, np.int64(2**62), 19), ["k"], I64_AGGS, "k:long,v:long", ()
    if name == "int64_null_negative_and_mixed":
        pdf = pd.DataFrame({"k": [1, 1, 1, 2, 2],
                            "v": pd.array([-(2**62), 2**62, None, -5, 7], dtype="Int64")})
        return pdf, ["k"], [("s", "sum", "v"), ("lo", "min", "v")], "k:long,v:long", ()
    if name == "int64_null_extremes":
        ii = np.iinfo(np.int64)
        pdf = pd.DataFrame({"k": [1, 1, 1], "v": pd.array([ii.max, ii.min, None], dtype="Int64")})
        return pdf, ["k"], [("lo", "min", "v"), ("hi", "max", "v"), ("c", "count", "v")], "k:long,v:long", ()
    if name == "encoded_string_key":  # test_encoded_columns.py
        pdf = pd.DataFrame({"s": rng.choice(np.array(["apple", "pear", "fig", None], dtype=object), 400).tolist(),
                            "v": rng.random(400)})
        return pdf, ["s"], [("t", "sum", "v"), ("n", "count", "v")], None, ()
    if name == "encoded_nullable_int_values":
        pdf = pd.DataFrame({"k": [1, 1, 2, 2, 3], "a": pd.array([10, None, None, None, 5], dtype="Int32")})
        return pdf, ["k"], [("s", "sum", "a"), ("n", "count", "a"), ("m", "max", "a")], None, ()
    if name == "encoded_nullable_int_key":
        pdf = pd.DataFrame({"k": pd.array([1, 1, None, None, 2], dtype="Int64"), "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
        return pdf, ["k"], [("s", "sum", "v")], None, ()
    if name == "encoded_datetime_key":
        pdf = pd.DataFrame({"d": pd.to_datetime(["2020-01-01", "2020-01-01", "2021-05-05", None]),
                            "v": [1.0, 2.0, 3.0, 4.0]})
        return pdf, ["d"], [("s", "sum", "v")], None, ()
    if name == "encoded_string_min_max":
        s = rng.choice(np.array(["pear", "apple", "zebra", "fig"], dtype=object), 200)
        s[rng.integers(0, 200, 20)] = None
        pdf = pd.DataFrame({"k": rng.integers(0, 5, 200), "s": s.tolist()})
        return pdf, ["k"], [("lo", "min", "s"), ("hi", "max", "s"), ("n", "count", "s")], None, ()
    n = 3_001
    v32 = (rng.random(n) * 10).astype(np.float32)
    v32[rng.random(n) < 0.1] = np.nan
    if name == "multi_key_string_int_float32":
        pdf = pd.DataFrame({"g": rng.choice(np.array(["x", "", "ü", None], dtype=object), n).tolist(),
                            "k": rng.integers(-2, 2, n).astype(np.int16), "v": v32})
        return pdf, ["g", "k"], FIVE + [("all", "count", "*")], None, ("s", "m")
    if name == "nan_float_key":
        f = rng.integers(0, 4, n) / 2.0
        f[rng.random(n) < 0.2] = np.nan
        return pd.DataFrame({"f": f, "v": v32}), ["f"], FIVE, None, ("s", "m")
    if name == "float32_key_without_nan":
        f = (rng.integers(-3, 3, n) / 4.0).astype(np.float32)
        return pd.DataFrame({"f": f, "v": v32}), ["f"], FIVE, None, ("s", "m")
    if name == "bool_key":
        return pd.DataFrame({"b": rng.random(n) < 0.4, "v": v32}), ["b"], FIVE, None, ("s", "m")
    if name == "nullable_bool_key_and_value":
        b = pd.array(np.where(rng.random(n) < 0.2, None, rng.random(n) < 0.5), dtype="boolean")
        w = pd.array(np.where(rng.random(n) < 0.3, None, rng.random(n) < 0.5), dtype="boolean")
        return (pd.DataFrame({"b": b, "w": w, "v": v32}), ["b"],
                [("n", "count", "w"), ("lo", "min", "w"), ("s", "sum", "v")], None, ("s",))
    if name == "timestamp_tz_key":
        us = rng.integers(0, 5, n) * 3_600_000_000 + 1_600_000_000_000_000
        t = pa.array(us, pa.int64(), mask=rng.random(n) < 0.1).cast(pa.timestamp("us", tz="UTC"))
        return pa.table({"t": t, "v": v32}), ["t"], FIVE, None, ("s", "m")
    if name == "wide_int64_key":
        k = rng.integers(-(1 << 62), 1 << 62, 50)[rng.integers(0, 50, n)]
        return pd.DataFrame({"k": k, "v": v32}), ["k"], FIVE, None, ("s", "m")
    if name == "wide_int32_key_many_groups":
        k = rng.integers(0, 1 << 30, n).astype(np.int32)
        return pd.DataFrame({"k": k, "v": v32}), ["k"], FIVE, None, ("s", "m")
    if name == "count_star_and_count_1":
        return (pd.DataFrame({"k": rng.integers(0, 7, n), "v": v32}), ["k"],
                [("a", "count", "*"), ("b", "count", 1), ("n", "count", "v")], None, ())
    if name == "dict_min_max_string_key":
        g = rng.choice(np.array(["b", "a", "c", None], dtype=object), n)
        t = rng.choice(np.array(["zz", "y", "", None], dtype=object), n)
        return (pd.DataFrame({"g": g.tolist(), "t": t.tolist()}), ["g"],
                [("lo", "min", "t"), ("hi", "max", "t"), ("n", "count", "t"), ("all", "count", "*")], None, ())
    if name == "string_key_small_dict_f32_sum":  # the dense partials route: B1
        g = rng.choice(np.array(list("gfedcba"), dtype=object), n)
        return pd.DataFrame({"g": g.tolist(), "v": v32}), ["g"], FIVE, None, ("s", "m")
    if name == "nullable_int8_values_int16_key":
        a = pd.array(np.where(rng.random(n) < 0.3, None, rng.integers(-128, 128, n)), dtype="Int8")
        k = pd.array(np.where(rng.random(n) < 0.1, None, rng.integers(-5, 5, n)), dtype="Int16")
        return (pd.DataFrame({"k": k, "a": a}), ["k"],
                [("s", "sum", "a"), ("m", "avg", "a"), ("lo", "min", "a"), ("hi", "max", "a")], None, ())
    raise KeyError(name)  # pragma: no cover


CASES = [
    "resident_dense", "resident_all_null_group_sparse_range", "resident_int_sum_min_max",
    "resident_masked_int_2pow62", "int64_null_exact_at_2pow62", "int64_null_negative_and_mixed",
    "int64_null_extremes", "encoded_string_key", "encoded_nullable_int_values",
    "encoded_nullable_int_key", "encoded_datetime_key", "encoded_string_min_max",
    "multi_key_string_int_float32", "nan_float_key", "float32_key_without_nan", "bool_key",
    "nullable_bool_key_and_value", "timestamp_tz_key", "wide_int64_key",
    "wide_int32_key_many_groups", "count_star_and_count_1", "dict_min_max_string_key",
    "string_key_small_dict_f32_sum", "nullable_int8_values_int16_key",
]


@pytest.mark.parametrize("case", CASES)
def test_aggregate_matches_jax_engine(jax_engine, engine, case):
    data, by, spec, schema, f32_cols = _case(case, np.random.default_rng(len(case)))
    got = _run_both(jax_engine, engine, data, by, spec, schema, f32_cols)
    if case.startswith("resident_") and case != "resident_masked_int_2pow62":
        # the dense route finishes on the device: no host table, a valid mask
        assert got.host_table is None and got.valid_mask is not None
    if case == "int64_null_exact_at_2pow62":
        # exact against the pandas Int64 answer, as the JAX package's test holds it
        res = got.as_arrow().sort_by("k").to_pydict()
        grp = data.groupby("k")["v"]
        sums, mins, cnts = grp.sum(min_count=1), grp.min(), grp.count()
        for k, s, lo, c in zip(res["k"], res["s"], res["lo"], res["c"]):
            if k == 19:  # the all-NULL group
                assert s is None and lo is None and c == 0
                continue
            assert (s, lo, c) == (int(sums[k]), int(mins[k]), int(cnts[k])), k


def test_nullable_int_key_makes_null_its_own_group(engine):
    pdf = pd.DataFrame({"k": pd.array([1, 1, None, None, 2, 0], dtype="Int64"),
                        "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]})
    got = engine.aggregate(engine.to_df(pdf), PartitionSpec(by=["k"]), [ff.sum(col("v")).alias("s")])
    rows = sorted(zip(*got.as_arrow().to_pydict().values()), key=lambda r: (r[0] is None, r[0]))
    assert rows == [(0, 6.0), (1, 3.0), (2, 5.0), (None, 7.0)]


def test_string_key_with_small_dictionary_takes_the_dense_route(engine, monkeypatch):
    # one dictionary key whose codes span 8 buckets: the dense partials
    # route, through bin_sum for each float32 SUM (plain on the CPU)
    calls = []
    real = bin_groupby.bin_sum_idx
    monkeypatch.setattr("fugue_tpu_torch.ops.segment.bin_sum_idx",
                        lambda idx, v, b: calls.append(b) or real(idx, v, b))
    pdf = pd.DataFrame({"s": list("abcdefga"), "v": np.arange(8, dtype=np.float32)})
    got = engine.aggregate(engine.to_df(pdf), PartitionSpec(by=["s"]),
                           [ff.sum(col("v")).alias("t"), ff.avg(col("v")).alias("m")])
    assert calls == [8]  # AVG's SUM is the SUM already taken
    assert {r["s"]: r["t"] for r in got.as_arrow().to_pylist()} == {
        "a": 7.0, "b": 1.0, "c": 2.0, "d": 3.0, "e": 4.0, "f": 5.0, "g": 6.0}


def test_carried_jax_state_with_encodings(jax_engine, engine):
    # a JAX frame's device state, dictionaries and masks go into the port
    rng = np.random.default_rng(21)
    n = 1_001
    pdf = pd.DataFrame({
        "s": rng.choice(np.array(["x", "y", None], dtype=object), n).tolist(),
        "k": pd.array(np.where(rng.random(n) < 0.2, None, rng.integers(0, 3, n)), dtype="Int32"),
        "v": rng.random(n),
    })
    jdf = jax_engine.to_df(pdf)
    spec = [("t", "sum", "v"), ("hi", "max", "s"), ("c", "count", "*")]
    exp = jax_engine.aggregate(jdf, JPartitionSpec(by=["s", "k"]), _aggs("jax", spec))
    tdf = frame_from_numpy(
        {c: np.asarray(a) for c, a in jdf.device_cols.items()}, str(jdf.schema),
        valid=np.asarray(jdf.device_valid_mask()),
        nan_cols=[c for c in jdf.device_cols if jdf.maybe_nan(c)],
        encodings=jdf.encodings, null_masks={c: np.asarray(m) for c, m in jdf.null_masks.items()},
        device="cpu",
    )
    got = engine.aggregate(tdf, PartitionSpec(by=["s", "k"]), _aggs("torch", spec))
    _compare(got.as_arrow(), exp.as_arrow(), ["s", "k"])


def test_key_range_matches_the_jax_device_probe(jax_engine):
    # masked and encoded columns take the device probe in both packages
    pdf = pd.DataFrame({"k": pd.array([5, 10, None], dtype="Int64"), "s": ["a", "b", "c"], "p": [1, 2, 3]})
    jdf = jax_engine.to_df(pdf)
    tdf = TorchDataFrame(pdf, device="cpu")
    for c in ("k", "s", "p"):
        assert tdf.key_range(c) == jdf.key_range(c), c


def test_empty_input_goes_through_the_sorted_route(jax_engine, engine):
    pdf = pa.table({"s": pa.array([], pa.string()), "k": pa.array([], pa.int64()),
                    "v": pa.array([], pa.float32())})
    spec = [("t", "sum", "v"), ("c", "count", "*")]
    for by in (["k"], ["s", "k"]):
        got = _run_both(jax_engine, engine, pdf, by, spec)
        assert got.count() == 0


@pytest.mark.parametrize("name,orders", [("q1-keys", 5_000), ("q18-orderkey", 70_000), ("shipmode", 5_000)])
def test_sorted_path_aggregates_of_the_smoke(jax_engine, engine, name, orders):
    # chip_smoke.py's sorted_path phase at 20k rows (280k for q18, whose key
    # range must pass the dense table's 2**18 as at full size): the port
    # against the JAX engine, and against the smoke's float64 oracle and check
    tbl, aux = chip_smoke.make_lineitem(np, pa, seed=0, orders=orders, parts=20_000)
    assert 3 * orders < tbl.num_rows < 5 * orders
    by, aggs = chip_smoke.sorted_path_aggs(ff, col)[name]
    jby, jaggs = chip_smoke.sorted_path_aggs(jff, jcol)[name]
    got = api.aggregate(tbl, partition_by=by, engine=engine, as_fugue=True, **aggs)
    exp = jax_engine.aggregate(jax_engine.to_df(tbl), JPartitionSpec(by=jby),
                               [v.alias(k) for k, v in jaggs.items()])
    f32 = {"sum_qty", "avg_qty", "avg_disc"}
    _compare(got.as_arrow(), exp.as_arrow(), by, f32)
    assert got.valid_mask is None  # the partials route, not the dense device finish
    oracle = chip_smoke.lineitem_oracles(np, pd, tbl, aux)[name]
    chip_smoke.check_lineitem(np, got.as_pandas(), oracle, by, name)


def test_date32_key_where_the_reference_raises(jax_engine, engine):
    # fault C3 (ROADMAP.md C): the JAX engine decodes a date32 key's
    # partials with an int64 → date32 cast, which arrow does not have, so
    # every aggregate by a date32 key raises there. The port casts through
    # int32 and is held against pandas here.
    rng = np.random.default_rng(5)
    n = 2_001
    days = rng.integers(18_000, 18_010, n).astype(np.int32)
    tbl = pa.table({"d": pa.array(days, pa.int32(), mask=rng.random(n) < 0.1).cast(pa.date32()),
                    "v": rng.random(n), "w": rng.integers(0, 9, n)})
    with pytest.raises(pa.ArrowNotImplementedError, match="int64 to date32"):
        jax_engine.aggregate(jax_engine.to_df(tbl), JPartitionSpec(by=["d"]),
                             [jff.sum(jcol("v")).alias("s")])
    got = engine.aggregate(engine.to_df(tbl), PartitionSpec(by=["d", "w"]),
                           [ff.sum(col("v")).alias("s"), ff.count(col("*")).alias("c")])
    assert str(got.schema) == "d:date,w:long,s:double,c:long"
    exp = tbl.group_by(["d", "w"], use_threads=False).aggregate([("v", "sum"), ([], "count_all")])
    order = [("d", "ascending"), ("w", "ascending")]
    g, e = got.as_arrow().sort_by(order), exp.sort_by(order)
    assert g.column("d").to_pylist() == e.column("d").to_pylist() and g.column("d").null_count > 0
    assert g.column("w").to_pylist() == e.column("w").to_pylist()
    assert g.column("c").to_pylist() == e.column("count_all").to_pylist()
    assert np.allclose(g.column("s").to_numpy(), e.column("v_sum").to_numpy(), rtol=F64_RTOL, atol=0)
