"""The port's encoded columns against ``JaxDataFrame``'s: the same arrow
table goes into both frames and back out to arrow.

Exact throughout: the decoded tables, the dictionary codes (they are the
grouping identity), the sorted dictionaries, the null masks and the split
between device and host columns. The JAX frame is built with its ingest
cache off, so its ``as_arrow`` decodes the device columns as the port's
does. Row counts are not multiples of 8: the 8-device test mesh pads rows.
"""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pytest

from fugue_tpu.jax import JaxDataFrame
from fugue_tpu_torch.torch import TorchDataFrame, frame_from_numpy


def _strings(rng, n, words, null_frac):
    vals = rng.choice(np.array(words, dtype=object), n)
    vals[rng.random(n) < null_frac] = None
    return vals.tolist()


def _nullable_ints(rng, n, tp, null_frac=0.25):
    ii = np.iinfo(tp.to_pandas_dtype())
    vals = rng.integers(ii.min, ii.max, n, endpoint=True, dtype=tp.to_pandas_dtype())
    return pa.array(vals, type=tp, mask=rng.random(n) < null_frac)


def _table(case, rng):
    n = 1_003
    if case == "strings":
        words = ["pear", "", "äpfel", "zebra", "Ωmega", "apple", "日本", "fig"]
        return pa.table({"s": pa.array(_strings(rng, n, words, 0.1), pa.string()),
                         "v": rng.random(n)})
    if case == "large_string":
        words = ["b", "a", "c", "", "ba"]
        return pa.table({"s": pa.array(_strings(rng, n, words, 0.2), pa.large_string()),
                         "k": rng.integers(0, 9, n)})
    if case == "all_null_strings":
        return pa.table({"s": pa.array([None] * 21, pa.string()), "k": np.arange(21)})
    if case == "one_string":
        return pa.table({"s": pa.array(["only"] * 9 + [None], pa.string())})
    if case == "nullable_ints":
        return pa.table({str(tp): _nullable_ints(rng, n, tp)
                         for tp in (pa.int8(), pa.int16(), pa.int32(), pa.int64(), pa.uint8())})
    if case == "nullable_bool":
        return pa.table({"b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.3),
                         "c": pa.array(rng.random(n) < 0.5)})
    if case == "date32":
        days = rng.integers(-1_000, 20_000, n).astype(np.int32)
        return pa.table({"d": pa.array(days, pa.int32(), mask=rng.random(n) < 0.1).cast(pa.date32()),
                         "e": pa.array(days, pa.int32()).cast(pa.date32())})
    if case == "timestamps":
        us = rng.integers(-10**15, 2 * 10**15, n)
        mask = rng.random(n) < 0.15
        return pa.table({
            "us": pa.array(us, pa.int64(), mask=mask).cast(pa.timestamp("us")),
            "ns_tz": pa.array(us * 1000, pa.int64(), mask=mask).cast(pa.timestamp("ns", tz="Asia/Tokyo")),
            "us_tz": pa.array(us, pa.int64()).cast(pa.timestamp("us", tz="UTC")),
        })
    if case == "host_columns":
        m = 37
        return pa.table({
            "k": np.arange(m) % 5,
            "dec": pa.array([decimal.Decimal(i) / 100 if i % 4 else None for i in range(m)],
                            pa.decimal128(10, 2)),
            "bin": pa.array([bytes([i, 0, i]) if i % 3 else None for i in range(m)], pa.binary()),
            "lst": pa.array([list(range(i % 4)) for i in range(m)], pa.list_(pa.int64())),
            "st": pa.array([{"x": i, "y": str(i)} for i in range(m)],
                           pa.struct([("x", pa.int32()), ("y", pa.string())])),
            "u16": pa.array(np.arange(m, dtype=np.uint16)),
            "v": np.linspace(0, 1, m),
        })
    raise KeyError(case)  # pragma: no cover


CASES = ["strings", "large_string", "all_null_strings", "one_string", "nullable_ints",
         "nullable_bool", "date32", "timestamps", "host_columns"]


def _jax_frame(tbl):
    jdf = JaxDataFrame(tbl, ingest_cache=False)
    jdf.device_cols  # ingest now
    return jdf


@pytest.mark.parametrize("case", CASES)
def test_round_trip_and_codes_equal_jax_frame(case):
    tbl = _table(case, np.random.default_rng(len(case)))
    jdf = _jax_frame(tbl)
    tdf = TorchDataFrame(tbl, device="cpu")
    n = tbl.num_rows
    assert str(tdf.schema) == str(jdf.schema)
    out = tdf.as_arrow()
    assert out.equals(jdf.as_arrow())
    assert out.equals(tbl.cast(tdf.schema.pa_schema))
    # device and host columns: both packages keep uint16 on their device
    # (the port as int32 values, compared by value below)
    port_host = [] if tdf.host_table is None else tdf.host_table.column_names
    jax_host = [] if jdf.host_table is None else jdf.host_table.column_names
    assert sorted(port_host) == sorted(jax_host)
    for c, arr in tdf.device_cols.items():
        assert np.array_equal(arr.numpy(), np.asarray(jdf.device_cols[c])[:n]), c
    assert sorted(tdf.null_masks) == sorted(jdf.null_masks)
    for c, m in tdf.null_masks.items():
        assert np.array_equal(m.numpy(), np.asarray(jdf.null_masks[c])[:n]), c
    assert sorted(tdf.encodings) == sorted(jdf.encodings)
    for c, enc in tdf.encodings.items():
        jenc = jdf.encodings[c]
        assert enc["kind"] == jenc["kind"] and enc["type"] == jenc["type"], c
        if enc["kind"] == "dict":
            assert enc["dictionary"].equals(jenc["dictionary"]) and enc["sorted"], c
    assert {c for c in tdf.device_cols if tdf.maybe_nan(c)} == {
        c for c in jdf.device_cols if c in tdf.device_cols and jdf.maybe_nan(c)
    }


def test_string_codes_are_sorted_with_null_as_minus_one():
    tbl = pa.table({"s": pa.array(["b", None, "", "a", "b", "é"], pa.string())})
    tdf = TorchDataFrame(tbl, device="cpu")
    assert tdf.encodings["s"]["dictionary"].to_pylist() == ["", "a", "b", "é"]
    assert tdf.device_cols["s"].tolist() == [2, -1, 0, 1, 2, 3]
    assert tdf.key_range("s") == (-1, 3)


def test_key_range_reads_the_device_column_of_masked_and_encoded_columns():
    # the probe sees the fill value of a masked column and the −1 code of a
    # NULL string, as the JAX frame's device probe does
    tbl = pa.table({
        "k": pa.array([5, 10, None], pa.int64()),
        "s": pa.array(["a", None, "c"]),
        "p": pa.array([1, 2, 3], pa.int64()),
    })
    tdf = TorchDataFrame(tbl, device="cpu")
    assert tdf.key_range("k") == (0, 10)
    assert tdf.key_range("s") == (-1, 1)
    assert tdf.key_range("p") == (1, 3)


@pytest.mark.parametrize("case", ["strings", "nullable_ints", "nullable_bool", "timestamps", "host_columns"])
def test_carried_jax_state(case):
    tbl = _table(case, np.random.default_rng(7))
    if case == "host_columns":
        tbl = tbl.drop_columns(["u16"])
    jdf = _jax_frame(tbl)
    valid = np.asarray(jdf.device_valid_mask())
    assert not valid.all()  # padding rows are carried too
    tdf = frame_from_numpy(
        {c: np.asarray(a) for c, a in jdf.device_cols.items()},
        str(jdf.schema),
        valid=valid,
        nan_cols=[c for c in jdf.device_cols if jdf.maybe_nan(c)],
        encodings=jdf.encodings,
        null_masks={c: np.asarray(m) for c, m in jdf.null_masks.items()},
        host_table=jdf.host_table,
        device="cpu",
    )
    assert tdf.count() == tbl.num_rows
    assert tdf.as_arrow().equals(jdf.as_arrow())


def test_carried_unsigned_above_uint8_is_not_ported():
    """Named for the refusal it pinned before the unsigned types above
    uint8 lived on the port's device: the JAX frame's uint16, uint32 and
    uint64 device columns, values 0 and the type's top ones (2**63 - 1 and
    2**63 for uint64), carry across and come back as the same arrow
    columns."""
    for tp in (pa.uint16(), pa.uint32(), pa.uint64()):
        top = int(np.iinfo(tp.to_pandas_dtype()).max)
        vals = [0, 1, top // 2, top // 2 + 1, top - 1, top]
        jdf = _jax_frame(pa.table({"u": pa.array(vals, tp)}))
        tdf = frame_from_numpy({"u": np.asarray(jdf.device_cols["u"])}, str(jdf.schema),
                               valid=np.asarray(jdf.device_valid_mask()), device="cpu")
        assert str(tdf.schema) == str(jdf.schema)
        assert tdf.as_arrow().equals(jdf.as_arrow())
        assert tdf.as_arrow().column("u").to_pylist() == vals


def test_filtered_frame_drops_host_rows_by_the_valid_mask():
    tbl = pa.table({"k": np.arange(6), "dec": pa.array([decimal.Decimal(i) for i in range(6)])})
    valid = np.array([True, False, True, True, False, True])
    tdf = frame_from_numpy({"k": np.arange(6)}, "k:long,dec:decimal(38,0)", valid=valid,
                           host_table=tbl.select(["dec"]), device="cpu")
    out = tdf.as_arrow()
    assert out.column("k").to_pylist() == [0, 2, 3, 5]
    assert out.column("dec").to_pylist() == [decimal.Decimal(i) for i in (0, 2, 3, 5)]


def test_dates_and_timestamps_round_trip_through_pandas():
    pdf = pa.table({
        "d": pa.array([datetime.date(2020, 1, 1), None, datetime.date(1969, 12, 31)]),
        "t": pa.array([datetime.datetime(2020, 1, 1, 3), datetime.datetime(1960, 5, 5), None]),
    }).to_pandas()
    tdf = TorchDataFrame(pdf, device="cpu")
    assert tdf.encodings["t"]["kind"] == "datetime"
    back = tdf.as_pandas()
    assert back["t"].isna().tolist() == [False, False, True]
    assert str(back["t"].iloc[0]) == "2020-01-01 03:00:00"


def _c19_rows(df) -> list:
    return sorted((tuple(None if v is None or v != v else v for v in r) for r in df.as_array()),
                  key=repr)


def test_an_all_null_string_column():
    """C19: a pandas column of only NULLs comes into the torch engine as
    ``str`` (the host engine's ``null`` → ``str``), as into the JAX engine,
    so the filters answer in three-valued logic on the device and an
    aggregate keyed by such a column answers (NULL, 3.0). Held against
    ``JaxExecutionEngine`` on ROADMAP.md §C's three inputs; exact."""
    import pandas as pd

    import fugue_tpu.api as fa
    from fugue_tpu.column import col as jcol
    from fugue_tpu.column import functions as jff
    from fugue_tpu.jax import JaxExecutionEngine
    from fugue_tpu_torch import api
    from fugue_tpu_torch.column import col
    from fugue_tpu_torch.column import functions as ff
    from fugue_tpu_torch.torch import TorchExecutionEngine

    jeng, teng = JaxExecutionEngine(), TorchExecutionEngine(device="cpu")
    frame = pd.DataFrame({"k": [1, 2, 3], "v": [0.1, np.nan, -0.3], "s": [None] * 3})
    keyed = pd.DataFrame({"k": [None, None], "v": [1.0, 2.0]})
    for pdf in (frame, keyed):
        assert str(teng.to_df(pdf).schema) == str(jeng.to_df(pdf).schema)
    assert str(teng.to_df(frame).schema) == "k:long,v:double,s:str"
    got = {
        "ne": api.filter(teng.to_df(frame), col("s") != "a", engine=teng, as_fugue=True),
        "not_gt": api.filter(teng.to_df(frame), ~(col("v") > 0), engine=teng, as_fugue=True),
        "agg": api.aggregate(teng.to_df(keyed), partition_by="k", engine=teng, as_fugue=True,
                             s=ff.sum(col("v"))),
        "distinct": api.distinct(teng.to_df(frame), engine=teng, as_fugue=True),
    }
    exp = {
        "ne": fa.filter(jeng.to_df(frame), jcol("s") != "a", engine=jeng, as_fugue=True),
        "not_gt": fa.filter(jeng.to_df(frame), ~(jcol("v") > 0), engine=jeng, as_fugue=True),
        "agg": fa.aggregate(jeng.to_df(keyed), partition_by="k", engine=jeng, as_fugue=True,
                            s=jff.sum(jcol("v"))),
        "distinct": fa.distinct(jeng.to_df(frame), engine=jeng, as_fugue=True),
    }
    for case in got:
        assert str(got[case].schema) == str(exp[case].schema), case
        assert _c19_rows(got[case]) == _c19_rows(exp[case]), case
    assert _c19_rows(got["ne"]) == []
    assert [r[0] for r in _c19_rows(got["not_gt"])] == [3]
    assert _c19_rows(got["agg"]) == [(None, 3.0)]
    jeng.stop()
