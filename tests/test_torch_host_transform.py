"""``fugue_tpu_torch.api.transform`` with host transformers (device="cpu")
against ``fugue_tpu.api.transform`` on ``JaxExecutionEngine`` (the
8-device CPU mesh), on the same inputs made from a seed with numpy. Both
engines map these on their host engines (``PandasMapEngine``): each
annotation form, ``Transformer`` classes with ``on_init``,
``@transformer``, ``# schema:`` comments, ``*`` expressions, ``params``,
``ignore_errors``, presorts, keyless partition counts, NULL, NaN and
dictionary-string keys, empty frames, a one-pass stream, and
``out_transform``; then the refusals of what is not ported (ROADMAP.md
A.10), and ``chip_smoke.py``'s ``host_path`` phase at small size.

Results are compared after sorting by every column (the JAX package's
host map runs over its device frame's rows, the port's over its own):
schemas, keys, row counts and NULL placement exact; floats with pandas'
``assert_frame_equal`` default (``rtol=1e-5``), as the reference's own
tests compare.
"""

import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import fugue_tpu.api as fa
import fugue_tpu.dataframe as jdf
import fugue_tpu.extensions as jtr
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu_torch import api
from fugue_tpu_torch import dataframe as tdf
from fugue_tpu_torch import extensions as ttr
from fugue_tpu_torch.exceptions import FugueWorkflowRuntimeValidationError
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine()
    yield e
    e.stop()


@pytest.fixture(scope="module")
def engine():
    return TorchExecutionEngine(device="cpu")


def _frame(n: int = 200, seed: int = 0, keys: str = "int") -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 7, n)
    if keys == "null":
        k = pd.array(np.where(rng.random(n) < 0.2, None, k), dtype="Int64")
    elif keys == "nan":
        k = np.where(rng.random(n) < 0.2, np.nan, k.astype(np.float64))
    elif keys == "str":
        k = np.array(["ant", "bee", "cat", None], dtype=object)[rng.integers(0, 4, n)]
    return pd.DataFrame({"k": k, "v": rng.random(n)})


def _sorted(pdf: pd.DataFrame) -> pd.DataFrame:
    return pdf.sort_values(list(pdf.columns)).reset_index(drop=True)


def _check(jax_engine, engine, data, jax_using, torch_using=None, port_data=None, **kw):
    """The port's transform of ``data`` (``port_data``, where the packages'
    frames differ) against the JAX engine's; the port's result comes back
    on its device."""
    exp = fa.transform(data if isinstance(data, jdf.DataFrame) else jax_engine.to_df(data),
                       jax_using, engine=jax_engine, as_fugue=True, **kw)
    got = api.transform(data if port_data is None else port_data, torch_using or jax_using,
                        engine=engine, as_fugue=True, **kw)
    assert isinstance(got, TorchDataFrame) and got.device == engine.device
    assert str(got.schema) == str(exp.schema)
    pd.testing.assert_frame_equal(_sorted(got.as_pandas()), _sorted(exp.as_pandas()), check_dtype=False)
    return got, exp


# ---- the annotation forms ---------------------------------------------------


def pandas_form(df: pd.DataFrame) -> pd.DataFrame:
    return df.assign(n=len(df))


def arrow_form(t: pa.Table) -> pa.Table:
    return t.append_column("n", pa.array([t.num_rows] * t.num_rows, pa.int64()))


def list_form(rows: List[List[Any]]) -> List[List[Any]]:
    return [r + [len(rows)] for r in rows]


def dict_form(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [dict(r, n=len(rows)) for r in rows]


def iter_pandas_form(dfs: Iterable[pd.DataFrame]) -> Iterable[pd.DataFrame]:
    for df in dfs:
        yield df.assign(n=len(df))


def iter_list_form(rows: Iterable[List[Any]]) -> Iterable[List[Any]]:
    rows = list(rows)
    for r in rows:
        yield r + [len(rows)]


def _local_form(pkg):
    def local_form(df: pkg.LocalDataFrame) -> pkg.LocalDataFrame:
        return pkg.PandasDataFrame(df.as_pandas().assign(n=df.count()), df.schema + "n:long")

    return local_form


FORMS = {
    "pd.DataFrame": (pandas_form, pandas_form),
    "pa.Table": (arrow_form, arrow_form),
    "List[List[Any]]": (list_form, list_form),
    "List[Dict[str, Any]]": (dict_form, dict_form),
    "Iterable[pd.DataFrame]": (iter_pandas_form, iter_pandas_form),
    "Iterable[List[Any]]": (iter_list_form, iter_list_form),
    "LocalDataFrame": (_local_form(jdf), _local_form(tdf)),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_annotation_forms(jax_engine, engine, form):
    jf, tf = FORMS[form]
    _check(jax_engine, engine, _frame(), jf, tf, schema="*,n:long", partition={"by": ["k"]})


@pytest.mark.parametrize("keys", ["null", "nan", "str"])
def test_null_nan_and_string_keys_group_as_the_reference(jax_engine, engine, keys):
    """A NULL (or NaN) key is one group of its own, sorted first."""
    got, _ = _check(jax_engine, engine, _frame(keys=keys), pandas_form, schema="*,n:long",
                    partition={"by": ["k"]})
    pdf = _frame(keys=keys)
    assert sorted(got.as_pandas()["n"].unique()) == sorted(pdf.groupby("k", dropna=False).size().unique())


# ---- transformers, schemas, params ------------------------------------------


def _init_transformer(pkg_transformer, pkg):
    class AddBase(pkg_transformer.Transformer):
        def get_output_schema(self, df):
            return df.schema + "m:double"

        def on_init(self, df):
            self.base = 10.0 + self.params.get("a", 0)

        def transform(self, df):
            pdf = df.as_pandas()
            pdf["m"] = pdf["v"] + self.base + self.cursor.key_value_dict["k"]
            return pkg.PandasDataFrame(pdf, self.output_schema)

    return AddBase


@pytest.mark.parametrize("as_instance", [False, True])
def test_transformer_class_with_on_init(jax_engine, engine, as_instance):
    jc, tc = _init_transformer(jtr, jdf), _init_transformer(ttr, tdf)
    _check(jax_engine, engine, _frame(), jc() if as_instance else jc, tc() if as_instance else tc,
           params={"a": 5}, partition={"by": ["k"]})


def test_transformer_decorator(jax_engine, engine):
    def body(df: pd.DataFrame) -> pd.DataFrame:
        return df.assign(m=df["v"] * 2)

    _check(jax_engine, engine, _frame(), jtr.transformer("*,m:double")(body),
           ttr.transformer("*,m:double")(body), partition={"by": ["k"]})


# schema: *,m:double
def commented(df: pd.DataFrame) -> pd.DataFrame:
    return df.assign(m=df["v"].cumsum())


def test_schema_comment(jax_engine, engine):
    _check(jax_engine, engine, _frame(), commented, partition={"by": ["k"], "presort": "v"})


def identity(df: pd.DataFrame) -> pd.DataFrame:
    return df


def add_d(df: pd.DataFrame) -> pd.DataFrame:
    return df.assign(d=df["v"] + 1)


def keys_only(df: pd.DataFrame) -> pd.DataFrame:
    return df[["k"]]


def keys_and_d(df: pd.DataFrame) -> pd.DataFrame:
    return df[["k"]].assign(d=df["v"] * 3)


STAR_SCHEMAS = {"*": identity, "*,d:double": add_d, "*,-v": keys_only, "*,d:double,~v,~w": keys_and_d}


@pytest.mark.parametrize("schema", sorted(STAR_SCHEMAS))
def test_star_schemas(jax_engine, engine, schema):
    """``*`` is the input's columns; ``-v`` drops v, ``~w`` drops w where it is."""
    _check(jax_engine, engine, _frame(), STAR_SCHEMAS[schema], schema=schema, partition={"by": ["k"]})


def scaled(df: pd.DataFrame, a: float, b: int = 1) -> pd.DataFrame:
    return df.assign(v=df["v"] * a + b)


def test_params(jax_engine, engine):
    _check(jax_engine, engine, _frame(), scaled, schema="*", params={"a": 2.5, "b": 4},
           partition={"by": ["k"]})


def fails_on_three(df: pd.DataFrame) -> pd.DataFrame:
    if (df["k"] == 3).any():
        raise ValueError("three")
    return df


@pytest.mark.parametrize("error", [ValueError, "ValueError"])
def test_ignore_errors(jax_engine, engine, error):
    got, _ = _check(jax_engine, engine, _frame(), fails_on_three, schema="*", partition={"by": ["k"]},
                    ignore_errors=[error])
    assert 3 not in set(got.as_pandas()["k"])
    with pytest.raises(ValueError, match="three"):
        api.transform(_frame(), fails_on_three, schema="*", partition={"by": ["k"]}, engine=engine)


def first_row(df: pd.DataFrame) -> pd.DataFrame:
    return df.head(1)


@pytest.mark.parametrize("presort", ["v desc", "v asc"])
def test_presort(jax_engine, engine, presort):
    _check(jax_engine, engine, _frame(), first_row, schema="*", partition={"by": ["k"], "presort": presort})


def count_rows(df: pd.DataFrame) -> pd.DataFrame:
    return pd.DataFrame({"n": [len(df)], "s": [df["v"].sum()]})


@pytest.mark.parametrize("num", [1, 3, "ROWCOUNT/50"])
def test_keyless_partition_counts(jax_engine, engine, num):
    got, _ = _check(jax_engine, engine, _frame(), count_rows, schema="n:long,s:double",
                    partition={"num": num})
    assert got.as_pandas()["n"].sum() == 200


def test_validation_rules_of_a_comment(engine):
    # input_has: w
    def needs_w(df: pd.DataFrame) -> pd.DataFrame:
        return df

    with pytest.raises(FugueWorkflowRuntimeValidationError):
        api.transform(_frame(), needs_w, schema="*", engine=engine)


# ---- frames ---------------------------------------------------------------------


def test_empty_frame(jax_engine, engine):
    empty = pd.DataFrame({"k": pd.Series([], dtype="int64"), "v": pd.Series([], dtype="float64")})
    got, exp = _check(jax_engine, engine, empty, pandas_form, schema="*,n:long", partition={"by": ["k"]})
    assert got.count() == exp.count() == 0
    res = api.transform(empty, pandas_form, schema="*,n:long", engine=engine)
    assert isinstance(res, pd.DataFrame) and list(res.columns) == ["k", "v", "n"] and len(res) == 0


def test_stream_into_a_pandas_udf(jax_engine, engine):
    """A one-pass stream handed to a host transformer is read whole."""
    parts = [_frame(100, seed=i) for i in range(3)]
    jstream = jdf.LocalDataFrameIterableDataFrame([jdf.PandasDataFrame(p) for p in parts], "k:long,v:double")
    tstream = tdf.LocalDataFrameIterableDataFrame(iter(parts), "k:long,v:double")
    _check(jax_engine, engine, jstream, pandas_form, schema="*,n:long", partition={"by": ["k"]},
           port_data=tstream)


def test_input_and_result_families(engine):
    pdf = _frame()
    assert isinstance(api.transform(pdf, pandas_form, schema="*,n:long", engine=engine), pd.DataFrame)
    tbl = pa.Table.from_pandas(pdf)
    assert isinstance(api.transform(tbl, pandas_form, schema="*,n:long", engine=engine), pa.Table)
    local = api.transform(pdf, pandas_form, schema="*,n:long", engine=engine, as_fugue=True, as_local=True)
    assert isinstance(local, tdf.LocalBoundedDataFrame) and local.count() == 200


# ---- out_transform ----------------------------------------------------------------


def test_out_transform(jax_engine, engine):
    seen: Dict[str, List[int]] = {"jax": [], "torch": []}

    def sink(name):
        def record(df: pd.DataFrame) -> None:
            seen[name].append(len(df))

        return record

    fa.out_transform(jax_engine.to_df(_frame()), sink("jax"), partition={"by": ["k"]}, engine=jax_engine)
    api.out_transform(_frame(), sink("torch"), partition={"by": ["k"]}, engine=engine)
    assert sorted(seen["torch"]) == sorted(seen["jax"]) and sum(seen["torch"]) == 200


# ---- the forked pool (ROADMAP.md A.10) and callbacks ----------------------------------


def reporting_form(df: pd.DataFrame, cb: callable) -> pd.DataFrame:
    cb(len(df))
    return df.assign(n=len(df))


@pytest.mark.parametrize("case", ["pool", "callback"])
def test_pool_and_callbacks_are_refused(jax_engine, engine, case):
    """The host map's forked pool and callbacks, refused under this name
    until they were ported, run. The pool (``fugue.tpu.map.parallelism``
    2) gives the JAX engine's pooled answer. A callback reaches the
    function once a partition through ``api.transform`` and
    ``api.out_transform``, with the rows the JAX engine sends it."""
    if case == "pool":
        conf = {"fugue.tpu.map.parallelism": 2, "fugue.tpu.map.parallel_min_rows": 0}
        eng = TorchExecutionEngine(device="cpu", conf=conf)
        got = api.transform(_frame(), pandas_form, schema="*,n:long", partition={"by": ["k"]}, engine=eng)
        jeng = JaxExecutionEngine(conf)
        exp = fa.transform(_frame(), pandas_form, schema="*,n:long", partition={"by": ["k"]}, engine=jeng)
        jeng.stop()
        cols = ["k", "v", "n"]
        assert got.sort_values(cols)[cols].values.tolist() == exp.sort_values(cols)[cols].values.tolist()
        assert eng.resilience_stats.as_dict()["map.chunks_ok"] >= 2
        return
    seen: Dict[str, List[int]] = {"jax": [], "torch": [], "jax_out": [], "torch_out": []}
    exp = fa.transform(_frame(), reporting_form, schema="*,n:long", partition={"by": ["k"]},
                       callback=seen["jax"].append, engine=jax_engine)
    got = api.transform(_frame(), reporting_form, schema="*,n:long", partition={"by": ["k"]},
                        callback=seen["torch"].append, engine=engine)
    fa.out_transform(_frame(), reporting_form, partition={"by": ["k"]}, callback=seen["jax_out"].append,
                     engine=jax_engine)
    api.out_transform(_frame(), reporting_form, partition={"by": ["k"]}, callback=seen["torch_out"].append,
                      engine=engine)
    assert sorted(seen["torch"]) == sorted(seen["jax"]) and sum(seen["torch"]) == 200
    assert sorted(seen["torch_out"]) == sorted(seen["jax_out"]) == sorted(seen["jax"])
    cols = ["k", "v", "n"]
    assert got.sort_values(cols)[cols].values.tolist() == exp.sort_values(cols)[cols].values.tolist()


def test_strings_and_cotransformers_are_refused(engine, jax_engine):
    """A transformer named by a string resolves since the extension
    registry is ported (ROADMAP.md A.11's workflow part): in the caller's
    scope, as the function it names. A cotransformer (a function of two
    frames) runs over a zipped frame as the JAX engine runs it, and over a
    frame that is not zipped raises what the reference raises, with the
    same exception class (the test keeps its name from when the port
    refused cotransformers)."""
    from fugue_tpu.collections import PartitionSpec as JPartitionSpec
    from fugue_tpu_torch.collections import PartitionSpec

    def two(a: pd.DataFrame, b: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"k": [a["k"].iloc[0]], "n": [len(a) + len(b)], "s": [a["v"].sum()]})

    by_name = api.transform(_frame(), "pandas_form", schema="*,n:long", engine=engine)
    by_func = api.transform(_frame(), pandas_form, schema="*,n:long", engine=engine)
    pd.testing.assert_frame_equal(by_name, by_func)
    a, b = _frame(120, 1), _frame(80, 2)
    z = engine.zip(tdf.DataFrames(engine.to_df(a), engine.to_df(b)), partition_spec=PartitionSpec(by=["k"]))
    jz = jax_engine.zip(jdf.DataFrames(jax_engine.to_df(a), jax_engine.to_df(b)),
                        partition_spec=JPartitionSpec(by=["k"]))
    got = api.transform(z, two, schema="k:long,n:long,s:double", engine=engine, as_fugue=True).as_pandas()
    exp = fa.transform(jz, two, schema="k:long,n:long,s:double", engine=jax_engine, as_fugue=True).as_pandas()
    pd.testing.assert_frame_equal(_sorted(got), _sorted(exp), check_dtype=False)
    errs = []
    for mod, eng in ((fa, jax_engine), (api, engine)):
        with pytest.raises(Exception, match="the input of cotransform must be a zipped dataframe") as err:
            mod.transform(_frame(), two, schema="*", engine=eng)
        errs.append(type(err.value).__name__)
    assert errs == ["FugueWorkflowError"] * 2


# ---- chip_smoke.py's host_path phase, at small size ----------------------------------


# the phase with the torch.cuda calls it makes as no-ops, in a process of
# its own that loads no JAX, as chip_smoke.py runs on the card; the
# expansion budget is cut so that the small lineitem cell still passes it
_HOST_PATH_ON_THE_CPU = """
import json, sys, numpy as np, pandas as pd, pyarrow as pa, torch
import chip_smoke
from fugue_tpu_torch import api
from fugue_tpu_torch.ops import bin_groupby as bg, join as tj
from fugue_tpu_torch.torch import TorchExecutionEngine, frame_from_numpy
for name in ("synchronize", "reset_peak_memory_stats", "empty_cache", "set_sync_debug_mode"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
tj.MAX_EXPAND_ROWS = 1 << 12
out = chip_smoke.phase_host_path(torch, np, pd, pa, bg, api, frame_from_numpy,
                                 TorchExecutionEngine(device="cpu"), 0, 64_000, 8_000, 17.5)
print("RESULT", json.dumps(out["cells"]))
print("JAX", "jax" in sys.modules or "fugue_tpu" in sys.modules)
"""


def test_chip_smoke_host_path_on_the_cpu():
    """The three cells at small size, each through its oracle, one line
    each; B1/B2 are not launched on this path."""
    res = subprocess.run([sys.executable, "-c", _HOST_PATH_ON_THE_CPU], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert sum(ln.startswith('{"phase": "host_path"') for ln in res.stdout.splitlines()) == 3
    assert "JAX False" in res.stdout
    cells = json.loads(res.stdout.split("RESULT ", 1)[1].splitlines()[0])
    assert sorted(cells) == ["orders-lineitem-expand-sf10", "pandas-demean-100m", "pandas-demean-1m"]
    for line in cells.values():
        assert line["launches"] == {"bin_sum": 0, "bin_sum_count": 0}
        assert line["ms"] > 0 and "profile" in line
        assert set(line["split"]) == {"d2h_ms", "pandas_ms", "h2d_ms"}
    assert cells["pandas-demean-100m"]["compiled_ms"] == 17.5
    assert cells["orders-lineitem-expand-sf10"]["plan"] == "host"
    assert not list(ROOT.glob(".host_path_*"))  # the round trip's files are gone


def test_chip_smoke_demean_oracle_rejects_a_wrong_answer():
    import chip_smoke

    pdf = chip_smoke.udf_frame(np, pd).iloc[:5000]
    k, v = pdf["k"].to_numpy(), pdf["v"].to_numpy()
    res = api.transform(pdf.copy(), chip_smoke.host_udfs(pd)["demean"], schema="*",
                        partition={"by": ["k"]}, device="cpu")
    chip_smoke.check_demean(np, "1m", res["k"].to_numpy(), res["v"].to_numpy(), k, v)
    with pytest.raises(RuntimeError, match="1m"):
        chip_smoke.check_demean(np, "1m", res["k"].to_numpy(), res["v"].to_numpy() + 1e-3, k, v)
    with pytest.raises(RuntimeError, match="1m"):
        chip_smoke.check_demean(np, "1m", res["k"].to_numpy()[1:], res["v"].to_numpy()[1:], k, v)


def test_chip_smoke_expand_oracle_rejects_rows_paired_otherwise(engine):
    """The expansion's oracle compares row multisets by a hash of each
    row: values that stay in their columns but move between rows fail it."""
    import chip_smoke
    import torch

    tbl, aux = chip_smoke.make_lineitem(np, pa, 0, 2000)
    otbl, oaux = chip_smoke.make_orders(np, pa, tbl, aux, 0)
    oaux["totalprice"] = otbl.column("o_totalprice").to_numpy()
    res = api.join(engine.to_df(otbl), engine.to_df(tbl), how="inner", on=["l_orderkey"], engine=engine)
    chip_smoke.check_expand(np, pa, res, tbl, aux, oaux)
    cust = res.device_cols["o_custkey"].clone()
    keys = res.device_cols["l_orderkey"]
    j = int(torch.nonzero(keys != keys[0])[0])  # a row of another order
    cust[0], cust[j] = cust[j].item(), cust[0].item()
    res.device_cols["o_custkey"] = cust
    with pytest.raises(RuntimeError, match="pair"):
        chip_smoke.check_expand(np, pa, res, tbl, aux, oaux)
