"""Partitioning on one device: ``PartitionSpec(algo=...)`` and
``"per_row"``, the engines' ``repartition`` and ``api.repartition``, the
transforms and workflow verbs over them (``per_row``,
``per_partition_by``), and the keyless compiled map under a presort,
against the JAX package on the same inputs.

The reference runs on its 8-device CPU mesh, where ``rand`` and ``even``
move rows between shards; on one device no row moves. So results are
compared as row sets, sorted by every column, and a per-partition result
is pinned only where the layout fixes it: by the keys, one row a
partition, or the contiguous chunks of a keyless ``num`` on the host
(both engines split the frame in its own order). Also the cases of
``fugue_tpu_test/execution_suite.py`` that the port had left out:
``test_map_per_row`` :565 (and ``test_persist_broadcast``'s repartition
in ``tests/test_torch_select.py``).
"""

from typing import Dict

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import fugue_tpu.api as fa
import fugue_tpu.workflow as jwf
from fugue_tpu.collections import PartitionSpec as JPartitionSpec
from fugue_tpu.dataframe import ArrayDataFrame as JArrayDataFrame
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu_torch import api
import fugue_tpu_torch.workflow as twf
from fugue_tpu_torch.collections import PartitionSpec
from fugue_tpu_torch.collections.partition import PartitionSpecError
from fugue_tpu_torch.dataframe import ArrayDataFrame
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine

# the JAX package's result cache would serve a DAG it ran before
REF_CONF = {"fugue.tpu.cache.enabled": False}
SPECS = [
    {"by": ["k"], "algo": "even"},
    {"algo": "rand", "num": 2},
    {"num": "ROWCOUNT", "algo": "even"},
    {"by": ["k"], "algo": "hash"},
]
SPEC_IDS = ["by-even", "rand-2", "rowcount-even", "by-hash"]


@pytest.fixture(scope="module")
def jax_engine():
    e = JaxExecutionEngine(REF_CONF)
    yield e
    e.stop()


@pytest.fixture(scope="module", params=["native", "torch"])
def engine(request):
    return NativeExecutionEngine() if request.param == "native" else TorchExecutionEngine(device="cpu")


def _frame(n: int = 60, seed: int = 7) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 5, n), "v": rng.random(n)})


def _rows(df) -> pd.DataFrame:
    pdf = df if isinstance(df, pd.DataFrame) else df.as_pandas()
    return pdf.sort_values(list(pdf.columns)).reset_index(drop=True)


def _size(df: pd.DataFrame) -> pd.DataFrame:
    """Each row with the size of its partition."""
    return df.assign(n=len(df))


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_spec_reads_as_the_reference(spec):
    """``algo``, ``num``, the keys, ``empty`` and the uuid-bearing
    ``jsondict`` as the JAX package reads them, and every spec a
    different uuid."""
    p, j = PartitionSpec(spec), JPartitionSpec(spec)
    assert (p.algo, p.num_partitions, p.partition_by, p.empty) == (
        j.algo, j.num_partitions, j.partition_by, j.empty)
    assert p.jsondict["algo"] == j.jsondict["algo"]
    assert len({PartitionSpec(s).__uuid__() for s in SPECS}) == len(SPECS)


def test_per_row_and_algo_words():
    for args in (("per_row",), ("hash",), ("even",), ("rand",), ("coarse",), ("default",),
                 ('{"algo": "even", "by": ["a"]}',), (PartitionSpec("per_row"), {"by": ["a"]})):
        p, j = PartitionSpec(*args), JPartitionSpec(*[JPartitionSpec(a.jsondict) if isinstance(a, PartitionSpec)
                                                      else a for a in args])
        assert (p.algo, p.num_partitions, p.partition_by) == (j.algo, j.num_partitions, j.partition_by)
    assert PartitionSpec().empty and PartitionSpec("default").empty and not PartitionSpec("per_row").empty
    with pytest.raises(PartitionSpecError):
        PartitionSpec(algo="zigzag")
    with pytest.raises(PartitionSpecError):
        PartitionSpec(by=["a"], colour="red")


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_transform_under_spec(jax_engine, engine, spec):
    """A pandas transformer under each spec, on both port engines, equals
    the JAX engine's: every row with the size of its partition."""
    pdf = _frame()
    exp = fa.transform(pdf, _size, schema="*,n:long", partition=spec, engine=jax_engine)
    got = api.transform(pdf, _size, schema="*,n:long", partition=spec, engine=engine)
    pd.testing.assert_frame_equal(_rows(got), _rows(exp))


@pytest.mark.parametrize("spec", SPECS + [{"presort": "v desc"}], ids=SPEC_IDS + ["presort"])
def test_keyless_compiled_map_under_spec(jax_engine, spec):
    """A keyless ``Dict[str, tensor]`` map under a keyless spec (the
    presort too) runs on the device after the repartition, as the JAX
    engine's compiled map does; a keyed spec takes the keyed plans."""
    pdf = _frame()

    def jax_udf(cols: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        return {"k": cols["k"], "w": cols["v"] * 2.0}

    def torch_udf(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": cols["k"], "w": cols["v"] * 2.0}

    exp = fa.transform(pdf, jax_udf, schema="k:long,w:double", partition=spec, engine=jax_engine)
    got = api.transform(pdf, torch_udf, schema="k:long,w:double", partition=spec, device="cpu", as_fugue=True)
    assert isinstance(got, TorchDataFrame)
    pd.testing.assert_frame_equal(_rows(got), _rows(exp))


def test_api_repartition_moves_nothing(jax_engine, engine):
    """``api.repartition`` by hash and per row: the same rows as the JAX
    engine's, and on the torch engine the same tensors (no device copy)."""
    pdf = _frame()
    for spec in ({"by": ["k"], "algo": "hash"}, "per_row", {"algo": "rand"}, {"algo": "coarse"}):
        exp = fa.repartition(pdf, spec, engine=jax_engine)
        got = api.repartition(pdf, spec, engine=engine)
        pd.testing.assert_frame_equal(_rows(got), _rows(exp))
    if isinstance(engine, TorchExecutionEngine):
        tdf = engine.to_df(pdf)
        for spec in ({"by": ["k"], "algo": "hash"}, "per_row"):
            res = api.repartition(tdf, spec, engine=engine)
            assert all(res.device_cols[c] is tdf.device_cols[c] for c in tdf.schema.names)
        assert engine._repartition_single(tdf) is tdf
    assert api.repartition(pdf, PartitionSpec(), engine=engine).equals(pdf)


def test_map_per_row(jax_engine, engine):
    """``execution_suite.py`` ``test_map_per_row`` :565: one row a
    partition through the engine's map."""

    def m(cursor, df):
        rows = df.as_array()
        assert len(rows) == 1
        return ArrayDataFrame([[rows[0][0] * 10]], "a:long")

    def jm(cursor, df):
        rows = df.as_array()
        assert len(rows) == 1
        return JArrayDataFrame([[rows[0][0] * 10]], "a:long")

    exp = jax_engine.map_engine.map_dataframe(jax_engine.to_df(JArrayDataFrame([[1], [2], [3]], "a:long")), jm,
                                              "a:long", JPartitionSpec("per_row"))
    res = engine.map_engine.map_dataframe(engine.to_df(ArrayDataFrame([[1], [2], [3]], "a:long")), m, "a:long",
                                          PartitionSpec("per_row"))
    assert sorted(res.as_array()) == sorted(exp.as_array()) == [[10], [20], [30]]


@pytest.mark.parametrize("verb", ["per_row", "per_partition_by"])
def test_workflow_partition_verbs(jax_engine, engine, verb):
    """``WorkflowDataFrame.per_row`` (one row a partition) and
    ``per_partition_by`` (an even repartition by the keys) through a
    transform, against the reference's workflow on the JAX engine."""
    pdf = _frame(24, seed=8)
    outs = {}
    for name, wf, e in (("ref", jwf, jax_engine), ("port", twf, engine)):
        dag = wf.FugueWorkflow()
        src = dag.df(pdf)
        src = src.per_row() if verb == "per_row" else src.per_partition_by("k")
        spec = src.partition_spec
        assert spec.algo == "even"
        src.transform(_size, schema="*,n:long").yield_dataframe_as("res", as_local=True)
        outs[name] = dag.run(e, REF_CONF if name == "ref" else None)["res"].result
    pd.testing.assert_frame_equal(_rows(outs["port"]), _rows(outs["ref"]))
    if verb == "per_row":
        assert (_rows(outs["port"])["n"] == 1).all()
