"""The PyTorch port stands alone: no module of ``fugue_tpu_torch`` nor
``chip_smoke.py`` imports JAX or ``fugue_tpu``, importing the port's API
or running a compiled transform loads neither, and the port's engine refuses to start on a machine with
no card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pyarrow as pa
import pytest
import torch

from fugue_tpu_torch import api
from fugue_tpu_torch.column import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.parallel.device import resolve_device
from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "fugue_tpu")


def _port_files():
    return sorted((ROOT / "fugue_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_exist():
    files = _port_files()
    assert all(p.exists() for p in files)
    assert len(files) > 10


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_or_fugue_tpu_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path} imports {bad}"


def test_importing_the_api_loads_no_jax():
    code = (
        "import sys, fugue_tpu_torch.api, fugue_tpu_torch.torch;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fugue_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_a_compiled_transform_loads_no_jax():
    """The compiled maps (the annotation check, ``group_ops``, the keyed
    sort) run all three forms without loading JAX or ``fugue_tpu``."""
    code = """
import sys
from typing import Dict
import pandas as pd, torch
from fugue_tpu_torch import api
from fugue_tpu_torch.torch import group_ops as go
def f(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if go.SEGMENTS not in cols:  # keyless
        return {"k": cols["k"], "d": cols["v"] * 2}
    return {"k": cols["k"], "d": cols["v"] - go.per_row(cols, go.mean(cols, cols["v"]))}
pdf = pd.DataFrame({"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]})
for part in (None, {"by": ["k"]}, {"by": ["k"], "presort": "v desc"}):
    api.transform(pdf, f, schema="k:long,d:double", partition=part, device="cpu")
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fugue_tpu')]
print(bad); sys.exit(1 if bad else 0)
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchExecutionEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchExecutionEngine(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.aggregate(None, "k", engine="cuda", s=ff.sum(col("v")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.transform(None, lambda c: c, schema="k:long", engine="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchDataFrame(pa.table({"k": [1]}))
    assert TorchExecutionEngine(device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu").type == "cpu"


def test_unknown_engine_name_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        api.make_execution_engine("jax", device="cpu")


def test_the_serving_layer_and_views_load_no_jax():
    """``serve``, ``views`` and ``dist`` import neither JAX nor
    ``fugue_tpu``, and a submission answered by an ``EngineServer`` over
    ``TorchExecutionEngine(device="cpu")`` loads neither."""
    code = """
import sys
import pandas as pd
import fugue_tpu_torch.dist, fugue_tpu_torch.views
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.serve import EngineServer
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow
def build():
    dag = FugueWorkflow()
    dag.df(pd.DataFrame({"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]})).partition_by("k").aggregate(
        s=ff.sum(col("v"))).yield_dataframe_as("r")
    return dag
with EngineServer(TorchExecutionEngine(device="cpu")) as srv:
    got = srv.submit(build).result(timeout=60).yields["r"].result.as_pandas()
assert sorted(got["s"]) == [3.0, 3.0], got
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fugue_tpu')]
print(bad); sys.exit(1 if bad else 0)
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=180
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_warehouse_bag_and_notebook_load_no_jax():
    """``warehouse``, ``bag``, ``dataset`` and ``notebook`` import neither
    JAX nor ``fugue_tpu``, and a mixed pipeline on ``sqlite_torch``
    (SELECT in sqlite, a torch UDF's map, ``CONNECT torch``, ``CONNECT
    sqlite``) loads neither."""
    code = """
import sys
from typing import Dict
import pandas as pd, torch
import fugue_tpu_torch.bag, fugue_tpu_torch.dataset, fugue_tpu_torch.notebook, fugue_tpu_torch.warehouse
from fugue_tpu_torch import ArrayBag, api
from fugue_tpu_torch.torch import group_ops as go
def demean(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"k": cols["k"], "z": (cols["v"] - go.per_row(cols, go.mean(cols, cols["v"]))).float()}
pdf = pd.DataFrame({"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]})
res = api.fugue_sql('''
big = SELECT k, v FROM pdf WHERE v > 0
c = TRANSFORM big PREPARTITION BY k USING demean SCHEMA k:long,z:float
sums = CONNECT torch SELECT k, SUM(z) AS s FROM c GROUP BY k
r = CONNECT sqlite SELECT k, s FROM sums ORDER BY k
''', pdf=pdf, engine="sqlite_torch", device="cpu", as_fugue=True)
assert [r[0] for r in res.as_array()] == [1, 2], res.as_array()
assert ArrayBag([1]).count() == 1
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fugue_tpu')]
print(bad); sys.exit(1 if bad else 0)
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=180
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_dist_tier_loads_no_jax(tmp_path):
    """``dist`` (board, worker, supervisor), ``shuffle`` and
    ``plan/distribute.py`` import neither JAX nor ``fugue_tpu``, and a
    workflow whose join runs as a fragment on a worker of the board
    loads neither."""
    code = """
import os, sys, threading
import pandas as pd
import fugue_tpu_torch.shuffle, fugue_tpu_torch.plan.distribute
from fugue_tpu_torch.column import col, functions as ff
from fugue_tpu_torch.dist import DistWorker
from fugue_tpu_torch.torch import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow
root = sys.argv[1]
for side in ("a", "b"):
    os.makedirs(os.path.join(root, side))
    pd.DataFrame({"k": [1, 2, 3], side: [1.0, 2.0, 3.0]}).to_parquet(os.path.join(root, side, "p.parquet"))
board = os.path.join(root, "board")
conf = {"fugue.tpu.cache.enabled": False, "fugue.tpu.dist.poll_s": 0.01}
w = DistWorker(board, "w0", conf=conf).start()
t = threading.Thread(target=w.serve_forever, kwargs={"stop_file": os.path.join(board, "_stop")}, daemon=True)
t.start()
dag = FugueWorkflow({"fugue.tpu.dist.board": board, "fugue.tpu.dist.buckets": 2})
(dag.load(os.path.join(root, "a"), fmt="parquet").join(dag.load(os.path.join(root, "b"), fmt="parquet"), how="inner",
 on=["k"]).partition_by("k").aggregate(s=ff.sum(col("a") * col("b"))).yield_dataframe_as("r"))
eng = TorchExecutionEngine(device="cpu", conf=conf)
got = dag.run(eng).yields["r"].result.as_pandas()
open(os.path.join(board, "_stop"), "w").close()
t.join(10)
w.stop()
assert sorted(got["s"]) == [1.0, 4.0, 9.0] and eng.stats()["dist"]["workflow_jobs"] == 1, got
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fugue_tpu')]
print(bad); sys.exit(1 if bad else 0)
"""
    res = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, capture_output=True, text=True, timeout=180
    )
    assert res.returncode == 0, res.stdout + res.stderr
