"""The PyTorch port stands alone: no module of ``fugue_tpu_torch`` nor
``chip_smoke.py`` imports JAX or ``fugue_tpu``, importing the port's API
loads neither, and the port's engine refuses to start on a machine with
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


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchExecutionEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchExecutionEngine(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.aggregate(None, "k", engine="cuda", s=ff.sum(col("v")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchDataFrame(pa.table({"k": [1]}))
    assert TorchExecutionEngine(device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu").type == "cpu"


def test_unknown_engine_name_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        api.make_execution_engine("jax", device="cpu")
