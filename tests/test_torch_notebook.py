"""The port's notebook (``fugue_tpu_torch/notebook``) against the JAX
package's: the case of ``tests/core/test_aux.py``
``test_magic_display_and_highlight``, run through each package in its own
IPython subprocess (an IPython shell started in this process would
register the HTML display for every later test, and the port's process
must not load JAX). The same ``%%fsql native`` and ``%%fsql sqlite``
cells yield the same rows, schemas and frame types into the namespace;
the yielded frames' and a fresh frame's ``_repr_html_`` (an HTML table
with the schema under it) are the same text, and so is the highlight
snippet. In the port's process, a cell with no engine runs on the port's
default, the card: with none and no device it raises, as
``TorchExecutionEngine()`` does, and neither JAX nor ``fugue_tpu`` is
loaded. Outside IPython, ``setup()`` registers nothing in either package
and a frame's ``_repr_html_`` is its type's name."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

CODE = """
import importlib
import json
import sys
PKG = sys.argv[1]
if PKG == "fugue_tpu_torch":
    import torch
    torch.cuda.is_available = lambda: False
from IPython.testing.globalipapp import start_ipython
ip = start_ipython()
nb = importlib.import_module(PKG + ".notebook")
assert nb.setup()
import pandas as pd
ip.user_ns["src"] = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
cell = chr(10).join(["SELECT a, b FROM src WHERE a > 1", "YIELD DATAFRAME AS res"])
out = {}
for eng in ("native", "sqlite"):
    ip.run_cell_magic("fsql", eng, cell.replace("res", "res_" + eng))
    r = ip.user_ns["res_" + eng].result
    out[eng] = {"rows": r.as_array(), "schema": str(r.schema), "type": type(r).__name__,
                "html": r._repr_html_()}
ArrayDataFrame = importlib.import_module(PKG + ".dataframe").ArrayDataFrame
out["html"] = ArrayDataFrame([[1, "x"]], "a:long,b:str")._repr_html_()
out["highlight_js"] = nb.NotebookSetup().highlight_js
if PKG == "fugue_tpu_torch":
    try:
        ip.run_cell_magic("fsql", "", cell)
        raise AssertionError("a cell with no engine ran without a card")
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "fugue_tpu")]
    assert bad == [], bad
print("NB_OK " + json.dumps(out))
"""


def _run(pkg: str) -> dict:
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", CODE, pkg], cwd=ROOT, env=env, capture_output=True,
                          timeout=240)
    lines = [ln for ln in proc.stdout.decode().splitlines() if ln.startswith("NB_OK ")]
    assert proc.returncode == 0 and len(lines) == 1, proc.stderr.decode()[-3000:]
    return json.loads(lines[0][len("NB_OK "):])


def test_magic_display_and_highlight():
    pytest.importorskip("IPython")
    got, want = _run("fugue_tpu_torch"), _run("fugue_tpu")
    assert got["native"]["rows"] == [[2, "y"], [3, "z"]]
    for eng in ("native", "sqlite"):
        assert got[eng] == want[eng], eng
        assert "<table" in got[eng]["html"] and "a:long,b:str" in got[eng]["html"]
    assert got["html"] == want["html"]
    assert "<table" in got["html"] and "a:long,b:str" in got["html"]
    assert got["highlight_js"] == want["highlight_js"] and "fsql" in got["highlight_js"]


def test_setup_outside_ipython_registers_nothing():
    from fugue_tpu.dataframe import ArrayDataFrame as JArrayDataFrame
    from fugue_tpu.notebook import setup as jsetup

    from fugue_tpu_torch.dataframe import ArrayDataFrame
    from fugue_tpu_torch.notebook import setup

    assert setup() is False and jsetup() is False
    got = ArrayDataFrame([[1]], "a:long")._repr_html_()
    assert got == "<pre>ArrayDataFrame</pre>" == JArrayDataFrame([[1]], "a:long")._repr_html_()
