"""``TorchExecutionEngine.join`` on a CUDA card against the port's own CPU
run on the same inputs. Without a card every test here skips. This file
imports no JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_join_cuda.py

Both devices sort stably, so results are compared row for row: exact for
keys, values, codes, masks and row order (a join moves values; it adds
nothing up).
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from fugue_tpu_torch import api
from fugue_tpu_torch.torch import TorchExecutionEngine

pytestmark = pytest.mark.cuda

HOWS = ["inner", "left_outer", "right_outer", "full_outer", "left_semi", "left_anti"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frames(dup: bool, n: int = 1 << 16):
    """A left frame of every key kind and a right frame, unique or
    duplicated in its keys, with NULLs in keys and values."""
    rng = np.random.default_rng(0)
    words = np.array(["ant", "bee", "cat", "dog", "eel"], dtype=object)
    m = n // 8
    i = np.arange(m) % (m // 2 if dup else m)
    right = pd.DataFrame({
        "i": i,
        "s": words[i % 5],
        "w": rng.random(m),
        "c": rng.integers(0, 100, m),
        "t": words[rng.integers(0, 5, m)],
        "d": pd.array(np.where(rng.random(m) < 0.1, None, rng.integers(0, 9, m)), dtype="Int32"),
    })
    right.loc[3, "w"] = np.nan
    left = pd.DataFrame({
        "i": rng.integers(0, 2 * m, n),
        "s": words[rng.integers(0, 5, n)],
        "v": rng.random(n),
    })
    left.loc[::97, "s"] = None
    return left, right


def _both(cuda_device, left, right, how):
    out = []
    for dev in ("cpu", cuda_device):
        e = TorchExecutionEngine(device=dev)
        out.append(api.join(e.to_df(left), e.to_df(right), how=how, engine=e, as_fugue=True))
    assert out[1].device.type == "cuda"
    return out


@pytest.mark.parametrize("dup", [False, True], ids=["unique", "duplicated"])
@pytest.mark.parametrize("how", HOWS)
def test_join_on_the_card_equals_the_cpu(cuda_device, how, dup):
    left, right = _frames(dup)
    cpu, card = _both(cuda_device, left, right, how)
    pd.testing.assert_frame_equal(card.as_pandas(), cpu.as_pandas())


def test_cross_join_on_the_card_equals_the_cpu(cuda_device):
    left = pd.DataFrame({"x": np.arange(300), "s": ["p", "q", None] * 100})
    right = pd.DataFrame({"y": np.arange(200) / 7, "m": pd.array([1, None] * 100, dtype="Int64")})
    cpu, card = _both(cuda_device, left, right, "cross")
    pd.testing.assert_frame_equal(card.as_pandas(), cpu.as_pandas())
    assert card.count() == 60_000


def _syncs(fn) -> list:
    """The synchronizing CUDA calls the port makes in ``fn`` (PyTorch's sync
    debug mode warns once for each; the first switch of the mode in a
    process was seen to add one from ``torch/cuda`` itself, left out
    here), as the source lines that made them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message) and "fugue_tpu_torch" in w.filename]


def test_the_probe_reads_the_device_once_and_the_expansion_twice(cuda_device):
    """Plain int keys already on the card: the unique probe reads back its
    duplicate flag only; the expansion also reads its slot total."""
    e = TorchExecutionEngine(device=cuda_device)
    left = e.to_df(pd.DataFrame({"k": np.arange(1 << 16) % 5000, "v": np.ones(1 << 16)}))
    unique = e.to_df(pd.DataFrame({"k": np.arange(4000), "w": np.ones(4000)}))
    dup = e.to_df(pd.DataFrame({"k": np.arange(4000) % 2000, "w": np.ones(4000)}))
    left.device_valid_mask(), unique.device_valid_mask(), dup.device_valid_mask()
    torch.cuda.synchronize()
    probe = _syncs(lambda: e.join(left, unique, how="inner"))
    assert len(probe) == 1 and "ops/join.py" in probe[0], probe
    expand = _syncs(lambda: e.join(left, dup, how="inner"))
    assert len(expand) == 2 and all("ops/join.py" in s for s in expand), expand


def test_join_spans_appear_in_a_trace(cuda_device):
    e = TorchExecutionEngine(device=cuda_device)
    left = e.to_df(pd.DataFrame({"k": np.arange(1000), "v": np.ones(1000)}))
    right = e.to_df(pd.DataFrame({"k": np.arange(500) % 250, "w": np.ones(500)}))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        e.join(left, right, how="left_outer")
        torch.cuda.synchronize()
    names = {ev.key for ev in prof.key_averages()}
    assert {"engine.join", "fugue::join_prep", "fugue::join_probe", "fugue::join_expand"} <= names
