"""The autouse fixture of the port's test modules that run streamed
workflows: a tuned store of each test's own (``FUGUE_TPU_TUNING_PATH``), so
that what another test's streams taught the tuner about the same plan never
changes a test's chunks. A module takes it with
``from torch_tuned_store import own_tuned_store  # noqa: F401``; it imports
neither jax nor the JAX package, so the card-only modules take it too."""

import pytest


@pytest.fixture(autouse=True)
def own_tuned_store(tmp_path, monkeypatch):
    monkeypatch.setenv("FUGUE_TPU_TUNING_PATH", str(tmp_path / "_tuned.json"))
