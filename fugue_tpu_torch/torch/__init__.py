"""The torch engine: device frames and the execution engine (the port of
``fugue_tpu/jax``). Inside this package ``import torch`` is PyTorch:
imports are absolute."""

from .dataframe import TorchDataFrame, frame_from_numpy
from .execution_engine import TorchExecutionEngine, TorchMapEngine

__all__ = ["TorchDataFrame", "TorchExecutionEngine", "TorchMapEngine", "frame_from_numpy"]
