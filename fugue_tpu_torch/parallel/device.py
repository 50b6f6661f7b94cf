"""Device selection — the one-device counterpart of
``fugue_tpu/parallel/mesh.py``.

The port runs on ``cuda:0`` unless the caller asks for another device,
such as ``"cpu"``. It never falls back to the CPU by itself: with no
device given and no card present, :func:`resolve_device` raises.
"""

from typing import Any

import torch


def resolve_device(device: Any = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda:0``."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the torch engine runs on a CUDA device and none is available; "
            "pass device='cpu' to run it on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
