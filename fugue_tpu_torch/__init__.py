"""fugue_tpu_torch — the PyTorch/CUDA port of ``fugue_tpu``'s device engine.

A package of its own beside ``fugue_tpu``: it imports ``torch``, numpy,
pandas and pyarrow, and nothing of JAX or of ``fugue_tpu``. Its engine runs
on one CUDA device unless the caller passes ``device="cpu"``.
"""
