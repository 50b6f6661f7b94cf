"""The cache package, copied from ``fugue_tpu/cache`` as far as the UDF
analyzer needs it: the ``@non_deterministic`` marker and the callable
fingerprint (``fingerprint.py``). The result and delta caches wait for
ROADMAP.md A.10."""

from .fingerprint import non_deterministic

__all__ = ["non_deterministic"]
