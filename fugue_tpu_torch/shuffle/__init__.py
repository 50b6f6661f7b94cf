"""The key half of ``fugue_tpu/shuffle``: the hash bucketing that the
dist tier's exchange routes rows by (``partitioner.py``). The spill
partitioner, the spill joins and the staged exchange wait for ROADMAP.md
A.7."""

from .partitioner import bucket_ids, canonical_key_kinds

__all__ = ["bucket_ids", "canonical_key_kinds"]
