"""The result cache, copied from ``fugue_tpu/cache``: cross-run
memoization keyed on canonical plan fingerprints.

- :mod:`~fugue_tpu_torch.cache.fingerprint` — canonical recursive hash
  per optimized plan node; refusal (poisoning) over guessing.
- :mod:`~fugue_tpu_torch.cache.store` — in-process byte-budgeted LRU over
  live frames (device frames stay on the card) backed by an on-disk
  parquet artifact store.
- :mod:`~fugue_tpu_torch.cache.planner` — cuts the DAG at the deepest
  cached frontier so upstream producers are never executed.
- :mod:`~fugue_tpu_torch.cache.delta` — partition-level incremental
  recompute: a warm run over a grown Load source recomputes only the new
  partitions and merges with the cached result or partial accumulator.
"""

from .delta import (
    DeltaHit,
    DeltaTemplate,
    build_delta_templates,
    execute_delta,
    match_manifest,
)
from .fingerprint import (
    FP_VERSION,
    FingerprintReport,
    fingerprint_tasks,
    non_deterministic,
)
from .planner import CachePlan, describe_cache, plan_cache
from .store import (
    ArtifactStore,
    CacheStats,
    MemoryLRU,
    ResultCache,
    clean_cache_dir,
    estimate_df_bytes,
)

__all__ = [
    "FP_VERSION",
    "FingerprintReport",
    "fingerprint_tasks",
    "non_deterministic",
    "CachePlan",
    "plan_cache",
    "describe_cache",
    "ArtifactStore",
    "CacheStats",
    "MemoryLRU",
    "ResultCache",
    "clean_cache_dir",
    "estimate_df_bytes",
    "DeltaHit",
    "DeltaTemplate",
    "build_delta_templates",
    "match_manifest",
    "execute_delta",
]
