"""The out-of-core hash shuffle of one card, copied from ``fugue_tpu/shuffle``:
spill-partitioned joins and repartitions past the device budget.

- :mod:`.partitioner`: the streaming hash partitioner: any input, chunk by
  chunk, into P atomically published arrow IPC buckets; torn-bucket
  detection and single-bucket recovery. Its key hashing is also the dist
  tier's exchange.
- :mod:`.join`: the bucket-at-a-time spill join over the engine's device
  join, and the spill repartition.
- :mod:`.pipeline`: the overlapped spill: the write-behind writer, the
  memory-resident bucket tier's ledger, the per-exchange context; the
  kill switch ``fugue.tpu.shuffle.pipeline.enabled=false`` restores the
  serial path.
- :mod:`.strategy`: the ONE broadcast / copartition / device_exchange /
  shuffle_spill rule, shared by plan time (``workflow.explain()``) and
  run time (``engine.join``).
- :mod:`.stats`: the ``engine.stats()["shuffle"]`` counters.

The staged device exchange (``staged_exchange_rows``,
``staged_copartition_by_keys``) is the multi-device layout's and is not
here.
"""

from .join import shuffle_spill_join, spill_repartition
from .partitioner import (
    SpilledSide,
    bucket_ids,
    canonical_key_kinds,
    new_spill_dir,
    remove_spill_dir,
    spill_dir_bytes,
    spill_partition,
)
from .pipeline import MemBucketLedger, SpillPipeline, SpillWriter
from .stats import ShuffleStats
from .strategy import (
    JoinDecision,
    broadcast_max_rows,
    bucket_count,
    choose_join_strategy,
    device_budget_bytes,
    device_budget_info,
    device_exchange_enabled,
    estimate_frame_bytes,
    estimate_frame_rows,
    exchange_stage_bytes,
    mem_bucket_cap_bytes,
    pair_prefetch_depth,
    pipeline_enabled,
    shuffle_enabled,
    spill_dir_root,
    target_bucket_bytes,
    writebehind_depth,
)

__all__ = [
    "SpilledSide",
    "bucket_ids",
    "canonical_key_kinds",
    "new_spill_dir",
    "remove_spill_dir",
    "spill_dir_bytes",
    "spill_partition",
    "shuffle_spill_join",
    "spill_repartition",
    "ShuffleStats",
    "JoinDecision",
    "broadcast_max_rows",
    "bucket_count",
    "choose_join_strategy",
    "device_budget_bytes",
    "device_budget_info",
    "device_exchange_enabled",
    "estimate_frame_bytes",
    "estimate_frame_rows",
    "exchange_stage_bytes",
    "shuffle_enabled",
    "spill_dir_root",
    "target_bucket_bytes",
    "MemBucketLedger",
    "SpillPipeline",
    "SpillWriter",
    "mem_bucket_cap_bytes",
    "pair_prefetch_depth",
    "pipeline_enabled",
    "writebehind_depth",
]
