"""Join-strategy selection, copied from ``fugue_tpu/shuffle/strategy.py``:
ONE decision function shared by plan time (``workflow.explain()``) and run
time (``engine.join``).

The ladder:

- ``broadcast``: the right side whole beside the left rows in place;
  taken when it fits (``fugue.tpu.join.broadcast_max_rows`` rows and
  under the device budget).
- ``copartition``: both sides on the device at once. On one card it runs
  the same device join as ``broadcast`` (the engine's ``_join_device``).
- ``device_exchange``: sides past the per-device budget but within the
  aggregate memory of a mesh. Its exchange is the multi-device layout's;
  on one card ``n_shards == 1`` keeps the rung closed.
- ``shuffle_spill``: neither bound holds; both sides stream through the
  on-disk hash partitioner (``partitioner.py``) and matching buckets join
  one pair at a time under the device budget (``join.py``).

The plan optimizer calls :func:`choose_join_strategy` with estimates and
shows the choice in ``workflow.explain()``; ``engine.join`` calls it again
with the live frames' sizes, and the run-time decision is the one that
holds.

The device budget, when no conf sets it, is the card's memory
(``torch.cuda.mem_get_info``, source ``cuda_mem_get_info``) for a CUDA
device, else half of the host's MemTotal (``host_meminfo``), else 16 GiB
(``fallback``). The tuner sizes its chunks and buckets against the same
helper (:func:`device_budget_info`).
"""

from typing import Any, NamedTuple, Optional

from typing import Tuple

from ..constants import (
    FUGUE_TPU_CONF_JOIN_BROADCAST_MAX_ROWS,
    FUGUE_TPU_CONF_SHUFFLE_BUCKET_BYTES,
    FUGUE_TPU_CONF_SHUFFLE_BUCKETS,
    FUGUE_TPU_CONF_SHUFFLE_DEVICE_BUDGET,
    FUGUE_TPU_CONF_SHUFFLE_DEVICE_EXCHANGE_ENABLED,
    FUGUE_TPU_CONF_SHUFFLE_DIR,
    FUGUE_TPU_CONF_SHUFFLE_ENABLED,
    FUGUE_TPU_CONF_SHUFFLE_EXCHANGE_STAGE_BYTES,
    FUGUE_TPU_CONF_SHUFFLE_MEM_BUCKET_BYTES,
    FUGUE_TPU_CONF_SHUFFLE_PIPELINE_ENABLED,
    FUGUE_TPU_CONF_SHUFFLE_PREFETCH_DEPTH,
    FUGUE_TPU_CONF_SHUFFLE_WRITEBEHIND_DEPTH,
)

__all__ = [
    "JoinDecision",
    "broadcast_max_rows",
    "shuffle_enabled",
    "spill_dir_root",
    "device_budget_bytes",
    "device_budget_info",
    "device_exchange_enabled",
    "exchange_stage_bytes",
    "default_mesh_shards",
    "target_bucket_bytes",
    "bucket_count",
    "estimate_frame_bytes",
    "estimate_frame_rows",
    "choose_join_strategy",
    "pipeline_enabled",
    "mem_bucket_cap_bytes",
    "pair_prefetch_depth",
    "writebehind_depth",
]

DEFAULT_BUCKET_BYTES = 1 << 26  # 64 MiB on disk per bucket
MAX_BUCKETS = 4096
DEFAULT_MEM_BUCKET_CAP = 1 << 28  # mem-tier auto ledger ceiling: 256 MiB
DEFAULT_WRITEBEHIND_DEPTH = 8


class JoinDecision(NamedTuple):
    strategy: str  # broadcast | copartition | device_exchange | shuffle_spill
    reason: str


def _conf_get(conf: Any, key: str, default: Any) -> Any:
    if conf is None:
        return default
    try:
        return conf.get(key, default)
    except Exception:
        return default


def broadcast_max_rows(conf: Any) -> int:
    """The broadcast threshold from the conf (default
    ``ops/join.py`` ``MAX_BROADCAST_ROWS``)."""
    from ..ops.join import MAX_BROADCAST_ROWS

    return int(_conf_get(conf, FUGUE_TPU_CONF_JOIN_BROADCAST_MAX_ROWS, MAX_BROADCAST_ROWS))


def shuffle_enabled(conf: Any) -> bool:
    return bool(_conf_get(conf, FUGUE_TPU_CONF_SHUFFLE_ENABLED, True))


def spill_dir_root(conf: Any) -> str:
    import os
    import tempfile

    d = str(_conf_get(conf, FUGUE_TPU_CONF_SHUFFLE_DIR, "") or "")
    if not d:
        d = os.path.join(tempfile.gettempdir(), "fugue_tpu_shuffle")
    return d


def _device_type(device: Any) -> Optional[str]:
    if device is None:
        return None
    t = getattr(device, "type", None)
    return t if t is not None else str(device).split(":")[0]


def _auto_device_budget(device: Any = None) -> Tuple[int, str]:
    """The device byte budget when no conf sets it, and the source that
    won: the card's total memory for a CUDA device
    (``cuda_mem_get_info``), else half of the host's MemTotal (the CPU
    device is host memory), else a conservative constant. torch is
    imported only for a CUDA device, so a host process (a dist worker)
    that plans a join loads no torch."""
    if _device_type(device) == "cuda":
        try:
            import torch

            return int(torch.cuda.mem_get_info(torch.device(device))[1]), "cuda_mem_get_info"
        except Exception:
            pass
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024 // 2, "host_meminfo"
    except Exception:
        pass
    return 1 << 34, "fallback"  # 16 GiB


def device_budget_info(conf: Any, device: Any = None) -> Tuple[int, str]:
    """(budget bytes, source): ``conf`` when the conf sets it, else the
    rung of :func:`_auto_device_budget` that won for ``device``. Recorded
    in ``engine.stats()["shuffle"]``, so a wrong detection shows."""
    b = int(_conf_get(conf, FUGUE_TPU_CONF_SHUFFLE_DEVICE_BUDGET, 0) or 0)
    if b > 0:
        return b, "conf"
    return _auto_device_budget(device)


def device_budget_bytes(conf: Any, device: Any = None) -> int:
    return device_budget_info(conf, device)[0]


def device_exchange_enabled(conf: Any) -> bool:
    """``fugue.tpu.shuffle.device_exchange.enabled``: the exchange rung's
    kill switch. False restores the three-rung ladder."""
    return bool(_conf_get(conf, FUGUE_TPU_CONF_SHUFFLE_DEVICE_EXCHANGE_ENABLED, True))


def exchange_stage_bytes(conf: Any, device: Any = None) -> int:
    """The staged exchange's payload cap a stage and device: the conf's,
    else 1/8 of the device budget, at least 64 KiB."""
    t = int(_conf_get(conf, FUGUE_TPU_CONF_SHUFFLE_EXCHANGE_STAGE_BYTES, 0) or 0)
    if t > 0:
        return t
    return max(1 << 16, device_budget_bytes(conf, device) // 8)


def default_mesh_shards() -> int:
    """The plan-time shard count: 1, the one card the port runs on. (The
    JAX package counts its devices; its run-time rung reads its mesh.)"""
    return 1


def target_bucket_bytes(conf: Any, device: Any = None) -> int:
    t = int(_conf_get(conf, FUGUE_TPU_CONF_SHUFFLE_BUCKET_BYTES, 0) or 0)
    if t > 0:
        return t
    # a bucket PAIR and the join's intermediates (the sorted right side,
    # the expansion's output for repeated keys) must fit the budget
    # together: 1/32 of it, at least 64 KiB
    return max(1 << 16, min(DEFAULT_BUCKET_BYTES, device_budget_bytes(conf, device) // 32))


def pipeline_enabled(conf: Any) -> bool:
    """``fugue.tpu.shuffle.pipeline.enabled``: the overlapped spill's kill
    switch. False restores the serial phase-barrier spill path."""
    return bool(_conf_get(conf, FUGUE_TPU_CONF_SHUFFLE_PIPELINE_ENABLED, True))


def mem_bucket_cap_bytes(conf: Any) -> int:
    """The memory-resident bucket tier's host-byte cap. 0/unset = 1/16 of
    the host's MemTotal, at most 256 MiB; negative turns the tier off."""
    raw = int(_conf_get(conf, FUGUE_TPU_CONF_SHUFFLE_MEM_BUCKET_BYTES, 0) or 0)
    if raw < 0:
        return 0
    if raw > 0:
        return raw
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return min(DEFAULT_MEM_BUCKET_CAP, int(line.split()[1]) * 1024 // 16)
    except Exception:
        pass
    return DEFAULT_MEM_BUCKET_CAP


def pair_prefetch_depth(conf: Any, device: Any = None) -> int:
    """The spill join's bucket-pair prefetch depth. Unset: the stream
    prefetcher's default for ``device`` (0 on a one-core host with the
    CPU as the device, where a producer thread only takes the
    consumer's time)."""
    raw = _conf_get(conf, FUGUE_TPU_CONF_SHUFFLE_PREFETCH_DEPTH, None)
    if raw is None:
        from ..torch.pipeline import default_prefetch_depth

        return default_prefetch_depth("cpu" if device is None else device)
    return int(raw)


def writebehind_depth(conf: Any) -> int:
    """Bucket batches in flight to the background spill writer before the
    partitioner blocks."""
    d = int(
        _conf_get(conf, FUGUE_TPU_CONF_SHUFFLE_WRITEBEHIND_DEPTH, 0)
        or DEFAULT_WRITEBEHIND_DEPTH
    )
    return max(1, d)


def bucket_count(conf: Any, est_bytes: Optional[int], device: Any = None) -> int:
    """P for one shuffle: the conf's; else size / target, bounded; 16 when
    the size cannot be known (a one-pass stream)."""
    p = int(_conf_get(conf, FUGUE_TPU_CONF_SHUFFLE_BUCKETS, 0) or 0)
    if p > 0:
        return min(p, MAX_BUCKETS)
    if not est_bytes or est_bytes <= 0:
        return 16
    return max(1, min(MAX_BUCKETS, -(-est_bytes // target_bucket_bytes(conf, device))))


def estimate_frame_bytes(df: Any) -> Optional[int]:
    """A cheap byte estimate of a frame: a ``TorchDataFrame``'s resident
    bytes (``device_nbytes``: its device tensors and host columns), a
    local frame's arrow or pandas bytes; None where it cannot be known
    without consuming the frame (a one-pass stream). Reads nothing onto
    the device."""
    try:
        nb = getattr(df, "device_nbytes", None)
        if nb is not None:
            return int(nb)
    except Exception:
        pass
    for attr in ("native",):
        native = getattr(df, attr, None)
        if native is None:
            continue
        try:
            import pandas as pd
            import pyarrow as pa

            if isinstance(native, pa.Table):
                return int(native.nbytes)
            if isinstance(native, pd.DataFrame):
                return int(native.memory_usage(index=False, deep=False).sum())
        except Exception:
            pass
    return None


def estimate_frame_rows(df: Any) -> Optional[int]:
    try:
        if getattr(df, "is_bounded", False):
            return int(df.count())
    except Exception:
        pass
    return None


def choose_join_strategy(
    conf: Any,
    est_left_bytes: Optional[int],
    est_right_bytes: Optional[int],
    est_right_rows: Optional[int],
    streaming: bool = False,
    n_shards: int = 1,
    device: Any = None,
) -> JoinDecision:
    """The one strategy rule. An unknown bounded side is taken to fit (the
    run time checks again with the real size); a one-pass stream
    (``streaming=True``) with no streaming plan can only spill: reading
    it whole is the unbounded memory this ladder removes. ``n_shards``
    opens the ``device_exchange`` rung; at 1, the port's one card, the
    aggregate is the budget and the ladder has three rungs."""
    budget, budget_src = device_budget_info(conf, device)
    bmax = broadcast_max_rows(conf)
    if not shuffle_enabled(conf):
        if est_right_rows is not None and est_right_rows <= bmax:
            return JoinDecision("broadcast", f"right ~{est_right_rows} rows <= {bmax}")
        return JoinDecision("copartition", "shuffle disabled (fugue.tpu.shuffle.enabled=false)")
    if streaming:
        return JoinDecision(
            "shuffle_spill", "one-pass stream with no eligible streaming join plan"
        )
    r_fits_bc = (
        est_right_rows is not None
        and est_right_rows <= bmax
        and (est_right_bytes is None or est_right_bytes <= budget)
    )
    if r_fits_bc:
        return JoinDecision(
            "broadcast", f"right ~{est_right_rows} rows <= broadcast_max_rows {bmax}"
        )
    both = (est_left_bytes or 0) + (est_right_bytes or 0)
    if (est_left_bytes is None and est_right_bytes is None) or both <= budget:
        return JoinDecision(
            "copartition", f"both sides ~{both}B fit device budget {budget}B"
        )
    aggregate = budget * max(1, int(n_shards))
    if (
        device_exchange_enabled(conf)
        and int(n_shards) > 1
        and both <= aggregate
    ):
        return JoinDecision(
            "device_exchange",
            f"sides ~{both}B exceed per-device budget {budget}B "
            f"({budget_src}) but fit aggregate mesh memory {aggregate}B "
            f"across {n_shards} shards",
        )
    return JoinDecision(
        "shuffle_spill",
        f"sides ~{both}B exceed device budget {budget}B ({budget_src})",
    )
