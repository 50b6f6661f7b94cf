"""Shuffle counters, copied from ``fugue_tpu/shuffle/stats.py``: the
engine's ``shuffle`` stats source (``engine.stats()["shuffle"]``).

On reset the counters go to zero and the budget (configuration, not a
counter) stays. ``peak_device_bytes`` is a high-water gauge: the most any
bucket pair, or pair group, of a spill join held on the device since the
last reset (``shuffle/join.py`` says how it is measured). The
``device_exchange_*`` counters are the multi-device layout's and stay at
0 on one card.
"""

import threading
from typing import Dict

__all__ = ["ShuffleStats"]

_COUNTERS = (
    "partitions",  # sides spilled to buckets
    "chunks",  # input chunks consumed by the partitioner
    "rows_spilled",
    "bytes_spilled",  # bucket payload bytes routed (disk-encoded + mem-resident)
    "buckets",  # buckets materialized (disk files + mem-resident)
    "bucket_joins",  # bucket pairs joined
    "bucket_rows_out",
    "bucket_recoveries",  # torn/corrupt/missing buckets repartitioned
    "spill_faults",  # injected shuffle.spill faults absorbed
    "spill_dirs_cleaned",
    "joins_spill",  # joins executed with the spill-shuffle strategy
    "repartitions_spill",
    # --- pipelined exchange (docs/shuffle.md "Pipelined exchange") ---
    "pipelined_joins",  # spill joins that ran the overlapped pipeline
    "group_joins",  # coalesced pair-group kernel launches
    "mem_buckets",  # buckets retained in the memory-resident tier
    "mem_bucket_bytes",  # arrow bytes those buckets held (never hit disk)
    "mem_bucket_hits",  # bucket reads served from the mem tier
    "mem_demotions",  # mem buckets demoted to disk under ledger pressure
    "writebehind_batches",  # batches routed through the background writer
    # --- device-resident exchange (docs/shuffle.md "Device exchange") ---
    "device_exchange_joins",  # joins executed with the device_exchange strategy
    "device_exchange_fallbacks",  # exchange-band joins forced back to spill
    "device_exchange_stages",  # staged-schedule collective launches (hops × rounds)
    "device_exchange_rows",  # rows moved through the staged exchange
    "device_exchange_bytes",  # payload bytes moved (rows × row width)
    "mem_bucket_ingest_hits",  # pair reads served from the decoded-form cache
)


class ShuffleStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + int(n)

    def peak(self, nbytes: int) -> None:
        with self._lock:
            if nbytes > self._peak:
                self._peak = int(nbytes)

    def peak_exchange(self, nbytes: int) -> None:
        """High-water per-stage payload of the staged device exchange (the
        multi-device layout's; unused on one card)."""
        with self._lock:
            if nbytes > self._peak_exchange:
                self._peak_exchange = int(nbytes)

    def set_budget(self, nbytes: int, source: str) -> None:
        """Record the resolved device budget and which detection source
        won (``conf`` / ``cuda_mem_get_info`` / ``host_meminfo`` /
        ``fallback``). Survives ``reset()`` — it is configuration, not a
        counter."""
        with self._lock:
            self._budget_bytes = int(nbytes)
            self._budget_source = str(source)

    def get(self, name: str) -> int:
        with self._lock:
            if name == "peak_device_bytes":
                return self._peak
            if name == "device_exchange_peak_stage_bytes":
                return self._peak_exchange
            return self._c.get(name, 0)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            out = {k: self._c.get(k, 0) for k in _COUNTERS}
            out["peak_device_bytes"] = self._peak
            out["device_exchange_peak_stage_bytes"] = self._peak_exchange
            out["device_budget_bytes"] = self._budget_bytes
            # a string leaf: /metrics skips non-numbers, so the source shows
            # in engine.stats() without breaking the exposition
            out["device_budget_source"] = self._budget_source  # type: ignore[assignment]
            return out

    def reset(self) -> None:
        with self._lock:
            self._c: Dict[str, int] = {}
            self._peak = 0
            self._peak_exchange = 0
            self._budget_bytes = getattr(self, "_budget_bytes", 0)
            self._budget_source = getattr(self, "_budget_source", "unset")
