"""Continuous resource sampler. The port's copy of
``fugue_tpu/obs/sampler.py``: one change, the device-bytes probe, which
reads the CUDA caching allocator instead of JAX's live arrays.

A single daemon thread periodically reads a set of cheap **probes** —
device bytes (``torch.cuda.memory_allocated``), host RSS, pipeline
``overlap_fraction`` — into a bounded ring buffer of
``(ts_ns, {name: value})`` samples. Timestamps use the SAME clock as the
span tracer (``time.perf_counter_ns``), so the series export directly as
Perfetto counter tracks under the span timeline (``ph: "C"`` events in
the Chrome trace — see ``export.to_chrome_trace``) and the last sample
serves as the gauge set on ``/metrics``.

Default **off** (conf ``fugue.tpu.telemetry.enabled``, env
``FUGUE_TPU_TELEMETRY`` overrides both ways — the tracer's enablement
contract): disabled there is no thread, no allocation, nothing. Enabled,
one sample every ``fugue.tpu.telemetry.interval`` seconds (default 0.25)
over ~5 cheap probes stays well under the 2% budget.

Probes are registered by name (engines register theirs at construction,
bound through a ``weakref`` so a collected engine's probes remove
themselves by raising :class:`ProbeGone`); ``start()``/``stop()`` are
idempotent; ``reset()`` clears the ring but KEEPS probes and the running
state — the keep-entries contract ``engine.reset_stats()`` applies to
every source.
"""

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "ProbeGone",
    "ResourceSampler",
    "configure_sampler_from_conf",
    "get_sampler",
]

ENV_TELEMETRY = "FUGUE_TPU_TELEMETRY"

_DEFAULT_INTERVAL_S = 0.25
_DEFAULT_RING_SIZE = 4096


class ProbeGone(Exception):
    """Raised by a probe whose subject no longer exists — the sampler
    unregisters it (the weakref-bound engine-probe cleanup path)."""


def _host_rss_bytes() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except Exception:
        pass
    import resource

    # fallback: peak RSS (linux reports KiB) — monotone but better than nothing
    return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024.0


def _device_bytes() -> float:
    """Bytes the CUDA caching allocator holds in live tensors, summed over
    the visible devices (prefetched in-flight chunks count naturally).
    Before the process's first CUDA call this is 0.0 and touches nothing:
    the sampler's thread must never be the one that creates a CUDA
    context. A torch built without CUDA has no such probe."""
    import torch

    if not torch.backends.cuda.is_built():
        raise ProbeGone()
    if not torch.cuda.is_initialized():
        return 0.0
    return float(
        sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count()))
    )


class ResourceSampler:
    """Daemon-thread sampler over named probes into a bounded ring."""

    def __init__(
        self,
        interval: float = _DEFAULT_INTERVAL_S,
        ring_size: int = _DEFAULT_RING_SIZE,
    ):
        self._lock = threading.Lock()
        self._probes: Dict[str, Callable[[], float]] = {}
        self._ring: "deque[Tuple[int, Dict[str, float]]]" = deque(maxlen=ring_size)
        self._interval = float(interval)
        self._thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()
        self.sample_errors = 0
        self.register_probe("host_rss_bytes", _host_rss_bytes)
        self.register_probe("device_bytes", _device_bytes)

    # -- probes --------------------------------------------------------------
    def register_probe(self, name: str, fn: Callable[[], float]) -> None:
        """Register (or replace) a named probe: a zero-arg callable
        returning a float. Raise :class:`ProbeGone` to self-unregister;
        any other exception skips the value for that tick only."""
        with self._lock:
            self._probes[name] = fn

    def unregister_probe(self, name: str) -> None:
        with self._lock:
            self._probes.pop(name, None)

    def probe_names(self) -> List[str]:
        with self._lock:
            return sorted(self._probes)

    # -- lifecycle (idempotent both ways) ------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def interval(self) -> float:
        return self._interval

    def configure(
        self, interval: Optional[float] = None, ring_size: Optional[int] = None
    ) -> None:
        with self._lock:
            if interval is not None:
                self._interval = max(float(interval), 0.001)
            if ring_size is not None and int(ring_size) != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(int(ring_size), 1))

    def start(
        self, interval: Optional[float] = None, ring_size: Optional[int] = None
    ) -> "ResourceSampler":
        self.configure(interval, ring_size)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self  # already running — idempotent
            self._stop_ev = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, name="fugue-tpu-telemetry", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
            self._stop_ev.set()
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def _loop(self) -> None:
        ev = self._stop_ev
        while not ev.wait(self._interval):
            try:
                self.sample_once()
            except Exception:
                with self._lock:
                    self.sample_errors += 1

    # -- sampling ------------------------------------------------------------
    def sample_once(self) -> Dict[str, float]:
        """Take one sample now (the thread's body; also callable directly
        for a deterministic sample in tests/smoke)."""
        with self._lock:
            probes = list(self._probes.items())
        vals: Dict[str, float] = {}
        gone: List[str] = []
        for name, fn in probes:
            try:
                vals[name] = float(fn())
            except ProbeGone:
                gone.append(name)
            except Exception:
                with self._lock:
                    self.sample_errors += 1
        ts = time.perf_counter_ns()
        with self._lock:
            for name in gone:
                self._probes.pop(name, None)
            self._ring.append((ts, vals))
        return vals

    def series(self) -> List[Tuple[int, Dict[str, float]]]:
        """The ring's samples oldest-first — the Perfetto counter-track
        source (same ``perf_counter_ns`` clock as span timestamps)."""
        with self._lock:
            return list(self._ring)

    def last(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._ring[-1][1]) if self._ring else {}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- registry source contract -------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._ring)
            last = dict(self._ring[-1][1]) if self._ring else {}
            probes = sorted(self._probes)
        return {
            "running": self.running,
            "samples": n,
            "interval_s": self._interval,
            "probes": probes,
            "last": last,
        }

    def reset(self) -> None:
        """Clear the ring buffer. Probes stay registered and the thread
        keeps running — the keep-entries contract: a stats reset empties
        the recorded series without tearing the sampler down."""
        self.clear()


_SAMPLER = ResourceSampler()


def get_sampler() -> ResourceSampler:
    return _SAMPLER


def configure_sampler_from_conf(conf: Any) -> None:
    """Apply telemetry switches from an engine conf (engine construction
    path, next to the tracer's ``configure_from_conf``). The
    ``FUGUE_TPU_TELEMETRY`` env var overrides the conf in both
    directions; absent key + absent env leaves the current state
    untouched (another engine may have started the sampler already)."""
    from ..constants import (
        FUGUE_TPU_CONF_TELEMETRY_ENABLED,
        FUGUE_TPU_CONF_TELEMETRY_INTERVAL,
        FUGUE_TPU_CONF_TELEMETRY_RING,
    )
    from .tracer import _truthy

    try:
        raw = conf.get_or_none(FUGUE_TPU_CONF_TELEMETRY_ENABLED, object)
        interval = conf.get_or_none(FUGUE_TPU_CONF_TELEMETRY_INTERVAL, object)
        ring = conf.get_or_none(FUGUE_TPU_CONF_TELEMETRY_RING, object)
    except Exception:
        raw = interval = ring = None
    env = os.environ.get(ENV_TELEMETRY)
    enabled: Optional[bool] = None
    if env is not None and env != "":
        enabled = _truthy(env)
    elif raw is not None:
        enabled = _truthy(raw)
    s = get_sampler()
    s.configure(
        interval=float(interval) if interval is not None else None,
        ring_size=int(ring) if ring is not None else None,
    )
    if enabled is True:
        s.start()
    elif enabled is False:
        s.stop()
