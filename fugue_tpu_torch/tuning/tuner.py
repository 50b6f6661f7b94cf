"""Cost-based adaptive execution, copied from ``fugue_tpu/tuning/tuner.py``:
the feedback loop over the engine's own telemetry.

A stream's chunk size and prefetch depth show their consequences in the
ingest pipeline's run record (``torch/pipeline.py``: chunks, producer and
consumer waits, wall time). This module closes the loop:

- :func:`run_scope` (entered by ``FugueWorkflow.run``) keys one run's
  observations by the plan fingerprint;
- :meth:`Tuner.stream_params` / :meth:`Tuner.join_params` resolve knobs —
  from the learned entry when one exists, from the static rule otherwise
  (every resolution is recorded as a decision with its evidence);
- at scope exit, :meth:`Tuner.flush` turns the run's observations into
  the NEXT generation's settings via bounded multiplicative adjustment
  (at most ``MAX_CHUNK_FACTOR``x / ``MAX_BUCKET_FACTOR``x per
  generation, so a wild first estimate converges within a few runs
  instead of oscillating) and publishes them to the
  :class:`~fugue_tpu_torch.tuning.store.TunedStore`.

The join and shuffle knobs (``join_params``, :class:`ExchangeHandle`,
``adjust_buckets``, ``adjust_pipeline``) are copied whole; their callers,
the shuffle ladder, wait for ROADMAP.md A.7. The device budget that caps
a chunk is the card's memory (``torch.cuda.mem_get_info``), or half the
host's on the CPU.

Degradation ladder (every rung gives the same results):

1. ``fugue.tpu.tuning.enabled=false`` → this module is inert; every
   knob resolves exactly as before the layer existed.
2. No run scope (direct engine verb calls outside ``workflow.run``) →
   static conf.
3. Scope but no learned entry (cold plan) → static conf, decision
   recorded as ``static: no observations``.
4. Learned entry → adaptive values; the streaming paths' own eligibility
   checks stay authoritative — tuning only feeds them better inputs.
5. Streams too small to measure (``wall < MIN_WALL_S``) are never
   adjusted — tiny test workloads can't perturb the store.
"""

import contextvars
import hashlib
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .stats import TuningStats
from .store import TunedStore, resolve_tuned_path

__all__ = [
    "Tuner",
    "StreamHandle",
    "ExchangeHandle",
    "plan_fingerprint",
    "tuning_enabled",
    "run_scope",
    "current_scope",
    "describe_tuning",
    "adjust_stream",
    "adjust_buckets",
    "adjust_pipeline",
]

# -- adjustment policy constants -------------------------------------------
MIN_WALL_S = 0.15  # streams faster than this carry no usable signal
MIN_SHUFFLE_WALL_S = 0.3
CHUNK_BAND_HI = 16  # chunk-count band: above it, grow chunk_rows ...
CHUNK_TARGET = 8  # ... toward this many chunks per stream
MAX_CHUNK_FACTOR = 4.0  # bounded multiplicative step per generation
CHUNK_MIN_ROWS = 1 << 12
CHUNK_MAX_ROWS = 1 << 22
CHUNK_BYTES_FRACTION = 8  # chunk bytes stay under budget/8
DEPTH_MAX = 8
MAX_BUCKET_FACTOR = 8.0
MIN_BUCKETS_TO_SHRINK = 16  # below this, per-bucket overhead is noise
PEAK_TARGET_FRACTION = 2  # aim bucket-pair peak at budget/2
CARDINALITY_MARGIN = 0.2  # republish observed sizes on >20% drift
PAIR_DEPTH_MAX = 4  # bucket-pair prefetch never queues deeper than this
MEM_BYTES_MIN = 1 << 26  # learned mem-tier budget floor (64 MiB)
MEM_BYTES_MAX = 1 << 30  # ... and ceiling (1 GiB)


_ADDR_RE = None


def _sig_of(v: Any) -> str:
    """Address-free signature of one task parameter. Task ``__uuid__``s
    hash raw data objects by IDENTITY (correct for checkpoints, where a
    false hit serves wrong data) — but tuning keys on plan SHAPE: the
    same pipeline over a re-created stream source must land on the same
    entry, and the worst a collision can cost is a mis-tuned knob that
    the next observation corrects, never a wrong result."""
    global _ADDR_RE
    if _ADDR_RE is None:
        import re

        _ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")
    if callable(v):
        return "fn:%s.%s" % (
            getattr(v, "__module__", ""),
            getattr(v, "__qualname__", type(v).__name__),
        )
    try:
        r = repr(v)
    except Exception:
        r = type(v).__name__
    return _ADDR_RE.sub("0x", r[:200])


def plan_fingerprint(tasks: Any) -> Optional[str]:
    """Structural fingerprint of the POST-optimization task DAG — the
    store key. Same plan shape => same fingerprint across processes and
    restarts (task uuids won't do: they embed data-object identity). The
    package's name is hashed first, so a store file shared with the JAX
    package, whose classes have the same names, never hands one package
    the other's settings."""
    try:
        tasks = list(tasks)
        idx = {id(t): i for i, t in enumerate(tasks)}
        md = hashlib.sha1(b"fugue_tpu_torch\n")
        for i, t in enumerate(tasks):
            parts = [
                str(i),
                type(t).__name__,
                type(getattr(t, "extension", None)).__name__,
            ]
            try:
                for k in sorted(str(k) for k in t.params.keys()):
                    parts.append(f"{k}={_sig_of(t.params[k])}")
            except Exception:
                pass
            try:
                parts.append(str(t.partition_spec))
            except Exception:
                pass
            try:
                parts.append(
                    ",".join(str(idx.get(id(x), -1)) for x in t.inputs)
                )
            except Exception:
                pass
            md.update(("|".join(parts) + "\n").encode())
        return md.hexdigest()[:16]
    except Exception:
        return None


def tuning_enabled(conf: Any) -> bool:
    from ..constants import FUGUE_TPU_CONF_TUNING_ENABLED

    if conf is None:
        return True
    try:
        return bool(conf.get(FUGUE_TPU_CONF_TUNING_ENABLED, True))
    except Exception:
        return True


def _confidence(obs: int) -> float:
    return round(min(1.0, obs / 3.0), 2)


# -- pure adjustment functions (unit-tested directly) ------------------------
def adjust_stream(
    chunk_rows: int, depth: int, obs: Dict[str, Any], budget_bytes: int
) -> Optional[Dict[str, Any]]:
    """Next-generation (chunk_rows, prefetch_depth) for one stream from
    one observed run, or None when the run carries no usable signal.

    - too many chunks (> ``CHUNK_BAND_HI``) → grow ``chunk_rows`` toward
      ``CHUNK_TARGET`` chunks, at most ``MAX_CHUNK_FACTOR``x per
      generation, capped so one chunk stays under
      ``budget/CHUNK_BYTES_FRACTION`` bytes;
    - consumer starved (waited on an empty queue far longer than the
      producer waited on a full one) → deepen the prefetch queue, up to
      ``DEPTH_MAX``;
    - producer starved → shallower queue (floor 2: double buffering),
      releasing host memory the pipeline can't use.
    """
    chunks = int(obs.get("chunks_prefetched", 0) or 0)
    wall = float(obs.get("wall_s", 0.0) or 0.0)
    if chunks <= 0 or wall < MIN_WALL_S:
        return None
    notes: List[str] = []
    new_chunk, new_depth = int(chunk_rows), int(depth)
    if chunks > CHUNK_BAND_HI:
        factor = min(MAX_CHUNK_FACTOR, chunks / float(CHUNK_TARGET))
        new_chunk = int(chunk_rows * factor)
        rows = int(obs.get("rows", 0) or 0)
        nbytes = int(obs.get("bytes", 0) or 0)
        if rows > 0 and nbytes > 0 and budget_bytes > 0:
            bpr = max(nbytes / rows, 1e-9)
            new_chunk = min(
                new_chunk, int(budget_bytes / CHUNK_BYTES_FRACTION / bpr)
            )
        new_chunk = max(CHUNK_MIN_ROWS, min(CHUNK_MAX_ROWS, new_chunk))
        new_chunk = -(-new_chunk // 1024) * 1024  # stable jit-key rounding
        if new_chunk != chunk_rows:
            notes.append(
                f"{chunks} chunks > band {CHUNK_BAND_HI}: chunk_rows "
                f"{chunk_rows} -> {new_chunk} (x{factor:.1f}, bounded)"
            )
    pw = float(obs.get("producer_wait_s", 0.0) or 0.0)
    cw = float(obs.get("consumer_wait_s", 0.0) or 0.0)
    if depth >= 1:
        if cw > max(2.0 * pw, 0.05) and depth < DEPTH_MAX and chunks > 2 * depth:
            new_depth = min(DEPTH_MAX, max(2, depth * 2))
            notes.append(
                f"producer-bound (consumer waited {cw:.2f}s vs {pw:.2f}s): "
                f"prefetch_depth {depth} -> {new_depth}"
            )
        elif pw > max(2.0 * cw, 0.05) and depth > 2:
            new_depth = max(2, depth // 2)
            notes.append(
                f"consumer-bound (producer waited {pw:.2f}s vs {cw:.2f}s): "
                f"prefetch_depth {depth} -> {new_depth}"
            )
    converged = new_chunk == chunk_rows and new_depth == depth
    overlap = obs.get("overlap_fraction", 0.0)
    return {
        "chunk_rows": new_chunk,
        "prefetch_depth": new_depth,
        "converged": converged,
        "evidence": "; ".join(notes)
        or (
            f"in band: {chunks} chunks, waits balanced "
            f"(overlap {overlap}, wall {wall:.2f}s)"
        ),
    }


def adjust_buckets(
    buckets: int, obs: Dict[str, Any], budget_bytes: int
) -> Optional[Dict[str, Any]]:
    """Next-generation shuffle bucket count from one observed exchange.

    The static sizer (``bucket_count``: size / (budget/32)) guesses the
    bucket-pair expansion; the measured ``peak_device_bytes`` replaces
    the guess: scale P so the peak lands near
    ``budget/PEAK_TARGET_FRACTION`` — fewer, larger buckets when the
    observed peak was far under budget (less per-bucket overhead), more
    when it crowded the budget. Bounded to ``MAX_BUCKET_FACTOR``x per
    generation; never shrinks below-noise bucket counts."""
    peak = int(obs.get("peak_device_bytes", 0) or 0)
    wall = float(obs.get("wall_s", 0.0) or 0.0)
    if buckets <= 0 or peak <= 0 or budget_bytes <= 0:
        return None
    over_budget = peak > budget_bytes
    if not over_budget and (
        wall < MIN_SHUFFLE_WALL_S or buckets <= MIN_BUCKETS_TO_SHRINK
    ):
        return None
    target_peak = budget_bytes / float(PEAK_TARGET_FRACTION)
    ideal = max(1, -(-int(buckets * (peak / target_peak)) // 1))
    lo = max(1, int(buckets / MAX_BUCKET_FACTOR))
    hi = min(4096, int(buckets * MAX_BUCKET_FACTOR))
    new = max(lo, min(hi, ideal))
    if not over_budget and 0.5 <= peak / target_peak <= 2.0:
        new = buckets  # close enough: stability beats the last few %
    return {
        "buckets": new,
        "converged": new == buckets,
        "evidence": (
            f"peak {peak}B at {buckets} buckets vs budget {budget_bytes}B "
            f"(target ~{int(target_peak)}B): buckets {buckets} -> {new}"
        ),
    }


def adjust_pipeline(
    depth: int, mem_bytes: int, obs: Dict[str, Any]
) -> Optional[Dict[str, Any]]:
    """Next-generation (pair_depth, mem_bytes) for one pipelined
    exchange from its observed producer/consumer waits and mem-tier
    pressure, or None when the run carries no usable signal.

    - consumer starved (the kernel waited on the pair producer far
      longer than the producer waited on a full queue) → deepen the
      pair prefetch, up to ``PAIR_DEPTH_MAX``;
    - producer starved → shallower (floor 0: serial consumption — on a
      single-core mesh a producer thread only steals consumer time);
    - demotions under ledger pressure → grow the mem-tier budget
      (bounded 2x per generation, capped at ``MEM_BYTES_MAX``);
    - a tier running far under its cap shrinks toward what the exchange
      actually used, releasing host memory the pipeline can't use.
    """
    groups = int(obs.get("pipe_chunks", 0) or 0)
    wall = float(obs.get("wall_s", 0.0) or 0.0)
    if groups <= 0 or wall < MIN_SHUFFLE_WALL_S:
        return None
    notes: List[str] = []
    new_depth, new_mem = int(depth), int(mem_bytes)
    pw = float(obs.get("pipe_producer_wait_s", 0.0) or 0.0)
    cw = float(obs.get("pipe_consumer_wait_s", 0.0) or 0.0)
    if cw > max(2.0 * pw, 0.05) and depth < PAIR_DEPTH_MAX and groups > 2 * max(depth, 1):
        new_depth = min(PAIR_DEPTH_MAX, max(1, depth * 2))
        notes.append(
            f"producer-bound (consumer waited {cw:.2f}s vs {pw:.2f}s): "
            f"pair_depth {depth} -> {new_depth}"
        )
    elif pw > max(2.0 * cw, 0.05) and depth > 0:
        new_depth = depth // 2
        notes.append(
            f"consumer-bound (producer waited {pw:.2f}s vs {cw:.2f}s): "
            f"pair_depth {depth} -> {new_depth}"
        )
    demotions = int(obs.get("mem_demotions", 0) or 0)
    used = int(obs.get("mem_bytes_used", 0) or 0)
    if demotions > 0 and mem_bytes < MEM_BYTES_MAX:
        new_mem = min(MEM_BYTES_MAX, max(MEM_BYTES_MIN, mem_bytes * 2))
        notes.append(
            f"{demotions} demotions under a {mem_bytes}B ledger: "
            f"mem_bytes -> {new_mem}"
        )
    elif demotions == 0 and 0 < used < mem_bytes // 4 and mem_bytes > MEM_BYTES_MIN:
        new_mem = max(MEM_BYTES_MIN, used * 2)
        notes.append(
            f"tier used {used}B of {mem_bytes}B with no pressure: "
            f"mem_bytes -> {new_mem}"
        )
    converged = new_depth == depth and new_mem == mem_bytes
    return {
        "pair_depth": new_depth,
        "mem_bytes": new_mem,
        "converged": converged,
        "evidence": "; ".join(notes)
        or (
            f"pipeline balanced: {groups} groups, waits {pw:.2f}s/{cw:.2f}s, "
            f"tier {used}B/{mem_bytes}B"
        ),
    }


def device_budget_bytes(device: Any = None) -> int:
    """The byte budget a chunk is sized against: the card's memory
    (``torch.cuda.mem_get_info``) for a CUDA device, else half the host's
    memory (the CPU device is host memory), else 16 GiB."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024 // 2
    except Exception:
        pass
    return 1 << 34


# -- run scope ---------------------------------------------------------------
class _Scope:
    """One workflow.run's tuning context: the plan fingerprint, per-kind
    ordinal counters (deterministic stream/join ids for a deterministic
    plan), the handles awaiting their prefetcher, and the observations
    collected for flush."""

    def __init__(self, tuner: "Tuner", plan_fp: str, enabled: bool):
        self.tuner = tuner
        self.plan_fp = plan_fp
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self.pending: Dict[str, "StreamHandle"] = {}
        self.stream_obs: List[Tuple["StreamHandle", Dict[str, Any]]] = []
        self.exchanges: List["ExchangeHandle"] = []

    def next_sid(self, kind: str) -> str:
        with self._lock:
            n = self._counters.get(kind, 0)
            self._counters[kind] = n + 1
        return kind if n == 0 else f"{kind}#{n}"

    def add_stream_obs(self, handle: "StreamHandle", run: Dict[str, Any]) -> None:
        with self._lock:
            self.stream_obs.append((handle, dict(run)))

    def add_exchange(self, handle: "ExchangeHandle") -> None:
        with self._lock:
            self.exchanges.append(handle)


_RUN: "contextvars.ContextVar[Optional[_Scope]]" = contextvars.ContextVar(
    "fugue_tpu_torch_tuning_scope", default=None
)


def current_scope() -> Optional[_Scope]:
    return _RUN.get()


@contextmanager
def run_scope(engine: Any, plan_fp: Optional[str], conf: Any = None) -> Iterator[Any]:
    """Entered by ``workflow.run`` around task execution. ``conf`` is the
    run's merged view (engine conf overlaid with workflow compile conf) —
    the same precedence ``explain()`` uses — so a per-workflow or
    per-tenant ``fugue.tpu.tuning.enabled=false`` disables tuning for
    THIS run without touching the shared engine."""
    tuner = getattr(engine, "tuner", None)
    if tuner is None or plan_fp is None:
        yield None
        return
    enabled = tuning_enabled(conf if conf is not None else getattr(engine, "conf", None))
    scope = _Scope(tuner, plan_fp, enabled)
    token = _RUN.set(scope if enabled else None)
    try:
        yield scope
    finally:
        _RUN.reset(token)
        if enabled:
            try:
                tuner.flush(scope)
            except Exception:  # learning must never fail a run
                import logging

                logging.getLogger("fugue_tpu_torch.tuning").debug(
                    "tuning flush failed", exc_info=True
                )


# -- handles -----------------------------------------------------------------
class StreamHandle:
    """One stream's resolved knobs plus the observation funnel back."""

    __slots__ = (
        "scope",
        "sid",
        "chunk_rows",
        "prefetch_depth",
        "adaptive",
        "used_depth",
    )

    def __init__(
        self,
        scope: _Scope,
        sid: str,
        chunk_rows: int,
        prefetch_depth: Optional[int],
        adaptive: bool,
    ):
        self.scope = scope
        self.sid = sid
        self.chunk_rows = chunk_rows
        self.prefetch_depth = prefetch_depth  # None = use the static default
        self.adaptive = adaptive
        self.used_depth = 0

    @property
    def coalesce(self) -> bool:
        """Merge undersized source chunks up to ``chunk_rows`` before the
        device step. Only an ADAPTIVE setting coalesces: the static path
        must stay bit-identical in shape to the pre-tuning engine."""
        return self.adaptive

    def observe(self, run: Dict[str, Any]) -> None:
        self.scope.tuner.stats.inc("observations")
        self.scope.add_stream_obs(self, run)


class ExchangeHandle:
    """One spill join/repartition's calibration + observation funnel."""

    __slots__ = (
        "scope",
        "sid",
        "entry",
        "used_buckets",
        "used_pair_depth",
        "used_mem_bytes",
        "obs",
    )

    def __init__(self, scope: _Scope, sid: str, entry: Optional[Dict[str, Any]]):
        self.scope = scope
        self.sid = sid
        self.entry = dict(entry or {})
        self.used_buckets = 0
        self.used_pair_depth = 0
        self.used_mem_bytes = 0
        self.obs: Dict[str, Any] = {}
        scope.add_exchange(self)

    def bucket_count(self, static_buckets: int) -> int:
        """Calibrated bucket count for this exchange: the learned value
        when one exists, the caller's static rule (``static_buckets``)
        otherwise."""
        cal = self.entry.get("buckets")
        if cal:
            n = max(1, min(4096, int(cal)))
            source, evidence = "adaptive", str(self.entry.get("evidence", ""))
        else:
            n = int(static_buckets)
            source, evidence = "static", "no observations"
        self.used_buckets = n
        self.scope.tuner.stats.decision(
            {
                "target": "shuffle",
                "key": self.sid,
                "plan": self.scope.plan_fp,
                "value": {"buckets": n},
                "source": source,
                "evidence": evidence,
                "confidence": _confidence(int(self.entry.get("obs", 0) or 0)),
            }
        )
        return n

    def pipeline_params(
        self, conf: Any, static_depth: int, static_mem_bytes: int
    ) -> Tuple[int, int]:
        """Resolve the pipelined exchange's pair-prefetch depth and
        mem-tier budget: the learned values when prior runs of this plan
        observed the pipeline, the static conf resolution otherwise.
        Every resolution is recorded as a decision with its evidence."""
        depth, mem = self.entry.get("pair_depth"), self.entry.get("mem_bytes")
        if depth is not None or mem is not None:
            d = int(depth) if depth is not None else int(static_depth)
            m = int(mem) if mem is not None else int(static_mem_bytes)
            source = "adaptive"
            evidence = str(self.entry.get("pipe_evidence", ""))
        else:
            d, m = int(static_depth), int(static_mem_bytes)
            source, evidence = "static", "no observations"
        self.used_pair_depth, self.used_mem_bytes = d, m
        self.scope.tuner.stats.decision(
            {
                "target": "shuffle_pipeline",
                "key": self.sid,
                "plan": self.scope.plan_fp,
                "value": {"pair_depth": d, "mem_bytes": m},
                "source": source,
                "evidence": evidence,
                "confidence": _confidence(int(self.entry.get("obs", 0) or 0)),
            }
        )
        return d, m

    def observe_pair_stream(self, run: Dict[str, Any]) -> None:
        """The pair prefetcher's finished-run telemetry (the pipeline's
        run dict): producer/consumer waits name the pipeline's bottleneck
        for the next generation."""
        self.obs.update(
            pipe_chunks=int(run.get("chunks_prefetched", 0) or 0),
            pipe_producer_wait_s=float(run.get("producer_wait_s", 0.0) or 0.0),
            pipe_consumer_wait_s=float(run.get("consumer_wait_s", 0.0) or 0.0),
        )
        self.scope.tuner.stats.inc("observations")

    def observe_pipeline(self, info: Dict[str, Any]) -> None:
        """Mem-tier pressure + grouping evidence from the finished
        exchange (ledger peak/demotions, pairs per group)."""
        self.obs.update(
            pairs_per_group=int(info.get("pairs_per_group", 0) or 0),
            mem_bytes_used=int(info.get("mem_bytes_used", 0) or 0),
            mem_demotions=int(info.get("mem_demotions", 0) or 0),
        )

    def observe_sides(
        self, left_bytes: int, right_bytes: int, left_rows: int, right_rows: int
    ) -> None:
        self.obs.update(
            left_bytes=int(left_bytes),
            right_bytes=int(right_bytes),
            left_rows=int(left_rows),
            right_rows=int(right_rows),
        )
        self.scope.tuner.stats.inc("observations")

    def observe_run(self, peak_device_bytes: int, wall_s: float) -> None:
        self.obs.update(
            peak_device_bytes=int(peak_device_bytes), wall_s=float(wall_s)
        )

    def observe_exchange(self, stages: int, peak_stage_bytes: int) -> None:
        """Staged device-exchange telemetry: how many collective stages
        this join's schedule ran and the high-water per-stage payload.
        Persisted as exchange-size calibration evidence — next runs of
        this plan see the measured schedule in ``workflow.explain()``."""
        self.obs.update(
            exch_stages=int(stages),
            exch_peak_stage_bytes=int(peak_stage_bytes),
        )
        self.scope.tuner.stats.inc("observations")


# -- the tuner ---------------------------------------------------------------
class Tuner:
    """Per-engine adaptive-execution coordinator. Owns the stats group
    (``engine.stats()["tuning"]``) and the persistent store; all knob
    resolutions and all learning go through here."""

    def __init__(self, conf: Any = None, device: Any = None):
        from ..constants import FUGUE_TPU_CONF_TUNING_MAX_ENTRIES
        from .store import DEFAULT_MAX_ENTRIES

        self._conf = conf
        self._device = device
        self.stats = TuningStats()
        try:
            max_entries = int(
                conf.get(FUGUE_TPU_CONF_TUNING_MAX_ENTRIES, DEFAULT_MAX_ENTRIES)
            )
        except Exception:
            max_entries = DEFAULT_MAX_ENTRIES
        self.store = TunedStore(
            resolve_tuned_path(conf), max_entries=max_entries, stats=self.stats
        )
        # per-verb roofline folds (record-only) — published into the same
        # store under its "rooflines" key at flush
        from .roofline import RooflineRecorder

        self.roofline = RooflineRecorder(self.store, stats=self.stats)

    # MetricsRegistry source contract (obs/registry.py)
    def as_dict(self) -> Dict[str, Any]:
        out = self.stats.as_dict()
        out["entries"] = self.store.count()
        out["roofline_pending"] = self.roofline.pending_count()
        return out

    def reset(self) -> None:
        """Counters zero; LEARNED entries are kept (forgetting them would
        re-pay cold runs)."""
        self.stats.reset()

    # -- resolution ----------------------------------------------------------
    def _plan_section(self, scope: _Scope, section: str, sid: str) -> Optional[dict]:
        entry = self.store.plan_entry(scope.plan_fp)
        if not entry:
            return None
        sec = entry.get(section)
        if not isinstance(sec, dict):
            return None
        v = sec.get(sid)
        return v if isinstance(v, dict) else None

    def stream_params(self, verb: str, static_chunk_rows: int) -> Optional[StreamHandle]:
        """Resolve one stream's chunk size (and learned prefetch depth).
        Returns None outside an enabled run scope — the caller uses its
        static values untouched, exactly the pre-tuning code path."""
        scope = _RUN.get()
        if scope is None or not scope.enabled:
            return None
        sid = scope.next_sid(verb)
        learned = self._plan_section(scope, "streams", sid)
        if learned and int(learned.get("chunk_rows", 0) or 0) > 0:
            handle = StreamHandle(
                scope,
                sid,
                int(learned["chunk_rows"]),
                int(learned["prefetch_depth"])
                if learned.get("prefetch_depth")
                else None,
                adaptive=True,
            )
            source, evidence = "adaptive", str(learned.get("evidence", ""))
            conf_n = int(learned.get("obs", 0) or 0)
        else:
            handle = StreamHandle(scope, sid, int(static_chunk_rows), None, False)
            source, evidence = "static", "no observations"
            conf_n = 0
        self.stats.decision(
            {
                "target": "stream",
                "key": sid,
                "plan": scope.plan_fp,
                "value": {
                    "chunk_rows": handle.chunk_rows,
                    "prefetch_depth": handle.prefetch_depth,
                },
                "source": source,
                "evidence": evidence,
                "confidence": _confidence(conf_n),
            }
        )
        scope.pending[verb] = handle
        return handle

    def take_stream_handle(self, verb: str) -> Optional[StreamHandle]:
        """Claim the handle :meth:`stream_params` left for this verb's
        prefetcher (same function invocation, same thread)."""
        scope = _RUN.get()
        if scope is None or not scope.enabled:
            return None
        return scope.pending.pop(verb, None)

    def join_params(
        self,
        est_left_bytes: Optional[int],
        est_right_bytes: Optional[int],
        est_right_rows: Optional[int],
    ) -> Tuple[Optional[int], Optional[int], Optional[int], Optional[ExchangeHandle]]:
        """Feed observed join-side cardinalities back into the strategy
        ladder: where the static estimate is UNKNOWN (None — one-pass
        streams, host frames), substitute what a previous run of this
        plan measured. Known estimates are never overridden — the live
        size is fresher than history."""
        scope = _RUN.get()
        if scope is None or not scope.enabled:
            return est_left_bytes, est_right_bytes, est_right_rows, None
        sid = scope.next_sid("join")
        learned = self._plan_section(scope, "joins", sid)
        handle = ExchangeHandle(scope, sid, learned)
        l, r, rr = est_left_bytes, est_right_bytes, est_right_rows
        used: List[str] = []
        if learned:
            if l is None and learned.get("left_bytes"):
                l = int(learned["left_bytes"])
                used.append(f"left_bytes~{l}")
            if r is None and learned.get("right_bytes"):
                r = int(learned["right_bytes"])
                used.append(f"right_bytes~{r}")
            if rr is None and learned.get("right_rows"):
                rr = int(learned["right_rows"])
                used.append(f"right_rows~{rr}")
        self.stats.decision(
            {
                "target": "join",
                "key": sid,
                "plan": scope.plan_fp,
                "value": {
                    "left_bytes": l,
                    "right_bytes": r,
                    "right_rows": rr,
                },
                "source": "adaptive" if used else "static",
                "evidence": (
                    "observed cardinalities: " + ", ".join(used)
                    if used
                    else "no observations"
                ),
                "confidence": _confidence(int((learned or {}).get("obs", 0) or 0)),
            }
        )
        return l, r, rr, handle

    # -- learning ------------------------------------------------------------
    def _budget(self) -> int:
        try:
            return device_budget_bytes(self._device)
        except Exception:
            return 0

    def flush(self, scope: _Scope) -> None:
        """Turn the scope's observations into next-generation settings and
        persist. Publishes to disk only on MATERIAL change (a new or
        changed setting, a convergence flip, a >20% cardinality drift);
        bookkeeping-only updates stay in memory — a converged warm server
        does not rewrite the file on every submission."""
        # drain the run's roofline folds first — they publish (or no-op)
        # independently of whether any knob observation landed below
        self.roofline.flush()
        with scope._lock:
            stream_obs = list(scope.stream_obs)
            exchanges = list(scope.exchanges)
        if not stream_obs and not any(h.obs for h in exchanges):
            return
        budget = self._budget()
        material = False
        converged_flips = 0
        cur_entry = self.store.plan_entry(scope.plan_fp) or {}

        def mutate(e: Dict[str, Any]) -> Optional[Dict[str, Any]]:
            nonlocal material, converged_flips
            streams = dict(e.get("streams") or {})
            joins = dict(e.get("joins") or {})
            for handle, run in stream_obs:
                used_chunk = handle.chunk_rows
                used_depth = handle.used_depth
                adj = adjust_stream(used_chunk, used_depth, run, budget)
                cur = streams.get(handle.sid)
                if adj is None:
                    if cur:
                        cur = dict(cur)
                        cur["obs"] = int(cur.get("obs", 0) or 0) + 1
                        streams[handle.sid] = cur
                    continue
                if cur is None and adj["converged"]:
                    continue  # static values already in band: nothing learned
                new = {
                    "chunk_rows": adj["chunk_rows"],
                    "prefetch_depth": adj["prefetch_depth"],
                    "obs": int((cur or {}).get("obs", 0) or 0) + 1,
                    "converged": adj["converged"],
                    "evidence": adj["evidence"],
                }
                if adj["converged"] and not (cur or {}).get("converged"):
                    converged_flips += 1
                if (
                    cur is None
                    or cur.get("chunk_rows") != new["chunk_rows"]
                    or cur.get("prefetch_depth") != new["prefetch_depth"]
                    or bool(cur.get("converged")) != new["converged"]
                ):
                    material = True
                streams[handle.sid] = new
            for handle in exchanges:
                if not handle.obs:
                    continue
                cur = dict(joins.get(handle.sid) or {})
                new = dict(cur)
                new["obs"] = int(cur.get("obs", 0) or 0) + 1
                for k in ("left_bytes", "right_bytes", "left_rows", "right_rows"):
                    v = handle.obs.get(k)
                    if v is None:
                        continue
                    old = cur.get(k)
                    if old is None or abs(v - old) > CARDINALITY_MARGIN * max(
                        old, 1
                    ):
                        new[k] = int(v)
                        material = True
                # staged device-exchange calibration: persist
                # the measured schedule (stage count + peak per-stage
                # payload) under the same drift margin as cardinalities
                for k in ("exch_stages", "exch_peak_stage_bytes"):
                    v = handle.obs.get(k)
                    if v is None:
                        continue
                    old = cur.get(k)
                    if old is None or abs(v - old) > CARDINALITY_MARGIN * max(
                        old, 1
                    ):
                        new[k] = int(v)
                        material = True
                if handle.used_buckets and handle.obs.get("peak_device_bytes"):
                    adj = adjust_buckets(handle.used_buckets, handle.obs, budget)
                    if adj is not None:
                        if cur.get("buckets") != adj["buckets"] or bool(
                            cur.get("converged")
                        ) != adj["converged"]:
                            material = True
                        if adj["converged"] and not cur.get("converged"):
                            converged_flips += 1
                        new["buckets"] = adj["buckets"]
                        new["converged"] = adj["converged"]
                        new["evidence"] = adj["evidence"]
                if handle.obs.get("pipe_chunks"):
                    padj = adjust_pipeline(
                        handle.used_pair_depth, handle.used_mem_bytes, handle.obs
                    )
                    if padj is not None:
                        if (
                            cur.get("pair_depth") != padj["pair_depth"]
                            or cur.get("mem_bytes") != padj["mem_bytes"]
                            or bool(cur.get("pipe_converged"))
                            != padj["converged"]
                        ):
                            material = True
                        if padj["converged"] and not cur.get("pipe_converged"):
                            converged_flips += 1
                        new["pair_depth"] = padj["pair_depth"]
                        new["mem_bytes"] = padj["mem_bytes"]
                        new["pipe_converged"] = padj["converged"]
                        new["pipe_evidence"] = padj["evidence"]
                if new != cur:
                    joins[handle.sid] = new
            if not streams and not joins:
                return None
            e["streams"] = streams
            e["joins"] = joins
            return e

        # compute ONCE against the current snapshot; publish overlays the
        # computed sections onto a fresh read (cross-process merge at the
        # entry level; a racing publisher of the SAME plan last-wins)
        merged = mutate(dict(cur_entry))
        if merged is None:
            return
        if converged_flips:
            self.stats.inc("converged", converged_flips)
        if material:

            def install(e: Dict[str, Any]) -> Dict[str, Any]:
                out_streams = dict(e.get("streams") or {})
                out_streams.update(merged.get("streams") or {})
                out_joins = dict(e.get("joins") or {})
                out_joins.update(merged.get("joins") or {})
                e["streams"] = out_streams
                e["joins"] = out_joins
                return e

            self.store.publish(scope.plan_fp, install)
        else:
            import time as _time

            merged["ts"] = _time.time()
            merged.setdefault("gen", int(cur_entry.get("gen", 0) or 0))
            self.store.remember(scope.plan_fp, merged)


# -- explain rendering -------------------------------------------------------
def describe_tuning(
    conf: Any, plan_fp: Optional[str], engine: Any = None
) -> List[str]:
    """The ``workflow.explain()`` tuning section: what the tuner WOULD
    use for this plan right now — per-knob value, source, evidence and
    confidence — or why it stays static."""
    lines = ["", "Adaptive tuning:"]
    if not tuning_enabled(conf):
        lines.append(
            "  DISABLED (fugue.tpu.tuning.enabled=false) -- all knobs static"
        )
        return lines
    if plan_fp is None:
        lines.append("  static: plan not fingerprintable")
        return lines
    tuner = getattr(engine, "tuner", None) if engine is not None else None
    store = tuner.store if tuner is not None else TunedStore(resolve_tuned_path(conf))
    entry = store.plan_entry(plan_fp)
    if not entry:
        lines.append(
            f"  static: no observations for plan {plan_fp} "
            f"(store: {store.path})"
        )
        return lines
    gen = int(entry.get("gen", 0) or 0)
    lines.append(f"  plan {plan_fp}: generation {gen} (store: {store.path})")
    for sid, s in sorted((entry.get("streams") or {}).items()):
        if not isinstance(s, dict):
            continue
        lines.append(
            "  stream %s: chunk_rows=%s prefetch_depth=%s [%s, obs=%s, "
            "confidence=%s] -- %s"
            % (
                sid,
                s.get("chunk_rows"),
                s.get("prefetch_depth"),
                "converged" if s.get("converged") else "adjusting",
                s.get("obs", 0),
                _confidence(int(s.get("obs", 0) or 0)),
                s.get("evidence", ""),
            )
        )
    for sid, j in sorted((entry.get("joins") or {}).items()):
        if not isinstance(j, dict):
            continue
        parts = []
        if j.get("buckets"):
            parts.append(f"buckets={j['buckets']}")
        if j.get("pair_depth") is not None:
            parts.append(f"pair_depth={j['pair_depth']}")
        if j.get("mem_bytes") is not None:
            parts.append(f"mem_bytes={j['mem_bytes']}")
        for k in ("left_bytes", "right_bytes", "right_rows"):
            if j.get(k) is not None:
                parts.append(f"{k}~{j[k]}")
        if j.get("exch_stages") is not None:
            parts.append(
                f"exchange: {j['exch_stages']} stages @ "
                f"<={j.get('exch_peak_stage_bytes', 0)}B/stage"
            )
        lines.append(
            "  %s: %s [%s, obs=%s, confidence=%s] -- %s"
            % (
                sid,
                " ".join(parts) or "(cardinalities only)",
                "converged" if j.get("converged") else "adjusting",
                j.get("obs", 0),
                _confidence(int(j.get("obs", 0) or 0)),
                j.get("evidence", ""),
            )
        )
    return lines
