"""Cost-based adaptive execution, copied from ``fugue_tpu/tuning``: a
feedback layer that re-derives a stream's chunk size and prefetch depth,
and a spill join's bucket count, pipeline knobs and side estimates, from
the engine's own telemetry, keyed by plan fingerprint and
persisted to ``fugue_tpu_torch/build/_tuned.json`` (or
``fugue.tpu.tuning.path``) so a warm engine converges across runs and
survives restart. ``fugue.tpu.tuning.enabled=false`` resolves every knob
from the static conf."""

from .roofline import RooflineRecorder, install_verb_observer, rooflines_enabled
from .stats import TuningStats
from .store import TunedStore, default_tuned_path, resolve_tuned_path
from .tuner import (
    ExchangeHandle,
    StreamHandle,
    Tuner,
    adjust_buckets,
    adjust_pipeline,
    adjust_stream,
    current_scope,
    describe_tuning,
    plan_fingerprint,
    run_scope,
    tuning_enabled,
)

__all__ = [
    "ExchangeHandle",
    "RooflineRecorder",
    "StreamHandle",
    "TunedStore",
    "Tuner",
    "TuningStats",
    "adjust_buckets",
    "adjust_pipeline",
    "adjust_stream",
    "current_scope",
    "default_tuned_path",
    "describe_tuning",
    "install_verb_observer",
    "plan_fingerprint",
    "resolve_tuned_path",
    "rooflines_enabled",
    "run_scope",
    "tuning_enabled",
]
