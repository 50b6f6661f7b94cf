"""Unified observability: hierarchical span tracing, one metrics
registry, live distribution metrics, and a continuous resource sampler.

The port's copy of ``fugue_tpu/obs`` (see ``docs/observability.md``),
process-wide state of its own: the tracer, the span metrics and the
sampler here are not the JAX package's. Two modules differ from the
reference: ``tracer.py`` mirrors spans into ``torch.profiler`` ranges and
``sampler.py`` reads device bytes from the CUDA caching allocator. The
cluster pieces (``spool``, ``assemble``, ``events``) are file based and
copied whole; the dist tier's workers and supervisor (``fugue_tpu_torch/
dist``) write them.
Quick start::

    from fugue_tpu_torch.obs import get_tracer, get_sampler
    from fugue_tpu_torch.obs.export import write_chrome_trace

    get_tracer().enable()          # or conf fugue.tpu.trace.enabled=True
    get_sampler().start()          # or conf fugue.tpu.telemetry.enabled=True
    ...run workflows...
    write_chrome_trace("/tmp/trace.json")   # spans + resource counter tracks
    print(engine.report())                  # top-N report w/ p50/p95/p99
    engine.stats()["latency"]               # per-span latency distributions
    to_prometheus_text(engine)              # what GET /metrics serves
    engine.reset_stats()                    # consistent reset across all
"""

from .assemble import assemble_trace
from .events import (
    EVENT_TYPES,
    EventLog,
    configure_events_from_conf,
    get_event_log,
    read_events,
    render_timeline,
)
from .export import (
    render_report,
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)
from .metrics import (
    Histogram,
    HistogramFamily,
    SpanMetrics,
    active_run_labels,
    current_run_labels,
    get_span_metrics,
    run_labels,
)
from .prom import to_prometheus_text, validate_prometheus_text
from .registry import MetricsRegistry
from .sampler import (
    ResourceSampler,
    configure_sampler_from_conf,
    get_sampler,
)
from .spool import publish_spool, read_spools
from .tracer import (
    NULL_SPAN,
    Tracer,
    configure_from_conf,
    current_trace_id,
    get_tracer,
    mint_trace_id,
    proc_ident,
    set_verb_observer,
    trace_carrier,
    trace_scope,
    traced_verb,
)

__all__ = [
    "EVENT_TYPES",
    "EventLog",
    "Histogram",
    "HistogramFamily",
    "MetricsRegistry",
    "NULL_SPAN",
    "ResourceSampler",
    "SpanMetrics",
    "Tracer",
    "active_run_labels",
    "assemble_trace",
    "configure_events_from_conf",
    "configure_from_conf",
    "configure_sampler_from_conf",
    "current_run_labels",
    "current_trace_id",
    "get_event_log",
    "get_sampler",
    "get_span_metrics",
    "get_tracer",
    "mint_trace_id",
    "proc_ident",
    "publish_spool",
    "read_events",
    "read_spools",
    "render_report",
    "render_timeline",
    "run_labels",
    "set_verb_observer",
    "to_chrome_trace",
    "to_prometheus_text",
    "trace_carrier",
    "trace_scope",
    "traced_verb",
    "validate_chrome_trace",
    "validate_prometheus_text",
    "write_chrome_trace",
]
