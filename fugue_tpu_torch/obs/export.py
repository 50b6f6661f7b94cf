"""Trace exporters: Chrome trace-event JSON (Perfetto / about:tracing) and
a plain-text top-N report.

The Chrome format is the `trace event format`_ "JSON object" flavor: a
``{"traceEvents": [...]}`` envelope of complete (``"ph": "X"``) events
with microsecond ``ts``/``dur``. Resource-sampler series additionally
export as counter (``"ph": "C"``) events — Perfetto renders each as a
counter track (device bytes, host RSS, overlap_fraction, ...) directly
under the span timeline, same clock. Perfetto and chrome://tracing both
load it; ``validate_chrome_trace`` asserts an exported file actually
parses as that shape.

.. _trace event format:
   https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""

import json
import os
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "to_chrome_trace",
    "write_chrome_trace",
    "validate_chrome_trace",
    "render_report",
]


def to_chrome_trace(
    records: Iterable[Dict[str, Any]],
    counters: Optional[Iterable[Any]] = None,
    counter_tracks: Optional[Dict[int, Iterable[Any]]] = None,
    process_names: Optional[Dict[int, str]] = None,
) -> Dict[str, Any]:
    """Convert tracer records (ns timestamps) to a Chrome trace-event dict.

    ``counters`` is an optional resource-sampler series — an iterable of
    ``(ts_ns, {name: value})`` samples (``ResourceSampler.series()``);
    each name becomes one Perfetto counter track (``ph: "C"``) on the
    driver process, sharing the spans' clock so resource curves render
    directly under the span bars. ``counter_tracks`` pins additional
    series to explicit track pids (the cluster assembler ships each remote
    process's sampler ring home and renders it on that process's track).
    ``process_names`` overrides the default driver/worker track naming.
    Each span event carries its tracer span id as a top-level ``"id"`` so
    ``validate_chrome_trace`` can prove cluster-wide id uniqueness."""
    events: List[Dict[str, Any]] = []
    pids = set()
    for r in records:
        pids.add(r["pid"])
        ev = {
            "name": r["name"],
            "cat": r.get("cat", "host"),
            "ph": "X",
            "ts": r["ts"] / 1000.0,  # ns → µs
            "dur": max(r["dur"], 0) / 1000.0,
            "pid": r["pid"],
            "tid": r.get("tid", 1),
            "args": _jsonable(r.get("args", {})),
        }
        if r.get("id") is not None:
            ev["id"] = r["id"]
        if r.get("trace"):
            ev["args"]["trace"] = r["trace"]
        events.append(ev)
    tracks: Dict[int, Any] = dict(counter_tracks or {})
    if counters:
        tracks.setdefault(os.getpid(), counters)
    for cpid, series in tracks.items():
        for ts, vals in series:
            for cname, v in vals.items():
                events.append(
                    {
                        "name": cname,
                        "cat": "resource",
                        "ph": "C",
                        "ts": ts / 1000.0,
                        "pid": cpid,
                        "tid": 0,
                        "args": {"value": v},
                    }
                )
        pids.add(cpid)
    # metadata events name the process tracks (driver vs forked workers)
    first = min(pids) if pids else None
    names = process_names or {}
    for pid in sorted(pids):
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {
                    "name": names.get(
                        pid,
                        "fugue-tpu driver" if pid == first else f"fugue-tpu worker {pid}",
                    )
                },
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(args: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in args.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


def write_chrome_trace(
    path: str,
    records: Optional[Iterable[Dict[str, Any]]] = None,
    counters: Optional[Iterable[Any]] = None,
) -> str:
    """Write the (or the global tracer's) records as Chrome trace JSON.
    When ``counters`` is not given, the global resource sampler's ring is
    included automatically — a sampled run exports its resource curves as
    counter tracks with no extra plumbing."""
    if records is None:
        from .tracer import get_tracer

        records = get_tracer().records()
    if counters is None:
        from .sampler import get_sampler

        counters = get_sampler().series()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(records, counters=counters), f)
    return path


def validate_chrome_trace(path: str) -> Dict[str, Any]:
    """Assert ``path`` is valid trace-event JSON; returns summary counts.

    Checks the envelope, the per-event required keys, that durations/
    timestamps are non-negative numbers — the properties Perfetto needs to
    render the file at all — and that no two span events share
    one ``(pid, span id)`` pair, the regression the host+pid id prefix
    exists to prevent when multiple hosts' spans merge into one trace.
    """
    with open(path) as f:
        doc = json.load(f)
    assert isinstance(doc, dict) and "traceEvents" in doc, (
        f"{path}: expected a traceEvents envelope"
    )
    events = doc["traceEvents"]
    assert isinstance(events, list) and len(events) > 0, f"{path}: no events"
    n_spans = 0
    n_counters = 0
    names = set()
    counter_names = set()
    seen_ids = set()
    for ev in events:
        assert isinstance(ev, dict) and "ph" in ev and "name" in ev, ev
        assert "pid" in ev, ev
        if ev["ph"] == "X":
            n_spans += 1
            names.add(ev["name"])
            assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0, ev
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0, ev
            assert "tid" in ev, ev
            if ev.get("id") is not None:
                key = (ev["pid"], ev["id"])
                assert key not in seen_ids, (
                    f"{path}: duplicate (pid, span id) pair {key} — "
                    "colliding span ids corrupt parent links in merged traces"
                )
                seen_ids.add(key)
        elif ev["ph"] == "C":
            n_counters += 1
            counter_names.add(ev["name"])
            assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0, ev
            args = ev.get("args")
            assert isinstance(args, dict) and args, ev
            assert all(isinstance(v, (int, float)) for v in args.values()), ev
    assert n_spans > 0, f"{path}: no complete ('X') span events"
    return {
        "events": len(events),
        "spans": n_spans,
        "names": sorted(names),
        "counters": n_counters,
        "counter_names": sorted(counter_names),
    }


def render_report(
    records: List[Dict[str, Any]],
    stats: Optional[Dict[str, Any]] = None,
    top_n: int = 15,
    span_metrics: Any = None,
    rooflines: Optional[Dict[str, Dict[str, Any]]] = None,
) -> str:
    """Plain-text top-N report: spans grouped by name with count / total /
    self / mean / p50 / p95 / p99 / max wall, plus the metrics registry
    dump. Quantiles come from the span-latency histograms (the global
    :class:`~fugue_tpu_torch.obs.metrics.SpanMetrics` store unless one is
    passed); a span name with no histogram series prints ``-``.
    ``rooflines`` (``<verb>|<dtype-class>|w<width>`` → throughput fold,
    the record-only table) renders as its own section when
    non-empty."""
    if span_metrics is None:
        from .metrics import get_span_metrics

        span_metrics = get_span_metrics()
    try:
        latency = span_metrics.summary()
    except Exception:
        latency = {}
    by_id = {r["id"]: r for r in records}
    child_time: Dict[str, int] = {}
    for r in records:
        p = r.get("parent")
        if p is not None and p in by_id:
            child_time[p] = child_time.get(p, 0) + r["dur"]
    agg: Dict[str, Dict[str, float]] = {}
    for r in records:
        a = agg.setdefault(
            r["name"], {"count": 0, "total": 0, "self": 0, "max": 0}
        )
        a["count"] += 1
        a["total"] += r["dur"]
        a["self"] += max(r["dur"] - child_time.get(r["id"], 0), 0)
        a["max"] = max(a["max"], r["dur"])
    lines = ["== span report (top %d by total wall) ==" % top_n]
    if not agg:
        lines.append("(no spans recorded — is tracing enabled?)")
    else:
        lines.append(
            f"{'span':<28}{'count':>8}{'total_ms':>12}{'self_ms':>12}"
            f"{'mean_ms':>10}{'p50_ms':>10}{'p95_ms':>10}{'p99_ms':>10}"
            f"{'max_ms':>10}"
        )

        def q(name: str, key: str) -> str:
            v = latency.get(name, {}).get(key)
            return f"{v:>10.3f}" if isinstance(v, (int, float)) else f"{'-':>10}"

        ranked = sorted(agg.items(), key=lambda kv: -kv[1]["total"])[:top_n]
        for name, a in ranked:
            lines.append(
                f"{name:<28}{int(a['count']):>8}"
                f"{a['total'] / 1e6:>12.3f}{a['self'] / 1e6:>12.3f}"
                f"{a['total'] / a['count'] / 1e6:>10.3f}"
                f"{q(name, 'p50_ms')}{q(name, 'p95_ms')}{q(name, 'p99_ms')}"
                f"{a['max'] / 1e6:>10.3f}"
            )
    if rooflines:
        lines.append("")
        lines.append("== verb rooflines (record-only; best achieved) ==")
        lines.append(
            f"{'verb|dtype|width':<36}{'obs':>6}{'best_MB/s':>12}"
            f"{'best_Mrow/s':>13}{'last_MB/s':>12}{'last_Mrow/s':>13}"
        )

        def mb(v: Any) -> str:
            return (
                f"{float(v) / 1e6:>12.2f}"
                if isinstance(v, (int, float))
                else f"{'-':>12}"
            )

        ranked_rl = sorted(
            rooflines.items(),
            key=lambda kv: -float(kv[1].get("best_bytes_s", 0) or 0),
        )
        for key, e in ranked_rl:
            lines.append(
                f"{key:<36}{int(e.get('obs', 0) or 0):>6}"
                f"{mb(e.get('best_bytes_s'))}"
                f"{mb(e.get('best_rows_s')):>13}"
                f"{mb(e.get('last_bytes_s'))}"
                f"{mb(e.get('last_rows_s')):>13}"
            )
    if stats:
        lines.append("")
        lines.append("== metrics ==")
        for group, vals in stats.items():
            lines.append(f"[{group}]")
            if isinstance(vals, dict):
                for k, v in sorted(vals.items()):
                    if isinstance(v, dict):
                        lines.append(f"  {k}: {json.dumps(v, sort_keys=True)}")
                    else:
                        lines.append(f"  {k}: {v}")
            else:
                lines.append(f"  {vals}")
    return "\n".join(lines)
