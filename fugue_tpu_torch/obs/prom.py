"""Prometheus text exposition.

``to_prometheus_text`` renders the process-global span histograms, the
resource sampler's latest gauges, and (optionally) one engine's
flattened counter registry into the `text exposition format`_ version
0.0.4 — what the JAX package's ``HttpRPCServer`` serves at ``GET /metrics``
(the port's HTTP server is not ported yet, ROADMAP.md A.10) and any
Prometheus-compatible scraper ingests. Histogram series
keep their full label sets (``span``/``workflow``/``run``) — the
attribution a per-tenant serving layer reuses unchanged.

``validate_prometheus_text`` asserts the line grammar, label syntax, that no name gets a second
``# TYPE`` line and no (name, label-set) sample repeats, cumulative-bucket
monotonicity, the ``+Inf`` bucket, and ``_count``/``+Inf`` agreement —
the properties a scraper needs to ingest the page at all.

.. _text exposition format:
   https://prometheus.io/docs/instrumenting/exposition_formats/
"""

import math
import re
from typing import Any, Dict, List, Optional

__all__ = ["to_prometheus_text", "validate_prometheus_text"]

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LINE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"  # metric name
    r"(\{[^{}]*\})?"  # optional label set
    r" (-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf)|NaN|\+Inf)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _name(*parts: str) -> str:
    n = _NAME_BAD.sub("_", "_".join(p for p in parts if p))
    return n if not n[:1].isdigit() else "_" + n


def _escape(v: Any) -> str:
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_NAME_BAD.sub("_", str(k))}="{_escape(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _num(v: float) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _render_histogram_family(family: Any, lines: List[str]) -> int:
    """Render one HistogramFamily; returns the number of series emitted."""
    name = _name(family.name)
    emitted = 0
    header = False
    for labels, hist in family.series():
        enc = hist.encode()
        if not enc["count"]:
            continue
        if not header:
            lines.append(f"# HELP {name} {family.help}")
            lines.append(f"# TYPE {name} histogram")
            header = True
        emitted += 1
        cum = 0
        for bound, c in zip(family.bounds, enc["counts"]):
            cum += c
            lines.append(
                f"{name}_bucket{_labels({**labels, 'le': '%g' % bound})} {cum}"
            )
        cum += enc["counts"][-1]
        lines.append(f"{name}_bucket{_labels({**labels, 'le': '+Inf'})} {cum}")
        lines.append(f"{name}_sum{_labels(labels)} {_num(float(enc['sum']))}")
        lines.append(f"{name}_count{_labels(labels)} {enc['count']}")
    return emitted


def _flatten_numeric(d: Any, prefix: str, out: Dict[str, float]) -> None:
    if not isinstance(d, dict):
        return
    for k, v in d.items():
        path = f"{prefix}_{k}" if prefix else str(k)
        if isinstance(v, dict):
            _flatten_numeric(v, path, out)
        elif isinstance(v, bool):
            out[path] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            out[path] = float(v)


def to_prometheus_text(
    engine: Any = None,
    span_metrics: Any = None,
    sampler: Any = None,
) -> str:
    """Render the current telemetry as Prometheus text exposition.

    Included, in order: every span histogram family (latency / rows /
    bytes, fully labeled), the sampler's latest sample as
    ``fugue_tpu_resource_*`` gauges (+ ring/running meta), and — when an
    engine is given — its ``engine.stats()`` numeric leaves flattened to
    ``fugue_tpu_<group>_<key>`` gauges."""
    if span_metrics is None:
        from .metrics import get_span_metrics

        span_metrics = get_span_metrics()
    if sampler is None:
        from .sampler import get_sampler

        sampler = get_sampler()
    lines: List[str] = []
    for family in span_metrics.families():
        _render_histogram_family(family, lines)
    last = sampler.last()
    for k in sorted(last):
        n = _name("fugue_tpu_resource", k)
        lines.append(f"# HELP {n} resource sampler gauge {k}")
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_num(float(last[k]))}")
    # sampler meta is emitted here unconditionally and ONLY here — the
    # engine-stats flatten below skips the "telemetry" group so these
    # names never appear twice on one page (a duplicate TYPE/sample makes
    # Prometheus reject the whole scrape)
    meta = sampler.as_dict()
    lines.append("# TYPE fugue_tpu_telemetry_samples gauge")
    lines.append(f"fugue_tpu_telemetry_samples {meta['samples']}")
    lines.append("# TYPE fugue_tpu_telemetry_running gauge")
    lines.append(f"fugue_tpu_telemetry_running {1 if meta['running'] else 0}")
    if engine is not None:
        flat: Dict[str, float] = {}
        try:
            for group, vals in engine.stats().items():
                if group in ("latency", "telemetry"):
                    # latency: already exposed as real histograms above;
                    # telemetry: the sampler gauges + meta above are the
                    # single source for those names
                    continue
                _flatten_numeric(vals, str(group), flat)
        except Exception:
            flat = {}
        for k in sorted(flat):
            n = _name("fugue_tpu", k)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_num(flat[k])}")
    return "\n".join(lines) + "\n"


def validate_prometheus_text(text: str) -> Dict[str, Any]:
    """Assert ``text`` is scrapeable exposition; returns summary counts.

    Checks every sample line against the exposition grammar, label-pair
    syntax, that no metric name gets a second ``# TYPE`` line, that no
    (name, label-set) sample appears twice (either duplicate makes a real
    Prometheus scrape fail), and for each histogram series: cumulative
    buckets non-decreasing, a ``+Inf`` bucket present, and ``_count``
    equal to the ``+Inf`` bucket."""
    samples = 0
    names = set()
    typed: Dict[str, int] = {}  # name -> lineno of its TYPE line
    seen: Dict[Any, int] = {}  # (name, sorted labels) -> lineno
    # (base_name, labels-minus-le) -> {"buckets": [(le, v)], "count": v}
    hists: Dict[Any, Dict[str, Any]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                tname = parts[2]
                assert tname not in typed, (
                    f"line {lineno}: duplicate TYPE for {tname} "
                    f"(first at line {typed[tname]})"
                )
                typed[tname] = lineno
            continue
        m = _LINE_RE.match(line)
        assert m is not None, f"line {lineno} not valid exposition: {line!r}"
        name, labelstr, value = m.group(1), m.group(2) or "", m.group(3)
        labels: Dict[str, str] = {}
        if labelstr:
            body = labelstr[1:-1]
            matched = _LABEL_RE.findall(body)
            rebuilt = ",".join(f'{k}="{v}"' for k, v in matched)
            assert rebuilt == body, f"line {lineno} bad labels: {labelstr!r}"
            labels = dict(matched)
        ident = (name, tuple(sorted(labels.items())))
        assert ident not in seen, (
            f"line {lineno}: duplicate sample {name}{labelstr} "
            f"(first at line {seen[ident]})"
        )
        seen[ident] = lineno
        samples += 1
        names.add(name)
        if name.endswith("_bucket") and "le" in labels:
            base = name[: -len("_bucket")]
            key = (base, tuple(sorted((k, v) for k, v in labels.items() if k != "le")))
            h = hists.setdefault(key, {"buckets": [], "count": None})
            le = labels["le"]
            h["buckets"].append(
                (math.inf if le == "+Inf" else float(le), float(value))
            )
        elif name.endswith("_count"):
            base = name[: -len("_count")]
            key = (base, tuple(sorted(labels.items())))
            hists.setdefault(key, {"buckets": [], "count": None})["count"] = float(
                value
            )
    for (base, lbl), h in hists.items():
        if not h["buckets"]:
            continue
        bs = sorted(h["buckets"])
        assert bs[-1][0] == math.inf, f"{base}{dict(lbl)}: no +Inf bucket"
        vals = [v for _, v in bs]
        assert all(
            a <= b for a, b in zip(vals, vals[1:])
        ), f"{base}{dict(lbl)}: buckets not cumulative: {vals}"
        if h["count"] is not None:
            assert h["count"] == bs[-1][1], (
                f"{base}{dict(lbl)}: _count {h['count']} != +Inf {bs[-1][1]}"
            )
    n_hist = sum(1 for h in hists.values() if h["buckets"])
    assert samples > 0, "no samples in exposition"
    return {"samples": samples, "names": sorted(names), "histogram_series": n_hist}
