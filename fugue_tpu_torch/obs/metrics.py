"""Distribution metrics: bucketed histograms, labeled families, and the
process-global span-metrics store.

The PR 3 registry holds plain counters — enough for "how many", useless
for "how long". This module adds the distribution substrate:

- :class:`Histogram`: fixed exponential buckets with p50/p95/p99
  estimation (Prometheus-style linear interpolation inside the bucket
  containing the target rank, clamped to the observed min/max). The
  internal state is a **mergeable encoding** — plain lists/numbers that
  add associatively — so worker-recorded distributions ship across the
  fork boundary and merge into the driver's without loss.
- :class:`HistogramFamily`: one metric name fanned out over label sets
  (``family.observe(v, span="engine.aggregate", run="ab12")``), the
  attribution scheme a per-tenant serving layer reuses unchanged.
- :class:`SpanMetrics`: the process-global store fed by the tracer at
  every span close — every span name gets a latency distribution for
  free, and ``rows``/``bytes`` span attrs feed throughput histograms.
  Process-global like the tracer itself (one timeline, one metric
  store); ``engine.stats()["latency"]`` reads it, ``engine.reset_stats()``
  resets it under the keep-entries contract (series stay registered,
  observations zero — the ``JitCache.reset`` rule).

Run attribution: :func:`run_labels` is a context-local label scope the
workflow layer enters for the duration of a run; every observation made
while it is active carries the ``workflow``/``run`` labels. It is a
:class:`contextvars.ContextVar`, so two runs executing concurrently in
one process never see each other's labels; propagation to the places
observations actually happen is explicit: the workflow task pool submits
through ``contextvars.copy_context()``, the chunk prefetcher runs its
producer inside the consumer's context snapshot, and forked map workers
inherit the forking thread's context wholesale (``fork`` clones it —
the pool is forked per map call, inside the run).
"""

import contextvars
import itertools
import threading
from bisect import bisect_left
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "DEFAULT_LATENCY_BOUNDS",
    "DEFAULT_SIZE_BOUNDS",
    "Histogram",
    "HistogramFamily",
    "SpanMetrics",
    "active_run_labels",
    "current_run_labels",
    "get_span_metrics",
    "run_labels",
]

# latency buckets (seconds): 1µs … ~134s, ×2 per bucket — 28 buckets plus
# overflow covers a single jit dispatch through a full 1B-row pass
DEFAULT_LATENCY_BOUNDS: Tuple[float, ...] = tuple(1e-6 * (2**i) for i in range(28))
# size buckets (rows or bytes): 4 … ~1.1e12, ×4 per bucket
DEFAULT_SIZE_BOUNDS: Tuple[float, ...] = tuple(float(4**i) for i in range(1, 21))


def _quantile_from(
    enc: Dict[str, Any], bounds: Tuple[float, ...], q: float
) -> Optional[float]:
    """Quantile estimate over an :meth:`Histogram.encode` snapshot: linear
    interpolation inside the bucket containing the target rank, clamped to
    the snapshot's [min, max]. Pure function of the snapshot, so every
    field derived from one encode() is mutually consistent."""
    count = enc["count"]
    if not count:
        return None
    vmin, vmax = enc["min"], enc["max"]
    target = max(min(q, 1.0), 0.0) * count
    cum = 0
    lo = 0.0
    for i, c in enumerate(enc["counts"]):
        hi = bounds[i] if i < len(bounds) else (vmax if vmax is not None else lo)
        if cum + c >= target and c > 0:
            est = lo + (hi - lo) * ((target - cum) / c)
            break
        cum += c
        lo = hi
    else:
        est = vmax if vmax is not None else 0.0
    if vmin is not None:
        est = max(est, vmin)
    if vmax is not None:
        est = min(est, vmax)
    return est


class Histogram:
    """Fixed-bucket histogram with quantile estimation and merge support.

    ``counts[i]`` counts observations ``v <= bounds[i]`` (first matching
    bucket); ``counts[-1]`` is the overflow bucket. ``encode()`` returns
    the plain-data form that :meth:`merge` adds back in — counts, sum and
    count add associatively, min/max combine via min/max, so merging is
    order-independent across any number of workers.
    """

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_LATENCY_BOUNDS):
        self.bounds = tuple(bounds)
        self._lock = threading.Lock()
        self._zero_locked()

    def _zero_locked(self) -> None:
        # caller holds self._lock (construction is single-threaded)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.counts[bisect_left(self.bounds, v)] += 1
            self.sum += v
            self.count += 1
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    # -- mergeable encoding --------------------------------------------------
    def encode(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counts": list(self.counts),
                "sum": self.sum,
                "count": self.count,
                "min": self.min,
                "max": self.max,
            }

    def merge(self, enc: Dict[str, Any]) -> None:
        """Add an encoded delta in. Associative and commutative: merging
        worker A's delta then B's equals B's then A's equals observing
        every value locally."""
        if not enc or not enc.get("count"):
            return
        counts = enc["counts"]
        with self._lock:
            n = min(len(counts), len(self.counts))
            for i in range(n):
                self.counts[i] += counts[i]
            self.sum += enc["sum"]
            self.count += enc["count"]
            for key, pick in (("min", min), ("max", max)):
                v = enc.get(key)
                if v is not None:
                    cur = getattr(self, key)
                    setattr(self, key, v if cur is None else pick(cur, v))

    def subtract(self, enc: Dict[str, Any]) -> Dict[str, Any]:
        """Current state minus an earlier :meth:`encode` — the
        fork-boundary delta a worker ships home (its post-fork
        observations only; the COW copy inherited at fork subtracts out)."""
        cur = self.encode()
        if not enc:
            return cur
        base = enc.get("counts", [])
        counts = [
            c - (base[i] if i < len(base) else 0) for i, c in enumerate(cur["counts"])
        ]
        return {
            "counts": counts,
            "sum": cur["sum"] - enc.get("sum", 0.0),
            "count": cur["count"] - enc.get("count", 0),
            # min/max of just-the-delta is unrecoverable from two encodes;
            # the current values are a conservative superset (merging them
            # home can only widen the driver's range to values it, or its
            # fork parent, already saw)
            "min": cur["min"],
            "max": cur["max"],
        }

    # -- quantiles -----------------------------------------------------------
    # All quantile/summary readers derive from ONE encode() snapshot (a
    # single lock acquisition), so a reported p50/p95/p99 and the
    # count/mean beside it always describe the same distribution even
    # while observe() runs concurrently.
    def quantile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile (0..1) by linear interpolation within
        the bucket containing the target rank, clamped to the observed
        [min, max] so estimates never leave the data's actual range."""
        return _quantile_from(self.encode(), self.bounds, q)

    def percentiles(self) -> Dict[str, Optional[float]]:
        enc = self.encode()
        return {
            "p50": _quantile_from(enc, self.bounds, 0.50),
            "p95": _quantile_from(enc, self.bounds, 0.95),
            "p99": _quantile_from(enc, self.bounds, 0.99),
        }

    # -- registry source contract -------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        enc = self.encode()
        out: Dict[str, Any] = {
            "count": enc["count"],
            "sum": round(enc["sum"], 9),
            "min": enc["min"],
            "max": enc["max"],
            "mean": (enc["sum"] / enc["count"]) if enc["count"] else None,
        }
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            out[name] = _quantile_from(enc, self.bounds, q)
        return out

    def reset(self) -> None:
        with self._lock:
            self._zero_locked()


def _labels_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class HistogramFamily:
    """A labeled histogram family: one metric name, one series per label
    set. The unit of Prometheus exposition (each series renders its own
    ``_bucket``/``_sum``/``_count`` lines) and of fork-boundary transport
    (encode/merge/delta operate per series, matched by labels — never by
    pid, so two workers' series with equal labels merge additively)."""

    def __init__(
        self,
        name: str,
        bounds: Tuple[float, ...] = DEFAULT_LATENCY_BOUNDS,
        help: str = "",
    ):
        self.name = name
        self.bounds = tuple(bounds)
        self.help = help or name
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], Histogram] = {}

    def _get_or_create(self, key: Tuple[Tuple[str, str], ...]) -> Histogram:
        with self._lock:
            h = self._series.get(key)
            if h is None:
                h = Histogram(self.bounds)
                self._series[key] = h
            return h

    def observe(self, value: float, **labels: Any) -> None:
        self._get_or_create(_labels_key(labels)).observe(value)

    def get(self, **labels: Any) -> Optional[Histogram]:
        with self._lock:
            return self._series.get(_labels_key(labels))

    def series(self) -> List[Tuple[Dict[str, str], Histogram]]:
        with self._lock:
            items = list(self._series.items())
        return [(dict(k), h) for k, h in items]

    # -- mergeable encoding (fork-boundary transport) ------------------------
    def encode(self) -> List[Dict[str, Any]]:
        return [
            {"labels": labels, **h.encode()} for labels, h in self.series()
        ]

    def merge(self, encoded: List[Dict[str, Any]]) -> None:
        for enc in encoded or []:
            if enc.get("count"):
                self._get_or_create(_labels_key(enc.get("labels", {}))).merge(enc)

    def delta_since(self, snapshot: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        base = {
            _labels_key(e.get("labels", {})): e for e in (snapshot or [])
        }
        out: List[Dict[str, Any]] = []
        for labels, h in self.series():
            d = h.subtract(base.get(_labels_key(labels), {}))
            if d.get("count"):
                out.append({"labels": labels, **d})
        return out

    # -- registry source contract -------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for labels, h in self.series():
            if h.count == 0:
                continue  # reset series stay registered but don't report
            key = ",".join(f"{k}={v}" for k, v in sorted(labels.items())) or "_"
            out[key] = h.as_dict()
        return out

    def reset(self) -> None:
        """Zero every series' observations. Series stay REGISTERED — the
        keep-entries contract (``JitCache.reset``): a stats reset must not
        tear down the metric schema a scraper is watching."""
        for _, h in self.series():
            h.reset()

    def prune(self, predicate: Callable[[Dict[str, str]], bool]) -> int:
        """Drop every series whose label dict matches ``predicate``;
        returns how many were dropped. Unlike :meth:`reset` this removes
        the registration itself — the run-label rotation uses it to bound
        per-run series cardinality (see :attr:`SpanMetrics.MAX_RUN_SERIES`)."""
        with self._lock:
            drop = [k for k in self._series if predicate(dict(k))]
            for k in drop:
                del self._series[k]
        return len(drop)

    def clear(self) -> None:
        """Drop every series (test isolation; NOT part of reset)."""
        with self._lock:
            self._series.clear()


# --------------------------------------------------------------------------
# run attribution labels
# --------------------------------------------------------------------------

_RUN_LABELS_VAR: "contextvars.ContextVar[Dict[str, str]]" = contextvars.ContextVar(
    "fugue_tpu_run_labels", default={}
)
# currently-entered label scopes, for introspection (/stats) from threads
# outside any run context (e.g. the HTTP server); insertion-ordered so the
# most recently entered run is last
_ACTIVE_LOCK = threading.Lock()
_ACTIVE_RUNS: "OrderedDict[int, Dict[str, str]]" = OrderedDict()
_ACTIVE_SEQ = itertools.count()


def current_run_labels() -> Dict[str, str]:
    """The labels attached to metric observations made from the calling
    context (``workflow``/``run`` inside a workflow run's context, else
    empty). Context-local: concurrent runs each see their own."""
    return dict(_RUN_LABELS_VAR.get())


def active_run_labels() -> List[Dict[str, str]]:
    """Label dicts of every :func:`run_labels` scope currently entered
    anywhere in the process, oldest first — the cross-thread view a
    telemetry endpoint reports when it is not itself inside a run."""
    with _ACTIVE_LOCK:
        return [dict(v) for v in _ACTIVE_RUNS.values()]


@contextmanager
def run_labels(**labels: Any) -> Iterator[None]:
    """Attach labels to every span-metric observation for the duration.

    Context-local (:mod:`contextvars`): concurrent runs in one process
    never cross-contaminate, and the token-based reset restores the right
    outer scope even under non-LIFO exits. Nested uses overlay (inner
    wins, outer restored on exit). Propagation is explicit where work
    leaves this context: thread pools submit through
    ``contextvars.copy_context()`` and forked workers inherit the forking
    thread's context."""
    merged = {
        **_RUN_LABELS_VAR.get(),
        **{str(k): str(v) for k, v in labels.items()},
    }
    token = _RUN_LABELS_VAR.set(merged)
    key = next(_ACTIVE_SEQ)
    with _ACTIVE_LOCK:
        _ACTIVE_RUNS[key] = merged
    try:
        yield
    finally:
        _RUN_LABELS_VAR.reset(token)
        with _ACTIVE_LOCK:
            _ACTIVE_RUNS.pop(key, None)


# --------------------------------------------------------------------------
# the process-global span-metrics store
# --------------------------------------------------------------------------


class SpanMetrics:
    """Latency/rows/bytes histogram families auto-fed at span close.

    Every tracer record feeds ``span_latency_seconds`` (labels: ``span``
    plus the current run labels); ``rows``/``rows_out`` span attrs feed
    ``span_rows``; ``bytes``/``bytes_in``/``bytes_out`` feed
    ``span_bytes``. The registry source contract (``as_dict``/``reset``)
    makes it mount directly as ``engine.stats()["latency"]``.

    Cardinality bound: the ``run`` label is fresh per workflow run, so a
    long-lived process would otherwise accumulate one series per
    (span x workflow x run) forever. Only the most recent
    :attr:`MAX_RUN_SERIES` distinct ``run`` values keep their series;
    when a newer run arrives, the oldest run's series are pruned from
    every family (the per-SPAN summaries and Prometheus page stay
    bounded; traces retain every run's spans untouched). The serving
    layer's ``tenant`` label rides the same rotation with its
    own, larger window (:attr:`MAX_TENANT_SERIES`): tenant ids are
    client-supplied, so an unbounded id stream must age out the same way
    run ids do.
    """

    #: distinct ``run`` label values whose series are retained (LRU by
    #: first observation; older runs' series are pruned, not zeroed)
    MAX_RUN_SERIES = 16
    #: distinct ``tenant`` label values retained — larger than the run
    #: window (tenants are long-lived identities, runs are ephemeral)
    MAX_TENANT_SERIES = 32

    def __init__(self) -> None:
        self._runs_lock = threading.Lock()
        self._label_lru: Dict[str, "OrderedDict[str, None]"] = {
            "run": OrderedDict(),
            "tenant": OrderedDict(),
        }
        self.latency = HistogramFamily(
            "fugue_tpu_span_latency_seconds",
            DEFAULT_LATENCY_BOUNDS,
            help="wall-clock latency distribution per span name",
        )
        self.rows = HistogramFamily(
            "fugue_tpu_span_rows",
            DEFAULT_SIZE_BOUNDS,
            help="rows processed per span (rows/rows_out attrs)",
        )
        self.bytes = HistogramFamily(
            "fugue_tpu_span_bytes",
            DEFAULT_SIZE_BOUNDS,
            help="bytes moved per span (bytes/bytes_in/bytes_out attrs)",
        )

    def families(self) -> Tuple[HistogramFamily, ...]:
        return (self.latency, self.rows, self.bytes)

    def _label_cap(self, label: str) -> int:
        return self.MAX_TENANT_SERIES if label == "tenant" else self.MAX_RUN_SERIES

    def _note_label(self, label: str, value: str) -> None:
        """Record that ``value`` is a live id for ``label``; evict the
        oldest ids' series once more than the label's window has been
        seen. (``_note_run`` generalized for the tenant label.)"""
        lru = self._label_lru[label]
        evict: List[str] = []
        with self._runs_lock:
            if value in lru:
                lru.move_to_end(value)
            else:
                lru[value] = None
                while len(lru) > self._label_cap(label):
                    evict.append(lru.popitem(last=False)[0])
        for old in evict:
            for f in self.families():
                f.prune(
                    lambda labels, _old=old, _l=label: labels.get(_l) == _old
                )

    def _note_run(self, run_id: str) -> None:
        self._note_label("run", run_id)

    def observe_record(self, rec: Dict[str, Any]) -> None:
        """Feed one completed tracer record (called from ``Tracer._emit``
        — i.e. only while tracing is enabled; the disabled path never
        reaches here)."""
        labels = {"span": rec["name"], **_RUN_LABELS_VAR.get()}
        for rotated in ("run", "tenant"):
            if rotated in labels:
                self._note_label(rotated, labels[rotated])
        self.latency.observe(max(rec.get("dur", 0), 0) / 1e9, **labels)
        args = rec.get("args") or {}
        rows = args.get("rows", args.get("rows_out"))
        if isinstance(rows, (int, float)) and not isinstance(rows, bool):
            self.rows.observe(rows, **labels)
        nbytes = args.get("bytes")
        if nbytes is None:
            bi, bo = args.get("bytes_in"), args.get("bytes_out")
            if bi is not None or bo is not None:
                nbytes = (bi or 0) + (bo or 0)
        if isinstance(nbytes, (int, float)) and not isinstance(nbytes, bool):
            self.bytes.observe(nbytes, **labels)

    # -- fork-boundary transport --------------------------------------------
    def snapshot(self) -> Dict[str, List[Dict[str, Any]]]:
        """Full encode — a worker takes one at chunk start, ships
        :meth:`delta_since` home with the chunk result."""
        return {
            "latency": self.latency.encode(),
            "rows": self.rows.encode(),
            "bytes": self.bytes.encode(),
        }

    def delta_since(
        self, snap: Dict[str, List[Dict[str, Any]]]
    ) -> Dict[str, List[Dict[str, Any]]]:
        snap = snap or {}
        out = {
            "latency": self.latency.delta_since(snap.get("latency", [])),
            "rows": self.rows.delta_since(snap.get("rows", [])),
            "bytes": self.bytes.delta_since(snap.get("bytes", [])),
        }
        return {k: v for k, v in out.items() if v}

    def merge(self, delta: Dict[str, List[Dict[str, Any]]]) -> None:
        if not delta:
            return
        # worker deltas carry run/tenant labels too — count them against
        # the same rotation windows so merged series obey the bound
        for encs in delta.values():
            for enc in encs or []:
                lab = enc.get("labels") or {}
                for rotated in ("run", "tenant"):
                    v = lab.get(rotated)
                    if v:
                        self._note_label(rotated, v)
        self.latency.merge(delta.get("latency", []))
        self.rows.merge(delta.get("rows", []))
        self.bytes.merge(delta.get("bytes", []))

    # -- registry source contract (engine.stats()["latency"]) ----------------
    def summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-SPAN-NAME latency summary, merged across run-label series:
        ``{span: {count, mean_ms, p50_ms, p95_ms, p99_ms, max_ms}}``."""
        merged: Dict[str, Histogram] = {}
        for labels, h in self.latency.series():
            if h.count == 0:
                continue
            span = labels.get("span", "?")
            agg = merged.get(span)
            if agg is None:
                agg = merged[span] = Histogram(self.latency.bounds)
            agg.merge(h.encode())
        out: Dict[str, Dict[str, Any]] = {}
        for span, h in merged.items():
            p = h.percentiles()
            out[span] = {
                "count": h.count,
                "mean_ms": round(h.sum / h.count * 1e3, 6) if h.count else None,
                "p50_ms": round(p["p50"] * 1e3, 6) if p["p50"] is not None else None,
                "p95_ms": round(p["p95"] * 1e3, 6) if p["p95"] is not None else None,
                "p99_ms": round(p["p99"] * 1e3, 6) if p["p99"] is not None else None,
                "max_ms": round(h.max * 1e3, 6) if h.max is not None else None,
            }
        return out

    def as_dict(self) -> Dict[str, Any]:
        return self.summary()

    def reset(self) -> None:
        for f in self.families():
            f.reset()

    def clear(self) -> None:
        for f in self.families():
            f.clear()
        with self._runs_lock:
            for lru in self._label_lru.values():
                lru.clear()


_SPAN_METRICS = SpanMetrics()


def get_span_metrics() -> SpanMetrics:
    return _SPAN_METRICS
