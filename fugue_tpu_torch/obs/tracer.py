"""Hierarchical span tracer — the measurement substrate. The port's copy
of ``fugue_tpu/obs/tracer.py``: one change, the profiler range a span
mirrors into (``torch.profiler.record_function`` for JAX's
``TraceAnnotation``).

One process-wide :class:`Tracer` records nested spans from the workflow
layer down to individual streaming chunks:

    workflow.run → workflow.task → engine.<verb> → stream.chunk
                                 → map.parallel → map.worker_chunk → map.partition

Design constraints, in priority order:

- **Near-zero overhead when disabled.** ``tracer.span(...)`` returns one
  shared null context object when tracing is off: the cost is an attribute
  check and a no-op ``with`` — no allocation, no clock read, no lock. The
  hot paths (per-chunk, per-partition) stay instrumented permanently.
- **Nanosecond wall clock** (``time.perf_counter_ns``), comparable across
  threads AND forked children (CLOCK_MONOTONIC is process-shared on
  Linux), so worker spans shipped home line up with driver spans on one
  timeline.
- **Profiler timeline alignment**: spans created with ``annotate=True``
  also enter a ``torch.profiler.record_function`` range of the same name,
  so when a ``torch.profiler`` capture is active the host-side span names
  enclose the kernels they launch. Only where torch is already imported:
  a process without it (a dist worker) runs no capture, and importing
  torch for a range would cost it seconds. A span measures host wall time: CUDA
  runs asynchronously and a span's close does not wait on the card, so
  a verb's span covers its device work only where the verb itself waits
  (a count, a copy to the host).
- **Fork-boundary transport**: completed spans are plain dicts of
  primitives. A forked pool worker records into its (copy-on-write)
  buffer, slices off what it produced (:meth:`Tracer.mark` /
  :meth:`Tracer.take_since`) and ships the records back with its chunk
  result; the driver :meth:`Tracer.ingest`\\ s them. Span ids are
  ``"<host>-<pid>:<seq>"`` strings so ids never collide across the fork
  nor across hosts sharing a store (:func:`proc_ident`).
- **Cluster trace context**: :func:`trace_scope` binds a
  Dapper-style ``{"trace", "parent"}`` context; :func:`trace_carrier`
  is the wire form every cross-process hop ships, so remote spans attach
  under the submitting run instead of floating as local roots.

Enablement: conf ``fugue.tpu.trace.enabled`` (checked at engine
construction via :func:`configure_from_conf`) or the ``FUGUE_TPU_TRACE``
env var (which overrides the conf either way). ``fugue.tpu.trace.xla``
(default true) gates the profiler-range mirroring.
"""

import contextlib
import os
import socket
import sys
import threading
import time
import uuid
from contextvars import ContextVar
from typing import Any, Callable, Dict, Iterator, List, Optional

from .metrics import get_span_metrics

__all__ = [
    "Tracer",
    "get_tracer",
    "configure_from_conf",
    "traced_verb",
    "set_verb_observer",
    "NULL_SPAN",
    "proc_ident",
    "mint_trace_id",
    "trace_scope",
    "current_trace_id",
    "trace_carrier",
]

ENV_TRACE = "FUGUE_TPU_TRACE"

_DEFAULT_MAX_SPANS = 200_000

# short hostname, resolved once per process image (fork children inherit it,
# which is correct — they share the host)
_HOST = socket.gethostname().split(".")[0] or "localhost"


def proc_ident() -> str:
    """Cluster-unique process identity: ``"<host>-<pid>"``. Span ids and
    spool filenames are prefixed with this so nothing collides when two
    hosts hand out the same pid."""
    return f"{_HOST}-{os.getpid()}"


# -- cluster trace context --------------------------------------------------
#
# A Dapper-style trace context rides a ContextVar (same shape as the
# run-label machinery in metrics.py): ``{"trace": <id>, "parent": <span id>}``.
# ``workflow.run`` / ``serve.submit`` mint a trace id; every outbound hop
# (HTTP request, board task spec, fleet claim) ships ``trace_carrier()``;
# the receiving process re-enters the context with ``trace_scope(...)`` so
# its spans (a) carry the trace id and (b) root under the carried parent
# span instead of floating as process-local roots.

_TRACE_CTX: ContextVar[Dict[str, str]] = ContextVar("fugue_tpu_trace_ctx", default={})


def mint_trace_id() -> str:
    """A cluster-unique trace id for one ``workflow.run``/``serve.submit``."""
    return uuid.uuid4().hex[:16]


def current_trace_id() -> Optional[str]:
    return _TRACE_CTX.get().get("trace")


@contextlib.contextmanager
def trace_scope(
    trace: Optional[str] = None, parent: Optional[str] = None
) -> Iterator[str]:
    """Bind a trace context for the duration (minting an id when ``trace``
    is None). Spans opened inside carry the trace id, and a span opened
    with no local parent attaches under ``parent`` — the remote submitting
    span. Nesting re-binds; the outer context is restored on exit."""
    ctx: Dict[str, str] = {"trace": trace or mint_trace_id()}
    if parent:
        ctx["parent"] = parent
    token = _TRACE_CTX.set(ctx)
    try:
        yield ctx["trace"]
    finally:
        _TRACE_CTX.reset(token)


def trace_carrier() -> Dict[str, str]:
    """The wire fields for one outbound hop: the bound trace id plus the
    innermost open span id as the causal parent. Empty when no trace
    context is bound (propagation stays opt-in and zero-cost)."""
    ctx = _TRACE_CTX.get()
    if not ctx:
        return {}
    out = {"trace": ctx["trace"]}
    sid = _TRACER.current_span_id() or ctx.get("parent")
    if sid:
        out["parent"] = sid
    return out


class _NullSpan:
    """Shared do-nothing span/context — the entire disabled-path cost."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


NULL_SPAN = _NullSpan()


class _SpanCtx:
    """A live span: context manager + attribute sink (``sp.set(rows=...)``)."""

    __slots__ = ("_tr", "_name", "_cat", "_annotate", "_parent", "_args", "_sid", "_ann", "_t0")

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        cat: str,
        annotate: bool,
        parent: Optional[str],
        args: Dict[str, Any],
    ):
        self._tr = tracer
        self._name = name
        self._cat = cat
        self._annotate = annotate
        self._parent = parent
        self._args = args
        self._ann: Any = None

    def __enter__(self) -> "_SpanCtx":
        tr = self._tr
        stack = tr._stack()
        if self._parent is None and stack:
            self._parent = stack[-1]
        elif self._parent is None:
            # no local ancestor: attach under the carried remote parent (the
            # submitting run's span) when a trace context is bound
            self._parent = _TRACE_CTX.get().get("parent")
        self._sid = tr._new_id()
        stack.append(self._sid)
        if self._annotate and tr.xla_annotate:
            cls = tr._annotation_cls()
            if cls is not None:
                try:
                    self._ann = cls(self._name)
                    self._ann.__enter__()
                except Exception:
                    self._ann = None
        self._t0 = time.perf_counter_ns()
        return self

    def set(self, **attrs: Any) -> None:
        self._args.update(attrs)

    def __exit__(self, et: Any, ev: Any, tb: Any) -> bool:
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            try:
                self._ann.__exit__(et, ev, tb)
            except Exception:
                pass
        tr = self._tr
        stack = tr._stack()
        if stack and stack[-1] == self._sid:
            stack.pop()
        elif self._sid in stack:  # defensive: mis-nested exit
            stack.remove(self._sid)
        if et is not None:
            self._args.setdefault("error", getattr(et, "__name__", str(et)))
        rec = {
            "name": self._name,
            "cat": self._cat,
            "ts": self._t0,
            "dur": t1 - self._t0,
            "pid": os.getpid(),
            "proc": proc_ident(),
            "tid": tr._tid(),
            "id": self._sid,
            "parent": self._parent,
            "args": self._args,
        }
        trace = _TRACE_CTX.get().get("trace")
        if trace:
            rec["trace"] = trace
        tr._emit(rec)
        return False


class Tracer:
    """Process-wide span recorder. Use the :func:`get_tracer` singleton."""

    def __init__(self, max_spans: int = _DEFAULT_MAX_SPANS):
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []
        self._tls = threading.local()
        self._seq = 0
        self._tids: Dict[int, int] = {}
        self._ann_cls: Any = False  # False = unresolved (torch not imported yet)
        self.enabled = False
        self.xla_annotate = True
        self.max_spans = max_spans
        self.dropped = 0

    # -- recording ----------------------------------------------------------
    def span(
        self,
        name: str,
        cat: str = "host",
        annotate: bool = False,
        parent: Optional[str] = None,
        **args: Any,
    ) -> Any:
        """Open a span context. When tracing is disabled this returns one
        shared null object — the instrumented call sites pay ~an attribute
        check, nothing else."""
        if not self.enabled:
            return NULL_SPAN
        return _SpanCtx(self, name, cat, annotate, parent, args)

    def _emit(self, rec: Dict[str, Any]) -> None:
        # every span close feeds the latency/rows/bytes histograms — BEFORE
        # the buffer-cap check: distributions must stay correct even when
        # the span buffer saturates and drops the raw record
        get_span_metrics().observe_record(rec)
        with self._lock:
            if len(self._records) >= self.max_spans:
                self.dropped += 1
                return
            self._records.append(rec)

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def _new_id(self) -> str:
        # host+pid-prefixed: unique across forks AND across hosts sharing a
        # store (two hosts can hand out the same pid)
        with self._lock:
            self._seq += 1
            return f"{proc_ident()}:{self._seq}"

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            n = self._tids.get(ident)
            if n is None:
                n = len(self._tids) + 1
                self._tids[ident] = n
            return n

    def _annotation_cls(self) -> Any:
        if self._ann_cls is False:
            # torch already imported or no mirror: importing it here would
            # cost a host process (a dist worker) seconds on its first span
            cls = getattr(getattr(sys.modules.get("torch"), "profiler", None), "record_function", None)
            if cls is None:
                return None
            # racing first-touchers resolve the IDENTICAL class; the lock
            # just makes the publish a clean single write
            with self._lock:
                self._ann_cls = cls
        return self._ann_cls

    def current_span_id(self) -> Optional[str]:
        """Id of the innermost open span on THIS thread (for explicit
        parenting across thread/process boundaries)."""
        st = self._stack()
        return st[-1] if st else None

    # -- buffer access ------------------------------------------------------
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0

    def mark(self) -> int:
        """Current buffer length — pair with :meth:`take_since` to slice off
        the spans produced after this point (the fork-boundary protocol)."""
        with self._lock:
            return len(self._records)

    def take_since(self, mark: int) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records[mark:])

    def ingest(self, records: List[Dict[str, Any]]) -> None:
        """Append records produced elsewhere (forked worker, remote).

        Deliberately does NOT feed the span histograms: the recording
        process already fed its own at ``_emit`` time, and the fork
        protocol ships those observations home as an explicit mergeable
        histogram delta (``SpanMetrics.delta_since``) alongside the
        spans — feeding here too would double-count."""
        if not records:
            return
        with self._lock:
            room = self.max_spans - len(self._records)
            if room <= 0:
                self.dropped += len(records)
                return
            self._records.extend(records[:room])
            self.dropped += max(0, len(records) - room)

    # -- analysis -----------------------------------------------------------
    def span_tree(self) -> List[Dict[str, Any]]:
        """Reconstruct the span forest from parent links: a list of root
        nodes ``{"name", "cat", "ts", "dur", "args", "children": [...]}``
        ordered by start time."""
        recs = self.records()
        nodes = {
            r["id"]: dict(r, children=[]) for r in recs
        }
        roots: List[Dict[str, Any]] = []
        for r in recs:
            node = nodes[r["id"]]
            parent = nodes.get(r["parent"]) if r["parent"] else None
            if parent is not None:
                parent["children"].append(node)
            else:
                roots.append(node)
        for n in nodes.values():
            n["children"].sort(key=lambda c: c["ts"])
        roots.sort(key=lambda c: c["ts"])
        return roots

    # -- switches -----------------------------------------------------------
    def enable(self) -> None:
        with self._lock:
            self.enabled = True

    def disable(self) -> None:
        with self._lock:
            self.enabled = False


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def _truthy(v: Any) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def configure_from_conf(conf: Any) -> None:
    """Apply trace switches from an engine conf. Called at engine
    construction. The ``FUGUE_TPU_TRACE`` env var overrides the conf in
    both directions; an absent conf key + absent env leaves the current
    state untouched (another engine may have enabled tracing already)."""
    from ..constants import (
        FUGUE_TPU_CONF_TRACE_ENABLED,
        FUGUE_TPU_CONF_TRACE_MAX_SPANS,
        FUGUE_TPU_CONF_TRACE_XLA,
    )

    tr = _TRACER
    try:
        raw = conf.get_or_none(FUGUE_TPU_CONF_TRACE_ENABLED, object)
        xla = conf.get_or_none(FUGUE_TPU_CONF_TRACE_XLA, object)
        cap = conf.get_or_none(FUGUE_TPU_CONF_TRACE_MAX_SPANS, object)
    except Exception:
        raw = xla = cap = None
    env = os.environ.get(ENV_TRACE)
    if env is not None and env != "":
        tr.enabled = _truthy(env)
    elif raw is not None:
        tr.enabled = _truthy(raw)
    if xla is not None:
        tr.xla_annotate = _truthy(xla)
    if cap is not None:
        tr.max_spans = int(cap)


# process-wide traced-verb close hook (roofline recording):
# called as (verb_name, wall_seconds, result) after a SUCCESSFUL traced
# verb while tracing is enabled. None = no observer = zero extra work.
_VERB_OBSERVER: Optional[Callable[[str, float, Any], None]] = None


def set_verb_observer(fn: Optional[Callable[[str, float, Any], None]]) -> None:
    """Install (or clear, with None) the traced-verb close observer. One
    slot per process — a newer install replaces the previous one."""
    global _VERB_OBSERVER
    _VERB_OBSERVER = fn


def traced_verb(name: str, cat: str = "engine", annotate: bool = True) -> Callable:
    """Decorator instrumenting an engine verb as one span. The disabled
    path is a single attribute check before delegating. While tracing is
    on, a successful close additionally feeds the registered verb
    observer (roofline recording) with the verb's wall time and result —
    failures are never folded into throughput ceilings."""
    import functools

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*a: Any, **k: Any) -> Any:
            tr = _TRACER
            if not tr.enabled:
                return fn(*a, **k)
            obs = _VERB_OBSERVER
            if obs is None:
                with tr.span(name, cat=cat, annotate=annotate):
                    return fn(*a, **k)
            t0 = time.perf_counter()
            with tr.span(name, cat=cat, annotate=annotate):
                out = fn(*a, **k)
            try:
                obs(name, time.perf_counter() - t0, out)
            except Exception:  # recording must never fail the verb
                pass
            return out

        return wrapper

    return deco
