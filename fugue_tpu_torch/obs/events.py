"""Cluster flight recorder.

A structured, append-only event log recording every **recovery-ladder**
event the dist/serve tiers take — lease acquire/renew/steal, heartbeat
expiry, categorized re-dispatch, orphaned-output invalidation,
speculative twins, fleet claim steals and failovers, journal replays —
as typed JSON records carrying the cluster trace id + causal parent span,
so a chaos post-mortem ("worker-2 SIGKILLed at t+3.1s → lease stolen by
worker-0 at t+4.0s → map 7 re-dispatched") reconstructs from the log
alone, without grepping N processes' stderr.

Transport mirrors the span spool: each process appends JSON lines to its
own file in a shared directory —

    <events_dir>/<host>-<pid>.events.jsonl

One line per event, flushed on write (an append of one line is atomic for
these sizes on POSIX; a torn final line from a SIGKILLed writer is
skipped by :func:`read_events`). Timestamps are ``time.time()`` epoch
seconds — coarse but comparable across hosts, which a post-mortem needs
more than nanosecond precision.

Default **off** (conf ``fugue.tpu.events.enabled`` +
``fugue.tpu.events.dir``; env ``FUGUE_TPU_EVENTS`` / ``FUGUE_TPU_EVENTS_DIR``
override, the tracer's enablement contract). Disabled cost is one
attribute check per call site.
"""

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .tracer import current_trace_id, get_tracer, proc_ident

__all__ = [
    "EVENT_TYPES",
    "EventLog",
    "get_event_log",
    "configure_events_from_conf",
    "read_events",
    "render_timeline",
]

ENV_EVENTS = "FUGUE_TPU_EVENTS"
ENV_EVENTS_DIR = "FUGUE_TPU_EVENTS_DIR"

EVENTS_SUFFIX = ".events.jsonl"

# the recovery-ladder vocabulary — every emitter uses one of these, so the
# timeline renderer and the completeness gate enumerate a closed set
EVENT_TYPES = frozenset(
    {
        "lease.acquire",  # clean lease grant
        "lease.renew",  # keeper heartbeat on a held lease
        "lease.steal",  # takeover of a dead/expired holder's lease
        "hb.expired",  # holder's heartbeat proven stale (precedes a steal)
        "task.redispatch",  # stolen task re-executed by the new holder
        "task.orphan",  # done record invalidated (missing/torn artifact)
        "task.speculative",  # straggler marked for a speculative twin
        "task.failed",  # categorized task failure recorded on the board
        "fleet.claim_steal",  # serve-fleet claim lease taken from a dead replica
        "fleet.failover",  # FleetClient re-placed a submission elsewhere
        "serve.journal_replay",  # replica resubmitted journaled work on restart
        "chaos.inject",  # fault injected by a smoke/chaos harness
        "view.register",  # standing view registered (continuous pipelines)
        "view.unregister",  # standing view retired; lease released
        "view.lease.acquire",  # replica became a view's maintainer
        "view.lease.steal",  # maintenance moved off a dead/expired replica
        "view.refresh",  # maintainer pushed fresh partitions through the queue
        "view.publish",  # a new view generation reached the fleet store
        "view.slo_breach",  # view staleness exceeded its tenant freshness SLO
    }
)


class EventLog:
    """Per-process appender. Use the :func:`get_event_log` singleton."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._fh: Any = None
        self.enabled = False
        self.emitted = 0
        self.errors = 0

    def configure(self, events_dir: Optional[str], enabled: bool) -> None:
        with self._lock:
            if events_dir is not None and events_dir != self._dir:
                if self._fh is not None:
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                self._fh = None
                self._dir = events_dir
            self.enabled = bool(enabled) and self._dir is not None

    def path(self) -> Optional[str]:
        with self._lock:
            if self._dir is None:
                return None
            return os.path.join(self._dir, proc_ident() + EVENTS_SUFFIX)

    def emit(self, etype: str, **detail: Any) -> None:
        """Append one typed record. No-op when disabled. Never raises —
        a full disk must not take the recovery path down with it."""
        if not self.enabled:
            return
        rec: Dict[str, Any] = {
            "ts": time.time(),
            "type": etype,
            "proc": proc_ident(),
            "pid": os.getpid(),
        }
        trace = current_trace_id()
        if trace:
            rec["trace"] = trace
        parent = get_tracer().current_span_id()
        if parent:
            rec["parent"] = parent
        for k, v in detail.items():
            if v is not None:
                rec[k] = v
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            try:
                if self._fh is None:
                    if self._dir is None:
                        return
                    os.makedirs(self._dir, exist_ok=True)
                    # pid can change across a fork that inherited this
                    # object — reopening per identity keeps files per-process
                    self._fh = open(
                        os.path.join(self._dir, proc_ident() + EVENTS_SUFFIX), "a"
                    )
                self._fh.write(line + "\n")
                self._fh.flush()
                self.emitted += 1
            except OSError:
                self.errors += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "dir": self._dir,
                "emitted": self.emitted,
                "errors": self.errors,
            }


_EVENT_LOG = EventLog()


def get_event_log() -> EventLog:
    return _EVENT_LOG


def configure_events_from_conf(conf: Any) -> None:
    """Apply flight-recorder switches from an engine conf (engine
    construction path, next to the tracer's ``configure_from_conf``).
    Env vars override; absent key + absent env leaves state untouched."""
    from ..constants import (
        FUGUE_TPU_CONF_EVENTS_DIR,
        FUGUE_TPU_CONF_EVENTS_ENABLED,
    )
    from .tracer import _truthy

    try:
        raw = conf.get_or_none(FUGUE_TPU_CONF_EVENTS_ENABLED, object)
        d = conf.get_or_none(FUGUE_TPU_CONF_EVENTS_DIR, object)
    except Exception:
        raw = d = None
    env = os.environ.get(ENV_EVENTS)
    env_dir = os.environ.get(ENV_EVENTS_DIR)
    if env_dir:
        d = env_dir
    enabled: Optional[bool] = None
    if env is not None and env != "":
        enabled = _truthy(env)
    elif raw is not None:
        enabled = _truthy(raw)
    log = _EVENT_LOG
    if d is not None or enabled is not None:
        log.configure(
            str(d) if d is not None else None,
            log.enabled if enabled is None else enabled,
        )


def read_events(events_dir: str) -> List[Dict[str, Any]]:
    """Merge every process's event file in ``events_dir`` into one list
    sorted by timestamp. Torn trailing lines (SIGKILLed writer) and
    foreign files are skipped."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(events_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(EVENTS_SUFFIX):
            continue
        try:
            with open(os.path.join(events_dir, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and "type" in rec and "ts" in rec:
                        out.append(rec)
        except OSError:
            continue
    out.sort(key=lambda r: (r.get("ts", 0.0), r.get("proc", ""), r.get("type", "")))
    return out


_RENDER = {
    "lease.acquire": lambda r: f"lease acquired for {r.get('task')} by {r.get('owner')}",
    "lease.renew": lambda r: f"lease renewed for {r.get('task')} by {r.get('owner')}",
    "lease.steal": lambda r: (
        f"lease for {r.get('task')} stolen by {r.get('owner')} "
        f"from {r.get('prev_owner')} ({r.get('reason')})"
    ),
    "hb.expired": lambda r: (
        f"heartbeat of {r.get('holder')} proven stale "
        f"(age {r.get('age_s', '?')}s, task {r.get('task')})"
    ),
    "task.redispatch": lambda r: (
        f"task {r.get('task')} re-dispatched on {r.get('owner')} "
        f"({r.get('reason', 'stolen')})"
    ),
    "task.orphan": lambda r: (
        f"orphaned output of {r.get('task')} invalidated ({r.get('why')})"
    ),
    "task.speculative": lambda r: (
        f"speculative twin marked for straggler {r.get('task')}"
    ),
    "task.failed": lambda r: (
        f"task {r.get('task')} failed on {r.get('worker')} "
        f"({r.get('category')}: {r.get('error', '')})"
    ),
    "fleet.claim_steal": lambda r: (
        f"fleet claim {r.get('key')} stolen by {r.get('owner')} "
        f"from {r.get('prev_owner')}"
    ),
    "fleet.failover": lambda r: (
        f"submission {r.get('key')} failed over from replica "
        f"{r.get('from_replica')} to {r.get('to_replica')}"
    ),
    "serve.journal_replay": lambda r: (
        f"replica {r.get('replica')} replayed {r.get('entries')} journaled "
        f"submission(s)"
    ),
    "chaos.inject": lambda r: (
        f"{r.get('fault', 'fault')} injected into {r.get('target')}"
    ),
    "view.register": lambda r: (
        f"view {r.get('view')} registered by tenant {r.get('tenant')} "
        f"on {r.get('source')}"
    ),
    "view.unregister": lambda r: f"view {r.get('view')} unregistered",
    "view.lease.acquire": lambda r: (
        f"view {r.get('view')} watch lease acquired by {r.get('owner')}"
    ),
    "view.lease.steal": lambda r: (
        f"view {r.get('view')} watch lease stolen by {r.get('owner')} "
        f"from {r.get('prev_owner')} ({r.get('reason')})"
    ),
    "view.refresh": lambda r: (
        f"view {r.get('view')} refresh -> gen {r.get('gen')} "
        f"({r.get('mode')}: {r.get('fresh')}/{r.get('total')} partition(s) fresh)"
    ),
    "view.publish": lambda r: (
        f"view {r.get('view')} generation {r.get('gen')} published "
        f"(as_of {r.get('as_of')})"
    ),
    "view.slo_breach": lambda r: (
        f"view {r.get('view')} freshness SLO breached "
        f"(lag {r.get('lag_s')}s > {r.get('slo_s')}s)"
    ),
}


def render_timeline(
    events: List[Dict[str, Any]],
    t0: Optional[float] = None,
    trace: Optional[str] = None,
) -> str:
    """Human-readable post-mortem: one ``t+<s>`` line per event, relative
    to ``t0`` (default: the first event). ``trace`` keeps only one run's
    events (records with no trace id — e.g. chaos injections — are kept)."""
    if trace is not None:
        events = [e for e in events if e.get("trace") in (trace, None)]
    if not events:
        return "(no events recorded — is fugue.tpu.events.enabled on?)"
    if t0 is None:
        t0 = min(e.get("ts", 0.0) for e in events)
    lines = [f"== cluster timeline ({len(events)} events) =="]
    for e in events:
        fn = _RENDER.get(e["type"])
        text = fn(e) if fn else json.dumps(e, sort_keys=True)
        lines.append(f"t+{e.get('ts', t0) - t0:6.2f}s  [{e.get('proc', '?')}] {text}")
    return "\n".join(lines)
