"""Heartbeat-file liveness: cross-host proof of life for workers/replicas.

The claim protocol proved a dead owner with a same-host pid probe
(``os.kill(pid, 0)``) — explicitly useless across hosts. The worker tier
replaces it with a *heartbeat file*: every worker (and every
:class:`~fugue_tpu_torch.serve.EngineServer` replica with
``fugue.tpu.dist.heartbeat.dir`` set) rewrites
``<dir>/<id>.hb.json`` every ``interval_s`` through the same
temp-write + atomic-rename publish as every other store artifact, so a
reader sees either the previous complete beat or the next one — never a
torn file. Liveness is then a pure data question any host can answer:

- beat younger than ``stale_after_s``  → provably ALIVE;
- beat older than ``stale_after_s``    → provably DEAD (the writer loop
  runs at several beats per stale window — missing all of them means the
  process, its host, or its disk is gone);
- no beat file at all                  → UNKNOWN (the owner predates the
  heartbeat dir, or never joined it) — callers fall back to the pid
  probe / lease expiry they used before.

Wall-clock ``time.time()`` is deliberately the beat timestamp: it is the
only clock shared across hosts, and the stale windows (seconds) dwarf
realistic NTP skew. The reader additionally takes ``max(ts, mtime)`` so
a writer with a skewed-backwards clock is still judged by when the file
actually landed.

The ``dist.heartbeat`` fault site fires before each write: an ``error``
rule SKIPS that beat (a simulated network partition — enough skipped
beats and the worker reads as dead to stealers), ``delay`` widens the
gap the same way.
"""

import json
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..resilience import SITE_DIST_HEARTBEAT, FaultInjector, NULL_INJECTOR

__all__ = [
    "HeartbeatWriter",
    "read_heartbeat",
    "heartbeat_age_s",
    "holder_alive",
    "DEFAULT_INTERVAL_S",
    "DEFAULT_STALE_AFTER_S",
]

DEFAULT_INTERVAL_S = 0.5
DEFAULT_STALE_AFTER_S = 3.0


def _hb_path(hb_dir: str, name: str) -> str:
    return os.path.join(hb_dir, f"{name}.hb.json")


def read_heartbeat(hb_dir: str, name: str) -> Optional[Dict[str, Any]]:
    """The latest complete beat payload for ``name``, or None. A torn or
    unreadable file reads as absent (UNKNOWN, never a crash)."""
    path = _hb_path(hb_dir, name)
    try:
        with open(path) as f:
            payload = json.load(f)
        st = os.stat(path)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict):
        return None
    # a writer with a backwards-skewed clock is judged by when the file
    # actually landed on the shared filesystem
    payload["_observed_ts"] = max(float(payload.get("ts", 0.0)), st.st_mtime)
    return payload


def heartbeat_age_s(payload: Dict[str, Any], now: Optional[float] = None) -> float:
    if now is None:
        now = time.time()
    return max(0.0, now - float(payload.get("_observed_ts", payload.get("ts", 0.0))))


def holder_alive(
    owner: str,
    hb_dir: Optional[str],
    stale_after_s: float = DEFAULT_STALE_AFTER_S,
    now: Optional[float] = None,
) -> Optional[bool]:
    """Tri-state cross-host liveness of ``owner``:

    - ``True``  — fresh beat: provably alive;
    - ``False`` — stale beat: provably dead;
    - ``None``  — no heartbeat dir configured or no beat file: unknown,
      the caller falls back to its pre-heartbeat probe (same-host pid).
    """
    if not hb_dir or not owner:
        return None
    payload = read_heartbeat(hb_dir, owner)
    if payload is None:
        return None
    return heartbeat_age_s(payload, now=now) <= float(stale_after_s)


class HeartbeatWriter:
    """A daemon thread keeping ``<dir>/<name>.hb.json`` fresh.

    ``extra`` (a zero-arg callable returning a json-able dict) is merged
    into every beat — workers ship their address and live counters home
    this way, so the supervisor reads per-worker stats from the same file
    it reads liveness from. ``beat()`` writes one beat synchronously
    (start() does this too, so a started writer is immediately alive).
    """

    def __init__(
        self,
        hb_dir: str,
        name: str,
        interval_s: float = DEFAULT_INTERVAL_S,
        extra: Optional[Callable[[], Dict[str, Any]]] = None,
        injector: Optional[FaultInjector] = None,
        log: Any = None,
    ):
        self.hb_dir = hb_dir
        self.name = name
        self.interval_s = max(0.05, float(interval_s))
        self._extra = extra
        self._injector = injector or NULL_INJECTOR
        self._log = log
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._seq = 0
        self._skipped = 0
        os.makedirs(hb_dir, exist_ok=True)

    @property
    def path(self) -> str:
        return _hb_path(self.hb_dir, self.name)

    @property
    def skipped(self) -> int:
        """Beats the fault site (or a write failure) suppressed."""
        with self._lock:
            return self._skipped

    def beat(self) -> bool:
        """Write one beat now; False when the beat was skipped (injected
        partition or a write error — liveness must never crash a worker)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        payload: Dict[str, Any] = {
            "name": self.name,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "ts": time.time(),
            "interval_s": self.interval_s,
            "seq": seq,
        }
        if self._extra is not None:
            try:
                payload.update(self._extra())
            except Exception:
                pass  # stats are a passenger, never the reason a beat dies
        final = self.path
        tmp = f"{final}.__tmp_{os.getpid()}_{seq}"
        try:
            self._injector.fire(SITE_DIST_HEARTBEAT)
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, final)
            return True
        except Exception as ex:
            try:
                os.remove(tmp)
            except OSError:
                pass
            with self._lock:
                self._skipped += 1
            if self._log is not None:
                self._log.warning(
                    "heartbeat %s beat skipped (%s: %s)",
                    self.name,
                    type(ex).__name__,
                    ex,
                )
            return False

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def start(self) -> "HeartbeatWriter":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name=f"fugue-hb-{self.name}", daemon=True
            )
        self.beat()  # alive from the first instant, not interval_s later
        self._thread.start()
        return self

    def stop(self, remove: bool = False) -> None:
        """Stop beating; ``remove=True`` also deletes the beat file (an
        ORDERLY departure reads as UNKNOWN, not as a death to steal from
        — a crash, by definition, leaves its last beat to go stale)."""
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5.0)
        if remove:
            try:
                os.remove(self.path)
            except OSError:
                pass
