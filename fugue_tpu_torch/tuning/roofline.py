"""Per-verb roofline recording, copied from ``fugue_tpu/tuning/roofline.py``
— RECORD ONLY.

While tracing is enabled, every traced engine verb's close folds one
observation — achieved bytes/s and rows/s — into an in-memory table
keyed ``<verb>|<dtype-class>|w<width-bucket>``, and the folds are
published into the :class:`~fugue_tpu_torch.tuning.store.TunedStore` under its
``"rooflines"`` top-level key at run-scope flush (same atomic
temp-write+rename publish, same LRU entry bound as the ``"tuning"``
key). No placement decision reads these yet; ``engine.report()`` renders
them so the measured per-verb ceilings are visible before anything acts
on them.

Cost contract (``fugue.tpu.tuning.rooflines``, default ON): one
in-memory dict fold per traced verb close while tracing is enabled;
nothing at all while tracing is off (the hook lives behind the tracer's
enabled check). The result-frame probe reads only already-materialized
metadata — it must NEVER force a device fetch or an ingest (a lazy
frame with unknown row count simply isn't folded).
"""

import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = [
    "RooflineRecorder",
    "rooflines_enabled",
    "frame_profile",
    "install_verb_observer",
]

# a close faster than this carries no usable throughput signal (the
# MIN_WALL_S discipline from tuner.py, scaled to single-verb granularity)
MIN_VERB_WALL_S = 1e-4


def rooflines_enabled(conf: Any) -> bool:
    from ..constants import FUGUE_TPU_CONF_TUNING_ROOFLINES

    if conf is None:
        return True
    try:
        return bool(conf.get(FUGUE_TPU_CONF_TUNING_ROOFLINES, True))
    except Exception:
        return True


def _dtype_class(pa_type: Any) -> str:
    import pyarrow.types as pt

    if pt.is_floating(pa_type):
        return "float"
    if pt.is_integer(pa_type):
        return "int"
    if pt.is_boolean(pa_type):
        return "bool"
    if pt.is_temporal(pa_type):
        return "temporal"
    return "object"


def _width_bucket(width: int) -> int:
    """Power-of-two ceiling: w1/w2/w4/w8... — bounded key cardinality."""
    return 1 << max(0, width - 1).bit_length() if width > 1 else 1


def frame_profile(out: Any) -> Optional[Tuple[int, int, str, int]]:
    """Cheap ``(rows, bytes, dtype_class, width_bucket)`` of a verb's
    result frame, or None when it can't be read without forcing work.

    - rows: a device frame's cached ``_row_count`` (NEVER the masked
      ``count()`` — that forces a device read), or ``count()`` on a
      local bounded frame (metadata there);
    - bytes: summed device-column ``nbytes`` of a ``TorchDataFrame``, the
      arrow table's ``nbytes`` when the native object exposes one, else
      the 64-bit-cell estimate ``rows*width*8``;
    - dtype class: ``float``/``int``/``bool``/``temporal`` when every
      column agrees, ``mixed`` otherwise.
    """
    try:
        schema = getattr(out, "schema", None)
        pa_schema = getattr(schema, "pa_schema", None)
        if pa_schema is None:
            return None
        fields = list(pa_schema)
        width = len(fields)
        if width == 0:
            return None
        classes = {_dtype_class(f.type) for f in fields}
        cls = classes.pop() if len(classes) == 1 else "mixed"

        rows: Optional[int] = None
        rc = getattr(out, "_row_count", None)
        if isinstance(rc, int):
            rows = rc if rc >= 0 else None
        elif getattr(out, "is_local", False) and getattr(out, "is_bounded", False):
            rows = int(out.count())
        if rows is None or rows < 0:
            return None

        nbytes = 0
        dc = getattr(out, "device_cols", None)
        if isinstance(dc, dict) and dc:
            nbytes = sum(int(getattr(a, "nbytes", 0) or 0) for a in dc.values())
        if nbytes <= 0:
            nb = getattr(getattr(out, "native", None), "nbytes", None)
            nbytes = int(nb) if isinstance(nb, int) and nb > 0 else rows * width * 8
        return rows, nbytes, cls, _width_bucket(width)
    except Exception:
        return None


def _fold(entry: Dict[str, Any], obs: Dict[str, Any]) -> Dict[str, Any]:
    """Merge one observation batch into a roofline entry. Associative and
    commutative over batches (sums add, bests max, lasts last-write-win)
    — the same discipline as the span-histogram mergeable encoding, so a
    delta published by a flush composes with what another process already
    wrote under the same key."""
    out = dict(entry)
    out["obs"] = int(out.get("obs", 0) or 0) + int(obs.get("obs", 1))
    for k in ("rows", "bytes", "wall_s"):
        out[k] = (out.get(k, 0) or 0) + obs.get(k, 0)
    for k in ("best_bytes_s", "best_rows_s"):
        out[k] = max(float(out.get(k, 0.0) or 0.0), float(obs.get(k, 0.0)))
    for k in ("last_bytes_s", "last_rows_s"):
        if obs.get(k) is not None:
            out[k] = obs[k]
    return out


class RooflineRecorder:
    """In-memory fold table + flush-to-store for one engine's tuner.

    ``record`` is the traced-verb close hook: probe the result frame,
    fold under the lock, done — no I/O. ``flush`` drains the pending
    folds into the store's ``"rooflines"`` key as a DELTA (the store
    merge sums/maxes against what's already persisted, so concurrent
    processes sharing one store file compose instead of clobbering)."""

    def __init__(self, store: Any, stats: Any = None):
        self._store = store
        self._stats = stats
        self._lock = threading.Lock()
        self._pending: Dict[str, Dict[str, Any]] = {}

    def record(self, verb: str, wall_s: float, result: Any) -> None:
        if wall_s < MIN_VERB_WALL_S:
            return
        prof = frame_profile(result)
        if prof is None:
            return
        rows, nbytes, cls, wbucket = prof
        if rows <= 0 and nbytes <= 0:
            return
        self.observe(verb, cls, wbucket, wall_s, rows, nbytes)

    def observe(
        self, verb: str, dtype_class: str, width: int, wall_s: float,
        rows: int, nbytes: int,
    ) -> None:
        """Fold one explicit observation (the testable core of
        :meth:`record`; ``width`` is the already-bucketed column count)."""
        if wall_s <= 0:
            return
        key = f"{verb}|{dtype_class}|w{width}"
        obs = {
            "obs": 1,
            "rows": int(rows),
            "bytes": int(nbytes),
            "wall_s": float(wall_s),
            "best_bytes_s": nbytes / wall_s,
            "best_rows_s": rows / wall_s,
            "last_bytes_s": nbytes / wall_s,
            "last_rows_s": rows / wall_s,
        }
        with self._lock:
            self._pending[key] = _fold(self._pending.get(key, {}), obs)
        if self._stats is not None:
            self._stats.inc("roofline_folds")

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def flush(self) -> bool:
        """Publish the pending folds into the store's ``rooflines`` key
        (atomic read-merge-write; LRU-bounded there). True when a publish
        happened. Never raises — recording must not fail a run."""
        with self._lock:
            pend, self._pending = self._pending, {}
        if not pend:
            return False
        try:

            def mutate(entries: Dict[str, Any]) -> Dict[str, Any]:
                now = time.time()
                for key, obs in pend.items():
                    cur = entries.get(key)
                    merged = _fold(cur if isinstance(cur, dict) else {}, obs)
                    merged["ts"] = now
                    entries[key] = merged
                return entries

            return bool(self._store.publish_rooflines(mutate))
        except Exception:
            # put the folds back so the next flush retries them
            with self._lock:
                for key, obs in pend.items():
                    self._pending[key] = _fold(self._pending.get(key, {}), obs)
            return False

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Persisted entries overlaid with the not-yet-flushed folds —
        what ``engine.report()`` renders."""
        try:
            out = {k: dict(v) for k, v in self._store.rooflines().items()}
        except Exception:
            out = {}
        with self._lock:
            for key, obs in self._pending.items():
                out[key] = _fold(out.get(key, {}), obs)
        return out


def install_verb_observer(engine: Any) -> None:
    """Install the process-wide traced-verb close hook bound (by weakref)
    to ``engine``'s tuner. Called at torch-engine construction when
    ``fugue.tpu.tuning.rooflines`` is enabled; a newer engine's install
    replaces an older one's (the resource-probe registration rule). The
    hook only ever runs while tracing is enabled — ``traced_verb``'s
    disabled path stays a single attribute check."""
    from ..obs.tracer import set_verb_observer

    if not rooflines_enabled(getattr(engine, "conf", None)):
        return
    ref = weakref.ref(engine)

    def _observe(verb: str, wall_s: float, result: Any) -> None:
        e = ref()
        if e is None:
            set_verb_observer(None)  # engine collected: self-uninstall
            return
        e.tuner.roofline.record(verb, wall_s, result)

    set_verb_observer(_observe)
