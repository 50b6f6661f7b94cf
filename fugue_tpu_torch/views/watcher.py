"""Source watchers: how a standing view notices that its input grew.

The watcher interface is deliberately tiny — :meth:`SourceWatcher.observe`
returns the source's current partition-token list (the same
``{path, size, mtime_ns}`` tokens the delta manifests are keyed by)
plus the observation wall-clock, and :func:`classify_tokens` turns two
observations into one of three verdicts:

- ``unchanged`` — token lists identical; nothing to do.
- ``append`` — the previous list is a prefix of the current one (new
  partition files after it, or — for appendable csv/json — the last
  file grew in place). Exactly what the delta path serves incrementally.
- ``rewrite`` — anything else: a historical partition mutated, shrank,
  or vanished. The refusal ladder's steady-state rule applies: the view
  degrades to a FULL recompute for that generation — never to silent
  staleness — and the refusal is counted and reasoned in stats.

:class:`FileSourceWatcher` is the file/directory implementation riding
:func:`~fugue_tpu_torch.cache.delta.list_source_partitions` — the exact
discovery the delta loader itself uses, so watcher and cache agree on
what a "partition" is. When that discovery REFUSES the layout
(hive/nested dirs, avro, schema sidecars), the watcher falls back to a
coarse recursive walk: change detection keeps working, every change just
classifies as ``rewrite`` (mode ``full``), with the refusal reason
carried on the observation. A different arrival surface (a log stream,
an object-store notification feed) slots in by subclassing
:class:`SourceWatcher`; the maintainer only ever talks to the interface.
"""

import glob as _glob
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from ..cache.delta import (
    _APPENDABLE_FORMATS,
    _DeltaRefused,
    _token,
    _tokens_equal,
    list_source_partitions,
)

__all__ = [
    "Observation",
    "SourceWatcher",
    "FileSourceWatcher",
    "WatchError",
    "classify_tokens",
    "make_watcher",
]


class WatchError(Exception):
    """The source could not be observed at all (missing, unreadable)."""


class Observation:
    """One look at a watched source: partition tokens in load order,
    resolved format, wall-clock of the look (what ``as_of`` means), and
    the delta-refusal reason when the layout is not delta-eligible."""

    __slots__ = ("tokens", "fmt", "ts", "refusal")

    def __init__(
        self,
        tokens: List[Dict[str, Any]],
        fmt: str,
        ts: float,
        refusal: Optional[str] = None,
    ):
        self.tokens = tokens
        self.fmt = fmt
        self.ts = ts
        self.refusal = refusal


def classify_tokens(
    prev: List[Dict[str, Any]],
    cur: List[Dict[str, Any]],
    fmt: str,
) -> Tuple[str, int]:
    """(verdict, fresh_partitions) between two token lists — mirrors the
    delta manifest matcher's append rules so the watcher's ``mode``
    prediction and the cache's actual behavior agree."""
    n = len(prev)
    if len(cur) < n:
        return "rewrite", len(cur)
    head = max(0, n - 1)
    for a, b in zip(prev[:head], cur[:head]):
        if not _tokens_equal(a, b):
            return "rewrite", len(cur)
    if n > 0:
        a, b = prev[n - 1], cur[n - 1]
        if not _tokens_equal(a, b):
            grown_in_place = (
                a.get("path") == b.get("path")
                and int(b.get("size", 0)) > int(a.get("size", 0))
                and fmt in _APPENDABLE_FORMATS
            )
            if not grown_in_place:
                return "rewrite", len(cur)
            return "append", len(cur) - n + 1
    fresh = len(cur) - n
    return ("append", fresh) if fresh > 0 else ("unchanged", 0)


class SourceWatcher:
    """Pluggable watcher interface. Implementations observe one source;
    the maintainer owns the polling cadence and the verdicts."""

    def observe(self) -> Observation:
        raise NotImplementedError

    def classify(
        self, prev_tokens: List[Dict[str, Any]], obs: Observation
    ) -> Tuple[str, int]:
        if obs.refusal is not None and prev_tokens != obs.tokens:
            # a non-delta-eligible layout that changed: always a full
            # recompute, whatever shape the change took
            return "rewrite", len(obs.tokens)
        return classify_tokens(prev_tokens, obs.tokens, obs.fmt)


class FileSourceWatcher(SourceWatcher):
    """Watches a file/directory/glob source through the delta loader's
    own partition discovery."""

    def __init__(self, source: str, fmt: str = ""):
        self.source = source
        self.fmt = fmt

    def observe(self) -> Observation:
        ts = time.time()
        try:
            tokens, fmt, _single = list_source_partitions(self.source, self.fmt)
            return Observation(tokens, fmt, ts)
        except _DeltaRefused as ex:
            return Observation(
                self._coarse_tokens(), self.fmt or "", ts, refusal=ex.reason
            )

    def _coarse_tokens(self) -> List[Dict[str, Any]]:
        """Fallback discovery for delta-refused layouts: every regular
        file under the source, in a deterministic order. Good enough to
        DETECT change; never used to load incrementally."""
        src = self.source
        if os.path.isfile(src):
            return [_token(src)]
        if os.path.isdir(src):
            out: List[Dict[str, Any]] = []
            for root, dirs, names in os.walk(src):
                dirs.sort()
                for n in sorted(names):
                    full = os.path.join(root, n)
                    if os.path.isfile(full):
                        out.append(_token(full))
            return out
        matched = sorted(f for f in _glob.glob(src) if os.path.isfile(f))
        if matched:
            return [_token(f) for f in matched]
        raise WatchError(f"watched source {src} does not exist")


def make_watcher(source: str, fmt: str = "") -> SourceWatcher:
    """Watcher factory — the one place a future non-file source type
    (e.g. a log stream) gets dispatched from."""
    return FileSourceWatcher(source, fmt)
