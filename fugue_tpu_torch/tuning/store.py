"""Persistence for learned settings, copied from
``fugue_tpu/tuning/store.py``: the ``_tuned.json`` plan ledger.

The port has no tuned default of its own, so the default file is
``fugue_tpu_torch/build/_tuned.json`` (git-ignored, beside the built
kernels), not a file of the package; ``fugue.tpu.tuning.path`` and the
``FUGUE_TPU_TUNING_PATH`` environment variable name another. This module
owns the file's ``"tuning"`` and ``"rooflines"`` top-level keys and keeps
every other key on publish. Layout::

    {
      "tuning": {
        "version": 1,
        "plans": {
          "<plan_fp>": {
            "ts": <last-used epoch seconds>,
            "gen": <publish generation>,
            "streams": {"<sid>": {"chunk_rows", "prefetch_depth",
                                   "obs", "converged", "evidence"}},
            "joins":   {"<sid>": {"left_bytes", "right_bytes",
                                   "right_rows", "buckets", "obs",
                                   "converged", "evidence"}}
          }
        }
      },
      "rooflines": {                 # record-only throughput folds
        "version": 1,
        "entries": {
          "<verb>|<dtype-class>|w<width>": {
            "ts", "obs", "rows", "bytes", "wall_s",
            "best_bytes_s", "best_rows_s", "last_bytes_s", "last_rows_s"
          }
        }
      }
    }

Contracts:

- **Atomic publish**: temp-write in the same directory + ``os.replace``,
  as checkpoints publish — a reader (or a racing second process) sees
  the old complete file or the new complete file, never a torn one.
  Concurrent publishers re-read the file under their own process lock
  before merging, so a race loses at most the OTHER process's newest
  entry to last-writer-wins — never the file's integrity.
- **Corrupt/truncated/unreadable → defaults with ONE warning** per path
  per process; the store keeps working memory-only so a warm engine still
  converges within its own lifetime.
- **Stale-fingerprint eviction**: at most ``max_entries`` plan entries,
  least-recently-used (``ts``) dropped at publish time.
"""

import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Optional, Set

__all__ = ["TunedStore", "default_tuned_path", "resolve_tuned_path"]

DEFAULT_MAX_ENTRIES = 64

_log = logging.getLogger("fugue_tpu_torch.tuning")

# one warning per degraded path per process — corrupt files and unwritable
# directories must not spam every run
_WARNED: Set[str] = set()
_WARNED_LOCK = threading.Lock()


def _warn_once(path: str, kind: str, detail: str) -> None:
    key = f"{kind}:{path}"
    with _WARNED_LOCK:
        if key in _WARNED:
            return
        _WARNED.add(key)
    _log.warning(
        "tuning store %s (%s): %s -- degrading to defaults "
        "(static conf; in-memory learning only)",
        kind,
        path,
        detail,
    )


def default_tuned_path() -> str:
    """``fugue_tpu_torch/build/_tuned.json``: git-ignored, beside the
    built kernels."""
    from ..ops._build import BUILD

    return str(BUILD / "_tuned.json")


def resolve_tuned_path(conf: Any) -> str:
    """Conf > env > package default (same precedence as the cache dir)."""
    from ..constants import FUGUE_TPU_CONF_TUNING_PATH

    try:
        p = str(conf.get(FUGUE_TPU_CONF_TUNING_PATH, "") or "")
    except Exception:
        p = ""
    if p:
        return p
    return os.environ.get("FUGUE_TPU_TUNING_PATH", "") or default_tuned_path()


class TunedStore:
    """mtime-cached reader + read-merge-write publisher over one path."""

    def __init__(
        self, path: str, max_entries: int = DEFAULT_MAX_ENTRIES, stats: Any = None
    ):
        self.path = path
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._stats = stats
        # memory overlay: what THIS process learned; authoritative when the
        # file can't be read or written (degraded mode keeps converging)
        self._mem: Dict[str, Dict[str, Any]] = {}
        self._cache: Dict[str, Dict[str, Any]] = {}
        self._cache_sig: Any = ("", -1)
        # ditto for the "rooflines" top-level key (record-only per-verb
        # throughput ceilings)
        self._mem_roof: Dict[str, Dict[str, Any]] = {}

    def _inc(self, name: str, n: int = 1) -> None:
        if self._stats is not None:
            self._stats.inc(name, n)

    # -- reading -------------------------------------------------------------
    def _read_file(self) -> Dict[str, Any]:
        """The whole JSON document (all top-level keys), {} when absent or
        corrupt (corrupt warns once and counts a load_failure)."""
        try:
            with open(self.path, encoding="utf-8") as f:
                raw = f.read()
        except FileNotFoundError:
            return {}
        except OSError as ex:
            self._inc("load_failures")
            _warn_once(self.path, "unreadable", str(ex))
            return {}
        try:
            doc = json.loads(raw)
            if not isinstance(doc, dict):
                raise ValueError(f"top-level {type(doc).__name__}, expected object")
            return doc
        except Exception as ex:
            self._inc("load_failures")
            _warn_once(self.path, "corrupt", str(ex))
            return {}

    def _plans_of(self, doc: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
        tuning = doc.get("tuning")
        if not isinstance(tuning, dict):
            return {}
        plans = tuning.get("plans")
        if not isinstance(plans, dict):
            return {}
        # tolerate foreign/garbage entries: only dict-valued plans survive
        return {str(k): v for k, v in plans.items() if isinstance(v, dict)}

    def _roof_of(self, doc: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
        roof = doc.get("rooflines")
        if not isinstance(roof, dict):
            return {}
        entries = roof.get("entries")
        if not isinstance(entries, dict):
            return {}
        return {str(k): v for k, v in entries.items() if isinstance(v, dict)}

    @staticmethod
    def _merge_roof_entry(
        a: Dict[str, Any], b: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Reconcile two VIEWS of one cumulative fold entry (the file's
        and this process's memory). Each view's totals (obs/rows/bytes/
        wall_s) and best_* rates only ever grow, so element-wise max never
        double-counts — and when one view is a superset of the other (the
        common case: our publish landed, then another process folded on
        top), max recovers exactly the fresher superset. ``last_*``/``ts``
        travel as a block from whichever view folded more recently."""
        out = dict(a)
        for k, v in b.items():
            if k == "ts" or k.startswith("last_"):
                continue
            cur = out.get(k)
            if isinstance(v, (int, float)) and isinstance(cur, (int, float)):
                out[k] = max(cur, v)
            elif cur is None:
                out[k] = v
        src = b if float(b.get("ts", 0) or 0) >= float(a.get("ts", 0) or 0) else a
        for k, v in src.items():
            if k == "ts" or k.startswith("last_"):
                out[k] = v
        return out

    def _overlay_roof_locked(
        self, entries: Dict[str, Dict[str, Any]]
    ) -> Dict[str, Dict[str, Any]]:
        for k, v in self._mem_roof.items():
            cur = entries.get(k)
            entries[k] = (
                dict(v) if cur is None else self._merge_roof_entry(cur, v)
            )
        return entries

    def rooflines(self) -> Dict[str, Dict[str, Any]]:
        """All roofline entries (``<verb>|<dtype-class>|w<width>`` →
        throughput fold), the file's view reconciled with this process's
        memory (:meth:`_merge_roof_entry`)."""
        with self._lock:
            return self._overlay_roof_locked(self._roof_of(self._read_file()))

    def plans(self) -> Dict[str, Dict[str, Any]]:
        """All plan entries, file overlaid with this process's memory
        (memory wins — it is at least as new as what we last published)."""
        with self._lock:
            try:
                st = os.stat(self.path)
                sig = (self.path, st.st_mtime_ns, st.st_size)
            except OSError:
                sig = (self.path, -1, -1)
            if sig != self._cache_sig:
                self._cache = self._plans_of(self._read_file())
                self._cache_sig = sig
                self._inc("loads")
            merged = dict(self._cache)
            merged.update(self._mem)
            return merged

    def plan_entry(self, fp: str) -> Optional[Dict[str, Any]]:
        return self.plans().get(fp)

    def count(self) -> int:
        return len(self.plans())

    def remember(self, fp: str, entry: Dict[str, Any]) -> None:
        """In-memory-only update (observation bookkeeping on an already
        converged entry) — no file write, no eviction."""
        with self._lock:
            self._mem[fp] = dict(entry)

    # -- publishing ----------------------------------------------------------
    def publish(
        self, fp: str, mutate: Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]
    ) -> bool:
        """Apply ``mutate(entry_or_empty) -> entry | None`` to plan ``fp``
        and persist. ``None`` means "nothing learned" — no write happens.
        Returns True when a publish (file or memory) occurred."""
        with self._lock:
            doc = self._read_file()
            plans = self._plans_of(doc)
            plans.update(self._mem)
            cur = plans.get(fp)
            entry = mutate(dict(cur) if isinstance(cur, dict) else {})
            if entry is None:
                return False
            entry["ts"] = time.time()
            entry["gen"] = int(entry.get("gen", 0)) + 1
            plans[fp] = entry
            self._mem[fp] = entry
            # stale-fingerprint eviction: LRU by last-used timestamp
            while len(plans) > self.max_entries:
                victim = min(
                    plans, key=lambda k: float(plans[k].get("ts", 0) or 0)
                )
                plans.pop(victim)
                self._mem.pop(victim, None)
                self._inc("evictions")
            doc.setdefault("tuning", {})
            doc["tuning"] = {"version": 1, "plans": plans}
            if self._write_doc_locked(doc):
                self._cache = plans
                self._inc("publishes")
            return True

    def _write_doc_locked(self, doc: Dict[str, Any]) -> bool:
        """Atomic whole-document write (temp in the same dir +
        ``os.replace``), refreshing the mtime cache signature. Caller
        holds ``self._lock``. False (after the one-shot unwritable
        warning) when the path can't be written — memory-only from
        there."""
        try:
            d = os.path.dirname(self.path) or "."
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, prefix="._tuned_", suffix=".json")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(doc, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            finally:
                if os.path.exists(tmp):  # replace failed
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
            try:
                st = os.stat(self.path)
                self._cache_sig = (self.path, st.st_mtime_ns, st.st_size)
            except OSError:
                self._cache_sig = (self.path, -1, -1)
            return True
        except OSError as ex:
            # unwritable store: memory-only from here on, one warning
            _warn_once(self.path, "unwritable", str(ex))
            return False

    def publish_rooflines(
        self, mutate: Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]
    ) -> bool:
        """Apply ``mutate(entries) -> entries | None`` to the
        ``"rooflines"`` top-level key and persist — the same
        read-merge-write + atomic-replace + LRU discipline as
        :meth:`publish`, preserving every other key verbatim. ``None`` =
        nothing to record."""
        with self._lock:
            doc = self._read_file()
            entries = self._overlay_roof_locked(self._roof_of(doc))
            out = mutate(dict(entries))
            if out is None:
                return False
            # stale-entry eviction: LRU by last-fold timestamp, the same
            # bound as plan entries (the two tables share max_entries)
            while len(out) > self.max_entries:
                victim = min(out, key=lambda k: float(out[k].get("ts", 0) or 0))
                out.pop(victim)
                self._inc("evictions")
            self._mem_roof = {k: dict(v) for k, v in out.items()}
            doc["rooflines"] = {"version": 1, "entries": out}
            if self._write_doc_locked(doc):
                self._inc("roofline_publishes")
            return True
