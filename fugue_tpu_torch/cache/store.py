"""The tiered result store, copied from ``fugue_tpu/cache/store.py``: an
in-process LRU over live frames, backed by a content-addressed on-disk
parquet artifact store.

Memory tier (:class:`MemoryLRU`): byte-budgeted
(``fugue.tpu.cache.mem_bytes``, default 256 MiB) references to the exact
frames a run produced. A hit serves the live frame again: a
``TorchDataFrame`` stays on its card, with no decode and no host→device
copy. Per engine, because a device frame belongs to one device.

Disk tier (:class:`ArtifactStore`): ``objs/<fp>.parquet`` artifacts plus
a ``<fp>.meta.json`` sidecar (schema and bytes), published by a
temp-write and atomic rename, as checkpoints are: two processes racing
to publish one fingerprint both succeed and the survivor is a complete
file. A fingerprint can instead be a *ref* (``<fp>.ref.json``) to an
artifact a permanent strong checkpoint already owns. Size-capped
(``fugue.tpu.cache.disk_bytes``) and count-capped
(``fugue.tpu.cache.disk_max_entries``), with LRU eviction on the
artifact's mtime (hits touch it). A corrupt or torn artifact is a miss:
the reader deletes it and the caller recomputes.

Claim files (``try_claim_file``): one small json file created with
``O_CREAT|O_EXCL``, so exactly one creator wins a cold race; a claim whose
lease expired, or whose owner is dead, may be stolen: its heartbeat
(``dist/heartbeat.py``) gone stale where a heartbeat directory is
configured, else its same-host pid gone.

:class:`ResultCache` joins both tiers behind ``lookup``/``publish`` and
owns the :class:`CacheStats` counters of ``engine.stats()["cache"]``.
``stats.reset()`` zeroes the counters and keeps the entries.
"""

import json
import os
import shutil
import socket
import threading
import time
import uuid as _uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..workflow._checkpoint import _atomic_publish, _best_effort_remove

__all__ = [
    "CacheStats",
    "MemoryLRU",
    "ArtifactStore",
    "ResultCache",
    "estimate_df_bytes",
    "clean_cache_dir",
    "try_claim_file",
    "read_claim_file",
    "release_claim_file",
]


# ---------------------------------------------------------------------------
# the file-claim primitive
# ---------------------------------------------------------------------------
# One small json file created with O_CREAT|O_EXCL — the same kernel-atomic
# primitive the temp-write+rename publishes lean on — so exactly one
# creator wins a cold race. A held claim is STEALABLE when the caller's
# ``stealable(holder)`` predicate says so (lease expiry, dead pid); steal
# races settle by re-reading the file after the atomic rewrite: whichever
# payload survived the rename owns it.


def _claim_write_json(final: str, payload: Dict[str, Any]) -> None:
    tmp = f"{final}.__tmp_{_uuid.uuid4().hex}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, final)


def read_claim_file(path: str) -> Optional[Dict[str, Any]]:
    """The current claim payload, or None. A torn/corrupt claim file is
    deleted and reads as absent (stealable, never a wedge)."""
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except Exception:
        _best_effort_remove(path)
        return None


def try_claim_file(
    path: str,
    payload: Dict[str, Any],
    stealable: Any,
) -> Tuple[bool, Optional[Dict[str, Any]]]:
    """Atomically claim ``path`` with ``payload`` (must carry ``owner``).

    Returns ``(owned, holder)``: ``owned`` means the payload's owner
    holds the claim now (fresh, re-entered, or stolen); otherwise
    ``holder`` is the live holder to wait on. ``stealable(holder)``
    decides whether a foreign holder may be overwritten."""
    owner = payload.get("owner")
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        try:
            data = json.dumps(payload).encode()
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        return True, payload
    except FileExistsError:
        pass
    except OSError:
        return False, None  # store trouble: behave as not-owned
    holder = read_claim_file(path)
    if holder is not None:
        if holder.get("owner") == owner:
            # re-entrant: the owner restarting meets its own prior claim
            return True, holder
        if not stealable(holder):
            return False, holder
    # expired/dead/torn: steal via atomic rewrite; the last rename wins,
    # so re-read to learn who actually owns it now
    try:
        _claim_write_json(path, payload)
    except OSError:
        return False, holder
    cur = read_claim_file(path)
    return (cur is not None and cur.get("owner") == owner), cur


def release_claim_file(path: str, owner: str) -> bool:
    """Remove the claim if ``owner`` still holds it (a steal victim's
    late release must not drop the thief's claim)."""
    cur = read_claim_file(path)
    if cur is not None and cur.get("owner") != owner:
        return False
    _best_effort_remove(path)
    return True

_COUNTERS = (
    "lookups",
    "hits_mem",
    "hits_disk",
    "misses",
    "refusals",
    "publishes",
    "links",
    "evictions_mem",
    "evictions_disk",
    "bytes_served",
    "bytes_published",
    "bytes_skipped",
    "tasks_skipped",
    # partition-level delta recompute (delta.py): a partial hit serves the cached part of a grown source
    # and recomputes only the delta partitions
    "partial_hits",
    "delta_partitions",
    "delta_partitions_fresh",
    "bytes_skipped_delta",
    "delta_refusals",
    "manifest_publishes",
)


class CacheStats:
    """Thread-safe cache counters (a ``MetricsRegistry`` source).

    ``reset()`` zeroes the counters WITHOUT evicting live entries: a
    stats reset must never become a perf event. Entry/byte gauges are re-read from the tiers on every
    ``as_dict`` so they survive resets."""

    def __init__(self, cache: Optional["ResultCache"] = None) -> None:
        self._lock = threading.Lock()
        self._cache = cache
        self.reset()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            out = {k: self._c.get(k, 0) for k in _COUNTERS}
        if self._cache is not None:
            out["mem_entries"] = self._cache.mem.entries
            out["mem_bytes"] = self._cache.mem.bytes
            out["disk_enabled"] = self._cache.disk is not None
        return out

    def reset(self) -> None:
        with self._lock:
            self._c: Dict[str, int] = {}


class MemoryLRU:
    """Byte-budgeted LRU of live DataFrames keyed by fingerprint."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0

    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def contains(self, fp: str) -> bool:
        with self._lock:
            return fp in self._entries

    def get(self, fp: str) -> Optional[Tuple[Any, int]]:
        with self._lock:
            hit = self._entries.get(fp)
            if hit is None:
                return None
            self._entries.move_to_end(fp)
            return hit

    def put(self, fp: str, df: Any, nbytes: int) -> int:
        """Insert (or refresh) an entry; returns how many were evicted.
        A frame larger than the whole budget is refused outright."""
        nbytes = max(0, int(nbytes))
        if self.budget <= 0 or nbytes > self.budget:
            return 0
        evicted = 0
        with self._lock:
            old = self._entries.pop(fp, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[fp] = (df, nbytes)
            self._bytes += nbytes
            while self._bytes > self.budget and len(self._entries) > 1:
                _, (_odf, ob) = self._entries.popitem(last=False)
                self._bytes -= ob
                evicted += 1
        return evicted

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0


class ArtifactStore:
    """Content-addressed parquet artifacts under ``<dir>/objs``."""

    def __init__(
        self,
        path: str,
        cap_bytes: int,
        log: Any = None,
        cap_entries: int = 0,
        hb_dir: Optional[str] = None,
        hb_stale_s: float = 3.0,
    ):
        self.root = path
        # with a heartbeat dir, a claim owner's staleness there is proof
        # of death across hosts (the serve fleet's replicas beat there)
        self.hb_dir = hb_dir or None
        self.hb_stale_s = float(hb_stale_s)
        self.objs = os.path.join(path, "objs")
        self.manifests = os.path.join(path, "manifests")
        self.claims = os.path.join(path, "claims")
        self.cap = int(cap_bytes)
        self.cap_entries = int(cap_entries)
        self._log = log
        os.makedirs(self.objs, exist_ok=True)
        os.makedirs(self.manifests, exist_ok=True)
        os.makedirs(self.claims, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _obj(self, fp: str) -> str:
        return os.path.join(self.objs, fp + ".parquet")

    def _meta(self, fp: str) -> str:
        return os.path.join(self.objs, fp + ".meta.json")

    def _ref(self, fp: str) -> str:
        return os.path.join(self.objs, fp + ".ref.json")

    def _manifest(self, key: str) -> str:
        return os.path.join(self.manifests, key + ".manifest.json")

    def _claim(self, key: str) -> str:
        return os.path.join(self.claims, key + ".claim.json")

    # -- fingerprint-ownership claims ----------------------------------------
    # Processes sharing this store may collapse identical work by claiming
    # a key before executing it: the winner executes and publishes, the
    # others wait on the published artifact. The claim
    # is a small json file created with O_CREAT|O_EXCL (the same
    # kernel-atomic primitive the temp-write+rename publishes lean on), so
    # exactly one creator wins a cold race. A claim is STEALABLE when its
    # owner is provably dead (same-host pid gone) or its lease expired —
    # steal races settle by re-reading the file after the atomic rewrite:
    # whichever payload survived the rename owns it.
    def try_claim(
        self, key: str, owner: str, lease_s: float
    ) -> Tuple[bool, Optional[Dict[str, Any]]]:
        """(owned, holder_payload). ``owned`` means THIS ``owner`` holds
        the claim now (fresh, re-entered after a restart, or stolen);
        otherwise ``holder_payload`` is the live holder to wait on."""
        payload = {
            "owner": owner,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "ts": time.time(),
            "lease_s": float(lease_s),
        }
        return try_claim_file(self._claim(key), payload, self._claim_stealable)

    def _claim_stealable(self, holder: Dict[str, Any]) -> bool:
        ts = float(holder.get("ts", 0.0))
        lease = float(holder.get("lease_s", 0.0))
        if ts + lease <= time.time():
            return True
        # cross-host liveness first: a stale heartbeat is proof of death
        # regardless of host; a fresh one pins the claim for its lease
        if self.hb_dir:
            from ..dist.heartbeat import holder_alive

            alive = holder_alive(str(holder.get("owner") or ""), self.hb_dir, self.hb_stale_s)
            if alive is not None:
                return not alive
        # fallback (no heartbeat dir, or an owner that never beat): a
        # SIGKILLed same-host owner shouldn't pin its claim for the whole
        # lease — a dead pid is stealable immediately
        pid = holder.get("pid")
        if pid and holder.get("host") == socket.gethostname():
            try:
                os.kill(int(pid), 0)
            except ProcessLookupError:
                return True
            except OSError:
                pass
        return False

    def read_claim(self, key: str) -> Optional[Dict[str, Any]]:
        """The current claim payload, or None. A torn/corrupt claim file
        is deleted and reads as absent (stealable, never a wedge)."""
        return read_claim_file(self._claim(key))

    def release_claim(self, key: str, owner: str) -> bool:
        """Remove the claim if ``owner`` still holds it (a steal victim's
        late release must not drop the thief's claim)."""
        return release_claim_file(self._claim(key), owner)

    # -- delta manifests -----------------------------------------------------
    def load_manifest(self, key: str) -> Optional[Dict[str, Any]]:
        """The partition manifest published under a delta key, or None. A
        torn/corrupt manifest is deleted and reads as absent (a delta miss
        degrades to whole-task recompute, never a wrong hit)."""
        path = self._manifest(key)
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except Exception:
            _best_effort_remove(path)
            return None

    def publish_manifest(self, key: str, payload: Dict[str, Any]) -> None:
        """Atomic last-writer-wins: two processes publishing the manifest
        of the same grown source write identical content by construction
        (segment artifacts are content-addressed), so either winner is
        complete and correct."""
        self._write_json(self._manifest(key), payload)

    def remove_manifest(self, key: str) -> None:
        _best_effort_remove(self._manifest(key))

    # -- read side -----------------------------------------------------------
    def exists(self, fp: str) -> bool:
        if os.path.exists(self._obj(fp)) and os.path.exists(self._meta(fp)):
            return True
        return os.path.exists(self._ref(fp))

    def load(self, fp: str, engine: Any) -> Optional[Tuple[Any, int]]:
        """(frame, artifact_bytes) or None. The sidecar's schema is
        re-applied on load so the parquet round trip can't drift dtypes.
        A torn/corrupt owned artifact is deleted and reads as a miss."""
        path, meta_path, owned = self._obj(fp), self._meta(fp), True
        if not os.path.exists(path):
            ref = self._ref(fp)
            if not os.path.exists(ref):
                return None
            try:
                with open(ref) as f:
                    target = json.load(f)
                path, meta_path, owned = target["path"], ref, False
            except Exception:
                _best_effort_remove(ref)
                return None
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            df = engine.load_df(path, format_hint="parquet")
            schema = meta.get("schema")
            if schema:
                df = engine.to_df(df, schema=schema)
            nbytes = int(meta.get("bytes", 0)) or _path_bytes(path)
            os.utime(self._meta(fp) if owned else meta_path, None)
            if owned:
                os.utime(path, None)
            return df, nbytes
        except Exception as ex:
            if self._log is not None:
                self._log.warning(
                    "result-cache artifact %s unreadable (%s); recomputing",
                    fp[:12],
                    type(ex).__name__,
                )
            if owned:
                _best_effort_remove(path)
                _best_effort_remove(meta_path)
            else:
                _best_effort_remove(self._ref(fp))
            return None

    # -- write side ----------------------------------------------------------
    def publish(self, fp: str, df: Any, engine: Any, schema: str) -> int:
        """Write the artifact + sidecar atomically; a concurrent publisher
        of the same fingerprint harmlessly wins or loses the final rename
        (the content is the same by construction). Returns bytes written
        (0 when the artifact already existed)."""
        if self.exists(fp):
            return 0
        final = self._obj(fp)
        tmp = f"{final}.__tmp_{_uuid.uuid4().hex}"
        try:
            engine.save_df(
                df, tmp, format_hint="parquet", mode="overwrite", force_single=True
            )
            nbytes = _path_bytes(tmp)
            _atomic_publish(tmp, final)
        finally:
            if os.path.exists(tmp):
                _best_effort_remove(tmp)
        self._write_json(self._meta(fp), {"schema": schema, "bytes": nbytes})
        return nbytes

    def link(self, fp: str, path: str, schema: str) -> bool:
        """Index an artifact another subsystem owns (one artifact, two
        indexes): the memoization path never writes a second copy of a
        frame a permanent StrongCheckpoint already published."""
        if self.exists(fp):
            return False
        self._write_json(
            self._ref(fp), {"path": path, "schema": schema, "bytes": _path_bytes(path)}
        )
        return True

    def _write_json(self, final: str, payload: Dict[str, Any]) -> None:
        tmp = f"{final}.__tmp_{_uuid.uuid4().hex}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, final)

    # -- eviction ------------------------------------------------------------
    def evict_to_cap(self) -> int:
        """Drop least-recently-used artifacts until under BOTH the size
        cap and the entry-count cap (per-partition delta artifacts
        multiply small files, so bytes alone don't bound inode pressure).
        Raced deletions are fine: the loser's remove is a no-op. Manifests
        referencing an evicted artifact are invalidated LAZILY — the next
        delta match sees the missing artifact, deletes the stale manifest
        and degrades that one chain to whole-task recompute."""
        if self.cap <= 0 and self.cap_entries <= 0:
            return 0
        entries: List[Tuple[float, int, str]] = []
        total = 0
        try:
            names = os.listdir(self.objs)
        except OSError:
            return 0
        for n in names:
            if not n.endswith(".parquet"):
                continue
            p = os.path.join(self.objs, n)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime, int(st.st_size), p[: -len(".parquet")]))
            total += int(st.st_size)
        evicted = 0
        count = len(entries)
        for _mt, size, base in sorted(entries):
            over_bytes = self.cap > 0 and total > self.cap
            over_count = self.cap_entries > 0 and count > self.cap_entries
            if not (over_bytes or over_count):
                break
            _best_effort_remove(base + ".parquet")
            _best_effort_remove(base + ".meta.json")
            total -= size
            count -= 1
            evicted += 1
        return evicted

    def clear(self) -> None:
        shutil.rmtree(self.objs, ignore_errors=True)
        shutil.rmtree(self.manifests, ignore_errors=True)
        os.makedirs(self.objs, exist_ok=True)
        os.makedirs(self.manifests, exist_ok=True)


class ResultCache:
    """The engine-facing cache: conf-driven tiers + counters."""

    def __init__(self, conf: Any, log: Any = None):
        from ..constants import (
            FUGUE_TPU_CONF_CACHE_DELTA_ENABLED,
            FUGUE_TPU_CONF_CACHE_DIR,
            FUGUE_TPU_CONF_CACHE_DISK_BYTES,
            FUGUE_TPU_CONF_CACHE_DISK_MAX_ENTRIES,
            FUGUE_TPU_CONF_CACHE_ENABLED,
            FUGUE_TPU_CONF_CACHE_MAX_ARTIFACT_BYTES,
            FUGUE_TPU_CONF_CACHE_MEM_BYTES,
        )

        def _get(key: str, default: Any) -> Any:
            try:
                return conf.get(key, default)
            except Exception:
                return default

        self._log = log
        self.enabled = bool(_get(FUGUE_TPU_CONF_CACHE_ENABLED, True))
        self.delta_enabled = bool(_get(FUGUE_TPU_CONF_CACHE_DELTA_ENABLED, True))
        self.max_artifact_bytes = int(
            _get(FUGUE_TPU_CONF_CACHE_MAX_ARTIFACT_BYTES, 256 * 1024 * 1024)
        )
        self.mem = MemoryLRU(int(_get(FUGUE_TPU_CONF_CACHE_MEM_BYTES, 256 * 1024 * 1024)))
        self.stats = CacheStats(self)
        self.disk: Optional[ArtifactStore] = None
        # in-process manifest tier: delta recompute works memory-only too
        # (same-engine warm runs); the disk copy is the cross-process one
        self._manifest_lock = threading.Lock()
        self._mem_manifests: Dict[str, Dict[str, Any]] = {}
        cache_dir = str(
            _get(FUGUE_TPU_CONF_CACHE_DIR, "") or os.environ.get("FUGUE_TPU_CACHE_DIR", "")
        )
        if self.enabled and cache_dir:
            from ..constants import FUGUE_TPU_CONF_DIST_HB_DIR, FUGUE_TPU_CONF_DIST_HB_STALE_S

            cap = int(_get(FUGUE_TPU_CONF_CACHE_DISK_BYTES, 4 * 1024 * 1024 * 1024))
            cap_entries = int(_get(FUGUE_TPU_CONF_CACHE_DISK_MAX_ENTRIES, 65536))
            try:
                store = ArtifactStore(
                    cache_dir,
                    cap,
                    log=log,
                    cap_entries=cap_entries,
                    hb_dir=str(_get(FUGUE_TPU_CONF_DIST_HB_DIR, "")) or None,
                    hb_stale_s=float(_get(FUGUE_TPU_CONF_DIST_HB_STALE_S, 3.0)),
                )
                probe = os.path.join(store.objs, f".probe_{_uuid.uuid4().hex}")
                with open(probe, "w") as f:
                    f.write("ok")
                os.remove(probe)
                self.disk = store
            except OSError as ex:
                # degrade to memory-only: ONE warning, never a crash
                if log is not None:
                    log.warning(
                        "fugue.tpu.cache.dir %r is not writable (%s); result "
                        "cache degrades to memory-only",
                        cache_dir,
                        ex,
                    )

    # -- read side -----------------------------------------------------------
    def contains(self, fp: str) -> Optional[str]:
        """Which tier could serve ``fp`` right now (no counters touched —
        the planner probes many times while computing the cut)."""
        if not self.enabled:
            return None
        if self.mem.contains(fp):
            return "mem"
        if self.disk is not None and self.disk.exists(fp):
            return "disk"
        return None

    def lookup(self, fp: str, engine: Any) -> Optional[Tuple[Any, str, int]]:
        """(frame, tier, bytes) or None. Disk hits are promoted into the
        memory tier so a hot fingerprint is served live next time."""
        self.stats.inc("lookups")
        if not self.enabled:
            self.stats.inc("misses")
            return None
        hit = self.mem.get(fp)
        if hit is not None:
            self.stats.inc("hits_mem")
            self.stats.inc("bytes_served", hit[1])
            return hit[0], "mem", hit[1]
        if self.disk is not None:
            loaded = self.disk.load(fp, engine)
            if loaded is not None:
                df, nbytes = loaded
                self.stats.inc("hits_disk")
                self.stats.inc("bytes_served", nbytes)
                self.stats.inc("evictions_mem", self.mem.put(fp, df, nbytes))
                return df, "disk", nbytes
        self.stats.inc("misses")
        return None

    # -- write side ----------------------------------------------------------
    def publish(
        self,
        fp: str,
        df: Any,
        engine: Any,
        schema: str,
        ref_path: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Memory-insert always; disk-publish when a store is mounted and
        the frame fits the artifact cap. ``ref_path`` indexes an existing
        file (a permanent checkpoint) instead of writing a copy."""
        out: Dict[str, Any] = {"tier": "mem"}
        if not self.enabled:
            return out
        nbytes = estimate_df_bytes(df)
        self.stats.inc("evictions_mem", self.mem.put(fp, df, nbytes))
        if self.disk is None:
            return out
        try:
            if ref_path is not None and os.path.exists(ref_path):
                if self.disk.link(fp, ref_path, schema):
                    self.stats.inc("links")
                out["tier"] = "ref"
            elif nbytes <= self.max_artifact_bytes:
                written = self.disk.publish(fp, df, engine, schema)
                if written > 0:
                    self.stats.inc("publishes")
                    self.stats.inc("bytes_published", written)
                    self.stats.inc("evictions_disk", self.disk.evict_to_cap())
                out["tier"] = "disk"
                out["bytes"] = written
        except Exception as ex:  # publishing must never fail the run
            if self._log is not None:
                self._log.warning(
                    "result-cache publish of %s failed: %s", fp[:12], ex
                )
        return out

    # -- delta manifests -----------------------------------------------------
    def get_manifest(self, key: str) -> Optional[Dict[str, Any]]:
        """Freshest manifest for a delta key: the in-process copy when this
        engine published it, else the shared disk copy."""
        if not self.enabled or not self.delta_enabled:
            return None
        with self._manifest_lock:
            m = self._mem_manifests.get(key)
        if m is not None:
            return m
        if self.disk is not None:
            return self.disk.load_manifest(key)
        return None

    def put_manifest(self, key: str, payload: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        with self._manifest_lock:
            self._mem_manifests[key] = payload
        if self.disk is not None:
            try:
                self.disk.publish_manifest(key, payload)
            except Exception as ex:  # publishing must never fail the run
                if self._log is not None:
                    self._log.warning(
                        "delta manifest publish of %s failed: %s", key[:12], ex
                    )
        self.stats.inc("manifest_publishes")

    def drop_manifest(self, key: str) -> None:
        """A stale manifest (evicted/changed artifacts) invalidates ONLY
        itself — the rest of the cache stays serviceable."""
        with self._manifest_lock:
            self._mem_manifests.pop(key, None)
        if self.disk is not None:
            self.disk.remove_manifest(key)

    def clear(self) -> None:
        self.mem.clear()
        with self._manifest_lock:
            self._mem_manifests.clear()
        if self.disk is not None:
            self.disk.clear()


def estimate_df_bytes(df: Any) -> int:
    """Byte size of a live frame for LRU accounting (best effort): a
    ``TorchDataFrame``'s device bytes (its columns, masks and host-side
    columns), else the host frame's."""
    try:
        from ..torch.dataframe import TorchDataFrame

        if isinstance(df, TorchDataFrame):
            return df.device_nbytes
    except Exception:
        pass
    try:
        import pandas as pd
        import pyarrow as pa

        native = getattr(df, "native", None)
        if isinstance(native, pa.Table):
            return int(native.nbytes)
        if isinstance(native, pd.DataFrame):
            return int(native.memory_usage(index=False, deep=False).sum())
        if isinstance(native, list):
            return len(native) * max(1, len(df.schema)) * 16
    except Exception:
        pass
    try:
        return int(df.count()) * max(1, len(df.schema)) * 16
    except Exception:
        return 0


def _path_bytes(path: str) -> int:
    try:
        if os.path.isdir(path):
            total = 0
            for root, _d, names in os.walk(path):
                for n in names:
                    total += os.path.getsize(os.path.join(root, n))
            return total
        return os.path.getsize(path)
    except OSError:
        return 0


def clean_cache_dir(path: str) -> str:
    """Wipe a result-cache directory's artifacts and manifests."""
    if not path:
        return (
            "no cache dir given (set FUGUE_TPU_CACHE_DIR or pass a path); "
            "nothing cleaned"
        )
    objs = os.path.join(path, "objs")
    if not os.path.isdir(objs):
        return f"{path} holds no result-cache artifacts; nothing cleaned"
    n = len([f for f in os.listdir(objs) if not f.startswith(".")])
    shutil.rmtree(objs, ignore_errors=True)
    manifests = os.path.join(path, "manifests")
    if os.path.isdir(manifests):
        n += len([f for f in os.listdir(manifests) if not f.startswith(".")])
        shutil.rmtree(manifests, ignore_errors=True)
    return f"removed {n} artifact file(s) from {objs}"
