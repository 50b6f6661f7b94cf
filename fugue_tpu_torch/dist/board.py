"""The shared task board, copied from ``fugue_tpu/dist/board.py``:
durable dispatch state on a shared filesystem.

Everything the worker tier coordinates through lives under one root::

    <root>/tasks/<tid>.task.json     task specs (supervisor writes once)
    <root>/done/<tid>.done.json      done records — O_CREAT|O_EXCL, so the
                                     FIRST publisher wins and a speculative
                                     or steal-raced duplicate loses cleanly
    <root>/fail/<tid>.<uuid>.json    one record per failed attempt
                                     (category from the resilience
                                     taxonomy)
    <root>/spec/<tid>.spec           straggler hints (supervisor marks,
                                     idle workers volunteer)
    <root>/leases/                   task leases (:mod:`.lease`)
    <root>/hb/                       worker heartbeats (:mod:`.heartbeat`)
    <root>/store/                    the shared content-addressed
                                     ArtifactStore (reduce outputs)
    <root>/jobs/<jid>.job.json       job manifests (supervisor restart)
    <root>/workers/<wid>/            per-worker data dirs (shuffle
                                     fragments — served over HTTP when the
                                     filesystem is NOT shared)

A task is *runnable* when it has a spec, no done record, and every dep's
done record exists. Every mutation is an atomic create or rename, so any
process (or any restart of one) reads a consistent board: the recovery
story is "look at the files", not "replay my memory".
"""

import base64
import hashlib
import json
import os
import uuid as _uuid
from typing import Any, Dict, List, Optional

import cloudpickle

from ..workflow._checkpoint import _best_effort_remove

__all__ = ["TaskBoard", "spec_fingerprint", "dump_fn", "load_fn"]


def dump_fn(fn: Any) -> Optional[str]:
    """A callable as base64 cloudpickle (None stays None)."""
    if fn is None:
        return None
    return base64.b64encode(cloudpickle.dumps(fn)).decode()


def load_fn(blob: Optional[str]) -> Any:
    if not blob:
        return None
    return cloudpickle.loads(base64.b64decode(blob))


def spec_fingerprint(*parts: Any) -> str:
    """Deterministic content address for a task's output: md5 over the
    json-stable parts (input file tokens, function payloads, bucket ids…)
    — speculative duplicates and steal re-runs compute the SAME id, so
    the artifact store dedups their publishes by construction."""
    h = hashlib.md5()
    for p in parts:
        h.update(json.dumps(p, sort_keys=True, default=str).encode())
        h.update(b"\x00")
    return h.hexdigest()


class TaskBoard:
    """File-backed task state under one shared root."""

    def __init__(self, root: str):
        self.root = root
        self.tasks_dir = os.path.join(root, "tasks")
        self.done_dir = os.path.join(root, "done")
        self.fail_dir = os.path.join(root, "fail")
        self.spec_dir = os.path.join(root, "spec")
        self.leases_dir = os.path.join(root, "leases")
        self.hb_dir = os.path.join(root, "hb")
        self.store_dir = os.path.join(root, "store")
        self.jobs_dir = os.path.join(root, "jobs")
        self.workers_dir = os.path.join(root, "workers")
        for d in (
            self.tasks_dir,
            self.done_dir,
            self.fail_dir,
            self.spec_dir,
            self.leases_dir,
            self.hb_dir,
            self.store_dir,
            self.jobs_dir,
            self.workers_dir,
        ):
            os.makedirs(d, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _task(self, tid: str) -> str:
        return os.path.join(self.tasks_dir, f"{tid}.task.json")

    def _done(self, tid: str) -> str:
        return os.path.join(self.done_dir, f"{tid}.done.json")

    def _spec_mark(self, tid: str) -> str:
        return os.path.join(self.spec_dir, f"{tid}.spec")

    def _job(self, jid: str) -> str:
        return os.path.join(self.jobs_dir, f"{jid}.job.json")

    def worker_data_dir(self, worker_id: str) -> str:
        d = os.path.join(self.workers_dir, worker_id)
        os.makedirs(d, exist_ok=True)
        return d

    # -- atomic json ---------------------------------------------------------
    @staticmethod
    def _write_json(final: str, payload: Dict[str, Any]) -> None:
        tmp = f"{final}.__tmp_{_uuid.uuid4().hex}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, final)

    @staticmethod
    def _read_json(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except Exception:
            return None  # torn mid-replace read: retry next scan

    # -- tasks ---------------------------------------------------------------
    def put_task(self, tid: str, spec: Dict[str, Any]) -> None:
        doc = dict(spec, id=tid)
        if "trace" not in doc:
            # cluster tracing: a spec written inside a traced
            # run carries the run's {"trace", "parent"} so the executing
            # worker's spans attach under the submitting run
            from ..obs.tracer import trace_carrier

            carrier = trace_carrier()
            if carrier:
                doc["trace"] = carrier
        self._write_json(self._task(tid), doc)

    def read_task(self, tid: str) -> Optional[Dict[str, Any]]:
        return self._read_json(self._task(tid))

    def list_tasks(self) -> List[str]:
        try:
            names = os.listdir(self.tasks_dir)
        except OSError:
            return []
        return sorted(
            n[: -len(".task.json")] for n in names if n.endswith(".task.json")
        )

    # -- done records (first publish wins) -----------------------------------
    def publish_done(self, tid: str, payload: Dict[str, Any]) -> bool:
        """O_CREAT|O_EXCL: exactly one executor's record survives. False
        = another executor (speculative twin, steal racer) already
        published — the caller's work was redundant, not wrong; its
        artifact publishes were deduped by content address."""
        path = self._done(tid)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        except OSError:
            return False
        try:
            data = json.dumps(dict(payload, task=tid)).encode()
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        return True

    def read_done(self, tid: str) -> Optional[Dict[str, Any]]:
        return self._read_json(self._done(tid))

    def invalidate_done(self, tid: str) -> bool:
        """Orphaned-output recovery: a consumer that PROVED a done
        record's outputs unreachable (dead producer, torn fragment)
        deletes the record — the task becomes runnable again and a live
        worker re-executes it. Deterministic tasks re-produce identical
        bytes, so consumers that already read the old outputs stay
        consistent with consumers of the new ones."""
        path = self._done(tid)
        existed = os.path.exists(path)
        _best_effort_remove(path)
        return existed

    def done_count(self, tids: List[str]) -> int:
        return sum(1 for t in tids if os.path.exists(self._done(t)))

    # -- failure records -----------------------------------------------------
    def record_failure(
        self, tid: str, worker: str, category: str, error: str
    ) -> None:
        path = os.path.join(
            self.fail_dir, f"{tid}.{_uuid.uuid4().hex[:8]}.json"
        )
        self._write_json(
            path,
            {"task": tid, "worker": worker, "category": category, "error": error},
        )

    def failures(self, tid: str) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        try:
            names = os.listdir(self.fail_dir)
        except OSError:
            return out
        for n in sorted(names):
            if n.startswith(tid + ".") and n.endswith(".json"):
                rec = self._read_json(os.path.join(self.fail_dir, n))
                if rec is not None:
                    out.append(rec)
        return out

    # -- speculation ---------------------------------------------------------
    def mark_speculative(self, tid: str) -> bool:
        path = self._spec_mark(tid)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            return True
        except OSError:
            return False

    def is_speculative(self, tid: str) -> bool:
        return os.path.exists(self._spec_mark(tid))

    # -- job manifests -------------------------------------------------------
    def put_job(self, jid: str, manifest: Dict[str, Any]) -> None:
        self._write_json(self._job(jid), dict(manifest, id=jid))

    def read_job(self, jid: str) -> Optional[Dict[str, Any]]:
        return self._read_json(self._job(jid))
