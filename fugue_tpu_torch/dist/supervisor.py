"""The supervisor, copied from ``fugue_tpu/dist/supervisor.py``: plans
distributed jobs, watches the board, recovers.

:class:`DistSupervisor` makes a multi-worker run look like one engine
call (the Cylon execution-environment shape, arXiv:2301.07896): a *job*
is a distributed load → network-partitioned shuffle → per-bucket reduce
→ combine, expressed as plain pandas functions and executed by however
many :class:`~fugue_tpu_torch.dist.worker.DistWorker` processes are watching
the shared board. The supervisor itself never executes tasks (except on
the kill-switch path) — it writes task specs, watches done/fail/lease
state, classifies re-dispatches under the resilience taxonomy, marks
stragglers speculative, and combines the content-addressed reduce
artifacts into the final frame.

Recovery ladder, all of it observable in
``engine.stats()["dist"]``:

1. an attempt that RAISES records a categorized failure and releases its
   lease — TRANSIENT/TIMEOUT/WORKER_LOST re-dispatch to any live worker;
   POISON (deterministic user-code failure) aborts the job with the
   per-task report; attempts are bounded by ``fugue.tpu.retry.dist.*``;
2. a worker that DIES mid-task stops heartbeating — its lease reads
   stealable and a live worker re-executes (``redispatch_worker_lost``);
3. a completed task whose OUTPUT became unreachable (producer SIGKILLed
   before consumers fetched, torn fragment) is invalidated by the
   consumer and re-runs (``orphaned_outputs_recovered``);
4. a LIVE owner that straggles past ``fugue.tpu.dist.speculative_after_s``
   gets a speculative twin; the first done-record publish wins and the
   loser's artifact publishes dedup by content address.

Kill-switch: ``fugue.tpu.dist.enabled=false`` routes ``run_*`` through
``_run_serial`` — the SAME map/bucket/reduce/combine functions, the same
bucket order, in this process — bit-identical by construction.
"""

import os
import time
import uuid as _uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import pandas as pd
import pyarrow as pa

from ..obs.events import get_event_log
from ..obs.tracer import proc_ident
from ..resilience import RetryPolicy
from ..shuffle.partitioner import bucket_ids, canonical_key_kinds
from .board import TaskBoard, dump_fn, load_fn, spec_fingerprint
from .heartbeat import DEFAULT_STALE_AFTER_S, read_heartbeat
from .lease import LeaseBoard
from .stats import DistStats
from .worker import _empty_frame, apply_map, read_source_paths

__all__ = ["DistSupervisor", "DistJobError"]


class DistJobError(RuntimeError):
    """Terminal job failure (poison task, attempts exhausted, timeout).
    Carries a per-task ``report``."""

    def __init__(self, message: str, report: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.report = dict(report or {})


def _default_combine(partials: List[pd.DataFrame]) -> pd.DataFrame:
    if not partials:
        return pd.DataFrame()
    return pd.concat(partials, ignore_index=True)


def _chunk(paths: List[str], per_task: int) -> List[List[str]]:
    per_task = max(1, int(per_task))
    return [paths[i : i + per_task] for i in range(0, len(paths), per_task)]


def _file_token(path: str) -> List[Any]:
    try:
        st = os.stat(path)
        return [path, int(st.st_size), int(st.st_mtime_ns)]
    except OSError:
        return [path, 0, 0]


def _fields(schema: pa.Schema) -> Dict[str, Any]:
    """Name-indexable view of an arrow schema (what
    ``canonical_key_kinds`` expects — fugue Schemas index by name; this
    pyarrow build's ``Schema.__getitem__`` is position-only)."""
    return {n: schema.field(n) for n in schema.names}


class DistSupervisor:
    """Location-transparent job execution over the worker tier."""

    def __init__(
        self,
        root: str,
        engine: Any = None,
        conf: Optional[Dict[str, Any]] = None,
    ):
        from ..constants import (
            FUGUE_TPU_CONF_CACHE_ENABLED,
            FUGUE_TPU_CONF_DIST_BUCKETS,
            FUGUE_TPU_CONF_DIST_ENABLED,
            FUGUE_TPU_CONF_DIST_HB_STALE_S,
            FUGUE_TPU_CONF_DIST_POLL_S,
            FUGUE_TPU_CONF_DIST_SPECULATIVE_AFTER_S,
            FUGUE_TPU_CONF_TUNING_ENABLED,
        )

        from ..execution import NativeExecutionEngine

        if engine is None:
            engine = NativeExecutionEngine(dict(conf or {}))
        self.engine = engine
        # the reduce artifacts are read on the host: a driving engine on
        # the card takes the combined frame once, in the workflow context
        self._host = (
            engine
            if isinstance(engine, NativeExecutionEngine)
            else NativeExecutionEngine(
                {FUGUE_TPU_CONF_CACHE_ENABLED: False, FUGUE_TPU_CONF_TUNING_ENABLED: False}
            )
        )
        # explicit conf overlays the engine's: workflow.run passes its
        # RUN-scoped merge here so workflow-level dist knobs apply without
        # writing through to the engine
        c = dict(engine.conf)
        c.update(dict(conf or {}))
        self.board = TaskBoard(root)
        self.enabled = bool(c.get(FUGUE_TPU_CONF_DIST_ENABLED, True))
        self.default_buckets = int(c.get(FUGUE_TPU_CONF_DIST_BUCKETS, 8))
        self.poll_s = max(0.005, float(c.get(FUGUE_TPU_CONF_DIST_POLL_S, 0.05)))
        self.speculative_after_s = float(
            c.get(FUGUE_TPU_CONF_DIST_SPECULATIVE_AFTER_S, 0.0)
        )
        self.hb_stale_s = float(
            c.get(FUGUE_TPU_CONF_DIST_HB_STALE_S, DEFAULT_STALE_AFTER_S)
        )
        self.stats = DistStats()
        self.retry_policy = RetryPolicy.from_conf(
            c, prefix="fugue.tpu.retry.dist", default_attempts=4
        )
        self.leases = LeaseBoard(
            self.board.leases_dir,
            hb_dir=self.board.hb_dir,
            hb_stale_s=self.hb_stale_s,
        )
        # the supervisor's counters ride its engine's unified registry:
        # engine.stats()["dist"] (with a per-worker breakdown shipped
        # home in heartbeats/done records)
        engine.metrics.register("dist", self.stats)

    # -- planning ------------------------------------------------------------
    def _probe_side(
        self, paths: List[str], fn_blob: Optional[str]
    ) -> Tuple[Dict[str, str], pa.Schema]:
        """Post-map column dtypes + arrow schema of one side, probed on an
        EMPTY typed frame so planning never runs user code over real rows
        (map functions should tolerate empty frames; one that doesn't is
        probed on a small head instead — documented caveat). A function
        that fails BOTH probes degrades to the pre-map schema: planning
        never raises user-code errors — those surface at task time where
        the POISON ladder owns them."""
        sample = read_source_paths(paths[:1])
        fn = load_fn(fn_blob)
        empty = sample.head(0)
        if fn is not None:
            try:
                empty = fn(sample.head(0).copy()).head(0)
            except Exception:
                try:
                    empty = fn(sample.head(8).copy()).head(0)
                except Exception:
                    empty = sample.head(0)
        columns = {c: str(empty[c].dtype) for c in empty.columns}
        return columns, pa.Table.from_pandas(empty, preserve_index=False).schema

    def plan_join_job(
        self,
        left_paths: List[str],
        right_paths: Optional[List[str]],
        keys: List[str],
        reduce_fn: Callable[..., pd.DataFrame],
        combine_fn: Optional[Callable[[List[pd.DataFrame]], pd.DataFrame]] = None,
        map_left: Optional[Callable[[pd.DataFrame], pd.DataFrame]] = None,
        map_right: Optional[Callable[[pd.DataFrame], pd.DataFrame]] = None,
        buckets: Optional[int] = None,
        paths_per_task: int = 1,
        job_id: Optional[str] = None,
    ) -> str:
        """Write one job to the board: per-range map tasks (distributed
        Load) for each side, one reduce task per bucket depending on all
        of them. Returns the job id; workers start the moment specs land.
        The manifest (cloudpickled functions included) persists under
        ``jobs/`` so a restarted supervisor resumes with ``wait_job``."""
        jid = job_id or "j" + _uuid.uuid4().hex[:10]
        n_buckets = int(buckets or self.default_buckets)
        sides: List[Dict[str, Any]] = [
            {"name": "left", "paths": list(left_paths), "fn": dump_fn(map_left)}
        ]
        if right_paths is not None:
            sides.append(
                {"name": "right", "paths": list(right_paths), "fn": dump_fn(map_right)}
            )
        schemas: List[pa.Schema] = []
        for side in sides:
            side["ranges"] = _chunk(side["paths"], paths_per_task)
            side["columns"], schema = self._probe_side(side["paths"], side["fn"])
            schemas.append(schema)
        kinds = canonical_key_kinds(
            _fields(schemas[0]), _fields(schemas[-1]), list(keys)
        )
        if kinds is None:
            raise DistJobError(
                f"join keys {list(keys)} have no canonical hashable dtype "
                "across the sides (decimal/binary/nested, or string vs "
                "numeric) — the distributed exchange cannot co-bucket them"
            )
        reduce_blob = dump_fn(reduce_fn)
        combine_blob = dump_fn(combine_fn or _default_combine)
        map_tids: List[str] = []
        for side in sides:
            tids = []
            for i, rng in enumerate(side["ranges"]):
                tid = f"{jid}-m-{side['name']}-{i:04d}"
                self.board.put_task(
                    tid,
                    {
                        "kind": "map",
                        "job": jid,
                        "paths": rng,
                        "fn": side["fn"],
                        "fp": spec_fingerprint(
                            jid, "map", side["name"], [_file_token(p) for p in rng]
                        ),
                        "shuffle": {
                            "exchange": side["name"],
                            "keys": list(keys),
                            "kinds": kinds,
                            "buckets": n_buckets,
                        },
                        "deps": [],
                    },
                )
                tids.append(tid)
            side["map_tids"] = tids
            map_tids.extend(tids)
        reduce_tids: List[str] = []
        all_columns = {s["name"]: s["columns"] for s in sides}
        for b in range(n_buckets):
            tid = f"{jid}-r-{b:04d}"
            self.board.put_task(
                tid,
                {
                    "kind": "reduce",
                    "job": jid,
                    "bucket": b,
                    "fn": reduce_blob,
                    "columns": all_columns,
                    "exchanges": {
                        s["name"]: {"producers": s["map_tids"]} for s in sides
                    },
                    "fp": spec_fingerprint(jid, "reduce", b, map_tids),
                    "deps": list(map_tids),
                },
            )
            reduce_tids.append(tid)
        self.board.put_job(
            jid,
            {
                "buckets": n_buckets,
                "keys": list(keys),
                "kinds": kinds,
                "sides": [
                    {
                        "name": s["name"],
                        "ranges": s["ranges"],
                        "fn": s["fn"],
                        "map_tids": s["map_tids"],
                        "columns": s["columns"],
                    }
                    for s in sides
                ],
                "reduce_tids": reduce_tids,
                "reduce_fn": reduce_blob,
                "combine": combine_blob,
                "created": time.time(),
            },
        )
        self.stats.inc("jobs")
        self.stats.inc("map_tasks", len(map_tids))
        self.stats.inc("reduce_tasks", len(reduce_tids))
        return jid

    # -- workflow jobs (plan/distribute.py routes through here) --------------
    def plan_workflow_job(
        self,
        left_paths: List[str],
        right_paths: Optional[List[str]],
        keys: List[str],
        reduce_fn: Callable[..., pd.DataFrame],
        combine_fn: Optional[Callable[[List[pd.DataFrame]], pd.DataFrame]] = None,
        map_left: Optional[Callable[[pd.DataFrame], pd.DataFrame]] = None,
        map_right: Optional[Callable[[pd.DataFrame], pd.DataFrame]] = None,
        buckets: Optional[int] = None,
        paths_per_task: int = 1,
        tokens: Optional[Dict[str, str]] = None,
    ) -> Tuple[str, List[str]]:
        """Plan one WORKFLOW fragment as a board job. Identical spec and
        manifest shapes to :meth:`plan_join_job` (so the whole recovery
        ladder, ``wait_job`` and ``audit_job`` apply unchanged), but task
        ids and artifact fps are CONTENT-ADDRESSED — a deterministic
        fingerprint over the fragment's logic token (the planner's
        description of map/reduce steps) and each partition range's file
        tokens (path, size, mtime) instead of a fresh job uuid. A warm
        rerun therefore finds done records already on the board for every
        unchanged partition and delta-skips them: only map tasks over new
        or changed files (and the reduces downstream of the changed map
        set) execute. Returns ``(jid, all_tids)``; the count of reused
        done records lands in ``workflow_partitions_delta_skipped``."""
        toks = dict(tokens or {})
        n_buckets = int(buckets or self.default_buckets)
        sides: List[Dict[str, Any]] = [
            {"name": "left", "paths": list(left_paths), "fn": dump_fn(map_left)}
        ]
        if right_paths is not None:
            sides.append(
                {
                    "name": "right",
                    "paths": list(right_paths),
                    "fn": dump_fn(map_right),
                }
            )
        schemas: List[pa.Schema] = []
        for side in sides:
            side["ranges"] = _chunk(side["paths"], paths_per_task)
            side["columns"], schema = self._probe_side(side["paths"], side["fn"])
            schemas.append(schema)
        kinds = canonical_key_kinds(
            _fields(schemas[0]), _fields(schemas[-1]), list(keys)
        )
        if kinds is None:
            raise DistJobError(
                f"shuffle keys {list(keys)} have no canonical hashable dtype "
                "across the sides — the distributed exchange cannot "
                "co-bucket them"
            )
        reduce_blob = dump_fn(reduce_fn)
        combine_blob = dump_fn(combine_fn or _default_combine)
        reduce_token = toks.get("reduce", "")
        map_tids: List[str] = []
        skipped = 0
        for side in sides:
            side_token = toks.get(side["name"], "")
            tids = []
            for rng in side["ranges"]:
                tid = "wfm-" + spec_fingerprint(
                    "map",
                    side["name"],
                    side_token,
                    list(keys),
                    kinds,
                    n_buckets,
                    [_file_token(p) for p in rng],
                )[:20]
                skipped += int(self.board.read_done(tid) is not None)
                self.board.put_task(
                    tid,
                    {
                        "kind": "map",
                        # fragment rel paths embed the content-addressed
                        # tid, so a constant job dir keeps reruns pointing
                        # at the same (reusable) fragments
                        "job": "wf",
                        "paths": rng,
                        "fn": side["fn"],
                        "fp": spec_fingerprint("wf-map-art", tid),
                        "shuffle": {
                            "exchange": side["name"],
                            "keys": list(keys),
                            "kinds": kinds,
                            "buckets": n_buckets,
                        },
                        "deps": [],
                    },
                )
                tids.append(tid)
            side["map_tids"] = tids
            map_tids.extend(tids)
        reduce_tids: List[str] = []
        all_columns = {s["name"]: s["columns"] for s in sides}
        for b in range(n_buckets):
            tid = "wfr-" + spec_fingerprint(
                "reduce", reduce_token, b, map_tids
            )[:20]
            skipped += int(self.board.read_done(tid) is not None)
            self.board.put_task(
                tid,
                {
                    "kind": "reduce",
                    "job": "wf",
                    "bucket": b,
                    "fn": reduce_blob,
                    "columns": all_columns,
                    "exchanges": {
                        s["name"]: {"producers": s["map_tids"]} for s in sides
                    },
                    "fp": spec_fingerprint("wf-reduce-art", tid),
                    "deps": list(map_tids),
                },
            )
            reduce_tids.append(tid)
        jid = "wfj" + spec_fingerprint(
            reduce_token,
            [toks.get(s["name"], "") for s in sides],
            map_tids,
            reduce_tids,
        )[:16]
        self.board.put_job(
            jid,
            {
                "buckets": n_buckets,
                "keys": list(keys),
                "kinds": kinds,
                "sides": [
                    {
                        "name": s["name"],
                        "ranges": s["ranges"],
                        "fn": s["fn"],
                        "map_tids": s["map_tids"],
                        "columns": s["columns"],
                    }
                    for s in sides
                ],
                "reduce_tids": reduce_tids,
                "reduce_fn": reduce_blob,
                "combine": combine_blob,
                "created": time.time(),
            },
        )
        all_tids = map_tids + reduce_tids
        self.stats.inc("jobs")
        self.stats.inc("map_tasks", len(map_tids))
        self.stats.inc("reduce_tasks", len(reduce_tids))
        self.stats.inc("workflow_jobs")
        self.stats.inc("workflow_tasks_dispatched", len(all_tids) - skipped)
        self.stats.inc("workflow_partitions_delta_skipped", skipped)
        return jid, all_tids

    def run_workflow_job(
        self,
        left_paths: List[str],
        right_paths: Optional[List[str]],
        keys: List[str],
        reduce_fn: Callable[..., pd.DataFrame],
        *,
        combine_fn: Optional[Callable[[List[pd.DataFrame]], pd.DataFrame]] = None,
        map_left: Optional[Callable[[pd.DataFrame], pd.DataFrame]] = None,
        map_right: Optional[Callable[[pd.DataFrame], pd.DataFrame]] = None,
        buckets: Optional[int] = None,
        paths_per_task: int = 1,
        tokens: Optional[Dict[str, str]] = None,
        timeout: Optional[float] = None,
    ) -> pd.DataFrame:
        """One workflow fragment end to end: plan (content-addressed,
        delta-skipping) + wait, with the job's recovery activity
        attributed to the ``workflow_*`` counters. The kill-switch
        (``fugue.tpu.dist.enabled=false``) runs the identical plan
        serially in this process — bit-identical by construction."""
        if not self.enabled:
            return self._run_serial(
                left_paths,
                right_paths,
                keys,
                reduce_fn,
                combine_fn=combine_fn,
                map_left=map_left,
                map_right=map_right,
                buckets=buckets,
                paths_per_task=paths_per_task,
            )
        before = self.stats.as_dict()
        jid, all_tids = self.plan_workflow_job(
            left_paths,
            right_paths,
            keys,
            reduce_fn,
            combine_fn=combine_fn,
            map_left=map_left,
            map_right=map_right,
            buckets=buckets,
            paths_per_task=paths_per_task,
            tokens=tokens,
        )
        fails_before = sum(
            1
            for t in all_tids
            for f in self.board.failures(t)
            if f.get("category") != "poison"
        )
        try:
            return self.wait_job(jid, timeout=timeout)
        finally:
            self._account_workflow(all_tids, before, fails_before)

    def _account_workflow(
        self,
        tids: List[str],
        before: Dict[str, Any],
        fails_before: int,
    ) -> None:
        """Fold the recovery activity observed while a workflow job was
        in flight into the workflow counters (before/after deltas over
        the folded supervisor+worker totals — attributed to the observing
        job, approximate only when unrelated jobs share the supervisor)."""
        after = self.stats.as_dict()

        def total(d: Dict[str, Any], name: str, fold_workers: bool) -> int:
            t = int(d.get(name, 0) or 0)
            if fold_workers:
                for w in (d.get("workers") or {}).values():
                    t += int(w.get(name, 0) or 0)
            return t

        for counter, name, fold in (
            # steal classification is already folded into the redispatch
            # totals by as_dict; orphan/speculative need the worker fold
            ("workflow_tasks_stolen", "redispatch_worker_lost", False),
            ("workflow_tasks_stolen", "redispatch_transient", False),
            ("workflow_fragments_invalidated", "orphaned_outputs_recovered", True),
            ("workflow_tasks_speculative", "speculative_marks", True),
        ):
            d = total(after, name, fold) - total(before, name, fold)
            if d > 0:
                self.stats.inc(counter, d)
        fails_now = sum(
            1
            for t in tids
            for f in self.board.failures(t)
            if f.get("category") != "poison"
        )
        if fails_now > fails_before:
            self.stats.inc(
                "workflow_tasks_re_dispatched", fails_now - fails_before
            )

    # -- monitoring / recovery ----------------------------------------------
    def _abort(self, jid: str, why: str, tids: List[str]) -> None:
        report = {
            t: [f"{r['category']}: {r['error']}" for r in self.board.failures(t)]
            for t in tids
            if self.board.failures(t)
        }
        self.stats.inc("jobs_failed")
        raise DistJobError(f"dist job {jid} failed: {why}", report)

    def _watch_once(self, jid: str, tids: List[str]) -> None:
        """One monitoring pass: bound failures, mark stragglers
        speculative. (Re-dispatch classification happens at the steal
        site, inside whichever worker's LeaseBoard stole the lease, and
        ships home in its counters — a fast steal between two supervisor
        polls is never missed.)"""
        now = time.time()
        for tid in tids:
            if self.board.read_done(tid) is not None:
                continue
            fails = self.board.failures(tid)
            poison = [f for f in fails if f.get("category") == "poison"]
            if poison:
                self._abort(
                    jid, f"task {tid} failed deterministically (poison)", tids
                )
            if len(fails) >= self.retry_policy.max_attempts:
                self._abort(
                    jid,
                    f"task {tid} exhausted {len(fails)} attempts "
                    f"(max {self.retry_policy.max_attempts})",
                    tids,
                )
            lease = self.leases.read(tid)
            if lease is None:
                continue
            if (
                self.speculative_after_s > 0
                and not self.board.is_speculative(tid)
                and not self.leases.stealable(lease)
            ):
                acquired = float(lease.get("acquired_ts", lease.get("ts", now)))
                if now - acquired > self.speculative_after_s:
                    if self.board.mark_speculative(tid):
                        self.stats.inc("speculative_marks")
                        get_event_log().emit(
                            "task.speculative",
                            task=tid,
                            holder=lease.get("owner"),
                            held_s=round(now - acquired, 3),
                        )

    def wait_job(self, jid: str, timeout: Optional[float] = None) -> pd.DataFrame:
        """Block until every reduce task is done, then combine their
        artifacts (in bucket order). Safe to call from a RESTARTED
        supervisor: all job state — manifest, specs, leases, done
        records — lives on the board, so in-flight leases simply
        continue (or expire and re-dispatch) under the new watcher."""
        from ..cache.store import ArtifactStore
        from ..obs import get_tracer

        manifest = self.board.read_job(jid)
        if manifest is None:
            raise DistJobError(f"unknown dist job {jid!r} (no manifest)")
        reduce_tids: List[str] = manifest["reduce_tids"]
        all_tids = [
            t for s in manifest["sides"] for t in s["map_tids"]
        ] + reduce_tids
        deadline = None if timeout is None else time.monotonic() + timeout
        store = ArtifactStore(self.board.store_dir, cap_bytes=0)
        tracer = get_tracer()
        with tracer.span("dist.job", cat="dist", job=jid, tasks=len(all_tids)):
            while True:
                while self.board.done_count(reduce_tids) < len(reduce_tids):
                    self._watch_once(jid, all_tids)
                    if deadline is not None and time.monotonic() > deadline:
                        self._abort(
                            jid, f"timed out after {timeout}s", all_tids
                        )
                    time.sleep(self.poll_s)
                partials: List[pd.DataFrame] = []
                missing = None
                for tid in reduce_tids:
                    rec = self.board.read_done(tid)
                    if rec is None:
                        missing = tid
                        break
                    loaded = store.load(rec["fp"], self._host)
                    if loaded is None:
                        # torn/evicted artifact: recovery ladder rung 3 —
                        # invalidate and let a live worker re-produce it
                        self.board.invalidate_done(tid)
                        self.stats.inc("orphaned_outputs_recovered")
                        get_event_log().emit(
                            "task.orphan",
                            task=tid,
                            why="torn/evicted reduce artifact",
                            producer=rec.get("worker"),
                        )
                        missing = tid
                        break
                    partials.append(loaded[0].as_pandas())
                if missing is None:
                    break
        # fold worker-shipped counters home from BOTH channels — map/
        # reduce done records and the latest heartbeats. Counters are
        # monotonic and note_worker merges by max, so channel lag (a
        # GIL-starved beat thread) can never under-report
        for tid in all_tids:
            rec = self.board.read_done(tid)
            if rec is not None:
                self._ingest_done(rec, tracer)
        for name in os.listdir(self.board.hb_dir):
            if name.endswith(".hb.json"):
                hb = read_heartbeat(self.board.hb_dir, name[: -len(".hb.json")])
                if hb is not None and isinstance(hb.get("stats"), dict):
                    self.stats.note_worker(str(hb.get("name")), hb["stats"])
        combine = load_fn(manifest["combine"]) or _default_combine
        self.stats.inc("tasks_completed", len(all_tids))
        return combine(partials)

    def _ingest_done(self, rec: Dict[str, Any], tracer: Any) -> None:
        """Worker-shipped observability, the fork-worker protocol shape:
        spans ingest into this process's tracer, counters land in the
        per-worker breakdown of ``engine.stats()["dist"]``."""
        spans = rec.get("spans")
        if spans and tracer.enabled:
            # an IN-process worker (thread-pool tests, single-host runs)
            # shares this tracer and already emitted its spans — only
            # foreign PROCESSES' records are new information. Identity is
            # host+pid (proc_ident): a bare pid match would wrongly drop a
            # remote host's spans that happen to share this pid
            me = proc_ident()
            spans = [
                s for s in spans if (s.get("proc") or s.get("pid")) not in (me, os.getpid())
            ]
            tracer.ingest(spans)
        m = rec.get("metrics")
        if (
            isinstance(m, dict)
            and m.get("delta")
            and m.get("proc") not in (proc_ident(), None)
        ):
            # metrics federation: a remote worker's span-
            # histogram delta merges into this process's families with the
            # associative encoding — its /metrics covers the fleet.
            # An in-process worker shares these families (its proc is
            # ours) and is skipped: its observations already landed.
            from ..obs import get_span_metrics

            get_span_metrics().merge(m["delta"])
        if isinstance(rec.get("stats"), dict) and rec.get("worker"):
            self.stats.note_worker(str(rec["worker"]), rec["stats"])

    def run_join_job(self, *args: Any, timeout: Optional[float] = None, **kwargs: Any) -> pd.DataFrame:
        """Plan + wait — or, with ``fugue.tpu.dist.enabled=false``, run
        the identical job serially in this process (bit-identical)."""
        if not self.enabled:
            return self._run_serial(*args, **kwargs)
        jid = self.plan_join_job(*args, **kwargs)
        return self.wait_job(jid, timeout=timeout)

    # -- the kill-switch path ------------------------------------------------
    def _run_serial(
        self,
        left_paths: List[str],
        right_paths: Optional[List[str]],
        keys: List[str],
        reduce_fn: Callable[..., pd.DataFrame],
        combine_fn: Optional[Callable[[List[pd.DataFrame]], pd.DataFrame]] = None,
        map_left: Optional[Callable[[pd.DataFrame], pd.DataFrame]] = None,
        map_right: Optional[Callable[[pd.DataFrame], pd.DataFrame]] = None,
        buckets: Optional[int] = None,
        paths_per_task: int = 1,
        job_id: Optional[str] = None,
    ) -> pd.DataFrame:
        """Single-process execution of the SAME plan: same per-range map
        application, same hash bucketing, same per-bucket reduce in the
        same bucket order, same combine — so the distributed result is
        bit-identical to this one whenever the job functions are
        partition-local (the distributed contract)."""
        import numpy as np

        n_buckets = int(buckets or self.default_buckets)
        sides = [("left", left_paths, map_left)]
        if right_paths is not None:
            sides.append(("right", right_paths, map_right))
        probed: List[Tuple[List[pa.Table], List[Any], Dict[str, str]]] = []
        schemas: List[pa.Schema] = []
        for _name, paths, fn in sides:
            frames = [apply_map(rng, fn) for rng in _chunk(paths, paths_per_task)]
            tbls = [
                pa.Table.from_pandas(f, preserve_index=False) for f in frames
            ]
            columns = (
                {c: str(frames[0][c].dtype) for c in frames[0].columns}
                if frames
                else {}
            )
            probed.append((tbls, frames, columns))
            schemas.append(
                tbls[0].schema if tbls else pa.schema([])
            )
        kinds = canonical_key_kinds(
            _fields(schemas[0]), _fields(schemas[-1]), list(keys)
        )
        if kinds is None:
            raise DistJobError(
                f"join keys {list(keys)} have no canonical hashable dtype"
            )
        ids_per_side = [
            [bucket_ids(t, list(keys), kinds, n_buckets) for t in tbls]
            for tbls, _f, _c in probed
        ]
        partials: List[pd.DataFrame] = []
        for b in range(n_buckets):
            inputs: List[pd.DataFrame] = []
            for (tbls, _frames, columns), ids_list in zip(probed, ids_per_side):
                picked: List[pd.DataFrame] = []
                for tbl, ids in zip(tbls, ids_list):
                    (sel,) = np.nonzero(ids == b)
                    if len(sel) == 0:
                        continue
                    picked.append(
                        tbl.take(pa.array(sel, type=pa.int64())).to_pandas()
                    )
                if picked:
                    pdf = (
                        picked[0].reset_index(drop=True)
                        if len(picked) == 1
                        else pd.concat(picked, ignore_index=True)
                    )
                else:
                    pdf = _empty_frame(columns)
                inputs.append(pdf)
            partials.append(reduce_fn(*inputs).reset_index(drop=True))
        return (combine_fn or _default_combine)(partials)

    # -- the artifact/bucket audit -------------------------------------------
    def audit_job(self, jid: str) -> Dict[str, Any]:
        """Zero-lost / zero-double-counted proof over the shuffle: every
        row a (current) map done record declared into a bucket was
        consumed by that bucket's reduce exactly once. Run AFTER the job
        completes; the chaos gate fails on any nonzero loss/double."""
        manifest = self.board.read_job(jid)
        if manifest is None:
            raise DistJobError(f"unknown dist job {jid!r} (no manifest)")
        declared: Dict[Tuple[str, str, int], int] = {}
        for side in manifest["sides"]:
            for tid in side["map_tids"]:
                rec = self.board.read_done(tid)
                if rec is None:
                    continue
                for b, frag in (rec.get("fragments") or {}).items():
                    declared[(side["name"], tid, int(b))] = int(frag["rows"])
        consumed: Dict[Tuple[str, str, int], int] = {}
        reduces_done = 0
        for tid in manifest["reduce_tids"]:
            rec = self.board.read_done(tid)
            if rec is None:
                continue
            reduces_done += 1
            b = int(self.board.read_task(tid)["bucket"])
            for sname, per_prod in (rec.get("consumed") or {}).items():
                for ptid, rows in per_prod.items():
                    if int(rows) > 0:
                        consumed[(sname, ptid, b)] = (
                            consumed.get((sname, ptid, b), 0) + int(rows)
                        )
        lost = double = 0
        for key, rows in declared.items():
            got = consumed.get(key, 0)
            lost += max(0, rows - got)
            double += max(0, got - rows)
        for key, got in consumed.items():
            if key not in declared:
                double += got
        return {
            "map_done": sum(
                1
                for s in manifest["sides"]
                for t in s["map_tids"]
                if self.board.read_done(t) is not None
            ),
            "reduce_done": reduces_done,
            "fragments_declared": len(declared),
            "rows_declared": sum(declared.values()),
            "rows_consumed": sum(consumed.values()),
            "rows_lost": lost,
            "rows_double_counted": double,
        }
