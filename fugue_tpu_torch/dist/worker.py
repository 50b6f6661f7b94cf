"""One worker of the distributed tier, copied from
``fugue_tpu/dist/worker.py``: lease → execute → publish.

A :class:`DistWorker` is a standalone host engine process (its own
:class:`~fugue_tpu_torch.execution.NativeExecutionEngine`, its own HTTP
surface; it never touches a card) that pulls work from the shared
:class:`~fugue_tpu_torch.dist.board.TaskBoard`:

- scan for runnable tasks (spec present, no done record, deps done),
- acquire the task lease (:mod:`.lease`; renewed at ``lease_s/3`` while
  the task body runs, so only a dead/wedged owner's lease expires),
- execute — **map** tasks read a partition range of source files, apply
  the job's row-local function and hash-split the rows into per-bucket
  arrow-IPC *fragments* under this worker's own data dir (the
  exchange, network-partitioned); **reduce** tasks gather one bucket's
  fragments from every producer (local read or HTTP ``/dist/fetch`` from
  the producer's server), run the job's reduce function, and publish the
  output as a content-addressed artifact in the SHARED store — so
  any worker (and the supervisor) can serve any other's output,
- publish the done record **first-wins** (``O_CREAT|O_EXCL``): a
  speculative twin or a steal racer that finishes second loses the
  record, and its artifact publishes were already deduped by content
  address — at-least-once execution, exactly-once observation.

Failure ladder (the resilience taxonomy, ``resilience/policy.py``): an attempt that
raises records a failure (category attached) and releases the lease —
TRANSIENT/TIMEOUT/WORKER_LOST re-dispatch to any live worker, POISON
aborts the job at the supervisor. A fragment that cannot be fetched
(producer SIGKILLed, torn file) is *orphaned-output recovery*: the
consumer deletes the producer's done record — re-running it on a live
worker — and retries, extending the torn-bucket recovery to the
remote-fetch path.

``python -m fugue_tpu_torch.dist.worker --root <board> --id w0`` runs one
(``--conf '<json>'`` overrides, ``--stop-file <path>`` ends it). Start it
as a fresh interpreter, never by forking a process that holds a CUDA
context.
"""

import argparse
import http.client
import io
import json
import os
import sys
import time
import threading
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

import pandas as pd
import pyarrow as pa

from ..obs.events import get_event_log
from ..resilience import (
    SITE_DIST_BOARD,
    SITE_DIST_LEASE,
    Deadline,
    FailureCategory,
    FaultInjector,
    RetryPolicy,
    WorkerLostError,
    classify_failure,
)
from ..shuffle.partitioner import bucket_ids
from ..workflow._checkpoint import _atomic_publish, _best_effort_remove
from .board import TaskBoard, load_fn
from .heartbeat import (
    DEFAULT_INTERVAL_S,
    DEFAULT_STALE_AFTER_S,
    HeartbeatWriter,
    holder_alive,
)
from .lease import LeaseBoard
from .stats import DistStats

__all__ = ["DistWorker", "BucketUnavailableError", "read_source_paths", "apply_map"]


class BucketUnavailableError(ConnectionError):
    """A shuffle fragment could not be served by its producer (dead
    worker, torn file). Subclasses ConnectionError so the resilience taxonomy
    classifies it TRANSIENT — the attempt is re-dispatched after the
    producer's done record was invalidated for re-execution."""


def read_source_paths(paths: List[str]) -> pd.DataFrame:
    """One partition range of source files → one pandas frame (format by
    extension, concatenated in path order — the same order a
    single-process load would read them)."""
    frames: List[pd.DataFrame] = []
    for p in paths:
        ext = os.path.splitext(p)[1].lower()
        if ext in (".parquet", ".pq"):
            frames.append(pd.read_parquet(p))
        elif ext == ".csv":
            frames.append(pd.read_csv(p))
        elif ext == ".json":
            frames.append(pd.read_json(p, lines=True))
        else:
            raise ValueError(f"unsupported source extension {ext!r} ({p})")
    if not frames:
        return pd.DataFrame()
    if len(frames) == 1:
        return frames[0].reset_index(drop=True)
    return pd.concat(frames, ignore_index=True)


def apply_map(paths: List[str], fn: Any) -> pd.DataFrame:
    """The map-task body shared VERBATIM by workers and the supervisor's
    serial (kill-switch) path — bit-identity between the two is by
    construction, not by parallel maintenance."""
    pdf = read_source_paths(paths)
    if fn is not None:
        pdf = fn(pdf)
        if not isinstance(pdf, pd.DataFrame):
            raise TypeError(
                f"dist map function must return a pandas DataFrame, got "
                f"{type(pdf).__name__}"
            )
        pdf = pdf.reset_index(drop=True)
    return pdf


def _empty_frame(columns: Optional[Dict[str, str]]) -> pd.DataFrame:
    if not columns:
        return pd.DataFrame()
    import numpy as np

    return pd.DataFrame(
        {c: pd.Series(dtype=np.dtype(d)) for c, d in columns.items()}
    )


class _LeaseKeeper:
    """Renews one lease at ``lease_s/3`` while the task body runs."""

    def __init__(self, leases: LeaseBoard, lease_id: str, owner: str, lease_s: float):
        self._leases = leases
        self._lease_id = lease_id
        self._owner = owner
        self._lease_s = lease_s
        self._stop = threading.Event()
        self.lost = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        period = max(0.05, self._lease_s / 3.0)
        while not self._stop.wait(period):
            if not self._leases.renew(self._lease_id, self._owner, self._lease_s):
                self.lost.set()
                return

    def start(self) -> "_LeaseKeeper":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


class DistWorker:
    """One engine process of the worker tier."""

    def __init__(
        self,
        root: str,
        worker_id: str,
        conf: Optional[Dict[str, Any]] = None,
        start_http: bool = True,
    ):
        from ..constants import (
            FUGUE_TPU_CONF_DIST_FETCH,
            FUGUE_TPU_CONF_DIST_FETCH_PREFETCH_DEPTH,
            FUGUE_TPU_CONF_DIST_HB_INTERVAL_S,
            FUGUE_TPU_CONF_DIST_HB_STALE_S,
            FUGUE_TPU_CONF_DIST_LEASE_S,
            FUGUE_TPU_CONF_DIST_POLL_S,
            FUGUE_TPU_CONF_TRACE_SPOOL_DIR,
        )
        from ..execution import NativeExecutionEngine

        self.worker_id = worker_id
        self.board = TaskBoard(root)
        self.engine = NativeExecutionEngine(dict(conf or {}))
        c = self.engine.conf
        # cluster tracing: with a spool dir configured, every
        # task attempt ends with an atomic publish of this worker's whole
        # span buffer + sampler ring to <spool>/<host>-<pid>.spool.json
        self.spool_dir = str(c.get(FUGUE_TPU_CONF_TRACE_SPOOL_DIR, ""))
        self.lease_s = float(c.get(FUGUE_TPU_CONF_DIST_LEASE_S, 15.0))
        self.poll_s = max(0.005, float(c.get(FUGUE_TPU_CONF_DIST_POLL_S, 0.05)))
        self.fetch_mode = str(c.get(FUGUE_TPU_CONF_DIST_FETCH, "auto"))
        # reduce-side fragment prefetch: fetch of
        # fragment i+1 (HTTP /dist/fetch or local read) overlaps the
        # decode+reduce of fragment i; <=0 restores serial fetches
        self.fetch_prefetch_depth = int(
            c.get(FUGUE_TPU_CONF_DIST_FETCH_PREFETCH_DEPTH, 2)
        )
        hb_interval = float(
            c.get(FUGUE_TPU_CONF_DIST_HB_INTERVAL_S, DEFAULT_INTERVAL_S)
        )
        self.hb_stale_s = float(
            c.get(FUGUE_TPU_CONF_DIST_HB_STALE_S, DEFAULT_STALE_AFTER_S)
        )
        self.stats = DistStats()
        self._injector = FaultInjector.from_conf(c)
        self.retry_policy = RetryPolicy.from_conf(
            c, prefix="fugue.tpu.retry.dist", default_attempts=4
        )
        from ..constants import FUGUE_TPU_CONF_RETRY_DIST_DEADLINE_S

        # wall-clock budget across ALL attempts of one fragment fetch;
        # <=0/unset = unbounded (the attempt budget alone bounds it)
        self.fetch_deadline_s = float(
            c.get(FUGUE_TPU_CONF_RETRY_DIST_DEADLINE_S, 20.0)
        )
        self.leases = LeaseBoard(
            self.board.leases_dir,
            hb_dir=self.board.hb_dir,
            hb_stale_s=self.hb_stale_s,
            stats=self.stats,
        )
        self.data_dir = self.board.worker_data_dir(worker_id)
        self._addr: Optional[List[Any]] = None
        self._rpc: Any = None
        self._start_http = start_http
        self.heartbeat = HeartbeatWriter(
            self.board.hb_dir,
            worker_id,
            interval_s=hb_interval,
            extra=self._hb_extra,
            injector=self._injector,
            log=self.engine.log,
        )
        # the engine's unified registry carries the worker's own counters
        # (scrapeable over this worker's /metrics like any engine source)
        self.engine.metrics.register("dist", self.stats)

    def _hb_extra(self) -> Dict[str, Any]:
        # the heartbeat doubles as the ship-home channel for worker
        # metrics: the supervisor reads liveness AND counters in one file
        return {"addr": self._addr, "stats": self.stats.as_dict()}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DistWorker":
        if self._start_http and self._rpc is None:
            from ..rpc.http import HttpRPCServer

            self._rpc = HttpRPCServer(self.engine.conf)
            self._rpc.start_server()
            self._rpc.bind_engine(self.engine)
            self._rpc.bind_dist(self)
            self._addr = [self._rpc.host, self._rpc.port]
        self.heartbeat.start()
        return self

    def stop(self) -> None:
        self.heartbeat.stop(remove=True)
        if self._rpc is not None:
            self._rpc.stop_server()
            self._rpc = None

    @property
    def addr(self) -> Optional[List[Any]]:
        return self._addr

    # -- the /dist/fetch surface (rpc/http.py binds this) --------------------
    def read_blob(self, rel: str) -> Optional[bytes]:
        """Bytes of one file under THIS worker's data dir, or None. The
        path is jailed to the data dir — the fetch route can never serve
        an arbitrary host file."""
        full = os.path.realpath(os.path.join(self.data_dir, rel))
        base = os.path.realpath(self.data_dir)
        if not full.startswith(base + os.sep):
            return None
        try:
            with open(full, "rb") as f:
                return f.read()
        except OSError:
            return None

    # -- the scan loop -------------------------------------------------------
    def _deps_done(self, spec: Dict[str, Any]) -> bool:
        return all(
            self.board.read_done(d) is not None for d in spec.get("deps", ())
        )

    def _exhausted(self, tid: str) -> bool:
        """A task no live worker should touch again: a POISON failure
        (deterministic — retrying wastes time, the supervisor aborts the
        job) or the retry budget spent."""
        fails = self.board.failures(tid)
        if any(f.get("category") == FailureCategory.POISON.value for f in fails):
            return True
        return len(fails) >= self.retry_policy.max_attempts

    def poll_once(self) -> bool:
        """One scan over the board; True when a task was attempted."""
        for tid in self.board.list_tasks():
            if self.board.read_done(tid) is not None:
                continue
            spec = self.board.read_task(tid)
            if spec is None or not self._deps_done(spec):
                continue
            if self._exhausted(tid):
                continue
            holder = self.leases.read(tid)
            if (
                holder is not None
                and holder.get("owner") != self.worker_id
                and not self.leases.stealable(holder)
            ):
                # a live owner holds it — volunteer as the speculative
                # twin only when the supervisor marked it a straggler
                if self.board.is_speculative(tid):
                    if self.run_task(tid, speculative=True):
                        return True
                continue
            if self.run_task(tid):
                return True
        return False

    def serve_forever(self, stop_file: Optional[str] = None) -> None:
        while True:
            if stop_file is not None and os.path.exists(stop_file):
                return
            if not self.poll_once():
                time.sleep(self.poll_s)

    # -- task execution ------------------------------------------------------
    def run_task(self, tid: str, speculative: bool = False) -> bool:
        """Lease → execute → first-wins publish. False when the lease was
        not acquired or the attempt failed (failure recorded; a live
        worker — possibly this one — retries on a later scan)."""
        from contextlib import nullcontext

        from ..obs import get_tracer, trace_scope

        spec = self.board.read_task(tid)
        if spec is None:
            return False
        lease_id = f"{tid}.spec" if speculative else tid
        prev_holder = self.leases.read(lease_id)
        owned, _holder = self.leases.try_acquire(
            lease_id, self.worker_id, self.lease_s
        )
        if not owned:
            return False
        # categorized re-dispatch record (flight recorder): this attempt
        # follows a steal (previous holder displaced) or a recorded failure
        stolen = prev_holder is not None and prev_holder.get("owner") not in (
            None,
            self.worker_id,
        )
        n_fails = len(self.board.failures(tid))
        if stolen or n_fails > 0:
            get_event_log().emit(
                "task.redispatch",
                task=tid,
                owner=self.worker_id,
                reason="stolen" if stolen else "failed_retry",
                attempts=n_fails,
                trace=(spec.get("trace") or {}).get("trace"),
            )
        keeper = _LeaseKeeper(
            self.leases, lease_id, self.worker_id, self.lease_s
        ).start()
        tracer = get_tracer()
        # adopt the submitting run's trace context carried on the spec:
        # this task's spans land under the run's trace id, parented on the
        # supervisor-side dist.job span instead of floating as local roots
        carrier = spec.get("trace") or {}
        tctx = (
            trace_scope(carrier.get("trace"), carrier.get("parent"))
            if (tracer.enabled and carrier)
            else nullcontext()
        )
        try:
            # the dist.lease fault site sits between lease acquisition
            # and the task body: an `error` rule unwinds through the
            # release below (TRANSIENT re-dispatch), a `kill` leaves an
            # orphaned lease for a live worker to steal
            self._injector.fire(SITE_DIST_LEASE)
            mark = tracer.mark() if tracer.enabled else 0
            msnap = None
            if tracer.enabled:
                from ..obs import get_span_metrics

                msnap = get_span_metrics().snapshot()
            t0 = time.time()
            with tctx, tracer.span(
                "dist.task",
                cat="dist",
                task=tid,
                kind=spec.get("kind", "?"),
                worker=self.worker_id,
                speculative=speculative,
            ):
                payload = self._execute(spec)
            payload.update(
                worker=self.worker_id,
                addr=self._addr,
                data_dir=self.data_dir,
                speculative=speculative,
                ts0=t0,
                ts1=time.time(),
            )
            if carrier.get("trace"):
                payload["trace"] = carrier["trace"]
            if tracer.enabled:
                # ship spans home like fork workers do: the supervisor
                # ingests these when it collects the done record
                payload["spans"] = tracer.take_since(mark)
                # … and the span-HISTOGRAM delta (metrics
                # federation): the supervisor's /metrics then covers remote
                # task latencies too. Keyed by proc identity so an
                # in-process worker's delta is never merged twice.
                from ..obs import get_span_metrics, proc_ident

                delta = get_span_metrics().delta_since(msnap or {})
                if delta:
                    payload["metrics"] = {"proc": proc_ident(), "delta": delta}
            payload["stats"] = self.stats.as_dict()
            # the dist.board fault site sits in the torn-publish window:
            # every output is already durable (fragments / artifact) but
            # the done record is not yet on the board — `kill` here leaves
            # orphaned outputs for the steal + invalidation ladder to
            # cover, `error` unwinds to a TRANSIENT re-dispatch whose
            # re-publishes dedup by content address
            self._injector.fire(SITE_DIST_BOARD)
            won = self.board.publish_done(tid, payload)
            self.stats.inc("tasks_completed")
            if speculative:
                self.stats.inc(
                    "speculative_wins" if won else "speculative_losses"
                )
            elif not won:
                self.stats.inc("duplicate_publishes")
            return True
        except BaseException as e:
            cat = classify_failure(e)
            self.board.record_failure(
                tid, self.worker_id, cat.value, f"{type(e).__name__}: {e}"
            )
            get_event_log().emit(
                "task.failed",
                task=tid,
                worker=self.worker_id,
                category=cat.value,
                error=f"{type(e).__name__}: {e}"[:200],
                trace=carrier.get("trace"),
            )
            self.stats.inc("tasks_failed")
            if cat is FailureCategory.FATAL:
                raise
            return False
        finally:
            keeper.stop()
            self.leases.release(lease_id, self.worker_id)
            self._maybe_publish_spool(tracer)

    def _maybe_publish_spool(self, tracer: Any) -> None:
        """Atomic publish of this worker's span buffer + sampler ring +
        stats to the shared spool (cluster tracing); best-effort — a full
        disk must not fail the task that already published its result."""
        if not self.spool_dir or not tracer.enabled:
            return
        try:
            from ..obs import publish_spool

            publish_spool(
                self.spool_dir,
                stats=self.stats.as_dict(),
                label=f"worker {self.worker_id}",
            )
        except Exception as ex:
            self.engine.log.warning("span spool publish failed: %s", ex)

    def _execute(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        kind = spec.get("kind")
        if kind == "map":
            return self._execute_map(spec)
        if kind == "reduce":
            return self._execute_reduce(spec)
        raise ValueError(f"unknown dist task kind {kind!r}")

    # -- map: partition range → bucket fragments (or an artifact) ------------
    def _execute_map(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        pdf = apply_map(spec["paths"], load_fn(spec.get("fn")))
        self.stats.inc("rows_in", len(pdf))
        shuffle = spec.get("shuffle")
        if not shuffle:
            fp = spec["fp"]
            self._publish_artifact(fp, pdf)
            return {"kind": "map", "fp": fp, "rows_out": len(pdf)}
        tbl = pa.Table.from_pandas(pdf, preserve_index=False)
        n_buckets = int(shuffle["buckets"])
        ids = bucket_ids(tbl, shuffle["keys"], shuffle["kinds"], n_buckets)
        frag_dir = os.path.join(
            "shuffle", str(spec.get("job", "job")), str(shuffle["exchange"])
        )
        os.makedirs(os.path.join(self.data_dir, frag_dir), exist_ok=True)
        import numpy as np

        fragments: Dict[str, Dict[str, Any]] = {}
        for b in range(n_buckets):
            (sel,) = np.nonzero(ids == b)
            if len(sel) == 0:
                continue
            part = tbl.take(pa.array(sel, type=pa.int64()))
            rel = os.path.join(frag_dir, f"b{b:04d}_{spec['id']}.arrow")
            final = os.path.join(self.data_dir, rel)
            tmp = final + ".tmp"
            with pa.OSFile(tmp, "wb") as sink:
                with pa.ipc.new_stream(sink, tbl.schema) as writer:
                    writer.write_table(part)
            _atomic_publish(tmp, final)
            fragments[str(b)] = {"rel": rel, "rows": int(part.num_rows)}
            self.stats.inc("fragments_written")
        return {
            "kind": "map",
            "fragments": fragments,
            "rows_out": int(tbl.num_rows),
        }

    # -- reduce: gather one bucket from every producer, reduce, publish ------
    def _execute_reduce(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        bucket = int(spec["bucket"])
        fn = load_fn(spec["fn"])
        columns = spec.get("columns", {})
        sides: List[pd.DataFrame] = []
        consumed: Dict[str, Dict[str, int]] = {}
        remote = local = 0
        for side, ex in spec["exchanges"].items():
            frames: List[pd.DataFrame] = []
            consumed[side] = {}
            # fragment fetches flow through the stream prefetcher: the
            # producer thread pulls fragment i+1 over /dist/fetch (or
            # reads it locally) while this thread decodes and reduces
            # fragment i — network wait overlaps reduce compute. Fetch
            # failures (BucketUnavailableError and friends) re-raise
            # here with their original traceback; depth<=0 is the serial
            # pre-pipeline shape. (``execution/prefetch.py`` imports no
            # torch: a worker process never does.)
            from ..execution.prefetch import maybe_prefetch

            def fetch(producers: List[str]) -> Any:
                for ptid in producers:
                    rec = self.board.read_done(ptid)
                    if rec is None:
                        # the producer was invalidated after our dep
                        # check — transient by definition, re-scan will
                        # wait on it
                        raise BucketUnavailableError(
                            f"producer {ptid} has no done record "
                            "(invalidated mid-read); re-dispatching"
                        )
                    frag = (rec.get("fragments") or {}).get(str(bucket))
                    if frag is None:
                        yield ptid, None, False
                        continue
                    tbl, was_remote = self._fetch_fragment(rec, frag, ptid)
                    yield ptid, tbl, was_remote

            it = maybe_prefetch(
                fetch(list(ex["producers"])),
                self.fetch_prefetch_depth,
                verb="dist.fetch",
            )
            try:
                for ptid, tbl, was_remote in it:
                    if tbl is None:
                        consumed[side][ptid] = 0
                        continue
                    frames.append(tbl.to_pandas())
                    consumed[side][ptid] = int(tbl.num_rows)
                    remote += int(was_remote)
                    local += int(not was_remote)
            finally:
                it.close()
            if frames:
                pdf = (
                    frames[0].reset_index(drop=True)
                    if len(frames) == 1
                    else pd.concat(frames, ignore_index=True)
                )
            else:
                pdf = _empty_frame(columns.get(side))
            sides.append(pdf)
        self.stats.inc("fragments_local", local)
        self.stats.inc("fragments_remote", remote)
        out = fn(*sides)
        if not isinstance(out, pd.DataFrame):
            raise TypeError(
                "dist reduce function must return a pandas DataFrame, got "
                f"{type(out).__name__}"
            )
        out = out.reset_index(drop=True)
        fp = spec["fp"]
        self._publish_artifact(fp, out)
        self.stats.inc("rows_out", len(out))
        return {
            "kind": "reduce",
            "fp": fp,
            "rows_out": len(out),
            "consumed": consumed,
            "remote_fetches": remote,
            "local_reads": local,
        }

    def _publish_artifact(self, fp: str, pdf: pd.DataFrame) -> None:
        """Content-addressed publish to the SHARED store: speculative
        twins and steal re-runs compute the same fp, so the second
        publish is a no-op (``exists`` short-circuits) and racing renames
        both land a complete identical artifact."""
        from ..cache.store import ArtifactStore

        store = ArtifactStore(self.board.store_dir, cap_bytes=0)
        edf = self.engine.to_df(pdf)
        written = store.publish(fp, edf, self.engine, str(edf.schema))
        if written > 0:
            self.stats.inc("artifacts_published")

    # -- fragment fetch (local / remote, with orphan recovery) ---------------
    def _fetch_fragment(
        self, rec: Dict[str, Any], frag: Dict[str, Any], ptid: str
    ) -> Tuple[pa.Table, bool]:
        """One producer's fragment for one bucket, validated against its
        declared row count. Tries the local filesystem and/or the
        producer's HTTP route per ``fugue.tpu.dist.fetch``; a fragment
        that can't be served intact ORPHANS the producer's done record
        (it re-runs on a live worker) and raises TRANSIENT."""
        own = rec.get("worker") == self.worker_id
        rel = frag["rel"]
        want_rows = int(frag["rows"])
        local_path = os.path.join(str(rec.get("data_dir", "")), rel)
        try_local = self.fetch_mode == "local" or self.fetch_mode == "auto" or own
        if try_local:
            tbl = self._read_fragment_file(local_path, want_rows)
            if tbl is not None:
                return tbl, False
            if self.fetch_mode == "local" or own:
                return self._orphan(ptid, rec, f"local fragment {rel} unreadable")
        # remote: the producer serves its own dir over /dist/fetch. The
        # retry loop is the shared RetryPolicy (conf fugue.tpu.retry.dist.*)
        # under a wall-clock Deadline (fugue.tpu.retry.dist.deadline_s) —
        # backoff/jitter/attempt budget come from conf, not ad-hoc sleeps.
        addr = rec.get("addr")
        if not addr:
            return self._orphan(ptid, rec, "producer has no fetch address")
        deadline = Deadline.after(self.fetch_deadline_s)
        failures = 0
        last: Optional[BaseException] = None
        while True:
            try:
                blob = self._http_fetch(addr[0], int(addr[1]), rel)
            except ConnectionRefusedError:
                # nothing is listening on the producer's advertised port:
                # the process is gone, not slow — orphan immediately and
                # classify the re-dispatch WORKER_LOST instead of burning
                # the TRANSIENT backoff budget on a dead peer
                return self._orphan(
                    ptid,
                    rec,
                    f"connection refused fetching {rel} from {addr}",
                    err_type=WorkerLostError,
                )
            except Exception as e:
                last = e
            else:
                tbl = self._decode_fragment(blob, want_rows)
                if tbl is not None:
                    return tbl, True
                break  # complete transfer, bad content: torn at source
            failures += 1
            if deadline.expired or not self.retry_policy.should_retry(
                classify_failure(last), failures
            ):
                break
            pause = self.retry_policy.delay(failures, seed=rel)
            rem = deadline.remaining()
            time.sleep(pause if rem is None else min(pause, rem))
        return self._orphan(
            ptid,
            rec,
            f"remote fetch of {rel} from {addr} failed after "
            f"{failures} attempt(s) (last: {last})",
        )

    @staticmethod
    def _read_fragment_file(path: str, want_rows: int) -> Optional[pa.Table]:
        if not os.path.exists(path):
            return None
        try:
            with pa.ipc.open_stream(path) as reader:
                tbl = reader.read_all()
        except Exception:
            return None
        return tbl if tbl.num_rows == want_rows else None

    @staticmethod
    def _decode_fragment(blob: bytes, want_rows: int) -> Optional[pa.Table]:
        try:
            with pa.ipc.open_stream(io.BytesIO(blob)) as reader:
                tbl = reader.read_all()
        except Exception:
            return None
        return tbl if tbl.num_rows == want_rows else None

    def _http_fetch(self, host: str, port: int, rel: str) -> bytes:
        """One GET against the producer's /dist/fetch route. Raises on
        any transport failure — ConnectionRefusedError propagates intact
        so the caller can prove the producer WORKER_LOST — and a non-200
        status raises TRANSIENT (producer alive, fragment unservable)."""
        from ..rpc.http import trace_headers

        conn = http.client.HTTPConnection(host, port, timeout=2.0)
        try:
            conn.request(
                "GET",
                "/dist/fetch?path=" + urllib.parse.quote(rel, safe=""),
                headers=trace_headers(),
            )
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise BucketUnavailableError(
                    f"/dist/fetch {rel} from {host}:{port} -> "
                    f"HTTP {resp.status}"
                )
            return body
        finally:
            conn.close()

    def _orphan(
        self,
        ptid: str,
        rec: Dict[str, Any],
        why: str,
        err_type: type = BucketUnavailableError,
    ) -> Any:
        """The remote-fetch extension of the torn-bucket recovery: the
        consumer proves the output unreachable, deletes the producer's
        done record (any live worker re-executes it — deterministic, so
        bit-identical fragments reappear) and re-raises — TRANSIENT by
        default, WORKER_LOST when the evidence is a refused connection."""
        self.stats.inc("fetch_failures")
        alive = holder_alive(
            str(rec.get("worker") or ""), self.board.hb_dir, self.hb_stale_s
        )
        if self.board.invalidate_done(ptid):
            self.stats.inc("orphaned_outputs_recovered")
            get_event_log().emit(
                "task.orphan", task=ptid, why=why[:200], producer=rec.get("worker")
            )
        raise err_type(
            f"{why}; producer {rec.get('worker')!r} "
            f"{'alive' if alive else 'dead/unknown'}; done record "
            f"invalidated for re-dispatch"
        )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="fugue-tpu-torch dist worker")
    ap.add_argument("--root", required=True, help="shared board root dir")
    ap.add_argument("--id", required=True, help="worker id (heartbeat name)")
    ap.add_argument("--conf", default="{}", help="json conf overrides")
    ap.add_argument("--stop-file", default=None, help="exit when this appears")
    args = ap.parse_args(argv)
    worker = DistWorker(args.root, args.id, conf=json.loads(args.conf))
    worker.start()
    try:
        worker.serve_forever(stop_file=args.stop_file)
    finally:
        worker.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    sys.exit(main())
