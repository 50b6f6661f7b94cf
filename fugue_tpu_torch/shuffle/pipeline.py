"""The overlapped spill's pieces, copied from ``fugue_tpu/shuffle/pipeline.py``.

The serial spill is a phase barrier: both sides spill to disk, then
bucket pairs join one at a time, and disk, host decode, the copy to the
card and the join never overlap; small buckets pay a disk round trip
though they would fit in host memory. Three pieces turn it into a
pipeline:

- :class:`SpillWriter`: write-behind. One background thread owns every
  bucket's arrow IPC writer and drains a bounded queue of (bucket, batch)
  jobs, so the partitioner's decode and hash of chunk n+1 overlap the
  disk write of chunk n. Publishes stay a temp write and a rename, and
  the ``shuffle.spill`` fault site fires between a bucket's close and its
  publish, on the writer thread. An error on the writer thread is carried
  to the submitting thread and raised there with its own traceback; a
  failed writer never leaves the partitioner blocked on a full queue, and
  an abandoned spill leaves no tmp file.
- :class:`MemBucketLedger`: the byte ledger of the memory-resident bucket
  tier. Buckets whose arrow bytes fit ``fugue.tpu.shuffle.mem_bucket_bytes``
  stay host arrow buffers and never touch disk. Admission is strict
  (never over the cap); under pressure the partitioner demotes its
  largest memory-resident bucket to the writer, so the bound holds over
  the whole exchange (both sides share one ledger).
- :class:`SpillPipeline`: the bundle one exchange hands to
  ``spill_partition``; ``None`` (the ``fugue.tpu.shuffle.pipeline.enabled
  =false`` kill switch) leaves the serial path.

The bucket-pair prefetch lives in ``shuffle/join.py``; it uses the port's
``execution/prefetch.py`` ``maybe_prefetch``.
"""

import os
import queue
import threading
from typing import Any, Dict, Optional, Tuple

import pyarrow as pa

from ..resilience import SITE_SHUFFLE_SPILL
from ..workflow._checkpoint import _atomic_publish, _best_effort_remove

__all__ = ["MemBucketLedger", "SpillWriter", "SpillPipeline"]


class MemBucketLedger:
    """Thread-safe byte ledger bounding the host bytes held by
    memory-resident buckets across one exchange (both sides).

    ``admit`` is all-or-nothing — the tier NEVER runs over its cap; the
    caller demotes buckets (releasing their bytes) to make room or sends
    the batch to disk. ``cap_bytes <= 0`` disables the tier (every admit
    refuses), which is also the kill-switch representation.
    """

    def __init__(self, cap_bytes: int):
        self._lock = threading.Lock()
        self.cap_bytes = max(0, int(cap_bytes))
        self._used = 0
        self._peak = 0
        self._demotions = 0

    def admit(self, nbytes: int) -> bool:
        with self._lock:
            if self._used + nbytes > self.cap_bytes:
                return False
            self._used += int(nbytes)
            if self._used > self._peak:
                self._peak = self._used
            return True

    def release(self, nbytes: int) -> None:
        with self._lock:
            self._used = max(0, self._used - int(nbytes))

    def note_demotion(self) -> None:
        with self._lock:
            self._demotions += 1

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    @property
    def peak_bytes(self) -> int:
        with self._lock:
            return self._peak

    @property
    def demotions(self) -> int:
        with self._lock:
            return self._demotions


class _WriterFailure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_FLUSH = object()


class SpillWriter:
    """Write-behind bucket writer for one spilled side.

    One daemon thread owns all of the side's ``<side>_<i>.arrow.tmp``
    IPC writers (single owner — no per-file locking) and drains a
    bounded job queue; :meth:`submit` blocks only when ``depth`` batches
    are already in flight, which is the memory bound the partitioner
    accounts for. :meth:`finalize` flushes the queue, closes every
    writer and publishes each bucket atomically ON THE WRITER THREAD,
    firing the ``shuffle.spill`` fault site between close and publish —
    an injected (or real) publish failure tears ONLY that bucket,
    exactly like the serial path, and the reader repairs it lazily.

    A failure while WRITING (a real I/O error, a poisoned batch) is
    carried across the thread boundary and re-raised — original
    traceback preserved — from the next ``submit``/``finalize`` call,
    after the thread has removed every tmp file it created.
    """

    def __init__(
        self,
        spill_dir: str,
        side: str,
        pa_schema: pa.Schema,
        depth: int,
        injector: Any = None,
        stats: Any = None,
    ):
        self._spill_dir = spill_dir
        self._side = side
        self._schema = pa_schema
        self._injector = injector
        self._stats = stats
        self._lock = threading.Lock()
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, int(depth)))
        self._aborting = threading.Event()
        self._done = threading.Event()
        self._failure: Optional[_WriterFailure] = None
        self._published: Dict[int, int] = {}  # bucket -> published bytes
        self._faults = 0
        self._batches = 0
        self._thread = threading.Thread(
            target=self._run, name=f"fugue-tpu-spill-writer-{side}", daemon=True
        )
        self._thread.start()

    # -- writer thread -------------------------------------------------------
    def _tmp(self, i: int) -> str:
        return os.path.join(self._spill_dir, f"{self._side}_{i:05d}.arrow.tmp")

    def _final(self, i: int) -> str:
        return os.path.join(self._spill_dir, f"{self._side}_{i:05d}.arrow")

    def _run(self) -> None:
        writers: Dict[int, Any] = {}
        sinks: Dict[int, Any] = {}
        try:
            while True:
                job = self._q.get()
                if job is _FLUSH:
                    break
                i, tbl = job
                w = writers.get(i)
                if w is None:
                    sink = pa.OSFile(self._tmp(i), "wb")
                    sinks[i] = sink
                    w = pa.ipc.new_stream(sink, self._schema)
                    writers[i] = w
                w.write_table(tbl)
                with self._lock:
                    self._batches += 1
            # close + publish each bucket; the fault site fires between
            # the write-close and the publish, on THIS thread — the
            # write-behind form of the serial publish loop. An aborting
            # caller (the partitioner's failure path) gets tmp cleanup
            # instead of publishes — it is about to remove the dir.
            for i in writers:
                writers[i].close()
                sinks[i].close()
                if self._aborting.is_set():
                    _best_effort_remove(self._tmp(i))
                    continue
                try:
                    if self._injector is not None:
                        self._injector.fire(SITE_SHUFFLE_SPILL)
                    _atomic_publish(self._tmp(i), self._final(i))
                    nbytes = os.path.getsize(self._final(i))
                    with self._lock:
                        self._published[i] = nbytes
                except Exception:
                    _best_effort_remove(self._tmp(i))
                    with self._lock:
                        self._faults += 1
        except BaseException as ex:  # noqa: BLE001 — carried to the caller
            with self._lock:
                self._failure = _WriterFailure(ex)
            # no orphans: every tmp this thread created is removed
            for i, w in writers.items():
                try:
                    w.close()
                except Exception:
                    pass
                try:
                    sinks[i].close()
                except Exception:
                    pass
                _best_effort_remove(self._tmp(i))
            # drain so a blocked submit() can observe the failure
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
        finally:
            self._done.set()

    # -- submitting side -----------------------------------------------------
    def _raise_if_failed(self) -> None:
        with self._lock:
            failure = self._failure
        if failure is not None:
            # the original exception object keeps its writer-thread frames,
            # as the stream prefetcher's failures do
            raise failure.exc

    def submit(self, bucket: int, tbl: pa.Table) -> None:
        """Queue one bucket batch; blocks when ``depth`` batches are in
        flight. Re-raises a writer-thread failure instead of queueing
        into a dead writer."""
        while True:
            self._raise_if_failed()
            if self._done.is_set():
                self._raise_if_failed()
                raise RuntimeError("spill writer already finalized")
            try:
                self._q.put((bucket, tbl), timeout=0.05)
                return
            except queue.Full:
                continue

    def finalize(self) -> Tuple[Dict[int, int], int, int]:
        """Flush, close and publish everything; returns
        ``(bytes-per-published-bucket, publish_faults, batches)``.
        Re-raises any writer-thread failure with its original traceback."""
        while True:
            self._raise_if_failed()
            try:
                self._q.put(_FLUSH, timeout=0.05)
                break
            except queue.Full:
                continue
        self._done.wait()
        self._thread.join(timeout=10.0)
        self._raise_if_failed()
        with self._lock:
            return dict(self._published), self._faults, self._batches

    def abort(self) -> None:
        """Best-effort teardown on the partitioner's failure path: stop
        the thread (publishing nothing) and remove every tmp file.
        Never raises."""
        self._aborting.set()
        try:
            self._q.put_nowait(_FLUSH)
        except queue.Full:
            # drain one slot so the flush sentinel fits; the writer is
            # alive (it would have drained the queue on failure)
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                self._q.put_nowait(_FLUSH)
            except queue.Full:
                pass
        self._done.wait(timeout=10.0)
        for name in list(os.listdir(self._spill_dir) if os.path.isdir(self._spill_dir) else ()):
            if name.startswith(f"{self._side}_") and name.endswith(".tmp"):
                _best_effort_remove(os.path.join(self._spill_dir, name))


class SpillPipeline:
    """Per-exchange pipeline context handed into ``spill_partition``:
    the shared mem-bucket ledger plus the write-behind queue depth. One
    instance covers every side of one join/repartition, so the mem-tier
    ledger bound holds across sides."""

    def __init__(self, ledger: MemBucketLedger, writebehind_depth: int, stats: Any = None):
        self.ledger = ledger
        self.writebehind_depth = max(1, int(writebehind_depth))
        self.stats = stats

    def writer(
        self, spill_dir: str, side: str, pa_schema: pa.Schema, injector: Any
    ) -> SpillWriter:
        return SpillWriter(
            spill_dir,
            side,
            pa_schema,
            self.writebehind_depth,
            injector=injector,
            stats=self.stats,
        )
