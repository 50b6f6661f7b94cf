"""The chunk prefetcher of the streaming pipeline, which needs no torch:
the producer thread, its bounded queue and the serial shim
(``maybe_prefetch``), and the ``PipelineStats`` it records into. The
streaming verbs take it through ``fugue_tpu_torch/torch/pipeline.py``
(which also has the copy to the card); the dist tier's reduce takes it
here, so that a worker process, a host engine, never imports torch.

Spans for ``torch.profiler``: ``fugue::stream_chunk`` around the making of
each chunk on the producer's thread and ``fugue::stream_wait`` around the
consumer's wait for it, entered only where torch is already imported
(every process of the card's engine; not a worker's). They record
nothing unless a profiler runs.
"""

import contextvars
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

from ..parallel.profiler import annotate
from ..resilience import SITE_STREAM_CHUNK

__all__ = ["ChunkPrefetcher", "PipelineStats", "maybe_prefetch"]


def _chunk_attrs(item: Any) -> Dict[str, Any]:
    """Rows (and bytes where cheap) of a chunk of any streamed shape:
    ``(n, ...)`` tuples, pandas frames, arrow tables."""
    try:
        if isinstance(item, tuple) and len(item) > 0 and isinstance(item[0], int):
            return {"rows": item[0]}
        num_rows = getattr(item, "num_rows", None)  # pyarrow.Table
        if isinstance(num_rows, int):
            return {"rows": num_rows, "bytes": int(getattr(item, "nbytes", 0))}
        if hasattr(item, "memory_usage") and hasattr(item, "__len__"):  # pandas
            return {"rows": len(item), "bytes": int(item.memory_usage(index=False).sum())}
    except Exception:
        pass
    return {}


class PipelineStats:
    """Thread-safe counters of an engine's ingest pipeline.

    ``overlap_fraction`` is the share of the serial estimate (producer busy
    + consumer busy) that the pipeline removed from the wall time: 0 =
    serial, toward 1 = hidden. Producer wait is time the producer sat on a
    full queue (the consumer sets the pace); consumer wait is time the
    consumer sat on an empty one (the producer sets it). Runs are also
    summed by verb and by stream (the tuner's stream id inside a run
    scope, else the verb; at most ``MAX_STREAMS`` of them, the oldest
    dropped first)."""

    _KEYS = ("producer_busy_s", "producer_wait_s", "consumer_wait_s", "wall_s", "overlap_saved_s")
    MAX_STREAMS = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    @staticmethod
    def _zero() -> Dict[str, Any]:
        return {"runs": 0, "chunks_prefetched": 0, "rows": 0,
                **{k: 0.0 for k in PipelineStats._KEYS}}

    @staticmethod
    def _with_overlap(t: Dict[str, Any]) -> Dict[str, Any]:
        serial = t["producer_busy_s"] + max(t["wall_s"] - t["consumer_wait_s"], 0.0)
        return {**t, "overlap_fraction": t["overlap_saved_s"] / serial if serial > 0 else 0.0}

    def record_run(
        self,
        verb: str,
        chunks: int,
        rows: int,
        producer_busy_s: float,
        producer_wait_s: float,
        consumer_wait_s: float,
        wall_s: float,
        stream: str = "",
    ) -> None:
        serial = producer_busy_s + max(wall_s - consumer_wait_s, 0.0)
        run = {
            "verb": verb,
            "runs": 1,
            "chunks_prefetched": chunks,
            "rows": rows,
            "producer_busy_s": producer_busy_s,
            "producer_wait_s": producer_wait_s,
            "consumer_wait_s": consumer_wait_s,
            "wall_s": wall_s,
            "overlap_saved_s": max(serial - wall_s, 0.0),
        }
        key = stream or verb
        with self._lock:
            if key not in self._streams:
                while len(self._streams) >= self.MAX_STREAMS:
                    self._streams.pop(next(iter(self._streams)))
                self._streams[key] = self._zero()
            for t in (
                self._totals,
                self._by_verb.setdefault(verb, self._zero()),
                self._streams[key],
            ):
                for k in t:
                    t[k] += run[k]
            self._last = {**self._with_overlap(run), "stream": key}

    @property
    def last_run(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._last)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            out = self._with_overlap(dict(self._totals))
            out["by_verb"] = {v: self._with_overlap(dict(t)) for v, t in self._by_verb.items()}
            out["streams"] = {k: self._with_overlap(dict(t)) for k, t in self._streams.items()}
            out["last_run"] = dict(self._last)
        return out

    def reset(self) -> None:
        with self._lock:
            self._totals = self._zero()
            self._by_verb: Dict[str, Dict[str, Any]] = {}
            self._streams: Dict[str, Dict[str, Any]] = {}
            self._last: Dict[str, Any] = {}


def _rows_of(item: Any) -> int:
    """The rows of a produced chunk: ``(n, ...)`` tuples, or a pandas frame."""
    if isinstance(item, tuple) and len(item) > 0 and isinstance(item[0], int):
        return item[0]
    return len(item) if hasattr(item, "__len__") else 0


class _SerialChunks:
    """``depth <= 0``: the same iterator and ``close()``, no thread. With
    an ``observer`` (a tuner handle) it measures the run's chunk count,
    rows, bytes and wall for it, with no waits (there is no queue); with
    none it measures nothing, and it never records in ``PipelineStats``
    (whose counters mean "prefetched")."""

    def __init__(
        self,
        source: Iterator[Any],
        verb: str = "",
        stream: str = "",
        observer: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self._src = source
        self._verb = verb
        self._stream = stream
        self._observer = observer
        self._chunks = 0
        self._rows = 0
        self._bytes = 0
        self._busy = 0.0
        self._done = False
        self._t0 = time.perf_counter()

    def __iter__(self) -> "_SerialChunks":
        return self

    def __next__(self) -> Any:
        if self._observer is None:
            with annotate("fugue::stream_chunk"):
                return next(self._src)
        t0 = time.perf_counter()
        try:
            with annotate("fugue::stream_chunk"):
                item = next(self._src)
        except StopIteration:
            self._finish()
            raise
        self._busy += time.perf_counter() - t0
        self._chunks += 1
        attrs = _chunk_attrs(item)
        self._rows += int(attrs.get("rows", 0))
        self._bytes += int(attrs.get("bytes", 0))
        return item

    def _finish(self) -> None:
        if self._done or self._observer is None:
            return
        self._done = True
        _observe(
            self._observer,
            {
                "verb": self._verb,
                "stream": self._stream or self._verb,
                "chunks_prefetched": self._chunks,
                "rows": self._rows,
                "bytes": self._bytes,
                "producer_busy_s": self._busy,
                "producer_wait_s": 0.0,
                "consumer_wait_s": 0.0,
                "wall_s": time.perf_counter() - self._t0,
            },
        )

    def close(self) -> None:
        self._finish()
        close = getattr(self._src, "close", None)
        if close is not None:
            close()


def _observe(observer: Callable[[Dict[str, Any]], None], run: Dict[str, Any]) -> None:
    try:  # learning never fails the stream
        observer(run)
    except Exception:
        pass


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


class ChunkPrefetcher:
    """A background producer over ``source`` with a queue of ``depth``.

    The producer thread advances ``source`` (which decodes a chunk and
    starts its copy to the device) and queues the results; ``__next__``
    takes them off. At most ``depth`` finished items wait in the queue,
    plus one being produced."""

    def __init__(
        self,
        source: Iterator[Any],
        depth: int,
        stats: Optional[PipelineStats] = None,
        verb: str = "",
        injector: Any = None,
        stream: str = "",
        observer: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self._src = source
        self._depth = max(1, int(depth))
        self._stream = stream
        self._observer = observer
        self._bytes = 0
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._stats = stats
        self._verb = verb
        self._injector = injector
        self._chunks = 0
        self._rows = 0
        self._producer_busy = 0.0
        self._producer_wait = 0.0
        self._consumer_wait = 0.0
        self._finished = False
        self._t0 = time.perf_counter()
        # the producer runs in the consumer's context (contextvars do not
        # cross a thread's start on their own)
        self._thread = threading.Thread(
            target=contextvars.copy_context().run,
            args=(self._produce,),
            name=f"fugue-torch-prefetch-{verb or 'chunks'}",
            daemon=True,
        )
        self._thread.start()

    # -- producer side ------------------------------------------------------
    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    with annotate("fugue::stream_chunk"):
                        item = next(self._src)
                except StopIteration:
                    break
                if self._injector is not None:
                    # the poison-chunk site: the fault must reach the
                    # consumer, never hang the queue
                    self._injector.fire(SITE_STREAM_CHUNK)
                self._producer_busy += time.perf_counter() - t0
                if not self._put(item):
                    return
            self._put(_DONE)
        except BaseException as ex:  # noqa: BLE001 — carried to the consumer
            self._put(_Failure(ex))

    def _put(self, obj: Any) -> bool:
        """A blocking put that gives up once the consumer has closed the
        pipeline, so a consumer that left never pins this thread."""
        t0 = time.perf_counter()
        while not self._stop.is_set():
            try:
                self._q.put(obj, timeout=0.05)
                self._producer_wait += time.perf_counter() - t0
                return True
            except queue.Full:
                continue
        return False

    # -- consumer side ------------------------------------------------------
    def __iter__(self) -> "ChunkPrefetcher":
        return self

    def __next__(self) -> Any:
        if self._finished:
            raise StopIteration
        t0 = time.perf_counter()
        with annotate("fugue::stream_wait"):
            obj = self._q.get()
        self._consumer_wait += time.perf_counter() - t0
        if obj is _DONE:
            self._finish()
            raise StopIteration
        if isinstance(obj, _Failure):
            self._finish()
            self.close()
            # the original exception object keeps its traceback: the
            # producer's frames show where the chunk failed. No local of
            # this frame keeps it, or the frame and the exception would
            # hold each other (and the chunks the frames hold) until a
            # collection
            exc, obj = obj.exc, None
            try:
                raise exc
            finally:
                exc = None
        self._chunks += 1
        attrs = _chunk_attrs(obj)
        self._rows += int(attrs.get("rows", _rows_of(obj)))
        self._bytes += int(attrs.get("bytes", 0))
        return obj

    def _finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        wall = time.perf_counter() - self._t0
        if self._stats is not None:
            self._stats.record_run(
                self._verb,
                self._chunks,
                self._rows,
                self._producer_busy,
                self._producer_wait,
                self._consumer_wait,
                wall,
                stream=self._stream,
            )
        if self._observer is not None:
            _observe(
                self._observer,
                {
                    "verb": self._verb,
                    "stream": self._stream or self._verb,
                    "chunks_prefetched": self._chunks,
                    "rows": self._rows,
                    "bytes": self._bytes,
                    "producer_busy_s": self._producer_busy,
                    "producer_wait_s": self._producer_wait,
                    "consumer_wait_s": self._consumer_wait,
                    "wall_s": wall,
                },
            )

    def close(self) -> None:
        """Stop the producer and drop what it queued. Safe to call more
        than once; the consuming ``finally`` always calls it."""
        self._stop.set()
        while True:  # drain, so a blocked put() sees the stop
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        self._finish()


def maybe_prefetch(
    source: Iterator[Any],
    depth: int,
    stats: Optional[PipelineStats] = None,
    verb: str = "",
    injector: Any = None,
    stream: str = "",
    observer: Optional[Callable[[Dict[str, Any]], None]] = None,
) -> Any:
    """``source`` behind a :class:`ChunkPrefetcher` (``depth > 0``) or the
    serial shim of the same interface (``depth <= 0``)."""
    if depth <= 0:
        return _SerialChunks(iter(source), verb=verb, stream=stream, observer=observer)
    return ChunkPrefetcher(
        iter(source), depth, stats=stats, verb=verb, injector=injector,
        stream=stream, observer=observer,
    )
