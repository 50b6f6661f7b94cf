"""The streaming ingest pipeline, the port of ``fugue_tpu/jax/pipeline.py``.

- :class:`ChunkPrefetcher` runs the *producer* side of a chunk stream
  (host decode, staging, the host→device copy) in one background thread
  feeding a bounded queue (depth ``fugue.tpu.stream.prefetch_depth``,
  default 2), while the caller consumes chunks already on their way to the
  device. At most ``depth`` finished chunks wait in the queue, plus one
  being produced and one being consumed.
- An exception raised in the producer is carried across the thread and
  re-raised in the consumer with its original traceback; a consumer that
  leaves (an exception downstream, an abandoned generator) stops the
  producer through ``close()``.
- :class:`HostToDevice` is the copy a producer makes on CUDA: each column
  through a ring of pinned host buffers, ``non_blocking`` on a side
  stream, with an event the consumer waits on before it uses the chunk.
- :class:`PipelineStats` (``engine.pipeline_stats``) records chunks,
  producer and consumer waits and the overlap they show.
- ``prefetch_depth <= 0`` starts no thread: :class:`_SerialChunks` has the
  same interface, and the results are the same either way.

Spans for ``torch.profiler``: ``fugue::stream_chunk`` around the making of
each chunk (decode, staging and the copy's launch, on the producer's
thread) and ``fugue::stream_wait`` around the consumer's wait for it. They
record nothing unless a profiler runs.

``engine_prefetcher`` (reference :682-724) also arms the engine's fault
plan at ``stream.chunk`` on the producer's side (a fault reaches the
consumer as the producer's exception; the serial path has no such site,
as in the JAX package) and, while the tracer (``fugue_tpu_torch/obs``) is
on, wraps the chunks in :class:`_TracedChunks`, whose ``stream.chunk``
spans open on the consuming thread, under the verb's span. Where the
chunk-size site left a tuner handle for the verb (``Tuner.stream_params``
inside a workflow's run scope, ``fugue_tpu_torch/tuning``), the handle
gives the learned prefetch depth, keys the run's per-stream stats by its
stream id, and takes the finished run's record (chunks, rows, bytes,
waits, wall) as the next generation's evidence; the serial path measures
the same record for it. With no handle nothing changes.
"""

import contextvars
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..constants import FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH
from ..obs import get_tracer
from ..resilience import SITE_STREAM_CHUNK, FaultInjector

DEFAULT_PREFETCH_DEPTH = 2


def default_prefetch_depth(device: torch.device) -> int:
    """Overlap needs a spare execution unit: another host core, or a CUDA
    device that computes off the host. On one core with the CPU as the
    device, a producer thread only takes time from the consumer, so the
    default is serial there."""
    if (os.cpu_count() or 1) > 1 or torch.device(device).type == "cuda":
        return DEFAULT_PREFETCH_DEPTH
    return 0


def prefetch_depth(conf: Any, device: torch.device) -> int:
    """``fugue.tpu.stream.prefetch_depth`` of an engine's conf (unset:
    :func:`default_prefetch_depth`)."""
    raw = conf.get_or_none(FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH, object)
    return default_prefetch_depth(device) if raw is None else int(raw)


def stream_depth(engine: Any, handle: Any = None) -> int:
    """A stream's prefetch depth: the tuner handle's learned depth, else
    the engine's :func:`prefetch_depth`."""
    if handle is not None and handle.prefetch_depth is not None:
        return int(handle.prefetch_depth)
    return prefetch_depth(engine.conf, engine.device)


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
            with record_function("fugue::stream_chunk"):
                return next(self._src)
        t0 = time.perf_counter()
        try:
            with record_function("fugue::stream_chunk"):
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
                    with record_function("fugue::stream_chunk"):
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
        with record_function("fugue::stream_wait"):
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


class _TracedChunks:
    """Per-chunk spans over a (possibly prefetched) chunk iterator.

    Span ``stream.chunk`` #n opens on the consuming thread when chunk n is
    handed over and closes when the consumer asks for chunk n+1 (or closes
    the stream): it measures the downstream work on that chunk, nested in
    the verb's span open on that thread. ``fetch_wait_ns`` is how long the
    consumer waited for the chunk itself. The span also enters a
    ``torch.profiler`` range of its name."""

    def __init__(self, inner: Any, verb: str, tracer: Any):
        self._inner = inner
        self._verb = verb
        self._tracer = tracer
        self._open: Any = None
        self._i = 0

    def __iter__(self) -> "_TracedChunks":
        return self

    def _end_open(self) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None

    def __next__(self) -> Any:
        self._end_open()
        t0 = time.perf_counter_ns()
        item = next(self._inner)
        sp = self._tracer.span(
            "stream.chunk",
            cat="stream",
            annotate=True,
            verb=self._verb,
            chunk=self._i,
            fetch_wait_ns=time.perf_counter_ns() - t0,
            **_chunk_attrs(item),
        )
        sp.__enter__()
        self._open = sp
        self._i += 1
        return item

    def close(self) -> None:
        self._end_open()
        self._inner.close()


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


def engine_prefetcher(engine: Any, source: Iterator[Any], verb: str) -> Any:
    """The streaming paths' prefetcher: depth and fault plan from the
    engine's conf, runs recorded in its ``pipeline_stats``, and per-chunk
    spans while the tracer is on. The tuner's handle for ``verb``, where
    the chunk-size site left one, gives the learned depth and takes the
    run's record."""
    handle = engine.tuner.take_stream_handle(verb)
    depth = stream_depth(engine, handle)
    observer = None
    stream = ""
    if handle is not None:
        handle.used_depth = depth
        observer = handle.observe
        stream = handle.sid
    it = maybe_prefetch(
        source,
        depth,
        stats=engine.pipeline_stats,
        verb=verb,
        injector=FaultInjector.from_conf(engine.conf),
        stream=stream,
        observer=observer,
    )
    tracer = get_tracer()
    if tracer.enabled:
        return _TracedChunks(it, verb, tracer)
    return it


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


class DeviceChunk:
    """A chunk's device tensors and the event that marks their copy done."""

    def __init__(self, tensors: Dict[str, torch.Tensor], event: Any = None,
                 device: Optional[torch.device] = None):
        self._tensors = tensors
        self._event = event
        self._device = device

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The tensors, ready for the calling thread's current stream: it
        waits for the copy's event, and each tensor is recorded on it, so
        the caching allocator does not hand their memory to a later copy
        on the side stream while this stream's kernels still read them."""
        if self._event is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(self._event)
            for t in self._tensors.values():
                t.record_stream(cur)
            self._event = None
        return self._tensors


class HostToDevice:
    """Copies a chunk's numpy columns into device tensors of ``capacity``
    rows; rows past the chunk's length are 0.

    On CUDA (on the producer's thread): each column is copied into a
    pinned host buffer of a ring of ``slots`` (one buffer a column a slot,
    reused), then to the device with ``non_blocking=True`` on a side
    stream, and an event recorded after the chunk's copies. A slot is
    rewritten only after the event of its last copy has completed, so a
    copy in flight never reads a rewritten buffer. Copying into the pinned
    buffer also takes the place of ``torch.from_numpy`` on the read-only
    arrays pandas may hand out. On the CPU the columns are copied into new
    tensors."""

    def __init__(self, device: torch.device, capacity: int, slots: int = 2):
        self._device = device
        self._capacity = capacity
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(device)
            self._ring: List[Dict[str, torch.Tensor]] = [{} for _ in range(max(2, slots))]
            self._done: List[Any] = [None] * len(self._ring)
            self._slot = 0

    def put(self, cols: Dict[str, np.ndarray], n: int) -> DeviceChunk:
        cap = self._capacity
        if not self._cuda:
            out = {}
            for name, a in cols.items():
                t = torch.zeros(cap, dtype=_torch_dtype(a.dtype))
                t.numpy()[:n] = a
                out[name] = t
            return DeviceChunk(out)
        slot = self._slot
        self._slot = (slot + 1) % len(self._ring)
        if self._done[slot] is not None:
            self._done[slot].synchronize()
        bufs = self._ring[slot]
        out = {}
        with torch.cuda.stream(self._stream):
            for name, a in cols.items():
                dt = _torch_dtype(a.dtype)
                buf = bufs.get(name)
                if buf is None or buf.dtype != dt:
                    buf = bufs[name] = torch.empty(cap, dtype=dt, pin_memory=True)
                host = buf.numpy()
                host[:n] = a
                host[n:] = 0
                dev = torch.empty(cap, dtype=dt, device=self._device)
                dev.copy_(buf, non_blocking=True)
                out[name] = dev
            event = torch.cuda.Event()
            event.record(self._stream)
        self._done[slot] = event
        return DeviceChunk(out, event, self._device)
