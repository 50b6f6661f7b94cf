"""The streaming ingest pipeline, the port of ``fugue_tpu/jax/pipeline.py``.

- :class:`ChunkPrefetcher` (``execution/prefetch.py``, which imports no
  torch, so that a dist worker can use it) runs the *producer* side of a chunk stream
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

import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..constants import FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH
from ..execution.prefetch import (  # noqa: F401 (the streaming verbs and tests take them from here)
    ChunkPrefetcher,
    PipelineStats,
    _chunk_attrs,
    _SerialChunks,
    maybe_prefetch,
)
from ..obs import get_tracer
from ..resilience import FaultInjector

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
