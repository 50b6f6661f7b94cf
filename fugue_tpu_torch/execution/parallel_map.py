"""Process-pool execution of per-partition UDFs, with supervised recovery,
copied from ``fugue_tpu/execution/parallel_map.py``.

The host side of the map path runs in a fork-based process pool over
logical partitions: pandas UDFs hold the GIL, so threads don't help, while
``fork`` gives every worker copy-on-write access to the parent's
already-materialized pandas frame — no input serialization at all. Only
the (usually much smaller) per-partition outputs cross back, as arrow
tables.

The driver may have initialized CUDA, and may run the ingest pipeline's
and the sampler's threads, when it forks. A forked child must not touch
CUDA ("Cannot re-initialize CUDA in forked subprocess"), and the frame it
reads must be pageable: CUDA keeps pinned host buffers out of a child's
address space. The children run pandas UDFs over the host frame that
``TorchExecutionEngine._host`` copied off the card, and their spans open
no profiler range.

Partitions are split into more chunks than workers (dynamic balancing for
skewed group sizes), each chunk a contiguous partition range so global
partition numbering is preserved.

Dispatch is SUPERVISED (``fugue_tpu_torch/resilience``): each forked
worker has its own pipes (``_Worker``), a chunk goes to an idle worker with
a per-chunk deadline, the driver watches the workers' processes, and
recovery follows the graceful-degradation order
**parallel → retry → serial → raise**:

1. a dead worker (OOM-kill, segfault, injected SIGKILL) or an expired
   chunk deadline tears down the wave; finished chunk results are kept;
2. lost/failed chunks retry on a FRESH fork pool under the engine's
   ``fugue.tpu.retry.{attempts,base,multiplier,max_backoff,jitter}`` policy;
3. chunks that exhaust retries (or fail deterministically — "poison"
   partitions) are quarantined to serial in-driver execution, which also
   yields clean tracebacks;
4. only if the serial path fails too does the map raise, with a
   per-partition failure report (``ParallelMapError``).

Every recovery step increments the engine's ``resilience_stats``.

Not engaged when:
- the platform has no ``fork`` (non-Linux/macOS spawn semantics),
- the transformer carries a worker→driver RPC callback (the in-process
  ``NativeRPCServer`` can't cross a process boundary; such transformers run
  serially, as the JAX package's do),
- the frame is below ``fugue.tpu.map.parallel_min_rows`` (pool setup costs
  ~100ms — tiny frames are faster serial),
- everything fits one chunk (``len(chunks) <= 1``): a pool of one worker
  has no concurrency to offer, so the chunk runs serially in-driver.
"""

import multiprocessing as mp
import multiprocessing.connection as mp_connection
import os
import threading
import time
import warnings
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa

from ..resilience import (
    NULL_INJECTOR,
    SITE_MAP_CHUNK,
    SITE_MAP_DISPATCH,
    ChunkTimeoutError,
    Deadline,
    FailureCategory,
    FaultInjector,
    ParallelMapError,
    ResilienceStats,
    RetryPolicy,
    WorkerLostError,
    classify_failure,
)

# set in the parent immediately before forking; children inherit the memory
# image, so the frame and the (arbitrary, unpicklable) UDF need no transport.
# the lock spans set-state → fork → drain: concurrent map calls (workflow
# concurrency > 1) must not clobber each other's state mid-fork
_FORK_STATE: dict = {}
_FORK_LOCK = threading.Lock()

# the supervision loop's longest wait on the workers' pipes before it
# checks deadlines and deaths
_POLL_INTERVAL = 0.01


def fork_available() -> bool:
    try:
        return "fork" in mp.get_all_start_methods()
    except Exception:
        return False


def map_func_parallel_safe(map_func: Callable) -> bool:
    """True when the UDF can run in a forked worker.

    A transformer holding an in-process RPC callback must stay in the
    driver process: a forked child would invoke its own copy of the handler
    and the driver would never see the calls.
    """
    runner = getattr(map_func, "__self__", None)
    tf = getattr(runner, "transformer", None)
    if tf is None:
        return True
    return getattr(tf, "_callback", None) is None


def split_chunks(sizes: Sequence[int], n_chunks: int) -> List[Any]:
    """Split partition ids [0..len) into ≤n_chunks contiguous runs balanced
    by total row count (greedy quantile cuts over the cumulative sizes)."""
    n = len(sizes)
    if n == 0:
        return []
    n_chunks = max(1, min(n_chunks, n))
    cum = np.cumsum(np.asarray(sizes, dtype=np.int64))
    total = int(cum[-1])
    bounds = [0]
    for q in range(1, n_chunks):
        target = total * q // n_chunks
        pos = int(np.searchsorted(cum, target, side="left")) + 1
        if pos > bounds[-1] and pos < n:
            bounds.append(pos)
    bounds.append(n)
    return [range(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def _exec_partition(
    no: int,
    pdf: pd.DataFrame,
    groups: List[Any],
    map_func: Callable,
    cursor: Any,
    schema: Any,
    output_schema: Any,
    wrap: Callable,
    to_tbl: Callable,
) -> pa.Table:
    """Run the UDF over one logical partition — shared by the forked worker
    body and the driver's serial/quarantine paths."""
    idx = groups[no]
    if isinstance(idx, slice):
        sub = pdf.iloc[idx].reset_index(drop=True)
    else:
        sub = pdf.take(idx).reset_index(drop=True)
    part = wrap(sub, schema)
    cursor.set(lambda p=part: p.peek_array(), no, 0)
    res = map_func(cursor, part)
    return to_tbl(res, output_schema)


def _run_chunk(part_ids: Any) -> Dict[str, Any]:
    """Worker body: run the inherited UDF over a contiguous partition range.

    Results serialize as arrow IPC streams — pyarrow tables cross process
    boundaries far cheaper than pickled pandas frames. The return payload
    also carries the worker's OBSERVABILITY delta across the fork
    boundary: per-chunk resilience counters and any trace spans recorded
    while the chunk ran (a forked child's in-memory increments are
    otherwise invisible to the driver). Failed/killed chunks can't ship a
    delta — by design the payload rides the success path only.
    """
    from ..obs import get_span_metrics, get_tracer

    st = _FORK_STATE
    injector: FaultInjector = st.get("injector", NULL_INJECTOR)
    tracer = get_tracer()
    mark = tracer.mark()
    # histogram counterpart of the span mark: snapshot the (fork-inherited,
    # copy-on-write) span-metric state so only THIS chunk's observations
    # ship home as a mergeable delta
    hist_mark = get_span_metrics().snapshot() if tracer.enabled else None
    counters: Dict[str, int] = {"map.worker_chunks": 1}
    rows_out = 0
    out: List[bytes] = []
    with tracer.span(
        "map.worker_chunk",
        cat="worker",
        parent=st.get("trace_parent"),
        worker_pid=os.getpid(),
        partitions=len(part_ids),
    ) as chunk_sp:
        # fault-injection site: a `kill` here SIGKILLs this worker
        # mid-chunk, exactly the OOM-killer scenario the supervisor must
        # recover from
        injector.fire(SITE_MAP_CHUNK)
        for no in part_ids:
            with tracer.span("map.partition", cat="worker", partition=no) as sp:
                tbl = _exec_partition(
                    no,
                    st["pdf"],
                    st["groups"],
                    st["map_func"],
                    st["cursor"],
                    st["schema"],
                    st["output_schema"],
                    st["wrap_df"],
                    st["to_arrow"],
                )
                sp.set(rows_out=tbl.num_rows)
            counters["map.worker_partitions"] = (
                counters.get("map.worker_partitions", 0) + 1
            )
            rows_out += tbl.num_rows
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, tbl.schema) as w:
                w.write_table(tbl)
            out.append(sink.getvalue().to_pybytes())
        chunk_sp.set(rows_out=rows_out)
    counters["map.worker_rows_out"] = rows_out
    payload: Dict[str, Any] = {
        "blobs": out,
        "counters": counters,
        "spans": tracer.take_since(mark),
    }
    if hist_mark is not None:
        payload["hist"] = get_span_metrics().delta_since(hist_mark)
    return payload


def _harvest_chunk(payload: Any, stats: ResilienceStats) -> List[pa.Table]:
    """Driver side of the fork-boundary protocol: merge the worker's
    counter delta into the driver registry, ingest its spans into the
    global tracer, merge its histogram delta into the span-metrics store
    (label-keyed, never pid-keyed — associative across any worker order),
    and decode the arrow blobs."""
    stats.merge(payload["counters"])
    if payload["spans"]:
        from ..obs import get_tracer

        get_tracer().ingest(payload["spans"])
    if payload.get("hist"):
        from ..obs import get_span_metrics

        get_span_metrics().merge(payload["hist"])
    return [_decode_blob(b) for b in payload["blobs"]]


def _decode_blob(blob: bytes) -> pa.Table:
    with pa.ipc.open_stream(pa.BufferReader(blob)) as r:
        return r.read_all()


@contextmanager
def _quiet_fork_warnings():
    """Children never touch CUDA (host-only pandas UDFs). Before CUDA is
    initialized the fork-vs-threads warning is noise; once it is, keep the
    warning visible — forking a process that holds a CUDA context is
    riskier and worth the operator's attention. The filter spans the whole
    supervised phase: a wave's workers fork as it starts."""
    import torch

    with warnings.catch_warnings():
        if not torch.cuda.is_initialized():
            warnings.filterwarnings(
                "ignore", message=".*fork.*", category=RuntimeWarning
            )
            warnings.filterwarnings(
                "ignore", message=".*fork.*", category=DeprecationWarning
            )
        yield


class _Worker:
    """One forked worker with pipes of its own: chunk ranges in, payloads
    out. Workers share no lock or queue, so one that dies mid-chunk (the
    OOM killer, an injected SIGKILL) leaves none held: the JAX package
    runs a ``multiprocessing.Pool``, whose queues the workers share, and
    whose teardown after such a death was seen to hang on the card's host."""

    def __init__(self, ctx: Any):
        tasks_r, self.tasks = ctx.Pipe(duplex=False)
        self.results, results_w = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_worker_main, args=(tasks_r, results_w), daemon=True)
        self.proc.start()
        tasks_r.close()
        results_w.close()
        self.chunk: Optional[int] = None
        self.deadline: Optional[Deadline] = None

    def stop(self) -> None:
        if self.proc.exitcode is None:
            self.proc.kill()
        self.proc.join()
        self.tasks.close()
        self.results.close()


def _worker_main(tasks: Any, results: Any) -> None:
    """A forked worker's loop: run each chunk it is sent, send back its
    payload or its error, until the driver kills it."""
    while True:
        try:
            part_ids = tasks.recv()
        except EOFError:
            return
        try:
            out: Tuple[bool, Any] = (True, _run_chunk(part_ids))
        except Exception as ex:
            out = (False, ex)
        try:
            results.send(out)
        except Exception:  # an error that does not pickle travels as text
            results.send((False, RuntimeError(f"{type(out[1]).__name__}: {out[1]}")))


def _make_pool(n: int) -> List[_Worker]:
    """Fork ``n`` workers."""
    ctx = mp.get_context("fork")
    return [_Worker(ctx) for _ in range(n)]


def run_partitions_forked(
    pdf: pd.DataFrame,
    schema: Any,
    groups: List[Any],
    map_func: Callable,
    cursor: Any,
    output_schema: Any,
    n_workers: int,
    wrap_df: Callable,
    to_arrow: Callable,
    chunk_timeout: float = 0.0,
    policy: Optional[RetryPolicy] = None,
    injector: Optional[FaultInjector] = None,
    stats: Optional[ResilienceStats] = None,
) -> List[pa.Table]:
    """Run ``map_func`` over every logical partition using a supervised fork
    pool.

    ``groups`` is a list of positional row selections (ndarray or slice),
    one per logical partition, in partition order. Returns the per-partition
    arrow tables in the same order. ``chunk_timeout`` bounds each chunk's
    wall clock (0 = unbounded); ``policy``/``injector``/``stats`` are the
    resilience plumbing (see module docstring) and default to fail-safe
    no-ops.
    """
    policy = policy or RetryPolicy()
    injector = injector or NULL_INJECTOR
    stats = stats or ResilienceStats()
    sizes = [
        (idx.stop - idx.start) if isinstance(idx, slice) else len(idx)
        for idx in groups
    ]
    chunks = split_chunks(sizes, n_workers * 4)

    def _serial(part_ids: Any) -> List[pa.Table]:
        return [
            _exec_partition(
                no, pdf, groups, map_func, cursor, schema, output_schema,
                wrap_df, to_arrow,
            )
            for no in part_ids
        ]

    from ..obs import get_tracer

    tracer = get_tracer()
    # a single chunk gains nothing from a one-worker pool — skip the ~100ms
    # fork/teardown entirely and run in-driver
    if len(chunks) <= 1:
        if not chunks:
            return []
        with tracer.span(
            "map.serial", cat="engine", partitions=len(groups)
        ):
            return _serial(chunks[0])

    with _FORK_LOCK, tracer.span(
        "map.parallel",
        cat="engine",
        chunks=len(chunks),
        workers=n_workers,
        partitions=len(groups),
    ):
        _FORK_STATE.clear()
        _FORK_STATE.update(
            pdf=pdf,
            groups=groups,
            map_func=map_func,
            cursor=cursor,
            schema=schema,
            output_schema=output_schema,
            wrap_df=wrap_df,
            to_arrow=to_arrow,
            injector=injector,
            # children inherit this by fork: worker spans parent onto the
            # driver's map.parallel span so the tree stays connected
            trace_parent=tracer.current_span_id(),
        )
        try:
            with _quiet_fork_warnings():
                results, quarantined, failures = _supervise(
                    chunks, n_workers, chunk_timeout, policy, injector, stats
                )
            # quarantine phase: poison/exhausted chunks degrade to serial
            # in-driver execution, partition by partition, so the failure
            # report pinpoints the exact offending partitions
            report: Dict[int, str] = {}
            for ci in quarantined:
                tables: List[pa.Table] = []
                for no in chunks[ci]:
                    try:
                        tables.append(_serial([no])[0])
                    except Exception as ex:
                        history = "; ".join(failures.get(ci, []))
                        report[no] = (
                            f"{type(ex).__name__}: {ex}"
                            + (f" (pool attempts: {history})" if history else "")
                        )
                results[ci] = tables
                if not any(no in report for no in chunks[ci]):
                    stats.inc("map.serial_fallbacks")
            if report:
                raise ParallelMapError(report)
        finally:
            _FORK_STATE.clear()
    tables_out: List[pa.Table] = []
    for ci in range(len(chunks)):
        tables_out.extend(results[ci])
    return tables_out


def _supervise(
    chunks: List[Any],
    n_workers: int,
    chunk_timeout: float,
    policy: RetryPolicy,
    injector: FaultInjector,
    stats: ResilienceStats,
) -> Tuple[Dict[int, List[pa.Table]], List[int], Dict[int, List[str]]]:
    """Supervised dispatch of ``chunks`` over fork pools.

    Returns ``(results, quarantined_chunk_ids, failure_history)`` where
    ``results`` maps chunk id → decoded per-partition tables for every
    chunk that succeeded in a pool.
    """
    results: Dict[int, List[pa.Table]] = {}
    quarantined: List[int] = []
    failures: Dict[int, List[str]] = {}
    attempts: Dict[int, int] = {ci: 0 for ci in range(len(chunks))}
    pending: deque = deque(range(len(chunks)))

    def fail(ci: int, ex: BaseException) -> None:
        cat = classify_failure(ex)
        if cat is FailureCategory.FATAL:
            raise ex
        attempts[ci] += 1
        failures.setdefault(ci, []).append(
            f"attempt {attempts[ci]} [{cat.value}] {type(ex).__name__}: {ex}"
        )
        if policy.should_retry(cat, attempts[ci]):
            stats.inc("map.chunk_retries")
            pending.append(ci)
        else:
            stats.inc("map.quarantined_chunks")
            stats.inc("map.quarantined_partitions", len(chunks[ci]))
            quarantined.append(ci)

    # hard backstop against pathological requeue loops (e.g. a deadline
    # that keeps evicting collateral chunks): once crossed, everything
    # still pending degrades to the serial quarantine path
    max_waves = (policy.max_attempts + 1) * len(chunks) + 4
    wave = 0
    while pending:
        wave += 1
        if wave > max_waves:
            for ci in pending:
                stats.inc("map.quarantined_chunks")
                stats.inc("map.quarantined_partitions", len(chunks[ci]))
                quarantined.append(ci)
            pending.clear()
            break
        if wave > 1:
            stats.inc("map.pool_rebuilds")
        workers = _make_pool(min(n_workers, len(pending)))
        idle = list(workers)

        def take(w: _Worker) -> bool:
            """The finished chunk's payload off ``w``'s pipe; False when the
            pipe is closed (the worker died)."""
            try:
                ok, payload = w.results.recv()
            except (EOFError, OSError):
                return False
            ci, w.chunk = w.chunk, None
            try:
                if not ok:
                    raise payload
                results[ci] = _harvest_chunk(payload, stats)
                stats.inc("map.chunks_ok")
            except Exception as ex:
                fail(ci, ex)
            return True

        try:
            rebuild = False
            while (pending or len(idle) < len(workers)) and not rebuild:
                while pending and idle:
                    ci = pending.popleft()
                    try:
                        # driver-side injection site (synthetic dispatch
                        # errors); `kill` is driver-safe (degrades to raise)
                        injector.fire(SITE_MAP_DISPATCH)
                    except Exception as ex:
                        fail(ci, ex)
                        continue
                    w = idle.pop()
                    w.chunk, w.deadline = ci, Deadline.after(chunk_timeout)
                    w.tasks.send(chunks[ci])
                busy = [w for w in workers if w.chunk is not None]
                for conn in mp_connection.wait([w.results for w in busy], timeout=_POLL_INTERVAL):
                    w = next(w for w in busy if w.results is conn)
                    if take(w):
                        idle.append(w)
                busy = [w for w in workers if w.chunk is not None]
                late = [w for w in busy if w.deadline.expired]
                if late:
                    # a worker can't give up one chunk — tear down the
                    # wave; only the expired chunks are charged an attempt,
                    # collateral in-flight chunks requeue for free
                    for w in late:
                        stats.inc("map.deadline_expiries")
                        fail(w.chunk, ChunkTimeoutError(f"chunk exceeded {chunk_timeout}s deadline"))
                    pending.extend(w.chunk for w in busy if w not in late)
                    rebuild = True
                    break
                dead = [w for w in workers if w.proc.exitcode is not None]
                if dead:
                    # harvest whatever completed, then charge the chunks
                    # whose results can never arrive
                    stats.inc("map.worker_lost", len(dead))
                    for w in busy:
                        if not (w.results.poll() and take(w)):
                            ci, w.chunk = w.chunk, None
                            fail(
                                ci,
                                WorkerLostError(
                                    "pool worker died mid-chunk (exitcodes: "
                                    f"{[d.proc.exitcode for d in dead]})"
                                ),
                            )
                    rebuild = True
        finally:
            for w in workers:
                w.stop()
        if pending and wave < max_waves:
            # backoff before re-forking; seed by wave so concurrent maps
            # don't thunder in lockstep
            time.sleep(min(policy.delay(wave, seed=id(chunks)), 1.0))
    return results, quarantined, failures
