"""The bucket-at-a-time spill join and the spill repartition, copied from
``fugue_tpu/shuffle/join.py``.

Both sides stream through :mod:`.partitioner` into P buckets keyed by the
same normalized key hash; then buckets join one pair at a time: bucket i
of both sides is read onto the engine's device, joined there by the
engine's device join (``_join_device``, ``_full_outer_device``), its
result copied back to the host, and the pair's tensors dropped before the
next. The device holds one bucket pair and the join's intermediates,
whatever the size of the input.

Correctness: rows are hash-partitioned on the join key, so every key
lives in exactly one bucket pair and ``⋃ᵢ join(Lᵢ, Rᵢ) = join(L, R)`` (up
to row order) for every join that hash-partitions: inner, left_outer,
semi and anti directly, right_outer by mirroring, full_outer by the
engine's left_outer ∪ NULL-extended anti, each per bucket. NULL keys hash
to one fixed bucket and never match there (outer joins keep them). Cross
joins cannot hash-partition and refuse. A pair goes to the host engine
only where the JAX package's ``_host_bucket_join`` takes it: one side
empty (the NULL extension of an outer join), or key or column types the
device join refuses.

Unlike the JAX package, a bucket is read onto the device as it is, not
padded to one capacity: eager PyTorch compiles nothing, so buckets of
different sizes share no kernel to begin with. The pipelined consumer
still coalesces adjacent pairs into groups within the budget, which is
what bounds the launches (``group_joins``).

The device peak of a pair (``peak_device_bytes``; the JAX package sums
``jax.live_arrays()`` over the whole process) is measured on CUDA as the
high-water mark of ``torch.cuda.max_memory_allocated`` over the pair,
less the memory allocated when the join started; on the CPU as the bytes
of the tensors the pair holds. ``reset_peak_memory_stats`` is
process-wide, and an outer reader (a streamed verb over the join's
output, a harness's memory gate) reads the same peak, so the join keeps
the outer peak and restores the larger of the two when it ends
(:class:`_PeakMeter`).

The output is a one-pass stream of per-bucket arrow chunks in bucket
order, cast to the join's schema; the spill directory is removed when
the stream ends, fails or is abandoned, and on any failure while
partitioning.
"""

import os
import time
from typing import Any, Callable, Iterator, List, Optional

import pyarrow as pa

from ..dataframe import ArrowDataFrame, DataFrame, LocalDataFrameIterableDataFrame
from ..resilience import FaultInjector
from ..schema import Schema
from .partitioner import (
    SpilledSide,
    canonical_key_kinds,
    new_spill_dir,
    remove_spill_dir,
    spill_partition,
)
from .pipeline import MemBucketLedger, SpillPipeline
from .strategy import (
    bucket_count,
    device_budget_bytes,
    estimate_frame_bytes,
    mem_bucket_cap_bytes,
    pair_prefetch_depth,
    pipeline_enabled,
    spill_dir_root,
    writebehind_depth,
)

__all__ = ["shuffle_spill_join", "spill_repartition"]


def _chunk_rows(engine: Any) -> int:
    from ..constants import FUGUE_TPU_CONF_STREAM_CHUNK_ROWS
    from ..torch.streaming import DEFAULT_CHUNK_ROWS

    return int(engine.conf.get(FUGUE_TPU_CONF_STREAM_CHUNK_ROWS, DEFAULT_CHUNK_ROWS))


def _arrow_chunk_factory(engine: Any, df: DataFrame) -> Callable[[], Iterator[pa.Table]]:
    """A (re-)iterable arrow-chunk view of any frame: a stream's chunks, or
    a bounded frame whole (a device frame copied to the host once). For a
    one-pass stream it can run once; the caller says so by passing
    ``replay=None`` to the partitioner."""
    rows = _chunk_rows(engine)

    def gen() -> Iterator[pa.Table]:
        from ..torch.pipeline import engine_prefetcher
        from ..torch.streaming import _closing, _iter_local_frames

        chunks = engine_prefetcher(
            engine, (f.as_arrow() for f in _iter_local_frames(df, rows)), "shuffle"
        )
        yield from _closing(chunks)

    return gen


def _track_spill_dir(engine: Any, d: str, add: bool) -> None:
    dirs = getattr(engine, "_active_spill_dirs", None)
    if dirs is not None:
        (dirs.add if add else dirs.discard)(d)


def _spill_side(
    engine: Any,
    df: DataFrame,
    side: str,
    keys: List[str],
    kinds: List[str],
    n_buckets: int,
    spill_dir: str,
    injector: FaultInjector,
    parent_span: Optional[str],
    pipeline: Optional[SpillPipeline] = None,
) -> SpilledSide:
    from ..obs import get_tracer
    from ..torch.streaming import is_stream_frame

    stats = getattr(engine, "_shuffle_stats", None)
    factory = _arrow_chunk_factory(engine, df)
    replay = None if is_stream_frame(df) else factory
    pa_schema = Schema(df.schema).pa_schema
    with get_tracer().span("shuffle.partition", cat="shuffle", parent=parent_span, side=side) as sp:
        spilled = spill_partition(
            factory(),
            pa_schema,
            keys,
            kinds,
            n_buckets,
            spill_dir,
            side,
            injector=injector,
            stats=stats,
            replay=replay,
            pipeline=pipeline,
        )
        sp.set(
            rows=spilled.rows,
            buckets=sum(1 for r in spilled.bucket_rows if r > 0),
            bytes=spilled.bytes_spilled,
        )
        if pipeline is not None:
            sp.set(mem_buckets=len(spilled.mem_tables))
    return spilled


def _ingest(engine: Any, tbl: pa.Table) -> Any:
    """A bucket (or a group's concatenation) on the engine's device."""
    return engine.to_df(ArrowDataFrame(tbl))


class _PeakMeter:
    """The device peak of a spill join's pairs, as the rise above the
    memory allocated when the join started.

    On CUDA :meth:`window` resets the device's peak at a pair's (or a
    group's) start and :meth:`sample` reads ``max_memory_allocated``.
    ``reset_peak_memory_stats`` is process-wide, so the meter keeps the
    peak an outer reader would have seen and, in :meth:`close`, restores
    the larger of that and the join's own: it allocates the missing bytes
    once and frees them (the caching allocator rounds both figures to
    512 bytes, so the restored peak is exact). On the CPU :meth:`sample`
    is the bytes the pair's device frames hold (``device_nbytes``)."""

    def __init__(self, device: Any):
        import torch

        self._torch = torch
        self._dev = device
        self._cuda = device.type == "cuda"
        self.peak = 0
        if self._cuda:
            self._high = int(torch.cuda.max_memory_allocated(device))
            self._base = int(torch.cuda.memory_allocated(device))
            # the first window opens now: the producer may sample before
            # the consumer opens a pair's window
            torch.cuda.reset_peak_memory_stats(device)

    def window(self) -> None:
        if self._cuda:
            cuda = self._torch.cuda
            self._high = max(self._high, int(cuda.max_memory_allocated(self._dev)))
            cuda.reset_peak_memory_stats(self._dev)

    def sample(self, *frames: Any) -> int:
        if self._cuda:
            v = int(self._torch.cuda.max_memory_allocated(self._dev)) - self._base
        else:
            v = sum(int(getattr(f, "device_nbytes", 0)) for f in frames)
        self.peak = max(self.peak, v)
        return v

    def close(self) -> None:
        if not self._cuda:
            return
        cuda = self._torch.cuda
        now = int(cuda.max_memory_allocated(self._dev))
        if self._high > now:
            missing = self._high - int(cuda.memory_allocated(self._dev))
            bump = self._torch.empty(missing, dtype=self._torch.uint8, device=self._dev)
            del bump


def _to_out_table(res: Any, out_schema: Schema) -> pa.Table:
    """One bucket's join result in the stream's output schema (the device
    and host bucket paths must give interchangeable chunks)."""
    tbl = res.as_arrow() if isinstance(res, DataFrame) else res
    if list(tbl.schema.names) != list(out_schema.names):
        tbl = tbl.select(list(out_schema.names))
    if tbl.schema != out_schema.pa_schema:
        tbl = tbl.cast(out_schema.pa_schema)
    return tbl


def _host_bucket_join(
    engine: Any,
    lt: Optional[pa.Table],
    rt: Optional[pa.Table],
    l_schema: pa.Schema,
    r_schema: pa.Schema,
    jt: str,
    on: Any,
) -> Any:
    """The pairs the device does not join: types the device join refuses,
    and pairs with one side empty (an outer join's NULL extension with the
    host's exact types). The host engine's result per bucket equals a
    whole-frame host join's."""
    host = engine._host_engine
    ldf = ArrowDataFrame(lt if lt is not None else l_schema.empty_table())
    rdf = ArrowDataFrame(rt if rt is not None else r_schema.empty_table())
    return host.join(host.to_df(ldf), host.to_df(rdf), how=jt, on=on)


def _device_bucket_join(engine: Any, jl: Any, jr: Any, jt: str, on: Any, out_schema: Schema) -> Optional[Any]:
    """One bucket pair through the engine's device join; None: the caller
    joins the pair on the host engine."""
    from ..torch.execution_engine import _KERNEL_HOW

    if jt in _KERNEL_HOW:
        return engine._join_device(jl, jr, _KERNEL_HOW[jt], on)
    if jt == "right_outer":
        res = engine._join_device(jr, jl, "left_outer", on)
        if res is not None and list(res.schema.names) != list(out_schema.names):
            res = res[list(out_schema.names)]
        return res
    if jt == "full_outer":
        return engine._full_outer_device(jl, jr, on)
    return None


def _set_last_run(run: Any) -> None:
    from ..torch import streaming as _streaming

    _streaming.last_run_stats = dict(run, verb="shuffle_join")


def shuffle_spill_join(
    engine: Any,
    df1: DataFrame,
    df2: DataFrame,
    how: str,
    on: Any = None,
    tune: Any = None,
) -> Optional[DataFrame]:
    """Spill-partition both sides and join them bucket by bucket. Returns a
    one-pass stream of result chunks, or None where the join cannot
    hash-partition (a cross join, key types the partitioner cannot hash,
    no keys): the caller then takes the rest of its ladder.

    ``tune`` is the tuner's handle (``tuning/tuner.py`` ``ExchangeHandle``):
    it gives the bucket count that earlier runs of the plan calibrated
    (in place of the static ``budget / 32`` sizing) and takes this run's
    side sizes and pair peak. None (tuning off, a direct engine call)
    resolves as without it."""
    from ..dataframe.utils import get_join_schemas, parse_join_type
    from ..obs import get_tracer

    jt = parse_join_type(how)
    if jt == "cross":
        return None
    try:
        key_schema, out_schema = get_join_schemas(df1, df2, how=jt, on=on)
    except Exception:
        return None
    keys = list(key_schema.names)
    if len(keys) == 0:
        return None
    kinds = canonical_key_kinds(df1.schema, df2.schema, keys)
    if kinds is None:
        return None
    conf = engine.conf
    device = engine.device
    t_start = time.perf_counter()
    est1, est2 = estimate_frame_bytes(df1), estimate_frame_bytes(df2)
    est = max(est1 or 0, est2 or 0) or None
    n_buckets = bucket_count(conf, est, device)
    if tune is not None:
        n_buckets = tune.bucket_count(n_buckets)
    # the overlapped spill: one mem ledger and write-behind context for
    # both sides; the tuner may give a learned pair depth and tier size.
    # The kill switch leaves pipeline=None, the serial path.
    pipe_on = pipeline_enabled(conf)
    pair_depth = pair_prefetch_depth(conf, device)
    mem_cap = mem_bucket_cap_bytes(conf)
    if tune is not None and pipe_on:
        pair_depth, mem_cap = tune.pipeline_params(conf, pair_depth, mem_cap)
    stats = getattr(engine, "_shuffle_stats", None)
    pipeline = (
        SpillPipeline(MemBucketLedger(mem_cap), writebehind_depth(conf), stats) if pipe_on else None
    )
    root = spill_dir_root(conf)
    os.makedirs(root, exist_ok=True)
    spill_dir = new_spill_dir(root)
    _track_spill_dir(engine, spill_dir, True)
    injector = FaultInjector.from_conf(conf)
    tracer = get_tracer()
    parent = tracer.current_span_id()
    try:
        left = _spill_side(engine, df1, "left", keys, kinds, n_buckets, spill_dir, injector, parent, pipeline)
        right = _spill_side(engine, df2, "right", keys, kinds, n_buckets, spill_dir, injector, parent, pipeline)
    except BaseException:
        _track_spill_dir(engine, spill_dir, False)
        remove_spill_dir(spill_dir)
        if stats is not None:
            stats.inc("spill_dirs_cleaned")
        raise
    if stats is not None:
        stats.inc("joins_spill")
    if tune is not None:
        # the sides' real sizes (the partitioner saw every row): the
        # cardinalities the next run's strategy decision reads
        tune.observe_sides(left.bytes_spilled, right.bytes_spilled, left.rows, right.rows)
    l_schema = Schema(df1.schema).pa_schema
    r_schema = Schema(df2.schema).pa_schema

    def _cleanup() -> None:
        _track_spill_dir(engine, spill_dir, False)
        remove_spill_dir(spill_dir)
        if stats is not None:
            stats.inc("spill_dirs_cleaned")

    def gen() -> Iterator[Any]:
        run = {"chunks": 0, "rows": 0, "peak_device_bytes": 0, "buckets": n_buckets}
        meter = _PeakMeter(device)
        try:
            for i in range(n_buckets):
                with tracer.span("shuffle.bucket", cat="shuffle", parent=parent, bucket=i) as sp:
                    lt = left.read_bucket(i, stats)
                    rt = right.read_bucket(i, stats)
                    if lt is None and rt is None:
                        continue
                    meter.window()
                    res: Optional[Any] = None
                    jl = jr = None
                    if lt is not None and rt is not None:
                        jl, jr = _ingest(engine, lt), _ingest(engine, rt)
                        res = _device_bucket_join(engine, jl, jr, jt, on, out_schema)
                        if res is None:
                            jl = jr = None
                            res = _host_bucket_join(engine, lt, rt, l_schema, r_schema, jt, on)
                    elif jt in ("inner", "left_semi"):
                        continue  # one side empty: no matches, no output
                    else:
                        res = _host_bucket_join(engine, lt, rt, l_schema, r_schema, jt, on)
                    out = _to_out_table(res, out_schema)
                    # the peak while the pair and its result are still held
                    peak = meter.sample(jl, jr, res)
                    run["peak_device_bytes"] = meter.peak
                    res = jl = jr = None  # drop the pair before the next bucket
                    if stats is not None:
                        stats.inc("bucket_joins")
                        stats.inc("bucket_rows_out", out.num_rows)
                        stats.peak(peak)
                    sp.set(
                        rows_left=0 if lt is None else lt.num_rows,
                        rows_right=0 if rt is None else rt.num_rows,
                        rows_out=out.num_rows,
                    )
                run["chunks"] += 1
                run["rows"] += out.num_rows
                if out.num_rows > 0:
                    yield ArrowDataFrame(out)
        finally:
            meter.close()
            _cleanup()
            if tune is not None:
                tune.observe_run(run["peak_device_bytes"], time.perf_counter() - t_start)
            _set_last_run(run)

    def gen_pipelined() -> Iterator[Any]:
        """The overlapped consumer: bucket pairs flow through a bounded
        producer (the stream prefetcher) that reads, decodes and ingests
        pair group i+1 while the join runs group i. Adjacent pairs that
        both have rows coalesce into groups within the budget: keys never
        cross buckets, so ``join(concat Lᵢ, concat Rᵢ) = ⋃ᵢ join(Lᵢ, Rᵢ)``
        and one join covers many small buckets. A group is sized so that
        ``depth + 1`` groups in flight stay under the budget, from the
        measured peak of the groups before it."""
        from ..execution.prefetch import maybe_prefetch

        budget = device_budget_bytes(conf, device)
        inflight = max(1, pair_depth + 1)
        bpr_l = left.bytes_spilled / max(left.rows, 1)
        bpr_r = right.bytes_spilled / max(right.rows, 1)
        pair_bytes = max(left.max_bucket_rows, 1) * bpr_l + max(right.max_bucket_rows, 1) * bpr_r
        # group sizing is measured, not guessed: the first group is one
        # pair (the serial working set), and each group's peak sets the
        # next target: the budget over 2.5x the running-max peak a pair
        # for each group in flight, growing at most 2x a step. ``g_max``
        # guards from the ingest estimate: joins whose expansion dwarfs
        # their input stay near one pair a launch, because their measured
        # pair peak says so.
        g_max = max(1, min(64, int(budget / max(1.0, 2.0 * inflight * pair_bytes))))
        run = {"chunks": 0, "rows": 0, "peak_device_bytes": 0, "buckets": n_buckets, "pairs_per_group": 1}
        state = {"pair_peak": 0, "g": 1}
        meter = _PeakMeter(device)

        def _retarget() -> None:
            pp = state["pair_peak"]
            if pp <= 0:
                return
            g = int(budget / max(1.0, 2.5 * inflight * pp))
            state["g"] = max(1, min(g_max, g, state["g"] * 2))
            run["pairs_per_group"] = max(run["pairs_per_group"], state["g"])

        def build(batch: List[Any]) -> Any:
            lcat = batch[0][1] if len(batch) == 1 else pa.concat_tables([b[1] for b in batch])
            rcat = batch[0][2] if len(batch) == 1 else pa.concat_tables([b[2] for b in batch])
            jl, jr = _ingest(engine, lcat), _ingest(engine, rcat)
            # sampled on the producer's thread right after the ingest: a
            # prefetched group is on the device from now on and counts
            peak = meter.sample(jl, jr)
            if stats is not None:
                stats.peak(peak)
            return ("dev", [b[0] for b in batch], jl, jr, lcat, rcat)

        def produce() -> Iterator[Any]:
            batch: List[Any] = []
            for i in range(n_buckets):
                lt = left.read_bucket(i, stats)
                rt = right.read_bucket(i, stats)
                if lt is None and rt is None:
                    continue
                if lt is not None and rt is not None:
                    batch.append((i, lt, rt))
                    if len(batch) >= state["g"]:
                        yield build(batch)
                        batch = []
                elif jt in ("inner", "left_semi"):
                    continue  # one side empty: no matches, no output
                else:
                    if batch:  # flush first: the output stays in bucket order
                        yield build(batch)
                        batch = []
                    yield ("host", i, lt, rt)
            if batch:
                yield build(batch)

        it = maybe_prefetch(
            produce(),
            pair_depth,
            stats=getattr(engine, "pipeline_stats", None),
            verb="shuffle.pairs",
            stream=tune.sid if tune is not None else "",
            observer=tune.observe_pair_stream if tune is not None else None,
        )
        if stats is not None:
            stats.inc("pipelined_joins")
        try:
            for item in it:
                if item[0] == "host":
                    _, i, lt, rt = item
                    with tracer.span("shuffle.bucket", cat="shuffle", parent=parent, bucket=i) as sp:
                        res = _host_bucket_join(engine, lt, rt, l_schema, r_schema, jt, on)
                        out = _to_out_table(res, out_schema)
                        if stats is not None:
                            stats.inc("bucket_joins")
                            stats.inc("bucket_rows_out", out.num_rows)
                        sp.set(
                            rows_left=0 if lt is None else lt.num_rows,
                            rows_right=0 if rt is None else rt.num_rows,
                            rows_out=out.num_rows,
                        )
                else:
                    _, bids, jl, jr, lcat, rcat = item
                    item = None  # only the locals below hold the group now
                    with tracer.span(
                        "shuffle.bucket", cat="shuffle", parent=parent, bucket=bids[0], pairs=len(bids)
                    ) as sp:
                        meter.window()
                        res = _device_bucket_join(engine, jl, jr, jt, on, out_schema)
                        if res is None:
                            # the device join refuses the group (its types):
                            # a group is a union of buckets with disjoint
                            # keys, so one host join of the concatenations
                            # is exact
                            jl = jr = None
                            res = _host_bucket_join(engine, lcat, rcat, l_schema, r_schema, jt, on)
                        out = _to_out_table(res, out_schema)
                        peak = meter.sample(jl, jr, res)
                        state["pair_peak"] = max(state["pair_peak"], -(-peak // len(bids)))
                        _retarget()
                        rows_l, rows_r = lcat.num_rows, rcat.num_rows
                        res = jl = jr = lcat = rcat = None  # drop the group now
                        if stats is not None:
                            stats.inc("bucket_joins", len(bids))
                            stats.inc("group_joins")
                            stats.inc("bucket_rows_out", out.num_rows)
                            stats.peak(peak)
                        sp.set(rows_left=rows_l, rows_right=rows_r, rows_out=out.num_rows)
                run["chunks"] += 1
                run["rows"] += out.num_rows
                run["peak_device_bytes"] = meter.peak
                if out.num_rows > 0:
                    yield ArrowDataFrame(out)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            meter.close()
            run["peak_device_bytes"] = meter.peak
            left.release_mem()
            right.release_mem()
            _cleanup()
            if tune is not None:
                # the tuner calibrates the bucket count from a pair's
                # peak: normalize the grouped measure to one pair
                tune.observe_run(
                    state["pair_peak"] or run["peak_device_bytes"], time.perf_counter() - t_start
                )
                tune.observe_pipeline(
                    {
                        "pairs_per_group": run["pairs_per_group"],
                        "mem_bytes_used": pipeline.ledger.peak_bytes,
                        "mem_cap_bytes": pipeline.ledger.cap_bytes,
                        "mem_demotions": pipeline.ledger.demotions,
                    }
                )
            _set_last_run(run)

    chosen = gen_pipelined() if pipeline is not None else gen()
    return LocalDataFrameIterableDataFrame(chosen, schema=out_schema)


def spill_repartition(engine: Any, df: DataFrame, by: List[str], num: int = 0) -> Optional[DataFrame]:
    """Hash-repartition through the spill partitioner: a one-pass stream in
    which every key lies in exactly one chunk (bucket), in bucket order.
    None: key types the partitioner cannot hash."""
    from ..obs import get_tracer

    kinds = canonical_key_kinds(df.schema, df.schema, by)
    if kinds is None or len(by) == 0:
        return None
    conf = engine.conf
    device = engine.device
    n_buckets = int(num) if num and num > 0 else bucket_count(conf, estimate_frame_bytes(df), device)
    stats = getattr(engine, "_shuffle_stats", None)
    pipeline = (
        SpillPipeline(MemBucketLedger(mem_bucket_cap_bytes(conf)), writebehind_depth(conf), stats)
        if pipeline_enabled(conf)
        else None
    )
    root = spill_dir_root(conf)
    os.makedirs(root, exist_ok=True)
    spill_dir = new_spill_dir(root)
    _track_spill_dir(engine, spill_dir, True)
    injector = FaultInjector.from_conf(conf)
    parent = get_tracer().current_span_id()

    def _cleanup() -> None:
        _track_spill_dir(engine, spill_dir, False)
        remove_spill_dir(spill_dir)
        if stats is not None:
            stats.inc("spill_dirs_cleaned")

    try:
        side = _spill_side(engine, df, "part", by, kinds, n_buckets, spill_dir, injector, parent, pipeline)
    except BaseException:
        _cleanup()
        raise
    if stats is not None:
        stats.inc("repartitions_spill")
    schema = Schema(df.schema)

    def buckets() -> Iterator[Any]:
        for i in range(n_buckets):
            tbl = side.read_bucket(i, stats)
            if tbl is not None and tbl.num_rows > 0:
                yield ArrowDataFrame(tbl)

    def gen() -> Iterator[Any]:
        try:
            yield from buckets()
        finally:
            _cleanup()

    def gen_pipelined() -> Iterator[Any]:
        # one chunk a bucket still (every key in exactly one chunk), but
        # bucket i+1 is read and decoded in the background while the
        # consumer takes bucket i; mem-resident buckets skip the disk
        from ..execution.prefetch import maybe_prefetch

        it = maybe_prefetch(
            buckets(),
            pair_prefetch_depth(conf, device),
            stats=getattr(engine, "pipeline_stats", None),
            verb="shuffle.read",
        )
        try:
            yield from it
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            side.release_mem()
            _cleanup()

    chosen = gen_pipelined() if pipeline is not None else gen()
    return LocalDataFrameIterableDataFrame(chosen, schema=schema)
