#!/usr/bin/env python3
"""Drive the PyTorch port (fugue_tpu_torch) on one CUDA card.

Phases, each printing one JSON line; any failure exits non-zero:

1. device and build: the card's name and power limit, the seconds the
   port's CUDA sources take to build (one nvcc per source, all at once), and
   each kernel's registers, shared memory and spills as ptxas reports them;
2. kernels against their plain PyTorch versions: every hand kernel on
   2**20 + 37 rows at bucket counts 2 .. 2**18 and at the edge of its
   routes (the largest table of one block, the smallest of the global
   route), and at 2**20 + 3 buckets on 2**16 + 37 rows (the plain
   version's one-hot grows with the table), with skewed keys, invalid rows, and
   inf/NaN rows checked against a float64 numpy oracle, and on inputs whose
   starts are not 16-byte aligned;
3. the port's main path at full size: ``api.aggregate`` by one integer key
   with SUM/COUNT/AVG/MIN/MAX of a float32 column over 100,000,000 rows
   (BASELINE.json config #3's scale), once over 1,000 uniform keys and once
   over Zipf(1.1) keys filling the 2**18-bucket table, each checked against
   a float64 oracle on the host; the kernels' launch counts are set to 0
   just before and read just after;
4. times: the aggregate's wall time, and each kernel's route, its time
   beside its bound, its plain version's time and one PyTorch call's time;
5. profile: one aggregate per frame under ``torch.profiler``, for the
   device time by kernel and the device's idle share;
6. sorted_path: the sorted groupby and the encoded columns at full width,
   on TPC-H lineitem at scale factor 10 (15,000,000 orders, ~60M rows,
   built from ``--seed`` by dbgen's rules; its ingest seconds on a line of
   their own): ``q1-keys`` (two string keys, 4 groups), ``q18-orderkey``
   (one int64 key over ~6e7, 15M groups, the host merge) and ``shipmode``
   (one string key of 7 values: the dense partials route, B1 at 8
   buckets, MAX over dictionary codes), each checked against a float64
   oracle with the launch counts set to 0 just before and read just
   after, timed and traced once (device busy/idle share, top device
   operations, host time of the merge and decode); then B1 alone at
   ``shipmode``'s shape beside its bound and ``index_add_``;
7. select_path: the column expressions and the row-local verbs on
   ``sorted_path``'s lineitem frame, handed over (not built again), one
   line a cell: ``q1-select`` (TPC-H Q1 without the tax column:
   ``api.assign`` of ``disc_price``, then ``api.select`` of the grouped
   sums, averages and COUNT(*) by the two string flags, WHERE
   ``l_shipdate <= "1998-09-02"``: the device projection, the device
   filter with its date literal rewritten, the sorted groupby),
   ``q6-select`` (TPC-H Q6 as written: the five-term predicate on the
   device, the global SUM of an expression on the host over the rows that
   pass) and ``shipmode-where`` (a string predicate through the
   dictionary's lookup table, then the dense partials route under the
   mask: B1 twice a call, and HAVING on the host), each checked against a
   float64 numpy oracle that compares in each column's own type, with the
   launch counts set to 0 just before and read just after, timed (median
   of ``SELECT_REPS`` calls) beside its bound, traced once, and its
   filter (and Q1's projection) traced alone;
8. setop_path: the set verbs, ``sample`` and ``take`` on the same frame,
   one line a cell: ``distinct-flags-mode`` (``api.distinct`` of the
   three string flags), ``distinct-qty-disc`` (of two float32 columns),
   ``union-distinct-modes`` (``api.union`` of two filtered selects, then
   its distinct), ``intersect-qty-disc`` and ``subtract-qty-disc`` (the
   device distincts of two filtered selects, then the device semi and
   anti join on every column), ``take-top-price`` (100 rows by price
   desc, order key, ship date) and ``take-last-ship`` (10 by ship date
   desc, price desc), and ``sample-1pct`` (``frac=0.01``, its mask held
   bit for bit to the CPU draw at each end of the frame), each checked
   against a numpy oracle with the launch counts set to 0 just before and
   read just after, timed (median of ``SETOP_REPS`` calls) beside the
   bound of the bytes it reads, traced once, with its peak device memory;
   then ``stream-take`` and ``stream-distinct`` over a stream cut in scale
   to 2·10^7 rows in chunks of 4·10^6 (``--setop-stream-rows``), each
   against ``np.lexsort`` or ``np.unique``, and a take with no presort
   that stops after its first chunk;
9. sql_path: FugueSQL through ``api.fugue_sql`` on the same frame (the
   table ``lineitem``), one line a cell: ``sql-q1`` (TPC-H Q1 with ORDER BY
   l_returnflag, l_linestatus), ``sql-q6`` (Q6) and ``sql-shipmode-where``
   (the shipmode aggregate WHERE l_returnflag = 'R' HAVING SUM > 0: B1
   twice a call), each held against its select_path twin's oracle with
   the launch counts set to 0 just before and read just after (equal to
   the twin's), and ``sql-pipeline-4m`` (BASELINE.json config #2 as
   bench.py writes it: LOAD parquet of 4·10^6 rows, ``--sql-rows``, → SELECT
   WHERE/GROUP BY → TRANSFORM USING rescale) against a pandas oracle; each
   with its first call, the compile apart, the median of ``SQL_REPS``
   calls beside its twin's and the difference, and one traced call;
10. window_path: window functions through ``api.fugue_sql`` on the same
   frame, one line a cell: ``window-per-order`` (each order's lines
   ranked by price: RANK, DENSE_RANK, LAG and the order's total, WHERE
   l_discount > 0.05; ~15M partitions) and ``window-global`` (a global
   OVER by order key: RANK, the peer-frame running sum of the price and a
   RANGE 32 PRECEDING count), each through the device route (the pandas
   evaluator poisoned, the ``fugue::window_device`` span traced) against
   a numpy oracle of the generator's arrays with the launch counts set to
   0 just before and read just after, timed after a warm-up call (median
   of ``WINDOW_REPS`` calls and their range) beside the bound of the bytes it reads and
   writes, with its peak device memory and one traced call; then
   ``api.repartition`` by hash and per row (the frame's own tensors
   back) and a per-row transform of 1,000 rows against the host engine;
11. cogroup_path: zip and comap with a pandas cotransformer (BASELINE.json
   config #3's cogroup), one line a cell: ``cogroup-uniform-1k`` (cut in
   depth to 2·10^7 rows, ``--cogroup-rows``; ``k`` over 1,000 keys and ``v``
   float32 with 1% NaN, made on the card, zipped inner by ``k`` with 10^6
   rows over 1,100 keys through
   ``FugueWorkflow``: ``dag.zip(a, b, partition={"by": ["k"]})
   .transform(cogroup)``), ``sql-cogroup-uniform-1k`` (the same as
   FugueSQL ``TRANSFORM a, b PREPARTITION BY k USING cogroup``) and
   ``stream-cogroup`` (a key-sorted stream cut in scale to 8·10^6 rows in
   chunks of 4·10^6, ``--cogroup-stream-rows``, zipped with a bounded
   frame of 2·10^3 rows in shuffled order, cut in scale from 10^4), each against a ``np.bincount``
   oracle with the launch counts set to 0 just before and read just after
   (B1 and B2 launch 0 times here), timed (``cogroup-uniform-1k``: one
   call after the checked one; the other two: the checked call), with the
   copy to the host in
   seconds and bytes, the peak device memory and one traced call; then
   the tutorial's §2 block inside ``engine_context("torch")`` over
   sql_path's parquet frame, checked once against pandas;
12. transform_path: ``api.transform`` with ``Dict[str, torch.Tensor]``
   UDFs (``transform_udfs``) over frames of 100,000,000 rows built from
   ``--seed`` with numpy: ``map-keyless`` (elementwise), ``demean-dense``
   (bench.py's demean by 1,000 keys: the dense plan), ``demean-sorted``
   (the same over 1,000 keys spread over [0, 2**40): the sorted plan),
   ``window-presort`` (row_number, running sum and max, lag under a
   presort: the sorted plan and the log-step scan) and ``ridge-hpo``
   (bench.py's ridge fit over 32 configs: 21 group reductions a call),
   each checked against a float64 numpy oracle with the launch counts set
   to 0 just before and read just after, timed (median of
   ``TRANSFORM_REPS`` calls) beside its bound, and traced once; one line
   a frame;
13. join_path: the device joins at full width, one line a cell:
   ``north-star-100m`` (bench.py's ``_north_star`` in memory: the group
   means of 100,000,000 rows by ``api.aggregate``, joined back onto every
   row by ``api.join`` and subtracted by ``api.transform``),
   ``lineitem-orders-inner`` (lineitem SF10 inner its 15,000,000 orders:
   the unique probe), ``lineitem-orders-f`` (left_outer, then anti,
   against the orders whose status is F) and ``orders-lineitem-expand``
   (1,000,000 orders inner their lines: the expansion, cut in scale to
   stay under its 2**22 output rows), each checked against a host oracle
   with the launch counts set to 0 just before and read just after, its
   device syncs counted, timed (median of ``JOIN_REPS`` calls) beside its
   bound, and traced once;
14. host_path: the host engine behind the device engine, one line a cell:
   ``pandas-demean-1m`` (BASELINE.json config #1 as bench.py writes it:
   ``transform(pdf, demean, schema="*", partition={"by": ["k"]})`` with a
   pandas UDF over bench.py's ``_make_frame`` cut to 1,000,000 rows,
   pandas in and out, and a round trip through parquet, ``load_df`` and
   ``save_df``), ``pandas-demean-100m`` (the same UDF over the
   ``demean-dense`` frame, 10^8 rows on the card, beside the compiled
   map's time) and ``orders-lineitem-expand-sf10`` (15,000,000 orders
   inner their ~60M lines: past ``MAX_EXPAND_ROWS``, so the host join),
   each checked against a host oracle with the launch counts set to 0
   just before and read just after, timed, and traced once with the copy
   to the host, the pandas work and the copy back apart;
15. stream_path: the streaming paths at full size, one line a cell:
   ``north-star`` (bench.py's ``_north_star`` on the port: 10^9 rows made
   in chunks of 4·10^6 from ``default_rng(seed + i)`` and never held
   whole, streamed through the group means, then through the join of the
   means onto every row and the demean; bench.py's assertions, the means
   against a float64 oracle taken from the aggregate pass's chunks as they
   are made (on its producer thread), ``d`` on every 25th chunk; each pass's wall time, rows/s, the generator's host seconds,
   peak device bytes (under 1 GiB), the ingest pipeline's stats and a
   traced window of 6 chunks a pass, every thread's spans) and
   ``f32-aggregate`` (``--rows`` rows with ``v`` as float32, streamed into
   SUM/COUNT/AVG: B1 once a chunk, against a float64 oracle);
16. plan_path: the plan optimizer through ``FugueWorkflow`` on config
   #3's frame (``--rows`` rows, plus ``w`` float32), one line a cell with
   the PlanReport in short (pushdowns, prunes, fusions, segments lowered
   and executed): ``lowered-uniform-1k`` (``filter(v > 0.25) →
   select(k, v * w AS z) → aggregate`` of ``z``: one lowered segment, B1
   once a call), ``stream-lowered-f32`` (the same chain over the rows
   streamed in chunks of 4·10^6, ``--plan-stream-rows``: B1 once a chunk,
   the peak device bytes under 1 GiB), each beside its twin with
   ``fugue.tpu.plan.lower_segments=false``; ``unsigned-keys`` (``k`` as
   uint32 aggregated on the dense route, then a join of 10^6 rows by a
   uint64 key straddling 2**63) and ``sql-dialect`` (a FugueSQL query
   under the postgres compile dialect against its spark twin); each
   checked against a float64 numpy oracle and its twin, timed (median of
   ``PLAN_REPS`` calls) and traced once. sql_path's lines carry the same
   PlanReport summary;
17. analysis_path: the UDF analyzer on plan_path's frame, one line a cell:
   ``translated-uniform-1k`` (the module-level pandas UDF ``scale``
   through ``transform(scale, schema="*,z:float") → aggregate``: the
   analyzer translates it and the chain lowers into one segment, B1 once
   a call; its twin with ``fugue.tpu.plan.analyze_udfs=false`` runs the
   UDF in pandas on the host once, with its to-host / pandas / to-device
   split), ``stream-translated-f32`` (the same over the stream: B1 once a
   chunk, peak under 1 GiB), ``lowered-uint32`` (plan_path's chain keyed
   by a uint32 column with a plain uint32 SUM, bounded and streamed: one
   segment, none fallen back) and ``callback-1k`` (a pandas transform by
   1,000 keys over 10^6 rows whose callback counts 1,000 calls, and the
   workflow's ``lint()``); then a line of B1's time at each cell's shape
   beside one ``index_add_`` of the same values into the same ids;
18. obs_path: the span tracer, the trace export, the Prometheus text, the
   resource sampler, task retries and fault injection on plan_path's
   frame, one line a cell: ``traced-lowered`` (plan_path's lowered
   workflow on an engine whose conf turns on tracing, its profiler
   ranges, the trace directory and the sampler: the oracle; the span tree
   ``workflow.run`` → ``workflow.task`` → ``plan.segment`` / ``engine.*``;
   the exported file and the Prometheus page through their validators;
   the sampled device bytes between the frame's and the peak; one
   ``torch.profiler`` capture whose ``plan.segment`` range holds B1; the
   medians of 5 calls with tracing off and on, alternated),
   ``traced-stream`` (the chain over 2·10^7 streamed rows, cut in scale:
   a ``stream.chunk`` span a chunk under the segment, their rows summed,
   B1 once a chunk; off and on) and ``fault-retry`` (``task.execute``
   failing once, two attempts a task: the untraced run's result and one
   retry counted; then ``stream.chunk`` failing with no retry: the
   injected error, no producer thread left, the device bytes back);
19. services_path: the profiler hooks, the HTTP RPC server and the host
   map's fork pool, one line a cell: ``profiled-lowered`` (plan_path's
   lowered workflow inside ``profiled_engine_context`` and an
   ``annotate`` region, tracing off: the oracle, B1 once, the written
   Chrome trace holding one ``plan.segment`` range with B1's kernel inside
   and no ``fugue::plan_segment``), ``http-callback-1k`` (analysis_path's
   ``callback-1k`` with ``fugue.rpc.server`` naming the port's
   ``HttpRPCServer`` on loopback, beside the in-process cell; then
   ``rpc.request`` failing once under two attempts: one retry),
   ``http-scrape`` (``/metrics``, ``/metrics/snapshot``, ``/healthz``,
   ``/readyz``, ``/stats`` from the server the engine bound, after traced
   lowered calls that ``/metrics`` counts), ``pool-demean-1m``
   (BASELINE.json config #1 with ``fugue.tpu.map.parallelism`` at
   ``min(8, cpu_count)`` beside its serial twin), ``pool-demean-device-10m``
   (``demean-dense``'s frame cut in scale to 10^7 rows, on the card,
   forked after CUDA is initialized: oracle, twin, the copies and the
   pooled pandas apart) and ``pool-kill`` (a worker SIGKILLed: the twin's
   result, the recovery counted, no child left);
20. cache_path: the result cache, the delta cache and the tuner on
   plan_path's frame, written as 10 parquet files of 10^7 rows, through
   ``FugueWorkflow.run`` of ``LOAD dir → filter(v > 0.25) → select(k, v *
   w AS z) → aggregate`` (one lowered segment, B1 for SUM(z)), one line a
   cell: ``cache-cold`` (memory and disk tiers: a miss that publishes, B1
   once over every row), ``cache-warm-mem`` (the same engine: a memory
   hit, B1 0 times, one ``task.cache_hit`` span and no producer's),
   ``cache-warm-disk`` (a fresh engine on the same directory: a disk hit,
   B1 0 times), ``cache-delta`` (an 11th file: one
   ``task.delta_recompute`` over 10/11 partitions, B1 over the new rows
   only, against the oracle of all 11 files and the twin with the cache
   off; the device bytes of the memory tiers, and the device's allocated
   bytes back to the phase's start after ``clear()``; B1 alone at the
   delta's shape beside its bound and ``index_add_``) and ``tuned-stream``
   (2·10^7 rows streamed in chunks of 2^18, cut in scale, three runs with
   the tuner on beside a tuning-off twin: each run's chunks those
   ``adjust_stream`` gives, B1 once a chunk, the oracle; then B1 alone at
   each chunk shape beside ``index_add_``). Each line has its wall time,
   its B1 launches counted from 0 just before, ``engine.stats()["cache"]``
   and its spans. Its 11 files are handed over to serve_path;
21. serve_path: the serving layer and the standing views over
   cache_path's 11 files (1.1·10^8 rows), each submission ``LOAD dir →
   filter(v > t) → select(k, v * w AS z) → aggregate`` by ``k`` against a
   float64 oracle, one line a cell: ``serve-dedup`` (4 sessions, one plan:
   one execution, 3 deduped waiters, B1 once), ``serve-mixed`` (4 tenants,
   4 plans, priorities 0-3, two workers: B1 4 times, executions started in
   priority order, beside the four run one after another),
   ``serve-http`` (through ``ServeHttpClient`` on loopback: an idempotent
   replay, a 429 for a tenant whose budget lies below the first result's
   device bytes, ``/readyz`` and ``/stats``), ``serve-fleet`` (two
   replicas on two engines over one store, one plan to both at once: B1
   once across both) and ``serve-view`` (a standing view: generation 1
   over every row, then an appended file of 10^7 rows classified
   ``append`` and delta-served, ``/serve/view`` against the oracle of all
   12 files). Each line has each submission's queue wait and run time,
   B1's launches and the rows of each call, ``engine.stats()["serve"]``
   and the peak device bytes; at the end the device's allocated bytes are
   back to the phase's start, to the byte;
22. warehouse_path: config #2 on ``WarehouseTorchExecutionEngine``
   (``sqlite_torch``: the SQL in sqlite, the maps on the card) over
   config #2's frame in parquet, one line a cell: ``hybrid-pipeline-4m``
   (BASELINE config #2 verbatim, 4·10^6 rows, ``--sql-rows``; one call,
   against the pandas oracle, beside its twin ``sql-pipeline-4m``; B1 0)
   and ``hybrid-mixed-1m`` (cut in scale to 10^6 rows: SELECT WHERE in
   sqlite, a keyed torch UDF's map on the card, ``CONNECT torch``
   SUM/COUNT of the float32 ``z``, ORDER BY in sqlite; one call, checked,
   timed and split: the map on the card, ``z`` float32 after sqlite, B1 once a
   call inside the CONNECT step, its engine stopped, against a float64
   oracle), each with its wall time split, from the port's warehouse
   spans, into LOAD's ingest, the sqlite statements, ``fetch_arrow``, the
   device map, the ingest back, the CONNECT step and the temp tables'
   drops, the rows each moved, B1's launches and the peak
   device bytes; then B1 alone at the CONNECT step's shape; at the end no
   temp table is left and the device's allocated bytes are back to the
   phase's start, to the byte;
23. dist_path: the worker tier and the workflow's distributed pass: ``LOAD
   fact → filter(v > 0.25) → join(LOAD dim, on k) → select(g, v * w AS z)
   → aggregate`` by ``g`` on ``TorchExecutionEngine``, the join a fragment
   on three worker processes (``python -m fugue_tpu_torch.dist.worker``,
   fetch over HTTP), the ``select → aggregate`` segment on the card over
   the frame that lands (B1 once a run), one line a cell:
   ``dist-join-agg-10m`` (config #3's frame family cut in scale to 10^7
   rows in 16 parquet files, ``DIST_ROWS``; beside its twin with no
   board), ``dist-warm-10m`` (the same board: 0 tasks dispatched),
   ``dist-kill-2m`` (its own board and workers, one SIGKILLed while it
   holds a lease: WORKER_LOST re-dispatch, the steal in the event log),
   each against a float64 oracle with a zero audit and the wall time
   split into the fragment, the card's segment and the rest; then B1 at
   the segment's shape and the processes line (no worker held the card
   or is left running; device bytes back to the phase's start).

Every cell line of the phases before cache_path carries ``cache_hits``,
the result-cache hits the engines it ran on have served: it must be 0.
Cells whose input the cache would serve after their first call (a LOAD
of one file, a pandas frame under 64 MiB) run on engines with
``fugue.tpu.cache.enabled=false``, and the streamed cells that run through
workflows with ``fugue.tpu.tuning.enabled=false``, so they measure what
they measured.

Then a line with the run's seconds, a line ``{"kernels": [...]}`` and,
last, ``{"ok": true, "device": ...}``.
Run from the repository root: ``python3 chip_smoke.py [--seed 0]`` (``--rows
N`` cuts the dense, the transform and the north-star frames,
``--orders N`` the lineitem frames and ``--expand-orders N`` the expansion's, for a quick
try; ``--stream-rows N`` cuts the streamed north star, ``--setop-stream-rows N``
setop_path's streams, ``--sql-rows N`` sql_path's parquet file and the
engine-context check's, ``--cogroup-rows N`` and ``--cogroup-stream-rows N``
cogroup_path's frames, ``--plan-stream-rows N`` plan_path's stream;
``--sql-rows N`` cuts warehouse_path's config #2 cell too). With no CUDA
device, or outside the repository, it
exits non-zero and prints no result.
"""

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict

import pandas as pd  # the analysis_path UDFs' annotations: the analyzer reads their source

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3  # kernel vs plain: float32, other order
ORACLE_RTOL = 1e-4  # f32 atomics vs f64 oracle over ~1e5..1e7 rows a group
TIMING_REPS = 10  # medians of 10 timed calls, after a warm-up
SORTED_REPS = 3  # the sorted-path aggregates: medians of 3 calls, after the checked one
SELECT_REPS = 3  # select_path: medians of 3 calls, after the checked one
Q6_RTOL = 1e-9  # Q6's revenue: float64 products summed in another order
TRANSFORM_REPS = 5  # transform_path: medians of 5 calls, after the checked one
# transform outputs vs the float64 oracle: pandas' assert_frame_equal
# default, as the reference's tests compare; the ridge residuals with the
# absolute tolerance of bench.py's check
TRANSFORM_RTOL, TRANSFORM_ATOL, RIDGE_ATOL = 1e-5, 1e-8, 1e-6
# a running sum is a prefix sum over the whole frame (up to ~5e7 here) less
# the prefix at its group's start, as in the JAX package: one ulp of 5e7 is
# 7.5e-9, and a prefix sum taken in another order is off by a few
RUNNING_SUM_ATOL = 1e-6
TRACE_WINDOW_MS = 20  # transform_path: trace as many calls as fill this
# the engine's profiler ranges: its sub-verb steps, and the regions it
# names as the span tracer does (plan.segment, engine.join, engine.fused)
ENGINE_RANGES = ("fugue::", "engine.", "plan.")
TRANSFORM_KEYS, HPO_CONFIGS = 1000, 32
KERNEL_BUCKETS = (2, 5, 130, 1024, 12_289, 1 << 18, (1 << 20) + 3)
KERNEL_ROWS, KERNEL_ROWS_LARGE = (1 << 20) + 37, (1 << 16) + 37  # above 2**18 buckets
REPLACES = {
    "bin_sum": "fugue_tpu/ops/pallas_groupby.py:128 (_sum_kernel, via bin_sum_pallas :175)",
    "bin_sum_count": "fugue_tpu/ops/pallas_groupby.py:85 (_bin_kernel, via bin_sum_count_pallas :183)",
}


# a cell that would hit the cache (its input is a parquet file or a small
# pandas frame, fingerprinted) runs on an engine with the cache off and keeps
# measuring the compute it measured; a streamed cell keeps its static chunk size
NO_CACHE = {"fugue.tpu.cache.enabled": False}
STATIC_CHUNKS = {"fugue.tpu.tuning.enabled": False}


def emit(obj, *engines) -> None:
    """Print one line. Given the engines a cell ran on, the line carries
    ``cache_hits``, the result-cache hits (memory and disk) those engines
    have served since they were made (``engine.stats()["cache"]``), and a
    hit fails the run."""
    if engines:
        obj["cache_hits"] = sum(st["hits_mem"] + st["hits_disk"]
                                for st in (e.result_cache.stats.as_dict() for e in engines))
        require(obj["cache_hits"] == 0, f"{obj.get('cell', obj.get('phase'))}: {obj['cache_hits']} result-cache hits")
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def route_edges(bg, smem_optin: int) -> list:
    """Bucket counts at the edge of each kernel's routes: the largest table
    of one block and the smallest of the global route."""
    edges = set()
    for with_count in (False, True):
        largest = bg._largest_shared(with_count, smem_optin)
        edges.update((largest, largest + 1))
    return sorted(edges)


def phase_device(torch, build_all, kernel_resources) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = build_all()
    info = {
        "phase": "device",
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": build_s,
        "ptxas": kernel_resources("bin_groupby"),
        "allow_tf32": {"matmul": False, "cudnn": False},
    }
    emit(info)
    return info


def _oracle_sums(np, keys, vals, valid, buckets):
    """float64 per-bucket sums and counts, keys clipped as the contract says."""
    k = np.clip(keys, 0, buckets - 1)[valid]
    s = np.bincount(k, weights=vals[valid].astype(np.float64), minlength=buckets)
    c = np.bincount(k, minlength=buckets)
    return s, c


def _same_nonfinite(np, got, exp) -> bool:
    bad = ~np.isfinite(exp)
    return bool(
        (np.isfinite(got) == ~bad).all()
        and (np.isnan(got[bad]) == np.isnan(exp[bad])).all()
        and (got[bad & ~np.isnan(exp)] == exp[bad & ~np.isnan(exp)]).all()
    )


def phase_kernels(torch, np, bg, seed: int, dev) -> dict:
    """Every kernel against its plain version (and float64 oracle), on every
    route and on starts that are not 16-byte aligned."""
    rng = np.random.default_rng(seed)
    err = {"bin_sum": 0.0, "bin_sum_count": 0.0}
    cases = []
    bucket_counts = sorted(set(KERNEL_BUCKETS) | set(route_edges(bg, bg.smem_optin(dev))))
    routes = {b: [bg.route_of(b, w, dev).kind for w in (False, True)] for b in bucket_counts}
    for buckets in bucket_counts:
        n = KERNEL_ROWS if buckets <= 1 << 18 else KERNEL_ROWS_LARGE
        for dist in ("uniform", "zipf", "nonfinite", "offset"):
            if dist == "zipf":
                keys = ((rng.zipf(1.3, n) - 1) % (buckets + 2)).astype(np.int32)
            else:
                keys = rng.integers(-1, buckets + 1, n).astype(np.int32)  # clipped ends
            vals = rng.random(n, dtype=np.float32)
            valid = rng.random(n) > 0.1
            if dist == "nonfinite":
                rows = rng.choice(n, 6, replace=False)
                vals[rows] = [np.inf, -np.inf, np.nan, np.inf, np.nan, np.nan]
                valid[rows[:4]] = True
                valid[rows[4:]] = False  # NaN in invalid rows adds nothing
            tk, tv, tm = (torch.from_numpy(a).to(dev) for a in (keys, vals, valid))
            if dist == "offset":
                # keys, values and flags each start 1..3 elements into a
                # larger buffer: no common 16-byte alignment, the scalar path
                keys, vals, valid = keys[1:], vals[1:], valid[1:]
                tk = torch.cat([tk.new_zeros(2), tk])[3:]
                tv = torch.cat([tv.new_zeros(1), tv])[2:]
                tm = torch.cat([tm.new_zeros(3), tm])[4:]
            s1 = bg.bin_sum(tk, tv, tm, buckets)
            torch.cuda.synchronize()
            s2, c2 = bg.bin_sum_count(tk, tv, tm, buckets)
            torch.cuda.synchronize()
            r1 = bg.bin_sum_ref(tk, tv, tm, buckets)
            r2, rc2 = bg.bin_sum_count_ref(tk, tv, tm, buckets)
            torch.cuda.synchronize()
            s1, s2, c2, r1, r2, rc2 = (x.cpu().numpy() for x in (s1, s2, c2, r1, r2, rc2))
            exp_s, exp_c = _oracle_sums(np, keys, vals, valid, buckets)
            fin = np.isfinite(exp_s)
            for name, got, ref in (("bin_sum", s1, r1), ("bin_sum_count", s2, r2)):
                require(_same_nonfinite(np, got, exp_s), f"{name} b={buckets} {dist}: inf/NaN placement")
                require(_same_nonfinite(np, ref, exp_s), f"{name}_ref b={buckets} {dist}: inf/NaN placement")
                require(
                    np.allclose(got[fin], ref[fin], rtol=SUM_RTOL, atol=SUM_ATOL),
                    f"{name} b={buckets} {dist}: disagrees with its plain version",
                )
                require(
                    np.allclose(got[fin], exp_s[fin], rtol=SUM_RTOL, atol=SUM_ATOL),
                    f"{name} b={buckets} {dist}: disagrees with the float64 oracle",
                )
                if fin.any():
                    err[name] = max(err[name], float(np.abs(got[fin] - ref[fin]).max()))
            require((c2 == rc2).all() and (c2 == exp_c).all(), f"bin_sum_count b={buckets} {dist}: counts")
            require(c2.dtype == np.int32, "counts must be int32")
            cases.append(f"{buckets}/{dist}")
    out = {"phase": "kernels", "rows": [KERNEL_ROWS, KERNEL_ROWS_LARGE], "cases": cases,
           "routes": {str(b): r for b, r in routes.items()}, "max_abs_err": err,
           "tolerance": {"rtol": SUM_RTOL, "atol": SUM_ATOL}}
    emit(out)
    return out


def _make_frame(np, pd, rng, n: int, dist: str):
    if dist == "uniform":
        k = rng.integers(0, 1000, n, dtype=np.int64)  # bench.py's 1,000 groups
    else:
        k = (rng.zipf(1.1, n) - 1) % 200_000  # fills the 2**18-bucket table
    v = rng.random(n, dtype=np.float32)
    v[rng.random(n) < 0.01] = np.nan  # 1% NULL
    return pd.DataFrame({"k": k.astype(np.int64), "v": v})


def _oracle_agg(np, pd, pdf):
    k = pdf["k"].to_numpy()
    v = pdf["v"].to_numpy()
    nn = ~np.isnan(v)
    rows = np.bincount(k)
    n = np.bincount(k[nn], minlength=len(rows))
    s = np.bincount(k, weights=np.where(nn, v, 0).astype(np.float64), minlength=len(rows))
    keys = np.nonzero(rows > 0)[0]
    mm = pdf.groupby("k")["v"].agg(["min", "max"])
    exp = pd.DataFrame({"k": keys, "n": n[keys]})
    with np.errstate(invalid="ignore", divide="ignore"):
        exp["s"] = np.where(n[keys] > 0, s[keys], np.nan)
        exp["m"] = exp["s"] / np.where(n[keys] > 0, n[keys], np.nan)
    exp["lo"] = mm["min"].reindex(keys).to_numpy()
    exp["hi"] = mm["max"].reindex(keys).to_numpy()
    return exp


def _check_agg(np, got, exp, what: str) -> None:
    require(list(got.columns) == ["k", "s", "n", "m", "lo", "hi"], f"{what}: columns {list(got.columns)}")
    require(len(got) == len(exp), f"{what}: {len(got)} groups, expected {len(exp)}")
    require(np.array_equal(got["k"].to_numpy(), exp["k"].to_numpy()), f"{what}: keys")
    require(np.array_equal(got["n"].to_numpy(), exp["n"].to_numpy()), f"{what}: counts")
    for c in ("lo", "hi"):
        require(np.array_equal(got[c].to_numpy(), exp[c].to_numpy(), equal_nan=True), f"{what}: {c}")
    for c in ("s", "m"):
        g, e = got[c].to_numpy(), exp[c].to_numpy()
        require((np.isnan(g) == np.isnan(e)).all(), f"{what}: NULLs of {c}")
        ok = ~np.isnan(e)
        require(np.isfinite(g[ok]).all(), f"{what}: non-finite {c}")
        require(np.allclose(g[ok], e[ok], rtol=ORACLE_RTOL, atol=0), f"{what}: {c} vs oracle")


def phase_main_path(torch, np, pd, bg, api, ff, col, engine, seed: int, rows: int) -> dict:
    rng = np.random.default_rng(seed)
    frames, oracles = {}, {}
    for dist in ("uniform", "zipf"):
        pdf = _make_frame(np, pd, rng, rows, dist)
        oracles[dist] = _oracle_agg(np, pd, pdf)
        frames[dist] = engine.persist(engine.to_df(pdf))
        del pdf
    aggs = dict(s=ff.sum(col("v")), n=ff.count(col("v")), m=ff.avg(col("v")),
                lo=ff.min(col("v")), hi=ff.max(col("v")))
    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    results, per_call, first_s = {}, {}, {}
    for dist, tdf in frames.items():
        before = dict(bg.LAUNCHES)
        t0 = time.perf_counter()
        res = api.aggregate(tdf, partition_by="k", engine=engine, **aggs)
        torch.cuda.synchronize()
        first_s[dist] = time.perf_counter() - t0
        per_call[dist] = {k: bg.LAUNCHES[k] - before[k] for k in bg.LAUNCHES}
        results[dist] = res
    launches = dict(bg.LAUNCHES)
    for dist, res in results.items():
        require(per_call[dist]["bin_sum"] == 1, f"{dist}: bin_sum launched {per_call[dist]['bin_sum']} times, expected 1")
        require(str(res.schema) == "k:long,s:double,n:long,m:double,lo:float,hi:float", f"{dist}: schema {res.schema}")
        _check_agg(np, res.as_pandas(), oracles[dist], dist)
    out = {
        "phase": "main_path",
        "rows": rows,
        "groups": {d: len(o) for d, o in oracles.items()},
        "all_null_groups": {d: int(o["s"].isna().sum()) for d, o in oracles.items()},
        "first_call_s": first_s,
        "launches": launches,
        "launches_per_call": per_call,
        "checks": "keys, counts, min/max, NULLs exact; sum/avg rtol=1e-4 vs float64 oracle",
    }
    emit(out)
    return {"out": out, "frames": frames, "aggs": aggs}


# TPC-H lineitem at scale factor 10, by dbgen's rules (TPC-H spec 4.2.3):
# order dates uniform over [1992-01-01, 1998-12-31 - 151 days], 1..7 lines
# an order, quantity 1..50, part 1..SF*200,000, discount 0.00..0.10, ship
# date = order date + 1..121 days, receipt date = ship date + 1..30 days,
# return flag R or A at random if received by CURRENTDATE (1995-06-17) else
# N, line status O if shipped after CURRENTDATE else F, one of 7 ship modes.
# Days are counted from 1970-01-01.
SF10_ORDERS = 15_000_000
SF10_PARTS = 2_000_000
DAY_1992_01_01, DAY_1998_12_31, DAY_CURRENT = 8035, 10591, 9298
RETURNFLAGS = ("A", "N", "R")  # sorted: the port's dictionary codes
LINESTATUSES = ("F", "O")
SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")


def _strings(pa, codes, words):
    return pa.DictionaryArray.from_arrays(pa.array(codes), pa.array(words)).cast(pa.string())


def make_lineitem(np, pa, seed: int, orders: int = SF10_ORDERS, parts: int = SF10_PARTS):
    """``(table, aux)``: the lineitem columns the sorted-path aggregates
    read, as an arrow table (decimals as floats), and the per-row order
    index and dictionary codes for the oracle."""
    rng = np.random.default_rng(seed)
    i = np.arange(orders, dtype=np.int64)
    okey = (i // 8) * 32 + i % 8 + 1  # dbgen's sparse keys: 8 of every 32
    odate = rng.integers(DAY_1992_01_01, DAY_1998_12_31 - 151, orders, endpoint=True, dtype=np.int32)
    order = np.repeat(np.arange(orders, dtype=np.int32), rng.integers(1, 7, orders, endpoint=True))
    n = len(order)
    qty = rng.integers(1, 50, n, endpoint=True, dtype=np.int32)
    part = rng.integers(1, parts, n, endpoint=True, dtype=np.int64)
    price = (90_000 + (part // 10) % 20_001 + 100 * (part % 1_000)) / 100
    del part
    ship = odate[order] + rng.integers(1, 121, n, endpoint=True, dtype=np.int32)
    receipt = ship + rng.integers(1, 30, n, endpoint=True, dtype=np.int32)
    flag = np.where(receipt <= DAY_CURRENT, rng.integers(0, 2, n, dtype=np.int8) * 2, 1).astype(np.int8)
    del receipt
    status = (ship > DAY_CURRENT).astype(np.int8)
    mode = rng.integers(0, len(SHIPMODES), n, dtype=np.int8)

    tbl = pa.table({
        "l_orderkey": okey[order],
        "l_quantity": qty.astype(np.float32),
        "l_extendedprice": qty * price,
        "l_discount": (rng.integers(0, 10, n, endpoint=True) / 100).astype(np.float32),
        "l_shipdate": pa.array(ship, pa.int32()).cast(pa.date32()),
        "l_returnflag": _strings(pa, flag, RETURNFLAGS),
        "l_linestatus": _strings(pa, status, LINESTATUSES),
        "l_shipmode": _strings(pa, mode, SHIPMODES),
    })
    return tbl, {"order": order, "okey": okey, "odate": odate, "flag": flag, "status": status,
                 "mode": mode}


# sorted_path, join_path and host_path read the same SF10 lineitem, and
# the last two its orders: made once a run (three makes took ~38 s of
# numpy on the card's host) and dropped after host_path
_SHARED_TABLES: dict = {}


def shared_lineitem(np, pa, seed: int, orders: int):
    """``make_lineitem(np, pa, seed, orders)``, made once a run."""
    key = ("lineitem", seed, orders)
    if key not in _SHARED_TABLES:
        _SHARED_TABLES[key] = make_lineitem(np, pa, seed, orders)
    return _SHARED_TABLES[key]


def shared_orders(np, pa, seed: int, orders: int):
    """``(lineitem, aux, orders, oaux)``: ``shared_lineitem``'s frame with
    ``make_orders``' table (``oaux["totalprice"]`` its total prices), made
    once a run."""
    key = ("orders", seed, orders)
    if key not in _SHARED_TABLES:
        tbl, aux = shared_lineitem(np, pa, seed, orders)
        otbl, oaux = make_orders(np, pa, tbl, aux, seed)
        oaux["totalprice"] = otbl.column("o_totalprice").to_numpy()
        _SHARED_TABLES[key] = otbl, oaux
    return (*shared_lineitem(np, pa, seed, orders), *_SHARED_TABLES[key])


# TPC-H orders by dbgen's rules (TPC-H spec 4.2.3): one row per order of
# ``make_lineitem``'s ``aux``, customer keys 1..orders/10 skipping every
# multiple of 3, priority one of 5 at random, status F (every line F), O
# (every line O) or P, total price the sum of its lines' price after
# discount (tax left out).
ORDERPRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
ORDERSTATUSES = ("F", "O", "P")  # sorted: the port's dictionary codes


def make_orders(np, pa, lineitem, aux: dict, seed: int):
    """``(table, oaux)``: the orders of ``make_lineitem``'s frame, keyed by
    ``l_orderkey`` (dbgen's sparse ``o_orderkey``, named as lineitem names
    it, so the two join on it), and the customer, priority and status
    codes for the oracle."""
    rng = np.random.default_rng(seed + 1)
    orders = len(aux["okey"])
    i = rng.integers(0, max(1, orders // 10) * 2 // 3, orders, dtype=np.int64)
    custkey = i + i // 2 + 1  # the i-th integer that is not a multiple of 3
    priority = rng.integers(0, len(ORDERPRIORITIES), orders, dtype=np.int8)
    lines = np.bincount(aux["order"], minlength=orders)
    open_lines = np.bincount(aux["order"], weights=aux["status"], minlength=orders)
    status = np.where(open_lines == 0, 0, np.where(open_lines == lines, 1, 2)).astype(np.int8)
    net = lineitem.column("l_extendedprice").to_numpy() * (
        1 - lineitem.column("l_discount").to_numpy().astype(np.float64))
    tbl = pa.table({
        "l_orderkey": aux["okey"],
        "o_custkey": custkey,
        "o_orderdate": pa.array(aux["odate"], pa.int32()).cast(pa.date32()),
        "o_totalprice": np.bincount(aux["order"], weights=net, minlength=orders),
        "o_orderpriority": _strings(pa, priority, ORDERPRIORITIES),
        "o_orderstatus": _strings(pa, status, ORDERSTATUSES),
    })
    return tbl, {"custkey": custkey, "priority": priority, "status": status}


def sorted_path_aggs(ff, col) -> dict:
    """The three aggregates of the sorted-path phase: name → (keys, aggs)."""
    q, p, d = col("l_quantity"), col("l_extendedprice"), col("l_discount")
    return {
        "q1-keys": (["l_returnflag", "l_linestatus"], dict(
            sum_qty=ff.sum(q), sum_base_price=ff.sum(p), avg_qty=ff.avg(q),
            avg_price=ff.avg(p), avg_disc=ff.avg(d), count_order=ff.count(col("*")))),
        "q18-orderkey": (["l_orderkey"], dict(sum_qty=ff.sum(q))),
        "shipmode": (["l_shipmode"], dict(
            sum_qty=ff.sum(q), avg_disc=ff.avg(d), max_flag=ff.max(col("l_returnflag")),
            count_order=ff.count(col("*")))),
    }


def lineitem_oracles(np, pd, tbl, aux) -> dict:
    """float64 numpy answers of the three aggregates, keyed by name."""
    qty = tbl.column("l_quantity").to_numpy().astype(np.float64)
    price = tbl.column("l_extendedprice").to_numpy()
    disc = tbl.column("l_discount").to_numpy().astype(np.float64)
    out = {}
    gid = aux["flag"].astype(np.int64) * len(LINESTATUSES) + aux["status"]
    g = len(RETURNFLAGS) * len(LINESTATUSES)
    cnt = np.bincount(gid, minlength=g)
    sums = {c: np.bincount(gid, weights=w, minlength=g) for c, w in (("q", qty), ("p", price), ("d", disc))}
    have = np.nonzero(cnt)[0]
    out["q1-keys"] = pd.DataFrame({
        "l_returnflag": [RETURNFLAGS[x // len(LINESTATUSES)] for x in have],
        "l_linestatus": [LINESTATUSES[x % len(LINESTATUSES)] for x in have],
        "sum_qty": sums["q"][have], "sum_base_price": sums["p"][have],
        "avg_qty": sums["q"][have] / cnt[have], "avg_price": sums["p"][have] / cnt[have],
        "avg_disc": sums["d"][have] / cnt[have], "count_order": cnt[have],
    })
    out["q18-orderkey"] = pd.DataFrame({
        "l_orderkey": aux["okey"],
        "sum_qty": np.bincount(aux["order"], weights=qty, minlength=len(aux["okey"])),
    })
    m = len(SHIPMODES)
    cnt = np.bincount(aux["mode"], minlength=m)
    seen = np.bincount(aux["mode"].astype(np.int64) * len(RETURNFLAGS) + aux["flag"],
                       minlength=m * len(RETURNFLAGS)).reshape(m, len(RETURNFLAGS)) > 0
    have = np.nonzero(cnt)[0]
    out["shipmode"] = pd.DataFrame({
        "l_shipmode": [SHIPMODES[x] for x in have],
        "sum_qty": np.bincount(aux["mode"], weights=qty, minlength=m)[have],
        "avg_disc": np.bincount(aux["mode"], weights=disc, minlength=m)[have] / cnt[have],
        "max_flag": [RETURNFLAGS[np.nonzero(seen[x])[0].max()] for x in have],
        "count_order": cnt[have],
    })
    return out


def check_lineitem(np, got, exp, keys, what: str) -> None:
    """Keys, counts and MAX exact; sums and averages within ORACLE_RTOL."""
    require(list(got.columns) == list(exp.columns), f"{what}: columns {list(got.columns)}")
    got = got.sort_values(keys).reset_index(drop=True)
    require(len(got) == len(exp), f"{what}: {len(got)} groups, expected {len(exp)}")
    for c in exp.columns:
        g, e = got[c].to_numpy(), exp[c].to_numpy()
        if c in keys or c in ("count_order", "max_flag"):
            require(np.array_equal(g.astype(e.dtype), e), f"{what}: {c}")
        else:
            require(np.isfinite(g).all(), f"{what}: non-finite {c}")
            require(np.allclose(g, e, rtol=ORACLE_RTOL, atol=0), f"{what}: {c} vs oracle")


def _median_ms(torch, fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(n: int, row_bytes: int, out_bytes: int) -> tuple:
    """(least ms on the card, what bounds it): each input byte read once,
    each output byte written once, against one float32 add a row."""
    by_bytes = (n * row_bytes + out_bytes) / HBM_BYTES_PER_S
    by_ops = n / F32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def phase_times(torch, api, bg, engine, main: dict) -> dict:
    """Per frame: the aggregate's wall time, and each kernel at the shape
    the dense path gives it, beside its bound, its plain version and one
    PyTorch call. The plain version at 2**18 buckets would touch
    rows x 2**18 one-hot elements, so it is timed on the uniform frame only."""
    reps = TIMING_REPS
    out = {"phase": "times", "reps": reps, "frames": {}}
    for dist, tdf in main["frames"].items():
        n = tdf.count()
        wall = []
        api.aggregate(tdf, partition_by="k", engine=engine, **main["aggs"])
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.aggregate(tdf, partition_by="k", engine=engine, **main["aggs"])
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        agg_s = statistics.median(wall)
        # the kernels' inputs exactly as the dense path builds them
        kmin, kmax = tdf.key_range("k")
        buckets = 1 << (kmax - kmin + 1).bit_length()
        k, v, valid = tdf.device_cols["k"], tdf.device_cols["v"], tdf.device_valid_mask()
        ev = valid & ~torch.isnan(v)
        idx = torch.where(valid, k - kmin, buckets - 1).to(torch.int32)
        masked = torch.where(ev, v, 0.0)
        with_plain = dist == "uniform"
        kernels = []
        for name, run, plain, library, row_bytes, out_bytes in (
            (
                "bin_sum",
                lambda: bg.bin_sum_idx(idx, masked, buckets),
                lambda: bg.bin_sum_ref(idx, masked, None, buckets),
                lambda: torch.zeros(buckets, device=idx.device).index_add_(0, idx, masked),
                8, 4,
            ),
            (
                "bin_sum_count",
                lambda: bg.bin_sum_count(idx, v, ev, buckets),
                lambda: bg.bin_sum_count_ref(idx, v, ev, buckets),
                None,  # no one PyTorch call gives sums and counts together
                9, 8,
            ),
        ):
            bound_ms, bound_by = _bound(n, row_bytes, buckets * out_bytes)
            kernels.append({
                "name": name,
                "route": bg.route_of(buckets, name == "bin_sum_count", idx.device)._asdict(),
                "ms": _median_ms(torch, run, reps),
                "plain_ms": _median_ms(torch, plain, max(3, reps // 3)) if with_plain else None,
                "library_ms": None if library is None else _median_ms(torch, library, reps),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "shape": {"rows": n, "buckets": buckets},
            })
        # the aggregate reads k (8 B), v (4 B) and the valid mask (1 B) a row
        # and writes six columns and a mask per bucket
        agg_bound_ms, _ = _bound(n, 13, buckets * (8 + 8 + 8 + 8 + 4 + 4 + 1))
        out["frames"][dist] = {
            "aggregate_ms": agg_s * 1e3,
            "aggregate_rows_per_s": n / agg_s,
            "aggregate_bound_ms": agg_bound_ms,
            "kernels": kernels,
        }
    emit(out)
    return out


def phase_profile(torch, api, engine, main: dict) -> dict:
    """One aggregate per frame under ``torch.profiler``: device time by
    kernel, and the device's busy share of the call's wall time."""
    out = {"phase": "profile", "frames": {}}
    for dist, tdf in main["frames"].items():
        out["frames"][dist] = _trace(
            torch, lambda: api.aggregate(tdf, partition_by="k", engine=engine, **main["aggs"]))
    emit(out)
    return out


def _trace(torch, fn, calls: int = 1, all_threads: bool = False, warm_up=None) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler`` (one unless a call
    is too short to trace alone): per call, the device's busy and idle
    share of the wall time, the top device operations, and the host time of
    the engine's ranges (``fugue::*``, and ``engine.join``, ``engine.fused``
    and ``plan.segment``, which it opens with tracing off too). With ``all_threads`` the spans of every
    thread are recorded (the stream's producer threads), where this
    PyTorch's profiler offers it (``"all_threads"`` in the result says).

    One call runs first as the profiler's warm-up step, whose events are
    dropped: without it, kernels of the traced call went unrecorded (both
    of the keyless map's, some of the dense demean's). ``warm_up`` runs in
    its place where a call of ``fn`` is too long to run twice."""
    from torch.profiler import ProfilerActivity, profile, schedule

    extra, asked = {}, all_threads
    if all_threads:
        try:
            from torch._C._profiler import _ExperimentalConfig

            extra["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            all_threads = False
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1), **extra) as prof:
        (warm_up or fn)()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        prof.step()
    events = prof.key_averages()
    # the engine's ranges and the profiler's step appear on the device side
    # too, holding the device time of kernels inside them: only kernels and
    # copies count as busy
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
              and not e.key.startswith(ENGINE_RANGES + ("ProfilerStep",))]
    device.sort(key=lambda e: -e.device_time_total)
    busy_ms = sum(e.device_time_total for e in device) / 1e3 / calls
    return {
        "calls": calls,
        **({"all_threads": all_threads} if asked else {}),
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_ops": sum(e.count for e in device) / calls,
        "idle_share": (1 - busy_ms / wall_ms) if busy_ms > 0 else None,
        "by_kernel": [{"name": e.key[:80], "ms": e.device_time_total / 1e3 / calls,
                       "calls": e.count / calls} for e in device[:10]],
        "host_spans_ms": {e.key: e.cpu_time_total / 1e3 / calls for e in events
                          if e.key.startswith(ENGINE_RANGES) and e.device_type == torch.autograd.DeviceType.CPU},
    }


def phase_sorted_path(torch, np, pd, pa, bg, api, ff, col, engine, seed: int, orders: int) -> dict:
    """The sorted groupby and the encoded columns at full width: TPC-H
    lineitem at scale factor 10 (``make_lineitem``), three aggregates by
    ``api.aggregate``, each checked against a float64 oracle with its
    kernel launches counted from 0, timed (median of ``SORTED_REPS``
    calls) and traced once; then B1 alone at the shape ``shipmode`` gives
    it (8 buckets)."""
    t0 = time.perf_counter()
    tbl, aux = shared_lineitem(np, pa, seed, orders)
    generate_s = time.perf_counter() - t0
    oracles = lineitem_oracles(np, pd, tbl, aux)
    select_oracles = select_path_oracles(np, pd, tbl, aux)
    setop_oracles = setop_path_oracles(np, pd, pa, tbl, aux)
    window_arrays = window_path_arrays(np, tbl)
    t0 = time.perf_counter()
    tdf = engine.persist(engine.to_df(tbl))
    ingest_s = time.perf_counter() - t0
    rows = tbl.num_rows
    del tbl, aux
    tensors = list(tdf.device_cols.values()) + list(tdf.null_masks.values())
    emit({"phase": "sorted_path_ingest", "rows": rows, "orders": orders, "generate_s": generate_s,
          "ingest_s": ingest_s, "device_bytes": sum(t.numel() * t.element_size() for t in tensors),
          "encodings": {c: e["kind"] for c, e in tdf.encodings.items()}})
    out = {"phase": "sorted_path", "rows": rows, "reps": SORTED_REPS, "aggregates": {},
           "checks": f"keys, counts, MAX exact; sums/averages rtol={ORACLE_RTOL} vs float64 oracle"}
    for name, (by, aggs) in sorted_path_aggs(ff, col).items():
        def call():
            return api.aggregate(tdf, partition_by=by, engine=engine, **aggs)

        for k in bg.LAUNCHES:
            bg.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(bg.LAUNCHES)
        check_lineitem(np, res.as_pandas(), oracles[name], by, name)
        if name == "shipmode":
            require(launches["bin_sum"] == 2, f"shipmode: bin_sum launched {launches['bin_sum']} times, expected 2")
        groups = res.count()
        del res
        wall = []
        for _ in range(SORTED_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        out["aggregates"][name] = {
            "by": by, "groups": groups, "launches": launches, "first_call_s": first_s,
            "aggregate_ms": statistics.median(wall), "aggregate_ms_all": wall,
            "rows_per_s": rows / statistics.median(wall) * 1e3, "profile": _trace(torch, call),
        }
    # B1 alone, on the inputs the dense partials route builds for shipmode
    kmin, kmax = tdf.key_range("l_shipmode")
    buckets = 1 << (kmax - kmin + 1).bit_length()
    valid = tdf.device_valid_mask()
    idx = torch.where(valid, tdf.device_cols["l_shipmode"].to(torch.int64) - kmin, buckets - 1).to(torch.int32)
    masked = torch.where(valid, tdf.device_cols["l_quantity"], 0.0)
    bound_ms, bound_by = _bound(rows, 8, buckets * 4)
    out["bin_sum"] = {
        "route": bg.route_of(buckets, False, idx.device)._asdict(),
        "ms": _median_ms(torch, lambda: bg.bin_sum_idx(idx, masked, buckets), TIMING_REPS),
        "plain_ms": _median_ms(torch, lambda: bg.bin_sum_ref(idx, masked, None, buckets), 3),
        "library_ms": _median_ms(torch, lambda: torch.zeros(buckets, device=idx.device).index_add_(0, idx, masked),
                                 TIMING_REPS),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": {"rows": rows, "buckets": buckets},
        "launches_per_aggregate": out["aggregates"]["shipmode"]["launches"]["bin_sum"],
    }
    emit(out)
    # the frame and the oracles go on to select_path, setop_path, sql_path and window_path
    out["handover"] = {"frame": tdf, "oracles": select_oracles, "setop_oracles": setop_oracles,
                       "window_arrays": window_arrays}
    return out


# TPC-H Q1's and Q6's substitution parameters (TPC-H spec 2.4.1.3, 2.4.6.3):
# DELTA = 90 days before 1998-12-01; DATE = 1994-01-01, DISCOUNT = 0.06 ± 0.01,
# QUANTITY = 24
Q1_SHIPDATE = "1998-09-02"
Q6_DATES = ("1994-01-01", "1995-01-01")
Q6_DISCOUNT = (0.05, 0.07)
Q6_QUANTITY = 24


def select_path_cells(api, ff, col, engine) -> dict:
    """The three select_path cells: name → (``call(tdf)``, its WHERE, group
    keys, bytes a row of the columns it reads)."""
    q, p, d, s = col("l_quantity"), col("l_extendedprice"), col("l_discount"), col("l_shipdate")
    q1_where = s <= Q1_SHIPDATE
    q6_where = ((s >= Q6_DATES[0]) & (s < Q6_DATES[1]) & (d >= Q6_DISCOUNT[0])
                & (d <= Q6_DISCOUNT[1]) & (q < Q6_QUANTITY))
    ship_where = col("l_returnflag") == "R"

    def q1(tdf):
        a = api.assign(tdf, engine=engine, disc_price=p * (1 - d))
        return api.select(
            a, "l_returnflag", "l_linestatus", ff.sum(q).alias("sum_qty"),
            ff.sum(p).alias("sum_base_price"), ff.sum(col("disc_price")).alias("sum_disc_price"),
            ff.avg(q).alias("avg_qty"), ff.avg(p).alias("avg_price"), ff.avg(d).alias("avg_disc"),
            ff.count(col("*")).alias("count_order"), where=q1_where, engine=engine)

    def q6(tdf):
        return api.select(tdf, ff.sum(p * d).alias("revenue"), where=q6_where, engine=engine)

    def shipmode_where(tdf):
        return api.select(
            tdf, "l_shipmode", ff.sum(q).alias("sum_qty"), ff.avg(d).alias("avg_disc"),
            ff.count(col("*")).alias("count_order"), where=ship_where, having=ff.sum(q) > 0,
            engine=engine)

    # bytes a row: date 4, string codes 4, quantity 4, price 8, discount 4
    return {
        "q1-select": (q1, q1_where, ["l_returnflag", "l_linestatus"], 4 + 4 + 4 + 4 + 8 + 4),
        "q6-select": (q6, q6_where, [], 4 + 4 + 4 + 8),
        "shipmode-where": (shipmode_where, ship_where, ["l_shipmode"], 4 + 4 + 4 + 4),
    }


def select_path_oracles(np, pd, tbl, aux) -> dict:
    """float64 numpy answers of the three select_path cells, keyed by
    name. Each predicate compares in its column's own type, as both
    engines do: ``l_discount >= 0.05`` in float32 (a float64 comparison
    would drop the rows at 0.07, as float32(0.07) > 0.07)."""
    qty32 = tbl.column("l_quantity").to_numpy()
    price = tbl.column("l_extendedprice").to_numpy()
    disc32 = tbl.column("l_discount").to_numpy()
    ship = tbl.column("l_shipdate").to_numpy()
    out = {}
    m = ship <= np.datetime64(Q1_SHIPDATE)
    gid = (aux["flag"].astype(np.int64) * len(LINESTATUSES) + aux["status"])[m]
    g = len(RETURNFLAGS) * len(LINESTATUSES)
    cnt = np.bincount(gid, minlength=g)
    # 1 - l_discount is float32 on both engines, its product with the price float64
    disc_price = price[m] * (np.float32(1) - disc32[m]).astype(np.float64)
    sums = {c: np.bincount(gid, weights=w, minlength=g) for c, w in (
        ("q", qty32[m].astype(np.float64)), ("p", price[m]), ("dp", disc_price),
        ("d", disc32[m].astype(np.float64)))}
    have = np.nonzero(cnt)[0]
    out["q1-select"] = pd.DataFrame({
        "l_returnflag": [RETURNFLAGS[x // len(LINESTATUSES)] for x in have],
        "l_linestatus": [LINESTATUSES[x % len(LINESTATUSES)] for x in have],
        "sum_qty": sums["q"][have], "sum_base_price": sums["p"][have],
        "sum_disc_price": sums["dp"][have], "avg_qty": sums["q"][have] / cnt[have],
        "avg_price": sums["p"][have] / cnt[have], "avg_disc": sums["d"][have] / cnt[have],
        "count_order": cnt[have],
    })
    m = ((ship >= np.datetime64(Q6_DATES[0])) & (ship < np.datetime64(Q6_DATES[1]))
         & (disc32 >= np.float32(Q6_DISCOUNT[0])) & (disc32 <= np.float32(Q6_DISCOUNT[1]))
         & (qty32 < np.float32(Q6_QUANTITY)))
    out["q6-select"] = pd.DataFrame({"revenue": [float((price[m] * disc32[m].astype(np.float64)).sum())]})
    out["q6-rows"] = int(m.sum())
    m = aux["flag"] == RETURNFLAGS.index("R")
    k = len(SHIPMODES)
    mode = aux["mode"][m]
    cnt = np.bincount(mode, minlength=k)
    sq = np.bincount(mode, weights=qty32[m].astype(np.float64), minlength=k)
    have = np.nonzero((cnt > 0) & (sq > 0))[0]
    out["shipmode-where"] = pd.DataFrame({
        "l_shipmode": [SHIPMODES[x] for x in have],
        "sum_qty": sq[have],
        "avg_disc": np.bincount(mode, weights=disc32[m].astype(np.float64), minlength=k)[have] / cnt[have],
        "count_order": cnt[have],
    })
    return out


def phase_select_path(torch, np, bg, api, ff, col, engine, tdf, oracles: dict) -> dict:
    """The three select_path cells over the lineitem frame ``tdf``, one
    line each: checked against ``oracles`` with the launch counts set to 0
    just before the first call and read just after, timed (median of
    ``SELECT_REPS`` calls) beside the bound of the bytes of the columns it
    reads, traced once; and its filter alone (and Q1's projection alone)
    traced, for the device passes and time they take."""
    rows = tdf.count()
    out = {"cells": {}}
    for name, (fn, where, keys, row_bytes) in select_path_cells(api, ff, col, engine).items():
        def call(fn=fn):
            return fn(tdf)

        for k in bg.LAUNCHES:
            bg.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(bg.LAUNCHES)
        got = res.as_pandas()
        if name == "q6-select":
            require(list(got.columns) == ["revenue"] and len(got) == 1, f"q6-select: {got}")
            require(np.allclose(got["revenue"].to_numpy(), oracles[name]["revenue"].to_numpy(),
                                rtol=Q6_RTOL, atol=0), f"q6-select: revenue {got['revenue'][0]} vs oracle")
        else:
            check_lineitem(np, got, oracles[name], keys, name)
        if name == "shipmode-where":
            expected = 2 if engine.device.type == "cuda" else 0
            require(launches["bin_sum"] == expected,
                    f"shipmode-where: bin_sum launched {launches['bin_sum']} times, expected {expected}")
        del res, got
        wall = []
        for _ in range(SELECT_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        profile = _trace(torch, call)
        if name == "q1-select":
            # the WHERE and the projection run on the device: no row goes to the host
            require("fugue::to_host" not in profile["host_spans_ms"],
                    f"q1-select: a copy to the host {profile['host_spans_ms']}")
        bound_ms, bound_by = _bound(rows, row_bytes, 0)
        line = {
            "phase": "select_path", "cell": name, "rows": rows,
            "rows_selected": oracles["q6-rows"] if name == "q6-select" else int(oracles[name]["count_order"].sum()),
            "launches": launches, "first_call_s": first_s,
            "ms": statistics.median(wall), "ms_all": wall, "rows_per_s": rows / statistics.median(wall) * 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "checks": ("revenue rtol=1e-9" if name == "q6-select" else
                       f"keys, counts exact; sums/averages rtol={ORACLE_RTOL}") + " vs float64 oracle",
            "profile": profile,
            "filter_profile": _trace(torch, lambda w=where: engine.filter(tdf, w)),
        }
        if name == "q1-select":
            line["project_profile"] = _trace(torch, lambda: api.assign(
                tdf, engine=engine, disc_price=col("l_extendedprice") * (1 - col("l_discount"))))
        emit(line, engine)
        out["cells"][name] = line
    return out


# sql_path: FugueSQL on the port (``api.fugue_sql``): TPC-H Q1, Q6 and the
# shipmode WHERE aggregate over select_path's lineitem frame, each beside
# its select_path twin, and BASELINE.json config #2 as bench.py writes it
SQL_REPS = 3  # medians of 3 calls, after the checked one
SQL_PIPELINE_ROWS = 4_000_000  # bench.py's SQL_ROWS
SQL_PIPELINE_GROUPS = 1_000  # bench.py's N_GROUPS
SQL_PIPELINE_RTOL, SQL_PIPELINE_ATOL = 1e-5, 1e-8


def sql_path_queries() -> dict:
    """The FugueSQL texts of sql_path's lineitem cells: name → (text over
    the table ``lineitem``, its select_path twin).

    Q1 computes its discounted price in a derived table, as its twin's
    ``api.assign`` does: an aggregate over an expression
    (``SUM(l_extendedprice * (1 - l_discount))``, as TPC-H writes it)
    sends a grouped select to the host engine, on the JAX engine as on the
    port (``_plan_device_agg`` takes column arguments only)."""
    return {
        "sql-q1": (f"""
SELECT l_returnflag, l_linestatus,
       SUM(l_quantity) AS sum_qty, SUM(l_extendedprice) AS sum_base_price,
       SUM(disc_price) AS sum_disc_price,
       AVG(l_quantity) AS avg_qty, AVG(l_extendedprice) AS avg_price,
       AVG(l_discount) AS avg_disc, COUNT(*) AS count_order
FROM (SELECT *, l_extendedprice * (1 - l_discount) AS disc_price FROM lineitem) AS li
WHERE l_shipdate <= '{Q1_SHIPDATE}'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus""", "q1-select"),
        "sql-q6": (f"""
SELECT SUM(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= '{Q6_DATES[0]}' AND l_shipdate < '{Q6_DATES[1]}'
  AND l_discount BETWEEN {Q6_DISCOUNT[0]} AND {Q6_DISCOUNT[1]} AND l_quantity < {Q6_QUANTITY}""",
                   "q6-select"),
        "sql-shipmode-where": ("""
SELECT l_shipmode, SUM(l_quantity) AS sum_qty, AVG(l_discount) AS avg_disc, COUNT(*) AS count_order
FROM lineitem
WHERE l_returnflag = 'R'
GROUP BY l_shipmode
HAVING SUM(l_quantity) > 0""", "shipmode-where"),
    }


def sql_pipeline_text(path: str) -> str:
    """bench.py's ``_bench_sql_pipeline`` FugueSQL, verbatim, over ``path``."""
    return f"""
    src = LOAD "{path}"
    agg = SELECT k, SUM(v) AS s, COUNT(*) AS n FROM src WHERE w > 0.1 GROUP BY k
    TRANSFORM agg USING rescale SCHEMA k:long,s:double,n:long
    """


def sql_pipeline_frame(np, pd, rows: int = SQL_PIPELINE_ROWS, groups: int = SQL_PIPELINE_GROUPS):
    """bench.py's config #2 frame: ``default_rng(11)``, keys in [0, groups)."""
    rng = np.random.default_rng(11)
    return pd.DataFrame({"k": rng.integers(0, groups, rows), "v": rng.random(rows), "w": rng.random(rows)})


def sql_pipeline_oracle(pdf):
    """The pipeline's answer in pandas: the filtered group sums and counts,
    the sums over their largest, by key."""
    g = pdf[pdf["w"] > 0.1].groupby("k").agg(s=("v", "sum"), n=("v", "size")).reset_index()
    g["s"] = g["s"] / g["s"].max()
    return g


def check_sql_pipeline(np, got, exp) -> None:
    got = got.sort_values("k").reset_index(drop=True)
    require(list(got.columns) == ["k", "s", "n"], f"sql-pipeline: columns {list(got.columns)}")
    require(np.array_equal(got["k"].to_numpy(), exp["k"].to_numpy())
            and np.array_equal(got["n"].to_numpy(), exp["n"].to_numpy()), "sql-pipeline: keys or counts differ")
    require(np.allclose(got["s"].to_numpy(), exp["s"].to_numpy(), rtol=SQL_PIPELINE_RTOL,
                        atol=SQL_PIPELINE_ATOL), "sql-pipeline: s differs from the pandas oracle")


def phase_sql_path(torch, np, pd, bg, api, engine, tdf, oracles: dict, select_cells: dict,
                   pipeline_rows: int = SQL_PIPELINE_ROWS) -> dict:
    """FugueSQL through ``api.fugue_sql`` on the card, one line a cell:
    ``sql-q1``, ``sql-q6`` and ``sql-shipmode-where`` over the lineitem
    frame ``tdf`` (the table ``lineitem``), each held against its
    select_path twin's oracle, and ``sql-pipeline-4m`` (bench.py's config
    #2 text and ``rescale`` over a parquet file of ``pipeline_rows`` rows
    in a temporary directory of the checkout, removed after, on an engine
    with the result cache off) against a pandas oracle. Each line: the first call's seconds with the launch
    counts set to 0 just before and read just after (asserted equal to
    the twin's), the compile (building the workflow) timed apart, the
    median of ``SQL_REPS`` calls beside the twin's (``select_cells``) and
    their difference, the SQL layer's cost, and one traced call."""
    import shutil
    import tempfile
    from pathlib import Path

    import pyarrow as pa
    import pyarrow.parquet as pq

    from fugue_tpu_torch.torch import TorchExecutionEngine

    start = time.perf_counter()
    out = {"cells": {}}

    def rescale(df: pd.DataFrame) -> pd.DataFrame:
        df["s"] = df["s"] / df["s"].max()
        return df

    def run_cell(cell: str, call, compile_only, check, twin=None, rows=0, extra=None, eng=None) -> None:
        eng = eng or engine
        for k in bg.LAUNCHES:
            bg.LAUNCHES[k] = 0
        before = eng.plan_stats.as_dict()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(bg.LAUNCHES)
        # the optimizer's report of the same DAG, nothing run
        plan = _plan_summary(compile_only().plan_report(engine=eng), before, eng.plan_stats.as_dict())
        checks = check(res)
        del res
        if twin is not None:
            want = select_cells[twin]["launches"]
            require(launches == want, f"{cell}: launches {launches}, its twin {twin} {want}")
        if cell == "sql-shipmode-where":
            require(launches["bin_sum"] == (2 if eng.device.type == "cuda" else 0),
                    f"{cell}: bin_sum launched {launches['bin_sum']} times")
        compile_ms = []
        for _ in range(SQL_REPS):
            t0 = time.perf_counter()
            compile_only()
            compile_ms.append((time.perf_counter() - t0) * 1e3)
        wall = []
        for _ in range(SQL_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(wall)
        line = {"phase": "sql_path", "cell": cell, "rows": rows, "launches": launches, "plan": plan,
                "first_call_s": first_s, "compile_ms": statistics.median(compile_ms),
                "ms": ms, "ms_all": wall, "rows_per_s": rows / ms * 1e3, "checks": checks}
        if twin is not None:
            twin_ms = select_cells[twin]["ms"]
            line.update(twin=twin, twin_ms=twin_ms, sql_cost_ms=ms - twin_ms)
        line.update(extra or {})
        line["profile"] = _trace(torch, call)
        line["phase_s_so_far"] = time.perf_counter() - start
        emit(line, eng)
        out["cells"][cell] = line

    rows = tdf.count()
    for cell, (query, twin) in sql_path_queries().items():
        def call(query=query):
            return api.fugue_sql(query, lineitem=tdf, engine=engine, as_fugue=True)

        def compile_only(query=query):
            return api.fugue_sql_flow(query, lineitem=tdf)

        def check(res, cell=cell, twin=twin):
            got = res.as_pandas()
            if twin == "q6-select":
                require(list(got.columns) == ["revenue"] and len(got) == 1, f"{cell}: {got}")
                require(np.allclose(got["revenue"].to_numpy(), oracles[twin]["revenue"].to_numpy(),
                                    rtol=Q6_RTOL, atol=0), f"{cell}: revenue {got['revenue'][0]} vs oracle")
                return f"revenue rtol={Q6_RTOL} vs float64 oracle"
            keys = [c for c in got.columns if c.startswith("l_")]
            check_lineitem(np, got, oracles[twin], keys, cell)
            if twin == "q1-select":
                order = list(zip(got["l_returnflag"], got["l_linestatus"]))
                require(order == sorted(order), f"{cell}: not in ORDER BY order {order}")
            return f"keys, counts exact; sums/averages rtol={ORACLE_RTOL} vs float64 oracle"

        run_cell(cell, call, compile_only, check, twin=twin, rows=rows)

    # BASELINE config #2: LOAD parquet -> SELECT -> TRANSFORM, as bench.py writes it
    t0 = time.perf_counter()
    pdf = sql_pipeline_frame(np, pd, pipeline_rows)
    expected = sql_pipeline_oracle(pdf)
    tmp = Path(tempfile.mkdtemp(prefix=".sql_path_", dir=Path(__file__).resolve().parent))
    try:
        path = str(tmp / "bench.parquet")
        pq.write_table(pa.Table.from_pandas(pdf, preserve_index=False), path)
        del pdf
        setup_s = time.perf_counter() - t0
        sql = sql_pipeline_text(path)

        # a LOAD of one file: the cache would serve every call after the first
        nc_engine = TorchExecutionEngine(device=engine.device, conf=NO_CACHE)

        def run(engine):
            return api.fugue_sql(sql, rescale=rescale, engine=engine, as_fugue=True)

        def check(res):
            require(res.count() == len(expected), f"sql-pipeline-4m: {res.count()} groups")
            check_sql_pipeline(np, res.as_pandas(), expected)
            return (f"keys and counts exact; s rtol={SQL_PIPELINE_RTOL} atol={SQL_PIPELINE_ATOL} "
                    "vs a pandas oracle of the same frame")

        run_cell("sql-pipeline-4m", lambda: run(nc_engine), lambda: api.fugue_sql_flow(sql, rescale=rescale),
                 check, rows=pipeline_rows, extra={"groups": len(expected), "setup_s": setup_s}, eng=nc_engine)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - start
    return out


# window_path: FugueSQL window functions on the lineitem frame
WINDOW_REPS = 3  # medians of 3 calls, after the checked one
WINDOW_SUM_RTOL = 1e-9  # float64 sums in another order than the oracle's
WINDOW_PER_ROW_ROWS = 1_000


def window_path_queries() -> dict:
    """The two cells of window_path: name → SQL over the table ``lineitem``."""
    return {
        # each order's lines ranked by price (about 15M partitions of 1-7 rows)
        "window-per-order": (
            "SELECT l_orderkey, l_extendedprice, "
            "RANK() OVER (PARTITION BY l_orderkey ORDER BY l_extendedprice DESC) AS r, "
            "DENSE_RANK() OVER (PARTITION BY l_orderkey ORDER BY l_extendedprice DESC) AS dr, "
            "LAG(l_extendedprice, 1, 0.0) OVER (PARTITION BY l_orderkey ORDER BY l_extendedprice DESC) AS prev, "
            "SUM(l_extendedprice) OVER (PARTITION BY l_orderkey) AS order_total "
            "FROM lineitem WHERE l_discount > 0.05"),
        # a global OVER: one segment of every row, a peer-frame running sum
        # and a value-range frame
        "window-global": (
            "SELECT l_orderkey, RANK() OVER (ORDER BY l_orderkey) AS r, "
            "SUM(l_extendedprice) OVER (ORDER BY l_orderkey) AS running, "
            "COUNT(l_quantity) OVER (ORDER BY l_orderkey RANGE BETWEEN 32 PRECEDING AND CURRENT ROW) AS near "
            "FROM lineitem"),
    }


def window_path_arrays(np, tbl) -> dict:
    """The generator's columns the window oracles read, as numpy arrays."""
    return {c: tbl.column(c).to_numpy() for c in ("l_orderkey", "l_extendedprice", "l_discount", "l_quantity")}


def window_path_oracles(np, arrays: dict) -> dict:
    """Each window cell's rows, computed with numpy from the generator's
    arrays (the rows come grouped by order key, keys ascending): per
    order, its filtered lines by price descending, ranks from the starts
    of equal prices, the previous price (0.0 first) and the order's total;
    globally, the rank and running sum by order key and the count of lines
    whose key lies within 32 below."""
    okey, price = arrays["l_orderkey"], arrays["l_extendedprice"]
    require(bool((np.diff(okey) >= 0).all()), "window oracles: the generator's rows are not by order key")
    out = {}
    keep = arrays["l_discount"] > np.float32(0.05)  # float32 against a weak literal, as JAX compares
    k, p = okey[keep], price[keep]
    o = _order_by(np, np.cumsum(np.r_[True, k[1:] != k[:-1]]) - 1, -p)
    k, p = k[o], p[o]
    n = len(k)
    idx = np.arange(n)
    seg = np.r_[True, k[1:] != k[:-1]] if n else np.zeros(0, bool)
    peer = seg | np.r_[True, p[1:] != p[:-1]] if n else seg
    seg_start = np.maximum.accumulate(np.where(seg, idx, 0))
    dense = np.cumsum(peer)
    starts = np.flatnonzero(seg)
    out["window-per-order"] = {
        "l_orderkey": k, "l_extendedprice": p,
        "r": np.maximum.accumulate(np.where(peer, idx, 0)) - seg_start + 1,
        "dr": dense - dense[seg_start] + 1,
        "prev": np.where(seg, 0.0, np.r_[0.0, p[:-1]]),
        "order_total": np.repeat(np.add.reduceat(p, starts) if n else p, np.diff(np.r_[starts, n])),
    }
    n = len(okey)
    run_start = np.searchsorted(okey, okey, side="left")
    run_end = np.searchsorted(okey, okey, side="right") - 1
    out["window-global"] = {
        "l_orderkey": okey, "r": run_start + 1, "running": np.cumsum(price)[run_end],
        "near": run_end + 1 - np.searchsorted(okey, okey - 32, side="left"),
    }
    return out


def check_window(torch, np, res, exp: dict, what: str) -> str:
    """A window cell's rows against its oracle's, on the card: both sorted
    by (key, price descending, previous price) where they have them, the
    order key otherwise (rows of one key are then equal); ranks and counts
    exact, sums within WINDOW_SUM_RTOL."""
    require(res.schema.names == list(exp), f"{what}: columns {res.schema.names}")
    require(res.count() == len(exp["l_orderkey"]), f"{what}: {res.count()} rows, expected {len(exp['l_orderkey'])}")
    valid = res.device_valid_mask()
    dev = valid.device
    got = {c: res.device_cols[c][valid] for c in exp}
    want = {c: torch.from_numpy(np.require(a, requirements=["C", "W"])).to(dev) for c, a in exp.items()}

    def order(cols):
        perm = torch.arange(len(cols["l_orderkey"]), device=dev)
        keys = [cols["l_orderkey"]]
        if "prev" in cols:
            keys = [cols["l_orderkey"], -cols["l_extendedprice"], cols["prev"]]
        for key in reversed(keys):
            perm = perm[torch.sort(key[perm], stable=True).indices]
        return perm

    g, w = order(got), order(want)
    for c in exp:
        a, b = got[c][g], want[c][w].to(got[c].dtype)
        if a.is_floating_point() and c not in ("l_extendedprice", "prev"):
            require(bool(torch.isfinite(a).all()), f"{what}: non-finite {c}")
            require(bool(torch.allclose(a, b, rtol=WINDOW_SUM_RTOL, atol=0)), f"{what}: {c} vs the oracle")
        else:
            require(bool(torch.equal(a, b)), f"{what}: {c} differs from the oracle")
    return f"ranks, counts, keys, prices exact; sums rtol={WINDOW_SUM_RTOL} vs a numpy oracle"


def phase_window_path(torch, np, pd, bg, api, engine, tdf, arrays: dict) -> dict:
    """Window functions through ``api.fugue_sql`` on the card, one line a
    cell of ``window_path_queries`` over the lineitem frame ``tdf``: the
    first call with the pandas evaluator poisoned (the device route must
    answer) and the launch counts set to 0 just before and read just
    after, checked against ``window_path_oracles``; one warm-up call, then
    the median of ``WINDOW_REPS`` calls and their range; one traced call (its
    ``fugue::window_device`` span asserted); the bound of the bytes the
    cell reads and writes; the peak device memory. Then repartition,
    untimed: ``api.repartition`` by hash and per row returns the frame's
    own tensors, and a per-row transform of WINDOW_PER_ROW_ROWS rows equals
    the host engine's."""
    import unittest.mock as mock

    import fugue_tpu_torch.column.window as host_window

    from fugue_tpu_torch.execution import NativeExecutionEngine

    start = time.perf_counter()
    t0 = time.perf_counter()
    oracles = window_path_oracles(np, arrays)
    oracle_s = time.perf_counter() - t0
    out = {"cells": {}}
    rows = tdf.count()

    def poisoned(*a, **k):
        raise AssertionError("the pandas window evaluator ran on the device engine")

    for cell, query in window_path_queries().items():
        def call(query=query):
            return api.fugue_sql(query, lineitem=tdf, engine=engine, as_fugue=True)

        for k in bg.LAUNCHES:
            bg.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        with mock.patch.object(host_window, "eval_window", poisoned):
            res = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(bg.LAUNCHES)
        t0 = time.perf_counter()
        checks = check_window(torch, np, res, oracles[cell], cell)
        check_s = time.perf_counter() - t0
        out_rows = res.count()
        out_bytes = sum(t.element_size() for t in res.device_cols.values()) * out_rows
        del res
        call()  # warm-up: the check's device copies left the allocator's cache in other sizes
        wall = []
        for _ in range(WINDOW_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(wall)
        read = ("l_orderkey", "l_extendedprice", "l_discount") if cell == "window-per-order" else (
            "l_orderkey", "l_extendedprice", "l_quantity")
        row_bytes = sum(tdf.device_cols[c].element_size() for c in read)
        bound_ms, bound_by = _bound(rows, row_bytes, out_bytes)
        profile = _trace(torch, call)
        require("fugue::window_device" in profile["host_spans_ms"], f"{cell}: no fugue::window_device span")
        line = {"phase": "window_path", "cell": cell, "rows": rows, "rows_out": out_rows, "launches": launches,
                "first_call_s": first_s, "check_s": check_s, "ms": ms, "ms_range": [min(wall), max(wall)],
                "ms_all": wall, "rows_per_s": rows / ms * 1e3, "bound_ms": bound_ms, "bound_by": bound_by,
                "peak_device_gb": peak / 1e9, "peak_above_frame_gb": (peak - base) / 1e9, "checks": checks,
                "profile": profile, "phase_s_so_far": time.perf_counter() - start}
        emit(line, engine)
        out["cells"][cell] = line
    # repartition on one device: no row moves, no copy
    for spec in ({"by": ["l_orderkey"], "algo": "hash"}, "per_row"):
        rep = api.repartition(tdf, spec, engine=engine)
        require(rep.count() == rows and all(
            rep.device_cols[c].data_ptr() == tdf.device_cols[c].data_ptr() for c in tdf.schema.names),
            f"repartition {spec}: the rows were copied or changed")

    def size(df: pd.DataFrame) -> pd.DataFrame:
        return df.assign(n=len(df))

    small = pd.DataFrame({"l_orderkey": arrays["l_orderkey"][:WINDOW_PER_ROW_ROWS],
                          "l_extendedprice": arrays["l_extendedprice"][:WINDOW_PER_ROW_ROWS]})
    got = api.transform(engine.to_df(small), size, schema="*,n:long", partition="per_row", engine=engine)
    exp = api.transform(small, size, schema="*,n:long", partition="per_row", engine=NativeExecutionEngine())
    require(got.device.type == engine.device.type, "per_row transform: the result left the device")
    _same_rows(np, got.as_pandas(), exp, "per_row transform")
    require(bool((exp["n"] == 1).all()), "per_row transform: a partition of more than one row")
    out["repartition"] = {"checks": "hash and per_row: the frame's own tensors; per_row transform of "
                          f"{WINDOW_PER_ROW_ROWS} rows equals the host engine's"}
    out["oracle_s"] = oracle_s
    out["seconds"] = time.perf_counter() - start
    emit({"phase": "window_path_end", "oracle_s": oracle_s, "repartition": out["repartition"],
          "seconds": out["seconds"]})
    return out


# cogroup_path: zip and comap with a cotransformer (BASELINE config #3's
# cogroup), in memory through the workflow and FugueSQL, and streamed;
# then the tutorial's engine-context block
# a: cut in depth from config #3's 10^8 rows to 2·10^7, width kept: at 10^8
# the phase took 194 s on the card (a call 15.6-19.0 s), over its 180 s budget
COGROUP_ROWS, COGROUP_B_ROWS = 20_000_000, 1_000_000
COGROUP_KEYS, COGROUP_B_KEYS = 1_000, 1_100  # the second frame holds 100 keys the first lacks
# one timed call after the checked one: cut in depth from 3 (each ~5 s of
# pandas, one call a key) to make room for cache_path
COGROUP_REPS = 1
# the stream cut in scale, as setop_path's streams, then from 2·10^7 to
# 8·10^6 rows (2 chunks: keys still cross a chunk's end) to make room for
# services_path under the budget
COGROUP_STREAM_ROWS, COGROUP_STREAM_CHUNK = 8_000_000, 4_000_000
# ascending keys; the bounded frame holds each once, shuffled; cut in scale
# from 10^4 (~3 s of pandas a 1,000 keys) to make room for warehouse_path
COGROUP_STREAM_KEYS = 2_000
COGROUP_SCHEMA = "k:long,n_a:long,sum_v:double,n_b:long,mean_w:double"
COGROUP_SQL = f"r = TRANSFORM a, b PREPARTITION BY k USING cogroup SCHEMA {COGROUP_SCHEMA}"


def cogroup_oracle(np, ka, va, kb, wb):
    """The inner cogroup by ``np.bincount``, in float64: the keys of both
    frames, their rows in each, the sums of ``va`` without its NaN, the
    means of ``wb``."""
    size = int(max(ka.max(), kb.max())) + 1
    nn = ~np.isnan(va)
    n_a = np.bincount(ka, minlength=size)
    s_a = np.bincount(ka[nn], weights=va[nn].astype(np.float64), minlength=size)
    n_b = np.bincount(kb, minlength=size)
    s_b = np.bincount(kb, weights=wb, minlength=size)
    k = np.nonzero((n_a > 0) & (n_b > 0))[0]
    return {"k": k, "n_a": n_a[k], "sum_v": s_a[k], "n_b": n_b[k], "mean_w": s_b[k] / n_b[k]}


def check_cogroup(np, got, exp, what: str) -> str:
    got = got.sort_values("k").reset_index(drop=True)
    names = [f.split(":")[0] for f in COGROUP_SCHEMA.split(",")]
    require(list(got.columns) == names, f"{what}: columns {list(got.columns)}")
    require(len(got) == len(exp["k"]), f"{what}: {len(got)} keys, expected {len(exp['k'])}")
    for c in ("k", "n_a", "n_b"):
        require(np.array_equal(got[c].to_numpy(), exp[c]), f"{what}: {c} differs from the oracle")
    for c in ("sum_v", "mean_w"):
        g = got[c].to_numpy()
        require(np.isfinite(g).all() and np.allclose(g, exp[c], rtol=ORACLE_RTOL, atol=0),
                f"{what}: {c} vs oracle")
    return f"keys, counts exact; sum_v, mean_w rtol={ORACLE_RTOL} vs a float64 np.bincount oracle"


def _comap_split(profile: dict) -> dict:
    """A traced comap's host time: the copy to the host, the copy of the
    output back, and the pandas work between (grouping and the calls)."""
    spans = profile["host_spans_ms"]
    comap, to_host = spans.get("fugue::comap", 0.0), spans.get("fugue::comap_to_host", 0.0)
    to_device = spans.get("fugue::to_device", 0.0)
    return {"comap_ms": comap, "comap_to_host_ms": to_host, "to_device_ms": to_device,
            "pandas_ms": comap - to_host - to_device}


def phase_cogroup_path(torch, np, pd, bg, api, ff, col, frame_from_numpy, engine, seed: int,
                       rows: int = COGROUP_ROWS, b_rows: int = COGROUP_B_ROWS,
                       stream_rows: int = COGROUP_STREAM_ROWS, stream_chunk: int = COGROUP_STREAM_CHUNK,
                       stream_keys: int = COGROUP_STREAM_KEYS, ctx_rows: int = SQL_PIPELINE_ROWS) -> dict:
    """Zip and comap on the card, one line a cell: ``cogroup-uniform-1k``
    (``a``: ``rows`` rows, ``k`` over 1,000 keys and ``v`` float32 with 1%
    NaN, made on the card by ``frame_from_numpy`` from ``_make_frame``'s
    arrays; ``b``: ``b_rows`` rows, ``k`` over 1,100 keys and ``w``
    float64; ``dag.zip(a, b, partition={"by": ["k"]}).transform(cogroup)``),
    ``sql-cogroup-uniform-1k`` (the same in FugueSQL, ``TRANSFORM a, b
    PREPARTITION BY k USING cogroup``) and ``stream-cogroup`` (a stream of
    ``stream_rows`` rows in chunks of ``stream_chunk``, keys ascending over
    ``stream_keys``, zipped with a bounded frame of a row a key in shuffled
    order);
    each checked against a ``np.bincount`` oracle with the launch counts
    set to 0 just before the cell and read after it (0: no binned SUM on
    this path), timed (the in-memory cell: median of ``COGROUP_REPS``
    calls and their range; the others their checked call), with the seconds and
    bytes of the copy to the host, the checked call traced (its idle share
    and the comap's host spans) and the peak device memory. Then the
    tutorial's §2 block inside ``engine_context("torch")`` over a parquet
    file of ``ctx_rows`` rows (sql_path's frame) in a temporary directory
    of the checkout, removed after: checked once against pandas, not
    timed."""
    import shutil
    import tempfile
    from pathlib import Path

    import pyarrow as pa
    import pyarrow.parquet as pq

    from fugue_tpu_torch.collections import PartitionSpec
    from fugue_tpu_torch.dataframe import DataFrames, LocalDataFrameIterableDataFrame, PandasDataFrame
    from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
    from fugue_tpu_torch.torch.zipped import ZippedTorchDataFrame
    from fugue_tpu_torch.workflow import FugueWorkflow

    start = time.perf_counter()
    out = {"cells": {}}

    def cogroup(a: pd.DataFrame, b: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"k": [a["k"].iloc[0]], "n_a": [len(a)], "sum_v": [a["v"].sum()],
                             "n_b": [len(b)], "mean_w": [b["w"].mean()]})

    # the frames: a as the dense frames' uniform-1k, b with 100 keys more
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 12)
    pdf = _make_frame(np, pd, rng, rows, "uniform")
    ka, va = pdf["k"].to_numpy(), pdf["v"].to_numpy()
    del pdf
    kb = rng.integers(0, COGROUP_B_KEYS, b_rows, dtype=np.int64)
    wb = rng.random(b_rows)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ta = engine.persist(frame_from_numpy({"k": ka, "v": va}, "k:long,v:float", nan_cols=("v",),
                                         device=engine.device))
    tb = engine.persist(frame_from_numpy({"k": kb, "w": wb}, "k:long,w:double", nan_cols=(),
                                         device=engine.device))
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exp = cogroup_oracle(np, ka, va, kb, wb)
    oracle_s = time.perf_counter() - t0
    del ka, va, kb, wb
    frame_bytes = sum(t.numel() * t.element_size() for f in (ta, tb) for t in f.device_cols.values())
    small = (engine.to_df(pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]}).astype({"v": "float32"})),
             engine.to_df(pd.DataFrame({"k": [1, 2], "w": [3.0, 4.0]})))

    def by_dag(a, b):
        dag = FugueWorkflow()
        dag.zip(dag.df(a), dag.df(b), partition={"by": ["k"]}).transform(
            cogroup, schema=COGROUP_SCHEMA).yield_dataframe_as("r")
        return dag.run(engine).yields["r"].result

    def by_sql(a, b):
        return api.fugue_sql(COGROUP_SQL, a=a, b=b, cogroup=cogroup, engine=engine, as_fugue=True)

    def timed(fn, reps: int):
        wall = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        return wall

    require(isinstance(engine.zip(DataFrames(ta, tb), partition_spec=PartitionSpec(by=["k"])),
                       ZippedTorchDataFrame), "cogroup: the zip of the frames takes the blob protocol")
    for cell, run, reps in (("cogroup-uniform-1k", by_dag, COGROUP_REPS), ("sql-cogroup-uniform-1k", by_sql, 0)):
        for k in bg.LAUNCHES:
            bg.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the checked first call is the traced one (the small frames its
        # warm-up step), and the SQL cell's timed one too (reps 0)
        got = {}
        profile = _trace(torch, lambda: got.update(r=run(ta, tb)), warm_up=lambda: run(*small))
        res = got.pop("r")
        first_s = profile["wall_ms"] / 1e3
        peak = torch.cuda.max_memory_allocated()
        require(isinstance(res, TorchDataFrame) and res.device == engine.device,
                f"{cell}: the output is not on {engine.device}")
        checks = check_cogroup(np, res.as_pandas(), exp, cell)
        rows_out = res.count()
        del res
        wall = timed(lambda: run(ta, tb), reps) if reps else [first_s * 1e3]
        launches = dict(bg.LAUNCHES)
        require(launches == {k: 0 for k in launches}, f"{cell}: binned-sum launches {launches}")
        require("fugue::comap" in profile["host_spans_ms"], f"{cell}: no fugue::comap span")
        ms = statistics.median(wall)
        line = {"phase": "cogroup_path", "cell": cell, "rows": rows, "rows_b": b_rows, "rows_out": rows_out,
                "launches": launches, "generate_s": gen_s, "ingest_s": ingest_s, "oracle_s": oracle_s,
                "first_call_s": first_s, "ms": ms, "ms_range": [min(wall), max(wall)], "ms_all": wall,
                "rows_per_s": (rows + b_rows) / ms * 1e3, "to_host_bytes": frame_bytes,
                "split": _comap_split(profile), "peak_device_gb": peak / 1e9, "checks": checks,
                "profile": profile, "phase_s_so_far": time.perf_counter() - start}
        if cell.startswith("sql-"):
            # its traced call against the twin's timed one: both pay no
            # first call's setup, which the twin's first call pays
            twin = out["cells"]["cogroup-uniform-1k"]["ms"]
            line.update(twin="cogroup-uniform-1k", twin_ms=twin, sql_cost_ms=ms - twin)
        emit(line, engine)
        out["cells"][cell] = line
    del ta, tb, small
    torch.cuda.empty_cache()

    # stream-cogroup: a key-sorted stream against a bounded frame in any order
    n_keys = stream_keys
    per_key = max(stream_rows // n_keys, 1)
    stream_rows = per_key * n_keys

    def chunk(i: int):
        lo = i * stream_chunk
        hi = min(lo + stream_chunk, stream_rows)
        r = np.random.default_rng(seed + 1000 + i)
        v = r.random(hi - lo, dtype=np.float32)
        v[r.random(hi - lo) < 0.01] = np.nan
        return np.arange(lo, hi, dtype=np.int64) // per_key, v

    n_chunks = -(-stream_rows // stream_chunk)

    def stream(chunks: int = n_chunks):
        def gen():
            for i in range(chunks):
                k, v = chunk(i)
                yield PandasDataFrame(pd.DataFrame({"k": k, "v": v}), "k:long,v:float")

        return LocalDataFrameIterableDataFrame(gen(), schema="k:long,v:float")

    r = np.random.default_rng(seed + 13)
    dim = pd.DataFrame({"k": r.permutation(n_keys).astype(np.int64), "w": r.random(n_keys)})
    t0 = time.perf_counter()
    parts = [chunk(i) for i in range(n_chunks)]
    sexp = cogroup_oracle(np, np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]),
                          dim["k"].to_numpy(), dim["w"].to_numpy())
    del parts
    oracle_s = time.perf_counter() - t0
    # the cache would serve the bounded frame's create after the first run
    sengine = TorchExecutionEngine(device=engine.device, conf={"fugue.tpu.stream.chunk_rows": stream_chunk,
                                                               **STATIC_CHUNKS, **NO_CACHE})

    def stream_run(chunks: int = n_chunks):
        dag = FugueWorkflow()
        dag.zip(dag.df(stream(chunks)), dag.df(dim), partition={"by": ["k"]}).transform(
            cogroup, schema=COGROUP_SCHEMA).yield_dataframe_as("r", as_local=True)
        return dag.run(sengine).yields["r"].result

    from fugue_tpu_torch.torch import streaming

    for k in bg.LAUNCHES:
        bg.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = stream_run()
    got = res.as_pandas()
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    stats = dict(streaming.last_run_stats)
    peak = torch.cuda.max_memory_allocated()
    checks = check_cogroup(np, got, sexp, "stream-cogroup")
    require(stats.get("verb") == "comap" and stats["rows"] == stream_rows + n_keys,
            f"stream-cogroup: not the streamed comap ({stats})")
    profile = _trace(torch, lambda: stream_run(1).as_pandas(), warm_up=lambda: stream_run(1).as_pandas())
    launches = dict(bg.LAUNCHES)
    require(launches == {k: 0 for k in launches}, f"stream-cogroup: binned-sum launches {launches}")
    line = {"phase": "cogroup_path", "cell": "stream-cogroup", "rows": stream_rows, "rows_b": n_keys,
            "rows_out": len(got), "chunk_rows": stream_chunk, "chunks": n_chunks, "launches": launches,
            "oracle_s": oracle_s, "pass_s": pass_s, "ms": pass_s * 1e3,
            "rows_per_s": (stream_rows + n_keys) / pass_s, "stream_stats": stats,
            "peak_device_gb": peak / 1e9, "checks": checks,
            "profile_one_chunk": profile, "split_one_chunk": _comap_split(profile),
            "phase_s_so_far": time.perf_counter() - start}
    emit(line, sengine)
    out["cells"]["stream-cogroup"] = line
    del res, got

    # the tutorial's §2 block (docs/tutorial.md:46) in an engine context
    pdf = sql_pipeline_frame(np, pd, ctx_rows)
    expect = pdf[pdf["v"] > 0.5].groupby("k")["v"].sum()
    tmp = Path(tempfile.mkdtemp(prefix=".cogroup_path_", dir=Path(__file__).resolve().parent))
    try:
        src, dst = str(tmp / "data.parquet"), str(tmp / "out.parquet")
        pq.write_table(pa.Table.from_pandas(pdf, preserve_index=False), src)
        del pdf
        t0 = time.perf_counter()
        with api.engine_context("torch", device=engine.device) as e:
            big = api.load(src)
            flt = api.filter(big, col("v") > 0.5)
            agg = api.aggregate(flt, partition_by="k", s=ff.sum(col("v")))
            api.save(agg, dst, partition={"by": ["k"]})
            require(api.get_context_engine() is e and isinstance(e, TorchExecutionEngine)
                    and e.device == engine.device, "engine context: not the torch engine on the card")
            require(isinstance(agg, TorchDataFrame) and agg.device == e.device,
                    "engine context: the verbs did not run on the context engine")
        ctx_s = time.perf_counter() - t0
        back = pd.read_parquet(dst)
        back = back.assign(k=back["k"].astype(np.int64)).sort_values("k")
        require(np.array_equal(back["k"].to_numpy(), expect.index.to_numpy())
                and np.allclose(back["s"].to_numpy(), expect.to_numpy(), rtol=1e-9, atol=0),
                "engine context: the saved aggregate differs from pandas")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["engine_context"] = {"rows": ctx_rows, "seconds": ctx_s,
                             "checks": "keys exact, sums rtol=1e-9 vs pandas; verbs on the context engine"}
    out["seconds"] = time.perf_counter() - start
    emit({"phase": "cogroup_path_end", "engine_context": out["engine_context"], "seconds": out["seconds"]}, e)
    return out


# setop_path: the set verbs, sample and take on the lineitem frame, and
# two streamed cells cut in scale to SETOP_STREAM_ROWS rows
SETOP_REPS = 3  # medians of 3 calls, after the checked one
SAMPLE_SEED, SAMPLE_FRAC = 20261017, 0.01
SAMPLE_WINDOW = 1_000_000  # the card's mask held bit for bit at each end of the frame
SETOP_STREAM_ROWS, SETOP_STREAM_CHUNK = 20_000_000, 4_000_000
STREAM_KEYS = 1 << 17  # stream k uniform over [0, 2**17), b over [0, 8)


def setop_path_cells(api, col, engine) -> dict:
    """The in-memory cells of setop_path: name → (``call(tdf)``, the
    columns it reads: a take's are its sort keys, in order). Each call
    takes the lineitem frame."""
    q, d = col("l_quantity"), col("l_discount")
    flag, mode = col("l_returnflag"), col("l_shipmode")

    def qd_side(tdf, where):
        return api.select(tdf, "l_quantity", "l_discount", where=where, engine=engine)

    def sides(tdf):
        return (qd_side(tdf, (flag == "R") & (q <= 40)), qd_side(tdf, (mode == "MAIL") & (d >= 0.05)))

    return {
        "distinct-flags-mode": (
            lambda tdf: api.distinct(api.select(tdf, "l_returnflag", "l_linestatus", "l_shipmode",
                                                engine=engine), engine=engine),
            ["l_returnflag", "l_linestatus", "l_shipmode"]),
        "distinct-qty-disc": (
            lambda tdf: api.distinct(api.select(tdf, "l_quantity", "l_discount", engine=engine), engine=engine),
            ["l_quantity", "l_discount"]),
        "union-distinct-modes": (
            lambda tdf: api.union(
                api.select(tdf, "l_returnflag", "l_shipmode", where=q < 10, engine=engine),
                api.select(tdf, "l_returnflag", "l_shipmode", where=d >= 0.09, engine=engine), engine=engine),
            ["l_returnflag", "l_shipmode", "l_quantity", "l_discount"]),
        "intersect-qty-disc": (lambda tdf: api.intersect(*sides(tdf), engine=engine),
                               ["l_returnflag", "l_shipmode", "l_quantity", "l_discount"]),
        "subtract-qty-disc": (lambda tdf: api.subtract(*sides(tdf), engine=engine),
                              ["l_returnflag", "l_shipmode", "l_quantity", "l_discount"]),
        "take-top-price": (
            lambda tdf: api.take(tdf, 100, presort="l_extendedprice desc, l_orderkey, l_shipdate", engine=engine),
            ["l_extendedprice", "l_orderkey", "l_shipdate"]),
        "take-last-ship": (
            lambda tdf: api.take(tdf, 10, presort="l_shipdate desc, l_extendedprice desc", engine=engine),
            ["l_shipdate", "l_extendedprice"]),
        "sample-1pct": (lambda tdf: api.sample(tdf, frac=SAMPLE_FRAC, seed=SAMPLE_SEED, engine=engine), []),
    }


def _top_rows(np, keys_desc, n: int):
    """The indices of the first ``n`` rows by ``keys_desc`` (``(array,
    descending)`` pairs, the first the most significant), the row index
    last: the candidates at or above the first key's n-th value, then
    ``np.lexsort``."""
    first, desc = keys_desc[0]
    image = -first.astype(np.float64) if desc else first.astype(np.float64)
    cut = np.partition(image, n - 1)[n - 1]
    cand = np.nonzero(image <= cut)[0]
    lex = [cand] + [(-k[cand].astype(np.float64) if dsc else k[cand]) for k, dsc in reversed(keys_desc)]
    return cand[np.lexsort(lex)][:n]


def setop_path_oracles(np, pd, pa, tbl, aux) -> dict:
    """The answers of setop_path's in-memory cells, from the generator's
    codes and the table's columns: distinct rows and set operations by
    ``np.bincount`` over combined codes (sorted frames), the takes as the
    table's rows by ``np.lexsort`` with the row index last."""
    qty, disc = tbl.column("l_quantity").to_numpy(), tbl.column("l_discount").to_numpy()
    qi, di = qty.astype(np.int64), np.rint(disc.astype(np.float64) * 100).astype(np.int64)
    flag, status, mode = aux["flag"].astype(np.int64), aux["status"].astype(np.int64), aux["mode"].astype(np.int64)
    ns, nm = len(LINESTATUSES), len(SHIPMODES)

    def present(codes, size, mask=None):
        return set(np.nonzero(np.bincount(codes if mask is None else codes[mask], minlength=size))[0].tolist())

    def qd(codes):
        idx = np.array(sorted(codes), dtype=np.int64)
        return pd.DataFrame({"l_quantity": (idx // 11).astype(np.float32),
                             "l_discount": ((idx % 11) / 100).astype(np.float32)})

    out = {}
    fsm = present((flag * ns + status) * nm + mode, len(RETURNFLAGS) * ns * nm)
    out["distinct-flags-mode"] = pd.DataFrame(
        [(RETURNFLAGS[x // (ns * nm)], LINESTATUSES[x // nm % ns], SHIPMODES[x % nm]) for x in sorted(fsm)],
        columns=["l_returnflag", "l_linestatus", "l_shipmode"])
    pair = qi * 11 + di  # quantity 1..50, discount 0.00..0.10
    out["distinct-qty-disc"] = qd(present(pair, 51 * 11))
    fm = flag * nm + mode
    modes = present(fm, len(RETURNFLAGS) * nm, qty < np.float32(10)) | present(
        fm, len(RETURNFLAGS) * nm, disc >= np.float32(0.09))
    out["union-distinct-modes"] = pd.DataFrame([(RETURNFLAGS[x // nm], SHIPMODES[x % nm]) for x in sorted(modes)],
                                               columns=["l_returnflag", "l_shipmode"])
    a = present(pair, 51 * 11, (flag == RETURNFLAGS.index("R")) & (qty <= np.float32(40)))
    b = present(pair, 51 * 11, (mode == SHIPMODES.index("MAIL")) & (disc >= np.float32(0.05)))
    out["intersect-qty-disc"], out["subtract-qty-disc"] = qd(a & b), qd(a - b)
    price, okey = tbl.column("l_extendedprice").to_numpy(), tbl.column("l_orderkey").to_numpy()
    ship = tbl.column("l_shipdate").cast(pa.int32()).to_numpy()
    out["take-top-price"] = tbl.take(_top_rows(np, [(price, True), (okey, False), (ship, False)], 100))
    out["take-last-ship"] = tbl.take(_top_rows(np, [(ship, True), (price, True)], 10))
    return out


def _same_rows(np, got, exp, what: str) -> None:
    """Two pandas frames with the same columns hold the same rows."""
    require(list(got.columns) == list(exp.columns) and len(got) == len(exp),
            f"{what}: {list(got.columns)} {len(got)} rows vs {list(exp.columns)} {len(exp)}")
    cols = list(exp.columns)
    g = got.sort_values(cols).reset_index(drop=True)
    e = exp.sort_values(cols).reset_index(drop=True)
    for c in cols:
        require(np.array_equal(g[c].to_numpy(), e[c].to_numpy().astype(g[c].to_numpy().dtype)),
                f"{what}: column {c} differs from the oracle")


def _same_take(got, exp, keys, what: str) -> None:
    """A take against its oracle (arrow tables): the key columns in order,
    and the whole rows as a set."""
    got, exp = got.replace_schema_metadata(None), exp.replace_schema_metadata(None)
    require(got.schema.equals(exp.schema) and got.num_rows == exp.num_rows, f"{what}: {got.schema} vs {exp.schema}")
    require(got.select(keys).equals(exp.select(keys)), f"{what}: the key columns differ from the oracle")
    order = [(c, "ascending") for c in exp.column_names]
    require(got.sort_by(order).equals(exp.sort_by(order)), f"{what}: the rows differ from the oracle")


def check_sample(torch, np, uniform, res, tdf, what: str) -> dict:
    """A sample of the lineitem frame: its count within 6 sigma of n·frac,
    and its mask, at each end of the frame, bit for bit the port's CPU
    draw (``ops.random.uniform``) ANDed with the frame's validity."""
    n = tdf.count()
    mean, sigma = n * SAMPLE_FRAC, (n * SAMPLE_FRAC * (1 - SAMPLE_FRAC)) ** 0.5
    got = res.count()
    require(abs(got - mean) <= 6 * sigma, f"{what}: {got} rows, expected {mean:.2f} ± {6 * sigma:.2f}")
    mask, valid = res.valid_mask, tdf.device_valid_mask()
    cpu = torch.device("cpu")
    for start in (0, max(0, mask.shape[0] - SAMPLE_WINDOW)):
        count = min(SAMPLE_WINDOW, mask.shape[0] - start)
        exp = (uniform(SAMPLE_SEED, start, count, cpu) < SAMPLE_FRAC) & valid[start:start + count].cpu()
        require(torch.equal(mask[start:start + count].cpu(), exp), f"{what}: the mask of rows [{start}, +{count}) "
                "is not the CPU draw's")
    return {"rows": got, "expected": mean, "sigma": sigma}


def stream_setop_chunks(np, pd, PandasDataFrame, seed: int, rows: int = SETOP_STREAM_ROWS,
                        chunk: int = SETOP_STREAM_CHUNK) -> list:
    """The streamed cells' chunks, made once: chunk i from
    ``default_rng(seed + 10_000 + i)``, ``k`` int64 uniform over
    [0, 2**17), ``b`` int8 over [0, 8), ``v`` float32 uniform."""
    out = []
    for i in range((rows + chunk - 1) // chunk):
        rng = np.random.default_rng(seed + 10_000 + i)
        n = min(chunk, rows - i * chunk)
        out.append(pd.DataFrame({"k": rng.integers(0, STREAM_KEYS, n), "b": rng.integers(0, 8, n).astype(np.int8),
                                 "v": rng.random(n, dtype=np.float32)}))
    return out


def phase_setop_path(torch, np, pd, pa, bg, api, col, engine, tdf, oracles: dict, seed: int,
                     stream_rows: int = SETOP_STREAM_ROWS, stream_chunk: int = SETOP_STREAM_CHUNK) -> dict:
    """The set verbs, sample and take over the lineitem frame ``tdf``, one
    line a cell: checked against ``oracles`` with the launch counts set to
    0 just before the first call and read just after, timed (median of
    ``SETOP_REPS`` calls) beside the bound of the bytes of the columns it
    reads, traced once, with its peak device memory. Then two streamed
    cells, ``stream-take`` and ``stream-distinct``, over ``stream_rows``
    rows in chunks of ``stream_chunk``."""
    from fugue_tpu_torch.constants import FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH
    from fugue_tpu_torch.dataframe import LocalDataFrameIterableDataFrame, PandasDataFrame
    from fugue_tpu_torch.ops.random import uniform
    from fugue_tpu_torch.torch import TorchExecutionEngine, streaming
    from fugue_tpu_torch.torch.pipeline import prefetch_depth

    start = time.perf_counter()
    rows = tdf.count()
    out = {"cells": {}}

    def emit_cell(cell: str, line: dict, *engines) -> None:
        line = {"phase": "setop_path", "cell": cell, **line, "phase_s_so_far": time.perf_counter() - start}
        emit(line, engine, *engines)
        out["cells"][cell] = line

    for name, (fn, reads) in setop_path_cells(api, col, engine).items():
        def call(fn=fn):
            return fn(tdf)

        for k in bg.LAUNCHES:
            bg.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(bg.LAUNCHES)
        if name == "sample-1pct":
            checked = check_sample(torch, np, uniform, res, tdf, name)
            again = call()
            require(torch.equal(again.valid_mask, res.valid_mask), f"{name}: the same seed drew another mask")
            checks = ("count within 6 sigma of n·frac; the mask of rows [0, 1e6) and [n-1e6, n) bit for bit the "
                      "CPU draw; a second call's mask the same")
            rows_out = checked["rows"]
            del again
        elif name.startswith("take"):
            _same_take(res.as_arrow(), oracles[name], reads, name)  # a take reads its keys
            checks, rows_out = "key columns in order exact, rows as a set, vs np.lexsort", res.count()
        else:
            _same_rows(np, res.as_pandas(), oracles[name], name)
            checks, rows_out = "rows exact vs the oracle's set", res.count()
        require(sum(launches.values()) == 0, f"{name}: a hand kernel launched {launches}")
        del res
        wall = []
        for _ in range(SETOP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        row_bytes = sum(tdf.device_cols[c].element_size() for c in reads) if reads else 2  # sample: mask in, out
        bound_ms, bound_by = _bound(rows, row_bytes, 0)
        emit_cell(name, {
            "rows": rows, "rows_out": rows_out, "launches": launches, "first_call_s": first_s,
            "ms": statistics.median(wall), "ms_all": wall, "rows_per_s": rows / statistics.median(wall) * 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by, "peak_device_gb": peak / 1e9, "checks": checks,
            "profile": _trace(torch, call),
        })

    # the streamed cells: host pandas a chunk, as in the JAX package
    t0 = time.perf_counter()
    chunks = stream_setop_chunks(np, pd, PandasDataFrame, seed, rows=stream_rows, chunk=stream_chunk)
    generate_s = time.perf_counter() - t0
    k = np.concatenate([c["k"].to_numpy() for c in chunks])
    b = np.concatenate([c["b"].to_numpy() for c in chunks])
    v = np.concatenate([c["v"].to_numpy() for c in chunks])
    schema = "k:long,b:byte,v:float"
    take_exp = pa.table({"k": k, "b": b, "v": v}).take(_top_rows(np, [(v, True), (k, False), (b, False)], 100))
    pairs = np.unique(k * 8 + b)
    distinct_exp = pd.DataFrame({"k": pairs // 8, "b": (pairs % 8).astype(np.int8)})
    del k, b, v

    def stream(cols=None, produced=None):
        def gen():
            for c in chunks:
                if produced is not None:
                    produced[0] += 1
                yield PandasDataFrame(c if cols is None else c[cols], schema if cols is None else "k:long,b:byte")

        return LocalDataFrameIterableDataFrame(gen(), schema=schema if cols is None else "k:long,b:byte")

    def streamed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    res, wall_s, peak = streamed(lambda: api.take(stream(), 100, presort="v desc, k, b", engine=engine))
    _same_take(res.as_arrow(), take_exp, ["v", "k", "b"], "stream-take")
    stats = dict(streaming.last_run_stats)
    require(stats["chunks"] == len(chunks), f"stream-take: read {stats['chunks']} of {len(chunks)} chunks")
    # no presort: the first chunk holds the 1000 rows; the pipeline's
    # read-ahead may have made up to its depth + 1 more, serial none
    early, early_engines = {}, []
    for depth in (0, None):
        conf = {} if depth is None else {FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH: depth}
        eng = TorchExecutionEngine(device=engine.device, conf=conf)
        early_engines.append(eng)
        made = [0]
        head = api.take(stream(produced=made), 1000, presort="", engine=eng)
        require(head.count() == 1000 and streaming.last_run_stats["chunks"] == 1,
                f"stream-take: no presort read {streaming.last_run_stats['chunks']} chunks")
        limit = 1 if depth == 0 else 2 + prefetch_depth(eng.conf, eng.device)
        require(made[0] <= limit, f"stream-take: {made[0]} chunks made after an early stop (limit {limit})")
        early["serial" if depth == 0 else "prefetch"] = {"chunks_made": made[0], "limit": limit}
    emit_cell("stream-take", {
        "rows": stream_rows, "chunk": stream_chunk, "generate_s": generate_s, "s": wall_s,
        "rows_per_s": stream_rows / wall_s, "peak_device_gb": peak / 1e9, "stream_stats": stats,
        "early_stop": early, "checks": "take(100, 'v desc, k, b'): key columns in order and rows vs np.lexsort; "
                                      "take(1000) with no presort reads one chunk",
    }, *early_engines)
    res, wall_s, peak = streamed(lambda: api.distinct(stream(["k", "b"]), engine=engine))
    got = res.as_pandas()
    _same_rows(np, got, distinct_exp, "stream-distinct")
    emit_cell("stream-distinct", {
        "rows": stream_rows, "chunk": stream_chunk, "rows_out": len(got), "s": wall_s,
        "rows_per_s": stream_rows / wall_s, "peak_device_gb": peak / 1e9,
        "stream_stats": dict(streaming.last_run_stats), "checks": "rows exact vs np.unique",
    })
    return out


def transform_udfs(torch, go) -> dict:
    """The transform_path UDFs, written for the port: name -> function."""
    T = Dict[str, torch.Tensor]

    def map_keyless(cols: T) -> T:
        return {"k": cols["k"], "v": cols["v"] * 2 + 1}

    def demean(cols: T) -> T:
        # bench.py's demean_jax (:530)
        m = go.mean(cols, cols["v"])
        return {"k": cols["k"], "v": cols["v"] - go.per_row(cols, m)}

    def window(cols: T) -> T:
        v = cols["v"]
        return {"k": cols["k"], "t": cols["t"], "rn": go.row_number(cols),
                "rs": go.running_sum(cols, v), "rm": go.running_max(cols, v), "lg": go.lag(cols, v)}

    def ridge_fit_score(cols: T) -> T:
        # bench.py's ridge_fit_score (:643): per-config normal equations
        # from 20 group sums and one group max, a batched 4x4 solve, the
        # residual of every row. solve_ex: solve would read back to the
        # host to check for singular matrices, which the empty segment
        # ids give (A = -inf·I with NaN off the diagonal, rows unused)
        xs = [cols[f"x{i}"] for i in range(4)]
        y = cols["y"]
        ata = [[go.segment_sum(cols, xs[i] * xs[j]) for j in range(4)] for i in range(4)]
        aty = [go.segment_sum(cols, xs[i] * y) for i in range(4)]
        alpha = go.segment_max(cols, cols["alpha"])
        a = torch.stack([torch.stack(r, dim=-1) for r in ata], dim=-2)
        a = a + alpha[:, None, None] * torch.eye(4, dtype=a.dtype, device=a.device)
        b = torch.stack(aty, dim=-1)
        w = torch.linalg.solve_ex(a, b[..., None]).result[..., 0]
        pred = sum(go.per_row(cols, w[:, i]) * xs[i] for i in range(4))
        return {"config": cols["config"], "resid": y - pred}

    return {"map_keyless": map_keyless, "demean": demean, "window": window, "ridge": ridge_fit_score}


# cell -> (frame, UDF, output schema, partition, plan)
TRANSFORM_CELLS = {
    "map-keyless": ("bench", "map_keyless", "k:long,v:double", None, "keyless"),
    "demean-dense": ("bench", "demean", "k:long,v:double", {"by": ["k"]}, "dense"),
    "demean-sorted": ("wide", "demean", "k:long,v:double", {"by": ["k"]}, "sorted"),
    "window-presort": ("window", "window", "k:long,t:long,rn:long,rs:double,rm:double,lg:double",
                       {"by": ["k"], "presort": "t"}, "sorted"),
    "ridge-hpo": ("hpo", "ridge", "config:long,resid:double", {"by": ["config"]}, "dense"),
}


def transform_frame(np, kind: str, rows: int, seed: int):
    """``(columns, schema, aux)`` of one transform_path frame, made with
    numpy from ``seed``: ``bench`` is bench.py's ``_make_frame`` shape (``k``
    uniform over 1,000 keys, ``v`` uniform); ``wide`` the same keys spread
    over [0, 2**40) (``aux["idx"]`` their rank); ``window`` adds ``t``, a
    permutation of the rows; ``hpo`` is bench.py's ``_make_hpo_frame``
    (seed 23, its own) at ``rows // 32`` rows a config."""
    rng = np.random.default_rng(seed)
    if kind == "hpo":
        per = rows // HPO_CONFIGS
        rng = np.random.default_rng(23)
        x = rng.random((per, 4))
        y = x @ np.asarray([1.0, -2.0, 0.5, 3.0]) + rng.normal(0, 0.1, per)
        config = np.repeat(np.arange(HPO_CONFIGS, dtype=np.int64), per)
        cols = {f"x{i}": np.tile(x[:, i], HPO_CONFIGS) for i in range(4)}
        cols.update(y=np.tile(y, HPO_CONFIGS), config=config,
                    alpha=10.0 ** (config / 4 - 4))
        schema = "x0:double,x1:double,x2:double,x3:double,y:double,config:long,alpha:double"
        return cols, schema, {"x": x, "y": y, "per": per}
    idx = rng.integers(0, TRANSFORM_KEYS, rows, dtype=np.int16)
    v = rng.random(rows)
    aux = {"idx": idx}
    if kind == "wide":
        ks = np.sort(rng.choice(1 << 40, TRANSFORM_KEYS, replace=False)).astype(np.int64)
        aux["ks"] = ks
        return {"k": ks[idx], "v": v}, "k:long,v:double", aux
    cols = {"k": idx.astype(np.int64), "v": v}
    if kind == "window":
        cols["t"] = rng.permutation(rows).astype(np.int64)
        return cols, "k:long,v:double,t:long", aux
    return cols, "k:long,v:double", aux


def _close(np, got, exp, what: str, rtol=TRANSFORM_RTOL, atol=TRANSFORM_ATOL) -> None:
    require(got.shape == exp.shape, f"{what}: {got.shape} rows, expected {exp.shape}")
    require((np.isnan(got) == np.isnan(exp)).all(), f"{what}: NULLs")
    ok = ~np.isnan(exp)
    require(np.allclose(got[ok], exp[ok], rtol=rtol, atol=atol), f"{what}: vs float64 oracle")


def check_transform(np, cell: str, got, cols: dict, aux: dict) -> None:
    """``got`` (an arrow table) against the float64 numpy oracle of
    ``cell``. The dense plan and the keyless map keep the input's order;
    the sorted plan's is its stable sort by (keys, presort)."""
    out = {c: got.column(c).to_numpy() for c in got.column_names}
    if cell == "ridge-hpo":
        x, y, per = aux["x"], aux["y"], aux["per"]
        require(np.array_equal(out["config"], cols["config"]), f"{cell}: config")
        xtx, xty = x.T @ x, x.T @ y
        for c in range(HPO_CONFIGS):
            w = np.linalg.solve(xtx + 10.0 ** (c / 4 - 4) * np.eye(4), xty)
            _close(np, out["resid"][c * per:(c + 1) * per], y - x @ w, f"{cell}: resid of config {c}",
                   rtol=0, atol=RIDGE_ATOL)
        return
    k, v, idx = cols["k"], cols["v"], aux["idx"]
    if cell == "map-keyless":
        require(np.array_equal(out["k"], k), f"{cell}: k")
        _close(np, out["v"], v * 2 + 1, f"{cell}: v")
        return
    counts = np.bincount(idx, minlength=TRANSFORM_KEYS)
    mean = np.bincount(idx, weights=v, minlength=TRANSFORM_KEYS) / np.maximum(counts, 1)
    if cell == "demean-dense":
        require(np.array_equal(out["k"], k), f"{cell}: k")
        _close(np, out["v"], v - mean[idx], f"{cell}: v")
        return
    if cell == "demean-sorted":
        order = np.argsort(idx, kind="stable")
        require(np.array_equal(out["k"], k[order]), f"{cell}: k")
        _close(np, out["v"], (v - mean[idx])[order], f"{cell}: v")
        return
    # window-presort: rows in t order, then a stable sort by k
    t = cols["t"]
    by_t = np.empty_like(t)
    by_t[t] = np.arange(len(t))
    order = by_t[np.argsort(idx[by_t], kind="stable")]
    require(np.array_equal(out["k"], k[order]) and np.array_equal(out["t"], t[order]),
            f"{cell}: k and t in (k, t) order")
    gid, vs = idx[order].astype(np.int64), v[order]
    pos = np.arange(len(vs))
    start = np.r_[0, np.cumsum(counts)[:-1]]  # first position of each key
    require(np.array_equal(out["rn"], pos - start[gid] + 1), f"{cell}: row_number")
    cs = np.cumsum(vs)
    _close(np, out["rs"], cs - (cs[start] - vs[start])[gid], f"{cell}: running_sum",
           atol=RUNNING_SUM_ATOL)
    # v in [0, 1): a key's offset of 2 keeps every running max inside its key
    _close(np, out["rm"], np.maximum.accumulate(vs + 2.0 * gid) - 2.0 * gid, f"{cell}: running_max")
    lag = np.r_[np.nan, vs[:-1]]
    lag[pos == start[gid]] = np.nan
    _close(np, out["lg"], lag, f"{cell}: lag")


def _transform_bound(cell: str, n: int) -> tuple:
    """Each input column read once and each output column written once
    (8 bytes a value), over the card's memory rate."""
    schema = TRANSFORM_CELLS[cell][2]
    inputs = {"bench": 2, "wide": 2, "window": 3, "hpo": 7}[TRANSFORM_CELLS[cell][0]]
    outputs = len(schema.split(","))
    return _bound(n, 8 * (inputs + outputs), 0)


def phase_transform_path(torch, np, bg, api, go, frame_from_numpy, engine, seed: int,
                         rows: int) -> dict:
    """``api.transform`` over the five transform_path frames: each checked
    against its float64 oracle with its kernel launches counted from 0,
    timed (median of ``TRANSFORM_REPS`` calls) beside its bound, and
    traced once."""
    udfs = transform_udfs(torch, go)
    out = {"phase": "transform_path", "rows": rows, "reps": TRANSFORM_REPS, "cells": {},
           "checks": f"keys and order exact; values rtol={TRANSFORM_RTOL} atol={TRANSFORM_ATOL} "
                     f"(running sums atol={RUNNING_SUM_ATOL}, ridge atol={RIDGE_ATOL}) vs float64 oracle"}
    for kind in ("bench", "wide", "window", "hpo"):
        t0 = time.perf_counter()
        cols, schema, aux = transform_frame(np, kind, rows, seed)
        generate_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tdf = engine.persist(frame_from_numpy(cols, schema, nan_cols=(), device=engine.device))
        ingest_s = time.perf_counter() - t0
        n = tdf.count()
        for cell, (fkind, udf, out_schema, partition, plan) in TRANSFORM_CELLS.items():
            if fkind != kind:
                continue

            def call():
                return api.transform(tdf, udfs[udf], schema=out_schema, partition=partition,
                                     engine=engine, as_fugue=True)

            for k in bg.LAUNCHES:
                bg.LAUNCHES[k] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = dict(bg.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            # the sorted plan's output carries its sorted valid mask
            require((res.valid_mask is not None) == (plan == "sorted"), f"{cell}: not the {plan} plan")
            check_transform(np, cell, res.as_arrow(), cols, aux)
            del res
            wall = []
            for _ in range(TRANSFORM_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(wall)
            bound_ms, bound_by = _transform_bound(cell, n)
            line = {
                "phase": "transform_path", "cell": cell, "plan": plan, "rows": n,
                "generate_s": generate_s, "ingest_s": ingest_s, "first_call_s": first_s,
                "launches": launches, "peak_device_gb": peak / 1e9,
                "transform_ms": ms, "transform_ms_all": wall, "rows_per_s": n / ms * 1e3,
                "bound_ms": bound_ms, "bound_by": bound_by,
                # a window of at least TRACE_WINDOW_MS: a call of ~1 ms is
                # too short a window to read an idle share from
                "profile": _trace(torch, call, calls=max(1, int(TRACE_WINDOW_MS / ms))),
            }
            emit(line, engine)
            out["cells"][cell] = line
        del tdf, cols, aux
        torch.cuda.empty_cache()
    return out


# join_path: bench.py's north star in memory, and TPC-H lineitem with orders
NS_GROUPS = 100_000  # bench.py's NS_GROUPS
JOIN_REPS = 5  # join_path: medians of 5 calls, after the checked one
EXPAND_ORDERS = 1_000_000  # ~4.0M pairs: under MAX_EXPAND_ROWS (2**22) output rows


def north_star_frame(np, rows: int, seed: int) -> dict:
    """bench.py's ``_north_star`` frame in memory: ``k`` uniform over
    ``NS_GROUPS`` keys, ``v`` uniform."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, NS_GROUPS, rows, dtype=np.int64), "v": rng.random(rows)}


def north_star_steps(torch, api, ff, col, engine) -> dict:
    """bench.py's north-star chain as three verbs of the port: the group
    means (``aggregate``), the means onto every row (a broadcast-hash
    ``join``) and the demean (a keyless ``transform``). name -> step."""
    T = Dict[str, torch.Tensor]

    def demean(cols: T) -> T:
        return {"k": cols["k"], "d": cols["v"] - cols["m"]}

    return {
        "aggregate": lambda tdf: api.aggregate(tdf, partition_by="k", engine=engine, m=ff.avg(col("v"))),
        "join": lambda tdf, means: api.join(tdf, means, how="inner", engine=engine),
        "transform": lambda joined: api.transform(joined, demean, schema="k:long,d:double",
                                                  engine=engine, as_fugue=True),
    }


def check_north_star(np, got, cols: dict) -> None:
    """bench.py's own assertions (every row comes out, the demeaned values
    sum to ~0), and ``d`` against ``v`` less its key's float64 mean."""
    k, v = cols["k"], cols["v"]
    d = got.column("d").to_numpy()
    require(len(d) == len(k), f"north-star: {len(d)} rows, expected {len(k)}")
    require(abs(float(d.sum())) < 1.0, f"north-star: the demeaned values sum to {d.sum()}")
    require(np.array_equal(got.column("k").to_numpy(), k), "north-star: k in the input's order")
    mean = np.bincount(k, weights=v, minlength=NS_GROUPS) / np.maximum(
        np.bincount(k, minlength=NS_GROUPS), 1)
    _close(np, d, v - mean[k], "north-star: d")


def _codes_of(np, res, name: str, words, idx):
    """The codes the result should hold for strings ``words[idx]`` (−1
    where ``idx`` is negative) in the result's own dictionary of ``name``."""
    dictionary = res.encodings[name]["dictionary"].to_pylist()
    lut = np.asarray([dictionary.index(w) if w in dictionary else -2 for w in words] + [-1])
    return lut[np.where(idx < 0, len(words), idx)]


def check_orders_join(np, res, how: str, aux: dict, oaux: dict, only_f: bool) -> None:
    """lineitem (left) joined with orders, or with its F orders: every
    lineitem row's order values gathered by ``aux["order"]`` (no merge).
    Keys, codes, rows and NULLs exact; the price ``rtol=1e-5, atol=1e-8``."""
    what = f"lineitem {how} orders{'_f' if only_f else ''}"
    order = aux["order"]
    hit = (oaux["status"] == 0)[order] if only_f else np.ones(len(order), dtype=bool)
    valid = res.device_valid_mask().cpu().numpy()
    if how == "anti":
        require(np.array_equal(valid, ~hit), f"{what}: rows")
        require(res.count() == int((~hit).sum()), f"{what}: row count")
        return
    require(np.array_equal(valid, hit if how == "inner" else np.ones_like(hit)), f"{what}: rows")
    host = {c: t.cpu().numpy() for c, t in res.device_cols.items()}
    masks = {c: t.cpu().numpy() for c, t in res.null_masks.items()}
    src = np.where(hit, order, -1)
    require(np.array_equal(host["l_orderkey"], aux["okey"][order]), f"{what}: keys")
    for name, exp, fill in (("o_custkey", oaux["custkey"], 0), ("o_orderdate", aux["odate"], 0)):
        got = host[name][valid]
        require(np.array_equal(got, np.where(src >= 0, exp[src], fill)[valid]), f"{what}: {name}")
        if how == "left_outer":
            require(np.array_equal(masks[name], ~hit), f"{what}: NULLs of {name}")
    for name, words, codes in (("o_orderpriority", ORDERPRIORITIES, oaux["priority"]),
                               ("o_orderstatus", ORDERSTATUSES, oaux["status"])):
        exp = _codes_of(np, res, name, words, np.where(src >= 0, codes[np.maximum(src, 0)], -1))
        require(np.array_equal(host[name][valid], exp[valid]), f"{what}: {name} codes")
    price = np.where(src >= 0, oaux["totalprice"][np.maximum(src, 0)], np.nan)
    _close(np, host["o_totalprice"][valid], price[valid], f"{what}: o_totalprice")


def _order_by(np, group, within):
    """The order of ``np.lexsort((within, group))`` (by ``group``, then by
    ``within``) as one sort by ``within`` and a stable one by ``group``,
    which takes numpy's radix sort when ``group`` fits 16 bits: a fraction
    of lexsort's time at 10^7–10^8 rows."""
    o = np.argsort(within)
    g = group[o]
    if len(g) > 0 and -(1 << 15) <= g.min() and g.max() < (1 << 15):
        g = g.astype(np.int16)
    return o[np.argsort(g, kind="stable")]


def _bits(np, c):
    """A column's values as uint64 bit patterns (floats by their bits)."""
    if c.dtype.kind == "f":
        c = c.view(np.uint64 if c.itemsize == 8 else np.uint32)
    return c.astype(np.uint64)


def _row_hash(np, cols):
    """A 64-bit hash of each row of ``cols``: splitmix64 chained over the
    columns' bits, so equal rows hash alike and a row's hash depends on
    all of its values together. Summed over the rows (mod 2^64) it is a
    hash of the row multiset: two different multisets agree once in
    ~2^64."""
    h = np.zeros(len(cols[0]), np.uint64)
    for c in cols:
        h += _bits(np, c) + np.uint64(0x9E3779B97F4A7C15)
        h ^= h >> np.uint64(30)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(27)
        h *= np.uint64(0x94D049BB133111EB)
        h ^= h >> np.uint64(31)
    return h


def check_expand(np, pa, res, lineitem, aux: dict, oaux: dict) -> None:
    """orders (left) inner lineitem (right): one row per (order, line)
    pair, held against the pairs ``aux["order"]`` gives, as row sets: each
    column's values summed as bits (which column differs), then a hash of
    the row multiset (how the columns pair), each exact. No sort: at SF10's
    60M rows a sort of each side took minutes."""
    valid = res.device_valid_mask().cpu().numpy()
    got = {c: t.cpu().numpy()[valid] for c, t in res.device_cols.items()}
    order = aux["order"]
    exp = {
        "l_orderkey": aux["okey"][order],
        "o_custkey": oaux["custkey"][order],
        "o_orderdate": aux["odate"][order],
        "o_totalprice": oaux["totalprice"][order],
        "o_orderpriority": _codes_of(np, res, "o_orderpriority", ORDERPRIORITIES, oaux["priority"][order]),
        "o_orderstatus": _codes_of(np, res, "o_orderstatus", ORDERSTATUSES, oaux["status"][order]),
        "l_quantity": lineitem.column("l_quantity").to_numpy(),
        "l_extendedprice": lineitem.column("l_extendedprice").to_numpy(),
        "l_discount": lineitem.column("l_discount").to_numpy(),
        "l_shipdate": lineitem.column("l_shipdate").cast(pa.int32()).to_numpy(),
        "l_returnflag": _codes_of(np, res, "l_returnflag", RETURNFLAGS, aux["flag"]),
        "l_linestatus": _codes_of(np, res, "l_linestatus", LINESTATUSES, aux["status"]),
        "l_shipmode": _codes_of(np, res, "l_shipmode", SHIPMODES, aux["mode"]),
    }
    require(sorted(got) == sorted(exp), f"expand: columns {sorted(got)}")
    require(len(got["l_orderkey"]) == len(order), f"expand: {len(got['l_orderkey'])} pairs, expected {len(order)}")
    names = sorted(exp)
    for c in names:
        require(_bits(np, got[c]).sum() == _bits(np, exp[c]).sum(), f"expand: {c}")
    require(_row_hash(np, [got[c] for c in names]).sum() == _row_hash(np, [exp[c] for c in names]).sum(),
            "expand: the columns pair otherwise than in the oracle's rows")


def _synced(torch, fn):
    """``(fn(), the source lines of the synchronizing CUDA calls it
    made)``, as PyTorch's sync debug mode reports them: each device→host
    read is one. The first switch of the mode in a process was seen to
    report one more, from ``torch/cuda`` itself; ``_port_syncs`` leaves
    torch's own out."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return res, [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]


def _port_syncs(lines) -> list:
    """The syncs made by the port's code (not by torch's own)."""
    return [ln for ln in lines if "/torch/" not in ln]


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _frame_tensors(tdf) -> list:
    return list(tdf.device_cols.values()) + list(tdf.null_masks.values()) + [tdf.device_valid_mask()]


def _join_bound(left, right, res, keys, plan: str) -> tuple:
    """The join's least time on the card: the right side read once, the
    left's keys and valid mask read once (its whole rows for the
    expansion, which moves them), each new result tensor written once."""
    left_in = _frame_tensors(left) if plan == "expand" else (
        [left.device_cols[k] for k in keys] + [left.device_valid_mask()])
    reused = {id(t) for t in _frame_tensors(left)}
    written = [t for t in _frame_tensors(res) if id(t) not in reused]
    return _bound(0, 0, _tensor_bytes(left_in) + _tensor_bytes(_frame_tensors(right))
                  + _tensor_bytes(written))


def _first_call(torch, bg, fn) -> tuple:
    """``(fn(), line)``: the first call, with its seconds, kernel launches
    (counted from 0), peak device memory and device syncs in ``line``."""
    for k in bg.LAUNCHES:
        bg.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, syncs = _synced(torch, fn)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    out = {"launches": dict(bg.LAUNCHES), "first_call_s": first_s,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
           "host_syncs": len(_port_syncs(syncs)), "host_sync_lines": syncs}
    return res, out


def _traced_first_call(torch, bg, fn, warm_up) -> tuple:
    """``(fn(), line, profile)``: the first call, traced (``_trace`` with
    ``warm_up`` as its warm-up step), with ``_first_call``'s line; for a
    call long enough to be its own timing, run once."""
    got = {}
    for k in bg.LAUNCHES:
        bg.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profile = _trace(torch, lambda: got.update(r=_synced(torch, fn)), warm_up=warm_up)
    res, syncs = got.pop("r")
    line = {"launches": dict(bg.LAUNCHES), "first_call_s": profile["wall_ms"] / 1e3,
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
            "host_syncs": len(_port_syncs(syncs)), "host_sync_lines": syncs}
    return res, line, profile


def _time_and_trace(torch, fn, out: dict, rows_left: int, reps: int = JOIN_REPS) -> dict:
    """``out`` with the median and range of ``reps`` calls of ``fn``, the
    left rows a second, and one traced call."""
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(wall)
    out.update(ms=ms, ms_range=[min(wall), max(wall)], left_rows_per_s=rows_left / ms * 1e3,
               profile=_trace(torch, fn))
    return out


def phase_join_path(torch, np, pa, bg, api, ff, col, frame_from_numpy, engine, seed: int,
                    rows: int, orders: int, expand_orders: int) -> dict:
    """The device joins at full width, one line a cell: bench.py's north
    star (aggregate → join → transform over ``rows`` rows), TPC-H lineitem
    with its orders (the unique probe: inner, then left_outer and anti
    against the F orders) and orders with their lines (the expansion).
    Every cell's first call is held against a host oracle with its kernel
    launches counted from 0, then timed (median of ``JOIN_REPS`` calls)
    beside its bound and traced once."""
    out = {"phase": "join_path", "cells": {}}

    def emit_cell(cell: str, line: dict) -> None:
        line = {"phase": "join_path", "cell": cell, **line}
        emit(line, engine)
        out["cells"][line.get("key", cell)] = line

    # north-star-100m
    t0 = time.perf_counter()
    cols = north_star_frame(np, rows, seed)
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tdf = engine.persist(frame_from_numpy(cols, "k:long,v:double", nan_cols=(), device=engine.device))
    ingest_s = time.perf_counter() - t0
    steps = north_star_steps(torch, api, ff, col, engine)

    def chain():
        means = steps["aggregate"](tdf)
        return steps["transform"](steps["join"](tdf, means))

    res, line = _first_call(torch, bg, chain)
    check_north_star(np, res.as_arrow(), cols)
    del res
    means = steps["aggregate"](tdf)
    joined = steps["join"](tdf, means)
    verbs = {"aggregate": lambda: steps["aggregate"](tdf), "join": lambda: steps["join"](tdf, means),
             "transform": lambda: steps["transform"](joined)}
    verb_ms = {}
    for name, fn in verbs.items():
        verb_ms[name] = _time_and_trace(torch, fn, {}, rows)
    join_bound_ms, join_bound_by = _join_bound(tdf, means, joined, ["k"], "probe")
    g = means.count()
    agg_bound_ms, _ = _bound(rows, 16, g * 17)
    transform_bound_ms, _ = _bound(rows, 24, 0)
    line.update(plan="probe", rows_in=[rows, g], rows_out=joined.count(), generate_s=generate_s,
                ingest_s=ingest_s, verbs=verb_ms,
                bound_ms=agg_bound_ms + join_bound_ms + transform_bound_ms, bound_by="bytes",
                join_bound_ms=join_bound_ms, join_bound_by=join_bound_by)
    emit_cell("north-star-100m", _time_and_trace(torch, chain, line, rows))
    del tdf, cols, means, joined, verbs
    torch.cuda.empty_cache()

    # lineitem with orders: the unique probe
    t0 = time.perf_counter()
    tbl, aux, otbl, oaux = shared_orders(np, pa, seed, orders)
    otbl_f = otbl.filter(pa.array(oaux["status"] == 0))
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lineitem = engine.persist(engine.to_df(tbl))
    odf = engine.persist(engine.to_df(otbl))
    odf_f = engine.persist(engine.to_df(otbl_f))
    ingest_s = time.perf_counter() - t0
    n_left = tbl.num_rows
    del tbl
    for cell, right, how in (("lineitem-orders-inner", odf, "inner"),
                             ("lineitem-orders-f", odf_f, "left_outer"),
                             ("lineitem-orders-f", odf_f, "anti")):
        def call():
            return api.join(lineitem, right, how=how, on=["l_orderkey"], engine=engine)

        res, line = _first_call(torch, bg, call)
        check_orders_join(np, res, how, aux, oaux, only_f=right is odf_f)
        bound_ms, bound_by = _join_bound(lineitem, right, res, ["l_orderkey"], "probe")
        line.update(key=f"{cell}/{how}", join=how, plan="probe", rows_in=[n_left, right.count()],
                    rows_out=res.count(), generate_s=generate_s, ingest_s=ingest_s,
                    bound_ms=bound_ms, bound_by=bound_by)
        del res
        emit_cell(cell, _time_and_trace(torch, call, line, n_left))
    del lineitem, odf, odf_f, aux, oaux, otbl, otbl_f
    torch.cuda.empty_cache()

    # orders with their lines: the expansion
    t0 = time.perf_counter()
    tbl, aux = make_lineitem(np, pa, seed, expand_orders)
    otbl, oaux = make_orders(np, pa, tbl, aux, seed)
    oaux["totalprice"] = otbl.column("o_totalprice").to_numpy()
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lineitem = engine.persist(engine.to_df(tbl))
    odf = engine.persist(engine.to_df(otbl))
    ingest_s = time.perf_counter() - t0

    def expand():
        return api.join(odf, lineitem, how="inner", on=["l_orderkey"], engine=engine)

    res, line = _first_call(torch, bg, expand)
    check_expand(np, pa, res, tbl, aux, oaux)
    bound_ms, bound_by = _join_bound(odf, lineitem, res, ["l_orderkey"], "expand")
    line.update(plan="expand", rows_in=[odf.count(), lineitem.count()], rows_out=res.count(),
                generate_s=generate_s, ingest_s=ingest_s, bound_ms=bound_ms, bound_by=bound_by)
    del res
    emit_cell("orders-lineitem-expand", _time_and_trace(torch, expand, line, expand_orders))
    del lineitem, odf
    torch.cuda.empty_cache()
    return out


# host_path: the host engine, with the device↔host moves around it
UDF_GROUPS, UDF_FRAME_ROWS, UDF_ROWS = 1000, 2_000_000, 1_000_000  # bench.py's N_GROUPS, N_ROWS, UDF_ROWS
HOST_REPS = 5  # host_path: the 1m cell's median of 5 calls, after the checked one
HOST_BIG_ROWS = 20_000_000  # pandas-demean-100m, cut in scale from 10^8 rows (35-44 s of pandas)
HOST_RTOL, HOST_ATOL = 1e-5, 1e-8


def host_udfs(pd) -> dict:
    """bench.py's config #1 UDF, as it writes it: pandas in, pandas out."""

    def demean(df: pd.DataFrame) -> pd.DataFrame:
        df["v"] = df["v"] - df["v"].mean()
        return df

    return {"demean": demean}


def udf_frame(np, pd):
    """bench.py's ``_make_frame`` (``default_rng(42)``, ``k`` uniform over
    1,000 groups, ``v`` uniform float64) cut to its ``UDF_ROWS``."""
    rng = np.random.default_rng(42)
    pdf = pd.DataFrame({"k": rng.integers(0, UDF_GROUPS, UDF_FRAME_ROWS),
                        "v": rng.random(UDF_FRAME_ROWS)})
    return pdf.iloc[:UDF_ROWS]


def check_demean(np, cell: str, got_k, got_v, k, v, torch=None) -> None:
    """``v − mean[k]`` in float64 numpy, ``rtol=1e-5, atol=1e-8``; the keys
    and the row count exact. The host map's row order inside a group is
    its sort's, so both sides are compared in (key, value) order. With
    ``torch``, ``got_k`` and ``got_v`` are tensors and the two sorts run
    on their device (10^8 rows: milliseconds on the card, tens of seconds
    on a host core); the oracle's arithmetic stays numpy's."""
    require(len(got_k) == len(k), f"{cell}: {len(got_k)} rows, expected {len(k)}")
    groups = int(k.max()) + 1 if len(k) else 0
    mean = np.bincount(k, weights=v, minlength=groups) / np.maximum(np.bincount(k, minlength=groups), 1)
    exp = v - mean[k]
    if torch is None:
        g, e = _order_by(np, got_k, got_v), _order_by(np, k, exp)
        ok_k = np.array_equal(got_k[g], k[e])
        ok_v = np.allclose(got_v[g], exp[e], rtol=HOST_RTOL, atol=HOST_ATOL)
    else:
        k_t, exp_t = torch.from_numpy(k).to(got_k.device), torch.from_numpy(exp).to(got_k.device)
        g, e = _order_by_t(torch, got_k, got_v), _order_by_t(torch, k_t, exp_t)
        ok_k = bool(torch.equal(got_k[g], k_t[e]))
        ok_v = bool(torch.allclose(got_v[g], exp_t[e], rtol=HOST_RTOL, atol=HOST_ATOL))
    require(ok_k, f"{cell}: keys")
    require(ok_v, f"{cell}: v vs float64 oracle")


def _order_by_t(torch, group, within):
    """``_order_by`` of two tensors, on their device."""
    o = torch.argsort(within)
    return o[torch.argsort(group[o], stable=True)]


def _copy_split(profile: dict, engine_span: str) -> dict:
    """The host-path call's host time in the engine's three steps: the
    copy to the host (``fugue::to_host``), the pandas work and the copy
    back with its encoding (``fugue::to_device``)."""
    spans = profile["host_spans_ms"]
    return {"d2h_ms": spans.get("fugue::to_host"), "pandas_ms": spans.get(engine_span),
            "h2d_ms": spans.get("fugue::to_device")}


class _Calls:
    """Counts the calls of ``obj.name`` (an instance attribute shadows the
    method until ``restore``)."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.count = obj, name, 0
        orig = getattr(obj, name)

        def counted(*args, **kwargs):
            self.count += 1
            return orig(*args, **kwargs)

        setattr(obj, name, counted)

    def restore(self) -> None:
        delattr(self.obj, self.name)


def phase_host_path(torch, np, pd, pa, bg, api, frame_from_numpy, engine, seed: int, rows: int,
                    orders: int, compiled_ms=None) -> dict:
    """The host engine behind the device engine, one line a cell:
    ``pandas-demean-1m`` (BASELINE.json config #1 as bench.py writes it:
    pandas in, pandas out, median of ``HOST_REPS`` calls; and a round trip
    through parquet, ``engine.load_df``, the transform and
    ``engine.save_df``), ``pandas-demean-100m`` (the same UDF over
    transform_path's ``demean-dense`` frame already on the card, cut in
    scale to the first ``HOST_BIG_ROWS`` of its ``rows`` rows, beside the
    compiled map's time ``compiled_ms`` over all of them) and
    ``orders-lineitem-expand-sf10`` (``orders`` orders inner their lines,
    past ``MAX_EXPAND_ROWS``: the join the JAX engine makes on its host).
    Each is held against a host oracle with its kernel launches counted
    from 0, timed, and traced once (idle share, device operations, and the
    D2H, pandas and H2D steps apart); the two large cells check, time and
    trace one call, so each runs its UDF or join once."""
    import shutil
    import tempfile
    from pathlib import Path

    import pyarrow.parquet as pq

    from fugue_tpu_torch.torch import TorchExecutionEngine

    out = {"phase": "host_path", "cells": {},
           "checks": f"keys and row counts exact; values rtol={HOST_RTOL} atol={HOST_ATOL} vs "
                     "float64 oracle; the expansion's row set exact"}
    demean = host_udfs(pd)["demean"]

    def emit_cell(cell: str, line: dict, *engines) -> None:
        line = {"phase": "host_path", "cell": cell, **line}
        emit(line, engine, *engines)
        out["cells"][cell] = line

    # pandas-demean-1m: pandas in, pandas out
    pdf = udf_frame(np, pd)
    k, v = pdf["k"].to_numpy(), pdf["v"].to_numpy()

    # a pandas frame under 64 MiB is fingerprinted: the cache would serve every call after the first
    ueng = TorchExecutionEngine(device=engine.device, conf=NO_CACHE)

    def udf_call():
        return api.transform(pdf, demean, schema="*", partition={"by": ["k"]}, engine=ueng)

    maps = _Calls(ueng.map_engine._host_map, "map_dataframe")
    res, line = _first_call(torch, bg, udf_call)
    require(maps.count == 1, "pandas-demean-1m: not the host map")
    maps.restore()
    require(isinstance(res, pd.DataFrame), "pandas-demean-1m: pandas in, pandas out")
    check_demean(np, "pandas-demean-1m", res["k"].to_numpy(), res["v"].to_numpy(), k, v)
    del res
    wall = []
    for _ in range(HOST_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        udf_call()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(wall)
    profile = _trace(torch, udf_call)
    tmp = Path(tempfile.mkdtemp(prefix=".host_path_", dir=Path(__file__).resolve().parent))
    try:
        pq.write_table(pa.Table.from_pandas(pdf, preserve_index=False), tmp / "in.parquet")
        t0 = time.perf_counter()
        loaded = engine.load_df(str(tmp / "in.parquet"))
        mapped = api.transform(loaded, demean, schema="*", partition={"by": ["k"]}, engine=engine,
                               as_fugue=True)
        engine.save_df(mapped, str(tmp / "out.parquet"))
        back = pq.read_table(tmp / "out.parquet")
        round_trip_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    require(type(loaded).__name__ == "TorchDataFrame" and loaded.device == engine.device,
            "pandas-demean-1m: load_df not on the card")
    require(back.schema.names == ["k", "v"], f"pandas-demean-1m: round trip columns {back.schema.names}")
    check_demean(np, "pandas-demean-1m round trip", back.column("k").to_numpy(),
                 back.column("v").to_numpy(), k, v)
    line.update(rows=len(pdf), groups=UDF_GROUPS, ms=ms, ms_all=wall, rows_per_s=len(pdf) / ms * 1e3,
                copies_bytes={"d2h": 16 * len(pdf), "h2d": 16 * len(pdf)},
                split=_copy_split(profile, "fugue::host_map"), profile=profile,
                round_trip_s=round_trip_s)
    emit_cell("pandas-demean-1m", line, ueng)
    del pdf, k, v, loaded, mapped, back

    # pandas-demean-100m: the frame already on the card, cut in scale to
    # HOST_BIG_ROWS rows (its pandas time paced the whole smoke)
    full_rows, rows = rows, min(rows, HOST_BIG_ROWS)
    t0 = time.perf_counter()
    cols, schema, _ = transform_frame(np, "bench", rows, seed)
    generate_s = time.perf_counter() - t0
    tdf = engine.persist(frame_from_numpy(cols, schema, nan_cols=(), device=engine.device))

    def big_call():
        return api.transform(tdf, demean, schema="*", partition={"by": ["k"]}, engine=engine,
                             as_fugue=True)

    # one call is long enough to trace alone: a tiny op is the warm-up step.
    # The traced call is the checked and the timed one (host-bound: the
    # profiler records the torch ops, not pandas), so the UDF runs once
    res, line, profile = _traced_first_call(torch, bg, big_call,
                                            warm_up=lambda: torch.ones(1, device=engine.device) + 1)
    require(res.valid_mask is None and res.count() == rows, "pandas-demean-100m: rows")
    check_demean(np, "pandas-demean-100m", res.device_cols["k"], res.device_cols["v"],
                 cols["k"], cols["v"], torch=torch)
    del res
    ms = profile["wall_ms"]
    line.update(rows=rows, cut_in_scale_from=full_rows, groups=TRANSFORM_KEYS, generate_s=generate_s, ms=ms,
                rows_per_s=rows / ms * 1e3, compiled_ms=compiled_ms, copies_bytes={"d2h": 16 * rows, "h2d": 16 * rows},
                split=_copy_split(profile, "fugue::host_map"), profile=profile)
    emit_cell("pandas-demean-100m", line)
    del tdf, cols
    torch.cuda.empty_cache()

    # orders-lineitem-expand-sf10: past MAX_EXPAND_ROWS, the host join
    t0 = time.perf_counter()
    tbl, aux, otbl, oaux = shared_orders(np, pa, seed, orders)
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lineitem = engine.persist(engine.to_df(tbl))
    odf = engine.persist(engine.to_df(otbl))
    ingest_s = time.perf_counter() - t0

    def join_call():
        return api.join(odf, lineitem, how="inner", on=["l_orderkey"], engine=engine)

    joins = _Calls(engine._host_engine, "join")
    res, line, profile = _traced_first_call(torch, bg, join_call,
                                            warm_up=lambda: torch.ones(1, device=engine.device) + 1)
    require(joins.count == 1, "orders-lineitem-expand-sf10: not the host join")
    joins.restore()
    check_expand(np, pa, res, tbl, aux, oaux)
    rows_out = res.count()
    del res
    ms = profile["wall_ms"]  # the traced call is the checked and the timed one, as above
    d2h = _tensor_bytes(_frame_tensors(odf)) + _tensor_bytes(_frame_tensors(lineitem))
    line.update(plan="host", rows_in=[odf.count(), lineitem.count()], rows_out=rows_out,
                generate_s=generate_s, ingest_s=ingest_s, ms=ms, left_rows_per_s=odf.count() / ms * 1e3,
                copies_bytes={"d2h": d2h}, split=_copy_split(profile, "fugue::host_join"),
                profile=profile)
    emit_cell("orders-lineitem-expand-sf10", line)
    del lineitem, odf, tbl, otbl
    torch.cuda.empty_cache()
    return out


# stream_path: bench.py's north star streamed at its full size, and B1 on the stream
NS_STREAM_ROWS = 1_000_000_000  # bench.py's NS_ROWS
NS_STREAM_CHUNK = 4_000_000  # bench.py's NS_CHUNK
NS_CHECK_EVERY = 25  # d is held against the oracle on every 25th chunk
STREAM_TRACE_CHUNKS = 6  # a traced window of at least 5 chunks
STREAM_RTOL = 1e-9  # the streamed means against the float64 oracle
STREAM_PEAK_LIMIT = 1 << 30  # the north star's peak device bytes stay under 1 GiB


def stream_chunks(np, pd, PandasDataFrame, rows: int, chunk: int, seed: int, clock: dict,
                  count=None, f32: bool = False, tap=None):
    """bench.py's ``_north_star`` chunks: chunk i from
    ``np.random.default_rng(seed + i)``, ``k`` uniform over ``NS_GROUPS``
    keys, ``v`` uniform (float32 with ``f32``), as PandasDataFrames of
    ``k:long,v:double`` (``v:float``); the host seconds spent making them
    add up in ``clock["generate_s"]``. ``tap(k, v)``, where given, sees
    each chunk's arrays as they are made (its seconds add up in
    ``clock["tap_s"]``)."""
    schema = "k:long,v:float" if f32 else "k:long,v:double"
    n_chunks = (rows + chunk - 1) // chunk
    for i in range(n_chunks if count is None else min(count, n_chunks)):
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed + i)
        n = min(chunk, rows - i * chunk)
        k, v = rng.integers(0, NS_GROUPS, n), rng.random(n)
        part = PandasDataFrame(pd.DataFrame({"k": k, "v": v.astype(np.float32) if f32 else v}), schema)
        clock["generate_s"] += time.perf_counter() - t0
        if tap is not None:
            t0 = time.perf_counter()
            tap(k, v)
            clock["tap_s"] = clock.get("tap_s", 0.0) + time.perf_counter() - t0
        yield part


def _stream_oracle(np, pd, PandasDataFrame, rows: int, chunk: int, seed: int, f32: bool) -> tuple:
    """float64 per-group sums and counts of the stream, by ``np.bincount``."""
    sums, counts = np.zeros(NS_GROUPS), np.zeros(NS_GROUPS, dtype=np.int64)
    clock = {"generate_s": 0.0}
    for part in stream_chunks(np, pd, PandasDataFrame, rows, chunk, seed, clock, f32=f32):
        k, v = part.native["k"].to_numpy(), part.native["v"].to_numpy()
        sums += np.bincount(k, weights=v.astype(np.float64), minlength=NS_GROUPS)
        counts += np.bincount(k, minlength=NS_GROUPS)
    return sums, counts


def phase_stream_path(torch, np, pd, bg, api, ff, col, device, seed: int, rows: int = NS_STREAM_ROWS,
                      chunk: int = NS_STREAM_CHUNK, f32_rows: int = 100_000_000,
                      check_every: int = NS_CHECK_EVERY) -> dict:
    """The streaming paths at full size, one line a cell:

    - ``north-star``: bench.py's ``_north_star`` on the port, ``rows`` rows
      made in chunks of ``chunk`` and never held whole: the streamed group
      means (``aggregate``), then the streamed join of the means onto every
      row and the streamed demean (``join`` → ``transform``). Checked by
      bench.py's assertions (every row out, ``|Σd| < 1``), the means
      against a float64 ``np.bincount`` oracle (``rtol=STREAM_RTOL``), and
      ``d`` against ``v − mean[k]`` (``atol=1e-9``) on every
      ``check_every``-th chunk; timed by pass (the oracle is taken on the
      aggregate pass's producer thread, and its seconds are taken out of
      ``aggregate_s`` and ``rows_per_s``; ``*_with_oracle_s`` keep the raw
      wall), the peak device bytes under
      ``STREAM_PEAK_LIMIT``, the pipeline's stats, the generator's host
      seconds, and a traced window of ``STREAM_TRACE_CHUNKS`` chunks a pass.
    - ``f32-aggregate``: ``f32_rows`` rows with ``v`` as float32 streamed
      into SUM/COUNT/AVG: B1 launches once a chunk; against a float64
      oracle (``ORACLE_RTOL``).
    """
    from fugue_tpu_torch.collections import PartitionSpec
    from fugue_tpu_torch.constants import (
        FUGUE_TPU_CONF_STREAM_CHUNK_ROWS,
        FUGUE_TPU_CONF_STREAM_KEY_RANGE,
    )
    from fugue_tpu_torch.dataframe import LocalDataFrameIterableDataFrame, PandasDataFrame
    from fugue_tpu_torch.torch import TorchExecutionEngine, streaming

    T = Dict[str, torch.Tensor]

    def demean(cols: T) -> T:
        return {"k": cols["k"], "d": cols["v"] - cols["m"]}

    conf = {FUGUE_TPU_CONF_STREAM_KEY_RANGE: f"0,{NS_GROUPS - 1}", FUGUE_TPU_CONF_STREAM_CHUNK_ROWS: chunk}
    out = {"phase": "stream_path", "cells": {}}
    n_chunks = (rows + chunk - 1) // chunk

    def stream(clock, count=None, f32=False, n=rows, tap=None):
        schema = "k:long,v:float" if f32 else "k:long,v:double"
        return LocalDataFrameIterableDataFrame(
            stream_chunks(np, pd, PandasDataFrame, n, chunk, seed, clock, count, f32, tap), schema=schema)

    def aggregate(eng, s):
        return eng.aggregate(s, PartitionSpec(by=["k"]), [ff.avg(col("v")).alias("m")])

    def join_map(eng, s, means):
        return api.transform(eng.join(s, means, how="inner"), demean, schema="k:long,d:double",
                             engine=eng, as_fugue=True)

    # north-star: two timed passes. The float64 oracle is taken from the
    # aggregate pass's own chunks as they are made (cut in depth: it was a
    # third pass over the 10^9 rows, made again), on its producer thread,
    # which paces the stream: its seconds (tap_s) are taken out of the
    # aggregate pass's time that rows_per_s reads, and the raw wall is kept
    sums, counts = np.zeros(NS_GROUPS), np.zeros(NS_GROUPS, dtype=np.int64)

    def tap(k, v) -> None:
        np.add(sums, np.bincount(k, weights=v, minlength=NS_GROUPS), out=sums)
        np.add(counts, np.bincount(k, minlength=NS_GROUPS), out=counts)

    eng = TorchExecutionEngine(device=device, conf={**conf, **STATIC_CHUNKS})
    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    clock = {"generate_s": 0.0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    means = aggregate(eng, stream(clock, tap=tap))
    agg_s = time.perf_counter() - t0
    oracle_s = clock["tap_s"]
    mean = sums / np.maximum(counts, 1)
    agg_peak = torch.cuda.max_memory_allocated()
    agg_generate_s = clock["generate_s"]
    agg_stats = dict(streaming.last_run_stats)
    mp = means.as_pandas()
    present = np.nonzero(counts)[0]
    require(np.array_equal(mp["k"].to_numpy(), present), "north-star: the groups of the means")
    require(np.allclose(mp["m"].to_numpy(), mean[present], rtol=STREAM_RTOL, atol=0),
            "north-star: the means against the float64 oracle")
    kept, n_out, total = {}, 0, 0.0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i, part in enumerate(join_map(eng, stream(clock), means).native):
        p = part.as_pandas()
        n_out += len(p)
        total += float(p["d"].sum())
        if i % check_every == 0:
            kept[i] = (p["k"].to_numpy(), p["d"].to_numpy())
    join_map_s = time.perf_counter() - t0
    peak = max(agg_peak, torch.cuda.max_memory_allocated())
    launches = dict(bg.LAUNCHES)
    require(n_out == rows, f"north-star: {n_out} rows, expected {rows}")  # bench.py's assertions
    require(abs(total) < 1.0, f"north-star: the demeaned values sum to {total}")
    for i, (k, d) in kept.items():
        src = next(stream_chunks(np, pd, PandasDataFrame, rows - i * chunk, chunk, seed + i,
                                 {"generate_s": 0.0})).native
        require(np.array_equal(k, src["k"].to_numpy()), f"north-star: k of chunk {i}")
        require(np.allclose(d, src["v"].to_numpy() - mean[k], rtol=0, atol=1e-9),
                f"north-star: d of chunk {i}")
    require(peak < STREAM_PEAK_LIMIT, f"north-star: peak device bytes {peak}")
    window = min(STREAM_TRACE_CHUNKS, n_chunks)
    traces = {
        "aggregate": _trace(torch, lambda: aggregate(eng, stream({"generate_s": 0.0}, window)),
                            all_threads=True),
        "join_map": _trace(torch, lambda: [p.count() for p in join_map(
            eng, stream({"generate_s": 0.0}, window), means).native], all_threads=True),
    }
    wall = agg_s - oracle_s + join_map_s
    line = {"phase": "stream_path", "cell": "north-star", "rows": rows, "chunk": chunk,
            "chunks": n_chunks, "groups": int(len(present)), "launches": launches,
            "aggregate_s": agg_s - oracle_s, "aggregate_with_oracle_s": agg_s, "join_map_s": join_map_s,
            "wall_s": wall, "wall_with_oracle_s": agg_s + join_map_s,
            "rows_per_s": rows / wall, "generate_s": {"aggregate": agg_generate_s,
                                                     "join_map": clock["generate_s"] - agg_generate_s},
            "oracle_s": oracle_s, "peak_device_bytes": peak, "checked_chunks": sorted(kept),
            "aggregate_run": agg_stats, "join_map_run": dict(streaming.last_run_stats),
            "pipeline": eng.pipeline_stats.as_dict(), "trace_chunks": window, "profile": traces}
    emit(line, eng)
    out["cells"]["north-star"] = line
    del means, mp, kept, eng
    torch.cuda.empty_cache()

    # f32-aggregate: B1 once a chunk
    t0 = time.perf_counter()
    sums, counts = _stream_oracle(np, pd, PandasDataFrame, f32_rows, chunk, seed, f32=True)
    oracle_s = time.perf_counter() - t0
    eng = TorchExecutionEngine(device=device, conf={**conf, **STATIC_CHUNKS})
    f32_chunks = (f32_rows + chunk - 1) // chunk
    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    clock = {"generate_s": 0.0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = eng.aggregate(stream(clock, f32=True, n=f32_rows), PartitionSpec(by=["k"]),
                        [ff.sum(col("v")).alias("s"), ff.count(col("v")).alias("n"),
                         ff.avg(col("v")).alias("m")]).as_pandas()
    wall = time.perf_counter() - t0
    launches = dict(bg.LAUNCHES)
    # once a chunk on the card; on the CPU the wrapper takes its plain version
    expected = f32_chunks if eng.device.type == "cuda" else 0
    require(launches["bin_sum"] == expected,
            f"f32-aggregate: bin_sum launched {launches['bin_sum']} times over {f32_chunks} chunks")
    present = np.nonzero(counts)[0]
    require(np.array_equal(res["k"].to_numpy(), present), "f32-aggregate: groups")
    require(np.array_equal(res["n"].to_numpy(), counts[present]), "f32-aggregate: counts")
    require(np.allclose(res["s"].to_numpy(), sums[present], rtol=ORACLE_RTOL, atol=0),
            "f32-aggregate: sums against the float64 oracle")
    require(np.allclose(res["m"].to_numpy(), sums[present] / counts[present], rtol=ORACLE_RTOL, atol=0),
            "f32-aggregate: means against the float64 oracle")
    peak = torch.cuda.max_memory_allocated()
    # B1 alone at the shape the stream gives it: one chunk's bucket ids
    # and masked values, beside its bound and index_add_ (the plain
    # version's one-hot at this table size is left out, as for zipf-256k)
    part = next(stream_chunks(np, pd, PandasDataFrame, chunk, chunk, seed, {"generate_s": 0.0}, f32=True))
    buckets = 1 << NS_GROUPS.bit_length()
    idx = torch.from_numpy(part.native["k"].to_numpy().astype(np.int32)).to(eng.device)
    vals = torch.from_numpy(part.native["v"].to_numpy()).to(eng.device)
    bound_ms, bound_by = _bound(len(part.native), 8, buckets * 4)
    b1 = {"route": bg.route_of(buckets, False, idx.device)._asdict() if eng.device.type == "cuda" else None,
          "shape": {"rows": len(part.native), "buckets": buckets}, "bound_ms": bound_ms, "bound_by": bound_by}
    if eng.device.type == "cuda":
        b1["ms"] = _median_ms(torch, lambda: bg.bin_sum_idx(idx, vals, buckets), TIMING_REPS)
        b1["library_ms"] = _median_ms(torch, lambda: torch.zeros(buckets, device=idx.device).index_add_(
            0, idx, vals), TIMING_REPS)
    line = {"phase": "stream_path", "cell": "f32-aggregate", "rows": f32_rows, "chunk": chunk,
            "chunks": f32_chunks, "groups": int(len(present)), "launches": launches, "wall_s": wall,
            "rows_per_s": f32_rows / wall, "generate_s": clock["generate_s"], "oracle_s": oracle_s,
            "peak_device_bytes": peak, "run": dict(streaming.last_run_stats), "bin_sum": b1}
    emit(line, eng)
    out["cells"]["f32-aggregate"] = line
    return out


# plan_path: the plan optimizer and its lowered segments through FugueWorkflow
PLAN_REPS = 5  # medians of 5 calls, after the checked one
PLAN_STREAM_CHUNK = 4_000_000  # stream_path's f32-aggregate chunk
PLAN_JOIN_ROWS = 1_000_000
PLAN_DIM_ROWS = 1_000
PLAN_U64_BASE = (1 << 63) - PLAN_DIM_ROWS // 2  # the dimension keys straddle 2**63
LOWER_KEY = "fugue.tpu.plan.lower_segments"
PLAN_SQL = {
    "postgres": ('SELECT "k", SUM("v") AS s, COUNT(*) AS n FROM t '
                 'WHERE CAST("w" AS DOUBLE PRECISION) > 0.5 GROUP BY "k"'),
    "spark": "SELECT `k`, SUM(`v`) AS s, COUNT(*) AS n FROM t WHERE CAST(`w` AS double) > 0.5 GROUP BY `k`",
}


def plan_frame(np, pd, rows: int, seed: int):
    """Config #3's frame as ``_make_frame`` makes it (``k`` over 1,000
    uniform keys, ``v`` float32 with 1% NaN), plus ``w`` float32 uniform
    in [0, 1)."""
    rng = np.random.default_rng(seed + 13)
    pdf = _make_frame(np, pd, rng, rows, "uniform")
    pdf["w"] = rng.random(rows, dtype=np.float32)
    return pdf


def plan_oracle(np, pd, k, v, w=None):
    """Per key of ``k`` over the rows the chain keeps (``v > 0.25``, NaN
    dropped), of ``z = v * w`` in float32 as the card computes it (``v``
    itself with ``w`` None, every row): count, float64 sum and mean, and
    the float32 min and max (NaN where a group has no non-NULL value)."""
    if w is not None:
        keep = v > 0.25
        k, z = k[keep], v[keep] * w[keep]
    else:
        z = v
    nn = ~np.isnan(z)
    groups = np.bincount(k)
    n = np.bincount(k[nn], minlength=len(groups))
    s = np.bincount(k[nn], weights=z[nn].astype(np.float64), minlength=len(groups))
    keys = np.nonzero(groups > 0)[0]
    mm = pd.DataFrame({"k": k[nn], "z": z[nn]}).groupby("k")["z"].agg(["min", "max"])
    exp = pd.DataFrame({"k": keys, "n": n[keys]})
    with np.errstate(invalid="ignore", divide="ignore"):
        exp["s"] = np.where(n[keys] > 0, s[keys], np.nan)
        exp["m"] = exp["s"] / np.where(n[keys] > 0, n[keys], np.nan)
    exp["lo"] = mm["min"].reindex(keys).to_numpy()
    exp["hi"] = mm["max"].reindex(keys).to_numpy()
    return exp[["k", "s", "n", "m", "lo", "hi"]]


def _plan_summary(report, stats_before: dict, stats_after: dict) -> dict:
    """A PlanReport in short, with the segments the run executed and the
    ones that took the per-verb path."""
    return {
        "pushdowns": report.filters_pushed, "prunes": report.cols_pruned, "fusions": report.verbs_fused,
        "segments_lowered": report.segments_lowered,
        "segments_executed": stats_after["segments_executed"] - stats_before["segments_executed"],
        "segments_fallback": stats_after["segments_fallback"] - stats_before["segments_fallback"],
    }


def _wall_ms(torch, fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_plan_path(torch, np, pd, pa, bg, api, ff, col, engine, seed: int, rows: int,
                    stream_rows: int, stream_chunk: int = PLAN_STREAM_CHUNK, cells=None) -> dict:
    """The plan optimizer on the card, through ``FugueWorkflow``, one line
    a cell (``cells`` names a subset; None: all):

    - ``lowered-uniform-1k``: config #3's frame (``plan_frame``, ``rows``
      rows) on the card, ``filter(v > 0.25) → select(k, v * w AS z) →
      aggregate`` SUM/COUNT/AVG/MIN/MAX of ``z`` by ``k``: one lowered
      segment, B1 once a call; beside its twin with
      ``fugue.tpu.plan.lower_segments=false`` (the per-verb path);
    - ``stream-lowered-f32``: the same chain over ``stream_rows`` of the
      same rows streamed in chunks of ``stream_chunk`` rows: B1 once a
      chunk, the peak device bytes under ``STREAM_PEAK_LIMIT``, one traced
      call; beside its per-verb twin, and beside ``PLAN_REPS`` runs with
      the tuner at its default (on), a cold run and warm ones, each with
      its chunks, its B1 launches and the tuner's decision (``tuned_ms``:
      the median of the warm runs);
    - ``unsigned-keys``: the frame's ``k`` as uint32, aggregated
      SUM/COUNT/AVG/MIN/MAX of ``v`` (the dense route, B1 once), then an
      inner join of ``PLAN_JOIN_ROWS`` rows by a uint64 key straddling
      2**63 with ``PLAN_DIM_ROWS`` dimension rows;
    - ``sql-dialect``: one FugueSQL query compiled under
      ``fugue.sql.compile.dialect=postgres`` (double-quoted names, ``CAST
      ... AS DOUBLE PRECISION``) against the same query in spark's.

    Each is checked once against a float64 numpy oracle (keys, counts,
    MIN/MAX and rows exact; float32 sums ``ORACLE_RTOL``) and against its
    twin, with the launch counts set to 0 just before the checked call and
    read just after, then timed (median of ``PLAN_REPS`` calls, the twin's
    beside it) and traced once; each line has the PlanReport in short."""
    import shutil
    import tempfile
    from pathlib import Path

    from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
    from fugue_tpu_torch.sql import FugueSQLWorkflow
    from fugue_tpu_torch.torch import TorchExecutionEngine, streaming
    from fugue_tpu_torch.workflow import FugueWorkflow

    start = time.perf_counter()
    cells = set(cells or ("lowered-uniform-1k", "stream-lowered-f32", "unsigned-keys", "sql-dialect"))
    out = {"phase": "plan_path", "cells": {}}
    t0 = time.perf_counter()
    pdf = plan_frame(np, pd, rows, seed)
    k, v, w = (pdf[c].to_numpy() for c in ("k", "v", "w"))
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exp = plan_oracle(np, pd, k, v, w)
    oracle_s = time.perf_counter() - t0
    aggs = dict(s=ff.sum(col("z")), n=ff.count(col("z")), m=ff.avg(col("z")),
                lo=ff.min(col("z")), hi=ff.max(col("z")))
    on_card = engine.device.type == "cuda"

    def chain(src, conf=None):
        dag = FugueWorkflow(conf)
        (dag.df(src).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
         .partition_by("k").aggregate(**aggs).yield_dataframe_as("r"))
        return dag

    def run_dag(eng, make):
        dag = make()
        before = eng.plan_stats.as_dict()
        dag.run(eng)
        res = dag.yields["r"].result
        return res, _plan_summary(dag.last_plan_report, before, eng.plan_stats.as_dict())

    def checked(eng, make, what: str, oracle) -> tuple:
        """The first call: launches counted from 0, the result held to
        ``oracle``; ``(result pandas, launches, plan summary, first s)``."""
        for name in bg.LAUNCHES:
            bg.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, plan = run_dag(eng, make)
        got = res.as_pandas().sort_values("k").reset_index(drop=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        _check_agg(np, got, oracle, what)
        return got, dict(bg.LAUNCHES), plan, first_s

    def same_as_twin(got, twin, what: str) -> None:
        for c in ("k", "n", "lo", "hi"):
            require(np.array_equal(got[c].to_numpy(), twin[c].to_numpy(), equal_nan=True), f"{what}: {c} vs twin")
        for c in ("s", "m"):
            require(np.allclose(got[c].to_numpy(), twin[c].to_numpy(), rtol=ORACLE_RTOL, atol=0, equal_nan=True),
                    f"{what}: {c} vs twin")

    if "lowered-uniform-1k" in cells:
        t0 = time.perf_counter()
        tdf = engine.persist(engine.to_df(pdf))
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        got, launches, plan, first_s = checked(engine, lambda: chain(tdf), "lowered-uniform-1k", exp)
        require(plan["segments_executed"] == 1 and plan["segments_fallback"] == 0,
                f"lowered-uniform-1k: plan {plan}")
        require(launches["bin_sum"] == (1 if on_card else 0),
                f"lowered-uniform-1k: bin_sum launched {launches['bin_sum']} times")
        twin_got, twin_launches, twin_plan, _ = checked(
            engine, lambda: chain(tdf, {LOWER_KEY: False}), "lowered-uniform-1k twin", exp)
        require(twin_plan["segments_lowered"] == 0, f"lowered-uniform-1k twin: plan {twin_plan}")
        same_as_twin(got, twin_got, "lowered-uniform-1k")
        call = lambda: run_dag(engine, lambda: chain(tdf))[0].count()  # noqa: E731
        twin_call = lambda: run_dag(engine, lambda: chain(tdf, {LOWER_KEY: False}))[0].count()  # noqa: E731
        call()
        ms_all = _wall_ms(torch, call, PLAN_REPS)
        twin_call()
        twin_all = _wall_ms(torch, twin_call, PLAN_REPS)
        # reads k (8 B), v, w (4 B each) a row; writes six columns a bucket
        bound_ms, bound_by = _bound(rows, 16, 1024 * (8 + 8 + 8 + 8 + 4 + 4 + 1))
        line = {"phase": "plan_path", "cell": "lowered-uniform-1k", "rows": rows, "groups": len(exp),
                "generate_s": generate_s, "oracle_s": oracle_s, "ingest_s": ingest_s, "plan": plan,
                "launches": launches, "twin_launches": twin_launches, "first_call_s": first_s,
                "ms": statistics.median(ms_all), "ms_all": ms_all, "twin_ms": statistics.median(twin_all),
                "twin_ms_all": twin_all, "bound_ms": bound_ms, "bound_by": bound_by,
                "checks": f"keys, counts, min/max exact; sum/avg rtol={ORACLE_RTOL} vs float64 oracle and twin",
                "profile": _trace(torch, call), "twin_profile": _trace(torch, twin_call),
                "phase_s_so_far": time.perf_counter() - start}
        emit(line, engine)
        out["cells"]["lowered-uniform-1k"] = line
        del tdf
        torch.cuda.empty_cache()

    if "stream-lowered-f32" in cells:
        n_stream = min(stream_rows, rows)
        tbl = pa.table({"k": k[:n_stream], "v": v[:n_stream], "w": w[:n_stream]})
        chunks = (n_stream + stream_chunk - 1) // stream_chunk
        stream_exp = exp if n_stream == rows else plan_oracle(np, pd, k[:n_stream], v[:n_stream], w[:n_stream])
        seng = TorchExecutionEngine(device=engine.device, conf={
            "fugue.tpu.stream.chunk_rows": stream_chunk, "fugue.tpu.stream.key_range": "0,999", **STATIC_CHUNKS})

        def stream():
            return LocalDataFrameIterableDataFrame(
                (ArrowDataFrame(tbl.slice(s, stream_chunk)) for s in range(0, n_stream, stream_chunk)),
                schema="k:long,v:float,w:float")

        resident = torch.cuda.memory_allocated() if on_card else 0  # what earlier cells left on the card
        torch.cuda.reset_peak_memory_stats()
        got, launches, plan, first_s = checked(seng, lambda: chain(stream()), "stream-lowered-f32", stream_exp)
        peak = torch.cuda.max_memory_allocated() if on_card else streaming.last_run_stats["peak_device_bytes"]
        run_stats = dict(streaming.last_run_stats)
        require(plan["segments_executed"] == 1 and plan["segments_fallback"] == 0,
                f"stream-lowered-f32: plan {plan}")
        require(launches["bin_sum"] == (chunks if on_card else 0),
                f"stream-lowered-f32: bin_sum launched {launches['bin_sum']} times over {chunks} chunks")
        require(peak < STREAM_PEAK_LIMIT, f"stream-lowered-f32: peak device bytes {peak}")
        twin_got, twin_launches, twin_plan, twin_first_s = checked(
            seng, lambda: chain(stream(), {LOWER_KEY: False}), "stream-lowered-f32 twin", stream_exp)
        same_as_twin(got, twin_got, "stream-lowered-f32")
        call = lambda: run_dag(seng, lambda: chain(stream()))[0].count()  # noqa: E731
        twin_call = lambda: run_dag(seng, lambda: chain(stream(), {LOWER_KEY: False}))[0].count()  # noqa: E731
        ms_all = _wall_ms(torch, call, PLAN_REPS)
        twin_all = _wall_ms(torch, twin_call, PLAN_REPS)
        # the tuner at its default (on), its store in a temporary file: a
        # cold run, then warm ones that read what the runs before learned,
        # each timed as ``call`` is and checked, beside the static runs
        tuned_dir = tempfile.mkdtemp(prefix=".plan_path_tuned_", dir=Path(__file__).resolve().parent)
        try:
            teng = TorchExecutionEngine(device=engine.device, conf={
                "fugue.tpu.stream.chunk_rows": stream_chunk, "fugue.tpu.stream.key_range": "0,999",
                "fugue.tpu.tuning.path": str(Path(tuned_dir) / "tuned.json")})
            tuned = []
            for i in range(PLAN_REPS):
                for name in bg.LAUNCHES:
                    bg.LAUNCHES[name] = 0
                held = []
                t_ms = _wall_ms(torch, lambda: held.append(run_dag(teng, lambda: chain(stream()))[0])
                                or held[-1].count(), 1)[0]
                t_chunks, t_launches = streaming.last_run_stats["chunks"], dict(bg.LAUNCHES)
                t_got = held.pop().as_pandas().sort_values("k").reset_index(drop=True)
                _check_agg(np, t_got, stream_exp, f"stream-lowered-f32 tuned run {i}")
                same_as_twin(t_got, got, f"stream-lowered-f32 tuned run {i}")
                require(t_launches["bin_sum"] == (t_chunks if on_card else 0),
                        f"stream-lowered-f32 tuned run {i}: bin_sum {t_launches} over {t_chunks} chunks")
                decided = [x["value"] for x in teng.tuner.as_dict()["last_decisions"] if x["target"] == "stream"]
                tuned.append({"ms": t_ms, "chunks": t_chunks, "launches": t_launches,
                              "decision": decided[-1] if decided else None})
        finally:
            shutil.rmtree(tuned_dir, ignore_errors=True)
        tuned_all = [r["ms"] for r in tuned]
        bound_ms, bound_by = _bound(n_stream, 16, 1024 * 41)
        line = {"phase": "plan_path", "cell": "stream-lowered-f32", "rows": n_stream, "chunk": stream_chunk,
                "chunks": chunks, "plan": plan, "launches": launches, "twin_launches": twin_launches,
                "first_call_s": first_s, "twin_first_call_s": twin_first_s, "ms": statistics.median(ms_all),
                "ms_all": ms_all, "twin_ms": statistics.median(twin_all), "twin_ms_all": twin_all,
                "tuned_ms": statistics.median(tuned_all[1:] or tuned_all), "tuned_ms_all": tuned_all,
                "tuned_runs": tuned, "rows_per_s": n_stream / statistics.median(ms_all) * 1e3, "bound_ms": bound_ms,
                "bound_by": bound_by, "peak_device_bytes": peak, "resident_before_bytes": resident, "run": run_stats,
                "pipeline": seng.pipeline_stats.as_dict(),
                "checks": f"keys, counts, min/max exact; sum/avg rtol={ORACLE_RTOL} vs float64 oracle and twin",
                "profile": _trace(torch, call, all_threads=True),
                "phase_s_so_far": time.perf_counter() - start}
        emit(line, seng, teng)
        out["cells"]["stream-lowered-f32"] = line
        del tbl, seng, teng
        torch.cuda.empty_cache()

    if "unsigned-keys" in cells:
        uexp = plan_oracle(np, pd, k, v)
        tdf = engine.persist(engine.to_df(pd.DataFrame({"k": k.astype(np.uint32), "v": v})))
        vaggs = dict(s=ff.sum(col("v")), n=ff.count(col("v")), m=ff.avg(col("v")),
                     lo=ff.min(col("v")), hi=ff.max(col("v")))
        for name in bg.LAUNCHES:
            bg.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.aggregate(tdf, partition_by="k", engine=engine, **vaggs)
        got = res.as_pandas().sort_values("k").reset_index(drop=True)
        first_s = time.perf_counter() - t0
        launches = dict(bg.LAUNCHES)
        require(str(res.schema).startswith("k:uint32,"), f"unsigned-keys: schema {res.schema}")
        require(launches["bin_sum"] == (1 if on_card else 0), f"unsigned-keys: bin_sum launched {launches}")
        _check_agg(np, got.astype({"k": np.int64}), uexp, "unsigned-keys")
        agg_all = _wall_ms(torch, lambda: api.aggregate(tdf, partition_by="k", engine=engine, **vaggs).count(),
                           PLAN_REPS)
        agg_profile = _trace(torch, lambda: api.aggregate(tdf, partition_by="k", engine=engine, **vaggs).count())
        del tdf, res
        # the join: uint64 keys on both sides of 2**63
        rng = np.random.default_rng(seed + 17)
        dim_keys = (np.uint64(PLAN_U64_BASE) + np.arange(PLAN_DIM_ROWS, dtype=np.uint64))
        dim = pd.DataFrame({"u": dim_keys, "label": np.arange(PLAN_DIM_ROWS, dtype=np.int64)})
        pick = rng.integers(0, PLAN_DIM_ROWS + PLAN_DIM_ROWS // 10, PLAN_JOIN_ROWS)  # ~9% miss
        left = pd.DataFrame({"u": np.uint64(PLAN_U64_BASE) + pick.astype(np.uint64),
                             "x": rng.random(PLAN_JOIN_ROWS)})
        ldf, rdf = engine.persist(engine.to_df(left)), engine.persist(engine.to_df(dim))
        jres = api.join(ldf, rdf, how="inner", on=["u"], engine=engine, as_fugue=True)
        jgot = jres.as_pandas().sort_values(["u", "x"]).reset_index(drop=True)
        hit = pick < PLAN_DIM_ROWS
        jexp = pd.DataFrame({"u": left["u"][hit], "x": left["x"][hit], "label": pick[hit].astype(np.int64)}
                            ).sort_values(["u", "x"]).reset_index(drop=True)
        require(str(jres.schema) == "u:uint64,x:double,label:long", f"unsigned-keys join: schema {jres.schema}")
        require(len(jgot) == len(jexp) and all(np.array_equal(jgot[c].to_numpy(), jexp[c].to_numpy())
                                               for c in ("u", "x", "label")), "unsigned-keys join: rows")
        require(int(jgot["u"].min()) < (1 << 63) <= int(jgot["u"].max()), "unsigned-keys join: keys straddle 2**63")
        join_call = lambda: api.join(ldf, rdf, how="inner", on=["u"], engine=engine, as_fugue=True).count()  # noqa: E731
        join_all = _wall_ms(torch, join_call, PLAN_REPS)
        line = {"phase": "plan_path", "cell": "unsigned-keys", "rows": rows, "groups": len(uexp),
                "launches": launches, "first_call_s": first_s, "ms": statistics.median(agg_all), "ms_all": agg_all,
                "profile": agg_profile, "join_rows": {"left": PLAN_JOIN_ROWS, "right": PLAN_DIM_ROWS,
                                                      "out": len(jgot)},
                "join_ms": statistics.median(join_all), "join_ms_all": join_all,
                "join_profile": _trace(torch, join_call),
                "checks": (f"aggregate: keys, counts, min/max exact, sum/avg rtol={ORACLE_RTOL} vs float64 oracle; "
                           "join: rows exact vs numpy"),
                "phase_s_so_far": time.perf_counter() - start}
        emit(line, engine)
        out["cells"]["unsigned-keys"] = line
        del ldf, rdf, jres
        torch.cuda.empty_cache()

    if "sql-dialect" in cells:
        tdf = engine.persist(engine.to_df(pdf))
        keep = w > 0.5
        nn = keep & ~np.isnan(v)
        sexp_n = np.bincount(k[keep], minlength=1000)
        sexp_s = np.bincount(k[nn], weights=v[nn].astype(np.float64), minlength=1000)

        def run_sql(dialect: str):
            dag = FugueSQLWorkflow({"fugue.sql.compile.dialect": dialect})
            dag(PLAN_SQL[dialect] + " YIELD DATAFRAME AS r", t=tdf)
            before = engine.plan_stats.as_dict()
            dag.run(engine)
            return dag.yields["r"].result, _plan_summary(dag.last_plan_report, before, engine.plan_stats.as_dict())

        for name in bg.LAUNCHES:
            bg.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        res, plan = run_sql("postgres")
        got = res.as_pandas().sort_values("k").reset_index(drop=True)
        first_s = time.perf_counter() - t0
        launches = dict(bg.LAUNCHES)
        twin = run_sql("spark")[0].as_pandas().sort_values("k").reset_index(drop=True)
        keys = np.nonzero(sexp_n)[0]
        require(list(got.columns) == ["k", "s", "n"] and np.array_equal(got["k"].to_numpy(), keys),
                f"sql-dialect: columns {list(got.columns)} or keys")
        require(np.array_equal(got["n"].to_numpy(), sexp_n[keys]), "sql-dialect: counts")
        require(np.allclose(got["s"].to_numpy(), sexp_s[keys], rtol=ORACLE_RTOL, atol=0), "sql-dialect: sums")
        require(np.array_equal(got["n"].to_numpy(), twin["n"].to_numpy())
                and np.allclose(got["s"].to_numpy(), twin["s"].to_numpy(), rtol=ORACLE_RTOL, atol=0),
                "sql-dialect: postgres vs spark")
        ms_all = _wall_ms(torch, lambda: run_sql("postgres")[0].count(), PLAN_REPS)
        twin_all = _wall_ms(torch, lambda: run_sql("spark")[0].count(), PLAN_REPS)
        line = {"phase": "plan_path", "cell": "sql-dialect", "rows": rows, "query": PLAN_SQL["postgres"],
                "plan": plan, "launches": launches, "first_call_s": first_s, "ms": statistics.median(ms_all),
                "ms_all": ms_all, "twin_ms": statistics.median(twin_all), "twin_ms_all": twin_all,
                "checks": f"keys, counts exact; sums rtol={ORACLE_RTOL} vs float64 oracle and the spark twin",
                "profile": _trace(torch, lambda: run_sql("postgres")[0].count()),
                "phase_s_so_far": time.perf_counter() - start}
        emit(line, engine)
        out["cells"]["sql-dialect"] = line
        del tdf
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - start
    out["handover"] = pdf  # analysis_path and obs_path run on the same frame
    out["handover_oracle"] = exp  # obs_path holds its lowered cells to it
    return out


# analysis_path: the UDF analyzer translates a pandas UDF into the chain
ANALYZE_KEY = "fugue.tpu.plan.analyze_udfs"
CALLBACK_ROWS = 1_000_000
CALLBACK_KEYS = 1_000


def scale(df: pd.DataFrame) -> pd.DataFrame:
    df["z"] = df["v"].fillna(0.0) * df["w"]
    df = df[df["z"] > 0.1]
    return df


def report_rows(df: pd.DataFrame, cb: Callable) -> pd.DataFrame:
    cb(len(df))
    return df


def scale_oracle(np, k, v, w, lo: int = 0, hi=None):
    """Per key of ``k[lo:hi]``, ``scale``'s rows (``z = fillna(v, 0) * w``
    in float32, as pandas and the card compute it, kept where ``z > 0.1``):
    ``(keys, count, float64 sum)``."""
    k, v, w = k[lo:hi], v[lo:hi], w[lo:hi]
    z = np.where(np.isnan(v), np.float32(0), v) * w
    keep = z > np.float32(0.1)
    n = np.bincount(k[keep], minlength=1000)
    s = np.bincount(k[keep], weights=z[keep].astype(np.float64), minlength=1000)
    keys = np.nonzero(n)[0]
    return keys, n[keys], s[keys]


def _check_scaled(np, got, exp, what: str, extra=None) -> None:
    keys, n, s = exp
    cols = ["k", "s", "n"] + list(extra or {})
    require(list(got.columns) == cols, f"{what}: columns {list(got.columns)}")
    require(np.array_equal(got["k"].to_numpy().astype(np.int64), keys), f"{what}: keys")
    require(np.array_equal(got["n"].to_numpy(), n), f"{what}: counts")
    require(np.allclose(got["s"].to_numpy(), s, rtol=ORACLE_RTOL, atol=0), f"{what}: sums vs oracle")
    for c, e in (extra or {}).items():
        require(np.array_equal(got[c].to_numpy().astype(np.int64), e), f"{what}: {c}")


def b1_at_shape(torch, bg, k, vals, valid, kmin: int, kmax: int, plain_reps: int = 0) -> dict:
    """B1 on the ids and values a lowered segment hands it (the dense
    kernel's: invalid rows to the top bucket, their values and NaN as 0),
    beside its bound, its plain version (``plain_reps`` > 0) and one
    ``index_add_`` of the same values into the same ids."""
    buckets = 1 << (kmax - kmin + 1).bit_length()
    ev = valid & ~torch.isnan(vals)
    idx = torch.where(valid, k - kmin, buckets - 1).to(torch.int32)
    masked = torch.where(ev, vals, 0.0)
    n = idx.shape[0]
    bound_ms, bound_by = _bound(n, 8, buckets * 4)
    return {
        "rows": n, "valid_rows": int(valid.sum()), "buckets": buckets,
        "route": bg.route_of(buckets, False, idx.device)._asdict(),
        "ms": _median_ms(torch, lambda: bg.bin_sum_idx(idx, masked, buckets), TIMING_REPS),
        "plain_ms": (_median_ms(torch, lambda: bg.bin_sum_ref(idx, masked, None, buckets), plain_reps)
                     if plain_reps else None),
        "library_ms": _median_ms(
            torch, lambda: torch.zeros(buckets, device=idx.device).index_add_(0, idx, masked), TIMING_REPS),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def phase_analysis_path(torch, np, pd, pa, bg, api, ff, col, engine, pdf, stream_rows: int,
                        stream_chunk: int = PLAN_STREAM_CHUNK) -> dict:
    """The UDF analyzer on the card, through ``FugueWorkflow``, on
    plan_path's frame ``pdf`` (config #3's, plus ``w``), one line a cell:

    - ``translated-uniform-1k``: ``transform(scale, schema="*,z:float") →
      partition_by(k) → aggregate(SUM(z), COUNT(z))`` over the frame on the
      card: the analyzer translates ``scale`` into the chain, which lowers
      with the aggregate into one segment (B1 once a call); beside its twin
      with ``fugue.tpu.plan.analyze_udfs=false`` (``scale`` in pandas on
      the host), run once and traced for its to-host / pandas / to-device
      split;
    - ``stream-translated-f32``: the same workflow over ``stream_rows`` of
      the rows in chunks of ``stream_chunk``: one segment, B1 once a chunk,
      the peak device bytes under ``STREAM_PEAK_LIMIT``; its twin once;
    - ``lowered-uint32``: plan_path's chain with ``k`` as uint32 and a
      plain SUM of a uint32 column (``k`` again), bounded and streamed: one
      segment executed, none fallen back, B1 once a call or a chunk;
    - ``callback-1k``: a pandas transform partitioned by ``k`` over
      ``CALLBACK_ROWS`` rows with a callback that counts its calls and the
      rows they report, and the workflow's ``lint()``.

    Then the B1 kernel at the shapes of plan_path's and this phase's
    cells, beside one ``index_add_`` of the same values into the same ids.
    Launch counts are set to 0 just before each checked call and read just
    after; every result is held to a float64 numpy oracle."""
    from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
    from fugue_tpu_torch.torch import TorchExecutionEngine, streaming
    from fugue_tpu_torch.workflow import FugueWorkflow

    start = time.perf_counter()
    out = {"phase": "analysis_path", "cells": {}}
    on_card = engine.device.type == "cuda"
    rows = len(pdf)
    k, v, w = (pdf[c].to_numpy() for c in ("k", "v", "w"))
    t0 = time.perf_counter()
    exp = scale_oracle(np, k, v, w)
    oracle_s = time.perf_counter() - t0

    def scaled(src, conf=None):
        dag = FugueWorkflow(conf)
        (dag.df(src).transform(scale, schema="*,z:float").partition_by("k")
         .aggregate(s=ff.sum(col("z")), n=ff.count(col("z"))).yield_dataframe_as("r"))
        return dag

    def run_dag(eng, dag):
        before = eng.plan_stats.as_dict()
        dag.run(eng)
        res = dag.yields["r"].result
        summary = _plan_summary(dag.last_plan_report, before, eng.plan_stats.as_dict())
        summary["udfs_translated"] = dag.last_plan_report.udfs_translated
        return res, summary

    def checked(eng, make, what: str, check) -> tuple:
        """The first call: launches counted from 0, the result held by
        ``check``; ``(launches, plan summary, seconds)``."""
        for name in bg.LAUNCHES:
            bg.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, plan = run_dag(eng, make())
        got = res.as_pandas().sort_values("k").reset_index(drop=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(bg.LAUNCHES)
        check(got, what)
        return launches, plan, first_s

    def twin_once(eng, make, what: str, check, warm_up) -> dict:
        """The twin (analysis off) run once, traced: its wall ms, result
        check and host split."""
        held = []
        prof = _trace(torch, lambda: held.append(run_dag(eng, make())[0].as_pandas()), warm_up=warm_up)
        check(held[-1].sort_values("k").reset_index(drop=True), what)
        return {"ms": prof["wall_ms"], "split": _copy_split(prof, "fugue::host_map"), "profile": prof}

    def translated_ok(plan, launches, want_b1: int, what: str) -> None:
        require(plan["udfs_translated"] == 1 and plan["segments_executed"] == 1
                and plan["segments_fallback"] == 0, f"{what}: plan {plan}")
        require(launches["bin_sum"] == (want_b1 if on_card else 0),
                f"{what}: bin_sum launched {launches['bin_sum']} times")

    check = lambda got, what: _check_scaled(np, got, exp, what)  # noqa: E731
    t0 = time.perf_counter()
    tdf = engine.persist(engine.to_df(pdf))
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    launches, plan, first_s = checked(engine, lambda: scaled(tdf), "translated-uniform-1k", check)
    translated_ok(plan, launches, 1, "translated-uniform-1k")
    call = lambda: run_dag(engine, scaled(tdf))[0].count()  # noqa: E731
    call()
    ms_all = _wall_ms(torch, call, PLAN_REPS)
    twin = twin_once(engine, lambda: scaled(tdf, {ANALYZE_KEY: False}), "translated-uniform-1k twin", check, call)
    # reads k (8 B), v, w (4 B each) a row; writes two columns a bucket
    bound_ms, bound_by = _bound(rows, 16, 1024 * (8 + 4 + 8 + 1))
    line = {"phase": "analysis_path", "cell": "translated-uniform-1k", "rows": rows, "groups": len(exp[0]),
            "oracle_s": oracle_s, "ingest_s": ingest_s, "plan": plan, "launches": launches,
            "first_call_s": first_s, "ms": statistics.median(ms_all), "ms_all": ms_all,
            "twin_ms": twin["ms"], "twin_split": twin["split"], "twin_profile": twin["profile"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "checks": f"keys, counts exact; sums rtol={ORACLE_RTOL} vs float64 oracle, the twin too",
            "profile": _trace(torch, call), "phase_s_so_far": time.perf_counter() - start}
    emit(line, engine)
    out["cells"]["translated-uniform-1k"] = line

    # B1 at the shapes of the lowered and translated cells, on this frame
    kt, vt, wt = (tdf.device_cols[c] for c in ("k", "v", "w"))
    z_chain = vt * wt  # plan_path's chain: z = v * w where v > 0.25
    z_scale = torch.where(torch.isnan(vt), 0.0, vt) * wt
    every = torch.ones_like(vt, dtype=torch.bool)
    chunk = slice(0, min(stream_chunk, rows))
    shapes = {
        "lowered-uniform-1k": (kt, z_chain, vt > 0.25, 1),
        "stream-lowered-f32 chunk": (kt[chunk], z_chain[chunk], vt[chunk] > 0.25, 3),
        "unsigned-keys": (kt, vt, every, 0),
        "sql-dialect": (kt, vt, wt > 0.5, 0),
        "translated-uniform-1k": (kt, z_scale, z_scale > 0.1, 0),
        "stream-translated-f32 chunk": (kt[chunk], z_scale[chunk], z_scale[chunk] > 0.1, 3),
    }
    # (CUDA events time them: on the card only)
    out["b1"] = {name: b1_at_shape(torch, bg, kk, vals, valid, 0, 999, plain_reps)
                 for name, (kk, vals, valid, plain_reps) in shapes.items()} if on_card else {}
    emit({"phase": "analysis_path", "cell": "b1-at-shapes", "shapes": out["b1"],
          "phase_s_so_far": time.perf_counter() - start})
    del tdf, kt, vt, wt, z_chain, z_scale, every, shapes
    torch.cuda.empty_cache()

    # the same workflow over the rows streamed
    n_stream = min(stream_rows, rows)
    tbl = pa.table({"k": k[:n_stream], "v": v[:n_stream], "w": w[:n_stream]})
    chunks = (n_stream + stream_chunk - 1) // stream_chunk
    stream_exp = exp if n_stream == rows else scale_oracle(np, k, v, w, 0, n_stream)
    stream_check = lambda got, what: _check_scaled(np, got, stream_exp, what)  # noqa: E731
    seng = TorchExecutionEngine(device=engine.device, conf={
        "fugue.tpu.stream.chunk_rows": stream_chunk, "fugue.tpu.stream.key_range": "0,999", **STATIC_CHUNKS})

    def stream(t=tbl):
        return LocalDataFrameIterableDataFrame(
            (ArrowDataFrame(t.slice(s, stream_chunk)) for s in range(0, n_stream, stream_chunk)),
            schema=ArrowDataFrame(t.slice(0, 0)).schema)

    resident = torch.cuda.memory_allocated() if on_card else 0
    torch.cuda.reset_peak_memory_stats()
    launches, plan, first_s = checked(seng, lambda: scaled(stream()), "stream-translated-f32", stream_check)
    peak = torch.cuda.max_memory_allocated() if on_card else streaming.last_run_stats["peak_device_bytes"]
    run_stats = dict(streaming.last_run_stats)
    translated_ok(plan, launches, chunks, "stream-translated-f32")
    require(peak < STREAM_PEAK_LIMIT, f"stream-translated-f32: peak device bytes {peak}")
    call = lambda: run_dag(seng, scaled(stream()))[0].count()  # noqa: E731
    ms_all = _wall_ms(torch, call, PLAN_REPS)
    twin = twin_once(seng, lambda: scaled(stream(), {ANALYZE_KEY: False}), "stream-translated-f32 twin",
                     stream_check, call)
    line = {"phase": "analysis_path", "cell": "stream-translated-f32", "rows": n_stream, "chunk": stream_chunk,
            "chunks": chunks, "plan": plan, "launches": launches, "first_call_s": first_s,
            "ms": statistics.median(ms_all), "ms_all": ms_all, "rows_per_s": n_stream / statistics.median(ms_all) * 1e3,
            "twin_ms": twin["ms"], "twin_split": twin["split"], "peak_device_bytes": peak,
            "resident_before_bytes": resident, "run": run_stats, "bound_ms": _bound(n_stream, 16, 1024 * 21)[0],
            "checks": f"keys, counts exact; sums rtol={ORACLE_RTOL} vs float64 oracle, the twin too",
            "profile": _trace(torch, call, all_threads=True), "phase_s_so_far": time.perf_counter() - start}
    emit(line, seng)
    out["cells"]["stream-translated-f32"] = line
    del tbl, seng
    torch.cuda.empty_cache()

    # plan_path's chain keyed by a uint32 column, with a plain uint32 SUM
    keep = v > 0.25
    n_u = np.bincount(k[keep], minlength=1000)
    s_u = np.bincount(k[keep], weights=(v[keep] * w[keep]).astype(np.float64), minlength=1000)
    ukeys = np.nonzero(n_u)[0]
    uexp = (ukeys, n_u[ukeys], s_u[ukeys])
    usum = {"su": (ukeys * n_u[ukeys]) % (1 << 32)}  # SUM of uint32 wraps at its width
    k32 = k.astype(np.uint32)

    def chain_u(src):
        dag = FugueWorkflow()
        (dag.df(src).filter(col("v") > 0.25)
         .select(col("k"), (col("v") * col("w")).alias("z"), col("k").alias("u"))
         .partition_by("k").aggregate(s=ff.sum(col("z")), n=ff.count(col("z")), su=ff.sum(col("u")))
         .yield_dataframe_as("r"))
        return dag

    ucheck = lambda got, what: _check_scaled(np, got, uexp, what, usum)  # noqa: E731
    tdf = engine.persist(engine.to_df(pd.DataFrame({"k": k32, "v": v, "w": w})))
    require(str(tdf.schema) == "k:uint32,v:float,w:float", f"lowered-uint32: schema {tdf.schema}")
    b_launches, b_plan, b_first = checked(engine, lambda: chain_u(tdf), "lowered-uint32", ucheck)
    ucall = lambda: run_dag(engine, chain_u(tdf))[0].count()  # noqa: E731
    b_ms = _wall_ms(torch, ucall, PLAN_REPS)
    del tdf
    torch.cuda.empty_cache()
    utbl = pa.table({"k": k32[:n_stream], "v": v[:n_stream], "w": w[:n_stream]})
    if n_stream != rows:
        keep = keep[:n_stream]
        kk = k[:n_stream][keep]
        n_s = np.bincount(kk, minlength=1000)
        s_s = np.bincount(kk, weights=(v[:n_stream][keep] * w[:n_stream][keep]).astype(np.float64), minlength=1000)
        sk = np.nonzero(n_s)[0]
        uexp, usum = (sk, n_s[sk], s_s[sk]), {"su": (sk * n_s[sk]) % (1 << 32)}
    seng = TorchExecutionEngine(device=engine.device, conf={
        "fugue.tpu.stream.chunk_rows": stream_chunk, "fugue.tpu.stream.key_range": "0,999", **STATIC_CHUNKS})
    s_launches, s_plan, s_first = checked(seng, lambda: chain_u(stream(utbl)), "lowered-uint32 stream", ucheck)
    s_ms = _wall_ms(torch, lambda: run_dag(seng, chain_u(stream(utbl)))[0].count(), PLAN_REPS)
    for plan, launches, want, what in ((b_plan, b_launches, 1, "lowered-uint32"),
                                       (s_plan, s_launches, chunks, "lowered-uint32 stream")):
        require(plan["segments_executed"] == 1 and plan["segments_fallback"] == 0, f"{what}: plan {plan}")
        require(launches["bin_sum"] == (want if on_card else 0), f"{what}: bin_sum launched {launches}")
    line = {"phase": "analysis_path", "cell": "lowered-uint32", "rows": rows, "stream_rows": n_stream,
            "plan": b_plan, "stream_plan": s_plan, "launches": b_launches, "stream_launches": s_launches,
            "first_call_s": b_first, "stream_first_call_s": s_first, "ms": statistics.median(b_ms), "ms_all": b_ms,
            "stream_ms": statistics.median(s_ms), "stream_ms_all": s_ms,
            "checks": f"keys, counts, SUM(u) exact; sums rtol={ORACLE_RTOL} vs float64 oracle",
            "phase_s_so_far": time.perf_counter() - start}
    emit(line, engine, seng)
    out["cells"]["lowered-uint32"] = line
    del utbl, seng
    torch.cuda.empty_cache()

    # a pandas transform by key with a callback, and the workflow's lint
    small = pdf.iloc[:CALLBACK_ROWS]
    calls = {"calls": 0, "rows": 0}

    def counter(n: int) -> None:
        calls["calls"] += 1
        calls["rows"] += n

    def by_key(udf):
        dag = FugueWorkflow()
        dag.df(small).partition_by("k").transform(udf, schema="*", callback=counter).yield_dataframe_as("r")
        return dag

    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    dag = by_key(report_rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dag.run(engine)
    n_out = dag.yields["r"].result.count()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(bg.LAUNCHES)
    keys = small["k"].nunique()
    require(keys == CALLBACK_KEYS and calls == {"calls": CALLBACK_KEYS, "rows": CALLBACK_ROWS} and n_out == len(small),
            f"callback-1k: {calls}, {n_out} rows out over {keys} keys")
    # the analyzer reads the signature first: a UDF that takes the callback
    # refuses as "signature"; a plain one with a callback wired in as "callback"
    lint = {"report_rows": by_key(report_rows).lint().udfs[0].status,
            "scale": by_key(scale).lint().udfs[0].status}
    require(lint == {"report_rows": "signature", "scale": "callback"}, f"callback-1k: lint {lint}")
    line = {"phase": "analysis_path", "cell": "callback-1k", "rows": len(small), "keys": keys, "callback": calls,
            "launches": launches, "ms": ms, "lint": lint,
            "checks": "1,000 calls reporting 10^6 rows; rows out as in; the lint verdicts",
            "phase_s_so_far": time.perf_counter() - start}
    emit(line, engine)
    out["cells"]["callback-1k"] = line
    out["seconds"] = time.perf_counter() - start
    return out


# obs_path: the observability and resilience layers on plan_path's frame
OBS_REPS = 5  # traced and untraced calls, alternated: medians of 5 each
OBS_STREAM_ROWS = 20_000_000  # traced-stream: 5 chunks of 4·10^6 (cut in scale from 10^8)
OBS_TELEMETRY_INTERVAL = 0.05  # the sampler's interval, seconds
OBS_FAULT_RETRY = {"fugue.tpu.fault.plan": "task.execute=error", "fugue.tpu.retry.task.attempts": 2,
                   "fugue.tpu.retry.task.base": 0.01}
OBS_FAULT_STREAM = {"fugue.tpu.fault.plan": "stream.chunk=error"}


def _span_chain(rec, by_id) -> tuple:
    names = []
    while rec is not None:
        names.append(rec["name"])
        rec = by_id.get(rec["parent"])
    return tuple(names)


def check_span_tree(recs, what: str) -> dict:
    """One ``workflow.run``; every ``workflow.task`` directly under it;
    every ``plan.segment`` under a task; every ``engine.*`` span with a
    task among its ancestors and the run at the root. The span names,
    counted."""
    by_id = {r["id"]: r for r in recs}
    runs = [r for r in recs if r["name"] == "workflow.run"]
    require(len(runs) == 1 and runs[0]["parent"] is None, f"{what}: {len(runs)} workflow.run spans")
    for r in recs:
        chain = _span_chain(r, by_id)
        if r["name"] == "workflow.task":
            require(chain == ("workflow.task", "workflow.run"), f"{what}: task span chain {chain}")
        elif r["name"] == "plan.segment":
            require(chain == ("plan.segment", "workflow.task", "workflow.run"), f"{what}: segment chain {chain}")
        elif r["name"].startswith("engine."):
            require("workflow.task" in chain and chain[-1] == "workflow.run", f"{what}: engine chain {chain}")
    names: Dict[str, int] = {}
    for r in recs:
        names[r["name"]] = names.get(r["name"], 0) + 1
    return names


def profiled_ranges(path: str, outer: str, kernel: str) -> dict:
    """In a ``torch.profiler`` Chrome trace: the ``outer`` ranges, the
    kernels whose name holds ``kernel`` (the profiler names a kernel by
    its signature, ``void binned_shared<false>(...)``), and how many of them
    were launched inside an ``outer`` range of the launching thread (the
    launch's runtime or driver call, matched by its correlation id, within
    the range) or ran inside its device-side twin."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    host = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e["name"] == outer and e.get("cat") in ("user_annotation", "cpu_op")]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e["name"] == outer and e.get("cat") == "gpu_user_annotation"]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel" and kernel in e["name"]]
    inside = 0
    for k in kernels:
        call = calls.get(k.get("args", {}).get("correlation"))
        by_launch = call is not None and any(
            tid == call["tid"] and lo <= call["ts"] <= hi for tid, lo, hi in host)
        by_device = any(lo <= k["ts"] and k["ts"] + k["dur"] <= hi for lo, hi in device)
        inside += by_launch or by_device
    return {"ranges": len(host), "device_ranges": len(device), "kernels": len(kernels), "inside": inside,
            "kernel_names": sorted({e["name"][:60] for e in kernels})}


def launches_without_kernel(path: str) -> dict:
    """In a ``torch.profiler`` Chrome trace: the kernel launches (runtime
    or driver calls) and how many of them have no kernel event of their
    correlation id, the records the capture lost."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    launches = [e["args"]["correlation"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e.get("name", "") and "correlation" in e.get("args", {})]
    return {"launches": len(launches), "without_kernel": sum(c not in kernels for c in launches)}


def phase_obs_path(torch, np, pd, pa, bg, ff, col, engine, pdf, exp, stream_rows: int = OBS_STREAM_ROWS,
                   stream_chunk: int = PLAN_STREAM_CHUNK) -> dict:
    """The observability and resilience layers on the card, on plan_path's
    frame ``pdf`` (its oracle ``exp``), one line a cell:

    - ``traced-lowered``: plan_path's lowered workflow on an engine whose
      conf turns on the tracer (``fugue.tpu.trace.enabled``, ``.xla``),
      the trace export (``fugue.tpu.trace.dir``, a temporary directory of
      the checkout) and the sampler (``fugue.tpu.telemetry.*`` at
      ``OBS_TELEMETRY_INTERVAL`` s): the result against the oracle, the
      span tree (``check_span_tree``), the exported file through
      ``validate_chrome_trace``, ``to_prometheus_text(engine)`` through
      ``validate_prometheus_text``, the sampler's largest device bytes
      between the frame's bytes and the peak, and one ``torch.profiler``
      capture of a traced call whose ``plan.segment`` range holds the B1
      kernel; the medians of ``OBS_REPS`` calls with the tracer and
      sampler off and on, alternated;
    - ``traced-stream``: the same chain over ``stream_rows`` rows streamed
      in chunks of ``stream_chunk``: one ``stream.chunk`` span a chunk
      under the segment's span, their rows summing to the stream's, B1
      once a chunk; the medians off and on;
    - ``fault-retry``: the workflow with ``task.execute`` failing once
      and two attempts a task: the untraced run's result (keys, counts,
      min/max exact; sums ``rtol=ORACLE_RTOL``) and one retry in
      ``engine.stats()["resilience"]``; then the stream with
      ``stream.chunk`` failing and no retry: the injected error, no
      producer thread left, and ``torch.cuda.memory_allocated()`` back at
      its value before the call.

    Launch counts are set to 0 just before each checked call and read just
    after. The tracer and the sampler are process-wide: the phase turns
    them off and empties them at its end."""
    import shutil
    import tempfile
    import threading
    from pathlib import Path

    from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
    from fugue_tpu_torch.obs import (get_sampler, get_span_metrics, get_tracer, to_prometheus_text,
                                     validate_chrome_trace, validate_prometheus_text)
    from fugue_tpu_torch.resilience import InjectedFaultError
    from fugue_tpu_torch.torch import TorchExecutionEngine
    from fugue_tpu_torch.workflow import FugueWorkflow

    start = time.perf_counter()
    out = {"phase": "obs_path", "cells": {}}
    on_card = engine.device.type == "cuda"
    tracer, sampler, metrics = get_tracer(), get_sampler(), get_span_metrics()
    rows = len(pdf)
    k, v, w = (pdf[c].to_numpy() for c in ("k", "v", "w"))
    aggs = dict(s=ff.sum(col("z")), n=ff.count(col("z")), m=ff.avg(col("z")),
                lo=ff.min(col("z")), hi=ff.max(col("z")))

    def chain(src, conf=None):
        dag = FugueWorkflow(conf)
        (dag.df(src).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
         .partition_by("k").aggregate(**aggs).yield_dataframe_as("r"))
        return dag

    def run(eng, dag):
        dag.run(eng)
        return dag.yields["r"].result

    def checked(eng, dag, what: str, oracle):
        """The first call: launches counted from 0, the result held to
        ``oracle``; ``(result pandas, launches, seconds)``."""
        for name in bg.LAUNCHES:
            bg.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(eng, dag).as_pandas().sort_values("k").reset_index(drop=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(bg.LAUNCHES)
        _check_agg(np, got, oracle, what)
        return got, launches, first_s

    def off_and_on(call) -> tuple:
        """``OBS_REPS`` calls with the tracer and the sampler off, and as
        many with them on, alternated: (off ms, on ms)."""
        off, on = [], []
        for _ in range(OBS_REPS):
            tracer.disable()
            sampler.stop()
            off += _wall_ms(torch, call, 1)
            tracer.enable()
            sampler.start()
            on += _wall_ms(torch, call, 1)
        return off, on

    def timing(off, on) -> dict:
        m_off, m_on = statistics.median(off), statistics.median(on)
        return {"untraced_ms": m_off, "untraced_ms_all": off, "traced_ms": m_on, "traced_ms_all": on,
                "traced_share": m_on / m_off - 1}

    tmp = Path(tempfile.mkdtemp(prefix=".obs_path_", dir=Path(__file__).resolve().parent))
    try:
        # traced-lowered: the engine's conf turns the tracer and the sampler on
        teng = TorchExecutionEngine(device=engine.device, conf={
            "fugue.tpu.trace.enabled": True, "fugue.tpu.trace.xla": True, "fugue.tpu.trace.dir": str(tmp),
            "fugue.tpu.telemetry.enabled": True, "fugue.tpu.telemetry.interval": OBS_TELEMETRY_INTERVAL})
        require(tracer.enabled and sampler.running, "traced-lowered: the conf did not start the tracer and sampler")
        t0 = time.perf_counter()
        tdf = teng.persist(teng.to_df(pdf))
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        frame_bytes = _tensor_bytes(_frame_tensors(tdf))
        tracer.clear()
        metrics.clear()
        sampler.clear()
        got, launches, first_s = checked(teng, chain(tdf), "traced-lowered", exp)
        require(launches["bin_sum"] == (1 if on_card else 0), f"traced-lowered: bin_sum launched {launches}")
        recs = tracer.records()
        names = check_span_tree(recs, "traced-lowered")
        require(names.get("plan.segment") == 1 and names.get("workflow.task", 0) >= 2,
                f"traced-lowered: spans {names}")
        files = sorted(tmp.glob("fugue_trace_*.json"))
        require(len(files) == 1, f"traced-lowered: {len(files)} trace files")
        chrome = validate_chrome_trace(str(files[0]))
        require(chrome["spans"] == len(recs), f"traced-lowered: {chrome['spans']} spans exported of {len(recs)}")
        trace_bytes = files[0].stat().st_size
        prom = validate_prometheus_text(to_prometheus_text(teng))
        require("fugue_tpu_span_latency_seconds_bucket" in prom["names"]
                and "fugue_tpu_plan_segments_executed" in prom["names"], f"traced-lowered: prometheus {prom}")
        call = lambda: run(teng, chain(tdf)).count()  # noqa: E731
        tracer.disable()
        plain = run(teng, chain(tdf)).as_pandas().sort_values("k").reset_index(drop=True)
        off, on = off_and_on(call)
        samples = [vals["device_bytes"] for _, vals in sampler.series() if "device_bytes" in vals]
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            require(samples and frame_bytes <= max(samples) <= peak,
                    f"traced-lowered: sampled device bytes {max(samples, default=None)} outside "
                    f"[{frame_bytes}, {peak}]")
        # one profiler capture of a traced call: plan.segment's range holds B1
        prof_path = tmp / "profile.json"
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA],
                                    schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            call()
            torch.cuda.synchronize()
            prof.step()
            call()
            torch.cuda.synchronize()
            prof.step()
        prof.export_chrome_trace(str(prof_path))
        ranges = profiled_ranges(str(prof_path), "plan.segment", "binned_")
        require(ranges["ranges"] >= 1, f"traced-lowered: no plan.segment range in the profile {ranges}")
        if on_card:
            require(ranges["kernels"] >= 1 and ranges["inside"] == ranges["kernels"],
                    f"traced-lowered: B1 outside plan.segment {ranges}")
        line = {"phase": "obs_path", "cell": "traced-lowered", "rows": rows, "ingest_s": ingest_s,
                "launches": launches, "first_call_s": first_s, **timing(off, on),
                "spans_per_call": len(recs), "span_names": names, "trace_file_bytes": trace_bytes,
                "chrome": {"spans": chrome["spans"], "names": chrome["names"]},
                "prometheus": {"families": len(prom["names"]), "samples": prom["samples"],
                               "histogram_series": prom["histogram_series"]},
                "sampler": {"samples": len(samples), "max_device_bytes": max(samples, default=None),
                            "frame_bytes": frame_bytes, "peak_bytes": peak, "errors": sampler.sample_errors},
                "profile_ranges": ranges,
                "checks": f"keys, counts, min/max exact; sum/avg rtol={ORACLE_RTOL} vs float64 oracle; span tree; "
                          "chrome trace; prometheus text; sampled bytes in [frame, peak]; B1 inside plan.segment",
                "phase_s_so_far": time.perf_counter() - start}
        emit(line, teng)
        out["cells"]["traced-lowered"] = line

        # traced-stream: the same chain over the rows streamed
        n_stream = min(stream_rows, rows)
        chunks = (n_stream + stream_chunk - 1) // stream_chunk
        stream_exp = exp if n_stream == rows else plan_oracle(np, pd, k[:n_stream], v[:n_stream], w[:n_stream])
        tbl = pa.table({"k": k[:n_stream], "v": v[:n_stream], "w": w[:n_stream]})
        seng = TorchExecutionEngine(device=engine.device, conf={
            "fugue.tpu.stream.chunk_rows": stream_chunk, "fugue.tpu.stream.key_range": "0,999", **STATIC_CHUNKS})

        def stream():
            return LocalDataFrameIterableDataFrame(
                (ArrowDataFrame(tbl.slice(s, stream_chunk)) for s in range(0, n_stream, stream_chunk)),
                schema="k:long,v:float,w:float")

        tracer.enable()
        tracer.clear()
        _, s_launches, s_first = checked(seng, chain(stream()), "traced-stream", stream_exp)
        require(s_launches["bin_sum"] == (chunks if on_card else 0),
                f"traced-stream: bin_sum launched {s_launches} over {chunks} chunks")
        recs = tracer.records()
        s_names = check_span_tree(recs, "traced-stream")
        by_id = {r["id"]: r for r in recs}
        spans = [r for r in recs if r["name"] == "stream.chunk"]
        require(len(spans) == chunks, f"traced-stream: {len(spans)} chunk spans over {chunks} chunks")
        for r in spans:
            c = _span_chain(r, by_id)
            require(c[1] in ("engine.aggregate", "plan.segment") and c[-2:] == ("workflow.task", "workflow.run"),
                    f"traced-stream: chunk span chain {c}")
        chunk_rows = sum(r["args"]["rows"] for r in spans)
        require(chunk_rows == n_stream, f"traced-stream: chunk spans hold {chunk_rows} rows of {n_stream}")
        s_off, s_on = off_and_on(lambda: run(seng, chain(stream())).count())
        line = {"phase": "obs_path", "cell": "traced-stream", "rows": n_stream, "chunk": stream_chunk,
                "chunks": chunks, "launches": s_launches, "first_call_s": s_first, **timing(s_off, s_on),
                "spans_per_call": len(recs), "span_names": s_names, "chunk_span_rows": chunk_rows,
                "chunk_span_ms": [r["dur"] / 1e6 for r in spans],
                "checks": f"keys, counts, min/max exact; sum/avg rtol={ORACLE_RTOL} vs float64 oracle; one chunk "
                          "span a chunk under the segment, rows summed",
                "phase_s_so_far": time.perf_counter() - start}
        emit(line, seng)
        out["cells"]["traced-stream"] = line

        # fault-retry: task.execute fails once, two attempts a task
        tracer.clear()
        retries = teng.stats()["resilience"].get("workflow.task_retries", 0)
        got, f_launches, f_first = checked(teng, chain(tdf, OBS_FAULT_RETRY), "fault-retry", exp)
        retries = teng.stats()["resilience"].get("workflow.task_retries", 0) - retries
        require(retries == 1, f"fault-retry: {retries} task retries counted")
        require(f_launches["bin_sum"] == (1 if on_card else 0), f"fault-retry: bin_sum launched {f_launches}")
        for c in ("k", "n", "lo", "hi"):
            require(np.array_equal(got[c].to_numpy(), plain[c].to_numpy(), equal_nan=True),
                    f"fault-retry: {c} vs the untraced run")
        for c in ("s", "m"):
            require(np.allclose(got[c].to_numpy(), plain[c].to_numpy(), rtol=ORACLE_RTOL, atol=0, equal_nan=True),
                    f"fault-retry: {c} vs the untraced run")
        attempts = [r["args"].get("attempts") for r in tracer.records() if r["name"] == "workflow.task"]
        # the stream fails at its first chunk, with no retry
        del got, plain
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated() if on_card else 0
        raised = None
        for name in bg.LAUNCHES:
            bg.LAUNCHES[name] = 0
        try:
            run(seng, chain(stream(), OBS_FAULT_STREAM))
        except InjectedFaultError as ex:
            raised = str(ex)
        torch.cuda.synchronize()
        s_launches = dict(bg.LAUNCHES)
        after_raise = torch.cuda.memory_allocated() if on_card else 0
        gc.collect()
        after_gc = torch.cuda.memory_allocated() if on_card else 0
        require(raised is not None and "stream.chunk" in raised, f"fault-retry: the stream raised {raised!r}")
        producers = [t.name for t in threading.enumerate() if t.name.startswith("fugue-torch-prefetch")]
        require(not producers, f"fault-retry: producer threads left {producers}")
        require(after_gc == before, f"fault-retry: {after_gc - before} device bytes held after the stream fault")
        line = {"phase": "obs_path", "cell": "fault-retry", "rows": rows, "plan": OBS_FAULT_RETRY["fugue.tpu.fault.plan"],
                "launches": f_launches, "first_call_s": f_first, "retries": retries, "task_attempts": attempts,
                "stream_fault": {"plan": OBS_FAULT_STREAM["fugue.tpu.fault.plan"], "raised": raised,
                                 "bytes_before": before, "bytes_after_raise": after_raise, "bytes_after_gc": after_gc},
                "stream_launches": s_launches,
                "checks": f"keys, counts, min/max exact, sum/avg rtol={ORACLE_RTOL} vs the untraced run; one retry; "
                          "the stream's injected error, no producer left, device bytes back",
                "phase_s_so_far": time.perf_counter() - start}
        emit(line, teng, seng)
        out["cells"]["fault-retry"] = line
        out["handover"] = tdf  # services_path profiles the same frame
        del tdf, tbl, teng, seng
    finally:
        tracer.disable()
        tracer.clear()
        metrics.clear()
        sampler.stop()
        sampler.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - start
    return out


# services_path: the profiler hooks, the HTTP RPC server and the host map's
# fork pool, on plan_path's frame and config #1's
SERVICES_REPS = 3  # medians of 3 calls, after the checked one
SERVICES_TRACED_CALLS = 3  # http-scrape: traced lowered calls its /metrics counts
POOL_DEVICE_ROWS = 10_000_000  # pool-demean-device-10m: demean-dense's frame cut in scale from 10^8
SERVICES_ROUTES = ("/metrics", "/metrics/snapshot", "/healthz", "/readyz", "/stats")
HTTP_SERVER = "fugue_tpu_torch.rpc.http.HttpRPCServer"
SERVICES_FAULT_RPC = {"fugue.tpu.fault.plan": "rpc.request=error:TimeoutError", "fugue.tpu.retry.rpc.attempts": 2,
                      "fugue.tpu.retry.rpc.base": 0.01}


def _child_pids() -> list:
    """The pids whose parent is this process (``/proc``)."""
    import os

    me, out = os.getpid(), []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == me:
                out.append(int(entry))
    return out


def _same_frames(np, got, exp, what: str) -> None:
    """Two pandas results of one UDF, equal row for row in (k, v) order."""
    g, e = got.sort_values(["k", "v"]).reset_index(drop=True), exp.sort_values(["k", "v"]).reset_index(drop=True)
    require(list(g.columns) == list(e.columns) and len(g) == len(e), f"{what}: {len(g)} rows vs {len(e)}")
    for c in g.columns:
        require(np.array_equal(g[c].to_numpy(), e[c].to_numpy()), f"{what}: {c} vs the serial twin")


def phase_services_path(torch, np, pd, bg, api, ff, col, frame_from_numpy, device, pdf, exp, seed: int,
                        tdf=None, lowered_ms=None, callback_ms=None, callback_rows: int = CALLBACK_ROWS,
                        udf_rows: int = UDF_ROWS, device_rows: int = POOL_DEVICE_ROWS, workers=None) -> dict:
    """The profiler hooks, the HTTP RPC server and the host map's fork pool
    on the card, one line a cell; launch counts set to 0 just before each
    checked call and read just after:

    - ``profiled-lowered``: plan_path's lowered workflow over ``pdf``
      (``exp`` its oracle; ``tdf``, when given, is ``pdf`` already on the
      card) inside ``profiled_engine_context(engine,
      conf={"fugue.tpu.profile.dir": d})`` and an ``annotate`` region, with
      tracing off: the oracle, B1 once, and the written Chrome trace holding
      one ``plan.segment`` range with B1's kernel inside it and no
      ``fugue::plan_segment``; its ms beside ``lowered_ms``, the file's bytes;
    - ``http-callback-1k``: analysis_path's ``callback-1k`` with
      ``fugue.rpc.server`` naming the port's ``HttpRPCServer`` on loopback:
      the rows and the calls, the median of ``SERVICES_REPS`` calls beside
      ``callback_ms``; then one call with ``rpc.request`` failing once under
      two attempts: the same answer, one retry counted by the server;
    - ``http-scrape``: ``SERVICES_TRACED_CALLS`` traced lowered calls, then
      ``SERVICES_ROUTES`` fetched from the server the engine bound:
      ``/metrics`` through the Prometheus validator, its ``plan.segment``
      histogram counting the traced calls; ``/readyz`` 200 with
      ``serve_bound: false``; each fetch's ms;
    - ``pool-demean-1m``: host_path's ``pandas-demean-1m`` (BASELINE.json
      config #1, ``udf_rows`` rows, pandas in and out) with
      ``fugue.tpu.map.parallelism`` at ``workers`` (``min(8, cpu_count)``)
      beside its serial twin: equal results, the medians, and the
      ``map.worker_chunk`` spans that came home;
    - ``pool-demean-device-10m``: transform_path's ``demean-dense`` frame
      cut to ``device_rows`` rows, made on the card, through the pool after
      CUDA is initialized: the float64 oracle, equal to the serial twin, back
      on the card; the split into copy to host, pooled pandas, copy back;
    - ``pool-kill``: ``pool-demean-1m`` with ``map.chunk=kill``: one worker
      SIGKILLed, its chunk retried on a fresh pool, the result equal, and no
      child process left.

    The tracer is process-wide: the phase turns it off and empties it at
    its end. No pool or server error is caught here."""
    import os
    import re
    import shutil
    import tempfile
    import urllib.request
    from pathlib import Path

    from fugue_tpu_torch.obs import get_span_metrics, get_tracer, validate_prometheus_text
    from fugue_tpu_torch.parallel.profiler import annotate, profiled_engine_context
    from fugue_tpu_torch.torch import TorchExecutionEngine
    from fugue_tpu_torch.workflow import FugueWorkflow

    start = time.perf_counter()
    out = {"phase": "services_path", "cells": {}}
    on_card = device.type == "cuda"
    tracer, metrics = get_tracer(), get_span_metrics()
    workers = workers or min(8, os.cpu_count() or 1)
    aggs = dict(s=ff.sum(col("z")), n=ff.count(col("z")), m=ff.avg(col("z")),
                lo=ff.min(col("z")), hi=ff.max(col("z")))

    def chain(src, conf=None):
        dag = FugueWorkflow(conf)
        (dag.df(src).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
         .partition_by("k").aggregate(**aggs).yield_dataframe_as("r"))
        return dag

    def run(eng, dag):
        dag.run(eng)
        return dag.yields["r"].result

    def zero():
        for name in bg.LAUNCHES:
            bg.LAUNCHES[name] = 0

    def emit_cell(cell: str, line: dict, *engines) -> None:
        line = {"phase": "services_path", "cell": cell, **line, "phase_s_so_far": time.perf_counter() - start}
        emit(line, *engines)
        out["cells"][cell] = line

    tmp = Path(tempfile.mkdtemp(prefix=".services_path_", dir=Path(__file__).resolve().parent))
    try:
        # profiled-lowered: one capture of the lowered call, tracing off
        heng = TorchExecutionEngine(device=device, conf={"fugue.rpc.server": HTTP_SERVER})
        tracer.disable()
        t0 = time.perf_counter()
        tdf = heng.persist(heng.to_df(pdf if tdf is None else tdf))
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        with profiled_engine_context(heng, conf={"fugue.tpu.profile.dir": str(tmp / "warm")}):
            # the first call, in a capture of its own: a first capture may drop kernels
            got = run(heng, chain(tdf)).as_pandas().sort_values("k").reset_index(drop=True)
        _check_agg(np, got, exp, "profiled-lowered")
        zero()
        torch.cuda.synchronize()
        t_capture = time.perf_counter()
        with profiled_engine_context(heng, conf={"fugue.tpu.profile.dir": str(tmp / "profile")}) as e, \
                annotate("services.profiled-lowered"):
            t0 = time.perf_counter()
            res = run(e, chain(tdf))
            res.count()
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
        capture_ms = (time.perf_counter() - t_capture) * 1e3
        launches = dict(bg.LAUNCHES)
        files = sorted((tmp / "profile").glob("*.json"))
        require(len(files) == 1, f"profiled-lowered: {len(files)} trace files")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        got = res.as_pandas().sort_values("k").reset_index(drop=True)
        _check_agg(np, got, exp, "profiled-lowered")
        require(launches == {"bin_sum": 1 if on_card else 0, "bin_sum_count": 0},
                f"profiled-lowered: launches {launches}")
        region = sum(1 for ev in events if ev.get("name") == "services.profiled-lowered" and ev.get("ph") == "X")
        ranges = profiled_ranges(str(files[0]), "plan.segment", "binned_")
        old = profiled_ranges(str(files[0]), "fugue::plan_segment", "binned_")["ranges"]
        require(region >= 1 and ranges["ranges"] == 1 and old == 0,
                f"profiled-lowered: region {region}, plan.segment {ranges}, fugue::plan_segment {old}")
        if on_card:
            require(ranges["kernels"] == 1 and ranges["inside"] == 1, f"profiled-lowered: B1 in the trace {ranges}")
        emit_cell("profiled-lowered", {
            "rows": len(pdf), "ingest_s": ingest_s, "launches": launches, "ms": profiled_ms,
            "capture_ms": capture_ms, "lowered_uniform_1k_ms": lowered_ms, "trace_file_bytes": files[0].stat().st_size,
            "trace_events": len(events), "annotate_ranges": region, "profile_ranges": ranges,
            "fugue_plan_segment_ranges": old, "kernel_records": launches_without_kernel(str(files[0])),
            "checks": f"keys, counts, min/max exact; sum/avg rtol={ORACLE_RTOL} vs float64 oracle; one plan.segment "
                      "range holding B1's kernel, no fugue::plan_segment"}, heng)
        del got, res

        # http-callback-1k: callbacks over the HTTP server on loopback
        small = pdf.iloc[:callback_rows]
        calls = {"calls": 0, "rows": 0}

        def counter(n: int) -> None:
            calls["calls"] += 1
            calls["rows"] += n

        def by_key(eng):
            calls.update(calls=0, rows=0)
            dag = FugueWorkflow()
            dag.df(small).partition_by("k").transform(report_rows, schema="*", callback=counter).yield_dataframe_as("r")
            dag.run(eng)
            return dag.yields["r"].result.count()

        keys = int(small["k"].nunique())
        # the cache would serve the pandas input's create after the first call
        ceng = TorchExecutionEngine(device=device, conf={"fugue.rpc.server": HTTP_SERVER, **NO_CACHE})
        zero()
        ms_all, n_out = [], []
        for _ in range(SERVICES_REPS):
            ms_all += _wall_ms(torch, lambda: n_out.append(by_key(ceng)), 1)
            require(calls == {"calls": keys, "rows": len(small)} and n_out[-1] == len(small),
                    f"http-callback-1k: {calls}, {n_out[-1]} rows out over {keys} keys")
        h_launches = dict(bg.LAUNCHES)
        require(type(ceng.rpc_server).__name__ == "HttpRPCServer" and not ceng.rpc_server.running,
                f"http-callback-1k: server {ceng.rpc_server}")
        feng = TorchExecutionEngine(device=device, conf={"fugue.rpc.server": HTTP_SERVER, **SERVICES_FAULT_RPC,
                                                         **NO_CACHE})
        f_out = by_key(feng)
        retries = feng.rpc_server.resilience_stats.as_dict()
        require(f_out == len(small) and calls == {"calls": keys, "rows": len(small)} and retries == {"rpc.retries": 1},
                f"http-callback-1k fault: {calls}, {f_out} rows, {retries}")
        emit_cell("http-callback-1k", {
            "rows": len(small), "keys": keys, "callback": calls, "launches": h_launches,
            "ms": statistics.median(ms_all), "ms_all": ms_all, "in_process_ms": callback_ms,
            "fault": {"plan": SERVICES_FAULT_RPC["fugue.tpu.fault.plan"], "retries": retries},
            "checks": "one call a key reporting every row; rows out as in; the faulted call's answer and one retry"},
            ceng, feng)
        del ceng, feng

        # http-scrape: traced lowered calls, then the bound server's routes
        tracer.clear()
        metrics.clear()
        tracer.enable()
        zero()
        for _ in range(SERVICES_TRACED_CALLS):
            run(heng, chain(tdf)).count()
        tracer.disable()
        s_launches = dict(bg.LAUNCHES)
        srv = heng.rpc_server
        fetched, fetch_ms = {}, {}
        with srv.start():
            for route in SERVICES_ROUTES:
                t0 = time.perf_counter()
                with urllib.request.urlopen(f"http://{srv.host}:{srv.port}{route}", timeout=30) as r:
                    fetched[route] = (r.status, r.read())
                fetch_ms[route] = (time.perf_counter() - t0) * 1e3
        require(all(status == 200 for status, _ in fetched.values()), f"http-scrape: {fetched}")
        text = fetched["/metrics"][1].decode()
        prom = validate_prometheus_text(text)
        segs = sum(int(float(m)) for m in re.findall(
            r'fugue_tpu_span_latency_seconds_count\{[^}]*span="plan\.segment"[^}]*\}\s+(\S+)', text))
        ready = json.loads(fetched["/readyz"][1])
        stats = json.loads(fetched["/stats"][1])
        require(segs == SERVICES_TRACED_CALLS, f"http-scrape: plan.segment counts {segs}")
        require(ready == {"status": "ready", "serve_bound": False}, f"http-scrape: /readyz {ready}")
        require(stats["engine"]["plan"]["segments_executed"] >= SERVICES_TRACED_CALLS, f"http-scrape: /stats {stats}")
        emit_cell("http-scrape", {
            "traced_calls": SERVICES_TRACED_CALLS, "launches": s_launches, "fetch_ms": fetch_ms,
            "bytes": {r: len(b) for r, (_, b) in fetched.items()},
            "prometheus": {"families": len(prom["names"]), "samples": prom["samples"],
                           "histogram_series": prom["histogram_series"], "plan_segment_count": segs},
            "readyz": ready, "healthz": json.loads(fetched["/healthz"][1]),
            "checks": "every route 200; the Prometheus validator; plan.segment counted once a traced call; "
                      "/readyz serve_bound false"}, heng)
        tracer.clear()
        metrics.clear()
        del tdf, heng
        gc.collect()
        torch.cuda.empty_cache()

        # pool-demean-1m: BASELINE.json config #1 through the fork pool
        got = {}
        demean = host_udfs(pd)["demean"]
        upd = udf_frame(np, pd).iloc[:udf_rows]
        k, v = upd["k"].to_numpy(), upd["v"].to_numpy()
        # the cache would serve every call of a pandas frame after the first
        serial = TorchExecutionEngine(device=device, conf=NO_CACHE)
        pooled = TorchExecutionEngine(device=device, conf={"fugue.tpu.map.parallelism": workers, **NO_CACHE})

        def udf_call(eng):
            return api.transform(upd, demean, schema="*", partition={"by": ["k"]}, engine=eng)

        zero()
        serial_ms = _wall_ms(torch, lambda: got.update(serial=udf_call(serial)), 1)
        exp_serial = got.pop("serial")
        tracer.clear()
        tracer.enable()
        pool_ms = _wall_ms(torch, lambda: got.update(pool=udf_call(pooled)), 1)
        got_pool = got.pop("pool")
        tracer.disable()
        p_launches = dict(bg.LAUNCHES)
        spans = [r for r in tracer.records() if r["name"] == "map.worker_chunk"]
        st = pooled.resilience_stats.as_dict()
        require(isinstance(got_pool, pd.DataFrame), "pool-demean-1m: pandas in, pandas out")
        check_demean(np, "pool-demean-1m", got_pool["k"].to_numpy(), got_pool["v"].to_numpy(), k, v)
        _same_frames(np, got_pool, exp_serial, "pool-demean-1m")
        require(spans and st.get("map.chunks_ok") == len(spans) and workers > 1,
                f"pool-demean-1m: {len(spans)} worker spans, {st}, {workers} workers")
        serial_ms += _wall_ms(torch, lambda: udf_call(serial), SERVICES_REPS - 1)
        pool_ms += _wall_ms(torch, lambda: udf_call(pooled), SERVICES_REPS - 1)
        tracer.clear()
        emit_cell("pool-demean-1m", {
            "rows": len(upd), "groups": int(upd["k"].nunique()), "workers": workers, "cpu_count": os.cpu_count(),
            "launches": p_launches, "ms": statistics.median(pool_ms), "ms_all": pool_ms,
            "serial_ms": statistics.median(serial_ms), "serial_ms_all": serial_ms,
            "speedup": statistics.median(serial_ms) / statistics.median(pool_ms),
            "worker_chunk_spans": len(spans), "worker_pids": len({r["args"]["worker_pid"] for r in spans}),
            "worker_chunk_ms": [r["dur"] / 1e6 for r in spans], "resilience": st,
            "checks": f"keys exact, v rtol={HOST_RTOL} atol={HOST_ATOL} vs float64 oracle; equal to the serial twin"},
            serial, pooled)

        # pool-demean-device-10m: a frame on the card, forked after CUDA is up
        t0 = time.perf_counter()
        cols, schema, _ = transform_frame(np, "bench", device_rows, seed)
        generate_s = time.perf_counter() - t0
        deng = TorchExecutionEngine(device=device, conf={"fugue.tpu.map.parallelism": workers})
        ddf = deng.persist(frame_from_numpy(cols, schema, nan_cols=(), device=device))
        require(not on_card or torch.cuda.is_initialized(), "pool-demean-device-10m: CUDA not initialized")

        def device_call(eng):
            return api.transform(ddf, demean, schema="*", partition={"by": ["k"]}, engine=eng, as_fugue=True)

        before = dict(deng.resilience_stats.as_dict())
        # one pooled call, traced: the copies and the pooled pandas apart
        res, d_line, profile = _traced_first_call(torch, bg, lambda: device_call(deng),
                                                  warm_up=lambda: torch.ones(1, device=device) + 1)
        require(type(res).__name__ == "TorchDataFrame" and res.device == device and res.count() == device_rows,
                f"pool-demean-device-10m: {type(res).__name__} on {getattr(res, 'device', None)}")
        check_demean(np, "pool-demean-device-10m", res.device_cols["k"], res.device_cols["v"], cols["k"], cols["v"],
                     torch=torch)
        twin_ms = _wall_ms(torch, lambda: got.update(twin=device_call(serial)), 1)[0]
        twin = got.pop("twin")
        g, t = _order_by_t(torch, res.device_cols["k"], res.device_cols["v"]), \
            _order_by_t(torch, twin.device_cols["k"], twin.device_cols["v"])
        require(bool(torch.equal(res.device_cols["k"][g], twin.device_cols["k"][t]))
                and bool(torch.equal(res.device_cols["v"][g], twin.device_cols["v"][t])),
                "pool-demean-device-10m: not the serial twin's rows")
        st = deng.resilience_stats.as_dict()
        lost = {c: st.get(c, 0) - before.get(c, 0) for c in ("map.worker_lost", "map.chunk_retries",
                                                             "map.serial_fallbacks")}
        require(st.get("map.chunks_ok", 0) > before.get("map.chunks_ok", 0) and not any(lost.values()),
                f"pool-demean-device-10m: {st}")
        del res, twin
        d_line.update(rows=device_rows, groups=TRANSFORM_KEYS, workers=workers, generate_s=generate_s,
                      ms=profile["wall_ms"], serial_ms=twin_ms, split=_copy_split(profile, "fugue::host_map"),
                      cuda_initialized_before_fork=bool(torch.cuda.is_initialized()), resilience=st,
                      profile=profile,
                      checks=f"keys exact, v rtol={HOST_RTOL} atol={HOST_ATOL} vs float64 oracle on the card; "
                             "equal to the serial twin; no lost worker, retry or fallback")
        emit_cell("pool-demean-device-10m", d_line, deng, serial)
        del ddf, cols, deng
        torch.cuda.empty_cache()

        # pool-kill: one worker SIGKILLed mid-chunk
        keng = TorchExecutionEngine(device=device, conf={"fugue.tpu.map.parallelism": workers,
                                                         "fugue.tpu.fault.plan": "map.chunk=kill",
                                                         "fugue.tpu.retry.base": 0.01, **NO_CACHE})
        zero()
        t0 = time.perf_counter()
        got_kill = udf_call(keng)
        kill_ms = (time.perf_counter() - t0) * 1e3
        k_launches = dict(bg.LAUNCHES)
        st = keng.resilience_stats.as_dict()
        _same_frames(np, got_kill, exp_serial, "pool-kill")
        left = _child_pids()
        import multiprocessing

        require(st.get("map.worker_lost") == 1 and st.get("map.chunk_retries", 0) >= 1
                and st.get("map.pool_rebuilds", 0) >= 1, f"pool-kill: {st}")
        require(not multiprocessing.active_children() and not left, f"pool-kill: children left {left}")
        emit_cell("pool-kill", {
            "rows": len(upd), "workers": workers, "launches": k_launches, "ms": kill_ms,
            "pool_ms": statistics.median(pool_ms), "resilience": st, "children_left": left,
            "checks": "equal to the serial twin; one worker lost, its chunk retried on a fresh pool; no child left"},
            keng)
    finally:
        tracer.disable()
        tracer.clear()
        metrics.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - start
    return out


# cache_path: the result cache, the delta cache and the tuner on plan_path's frame
CACHE_FILES = 10  # plan_path's 10^8 rows as 10 parquet files of 10^7
# the tuned stream, cut in scale as traced-stream is: 2·10^7 rows in
# chunks of 2^18 (77 chunks), so that the tuner has chunks to merge
TUNED_STREAM_ROWS, TUNED_STREAM_CHUNK = 20_000_000, 1 << 18
TUNED_RUNS = 3
CACHE_AGGS = ("s", "n", "lo", "hi")  # no AVG: the finished table is the partial accumulator


def _tuned_chunks(n: int, src_chunk: int, size: int) -> int:
    """The chunks a stream of ``n`` rows made in chunks of ``src_chunk``
    reaches the device in at chunk size ``size``: a learned size merges the
    source's chunks up to it (``_maybe_coalesce``), then each is cut at it
    (``_rechunk``)."""
    src = [min(src_chunk, n - s) for s in range(0, n, src_chunk)]
    if size != src_chunk:
        merged, have = [], 0
        for c in src:
            if c >= size and have == 0:
                merged.append(c)
                continue
            have += c
            if have >= size:
                merged, have = merged + [have], 0
        src = merged + ([have] if have else [])
    return sum(-(-c // size) for c in src)


def _merge_oracles(np, pd, a, b):
    """The oracle of two sources' rows from theirs: counts and float64 sums
    add, the float32 MIN and MAX meet, a group with no value stays NULL."""
    m = a.merge(b, on="k", how="outer", suffixes=("_a", "_b")).sort_values("k").reset_index(drop=True)
    n = m["n_a"].fillna(0).astype(np.int64) + m["n_b"].fillna(0).astype(np.int64)
    s = m["s_a"].fillna(0.0) + m["s_b"].fillna(0.0)
    out = pd.DataFrame({"k": m["k"].to_numpy(), "n": n.to_numpy()})
    out["s"] = np.where(n > 0, s, np.nan)
    out["lo"] = np.fmin(m["lo_a"].to_numpy(), m["lo_b"].to_numpy())
    out["hi"] = np.fmax(m["hi_a"].to_numpy(), m["hi_b"].to_numpy())
    return out[["k", "s", "n", "lo", "hi"]]


def _check_cache(np, got, exp, what: str) -> str:
    require(list(got.columns) == ["k", *CACHE_AGGS], f"{what}: columns {list(got.columns)}")
    require(len(got) == len(exp), f"{what}: {len(got)} groups, expected {len(exp)}")
    for c in ("k", "n", "lo", "hi"):
        require(np.array_equal(got[c].to_numpy(), exp[c].to_numpy(), equal_nan=True), f"{what}: {c}")
    g, e = got["s"].to_numpy(), exp["s"].to_numpy()
    require((np.isnan(g) == np.isnan(e)).all(), f"{what}: NULLs of s")
    ok = ~np.isnan(e)
    require(np.allclose(g[ok], e[ok], rtol=ORACLE_RTOL, atol=0), f"{what}: s vs oracle")
    return f"keys, counts, min/max exact; sums rtol={ORACLE_RTOL} vs float64 oracle"


def phase_cache_path(torch, np, pd, pa, bg, ff, col, device, pdf, seed: int, exp=None, files: int = CACHE_FILES,
                     stream_rows: int = TUNED_STREAM_ROWS, stream_chunk: int = TUNED_STREAM_CHUNK,
                     tmp_root=None, keep_source: bool = False) -> dict:
    """The result cache, the delta cache and the tuner on the card, through
    ``FugueWorkflow.run``, one line a cell. ``pdf`` (plan_path's frame, handed
    over; ``exp`` its oracle) is written as ``files`` parquet files into a
    temporary directory of the checkout (removed after), and each run is
    ``LOAD dir → filter(v > 0.25) → select(k, v * w AS z) → aggregate`` by
    ``k`` (SUM/COUNT/MIN/MAX of ``z``): one lowered segment, B1 for SUM(z).

    - ``cache-cold``: the memory and disk tiers (``fugue.tpu.cache.dir``): a
      miss that publishes, B1 once over every row;
    - ``cache-warm-mem``: the same DAG on the same engine: one memory hit,
      B1 0 times, one ``task.cache_hit`` span and no producer's;
    - ``cache-warm-disk``: a fresh engine on the same directory: one disk
      hit, B1 0 times;
    - ``cache-delta``: one more file of ``len(pdf) / files`` new rows: one
      ``task.delta_recompute`` span over ``files/files+1`` partitions, B1
      over the new rows only, the merged partials against the oracle of
      every file and against the twin with the cache off; then the device
      bytes the memory tiers hold, and, after their ``clear()``, the
      device's allocated bytes back to the phase's start, to the byte;
    - ``tuned-stream``: ``stream_rows`` rows streamed in chunks of
      ``stream_chunk`` through the same chain, ``TUNED_RUNS`` runs with the
      tuner on (its store in the temporary directory) beside a tuning-off
      twin: each run's chunks, the tuner's decision, B1 once a chunk, and
      the result against the oracle; the chunk counts follow what
      ``adjust_stream`` gives for the run before.

    Each line has its wall time, its B1 launches counted from 0 just before,
    ``engine.stats()["cache"]`` and its spans (the port's tracer on). The
    first call of each cell is its measure: a second call would be a hit.
    Then B1 alone at the shapes of ``tuned-stream``'s chunks, beside one
    ``index_add_``. With ``keep_source`` the parquet directory (``files`` + 1
    files) is not removed but handed over in ``out["handover"]`` with its
    columns."""
    import shutil
    import tempfile
    from collections import Counter
    import os
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import pyarrow.parquet as pq

    from fugue_tpu_torch.dataframe import ArrowDataFrame, LocalDataFrameIterableDataFrame
    from fugue_tpu_torch.obs import get_tracer
    from fugue_tpu_torch.torch import TorchExecutionEngine, streaming
    from fugue_tpu_torch.torch.pipeline import prefetch_depth
    from fugue_tpu_torch.tuning import adjust_stream
    from fugue_tpu_torch.workflow import FugueWorkflow

    start = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    out = {"phase": "cache_path", "cells": {}}
    rows = len(pdf)
    per = rows // files
    rows = per * files
    k, v, w = (pdf[c].to_numpy()[:rows] for c in ("k", "v", "w"))
    exp = plan_oracle(np, pd, k, v, w) if exp is None or rows != len(pdf) else exp
    exp = exp[["k", *CACHE_AGGS]]
    rng = np.random.default_rng(seed + 29)  # the new file's rows
    nk = rng.integers(0, 1000, per, dtype=np.int64)
    nv = rng.random(per, dtype=np.float32)
    nv[rng.random(per) < 0.01] = np.nan
    nw = rng.random(per, dtype=np.float32)
    exp11 = _merge_oracles(np, pd, exp, plan_oracle(np, pd, nk, nv, nw)[["k", *CACHE_AGGS]])
    aggs = dict(s=ff.sum(col("z")), n=ff.count(col("z")), lo=ff.min(col("z")), hi=ff.max(col("z")))
    tracer = get_tracer()
    b1_rows: list = []
    real_b1 = bg.bin_sum

    def spy_b1(keys, values, valid, buckets):  # the rows each B1 call gets
        b1_rows.append(int(keys.shape[0]))
        return real_b1(keys, values, valid, buckets)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated() if on_card else 0
    root = Path(tmp_root) if tmp_root else Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix=".cache_path_", dir=root))
    src = tmp / "src"
    src.mkdir()
    conf = {"fugue.tpu.cache.dir": str(tmp / "cache")}
    bg.bin_sum = spy_b1
    tracer.clear()
    tracer.enable()
    handed = False
    try:
        def write(i: int) -> None:
            sl = slice(i * per, (i + 1) * per)
            pq.write_table(pa.table({"k": k[sl], "v": v[sl], "w": w[sl]}), src / f"part_{i:03d}.parquet",
                           compression="none")

        t0 = time.perf_counter()
        with ThreadPoolExecutor(min(files, os.cpu_count() or 1)) as pool:
            list(pool.map(write, range(files)))
        write_s = time.perf_counter() - t0

        def chain(conf_=None):
            dag = FugueWorkflow(conf_)
            (dag.load(str(src), fmt="parquet").filter(col("v") > 0.25)
             .select(col("k"), (col("v") * col("w")).alias("z")).partition_by("k").aggregate(**aggs)
             .yield_dataframe_as("r", as_local=True))
            return dag

        def run(eng, cell: str, oracle, conf_=None) -> tuple:
            """One checked run: (result pandas, line fields)."""
            for name in bg.LAUNCHES:
                bg.LAUNCHES[name] = 0
            b1_rows.clear()
            tracer.clear()
            before = eng.stats()["cache"]
            dag = chain(conf_)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dag.run(eng)
            got = dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            after = eng.stats()["cache"]
            recs = tracer.records()
            spans = dict(Counter(r["name"] for r in recs))
            keep = ("tier", "outcome", "partitions", "bytes_skipped", "task")
            cache_spans = [{"name": r["name"], **{a: r["args"][a] for a in keep if a in r["args"]}}
                           for r in recs if r["name"].startswith(("cache.", "task."))]
            delta = {c: after[c] - before[c] for c in after if isinstance(after[c], int)
                     and not isinstance(after[c], bool)}
            line = {"phase": "cache_path", "cell": cell, "wall_s": wall_s, "launches": dict(bg.LAUNCHES),
                    "b1_rows": list(b1_rows), "cache": after, "cache_delta": delta, "spans": spans,
                    "cache_spans": cache_spans, "checks": _check_cache(np, got, oracle, cell),
                    "segments_lowered": dag.last_plan_report.segments_lowered}
            return got, line, dag

        def finish(line: dict) -> None:
            line["phase_s_so_far"] = time.perf_counter() - start
            emit(line)
            out["cells"][line["cell"]] = line

        eng = TorchExecutionEngine(device=device, conf=conf)
        cold, line, dag = run(eng, "cache-cold", exp)
        d = line["cache_delta"]
        require(d["hits_mem"] + d["hits_disk"] == 0 and d["misses"] >= 1 and d["publishes"] >= 1,
                f"cache-cold: {d}")
        require(line["segments_lowered"] == 1, "cache-cold: not one lowered segment")
        require(line["launches"]["bin_sum"] == (1 if on_card else 0) and line["b1_rows"] == [rows],
                f"cache-cold: B1 {line['launches']} over {line['b1_rows']} rows")
        line.update(rows=rows, files=files, write_s=write_s)
        finish(line)
        del dag

        warm, line, dag = run(eng, "cache-warm-mem", exp)
        d, sp = line["cache_delta"], line["spans"]
        require(d["hits_mem"] == 1 and d["hits_disk"] == 0, f"cache-warm-mem: {d}")
        require(line["launches"]["bin_sum"] == 0 and not line["b1_rows"], f"cache-warm-mem: B1 {line['launches']}")
        require(sp.get("task.cache_hit") == 1 and sp.get("workflow.task") == 1 and "plan.segment" not in sp,
                f"cache-warm-mem: spans {sp}")
        require(cold.equals(warm), "cache-warm-mem: not the cold run's result")
        finish(line)
        del dag

        deng = TorchExecutionEngine(device=device, conf=conf)
        disk, line, dag = run(deng, "cache-warm-disk", exp)
        d, sp = line["cache_delta"], line["spans"]
        require(d["hits_disk"] == 1 and d["hits_mem"] == 0, f"cache-warm-disk: {d}")
        require(line["launches"]["bin_sum"] == 0 and not line["b1_rows"], f"cache-warm-disk: B1 {line['launches']}")
        require(sp.get("task.cache_hit") == 1 and "plan.segment" not in sp, f"cache-warm-disk: spans {sp}")
        require(cold.equals(disk), "cache-warm-disk: not the cold run's result")
        finish(line)
        del dag, disk, warm

        t0 = time.perf_counter()
        pq.write_table(pa.table({"k": nk, "v": nv, "w": nw}), src / f"part_{files:03d}.parquet",
                       compression="none")
        append_s = time.perf_counter() - t0
        got, line, dag = run(eng, "cache-delta", exp11)
        d, sp = line["cache_delta"], line["spans"]
        (rec,) = [c for c in line["cache_spans"] if c["name"] == "task.delta_recompute"]
        require(d["partial_hits"] == 1 and d["delta_partitions"] == files and d["hits_mem"] + d["hits_disk"] == 1,
                f"cache-delta: {d}")
        require(rec["partitions"] == f"{files}/{files + 1}", f"cache-delta: partitions {rec}")
        # B1 over the new rows (the fresh partial), then the merge of the
        # two partials' float32 sums (one row a key each) where the engine
        # sums them in float32
        require(line["b1_rows"][:1] == [per] and all(r <= 2 * 1000 for r in line["b1_rows"][1:]),
                f"cache-delta: B1 over {line['b1_rows']} rows")
        require(line["launches"]["bin_sum"] == (len(line["b1_rows"]) if on_card else 0),
                f"cache-delta: B1 {line['launches']}")
        del dag
        twin_eng = TorchExecutionEngine(device=device, conf={**conf, **NO_CACHE})
        twin, tline, dag = run(twin_eng, "cache-delta twin", exp11)
        require(tline["b1_rows"] == [rows + per], f"cache-delta twin: B1 over {tline['b1_rows']} rows")
        for c in ("k", "n", "lo", "hi"):
            require(np.array_equal(got[c].to_numpy(), twin[c].to_numpy(), equal_nan=True), f"cache-delta: {c} vs twin")
        require(np.allclose(got["s"].to_numpy(), twin["s"].to_numpy(), rtol=ORACLE_RTOL, atol=0, equal_nan=True),
                "cache-delta: s vs twin")
        del dag, twin, got, cold
        # B1 alone at the delta's shape: the new rows under the chain's mask
        kd = torch.from_numpy(nk).to(device)
        vd, wd = torch.from_numpy(nv).to(device), torch.from_numpy(nw).to(device)
        bg.bin_sum = real_b1
        b1 = (b1_at_shape(torch, bg, kd, vd * wd, vd > 0.25, 0, 999, plain_reps=3) if on_card
              else {"rows": per, "ms": None, "note": "timed on the card only"})
        bg.bin_sum = spy_b1
        del kd, vd, wd
        # the device bytes the memory tiers hold, then cleared, to the byte
        held = {name: e._resource_probe_fns()["result_cache_mem_bytes"](e)
                for name, e in (("engine", eng), ("fresh_engine", deng))}
        entries = {name: e.result_cache.mem.entries for name, e in (("engine", eng), ("fresh_engine", deng))}
        for e in (eng, deng, twin_eng):
            e.result_cache.clear()
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated() if on_card else 0
        require(mem_after == mem_before, f"cache-delta: {mem_after - mem_before} device bytes held after clear()")
        line.update(rows_new=per, files=files + 1, append_s=append_s, twin_wall_s=tline["wall_s"],
                    twin_launches=tline["launches"], twin_b1_rows=tline["b1_rows"],
                    mem_tier_device_bytes=held, mem_tier_entries=entries,
                    memory={"before_phase": mem_before, "after_clear": mem_after}, b1_at_shape=b1)
        finish(line)
        out["b1"] = {"cache-delta": {**b1, "launches": line["launches"]["bin_sum"]}}
        del eng, deng, twin_eng

        # tuned-stream: the tuner learns the lowered stream's chunk size
        n = min(stream_rows, rows)
        tbl = pa.table({"k": k[:n], "v": v[:n], "w": w[:n]})
        sexp = plan_oracle(np, pd, k[:n], v[:n], w[:n])[["k", *CACHE_AGGS]]
        tconf = {"fugue.tpu.stream.chunk_rows": stream_chunk, "fugue.tpu.stream.key_range": "0,999",
                 "fugue.tpu.tuning.path": str(tmp / "tuned.json"), **NO_CACHE}

        def stream():
            return LocalDataFrameIterableDataFrame(
                (ArrowDataFrame(tbl.slice(s, stream_chunk)) for s in range(0, n, stream_chunk)),
                schema="k:long,v:float,w:float")

        def stream_run(e):
            for name in bg.LAUNCHES:
                bg.LAUNCHES[name] = 0
            dag = FugueWorkflow()
            (dag.df(stream()).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
             .partition_by("k").aggregate(**aggs).yield_dataframe_as("r", as_local=True))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dag.run(e)
            got = dag.yields["r"].result.as_pandas().sort_values("k").reset_index(drop=True)
            torch.cuda.synchronize()
            return got, time.perf_counter() - t0, dict(bg.LAUNCHES), dict(streaming.last_run_stats)

        # before the run: the counts adjust_stream gives a run above MIN_WALL_S
        predicted, size = [], stream_chunk
        for _ in range(TUNED_RUNS):
            predicted.append(_tuned_chunks(n, stream_chunk, size))
            adj = adjust_stream(size, 2, {"chunks_prefetched": predicted[-1], "wall_s": 1.0, "rows": n}, 0)
            size = adj["chunk_rows"] if adj else size
        teng = TorchExecutionEngine(device=device, conf=tconf)
        runs, size, results = [], stream_chunk, []
        for i in range(TUNED_RUNS):
            got, wall_s, launches, stats = stream_run(teng)
            last = teng.pipeline_stats.last_run
            decision = [x for x in teng.stats()["tuning"]["last_decisions"] if x["target"] == "stream"][-1]
            require(decision["value"]["chunk_rows"] == size, f"tuned-stream run {i}: decision {decision}")
            require(stats["chunks"] == _tuned_chunks(n, stream_chunk, size),
                    f"tuned-stream run {i}: {stats['chunks']} chunks at {size}")
            require(launches["bin_sum"] == (stats["chunks"] if on_card else 0),
                    f"tuned-stream run {i}: B1 {launches} over {stats['chunks']} chunks")
            _check_cache(np, got, sexp, f"tuned-stream run {i}")
            runs.append({"chunks": stats["chunks"], "chunk_rows": size, "decision": decision, "wall_s": wall_s,
                         "launches": launches, "peak_device_bytes": stats.get("peak_device_bytes"),
                         "pipeline_run": last})
            results.append(got)
            depth = decision["value"]["prefetch_depth"]
            depth = prefetch_depth(teng.conf, device) if depth is None else depth
            adj = adjust_stream(size, depth, {"chunks_prefetched": last["chunks_prefetched"],
                                              "wall_s": last["wall_s"], "rows": n}, 0)
            size = adj["chunk_rows"] if adj else size
        counts = [r["chunks"] for r in runs]
        require(counts[1] < counts[0], f"tuned-stream: chunk counts {counts} did not fall")
        twin_e = TorchExecutionEngine(device=device, conf={**tconf, **STATIC_CHUNKS})
        twin, twin_wall, twin_launches, twin_stats = stream_run(twin_e)
        require(twin_stats["chunks"] == counts[0], f"tuned-stream twin: {twin_stats['chunks']} chunks")
        for i, got in enumerate(results):
            for c in ("k", "n", "lo", "hi"):
                require(np.array_equal(got[c].to_numpy(), twin[c].to_numpy(), equal_nan=True),
                        f"tuned-stream run {i}: {c} vs twin")
            require(np.allclose(got["s"].to_numpy(), twin["s"].to_numpy(), rtol=ORACLE_RTOL, atol=0,
                                equal_nan=True), f"tuned-stream run {i}: s vs twin")
        finish({"phase": "cache_path", "cell": "tuned-stream", "rows": n, "chunk": stream_chunk,
                "predicted_chunks": predicted, "chunks": counts, "runs": runs, "twin_wall_s": twin_wall,
                "twin_launches": twin_launches, "twin_chunks": twin_stats["chunks"],
                "tuning": teng.stats()["tuning"],
                "checks": f"keys, counts, min/max exact; sums rtol={ORACLE_RTOL} vs float64 oracle and the twin; "
                          "each run's chunks those adjust_stream gives for the run before"})
        del teng, twin_e, tbl, results, twin
        # B1 alone at each chunk shape the tuned stream ran (its first rows)
        bg.bin_sum = real_b1
        for size in sorted({r["chunk_rows"] for r in runs}):
            m = min(size, n)
            kd = torch.from_numpy(k[:m]).to(device)
            vd, wd = torch.from_numpy(v[:m]).to(device), torch.from_numpy(w[:m]).to(device)
            at = (b1_at_shape(torch, bg, kd, vd * wd, vd > 0.25, 0, 999, plain_reps=3) if on_card
                  else {"rows": m, "ms": None, "note": "timed on the card only"})
            out["b1"][f"tuned-stream-{m}"] = {**at, "launches": sum(r["launches"]["bin_sum"] for r in runs
                                                                   if r["chunk_rows"] == size)}
            del kd, vd, wd
        if keep_source:
            out["handover"] = {"tmp": tmp, "src": str(src), "files": files + 1, "rows": rows + per,
                               "arrays": (k, v, w), "new": (nk, nv, nw)}
            handed = True
    finally:
        bg.bin_sum = real_b1
        tracer.disable()
        tracer.clear()
        if not handed:
            shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - start
    return out


# serve_path: the serving layer and the standing views on the card
SERVE_THRESHOLDS = (0.1, 0.25, 0.5, 0.75)  # serve-mixed's four plans, priorities 0..3
SERVE_NEW_ROWS = 10_000_000  # serve-view's appended file
SERVE_TIMEOUT_S = 600.0


def serve_oracles(np, pd, k, v, w, thresholds) -> dict:
    """For each ``t`` of the ascending ``thresholds``, per key of ``k`` over
    the rows ``v > t`` keeps (NaN dropped; ``w`` has no NaN), of ``z = v *
    w`` in float32 as the card computes it: the count and the float64
    sum. One pass: each row's level is how many thresholds it passes, one
    ``bincount`` by (key, level) a slice of rows on a thread, and a
    threshold takes the levels above its index."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    levels = len(thresholds) + 1
    size = (int(k.max()) + 1) * levels if len(k) else levels

    def part(sl):
        kk, vv = k[sl], v[sl]
        level = np.zeros(len(vv), dtype=np.int64)
        for t in thresholds:
            level += vv > t
        key = kk * levels + level
        z = (vv * w[sl]).astype(np.float64)
        z[level == 0] = 0.0  # NaN rows are level 0; level 0 is read by no threshold
        return np.bincount(key, minlength=size), np.bincount(key, weights=z, minlength=size)

    parts = min(8, os.cpu_count() or 1)
    step = -(-len(k) // parts) or 1
    with ThreadPoolExecutor(parts) as pool:
        got = list(pool.map(part, [slice(i, i + step) for i in range(0, max(len(k), 1), step)]))
    n = sum(g[0] for g in got).reshape(-1, levels)
    s = sum(g[1] for g in got).reshape(-1, levels)
    out = {}
    for i, t in enumerate(thresholds):
        ni, si = n[:, i + 1:].sum(axis=1), s[:, i + 1:].sum(axis=1)
        keys = np.nonzero(ni > 0)[0]
        out[t] = pd.DataFrame({"k": keys, "s": si[keys], "n": ni[keys]})
    return out


def _merge_sn(np, pd, a, b):
    """The oracle of two sources' rows from theirs: counts and sums add."""
    m = a.merge(b, on="k", how="outer", suffixes=("_a", "_b")).sort_values("k").reset_index(drop=True)
    n = m["n_a"].fillna(0).astype(np.int64) + m["n_b"].fillna(0).astype(np.int64)
    out = pd.DataFrame({"k": m["k"].to_numpy(), "n": n.to_numpy()})
    out["s"] = np.where(n > 0, m["s_a"].fillna(0.0) + m["s_b"].fillna(0.0), np.nan)
    return out[["k", "s", "n"]]


def _check_serve(np, got, exp, what: str) -> str:
    got = got.sort_values("k").reset_index(drop=True)
    require(list(got.columns) == ["k", "s", "n"], f"{what}: columns {list(got.columns)}")
    require(len(got) == len(exp), f"{what}: {len(got)} groups, expected {len(exp)}")
    for c in ("k", "n"):
        require(np.array_equal(got[c].to_numpy(), exp[c].to_numpy()), f"{what}: {c}")
    g, e = got["s"].to_numpy(), exp["s"].to_numpy()
    require((np.isnan(g) == np.isnan(e)).all(), f"{what}: NULLs of s")
    ok = ~np.isnan(e)
    require(np.allclose(g[ok], e[ok], rtol=ORACLE_RTOL, atol=0), f"{what}: s vs oracle")
    return f"keys, counts exact; sums rtol={ORACLE_RTOL} vs float64 oracle"


def phase_serve_path(torch, np, pd, pa, bg, ff, col, device, handover: dict, seed: int,
                     new_rows: int = SERVE_NEW_ROWS) -> dict:
    """The serving layer and the standing views on the card, one line a
    cell, over cache_path's parquet directory (``handover``: its 11 files
    of config #3's frame plus ``w``, their columns; removed at the end).
    Each submission is ``LOAD dir → filter(v > t) → select(k, v * w AS z) →
    aggregate`` by ``k`` (SUM and COUNT of ``z``): one lowered segment, B1
    for SUM(z), checked against a float64 numpy oracle over the files it
    read. The engines run with the result cache off, but ``serve-fleet``'s
    and ``serve-view``'s, which need the shared store.

    - ``serve-dedup``: 4 sessions (threads) submit the same plan at once
      (``t = 0.25``, ``max_concurrent = 4``): one execution, 3 deduped
      waiters sharing its frame, B1 once;
    - ``serve-mixed``: 4 tenants, one distinct plan each (``t`` in
      ``SERVE_THRESHOLDS``, priorities 0-3, submitted lowest first while
      two gates hold the ``max_concurrent = 2`` workers): B1 4 times,
      executions started in priority order, the batch's wall time beside
      the four plans run one after another on the same engine;
    - ``serve-http``: through ``ServeHttpClient`` on loopback: submit, the
      same idempotency key replayed (the same submission id), poll, then a
      second submission of the tenant, whose ``budget_bytes`` lies below
      the first result's charged device bytes, refused with 429, then the
      result; ``/readyz`` (``serve_bound``) and ``/stats`` (``serve``);
    - ``serve-fleet``: two replicas on two engines on the card over one
      store (``fugue.tpu.cache.dir``), the same plan submitted to both at
      once: B1 once across both, both answer the oracle;
    - ``serve-view``: ``fugue.tpu.views.enabled``; a view of the chain over
      the directory: ``tick_once`` publishes generation 1 (B1 over every
      row); a file of ``new_rows`` rows appended, ``tick_once`` publishes
      generation 2, classified ``append`` and delta-served (B1 over the
      new rows, then the merge of the two partials); ``/serve/view``
      answers the oracle over all the files; the view's lag.

    Each line has its wall time, each submission's queue wait and run
    time, B1 launches counted from 0 just before the cell and the rows of
    each B1 call, ``engine.stats()["serve"]`` and the peak device bytes.
    After the servers stop and their yielded frames are dropped, the
    device's allocated bytes return to the phase's start, to the byte,
    while the stopped servers, their retained submissions and their
    engines are still referenced."""
    import os
    import shutil
    import threading
    from pathlib import Path

    import pyarrow.parquet as pq

    from fugue_tpu_torch.serve import EngineServer, ServeHttpClient, ServeRejected
    from fugue_tpu_torch.torch import TorchExecutionEngine
    from fugue_tpu_torch.workflow import FugueWorkflow

    start = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    out = {"phase": "serve_path", "cells": {}}
    tmp, src = Path(handover["tmp"]), handover["src"]
    files, rows = handover["files"], handover["rows"]
    k, v, w = handover["arrays"]
    nk, nv, nw = handover["new"]
    b1_rows: list = []
    real_b1 = bg.bin_sum

    def spy_b1(keys, values, valid, buckets):  # the rows each B1 call gets
        b1_rows.append(int(keys.shape[0]))
        return real_b1(keys, values, valid, buckets)

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    def chain(t: float, as_local: bool = False):
        def build():
            dag = FugueWorkflow()
            (dag.load(src, fmt="parquet").filter(col("v") > t).select(col("k"), (col("v") * col("w")).alias("z"))
             .partition_by("k").aggregate(s=ff.sum(col("z")), n=ff.count(col("z")))
             .yield_dataframe_as("r", as_local=as_local))
            return dag

        return build


    def begin() -> None:
        for name in bg.LAUNCHES:
            bg.LAUNCHES[name] = 0
        b1_rows.clear()
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def subs_line(subs: dict) -> dict:
        return {name: {"id": s.id, "tenant": s.tenant, "priority": s.priority, "deduped": s.deduped,
                       "queue_wait_s": s.queue_wait_s, "run_s": s.run_s} for name, s in subs.items()}

    def finish(cell: str, line: dict, *engines, launches=None, rows_=None) -> None:
        line = {"phase": "serve_path", "cell": cell, **line, "launches": launches or dict(bg.LAUNCHES),
                "b1_rows": list(b1_rows) if rows_ is None else rows_,
                "peak_device_bytes": torch.cuda.max_memory_allocated() if on_card else None,
                "phase_s_so_far": time.perf_counter() - start}
        emit(line, *engines)
        out["cells"][cell] = line

    def frame(res):
        return res.yields["r"].result.as_pandas()

    def gate_dag(release, entered):
        def make() -> pd.DataFrame:
            entered.release()
            require(release.wait(SERVE_TIMEOUT_S), "serve_path: a gate was never released")
            return pd.DataFrame({"a": [1]})

        dag = FugueWorkflow()
        dag.create(make, schema="a:long").yield_dataframe_as("g", as_local=True)
        return dag

    t0 = time.perf_counter()
    old, new = (serve_oracles(np, pd, *cols, SERVE_THRESHOLDS) for cols in ((k, v, w), (nk, nv, nw)))
    oracles = {t: _merge_sn(np, pd, old[t], new[t]) for t in SERVE_THRESHOLDS}
    del old, new
    oracle_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    mem_before = torch.cuda.memory_allocated() if on_card else 0
    bg.bin_sum = spy_b1
    servers: list = []

    def serve_dedup() -> None:
        """serve-dedup: four sessions, one plan, one execution."""
        eng = TorchExecutionEngine(device=device, conf={**NO_CACHE, "fugue.tpu.serve.max_concurrent": 4})
        srv = EngineServer(eng).start()
        servers.append(srv)
        begin()
        subs, barrier = {}, threading.Barrier(4)

        def session(i: int) -> None:
            barrier.wait()
            subs[f"session{i}"] = srv.submit(chain(0.25), tenant=f"session{i}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=session, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        require(len(subs) == 4, f"serve-dedup: {len(subs)} of 4 sessions admitted")
        results = {name: s.result(timeout=SERVE_TIMEOUT_S) for name, s in subs.items()}
        sync()
        wall_s = time.perf_counter() - t0
        frames = [r.yields["r"].result for r in results.values()]
        require(all(f is frames[0] for f in frames), "serve-dedup: the waiters' frames are not one frame")
        require(getattr(frames[0], "device", device) == device, "serve-dedup: the frame is not on the card")
        checks = _check_serve(np, frames[0].as_pandas(), oracles[0.25], "serve-dedup")
        st = srv.stats()
        require(st["executions"] == 1 and st["dedup_hits"] == 3 and sum(s.deduped for s in subs.values()) == 3,
                f"serve-dedup: {st['executions']} executions, {st['dedup_hits']} deduped")
        require(bg.LAUNCHES["bin_sum"] == (1 if on_card else 0) and b1_rows == [rows],
                f"serve-dedup: B1 {bg.LAUNCHES} over {b1_rows} rows")
        finish("serve-dedup", {"rows": rows, "files": files, "t": 0.25, "wall_s": wall_s, "oracle_s": oracle_s,
                               "submissions": subs_line(subs), "serve": eng.stats()["serve"], "checks": checks},
               eng)
        srv.stop()
        frames.clear()
        for r in results.values():  # the yields the retained submissions share
            r.yields.clear()

    def serve_mixed() -> None:
        """serve-mixed: four tenants, four plans, two workers, priority order."""
        eng = TorchExecutionEngine(device=device, conf={**NO_CACHE, "fugue.tpu.serve.max_concurrent": 2})
        srv = EngineServer(eng).start()
        servers.append(srv)
        release, entered = threading.Event(), threading.Semaphore(0)
        gates = [srv.submit(gate_dag(release, entered), tenant="gate") for _ in range(2)]
        for _ in gates:
            require(entered.acquire(timeout=SERVE_TIMEOUT_S), "serve-mixed: a gate did not start")
        begin()
        subs = {}
        for p in reversed(range(len(SERVE_THRESHOLDS))):  # the least urgent first
            t = SERVE_THRESHOLDS[p]
            subs[f"tenant{p}"] = srv.submit(chain(t), tenant=f"tenant{p}", priority=p)
        t0 = time.perf_counter()
        release.set()
        results = {name: s.result(timeout=SERVE_TIMEOUT_S) for name, s in subs.items()}
        sync()
        wall_s = time.perf_counter() - t0
        [g.result(timeout=SERVE_TIMEOUT_S) for g in gates]
        started = sorted(subs, key=lambda name: subs[name]._execution.started_at)
        require(started == [f"tenant{p}" for p in range(len(SERVE_THRESHOLDS))],
                f"serve-mixed: executions started {started}")
        checks = [_check_serve(np, frame(results[f"tenant{p}"]), oracles[t], f"serve-mixed t={t}")
                  for p, t in enumerate(SERVE_THRESHOLDS)][0]
        launches, batch_rows = dict(bg.LAUNCHES), list(b1_rows)
        require(launches["bin_sum"] == (4 if on_card else 0) and batch_rows == [rows] * 4,
                f"serve-mixed: B1 {launches} over {batch_rows} rows")
        st = eng.stats()["serve"]
        require(st["executions"] == 6 and st["dedup_hits"] == 0, f"serve-mixed: {st}")
        serial = {}
        for t in SERVE_THRESHOLDS:  # the same four plans one after another
            dag = chain(t)()
            sync()
            t1 = time.perf_counter()
            dag.run(eng)
            got = frame(dag)
            sync()
            serial[t] = time.perf_counter() - t1
            _check_serve(np, got, oracles[t], f"serve-mixed serial t={t}")
        bg.LAUNCHES.update(launches)
        b1_rows[:] = batch_rows
        finish("serve-mixed", {"rows": rows, "thresholds": list(SERVE_THRESHOLDS), "max_concurrent": 2,
                               "wall_s": wall_s, "serial_s": serial, "serial_sum_s": sum(serial.values()),
                               "started": started, "submissions": subs_line(subs), "serve": st,
                               "checks": checks + "; executions started in priority order"}, eng)
        srv.stop()
        for r in results.values():
            r.yields.clear()

    def serve_http() -> None:
        """serve-http: the same over http on loopback."""
        budget = 1024
        eng = TorchExecutionEngine(device=device, conf={
            **NO_CACHE, "fugue.rpc.server": HTTP_SERVER, "fugue.tpu.serve.max_concurrent": 2,
            "fugue.tpu.serve.tenant.tight.budget_bytes": budget})
        rpc = eng.rpc_server
        rpc.start()
        srv = EngineServer(eng).start()
        servers.append(srv)
        rpc.bind_serve(srv)
        try:
            cl = ServeHttpClient(rpc.host, rpc.port)
            begin()
            t0 = time.perf_counter()
            a = cl.submit(chain(0.5), tenant="tight", idempotency_key="serve-http-1")
            b = cl.submit(chain(0.5), tenant="tight", idempotency_key="serve-http-1")
            require(a["id"] == b["id"], f"serve-http: the replay answered {b['id']}, not {a['id']}")
            polls = 1
            while cl.poll(a["id"])["status"] not in ("done", "failed"):
                polls += 1
                time.sleep(0.01)
            # "done" shows before the waiters are released, and the charge is
            # restated to the result's bytes in between
            require(srv.get(a["id"]).wait(SERVE_TIMEOUT_S), "serve-http: the submission did not finish")
            held = srv.get(a["id"])._execution.result.yields["r"].result
            charged = srv.stats()["charged_bytes"].get("tight", 0)
            require(charged == held.device_nbytes > budget,
                    f"serve-http: charged {charged} B, the frame's device bytes {held.device_nbytes}")
            rejected = None
            try:
                cl.submit(chain(0.75), tenant="tight")
            except ServeRejected as ex:  # the client raises it on a 429
                rejected = ex.reason
            require(rejected == "tenant_budget", f"serve-http: the over-budget submission got {rejected}")
            got = cl.result(a["id"], timeout=SERVE_TIMEOUT_S)["r"]
            sync()
            wall_s = time.perf_counter() - t0
            checks = _check_serve(np, got, oracles[0.5], "serve-http")
            after_claim = srv.stats()["charged_bytes"].get("tight", 0)
            ready = json.loads(urllib_get(rpc, "/readyz"))
            stats = json.loads(urllib_get(rpc, "/stats"))
            require(ready.get("serve_bound") is True and "serve" in stats and stats["serve"]["completed"] >= 1,
                    f"serve-http: /readyz {ready}, /stats keys {sorted(stats)}")
            st = srv.stats()
            require(st["idempotent_replays"] == 1 and st["rejected_budget"] == 1 and st["executions"] == 1,
                    f"serve-http: {st}")
            require(bg.LAUNCHES["bin_sum"] == (1 if on_card else 0) and b1_rows == [rows],
                    f"serve-http: B1 {bg.LAUNCHES} over {b1_rows} rows")
            finish("serve-http", {"rows": rows, "t": 0.5, "wall_s": wall_s, "polls": polls, "id": a["id"],
                                  "replayed_id": b["id"], "budget_bytes": budget, "charged_bytes": charged,
                                  "charged_after_claim": after_claim, "rejected": {"http": 429, "reason": rejected},
                                  "readyz": ready, "stats_serve_completed": stats["serve"]["completed"],
                                  "serve": eng.stats()["serve"], "checks": checks}, eng)
        finally:
            srv.stop()
            rpc.stop()
        srv.get(a["id"]).result(timeout=SERVE_TIMEOUT_S).yields.clear()

    def serve_fleet() -> None:
        """serve-fleet: two replicas over one store, the same plan to both."""
        store = tmp / "fleet"
        fconf = {"fugue.tpu.cache.dir": str(store), "fugue.tpu.serve.fleet.enabled": True}
        ea = TorchExecutionEngine(device=device, conf={**fconf, "fugue.tpu.serve.replica_id": "replica-a"})
        eb = TorchExecutionEngine(device=device, conf={**fconf, "fugue.tpu.serve.replica_id": "replica-b"})
        sa, sb = EngineServer(ea).start(), EngineServer(eb).start()
        servers.extend([sa, sb])
        begin()
        subs, barrier = {}, threading.Barrier(2)

        def replica(name: str, s) -> None:
            barrier.wait()
            subs[name] = s.submit(chain(0.25), tenant="fleet")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=replica, args=(n, s)) for n, s in (("replica-a", sa), ("replica-b", sb))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        results = {name: s.result(timeout=SERVE_TIMEOUT_S) for name, s in subs.items()}
        sync()
        wall_s = time.perf_counter() - t0
        checks = [_check_serve(np, frame(r), oracles[0.25], f"serve-fleet {name}") for name, r in results.items()][0]
        sts = {"replica-a": sa.stats(), "replica-b": sb.stats()}
        fleet = {name: {c: s[c] for c in s if c.startswith("fleet_") or c in ("executions", "dedup_hits")}
                 for name, s in sts.items()}
        require(sum(s["fleet_publishes"] for s in sts.values()) == 1, f"serve-fleet: {fleet}")
        require(bg.LAUNCHES["bin_sum"] == (1 if on_card else 0) and b1_rows == [rows],
                f"serve-fleet: B1 {bg.LAUNCHES} over {b1_rows} rows")
        finish("serve-fleet", {"rows": rows, "t": 0.25, "wall_s": wall_s, "submissions": subs_line(subs),
                                "fleet": fleet, "serve": {"replica-a": ea.stats()["serve"],
                                                          "replica-b": eb.stats()["serve"]},
                                "checks": checks})
        sa.stop()
        sb.stop()
        [e.result_cache.clear() for e in (ea, eb)]
        for r in results.values():
            r.yields.clear()

    def serve_view() -> None:
        """serve-view: a standing view, a full generation, then an append."""
        veng = TorchExecutionEngine(device=device, conf={
            "fugue.tpu.cache.dir": str(tmp / "views"), "fugue.tpu.views.enabled": True,
            "fugue.tpu.views.poll_s": 3600.0, "fugue.tpu.serve.replica_id": "views",
            "fugue.rpc.server": HTTP_SERVER})
        rpc = veng.rpc_server
        rpc.start()
        vsrv = EngineServer(veng).start()
        servers.append(vsrv)
        rpc.bind_serve(vsrv)
        try:
            vs = vsrv.views
            # the loop's first tick (at start) ends before the view is
            # registered, and no other comes: only the tick_once() calls
            # below publish, none beside a loop tick
            vs.maintainer.halt_for_test()
            vs.maintainer._stop_evt.clear()
            vs.register("serve_agg", chain(0.25, as_local=True), src, fmt="parquet", tenant="views")
            begin()
            t0 = time.perf_counter()
            vs.maintainer.tick_once()
            sync()
            gen1_s = time.perf_counter() - t0
            res = vs.result("serve_agg")
            require(res is not None and res["generation"] == 1 and res["mode"] == "full",
                    f"serve-view: generation 1 {None if res is None else (res['generation'], res['mode'])}")
            _check_serve(np, res["frames"]["r"], oracles[0.25], "serve-view generation 1")
            gen1 = {"s": gen1_s, "launches": dict(bg.LAUNCHES), "b1_rows": list(b1_rows)}
            require(gen1["launches"]["bin_sum"] == (1 if on_card else 0) and gen1["b1_rows"] == [rows],
                    f"serve-view: generation 1 B1 {gen1}")
            rng = np.random.default_rng(seed + 31)  # the appended file's rows
            ak = rng.integers(0, 1000, new_rows, dtype=np.int64)
            av = rng.random(new_rows, dtype=np.float32)
            av[rng.random(new_rows) < 0.01] = np.nan
            aw = rng.random(new_rows, dtype=np.float32)
            pq.write_table(pa.table({"k": ak, "v": av, "w": aw}), os.path.join(src, f"part_{files:03d}.parquet"),
                           compression="none")
            exp12 = _merge_sn(np, pd, oracles[0.25], serve_oracles(np, pd, ak, av, aw, (0.25,))[0.25])
            begin()
            t0 = time.perf_counter()
            vs.maintainer.tick_once()
            sync()
            gen2_s = time.perf_counter() - t0
            res = vs.result("serve_agg")
            head = vs.registry.head("serve_agg")
            require(res["generation"] == 2 and res["mode"] == "delta" and not head.get("reason"),
                    f"serve-view: generation 2 {res['generation']} {res['mode']} {head.get('reason')}")
            # B1 over the new rows (the fresh partial), then the merge of the
            # two partials' float32 sums (one row a key each)
            require(b1_rows[:1] == [new_rows] and all(r <= 2 * 1000 for r in b1_rows[1:]),
                    f"serve-view: generation 2 B1 over {b1_rows} rows")
            require(bg.LAUNCHES["bin_sum"] == (len(b1_rows) if on_card else 0),
                    f"serve-view: generation 2 B1 {bg.LAUNCHES}")
            gen2 = {"launches": dict(bg.LAUNCHES), "b1_rows": list(b1_rows)}
            t0 = time.perf_counter()
            served = ServeHttpClient(rpc.host, rpc.port).view("serve_agg", timeout=60)
            view_ms = (time.perf_counter() - t0) * 1e3
            checks = _check_serve(np, served["frames"]["r"], exp12, "serve-view /serve/view")
            vst = veng.stats()["views"]
            require(vst["generations_published"] == 2 and vst["delta_refusals"] == 0, f"serve-view: {vst}")
            lag = vs.describe("serve_agg")
            finish("serve-view", {"rows": rows + new_rows, "files": files + 1, "t": 0.25,
                                  "generation_1": gen1, "generation_2": {"s": gen2_s, "mode": res["mode"],
                                                                          "rows_new": new_rows, **gen2},
                                  "served": {"generation": served["generation"], "mode": served["mode"],
                                             "staleness_s": served["staleness_s"], "ms": view_ms},
                                  "lag": {"staleness_s": lag.get("staleness_s"), "as_of": lag.get("as_of")},
                                  "views": vst, "serve": veng.stats()["serve"], "checks": checks},
                   launches={n: gen1["launches"][n] + gen2["launches"][n] for n in gen1["launches"]},
                   rows_=gen1["b1_rows"] + gen2["b1_rows"])
        finally:
            vsrv.stop()
            rpc.stop()
        veng.result_cache.clear()

    try:
        serve_dedup()
        serve_mixed()
        serve_http()
        serve_fleet()
        serve_view()
    finally:
        bg.bin_sum = real_b1
        for srv in servers:
            srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    # the stopped servers, their retained submissions and their engines still
    # referenced, the yielded frames dropped: the device back to its start
    gc.collect()
    sync()
    mem_after = torch.cuda.memory_allocated() if on_card else 0
    retained = sum(srv.stats()["retained"] for srv in servers)
    require(mem_after == mem_before, f"serve_path: {mem_after - mem_before} device bytes held after stop() "
                                     f"by {len(servers)} servers retaining {retained} submissions")
    out["memory"] = {"before_phase": mem_before, "after_stop": mem_after, "servers": len(servers),
                     "retained_submissions": retained}
    servers.clear()
    emit({"phase": "serve_path", "cell": "memory", **out["memory"]})
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - start
    return out


# warehouse_path: config #2 on the hybrid engine (SQL in sqlite, maps on the card)
WH_MIXED_ROWS = 1_000_000  # hybrid-mixed-1m, cut in scale by the sqlite ingest's ~5.5 us a row
WH_MIXED_RTOL, WH_MIXED_ATOL = 1e-4, 1e-3  # float32 binned sums vs a float64 oracle
WH_STEPS = ("load_ingest", "sqlite", "fetch_arrow", "device_map", "ingest_back", "connect", "drop")


def wh_mixed_text(path: str) -> str:
    """The mixed pipeline: a SELECT in sqlite, a keyed torch UDF on the
    card, a ``CONNECT torch`` aggregate (B1 for the float32 SUM), and an
    ORDER BY in sqlite."""
    return f"""
    src = LOAD "{path}"
    big = SELECT k, v, w FROM src WHERE w > 0.1
    centered = TRANSFORM big PREPARTITION BY k USING demean_t SCHEMA k:long,z:float,w:double
    sums = CONNECT torch SELECT k, SUM(z) AS s, COUNT(*) AS n FROM centered GROUP BY k
    SELECT k, s, n FROM sums ORDER BY k
    """


def wh_mixed_oracle(np, pdf) -> dict:
    """The mixed pipeline in float64 numpy: each kept row's z rounded to
    float32 as the UDF writes it, then summed by key."""
    keep = pdf["w"].to_numpy() > 0.1
    k, v, w = pdf["k"].to_numpy()[keep], pdf["v"].to_numpy()[keep], pdf["w"].to_numpy()[keep]
    keys, inv, n = np.unique(k, return_inverse=True, return_counts=True)
    mean = np.bincount(inv, weights=v) / n
    z = ((v - mean[inv]) * w).astype(np.float32)
    return {"k": keys, "n": n, "s": np.bincount(inv, weights=z.astype(np.float64)), "rows_k": k, "rows_z": z}


# the split's steps: the span that times each, counted where no other of
# these spans encloses it (the LOAD's ingest is the load's, the fetch and
# the ingest inside a CONNECT are the CONNECT's)
WH_STEP_SPANS = {"warehouse.load": "load_ingest", "warehouse.materialize": "sqlite",
                 "warehouse.fetch": "fetch_arrow", "engine.transform": "device_map",
                 "warehouse.ingest": "ingest_back", "sql.connect": "connect", "warehouse.drop": "drop"}


def wh_split(recs: list, wall_ms: float) -> dict:
    """The split of one call's wall time over ``WH_STEPS``, read from the
    spans the call recorded: each step's time, calls and the rows its
    spans report (the device map's, those its ``warehouse.map`` fetched; a
    statement's, those a whole fetch of its table read, else None; a
    dropped table's, those its ingest wrote or a fetch read, else None),
    and ``other`` for the rest. Spans time the host: a step's device work
    ends by the next copy to the host at the latest."""
    by_id = {r["id"]: r for r in recs}
    fetched = {r["args"].get("table"): r["args"].get("rows") for r in recs
               if r["name"] in ("warehouse.fetch", "warehouse.ingest")}
    ms = {st: 0.0 for st in WH_STEPS}
    calls = {st: 0 for st in WH_STEPS}
    rows: dict = {st: [] for st in WH_STEPS}
    for r in recs:
        step = WH_STEP_SPANS.get(r["name"])
        if step is None:
            continue
        parent = by_id.get(r["parent"])
        up, nested = parent, False
        while up is not None and not nested:
            nested = up["name"] in WH_STEP_SPANS
            up = by_id.get(up["parent"])
        if nested:
            continue
        ms[step] += r["dur"] / 1e6
        calls[step] += 1
        if step in ("sqlite", "drop"):
            rows[step].append(fetched.get(r["args"]["table"]))
        elif step == "device_map":
            rows[step].append(parent["args"].get("rows") if parent is not None else None)
        else:
            rows[step].append(r["args"].get("rows"))
    return {"split_ms": {**ms, "other": wall_ms - sum(ms.values())}, "step_calls": calls, "step_rows": rows}


def phase_warehouse_path(torch, np, pd, pa, bg, go, device, rows: int = SQL_PIPELINE_ROWS,
                         mixed_rows: int = WH_MIXED_ROWS, twin=None) -> dict:
    """Config #2 on ``WarehouseTorchExecutionEngine`` (``sqlite_torch``: the
    SQL in sqlite, the maps on ``device``), one line a cell, over config
    #2's frame (``sql_pipeline_frame``) written to parquet in a temporary
    directory of the checkout, removed after; every engine has the result
    cache off.

    - ``hybrid-pipeline-4m``: BASELINE config #2 verbatim
      (``sql_pipeline_text``, ``rescale``, ``rows`` rows), one call,
      checked against ``sql_pipeline_oracle`` and timed, beside its twin
      ``sql-pipeline-4m`` of sql_path on the torch engine (``twin``): B1 0
      (the sums are float64 and run in sqlite); ``rescale`` is a pandas UDF,
      so the torch map engine runs it through its host path and returns a
      ``TorchDataFrame``;
    - ``hybrid-mixed-1m``: ``wh_mixed_text`` over the first ``mixed_rows``
      rows, one call, checked, timed and split: the torch UDF's map
      returns a ``TorchDataFrame`` on the card (the dense keyed plan, no
      host map), ``centered``'s ``z`` is float32 after the sqlite round
      trip, B1 launches once a call, inside the ``CONNECT torch`` step, and
      the temporary engine that step makes is stopped; keys and counts
      equal a float64 numpy oracle, ``s`` within ``WH_MIXED_RTOL`` /
      ``WH_MIXED_ATOL``, the rows in ORDER BY order; then B1 alone at the
      shape that step gave it, beside its bound and ``index_add_``.

    Each line has its wall time split into the steps (``WH_STEPS``: LOAD's
    ingest into sqlite, the sqlite statements, ``fetch_arrow``, the device
    map, the ingest back, the ``CONNECT`` step, the drops of released
    temp tables, and the rest), read from the spans the port records
    while tracing is on (``wh_split``), the rows each step moved, B1
    launches counted from 0 just before the cell and the peak device
    bytes. Inside the timed call the harness counts the host map's calls
    and, as the CONNECT step starts, notes B1's count and reads one row of
    its input (its arrow schema after sqlite); it holds no frame, so the
    run drops its tables as it would alone. After the cells, with the frames dropped and
    before ``stop()``, each engine's connection holds no temp table; after
    ``stop()`` the device's allocated bytes are back to the phase's start,
    to the byte."""
    import shutil
    import tempfile
    from pathlib import Path

    import pyarrow.parquet as pq

    import fugue_tpu_torch.execution.factory as factory
    from fugue_tpu_torch import api
    from fugue_tpu_torch.extensions._builtins.processors import RunSQLSelect
    from fugue_tpu_torch.obs import get_tracer
    from fugue_tpu_torch.torch import TorchDataFrame
    from fugue_tpu_torch.warehouse import WarehouseTorchExecutionEngine

    start = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    out = {"phase": "warehouse_path", "cells": {}}
    T = Dict[str, torch.Tensor]

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    def rescale(df: pd.DataFrame) -> pd.DataFrame:
        df["s"] = df["s"] / df["s"].max()
        return df

    def demean_t(cols: T) -> T:
        z = ((cols["v"] - go.per_row(cols, go.mean(cols, cols["v"]))) * cols["w"]).float()
        return {"k": cols["k"], "z": z, "w": cols["w"]}

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    sync()
    mem_before = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    pdf = sql_pipeline_frame(np, pd, rows)
    expected = sql_pipeline_oracle(pdf)
    mixed = wh_mixed_oracle(np, pdf.iloc[:mixed_rows])
    tmp = Path(tempfile.mkdtemp(prefix=".warehouse_path_", dir=Path(__file__).resolve().parent))
    path, mixed_path = str(tmp / "config2.parquet"), str(tmp / "config2_mixed.parquet")
    pq.write_table(pa.Table.from_pandas(pdf, preserve_index=False), path)
    pq.write_table(pa.Table.from_pandas(pdf.iloc[:mixed_rows], preserve_index=False), mixed_path)
    del pdf
    setup_s = time.perf_counter() - t0
    engines: list = []
    made: list = []  # the engines CONNECT makes; B1's count and its input's schema as it starts
    connect_b1: list = []
    centered_types: list = []
    real_make = factory.make_execution_engine
    real_connect = RunSQLSelect.process
    tracer = get_tracer()

    def make_spy(*a, **k):
        e = real_make(*a, **k)
        if not any(e is x for x in engines):  # a run resolving its own engine
            made.append(e)
        return e

    def connect_spy(self, dfs):
        """A CONNECT's select: note B1's count as it starts and the arrow
        schema of its input after sqlite (one row read)."""
        if self.params.get_or_none("sql_engine", object) is not None:
            connect_b1.append(bg.LAUNCHES["bin_sum"])
            centered_types.extend(str(df.head(1).as_arrow().schema) for df in dfs.values())
        return real_connect(self, dfs)

    def run_cell(cell: str, text: str, cell_rows: int) -> None:
        eng = WarehouseTorchExecutionEngine(NO_CACHE, device=device)
        engines.append(eng)
        host_maps = [0]
        tmap = eng.torch_engine.map_engine
        real_host = tmap._host_map.map_dataframe

        def host_spy(*a, **k):
            host_maps[0] += 1
            return real_host(*a, **k)

        tmap._host_map.map_dataframe = host_spy
        checks, runs = [], []
        try:
            for name in bg.LAUNCHES:
                bg.LAUNCHES[name] = 0
            host_maps[0] = 0
            made.clear()
            connect_b1.clear()
            centered_types.clear()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            sync()
            tracer.clear()
            tracer.enable()
            try:
                t1 = time.perf_counter()
                res = api.fugue_sql(text, rescale=rescale, demean_t=demean_t, engine=eng, as_fugue=True)
                sync()
                wall_ms = (time.perf_counter() - t1) * 1e3
            finally:
                tracer.disable()
            launches = dict(bg.LAUNCHES)
            recs = tracer.records()
            tracer.clear()
            split = wh_split(recs, wall_ms)
            maps = [(r["args"].get("frame"), r["args"].get("device")) for r in recs
                    if r["name"] == "warehouse.map"]
            got = res.as_pandas()
            del res, recs
            stopped = [bool(e._stopped) for e in made]
            run = {"wall_ms": wall_ms, "launches": launches, **split,
                   "device_map_results": list(maps), "host_maps": host_maps[0],
                   "connect_engines": [type(e).__name__ for e in made], "connect_engines_stopped": stopped,
                   "peak_device_bytes": torch.cuda.max_memory_allocated() if on_card else None}
            calls = split["step_calls"]
            want_calls = {"load_ingest": 1, "device_map": 1, "ingest_back": 1,
                          "connect": 0 if cell == "hybrid-pipeline-4m" else 1}
            require(all(calls[st] == n for st, n in want_calls.items()) and calls["sqlite"] >= 1
                    and calls["fetch_arrow"] >= 1, f"{cell}: the steps' spans {calls}")
            require(len(maps) == 1 and maps[0][0] == "TorchDataFrame",
                    f"{cell}: the torch map engine returned {maps}")
            if cell == "hybrid-pipeline-4m":
                require(launches["bin_sum"] == 0, f"{cell}: B1 launched {launches['bin_sum']} times")
                require(host_maps[0] == 1, f"{cell}: rescale took the host path {host_maps[0]} times")
                require(len(got) == len(expected), f"{cell}: {len(got)} groups")
                check_sql_pipeline(np, got, expected)
                checks.append(f"keys and counts exact; s rtol={SQL_PIPELINE_RTOL} atol={SQL_PIPELINE_ATOL} "
                              "vs a pandas oracle of the same frame")
            else:
                require(maps[0][1] == str(device), f"{cell}: the map ran on {maps[0][1]}")
                require(host_maps[0] == 0, f"{cell}: the torch UDF took the host path")
                require(len(centered_types) == 1 and "z: float\n" in centered_types[0] + "\n",
                        f"{cell}: CONNECT's input after sqlite {centered_types}")
                want_b1 = 1 if on_card else 0
                require(launches["bin_sum"] == want_b1, f"{cell}: B1 launched {launches['bin_sum']} times")
                require(len(connect_b1) == 1 and launches["bin_sum"] - connect_b1[0] == want_b1,
                        f"{cell}: B1 outside the CONNECT step")
                require([type(e).__name__ for e in made] == ["TorchExecutionEngine"] and all(stopped),
                        f"{cell}: CONNECT's engines {made} stopped {stopped}")
                require(list(got.columns) == ["k", "s", "n"], f"{cell}: columns {list(got.columns)}")
                require(got["k"].tolist() == sorted(got["k"].tolist()), f"{cell}: not in ORDER BY order")
                require(np.array_equal(got["k"].to_numpy(), mixed["k"])
                        and np.array_equal(got["n"].to_numpy(), mixed["n"]), f"{cell}: keys or counts differ")
                require(np.allclose(got["s"].to_numpy(), mixed["s"], rtol=WH_MIXED_RTOL, atol=WH_MIXED_ATOL),
                        f"{cell}: s differs from the float64 oracle")
                checks.append(f"keys and counts exact; s rtol={WH_MIXED_RTOL} atol={WH_MIXED_ATOL} vs a "
                              "float64 numpy oracle; ORDER BY; z float32 after sqlite")
                run["centered_schema"] = centered_types[0]
            runs.append(run)
            made.clear()
        finally:
            tmap._host_map.map_dataframe = real_host
        line = {"phase": "warehouse_path", "cell": cell, "rows": cell_rows, **runs[-1], "checks": checks,
                "first_call_ms": runs[0]["wall_ms"], "setup_s": setup_s,
                "phase_s_so_far": time.perf_counter() - start}
        if cell == "hybrid-pipeline-4m" and twin is not None:
            line.update(twin="sql-pipeline-4m", twin_ms=twin["ms"], twin_first_call_s=twin["first_call_s"])
        emit(line, eng)
        out["cells"][cell] = line

    try:
        factory.make_execution_engine = make_spy
        RunSQLSelect.process = connect_spy
        run_cell("hybrid-pipeline-4m", sql_pipeline_text(path), rows)
        run_cell("hybrid-mixed-1m", wh_mixed_text(mixed_path), mixed_rows)
    finally:
        factory.make_execution_engine = real_make
        RunSQLSelect.process = real_connect
        shutil.rmtree(tmp, ignore_errors=True)

    # B1 alone at the shape CONNECT torch gave it, the kept rows' keys and z
    # (CUDA events time it: on the card only)
    out["b1"] = {}
    if on_card:
        kk = torch.as_tensor(mixed["rows_k"], device=device)
        zz = torch.as_tensor(mixed["rows_z"], device=device)
        valid = torch.ones(kk.shape[0], dtype=torch.bool, device=device)
        b1 = b1_at_shape(torch, bg, kk, zz, valid, int(mixed["k"].min()), int(mixed["k"].max()), plain_reps=3)
        out["b1"]["hybrid-mixed-1m"] = {**b1, "launches": out["cells"]["hybrid-mixed-1m"]["launches"]["bin_sum"]}
        del kk, zz, valid
    emit({"phase": "warehouse_path", "cell": "b1-at-shape", "shapes": out["b1"]})

    # no temp table of the phase's frames left in a connection, then stop
    gc.collect()
    left = {i: e.connection.execute("SELECT name FROM sqlite_temp_master WHERE name LIKE '_fugue_temp_table_%'")
            .fetchall() for i, e in enumerate(engines)}
    for e in engines:
        e.stop()
    require(all(len(v) == 0 for v in left.values()), f"warehouse_path: temp tables left {left}")
    require(all(e._stopped and e.torch_engine._stopped for e in engines), "warehouse_path: an engine still runs")
    n_engines = len(engines)
    engines.clear()
    gc.collect()
    sync()
    mem_after = torch.cuda.memory_allocated() if on_card else 0
    require(mem_after == mem_before, f"warehouse_path: {mem_after - mem_before} device bytes held after stop()")
    out["memory"] = {"before_phase": mem_before, "after_stop": mem_after, "engines": n_engines,
                     "temp_tables_left": 0}
    emit({"phase": "warehouse_path", "cell": "memory", **out["memory"]})
    if on_card:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - start
    return out


# dist_path: config #3's frame family over parquet, cut in scale from 10^8
# rows (the worker tier is host work: 10^7 rows took the JAX package's
# in-process tier 3.70 s on an 8-core CPU)
DIST_ROWS, DIST_FILES = 10_000_000, 16
DIST_KEYS, DIST_GROUPS = 1_000_000, 1024
DIST_KILL_ROWS, DIST_KILL_FILES = 2_000_000, 4
DIST_WORKERS, DIST_BUCKETS, DIST_TIMEOUT_S = 3, 8, 120
DIST_RTOL = 1e-4  # float32 binned sums vs a float64 oracle
# bench.py's _DIST_CONF: fetch=remote is the multi-host shape, every
# foreign fragment over the producer's /dist/fetch
DIST_CONF = {
    "fugue.tpu.dist.heartbeat.interval_s": 0.2,
    "fugue.tpu.dist.heartbeat.stale_after_s": 1.2,
    "fugue.tpu.dist.lease_s": 2.5,
    "fugue.tpu.dist.fetch": "remote",
    "fugue.tpu.cache.enabled": False,
    "fugue.tpu.tuning.enabled": False,
}
DIST_VICTIM_PLAN = "dist.lease=delay:4@1"  # dist-kill-2m: w0 holds its first lease 4 s
# ... and w1, w2 their first 0.5 s, so that w0 surely takes one
DIST_SURVIVOR_PLAN = "dist.lease=delay:0.5@1"


def dist_frames(np, pa, pq, root, seed: int, rows: int, files: int, dim: bool) -> dict:
    """``fact`` (``k`` int64 uniform over ``DIST_KEYS``, ``g`` int64 over
    ``DIST_GROUPS``, ``v`` float32) as ``files`` parquet files under
    ``root/fact``, and with ``dim`` the dimension table (``k`` 0 ..
    DIST_KEYS-1, ``w`` float32) under ``root/dim``; returns the arrays."""
    import os

    rng = np.random.default_rng(seed)
    k = rng.integers(0, DIST_KEYS, rows, dtype=np.int64)
    g = rng.integers(0, DIST_GROUPS, rows, dtype=np.int64)
    v = rng.random(rows, dtype=np.float32)
    os.makedirs(os.path.join(root, "fact"))
    edges = np.linspace(0, rows, files + 1).astype(np.int64)
    for i in range(files):
        lo, hi = edges[i], edges[i + 1]
        pq.write_table(pa.table({"k": k[lo:hi], "g": g[lo:hi], "v": v[lo:hi]}),
                       os.path.join(root, "fact", f"part-{i:04d}.parquet"))
    out = {"k": k, "g": g, "v": v}
    if dim:
        w = rng.random(DIST_KEYS, dtype=np.float32)
        os.makedirs(os.path.join(root, "dim"))
        pq.write_table(pa.table({"k": np.arange(DIST_KEYS, dtype=np.int64), "w": w}),
                       os.path.join(root, "dim", "part-0000.parquet"))
        out["w"] = w
    return out


def dist_oracle(np, arrays: dict, w) -> dict:
    """The workflow in numpy: rows with ``v > 0.25`` joined to ``w`` by
    ``k`` (every key is in the dimension), ``z = v * w`` in float32 as the
    card computes it, summed in float64 by ``g``."""
    keep = arrays["v"] > 0.25
    g = arrays["g"][keep]
    z = arrays["v"][keep] * w[arrays["k"][keep]]
    return {"g": np.arange(DIST_GROUPS), "n": np.bincount(g, minlength=DIST_GROUPS),
            "s": np.bincount(g, weights=z.astype(np.float64), minlength=DIST_GROUPS),
            "rows_g": g, "rows_z": z}


def _worker_state(pid: int) -> dict:
    """Whether a process has a CUDA device file open (a context opens
    ``/dev/nvidia*``) and whether it loaded torch (``libtorch`` mapped)."""
    import os

    card = False
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                card = card or os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
            except OSError:
                continue
        with open(f"/proc/{pid}/maps") as f:
            torch_loaded = "libtorch" in f.read()
    except OSError:
        torch_loaded = False
    return {"card": card, "torch": torch_loaded}


def phase_dist_path(torch, np, pd, pa, bg, ff, col, device, seed: int, rows: int = DIST_ROWS,
                    files: int = DIST_FILES, kill_rows: int = DIST_KILL_ROWS,
                    kill_files: int = DIST_KILL_FILES) -> dict:
    """The worker tier and the workflow's distributed pass, one line a cell.
    ``LOAD fact → filter(v > 0.25) → join(LOAD dim, on k) → select(g, v * w
    AS z) → aggregate(SUM(z), COUNT(z)) by g`` on ``TorchExecutionEngine``
    on ``device`` (result cache and tuner off): the optimizer lowers it into
    two segments, the planner makes one fragment of the first (the filter
    in the fact side's map, the join in the reduce: ``DIST_BUCKETS``
    buckets), and ``select → aggregate`` runs on the card over the frame
    that lands there (B1 for the float32 SUM). The workers are
    ``DIST_WORKERS`` fresh interpreters a board (``python -m
    fugue_tpu_torch.dist.worker``, host engines, ``DIST_CONF``), all six
    started at once at the phase's start; the data is parquet in a
    temporary directory of the checkout, removed after.

    - ``dist-join-agg-10m``: ``rows`` rows in ``files`` files on a fresh
      board: the explain's fragment, keys and counts equal to a float64
      numpy oracle and ``s`` within ``DIST_RTOL``, the result a
      ``TorchDataFrame`` on ``device``, B1 once (counted from 0 just
      before), one workflow job, no failed task, a zero audit, the rows
      that landed equal to the oracle's; the wall time split into the
      fragment (span ``dist.workflow_fragment``), the card's segment
      (``plan.segment``) and the rest; its twin is the same workflow with
      no board on the same engine (local on the card, B1 once);
    - ``dist-warm-10m``: the same on the same board: 0 tasks dispatched,
      every task's done record reused, B1 once, the same result;
    - ``dist-kill-2m``: ``kill_rows`` rows in ``kill_files`` files on its
      own board and workers, the event log on, ``w0`` under
      ``DIST_VICTIM_PLAN`` (the others under ``DIST_SURVIVOR_PLAN``, so
      that ``w0`` takes a lease): SIGKILLed while it holds it; at
      least one WORKER_LOST re-dispatch, the steal in the event log, a
      zero audit, the result against its oracle, B1 once;
    - ``b1-at-shape``: B1 alone at the local segment's shape beside its
      bound and ``index_add_``;
    - ``processes``: no worker loaded torch, held a CUDA device file or
      showed in ``nvidia-smi``'s compute apps while it ran (a worker is a
      host engine: it never imports torch); each stopped by its stop
      file (the victim excepted), none left a child of this process; the
      device's allocated bytes back to the phase's start, to the byte."""
    import os
    import shutil
    import signal
    import tempfile
    import threading
    from pathlib import Path

    import pyarrow.parquet as pq

    from fugue_tpu_torch.dist.heartbeat import read_heartbeat
    from fugue_tpu_torch.obs import get_tracer, read_events
    from fugue_tpu_torch.torch import TorchDataFrame, TorchExecutionEngine
    from fugue_tpu_torch.workflow import FugueWorkflow

    start = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    out = {"phase": "dist_path", "cells": {}}

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    sync()
    mem_before = torch.cuda.memory_allocated() if on_card else 0
    here = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix=".dist_path_", dir=here))
    boards = {"main": str(tmp / "board"), "kill": str(tmp / "board_kill")}
    events_dir = str(tmp / "events")
    procs: dict = {}  # (board, worker id) -> Popen
    logs: list = []
    victim: dict = {"pid": None}
    tracer = get_tracer()

    def launch(board: str, wid: str, extra: dict) -> None:
        conf = dict(DIST_CONF, **extra)
        log = open(str(tmp / f"{os.path.basename(board)}-{wid}.log"), "w")
        logs.append(log)
        procs[(board, wid)] = subprocess.Popen(
            [sys.executable, "-m", "fugue_tpu_torch.dist.worker", "--root", board, "--id", wid,
             "--conf", json.dumps(conf), "--stop-file", os.path.join(board, "_stop")],
            cwd=str(here), stdout=log, stderr=subprocess.STDOUT)

    def log_tails() -> str:
        tails = []
        for log in logs:
            log.flush()
            with open(log.name) as f:
                tails.append(f"{os.path.basename(log.name)}: {f.read()[-600:]}")
        return " | ".join(tails)

    def workers_up(board: str, timeout: float = 120.0) -> None:
        hb_dir = os.path.join(board, "hb")
        deadline = time.monotonic() + timeout
        while not all(read_heartbeat(hb_dir, f"w{i}") is not None for i in range(DIST_WORKERS)):
            dead = [w for (b, w), p in procs.items() if b == board and p.poll() is not None]
            require(not dead and time.monotonic() < deadline,
                    f"dist_path: workers of {board} not up (exited: {dead}); {log_tails()}")
            time.sleep(0.05)

    def build(dag, fact: str, dim: str):
        (dag.load(fact, fmt="parquet").filter(col("v") > 0.25)
         .join(dag.load(dim, fmt="parquet"), how="inner", on=["k"])
         .select(col("g"), (col("v") * col("w")).alias("z"))
         .partition_by("g").aggregate(ff.sum(col("z")).alias("s"), ff.count(col("z")).alias("n"))
         .yield_dataframe_as("r"))
        return dag

    def run_conf(board: str) -> dict:
        return {"fugue.tpu.dist.board": board, "fugue.tpu.dist.buckets": DIST_BUCKETS,
                "fugue.tpu.dist.workflow_timeout_s": DIST_TIMEOUT_S}

    def check(res, exp: dict, cell: str) -> str:
        require(isinstance(res, TorchDataFrame) and res.device == device,
                f"{cell}: the result is {type(res).__name__} on {getattr(res, 'device', None)}")
        got = res.as_pandas().sort_values("g").reset_index(drop=True)
        require(np.array_equal(got["g"].to_numpy(), exp["g"]) and np.array_equal(got["n"].to_numpy(), exp["n"]),
                f"{cell}: keys or counts differ from the oracle")
        require(np.allclose(got["s"].to_numpy(), exp["s"], rtol=DIST_RTOL, atol=0),
                f"{cell}: s differs from the float64 oracle")
        return f"keys and counts exact; s rtol={DIST_RTOL} vs a float64 numpy oracle"

    def dist_stats(engine) -> dict:
        d = engine.stats().get("dist", {})
        failed = d.get("tasks_failed", 0) + sum(w.get("tasks_failed", 0) for w in d.get("workers", {}).values())
        return {k: d.get(k, 0) for k in ("workflow_jobs", "workflow_tasks_dispatched",
                                         "workflow_partitions_delta_skipped", "workflow_tasks_re_dispatched",
                                         "redispatch_worker_lost", "redispatch_transient")} | {"tasks_failed": failed}

    def board_job(board: str) -> tuple:
        """The board's one workflow job: its id, the audit of the
        supervisor that ran it, the rows its reduces published (what
        landed on the card) and its failure records."""
        from fugue_tpu_torch.dist import TaskBoard

        jids = [n[: -len(".job.json")] for n in os.listdir(os.path.join(board, "jobs")) if n.endswith(".job.json")]
        require(len(jids) == 1, f"dist_path: jobs on {board}: {jids}")
        tb = TaskBoard(board)
        manifest = tb.read_job(jids[0])
        landed = sum(int(tb.read_done(t)["rows_out"]) for t in manifest["reduce_tids"])
        sup = engine._wf_dist_supervisor
        require(os.path.abspath(sup.board.root) == os.path.abspath(board), f"dist_path: supervisor of {board}")
        audit = sup.audit_job(jids[0])
        return jids[0], audit, landed, len(os.listdir(tb.fail_dir))

    def run_cell(cell: str, dag) -> dict:
        for name in bg.LAUNCHES:
            bg.LAUNCHES[name] = 0
        sup = getattr(engine, "_wf_dist_supervisor", None)
        before = dist_stats(engine)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sync()
        tracer.clear()
        tracer.enable()
        try:
            t0 = time.perf_counter()
            res = dag.run(engine).yields["r"].result
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            tracer.disable()
        recs = tracer.records()
        tracer.clear()
        launches = dict(bg.LAUNCHES)
        require(launches["bin_sum"] == (1 if on_card else 0), f"{cell}: B1 launched {launches['bin_sum']} times")
        frag_ms = sum(r["dur"] for r in recs if r["name"] == "dist.workflow_fragment") / 1e6
        seg_ms = sum(r["dur"] for r in recs if r["name"] == "plan.segment") / 1e6
        after = dist_stats(engine)
        if getattr(engine, "_wf_dist_supervisor", None) is not sup:  # a new board's supervisor
            before = {}
        return {"res": res, "launches": launches, "wall_ms": wall_ms,
                "split_ms": {"fragment": frag_ms, "card_segment": seg_ms, "other": wall_ms - frag_ms - seg_ms},
                "fragment_spans": sum(r["name"] == "dist.workflow_fragment" for r in recs),
                "dist": {k: after[k] - before.get(k, 0) for k in after},
                "peak_device_bytes": torch.cuda.max_memory_allocated() if on_card else None}

    engine = None
    try:
        # the six workers start first: their imports overlap the data's making
        for board in boards.values():
            os.makedirs(board)
            for i in range(DIST_WORKERS):
                extra = {}
                if board == boards["kill"]:
                    extra = {"fugue.tpu.events.enabled": True, "fugue.tpu.events.dir": events_dir,
                             "fugue.tpu.fault.plan": DIST_SURVIVOR_PLAN if i else DIST_VICTIM_PLAN}
                launch(board, f"w{i}", extra)
        t0 = time.perf_counter()
        data = dist_frames(np, pa, pq, str(tmp / "main"), seed + 19, rows, files, dim=True)
        exp = dist_oracle(np, data, data["w"])
        kill_data = dist_frames(np, pa, pq, str(tmp / "kill"), seed + 20, kill_rows, kill_files, dim=False)
        kill_exp = dist_oracle(np, kill_data, data["w"])
        del data, kill_data
        setup_s = time.perf_counter() - t0
        fact, dim = str(tmp / "main" / "fact"), str(tmp / "main" / "dim")
        engine = TorchExecutionEngine(device, conf=dict(NO_CACHE, **STATIC_CHUNKS))
        t0 = time.perf_counter()
        workers_up(boards["main"])
        workers_up(boards["kill"])
        wait_s = time.perf_counter() - t0

        # dist-join-agg-10m: the cold run on a fresh board, then its twin
        dag = build(FugueWorkflow(run_conf(boards["main"])), fact, dim)
        explain = dag.explain(engine=engine)
        dist_part = explain[explain.index("== distributed workflows"):]
        require("1 fragment(s)" in dist_part and "join how=inner on=['k'] buckets=8 covers 3 task(s)" in dist_part
                and "map[left]: %d file(s) | filter[(v > 0.25)]" % files in dist_part
                and "-> aggregate[s,n]" in explain and "not distributed t3 LoweredSegment" in dist_part,
                f"dist-join-agg-10m: the explain {dist_part!r}")
        cold = run_cell("dist-join-agg-10m", dag)
        checks = check(cold.pop("res"), exp, "dist-join-agg-10m")
        jid, audit, landed, fails = board_job(boards["main"])
        require(cold["dist"]["workflow_jobs"] == 1 and cold["dist"]["tasks_failed"] == 0 and fails == 0,
                f"dist-join-agg-10m: dist stats {cold['dist']}, {fails} failure records")
        require(audit["rows_lost"] == 0 and audit["rows_double_counted"] == 0, f"dist-join-agg-10m: audit {audit}")
        require(landed == len(exp["rows_g"]), f"dist-join-agg-10m: {landed} rows landed")
        require(cold["fragment_spans"] == 1, "dist-join-agg-10m: no dist.workflow_fragment span")
        twin = run_cell("dist-join-agg-10m twin", build(FugueWorkflow(), fact, dim))
        check(twin.pop("res"), exp, "dist-join-agg-10m twin")
        require(twin["fragment_spans"] == 0 and twin["dist"]["workflow_jobs"] == 0,
                "dist-join-agg-10m twin: the twin went to the board")
        line = {"phase": "dist_path", "cell": "dist-join-agg-10m", "rows": rows, "files": files,
                "workers": DIST_WORKERS, "buckets": DIST_BUCKETS, "rows_landed": landed,
                "tasks_dispatched": cold["dist"]["workflow_tasks_dispatched"], **cold, "job": jid, "audit": audit,
                "checks": checks, "twin_ms": twin["wall_ms"], "twin_split_ms": twin["split_ms"],
                "twin_launches": twin["launches"], "setup_s": setup_s, "workers_up_s": wait_s,
                "explain_fragment": [ln.strip() for ln in dist_part.splitlines()[1:4]],
                "phase_s_so_far": time.perf_counter() - start}
        emit(line, engine)
        out["cells"]["dist-join-agg-10m"] = line
        del dag  # its last run holds the frame that landed on the card

        # dist-warm-10m: every done record reused
        warm = run_cell("dist-warm-10m", build(FugueWorkflow(run_conf(boards["main"])), fact, dim))
        checks = check(warm.pop("res"), exp, "dist-warm-10m")
        n_tasks = line["tasks_dispatched"]
        require(warm["dist"]["workflow_tasks_dispatched"] == 0
                and warm["dist"]["workflow_partitions_delta_skipped"] == n_tasks,
                f"dist-warm-10m: dist stats {warm['dist']} of {n_tasks} tasks")
        line = {"phase": "dist_path", "cell": "dist-warm-10m", "rows": rows,
                "tasks_dispatched": warm["dist"]["workflow_tasks_dispatched"],
                "tasks_delta_skipped": warm["dist"]["workflow_partitions_delta_skipped"], **warm, "checks": checks,
                "phase_s_so_far": time.perf_counter() - start}
        emit(line, engine)
        out["cells"]["dist-warm-10m"] = line

        # the workers, alive: none holds the card
        pids = {f"{os.path.basename(b)}/{w}": p.pid for (b, w), p in procs.items()}
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout if on_card else ""
        smi_pids = {int(r.split(",")[0]) for r in smi.splitlines() if r.split(",")[0].strip().isdigit()}
        states = {w: _worker_state(pid) for w, pid in pids.items()}
        holding = [w for w, pid in pids.items() if states[w]["card"] or states[w]["torch"] or pid in smi_pids]
        require(not holding, f"dist_path: workers holding the card or torch {states}, compute apps {smi!r}")

        # dist-kill-2m: w0 SIGKILLed while it holds its first lease
        kill_board = boards["kill"]
        kill_proc = procs[(kill_board, "w0")]

        def killer() -> None:
            lease_dir = os.path.join(kill_board, "leases")
            deadline = time.monotonic() + DIST_TIMEOUT_S
            while time.monotonic() < deadline and kill_proc.poll() is None:
                for n in os.listdir(lease_dir):
                    try:
                        with open(os.path.join(lease_dir, n)) as f:
                            holder = json.load(f)
                    except (OSError, ValueError):
                        continue
                    if holder.get("owner") == "w0":
                        victim.update(pid=kill_proc.pid, lease=n, at_s=time.perf_counter() - start)
                        kill_proc.send_signal(signal.SIGKILL)
                        return
                time.sleep(0.005)

        thread = threading.Thread(target=killer, daemon=True)
        thread.start()
        kill = run_cell("dist-kill-2m", build(FugueWorkflow(run_conf(kill_board)), str(tmp / "kill" / "fact"), dim))
        thread.join(timeout=5)
        checks = check(kill.pop("res"), kill_exp, "dist-kill-2m")
        require(victim["pid"] is not None and kill_proc.wait(timeout=30) == -signal.SIGKILL,
                f"dist-kill-2m: w0 never killed ({victim})")
        jid, audit, landed, fails = board_job(kill_board)
        require(kill["dist"]["redispatch_worker_lost"] >= 1, f"dist-kill-2m: dist stats {kill['dist']}")
        require(audit["rows_lost"] == 0 and audit["rows_double_counted"] == 0, f"dist-kill-2m: audit {audit}")
        events = read_events(events_dir)
        kinds = sorted({e.get("type") for e in events})
        stolen = [e for e in events if e.get("type") in ("lease.steal", "task.redispatch")]
        require(stolen, f"dist-kill-2m: no steal or re-dispatch in the event log ({kinds})")
        states.update({w: _worker_state(pids[w]) for w in ("board_kill/w1", "board_kill/w2")})
        require(not any(states[w]["card"] or states[w]["torch"] for w in ("board_kill/w1", "board_kill/w2")),
                f"dist-kill-2m: workers holding the card or torch {states}")
        line = {"phase": "dist_path", "cell": "dist-kill-2m", "rows": kill_rows, "files": kill_files,
                "rows_landed": landed, "tasks_dispatched": kill["dist"]["workflow_tasks_dispatched"], **kill,
                "victim": victim, "job": jid, "audit": audit, "failure_records": fails,
                "event_types": kinds, "steal_events": len(stolen), "checks": checks,
                "phase_s_so_far": time.perf_counter() - start}
        emit(line, engine)
        out["cells"]["dist-kill-2m"] = line
    finally:
        for board in boards.values():
            with open(os.path.join(board, "_stop"), "w") as f:
                f.write("stop")
        killed = []
        for (board, wid), p in procs.items():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                killed.append(f"{os.path.basename(board)}/{wid}")
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    require(not killed, f"dist_path: workers killed at the end {killed}")
    codes = {f"{os.path.basename(b)}/{w}": p.returncode for (b, w), p in procs.items()}
    require(all(c == 0 for w, c in codes.items() if w != "board_kill/w0"), f"dist_path: worker exits {codes}")
    left = sorted(set(_child_pids()) & {p.pid for p in procs.values()})
    require(not left, f"dist_path: workers left running {left}")

    # B1 alone at the local segment's shape (CUDA events time it: on the card only)
    out["b1"] = {}
    if on_card:
        gg = torch.as_tensor(exp["rows_g"], device=device)
        zz = torch.as_tensor(exp["rows_z"], device=device)
        valid = torch.ones(gg.shape[0], dtype=torch.bool, device=device)
        b1 = b1_at_shape(torch, bg, gg, zz, valid, 0, DIST_GROUPS - 1, plain_reps=3)
        out["b1"]["dist-join-agg-10m"] = {**b1, "launches": out["cells"]["dist-join-agg-10m"]["launches"]["bin_sum"]}
        del gg, zz, valid
    emit({"phase": "dist_path", "cell": "b1-at-shape", "shapes": out["b1"]})

    del engine, exp, kill_exp
    gc.collect()
    sync()
    mem_after = torch.cuda.memory_allocated() if on_card else 0
    require(mem_after == mem_before, f"dist_path: {mem_after - mem_before} device bytes held after the phase")
    out["processes"] = {"workers": pids, "exit_codes": codes, "worker_states": states, "nvidia_smi_apps": smi,
                        "left_running": left, "killed_at_end": killed,
                        "memory": {"before_phase": mem_before, "after_phase": mem_after}}
    emit({"phase": "dist_path", "cell": "processes", **out["processes"]})
    if on_card:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - start
    emit({"phase": "dist_path", "cell": "end", "seconds": out["seconds"]})
    return out


def urllib_get(rpc, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://{rpc.host}:{rpc.port}{path}", timeout=30) as r:
        return r.read().decode()


def _release(torch) -> None:
    """Between phases: collect what the phase before left in reference
    cycles (a ``FugueSQLWorkflow`` and its frames form one, as in the JAX
    package), then hand the cached blocks back, so that no phase's peak
    counts an earlier phase's frames."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--orders", type=int, default=SF10_ORDERS)
    ap.add_argument("--expand-orders", type=int, default=EXPAND_ORDERS)
    ap.add_argument("--stream-rows", type=int, default=NS_STREAM_ROWS)
    ap.add_argument("--setop-stream-rows", type=int, default=SETOP_STREAM_ROWS)
    ap.add_argument("--sql-rows", type=int, default=SQL_PIPELINE_ROWS)
    ap.add_argument("--cogroup-rows", type=int, default=COGROUP_ROWS)
    ap.add_argument("--cogroup-stream-rows", type=int, default=COGROUP_STREAM_ROWS)
    ap.add_argument("--plan-stream-rows", type=int, default=None)
    args = ap.parse_args()
    start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    try:
        import numpy as np
        import pandas as pd
        import pyarrow as pa

        from fugue_tpu_torch import api
        from fugue_tpu_torch.column import col
        from fugue_tpu_torch.column import functions as ff
        from fugue_tpu_torch.ops import bin_groupby as bg
        from fugue_tpu_torch.ops._build import build_all, kernel_resources
        from fugue_tpu_torch.torch import TorchExecutionEngine, frame_from_numpy
        from fugue_tpu_torch.torch import group_ops as go
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 3

    dev = torch.device("cuda", 0)
    phase_device(torch, build_all, kernel_resources)
    kern = phase_kernels(torch, np, bg, args.seed, dev)
    engine = TorchExecutionEngine()
    main_path = phase_main_path(torch, np, pd, bg, api, ff, col, engine, args.seed, args.rows)
    times = phase_times(torch, api, bg, engine, main_path)
    phase_profile(torch, api, engine, main_path)
    del main_path["frames"]
    _release(torch)
    sorted_path = phase_sorted_path(torch, np, pd, pa, bg, api, ff, col, engine, args.seed, args.orders)
    handover = sorted_path.pop("handover")
    select_path = phase_select_path(torch, np, bg, api, ff, col, engine, handover["frame"], handover["oracles"])
    setop_path = phase_setop_path(torch, np, pd, pa, bg, api, col, engine, handover["frame"],
                                  handover["setop_oracles"], args.seed, stream_rows=args.setop_stream_rows)
    sql_path = phase_sql_path(torch, np, pd, bg, api, engine, handover["frame"], handover["oracles"],
                              select_path["cells"], pipeline_rows=args.sql_rows)
    window_path = phase_window_path(torch, np, pd, bg, api, engine, handover["frame"], handover["window_arrays"])
    del handover
    _release(torch)
    cogroup_path = phase_cogroup_path(torch, np, pd, bg, api, ff, col, frame_from_numpy, engine, args.seed,
                                      rows=args.cogroup_rows, stream_rows=args.cogroup_stream_rows,
                                      ctx_rows=args.sql_rows)
    _release(torch)
    transform_path = phase_transform_path(torch, np, bg, api, go, frame_from_numpy, engine, args.seed,
                                          args.rows)
    _release(torch)
    join_path = phase_join_path(torch, np, pa, bg, api, ff, col, frame_from_numpy, engine, args.seed,
                                args.rows, args.orders, args.expand_orders)
    _release(torch)
    host_path = phase_host_path(torch, np, pd, pa, bg, api, frame_from_numpy, engine, args.seed, args.rows,
                                args.orders, transform_path["cells"]["demean-dense"]["transform_ms"])
    _SHARED_TABLES.clear()
    del engine
    _release(torch)
    stream_path = phase_stream_path(torch, np, pd, bg, api, ff, col, None, args.seed,
                                    rows=args.stream_rows, f32_rows=args.rows)
    _release(torch)
    plan_path = phase_plan_path(torch, np, pd, pa, bg, api, ff, col, TorchExecutionEngine(), args.seed,
                                rows=args.rows, stream_rows=args.plan_stream_rows or args.rows)
    _release(torch)
    plan_frame_, plan_exp = plan_path.pop("handover"), plan_path.pop("handover_oracle")
    analysis_path = phase_analysis_path(torch, np, pd, pa, bg, api, ff, col, TorchExecutionEngine(),
                                        plan_frame_, stream_rows=args.plan_stream_rows or args.rows)
    _release(torch)
    obs_path = phase_obs_path(torch, np, pd, pa, bg, ff, col, TorchExecutionEngine(), plan_frame_, plan_exp)
    _release(torch)
    services_path = phase_services_path(
        torch, np, pd, bg, api, ff, col, frame_from_numpy, dev, plan_frame_, plan_exp, args.seed,
        tdf=obs_path.pop("handover"), lowered_ms=plan_path["cells"]["lowered-uniform-1k"]["ms"],
        callback_ms=analysis_path["cells"]["callback-1k"]["ms"])
    _release(torch)
    cache_path = phase_cache_path(torch, np, pd, pa, bg, ff, col, dev, plan_frame_, args.seed, exp=plan_exp,
                                  keep_source=True)
    del plan_frame_, plan_exp
    _release(torch)
    serve_path = phase_serve_path(torch, np, pd, pa, bg, ff, col, dev, cache_path.pop("handover"), args.seed)
    _release(torch)
    warehouse_path = phase_warehouse_path(torch, np, pd, pa, bg, go, dev, rows=args.sql_rows,
                                          twin=sql_path["cells"]["sql-pipeline-4m"])
    _release(torch)
    dist_path = phase_dist_path(torch, np, pd, pa, bg, ff, col, dev, args.seed)

    sources = {"bin_sum": "fugue_tpu_torch/csrc/bin_groupby.cu", "bin_sum_count": "fugue_tpu_torch/csrc/bin_groupby.cu"}
    kernels = []
    for i, t in enumerate(times["frames"]["uniform"]["kernels"]):
        name = t["name"]
        by_path = {"dense": main_path["out"]["launches"][name],
                   "sorted_path": {a: r["launches"][name] for a, r in sorted_path["aggregates"].items()},
                   "select_path": {c: r["launches"][name] for c, r in select_path["cells"].items()},
                   "setop_path": {c: r["launches"][name] for c, r in setop_path["cells"].items()
                                  if "launches" in r},
                   "sql_path": {c: r["launches"][name] for c, r in sql_path["cells"].items()},
                   "window_path": {c: r["launches"][name] for c, r in window_path["cells"].items()},
                   "cogroup_path": {c: r["launches"][name] for c, r in cogroup_path["cells"].items()},
                   "transform_path": {c: r["launches"][name] for c, r in transform_path["cells"].items()},
                   "join_path": {c: r["launches"][name] for c, r in join_path["cells"].items()},
                   "host_path": {c: r["launches"][name] for c, r in host_path["cells"].items()},
                   "stream_path": {c: r["launches"][name] for c, r in stream_path["cells"].items()},
                   "plan_path": {c: r["launches"][name] for c, r in plan_path["cells"].items()},
                   "analysis_path": {c: r["launches"][name] + r.get("stream_launches", {}).get(name, 0)
                                     for c, r in analysis_path["cells"].items()},
                   "obs_path": {c: r["launches"][name] + r.get("stream_launches", {}).get(name, 0)
                                for c, r in obs_path["cells"].items()},
                   "services_path": {c: r["launches"][name] for c, r in services_path["cells"].items()},
                   "cache_path": {c: (r["launches"][name] if "launches" in r
                                      else sum(x["launches"][name] for x in r["runs"]))
                                  for c, r in cache_path["cells"].items()},
                   "serve_path": {c: r["launches"][name] for c, r in serve_path["cells"].items()
                                  if "launches" in r},
                   "warehouse_path": {c: r["launches"][name] for c, r in warehouse_path["cells"].items()},
                   "dist_path": {c: r["launches"][name] for c, r in dist_path["cells"].items()}}
        by_frame = {
            dist: {k: f["kernels"][i][k] for k in ("route", "ms", "bound_ms", "library_ms")}
            for dist, f in times["frames"].items()
        }
        if name == "bin_sum":
            by_frame["shipmode"] = {k: sorted_path["bin_sum"][k]
                                    for k in ("route", "ms", "plain_ms", "bound_ms", "library_ms", "shape")}
            by_frame["stream-chunk"] = stream_path["cells"]["f32-aggregate"]["bin_sum"]
            by_frame.update(analysis_path["b1"])  # plan_path's and analysis_path's shapes
            by_frame.update(cache_path["b1"])  # the delta recompute's new rows
            by_frame.update(warehouse_path["b1"])  # CONNECT torch's SUM of z
            by_frame.update(dist_path["b1"])  # the SUM of z after the distributed join
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": sources[name],
            "replaces": REPLACES[name],
            "launches": by_path["dense"] + sum(by_path["sorted_path"].values())
            + sum(by_path["select_path"].values()) + sum(by_path["setop_path"].values())
            + sum(by_path["sql_path"].values()) + sum(by_path["window_path"].values())
            + sum(by_path["cogroup_path"].values())
            + sum(by_path["transform_path"].values()) + sum(by_path["join_path"].values())
            + sum(by_path["host_path"].values()) + sum(by_path["stream_path"].values())
            + sum(by_path["plan_path"].values()) + sum(by_path["analysis_path"].values())
            + sum(by_path["obs_path"].values()) + sum(by_path["services_path"].values())
            + sum(by_path["cache_path"].values()) + sum(by_path["serve_path"].values())
            + sum(by_path["warehouse_path"].values()) + sum(by_path["dist_path"].values()),
            "launches_by_path": by_path,
            "on_main_path": name == "bin_sum",
            "max_abs_err": kern["max_abs_err"][name],
            "matched": True,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "by_frame": by_frame,
        })
    emit({"phase": "end", "seconds": time.perf_counter() - start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
