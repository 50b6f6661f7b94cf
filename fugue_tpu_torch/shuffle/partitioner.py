"""The streaming hash partitioner, copied from
``fugue_tpu/shuffle/partitioner.py``: rows routed by key hash into P
bucket files, in one pass, with bounded host memory and no device bytes.

Key hashing (:52-135): each key column is normalized to a canonical dtype
shared by BOTH sides of an exchange (so ``int64 5`` and ``float64 5.0``
co-bucket exactly as they match by value in a join), hashed with
``pd.util.hash_pandas_object`` (deterministic across processes) and taken
mod the bucket count. The ids equal the JAX package's bit for bit: the
dist tier concatenates its reduce outputs in bucket order, and a spilled
repartition's chunks come in the same bucket order.

The spill (:136-627): any input, a bounded frame or a one-pass stream, is
consumed chunk by chunk; each chunk is split with arrow ``take`` (the
schema kept bit for bit) onto per-bucket arrow IPC stream writers. Every
bucket writes to ``<name>.tmp`` and is renamed into place when complete,
so a bucket file either does not exist or is whole. A missing, truncated
or corrupt bucket is found at read time (a full IPC decode and a row
count against the partitioner's own ledger) and recovered by
partitioning only that bucket again from the source, where the source
can be read again (anything but a one-pass stream). The ``shuffle.spill``
fault site fires between a bucket's write and its publish.
"""

import os
import shutil
import uuid as _uuid
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa

from ..exceptions import FugueTPUError
from ..resilience import SITE_SHUFFLE_SPILL, FaultInjector
from ..workflow._checkpoint import _atomic_publish, _best_effort_remove

__all__ = [
    "canonical_key_kinds",
    "bucket_ids",
    "SpilledSide",
    "spill_partition",
    "new_spill_dir",
    "remove_spill_dir",
    "spill_dir_bytes",
]


def _kind_of(tp: pa.DataType) -> Optional[str]:
    if pa.types.is_dictionary(tp):
        tp = tp.value_type
    if pa.types.is_floating(tp):
        return "f"
    if pa.types.is_integer(tp) or pa.types.is_boolean(tp):
        return "i"
    if pa.types.is_string(tp) or pa.types.is_large_string(tp):
        return "s"
    if pa.types.is_timestamp(tp) or pa.types.is_date(tp):
        return "t"
    return None


def canonical_key_kinds(
    schema1: Any, schema2: Any, keys: List[str]
) -> Optional[List[str]]:
    """Per key column, the canonical hash dtype BOTH sides normalize to
    before hashing — equal-by-value keys must co-bucket even across
    dtypes (int64 ⋈ float64 matches by value in the join kernels). None
    = a key type the partitioner can't hash (decimal, binary, nested):
    the caller refuses and the legacy ladder handles the join."""
    kinds: List[str] = []
    for k in keys:
        k1, k2 = _kind_of(schema1[k].type), _kind_of(schema2[k].type)
        if k1 is None or k2 is None:
            return None
        if k1 == k2:
            kinds.append("f" if k1 == "f" else k1)
        elif {k1, k2} <= {"i", "f"}:
            kinds.append("f")  # value-equality across int/float via float64
        else:
            return None  # string vs numeric etc. — no value equality
    return kinds


def _normalize_key(col: pa.ChunkedArray, kind: str) -> pd.Series:
    """One key column → canonical pandas Series with NULLs filled to a
    fixed value (NULL keys never match, they only need a deterministic
    bucket)."""
    s = col.to_pandas()
    if kind == "f":
        s = pd.to_numeric(s, errors="coerce").astype(np.float64)
        # + 0.0 canonicalizes -0.0 → +0.0 (IEEE): the hash sees float bit
        # patterns, but the join kernels match 0.0 == -0.0 by value, so
        # both must land in the same bucket
        return s.fillna(0.0) + 0.0
    if kind == "i":
        # nullable ints arrive as Int64/object; uint64 wraps into int64
        # deterministically on both sides (bucketing needs consistency,
        # not order)
        s = s.fillna(0)
        return s.astype(np.int64, errors="ignore").astype(np.int64)
    if kind == "t":
        s = pd.to_datetime(s)
        try:
            # tz-aware → the UTC instant, so equal instants co-bucket even
            # when the two sides carry different timezones; tz-naive
            # raises TypeError and keeps its wall-clock int64 view
            s = s.dt.tz_convert("UTC").dt.tz_localize(None)
        except (AttributeError, TypeError):
            pass
        v = s.astype("int64", errors="ignore")
        if v.dtype != np.int64:  # NaT-bearing — view through float64
            return pd.to_numeric(v, errors="coerce").fillna(0.0).astype(np.float64)
        return v
    # strings
    return s.astype("object").where(~s.isna(), "").astype(str)


def bucket_ids(
    tbl: pa.Table, keys: List[str], kinds: List[str], n_buckets: int
) -> np.ndarray:
    """Per-row bucket id for one chunk (uint64 hash of the normalized key
    frame, mod P). Deterministic across processes and chunk boundaries."""
    norm = pd.DataFrame(
        {k: _normalize_key(tbl.column(k), kind) for k, kind in zip(keys, kinds)}
    )
    h = pd.util.hash_pandas_object(norm, index=False).to_numpy()
    return (h % np.uint64(n_buckets)).astype(np.int64)


# ---------------------------------------------------------------------------
# spill directories
# ---------------------------------------------------------------------------

def new_spill_dir(root: str) -> str:
    d = os.path.join(root, f"shuffle-{os.getpid()}-{_uuid.uuid4().hex[:12]}")
    os.makedirs(d, exist_ok=True)
    return d


def remove_spill_dir(path: str) -> None:
    try:
        shutil.rmtree(path)
    except OSError:
        pass


def spill_dir_bytes(paths: Any) -> int:
    """Live on-disk bytes across a set of spill dirs (the sampler probe).

    ``paths`` may be the engine's live spill-dir set, mutated by
    join/repartition threads while the sampler iterates — snapshot it,
    retrying once if a concurrent add/discard races the copy.

    ``*.tmp`` files are EXCLUDED from the walk: a bucket mid-publish
    briefly has both its tmp and (on republish after recovery) its
    published file visible, and with write-behind spill the tmp files
    stay open for the whole partition pass — counting them double-counts
    the bucket and made the probe report phantom bytes during the
    temp-write+rename window."""
    dirs: Tuple[str, ...] = ()
    for _ in range(2):
        try:
            dirs = tuple(paths)
            break
        except RuntimeError:
            continue
    total = 0
    for d in dirs:
        try:
            for name in os.listdir(d):
                if name.endswith(".tmp"):
                    continue
                try:
                    total += os.path.getsize(os.path.join(d, name))
                except OSError:
                    pass
        except OSError:
            pass
    return total


# ---------------------------------------------------------------------------
# the spilled representation of one join side
# ---------------------------------------------------------------------------

class SpilledSide:
    """P published bucket files plus the ledger needed to read them back
    safely (expected per-bucket row counts) and to recover a damaged one
    (the replay factory, when the source can be re-iterated).

    With the pipelined exchange, some buckets live in the
    **memory-resident tier** instead of on disk: ``mem_tables`` maps
    bucket id → accumulated arrow slices whose bytes fit the exchange's
    ``MemBucketLedger``. ``read_bucket`` serves them without any disk or
    IPC round-trip, combining the slices into ONE contiguous table the
    first time and caching that decoded form (keyed by bucket id,
    budget-accounted — see :meth:`_retain_combined`) so later reads of
    the same bucket never re-concat or re-decode the per-chunk slices.
    Torn/absent-file detection and recovery are unchanged for everything
    else (a demoted bucket is indistinguishable from a serial one)."""

    def __init__(
        self,
        spill_dir: str,
        side: str,
        pa_schema: pa.Schema,
        keys: List[str],
        kinds: List[str],
        n_buckets: int,
        bucket_rows: List[int],
        bytes_spilled: int,
        replay: Optional[Callable[[], Iterator[pa.Table]]],
        mem_tables: Optional[Dict[int, List[pa.Table]]] = None,
        ledger: Any = None,
        mem_bytes: int = 0,
        mem_bucket_bytes: Optional[Dict[int, int]] = None,
    ):
        self.spill_dir = spill_dir
        self.side = side
        self.pa_schema = pa_schema
        self.keys = keys
        self.kinds = kinds
        self.n_buckets = n_buckets
        self.bucket_rows = bucket_rows
        self.bytes_spilled = bytes_spilled
        self.replay = replay
        self.mem_tables = mem_tables or {}
        self.mem_bytes = mem_bytes
        self.mem_bucket_bytes = mem_bucket_bytes or {}
        self._ledger = ledger
        self._combined: set = set()

    def path(self, i: int) -> str:
        return os.path.join(self.spill_dir, f"{self.side}_{i:05d}.arrow")

    def release_mem(self) -> None:
        """Return this side's memory-resident bytes to the exchange
        ledger (the consuming stream's ``finally``). Idempotent."""
        if self._ledger is not None and self.mem_bytes > 0:
            self._ledger.release(self.mem_bytes)
            self.mem_bytes = 0
        self.mem_tables = {}
        self.mem_bucket_bytes = {}
        self._combined = set()

    @property
    def rows(self) -> int:
        return sum(self.bucket_rows)

    @property
    def max_bucket_rows(self) -> int:
        return max(self.bucket_rows) if self.bucket_rows else 0

    def read_bucket(self, i: int, stats: Any = None) -> Optional[pa.Table]:
        """Bucket ``i`` fully decoded (torn files can't parse), validated
        against the ledger row count; a missing/corrupt bucket is deleted
        and repartitioned from the source — only that bucket. A
        memory-resident bucket is served straight from its accumulated
        arrow slices, no disk and no IPC decode."""
        expected = self.bucket_rows[i]
        if expected == 0:
            return None
        parts = self.mem_tables.get(i)
        if parts is not None:
            if i in self._combined:
                # decoded-form cache hit: this bucket was already combined
                # into one contiguous table by an earlier read — serve it
                # straight, no re-concat and no per-slice re-decode for
                # the consumer's ingest
                if stats is not None:
                    stats.inc("mem_bucket_hits")
                    stats.inc("mem_bucket_ingest_hits")
                return parts[0]
            tbl = parts[0] if len(parts) == 1 else pa.concat_tables(parts)
            if tbl.num_rows == expected:
                if stats is not None:
                    stats.inc("mem_bucket_hits")
                return self._retain_combined(i, tbl)
            # a mem bucket that disagrees with its own ledger can only be
            # a bug — but recovery is cheap and already exists: fall
            # through to the disk/replay path below
            self.mem_tables.pop(i, None)
        path = self.path(i)
        tbl: Optional[pa.Table] = None
        if os.path.exists(path):
            try:
                with pa.ipc.open_stream(path) as reader:
                    tbl = reader.read_all()
                if tbl.num_rows != expected:
                    tbl = None
            except Exception:
                tbl = None
        if tbl is None:
            _best_effort_remove(path)
            tbl = self._recover_bucket(i)
            if stats is not None:
                stats.inc("bucket_recoveries")
        return tbl

    def _retain_combined(self, i: int, tbl: pa.Table) -> pa.Table:
        """Replace bucket ``i``'s accumulated per-chunk slices with ONE
        contiguous combined table and cache it for later reads. Budget-
        accounted: the combined copy's byte delta vs the slices is
        admitted to (or released from) the exchange ledger, so the cache
        can never exceed the mem-tier budget — a refused admit serves the
        chunked concat view uncached (correctness never depends on the
        cache)."""
        combined = tbl.combine_chunks()
        new_nb = int(combined.nbytes)
        old_nb = int(self.mem_bucket_bytes.get(i, new_nb))
        delta = new_nb - old_nb
        if self._ledger is not None:
            if delta > 0 and not self._ledger.admit(delta):
                return tbl
            if delta < 0:
                self._ledger.release(-delta)
        self.mem_tables[i] = [combined]
        self.mem_bucket_bytes[i] = new_nb
        self.mem_bytes += delta
        self._combined.add(i)
        return combined

    def _recover_bucket(self, i: int) -> pa.Table:
        if self.replay is None:
            raise FugueTPUError(
                f"shuffle spill bucket {self.side}_{i} is torn or missing and "
                "the source is a one-pass stream (not replayable); re-run the "
                "join or materialize the input first"
            )
        parts: List[pa.Table] = []
        for tbl in self.replay():
            if tbl.schema != self.pa_schema:
                tbl = tbl.cast(self.pa_schema)
            ids = bucket_ids(tbl, self.keys, self.kinds, self.n_buckets)
            (sel,) = np.nonzero(ids == i)
            if len(sel) > 0:
                parts.append(tbl.take(pa.array(sel, type=pa.int64())))
        got = (
            pa.concat_tables(parts)
            if parts
            else self.pa_schema.empty_table()
        )
        if got.num_rows != self.bucket_rows[i]:
            raise FugueTPUError(
                f"shuffle bucket {self.side}_{i} recovery produced "
                f"{got.num_rows} rows, ledger expects {self.bucket_rows[i]} "
                "(source changed between spill and recovery)"
            )
        # re-publish so later readers (and retries) see a complete file
        tmp = self.path(i) + ".tmp"
        with pa.OSFile(tmp, "wb") as sink:
            with pa.ipc.new_stream(sink, self.pa_schema) as writer:
                writer.write_table(got)
        _atomic_publish(tmp, self.path(i))
        return got


# ---------------------------------------------------------------------------
# the one-pass spill
# ---------------------------------------------------------------------------

def _chunk_bucket_parts(
    tbl: pa.Table, keys: List[str], kinds: List[str], n_buckets: int
) -> Iterator[Tuple[int, pa.Table]]:
    """One chunk split into its non-empty (bucket_id, slice) parts —
    the ONE split implementation shared by the serial and pipelined
    spill paths (stable argsort, schema preserved bit-for-bit)."""
    ids = bucket_ids(tbl, keys, kinds, n_buckets)
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    bounds = np.searchsorted(sorted_ids, np.arange(n_buckets + 1), side="left")
    for i in range(n_buckets):
        lo, hi = bounds[i], bounds[i + 1]
        if lo == hi:
            continue
        yield i, tbl.take(pa.array(order[lo:hi], type=pa.int64()))


def spill_partition(
    chunks: Iterator[pa.Table],
    pa_schema: pa.Schema,
    keys: List[str],
    kinds: List[str],
    n_buckets: int,
    spill_dir: str,
    side: str,
    injector: Optional[FaultInjector] = None,
    stats: Any = None,
    replay: Optional[Callable[[], Iterator[pa.Table]]] = None,
    pipeline: Any = None,
) -> SpilledSide:
    """Consume ``chunks`` once, routing rows into ``n_buckets`` spill
    files under ``spill_dir``. Buckets a fault rule tears stay
    unpublished — the reader repairs them lazily via ``read_bucket``.

    ``pipeline`` (a :class:`~fugue_tpu_torch.shuffle.pipeline.SpillPipeline`)
    switches to the overlapped form: batches go to a write-behind
    background writer and small buckets stay in the memory-resident
    tier. ``None`` is the serial path."""
    if pipeline is not None:
        return _spill_partition_pipelined(
            chunks,
            pa_schema,
            keys,
            kinds,
            n_buckets,
            spill_dir,
            side,
            injector,
            stats,
            replay,
            pipeline,
        )
    writers: Dict[int, Any] = {}
    sinks: Dict[int, Any] = {}
    bucket_rows = [0] * n_buckets
    n_chunks = 0

    def _writer(i: int) -> Any:
        w = writers.get(i)
        if w is None:
            sink = pa.OSFile(
                os.path.join(spill_dir, f"{side}_{i:05d}.arrow.tmp"), "wb"
            )
            sinks[i] = sink
            w = pa.ipc.new_stream(sink, pa_schema)
            writers[i] = w
        return w

    try:
        for tbl in chunks:
            if tbl.num_rows == 0:
                continue
            n_chunks += 1
            if tbl.schema != pa_schema:
                tbl = tbl.cast(pa_schema)
            for i, part in _chunk_bucket_parts(tbl, keys, kinds, n_buckets):
                _writer(i).write_table(part)
                bucket_rows[i] += part.num_rows
    finally:
        for w in writers.values():
            try:
                w.close()
            except Exception:
                pass
        for s in sinks.values():
            try:
                s.close()
            except Exception:
                pass

    bytes_spilled = 0
    for i in writers:
        tmp = os.path.join(spill_dir, f"{side}_{i:05d}.arrow.tmp")
        final = os.path.join(spill_dir, f"{side}_{i:05d}.arrow")
        try:
            if injector is not None:
                injector.fire(SITE_SHUFFLE_SPILL)
            _atomic_publish(tmp, final)
            bytes_spilled += os.path.getsize(final)
        except Exception:
            # an injected (or real) publish failure tears ONLY this
            # bucket; the reader recovers it from the replayable source
            _best_effort_remove(tmp)
            if stats is not None:
                stats.inc("spill_faults")
    if stats is not None:
        stats.inc("partitions")
        stats.inc("chunks", n_chunks)
        stats.inc("rows_spilled", sum(bucket_rows))
        stats.inc("bytes_spilled", bytes_spilled)
        stats.inc("buckets", len(writers))
    return SpilledSide(
        spill_dir,
        side,
        pa_schema,
        keys,
        kinds,
        n_buckets,
        bucket_rows,
        bytes_spilled,
        replay,
    )


def _spill_partition_pipelined(
    chunks: Iterator[pa.Table],
    pa_schema: pa.Schema,
    keys: List[str],
    kinds: List[str],
    n_buckets: int,
    spill_dir: str,
    side: str,
    injector: Optional[FaultInjector],
    stats: Any,
    replay: Optional[Callable[[], Iterator[pa.Table]]],
    pipeline: Any,
) -> SpilledSide:
    """The overlapped spill:
    decode/hash of chunk n+1 overlaps the disk write of chunk n through
    the bounded write-behind writer, and buckets whose accumulated arrow
    bytes fit the exchange's mem ledger never touch disk at all.

    Demotion is largest-first: when a batch can't be admitted, the
    biggest memory-resident bucket moves (in accumulation order, so the
    on-disk row order matches a serial spill of the same bucket) to the
    write-behind writer until the batch fits or the tier is empty. The
    ``shuffle.spill`` fault site fires per bucket either on the writer
    thread (disk buckets, between write-close and publish) or at mem
    retention — an injected fault DROPS the mem bucket, the tier's form
    of a torn publish, and ``read_bucket`` recovers it from the source.
    """
    ledger = pipeline.ledger
    writer: Any = None
    mem: Dict[int, List[pa.Table]] = {}
    mem_bytes: Dict[int, int] = {}
    disk_bound: set = set()
    bucket_rows = [0] * n_buckets
    n_chunks = 0

    def _writer() -> Any:
        nonlocal writer
        if writer is None:
            writer = pipeline.writer(spill_dir, side, pa_schema, injector)
        return writer

    def _demote_one() -> bool:
        if not mem_bytes:
            return False
        j = max(mem_bytes, key=lambda k: mem_bytes[k])
        for p in mem.pop(j):
            _writer().submit(j, p)
        ledger.release(mem_bytes.pop(j))
        disk_bound.add(j)
        ledger.note_demotion()
        if stats is not None:
            stats.inc("mem_demotions")
        return True

    try:
        for tbl in chunks:
            if tbl.num_rows == 0:
                continue
            n_chunks += 1
            if tbl.schema != pa_schema:
                tbl = tbl.cast(pa_schema)
            for i, part in _chunk_bucket_parts(tbl, keys, kinds, n_buckets):
                bucket_rows[i] += part.num_rows
                admitted = False
                nb = int(part.nbytes)
                if i not in disk_bound:
                    while True:
                        if ledger.admit(nb):
                            admitted = True
                            break
                        if not _demote_one():
                            break
                if admitted and i in disk_bound:
                    # the demotion loop evicted THIS bucket while making
                    # room — a bucket is mem- or disk-resident, never both
                    ledger.release(nb)
                    admitted = False
                if admitted:
                    mem.setdefault(i, []).append(part)
                    mem_bytes[i] = mem_bytes.get(i, 0) + nb
                else:
                    _writer().submit(i, part)
                    disk_bound.add(i)
    except BaseException:
        if writer is not None:
            writer.abort()
        ledger.release(sum(mem_bytes.values()))
        raise

    published: Dict[int, int] = {}
    batches = 0
    try:
        if writer is not None:
            published, wfaults, batches = writer.finalize()
            if stats is not None and wfaults:
                stats.inc("spill_faults", wfaults)
    except BaseException:
        ledger.release(sum(mem_bytes.values()))
        raise
    # mem-tier retention: the fault site fires per resident bucket, in
    # bucket order; a fault drops the bucket (release + lazy recovery)
    mem_total = 0
    for i in sorted(mem):
        try:
            if injector is not None:
                injector.fire(SITE_SHUFFLE_SPILL)
            mem_total += mem_bytes[i]
        except Exception:
            ledger.release(mem_bytes[i])
            del mem[i]
            del mem_bytes[i]
            if stats is not None:
                stats.inc("spill_faults")
    bytes_spilled = sum(published.values()) + mem_total
    if stats is not None:
        stats.inc("partitions")
        stats.inc("chunks", n_chunks)
        stats.inc("rows_spilled", sum(bucket_rows))
        stats.inc("bytes_spilled", bytes_spilled)
        stats.inc("buckets", sum(1 for r in bucket_rows if r > 0))
        stats.inc("mem_buckets", len(mem))
        stats.inc("mem_bucket_bytes", mem_total)
        stats.inc("writebehind_batches", batches)
    return SpilledSide(
        spill_dir,
        side,
        pa_schema,
        keys,
        kinds,
        n_buckets,
        bucket_rows,
        bytes_spilled,
        replay,
        mem_tables=mem,
        ledger=ledger,
        mem_bytes=mem_total,
        mem_bucket_bytes=mem_bytes,
    )
