"""Configuration keys of the port, copied from ``fugue_tpu/constants.py``
(:131-140, :41, :35, :471) and trimmed to the streaming keys, the host
map's pool, the distinct's guard, the workflow's keys and their global
defaults, the resilience, RPC and observability keys (:49-127), the
profiler's directory, and the result cache's and the tuner's keys
(:183-214, :438-462). The names are the JAX package's, so one
conf dict drives either engine."""

from ._utils.params import ParamDict

# rows per host→device chunk of a stream; the device working set is
# O(chunk_rows × columns), not O(stream)
FUGUE_TPU_CONF_STREAM_CHUNK_ROWS = "fugue.tpu.stream.chunk_rows"
# depth of the ingest pipeline's chunk queue (``torch/pipeline.py``): the
# decode and host→device copy of the next chunks overlap the device work
# on the current one; 0 runs the chunks serially, with no thread
FUGUE_TPU_CONF_STREAM_PREFETCH_DEPTH = "fugue.tpu.stream.prefetch_depth"
# "lo,hi" inclusive integer key range of a streaming dense aggregate;
# without it the range is probed from the first chunk, and a later key
# outside it raises (a one-pass stream cannot be read again)
FUGUE_TPU_CONF_STREAM_KEY_RANGE = "fugue.tpu.stream.key_range"
# processes of the host map's forked pool (``execution/parallel_map.py``);
# -1 (auto) sizes it by the engine's parallelism capped by the host's
# cores, 1 on one card; 0 and 1 map serially
FUGUE_TPU_CONF_MAP_PARALLELISM = "fugue.tpu.map.parallelism"
# frames below this row count always map serially (pool setup ~100 ms)
FUGUE_TPU_CONF_MAP_PARALLEL_MIN_ROWS = "fugue.tpu.map.parallel_min_rows"
# per-chunk wall-clock deadline (seconds) of the pool; 0/unset: unbounded
FUGUE_TPU_CONF_MAP_CHUNK_TIMEOUT = "fugue.tpu.map.chunk_timeout"
# the most groups a device ``distinct`` brings to the host (default 2**22,
# the JAX engine's); above it the host engine dedupes the frame
FUGUE_TPU_CONF_MAX_PARTIAL_ROWS = "fugue.tpu.max_partial_rows"

# the workflow's keys (``fugue_tpu/constants.py`` :18-26): tasks run at
# once (1: inline, in order), the checkpoint directory, auto-persist of
# frames with several consumers, and the dialect FugueSQL compiles from
FUGUE_CONF_WORKFLOW_CONCURRENCY = "fugue.workflow.concurrency"
FUGUE_CONF_WORKFLOW_CHECKPOINT_PATH = "fugue.workflow.checkpoint.path"
FUGUE_CONF_WORKFLOW_AUTO_PERSIST = "fugue.workflow.auto_persist"
FUGUE_CONF_WORKFLOW_AUTO_PERSIST_VALUE = "fugue.workflow.auto_persist_value"
FUGUE_CONF_SQL_DIALECT = "fugue.sql.compile.dialect"

# the conf when no engine is in context (``fugue_tpu/constants.py`` :471,
# trimmed to the keys above): what ``get_current_conf`` returns then
_FUGUE_GLOBAL_CONF = ParamDict(
    {
        FUGUE_CONF_WORKFLOW_CONCURRENCY: 1,
        FUGUE_CONF_WORKFLOW_AUTO_PERSIST: False,
        FUGUE_CONF_SQL_DIALECT: "spark",
    }
)

# the JAX package's workflow services that the port does not have
# (ROADMAP.md A.10): each key, set to turn its service on, makes a run
# raise. Their defaults are a plain run
A10_WORKFLOW_KEYS = {
    "fugue.tpu.dist.enabled": "the distributed pass",
    "fugue.tpu.dist.board": "the distributed pass",
}

# --- the result cache (``fugue_tpu_torch/cache``; ``fugue_tpu/constants.py``
# :183-214): task outputs memoized across runs, keyed on the fingerprints
# of the optimized plan. The master switch, default ON: with no
# ``cache.dir`` the cache is memory-only and scoped to one engine; false is
# the run with no cache at all
FUGUE_TPU_CONF_CACHE_ENABLED = "fugue.tpu.cache.enabled"
# the artifact store's directory (shared across processes; atomic
# publishes); unset or empty: no disk tier. The FUGUE_TPU_CACHE_DIR
# environment variable is read when the key is unset; an unwritable
# directory leaves the cache memory-only, with one warning
FUGUE_TPU_CONF_CACHE_DIR = "fugue.tpu.cache.dir"
# the byte budget of the memory tier's LRU over live result frames (on
# the card for a device frame); default 256 MiB
FUGUE_TPU_CONF_CACHE_MEM_BYTES = "fugue.tpu.cache.mem_bytes"
# the disk tier's size cap, LRU-evicted past it
FUGUE_TPU_CONF_CACHE_DISK_BYTES = "fugue.tpu.cache.disk_bytes"
# a frame larger than this is never written to the disk tier
FUGUE_TPU_CONF_CACHE_MAX_ARTIFACT_BYTES = "fugue.tpu.cache.max_artifact_bytes"
# a created table above this is refused (poisoned), not hashed
FUGUE_TPU_CONF_CACHE_FINGERPRINT_MAX_BYTES = "fugue.tpu.cache.fingerprint_max_bytes"
# mixed into every fingerprint: a new salt misses every old entry
FUGUE_TPU_CONF_CACHE_SALT = "fugue.tpu.cache.salt"
# the delta cache: a run over a grown LOAD source recomputes only the new
# partitions and merges them with the cached result or partial
# accumulator; default ON, false is the whole-task cache
FUGUE_TPU_CONF_CACHE_DELTA_ENABLED = "fugue.tpu.cache.delta.enabled"
# the disk tier's artifact-count cap (0: none), LRU-evicted past it
FUGUE_TPU_CONF_CACHE_DISK_MAX_ENTRIES = "fugue.tpu.cache.disk_max_entries"
# ``fugue.default.partitions`` changes what an unkeyed transformer sees,
# so it is part of every fingerprint
FUGUE_CONF_DEFAULT_PARTITIONS = "fugue.default.partitions"

# --- the adaptive tuner (``fugue_tpu_torch/tuning``; ``fugue_tpu/constants.py``
# :438-462): a stream's chunk size and prefetch depth learned from the
# engine's own telemetry, keyed by the optimized plan's fingerprint. The
# master switch, default ON; false resolves every knob from the static
# conf, as before the tuner. Scoped to a run like ``fugue.tpu.plan.*``
FUGUE_TPU_CONF_TUNING_ENABLED = "fugue.tpu.tuning.enabled"
FUGUE_TPU_CONF_TUNING_PREFIX = "fugue.tpu.tuning."
# where the learned settings persist (atomic temp-write and rename; a
# corrupt or unwritable file degrades to the static conf with one
# warning). The FUGUE_TPU_TUNING_PATH environment variable is read next;
# the default is ``fugue_tpu_torch/build/_tuned.json``
FUGUE_TPU_CONF_TUNING_PATH = "fugue.tpu.tuning.path"
# plan entries kept in the store; the least recently used past it go
FUGUE_TPU_CONF_TUNING_MAX_ENTRIES = "fugue.tpu.tuning.max_entries"
# record each traced verb's bytes/s and rows/s in the store's
# "rooflines" key while tracing is on (record only; default ON)
FUGUE_TPU_CONF_TUNING_ROOFLINES = "fugue.tpu.tuning.rooflines"
# --- resilience (``fugue_tpu_torch/resilience``; ``fugue_tpu/constants.py``
# :49-73). ``RetryPolicy.from_conf`` reads ``<prefix>.attempts`` (1
# disables retry), ``.base``, ``.multiplier``, ``.max_backoff`` (seconds)
# and ``.jitter``: the pool's chunks under ``fugue.tpu.retry``, the HTTP
# client's calls under ``fugue.tpu.retry.rpc`` (connect-phase failures and
# idempotent calls only: a request that may have reached the server is not
# re-sent), a workflow task under ``fugue.tpu.retry.task``. Attempts of one
# workflow task (default 1: fail fast); a retried task re-reads the strong
# checkpoints its upstream tasks wrote
FUGUE_TPU_CONF_RETRY_TASK_ATTEMPTS = "fugue.tpu.retry.task.attempts"
# the HTTP RPC client's socket timeouts (seconds)
FUGUE_RPC_CONF_HTTP_CONNECT_TIMEOUT = "fugue.rpc.http_client.connect_timeout"
FUGUE_RPC_CONF_HTTP_READ_TIMEOUT = "fugue.rpc.http_client.read_timeout"
# the fault plan (grammar in ``resilience/fault.py``); also read from the
# FUGUE_TPU_FAULT_PLAN environment variable
FUGUE_TPU_CONF_FAULT_PLAN = "fugue.tpu.fault.plan"

# --- observability (``fugue_tpu_torch/obs``; ``fugue_tpu/constants.py``
# :72-127). The span tracer's switch (the FUGUE_TPU_TRACE environment
# variable overrides it both ways)
FUGUE_TPU_CONF_TRACE_ENABLED = "fugue.tpu.trace.enabled"
# mirror spans opened with ``annotate=True`` into ``torch.profiler``
# ranges of the same name (default true; only while tracing is on)
FUGUE_TPU_CONF_TRACE_XLA = "fugue.tpu.trace.xla"
# directory a workflow run writes one Chrome trace file into; unset: none
FUGUE_TPU_CONF_TRACE_DIR = "fugue.tpu.trace.dir"
# the span buffer's cap; later spans are dropped and counted
FUGUE_TPU_CONF_TRACE_MAX_SPANS = "fugue.tpu.trace.max_spans"
# the recovery-event log's switch and directory (FUGUE_TPU_EVENTS and
# FUGUE_TPU_EVENTS_DIR override them)
FUGUE_TPU_CONF_EVENTS_ENABLED = "fugue.tpu.events.enabled"
FUGUE_TPU_CONF_EVENTS_DIR = "fugue.tpu.events.dir"
# the resource sampler's switch (FUGUE_TPU_TELEMETRY overrides it), its
# interval in seconds (default 0.25) and its ring's capacity in samples
FUGUE_TPU_CONF_TELEMETRY_ENABLED = "fugue.tpu.telemetry.enabled"
FUGUE_TPU_CONF_TELEMETRY_INTERVAL = "fugue.tpu.telemetry.interval"
FUGUE_TPU_CONF_TELEMETRY_RING = "fugue.tpu.telemetry.ring_size"
# the `workflow` label of every span-histogram sample during a run
# (default: an 8-hex hash of the workflow's task uuids)
FUGUE_TPU_CONF_TELEMETRY_WORKFLOW = "fugue.tpu.telemetry.workflow"

# the plan optimizer (``fugue_tpu_torch/plan``), rewriting the task DAG at
# ``FugueWorkflow.run``: the master switch and one switch a pass, all on by
# default (``fugue_tpu/constants.py`` :149-181). Every rewrite gives the
# result of the DAG as compiled. Read from the engine's conf overlaid with
# the workflow's, never written back into the engine's
FUGUE_TPU_CONF_PLAN_OPTIMIZE = "fugue.tpu.plan.optimize"
# column pruning: projections pushed into the creates, loads and stream
# producers, so columns no task reads are never decoded or copied
FUGUE_TPU_CONF_PLAN_PRUNE = "fugue.tpu.plan.prune"
# filter pushdown: filters hoisted through row-local verbs and join sides
# toward the producer
FUGUE_TPU_CONF_PLAN_PUSHDOWN = "fugue.tpu.plan.pushdown"
# verb fusion: adjacent select/filter/assign chains become one task
FUGUE_TPU_CONF_PLAN_FUSE = "fugue.tpu.plan.fuse"
# segment lowering: a row-local chain flowing into a dense aggregate, take,
# distinct or broadcast-join probe becomes one task the torch engine runs
# over the raw columns, with no frame between the verbs
FUGUE_TPU_CONF_PLAN_LOWER_SEGMENTS = "fugue.tpu.plan.lower_segments"
# the UDF analyzer's switches (``analysis/``): analyze the transform
# tasks' UDFs, and splice the translated ones into the plan
FUGUE_TPU_CONF_PLAN_ANALYZE_UDFS = "fugue.tpu.plan.analyze_udfs"
FUGUE_TPU_CONF_PLAN_TRANSLATE_UDFS = "fugue.tpu.plan.translate_udfs"
