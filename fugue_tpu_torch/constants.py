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


# --- serving and views (``fugue_tpu_torch/serve``, ``fugue_tpu_torch/views``):
# the keys of ``fugue_tpu/constants.py`` :279-379, copied with their
# defaults (views off; the fleet active only over a shared
# ``fugue.tpu.cache.dir``) ---
# --- multi-tenant serving layer (fugue_tpu_torch/serve, docs/serving.md) ---
# concurrent workflow executions one EngineServer runs at a time (its
# worker-thread pool size); everything past it waits in the admission queue
FUGUE_TPU_CONF_SERVE_MAX_CONCURRENT = "fugue.tpu.serve.max_concurrent"
# admission queue capacity: submissions past it are REJECTED (the /readyz
# readiness endpoint reports "overloaded" with a 503 before that happens,
# so a load balancer can shed first)
FUGUE_TPU_CONF_SERVE_QUEUE_DEPTH = "fugue.tpu.serve.queue_depth"
# priority for submissions that don't name one (lower = sooner; ties FIFO)
FUGUE_TPU_CONF_SERVE_DEFAULT_PRIORITY = "fugue.tpu.serve.default_priority"
# starvation guard: a queued execution's effective priority improves by
# one level per aging_s seconds waited, so FIFO-within-priority can never
# starve the lowest level under a steady high-priority stream. 0 disables.
FUGUE_TPU_CONF_SERVE_AGING_S = "fugue.tpu.serve.aging_s"
# bytes charged against a tenant's budget per admitted submission when
# the submission doesn't declare its own reserve_bytes (replaced by the
# measured result bytes once the run finishes — live accounting)
FUGUE_TPU_CONF_SERVE_RESERVE_BYTES = "fugue.tpu.serve.reserve_bytes"
# how many completed submissions the server retains for result pickup
# (oldest evicted past it; their tenant byte charge releases on eviction)
FUGUE_TPU_CONF_SERVE_RETAIN = "fugue.tpu.serve.retain"
# per-tenant overlays: fugue.tpu.serve.tenant.<id>.priority (scheduling
# default), fugue.tpu.serve.tenant.<id>.budget_bytes (admission gate:
# live charged bytes + the new reserve must stay under it; 0 = unlimited),
# and fugue.tpu.serve.tenant.<id>.conf.<key> (per-run conf overlay — any
# fugue.tpu.* key: workflow.run scopes conf per run, so an overlay can
# never leak into another tenant's run; non-fugue.tpu keys are dropped
# with a warning)
FUGUE_TPU_CONF_SERVE_TENANT_PREFIX = "fugue.tpu.serve.tenant."
# keys every tenant conf overlay must start with (run-scoped by the
# workflow.run conf overlay; see docs/serving.md)
FUGUE_TPU_CONF_SERVE_TENANT_OVERLAY_PREFIX = "fugue.tpu."
# distinct tenant ids the serving layer keeps state for (per-tenant stats
# breakdown, parsed tenant policies, the one-warning-per-tenant set) —
# least-recently-seen tenants past it are evicted, the same LRU
# discipline as the serve.retain retention ring: a hostile client minting
# tenant ids must not leak memory in a long-lived server
FUGUE_TPU_CONF_SERVE_MAX_TENANTS = "fugue.tpu.serve.max_tenants"

# --- serving fleet (fugue_tpu_torch/serve/fleet.py, docs/serving.md "Fleet") ---
# master switch for cross-replica coordination. ON by default but only
# ACTIVE when the engine mounts a shared disk store (fugue.tpu.cache.dir)
# — replicas sharing that directory collapse identical submissions across
# processes via claim files and serve each other's published results.
# =false (or a single replica with no shared store) preserves the
# single-server behavior bit-identically, including the /serve/* wire
# contract.
FUGUE_TPU_CONF_SERVE_FLEET_ENABLED = "fugue.tpu.serve.fleet.enabled"
# claim lease in seconds: a claim older than this whose owner can't be
# proven alive is STEALABLE — a dead replica's in-flight plan is taken
# over by whichever waiter gets the atomic claim rewrite in first. A
# same-host owner with a dead pid is stealable immediately.
FUGUE_TPU_CONF_SERVE_FLEET_LEASE_S = "fugue.tpu.serve.fleet.lease_s"
# how often a cross-replica waiter re-checks the shared store for the
# owner's published result (and the owner's claim for expiry)
FUGUE_TPU_CONF_SERVE_FLEET_POLL_S = "fugue.tpu.serve.fleet.poll_s"
# published serve-result payloads kept in the shared store (mtime-LRU
# eviction past it, the ArtifactStore discipline)
FUGUE_TPU_CONF_SERVE_FLEET_MAX_RESULTS = "fugue.tpu.serve.fleet.max_results"
# this replica's stable identity in claim files / journal names /
# /readyz; default "<hostname>-<pid>" (unique per process)
FUGUE_TPU_CONF_SERVE_REPLICA_ID = "fugue.tpu.serve.replica_id"
# crash-safe submission journal: the directory holding each replica's
# append-only fsync'd WAL (<replica_id>.jsonl). Unset (default) disables
# journaling; on restart a replica REPLAYS its own unfinished entries
# under their original idempotency keys (docs/serving.md "Fleet").
FUGUE_TPU_CONF_SERVE_JOURNAL_DIR = "fugue.tpu.serve.journal.dir"
# journal compaction threshold (bytes): past it the WAL is rewritten
# atomically with every terminal submission's records dropped — replay
# semantics are provably unchanged (unfinished() parity). 0 disables.
FUGUE_TPU_CONF_SERVE_JOURNAL_MAX_BYTES = "fugue.tpu.serve.journal.max_bytes"

# --- continuous views (fugue_tpu_torch/views, docs/views.md) ---
# master kill-switch, default OFF: =false means no registration
# endpoints (they 404), no watcher threads, and a serve wire contract /
# span multiset bit-identical to the pre-views tiers. Turning it on
# requires a shared store (fugue.tpu.cache.dir) — the registry, heads,
# leases and generation payloads all live there so any replica can serve
# while exactly one maintains.
FUGUE_TPU_CONF_VIEWS_ENABLED = "fugue.tpu.views.enabled"
# watcher loop interval in seconds: how often the maintainer re-observes
# every watched source (and renews its watch leases)
FUGUE_TPU_CONF_VIEWS_POLL_S = "fugue.tpu.views.poll_s"
# per-view watch lease duration: a lease this old whose holder cannot be
# proven alive (dist heartbeat / same-host pid probe) is stealable — the
# exactly-one-maintainer guarantee under replica death
FUGUE_TPU_CONF_VIEWS_LEASE_S = "fugue.tpu.views.lease_s"
# published generations retained per view beyond the pinned latest one
# (older generation payloads are deleted by the maintainer on publish)
FUGUE_TPU_CONF_VIEWS_KEEP_GENERATIONS = "fugue.tpu.views.keep_generations"
# how many priority points an SLO-at-risk refresh gains (priority is
# min-wins, so the boost SUBTRACTS; floor 0)
FUGUE_TPU_CONF_VIEWS_SLO_BOOST = "fugue.tpu.views.slo_boost"
# fraction of a tenant's freshness_s after which a pending refresh counts
# as at-risk and takes the boost (breach itself is at 1.0)
FUGUE_TPU_CONF_VIEWS_SLO_RISK_FRACTION = "fugue.tpu.views.slo_risk_fraction"
# registered views cap (bounds /metrics cardinality and registry scans)
FUGUE_TPU_CONF_VIEWS_MAX = "fugue.tpu.views.max"
# how long a maintainer waits for one refresh submission to finish before
# counting it failed and retrying next tick
FUGUE_TPU_CONF_VIEWS_REFRESH_TIMEOUT_S = "fugue.tpu.views.refresh_timeout_s"

# a serve replica's span spool directory (``fugue_tpu/constants.py`` :96):
# with tracing on, it publishes its span buffer there after each execution
FUGUE_TPU_CONF_TRACE_SPOOL_DIR = "fugue.tpu.trace.spool_dir"

# the heartbeat protocol of ``dist/heartbeat.py`` (``fugue_tpu/constants.py``
# :390-399): every replica or view maintainer with a heartbeat dir writes
# <dir>/<id>.hb.json every interval_s; a beat older than stale_after_s is
# proof of death for lease and claim stealing
FUGUE_TPU_CONF_DIST_HB_DIR = "fugue.tpu.dist.heartbeat.dir"
FUGUE_TPU_CONF_DIST_HB_INTERVAL_S = "fugue.tpu.dist.heartbeat.interval_s"
FUGUE_TPU_CONF_DIST_HB_STALE_S = "fugue.tpu.dist.heartbeat.stale_after_s"

# --- the worker tier (``fugue_tpu_torch/dist``; ``fugue_tpu/constants.py``
# :385-436) ---
# master kill-switch: =false makes DistSupervisor.run_* execute the whole
# job serially in THIS process (same functions, same bucket order) —
# bit-identical to the distributed result by construction
FUGUE_TPU_CONF_DIST_ENABLED = "fugue.tpu.dist.enabled"
# task lease duration: a lease this old whose owner cannot be proven
# alive (heartbeat) is stealable by any live worker; owners renew at
# lease_s/3 while executing, so only a dead or wedged owner expires
FUGUE_TPU_CONF_DIST_LEASE_S = "fugue.tpu.dist.lease_s"
# shuffle-fragment fetch mode: "auto" reads the producer's file directly
# when its path is visible on this host's filesystem and falls back to
# the producer's HTTP /dist/fetch route; "remote" always fetches over
# HTTP except from this worker's own dir (the multi-host shape); "local"
# never fetches (single-host tier)
FUGUE_TPU_CONF_DIST_FETCH = "fugue.tpu.dist.fetch"
# reduce-side bucket count for the network-partitioned exchange
FUGUE_TPU_CONF_DIST_BUCKETS = "fugue.tpu.dist.buckets"
# straggler mitigation: a task leased (and renewed) by a LIVE owner for
# longer than this is marked speculative — a second worker re-executes
# it and the first published done record wins (artifacts are content-
# addressed, so the loser's publish dedups). 0 (default) disables
FUGUE_TPU_CONF_DIST_SPECULATIVE_AFTER_S = "fugue.tpu.dist.speculative_after_s"
# supervisor/worker poll cadence over the shared board
FUGUE_TPU_CONF_DIST_POLL_S = "fugue.tpu.dist.poll_s"
# reduce-side fragment prefetch depth: the fetch of fragment i+1 overlaps
# the decode and reduce of fragment i; <=0 fetches serially; default 2
FUGUE_TPU_CONF_DIST_FETCH_PREFETCH_DEPTH = "fugue.tpu.dist.fetch_prefetch_depth"
# shared task-board root for DISTRIBUTED WORKFLOW execution: when set (and
# dist.enabled is true), workflow.run hands distributable fragments of the
# optimized DAG — Load roots + row-local chains into an equi-join, keyed
# aggregate, or bucket-local SQL SELECT — to
# DistSupervisor.run_workflow_job as leased board tasks
# (``plan/distribute.py``). Unset (default): the planner is inert
FUGUE_TPU_CONF_DIST_BOARD = "fugue.tpu.dist.board"
# wall-clock timeout (seconds) for one distributed workflow fragment's
# board job; 0/unset = unbounded (recovery is driven by leases, not this)
FUGUE_TPU_CONF_DIST_WORKFLOW_TIMEOUT_S = "fugue.tpu.dist.workflow_timeout_s"
# wall-clock deadline (seconds) across ALL RetryPolicy-driven attempts of
# one /dist/fetch fragment fetch (conf prefix fugue.tpu.retry.dist.*);
# past it the fetch stops retrying and the orphaned-fragment ladder runs
FUGUE_TPU_CONF_RETRY_DIST_DEADLINE_S = "fugue.tpu.retry.dist.deadline_s"
