"""Cache-aware plan cut, copied from ``fugue_tpu/cache/planner.py``:
decide, per run, which tasks are served from the result cache and which
upstream tasks are therefore never executed.

Reverse-topological walk over the POST-optimization task list:

- roots (output sinks, pinned tasks — checkpoints/yields/broadcasts —
  and dangling results) are always *needed*;
- a needed task that the cache (or an existing deterministic
  StrongCheckpoint) can resolve becomes a **frontier hit**: its result
  is loaded, its inputs are NOT marked needed;
- a needed task with no hit executes and marks its inputs needed;
- everything never marked needed is **skipped entirely** — not decoded,
  not transferred, no ``workflow.task`` span.

Frontier loads happen eagerly at plan time, onto the engine's device: a
torn artifact or an eviction race turns that task back into a miss and
the cut is recomputed (the load failure propagates need upstream, which
may itself hit). So by the time the graph runs, every hit already holds
its frame. The plan holds a frame only as long as the run's context does:
a memory hit is the LRU's own object, and nothing here keeps another.
"""

from typing import Any, Dict, List, Optional, Set

from ..workflow._checkpoint import StrongCheckpoint
from ..workflow._tasks import FugueTask, OutputTask

__all__ = ["CachePlan", "plan_cache", "describe_cache"]


class CachePlan:
    """One run's cut: what hits, what executes, what is skipped."""

    def __init__(self, fpr: Any) -> None:
        self.fpr = fpr  # FingerprintReport
        self.hits: Dict[int, Any] = {}  # id(task) -> loaded DataFrame
        self.hit_tier: Dict[int, str] = {}
        self.checkpoint_hits: Set[int] = set()
        self.skipped: Set[int] = set()
        self.executes: Set[int] = set()
        self.bytes_skipped = 0
        # partition-level delta recompute (delta.py):
        # tasks served as cached-partitions + fresh-partitions merges
        self.delta_hits: Dict[int, Any] = {}  # id(task) -> DeltaHit
        self.delta_templates: Dict[int, Any] = {}
        self.delta_reasons: Dict[int, str] = {}

    def fp(self, task: FugueTask) -> Optional[str]:
        return self.fpr.fp(task)

    def summary(self) -> Dict[str, int]:
        return {
            "hits": len(self.hits),
            "checkpoint_hits": len(self.checkpoint_hits),
            "skipped": len(self.skipped),
            "executes": len(self.executes),
            "bytes_skipped": self.bytes_skipped,
            "delta_hits": len(self.delta_hits),
            "delta_partitions": sum(
                h.matched_parts for h in self.delta_hits.values()
            ),
            "bytes_skipped_delta": sum(
                h.bytes_matched for h in self.delta_hits.values()
            ),
        }


def _checkpoint_available(task: FugueTask, checkpoint_path: Any) -> bool:
    """Whether the task's own deterministic StrongCheckpoint can replay it
    without inputs (the existing ``_run_task_once`` branch serves it; the
    planner only uses this to skip its ancestors)."""
    cp = task.checkpoint
    if not isinstance(cp, StrongCheckpoint) or not cp.deterministic:
        return False
    try:
        return cp.exists(checkpoint_path, task.__uuid__())
    except Exception:
        return False


def _compute_cut(
    tasks: List[FugueTask],
    available: Any,
    checkpoint_path: Any,
) -> Dict[str, Any]:
    """One reverse-topo pass; ``available(task) -> Optional[str]`` says
    which cache tier could currently resolve the task."""
    from ..plan.ir import task_pinned

    consumers: Dict[int, int] = {}
    for t in tasks:
        for d in t.inputs:
            consumers[id(d)] = consumers.get(id(d), 0) + 1
    needed: Set[int] = set()
    hits: Dict[int, str] = {}
    cp_hits: Set[int] = set()
    executes: Set[int] = set()
    skipped: List[FugueTask] = []
    for t in reversed(tasks):
        is_root = (
            isinstance(t, OutputTask)
            or task_pinned(t)
            or consumers.get(id(t), 0) == 0
        )
        if not (is_root or id(t) in needed):
            skipped.append(t)
            continue
        if not isinstance(t, OutputTask):
            if _checkpoint_available(t, checkpoint_path):
                cp_hits.add(id(t))
                continue  # replay branch needs no inputs
            tier = available(t)
            if tier is not None:
                hits[id(t)] = tier
                continue  # the cache needs no inputs either
        executes.add(id(t))
        for d in t.inputs:
            needed.add(id(d))
    return {
        "hits": hits,
        "cp_hits": cp_hits,
        "executes": executes,
        "skipped": skipped,
    }


def plan_cache(
    tasks: List[FugueTask],
    engine: Any,
    cache: Any,
    checkpoint_path: Any,
) -> CachePlan:
    """Fingerprint, cut, and eagerly load the frontier. Emits one
    ``cache.lookup`` span per frontier decision (hit or miss) so a warm
    run's trace shows exactly where the plan was cut."""
    from ..obs import get_tracer
    from .delta import _DeltaRefused, build_delta_templates, match_manifest
    from .fingerprint import fingerprint_tasks

    fpr = fingerprint_tasks(tasks, engine.conf, type(engine).__name__)
    plan = CachePlan(fpr)
    tracer = get_tracer()
    blacklist: Set[str] = set()
    looked_up: Set[int] = set()
    delta_on = cache.enabled and cache.delta_enabled
    if delta_on:
        plan.delta_templates, plan.delta_reasons = build_delta_templates(
            tasks, fpr
        )
    delta_offers: Dict[int, Any] = {}
    delta_blacklist: Set[int] = set()

    def available(task: FugueTask) -> Optional[str]:
        fp = fpr.fp(task)
        if fp is None or fp in blacklist:
            return None
        tier = cache.contains(fp)
        if tier is not None:
            return tier
        if id(task) in delta_offers:
            return "delta"
        if delta_on and id(task) not in delta_blacklist:
            tpl = plan.delta_templates.get(id(task))
            if tpl is not None:
                try:
                    delta_offers[id(task)] = match_manifest(tpl, cache)
                    return "delta"
                except _DeltaRefused as r:
                    plan.delta_reasons[id(task)] = r.reason
                    delta_blacklist.add(id(task))
                    if r.had_manifest:
                        cache.stats.inc("delta_refusals")
        return None

    # the eager-load loop: a frontier load that fails (eviction race,
    # torn artifact) blacklists that fingerprint and recomputes the cut
    for _ in range(len(tasks) + 1):
        cut = _compute_cut(tasks, available, checkpoint_path)
        retry = False
        for t in tasks:
            if id(t) not in cut["hits"]:
                continue
            if cut["hits"][id(t)] == "delta":
                if id(t) in plan.delta_hits:
                    continue
                hit = delta_offers[id(t)]
                looked_up.add(id(t))
                with tracer.span(
                    "cache.lookup",
                    cat="cache",
                    task=t.name or type(t.extension).__name__,
                    fp=(fpr.fp(t) or "")[:12],
                ) as sp:
                    frames = []
                    for afp in hit.artifact_fps:
                        loaded = cache.lookup(afp, engine)
                        if loaded is None:
                            break
                        frames.append(loaded[0])
                    if len(frames) != len(hit.artifact_fps):
                        # an artifact evaporated under us: this manifest is
                        # stale — invalidate it alone and recut without it
                        cache.drop_manifest(hit.template.delta_key)
                        delta_offers.pop(id(t), None)
                        delta_blacklist.add(id(t))
                        plan.delta_reasons[id(t)] = (
                            "cached partition artifact evicted (manifest "
                            "entry invalidated)"
                        )
                        sp.set(outcome="delta_miss")
                        retry = True
                        break
                    hit.cached_frames = frames
                    plan.delta_hits[id(t)] = hit
                    sp.set(
                        outcome="delta",
                        partitions=f"{hit.matched_parts}/{hit.total_parts}",
                        bytes_skipped=hit.bytes_matched,
                    )
                continue
            if id(t) in plan.hits:
                continue
            fp = fpr.fp(t)
            looked_up.add(id(t))
            with tracer.span(
                "cache.lookup",
                cat="cache",
                task=t.name or type(t.extension).__name__,
                fp=(fp or "")[:12],
            ) as sp:
                loaded = cache.lookup(fp, engine)
                if loaded is None:
                    blacklist.add(fp)  # type: ignore[arg-type]
                    sp.set(outcome="miss")
                    retry = True
                    break
                df, tier, nbytes = loaded
                plan.hits[id(t)] = df
                plan.hit_tier[id(t)] = tier
                sp.set(outcome="hit", tier=tier, bytes=nbytes)
        if not retry:
            break
    # drop hits that a later recut decided not to use after all (their
    # consumer's load failed and the consumer now executes: the hit frame
    # is still valid and stays — it feeds the consumer directly)
    plan.checkpoint_hits = cut["cp_hits"]
    plan.executes = cut["executes"]
    # a delta hit that a recut no longer uses must not keep its frames
    plan.delta_hits = {
        i: h for i, h in plan.delta_hits.items() if cut["hits"].get(i) == "delta"
    }
    for i in plan.delta_hits:
        plan.hit_tier[i] = "delta"
    for t in cut["skipped"]:
        plan.skipped.add(id(t))
        plan.bytes_skipped += fpr.source_bytes.get(id(t), 0)
    # the Load under a delta hit is "skipped" but its NEW partitions are
    # re-read — count only the bytes the delta actually avoids
    for h in plan.delta_hits.values():
        if id(h.template.load_task) in plan.skipped:
            plan.bytes_skipped = max(0, plan.bytes_skipped - h.bytes_fresh)
    # misses among tasks that will execute but were fingerprintable:
    # count them so hit-rate math works without a lookup side effect
    for t in tasks:
        if (
            id(t) in plan.executes
            and id(t) not in looked_up
            and fpr.fp(t) is not None
        ):
            cache.stats.inc("misses")
            cache.stats.inc("lookups")
        if fpr.fp(t) is None and not isinstance(t, OutputTask):
            cache.stats.inc("refusals")
    for h in plan.delta_hits.values():
        cache.stats.inc("partial_hits")
        cache.stats.inc("delta_partitions", h.matched_parts)
        cache.stats.inc(
            "delta_partitions_fresh", max(1, len(h.new_files))
        )
        cache.stats.inc("bytes_skipped_delta", h.bytes_matched)
    cache.stats.inc("tasks_skipped", len(plan.skipped))
    cache.stats.inc("bytes_skipped", plan.bytes_skipped)
    return plan


def describe_cache(
    tasks: List[FugueTask],
    conf: Any,
    cache: Any = None,
    checkpoint_path: Any = None,
    engine_kind: str = "any",
) -> List[str]:
    """Render the would-be cut for ``workflow.explain()`` (dry run: probes
    ``contains`` only, loads nothing, counts nothing). Fingerprints are
    engine-partitioned, so hit/miss is only accurate when ``engine_kind``
    names the engine class the run will use."""
    from ..constants import FUGUE_TPU_CONF_CACHE_ENABLED
    from .fingerprint import fingerprint_tasks
    from .store import ResultCache

    try:
        enabled = bool(conf.get(FUGUE_TPU_CONF_CACHE_ENABLED, True))
    except Exception:
        enabled = True
    if not enabled:
        return ["== result cache disabled (fugue.tpu.cache.enabled=false) =="]
    if cache is None:
        cache = ResultCache(conf)
    fpr = fingerprint_tasks(tasks, conf, engine_kind)
    from .delta import _DeltaRefused, build_delta_templates, match_manifest

    delta_on = cache.enabled and cache.delta_enabled
    templates: Dict[int, Any] = {}
    delta_reasons: Dict[int, str] = {}
    if delta_on:
        templates, delta_reasons = build_delta_templates(tasks, fpr)
    delta_offers: Dict[int, Any] = {}

    def available(task: FugueTask) -> Optional[str]:
        fp = fpr.fp(task)
        if fp is None:
            return None
        tier = cache.contains(fp)
        if tier is not None:
            return tier
        if id(task) in delta_offers:
            return "delta"
        tpl = templates.get(id(task))
        if tpl is not None and id(task) not in delta_reasons:
            try:
                # dry run: probe only, never repair/delete stale manifests
                delta_offers[id(task)] = match_manifest(tpl, cache, repair=False)
                return "delta"
            except _DeltaRefused as r:
                delta_reasons[id(task)] = r.reason
        return None

    cut = _compute_cut(tasks, available, checkpoint_path)
    skipped_ids = {id(t) for t in cut["skipped"]}
    bytes_skipped = sum(fpr.source_bytes.get(i, 0) for i in skipped_ids)
    scope = "" if engine_kind == "any" else f" for {engine_kind}"
    lines = [
        "== result cache%s (cut: %d hit, %d checkpoint, %d skipped upstream, "
        "~%d source bytes never read) =="
        % (scope, len(cut["hits"]), len(cut["cp_hits"]), len(skipped_ids), bytes_skipped)
    ]
    for i, t in enumerate(tasks):
        fp = fpr.fp(t)
        if id(t) in cut["hits"]:
            if cut["hits"][id(t)] == "delta":
                h = delta_offers[id(t)]
                status = (
                    f"DELTA[{h.matched_parts}/{h.total_parts} partitions] "
                    f"{h.template.delta_key[:12]} (~{h.bytes_matched} source "
                    "bytes served from cache; only new partitions recompute)"
                )
            else:
                status = f"HIT[{cut['hits'][id(t)]}] {fp[:12]}"
        elif id(t) in cut["cp_hits"]:
            status = "checkpoint replay"
        elif id(t) in skipped_ids:
            status = "skipped (downstream hit cuts the plan here)"
        elif fp is None:
            status = "uncacheable: " + fpr.reasons.get(id(t), "?")
        else:
            status = f"miss {fp[:12]}"
            why = delta_reasons.get(id(t))
            if why is not None and delta_on:
                status += f" (delta: {why})"
        lines.append(f"  t{i}: {type(t.extension).__name__} -- {status}")
    return lines
