"""Logical plan optimizer for the workflow DAG, copied from
``fugue_tpu/plan/`` for one card.

Runs at ``workflow.run()`` time over the task graph, before execution:

- **column pruning** — projections pushed into ``to_df``/load/stream
  producers so unread columns are never decoded or copied to the device;
- **filter pushdown** — filters hoisted through row-local verbs and
  inner-join sides toward the producer;
- **verb fusion** — adjacent select/filter/assign chains collapsed into
  one step;
- **segment lowering** — a fused chain flowing into a dense aggregate /
  take / distinct / broadcast-join probe collapsed into ONE task the torch
  engine runs over the raw columns (per segment, a refusal runs the
  per-verb path, counted in ``plan_stats.segments_fallback``).

Disable with ``fugue.tpu.plan.optimize=false`` (or per pass:
``.prune`` / ``.pushdown`` / ``.fuse`` / ``.lower_segments``). Every
rewrite gives the result of the unoptimized path. The distributed pass
(``fugue_tpu/plan/distribute.py``) waits for ROADMAP.md A.10.
"""

from .fused import FusedVerbs, apply_steps_engine, compose_steps
from .lowering import (
    LoweredSegment,
    apply_terminal_engine,
    lower_segments,
    segment_fingerprint,
)
from .optimizer import PlanReport, PlanStats, optimize_tasks

__all__ = [
    "FusedVerbs",
    "LoweredSegment",
    "PlanReport",
    "PlanStats",
    "apply_steps_engine",
    "apply_terminal_engine",
    "compose_steps",
    "lower_segments",
    "optimize_tasks",
    "segment_fingerprint",
]
