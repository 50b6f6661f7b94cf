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
rewrite gives the result of the unoptimized path.

A separate pass after the optimizer (``distribute.py``) partitions the
task DAG into board jobs for the worker tier (``fugue_tpu_torch/dist``)
when ``fugue.tpu.dist.board`` is set.
"""

from .distribute import (
    DistributePlan,
    describe_distribution,
    execute_fragment,
    plan_distribution,
)
from .fused import FusedVerbs, apply_steps_engine, compose_steps
from .lowering import (
    LoweredSegment,
    apply_terminal_engine,
    lower_segments,
    segment_fingerprint,
)
from .optimizer import PlanReport, PlanStats, optimize_tasks

__all__ = [
    "DistributePlan",
    "FusedVerbs",
    "LoweredSegment",
    "PlanReport",
    "PlanStats",
    "apply_steps_engine",
    "apply_terminal_engine",
    "compose_steps",
    "describe_distribution",
    "execute_fragment",
    "lower_segments",
    "optimize_tasks",
    "plan_distribution",
    "segment_fingerprint",
]
