"""UDF static analysis, copied from ``fugue_tpu/analysis``.

HiFrames-style (arXiv:1704.02341) AST analysis over plain-Python pandas
per-partition UDFs. For every ``transform`` task the analyzer produces

- exact column **read/write sets** — so the optimizer's backward demand
  analysis no longer treats a UDF as "reads everything" and column
  pruning / filter pushdown commute through it;
- a **purity / determinism / row-locality verdict** — so a filter
  commutes below a row-local UDF, and the delta cache
  (``fugue_tpu_torch/cache/delta.py``) splits a row-local UDF's input at
  a partition boundary;
- for the recognized shape subset (column arithmetic, comparisons,
  boolean masks, ``fillna``/``clip``/``where``/``mask``, ``np.where``
  conditionals, ``isin``, casts) a **translation** into the SAME step
  tuples the fusion (``fugue_tpu_torch/plan/fused.py``) and
  segment-lowering (``fugue_tpu_torch/plan/lowering.py``) passes already
  compile — a translated UDF fuses into surrounding chains and lowers
  with them into one segment.

Soundness over coverage: EVERY unrecognized construct refuses
conservatively to the interpreted path (bit-identical by construction)
with its reason rendered per-UDF in ``workflow.explain()`` and counted in
``engine.analysis_stats``.
"""

from .analyzer import (
    REASON_CODES,
    AnalysisStats,
    UdfAnalysis,
    analyze_transform_task,
    transform_row_local,
)
from .expand import expand_udf_transforms
from .lint import LintDiagnostic, LintReport, lint_tasks

__all__ = [
    "AnalysisStats",
    "LintDiagnostic",
    "LintReport",
    "REASON_CODES",
    "UdfAnalysis",
    "analyze_transform_task",
    "expand_udf_transforms",
    "lint_tasks",
    "transform_row_local",
]
