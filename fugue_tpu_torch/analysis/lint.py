"""``workflow.lint()`` — a no-execution static check pass, copied from
``fugue_tpu/analysis/lint.py``.

Runs the UDF analyzer plus the plan machinery (an optimizer dry run with
the join-strategy annotation and segment lowering) over a built workflow
and returns STRUCTURED diagnostics: per-UDF verdict + refusal reason,
each join's predicted strategy (``shuffle/strategy.py``), predicted
lowered segments, and every optimizer note. Also rendered by
``workflow.explain(lint=True)``.
"""

from typing import Any, Dict, List, Optional

__all__ = ["LintDiagnostic", "LintReport", "lint_tasks"]


class LintDiagnostic:
    """One structured finding. ``kind`` ∈ {"udf", "join", "segment",
    "note"}; ``status`` is the verdict/strategy/refusal code."""

    __slots__ = ("kind", "name", "status", "message")

    def __init__(self, kind: str, name: str, status: str, message: str):
        self.kind = kind
        self.name = name
        self.status = status
        self.message = message

    def as_dict(self) -> Dict[str, str]:
        return {
            "kind": self.kind,
            "name": self.name,
            "status": self.status,
            "message": self.message,
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"LintDiagnostic({self.kind}:{self.name}:{self.status})"


class LintReport:
    """The result of :meth:`FugueWorkflow.lint`. ``diagnostics`` is the
    structured list; ``plan_report`` the underlying optimizer report."""

    def __init__(self, diagnostics: List[LintDiagnostic], plan_report: Any):
        self.diagnostics = diagnostics
        self.plan_report = plan_report

    def by_kind(self, kind: str) -> List[LintDiagnostic]:
        return [d for d in self.diagnostics if d.kind == kind]

    @property
    def udfs(self) -> List[LintDiagnostic]:
        return self.by_kind("udf")

    def as_dict(self) -> List[Dict[str, str]]:
        return [d.as_dict() for d in self.diagnostics]

    def render(self) -> str:
        lines = ["== lint =="]
        if not self.diagnostics:
            lines.append("  (no findings)")
        for d in self.diagnostics:
            name = f" {d.name}" if d.name else ""
            lines.append(f"  [{d.kind}]{name}: {d.status} -- {d.message}")
        return "\n".join(lines)


def lint_tasks(tasks: List[Any], conf: Any) -> LintReport:
    """Dry-run the optimizer (nothing executes, original tasks are never
    mutated) and fold its structured facts into a LintReport."""
    from ..plan import optimize_tasks

    _run_tasks, _a, _r, report = optimize_tasks(tasks, conf)
    diags: List[LintDiagnostic] = []
    for d in getattr(report, "udf_diags", []):
        status = "translated" if d.get("translated") else str(
            d.get("code") or "refused"
        )
        msg = (
            "translated into compiled steps"
            if d.get("translated")
            else str(d.get("reason") or "refused to the interpreted path")
        )
        diags.append(
            LintDiagnostic("udf", f'{d["udf"]}[{d["fp"]}]', status, msg)
        )
    for j in getattr(report, "join_strategies", []):
        diags.append(
            LintDiagnostic(
                "join", str(j["node"]), str(j["strategy"]), str(j["reason"])
            )
        )
    for s in getattr(report, "segments", []):
        diags.append(LintDiagnostic("segment", s.split(":")[0], "lowered", s))
    seen = {(d.kind, d.name, d.message) for d in diags}
    for nt in report.notes:
        if nt.startswith("udf ") or "strategy=" in nt:
            continue  # already structured above
        if ("note", "", nt) not in seen:
            diags.append(LintDiagnostic("note", "", "info", nt))
    return LintReport(diags, report)
