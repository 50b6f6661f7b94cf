"""Plan-fingerprint identity for in-flight dedup (single-flight).

Two tenants submitting the same workflow should share ONE execution. The
identity that makes that safe is the same one the result cache already
trusts: the canonical post-optimization plan fingerprint of
``fugue_tpu_torch/cache/fingerprint.py`` — verb kinds, normalized params, UDF
source, input file (path, size, mtime) lists, engine class, conf salt.
Two submissions with equal keys are the same computation over the same
bytes under the same engine, so handing both the one result is exactly
what the cross-run cache would do anyway, just collapsed in flight.

Refusal is a value here too: if ANY non-output task refuses to
fingerprint (streams, non-deterministic UDFs, device frames, RPC
callbacks — everything docs/cache.md lists), the submission gets **no**
dedup key and always runs on its own. A refusal can never cause a wrong
share.

Output sinks (show/save/assert) never fingerprint — their side effects
are the point — but they don't poison dedup: an output task contributes
its deterministic task uuid plus its inputs' fingerprints, so two
identical dags (same sinks over the same fingerprinted frames) still
share, and the sink's side effect runs once per shared execution (the
semantics a served result share implies; see docs/serving.md).
"""

import hashlib
from typing import Any, Optional

from .._utils.params import ParamDict
from ..workflow._tasks import OutputTask

__all__ = ["submission_key"]


def submission_key(dag: Any, engine: Any, conf: Any = None) -> Optional[str]:
    """The in-flight dedup key for submitting ``dag`` to ``engine``, or
    ``None`` when the plan can't be fully fingerprinted (no dedup).

    Runs the same optimize→fingerprint pipeline the run path will run
    (dry: ``optimize_tasks`` clones, it never mutates the compiled
    tasks), under the same conf precedence — engine conf overlaid with
    the workflow's compile conf — so the key identifies the plan that
    would actually execute, not the one the user happened to type.
    """
    from ..cache.fingerprint import fingerprint_tasks
    from ..plan import optimize_tasks

    plan_conf = ParamDict(engine.conf)
    for k, v in dag._conf.items():
        plan_conf[k] = v
    if conf is not None:
        for k, v in ParamDict(conf).items():
            plan_conf[k] = v
    try:
        run_tasks, _aliases, _removed, _report = optimize_tasks(
            dag._tasks, plan_conf
        )
        fpr = fingerprint_tasks(run_tasks, plan_conf, type(engine).__name__)
    except Exception:
        return None  # an unplannable dag fails at run time, not here
    parts = []
    for t in run_tasks:
        fp = fpr.fp(t)
        if fp is not None:
            parts.append(fp)
            continue
        if not isinstance(t, OutputTask):
            return None  # refusal anywhere = no dedup, never a wrong share
        in_fps = [fpr.fp(d) for d in t.inputs]
        if any(f is None for f in in_fps):
            return None
        parts.append("out:" + t.__uuid__() + ":" + ",".join(in_fps))
    # both waiters read results by yield name — the mapping is part of
    # the identity (same plan, different names = different submissions)
    parts.append("yields:" + ",".join(sorted(dag.yields.keys())))
    return hashlib.md5("|".join(parts).encode()).hexdigest()
