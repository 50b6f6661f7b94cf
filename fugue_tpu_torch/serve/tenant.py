"""Per-tenant serving policy and live byte accounting.

Policy comes from the engine conf under ``fugue.tpu.serve.tenant.<id>.*``
(see ``docs/serving.md``):

- ``priority`` — scheduling default for submissions that don't name one;
- ``budget_bytes`` — the admission gate: the tenant's *charged* bytes
  (reserves of in-flight submissions plus the measured result bytes of
  completed-but-unclaimed ones) plus the new submission's reserve must
  stay under it. 0 = unlimited.
- ``freshness_s`` — the tenant's view-staleness SLO in seconds
  (continuous views, ``docs/views.md``): a standing view whose pending
  refresh has waited past the at-risk fraction of this budget gets a
  priority boost in the admission queue; past the full budget a
  ``view.slo_breach`` event is recorded. Unset / <= 0 = no SLO.
- ``conf.<key>`` — a per-run conf overlay merged into every submitted
  workflow's compile conf. Any ``fugue.tpu.*`` key is accepted:
  ``workflow.run`` scopes workflow conf per run (the engine's
  ``run_conf_scope`` context overlay), so an overlay can never be
  written into the SHARED engine conf or leak into another tenant's run.
  Keys outside ``fugue.tpu.*`` (workflow/compile semantics like
  ``fugue.workflow.*``) are still dropped with one warning per tenant —
  they change what a dag MEANS, not how this engine runs it.

Accounting is *live*, not declarative: a submission is admitted against
its declared ``reserve_bytes`` (or the ``fugue.tpu.serve.reserve_bytes``
default), and the charge is re-stated to the measured
:func:`~fugue_tpu_torch.cache.store.estimate_df_bytes` of its yielded frames
the moment the run finishes — exactly what the tenant is actually
holding live on the server until the result is claimed or evicted.
"""

import threading
from typing import Any, Dict, Optional, Tuple

from ..constants import (
    FUGUE_TPU_CONF_SERVE_TENANT_OVERLAY_PREFIX,
    FUGUE_TPU_CONF_SERVE_TENANT_PREFIX,
)

__all__ = ["TenantPolicy", "TenantAccounts", "tenant_policy"]


class TenantPolicy:
    """One tenant's parsed conf overlay."""

    def __init__(
        self,
        tenant: str,
        priority: Optional[int] = None,
        budget_bytes: int = 0,
        conf_overlay: Optional[Dict[str, Any]] = None,
        dropped_keys: Tuple[str, ...] = (),
        freshness_s: Optional[float] = None,
    ):
        self.tenant = tenant
        self.priority = priority
        self.budget_bytes = int(budget_bytes)
        self.conf_overlay = dict(conf_overlay or {})
        self.dropped_keys = tuple(dropped_keys)
        self.freshness_s = None if freshness_s is None else float(freshness_s)


def tenant_policy(conf: Any, tenant: str) -> TenantPolicy:
    """Parse ``fugue.tpu.serve.tenant.<id>.*`` out of an engine conf."""
    prefix = f"{FUGUE_TPU_CONF_SERVE_TENANT_PREFIX}{tenant}."
    priority: Optional[int] = None
    budget = 0
    freshness: Optional[float] = None
    overlay: Dict[str, Any] = {}
    dropped = []
    try:
        items = list(conf.items())
    except Exception:
        items = []
    for k, v in items:
        ks = str(k)
        if not ks.startswith(prefix):
            continue
        sub = ks[len(prefix):]
        if sub == "priority":
            priority = int(v)
        elif sub == "budget_bytes":
            budget = int(v)
        elif sub == "freshness_s":
            freshness = float(v)
        elif sub.startswith("conf."):
            key = sub[len("conf."):]
            # any fugue.tpu.* key is safely per-run now that workflow.run
            # scopes workflow conf (engine.run_conf_scope) instead of
            # writing it into the shared engine conf; keys outside it are
            # compile-semantics knobs a serving operator shouldn't set
            if key.startswith(FUGUE_TPU_CONF_SERVE_TENANT_OVERLAY_PREFIX):
                overlay[key] = v
            else:
                dropped.append(key)
    return TenantPolicy(
        tenant,
        priority=priority,
        budget_bytes=budget,
        conf_overlay=overlay,
        dropped_keys=tuple(dropped),
        freshness_s=freshness,
    )


class TenantAccounts:
    """Live charged-byte ledger, keyed (tenant, submission id)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._charges: Dict[Tuple[str, str], int] = {}

    def charged(self, tenant: str) -> int:
        with self._lock:
            return sum(
                v for (t, _sid), v in self._charges.items() if t == tenant
            )

    def try_charge(self, tenant: str, sid: str, nbytes: int, budget: int) -> bool:
        """Admission gate: charge ``nbytes`` unless it would push the
        tenant past ``budget`` (0 = unlimited). Atomic check-and-charge."""
        nbytes = max(0, int(nbytes))
        with self._lock:
            if budget > 0:
                live = sum(
                    v for (t, _sid), v in self._charges.items() if t == tenant
                )
                if live + nbytes > budget:
                    return False
            self._charges[(tenant, sid)] = nbytes
            return True

    def restate(self, tenant: str, sid: str, nbytes: int) -> None:
        """Replace a reserve with the measured live bytes (run finished).
        Never *rejects* — the work is already done; the next admission
        simply sees the true charge."""
        with self._lock:
            if (tenant, sid) in self._charges:
                self._charges[(tenant, sid)] = max(0, int(nbytes))

    def release(self, tenant: str, sid: str) -> None:
        with self._lock:
            self._charges.pop((tenant, sid), None)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for (t, _sid), v in self._charges.items():
                out[t] = out.get(t, 0) + v
            return out
