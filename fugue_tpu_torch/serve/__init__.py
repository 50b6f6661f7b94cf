"""Multi-tenant serving layer: a long-lived engine server for concurrent
workflows (docs/serving.md). The port's copy of ``fugue_tpu/serve``.

Quick start::

    from fugue_tpu_torch.serve import EngineServer, ServeHttpClient
    from fugue_tpu_torch.torch import TorchExecutionEngine

    eng = TorchExecutionEngine(conf={"fugue.tpu.serve.max_concurrent": 4})  # cuda:0
    with EngineServer(eng) as server:
        sub = server.submit(build_dag, tenant="acme", priority=3)
        frames = sub.result().yields

Over HTTP (the ``rpc/http.py`` surface; the engine's conf names
``"fugue.rpc.server": "fugue_tpu_torch.rpc.http.HttpRPCServer"``)::

    rpc = eng.rpc_server
    rpc.start()
    rpc.bind_serve(server)
    client = ServeHttpClient(rpc.host, rpc.port)
    sid = client.submit(build_dag, tenant="acme", idempotency_key="req-1")
    frames = client.result(sid, timeout=60)
"""

from .client import ServeHttpClient, ServeWorkerLost
from .dedup import submission_key
from .fleet import (
    FleetClient,
    FleetCoordinator,
    FleetResult,
    FleetSubmission,
    parse_view_result_name,
    view_result_key,
)
from .journal import SubmissionJournal
from .server import EngineServer, ServeRejected, Submission, SubmissionCanceled
from .stats import ServeStats
from .tenant import TenantAccounts, TenantPolicy, tenant_policy

__all__ = [
    "EngineServer",
    "FleetClient",
    "FleetCoordinator",
    "FleetResult",
    "FleetSubmission",
    "ServeHttpClient",
    "ServeRejected",
    "ServeStats",
    "ServeWorkerLost",
    "Submission",
    "SubmissionCanceled",
    "SubmissionJournal",
    "TenantAccounts",
    "TenantPolicy",
    "parse_view_result_name",
    "submission_key",
    "tenant_policy",
    "view_result_key",
]
