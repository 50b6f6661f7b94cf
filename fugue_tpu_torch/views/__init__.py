"""Continuous views (docs/views.md): standing workflows with
incremental view maintenance, served by the fleet.

A tenant registers a workflow factory plus a watched source; the fleet
journals the registration through the serve WAL, exactly one replica
advances the view under a per-view watch lease (the store's claim +
heartbeat primitive), fresh partitions ride the delta cache's path through the normal
admission queue, and every replica serves the latest published
generation with ``as_of``/staleness metadata. Default OFF
(``fugue.tpu.views.enabled``). The port's copy of ``fugue_tpu/views``: a
view's refresh runs on the server's engine, on the card for a
``TorchExecutionEngine``.
"""

from .maintainer import ViewMaintainer, probe_name
from .registry import ViewRegistry, ViewSpec
from .service import ViewService
from .stats import ViewStats
from .watcher import (
    FileSourceWatcher,
    Observation,
    SourceWatcher,
    WatchError,
    classify_tokens,
    make_watcher,
)

__all__ = [
    "ViewService",
    "ViewRegistry",
    "ViewSpec",
    "ViewMaintainer",
    "ViewStats",
    "SourceWatcher",
    "FileSourceWatcher",
    "Observation",
    "WatchError",
    "classify_tokens",
    "make_watcher",
    "probe_name",
]
