"""Per-process span spool — the cluster trace transport.

Remote processes (dist workers, serve replicas) cannot ship spans home
over the fork boundary the way ``parallel_map`` workers do, so each one
periodically **publishes its whole span buffer + resource-sampler ring +
stats** to a single per-process file in a shared spool directory:

    <spool_dir>/<host>-<pid>.spool.json

The publish is the repo's universal atomic discipline — temp write in the
same directory, ``os.replace`` — and each publish carries the FULL
cumulative buffer (bounded by the tracer's ``max_spans`` cap), so the
protocol is idempotent: last write wins, a crash mid-publish leaves the
previous complete file, and re-publishing after a retry is harmless.
Filenames are :func:`~fugue_tpu_torch.obs.tracer.proc_ident`-prefixed so two
hosts sharing a store never collide.

``obs/assemble.py`` merges the spools (plus the local buffer) into ONE
Perfetto trace with one named track per process.
"""

import json
import os
import tempfile
from typing import Any, Dict, List, Optional

from .tracer import get_tracer, proc_ident

__all__ = ["SPOOL_SUFFIX", "publish_spool", "read_spools"]

SPOOL_SUFFIX = ".spool.json"
SPOOL_VERSION = 1


def publish_spool(
    spool_dir: str,
    records: Optional[List[Dict[str, Any]]] = None,
    counters: Optional[List[Any]] = None,
    stats: Optional[Dict[str, Any]] = None,
    label: str = "",
) -> str:
    """Atomically publish THIS process's spans (default: the global tracer
    buffer), sampler ring (default: the global sampler's series — the
    remote counter-track fix) and optional stats snapshot to its spool
    file. Returns the published path."""
    if records is None:
        records = get_tracer().records()
    if counters is None:
        from .sampler import get_sampler

        counters = get_sampler().series()
    doc = {
        "version": SPOOL_VERSION,
        "proc": proc_ident(),
        "pid": os.getpid(),
        "label": label,
        "spans": records,
        "counters": [[ts, vals] for ts, vals in counters],
        "stats": stats or {},
    }
    os.makedirs(spool_dir, exist_ok=True)
    path = os.path.join(spool_dir, proc_ident() + SPOOL_SUFFIX)
    fd, tmp = tempfile.mkstemp(dir=spool_dir, prefix=".spool-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def read_spools(spool_dir: str) -> List[Dict[str, Any]]:
    """Read every complete spool in ``spool_dir``, sorted by process
    identity. Torn/corrupt files are skipped (the atomic publish makes
    them impossible from this writer, but the directory is shared)."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(spool_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(SPOOL_SUFFIX):
            continue
        try:
            with open(os.path.join(spool_dir, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("spans"), list):
            out.append(doc)
    return out
