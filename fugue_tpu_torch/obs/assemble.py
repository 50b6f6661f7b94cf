"""Cluster trace assembler: merge per-process span spools into
ONE Perfetto-loadable Chrome trace.

Input: a spool directory written by :func:`~fugue_tpu_torch.obs.spool.publish_spool`
(one file per remote process) plus, optionally, the local driver buffer.
Output: one trace file where

- every process gets its own **named track** ("fugue-tpu driver",
  "fugue-tpu worker <host>-<pid>", ...) under a **synthetic pid** — raw
  OS pids can collide across hosts, so track pids are remapped to a dense
  1..N ordering with the driver first;
- spans are **deduplicated by (process identity, span id)**: the driver's
  buffer may already hold worker spans ingested from done records, and
  those same spans appear in the worker's spool;
- each remote process's resource-sampler ring renders as counter tracks
  (``device_bytes``, ``host_rss_bytes``, ...) on that process's track —
  not only the local ring.

All span timestamps are ``perf_counter_ns`` — comparable across forked
processes of ONE host. Cross-host spools still merge into one file (ids
cannot collide — they are host+pid-prefixed), but their clocks are only
aligned per host.
"""

import json
import os
from typing import Any, Dict, List, Optional

from .export import to_chrome_trace, validate_chrome_trace
from .spool import read_spools
from .tracer import proc_ident

__all__ = ["assemble_trace"]


def assemble_trace(
    spool_dir: str,
    out_path: str,
    include_local: bool = True,
    local_records: Optional[List[Dict[str, Any]]] = None,
    local_counters: Optional[List[Any]] = None,
    trace_id: Optional[str] = None,
) -> Dict[str, Any]:
    """Merge every spool in ``spool_dir`` (plus the local tracer buffer
    unless ``include_local=False``) into one validated Chrome trace at
    ``out_path``. ``trace_id`` keeps only spans of that trace (counter
    tracks are kept regardless — resource curves have no trace identity).
    Returns the ``validate_chrome_trace`` summary extended with the
    per-process breakdown and the set of trace ids seen."""
    sources: List[Dict[str, Any]] = []
    if include_local:
        if local_records is None:
            from .tracer import get_tracer

            local_records = get_tracer().records()
        if local_counters is None:
            from .sampler import get_sampler

            local_counters = get_sampler().series()
        sources.append(
            {
                "proc": proc_ident(),
                "label": "driver",
                "spans": local_records,
                "counters": local_counters,
            }
        )
    local_proc = proc_ident() if include_local else None
    for doc in read_spools(spool_dir):
        if doc.get("proc") == local_proc:
            continue  # local buffer already included (and is fresher)
        sources.append(doc)

    # spans may appear in two sources (worker spool + driver ingest of the
    # done-record copy): first occurrence wins, keyed by process identity +
    # span id — exactly the pair validate_chrome_trace proves unique
    seen: set = set()
    merged: List[Dict[str, Any]] = []
    by_proc_spans: Dict[str, int] = {}
    traces: set = set()
    pid_of_proc: Dict[str, int] = {}

    def _proc_of(rec: Dict[str, Any], source_proc: str) -> str:
        return str(rec.get("proc") or rec.get("pid") or source_proc)

    ordered_procs: List[str] = []
    for src in sources:
        sproc = str(src.get("proc") or "unknown")
        for rec in src.get("spans", []):
            if not isinstance(rec, dict) or "id" not in rec:
                continue
            p = _proc_of(rec, sproc)
            key = (p, rec["id"])
            if key in seen:
                continue
            seen.add(key)
            if trace_id is not None and rec.get("trace") != trace_id:
                continue
            if p not in pid_of_proc:
                pid_of_proc[p] = len(pid_of_proc) + 1
                ordered_procs.append(p)
            merged.append(dict(rec, pid=pid_of_proc[p]))
            by_proc_spans[p] = by_proc_spans.get(p, 0) + 1
            if rec.get("trace"):
                traces.add(rec["trace"])

    counter_tracks: Dict[int, Any] = {}
    process_names: Dict[int, str] = {}
    for src in sources:
        sproc = str(src.get("proc") or "unknown")
        if sproc not in pid_of_proc:
            if not src.get("counters"):
                continue
            pid_of_proc[sproc] = len(pid_of_proc) + 1
            ordered_procs.append(sproc)
        spid = pid_of_proc[sproc]
        label = src.get("label") or "worker"
        process_names[spid] = (
            "fugue-tpu driver" if label == "driver" else f"fugue-tpu {label} {sproc}"
        )
        series = [(ts, vals) for ts, vals in src.get("counters", [])]
        if series:
            counter_tracks[spid] = series

    doc = to_chrome_trace(
        merged,
        counters=None,
        counter_tracks=counter_tracks,
        process_names=process_names,
    )
    d = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(d, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)

    summary = validate_chrome_trace(out_path)
    summary["path"] = out_path
    summary["processes"] = len(ordered_procs)
    summary["process_spans"] = {p: by_proc_spans.get(p, 0) for p in ordered_procs}
    summary["process_names"] = {
        p: process_names.get(pid_of_proc[p], "") for p in ordered_procs
    }
    summary["traces"] = sorted(traces)
    return summary
