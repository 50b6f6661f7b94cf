"""Crash-safe submission journal: a per-replica write-ahead log.

A replica that dies mid-run must not LOSE admitted submissions — the
fleet contract (docs/serving.md "Fleet") is exactly-once *observable*
effect over at-least-once execution. The journal is the at-least-once
half: every admission appends one fsync'd jsonl record (idempotency key,
tenant, priority, cloudpickled dag payload) BEFORE the submission enters
the queue, and completion appends a ``done`` record. On restart the
replica replays its own unfinished entries under their original
idempotency keys; a balancer (:class:`~fugue_tpu_torch.serve.fleet.FleetClient`)
fails a dead replica's submissions over to a survivor the same way. The
cross-replica claim protocol (``cache/store.py``) turns either replay
into a dedup hit instead of a duplicate execution whenever the original
run got far enough to publish.

File format — append-only jsonl, one file per replica
(``<dir>/<replica_id>.jsonl``), records:

- ``{"op": "admit", "sid", "idem", "tenant", "priority", "reserve",
  "dag" (base64 cloudpickle | null), "ts"}``
- ``{"op": "exec", "sid", "key"}`` — this replica became the claim owner
  and is about to execute (the no-double-execution audit reads these)
- ``{"op": "done", "sid", "state"}`` — terminal; replay skips the sid

Appends are atomic at the record level (single ``write`` of one line,
fsync'd); a torn final line — the crash window — is skipped by the
reader, which costs at most the one record whose admission never
completed anyway (the ``serve.journal`` fault site sits exactly there).

Compaction: a WAL only ever
grows, and a long-lived replica's is dominated by records of submissions
that already reached a terminal ``done`` — dead weight for the only
thing the file is FOR (replay). When the file passes
``fugue.tpu.serve.journal.max_bytes`` (checked every few appends, or on
an explicit :meth:`compact`), it is rewritten keeping exactly the
records of sids with NO ``done`` record, fsync'd to a temp file and
atomically published over the original — a crash mid-compaction leaves
the complete old file. ``unfinished()`` is provably identical before and
after (the replay-parity test), and the no-double-exec audit only ever
loses exec/done PAIRS of completed work, which it counts as zero anyway.
"""

import base64
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["SubmissionJournal"]


class SubmissionJournal:
    """Append-only fsync'd WAL of one replica's admitted submissions."""

    # how often the size check runs; a stat per append would be waste
    _COMPACT_CHECK_EVERY = 32

    def __init__(
        self, path: str, replica_id: str, log: Any = None, max_bytes: int = 0
    ):
        self.path = path
        self.replica_id = replica_id
        self.max_bytes = int(max_bytes)
        self._log = log
        self._lock = threading.Lock()
        self._fd: Optional[int] = None
        self._appends = 0
        self._compactions = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    # -- write side ----------------------------------------------------------
    def _append(self, rec: Dict[str, Any]) -> None:
        line = (json.dumps(rec, separators=(",", ":")) + "\n").encode()
        with self._lock:
            if self._fd is None:
                self._fd = os.open(
                    self.path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644
                )
            os.write(self._fd, line)
            os.fsync(self._fd)
            self._appends += 1
            if (
                self.max_bytes > 0
                and self._appends % self._COMPACT_CHECK_EVERY == 0
            ):
                try:
                    over = os.fstat(self._fd).st_size > self.max_bytes
                except OSError:
                    over = False
                if over:
                    self._compact_locked()

    def admit(
        self,
        sid: str,
        idem: Optional[str],
        tenant: str,
        priority: int,
        reserve: int,
        dag: Any,
    ) -> None:
        """Journal an admission. The dag (or factory) is cloudpickled
        best-effort: an unpicklable in-process dag (closing over live
        frames) journals with ``dag=null`` — the admission is still
        audited, it just can't be replayed from this file."""
        payload: Optional[str] = None
        try:
            import cloudpickle

            payload = base64.b64encode(cloudpickle.dumps(dag)).decode()
        except Exception:
            if self._log is not None:
                self._log.warning(
                    "journal: submission %s dag not picklable; journaled "
                    "without a replayable payload",
                    sid,
                )
        self._append(
            {
                "op": "admit",
                "sid": sid,
                "idem": idem,
                "tenant": tenant,
                "priority": int(priority),
                "reserve": int(reserve),
                "dag": payload,
                "ts": time.time(),
            }
        )

    def exec_start(self, sid: str, key: Optional[str]) -> None:
        self._append({"op": "exec", "sid": sid, "key": key})

    def done(self, sid: str, state: str) -> None:
        self._append({"op": "done", "sid": sid, "state": state})

    # -- standing views -------------------------------------------
    # A view registration is durable state, not a one-shot submission: it
    # journals BEFORE the spec becomes visible on the shared store, and
    # unregistration writes the terminal ``done``. The sid carries the
    # registration epoch (``view:<id>@<created_ts>``) so a
    # register→unregister→re-register cycle never aliases: compaction is
    # sid-based, and an aliased sid would let the old registration's
    # ``done`` swallow the new registration's record. The submission
    # replay path never sees these (``unfinished()`` filters on op ==
    # "admit"); :meth:`view_unfinished` is the views-side replay reader.

    @staticmethod
    def view_sid(view_id: str, created_ts: float) -> str:
        return f"view:{view_id}@{created_ts!r}"

    def view_register(self, sid: str, payload: Dict[str, Any]) -> None:
        """WAL a view registration (``payload`` is the wire-safe spec
        dict, factory already base64 cloudpickle)."""
        self._append(
            {"op": "view_register", "sid": sid, "view": payload,
             "ts": time.time()}
        )

    def view_unregister(self, sid: str) -> None:
        self.done(sid, "unregistered")

    def view_unfinished(self) -> List[Dict[str, Any]]:
        """Registration records with no terminal ``done`` — what a
        restarted replica re-publishes to the shared registry. Last
        record per view id wins (a re-register after unregister)."""
        done = set()
        regs: Dict[str, Dict[str, Any]] = {}
        for rec in self.read_records(self.path):
            op = rec.get("op")
            if op == "done":
                done.add(rec.get("sid"))
            elif op == "view_register" and rec.get("sid"):
                vid = (rec.get("view") or {}).get("id")
                if vid:
                    regs[vid] = rec
        return [r for r in regs.values() if r.get("sid") not in done]

    @property
    def appends(self) -> int:
        with self._lock:
            return self._appends

    @property
    def compactions(self) -> int:
        with self._lock:
            return self._compactions

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    # -- compaction ----------------------------------------------------------
    def compact(self) -> int:
        """Rewrite the WAL keeping only records of sids with no terminal
        ``done`` record. Returns how many records were dropped. Replay
        parity: ``unfinished()`` before == after, by construction."""
        with self._lock:
            return self._compact_locked()

    def _compact_locked(self) -> int:
        recs = self.read_records(self.path)
        done = {r.get("sid") for r in recs if r.get("op") == "done"}
        keep = [r for r in recs if r.get("sid") not in done]
        dropped = len(recs) - len(keep)
        if dropped <= 0:
            return 0
        tmp = f"{self.path}.__compact_{os.getpid()}"
        try:
            fd = os.open(tmp, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
            try:
                for r in keep:
                    os.write(
                        fd, (json.dumps(r, separators=(",", ":")) + "\n").encode()
                    )
                os.fsync(fd)
            finally:
                os.close(fd)
            os.replace(tmp, self.path)
        except OSError as ex:
            # a failed compaction must never lose the WAL: the original
            # file is untouched until the atomic rename
            try:
                os.remove(tmp)
            except OSError:
                pass
            if self._log is not None:
                self._log.warning("journal compaction of %s failed: %s", self.path, ex)
            return 0
        # the old fd points at the unlinked pre-compaction inode: reopen
        # so later appends land in the compacted file
        if self._fd is not None:
            os.close(self._fd)
            self._fd = os.open(
                self.path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644
            )
        self._compactions += 1
        if self._log is not None:
            self._log.info(
                "journal %s compacted: %d record(s) of finished submissions "
                "dropped, %d kept",
                os.path.basename(self.path),
                dropped,
                len(keep),
            )
        return dropped

    # -- read side -----------------------------------------------------------
    @staticmethod
    def read_records(path: str) -> List[Dict[str, Any]]:
        """Every parseable record in ``path`` (a torn trailing line —
        the crash window — is skipped)."""
        out: List[Dict[str, Any]] = []
        try:
            with open(path, "rb") as f:
                for raw in f:
                    try:
                        out.append(json.loads(raw.decode()))
                    except Exception:
                        continue
        except FileNotFoundError:
            pass
        return out

    def unfinished(self) -> List[Dict[str, Any]]:
        """This replica's admitted-but-not-done records, in admission
        order — what a restart replays."""
        done = set()
        admits: List[Dict[str, Any]] = []
        for rec in self.read_records(self.path):
            op = rec.get("op")
            if op == "done":
                done.add(rec.get("sid"))
            elif op == "admit":
                admits.append(rec)
        return [r for r in admits if r.get("sid") not in done]

    def decode_dag(self, rec: Dict[str, Any]) -> Optional[Any]:
        payload = rec.get("dag")
        if not payload:
            return None
        try:
            import cloudpickle

            return cloudpickle.loads(base64.b64decode(payload))
        except Exception:
            if self._log is not None:
                self._log.warning(
                    "journal: replay of %s skipped (payload undecodable)",
                    rec.get("sid"),
                )
            return None
