"""Fleet-wide view registry: durable specs + generation heads on the
shared store.

Layout, under ``<store_root>/views/``:

- ``<id>.view.json`` — the registration spec (tenant, watched source,
  format, base64-cloudpickled factory, creation epoch). Atomically
  published; its presence IS the registration, fleet-wide — every
  replica's maintainer loop discovers specs by scanning this directory,
  and every replica can serve the view.
- ``<id>.head.json`` — the monotonically versioned generation head:
  generation number, ``as_of`` (the source-observation wall-clock the
  generation reflects), the fleet result key holding the frames, the
  source tokens the generation was built from, and the refresh mode.
  Atomically replaced by the maintainer on every publish.
- ``<id>.tombstone.json`` — an unregistration marker. Registration WALs
  through the registering replica's fsync'd submission journal BEFORE
  the spec publish (the ``view.register`` fault site sits exactly in
  that window), so a replica SIGKILLed mid-register re-publishes the
  spec from its own WAL on restart. But the WAL is per-replica: a view
  registered on replica A and unregistered via replica B leaves A's WAL
  record unfinished forever, and A's replay would RESURRECT the view.
  The tombstone closes that hole — replay skips (and journals done for)
  any record older than a standing tombstone; a genuine re-registration
  clears it.

The registry never runs workflows and never takes leases — it is the
durable-state half of the subsystem; :class:`~fugue_tpu_torch.views.maintainer.
ViewMaintainer` is the active half.
"""

import base64
import json
import os
import re
import time
from typing import Any, Dict, List, Optional

from ..obs.events import get_event_log
from ..resilience.fault import SITE_VIEW_REGISTER
from ..workflow._checkpoint import _atomic_publish, _best_effort_remove
from ..workflow.factory import validate_view_factory

__all__ = ["ViewSpec", "ViewRegistry", "VIEWS_SUBDIR"]

VIEWS_SUBDIR = "views"
_SPEC_SUFFIX = ".view.json"
_HEAD_SUFFIX = ".head.json"
_TOMB_SUFFIX = ".tombstone.json"

# filename-safe, and no "--": the fleet result key grammar
# (view--<id>--g<gen>) must parse back unambiguously
_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.\-]{0,63}$")


class ViewSpec:
    """One registered view, as serialized in ``<id>.view.json``."""

    __slots__ = ("id", "tenant", "source", "fmt", "factory_b64", "created_ts")

    def __init__(
        self,
        view_id: str,
        tenant: str,
        source: str,
        fmt: str,
        factory_b64: str,
        created_ts: float,
    ):
        self.id = view_id
        self.tenant = tenant
        self.source = source
        self.fmt = fmt
        self.factory_b64 = factory_b64
        self.created_ts = float(created_ts)

    @property
    def sid(self) -> str:
        """The WAL sid of this registration epoch."""
        from ..serve.journal import SubmissionJournal

        return SubmissionJournal.view_sid(self.id, self.created_ts)

    def build_factory(self) -> Any:
        import cloudpickle

        return cloudpickle.loads(base64.b64decode(self.factory_b64))

    def to_payload(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "tenant": self.tenant,
            "source": self.source,
            "format": self.fmt,
            "factory": self.factory_b64,
            "created_ts": self.created_ts,
        }

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]) -> "ViewSpec":
        return cls(
            str(payload["id"]),
            str(payload.get("tenant", "default")),
            str(payload["source"]),
            str(payload.get("format", "")),
            str(payload["factory"]),
            float(payload.get("created_ts", 0.0)),
        )


class ViewRegistry:
    def __init__(
        self,
        store_root: str,
        journal: Any = None,
        stats: Any = None,
        injector: Any = None,
        log: Any = None,
        max_views: int = 64,
    ):
        self.dir = os.path.join(store_root, VIEWS_SUBDIR)
        self._journal = journal
        self._stats = stats
        self._injector = injector
        self._log = log
        self.max_views = int(max_views)

    # -- json-on-shared-disk plumbing ----------------------------------------
    def _path(self, view_id: str, suffix: str) -> str:
        return os.path.join(self.dir, view_id + suffix)

    def _write_json(self, path: str, payload: Dict[str, Any]) -> None:
        os.makedirs(self.dir, exist_ok=True)
        tmp = f"{path}.__tmp_{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True)
        _atomic_publish(tmp, path)

    @staticmethod
    def _read_json(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- registration --------------------------------------------------------
    def register(
        self,
        view_id: str,
        tenant: str,
        source: str,
        fmt: str,
        factory: Any,
    ) -> ViewSpec:
        """Durably register a standing view. WAL first, spec publish
        second — the crash between them is exactly what :meth:`replay`
        covers. Re-registering an identical (tenant, source, format) is
        idempotent; a conflicting re-use of a live id raises."""
        if not _ID_RE.match(view_id or "") or "--" in view_id:
            raise ValueError(
                f"invalid view id {view_id!r}: need filename-safe "
                f"[A-Za-z0-9_.-], <= 64 chars, no '--'"
            )
        existing = self.get(view_id)
        if existing is not None:
            if (
                existing.tenant == tenant
                and existing.source == source
                and existing.fmt == (fmt or "")
            ):
                return existing  # idempotent re-register (e.g. a client retry)
            raise ValueError(
                f"view {view_id!r} is already registered by tenant "
                f"{existing.tenant!r} on {existing.source!r}"
            )
        if self.max_views > 0 and len(self.list()) >= self.max_views:
            raise ValueError(
                f"view cap reached ({self.max_views}; fugue.tpu.views.max)"
            )
        validate_view_factory(factory)
        import cloudpickle

        spec = ViewSpec(
            view_id,
            tenant,
            source,
            fmt or "",
            base64.b64encode(cloudpickle.dumps(factory)).decode(),
            time.time(),
        )
        if self._journal is not None:
            self._journal.view_register(spec.sid, spec.to_payload())
        if self._injector is not None:
            self._injector.fire(SITE_VIEW_REGISTER)
        self._publish_spec(spec)
        get_event_log().emit(
            "view.register", view=view_id, tenant=tenant, source=source
        )
        if self._stats is not None:
            self._stats.inc("registered")
        return spec

    def _publish_spec(self, spec: ViewSpec) -> None:
        _best_effort_remove(self._path(spec.id, _TOMB_SUFFIX))
        self._write_json(self._path(spec.id, _SPEC_SUFFIX), spec.to_payload())

    def unregister(self, view_id: str) -> bool:
        """Retire a view: tombstone (so no replica's WAL replay can
        resurrect it), journal the terminal record, drop spec + head.
        Returns False for an unknown id."""
        spec = self.get(view_id)
        if spec is None:
            return False
        self._write_json(
            self._path(view_id, _TOMB_SUFFIX),
            {"id": view_id, "ts": time.time(), "created_ts": spec.created_ts},
        )
        if self._journal is not None:
            self._journal.view_unregister(spec.sid)
        _best_effort_remove(self._path(view_id, _SPEC_SUFFIX))
        _best_effort_remove(self._path(view_id, _HEAD_SUFFIX))
        get_event_log().emit("view.unregister", view=view_id, tenant=spec.tenant)
        if self._stats is not None:
            self._stats.inc("unregistered")
        return True

    def replay(self) -> int:
        """Close the register crash window from this replica's WAL:
        re-publish any journaled registration whose spec never became
        visible. Tombstoned (unregistered-elsewhere) records are closed
        out in this WAL instead. Returns how many specs were restored."""
        if self._journal is None:
            return 0
        restored = 0
        for rec in self._journal.view_unfinished():
            try:
                spec = ViewSpec.from_payload(rec.get("view") or {})
            except (KeyError, TypeError, ValueError):
                continue
            if self.get(spec.id) is not None:
                continue
            tomb = self._read_json(self._path(spec.id, _TOMB_SUFFIX))
            if tomb is not None and float(tomb.get("ts", 0.0)) >= spec.created_ts:
                self._journal.view_unregister(spec.sid)
                continue
            self._publish_spec(spec)
            get_event_log().emit(
                "view.register",
                view=spec.id,
                tenant=spec.tenant,
                source=spec.source,
                replayed=True,
            )
            if self._stats is not None:
                self._stats.inc("registered")
            restored += 1
            if self._log is not None:
                self._log.info(
                    "views: registration of %r replayed from the WAL "
                    "(spec publish never landed)",
                    spec.id,
                )
        return restored

    # -- read side -----------------------------------------------------------
    def get(self, view_id: str) -> Optional[ViewSpec]:
        payload = self._read_json(self._path(view_id, _SPEC_SUFFIX))
        if payload is None:
            return None
        try:
            return ViewSpec.from_payload(payload)
        except (KeyError, TypeError, ValueError):
            return None

    def list(self) -> List[ViewSpec]:
        out: List[ViewSpec] = []
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return out
        for name in names:
            if not name.endswith(_SPEC_SUFFIX):
                continue
            spec = self.get(name[: -len(_SPEC_SUFFIX)])
            if spec is not None:
                out.append(spec)
        return out

    # -- generation heads ----------------------------------------------------
    def head(self, view_id: str) -> Optional[Dict[str, Any]]:
        return self._read_json(self._path(view_id, _HEAD_SUFFIX))

    def publish_head(self, view_id: str, head: Dict[str, Any]) -> None:
        self._write_json(self._path(view_id, _HEAD_SUFFIX), head)
