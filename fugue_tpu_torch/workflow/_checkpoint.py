"""Checkpoints, copied from ``fugue_tpu/workflow/_checkpoint.py``: weak
(the engine's ``persist``), strong (saved and loaded back) and
deterministic (a uuid-keyed permanent file, or table, that a later run
loads instead of computing: resume), and ``CheckpointPath``, the
temporary and permanent directories under
``fugue.workflow.checkpoint.path``.

A strong checkpoint writes to a temporary name and renames it into place,
so a reader never sees a half-written file. The engine's fault plan fires
at ``checkpoint.save`` between the two (reference :171-179): a fault there
leaves no file at the final path."""

import os
import shutil
import uuid as _uuid
from typing import Any, Optional

from .._utils.assertion import assert_or_throw
from ..collections.partition import PartitionSpec
from ..collections.yielded import PhysicalYielded
from ..constants import FUGUE_CONF_WORKFLOW_CHECKPOINT_PATH
from ..dataframe import DataFrame
from ..exceptions import FugueWorkflowCompileError, FugueWorkflowRuntimeError
from ..execution.execution_engine import ExecutionEngine
from ..resilience import SITE_CHECKPOINT_SAVE, FaultInjector


def _atomic_publish(tmp: str, final: str) -> None:
    """Atomically move a finished write into place. ``tmp`` may be a single
    parquet file or a partitioned directory; same-directory rename is atomic
    on POSIX for both, so a checkpoint is either absent or complete."""
    if os.path.isdir(tmp):
        if os.path.isdir(final):
            shutil.rmtree(final)
        elif os.path.exists(final):
            os.remove(final)
        os.rename(tmp, final)
    else:
        os.replace(tmp, final)


def _best_effort_remove(p: str) -> None:
    try:
        if os.path.isdir(p):
            shutil.rmtree(p)
        else:
            os.remove(p)
    except OSError:  # pragma: no cover - cleanup only
        pass


class Checkpoint:
    """No-op checkpoint base."""

    def __init__(
        self,
        to_file: bool = False,
        deterministic: bool = False,
        permanent: bool = False,
        lazy: bool = False,
        **kwargs: Any,
    ):
        self.to_file = to_file
        self.deterministic = deterministic
        self.permanent = permanent
        self.lazy = lazy
        self.kwargs = dict(kwargs)
        self.yielded: Optional[PhysicalYielded] = None

    @property
    def is_null(self) -> bool:
        return True

    def run(self, df: DataFrame, path: "CheckpointPath") -> DataFrame:
        return df

    def exists(self, path: "CheckpointPath", tid: str) -> bool:
        return False


class WeakCheckpoint(Checkpoint):
    """Engine persist/cache (reference ``:38``)."""

    def __init__(self, lazy: bool = False, **kwargs: Any):
        super().__init__(to_file=False, deterministic=False, permanent=False, lazy=lazy, **kwargs)

    @property
    def is_null(self) -> bool:
        return False

    def run(self, df: DataFrame, path: "CheckpointPath") -> DataFrame:
        return path.execution_engine.persist(df, lazy=self.lazy, **self.kwargs)


class StrongCheckpoint(Checkpoint):
    """Save to storage and reload (reference ``:111``); with
    ``deterministic=True`` + permanent path this is cross-run resume."""

    def __init__(
        self,
        storage_type: str = "file",
        deterministic: bool = False,
        permanent: bool = False,
        lazy: bool = False,
        partition: Any = None,
        single: bool = False,
        namespace: Any = None,
        **kwargs: Any,
    ):
        super().__init__(
            to_file=True,
            deterministic=deterministic,
            permanent=permanent or deterministic,
            lazy=lazy,
            **kwargs,
        )
        assert_or_throw(
            storage_type in ("file", "table"),
            FugueWorkflowCompileError(f"invalid storage type {storage_type}"),
        )
        self.storage_type = storage_type
        self.partition = None if partition is None else PartitionSpec(partition)
        self.single = single
        self.namespace = namespace
        self._tid = ""

    @property
    def is_null(self) -> bool:
        return False

    def set_id(self, tid: str) -> None:
        from .._utils.hash import to_uuid

        self._tid = to_uuid(tid, self.namespace) if self.namespace is not None else tid

    def _file_path(self, path: "CheckpointPath") -> str:
        base = path.permanent_path if self.permanent else path.temp_path
        return os.path.join(base, self._tid + ".parquet")

    def _table_name(self) -> str:
        return "tbl_" + self._tid.replace("-", "")

    def exists(self, path: "CheckpointPath", tid: str) -> bool:
        if not self.deterministic:
            return False
        self.set_id(tid)
        if self.storage_type == "file":
            return os.path.exists(self._file_path(path))
        try:
            return path.execution_engine.sql_engine.table_exists(self._table_name())
        except Exception:  # engines without table support can't resume
            return False

    def run(self, df: DataFrame, path: "CheckpointPath") -> DataFrame:
        engine = path.execution_engine
        fp = self._file_path(path)
        if self.storage_type == "file":
            if not (self.deterministic and os.path.exists(fp)):
                # write to a temp name and atomically publish: an
                # interrupted write must never leave a torn file at the
                # final path, or a later run's exists() would resume from
                # corrupt data
                tmp = f"{fp}.__tmp_{_uuid.uuid4().hex}"
                try:
                    engine.save_df(
                        df,
                        tmp,
                        format_hint="parquet",
                        mode="overwrite",
                        partition_spec=self.partition,
                        force_single=self.single,
                        **self.kwargs,
                    )
                    # between the write and the publish: a fault here shows
                    # that a torn checkpoint is never read as one
                    FaultInjector.from_conf(engine.conf).fire(SITE_CHECKPOINT_SAVE)
                    _atomic_publish(tmp, fp)
                finally:
                    if os.path.exists(tmp):  # failed before publish
                        _best_effort_remove(tmp)
            res = engine.load_df(fp, format_hint="parquet")
        else:
            table = self._table_name()
            if not (self.deterministic and engine.sql_engine.table_exists(table)):
                engine.sql_engine.save_table(df, table, **self.kwargs)
            res = engine.sql_engine.load_table(table)
        if self.yielded is not None:
            self.yielded.set_value(fp if self.storage_type == "file" else table)
        return res

    def load(self, path: "CheckpointPath") -> DataFrame:
        if self.storage_type == "table":
            table = self._table_name()
            res = path.execution_engine.sql_engine.load_table(table)
            if self.yielded is not None:
                self.yielded.set_value(table)
            return res
        fp = self._file_path(path)
        res = path.execution_engine.load_df(fp, format_hint="parquet")
        if self.yielded is not None:
            self.yielded.set_value(fp)
        return res


class CheckpointPath:
    """Temp/permanent checkpoint directory lifecycle (reference ``:131``)."""

    def __init__(self, engine: ExecutionEngine, conf: Any = None):
        # conf: the run-scoped merge when built by a workflow run — a
        # workflow-level checkpoint path must keep working now that
        # workflow conf no longer writes through to the engine
        self._engine = engine
        self._conf_path = (conf if conf is not None else engine.conf).get(
            FUGUE_CONF_WORKFLOW_CHECKPOINT_PATH, ""
        )
        self._temp_path = ""
        self._execution_id = ""

    @property
    def execution_engine(self) -> ExecutionEngine:
        return self._engine

    @property
    def permanent_path(self) -> str:
        assert_or_throw(
            self._conf_path != "",
            FugueWorkflowRuntimeError(
                f"{FUGUE_CONF_WORKFLOW_CHECKPOINT_PATH} is not set"
            ),
        )
        os.makedirs(self._conf_path, exist_ok=True)
        return self._conf_path

    @property
    def temp_path(self) -> str:
        assert_or_throw(
            self._temp_path != "",
            FugueWorkflowRuntimeError("temp checkpoint path is not initialized"),
        )
        return self._temp_path

    def init_temp_path(self, execution_id: str) -> str:
        # like the reference, file checkpoints REQUIRE the conf path; the
        # error surfaces when a checkpoint accesses temp_path during run
        if self._conf_path == "":
            self._temp_path = ""
            return ""
        self._execution_id = execution_id
        self._temp_path = os.path.join(self._conf_path, execution_id)
        os.makedirs(self._temp_path, exist_ok=True)
        return self._temp_path

    def remove_temp_path(self) -> None:
        if self._temp_path != "":
            try:
                shutil.rmtree(self._temp_path)
            except Exception:  # pragma: no cover - best effort cleanup
                pass
