"""Retry/deadline policy and the failure-category taxonomy.

Distributed dataframe systems treat partition-level fault recovery as
table stakes (arXiv:2209.06146 §5, arXiv:2301.07896 §4): a transient
worker loss must not abort an hour of upstream work. This module is the
policy half of the resilience layer — *what* to do when something fails.
The mechanisms (supervised fork pools, task replay, RPC retry) live at
the call sites in ``execution/parallel_map.py``, ``workflow/`` and
``rpc/http.py``.

Failure taxonomy — every exception maps to exactly one category:

- ``TRANSIENT``  — connection resets/refusals, injected synthetic faults;
  safe to retry anywhere.
- ``TIMEOUT``    — a deadline expired (chunk deadline, socket timeout);
  retryable, the work may simply have been slow.
- ``WORKER_LOST`` — a pool worker died (OOM-kill, SIGKILL, segfault); the
  work unit is intact, only the executor is gone — retry on a fresh pool.
- ``POISON``     — deterministic user-code failure (the same inputs will
  fail the same way); retrying wastes time — degrade to the serial
  in-driver path for a clean traceback, then raise.
- ``FATAL``      — interrupts/exits; never retried, never quarantined.
"""

import enum
import hashlib
import time
from typing import Any, FrozenSet, Optional

__all__ = [
    "FailureCategory",
    "classify_failure",
    "RetryPolicy",
    "Deadline",
    "WorkerLostError",
    "ChunkTimeoutError",
    "InjectedFaultError",
    "ParallelMapError",
]


class FailureCategory(enum.Enum):
    TRANSIENT = "transient"
    TIMEOUT = "timeout"
    WORKER_LOST = "worker_lost"
    POISON = "poison"
    FATAL = "fatal"


class WorkerLostError(RuntimeError):
    """A pool worker process died (OOM-killed, segfaulted, SIGKILLed)
    while its chunk was in flight."""


class ChunkTimeoutError(TimeoutError):
    """A chunk exceeded its per-chunk deadline (``fugue.tpu.map.chunk_timeout``)."""


class InjectedFaultError(RuntimeError):
    """Synthetic error raised by the FaultInjector (always TRANSIENT)."""


class ParallelMapError(RuntimeError):
    """Terminal failure of a parallel map after retries AND the serial
    quarantine path failed. Carries a per-partition failure report."""

    def __init__(self, report: dict):
        self.report = dict(report)
        lines = [
            f"  partition {no}: {err}" for no, err in sorted(self.report.items())
        ]
        super().__init__(
            "parallel map failed after retry and serial fallback on "
            f"{len(self.report)} partition(s):\n" + "\n".join(lines)
        )


_TRANSIENT_TYPES = (
    ConnectionError,  # covers ConnectionRefused/Reset/Aborted, BrokenPipe
    InterruptedError,
)
_FATAL_TYPES = (KeyboardInterrupt, SystemExit, GeneratorExit)


def classify_failure(exc: BaseException) -> FailureCategory:
    """Map an exception to its failure category (see module docstring)."""
    if isinstance(exc, _FATAL_TYPES):
        return FailureCategory.FATAL
    if isinstance(exc, WorkerLostError):
        return FailureCategory.WORKER_LOST
    if isinstance(exc, (ChunkTimeoutError, TimeoutError)):
        return FailureCategory.TIMEOUT
    if isinstance(exc, (InjectedFaultError,) + _TRANSIENT_TYPES):
        return FailureCategory.TRANSIENT
    if isinstance(exc, OSError):
        # EAGAIN/EINTR-style host pressure; pandas/pyarrow raise subclasses
        # for real file errors but those carry filename context and are rare
        # on the in-memory map path — treat the bucket as retry-worthy
        return FailureCategory.TRANSIENT
    return FailureCategory.POISON


_RETRYABLE: FrozenSet[FailureCategory] = frozenset(
    {
        FailureCategory.TRANSIENT,
        FailureCategory.TIMEOUT,
        FailureCategory.WORKER_LOST,
    }
)


class RetryPolicy:
    """Bounded retry with exponential backoff and deterministic jitter.

    ``delay(attempt)`` grows as ``base * multiplier**(attempt-1)`` capped
    at ``max_delay``, plus up to ``jitter`` fraction of that value. The
    jitter is a hash of ``(seed, attempt)`` — deterministic, so tests and
    cross-run debugging see identical schedules, while distinct seeds
    (e.g. chunk ids) de-synchronize retry storms.
    """

    def __init__(
        self,
        max_attempts: int = 3,
        base_delay: float = 0.1,
        multiplier: float = 2.0,
        max_delay: float = 30.0,
        jitter: float = 0.1,
        retry_on: FrozenSet[FailureCategory] = _RETRYABLE,
    ):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = max(0.0, float(base_delay))
        self.multiplier = max(1.0, float(multiplier))
        self.max_delay = max(0.0, float(max_delay))
        self.jitter = max(0.0, float(jitter))
        self.retry_on = frozenset(retry_on)

    @classmethod
    def from_conf(
        cls,
        conf: Any,
        prefix: str = "fugue.tpu.retry",
        default_attempts: int = 3,
    ) -> "RetryPolicy":
        """Build from conf keys ``<prefix>.attempts/base/multiplier/
        max_backoff/jitter``; absent keys use the constructor defaults."""
        return cls(
            max_attempts=int(conf.get(f"{prefix}.attempts", default_attempts)),
            base_delay=float(conf.get(f"{prefix}.base", 0.1)),
            multiplier=float(conf.get(f"{prefix}.multiplier", 2.0)),
            max_delay=float(conf.get(f"{prefix}.max_backoff", 30.0)),
            jitter=float(conf.get(f"{prefix}.jitter", 0.1)),
        )

    def should_retry(self, category: FailureCategory, attempts_done: int) -> bool:
        """True when a unit that has already failed ``attempts_done`` times
        deserves another attempt."""
        return attempts_done < self.max_attempts and category in self.retry_on

    def delay(self, attempt: int, seed: Any = None) -> float:
        """Backoff before attempt ``attempt`` (1-based count of failures)."""
        if self.base_delay <= 0:
            return 0.0
        raw = self.base_delay * (self.multiplier ** max(0, attempt - 1))
        raw = min(raw, self.max_delay)
        if self.jitter > 0:
            h = hashlib.blake2b(
                f"{seed}:{attempt}".encode(), digest_size=8
            ).digest()
            frac = int.from_bytes(h, "big") / float(1 << 64)
            raw += raw * self.jitter * frac
        return min(raw, self.max_delay * (1.0 + self.jitter))


class Deadline:
    """A wall-clock budget; ``Deadline.after(None | 0)`` never expires."""

    def __init__(self, seconds: Optional[float]):
        self._seconds = seconds
        self._t0 = time.monotonic()

    @classmethod
    def after(cls, seconds: Optional[float]) -> "Deadline":
        if seconds is not None and seconds <= 0:
            seconds = None
        return cls(seconds)

    @property
    def unbounded(self) -> bool:
        return self._seconds is None

    @property
    def expired(self) -> bool:
        return (
            self._seconds is not None
            and time.monotonic() - self._t0 > self._seconds
        )

    def remaining(self) -> Optional[float]:
        if self._seconds is None:
            return None
        return max(0.0, self._seconds - (time.monotonic() - self._t0))

    def raise_if_expired(self, what: str = "operation") -> None:
        if self.expired:
            raise ChunkTimeoutError(
                f"{what} exceeded its {self._seconds}s deadline"
            )
