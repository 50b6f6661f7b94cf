"""Profiling hooks, the counterpart of ``fugue_tpu/parallel/profiler.py``.

Usage::

    from fugue_tpu_torch.parallel.profiler import profile

    with profile("/tmp/fugue_trace"):
        fa.transform(df, fn, engine="torch")

:func:`profile` is one ``torch.profiler`` capture: host activity, and the
card's kernels and copies when CUDA is available. Its warm-up step, whose
events are dropped, launches ``WARMUP_KERNELS`` small kernels when the
process has initialized CUDA already: a capture
made after earlier ones in a process loses its first kernel records, and
those take the loss. It writes one Chrome
trace (``fugue_profile_<pid>_<ns>.json``) into ``log_dir``, for Perfetto
or ``chrome://tracing``. :func:`annotate` names a region of the timeline
(``torch.profiler.record_function``, where torch is imported).

Conf-driven: setting ``fugue.tpu.profile.dir`` makes
:func:`profiled_engine_context` capture everything inside the context.

The engine names its regions through :func:`annotate`, with the span
tracer's names (``fugue_tpu_torch/obs``): ``plan.segment``, ``engine.join``
and ``engine.fused`` show in a capture whether tracing is on or off. With
``fugue.tpu.trace.enabled`` on, every other engine-verb span
(``engine.<verb>``) enters a range of its name too.
"""

import os
import sys
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Iterator

FUGUE_TPU_CONF_PROFILE_DIR = "fugue.tpu.profile.dir"

# small kernels launched in the capture's warm-up step, whose events the
# capture drops: in a process that captured before, the card's activity
# recording loses the first kernel records of the next capture, more the
# longer since (about 20 after four idle minutes on the H100 with
# PyTorch 2.11 and CUDA 12.8, ``tools/profiler_capture_diag.py``); these
# take the loss in place of the recorded step's kernels
WARMUP_KERNELS = 1024


@contextmanager
def profile(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``log_dir``. Raises
    ``RuntimeError`` inside another capture: a nested one records nothing."""
    import torch
    from torch.profiler import ProfilerActivity, schedule

    if torch._C._autograd._profiler_enabled():
        raise RuntimeError(
            "a torch.profiler capture is already active; profile() does not nest"
        )
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # a warm-up step first: the card's activity recording is set up before
    # the recorded step starts, and the records it loses are the warm-up's
    with torch.profiler.profile(
        activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
    ) as prof:
        # only where the process already uses the card: a capture of host
        # work initializes no CUDA context (a fork pool after it stays safe)
        if torch.cuda.is_initialized():
            x = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))
            for _ in range(WARMUP_KERNELS):
                x.add_(1)
            del x
            torch.cuda.synchronize()
        prof.step()
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.step()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"fugue_profile_{os.getpid()}_{time.time_ns()}.json")
    )


def annotate(name: str) -> Any:
    """Name a region in the trace (``torch.profiler.record_function``;
    shows up in the profiler timeline), a no-op outside a capture and
    where torch is not imported: no capture runs in a process without
    torch, and importing it for a range costs a host process seconds (a
    dist worker, a host engine's workflow)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return nullcontext()
    return torch.profiler.record_function(name)


@contextmanager
def profiled_engine_context(engine: Any = None, conf: Any = None) -> Iterator[Any]:
    """``engine_context`` that captures when the conf sets a profile dir.
    An engine instance keeps its own conf: the dir is read from ``conf``
    first, then from the engine's."""
    from .._utils.params import ParamDict
    from ..execution.api import engine_context
    from ..execution.execution_engine import ExecutionEngine

    given = isinstance(engine, ExecutionEngine)
    with engine_context(engine, None if given else conf) as e:
        log_dir = ParamDict(conf).get(FUGUE_TPU_CONF_PROFILE_DIR, "") if given else ""
        log_dir = log_dir or e.conf.get(FUGUE_TPU_CONF_PROFILE_DIR, "")
        if log_dir == "":
            yield e
        else:
            with profile(log_dir):
                yield e
