"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>-<hash>.so`` for Hopper (``sm_90a``). The hash covers
the source and the compiler flags, so an edited source rebuilds and an
unchanged one is loaded from the build directory. Nothing here runs when the
module is imported: a kernel is built at its first use, or ahead of time by
:func:`build_all`, which starts one ``nvcc`` for each source, all at once.
``ptxas``'s report of each kernel's registers, shared memory and spills is
kept beside the library (``.log``) and read by :func:`kernel_resources`.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is not None:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME")


def sources() -> List[str]:
    """The names of the port's CUDA sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def _start(name: str) -> "Tuple[subprocess.Popen[bytes], Path]":
    """Start ``nvcc`` on ``csrc/<name>.cu``, writing to a temporary file."""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp


def _finish(name: str, proc: "subprocess.Popen[bytes]", tmp: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log.decode(errors='replace')}")
    log_path(name).write_bytes(log)  # before the library: a library has its log
    # atomic: a concurrent loader sees no library or the whole of it
    os.replace(tmp, library_path(name))


def build_all() -> float:
    """Build every source that has no library for its current hash, one
    ``nvcc`` per source, all started together. Returns the seconds taken."""
    t0 = time.perf_counter()
    with _LOCK:
        procs = {n: _start(n) for n in sources() if not library_path(n).exists()}
        for n, (p, tmp) in procs.items():
            _finish(n, p, tmp)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            path = library_path(name)
            if not path.exists():
                _finish(name, *_start(name))
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_TEMPLATE = re.compile(r"\d([a-z_]+)ILb([01])E")


def _kernel_name(mangled: str) -> str:
    """``binned_global<true>`` for the mangled name of that instance."""
    m = _TEMPLATE.search(mangled)
    if m is None:
        return mangled
    return f"{m.group(1)}<{'true' if m.group(2) == '1' else 'false'}>"


def parse_ptxas(log: str) -> List[Dict[str, object]]:
    """Each kernel's registers, static shared memory and spill bytes, from
    ``nvcc -Xptxas -v`` output (one entry per ``Compiling entry function``)."""
    out: List[Dict[str, object]] = []
    cur: Optional[Dict[str, object]] = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m is not None:
            cur = {"kernel": _kernel_name(m.group(1)), "registers": None, "smem_bytes": 0,
                   "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _SPILLS.search(line)
        if m is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = _REGS.search(line)
        if m is not None:
            cur["registers"] = int(m.group(1))
            sm = _SMEM.search(line)
            cur["smem_bytes"] = int(sm.group(1)) if sm is not None else 0
    return out


def kernel_resources(name: str) -> List[Dict[str, object]]:
    """``ptxas``'s report for each kernel of ``csrc/<name>.cu``, built first
    if needed. Static shared memory only: the kernels' tables are dynamic."""
    load(name)
    return parse_ptxas(log_path(name).read_text(errors="replace"))
