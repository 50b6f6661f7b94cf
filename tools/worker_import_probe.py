"""Time fresh interpreters importing what a dist worker imports, alone and
several at once, from the repository root: bare Python, ``torch``, the
worker module (no torch), and the worker with the card's stream pipeline
(torch). One JSON line a module list: seconds to start and exit
``--procs`` processes at once, for each count.

    python3 tools/worker_import_probe.py --procs 1 6
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CODES = {
    "python": "pass",
    "torch": "import torch",
    "worker": "import fugue_tpu_torch.dist.worker",
    "worker+torch": "import fugue_tpu_torch.dist.worker, fugue_tpu_torch.torch.pipeline",
}


def wall(code: str, n: int) -> float:
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT) for _ in range(n)]
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(f"{code!r} exited {codes}")
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 6])
    args = ap.parse_args()
    for name, code in CODES.items():
        print(json.dumps({"import": name, "seconds": {n: wall(code, n) for n in args.procs}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
