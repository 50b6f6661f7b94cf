#!/usr/bin/env python3
"""Time the binned-sum kernels and the dense aggregate of two or more
checkouts of the PyTorch port on one CUDA card, in turns.

Each turn is a fresh process that imports ``fugue_tpu_torch`` from one
checkout, builds its kernels, makes the two 100M-row frames of
``chip_smoke.py`` (uniform-1k and zipf-256k, from ``--seed``) and times, per
frame: B1 (``bin_sum_idx`` on the pre-masked values) and B2
(``bin_sum_count`` on the values and the non-null mask) at the shapes the
dense path gives them, as medians of CUDA-event timings, and
``api.aggregate``'s wall time, as the median of host-clock calls with a
synchronise around each. The checkouts take turns forwards and then
backwards (A, B, B, A for two), so drift on the card falls on both.

Run from the repository root, with another checkout unpacked into a
git-ignored directory::

    git archive <commit> | tar -x -C .smoke_checkout/base
    python3 chip_turns.py .smoke_checkout/base .

It prints one JSON line per turn and, last, a summary by checkout.

``python3 chip_turns.py --atomics`` instead builds and runs
``tools/cuda_atomics_bench.cu``: the rates of the add primitives (shared,
distributed shared and global memory atomics, cluster.sync) that the
kernel's design chooses between.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _median_ms(torch, fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def worker(root: Path, rows: int, seed: int, reps: int) -> dict:
    """One turn: everything timed with the port of checkout ``root``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import pandas as pd
    import torch

    import fugue_tpu_torch
    from fugue_tpu_torch import api
    from fugue_tpu_torch.column import col
    from fugue_tpu_torch.column import functions as ff
    from fugue_tpu_torch.ops import bin_groupby as bg
    from fugue_tpu_torch.ops._build import build_all
    from fugue_tpu_torch.torch import TorchExecutionEngine

    pkg = Path(fugue_tpu_torch.__file__).resolve().parent.parent
    if pkg != root.resolve():
        raise RuntimeError(f"imported fugue_tpu_torch from {pkg}, not {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    build_s = build_all()
    engine = TorchExecutionEngine()
    aggs = dict(s=ff.sum(col("v")), n=ff.count(col("v")), m=ff.avg(col("v")),
                lo=ff.min(col("v")), hi=ff.max(col("v")))
    out = {"root": str(root), "build_s": build_s, "frames": {}}
    for dist, tdf, (idx, masked, vc, ev, buckets) in _frames(np, pd, torch, engine, rows, seed):
        frame = {"buckets": buckets}
        # in turns inside the process too: B1, B2, B2, B1
        b1 = lambda: bg.bin_sum_idx(idx, masked, buckets)  # noqa: E731
        b2 = lambda: bg.bin_sum_count(idx, vc, ev, buckets)  # noqa: E731
        t = [_median_ms(torch, f, reps) for f in (b1, b2, b2, b1)]
        frame["bin_sum_ms"] = [t[0], t[3]]
        frame["bin_sum_count_ms"] = [t[1], t[2]]
        api.aggregate(tdf, partition_by="k", engine=engine, **aggs)
        wall = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.aggregate(tdf, partition_by="k", engine=engine, **aggs)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        frame["aggregate_ms"] = statistics.median(wall)
        frame["aggregate_ms_range"] = [min(wall), max(wall)]
        out["frames"][dist] = frame
    return out


def _frames(np, pd, torch, engine, rows: int, seed: int):
    """The two frames of chip_smoke.py (``_make_frame``) on the card, one at
    a time, with the binned-sum kernels' inputs as the dense path builds
    them: ``(dist, frame, (idx, masked values, values, non-null, buckets))``."""
    rng = np.random.default_rng(seed)
    for dist in ("uniform", "zipf"):
        if dist == "uniform":
            k = rng.integers(0, 1000, rows, dtype=np.int64)
        else:
            k = (rng.zipf(1.1, rows) - 1) % 200_000
        v = rng.random(rows, dtype=np.float32)
        v[rng.random(rows) < 0.01] = np.nan
        tdf = engine.persist(engine.to_df(pd.DataFrame({"k": k.astype(np.int64), "v": v})))
        del k, v
        kmin, kmax = tdf.key_range("k")
        buckets = 1 << (kmax - kmin + 1).bit_length()
        kc, vc, valid = tdf.device_cols["k"], tdf.device_cols["v"], tdf.device_valid_mask()
        ev = valid & ~torch.isnan(vc)
        idx = torch.where(valid, kc - kmin, buckets - 1).to(torch.int32)
        yield dist, tdf, (idx, torch.where(ev, vc, 0.0), vc, ev, buckets)
        del tdf, kc, vc, valid, ev, idx
        torch.cuda.empty_cache()


def plain() -> int:
    """Time each kernel's plain PyTorch version once, at the shape the dense
    path gives it on each frame of chip_smoke.py (which times it at
    uniform-1k only: at 2**18 buckets one call takes minutes)."""
    sys.path.insert(0, str(HERE))
    import numpy as np
    import pandas as pd
    import torch

    from fugue_tpu_torch.ops import bin_groupby as bg
    from fugue_tpu_torch.torch import TorchExecutionEngine

    out = {"nvidia_smi": _smi(), "rows": 100_000_000, "frames": {}}
    for dist, _, (idx, masked, vc, ev, buckets) in _frames(np, pd, torch, TorchExecutionEngine(),
                                                             out["rows"], 0):
        frame = {"buckets": buckets}
        for name, fn in (("bin_sum_plain_ms", lambda: bg.bin_sum_ref(idx, masked, None, buckets)),
                         ("bin_sum_count_plain_ms", lambda: bg.bin_sum_count_ref(idx, vc, ev, buckets))):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            frame[name] = start.elapsed_time(end)
        out["frames"][dist] = frame
        print(json.dumps({dist: frame}), flush=True)
    print(json.dumps(out), flush=True)
    return 0


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def atomics() -> int:
    """Build tools/cuda_atomics_bench.cu into the build directory and run it."""
    sys.path.insert(0, str(HERE))
    from fugue_tpu_torch.ops._build import BUILD, _nvcc

    BUILD.mkdir(parents=True, exist_ok=True)
    exe = BUILD / "cuda_atomics_bench"
    src = HERE / "tools" / "cuda_atomics_bench.cu"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    subprocess.run([_nvcc(), *flags, "-o", str(exe), str(src)], check=True)
    return subprocess.run([str(exe)], timeout=300).returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", help="checkouts of the repository to compare")
    ap.add_argument("--atomics", action="store_true",
                    help="run tools/cuda_atomics_bench.cu instead")
    ap.add_argument("--plain", action="store_true",
                    help="time the plain versions once at both frames' shapes instead")
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.atomics:
        return atomics()
    if args.plain:
        return plain()
    if not args.roots:
        ap.error("give the checkouts to compare")
    if args.worker:
        print(json.dumps(worker(Path(args.roots[0]), args.rows, args.seed, args.reps)), flush=True)
        return 0

    smi = _smi()
    print(smi, flush=True)
    roots = [str(Path(r).resolve()) for r in args.roots]
    order = roots + roots[::-1]
    turns = []
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    for root in order:
        cmd = [sys.executable, str(HERE / "chip_turns.py"), "--worker", root,
               "--rows", str(args.rows), "--seed", str(args.seed), "--reps", str(args.reps)]
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    summary = {"nvidia_smi": smi, "rows": args.rows, "order": order, "by_root": {}}
    for root in roots:
        mine = [t for t in turns if t["root"] == root]
        summary["by_root"][root] = {
            dist: {
                key: sorted(x for t in mine for x in (
                    t["frames"][dist][key] if isinstance(t["frames"][dist][key], list)
                    else [t["frames"][dist][key]]))
                for key in ("bin_sum_ms", "bin_sum_count_ms", "aggregate_ms")
            }
            for dist in ("uniform", "zipf")
        }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
