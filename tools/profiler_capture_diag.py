"""Which kernels a ``torch.profiler`` capture keeps, by the capturing
process's age and by the captures it made before.

Each case runs in a fresh process on ``cuda:0`` and captures one lowered
workflow call (``LOAD``-free: ``filter(v > 0.25) → select(k, v * w AS z)
→ aggregate by k``, B1 last) after its own preamble:

- ``fresh``: no preamble;
- ``idle``: sleeps ``--idle`` seconds first;
- ``after20``: makes 20 short captures first (a small kernel in each,
  with the warm-up step that ``chip_smoke._trace`` uses);
- ``one_then_idle``: one short capture, then the idle sleep.

Each case captures with the port's ``profile()`` (``how=port``) or a plain
``torch.profiler.profile`` with no schedule (``how=plain``). ``--idle``
takes a comma-separated list: the idling cases run once for each value.
For every capture the script prints one JSON line: the kernel launches
and those whose kernel record is missing
(``chip_smoke.launches_without_kernel``), B1's presence, and ``kernel
ts − launch ts`` over the launches whose kernel was kept (correlation
ids), which shows whether the device's timestamps drift from the host's
window. The Chrome traces are kept under ``--out``
(``fugue_tpu_torch/build/profiler_diag/`` by default).

Run on the card (all cases at once, each in its own process)::

    python3 tools/profiler_capture_diag.py --rows 20000000 --idle 240
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CASES = ["fresh:port", "idle:port", "after20:port", "one_then_idle:port",
         "after20:plain", "one_then_idle:plain", "idle:plain"]


def analyse(path: str) -> dict:
    sys.path.insert(0, ROOT)
    from chip_smoke import launches_without_kernel

    with open(path) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in e.get("name", "")
                and "correlation" in e.get("args", {})}
    kernels = {e["args"].get("correlation"): e for e in xs if e.get("cat") == "kernel"}
    d = [kernels[c]["ts"] - launches[c]["ts"] for c in launches if c in kernels]
    return {**launches_without_kernel(path), "kernels": len(kernels),
            "b1_kernels": sum("binned_" in e.get("name", "") for e in kernels.values()),
            "kernel_minus_launch_us": ({"min": min(d), "max": max(d), "first": d[0],
                                        "median": sorted(d)[len(d) // 2]} if d else None)}


def child(case: str, rows: int, idle: float, out_dir: str) -> None:
    import numpy as np
    import pandas as pd
    import torch
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as tprofile

    sys.path.insert(0, ROOT)
    from fugue_tpu_torch.column import col
    from fugue_tpu_torch.column import functions as ff
    from fugue_tpu_torch.ops import bin_groupby as bg
    from fugue_tpu_torch.parallel.profiler import profile
    from fugue_tpu_torch.torch import TorchExecutionEngine
    from fugue_tpu_torch.workflow import FugueWorkflow

    born = time.monotonic()
    pre, how = case.split(":")
    tag = f"{pre}_{how}" + (f"_{idle:g}s" if "idle" in pre else "")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    rng = np.random.default_rng(0)
    pdf = pd.DataFrame({"k": rng.integers(0, 1000, rows).astype(np.int64),
                        "v": rng.random(rows, dtype=np.float32),
                        "w": rng.random(rows, dtype=np.float32)})
    eng = TorchExecutionEngine(device="cuda", conf={"fugue.tpu.cache.enabled": False})
    tdf = eng.persist(eng.to_df(pdf))

    def call():
        dag = FugueWorkflow()
        (dag.df(tdf).filter(col("v") > 0.25).select(col("k"), (col("v") * col("w")).alias("z"))
         .partition_by("k").aggregate(s=ff.sum(col("z"))).yield_dataframe_as("r"))
        dag.run(eng)
        return dag.yields["r"].result.count()

    call()  # first call outside any capture: build and warm
    torch.cuda.synchronize()
    lines = []

    def short_capture(i: int) -> None:
        x = torch.ones(1 << 20, device="cuda")
        with tprofile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as p:
            (x * 2).sum()
            torch.cuda.synchronize()
            p.step()
            for _ in range(3):
                (x * 3).sum()
            torch.cuda.synchronize()
            p.step()
        path = os.path.join(out_dir, f"{tag}_short{i}.json")
        p.export_chrome_trace(path)
        lines.append({"case": case, "capture": f"short{i}", "age_s": time.monotonic() - born, **analyse(path)})

    if pre == "idle":
        time.sleep(idle)
    elif pre == "after20":
        for i in range(20):
            short_capture(i)
    elif pre == "one_then_idle":
        short_capture(0)
        time.sleep(idle)
    bg.LAUNCHES["bin_sum"] = 0
    d = os.path.join(out_dir, tag)
    os.makedirs(d, exist_ok=True)
    age = time.monotonic() - born
    if how == "port":
        with profile(d):
            call()
    else:
        with tprofile(activities=acts) as p:
            call()
            torch.cuda.synchronize()
        p.export_chrome_trace(os.path.join(d, "plain.json"))
    (name,) = os.listdir(d)
    lines.append({"case": case, "idle_s": idle if "idle" in pre else 0, "capture": "lowered", "age_s": age,
                  "b1_launches": bg.LAUNCHES["bin_sum"], **analyse(os.path.join(d, name))})
    for line in lines:
        print(json.dumps(line), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=20_000_000)
    p.add_argument("--idle", default="240")
    p.add_argument("--case", default=None)
    p.add_argument("--cases", default=",".join(CASES))
    p.add_argument("--out", default=os.path.join(ROOT, "fugue_tpu_torch", "build", "profiler_diag"))
    a = p.parse_args()
    os.makedirs(a.out, exist_ok=True)
    if a.case:
        child(a.case, a.rows, float(a.idle), a.out)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    sys.path.insert(0, ROOT)
    from fugue_tpu_torch.ops import bin_groupby as bg

    x = torch.zeros(1024, device="cuda")  # B1 built once here, before the children start
    bg.bin_sum(torch.zeros(1024, dtype=torch.int32, device="cuda"), x, None, 16)
    runs = [(c, i) for c in a.cases.split(",") for i in (a.idle.split(",") if "idle" in c else ["0"])]
    procs = [subprocess.Popen([sys.executable, __file__, "--case", c, "--rows", str(a.rows),
                               "--idle", i, "--out", a.out]) for c, i in runs]
    rcs = [q.wait() for q in procs]
    print(json.dumps({"rcs": rcs}), flush=True)
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
