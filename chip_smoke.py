#!/usr/bin/env python3
"""Drive the PyTorch port (fugue_tpu_torch) on one CUDA card.

Phases, each printing one JSON line; any failure exits non-zero:

1. device and build: the card's name and power limit, and the seconds the
   port's CUDA sources take to build (one nvcc per source, all at once);
2. kernels against their plain PyTorch versions: every hand kernel on
   2**20 + 37 rows at bucket counts 2 .. 2**18, with skewed keys, invalid
   rows, and inf/NaN rows checked against a float64 numpy oracle;
3. the port's main path at full size: ``api.aggregate`` by one integer key
   with SUM/COUNT/AVG/MIN/MAX of a float32 column over 100,000,000 rows
   (BASELINE.json config #3's scale), once over 1,000 uniform keys and once
   over Zipf(1.1) keys filling the 2**18-bucket table, each checked against
   a float64 oracle on the host; the kernels' launch counts are set to 0
   just before and read just after;
4. times: the aggregate's wall time, and each kernel's time beside its
   bound, its plain version's time and one PyTorch call's time;
5. profile: one aggregate per frame under ``torch.profiler``, for the
   device time by kernel and the device's idle share.

Then a line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.
Run from the repository root: ``python3 chip_smoke.py [--seed 0]`` (``--rows
N`` cuts the main path's frames for a quick try). With no
CUDA device, or outside the repository, it exits non-zero and prints no
result.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3  # kernel vs plain: float32, other order
ORACLE_RTOL = 1e-4  # f32 atomics vs f64 oracle over ~1e5..1e7 rows a group
TIMING_REPS = 10  # medians of 10 timed calls, after a warm-up
KERNEL_BUCKETS = (2, 5, 130, 1024, 12_289, 1 << 18)
REPLACES = {
    "bin_sum": "fugue_tpu/ops/pallas_groupby.py:128 (_sum_kernel, via bin_sum_pallas :175)",
    "bin_sum_count": "fugue_tpu/ops/pallas_groupby.py:85 (_bin_kernel, via bin_sum_count_pallas :183)",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase_device(torch, build_all) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = build_all()
    info = {
        "phase": "device",
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": build_s,
        "allow_tf32": {"matmul": False, "cudnn": False},
    }
    emit(info)
    return info


def _oracle_sums(np, keys, vals, valid, buckets):
    """float64 per-bucket sums and counts, keys clipped as the contract says."""
    k = np.clip(keys, 0, buckets - 1)[valid]
    s = np.bincount(k, weights=vals[valid].astype(np.float64), minlength=buckets)
    c = np.bincount(k, minlength=buckets)
    return s, c


def _same_nonfinite(np, got, exp) -> bool:
    bad = ~np.isfinite(exp)
    return bool(
        (np.isfinite(got) == ~bad).all()
        and (np.isnan(got[bad]) == np.isnan(exp[bad])).all()
        and (got[bad & ~np.isnan(exp)] == exp[bad & ~np.isnan(exp)]).all()
    )


def phase_kernels(torch, np, bg, seed: int, dev) -> dict:
    """Every kernel against its plain version (and float64 oracle)."""
    n = (1 << 20) + 37
    rng = np.random.default_rng(seed)
    err = {"bin_sum": 0.0, "bin_sum_count": 0.0}
    cases = []
    for buckets in KERNEL_BUCKETS:
        for dist in ("uniform", "zipf", "nonfinite"):
            if dist == "zipf":
                keys = ((rng.zipf(1.3, n) - 1) % (buckets + 2)).astype(np.int32)
            else:
                keys = rng.integers(-1, buckets + 1, n).astype(np.int32)  # clipped ends
            vals = rng.random(n, dtype=np.float32)
            valid = rng.random(n) > 0.1
            if dist == "nonfinite":
                rows = rng.choice(n, 6, replace=False)
                vals[rows] = [np.inf, -np.inf, np.nan, np.inf, np.nan, np.nan]
                valid[rows[:4]] = True
                valid[rows[4:]] = False  # NaN in invalid rows adds nothing
            tk, tv, tm = (torch.from_numpy(a).to(dev) for a in (keys, vals, valid))
            s1 = bg.bin_sum(tk, tv, tm, buckets)
            torch.cuda.synchronize()
            s2, c2 = bg.bin_sum_count(tk, tv, tm, buckets)
            torch.cuda.synchronize()
            r1 = bg.bin_sum_ref(tk, tv, tm, buckets)
            r2, rc2 = bg.bin_sum_count_ref(tk, tv, tm, buckets)
            torch.cuda.synchronize()
            s1, s2, c2, r1, r2, rc2 = (x.cpu().numpy() for x in (s1, s2, c2, r1, r2, rc2))
            exp_s, exp_c = _oracle_sums(np, keys, vals, valid, buckets)
            fin = np.isfinite(exp_s)
            for name, got, ref in (("bin_sum", s1, r1), ("bin_sum_count", s2, r2)):
                require(_same_nonfinite(np, got, exp_s), f"{name} b={buckets} {dist}: inf/NaN placement")
                require(_same_nonfinite(np, ref, exp_s), f"{name}_ref b={buckets} {dist}: inf/NaN placement")
                require(
                    np.allclose(got[fin], ref[fin], rtol=SUM_RTOL, atol=SUM_ATOL),
                    f"{name} b={buckets} {dist}: disagrees with its plain version",
                )
                require(
                    np.allclose(got[fin], exp_s[fin], rtol=SUM_RTOL, atol=SUM_ATOL),
                    f"{name} b={buckets} {dist}: disagrees with the float64 oracle",
                )
                if fin.any():
                    err[name] = max(err[name], float(np.abs(got[fin] - ref[fin]).max()))
            require((c2 == rc2).all() and (c2 == exp_c).all(), f"bin_sum_count b={buckets} {dist}: counts")
            require(c2.dtype == np.int32, "counts must be int32")
            cases.append(f"{buckets}/{dist}")
    out = {"phase": "kernels", "rows": n, "cases": cases, "max_abs_err": err,
           "tolerance": {"rtol": SUM_RTOL, "atol": SUM_ATOL}}
    emit(out)
    return out


def _make_frame(np, pd, rng, n: int, dist: str):
    if dist == "uniform":
        k = rng.integers(0, 1000, n, dtype=np.int64)  # bench.py's 1,000 groups
    else:
        k = (rng.zipf(1.1, n) - 1) % 200_000  # fills the 2**18-bucket table
    v = rng.random(n, dtype=np.float32)
    v[rng.random(n) < 0.01] = np.nan  # 1% NULL
    return pd.DataFrame({"k": k.astype(np.int64), "v": v})


def _oracle_agg(np, pd, pdf):
    k = pdf["k"].to_numpy()
    v = pdf["v"].to_numpy()
    nn = ~np.isnan(v)
    rows = np.bincount(k)
    n = np.bincount(k[nn], minlength=len(rows))
    s = np.bincount(k, weights=np.where(nn, v, 0).astype(np.float64), minlength=len(rows))
    keys = np.nonzero(rows > 0)[0]
    mm = pdf.groupby("k")["v"].agg(["min", "max"])
    exp = pd.DataFrame({"k": keys, "n": n[keys]})
    with np.errstate(invalid="ignore", divide="ignore"):
        exp["s"] = np.where(n[keys] > 0, s[keys], np.nan)
        exp["m"] = exp["s"] / np.where(n[keys] > 0, n[keys], np.nan)
    exp["lo"] = mm["min"].reindex(keys).to_numpy()
    exp["hi"] = mm["max"].reindex(keys).to_numpy()
    return exp


def _check_agg(np, got, exp, what: str) -> None:
    require(list(got.columns) == ["k", "s", "n", "m", "lo", "hi"], f"{what}: columns {list(got.columns)}")
    require(len(got) == len(exp), f"{what}: {len(got)} groups, expected {len(exp)}")
    require(np.array_equal(got["k"].to_numpy(), exp["k"].to_numpy()), f"{what}: keys")
    require(np.array_equal(got["n"].to_numpy(), exp["n"].to_numpy()), f"{what}: counts")
    for c in ("lo", "hi"):
        require(np.array_equal(got[c].to_numpy(), exp[c].to_numpy(), equal_nan=True), f"{what}: {c}")
    for c in ("s", "m"):
        g, e = got[c].to_numpy(), exp[c].to_numpy()
        require((np.isnan(g) == np.isnan(e)).all(), f"{what}: NULLs of {c}")
        ok = ~np.isnan(e)
        require(np.isfinite(g[ok]).all(), f"{what}: non-finite {c}")
        require(np.allclose(g[ok], e[ok], rtol=ORACLE_RTOL, atol=0), f"{what}: {c} vs oracle")


def phase_main_path(torch, np, pd, bg, api, ff, col, engine, seed: int, rows: int) -> dict:
    rng = np.random.default_rng(seed)
    frames, oracles = {}, {}
    for dist in ("uniform", "zipf"):
        pdf = _make_frame(np, pd, rng, rows, dist)
        oracles[dist] = _oracle_agg(np, pd, pdf)
        frames[dist] = engine.persist(engine.to_df(pdf))
        del pdf
    aggs = dict(s=ff.sum(col("v")), n=ff.count(col("v")), m=ff.avg(col("v")),
                lo=ff.min(col("v")), hi=ff.max(col("v")))
    for name in bg.LAUNCHES:
        bg.LAUNCHES[name] = 0
    results, per_call, first_s = {}, {}, {}
    for dist, tdf in frames.items():
        before = dict(bg.LAUNCHES)
        t0 = time.perf_counter()
        res = api.aggregate(tdf, partition_by="k", engine=engine, **aggs)
        torch.cuda.synchronize()
        first_s[dist] = time.perf_counter() - t0
        per_call[dist] = {k: bg.LAUNCHES[k] - before[k] for k in bg.LAUNCHES}
        results[dist] = res
    launches = dict(bg.LAUNCHES)
    for dist, res in results.items():
        require(per_call[dist]["bin_sum"] == 1, f"{dist}: bin_sum launched {per_call[dist]['bin_sum']} times, expected 1")
        require(str(res.schema) == "k:long,s:double,n:long,m:double,lo:float,hi:float", f"{dist}: schema {res.schema}")
        _check_agg(np, res.as_pandas(), oracles[dist], dist)
    out = {
        "phase": "main_path",
        "rows": rows,
        "groups": {d: len(o) for d, o in oracles.items()},
        "all_null_groups": {d: int(o["s"].isna().sum()) for d, o in oracles.items()},
        "first_call_s": first_s,
        "launches": launches,
        "launches_per_call": per_call,
        "checks": "keys, counts, min/max, NULLs exact; sum/avg rtol=1e-4 vs float64 oracle",
    }
    emit(out)
    return {"out": out, "frames": frames, "aggs": aggs}


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


def _bound(n: int, row_bytes: int, out_bytes: int) -> tuple:
    """(least ms on the card, what bounds it): each input byte read once,
    each output byte written once, against one float32 add a row."""
    by_bytes = (n * row_bytes + out_bytes) / HBM_BYTES_PER_S
    by_ops = n / F32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def phase_times(torch, api, bg, engine, main: dict) -> dict:
    """Per frame: the aggregate's wall time, and each kernel at the shape
    the dense path gives it, beside its bound, its plain version and one
    PyTorch call. The plain version at 2**18 buckets would touch
    rows x 2**18 one-hot elements, so it is timed on the uniform frame only."""
    reps = TIMING_REPS
    out = {"phase": "times", "reps": reps, "frames": {}}
    for dist, tdf in main["frames"].items():
        n = tdf.count()
        wall = []
        api.aggregate(tdf, partition_by="k", engine=engine, **main["aggs"])
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.aggregate(tdf, partition_by="k", engine=engine, **main["aggs"])
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        agg_s = statistics.median(wall)
        # the kernels' inputs exactly as the dense path builds them
        kmin, kmax = tdf.key_range("k")
        buckets = 1 << (kmax - kmin + 1).bit_length()
        k, v, valid = tdf.device_cols["k"], tdf.device_cols["v"], tdf.device_valid_mask()
        ev = valid & ~torch.isnan(v)
        idx = torch.where(valid, k - kmin, buckets - 1).to(torch.int32)
        masked = torch.where(ev, v, 0.0)
        with_plain = dist == "uniform"
        kernels = []
        for name, run, plain, library, row_bytes, out_bytes in (
            (
                "bin_sum",
                lambda: bg.bin_sum_idx(idx, masked, buckets),
                lambda: bg.bin_sum_ref(idx, masked, None, buckets),
                lambda: torch.zeros(buckets, device=idx.device).index_add_(0, idx, masked),
                8, 4,
            ),
            (
                "bin_sum_count",
                lambda: bg.bin_sum_count(idx, v, ev, buckets),
                lambda: bg.bin_sum_count_ref(idx, v, ev, buckets),
                None,  # no one PyTorch call gives sums and counts together
                9, 8,
            ),
        ):
            bound_ms, bound_by = _bound(n, row_bytes, buckets * out_bytes)
            kernels.append({
                "name": name,
                "ms": _median_ms(torch, run, reps),
                "plain_ms": _median_ms(torch, plain, max(3, reps // 3)) if with_plain else None,
                "library_ms": None if library is None else _median_ms(torch, library, reps),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "shape": {"rows": n, "buckets": buckets},
            })
        # the aggregate reads k (8 B), v (4 B) and the valid mask (1 B) a row
        # and writes six columns and a mask per bucket
        agg_bound_ms, _ = _bound(n, 13, buckets * (8 + 8 + 8 + 8 + 4 + 4 + 1))
        out["frames"][dist] = {
            "aggregate_ms": agg_s * 1e3,
            "aggregate_rows_per_s": n / agg_s,
            "aggregate_bound_ms": agg_bound_ms,
            "kernels": kernels,
        }
    emit(out)
    return out


def phase_profile(torch, api, engine, main: dict) -> dict:
    """One aggregate per frame under ``torch.profiler``: device time by
    kernel, and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    out = {"phase": "profile", "frames": {}}
    for dist, tdf in main["frames"].items():
        api.aggregate(tdf, partition_by="k", engine=engine, **main["aggs"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            api.aggregate(tdf, partition_by="k", engine=engine, **main["aggs"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
        ]
        kernels.sort(key=lambda e: -e.device_time_total)
        busy_ms = sum(e.device_time_total for e in kernels) / 1e3
        out["frames"][dist] = {
            "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms > 0 else None,
            "by_kernel": [
                {"name": e.key[:80], "ms": e.device_time_total / 1e3, "calls": e.count}
                for e in kernels[:12]
            ],
        }
    emit(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=100_000_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    try:
        import numpy as np
        import pandas as pd

        from fugue_tpu_torch import api
        from fugue_tpu_torch.column import col
        from fugue_tpu_torch.column import functions as ff
        from fugue_tpu_torch.ops import bin_groupby as bg
        from fugue_tpu_torch.ops._build import build_all
        from fugue_tpu_torch.torch import TorchExecutionEngine
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 3

    dev = torch.device("cuda", 0)
    phase_device(torch, build_all)
    kern = phase_kernels(torch, np, bg, args.seed, dev)
    engine = TorchExecutionEngine()
    main_path = phase_main_path(torch, np, pd, bg, api, ff, col, engine, args.seed, args.rows)
    times = phase_times(torch, api, bg, engine, main_path)
    phase_profile(torch, api, engine, main_path)

    sources = {"bin_sum": "fugue_tpu_torch/csrc/bin_groupby.cu", "bin_sum_count": "fugue_tpu_torch/csrc/bin_groupby.cu"}
    kernels = []
    for t in times["frames"]["uniform"]["kernels"]:
        name = t["name"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": sources[name],
            "replaces": REPLACES[name],
            "launches": main_path["out"]["launches"][name],
            "on_main_path": name == "bin_sum",
            "max_abs_err": kern["max_abs_err"][name],
            "matched": True,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
