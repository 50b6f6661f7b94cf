"""Where a config #2 call on ``sqlite_torch`` spends the time that the
warehouse's steps do not cover.

Writes config #2's frame (``chip_smoke.sql_pipeline_frame``) to parquet in
a temporary directory of the checkout, then runs
``chip_smoke.sql_pipeline_text`` on one ``WarehouseTorchExecutionEngine``
with the result cache off: ``--traced`` calls with the tracer on, each
printed as one JSON line with its wall time, its split
(``chip_smoke.wh_split``, the steps of ``chip_smoke.WH_STEPS`` and
``other``) and its longest spans; then one call under ``cProfile``, whose
functions by cumulative and by own time are printed after it. The
directory is removed at the end.

Run on the card from the repository root::

    python3 tools/warehouse_split_probe.py --rows 4000000

``--device cpu`` runs it on the CPU (with a small ``--rows``).
"""

import argparse
import cProfile
import io
import json
import pstats
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=4_000_000)
    ap.add_argument("--traced", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args()

    import numpy as np
    import pandas as pd
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    import chip_smoke
    from fugue_tpu_torch import api
    from fugue_tpu_torch.obs import get_tracer
    from fugue_tpu_torch.warehouse import WarehouseTorchExecutionEngine

    device = torch.device(args.device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize()

    def rescale(df: pd.DataFrame) -> pd.DataFrame:
        df["s"] = df["s"] / df["s"].max()
        return df

    tmp = Path(tempfile.mkdtemp(prefix=".warehouse_probe_", dir=ROOT))
    try:
        path = str(tmp / "config2.parquet")
        pdf = chip_smoke.sql_pipeline_frame(np, pd, args.rows)
        pq.write_table(pa.Table.from_pandas(pdf, preserve_index=False), path)
        del pdf
        text = chip_smoke.sql_pipeline_text(path)
        eng = WarehouseTorchExecutionEngine(chip_smoke.NO_CACHE, device=device)
        tracer = get_tracer()
        for i in range(args.traced):
            tracer.clear()
            tracer.enable()
            try:
                t0 = time.perf_counter()
                res = api.fugue_sql(text, rescale=rescale, engine=eng, as_fugue=True)
                sync()
                wall_ms = (time.perf_counter() - t0) * 1e3
            finally:
                tracer.disable()
            recs = tracer.records()
            tracer.clear()
            longest = sorted(((r["dur"] / 1e6, r["name"]) for r in recs), reverse=True)[:12]
            print(json.dumps({"call": i, "rows": args.rows, "wall_ms": wall_ms, "spans": len(recs),
                              **chip_smoke.wh_split(recs, wall_ms), "longest_spans_ms": longest}), flush=True)
            del res, recs
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        res = api.fugue_sql(text, rescale=rescale, engine=eng, as_fugue=True)
        sync()
        prof.disable()
        print(json.dumps({"call": "profiled", "wall_ms": (time.perf_counter() - t0) * 1e3}), flush=True)
        del res
        for key in ("cumulative", "tottime"):
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats(key).print_stats(args.top)
            print(out.getvalue())
        eng.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
