#!/usr/bin/env python3
"""The controls and planted faults of a cell's check: the readings that set
each limit's upper end. Not part of a benchmark run.

    python3 bench_port/control.py --workload <cell> --seeds S1 S2 S3 [--seconds 5]
        [--controls tf32 fp8] [--faults homography_altered ...]

Each is a whole run of the cell (``lib/harness.py:run_cell``, a window of
``--seconds`` at the cell's own sizes and load, checked as a benchmark run
is), one after another in one process:
- ``tf32``: the program's float32 products in TF32 (the port turns TF32
  off; one precision below the configuration's float32 for the stitch);
- ``fp8``: the configuration's reference model (``reference``, default
  ``reference/yolo.py``) with every convolution's input and weight in
  float8 (e4m3; one precision below the configuration's bf16) in the place
  of the head logits of the detector's class;
- a fault of ``lib/faults.py`` planted under the timed path.
Prints one JSON line a run: whether it came out correct, and each number
compared with its limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", nargs="*", default=["tf32", "fp8"])
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args(argv)
    import run as bench_run

    bench_run._cache_dirs()
    spec = bench_run.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    from bench_port.lib import faults
    from bench_port.lib.harness import run_cell

    runs = [(c, None) for c in args.controls] + [(None, f) for f in args.faults]
    for seed in args.seeds:
        for control, fault in runs:
            patch = faults.Patch()
            if fault:
                faults.FAULTS[fault](patch)
            try:
                res = run_cell(spec, seed, args.seconds, False, "cuda", time.perf_counter(),
                               bench_run.read_metric, bench_run.metrics_of, control=control)
            finally:
                patch.undo()
            print(json.dumps({"workload": args.workload, "seed": seed, "run": control or fault,
                              "correct": res["correct"], "checks": res["checks"],
                              "info": res["info"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
