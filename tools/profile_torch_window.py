#!/usr/bin/env python3
"""Where the time of the PyTorch port's window step goes, on one CUDA card.

    python3 tools/profile_torch_window.py [--detector sift|orb] [--windows 2] [--trace trace.json]

Runs chip_smoke.py's synthetic clip (360x640 frames, 16-frame windows) through
rtvm_tpu_torch's VideMosaic, warms up on one window, times the next windows
without the profiler, restores the state and traces the same windows with
torch.profiler. Prints, per window: the untraced wall time and frames/s, the
kernels' busy time and the device's idle share of the untraced wall, the
number of kernel launches, the copies between host and card by direction and
the concatenation kernels (torch.cat), the four stage spans of the step
(window.features, window.match_ransac, window.chain, window.paint) with their
host time and the time and number of the kernels they launched, and the
kernels that take the most device time. The last line is one JSON object with
the same numbers; --trace writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--detector", choices=("sift", "orb"), default="sift")
    ap.add_argument("--windows", type=int, default=2, help="windows traced after the warm-up")
    ap.add_argument("--trace", default=None, help="write the Chrome trace to this path")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_window: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    n = 1 + (1 + args.windows) * cs.WINDOW
    frames, _ = cs.make_clip(np.random.RandomState(cs.SEED), n, cs.FRAME_H, cs.FRAME_W)
    m = VideMosaic(frames[0], detector_type=args.detector, seed=cs.SEED, device="cuda")
    wins = [frames[1 + i * cs.WINDOW : 1 + (i + 1) * cs.WINDOW] for i in range(1 + args.windows)]
    m.process_window(wins[0])  # warm-up: allocator, cuBLAS handles, kernel library
    torch.cuda.synchronize()
    snap = m.checkpoint()

    t0 = time.time()
    for w in wins[1:]:
        m.process_window(w)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / args.windows  # without the profiler
    m.restore(snap)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for w in wins[1:]:
            m.process_window(w)
        torch.cuda.synchronize()
        traced_ms = (time.time() - t0) * 1e3 / args.windows
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    # device-side ranges of the stage spans, and the kernels themselves
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == cuda and e.name.startswith("window.")]
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith("window.")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / args.windows
    spans = {}
    for name in sorted({r[0] for r in ranges}):
        host = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type != cuda and e.name == name) / 1e3 / args.windows
        ivs = [(a, b) for nm, a, b in ranges if nm == name]
        dev = sum(k.time_range.elapsed_us() for k in kernels
                  if any(a <= k.time_range.start < b for a, b in ivs)) / 1e3 / args.windows
        nk = sum(1 for k in kernels if any(a <= k.time_range.start < b for a, b in ivs)) / args.windows
        spans[name] = {"host_ms": host, "kernel_ms": dev, "launches": nk}
    by_name = {}
    for k in kernels:
        t, c = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.time_range.elapsed_us(), c + 1)
    top_rows = [{"name": nm[:100], "device_ms": t / 1e3 / args.windows, "count": c / args.windows}
                for nm, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]]
    launches = len(kernels) / args.windows
    copies = {kind: sum(1 for k in kernels if k.name.startswith(f"Memcpy {kind}")) / args.windows
              for kind in ("HtoD", "DtoH", "DtoD")}
    cats = sum(1 for k in kernels if "CatArray" in k.name) / args.windows

    print(f"card: {card}; detector {args.detector}")
    print(f"per 16-frame window: wall {wall_ms:.3f} ms ({cs.WINDOW * 1e3 / wall_ms:.2f} frames/s) "
          f"untraced, {traced_ms:.3f} ms traced; kernels busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f} of the untraced wall; {launches:.0f} kernel launches")
    print(f"  copies per window {copies}; concatenation kernels per window {cats:.0f}")
    for k, v in spans.items():
        print(f"  {k:20s} host {v['host_ms']:8.3f} ms  kernels {v['kernel_ms']:7.3f} ms  "
              f"launches {v['launches']:6.0f}")
    for r in top_rows:
        print(f"  {r['device_ms']:8.3f} ms  x{r['count']:6.1f}  {r['name']}")
    print(json.dumps({"card": card, "detector": args.detector, "wall_ms": wall_ms, "traced_wall_ms": traced_ms,
                      "kernel_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                      "launches": launches, "copies": copies, "cat_launches": cats,
                      "spans": spans, "top": top_rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
