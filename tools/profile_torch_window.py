#!/usr/bin/env python3
"""Where the time of the PyTorch port's window step goes, on one CUDA card.

    python3 tools/profile_torch_window.py [--detector sift|orb] [--windows 2] [--trace trace.json]
    python3 tools/profile_torch_window.py --detect yolov8n|yolo11n [--trace trace.json]

Runs chip_smoke.py's synthetic clip (360x640 frames, 16-frame windows) through
rtvm_tpu_torch's VideMosaic, warms up, times the work without the profiler,
restores the state and traces the same work with torch.profiler.

Without --detect the work is one window (process_window), after a warm-up
window, repeated over --windows windows. With --detect it is one
process_clip call over the clip's 3 windows with det_fn =
ObjectDetector._infer_fn(640, 0.25, 0.45) on the bundled checkpoint of that
model (BASELINE config 3), after one warm-up call; the hoisted detection is
the span clip.detect; the detection alone is also timed without the
profiler, which gives its idle share.

Prints, per unit of work (a window, or the clip): the untraced wall time and
frames/s, the kernels' busy time and the device's idle share of the untraced
wall, the number of kernel launches, the copies between host and card by
direction and the concatenation kernels (torch.cat), the spans
(window.features, window.match_ransac, window.chain, window.paint, and
clip.detect) with their host time and the time, number and card-to-host
copies of the kernels they launched, and the kernels that take the most
device time. The last line is one JSON object with the same numbers;
--trace writes the Chrome trace.
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
    ap.add_argument("--detect", choices=("yolov8n", "yolo11n"), default=None,
                    help="profile one process_clip call of 3 windows with this detector")
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
    n_win = cs.N_WINDOWS if args.detect else 1 + args.windows
    frames, _ = cs.make_clip(np.random.RandomState(cs.SEED), 1 + n_win * cs.WINDOW, cs.FRAME_H,
                             cs.FRAME_W)
    m = VideMosaic(frames[0], detector_type=args.detector, seed=cs.SEED, device="cuda")
    wins = [frames[1 + i * cs.WINDOW : 1 + (i + 1) * cs.WINDOW] for i in range(n_win)]
    if args.detect:
        from rtvm_tpu_torch.detect.detector import ObjectDetector

        path = cs.DETECT_MODELS[args.detect][0]
        det = ObjectDetector(args.detect, weights_path=path, load_world=False, device="cuda")
        det_fn = det._infer_fn(cs.DET_IMGSZ, cs.DET_CONF, cs.DET_IOU)
        clip = torch.as_tensor(np.stack(wins)).cuda()
        snap = m.checkpoint()
        units, unit_frames, unit = 1, n_win * cs.WINDOW, "clip"

        def work():
            m.process_clip(clip, det_fn=det_fn)
    else:
        m.process_window(wins[0])  # warm-up: allocator, cuBLAS handles, kernel library
        torch.cuda.synchronize()
        snap = m.checkpoint()
        units, unit_frames, unit = args.windows, cs.WINDOW, "window"

        def work():
            for w in wins[1:]:
                m.process_window(w)
    if args.detect:
        work()  # warm-up: cuDNN, the bf16 copy of the model
        m.restore(snap)
    torch.cuda.synchronize()

    t0 = time.time()
    work()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / units  # without the profiler
    m.restore(snap)
    detect_wall_ms = None
    if args.detect:  # the hoisted detection alone, on the clip's frames
        flat = clip.reshape((-1,) + clip.shape[2:])
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(3):
            det_fn(flat)
        torch.cuda.synchronize()
        detect_wall_ms = (time.time() - t0) * 1e3 / 3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        work()
        torch.cuda.synchronize()
        traced_ms = (time.time() - t0) * 1e3 / units
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    span_prefixes = ("window.", "clip.")
    # device-side ranges of the spans, and the kernels themselves
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == cuda and e.name.startswith(span_prefixes)]
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith(span_prefixes)]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / units
    spans = {}
    for name in sorted({r[0] for r in ranges}):
        host = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type != cuda and e.name == name) / 1e3 / units
        ivs = [(a, b) for nm, a, b in ranges if nm == name]
        inside = [k for k in kernels if any(a <= k.time_range.start < b for a, b in ivs)]
        spans[name] = {"host_ms": host,
                       "kernel_ms": sum(k.time_range.elapsed_us() for k in inside) / 1e3 / units,
                       "launches": len(inside) / units,
                       "dtoh": sum(1 for k in inside if k.name.startswith("Memcpy DtoH")) / units}
    by_name = {}
    for k in kernels:
        t, c = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.time_range.elapsed_us(), c + 1)
    top_rows = [{"name": nm[:100], "device_ms": t / 1e3 / units, "count": c / units}
                for nm, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]]
    launches = len(kernels) / units
    copies = {kind: sum(1 for k in kernels if k.name.startswith(f"Memcpy {kind}")) / units
              for kind in ("HtoD", "DtoH", "DtoD")}
    cats = sum(1 for k in kernels if "CatArray" in k.name) / units

    what = f"detector {args.detector}" + (f", detection {args.detect}" if args.detect else "")
    print(f"card: {card}; {what}")
    print(f"per {unit} of {unit_frames} frames: wall {wall_ms:.3f} ms "
          f"({unit_frames * 1e3 / wall_ms:.2f} frames/s) untraced, {traced_ms:.3f} ms traced; "
          f"kernels busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f} of the untraced "
          f"wall; {launches:.0f} kernel launches")
    print(f"  copies per {unit} {copies}; concatenation kernels per {unit} {cats:.0f}")
    if detect_wall_ms is not None:
        det_kernel_ms = spans.get("clip.detect", {"kernel_ms": 0.0})["kernel_ms"]
        print(f"  detection alone: wall {detect_wall_ms:.3f} ms untraced, kernels "
              f"{det_kernel_ms:.3f} ms, idle share {1 - det_kernel_ms / detect_wall_ms:.3f}")
    for k, v in spans.items():
        print(f"  {k:20s} host {v['host_ms']:8.3f} ms  kernels {v['kernel_ms']:7.3f} ms  "
              f"launches {v['launches']:6.0f}  card-to-host {v['dtoh']:4.0f}")
    for r in top_rows:
        print(f"  {r['device_ms']:8.3f} ms  x{r['count']:6.1f}  {r['name']}")
    print(json.dumps({"card": card, "detector": args.detector, "detect": args.detect,
                      "unit": unit, "frames_per_unit": unit_frames, "wall_ms": wall_ms,
                      "detect_wall_ms": detect_wall_ms,
                      "traced_wall_ms": traced_ms, "kernel_busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / wall_ms, "launches": launches,
                      "copies": copies, "cat_launches": cats, "spans": spans, "top": top_rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
