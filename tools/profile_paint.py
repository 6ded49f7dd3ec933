#!/usr/bin/env python3
"""Where the paint stage's device time goes on the 1080p canvas, on one CUDA card.

    python3 tools/profile_paint.py [--windows 3] [--reps 3]

Builds BASELINE config 5's stitch: 1080x1920 frames of chip_smoke.py's
make_stream_world on an elliptical orbit (168 x 504 px, 12 windows a lap, as
the benchmark's fused mix flies), the canvas sized by the port's pre-scan over
the lap (stride 8), ORB, windows of 16. After --windows windows through
VideMosaic.process_window it takes the next window's frames, H_abs and
blended flags, and replays the parts of mosaic/stitcher.py:paint_band on the
state the window starts from, each alone under torch.profiler: kernel A's
warp, frame_weight_params, frame_weight_eval (kernel D and its plain version,
held bitwise equal), the holes distance, the coarse footprints, the union
distance (kernel C and its plain version, held bitwise equal), the upsample,
the old weight, the blend blur (kernel E and its plain version, held within
1e-6) and the blend loop; then paint_band whole, with kernels C, D and E,
and with the plain union distance, the plain frame weight and the plain
blend blur in their places.

Prints, for each part, the device time of its kernels a window (the sum of
their durations, copies included), its launches and its wall time (CUDA
events, queue included); the last line is one JSON object with the same
numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEMI_AXES = (168.0, 504.0)  # px at 1080p: 0.156 x 0.467 frame heights
PERIOD = 12 * 16  # frames a lap


def orbit(n: int) -> np.ndarray:
    """[n, 2] even (dx, dy) offsets from frame 0 on the lap's ellipse."""
    t = 2.0 * np.pi * np.arange(n) / PERIOD
    off = np.stack([SEMI_AXES[0] * np.sin(t), SEMI_AXES[1] * (np.cos(t) - 1.0)], -1)
    return (2 * np.round(off / 2.0)).astype(np.int64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=3, help="windows stitched before the replay")
    ap.add_argument("--reps", type=int, default=3, help="profiled calls of each part")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_paint: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from rtvm_tpu_torch.config import MosaicConfig
    from rtvm_tpu_torch.mosaic import stitcher as S
    from rtvm_tpu_torch.mosaic.prescan import prescan_canvas
    from rtvm_tpu_torch.ops import warp as W
    from rtvm_tpu_torch.ops.kernel_warp import inverse_maps, warp_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    hf, wf, b = cs.STREAM_H, cs.STREAM_W, cs.WINDOW
    off = orbit(PERIOD)
    x0, y0 = 8 - int(off[:, 0].min()), 8 - int(off[:, 1].min())
    world = cs.make_stream_world(np.random.RandomState(cs.SEED),
                                 hf + int(np.ptp(off[:, 1])) + 16, wf + int(np.ptp(off[:, 0])) + 16)
    frames = np.stack([world[y0 + dy : y0 + dy + hf, x0 + dx : x0 + dx + wf] for dx, dy in off])
    pre = prescan_canvas(iter(frames), (hf, wf), stride=8, device="cuda")
    if pre is None:
        print("profile_paint: the pre-scan could not track the lap", file=sys.stderr)
        return 1
    cfg = MosaicConfig(window_size=b, canvas_hw=pre[0], seed_offset=pre[1])
    m = S.VideMosaic(frames[0], detector_type="orb", config=cfg, seed=cs.SEED, device="cuda")
    wins = [torch.as_tensor(frames[1 + i * b : 1 + (i + 1) * b]).cuda() for i in range(args.windows + 1)]
    for w in wins[:-1]:
        m.process_window(w)
    snap = m.checkpoint()
    aux = m.process_window(wins[-1])
    m.restore(snap)
    st = m.state
    hc, wc = st.canvas.shape[1], st.canvas.shape[2]
    H_abs, blended = aux.H_abs, aux.blended
    frames_cm = wins[-1].to(torch.float32).permute(0, 3, 1, 2).contiguous()

    # the intermediates of paint_band (band = the whole canvas), computed once
    new = warp_batch(frames_cm, inverse_maps(H_abs), hc, wc)
    params = W.frame_weight_params(H_abs, hf, wf, hc, wc)
    wq = W.frame_weight_eval(params, hc, wc)
    wq_plain = W.frame_weight_eval_plain(params, hc, wc)
    same_w = torch.equal(wq.view(torch.int32), wq_plain.view(torch.int32))
    del wq_plain
    wnew = W.frame_weight_with_holes(new, wq)
    wnew = torch.where(blended[:, None, None], wnew, torch.zeros_like(wnew))

    def unions():
        coarse = torch.cat([st.union_coarse[None], W.coarse_footprint(wnew)])
        inc = torch.cumsum(coarse[1:].to(torch.int32), dim=0) > 0
        return torch.cat([coarse[0][None], coarse[0][None] | inc[:-1]], dim=0)

    ub = unions()
    d = W.coarse_union_distance(ub)
    same = torch.equal(d, W.coarse_union_distance_plain(ub))
    ups = W.upsample_weight(d, hc, wc)

    def old_weight():
        cover0 = torch.amax(st.canvas, dim=0) > 0.0
        incc = torch.cumsum((wnew > 0.0).to(torch.int32), dim=0) > 0
        covers = torch.cat([cover0[None], cover0[None] | incc[:-1]], dim=0)
        return torch.where(covers, torch.clamp(ups - W.CELL_PX / 2.0, min=1.0), torch.zeros_like(ups))

    wold = old_weight()
    alpha, beta = W.blend_weights_smoothed(wnew, wold)
    blend_gap = max(float((k - p).abs().max())
                    for k, p in zip((alpha, beta), W.blend_weights_smoothed_plain(wnew, wold)))

    def blend_loop():
        canvas = st.canvas
        for i in range(b):
            canvas = W.blend_apply_cm(canvas, new[i], wnew[i], wold[i], alpha[i], beta[i])
        return canvas

    parts = {
        "warp (kernel A)": lambda: warp_batch(frames_cm, inverse_maps(H_abs), hc, wc),
        "frame_weight_params": lambda: W.frame_weight_params(H_abs, hf, wf, hc, wc),
        "frame_weight_eval (kernel D)": lambda: W.frame_weight_eval(params, hc, wc),
        "frame_weight_eval (plain)": lambda: W.frame_weight_eval_plain(params, hc, wc),
        "holes distance": lambda: W.frame_weight_with_holes(new, wq),
        "footprints": unions,
        "union distance (kernel C)": lambda: W.coarse_union_distance(ub),
        "union distance (plain)": lambda: W.coarse_union_distance_plain(ub),
        "upsample": lambda: W.upsample_weight(d, hc, wc),
        "old weight": old_weight,
        "blend blur (kernel E)": lambda: W.blend_weights_smoothed(wnew, wold),
        "blend blur (plain)": lambda: W.blend_weights_smoothed_plain(wnew, wold),
        "blend loop": blend_loop,
        "paint_band": lambda: S.paint_band(st.canvas, st.union_coarse, frames_cm, H_abs, blended,
                                           (hf, wf), (hc, wc)),
        "paint_band, plain union": lambda: plain_paint("coarse_union_distance"),
        "paint_band, plain weight": lambda: plain_paint("frame_weight_eval"),
        "paint_band, plain blend": lambda: plain_paint("blend_weights_smoothed"),
    }

    def plain_paint(fn: str):
        kernel = getattr(W, fn)
        setattr(W, fn, getattr(W, fn + "_plain"))
        try:
            return parts["paint_band"]()
        finally:
            setattr(W, fn, kernel)

    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        wall = start.elapsed_time(end) / args.reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == cuda]
        out[name] = {"device_ms": sum(e.time_range.elapsed_us() for e in evs) / 1e3 / args.reps,
                     "launches": len(evs) / args.reps, "wall_ms": wall}
        print(f"{name:28s} device {out[name]['device_ms']:9.3f} ms  launches "
              f"{out[name]['launches']:6.0f}  wall {wall:9.3f} ms", flush=True)
    print(f"canvas {hc}x{wc}, union grids {tuple(ub.shape)}, {int(blended.sum())}/{b} blended, "
          f"kernel C bitwise the plain version: {same}, kernel D: {same_w}, kernel E {blend_gap:.3g} "
          f"off it (at most 1e-6); on {card}")
    print(json.dumps({"card": card, "canvas": [hc, wc], "grids": list(ub.shape),
                      "union_bitwise": same, "weight_bitwise": same_w, "blend_gap": blend_gap,
                      "parts": out}))
    return 0 if same and same_w and blend_gap <= 1e-6 else 1


if __name__ == "__main__":
    sys.exit(main())
