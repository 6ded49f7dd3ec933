#!/usr/bin/env python3
"""Time two checkouts' kernels A (warp) and B (SIFT patches) on the same inputs, on one card.

    python3 tools/ab_kernels.py --make-inputs .tree_check/ab_inputs.pt
    python3 tools/ab_kernels.py --inputs .tree_check/ab_inputs.pt --tree DIR [--label NAME]
    python3 tools/ab_kernels.py --sift-window --tree DIR [--label NAME]

--make-inputs runs chip_smoke.py's synthetic clip through this checkout's
VideMosaic for one 16-frame window of 360x640 frames and saves that window's
frames, its H_abs, and the patch origins and Gaussian levels that its SIFT
stages produce (one stack per octave; about 60 MB, so write it to a
gitignored scratch directory such as .tree_check/). --tree DIR imports the
rtvm_tpu_torch package of another checkout (the root of an unpacked commit)
and times, on those inputs:
  - warp: the checkout's warp_batch (G = H_abs^-1 on the card) through its
    wrapper (CUDA events over back-to-back calls) and on the card (profiler);
  - patches: the patch cut of one window as that checkout's SIFT does it,
    one extract_patches_octaves call. "kernel" counts only the patch kernels'
    time on the card; "path" is the host-clock time of the whole cut.
Prints one JSON line. Imports torch, numpy and the checkout's package only.

--sift-window times, for the checkout at --tree, the SIFT window step on
chip_smoke.py's clip (this checkout's: 1 + 3 x 16 frames of 360x640
drifting (2, -4) px a frame): six runs of VideMosaic(detector_type="sift")
over the three windows; the first run and each run's first window are left
out, and the median and quartiles of the rest (host clock around a
synchronised process_window) are printed, beside _octave_levels on 16
random 360x640 frames (CUDA events, 50 calls). To compare two checkouts,
run them in turns in one call on one card: parent, change, change, parent.
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


def make_inputs(path: str) -> None:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rtvm_tpu_torch.config import FeatureConfig
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic
    from rtvm_tpu_torch.ops import color
    from rtvm_tpu_torch.ops.features.sift import detect_pyramid

    dev = torch.device("cuda")
    frames, _ = cs.make_clip(np.random.RandomState(cs.SEED), 1 + cs.WINDOW, cs.FRAME_H, cs.FRAME_W)
    m = VideMosaic(frames[0], detector_type="sift", seed=cs.SEED, device=dev)
    aux = m.process_window(frames[1:])
    _, _, stacks, ys, xs, _ = detect_pyramid(color.bgr2gray(torch.as_tensor(frames[1:], device=dev)),
                                             FeatureConfig())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"frames": torch.from_numpy(frames[1:]), "H_abs": aux.H_abs.cpu(),
                "canvas": tuple(m.state.canvas.shape[1:]),
                "stacks": [s.cpu().contiguous() for s in stacks],
                "ys": [y.cpu() for y in ys], "xs": [x.cpu() for x in xs]}, path)
    print(f"inputs: {path}")


def time_tree(path: str, tree: str, label: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from rtvm_tpu_torch import kernels

    from rtvm_tpu_torch.ops import kernel_patches as pp
    from rtvm_tpu_torch.ops.kernel_warp import inverse_maps, warp_batch, warp_plain

    dev = torch.device("cuda")
    d = torch.load(path)
    hc, wc = d["canvas"]
    fr = d["frames"].to(dev).to(torch.float32).permute(0, 3, 1, 2).contiguous()
    G = inverse_maps(d["H_abs"].to(dev)).contiguous()
    # the levels as the SIFT stages hold them: [B, s+3, H, W], levels 1..s stacked
    s = 3
    stacks = []
    for st in d["stacks"]:
        b, r, w = st.shape
        levels = torch.zeros((b, s + 3, r // s, w), device=dev)
        levels[:, 1 : s + 1] = st.to(dev).reshape(b, s, r // s, w)
        stacks.append(levels[:, 1 : s + 1].reshape(b, r, w))
    ys = [y.to(dev) for y in d["ys"]]
    xs = [x.to(dev) for x in d["xs"]]

    def cut():
        return pp.extract_patches_octaves(stacks, ys, xs)

    kernels.library()
    ref = torch.cat([pp.extract_patches_plain(st, y, x) for st, y, x in zip(stacks, ys, xs)], 1)
    same_b = bool(torch.equal(cut(), ref))
    same_a = bool(torch.equal(warp_batch(fr, G, hc, wc), warp_plain(fr, G, hc, wc)))

    def events_ms(fn, reps=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        z.record()
        z.synchronize()
        return a.elapsed_time(z) / reps

    def card_ms(fn, part, reps=20):
        """Time on the card, per call of fn, of the kernels whose name holds `part`."""
        cuda = torch.autograd.DeviceType.CUDA
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == cuda and part in e.name]
        return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / reps, len(evs) / reps

    def host_path_ms(fn, reps=50):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / reps

    warp = lambda: warp_batch(fr, G, hc, wc)  # noqa: E731
    res = {"label": label, "tree": tree, "warp_equal_plain": same_a, "patches_equal_plain": same_b}
    res["warp_wrapper_ms"] = events_ms(warp)
    res["warp_card_ms"], res["warp_launches"] = card_ms(warp, "rtvm_warp")
    res["patches_wrapper_ms"] = events_ms(cut)
    res["patches_card_ms"], res["patches_launches"] = card_ms(cut, "patches")
    res["patches_path_ms"] = host_path_ms(cut)
    res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(res))


def time_window(tree: str, label: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import rtvm_tpu_torch
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic
    from rtvm_tpu_torch.ops.features import sift

    if not os.path.abspath(rtvm_tpu_torch.__file__).startswith(tree):
        raise SystemExit(f"imported {rtvm_tpu_torch.__file__}, not the package under {tree}")
    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    dev = torch.device("cuda")
    h, w = cs.FRAME_H, cs.FRAME_W
    frames, _ = cs.make_clip(np.random.RandomState(cs.SEED), 1 + 3 * cs.WINDOW, h, w)
    wins = [torch.as_tensor(frames[1 + i * cs.WINDOW : 1 + (i + 1) * cs.WINDOW]).to(dev)
            for i in range(3)]
    secs = []
    for rep in range(6):
        m = VideMosaic(frames[0], detector_type="sift", seed=cs.SEED, device=dev)
        for i, win in enumerate(wins):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m.process_window(win)
            torch.cuda.synchronize()
            if rep > 0 and i > 0:
                secs.append(time.perf_counter() - t)
    base = torch.rand(cs.WINDOW, h, w, device=dev)
    s = 3
    sig = np.array([1.6 * 2 ** (lvl / s) for lvl in range(s + 3)], np.float32)
    deltas = np.sqrt(np.maximum(sig**2 - sig[0] ** 2, 0.0))
    levels_ms = cs.cuda_ms(torch, lambda: sift._octave_levels(base, deltas), reps=50)
    q1, med, q3 = (float(np.percentile(secs, p)) * 1e3 for p in (25, 50, 75))
    print(f"{label} {h}x{w}: window median {med:.2f} ms (quartiles {q1:.2f}-{q3:.2f}, "
          f"{len(secs)} windows), _octave_levels {levels_ms:.4f} ms on "
          f"{torch.cuda.get_device_name(0)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--make-inputs", default=None, help="write the window's inputs here")
    ap.add_argument("--inputs", default=None, help="inputs written by --make-inputs")
    ap.add_argument("--tree", default=ROOT, help="checkout whose rtvm_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--sift-window", action="store_true",
                    help="time the checkout's SIFT window step and _octave_levels")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    if args.make_inputs:
        make_inputs(args.make_inputs)
        return 0
    if args.sift_window:
        time_window(args.tree, args.label or args.tree)
        return 0
    if not args.inputs:
        ap.error("--inputs is required with --tree")
    time_tree(args.inputs, args.tree, args.label or args.tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
