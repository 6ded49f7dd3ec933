#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rtvm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its result and seconds on its own line:
  1. setup: the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: the CUDA kernels (csrc/*.cu -> one nvcc call -> ctypes), with
     each kernel's registers, shared memory and spills from ptxas, and
     alongside it the host C++ (csrc_host/*.cpp -> one g++ call -> ctypes);
  3. kernel A (the warp) against its plain PyTorch version on four fixed maps;
  4. kernel B (the SIFT patch copy) against its plain version on random
     origins at every octave shape, then timed on the origins the SIFT stages
     produce for one 16-frame window of the clip; kernel C (phase `union`,
     the paint's coarse union distance) against its plain version, bitwise,
     at the benchmark cells' 16x180x192 and 16x554x608 grids and on a grown
     canvas's 2x900x1000 (more rows than its shared-memory tile), timed
     beside it with its bound and its registers and spills;
  5. the SIFT window step (BASELINE config 2): 3 windows of 16 frames of a
     seeded synthetic world through VideMosaic.process_window, checked against
     the known camera path and against the same run with the plain versions
     swapped in; windows 2-3 run with CUDA's sync debug mode set to "error",
     so a device sync inside the window step fails the phase; then kernel A
     against its plain version on the maps of window 1, timed through
     warp_batch (phase `warp_real`, also on the card with torch.profiler);
     then kernel D (phase `weight`, the paint's analytic frame weight)
     against its plain version run on the card, bit for bit, on window 1's
     H_abs at 720x768, an orbit window at the fused 2216x2432 canvas and
     its bands, and edge quads at both, timed beside it with its bound,
     its registers and spills and its launch count; then kernel E (phase
     `blend`, the blend weights' 31-tap blur) against its plain version on
     the card, within BLEND_GAP, on the paint's weights of orbit windows at
     720x768 and 2216x2432, with bands of rows bit for bit the whole map's
     rows and strided inputs bit for bit their contiguous copies, timed
     beside the plain version and a library blur with its bound;
  6. the ORB window step (BASELINE config 1), the same clip and checks, with
     kernel A as its only kernel;
  7. the detection of BASELINE config 3, for YOLOv8n and then YOLO11n: the
     bundled checkpoint (weights/*_aerial.npz) read by the port's loader,
     then VideMosaic.process_clip over the same clip with det_fn =
     ObjectDetector._infer_fn(640, 0.25, 0.45) (bfloat16, as the JAX
     detector), whose stitch must equal phase 5's; its detections on 4
     frames, and the head logits, held against the port's own float32 run
     on the CPU, and a float32 run on the card held tighter; frames/s,
     detection ms, launches, card-to-host reads and peak memory;
  8. the pipeline driver (BASELINE config 3 end to end): the CLI's
     `mosaic <clip.npy> --detector sift --window 16 --no-detect --no-nav
     --per-frame-detect` on the same clip (phase `pipeline`: stats, a canvas
     equal to phase 5's, mosaic.jpg, mosaic_progress.jpg and Detections/
     as well-formed JPEG, per-frame detections against phase 7's), then
     run_mosaic(fused=True) with YOLO11n (phase `pipeline_fused`: equal to
     phase 7's stitch, the callback protocol), each with its wall time,
     frames/s and the driver's stage times;
  9. canvas growth (phase `grow`): a second clip drifting (6, -4) px a frame
     off the default canvas, stitched with auto_grow=True through the window
     loop (at most one device sync a window) and through the fused path on a
     pre-scanned canvas; the known camera path in the grown or pre-scanned
     canvas's coordinates, and kernel A against its plain version on it;
 10. the detection on the mosaic and the navigation map (phase `navigate`,
     BASELINE config 4): the CLI's `mosaic <clip.npy> --detector sift
     --window 16` with its defaults, on a third clip drifting as `grow`'s
     does (auto_grow=True through PipelineConfig) over a world with gray
     roofs and bright blobs: launches, YOLOv8n-world loaded, at least 2
     tiles, a classical building, a native A* call, the five JPEGs and
     their sizes, each detection pass against the port's float32 run on the
     CPU, nav_blocked against the CPU's; the stage times (first call and
     warm) and peak memory;
 11. the rest of the VideMosaic surface (phase `surface`): warp of one frame
     on the SIFT run's state (one launch of kernel A, equal to the same call
     with warp_plain), findHomography, validate_homography and
     smooth_homography against a CPU stitcher, matches.jpg from
     run_mosaic(visualize=True);
 12. the CLI's mosaic --images-dir (phase `images`) on three seeded images
     (two JPEGs, a PNG): Detections/, the decoded images, the detections
     against the port's float32 run on the CPU, the reader's decode time;
 13. BASELINE config 5 (phase `stream_1080p`): a 1080p clip, the pre-scan
     at stride 8, ORB, and process_clip with YOLOv8l at (768, 1280) in
     bf16 (weights/yolov8l_aerial.npz): the path, launches, no host-to-card
     copy, bf16 against the card's float32, kernel A on the 1080p maps;
 14. the CLI's slam on a 360x640 clip with parallax (phase `slam`) against
     the known direction and the port's CPU run, and the CLI's terrain on a
     soil image (phase `terrain`) against the CPU run;
 15. slice 8: one SIFT window at 480x854 (phase `sift_854`: octave widths
     that are not multiples of 4 floats through kernel B's pitched route,
     launches warp 1 and patches 2, B byte-identical to its plain version);
     the CLI's depth3d on a 1080x1920 PNG (phase `depth3d_image`: DepthNet
     on the card from weights/depthnet.npz against the port's CPU run, the
     cloud, mesh and panels, DepthNet's warm time, peak memory, the stage
     walls), on a 360x640 .npy clip (phase `depth3d_video`: ICP on the card
     against the CPU on the same clouds, the CPU pipeline's frames and
     points), on a directory of 4 views with --multi-view (phase
     `depth3d_multiview`: ORB angles, the indicator mesh; fuse_tsdf on
     analytic sphere depths against the CPU), and terrain --reconstruct-3d
     --fast (phase `terrain_3d`: the depth PNG against the CPU run, the
     bilateral and median filters on the card);
 16. slice 9: the CLI's view --backend offscreen --size 1920x1080 on
     depth3d_image's cloud and mesh (phase `view`: 1080x1920 PNGs equal to
     the port's CPU render on 0.999 of the pixels, the splat's warm time,
     the host's parts, peak memory); the CLI's stereo-demo (phase
     `stereo_demo`: the medians of 5 and 20 px, the CPU run's disparity);
     StereoTerrainMapper on a 480x640 slanted plane with 128 disparities
     (phase `stereo_480p`: raw SGM against the truth, the integer and
     refined disparity against the CPU run, SGM's time with the aggregation
     apart, its launches, peak memory); main_menu() with a scripted input
     (phase `menu`: the viewer's offscreen render of the mesh, equal to
     view's); the port's web server in a thread (phase `web`: a 1 + 16
     frame .npy clip through /upload, /start and /progress on the mosaic
     CLI's defaults, mosaic.jpg from /results, launches warp 1 and patches
     2). The gui command is not driven: the card's machine has no display;
 17. slice 10, the trainers (each in a temporary directory, never
     weights/): one full-width YOLOv8n loss + AdamW step (batch 16 at 320)
     against the port's CPU run on the same batch (phase `train_step`:
     loss, gradients, BatchNorm statistics, parameters; the warm step's ms
     and peak memory); train_synth.train for 20 steps at its defaults
     (phase `train_synth`: the loss finite and falling, the checkpoint's
     treedef equal to the bundled one and loaded by ObjectDetector,
     --resume continuing at step 21; ms a step with the host's make_batch
     apart); evaluate on weights/yolov8n_aerial.npz (phase `eval_yolo`:
     mAP50 against its report, 4 scenes against the CPU); the same for
     the open-vocabulary trainer and weights/yolov8n_world.npz (phase
     `train_world`); train_depth.main with --steps 1 --lr 0 against
     weights/depthnet.json, then 20 steps at its defaults (phase
     `train_depth`);
 18. slice 11, parallel/mesh.py and the .pt route: kernel A with a row
     origin bitwise equal to the full warp's rows, then dryrun_multichip(4)
     with its 4 ranks on the one card under gloo (phase `mesh`: the tiny
     ORB window, the dp YOLO training step, dp detection, the 360x640 ORB
     window onto the 720x768 canvas; then two SIFT windows on the (2, 2)
     mesh and two ORB windows on (1, 4), bitwise; each against the same
     step in one process on the card; kernel A's launches summed over the
     ranks one a rank a window, kernel B's one a rank a SIFT window; step
     and collective times, spawn and init, peak memory per rank; a batch
     of 4 frames against 8 in one process); the two ORB windows in one
     rank on NCCL (phase `mesh_nccl`, bitwise the one-process step); weights/yolov8n_aerial.npz through an ultralytics-layout .pt
     and back, and ObjectDetector("yolo11s") from a seeded .pt on the card
     against the CPU (phase `weights_pt`);
then one JSON line of per-kernel numbers, the elapsed time, and as the last
line {"ok": true, "device": {...}}. Any failed check exits non-zero. Without
a CUDA device it prints no result and exits non-zero.

Imports torch, numpy and rtvm_tpu_torch only.
"""

from __future__ import annotations

import collections
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

T_START = time.time()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
F32_NOFMA_OPS_PER_S = F32_OPS_PER_S / 2  # the same with no multiply-add: one operation a lane a clock
FRAME_H, FRAME_W = 360, 640  # BASELINE configs 1 and 2 frames
WINDOW = 16
N_WINDOWS = 3
MIN_ACCEPTED = 47
TRAJ_TOL_PX = 2.0
MIN_PSNR_DB = 60.0
SEED = 0
# BASELINE config 3: per-frame YOLO on the stitched clip
DETECT_MODELS = {  # model: (checkpoint, its leaf count, its value count)
    "yolov8n": ("weights/yolov8n_aerial.npz", 297, 3022792),
    "yolo11n": ("weights/yolo11n_aerial.npz", 417, 2606760),
}
DET_IMGSZ, DET_CONF, DET_IOU = 640, 0.25, 0.45
DET_FRAMES = [0, 17, 31, 47]  # the clip's frames held against the CPU
H_ABS_SAME = 1e-6
GROW_STEP = (6, -4)  # px a frame: 288 px right over the clip, past the 768-wide canvas
# Bounds against the port's float32 run on the CPU, per dtype on the card:
# (largest |d| of the head logits over their largest |value|, least share of
# detections matched at IoU >= 0.9 with the same class, largest score gap of
# a matched detection). Set from the first runs on an H100 (PERF.md, section 6),
# YOLOv8n and YOLO11n on these 4 frames: bf16 logits 2.0e-2 and 2.4e-2,
# 0.964-0.972 matched, score gaps up to 0.185; float32 logits 1.1e-6 and
# 8.3e-7, all matched, gaps 3.9e-6. Many scores on this clip sit near 0.5,
# where bf16 moves them most; the JAX package's own bf16 detector is no
# closer to float32 on these frames
# (tests/test_torch_detect.py::test_bfloat16_is_no_farther_from_float32_than_the_reference).
DET_BOUNDS = {"bfloat16": (0.05, 0.90, 0.25), "float32": (1e-5, 0.99, 1e-4)}


class CheckFailed(Exception):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def phase(name: str, t0: float, result: str) -> None:
    say(f"[{name}] {result} ({time.time() - t0:.2f} s)")


# the kernels that launch once a window step: the paint's warp (A), union
# (C), frame weight (D) and blend-weight blur (E)
PAINT_KERNELS = ("warp", "union", "weight", "blend")
# the launch counts of paths that neither paint nor cut SIFT patches
NO_LAUNCHES: dict = {}


def window_launches(windows: int, patches: int = 0) -> dict:
    """The launch counts of `windows` window steps whose SIFT patch cuts
    took `patches` launches of kernel B."""
    want = dict.fromkeys(PAINT_KERNELS, windows)
    if patches:
        want["patches"] = patches
    return want


def launch_counts() -> dict:
    """kernels.launches as a dict of the kernels that launched."""
    from rtvm_tpu_torch import kernels

    return dict(+kernels.launches)


def add_launches(*counts) -> dict:
    """The sum of launch-count dicts, by kernel."""
    return dict(sum(map(collections.Counter, counts), collections.Counter()))


def counted(run):
    """(run(), the kernels' launch counts in it): every count is set to 0
    just before `run` and read just after."""
    from rtvm_tpu_torch import kernels

    kernels.reset_launches()
    out = run()
    return out, launch_counts()


# ----------------------------------------------------------------- inputs


def _blur_axis(a: np.ndarray, sigma: float, axis: int) -> np.ndarray:
    r = max(1, int(math.ceil(3 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    taps = np.exp(-(x**2) / (2 * sigma**2))
    taps /= taps.sum()
    pad = [(0, 0)] * a.ndim
    pad[axis] = (r, r)
    p = np.pad(a, pad, mode="edge")
    n = a.shape[axis]
    return sum(t * np.take(p, np.arange(i, i + n), axis=axis) for i, t in enumerate(taps))


def make_world(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A textured BGR uint8 world: blurred noise at two scales plus random
    filled rectangles (corners and blobs for SIFT at every octave)."""
    img = rng.uniform(0, 255, (h, w, 3))
    img = _blur_axis(_blur_axis(img, 1.0, 0), 1.0, 1)
    coarse = rng.uniform(0, 255, (h // 16 + 2, w // 16 + 2, 3))
    coarse = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w]
    coarse = _blur_axis(_blur_axis(coarse, 6.0, 0), 6.0, 1)
    img = 0.6 * img + 0.4 * coarse
    for _ in range(h * w // 900):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
        dy, dx = rng.randint(6, 40), rng.randint(6, 40)
        img[y : y + dy, x : x + dx] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def camera_path(n: int, step=(2, -4)) -> np.ndarray:
    """Integer (x, y) crop origins of frames 0..n-1: a steady drift right and
    up. Steady, because the stitcher's 5-frame homography smoothing lags any
    change of speed, and the trajectory check is against the raw path. Even
    steps: an odd one biases SIFT's coarse octaves (ROADMAP Queue 3 item 3)."""
    i = np.arange(n)
    xs, ys = step[0] * i, step[1] * i
    return np.stack([xs - xs.min(), ys - ys.min()], -1)


def make_clip(rng, n: int, h: int, w: int, step=(2, -4)):
    path = camera_path(n, step)
    world = make_world(rng, h + int(path[:, 1].max()) + 8, w + int(path[:, 0].max()) + 8)
    frames = np.stack([world[y : y + h, x : x + w] for x, y in path])
    return frames, path


WARP_CASES = {
    "translate": [[1, 0, 20.3], [0, 1, 33.7], [0, 0, 1]],
    "scale_down": [[0.93, 0, 25], [0, 0.93, 30], [0, 0, 1]],
    "rot2_persp": [
        [0.98 * math.cos(0.03), -0.98 * math.sin(0.03), 30],
        [0.98 * math.sin(0.03), 0.98 * math.cos(0.03), 40],
        [1e-5, -8e-6, 1],
    ],
    "rot30": [
        [math.cos(math.radians(30)), -math.sin(math.radians(30)), 50],
        [math.sin(math.radians(30)), math.cos(math.radians(30)), 10],
        [0, 0, 1],
    ],
}


# ----------------------------------------------------------------- timing


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, kernel: str, reps: int = 10):
    """Mean time on the card of the kernel named `kernel` per call of fn, from
    torch.profiler; None when the profiler shows no such kernel."""
    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == cuda and e.name == kernel]
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / len(evs) if evs else None


def host_us(torch, fn, reps: int = 50) -> float:
    """Host time of one call of fn, without waiting for the card."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phases


def phase_warp(torch, dev, frames_u8: np.ndarray, hc: int, wc: int) -> None:
    """Kernel A against warp_plain on the four fixed maps: bitwise equal."""
    from rtvm_tpu_torch.ops.kernel_warp import inverse_maps, warp_batch, warp_plain

    t0 = time.time()
    names = list(WARP_CASES)
    H = torch.tensor([WARP_CASES[n] for n in names], dtype=torch.float32, device=dev)
    G = inverse_maps(H)
    fr = torch.as_tensor(frames_u8[: len(names)], device=dev).to(torch.float32)
    fr = fr.permute(0, 3, 1, 2).contiguous()
    out_k = warp_batch(fr, G, hc, wc)
    out_p = warp_plain(fr, G, hc, wc)
    torch.cuda.synchronize()
    errs = {n: float((out_k[i] - out_p[i]).abs().max()) for i, n in enumerate(names)}
    for i, n in enumerate(names):
        check(bool(torch.isfinite(out_k[i]).all()), f"warp {n}: non-finite output")
        check(float(out_k[i].abs().sum()) > 0, f"warp {n}: empty output")
    check(torch.equal(out_k, out_p), f"warp kernel differs from plain: max |d| per case {errs}")
    phase("warp", t0, f"bitwise equal to warp_plain on {names}")


def grid_sample_ms(torch, fr, G, hc: int, wc: int, out_k) -> tuple:
    """Kernel A's function as one library call: F.grid_sample (bilinear,
    zero padding) of the frames fr [B, 3, Hf, Wf] at the maps G, with the
    sampling grid built beforehand. Returns (ms a call, its largest |d| from
    the kernel's output out_k)."""
    b, _, hf, wf = fr.shape
    ys = torch.arange(hc, dtype=torch.float32, device=fr.device)[None, :, None]
    xs = torch.arange(wc, dtype=torch.float32, device=fr.device)[None, None, :]
    g = G.reshape(b, 9, 1, 1)
    den = g[:, 6] * xs + g[:, 7] * ys + g[:, 8]
    sx = (g[:, 0] * xs + g[:, 1] * ys + g[:, 2]) / den
    sy = (g[:, 3] * xs + g[:, 4] * ys + g[:, 5]) / den
    grid = torch.stack([sx * (2.0 / (wf - 1)) - 1.0, sy * (2.0 / (hf - 1)) - 1.0], -1)
    del den, sx, sy

    def call():
        return torch.nn.functional.grid_sample(fr, grid, mode="bilinear", padding_mode="zeros",
                                               align_corners=True)

    err = float((call() - out_k).abs().max())
    return cuda_ms(torch, call), err


def warp_real(torch, dev, frames_u8: np.ndarray, H_abs, hc: int, wc: int) -> dict:
    """Kernel A on the maps of a window of the main-path run: bitwise equal to
    warp_plain, then timed through warp_batch beside warp_plain and
    grid_sample on the same maps, and on maps that put the frame far off the
    canvas (every tile empty: the kernel's store-only floor)."""
    from rtvm_tpu_torch.ops.kernel_warp import (TILE_H, TILE_W, inverse_maps, tile_is_empty,
                                                warp_batch, warp_plain)

    t0 = time.time()
    b = H_abs.shape[0]
    fr = torch.as_tensor(frames_u8, device=dev).to(torch.float32).permute(0, 3, 1, 2).contiguous()
    G = inverse_maps(H_abs.to(device=dev, dtype=torch.float32)).contiguous()
    out_k = warp_batch(fr, G, hc, wc)
    out_p = warp_plain(fr, G, hc, wc)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    check(torch.equal(out_k, out_p), f"warp kernel vs plain on the window's maps: max |d| {err}")
    g_rows = G.reshape(b, 9).cpu().tolist()
    tiles = [(x, y) for y in range(0, hc, TILE_H) for x in range(0, wc, TILE_W)]
    empty = sum(tile_is_empty(g, x, y, min(x + TILE_W, wc) - 1, min(y + TILE_H, hc) - 1,
                              FRAME_H, FRAME_W) for g in g_rows for x, y in tiles)
    covered = float((out_p.amax(dim=1) > 0).float().mean())

    ms = cuda_ms(torch, lambda: warp_batch(fr, G, hc, wc))
    plain_ms = cuda_ms(torch, lambda: warp_plain(fr, G, hc, wc), reps=5)
    library_ms, library_err = grid_sample_ms(torch, fr, G, hc, wc, out_k)
    far = torch.tensor([[1, 0, 1e5], [0, 1, 1e5], [0, 0, 1]], dtype=torch.float32, device=dev)
    G_far = inverse_maps(far.expand(b, 3, 3)).contiguous()
    floor_ms = cuda_ms(torch, lambda: warp_batch(fr, G_far, hc, wc))
    ms_again = cuda_ms(torch, lambda: warp_batch(fr, G, hc, wc))
    dev_ms = device_ms(torch, lambda: warp_batch(fr, G, hc, wc), "rtvm_warp_bilinear_kernel")
    wrap_us = host_us(torch, lambda: warp_batch(fr, G, hc, wc))
    out_bytes = b * 3 * hc * wc * 4
    nbytes = b * (3 * FRAME_H * FRAME_W * 4 + 9 * 4) + out_bytes
    nops = b * hc * wc * (12 + 3 * 12)  # position math + 3 channels of taps and blends
    bound_ms, bound_by = bound(nbytes, nops)
    phase("warp_real", t0,
          f"bitwise equal to warp_plain on window 1's maps (B={b}); {covered:.4f} of the canvas "
          f"covered, {empty} of {b * len(tiles)} tiles skipped; through warp_batch: kernel "
          f"{ms:.4f} ms (again {ms_again:.4f}; on the card {fmt_ms(dev_ms)}, host "
          f"{wrap_us:.1f} us a call), plain {plain_ms:.4f} ms, grid_sample "
          f"{library_ms:.4f} ms (within {library_err:.2e} of the kernel), bound {bound_ms:.4f} ms "
          f"({bound_ms / ms:.3f} of it); every tile "
          f"empty: {floor_ms:.4f} ms (store bound {out_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return {"name": "warp_bilinear", "route": "cuda", "source": "rtvm_tpu_torch/csrc/warp.cu",
            "replaces": "rtvm_tpu/ops/pallas_warp.py:127", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": dev_ms}


def _gather_octaves(torch, stacks, ys, xs):
    """The library yardstick: one advanced-indexing gather per octave."""
    outs = []
    for s, y, x in zip(stacks, ys, xs):
        d = torch.arange(32, device=s.device)
        bi = torch.arange(s.shape[0], device=s.device)[:, None, None, None]
        outs.append(s[bi, y.long()[:, :, None, None] + d[:, None], x.long()[:, :, None, None] + d])
    return outs


def phase_patches(torch, dev, frames_u8: np.ndarray) -> dict:
    """Kernel B against its plain version: on random origins at every octave
    shape of the main path (strided level views, as the SIFT stages pass
    them), then on the origins the SIFT stages produce for window 1 of the
    clip, where it is timed (one launch per window) beside its plain version
    and the per-octave gathers."""
    from rtvm_tpu_torch.config import FeatureConfig
    from rtvm_tpu_torch.ops import color
    from rtvm_tpu_torch.ops.features.sift import PATCH, _octave_quotas, detect_pyramid
    from rtvm_tpu_torch.ops.kernel_patches import (extract_patches_octaves,
                                                   extract_patches_octaves_plain)

    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    b, s = WINDOW, 3
    stacks, ys, xs = [], [], []
    for o, q in enumerate(_octave_quotas(700, 4, 4.0)):
        h, w = FRAME_H >> o, FRAME_W >> o
        levels = torch.rand((b, s + 3, h, w), generator=gen, device=dev)
        stacks.append(levels[:, 1 : s + 1].reshape(b, s * h, w))
        ys.append(torch.randint(0, s * h - PATCH + 1, (b, q), generator=gen, device=dev,
                                dtype=torch.int32))
        xs.append(torch.randint(0, w - PATCH + 1, (b, q), generator=gen, device=dev,
                                dtype=torch.int32))
    out_k = extract_patches_octaves(stacks, ys, xs)
    out_p = extract_patches_octaves_plain(stacks, ys, xs)
    torch.cuda.synchronize()
    check(torch.equal(out_k, out_p), "patches on random origins: kernel differs from plain")
    shapes = [f"[{tuple(st.shape)}]x{y.shape[1]}" for st, y in zip(stacks, ys)]

    # the origins the SIFT stages produce for window 1 of the clip
    win = torch.as_tensor(frames_u8[1 : 1 + WINDOW], device=dev)
    _, _, stacks, ys, xs, _ = detect_pyramid(color.bgr2gray(win), FeatureConfig())
    out_k = extract_patches_octaves(stacks, ys, xs)
    out_p = extract_patches_octaves_plain(stacks, ys, xs)
    torch.cuda.synchronize()
    check(torch.equal(out_k, out_p), "patches on the SIFT origins: kernel differs from plain")
    err = float((out_k - out_p).abs().max())
    ms = cuda_ms(torch, lambda: extract_patches_octaves(stacks, ys, xs))
    plain_ms = cuda_ms(torch, lambda: extract_patches_octaves_plain(stacks, ys, xs))
    library_ms = cuda_ms(torch, lambda: _gather_octaves(torch, stacks, ys, xs))
    ms_again = cuda_ms(torch, lambda: extract_patches_octaves(stacks, ys, xs))
    dev_ms = device_ms(torch, lambda: extract_patches_octaves(stacks, ys, xs),
                       "rtvm_patches_tma_kernel")
    wrap_us = host_us(torch, lambda: extract_patches_octaves(stacks, ys, xs))
    # bytes this run must move: every stack pixel some patch covers, read once;
    # the origins; every patch written once
    read = 0
    for st, y, x in zip(stacks, ys, xs):
        touched = torch.zeros(st.shape, dtype=torch.bool, device=dev)
        d = torch.arange(PATCH, device=dev)
        y0 = y.long().clamp(0, st.shape[1] - PATCH)[:, :, None, None] + d[:, None]
        x0 = x.long().clamp(0, st.shape[2] - PATCH)[:, :, None, None] + d
        touched[torch.arange(b, device=dev)[:, None, None, None], y0, x0] = True
        read += int(touched.sum()) * 4 + 2 * y.numel() * 4
    written = out_k.numel() * 4
    bound_ms = bound(read + written, 0)[0]
    phase("patches", t0,
          f"byte-identical on random origins at {shapes} and on window 1's SIFT origins "
          f"({out_k.shape[1]} patches a frame, {read / 1e6:.2f} MB read, {written / 1e6:.2f} MB "
          f"written); per window (1 launch): kernel {ms:.4f} ms (again {ms_again:.4f}; on the "
          f"card {fmt_ms(dev_ms)}, host {wrap_us:.1f} us a call), plain "
          f"{plain_ms:.4f} ms, gathers {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_ms / ms:.3f} of it)")
    return {"name": "extract_patches", "route": "cuda", "source": "rtvm_tpu_torch/csrc/patches.cu",
            "replaces": "rtvm_tpu/ops/pallas_patches.py:145", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "device_ms": dev_ms}


UNION_SHAPES = {  # [N, Gh, Gw] coarse grids of kernel C
    "live": (16, 180, 192),  # sift360-yolov8n.live's window: 720x768 canvas, 4-px cells
    "fused": (16, 554, 608),  # orb1080-yolov8l.fused's window: 2216x2432 canvas
    "grown": (2, 900, 1000),  # a canvas grown past both: Gh well above the 128-row tile
}
UNION_OPS = 8  # float32 operations a candidate: |y - v|, max, min, sub, 2 mul, add, running min


def union_grids(torch, dev, shape, gen) -> dict:
    """Occupancy grids [N, Gh, Gw] on the card: random cells at three
    shares, and a mosaic's union (frame-sized rectangles of cells, with a
    few holes)."""
    n, gh, gw = shape
    out = {f"random {p}": torch.rand(shape, generator=gen, device=dev) < p for p in (0.5, 0.9, 0.99)}
    union = torch.zeros(shape, dtype=torch.bool, device=dev)
    ys = torch.randint(0, max(1, gh // 2), (n, 6), generator=gen, device=dev).tolist()
    xs = torch.randint(0, max(1, gw // 2), (n, 6), generator=gen, device=dev).tolist()
    for i in range(n):
        for y, x in zip(ys[i], xs[i]):
            union[i, y : y + gh // 2, x : x + gw // 2] = True
    out["mosaic"] = union & (torch.rand(shape, generator=gen, device=dev) < 0.995)
    return out


def phase_union(torch, dev, regs: dict) -> dict:
    """Kernel C against coarse_union_distance_plain, bitwise, on every grid
    of union_grids at each of UNION_SHAPES and at cell_px 1 and 4; then timed
    on the mosaic grids beside the plain version, with its bound (operations
    at the float32 rate without multiply-add, or bytes) and the ptxas report
    of its two kernels. Returns kernel C's row of the kernel table (the fused
    window's numbers, the others under by_shape)."""
    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.ops.warp import coarse_union_distance, coarse_union_distance_plain

    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    names = ("rtvm_union_rows_kernel", "rtvm_union_cols_kernel")
    by_shape, notes = {}, []
    for key, shape in UNION_SHAPES.items():
        grids = union_grids(torch, dev, shape, gen)
        for what, g in grids.items():
            for cell_px in (1.0, 4.0):
                kernels.reset_launches()
                got = coarse_union_distance(g, cell_px)
                check(kernels.launches["union"] == 1, f"union {key} {what}: launches {kernels.launches}")
                want = coarse_union_distance_plain(g, cell_px)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    d = float((got - want).abs().max())
                    raise CheckFailed(f"union {key} {what} cell {cell_px}: kernel C differs from "
                                      f"the plain version by up to {d}")
        g = grids["mosaic"]
        ms = cuda_ms(torch, lambda: coarse_union_distance(g))
        parts = [device_ms(torch, lambda: coarse_union_distance(g), k) for k in names]
        dev_ms = None if None in parts else sum(parts)
        wrap_us = host_us(torch, lambda: coarse_union_distance(g))
        plain_ms = cuda_ms(torch, lambda: coarse_union_distance_plain(g), reps=3, warmup=1)
        n, gh, gw = shape
        nops = n * gh * gh * gw * UNION_OPS
        nbytes = n * gh * gw * (1 + 4)  # the grids in, the distances out
        t_ops = nops / F32_NOFMA_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        by_shape[key] = {"shape": list(shape), "ms": ms, "device_ms": dev_ms, "host_us": wrap_us,
                         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "share_of_bound": bound_ms / (dev_ms or ms)}
        notes.append(f"{key} {list(shape)}: kernel {ms:.4f} ms (on the card {fmt_ms(dev_ms)}: "
                     f"{', '.join(fmt_ms(x) for x in parts)}; host {wrap_us:.1f} us a call), plain "
                     f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {nops / 1e9:.2f} G "
                     f"operations, {nbytes / 1e6:.2f} MB), {bound_ms / (dev_ms or ms):.3f} of it")
    ptx = "; ".join(f"{k}: {regs[k]['registers']} registers, {regs[k]['smem']} B smem, spills "
                    f"{regs[k]['spill_stores']}/{regs[k]['spill_loads']} B" for k in names if k in regs)
    phase("union", t0, f"kernel C bitwise equal to coarse_union_distance_plain on random grids "
                       f"(0.5, 0.9, 0.99 occupied) and a mosaic's union at {list(UNION_SHAPES)}, "
                       f"cell_px 1 and 4; timed on the mosaic's: " + "; ".join(notes)
          + f"; {ptx or 'no ptxas report'}")
    fused = by_shape["fused"]
    return {"name": "union_distance", "route": "cuda", "source": "rtvm_tpu_torch/csrc/union.cu",
            "replaces": "none (XLA fuses rtvm_tpu/ops/warp.py:63 on the TPU)", "max_abs_err": 0.0,
            "ms": fused["ms"], "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"],
            "bound_by": fused["bound_by"], "library_ms": None, "device_ms": fused["device_ms"],
            "by_shape": by_shape}


WEIGHT_OPS = (48, 30, 12)  # float32 operations a grid point and valid segment, a grid point, a pixel
WEIGHT_BANDS = ((0, 1), (2, 63), (1108, 65), (2214, 2), (1000, 1216))  # (row0, rows) at 2216 rows


def weight_window(torch, n: int, hc: int, wc: int, hf: int, wf: int, seed: int):
    """H_abs [n, 3, 3] of a window on a canvas: frames on the benchmark's
    elliptical orbit (semi-axes 0.156 x 0.467 frame heights, 12 windows a
    lap) about the canvas centre, each with the small rotation, scale and
    perspective an ORB fit leaves."""
    rng = np.random.RandomState(seed)
    t = 2.0 * np.pi * (np.arange(n) + rng.rand() * 192) / 192.0
    out = np.tile(np.eye(3), (n, 1, 1))
    out[:, :2, :2] += rng.randn(n, 2, 2) * 1e-4
    out[:, 2, :2] = rng.randn(n, 2) * 1e-7
    out[:, 0, 2] = (wc - wf) / 2.0 + 0.156 * hf * np.sin(t) + rng.randn(n) * 1e-3
    out[:, 1, 2] = (hc - hf) / 2.0 + 0.467 * hf * (np.cos(t) - 1.0) / 2.0 + rng.randn(n) * 1e-3
    return torch.from_numpy(out.astype(np.float32))


def weight_quads(torch, hc: int, wc: int, hf: int, wf: int):
    """H [12, 3, 3]: quads that test kernel D's edges on a canvas: clipped,
    rotated, mirrored, in strong perspective, with a corner near w = 0, off
    the canvas, covering it, of near-zero size, behind the camera, NaN."""
    def rot(deg, tx, ty, s=1.0):
        a = np.deg2rad(deg)
        return [[s * np.cos(a), -s * np.sin(a), tx], [s * np.sin(a), s * np.cos(a), ty], [0, 0, 1]]

    hs = [[[1, 0, wc - wf / 2.0], [0, 1, -hf / 3.0], [0, 0, 1]], rot(30.0, wc / 2.0, hc / 8.0),
          [[-1, 0, wc / 2.0 + wf], [0, 1, hc / 5.0], [0, 0, 1]],
          [[1.1, 0.2, wc / 5.0], [-0.1, 0.9, hc / 5.0], [2.5e-3 * 96 / wf, 1.8e-3 * 60 / hf, 1]],
          [[1, 0, wc / 6.0], [0, 1, hc / 7.0], [-1.0 / wf + 1e-6, 0, 1]],
          [[1, 0, 4.0 * wc], [0, 1, 3.0 * hc], [0, 0, 1]], rot(5.0, -wc / 3.0, -hc / 2.0, 4.0 * hc / hf),
          [[1e-6, 0, wc / 4.0], [0, 1e-6, hc / 2.5], [0, 0, 1]], [[1, 0, 1.5], [0, 1, 1.5], [0, 0, 1]],
          (-np.eye(3)).tolist(), [[1, 0, wc / 6.0], [0, 1, hc / 7.0], [-2.0 / wf, 0, 1]],
          np.full((3, 3), np.nan).tolist()]
    return torch.tensor(hs, dtype=torch.float32)


def phase_weight(torch, dev, regs: dict, live_H) -> dict:
    """Kernel D against frame_weight_eval_plain on the card, bit for bit
    (int32 views), on a real window's H_abs at the live 720x768 canvas, an
    orbit window at the fused 2216x2432 canvas with its bands, and quads at
    the edges of the function at both; then timed on the windows beside the
    plain version, with its bound (operations at the float32 rate without
    multiply-add, or bytes) and the ptxas report. Returns kernel D's row of
    the kernel table (the fused window's numbers, the live's under
    by_shape)."""
    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.ops.warp import (frame_weight_eval, frame_weight_eval_plain,
                                         frame_weight_params)

    t0 = time.time()
    name = "rtvm_frame_weight_kernel"
    shapes = {"live": (720, 768, FRAME_H, FRAME_W, live_H.to(dev)),
              "fused": (2216, 2432, STREAM_H, STREAM_W,
                        weight_window(torch, WINDOW, 2216, 2432, STREAM_H, STREAM_W, SEED + 21).to(dev))}

    def same_bits(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    by_shape, notes = {}, []
    for key, (hc, wc, hf, wf, H) in shapes.items():
        kernels.reset_launches()
        quads = frame_weight_params(weight_quads(torch, hc, wc, hf, wf).to(dev), hf, wf, hc, wc)
        params = frame_weight_params(H, hf, wf, hc, wc)
        cases = [("window", params, 0, hc), ("quads", quads, 0, hc)]
        cases += [("window band", params, r0, n) for r0, n in WEIGHT_BANDS if r0 + n <= hc]
        for what, prm, row0, rows in cases:
            got = frame_weight_eval(prm, hc, wc, row0=row0, rows=rows)
            want = frame_weight_eval_plain(prm, hc, wc, row0=row0, rows=rows)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                off = int((got.view(torch.int32) != want.view(torch.int32)).sum())
                d = float((got - want).abs().max())
                raise CheckFailed(f"weight {key} {what} rows {row0}+{rows}: kernel D differs from "
                                  f"the plain version in {off} values, by up to {d}")
        check(kernels.launches["weight"] == len(cases),
              f"weight: launches {kernels.launches} in {len(cases)} calls")
        ms = cuda_ms(torch, lambda: frame_weight_eval(params, hc, wc))
        dev_ms = device_ms(torch, lambda: frame_weight_eval(params, hc, wc), name)
        wrap_us = host_us(torch, lambda: frame_weight_eval(params, hc, wc))
        plain_ms = cuda_ms(torch, lambda: frame_weight_eval_plain(params, hc, wc), reps=3, warmup=1)
        b = H.shape[0]
        g = -(-hc // 2) * -(-wc // 2)
        ok = params[3].to(torch.int64)
        valid = int((params[1].sum(dim=1) * ok).sum())
        op_seg, op_point, op_pixel = WEIGHT_OPS
        nops = valid * g * op_seg + int(ok.sum()) * g * op_point + b * hc * wc * op_pixel
        nbytes = b * hc * wc * 4
        t_ops = nops / F32_NOFMA_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        by_shape[key] = {"shape": [b, hc, wc], "valid_segments": valid, "ms": ms, "device_ms": dev_ms,
                         "host_us": wrap_us, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "share_of_bound": bound_ms / (dev_ms or ms)}
        notes.append(f"{key} [{b}, {hc}, {wc}] ({valid} valid segments): kernel {ms:.4f} ms (on the "
                     f"card {fmt_ms(dev_ms)}; host {wrap_us:.1f} us a call), plain {plain_ms:.4f} ms, "
                     f"bound {bound_ms:.4f} ms ({bound_by}; {nops / 1e9:.2f} G operations, "
                     f"{nbytes / 1e6:.1f} MB), {bound_ms / (dev_ms or ms):.3f} of it")
    r = regs.get(name)
    ptx = (f"{r['registers']} registers, {r['smem']} B smem, spills {r['spill_stores']}/"
           f"{r['spill_loads']} B" if r else "no ptxas report")
    phase("weight", t0, f"kernel D bit for bit frame_weight_eval_plain on the card: a SIFT window's "
                        f"H_abs at 720x768, an orbit window at 2216x2432 and its bands "
                        f"{list(WEIGHT_BANDS)}, 12 edge quads at both; one launch a call; "
                        + "; ".join(notes) + f"; {ptx}")
    fused = by_shape["fused"]
    return {"name": "frame_weight", "route": "cuda", "source": "rtvm_tpu_torch/csrc/weight.cu",
            "replaces": "none (XLA fuses rtvm_tpu/ops/warp.py:557 on the TPU)", "max_abs_err": 0.0,
            "ms": fused["ms"], "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"],
            "bound_by": fused["bound_by"], "library_ms": None, "device_ms": fused["device_ms"],
            "by_shape": by_shape}


# Kernel E against the plain version on the card, largest |d| of alpha_s and
# beta_s: the plain version's cuBLAS band product may sum in another order
# than the kernel's chain of fused multiply-adds (the maps are in [0, 1]; on
# an H100, 700 W, both have read bit for bit the same).
BLEND_GAP = 1e-6
# float32 operations an element: 2 x 62 multiply-adds (31 a row, 31 a column,
# alpha and the region), two adds and a division (counted as 8) for alpha,
# two tests and an or for the region, beta's difference
BLEND_OPS = 2 * 62 + 2 + 8 + 3 + 1
BLEND_BANDS = ((0, 300), (17, 300), (420, 720), (600, 1000), (1700, 2216), (1000, 1031))  # rows [l, h)


def blend_weights_library(torch, w_new, w_old):
    """The blend weights from PyTorch's own operators: replicate padding and
    a 1 x 31 then a 31 x 1 convolution with the taps (the yardstick for
    kernel E, never the port's route)."""
    from rtvm_tpu_torch.ops import warp as warp_ops
    from rtvm_tpu_torch.ops.filters import gaussian_kernel1d

    F = torch.nn.functional
    r = warp_ops.BLEND_SMOOTH_RADIUS
    taps = torch.from_numpy(gaussian_kernel1d(warp_ops.BLEND_SMOOTH_SIGMA, r)).to(w_new.device)
    n, rows, cols = w_new.shape
    alpha = w_new / (w_new + w_old + 1e-6)
    region = ((w_new > 0.0) | (w_old > 0.0)).to(torch.float32)
    x = torch.stack([alpha, region], 1).reshape(2 * n, 1, rows, cols)
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), taps.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), taps.view(1, 1, -1, 1))
    a, g = x.reshape(n, 2, rows, cols).unbind(1)
    return a, g - a


def phase_blend(torch, dev, regs: dict) -> dict:
    """Kernel E against blend_weights_smoothed_plain on the card, within
    BLEND_GAP, on the paint's weights of orbit windows (the analytic frame
    weights of 16 frames, and of the window before, as w_new and w_old) at
    the live 720x768 and the fused 2216x2432 canvas; bands of rows, row- and
    column-sliced inputs, bit for bit the whole map's rows and their
    contiguous copies; then timed beside the plain version and the library's
    blur, with its bound (bytes, or operations at the float32 rate without
    multiply-add) and the ptxas report. Returns kernel E's row of the kernel
    table (the fused window's numbers, the live's under by_shape)."""
    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.ops.warp import (blend_weights_smoothed, blend_weights_smoothed_plain,
                                         frame_weight_eval, frame_weight_params)

    t0 = time.time()
    name = "rtvm_blend_kernel"
    r = 15

    def same_bits(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    def gap(got, want):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    by_shape, notes = {}, []
    for key, (hc, wc, hf, wf, seed) in {"live": (720, 768, FRAME_H, FRAME_W, SEED + 31),
                                        "fused": (2216, 2432, STREAM_H, STREAM_W, SEED + 32)}.items():
        w_new, w_old = (frame_weight_eval(frame_weight_params(
            weight_window(torch, WINDOW, hc, wc, hf, wf, s).to(dev), hf, wf, hc, wc), hc, wc)
            for s in (seed, seed + 1))
        kernels.reset_launches()
        got = blend_weights_smoothed(w_new, w_old)
        check(kernels.launches["blend"] == 1, f"blend {key}: launches {kernels.launches}")
        want = blend_weights_smoothed_plain(w_new, w_old)
        d = gap(got, want)
        check(d <= BLEND_GAP, f"blend {key}: kernel E {d} off the plain version")
        equal = float(sum((g == w).float().mean() for g, w in zip(got, want)) / 2)
        del want
        for l, h in BLEND_BANDS:
            if h > hc:
                continue
            band = blend_weights_smoothed(w_new[:, l:h], w_old[:, l:h])
            a = r if l > 0 else 0
            b = h - l - r if h < hc else h - l
            check(all(same_bits(x[:, a:b], y[:, l + a : l + b]) for x, y in zip(band, got)),
                  f"blend {key}: rows [{l + a}, {l + b}) of the band [{l}, {h}) differ from the "
                  f"whole map's")
        for sl in ((slice(None), slice(40, hc - 9)), (slice(None), slice(None), slice(3, wc - 2)),
                   (slice(1, None, 3), slice(None), slice(5, wc))):
            x, y = w_new[sl], w_old[sl]
            check(all(same_bits(g, w) for g, w in zip(
                blend_weights_smoothed(x, y), blend_weights_smoothed(x.contiguous(), y.contiguous()))),
                f"blend {key}: the strided input {sl} differs from its contiguous copy")
        ms = cuda_ms(torch, lambda: blend_weights_smoothed(w_new, w_old))
        dev_ms = device_ms(torch, lambda: blend_weights_smoothed(w_new, w_old), name)
        wrap_us = host_us(torch, lambda: blend_weights_smoothed(w_new, w_old))
        plain_ms = cuda_ms(torch, lambda: blend_weights_smoothed_plain(w_new, w_old), reps=3,
                           warmup=1)
        lib_gap = gap(blend_weights_library(torch, w_new, w_old), got)
        lib_ms = cuda_ms(torch, lambda: blend_weights_library(torch, w_new, w_old), reps=5)
        elems = w_new.numel()
        nops, nbytes = elems * BLEND_OPS, elems * 16
        t_ops = nops / F32_NOFMA_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        by_shape[key] = {"shape": list(w_new.shape), "max_abs_err": d, "equal_share": equal,
                         "ms": ms, "device_ms": dev_ms, "host_us": wrap_us, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "library_gap": lib_gap, "bound_ms": bound_ms,
                         "bound_by": bound_by, "share_of_bound": bound_ms / (dev_ms or ms)}
        notes.append(f"{key} {list(w_new.shape)}: {d:.3g} largest off the plain version (equal on "
                     f"{equal:.4f}); kernel {ms:.4f} ms (on the card {fmt_ms(dev_ms)}; host "
                     f"{wrap_us:.1f} us a call), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
                     f"({lib_gap:.3g} off), bound {bound_ms:.4f} ms ({bound_by}; {nops / 1e9:.2f} G "
                     f"operations, {nbytes / 1e9:.3f} GB), {bound_ms / (dev_ms or ms):.3f} of it")
        del w_new, w_old, got
    rg = regs.get(name)
    ptx = (f"{rg['registers']} registers, {rg['smem']} B static smem, stack {rg['stack']} B, "
           f"spills {rg['spill_stores']}/{rg['spill_loads']} B" if rg else "no ptxas report")
    phase("blend", t0, f"kernel E within {BLEND_GAP} of blend_weights_smoothed_plain on the card on "
                       f"the paint's weights at 720x768 and 2216x2432; bands {list(BLEND_BANDS)} and "
                       f"strided inputs bit for bit; one launch a call; " + "; ".join(notes)
          + f"; {ptx}")
    fused = by_shape["fused"]
    return {"name": "blend_weights", "route": "cuda", "source": "rtvm_tpu_torch/csrc/blend.cu",
            "replaces": "none (XLA fuses rtvm_tpu/ops/warp.py:blend_weights_smoothed on the TPU)",
            "max_abs_err": fused["max_abs_err"], "ms": fused["ms"], "plain_ms": fused["plain_ms"],
            "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"],
            "library_ms": fused["library_ms"], "device_ms": fused["device_ms"], "by_shape": by_shape}


def run_mosaic(torch, dev, frames: np.ndarray, detector: str, no_sync: bool = False):
    """VideMosaic on frames[0], then N_WINDOWS windows of WINDOW frames.
    With no_sync, windows 2.. run under CUDA's sync debug mode "error" (the
    frames are uploaded before it is set), so a device sync inside the window
    step raises. Returns (mosaic, list of WindowAux, seconds per window)."""
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic

    m = VideMosaic(frames[0], detector_type=detector, seed=SEED, device=dev)
    auxs, secs = [], []
    for wi in range(N_WINDOWS):
        torch.cuda.synchronize()
        t = time.time()
        win = torch.as_tensor(frames[1 + wi * WINDOW : 1 + (wi + 1) * WINDOW]).to(dev)
        guard = no_sync and wi > 0  # window 1 builds the cached constants
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            auxs.append(m.process_window(win))
        except RuntimeError as e:
            if guard:
                raise CheckFailed(f"{detector} window {wi + 1}: {e}") from e
            raise
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs.append(time.time() - t)
    return m, auxs, secs


def phase_window(torch, dev, frames: np.ndarray, path: np.ndarray, card: str,
                 detector: str, want: dict) -> tuple:
    """One detector's window step on the kernel path, then on the plain path.
    Returns (launch counts of the kernel path, window 1's H_abs)."""
    import rtvm_tpu_torch.mosaic.stitcher as stitcher_mod
    import rtvm_tpu_torch.ops.features.sift as sift_mod
    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.ops import warp as warp_ops
    from rtvm_tpu_torch.ops.kernel_patches import extract_patches_octaves_plain
    from rtvm_tpu_torch.ops.kernel_warp import warp_plain

    t0 = time.time()
    name = "window" if detector == "sift" else f"window_{detector}"
    kernels.reset_launches()
    m, auxs, secs = run_mosaic(torch, dev, frames, detector, no_sync=True)
    counts = launch_counts()
    n = N_WINDOWS * WINDOW
    check(counts == want, f"{name}: launch counts {counts}, expected {want}")

    blended = torch.cat([a.blended for a in auxs]).cpu().numpy()
    ok = torch.cat([a.ok for a in auxs]).cpu().numpy()
    accepted = int((blended & ok).sum())
    check(accepted >= MIN_ACCEPTED, f"{name}: only {accepted} of {n} frames accepted")

    H_abs = torch.cat([a.H_abs for a in auxs]).cpu().numpy().astype(np.float64)
    check(np.isfinite(H_abs).all(), f"{name}: non-finite H_abs")
    hf, wf = FRAME_H, FRAME_W
    corners = np.array([[0, 0, 1], [wf, 0, 1], [wf, hf, 1], [0, hf, 1]], np.float64).T
    got = np.einsum("bij,jk->bik", H_abs, corners)
    got = (got[:, :2] / got[:, 2:3]).transpose(0, 2, 1)  # [n, 4, 2]
    shift = path[1 : n + 1] - path[0] + np.array([m.h_offset, m.w_offset])
    want_c = corners[:2].T[None] + shift[:, None, :]
    traj_err = float(np.abs(got - want_c)[blended].max())
    check(traj_err <= TRAJ_TOL_PX,
          f"{name}: corner trajectory off by {traj_err:.3f} px > {TRAJ_TOL_PX}")

    canvas_k = m.state.canvas
    check(bool(torch.isfinite(canvas_k).all()), f"{name}: non-finite canvas")
    check(tuple(canvas_k.shape) == (3, 2 * hf, int(1.2 * wf)),
          f"{name}: canvas shape {tuple(canvas_k.shape)}")
    fps = (N_WINDOWS - 1) * WINDOW / sum(secs[1:])

    # the same run with the plain versions in place of the five kernels
    saved = (stitcher_mod.warp_batch, sift_mod.extract_patches_octaves,
             warp_ops.coarse_union_distance, warp_ops.frame_weight_eval,
             warp_ops.blend_weights_smoothed)
    stitcher_mod.warp_batch = warp_plain
    sift_mod.extract_patches_octaves = extract_patches_octaves_plain
    warp_ops.coarse_union_distance = warp_ops.coarse_union_distance_plain
    warp_ops.frame_weight_eval = warp_ops.frame_weight_eval_plain
    warp_ops.blend_weights_smoothed = warp_ops.blend_weights_smoothed_plain
    try:
        kernels.reset_launches()
        mp, auxs_p, secs_p = run_mosaic(torch, dev, frames, detector)
        check(sum(kernels.launches.values()) == 0, f"{name}: the plain run launched a kernel")
    finally:
        (stitcher_mod.warp_batch, sift_mod.extract_patches_octaves,
         warp_ops.coarse_union_distance, warp_ops.frame_weight_eval,
         warp_ops.blend_weights_smoothed) = saved
    mse = float(((canvas_k - mp.state.canvas) ** 2).mean())
    psnr = math.inf if mse == 0 else 10 * math.log10(255.0**2 / mse)
    check(psnr >= MIN_PSNR_DB, f"{name}: kernel vs plain canvas PSNR {psnr:.2f} dB < {MIN_PSNR_DB}")
    fps_plain = (N_WINDOWS - 1) * WINDOW / sum(secs_p[1:])
    canvases = "identical" if mse == 0 else f"PSNR {psnr:.2f} dB"
    phase(name, t0,
          f"{detector}: {accepted}/{n} frames accepted, corner trajectory max err {traj_err:.4f} px, "
          f"launches {counts}, no device sync in windows 2-{N_WINDOWS}, kernel-vs-plain canvas "
          f"{canvases}; "
          f"{fps:.2f} frames/s (plain path {fps_plain:.2f}) over windows 2-{N_WINDOWS}, "
          f"window s {[round(s, 4) for s in secs]} on {card}")
    return counts, auxs, m, fps


def _copies(torch, fn) -> dict:
    """Kernel launches and copies by direction of one call of fn, from
    torch.profiler."""
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == cuda]
    return {"HtoD": sum(n.startswith("Memcpy HtoD") for n in names),
            "DtoH": sum(n.startswith("Memcpy DtoH") for n in names),
            "kernels": sum(not n.startswith(("Memcpy", "Memset")) for n in names)}


def phase_detect(torch, dev, frames: np.ndarray, card: str, model: str, window_run) -> dict:
    """BASELINE config 3 for one model: the stitch of phase `window` with the
    detection hoisted after it, over the whole clip. Returns the kernels'
    launch counts of the main-path run, its canvas, accepted frames and
    number of detections."""
    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.detect.detector import ObjectDetector
    from rtvm_tpu_torch.models.yolo.postprocess import Detections, match_detections
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic
    from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

    t0 = time.time()
    name = f"detect_{model}"
    path, n_leaves, n_values = DETECT_MODELS[model]
    check(os.path.exists(path), f"{name}: {path} is not in this checkout")
    tree = load_pytree_npz(path)
    got = (len(tree), sum(int(v.size) for v in tree.values()))
    check(got == (n_leaves, n_values), f"{name}: {path} holds {got} leaves/values, expected "
                                       f"{(n_leaves, n_values)}")
    det = ObjectDetector(model, weights_path=path, load_world=False, device=dev)
    check(det.weights_loaded and det.weights_source == path,
          f"{name}: weights_loaded {det.weights_loaded}, source {det.weights_source}")
    say(f"[{name}] {path}: {os.path.getsize(path)} bytes, {got[0]} leaves, {got[1]} values, "
        f"classes {det.class_names}")

    # the main path: stitch + detection over the clip, one process_clip call
    n = N_WINDOWS * WINDOW
    wins = torch.as_tensor(frames[1 : 1 + n]).reshape(N_WINDOWS, WINDOW, FRAME_H, FRAME_W, 3)
    wins = wins.to(dev)
    det_fn = det._infer_fn(DET_IMGSZ, DET_CONF, DET_IOU)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t = time.time()
    m = VideMosaic(frames[0], detector_type="sift", seed=SEED, device=dev)
    aux, dets = m.process_clip(wins, det_fn=det_fn)
    torch.cuda.synchronize()
    first_s = time.time() - t
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = window_launches(N_WINDOWS, N_WINDOWS + 1)
    check(counts == want, f"{name}: launch counts {counts}, expected {want}")

    _, w_auxs, w_m, w_fps = window_run
    w_ok = torch.stack([a.blended & a.ok for a in w_auxs])
    check(torch.equal(aux.blended & aux.ok, w_ok), f"{name}: accepted frames differ from `window`")
    h_err = float((aux.H_abs - torch.stack([a.H_abs for a in w_auxs])).abs().max())
    check(h_err <= H_ABS_SAME, f"{name}: H_abs differs from `window` by {h_err}")
    check(torch.equal(m.state.canvas, w_m.state.canvas), f"{name}: canvas differs from `window`")
    for f, v in dets._asdict().items():
        check(tuple(v.shape[:3]) == (N_WINDOWS, WINDOW, 300), f"{name}: {f} {tuple(v.shape)}")
    check(bool(torch.isfinite(dets.boxes[dets.valid]).all()), f"{name}: non-finite boxes")

    # warm: the same call timed twice, and the detection alone
    fps = []
    for _ in range(2):
        m2 = VideMosaic(frames[0], detector_type="sift", seed=SEED, device=dev)
        torch.cuda.synchronize()
        t = time.time()
        m2.process_clip(wins, det_fn=det_fn)
        torch.cuda.synchronize()
        fps.append(n / (time.time() - t))
    flat = wins.reshape((n,) + wins.shape[2:])
    det_ms = cuda_ms(torch, lambda: det_fn(flat), reps=5, warmup=1)
    cp = _copies(torch, lambda: det_fn(flat))
    det_launches, det_reads = cp["kernels"], cp["DtoH"]

    # 4 frames against the port's float32 run on the CPU
    pick = torch.tensor(DET_FRAMES)
    four = frames[1 : 1 + n][DET_FRAMES]
    ref = ObjectDetector(model, weights_path=path, load_world=False, device="cpu")
    (rb, rc), _ = ref.head_logits(four, DET_IMGSZ, torch.float32)
    ref_logits = torch.cat([t.flatten() for t in rb + rc])
    scale = float(ref_logits.abs().max())
    notes, failed = [], []
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        rel_max, share_min, gap_max = DET_BOUNDS[dtype_name]
        card_four = torch.as_tensor(four).to(dev)
        (cb, cc), _ = det.head_logits(card_four, DET_IMGSZ, dtype)
        rel = float((torch.cat([t.flatten() for t in cb + cc]).cpu() - ref_logits).abs().max())
        rel /= scale
        if rel > rel_max:
            failed.append(f"{dtype_name}: logits off by {rel:.3e} of the largest > {rel_max}")
        parts = [f"{dtype_name}: logits max |d| {rel:.3e} of max |logit| {scale:.2f}"]
        for conf in (DET_CONF, 0.01):
            want_d = ref._infer_fn(DET_IMGSZ, conf, DET_IOU, torch.float32)(four)
            if dtype == torch.bfloat16 and conf == DET_CONF:  # the clip run's own detections
                got_d = Detections(*(v.reshape((n,) + v.shape[2:])[pick.to(dev)] for v in dets))
            else:
                got_d = det._infer_fn(DET_IMGSZ, conf, DET_IOU, dtype)(card_four)
            a = match_detections(want_d, got_d)
            if a["share"] < share_min or a["max_score_gap"] > gap_max:
                failed.append(f"{dtype_name} conf {conf}: {a}")
            parts.append(f"conf {conf}: {a['matched_got']}/{a['n_got']} card and "
                         f"{a['matched_ref']}/{a['n_ref']} CPU detections matched, score gap "
                         f"{a['max_score_gap']:.3e}")
        notes.append("; ".join(parts))
    phase(name, t0,
          f"stitch equal to `window` (accepted frames, H_abs within {h_err:.1e}, canvas "
          f"identical), launches {counts}; detections {tuple(dets.boxes.shape)}, "
          f"{int(dets.valid.sum())} valid at conf {DET_CONF}; stitch + detection "
          f"{fps[0]:.2f} and {fps[1]:.2f} frames/s warm ({n / first_s:.2f} first call), "
          f"stitch alone "
          f"{w_fps:.2f} frames/s (`window`); detection {det_ms:.4f} ms per {n} frames "
          f"({det_launches} kernel launches, {det_reads} card-to-host reads); peak "
          f"{peak / 2**20:.1f} MiB allocated; vs the CPU float32 run on frames {DET_FRAMES}: "
          + " | ".join(notes) + f"; on {card}")
    check(not failed, f"{name}: beyond the bounds {DET_BOUNDS}: " + " | ".join(failed))
    return {"counts": counts, "canvas": m.state.canvas, "accepted": int(aux.ok.sum()),
            "n_dets": int(dets.valid.sum()),
            "dets": Detections(*(v.reshape((n,) + v.shape[2:]) for v in dets))}


def corner_error(H_abs: np.ndarray, shift: np.ndarray, hf: int = FRAME_H, wf: int = FRAME_W) -> float:
    """Largest distance of the frames' warped corners under H_abs [n, 3, 3]
    from the corners shifted by the known path, shift [n, 2] (x, y)."""
    corners = np.array([[0, 0, 1], [wf, 0, 1], [wf, hf, 1], [0, hf, 1]], np.float64).T
    got = np.einsum("bij,jk->bik", H_abs.astype(np.float64), corners)
    got = (got[:, :2] / got[:, 2:3]).transpose(0, 2, 1)
    return float(np.abs(got - (corners[:2].T[None] + shift[:, None, :])).max())


def jpeg_dims(path: str) -> tuple:
    """(height, width) of a JPEG file; fails unless it has SOI, EOI and SOF0."""
    from rtvm_tpu_torch.io.jpeg import jpeg_size

    with open(path, "rb") as f:
        data = f.read()
    try:
        return jpeg_size(data)
    except ValueError as e:
        raise CheckFailed(f"{path}: {e}") from e


class _Recorder:
    """Wraps ObjectDetector._run_pass, ObjectDetector._infer_fn and the
    driver's StageTimer to keep what the driver computed: each frame's
    detections (as dicts and as the raw Detections), the detector's
    checkpoint, the timer. Each pass is timed in three parts: the wait for
    the card's queued work before it (a synchronize), the inference with a
    synchronize after it, and the rest (the reads to the host and the dicts)."""

    def __init__(self, torch):
        from rtvm_tpu_torch.detect.detector import ObjectDetector
        from rtvm_tpu_torch.pipelines import mosaic_pipeline

        self.torch, self.cls, self.mod = torch, ObjectDetector, mosaic_pipeline
        self.per_frame, self.raw, self.sources, self.timers = [], [], set(), []
        self.pass_ms = []  # (wait, infer, reads and dicts) per pass

    def __enter__(self):
        run_pass, infer_fn, timer_cls = self.cls._run_pass, self.cls._infer_fn, self.mod.StageTimer
        rec, sync = self, self.torch.cuda.synchronize

        def infer(det, *a, **k):
            fn = infer_fn(det, *a, **k)

            def run(images):
                t = time.perf_counter()
                out = fn(images)
                sync()
                rec.infer_s = time.perf_counter() - t
                rec.raw.append(out)
                return out
            return run

        def recording(det, images, *a, **k):
            t0 = time.perf_counter()
            sync()
            t1 = time.perf_counter()
            out = run_pass(det, images, *a, **k)
            dt = time.perf_counter() - t1
            rec.pass_ms.append(((t1 - t0) * 1e3, rec.infer_s * 1e3, (dt - rec.infer_s) * 1e3))
            rec.per_frame.extend(out)
            rec.sources.add(det.weights_source)
            return out

        def timer(*a, **k):
            rec.timers.append(timer_cls(*a, **k))
            return rec.timers[-1]

        self.saved = run_pass, infer_fn, timer_cls
        self.cls._run_pass, self.cls._infer_fn, self.mod.StageTimer = recording, infer, timer
        return self

    def __exit__(self, *exc):
        self.cls._run_pass, self.cls._infer_fn, self.mod.StageTimer = self.saved


def phase_pipeline(torch, dev, clip: str, tmp: str, card: str, window_m, det11: dict) -> dict:
    """The CLI's mosaic command on the clip: BASELINE config 3 end to end.
    Returns the kernels' launch counts."""
    from rtvm_tpu_torch import cli, kernels
    from rtvm_tpu_torch.io.jpeg import encode_jpg
    from rtvm_tpu_torch.models.yolo.postprocess import Detections, match_detections
    from rtvm_tpu_torch.utils.image import crop_black_areas, scale_to_screen

    t0 = time.time()
    out = os.path.join(tmp, "out")
    argv = ["mosaic", clip, "--output-dir", out, "--detector", "sift", "--window", str(WINDOW),
            "--no-detect", "--no-nav", "--per-frame-detect"]
    with _Recorder(torch) as rec:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.time()
        m, stats = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t
        counts = launch_counts()
    n = N_WINDOWS * WINDOW
    want = window_launches(N_WINDOWS, N_WINDOWS + 1)
    check(counts == want, f"pipeline: launch counts {counts}, expected {want}")
    check(stats["frames"] == n + 1 and stats["accepted"] >= MIN_ACCEPTED,
          f"pipeline: stats {stats}")
    check(m.device.type == "cuda", f"pipeline: ran on {m.device}")
    check(torch.equal(m.state.canvas, window_m.state.canvas), "pipeline: canvas differs from `window`")
    check(len(rec.sources) == 1 and os.path.samefile(rec.sources.pop(), DETECT_MODELS["yolo11n"][0]),
          f"pipeline: the frame detector loaded {rec.sources}")
    shown = scale_to_screen(crop_black_areas(m.output_img_u8, threshold=80, margin=30))
    dims = jpeg_dims(os.path.join(out, "mosaic.jpg"))
    check(dims == shown.shape[:2], f"pipeline: mosaic.jpg is {dims}, the cropped mosaic "
                                   f"{shown.shape[:2]}")
    prog = jpeg_dims(os.path.join(out, "mosaic_progress.jpg"))
    check(prog == m.canvas_shape[:2], f"pipeline: mosaic_progress.jpg is {prog}")
    check(len(rec.per_frame) == n, f"pipeline: {len(rec.per_frame)} frames detected")
    want_files = [f"frame_{i + 1:05d}_detected.jpg" for i, d in enumerate(rec.per_frame) if d]
    files = sorted(os.listdir(os.path.join(out, "Detections")))
    check(files == want_files, f"pipeline: Detections/ holds {len(files)} files, "
                               f"{len(want_files)} frames have a detection")
    for f in files:
        d = jpeg_dims(os.path.join(out, "Detections", f))
        check(d == (FRAME_H, FRAME_W), f"pipeline: {f} is {d}")
    n_det = sum(len(d) for d in rec.per_frame)
    check(abs(n_det - det11["n_dets"]) <= 0.1 * det11["n_dets"],
          f"pipeline: {n_det} detections, `detect_yolo11n` {det11['n_dets']}")
    # frame by frame against `detect_yolo11n`'s: the same frames and weights,
    # batches of 16 here and of 48 there
    raw = Detections(*(torch.cat(v) for v in zip(*rec.raw)))
    check(raw.boxes.shape[0] == n and int(raw.valid.sum()) == n_det,
          f"pipeline: raw detections {tuple(raw.boxes.shape)}, {int(raw.valid.sum())} valid")
    agree = match_detections(det11["dets"], raw)
    _, share_min, gap_max = DET_BOUNDS["bfloat16"]
    check(agree["share"] >= share_min and agree["max_score_gap"] <= gap_max,
          f"pipeline: detections against `detect_yolo11n`'s frame by frame {agree}")
    tm = rec.timers[0]
    stage = {k: (tm.totals[k] * 1e3, tm.counts[k]) for k in ("window", "detect", "draw", "export",
                                                               "mosaic_jpg")}
    # the JPEG writer alone on the host, on a frame of the clip and on a
    # 1080x1920 image of 3x3 such frames
    frame = np.array(np.load(clip, mmap_mode="r")[1])
    jpg_ms = {}
    for size, img, reps in (("360x640", frame, 5), ("1080x1920", np.tile(frame, (3, 3, 1)), 2)):
        encode_jpg(img)
        t = time.perf_counter()
        for _ in range(reps):
            encode_jpg(img)
        jpg_ms[size] = (time.perf_counter() - t) / reps * 1e3
    phase("pipeline", t0,
          f"{stats['frames']} frames, {stats['accepted']} accepted, launches {counts}, canvas "
          f"identical to `window`; mosaic.jpg {dims}, mosaic_progress.jpg {prog}, "
          f"{len(files)} Detections/ files; {n_det} detections (`detect_yolo11n` "
          f"{det11['n_dets']}; frame by frame {agree['matched_got']}/{agree['n_got']} here and "
          f"{agree['matched_ref']}/{agree['n_ref']} there matched, score gap "
          f"{agree['max_score_gap']:.3e}); wall {wall:.3f} s, {stats['frames'] / wall:.2f} "
          f"frames/s (driver's fps {stats['fps']:.2f}); stages ms (calls): "
          + ", ".join(f"{k} {v[0]:.1f} ({v[1]})" for k, v in stage.items())
          + "; detect passes ms (wait for queued work, inference synced, reads and dicts): "
          + ", ".join(f"({a:.1f}, {b:.1f}, {c:.1f})" for a, b, c in rec.pass_ms)
          + f"; JPEG {stage['export'][0] / max(stage['export'][1], 1):.2f} ms and drawing "
          f"{stage['draw'][0] / max(stage['draw'][1], 1):.2f} ms a frame; the JPEG writer alone "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in jpg_ms.items()) + f" on the host; on {card}")
    return counts


def phase_pipeline_fused(torch, clip: str, card: str, det11: dict) -> dict:
    """run_mosaic(fused=True) with YOLO11n inside the clip call, on the
    default device. Returns the kernels' launch counts."""
    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.config import MosaicConfig
    from rtvm_tpu_torch.detect.detector import ObjectDetector
    from rtvm_tpu_torch.pipelines.mosaic_pipeline import run_mosaic

    t0 = time.time()
    det = ObjectDetector("yolo11n", load_world=False)
    check(det.weights_loaded, "pipeline_fused: no YOLO11n checkpoint")
    calls = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    m, stats = run_mosaic(clip, config=MosaicConfig(window_size=WINDOW), fused=True,
                          per_frame_detector=det,
                          update_callback=lambda fc, img, pct: calls.append((fc, img.shape, pct)))
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = launch_counts()
    want = window_launches(N_WINDOWS, N_WINDOWS + 1)
    check(counts == want, f"pipeline_fused: launch counts {counts}, expected {want}")
    check(stats["fused_windows"] == N_WINDOWS, f"pipeline_fused: stats {stats}")
    check(stats["accepted"] == det11["accepted"],
          f"pipeline_fused: {stats['accepted']} accepted, `detect_yolo11n` {det11['accepted']}")
    check(torch.equal(m.state.canvas, det11["canvas"]),
          "pipeline_fused: canvas differs from `detect_yolo11n`")
    check(stats["det_scores_shape"] == (N_WINDOWS, WINDOW, 300), f"pipeline_fused: {stats}")
    fcs = [c[0] for c in calls]
    check(len(calls) >= 2 and fcs == sorted(fcs) and calls[-1][2] == 100.0
          and all(c[1] == m.output_img_u8.shape and 0 <= c[2] <= 100 for c in calls),
          f"pipeline_fused: callbacks {calls}")
    phase("pipeline_fused", t0,
          f"{stats['frames']} frames, {stats['accepted']} accepted, {stats['fused_windows']} "
          f"fused windows, launches {counts}, canvas identical to `detect_yolo11n`, detections "
          f"{stats['det_scores_shape']}, callbacks {[(c[0], round(c[2], 1)) for c in calls]}; "
          f"wall {wall:.3f} s, {stats['frames'] / wall:.2f} frames/s (steady "
          f"{stats.get('steady_fps', float('nan')):.2f}); on {card}")
    return counts


def phase_grow(torch, dev, tmp: str, card: str) -> dict:
    """auto_grow on a clip that leaves the default canvas: the window loop
    (growth by _maybe_grow), then the fused path on a pre-scanned canvas.
    Returns the kernels' launch counts of both runs."""
    import dataclasses
    import warnings

    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.config import MosaicConfig
    from rtvm_tpu_torch.mosaic.prescan import prescan_canvas_from_video
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic
    from rtvm_tpu_torch.ops.kernel_warp import inverse_maps, warp_batch, warp_plain
    from rtvm_tpu_torch.pipelines.mosaic_pipeline import run_mosaic

    t0 = time.time()
    n = N_WINDOWS * WINDOW
    frames, cam = make_clip(np.random.RandomState(SEED + 1), n + 1, FRAME_H, FRAME_W, GROW_STEP)
    clip = os.path.join(tmp, "grow.npy")
    np.save(clip, frames)
    default = (2 * FRAME_H, int(1.2 * FRAME_W))
    cfg = MosaicConfig(auto_grow=True, window_size=WINDOW)
    shift = cam[1 : n + 1] - cam[0]

    def warp_equal(win_frames, H_abs, hc, wc, what):
        fr = torch.as_tensor(win_frames, device=dev).to(torch.float32).permute(0, 3, 1, 2)
        G = inverse_maps(H_abs.to(dev)).contiguous()
        out_k, out_p = warp_batch(fr.contiguous(), G, hc, wc), warp_plain(fr.contiguous(), G, hc, wc)
        err = float((out_k - out_p).abs().max())
        check(torch.equal(out_k, out_p), f"grow {what}: warp kernel vs plain max |d| {err}")

    # the window loop: growth after each window's step
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    m = VideMosaic(frames[0], detector_type="sift", config=cfg, seed=SEED, device=dev)
    H_abs, ok, want_c, syncs, before = [], [], [], [], []
    for wi in range(N_WINDOWS):
        win = torch.as_tensor(frames[1 + wi * WINDOW : 1 + (wi + 1) * WINDOW]).to(dev)
        before.append((m.canvas_shape, m.h_offset, m.w_offset))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                aux = m.process_window(win)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs.append(sum("synchroniz" in str(c.message) for c in caught))
        H_abs.append(aux.H_abs)
        ok.append(aux.blended & aux.ok)
        want_c.append(shift[wi * WINDOW : (wi + 1) * WINDOW] + np.array([before[-1][1], before[-1][2]]))
    torch.cuda.synchronize()
    wall_w = time.time() - t
    counts = launch_counts()
    accepted = int(torch.cat(ok).sum())
    check(accepted >= MIN_ACCEPTED, f"grow: window loop accepted {accepted} of {n}")
    err_w = corner_error(torch.cat(H_abs).cpu().numpy(), np.concatenate(want_c))
    check(err_w <= TRAJ_TOL_PX, f"grow: window loop corners off by {err_w:.3f} px")
    grown = sum(b[0] != a[0] for a, b in zip(before, before[1:] + [(m.canvas_shape,)]))
    check(grown >= 1 and m.canvas_shape[1] > default[1],
          f"grow: canvas {m.canvas_shape} after the window loop, grown {grown} times")
    check(max(syncs) <= 1, f"grow: device syncs per window {syncs}")
    (hc, wc, _), _, _ = before[-1]
    warp_equal(frames[1 + (N_WINDOWS - 1) * WINDOW : 1 + n], H_abs[-1], hc, wc, "window loop")

    # the fused path, on the canvas the pre-scan sizes
    kernels.reset_launches()
    t = time.time()
    mf, stats = run_mosaic(clip, config=cfg, fused=True)
    torch.cuda.synchronize()
    wall_f = time.time() - t
    counts = add_launches(counts, launch_counts())
    t = time.time()
    pre = prescan_canvas_from_video(clip)
    prescan_s = time.time() - t
    check(pre is not None and mf.canvas_shape[:2] == pre[0] and stats["fused_windows"] == N_WINDOWS,
          f"grow: fused run on {mf.canvas_shape}, pre-scan {pre}, stats {stats}")
    check(stats["accepted"] >= MIN_ACCEPTED and pre[0][1] > default[1],
          f"grow: fused {stats}, pre-scanned canvas {pre[0]}")
    # the same stitch by hand, for its H_abs (not counted as main-path launches)
    fixed = dataclasses.replace(cfg, canvas_hw=pre[0], seed_offset=pre[1], auto_grow=False)
    mh = VideMosaic(frames[0], detector_type="sift", config=fixed, seed=SEED, device=dev)
    aux = mh.process_clip(torch.as_tensor(frames[1 : 1 + n]).reshape(
        N_WINDOWS, WINDOW, FRAME_H, FRAME_W, 3).to(dev))
    check(torch.equal(mh.state.canvas, mf.state.canvas), "grow: fused run and process_clip differ")
    err_f = corner_error(aux.H_abs.reshape(n, 3, 3).cpu().numpy(),
                         shift + np.array([mh.h_offset, mh.w_offset]))
    check(err_f <= TRAJ_TOL_PX, f"grow: pre-scanned canvas corners off by {err_f:.3f} px")
    warp_equal(frames[1 + n - WINDOW : 1 + n], aux.H_abs[-1], pre[0][0], pre[0][1], "pre-scan")
    want = window_launches(2 * N_WINDOWS, 2 * (N_WINDOWS + 1))
    check(counts == want, f"grow: launch counts {counts}, expected {want}")
    phase("grow", t0,
          f"drift {GROW_STEP} px a frame; window loop: {accepted}/{n} accepted, canvas "
          f"{default} -> {m.canvas_shape[:2]} ({grown} growths), corners within {err_w:.4f} px, "
          f"device syncs per window {syncs}, {n / wall_w:.2f} frames/s; fused on the "
          f"pre-scanned canvas {pre[0]} (seed offset {pre[1]}): {stats['accepted']}/{n} accepted, "
          f"corners within {err_f:.4f} px, {stats['frames'] / wall_f:.2f} frames/s with the "
          f"pre-scan, the pre-scan alone {prescan_s * 1e3:.1f} ms; launches {counts}; kernel A "
          f"bitwise equal to warp_plain on both canvases; on {card}")
    return counts


NAV_WORLD_NPZ = "weights/yolov8n_world.npz"
NAV_OUTPUTS = ("mosaic.jpg", "mosaic_progress.jpg", "debug_watershed.jpg", "debug_texture_mask.jpg",
               "navigation_map.jpg")
# the detection on the mosaic on the card against the port's float32 run on
# the CPU: the world model and the classical masks run in float32 on both, so
# (least share matched at IoU >= 0.9 with the same class, largest score gap);
# the closed-set tile pass is bf16 on the card: DET_BOUNDS["bfloat16"]
NAV_WORLD_MATCH = (0.99, 1e-3)
NAV_CLASSICAL_MATCH = (0.9, 0.05)  # the classical detectors: masks at float thresholds
NAV_MIN_EQUAL = 0.999  # nav_blocked, card against CPU


def make_nav_world(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A BGR uint8 world for the navigation map: low-frequency ground,
    sparse coloured rectangles (corners for SIFT, edges for the texture
    mask), flat gray roofs (for the classical building detector and the
    routes) and bright car-sized blobs (for the vehicle detector)."""
    coarse = rng.uniform(0, 255, (h // 16 + 2, w // 16 + 2, 3))
    coarse = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w]
    img = _blur_axis(_blur_axis(coarse, 6.0, 0), 6.0, 1) * 0.5 + 60
    for _ in range(h * w // 2500):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
        img[y : y + rng.randint(6, 30), x : x + rng.randint(6, 30)] = rng.uniform(0, 255, 3)
    for _ in range(8):  # gray roofs
        y, x = rng.randint(0, h - 120), rng.randint(0, w - 90)
        img[y : y + rng.randint(45, 80), x : x + rng.randint(45, 80)] = rng.uniform(110, 190)
    for _ in range(10):  # bright blobs
        y, x = rng.randint(0, h - 30), rng.randint(0, w - 30)
        img[y : y + rng.randint(10, 20), x : x + rng.randint(14, 26)] = (235, 235, 240)
    return np.clip(img, 0, 255).astype(np.uint8)


class _Patches:
    """Attribute replacements undone in reverse order."""

    def __init__(self):
        self.saved = []

    def set(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved = []


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _record_detection(torch, patches: _Patches, rec: dict) -> None:
    """Times each part of ObjectDetector.detect_objects (the card
    synchronized before and after) and keeps its result: rec[part] is a list
    of (seconds, result). Parts: world (the full image with flip TTA), clahe
    (the enhancement) and clahe_world (its pass), tiles_world and
    tiles_closed (the tile batch through both models), buildings and
    vehicles (the classical detectors), detect_objects (the whole; its
    detector and image in rec["args"])."""
    import rtvm_tpu_torch.detect.detector as dmod
    from rtvm_tpu_torch.models.yolo.world import YoloWorldDetector

    def timed(name, fn):
        def run(*a, **k):
            _sync(torch)
            t = time.perf_counter()
            out = fn(*a, **k)
            _sync(torch)
            # a copy: detect_objects goes on to move and rescale the dicts
            rec.setdefault(name, []).append((time.perf_counter() - t, copy.deepcopy(out)))
            return out
        return run

    predict = YoloWorldDetector.predict

    def world_predict(self, image, **k):
        return timed("world" if k.get("augment") else "clahe_world", predict)(self, image, **k)

    detect_objects = dmod.ObjectDetector.detect_objects

    def whole(self, image, **k):
        rec.setdefault("args", []).append((self, image))
        return timed("detect_objects", detect_objects)(self, image, **k)

    patches.set(YoloWorldDetector, "predict", world_predict)
    patches.set(YoloWorldDetector, "predict_batch",
                timed("tiles_world", YoloWorldDetector.predict_batch))
    patches.set(dmod.ObjectDetector, "_run_pass", timed("tiles_closed", dmod.ObjectDetector._run_pass))
    patches.set(dmod.ObjectDetector, "detect_objects", whole)
    patches.set(dmod, "enhance_for_detection", timed("clahe", dmod.enhance_for_detection))
    patches.set(dmod, "detect_buildings_classical", timed("buildings", dmod.detect_buildings_classical))
    patches.set(dmod, "detect_vehicles_classical", timed("vehicles", dmod.detect_vehicles_classical))


def _dict_share(want: list, got: list, iou_min: float, gap: float) -> float:
    """The smaller of the two lists' shares of detections that the other
    has with the same class at IoU >= iou_min and a score gap <= gap."""
    def iou(a, b):
        ix1, iy1, ix2, iy2 = max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), min(a[3], b[3])
        inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
        return inter / max((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter,
                           1e-9)

    def share(x, y):
        if not x:
            return 1.0
        return sum(any(d["class"] == e["class"] and iou(d["bbox"], e["bbox"]) >= iou_min
                       and abs(d["confidence"] - e["confidence"]) <= gap for e in y)
                   for d in x) / len(x)

    return min(share(want, got), share(got, want))


def _part_ms(rec: dict, part: str, i: int = 0) -> float:
    return rec[part][i][0] * 1e3 if part in rec and len(rec[part]) > i else 0.0


def phase_navigate(torch, dev, tmp: str, card: str) -> dict:
    """BASELINE config 4: the CLI's mosaic command with its defaults (the
    detection on the mosaic and the navigation map) on a clip that grows the
    canvas past 800 px, so that the tile pass runs. Returns the kernels'
    launch counts."""
    import dataclasses

    import rtvm_tpu_torch.config as config_mod
    import rtvm_tpu_torch.mosaic.stitcher as stitcher_mod
    from rtvm_tpu_torch import cli, kernels
    from rtvm_tpu_torch.detect.detector import ObjectDetector
    from rtvm_tpu_torch.navigate import native
    from rtvm_tpu_torch.navigate.mapping import analyze_for_navigation
    from rtvm_tpu_torch.navigate.obstacles import build_obstacle_masks
    from rtvm_tpu_torch.pipelines import mosaic_pipeline

    t0 = time.time()
    check(os.path.exists(NAV_WORLD_NPZ), f"navigate: {NAV_WORLD_NPZ} is not in this checkout")
    n = N_WINDOWS * WINDOW
    path = camera_path(n + 1, GROW_STEP)
    world = make_nav_world(np.random.RandomState(SEED + 2), FRAME_H + int(path[:, 1].max()) + 8,
                           FRAME_W + int(path[:, 0].max()) + 8)
    frames = np.stack([world[y : y + FRAME_H, x : x + FRAME_W] for x, y in path])
    clip = os.path.join(tmp, "navigate.npy")
    np.save(clip, frames)
    out = os.path.join(tmp, "navigate_out")
    argv = ["mosaic", clip, "--output-dir", out, "--detector", "sift", "--window", str(WINDOW)]

    rec, timers, progress = {}, [], []
    patches = _Patches()
    real_cfg, real_timer, real_jpg = (config_mod.PipelineConfig, mosaic_pipeline.StageTimer,
                                      stitcher_mod.imwrite_jpg)

    def pipeline_config(mosaic, **k):  # auto_grow through the CLI's PipelineConfig
        return real_cfg(mosaic=dataclasses.replace(mosaic, auto_grow=True), **k)

    def timer(*a, **k):
        timers.append(real_timer(*a, **k))
        return timers[-1]

    def progress_jpg(p, img, *a, **k):
        progress.append(img.shape[:2])
        return real_jpg(p, img, *a, **k)

    patches.set(config_mod, "PipelineConfig", pipeline_config)
    patches.set(mosaic_pipeline, "StageTimer", timer)
    patches.set(stitcher_mod, "imwrite_jpg", progress_jpg)
    _record_detection(torch, patches, rec)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        native.calls["astar"] = 0
        t = time.time()
        m, stats = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t
        counts, astar_calls = launch_counts(), native.calls["astar"]
        peak = torch.cuda.max_memory_allocated()
    finally:
        patches.undo()
    want = window_launches(N_WINDOWS, N_WINDOWS + 1)
    check(counts == want, f"navigate: launch counts {counts}, expected {want}")
    check(m.device.type == "cuda" and m.config.auto_grow, f"navigate: {m.device}, {m.config}")
    check(stats["frames"] == n + 1 and stats["accepted"] >= MIN_ACCEPTED, f"navigate: stats {stats}")
    check(m.canvas_shape[1] > int(1.2 * FRAME_W), f"navigate: canvas {m.canvas_shape} did not grow")
    (det, image), = rec["args"]
    (_, dets), = rec["detect_objects"]
    check(det.model_world is not None and det.model_world.is_open_vocab
          and os.path.samefile(det.model_world.weights_source, NAV_WORLD_NPZ),
          f"navigate: the world model is {det.model_world and det.model_world.weights_source}")
    check(max(image.shape[:2]) > 800, f"navigate: mosaic {image.shape}, no tiles")
    n_tiles = len(rec["tiles_world"][0][1])
    check(n_tiles >= 2 and len(rec["tiles_closed"][0][1]) == n_tiles, f"navigate: {n_tiles} tiles")
    n_build = sum(d["class"] == "building" and d.get("source") == "classical" for d in dets)
    check(n_build >= 1, "navigate: no classical building on the mosaic")
    check(astar_calls >= 1, "navigate: the native A* router was not called")
    check(stats["detections"] == len(dets), f"navigate: stats {stats}, {len(dets)} detections")
    dims = {f: jpeg_dims(os.path.join(out, f)) for f in NAV_OUTPUTS}
    for f in NAV_OUTPUTS:
        want_dims = progress[-1] if f == "mosaic_progress.jpg" else image.shape[:2]
        check(dims[f] == tuple(want_dims), f"navigate: {f} is {dims[f]}, expected {want_dims}")

    # the same image on the card again (warm), then on the CPU in float32
    again = {}
    _record_detection(torch, patches, again)
    try:
        torch.cuda.reset_peak_memory_stats()
        det.detect_objects(image)
        det_peak = torch.cuda.max_memory_allocated()
        ref = ObjectDetector("yolo11n", device="cpu")
        ref._infer_fn = lambda imgsz, conf, iou: ObjectDetector._infer_fn(ref, imgsz, conf, iou,
                                                                         torch.float32)
        cpu = {}
        patches.undo()
        _record_detection(torch, patches, cpu)
        ref.detect_objects(image)
    finally:
        patches.undo()
    _, bf_share, bf_gap = DET_BOUNDS["bfloat16"]
    agree, failed = {}, []
    for part, (smin, g) in (("world", NAV_WORLD_MATCH), ("clahe_world", NAV_WORLD_MATCH),
                            ("tiles_world", NAV_WORLD_MATCH), ("tiles_closed", (bf_share, bf_gap)),
                            ("buildings", NAV_CLASSICAL_MATCH), ("vehicles", NAV_CLASSICAL_MATCH)):
        a, b = rec[part][0][1], cpu[part][0][1]
        if part.startswith("tiles"):
            a, b = sum(a, []), sum(b, [])
        agree[part] = (_dict_share(b, a, 0.9, g), len(a), len(b))
        if agree[part][0] < smin:
            failed.append(f"{part} {agree[part]}")
    check(not failed, f"navigate: card against the CPU float32 run: " + ", ".join(failed))
    w_card, nav_card = build_obstacle_masks(image, dets, device=dev)
    w_cpu, nav_cpu = build_obstacle_masks(image, dets, device="cpu")
    nav_equal = float((nav_card == nav_cpu).mean())
    w_err = float(np.abs(w_card - w_cpu).max())
    check(nav_equal >= NAV_MIN_EQUAL and w_err <= 1e-6,
          f"navigate: nav_blocked equal on {nav_equal:.6f}, weights off by {w_err}")
    t = time.perf_counter()
    analyze_for_navigation(image, dets, device=dev)
    nav_warm = (time.perf_counter() - t) * 1e3

    tm = timers[0]
    stage = {k: tm.totals.get(k, 0.0) * 1e3 for k in ("window", "mosaic_jpg", "detect_init",
                                                       "detect_mosaic", "navigate", "navigation_jpg")}
    parts = ("world", "clahe", "clahe_world", "tiles_world", "tiles_closed", "buildings", "vehicles",
             "detect_objects")
    phase("navigate", t0,
          f"{stats['frames']} frames, {stats['accepted']} accepted, canvas {m.canvas_shape[:2]}, "
          f"launches {counts}; mosaic {image.shape[:2]}, {n_tiles} tiles, {len(dets)} detections "
          f"({n_build} classical buildings), native A* calls {astar_calls}; outputs "
          + ", ".join(f"{f} {dims[f]}" for f in NAV_OUTPUTS)
          + f"; wall {wall:.3f} s; stages ms: " + ", ".join(f"{k} {v:.1f}" for k, v in stage.items())
          + "; detect_mosaic parts ms (first call / warm): "
          + ", ".join(f"{p} {_part_ms(rec, p):.1f}/{_part_ms(again, p):.1f}" for p in parts)
          + f"; navigate warm {nav_warm:.1f} ms; peak {peak / 2**20:.1f} MiB allocated over the "
          f"run, {det_peak / 2**20:.1f} MiB in detect_objects; card against CPU float32 "
          "(share, card, CPU): " + ", ".join(f"{k} ({v[0]:.4f}, {v[1]}, {v[2]})"
                                            for k, v in agree.items())
          + f"; nav_blocked equal on {nav_equal:.6f}, weights max |d| {w_err:.1e}; on {card}")
    return counts


# ----------------------------------------------------------------- slice 7


def phase_surface(torch, dev, frames: np.ndarray, m, auxs, tmp: str, card: str) -> dict:
    """The rest of the VideMosaic surface on the SIFT clip's state after
    phase `window`: warp of one frame (kernel A once, equal to the same call
    with warp_plain), findHomography on noiseless correspondences of a known
    H, validate_homography and smooth_homography against a CPU stitcher,
    and run_mosaic(visualize=True)'s matches.jpg. The state is put back
    afterwards. Returns the launch counts of the warp call and of the
    visualize run."""
    import rtvm_tpu_torch.ops.warp as warp_ops
    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.config import MosaicConfig
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic
    from rtvm_tpu_torch.ops.kernel_warp import warp_plain
    from rtvm_tpu_torch.pipelines.mosaic_pipeline import run_mosaic

    t0 = time.time()
    n = N_WINDOWS * WINDOW
    saved = m.state
    H = auxs[-1].H_abs[-1]  # the last frame's pose: painted once more
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    m.warp(frames[n], H)
    warp_ms = (time.perf_counter() - t) * 1e3
    warp_counts = launch_counts()
    check(warp_counts == window_launches(1),
          f"surface: warp launches {warp_counts}")
    got = (m.state.canvas, m.state.union_coarse)
    check(bool(torch.isfinite(got[0]).all()), "surface: non-finite canvas after warp")
    m.state = saved
    real = warp_ops.warp_batch
    warp_ops.warp_batch = warp_plain
    try:
        m.warp(frames[n], H)
    finally:
        warp_ops.warp_batch = real
    check(torch.equal(got[0], m.state.canvas) and torch.equal(got[1], m.state.union_coarse),
          "surface: warp through kernel A differs from the same call with warp_plain")
    m.state = saved

    # findHomography on the card: noiseless correspondences of a known H
    H_true = np.array([[1.01, 0.02, 30.5], [-0.015, 0.99, -12.25], [2e-5, -1e-5, 1.0]])
    src = np.random.RandomState(SEED + 5).uniform([0, 0], [FRAME_W, FRAME_H], (200, 2))
    p = np.c_[src, np.ones(200)] @ H_true.T
    dst = p[:, :2] / p[:, 2:]
    Hf, inl = VideMosaic.findHomography(src.astype(np.float32), dst.astype(np.float32), seed=SEED,
                                        device=dev)
    h_err = float(np.abs(Hf / Hf[2, 2] - H_true).max())
    check(h_err <= 1e-3 and inl.all(), f"surface: findHomography off by {h_err}, "
                                       f"{int(inl.sum())}/200 inliers")

    # validate_homography and smooth_homography against a CPU stitcher
    cpu_m = VideMosaic(frames[0], detector_type="orb", seed=SEED, device="cpu")
    cases = [np.eye(3)] + [np.array([[1, 0, t], [0, 1, 0], [0, 0, 1]]) for t in (49.9, 50.0, 50.1)]
    cases += [np.array([[s_, 0, 1], [0, s_, 1], [0, 0, 1]]) for s_ in (0.69, 0.7, 1.3, 1.31)]
    cases += [np.array([[1, 0, 0], [0, 1, 0], [q, 0, 1]]) for q in (9.99e-4, 1e-3, 1.001e-3)]
    cases = [c.astype(np.float32) for c in cases]
    v_card = [m.validate_homography(c) for c in cases]
    v_cpu = [cpu_m.validate_homography(c) for c in cases]
    check(v_card == v_cpu and 0 < sum(v_card) < len(cases),
          f"surface: validate_homography card {v_card}, CPU {v_cpu}")
    # the same history on both (the card's holds the window run's)
    cpu_m.state = cpu_m.state._replace(hbuf=m.state.hbuf.cpu(), hcount=m.state.hcount.cpu())
    rng = np.random.RandomState(SEED + 6)
    s_err = 0.0
    for _ in range(8):
        Hs = (np.eye(3) + rng.randn(3, 3) * [[0.01, 0.01, 2], [0.01, 0.01, 2], [1e-5, 1e-5, 0]])
        Hs = Hs.astype(np.float32)
        s_err = max(s_err, float(np.abs(m.smooth_homography(Hs) - cpu_m.smooth_homography(Hs)).max()))
    same_hist = bool(np.array_equal(m.state.hbuf.cpu().numpy(), cpu_m.state.hbuf.numpy()))
    check(s_err <= 1e-6 and same_hist and int(m.state.hcount) == int(cpu_m.state.hcount),
          f"surface: smooth_homography off by {s_err}, history equal {same_hist}")
    m.state = saved

    # run_mosaic(visualize=True): matches.jpg of the first window's last pair
    clip = os.path.join(tmp, "surface.npy")
    np.save(clip, frames)
    viz = os.path.join(tmp, "surface_viz")
    kernels.reset_launches()
    run_mosaic(clip, config=MosaicConfig(window_size=WINDOW), detector_type="sift", visualize=True,
               viz_dir=viz)
    torch.cuda.synchronize()
    viz_counts = launch_counts()
    # the stitch's 3 and 4, and one patch launch for render_matches' two frames
    want = window_launches(N_WINDOWS, N_WINDOWS + 2)
    check(viz_counts == want, f"surface: visualize run launches {viz_counts}, expected {want}")
    dims = jpeg_dims(os.path.join(viz, "matches.jpg"))
    check(dims == (FRAME_H, 2 * FRAME_W) and os.listdir(viz) == ["matches.jpg"],
          f"surface: {os.listdir(viz)}, matches.jpg {dims}")
    phase("surface", t0,
          f"warp of frame {n}: launches {warp_counts}, canvas equal to warp_plain's, "
          f"{warp_ms:.2f} ms; findHomography within {h_err:.2e} of H, 200/200 inliers; "
          f"validate_homography equal to the CPU's on {len(cases)} H's; smooth_homography "
          f"within {s_err:.1e} over 8 calls, history equal; visualize run: launches "
          f"{viz_counts}, matches.jpg {dims}; on {card}")
    return {"surface": warp_counts, "surface_viz": viz_counts}


def _png_stored(img_bgr: np.ndarray) -> bytes:
    """A minimal RGB PNG of a BGR image: filter 0 rows, stored deflate."""
    import struct
    import zlib

    h, w, _ = img_bgr.shape
    raw = b"".join(b"\x00" + img_bgr[y, :, ::-1].tobytes() for y in range(h))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 0)) + chunk(b"IEND", b""))


IMAGES_MIN_JPEG_PSNR = 32.0  # io/jpeg.py's round trip of these images: 33.11 and 33.87 dB on a CPU


def _by_source(dets: list) -> dict:
    out = {"world": [], "yolo": [], "classical": []}
    for d in dets:
        out[d.get("source", "world")].append(d)
    return out


def phase_images(torch, dev, tmp: str, card: str) -> dict:
    """The CLI's mosaic --images-dir on three seeded 360x640 images (two
    JPEGs from io/jpeg.py, one stored-deflate PNG): the six Detections/
    files and their sizes, the decoded images against the sources, each
    image's open-vocabulary and classical detections against the port's
    float32 run on the CPU (images this small get no closed-set pass)."""
    from rtvm_tpu_torch import cli
    from rtvm_tpu_torch.config import PipelineConfig
    from rtvm_tpu_torch.detect.detector import ObjectDetector
    from rtvm_tpu_torch.io.imread import imread
    from rtvm_tpu_torch.io.jpeg import encode_jpg
    from rtvm_tpu_torch.utils.image import psnr

    t0 = time.time()
    world = make_nav_world(np.random.RandomState(SEED + 3), FRAME_H, 3 * FRAME_W)
    imgs = {"a.jpg": world[:, :FRAME_W], "b.jpg": world[:, FRAME_W : 2 * FRAME_W],
            "c.png": world[:, 2 * FRAME_W :]}
    src = os.path.join(tmp, "images")
    os.makedirs(src)
    for name, img in imgs.items():
        img = np.ascontiguousarray(img)
        imgs[name] = img
        with open(os.path.join(src, name), "wb") as f:
            f.write(_png_stored(img) if name.endswith(".png") else encode_jpg(img))
    decoded = {name: imread(os.path.join(src, name)) for name in imgs}
    decode_ms = {}
    for name in imgs:  # the reader runs on the host: the best of 3
        times = []
        for _ in range(3):
            t = time.perf_counter()
            imread(os.path.join(src, name))
            times.append((time.perf_counter() - t) * 1e3)
        decode_ms[name] = min(times)
    check(np.array_equal(decoded["c.png"], imgs["c.png"]), "images: the PNG does not decode to its source")
    jpeg_db = {n: psnr(decoded[n], imgs[n]) for n in ("a.jpg", "b.jpg")}
    check(min(jpeg_db.values()) >= IMAGES_MIN_JPEG_PSNR, f"images: JPEG round trip PSNR {jpeg_db}")

    out = os.path.join(tmp, "images_out")
    t = time.time()
    res, counts = counted(lambda: cli.main(["mosaic", "--images-dir", src, "--output-dir", out]))
    torch.cuda.synchronize()
    wall = time.time() - t
    check(counts == NO_LAUNCHES, f"images: launch counts {counts}")
    files = sorted(os.listdir(os.path.join(out, "Detections")))
    want_files = sorted(f"{os.path.splitext(n)[0]}_{k}.jpg" for n in imgs for k in ("detected", "navigation"))
    check(files == want_files, f"images: Detections/ holds {files}")
    for f in files:
        dims = jpeg_dims(os.path.join(out, "Detections", f))
        check(dims == (FRAME_H, FRAME_W), f"images: {f} is {dims}")
    check([os.path.basename(r["image"]) for r in res] == sorted(imgs), f"images: results {res}")

    ref = ObjectDetector(model=PipelineConfig().detect.model, device="cpu")
    ref._infer_fn = lambda imgsz, conf, iou: ObjectDetector._infer_fn(ref, imgsz, conf, iou,
                                                                     torch.float32)
    # detect_objects runs its closed-set YOLO pass only on the tiles of an
    # image wider or taller than 800 px; at 360x640 it does not run (phase
    # navigate holds that pass against the CPU on the mosaic's tiles)
    bounds = {"world": NAV_WORLD_MATCH, "classical": NAV_CLASSICAL_MATCH}
    agree, failed = {}, []
    for r in res:
        name = os.path.basename(r["image"])
        want = _by_source(ref.detect_objects(decoded[name]))
        got = _by_source(r["detections"])
        check(not got["yolo"] and not want["yolo"], f"images: a closed-set pass ran on {name}")
        for k, (smin, gap) in bounds.items():
            share = _dict_share(want[k], got[k], 0.9, gap)
            agree[f"{name} {k}"] = (round(share, 4), len(got[k]), len(want[k]))
            if share < smin:
                failed.append(f"{name} {k} {agree[f'{name} {k}']}")
    check(not failed, "images: card against the CPU float32 run: " + ", ".join(failed))
    n_det = sum(len(r["detections"]) for r in res)
    check(n_det >= 3, f"images: {n_det} detections on three images")
    phase("images", t0,
          f"3 images (JPEG PSNR {', '.join(f'{k} {v:.2f} dB' for k, v in jpeg_db.items())}, PNG "
          f"equal), decoded on the host in " + ", ".join(f"{k} {v:.1f} ms" for k, v in decode_ms.items())
          + f"; the CLI's --images-dir in {wall:.3f} s: {len(files)} files of "
          f"{FRAME_H}x{FRAME_W}, {n_det} detections; card against CPU float32 (share, card, CPU): "
          + ", ".join(f"{k} {v}" for k, v in agree.items()) + f"; launches {counts}; on {card}")
    return counts


STREAM_H, STREAM_W = 1080, 1920  # BASELINE config 5
STREAM_STEP = (18, -12)  # px a frame: `grow`'s (6, -4) at 3x the frame size
STREAM_DET = ("yolov8l", "weights/yolov8l_aerial.npz", (768, 1280))
STREAM_DET_FRAMES = [0, 40]


def make_stream_world(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A 1080p-scale BGR world: make_world at a third of the size,
    upsampled 3x (bilinear), with sparse sharp rectangles at full size."""
    import torch

    base = make_world(rng, h // 3 + 2, w // 3 + 2)
    up = torch.nn.functional.interpolate(torch.from_numpy(base).permute(2, 0, 1)[None].float(),
                                         scale_factor=3, mode="bilinear", align_corners=False)
    img = up[0].permute(1, 2, 0).numpy()[:h, :w].copy()
    for _ in range(h * w // 12000):
        y, x = rng.randint(0, h - 90), rng.randint(0, w - 90)
        img[y : y + rng.randint(12, 90), x : x + rng.randint(12, 90)] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def phase_stream_1080p(torch, dev, card: str) -> tuple:
    """BASELINE config 5: a 1080p clip drifting STREAM_STEP px a frame, the
    pre-scan at stride 8 sizing the canvas, ORB, windows of 16, and one
    process_clip over the 3 windows with det_fn = YOLOv8l's _infer_fn at
    (768, 1280) in bf16 with the bundled checkpoint. Returns (launch counts,
    kernel A's numbers on the run's last window)."""
    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.config import MosaicConfig
    from rtvm_tpu_torch.detect.detector import ObjectDetector
    from rtvm_tpu_torch.models.yolo.postprocess import Detections, match_detections
    from rtvm_tpu_torch.mosaic.prescan import prescan_canvas
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic
    from rtvm_tpu_torch.ops.kernel_warp import inverse_maps, warp_batch, warp_plain

    t0 = time.time()
    model, ckpt, det_hw = STREAM_DET
    check(os.path.exists(ckpt), f"stream_1080p: {ckpt} is not in this checkout")
    n = N_WINDOWS * WINDOW
    path = camera_path(n + 1, STREAM_STEP)
    world = make_stream_world(np.random.RandomState(SEED + 7), STREAM_H + int(path[:, 1].max()) + 8,
                              STREAM_W + int(path[:, 0].max()) + 8)
    frames = np.stack([world[y : y + STREAM_H, x : x + STREAM_W] for x, y in path])
    t = time.time()
    pre = prescan_canvas(iter(frames), (STREAM_H, STREAM_W), stride=8, device=dev)
    prescan_s = time.time() - t
    check(pre is not None, "stream_1080p: the pre-scan could not track the clip")
    cfg = MosaicConfig(window_size=WINDOW, canvas_hw=pre[0], seed_offset=pre[1])
    t = time.time()
    det = ObjectDetector(model, weights_path=ckpt, load_world=False, device=dev)
    load_s = time.time() - t
    check(det.weights_loaded and det.weights_source == ckpt,
          f"stream_1080p: weights_loaded {det.weights_loaded}, source {det.weights_source}")
    det_fn = det._infer_fn(det_hw, DET_CONF, DET_IOU)
    wins = torch.as_tensor(frames[1:]).reshape(N_WINDOWS, WINDOW, STREAM_H, STREAM_W, 3).to(dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t = time.time()
    m = VideMosaic(frames[0], detector_type="orb", config=cfg, seed=SEED, device=dev)
    aux, dets = m.process_clip(wins, det_fn=det_fn)
    torch.cuda.synchronize()
    first_s = time.time() - t
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = window_launches(N_WINDOWS)
    check(counts == want, f"stream_1080p: launch counts {counts}, expected {want}")
    ok = (aux.blended & aux.ok).reshape(n).cpu().numpy()
    check(int(ok.sum()) >= MIN_ACCEPTED, f"stream_1080p: {int(ok.sum())} of {n} frames accepted")
    H_abs = aux.H_abs.reshape(n, 3, 3).cpu().numpy()
    shift = path[1:] - path[0] + np.array([m.h_offset, m.w_offset])
    err = corner_error(H_abs[ok], shift[ok], STREAM_H, STREAM_W)
    check(err <= TRAJ_TOL_PX, f"stream_1080p: corners off by {err:.3f} px")
    for f, v in dets._asdict().items():
        check(tuple(v.shape[:3]) == (N_WINDOWS, WINDOW, 300), f"stream_1080p: {f} {tuple(v.shape)}")

    # warm: stitch + detection again, timed; then its copies by direction
    m2 = VideMosaic(frames[0], detector_type="orb", config=cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t = time.time()
    m2.process_clip(wins, det_fn=det_fn)
    torch.cuda.synchronize()
    warm_s = time.time() - t
    m3 = VideMosaic(frames[0], detector_type="orb", config=cfg, seed=SEED, device=dev)
    cp = _copies(torch, lambda: m3.process_clip(wins, det_fn=det_fn))
    check(cp["HtoD"] == 0, f"stream_1080p: the fused clip with det_fn copies to the card: {cp}")
    flat = wins.reshape((n,) + wins.shape[2:])
    det_ms = cuda_ms(torch, lambda: det_fn(flat), reps=3, warmup=1)

    # bf16 detections of 2 frames against the card's own float32 run
    pick = wins.reshape((n,) + wins.shape[2:])[STREAM_DET_FRAMES]
    (fb, fc), _ = det.head_logits(pick, det_hw, torch.float32)
    (bb, bc), _ = det.head_logits(pick, det_hw, torch.bfloat16)
    ref_l = torch.cat([x.flatten() for x in fb + fc]).float()
    rel = float((torch.cat([x.flatten() for x in bb + bc]).float() - ref_l).abs().max()
                / ref_l.abs().max())
    want_d = det._infer_fn(det_hw, DET_CONF, DET_IOU, torch.float32)(pick)
    got_d = Detections(*(v.reshape((n,) + v.shape[2:])[STREAM_DET_FRAMES] for v in dets))
    a = match_detections(want_d, got_d)
    rel_max, share_min, gap_max = DET_BOUNDS["bfloat16"]
    check(rel <= rel_max and a["share"] >= share_min and a["max_score_gap"] <= gap_max,
          f"stream_1080p: bf16 against float32: logits {rel:.3e}, {a}")

    # kernel A on the run's last window: bitwise equal, then timed
    hc, wc = pre[0]
    fr = wins[-1].to(torch.float32).permute(0, 3, 1, 2).contiguous()
    G = inverse_maps(aux.H_abs[-1]).contiguous()
    out_k = warp_batch(fr, G, hc, wc)
    out_p = warp_plain(fr, G, hc, wc)
    torch.cuda.synchronize()
    a_err = float((out_k - out_p).abs().max())
    check(torch.equal(out_k, out_p), f"stream_1080p: kernel A vs plain on 1080p maps: max |d| {a_err}")
    del out_p
    a_lib, a_lib_err = grid_sample_ms(torch, fr, G, hc, wc, out_k)
    del out_k
    a_ms = cuda_ms(torch, lambda: warp_batch(fr, G, hc, wc), reps=10)
    a_plain = cuda_ms(torch, lambda: warp_plain(fr, G, hc, wc), reps=2, warmup=1)
    a_dev = device_ms(torch, lambda: warp_batch(fr, G, hc, wc), "rtvm_warp_bilinear_kernel", reps=5)
    b = fr.shape[0]
    a_bound, a_by = bound(b * (3 * STREAM_H * STREAM_W * 4 + 36) + b * 3 * hc * wc * 4,
                          b * hc * wc * (12 + 3 * 12))
    row = {"frames": [b, 3, STREAM_H, STREAM_W], "canvas": [hc, wc], "ms": a_ms, "device_ms": a_dev,
           "plain_ms": a_plain, "bound_ms": a_bound, "bound_by": a_by, "library_ms": a_lib,
           "max_abs_err": a_err}
    phase("stream_1080p", t0,
          f"{n + 1} frames of {STREAM_H}x{STREAM_W} drifting {STREAM_STEP} px a frame; pre-scan "
          f"(stride 8) {prescan_s * 1e3:.1f} ms -> canvas {pre[0]}, seed {pre[1]}; {model} loaded "
          f"in {load_s:.2f} s; process_clip with det_fn at {det_hw} bf16: {int(ok.sum())}/{n} "
          f"accepted, corners within {err:.4f} px, launches {counts}, detections "
          f"{tuple(dets.boxes.shape)} ({int(dets.valid.sum())} valid); {n / first_s:.2f} frames/s "
          f"first call, {n / warm_s:.2f} warm; copies in a warm call {cp}; {model} "
          f"{det_ms:.2f} ms per {n} frames ({det_ms / N_WINDOWS:.2f} ms a window); peak "
          f"{peak / 2**20:.1f} MiB; bf16 vs the card's float32 on frames {STREAM_DET_FRAMES}: "
          f"logits {rel:.3e} of the largest, {a['matched_got']}/{a['n_got']} and "
          f"{a['matched_ref']}/{a['n_ref']} matched, score gap {a['max_score_gap']:.3e}; kernel A "
          f"on the last window's maps (B={b}, canvas {hc}x{wc}): bitwise equal to warp_plain, "
          f"{a_ms:.4f} ms (on the card {fmt_ms(a_dev)}), plain {a_plain:.4f} ms, grid_sample "
          f"{a_lib:.4f} ms (within {a_lib_err:.2e} of the kernel), bound "
          f"{a_bound:.4f} ms ({a_by}), {a_bound / a_ms:.3f} of it; on {card}")
    return counts, row


def layered_clip(rng: np.random.RandomState, n: int, h: int, w: int, rates) -> np.ndarray:
    """Frames of a camera translating along +x past textured fronto-parallel
    layers, one for each rate (an image shifted by `rate` px a frame: depth
    in inverse proportion), the first whole, the others patches, nearer
    layers occluding farther ones. A sample of points from one plane leaves
    the essential matrix undetermined; with many depths no plane holds most
    of the points."""
    big = w + rates[-1] * (n - 1) + 8
    layers = []
    for k, r in enumerate(rates):
        tex = np.clip(_blur_axis(_blur_axis(rng.uniform(0, 255, (h, big, 3)), 1.0, 0), 1.0, 1), 0, 255)
        alpha = np.ones((h, big), bool) if k == 0 else np.zeros((h, big), bool)
        if k:
            for _ in range(big * h // 4000):
                x, y = rng.randint(0, big - 60), rng.randint(0, h - 60)
                alpha[y : y + rng.randint(20, 60), x : x + rng.randint(20, 60)] = True
        layers.append((tex.astype(np.uint8), alpha, r))
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        for tex, alpha, r in layers:
            x0 = r * i
            frames[i] = np.where(alpha[:, x0 : x0 + w, None], tex[:, x0 : x0 + w], frames[i])
    return frames


SLAM_FRAMES = 60
SLAM_RATES = tuple(range(1, 15))  # px a frame: 14 depths, none holding most of the points
SLAM_POS_TOL = 1e-2  # unit-length steps
SLAM_ANGLE_DEG = 10.0


def phase_slam(torch, dev, tmp: str, card: str) -> dict:
    """The CLI's slam command on a 360x640 layered clip of the camera moving
    along +x: the saved trajectory, tracks and poses every frame, the path's
    direction against the truth; the tracked counts, the tracked points and
    every position against the port's CPU run."""
    import rtvm_tpu_torch.slam.vo as vo_mod
    from rtvm_tpu_torch import cli
    from rtvm_tpu_torch.slam.runner import run_slam_on_video

    t0 = time.time()
    frames = layered_clip(np.random.RandomState(SEED + 8), SLAM_FRAMES + 1, FRAME_H, FRAME_W,
                          SLAM_RATES)
    clip = os.path.join(tmp, "slam.npy")
    np.save(clip, frames)
    out = os.path.join(tmp, "slam_out")
    # the VO's detector on the card against the CPU: the RANSAC draws index
    # the keypoints by slot, so the two must rank them alike
    from rtvm_tpu_torch.ops import color
    from rtvm_tpu_torch.ops.features.fast import detect_fast

    kp = [detect_fast(color.bgr2gray(torch.as_tensor(frames[::20], device=d)), 2000, 20.0, 16, 9)
          for d in (dev, "cpu")]
    check(all(torch.equal(a.cpu(), b) for a, b in zip(*kp)),
          "slam: FAST keypoints on the card differ from the CPU's")
    seen, seen_cpu = [], []  # each frame's counts and the points to track from
    into = [seen]
    real = vo_mod.VisualOdometry.process_frame

    def recording(self, frame):
        pose = real(self, frame)
        into[0].append((self.last_num_tracked, self.last_ok, self.pts.cpu().numpy(),
                        self.pts_valid.cpu().numpy()))
        return pose

    vo_mod.VisualOdometry.process_frame = recording
    try:
        torch.cuda.synchronize()
        t = time.time()
        (slam, traj), counts = counted(lambda: cli.main(
            ["slam", clip, "--output-dir", out, "--max-frames", str(SLAM_FRAMES)]))
        torch.cuda.synchronize()
        wall = time.time() - t
        into[0] = seen_cpu
        t = time.time()
        _, cpu = run_slam_on_video(clip, os.path.join(tmp, "slam_cpu"), max_frames=SLAM_FRAMES,
                                   device="cpu")
        cpu_s = time.time() - t
    finally:
        vo_mod.VisualOdometry.process_frame = real
    check(slam.vo.device.type == "cuda", f"slam: ran on {slam.vo.device}")
    check(counts == NO_LAUNCHES, f"slam: launch counts {counts}")
    npy = np.load(os.path.join(out, "slam_trajectory_final.npy"))
    with open(os.path.join(out, "slam_trajectory_final.txt")) as f:
        lines = f.read().splitlines()
    check(npy.shape == (SLAM_FRAMES, 3) and np.array_equal(npy, traj) and len(lines) == 3 + SLAM_FRAMES
          and lines[0] == "# SLAM trajectory: slam.npy"
          and lines[1] == f"# frames: {SLAM_FRAMES}, keyframes: {len(slam.keyframes)}",
          f"slam: npy {npy.shape}, txt {lines[:2]} and {len(lines)} lines")
    tracked = [c[0] for c in seen[1:]]
    n_ok = sum(c[1] for c in seen[1:])
    check(min(tracked) > 8 and n_ok >= 50, f"slam: tracked {min(tracked)}-{max(tracked)}, {n_ok} poses")
    d = traj[-1] - traj[0]
    angle = float(np.degrees(np.arccos(np.clip(d[0] / max(np.linalg.norm(d), 1e-12), -1, 1))))
    check(angle <= SLAM_ANGLE_DEG, f"slam: the path runs {angle:.2f} degrees off +x: {d}")
    same_counts = [c[0] for c in seen_cpu] == [c[0] for c in seen]
    pts_err = [float(np.abs(a[2] - b[2])[a[3] & b[3]].max(initial=0.0)) for a, b in zip(seen, seen_cpu)]
    lk_err = max(pts_err)
    lk_first = next((i for i, e in enumerate(pts_err) if e > 0), None)
    pos_err = float(np.abs(cpu - traj).max())
    parting = (np.flatnonzero(np.abs(np.diff(cpu - traj, axis=0)).max(axis=1) > SLAM_POS_TOL) + 1)
    check(same_counts and pos_err <= SLAM_POS_TOL,
          f"slam: against the CPU run: tracked counts equal {same_counts}, positions within "
          f"{pos_err:.3e} (the steps to frames {parting.tolist()} part), tracked points within "
          f"{lk_err:.3e} px (first apart after frame {lk_first})")
    d_cpu = cpu[-1] - cpu[0]
    angle_cpu = float(np.degrees(np.arccos(np.clip(d_cpu[0] / max(np.linalg.norm(d_cpu), 1e-12), -1, 1))))
    check(angle_cpu <= SLAM_ANGLE_DEG, f"slam: the CPU run's path runs {angle_cpu:.2f} degrees off +x")
    phase("slam", t0,
          f"{SLAM_FRAMES} frames of {FRAME_H}x{FRAME_W} in {wall:.3f} s ({wall / SLAM_FRAMES * 1e3:.1f} "
          f"ms a frame, the CLI end to end); tracked {min(tracked)}-{max(tracked)} a frame, "
          f"{n_ok}/{SLAM_FRAMES - 1} poses, {len(slam.keyframes)} keyframes; path {angle:.2f} "
          f"degrees off the camera's +x (the CPU run's {angle_cpu:.2f}); against the CPU run: "
          f"FAST keypoints equal, tracked counts equal, tracked points within {lk_err:.3e} px, "
          f"positions within "
          f"{pos_err:.3e} ({cpu_s / SLAM_FRAMES * 1e3:.0f} ms a frame there); launches {counts}; "
          f"on {card}")
    return counts


def phase_terrain(torch, dev, tmp: str, card: str) -> dict:
    """The CLI's terrain command on a seeded soil image (a JPEG): every class
    string equal to the CPU run's, every number within 1e-4 relative, and the
    picture at (h, w + 360)."""
    from rtvm_tpu_torch import cli
    from rtvm_tpu_torch.io.imread import imread
    from rtvm_tpu_torch.io.jpeg import encode_jpg
    from rtvm_tpu_torch.slam.terrain import TerrainSoilAnalyzer

    t0 = time.time()
    rng = np.random.RandomState(0)  # tests/test_terrain.py's _soil_image((60, 90, 120))
    img = np.clip(np.full((200, 260, 3), (60, 90, 120), np.float32) + rng.randn(200, 260, 3) * 8,
                  0, 255).astype(np.uint8)
    img[:, :130] = (40, 160, 50)  # half of it green, as in its vegetation test
    src = os.path.join(tmp, "soil.jpg")
    with open(src, "wb") as f:
        f.write(encode_jpg(img))
    out = os.path.join(tmp, "terrain.jpg")
    t = time.time()
    res, counts = counted(lambda: cli.main(["terrain", src, "--output", out]))
    wall = time.time() - t
    check(counts == NO_LAUNCHES, f"terrain: launch counts {counts}")
    want = TerrainSoilAnalyzer(device="cpu").analyze_image(imread(src))
    bad = []

    def close(a, b, path):
        if isinstance(b, dict):
            if set(a) != set(b):
                bad.append(path)
            for k in b:
                close(a.get(k), b[k], f"{path}.{k}")
        elif isinstance(b, (list, tuple)):
            if len(a) != len(b):
                bad.append(path)
            for i, (x, y) in enumerate(zip(a, b)):
                close(x, y, f"{path}[{i}]")
        elif isinstance(b, str):
            if a != b:
                bad.append(f"{path}: {a!r} != {b!r}")
        elif abs(a - b) > 1e-4 * max(1.0, abs(b)):
            bad.append(f"{path}: {a} vs {b}")

    close(res, want, "result")
    check(not bad, f"terrain: card against CPU: {bad}")
    dims = jpeg_dims(out)
    check(dims == (200, 260 + 360), f"terrain: {out} is {dims}")
    phase("terrain", t0,
          f"{res['soil_type']} ({res['confidence']:.4f}), moisture {res['moisture_class']}, "
          f"vegetation {res['vegetation_class']} ({res['vegetation_cover']:.4f}), erosion "
          f"{res['erosion_class']}; every class equal to the CPU run's and every number within "
          f"1e-4; picture {dims}; the CLI {wall * 1e3:.1f} ms; launches {counts}; on {card}")
    return counts


# ------------------------------------------------- slice 8: item 34, depth3d

SIFT_854 = (480, 854)  # 480p: every octave width (854, 427, 214, 107) off a multiple of 4


def phase_sift_854(torch, dev, card: str) -> dict:
    """One SIFT window of 16 frames at 480x854 plus frame 0 through
    VideMosaic.process_window: kernel B on octaves whose widths are not
    multiples of 4 (pitched levels), launches warp 1 and patches 2, at least
    15 of 16 frames accepted on the known path; B byte-identical to its plain
    version on that window's stacks."""
    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.config import FeatureConfig
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic
    from rtvm_tpu_torch.ops import color
    from rtvm_tpu_torch.ops.features.sift import detect_pyramid
    from rtvm_tpu_torch.ops.kernel_patches import (extract_patches_octaves,
                                                   extract_patches_octaves_plain)

    t0 = time.time()
    h, w = SIFT_854
    frames, path = make_clip(np.random.RandomState(SEED + 9), 1 + WINDOW, h, w)
    win = torch.as_tensor(frames[1:]).to(dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    m = VideMosaic(frames[0], detector_type="sift", seed=SEED, device=dev)
    aux = m.process_window(win)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = launch_counts()
    check(counts == window_launches(1, 2),
          f"sift_854: launch counts {counts}")
    blended, ok = aux.blended.cpu().numpy(), aux.ok.cpu().numpy()
    accepted = int((blended & ok).sum())
    check(accepted >= WINDOW - 1, f"sift_854: only {accepted} of {WINDOW} frames accepted")
    H_abs = aux.H_abs.cpu().numpy().astype(np.float64)
    corners = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], np.float64).T
    got = np.einsum("bij,jk->bik", H_abs, corners)
    got = (got[:, :2] / got[:, 2:3]).transpose(0, 2, 1)
    shift = path[1:] - path[0] + np.array([m.h_offset, m.w_offset])
    traj_err = float(np.abs(got - (corners[:2].T[None] + shift[:, None, :]))[blended].max())
    check(traj_err <= TRAJ_TOL_PX, f"sift_854: corners off by {traj_err:.3f} px")

    _, _, stacks, ys, xs, _ = detect_pyramid(color.bgr2gray(win), FeatureConfig())
    widths = [int(st.shape[2]) for st in stacks]
    pitches = [int(st.stride(1)) for st in stacks]
    # the level buffers (all 6 levels of each octave) with and without the pitch
    level_bytes = sum(st.shape[0] * st.stride(0) * 4 for st in stacks)
    pad_bytes = sum(st.shape[0] * st.stride(0) // p * (p - wo) * 4
                    for st, p, wo in zip(stacks, pitches, widths))
    check(any(wo % 4 for wo in widths), f"sift_854: octave widths {widths} are all 4-aligned")
    out_k = extract_patches_octaves(stacks, ys, xs)
    out_p = extract_patches_octaves_plain(stacks, ys, xs)
    torch.cuda.synchronize()
    check(torch.equal(out_k, out_p), "sift_854: kernel B differs from its plain version")
    ms = cuda_ms(torch, lambda: extract_patches_octaves(stacks, ys, xs))
    plain_ms = cuda_ms(torch, lambda: extract_patches_octaves_plain(stacks, ys, xs))
    phase("sift_854", t0,
          f"{accepted}/{WINDOW} frames of {h}x{w} accepted, corners within {traj_err:.4f} px, "
          f"launches {counts}; octave widths {widths} on row pitches {pitches} "
          f"({pad_bytes / 1e6:.3f} MB of padding in {level_bytes / 1e6:.1f} MB of levels); kernel B "
          f"byte-identical to plain ({out_k.shape[1]} patches a frame), {ms:.4f} ms a window "
          f"(plain {plain_ms:.4f}); the window (frame 0 and 16 frames) {wall * 1e3:.1f} ms, "
          f"{WINDOW / wall:.2f} frames/s with the first call's costs; on {card}")
    return counts


class _Walls:
    """Wraps callables (owner, attribute, label) to add each call's wall,
    up to a synchronize after it, to walls[label] (ms), and keeps the last
    argument tuple and result of each label."""

    def __init__(self, torch, targets):
        self.torch, self.targets = torch, targets
        self.walls, self.last = {}, {}

    def __enter__(self):
        self.saved = []
        sync = self.torch.cuda.synchronize
        for owner, attr, label in self.targets:
            real = getattr(owner, attr)
            self.saved.append((owner, attr, real))
            self.walls.setdefault(label, 0.0)

            def wrapped(*a, _real=real, _label=label, **k):
                t = time.perf_counter()
                out = _real(*a, **k)
                sync()
                self.walls[_label] += (time.perf_counter() - t) * 1e3
                self.last[_label] = (a, out)
                return out
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, real in reversed(self.saved):
            setattr(owner, attr, real)

    def fmt(self) -> str:
        return ", ".join(f"{k} {v:.1f}" for k, v in self.walls.items()) + " ms"


DEPTH_IMAGE = (1080, 1920)  # BASELINE config 5's frames: DepthNet at the frame's own size
DEPTH_CPU_TOL = 1e-3  # normalised depth, card against the port's float32 CPU run
ICP_CPU_TOL = 1e-3  # ICP's R and t, card against the CPU on the same clouds
# R and t, the card's video pipeline against the CPU's, each on its own
# depths. tools/icp_depth_sensitivity.py on a CPU: +-4e-6 of depth noise
# moves them by up to 1.774e-2; a one-pixel shift of the depths, the
# previous frame's depths or depths times 0.99 by 0.108, 0.217 and 0.114.
ICP_PIPE_TOL = 4e-2
DEPTH_VIDEO_STEP = (2, -4)  # px a frame
TSDF_CPU_TOL = 1e-4
TERRAIN_IMAGE = (540, 960)
TERRAIN_OFF_BY_ONE = 1e-3  # share of depth PNG pixels one level off the CPU run's


def _depth_stages() -> list:
    """The stages of depth3d/pipeline.py (and the estimator's estimate_depth)
    as _Walls targets."""
    from rtvm_tpu_torch.depth3d import pipeline as pl

    return [(pl.MonocularDepthEstimator, "estimate_depth", "depth"),
            (pl, "unproject_depth", "unproject"), (pl, "remove_statistical_outliers", "outliers"),
            (pl, "depth_grid_mesh", "mesh"), (pl, "surface_mesh_from_points", "mesh"),
            (pl, "write_ply_points", "writes"), (pl, "write_obj_mesh", "writes"),
            (pl, "write_ply_mesh", "writes"), (pl, "save_depth_panels", "writes")]


def phase_depth3d_image(torch, dev, tmp: str, card: str) -> dict:
    """The CLI's depth3d on a 1080x1920 PNG of a seeded world: DepthNet on the
    card from weights/depthnet.npz (not the heuristic), its normalised depth
    within DEPTH_CPU_TOL of the port's float32 CPU run, the cloud, mesh and
    panels read back; DepthNet's warm time (CUDA events) and peak memory, and
    the wall of each stage."""
    from rtvm_tpu_torch import cli
    from rtvm_tpu_torch.depth3d.estimator import MonocularDepthEstimator
    from rtvm_tpu_torch.io.imread import imread
    from rtvm_tpu_torch.io.ply import read_obj_mesh, read_ply_points
    from rtvm_tpu_torch.io.png import imwrite_png

    t0 = time.time()
    h, w = DEPTH_IMAGE
    img = make_world(np.random.RandomState(SEED + 10), h, w)
    src = os.path.join(tmp, "scene.png")
    imwrite_png(src, img)
    out = os.path.join(tmp, "depth3d_image")
    with _Walls(torch, _depth_stages()) as walls:
        torch.cuda.synchronize()
        t = time.time()
        res, counts = counted(lambda: cli.main(["depth3d", src, "--output-dir", out]))
        wall = time.time() - t
    check(counts == NO_LAUNCHES, f"depth3d_image: launch counts {counts}")
    est = walls.last["depth"][0][0]  # the estimator the CLI built
    seen = (est.backend, est.device.type, est.checkpoint)
    check(seen[:2] == ("depthnet", "cuda") and str(seen[2]).endswith("depthnet.npz"),
          f"depth3d_image: the estimator ran as {seen} (want DepthNet on cuda from depthnet.npz)")
    depth = res["depth"]
    check(depth.shape == (h, w) and np.isfinite(depth).all() and depth.min() == 0.0
          and depth.max() == 1.0, f"depth3d_image: depth {depth.shape}, {depth.min()}..{depth.max()}")
    t = time.time()
    cpu = MonocularDepthEstimator(device="cpu").estimate_depth(img)
    cpu_s = time.time() - t
    err = float(np.abs(depth - cpu).max())
    check(err <= DEPTH_CPU_TOL, f"depth3d_image: depth {err:.3e} off the CPU run's")
    pts, cols = read_ply_points(res["cloud"])
    verts, faces = read_obj_mesh(res["mesh"])
    vis = imread(res["visualization"])
    check(len(pts) == len(res["points"]) > 0 and cols is not None and len(faces) > 0
          and np.isfinite(verts).all() and vis is not None and vis.shape[1] == 3 * vis.shape[0] * w // h,
          f"depth3d_image: cloud {len(pts)}, mesh {verts.shape} {faces.shape}, panels "
          f"{None if vis is None else vis.shape}")
    x = torch.as_tensor(img, device=dev).flip(-1).permute(2, 0, 1)[None].float() / 255.0
    convs = [m for m in est.net.modules() if isinstance(m, torch.nn.Conv2d)]
    flops = []  # 2 * output elements * input channels * kernel taps, each convolution
    hooks = [m.register_forward_hook(
        lambda m, i, o: flops.append(2 * o.numel() * m.in_channels * m.kernel_size[0]
                                     * m.kernel_size[1])) for m in convs]
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        est.net(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        for hk in hooks:
            hk.remove()
        net_ms = cuda_ms(torch, lambda: est.net(x), reps=5, warmup=2)
    gflop = sum(flops) / 1e9
    phase("depth3d_image", t0,
          f"{h}x{w}: DepthNet from {seen[2]} on the card, depth within {err:.3e} of the CPU "
          f"run ({cpu_s:.2f} s there); {len(pts)} points, {len(faces)} faces, panels "
          f"{vis.shape}; DepthNet {net_ms:.3f} ms warm ({gflop:.1f} GFLOP of convolutions, "
          f"{gflop / net_ms:.2f} TFLOP/s), peak {peak:.1f} MiB; the CLI "
          f"{wall:.3f} s, stages {walls.fmt()}; launches {counts}; on {card}")
    return counts


def phase_depth3d_video(torch, dev, tmp: str, card: str) -> dict:
    """The CLI's depth3d clip.npy --frame-step 4 --max-frames 8 on a seeded
    360x640 clip of a drifting camera, then the same pipeline on the CPU:
    each sampled frame's depth within DEPTH_CPU_TOL of the CPU's, the same
    frames used, the merged count within 1%, and each ICP call's R and t
    within ICP_PIPE_TOL of the CPU run's (each side on its own depths); then
    each card ICP call within ICP_CPU_TOL of register_clouds on the CPU fed
    the same clouds."""
    from rtvm_tpu_torch import cli
    from rtvm_tpu_torch.depth3d import estimator
    from rtvm_tpu_torch.depth3d import pipeline as pl

    t0 = time.time()
    frames = make_clip(np.random.RandomState(SEED + 11), 29, FRAME_H, FRAME_W, DEPTH_VIDEO_STEP)[0]
    clip = os.path.join(tmp, "depth_clip.npy")
    np.save(clip, frames)
    regs = {"card": [], "cpu": []}
    depths = {"card": [], "cpu": []}
    side = ["card"]
    real = pl.register_clouds
    real_depth = estimator.MonocularDepthEstimator.estimate_depth

    def recording(src, dst, *a, **k):
        r = real(src, dst, *a, **k)
        regs[side[0]].append((src, dst, a, k, r.R.cpu().numpy(), r.t.cpu().numpy(),
                              float(r.fitness), r.R.device.type))
        return r

    def recording_depth(self, img):
        d = real_depth(self, img)
        depths[side[0]].append((self.device.type, d))
        return d

    pl.register_clouds = recording
    estimator.MonocularDepthEstimator.estimate_depth = recording_depth
    try:
        torch.cuda.synchronize()
        t = time.time()
        res, counts = counted(lambda: cli.main(
            ["depth3d", clip, "--output-dir", os.path.join(tmp, "dv"), "--frame-step", "4",
             "--max-frames", "8"]))
        torch.cuda.synchronize()
        wall = time.time() - t
        side[0] = "cpu"
        t = time.time()
        cpu = pl.process_video_to_3d_model(clip, os.path.join(tmp, "dv_cpu"), frame_step=4,
                                           max_frames=8, device="cpu")
        cpu_s = time.time() - t
    finally:
        pl.register_clouds = real
        estimator.MonocularDepthEstimator.estimate_depth = real_depth
    check(counts == NO_LAUNCHES, f"depth3d_video: launch counts {counts}")
    card_r, cpu_r = regs["card"], regs["cpu"]
    check(res["frames_used"] == cpu["frames_used"] >= 2 and len(card_r) == len(cpu_r) == 7
          and all(r[7] == "cuda" for r in card_r),
          f"depth3d_video: frames used {res['frames_used']} (CPU {cpu['frames_used']}), ICP calls "
          f"{[r[7] for r in card_r]} and {len(cpu_r)}")
    on = [d[0] for d in depths["card"]], [d[0] for d in depths["cpu"]]
    check(on == (["cuda"] * 8, ["cpu"] * 8), f"depth3d_video: depths ran on {on}")
    d_err = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(depths["card"], depths["cpu"]))
    check(d_err <= DEPTH_CPU_TOL, f"depth3d_video: depth {d_err:.3e} off the CPU run's")
    pipe = [(float(np.abs(a[4] - b[4]).max()), float(np.abs(a[5] - b[5]).max()))
            for a, b in zip(card_r, cpu_r)]
    pipe_err = max(max(e) for e in pipe)
    check(pipe_err <= ICP_PIPE_TOL,
          f"depth3d_video: ICP transforms (R, t) against the CPU run's: {pipe}")
    same_in = []  # each card call against register_clouds on the CPU with its clouds
    for src, dst, a, k, R, tt, _, _ in card_r:
        r = real(src, dst, *a, **dict(k, device="cpu"))
        same_in.append((float(np.abs(R - r.R.numpy()).max()), float(np.abs(tt - r.t.numpy()).max())))
    r_err = max(e[0] for e in same_in)
    t_err = max(e[1] for e in same_in)
    check(r_err <= ICP_CPU_TOL and t_err <= ICP_CPU_TOL,
          f"depth3d_video: ICP on the card against the CPU on the same clouds: R {r_err:.3e}, "
          f"t {t_err:.3e} (per call {same_in})")
    # one ICP call on the card: its wall, and the syncs CUDA's debug mode
    # reports in it (the two uploads of the clouds included)
    import warnings

    src, dst, a, k = card_r[-1][:4]
    real(src, dst, *a, **k)
    torch.cuda.synchronize()
    t = time.perf_counter()
    real(src, dst, *a, **k)
    torch.cuda.synchronize()
    icp_ms = (time.perf_counter() - t) * 1e3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            real(src, dst, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    n, n_cpu = len(res["points"]), len(cpu["points"])
    check(abs(n - n_cpu) <= 0.01 * n_cpu, f"depth3d_video: {n} points, the CPU run {n_cpu}")
    phase("depth3d_video", t0,
          f"8 of 29 frames of {FRAME_H}x{FRAME_W}: {res['frames_used']} used (the CPU run's "
          f"{cpu['frames_used']}), depths within {d_err:.3e} of the CPU run's, ICP fitness "
          f"{[round(r[6], 4) for r in card_r]}; the transforms (R, t) against the CPU run's "
          f"{[(float(f'{x:.2e}'), float(f'{y:.2e}')) for x, y in pipe]} (bound {ICP_PIPE_TOL:g}); "
          f"each ICP call within R {r_err:.3e}, t {t_err:.3e} of the CPU's on the same clouds; "
          f"{n} points (CPU {n_cpu}); one ICP call {icp_ms:.1f} ms, {syncs} syncs in it; the CLI "
          f"{wall:.3f} s (the CPU run {cpu_s:.2f} s); launches {counts}; on {card}")
    return counts


def sphere_views(n_img: int = 96, f: float = 120.0, r_cam: float = 3.0, radius: float = 0.8):
    """tests/test_tsdf.py:test_tsdf_fusion_sphere_depths' analytic z-depths
    of a sphere from 4 cameras on a circle: (depths [4, n, n], K, poses)."""
    K = np.array([[f, 0, n_img / 2], [0, f, n_img / 2], [0, 0, 1]], np.float32)
    poses, depths = [], []
    for a in np.linspace(0, 2 * np.pi, 5)[:-1]:
        eye = np.array([r_cam * np.cos(a), r_cam * np.sin(a), 0.0])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, -np.cross(right, fwd), fwd, eye
        u, v = np.meshgrid(np.arange(n_img), np.arange(n_img))
        d_cam = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                          np.ones_like(u, np.float32)], -1)
        d_world = d_cam @ T[:3, :3].T
        b = (d_world * T[:3, 3]).sum(-1)
        aa = (d_world * d_world).sum(-1)
        disc = b * b - aa * ((T[:3, 3] ** 2).sum() - radius * radius)
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / aa, -1.0)
        depth = np.where(t > 0, t, 0.0).astype(np.float32)
        depths.append(np.where(depth > 0, (d_cam * depth[..., None])[..., 2], 0.0))
        poses.append(T)
    return np.stack(depths).astype(np.float32), K, np.stack(poses)


def phase_depth3d_multiview(torch, dev, tmp: str, card: str) -> dict:
    """The CLI's depth3d <dir> --multi-view on 4 views of a seeded world: the
    ORB angles on the card within 0.5 degrees of the CPU's, the indicator
    mesh route, the three files; then fuse_tsdf on the analytic sphere
    depths, within TSDF_CPU_TOL of the CPU run."""
    from rtvm_tpu_torch import cli
    from rtvm_tpu_torch.depth3d import tsdf
    from rtvm_tpu_torch.depth3d.pipeline import estimate_camera_angles_from_images
    from rtvm_tpu_torch.io.ply import read_obj_mesh, read_ply_points
    from rtvm_tpu_torch.io.png import imwrite_png

    t0 = time.time()
    world = make_world(np.random.RandomState(SEED + 12), FRAME_H, FRAME_W + 480)
    views = [world[:, x : x + FRAME_W] for x in (0, 120, 280, 480)]  # unequal steps
    vdir = os.path.join(tmp, "views")
    os.makedirs(vdir, exist_ok=True)
    for i, v in enumerate(views):
        imwrite_png(os.path.join(vdir, f"view_{i}.png"), v)
    out = os.path.join(tmp, "mv")
    walls = _Walls(torch, [(tsdf, "indicator_mesh_from_points", "indicator")])
    with walls:
        torch.cuda.synchronize()
        t = time.time()
        res, counts = counted(lambda: cli.main(["depth3d", vdir, "--multi-view", "--output-dir", out]))
        wall = time.time() - t
    check("indicator" in walls.last, "depth3d_multiview: the indicator mesh did not run")
    cpu_angles = estimate_camera_angles_from_images(views, device="cpu")
    a_err = float(np.abs(np.array(res["angles"]) - np.array(cpu_angles)).max())
    check(a_err <= 0.5, f"depth3d_multiview: angles {res['angles']} against the CPU's {cpu_angles}")
    pts, _ = read_ply_points(res["cloud"])
    verts, faces = read_obj_mesh(os.path.join(out, "multi_view_mesh.obj"))
    check(len(pts) == len(res["points"]) > 0 and len(faces) > 0 and
          os.path.exists(os.path.join(out, "multi_view_mesh.ply")),
          f"depth3d_multiview: cloud {len(pts)}, mesh {faces.shape}")

    depths, K, poses = sphere_views()
    vols = {}
    for d in (dev, "cpu"):
        torch.cuda.synchronize()
        t = time.time()
        vols[str(d)], n = counted(lambda: tsdf.fuse_tsdf(
            tsdf.make_tsdf((-1.2, -1.2, -1.2), 2.4, grid=72), depths, K, poses, device=d))
        if d is dev:
            counts = add_launches(counts, n)
        vols[str(d) + "_s"] = time.time() - t
    vk, vc = vols[str(dev)], vols["cpu"]
    t_err = float(np.abs(vk.tsdf - vc.tsdf).max())
    check(t_err <= TSDF_CPU_TOL and np.array_equal(vk.weight, vc.weight),
          f"fuse_tsdf: {t_err:.3e} off the CPU run, weights equal {np.array_equal(vk.weight, vc.weight)}")
    check(counts == NO_LAUNCHES, f"depth3d_multiview: launch counts {counts}")
    sv, sf = tsdf.tsdf_mesh(vk)
    r_med = float(np.median(np.linalg.norm(sv, axis=1)))
    check(len(sf) > 300 and abs(r_med - 0.8) < 0.08, f"fuse_tsdf: {len(sf)} faces, radius {r_med:.4f}")
    phase("depth3d_multiview", t0,
          f"4 views of {FRAME_H}x{FRAME_W}: angles {[round(a, 2) for a in res['angles']]} "
          f"(within {a_err:.2e} of the CPU's), {len(pts)} points, indicator mesh {len(faces)} "
          f"faces in {walls.walls['indicator']:.1f} ms; the CLI {wall:.3f} s; fuse_tsdf of 4 "
          f"96x96 sphere depths on a 72^3 grid within {t_err:.3e} of the CPU run, "
          f"{vols[str(dev) + '_s'] * 1e3:.1f} ms (CPU {vols['cpu_s'] * 1e3:.1f} ms), median "
          f"radius {r_med:.4f}; launches {counts}; on {card}")
    return counts


def phase_terrain_3d(torch, dev, tmp: str, card: str) -> dict:
    """The CLI's terrain <img> --reconstruct-3d --fast: the depth PNG equal to
    the CPU run's but for at most TERRAIN_OFF_BY_ONE of its pixels one level
    apart ((depth * 255).astype(uint8) truncates, so a 1e-6 depth gap can
    flip a level); the bilateral and median filters on the card."""
    from rtvm_tpu_torch import cli
    from rtvm_tpu_torch.depth3d.pipeline import ImageTerrainReconstructor
    from rtvm_tpu_torch.io.imread import imread
    from rtvm_tpu_torch.io.png import imwrite_png
    from rtvm_tpu_torch.ops import smooth
    from rtvm_tpu_torch.utils.colormap import PLASMA_BGR

    t0 = time.time()
    h, w = TERRAIN_IMAGE
    img = make_world(np.random.RandomState(SEED + 13), h, w)
    work = os.path.join(tmp, "terrain3d")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "field.png")
    imwrite_png(src, img)
    devices = []
    real = smooth.bilateral_filter_u8, smooth.median_blur_u8

    def on(fn, name):
        def wrapped(x, *a, **k):
            devices.append((name, x.device.type))
            return fn(x, *a, **k)
        return wrapped

    smooth.bilateral_filter_u8, smooth.median_blur_u8 = on(real[0], "bilateral"), on(real[1], "median")
    here = os.getcwd()
    os.chdir(work)
    try:
        torch.cuda.synchronize()
        t = time.time()
        _, counts = counted(lambda: cli.main(
            ["terrain", src, "--output", "terrain.png", "--reconstruct-3d", "--fast"]))
        wall = time.time() - t
        card_devices = list(devices)
        t = time.time()
        cpu = ImageTerrainReconstructor(fast=True, device="cpu").process(src, "cpu")
        cpu_s = time.time() - t
    finally:
        os.chdir(here)
        smooth.bilateral_filter_u8, smooth.median_blur_u8 = real
    check(counts == NO_LAUNCHES, f"terrain_3d: launch counts {counts}")
    check(card_devices == [("bilateral", "cuda"), ("median", "cuda")],
          f"terrain_3d: the filters ran as {card_devices}")
    names = ["field_depth.png", "field_pointcloud.ply", "field_mesh.obj", "field_panels.png",
             "terrain.png"]
    missing = [n for n in names if not os.path.exists(os.path.join(work, n))]
    check(not missing, f"terrain_3d: missing {missing}")
    level = {tuple(c): i for i, c in enumerate(PLASMA_BGR.tolist())}
    got, want = (imread(p) for p in (os.path.join(work, "field_depth.png"),
                                     os.path.join(work, cpu["depth"])))
    lg = np.array([level[tuple(c)] for c in got.reshape(-1, 3).tolist()])
    lw = np.array([level[tuple(c)] for c in want.reshape(-1, 3).tolist()])
    off = float((lg != lw).mean())
    check(np.abs(lg - lw).max() <= 1 and off <= TERRAIN_OFF_BY_ONE,
          f"terrain_3d: depth levels {off:.5f} apart from the CPU run (max "
          f"{int(np.abs(lg - lw).max())})")
    phase("terrain_3d", t0,
          f"{h}x{w}: depth PNG levels equal to the CPU run's but {off:.5f} of the pixels (one "
          f"level); bilateral and median on the card; the CLI {wall:.3f} s (analysis and "
          f"reconstruction; the CPU reconstruction {cpu_s:.2f} s); launches {counts}; on {card}")
    return counts


STEREO_SIZE = (480, 640)
STEREO_DISP = (8.0, 64.0)  # px from the left edge to the right: 0.088 px a pixel, tests/test_stereo.py's slope
STEREO_NUM_DISP = 128  # the estimator's default, the reference's SGBM numDisparities
STEREO_MARGIN = 80  # px of texture beyond each side, so the right view never samples past it


def slanted_pair(rng: np.random.RandomState, h: int, w: int, d0: float, d1: float,
                 margin: int = STEREO_MARGIN, sigma: float = 1.2):
    """tests/test_stereo.py's slanted plane at any size: blurred noise seen
    by a left camera and by a right one whose disparity ramps linearly from
    d0 at the left edge to d1 at the right (the right pixel xr sees the left
    pixel xl = (xr + d0) / (1 - s)). Returns uint8 BGR left and right views
    and the true disparity of each left pixel."""
    tex = rng.randint(0, 255, (h, w + 2 * margin)).astype(np.float64)
    tex = _blur_axis(_blur_axis(tex, sigma, 0), sigma, 1)
    xs = np.arange(w, dtype=np.float64)
    s = (d1 - d0) / (w - 1)
    src = margin + (xs + d0) / (1.0 - s)
    x0 = np.floor(src).astype(int)
    frac = src - x0
    right = tex[:, x0] * (1 - frac) + tex[:, x0 + 1] * frac
    left = tex[:, margin : margin + w]

    def bgr(g):
        return np.repeat(np.clip(np.rint(g), 0, 255).astype(np.uint8)[..., None], 3, -1)

    return bgr(left), bgr(right), np.tile(d0 + s * xs, (h, 1)).astype(np.float32)


STEREO_CPU_TOL = 1e-3  # px: the refined disparity, card against the port's CPU run
STEREO_MAX_MAE = 0.5  # px: raw SGM against the truth on valid pixels (JAX on a CPU: 0.1238)
STEREO_MIN_VALID = 0.9  # share of the pixels raw SGM keeps (JAX on a CPU: 0.9891)
STEREO_SAME_INT = 0.999  # share of pixels whose integer disparity equals the CPU run's
VIEW_SIZE = (1080, 1920)  # the JAX default of view --backend offscreen
VIEW_SAME_PIXELS = 0.999  # a projection at half a pixel may round the other way
WEB_LIMIT_S = 300.0  # the web phase's wait for /progress to read done


def kernel_launches(torch, fn):
    """CUDA kernels launched by one call of fn, from torch.profiler (None
    when the profiler shows no device activity)."""
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == cuda
            and not e.name.startswith(("Memcpy", "Memset")))
    return n or None


def phase_view(torch, dev, tmp: str, card: str) -> tuple:
    """The CLI's view --backend offscreen --size 1920x1080 on the cloud and
    the mesh that depth3d_image wrote: each PNG decodes to 1080x1920 and is
    not background only, and equals the port's CPU render of the same
    arrays on at least VIEW_SAME_PIXELS of the pixels; the splat's warm time
    (CUDA events), the host's parts (reading the file, sampling the
    surfels, the PNG), peak memory. Returns (counts, the mesh render)."""
    from rtvm_tpu_torch import cli
    from rtvm_tpu_torch.io import ply, png
    from rtvm_tpu_torch.io.imread import imread
    from rtvm_tpu_torch.viz import render

    t0 = time.time()
    src = os.path.join(tmp, "depth3d_image")
    counts, notes, mesh_img = dict(NO_LAUNCHES), [], None
    for name, kind in (("scene_pointcloud.ply", "cloud"), ("scene_mesh.obj", "mesh")):
        path, out = os.path.join(src, name), os.path.join(tmp, f"view_{kind}.png")
        targets = [(ply, "read_ply_points", "read"), (ply, "read_obj_mesh", "read"),
                   (render, "sample_mesh_surfels", "surfels"), (render, "splat", "splat"),
                   (png, "imwrite", "png")]
        with _Walls(torch, targets) as walls:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.time()
            got, c = counted(lambda: cli.main(["view", path, "--backend", "offscreen", "--size",
                                               f"{VIEW_SIZE[1]}x{VIEW_SIZE[0]}", "--out", out]))
            wall = time.time() - t
        peak = torch.cuda.max_memory_allocated() / 2**20
        check(c == NO_LAUNCHES, f"view {kind}: launch counts {c}")
        counts = add_launches(counts, c)
        args = walls.last["splat"][0]
        check(got == out and args[0].device.type == "cuda", f"view {kind}: wrote {got}, splat on "
              f"{args[0].device}")
        img = imread(out)
        check(img is not None and img.shape == VIEW_SIZE + (3,), f"view {kind}: PNG "
              f"{None if img is None else img.shape}")
        painted = float((img != 255).any(-1).mean())
        check(painted > 0.01, f"view {kind}: {painted:.4f} of the picture painted")
        data = walls.last["read"][1]
        t = time.time()
        if kind == "cloud":
            cpu = render.render_points(*data, VIEW_SIZE[1], VIEW_SIZE[0], device="cpu")
        else:
            cpu = render.render_mesh(*data, width=VIEW_SIZE[1], height=VIEW_SIZE[0], device="cpu")
            mesh_img = img
        cpu_s = time.time() - t
        same = float((img[..., ::-1] == cpu).all(-1).mean())
        check(same >= VIEW_SAME_PIXELS, f"view {kind}: {same:.5f} of the pixels equal the CPU "
              "render's")
        ms = cuda_ms(torch, lambda: render.splat(*args), reps=10, warmup=2)
        n_pts, psize = args[0].shape[0], args[6]
        notes.append(f"{kind} {n_pts} points ({n_pts * psize * psize} splats): splat {ms:.3f} ms "
                     f"warm, the CLI {wall:.3f} s (stages {walls.fmt()}), peak {peak:.1f} MiB, "
                     f"{painted:.4f} painted, {same:.5f} of the pixels equal to the CPU render "
                     f"({cpu_s:.2f} s there)")
    phase("view", t0, "; ".join(notes) + f"; launches {counts}; on {card}")
    return counts, mesh_img


def phase_stereo_demo(torch, dev, tmp: str, card: str) -> dict:
    """The CLI's stereo-demo: SGM on the card, the medians of the two
    rectangles within 1.5 px of 5 and 20 (tests/test_stereo.py's oracle),
    the disparity against the port's CPU run (the invalid masks equal, the
    rest within STEREO_CPU_TOL), the two PNGs."""
    from rtvm_tpu_torch import cli
    from rtvm_tpu_torch.io.imread import imread
    from rtvm_tpu_torch.stereo import depth as sd

    t0 = time.time()
    out = os.path.join(tmp, "stereo_demo")
    with _Walls(torch, [(sd, "sgm_disparity", "sgm")]) as walls:
        torch.cuda.synchronize()
        t = time.time()
        (left, _, disp), counts = counted(lambda: cli.main(["stereo-demo", "--output-dir", out]))
        wall = time.time() - t
    check(counts == NO_LAUNCHES, f"stereo_demo: launch counts {counts}")
    check(walls.last["sgm"][0][0].device.type == "cuda", "stereo_demo: SGM did not run on the card")
    far, near = disp[28:44, 96:124], disp[78:98, 48:84]
    mf, mn = float(np.median(far[far > 0])), float(np.median(near[near > 0]))
    check(abs(mf - 5) <= 1.5 and abs(mn - 20) <= 1.5, f"stereo_demo: medians {mf}, {mn}")
    cpu = sd.demo_stereo_depth(device="cpu")[2]
    both = (disp >= 0) & (cpu >= 0)
    err = float(np.abs(disp - cpu)[both].max())
    check(np.array_equal(disp < 0, cpu < 0) and err <= STEREO_CPU_TOL,
          f"stereo_demo: against the CPU run: masks equal {np.array_equal(disp < 0, cpu < 0)}, "
          f"disparity within {err:.3e}")
    shown = imread(os.path.join(out, "stereo_disparity.png"))
    check(np.array_equal(imread(os.path.join(out, "stereo_left.png")), left)
          and shown is not None and shown.shape == left.shape, "stereo_demo: the PNGs")
    phase("stereo_demo", t0,
          f"medians {mf:.3f} and {mn:.3f} px (want 5 and 20), {both.mean():.4f} valid; within "
          f"{err:.3e} px of the CPU run, masks equal; the CLI {wall:.3f} s; launches {counts}; "
          f"on {card}")
    return counts


def phase_stereo_480p(torch, dev, card: str) -> dict:
    """StereoTerrainMapper().process_stereo_frame on a seeded 480x640
    slanted plane with disparities from 8 to 64 px, 128 disparities: raw SGM
    against the truth (MAE at most STEREO_MAX_MAE px on the valid pixels, at
    least STEREO_MIN_VALID of them valid); against the port's CPU run, the
    integer disparity equal on STEREO_SAME_INT of the pixels and the refined
    disparity within STEREO_CPU_TOL; SGM's warm time with the aggregation
    apart (CUDA events), its launches, peak memory."""
    from rtvm_tpu_torch.stereo import depth as sd
    from rtvm_tpu_torch.stereo import sgm

    t0 = time.time()
    h, w = STEREO_SIZE
    left, right, gt = slanted_pair(np.random.RandomState(SEED + 14), h, w, *STEREO_DISP)
    stages = [(sd, "sgm_disparity", "sgm"), (sd, "speckle_suppress", "speckle"),
              (sd, "guided_refine", "guided")]
    runs = {}
    for where in ("cuda", "cpu"):
        mapper = sd.StereoTerrainMapper(device=None if where == "cuda" else "cpu")
        check(mapper.est.num_disparities == STEREO_NUM_DISP, "stereo_480p: the default disparities")
        with _Walls(torch, stages) as walls:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.time()
            res, c = counted(lambda: mapper.process_stereo_frame(left, right))
            runs[where] = (res, c, time.time() - t, walls, torch.cuda.max_memory_allocated() / 2**20)
    res, counts, wall, walls, peak = runs["cuda"]
    check(counts == NO_LAUNCHES, f"stereo_480p: launch counts {counts}")
    (gl, gr, _), raw = walls.last["sgm"]
    check(gl.device.type == "cuda", f"stereo_480p: SGM ran on {gl.device}")
    raw_d = raw.disparity.cpu().numpy()
    valid = raw_d >= 0
    mae = float(np.abs(raw_d - gt)[valid].mean())
    check(valid.mean() >= STEREO_MIN_VALID and mae <= STEREO_MAX_MAE,
          f"stereo_480p: raw SGM {valid.mean():.4f} valid, MAE {mae:.4f} px against the truth")
    cpu_res, _, cpu_s, cpu_walls, _ = runs["cpu"]
    same_int = float((raw.cost_volume.argmin(-1).cpu().numpy()
                      == cpu_walls.last["sgm"][1].cost_volume.argmin(-1).numpy()).mean())
    d, dc = res["disparity"], cpu_res["disparity"]
    both = (d >= 0) & (dc >= 0)
    same_mask = float(((d >= 0) == (dc >= 0)).mean())
    err = float(np.abs(d - dc)[both].max())
    check(same_int >= STEREO_SAME_INT and same_mask >= STEREO_SAME_INT and err <= STEREO_CPU_TOL,
          f"stereo_480p: against the CPU run: integer disparity equal on {same_int:.5f}, masks on "
          f"{same_mask:.5f}, refined within {err:.3e} px")
    check(np.isfinite(res["cloud"]).all() and res["cloud"].shape[1] == 6
          and res["disparity_vis"].shape == (h, w, 3), "stereo_480p: the products")
    sgm_ms = cuda_ms(torch, lambda: sgm.sgm_disparity(gl, gr, STEREO_NUM_DISP), reps=3, warmup=1)
    cost = sgm.build_cost_volume(gl, gr, STEREO_NUM_DISP)
    cost_ms = cuda_ms(torch, lambda: sgm.build_cost_volume(gl, gr, STEREO_NUM_DISP), reps=3,
                      warmup=1)
    agg_ms = cuda_ms(torch, lambda: sgm.aggregate(cost), reps=3, warmup=1)
    host_ms = host_us(torch, lambda: sgm.aggregate(cost), reps=3) / 1e3
    n_sgm = kernel_launches(torch, lambda: sgm.sgm_disparity(gl, gr, STEREO_NUM_DISP))
    n_agg = kernel_launches(torch, lambda: sgm.aggregate(cost))
    phase("stereo_480p", t0,
          f"{h}x{w}, {STEREO_NUM_DISP} disparities, truth {STEREO_DISP[0]:g}-{STEREO_DISP[1]:g} px: "
          f"raw SGM MAE {mae:.4f} px on {valid.mean():.4f} valid; against the CPU run integer "
          f"disparity equal on {same_int:.5f}, refined within {err:.3e} px (masks {same_mask:.5f}); "
          f"SGM {sgm_ms:.2f} ms warm (cost volume {cost_ms:.2f}, aggregation {agg_ms:.2f}, its "
          f"enqueue on the host {host_ms:.2f}), {n_sgm or 'not measured'} kernel launches a "
          f"call ({n_agg or 'not measured'} in the aggregation); the pair {wall:.3f} s end to end (stages "
          f"{walls.fmt()}), the CPU run {cpu_s:.2f} s; peak {peak:.1f} MiB; launches {counts}; "
          f"on {card}")
    return counts


def phase_menu(torch, dev, tmp: str, card: str, mesh_img) -> dict:
    """main_menu() with a scripted input(): the 3-D viewer (option 5) on the
    directory of view's files, file 1 (the mesh), the offscreen render
    (backend 2), then exit. The render runs on the card and equals view's
    render of the same mesh."""
    import builtins

    from rtvm_tpu_torch import menus
    from rtvm_tpu_torch.io.imread import imread
    from rtvm_tpu_torch.viz import render

    t0 = time.time()
    src = os.path.join(tmp, "depth3d_image")
    answers = iter(["5", src, "1", "2", "0"])
    real_input = builtins.input
    builtins.input = lambda prompt="": next(answers)
    try:
        with _Walls(torch, [(render, "splat", "splat")]) as walls:
            _, counts = counted(menus.main_menu)
    finally:
        builtins.input = real_input
    check(counts == NO_LAUNCHES, f"menu: launch counts {counts}")
    check(walls.last["splat"][0][0].device.type == "cuda", "menu: the render did not run on the card")
    img = imread(os.path.join(src, "scene_mesh_render.png"))
    check(img is not None and np.array_equal(img, mesh_img),
          "menu: the render differs from view's render of the mesh")
    phase("menu", t0, f"viewer: scene_mesh.obj rendered on the card at {img.shape[1]}x"
                      f"{img.shape[0]}, equal to view's; launches {counts}; on {card}")
    return counts


def _multipart(name: str, payload: bytes) -> tuple:
    boundary = "----rtvmchipsmoke"
    head = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"video\"; filename=\"{name}\""
            "\r\nContent-Type: application/octet-stream\r\n\r\n").encode()
    return (head + payload + f"\r\n--{boundary}--\r\n".encode(),
            {"Content-Type": f"multipart/form-data; boundary={boundary}"})


def phase_web(torch, dev, tmp: str, card: str) -> dict:
    """The port's web server on 127.0.0.1 in a thread: a 1 + 16 frame
    360x640 .npy clip through /upload (multipart), /start and /progress
    (until done, within WEB_LIMIT_S) on the mosaic CLI's defaults (SIFT,
    detection and navigation); /results lists mosaic.jpg and it decodes.
    Launches warp 1 and patches 2 (one patch launch for the first frame, one
    for the window). An error state fails the phase."""
    import http.client
    import io
    import threading

    from rtvm_tpu_torch.io.imread import imdecode
    from rtvm_tpu_torch.ui import web_app

    t0 = time.time()
    frames = make_clip(np.random.RandomState(SEED + 15), 1 + WINDOW, FRAME_H, FRAME_W)[0]
    buf = io.BytesIO()
    np.save(buf, frames)
    app = web_app.WebApp(os.path.join(tmp, "web"))
    srv = web_app.make_server("127.0.0.1", 0, app)
    port = srv.server_address[1]
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()

    def req(method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request(method, path, body, headers or {})
        r = conn.getresponse()
        data = r.read()
        conn.close()
        return r.status, data

    states = []

    def run():
        check(req("POST", "/start")[0] == 200, "web: /start refused")
        t = time.time()
        while time.time() - t < WEB_LIMIT_S:
            p = json.loads(req("GET", "/progress")[1])
            states.append((p["state"], p["frame"]))
            if p["state"] in ("done", "error"):
                return p
            time.sleep(0.1)
        return p

    try:
        status, page = req("GET", "/")
        check(status == 200 and "Аэромозаика" in page.decode(), f"web: / gave {status}")
        status, body = req("POST", "/upload", *_multipart("clip.npy", buf.getvalue()))
        check(status == 200 and json.loads(body) == {"ok": True, "path": "clip.npy"},
              f"web: /upload gave {status} {body[:200]!r}")
        t = time.time()
        p, counts = counted(run)
        wall = time.time() - t
        check(p["state"] == "done", f"web: /progress ended at {p}")
        files = json.loads(req("GET", "/results")[1])["files"]
        status, jpg = req("GET", files.get("mosaic.jpg", "/results-files/mosaic.jpg"))
    finally:
        srv.shutdown()
        srv.server_close()
        server.join(timeout=30)
    check(counts == window_launches(1, 2),
          f"web: launch counts {counts}")
    img = imdecode(jpg) if status == 200 else None
    check(img is not None and img.ndim == 3, f"web: mosaic.jpg gave {status}")
    running = sorted({f for s, f in states if s == "running"})
    phase("web", t0,
          f"upload, start, {len(states)} polls of /progress (frames seen running: {running}) to "
          f"done in {wall:.3f} s; /results lists {sorted(files)}; mosaic.jpg {img.shape}; "
          f"launches {counts}; on {card}")
    return counts


# ------------------------------------------------------------- training (slice 10)

TRAIN_SIZE, TRAIN_BATCH = 320, 16  # the trainers' defaults (imgsz, batch)
TRAIN_STEPS = 20  # each trainer's steps on the card (its defaults run 3000-4000)
TRAIN_STEP_LR = 1e-3  # train_step: init_train_state's constant-rate AdamW
# train_step, card against the port's float32 CPU run on the same batch (TF32
# off): the loss relative; each gradient leaf's relative L2 where its norm is
# above GRAD_NOISE of the global norm (else within GRAD_NOISE of the global
# norm); the BatchNorm statistics after the step |d| / (1 + |v|); the share of
# parameters within 1e-5 after the step (Adam moves a noise-sized gradient's
# weight by about the rate either way) and the largest |d| (2 x the rate).
# Set from the first run on an H100 (PERF.md, section 6): loss rel 0, gradients
# 1.059e-3, statistics 1.1e-7, parameters 0.998997 within 1e-5 and 1.92e-3 at
# most; the tests hold the CPU run to JAX's at 1e-3 and 0.999 (tier 1)
STEP_BOUNDS = {"loss": 1e-4, "grad": 5e-3, "stats": 1e-4, "params_share": 0.995,
               "params_max": 2 * TRAIN_STEP_LR}
GRAD_NOISE = 1e-5
EVAL_N = 48  # held-out scenes of the trainers' reports
MAP_GAP = 0.03  # |mAP50 - the bundled report's|: bf16 (closed set) or float32 (world) inference
EVAL_CPU_SCENES = 4  # held-out scenes whose detections the card's run holds to the CPU's
DEPTH_REPORT_TOL = 5e-3  # abs_rel and pearson of `--steps 1 --lr 0` against weights/depthnet.json
DEPTH_ARGS: list = []  # train_depth.main's size and batch: its defaults (240x320, batch 8)


def _bundled_yolo(torch, dev, model: str = "yolov8n"):
    from rtvm_tpu_torch.models.yolo.convert import flax_to_state_dict
    from rtvm_tpu_torch.models.yolo.model import build_yolo
    from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

    path = DETECT_MODELS[model][0]
    m = build_yolo(model, num_classes=8, device="cpu")
    m.load_state_dict(flax_to_state_dict(load_pytree_npz(path), model))
    return m.to(dev)


class _Steps:
    """Wraps make_train_step of models/yolo/train.py: each step's wall (up
    to a synchronize) and loss, and the count of steps."""

    def __init__(self, torch):
        from rtvm_tpu_torch.models.yolo import train as TT

        self.torch, self.mod, self.real = torch, TT, TT.make_train_step
        self.ms, self.losses = [], []

    def __enter__(self):
        def make(model, tx):
            step = self.real(model, tx)

            def timed(state, images, targets):
                t = time.perf_counter()
                out = step(state, images, targets)
                self.losses.append(float(out[1]["loss"]))  # reads back: waits for the step
                self.ms.append((time.perf_counter() - t) * 1e3)
                return out
            return timed
        self.mod.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.mod.make_train_step = self.real


def _grad_report(want: dict, got: dict) -> tuple:
    """(largest relative L2 of the leaves above GRAD_NOISE of the global
    norm, largest |d| of the others over the global norm)."""
    gnorm = math.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in want.values()))
    big, small = 0.0, 0.0
    for k, v in want.items():
        n, err = float(np.linalg.norm(v)), float(np.linalg.norm(got[k] - v))
        if n > GRAD_NOISE * gnorm:
            big = max(big, err / n)
        else:
            small = max(small, err / gnorm)
    return big, small


def _profile_step(torch, fn) -> tuple:
    """(the card's kernel time in ms as text, kernel launches, the three
    largest kernels by time) of one call of fn, from torch.profiler."""
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == cuda
           and not e.name.startswith(("Memcpy", "Memset"))]
    if not evs:
        return "not measured", 0, "not measured"
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    total = sum(by_name.values())
    return (f"{total:.2f} ms", len(evs),
            ", ".join(f"{name[:60]} {ms:.2f} ms" for name, ms in top))


def phase_train_step(torch, dev, card: str) -> dict:
    """One yolo_loss + AdamW step at full width (YOLOv8n, batch 16, 320, the
    bundled checkpoint, init_train_state's optimizer) on the card and on the
    CPU with the same batch: loss, gradients, BatchNorm statistics and
    parameters within STEP_BOUNDS; then the step's warm ms and peak memory."""
    from rtvm_tpu_torch.models.yolo import synth
    from rtvm_tpu_torch.models.yolo import train as TT
    from rtvm_tpu_torch.models.yolo.convert import torch_to_flax_arrays
    from rtvm_tpu_torch.models.yolo.train_synth import _bgr_to_rgb01

    t0 = time.time()
    rng = np.random.RandomState(SEED + 20)
    imgs, boxes, cls, valid = synth.make_batch(rng, synth.BackgroundPool(TRAIN_SIZE, rng=rng),
                                              TRAIN_BATCH, TRAIN_SIZE)
    out = {}
    for where in ("cpu", dev):
        model = _bundled_yolo(torch, where)
        state, tx = TT.init_train_state(model, lr=TRAIN_STEP_LR)
        x = _bgr_to_rgb01(torch.from_numpy(imgs).to(where))
        tg = TT.Targets(*(torch.from_numpy(a).to(where) for a in (boxes, cls, valid)))
        step = TT.make_train_step(model, tx)
        if where == dev:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            (state, metrics), counts = counted(lambda: step(state, x, tg))
        else:
            state, metrics = step(state, x, tg)
        # the step leaves each gradient in .grad (clipped, as the update took it)
        grads = {k: p.grad for k, p in model.named_parameters()}
        out[str(where)] = dict(loss=float(metrics["loss"]), pos=float(metrics["num_pos"]),
                               grads=torch_to_flax_arrays(grads),
                               stats=torch_to_flax_arrays(dict(model.named_buffers())),
                               params=torch_to_flax_arrays(dict(model.named_parameters())),
                               state=state, step=step, x=x, tg=tg)
    ref, got = out["cpu"], out[str(dev)]
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_big, grad_small = _grad_report(ref["grads"], got["grads"])
    stats = max(float(np.max(np.abs(got["stats"][k] - v) / (1 + np.abs(v))))
                for k, v in ref["stats"].items())
    d = np.concatenate([np.abs(got["params"][k] - v).ravel() for k, v in ref["params"].items()])
    share, pmax = float((d <= 1e-5).mean()), float(d.max())

    # warm: further steps on the card, each up to a synchronize
    st, step = got["state"], got["step"]
    for _ in range(2):
        step(st, got["x"], got["tg"])
    torch.cuda.synchronize()
    ms = []
    for _ in range(5):
        t = time.perf_counter()
        step(st, got["x"], got["tg"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    busy, launches, top = _profile_step(torch, lambda: step(st, got["x"], got["tg"]))
    torch.cuda.set_sync_debug_mode("error")  # reported, not a gate: a sync costs only time
    try:
        step(st, got["x"], got["tg"])
        syncs = "no device sync inside the step"
    except RuntimeError as e:
        syncs = f"a device sync inside the step ({str(e).splitlines()[0][:120]})"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    worst = max(((float(np.linalg.norm(got["grads"][k] - v)) / max(float(np.linalg.norm(v)), 1e-30),
                  k) for k, v in ref["grads"].items()), key=lambda t: t[0])
    phase("train_step", t0,
          f"YOLOv8n batch {TRAIN_BATCH} at {TRAIN_SIZE} from {DETECT_MODELS['yolov8n'][0]}: loss "
          f"{got['loss']:.6f} (CPU {ref['loss']:.6f}, rel {loss_rel:.3e}), {got['pos']:.0f} "
          f"assigned cells (CPU {ref['pos']:.0f}); gradients: largest relative L2 {grad_big:.3e} "
          f"of the leaves above {GRAD_NOISE} of the global norm, the others within "
          f"{grad_small:.3e} of it; BatchNorm statistics within {stats:.3e} (1 + |v|); "
          f"parameters after the step within 1e-5 on {share:.6f}, largest |d| {pmax:.3e}; "
          f"warm step {np.median(ms):.2f} ms (median of {len(ms)}: "
          f"{', '.join(f'{v:.2f}' for v in ms)}); {busy} of the card's time in {launches} "
          f"kernel launches a step (torch.profiler), the largest {top}; {syncs}; the worst gradient "
          f"leaf {worst[1]} ({worst[0]:.3e}); peak {peak / 2**20:.1f} MiB allocated; launches "
          f"{counts}; on {card}")
    check(got["pos"] == ref["pos"], "train_step: the card assigned other cells than the CPU")
    check(loss_rel <= STEP_BOUNDS["loss"] and grad_big <= STEP_BOUNDS["grad"]
          and grad_small <= GRAD_NOISE and stats <= STEP_BOUNDS["stats"]
          and share >= STEP_BOUNDS["params_share"] and pmax <= STEP_BOUNDS["params_max"],
          f"train_step: beyond {STEP_BOUNDS}")
    check(counts == NO_LAUNCHES, f"train_step: launch counts {counts}")
    return counts


def _train_run(torch, trainer, stem: str, out: str, **kw):
    """trainer.train at its defaults but TRAIN_STEPS steps, logged each
    step, the report at the end; the steps' walls and losses and the host's
    make_batch apart. Returns (state, model, steps, synthesis walls, counts)."""
    with _Walls(torch, [(trainer, "make_batch", "make_batch")]) as walls, _Steps(torch) as steps:
        (state, model), counts = counted(lambda: trainer.train(
            steps=TRAIN_STEPS, batch=TRAIN_BATCH, imgsz=TRAIN_SIZE, lr=2e-3, log_every=1,
            eval_every=TRAIN_STEPS, out_dir=out, **kw))
    check(sorted(os.listdir(out)) == sorted(f"{stem}{e}" for e in (".json", ".npz", "_trainstate.npz")),
          f"{stem}: wrote {sorted(os.listdir(out))}")
    return state, model, steps, walls, counts


def _train_checks(name: str, stem: str, out: str, steps: "_Steps", bundled: str) -> str:
    losses = steps.losses
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"{name}: losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"{name}: the loss did not fall: first 5 {first:.4f}, last 5 {last:.4f}")
    with np.load(os.path.join(out, f"{stem}.npz")) as a, np.load(bundled) as b:
        same = bytes(a["__treedef__"]) == bytes(b["__treedef__"])
    check(same, f"{name}: __treedef__ differs from {bundled}'s")
    return f"loss {losses[0]:.3f} -> {losses[-1]:.3f} (mean of the first 5 {first:.3f}, last 5 {last:.3f})"


def _resume_check(torch, name: str, trainer, stem: str, out: str, dev) -> str:
    """--resume from the trainstate continues at the next step: one more
    step, and the written report says TRAIN_STEPS + 1."""
    again = os.path.join(out, "resumed")
    with _Steps(torch) as steps:
        state, _ = trainer.train(steps=TRAIN_STEPS + 1, batch=TRAIN_BATCH, imgsz=TRAIN_SIZE,
                                 lr=2e-3, log_every=1, eval_every=TRAIN_STEPS + 1, out_dir=again,
                                 resume=os.path.join(out, f"{stem}_trainstate.npz"), device=dev)
    report = json.load(open(os.path.join(again, f"{stem}.json")))
    check(len(steps.losses) == 1 and state.step == TRAIN_STEPS + 1
          and report["step"] == TRAIN_STEPS + 1,
          f"{name}: resumed run took {len(steps.losses)} steps to step {state.step}")
    return f"--resume continued at step {TRAIN_STEPS + 1} ({steps.ms[0]:.1f} ms)"


def _scene_share(card_dets: list, cpu_dets: list, gap: float) -> tuple:
    """(least share of matched detections over the scenes, (card count, CPU
    count)) at IoU >= 0.9, the same class and a score gap <= gap."""
    shares = [_dict_share(w, g, 0.9, gap) for w, g in zip(cpu_dets, card_dets)]
    return min(shares), (sum(len(d) for d in card_dets), sum(len(d) for d in cpu_dets))


def _world_scenes(torch, model, imgs: np.ndarray):
    """(flat float32 logits on the host, detection dicts) of the world model
    on scenes with the class names as prompts, as train_world.evaluate runs
    it (float32, conf 0.25, IoU 0.45)."""
    from rtvm_tpu_torch.models.yolo import postprocess as pp
    from rtvm_tpu_torch.models.yolo.synth import AERIAL_CLASSES
    from rtvm_tpu_torch.models.yolo.train_synth import _bgr_to_rgb01, _dets
    from rtvm_tpu_torch.models.yolo.train_world import _tokens

    dev = next(model.parameters()).device
    ids, mask = _tokens(AERIAL_CLASSES, dev)
    with torch.inference_mode():
        box_l, cls_l = model.eval()(_bgr_to_rgb01(torch.from_numpy(imgs).to(dev)), ids, mask)
        boxes, scores = pp.decode_predictions(box_l, cls_l, model.cfg.strides, model.cfg.reg_max)
        det = pp.nms_fixed(boxes, scores, 0.25, 0.45)
        table = torch.cat([det.boxes, det.scores[..., None], det.classes[..., None].float(),
                           det.valid[..., None].float()], -1).cpu().numpy()
        logits = torch.cat([v.flatten().cpu() for o in (box_l, cls_l) for v in o])
    return logits, [_dets(rows) for rows in table]


def train_synth_eval_set(n: int) -> np.ndarray:
    from rtvm_tpu_torch.models.yolo.train_synth import make_eval_set

    return make_eval_set(n, TRAIN_SIZE)[0]


def phase_train_synth(torch, dev, tmp: str, card: str) -> dict:
    """train_synth.train at its defaults (YOLOv8n, batch 16, 320, lr 2e-3)
    for TRAIN_STEPS steps on the card: the loss finite and falling, the
    checkpoint's structure byte-equal to the bundled one and loadable by
    ObjectDetector, --resume continuing at the next step; ms a step with the
    host's make_batch apart, peak memory."""
    from rtvm_tpu_torch.detect.detector import ObjectDetector
    from rtvm_tpu_torch.models.yolo import train_synth

    t0 = time.time()
    out = os.path.join(tmp, "train_synth")
    torch.cuda.reset_peak_memory_stats()
    state, model, steps, walls, counts = _train_run(torch, train_synth, "yolov8n_aerial", out,
                                                    device=dev)
    peak = torch.cuda.max_memory_allocated()
    note = _train_checks("train_synth", "yolov8n_aerial", out, steps, DETECT_MODELS["yolov8n"][0])
    path = os.path.join(out, "yolov8n_aerial.npz")
    det = ObjectDetector("yolov8n", weights_path=path, load_world=False, device=dev)
    check(det.weights_loaded and det.weights_source == path, "train_synth: ObjectDetector "
          f"did not load {path}")
    report = json.load(open(os.path.join(out, "yolov8n_aerial.json")))
    resumed = _resume_check(torch, "train_synth", train_synth, "yolov8n_aerial", out, dev)
    synth_ms = walls.walls["make_batch"] / TRAIN_STEPS
    phase("train_synth", t0,
          f"{TRAIN_STEPS} steps: {note}; a step {np.median(steps.ms[1:]):.2f} ms warm (median; "
          f"first {steps.ms[0]:.1f} ms), make_batch {synth_ms:.1f} ms a batch on the host (apart); "
          f"report at step {report['step']}: mAP50 {report['eval']['mAP50']}; the checkpoint's "
          f"treedef equals the bundled one and ObjectDetector loads it; {resumed}; peak "
          f"{peak / 2**20:.1f} MiB allocated; launches {counts}; on {card}")
    check(counts == NO_LAUNCHES, f"train_synth: launch counts {counts}")
    return counts


def phase_eval_yolo(torch, dev, card: str) -> dict:
    """train_synth.evaluate on weights/yolov8n_aerial.npz (48 held-out
    scenes at 320, bf16): mAP50 within MAP_GAP of the bundled report; the
    card's detections and logits on EVAL_CPU_SCENES scenes against the port's
    float32 run on the CPU within DET_BOUNDS["bfloat16"]."""
    from rtvm_tpu_torch.models.yolo import train_synth

    t0 = time.time()
    bundled = json.load(open(DETECT_MODELS["yolov8n"][0].replace(".npz", ".json")))["eval"]["mAP50"]
    model = _bundled_yolo(torch, dev)
    t = time.time()
    report, counts = counted(lambda: train_synth.evaluate(model, n=EVAL_N, size=TRAIN_SIZE))
    eval_s = time.time() - t
    gap = abs(report["mAP50"] - bundled)
    imgs = train_synth_eval_set(EVAL_CPU_SCENES)
    rel_max, share_min, gap_max = DET_BOUNDS["bfloat16"]
    cpu_model = _bundled_yolo(torch, "cpu")
    card_dets = train_synth.predict_scenes(model, imgs)
    cpu_dets = train_synth.predict_scenes(cpu_model, imgs, bf16=False)
    share, n = _scene_share(card_dets, cpu_dets, gap_max)
    x = train_synth._bgr_to_rgb01(torch.from_numpy(imgs))
    with torch.inference_mode():
        ref = torch.cat([v.flatten() for o in cpu_model.eval()(x) for v in o])
        m16 = copy.deepcopy(model).eval().to(torch.bfloat16)
        got = torch.cat([v.float().flatten().cpu() for o in m16(x.to(dev, torch.bfloat16)) for v in o])
    rel = float((got - ref).abs().max() / ref.abs().max())
    phase("eval_yolo", t0,
          f"{DETECT_MODELS['yolov8n'][0]} on {EVAL_N} held-out scenes at {TRAIN_SIZE} in bf16: "
          f"mAP50 {report['mAP50']} (bundled report {bundled}, gap {gap:.4f}) in {eval_s:.2f} s; "
          f"{report}; {EVAL_CPU_SCENES} scenes against the CPU's float32 run: logits max |d| "
          f"{rel:.3e} of the largest, {n[0]} card and {n[1]} CPU detections, matched share "
          f"{share:.3f} (IoU 0.9, score gap {gap_max}); launches {counts}; on {card}")
    check(gap <= MAP_GAP, f"eval_yolo: mAP50 {report['mAP50']} vs {bundled}")
    check(rel <= rel_max and share >= share_min, f"eval_yolo: beyond {DET_BOUNDS['bfloat16']}")
    check(counts == NO_LAUNCHES, f"eval_yolo: launch counts {counts}")
    return counts


def phase_train_world(torch, dev, tmp: str, card: str) -> dict:
    """train_world.train at its defaults for TRAIN_STEPS steps on the card
    (the checks of train_synth, YoloWorldDetector loading the checkpoint),
    then train_world.evaluate on weights/yolov8n_world.npz (float32, as JAX
    runs it): mAP50 within MAP_GAP of the bundled report, and the card's
    detections on EVAL_CPU_SCENES scenes against the CPU's within
    DET_BOUNDS["float32"]."""
    from rtvm_tpu_torch.models.yolo import train_world
    from rtvm_tpu_torch.models.yolo.convert import flax_to_state_dict
    from rtvm_tpu_torch.models.yolo.world import YoloWorldDetector, build_yolo_world
    from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

    t0 = time.time()
    out = os.path.join(tmp, "train_world")
    torch.cuda.reset_peak_memory_stats()
    state, model, steps, walls, counts = _train_run(torch, train_world, "yolov8n_world", out,
                                                    device=dev)
    peak = torch.cuda.max_memory_allocated()
    note = _train_checks("train_world", "yolov8n_world", out, steps, NAV_WORLD_NPZ)
    path = os.path.join(out, "yolov8n_world.npz")
    wd = YoloWorldDetector(weights_path=path, device=dev)
    check(wd.is_open_vocab and wd.weights_source == path, f"train_world: {path} not loaded")
    resumed = _resume_check(torch, "train_world", train_world, "yolov8n_world", out, dev)

    bundled = json.load(open(NAV_WORLD_NPZ.replace(".npz", ".json")))["eval"]["mAP50"]
    models = {}
    for where in ("cpu", dev):
        m = build_yolo_world("yolov8n", device="cpu")
        m.load_state_dict(flax_to_state_dict(load_pytree_npz(NAV_WORLD_NPZ), "yolov8n"))
        models[str(where)] = m.to(where)
    t = time.time()
    report, eval_counts = counted(lambda: train_world.evaluate(models[str(dev)], n=EVAL_N,
                                                              imgsz=TRAIN_SIZE))
    eval_s = time.time() - t
    gap = abs(report["mAP50"] - bundled)
    imgs = train_synth_eval_set(EVAL_CPU_SCENES)
    rel_max, share_min, gap_max = DET_BOUNDS["float32"]
    (cpu_logits, cpu_dets), (card_logits, card_dets) = (_world_scenes(torch, models[k], imgs)
                                                        for k in ("cpu", str(dev)))
    rel = float((card_logits - cpu_logits).abs().max() / cpu_logits.abs().max())
    share, n = _scene_share(card_dets, cpu_dets, gap_max)
    phase("train_world", t0,
          f"{TRAIN_STEPS} steps: {note}; a step {np.median(steps.ms[1:]):.2f} ms warm (median; "
          f"first {steps.ms[0]:.1f} ms), make_batch {walls.walls['make_batch'] / TRAIN_STEPS:.1f} "
          f"ms a batch on the host (apart); treedef equals {NAV_WORLD_NPZ}'s and "
          f"YoloWorldDetector loads it; {resumed}; peak {peak / 2**20:.1f} MiB allocated; "
          f"{NAV_WORLD_NPZ} on {EVAL_N} held-out scenes (float32): mAP50 {report['mAP50']} "
          f"(bundled report {bundled}, gap {gap:.4f}) in {eval_s:.2f} s; {report}; "
          f"{EVAL_CPU_SCENES} scenes against the CPU's float32 run: logits max |d| {rel:.3e} of "
          f"the largest, {n[0]} card and {n[1]} CPU detections, matched share {share:.3f} (IoU "
          f"0.9, score gap {gap_max}); launches {counts} and {eval_counts}; on {card}")
    check(gap <= MAP_GAP, f"train_world: mAP50 {report['mAP50']} vs {bundled}")
    check(rel <= rel_max and share >= share_min, f"train_world: beyond {DET_BOUNDS['float32']}")
    check(counts == NO_LAUNCHES and eval_counts == NO_LAUNCHES,
          f"train_world: launch counts {counts} {eval_counts}")
    return add_launches(counts, eval_counts)


def phase_train_depth(torch, dev, tmp: str, card: str) -> dict:
    """train_depth.main on the card: --steps 1 --lr 0 --init
    weights/depthnet.npz reproduces weights/depthnet.json (abs_rel and
    pearson within DEPTH_REPORT_TOL; at lr 0 nothing moves); then
    TRAIN_STEPS steps at the defaults (240x320, batch 8) from the port's
    seeded init: ms a step (the loader's spawned pool apart), the loss
    finite, peak memory."""
    from rtvm_tpu_torch.models import train_depth

    t0 = time.time()
    want = json.load(open("weights/depthnet.json"))
    out = os.path.join(tmp, "train_depth_lr0")
    _, counts = counted(lambda: train_depth.main(
        DEPTH_ARGS + ["--steps", "1", "--lr", "0", "--init", "weights/depthnet.npz",
                      "--out-dir", out],
        device=dev))
    got = json.load(open(os.path.join(out, "depthnet.json")))
    gaps = {k: abs(got[k] - want[k]) for k in ("abs_rel", "pearson")}
    with np.load(os.path.join(out, "depthnet.npz")) as a, np.load("weights/depthnet.npz") as b:
        unmoved = all(np.array_equal(a[k], b[k]) for k in b.files)

    out2 = os.path.join(tmp, "train_depth")
    real_step, ms, losses = train_depth.train_step, [], []

    def timed(*a, **k):
        t = time.perf_counter()
        loss = real_step(*a, **k)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t) * 1e3)
        return loss

    train_depth.train_step = timed
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    try:
        _, counts2 = counted(lambda: train_depth.main(
            DEPTH_ARGS + ["--steps", str(TRAIN_STEPS), "--out-dir", out2], device=dev))
    finally:
        train_depth.train_step = real_step
    wall = time.time() - t
    peak = torch.cuda.max_memory_allocated()
    report = json.load(open(os.path.join(out2, "depthnet.json")))
    phase("train_depth", t0,
          f"--steps 1 --lr 0 --init weights/depthnet.npz: abs_rel {got['abs_rel']:.6f} pearson "
          f"{got['pearson']:.6f} (weights/depthnet.json {want['abs_rel']:.6f} "
          f"{want['pearson']:.6f}, gaps {gaps['abs_rel']:.2e} {gaps['pearson']:.2e}), parameters "
          f"{'unmoved' if unmoved else 'MOVED'}; {TRAIN_STEPS} steps at 240x320 batch 8: a step "
          f"{np.median(ms[1:]):.2f} ms warm (median; first {ms[0]:.1f} ms), loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}, main's wall {wall:.2f} s (spawned pool, report), report "
          f"abs_rel {report['abs_rel']:.4f} pearson {report['pearson']:.4f}; peak "
          f"{peak / 2**20:.1f} MiB allocated; launches {counts} and {counts2}; on {card}")
    check(max(gaps.values()) <= DEPTH_REPORT_TOL, f"train_depth: report gaps {gaps}")
    check(unmoved, "train_depth: --lr 0 moved the parameters")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"train_depth: losses {losses}")
    check(counts == NO_LAUNCHES and counts2 == NO_LAUNCHES,
          f"train_depth: launch counts {counts} {counts2}")
    return counts2


# ------------------------------------------------- slice 11: mesh and .pt

MESH_RANKS = 4  # a (2, 2) mesh, every rank on the one card (gloo)
MESH_WINDOWS = 2  # of the 360x640 cases the phase adds: the second is timed warm
# The sharded steps against the same steps in one process on the card.
# On the (2, 2) mesh: the accepted flags equal; H_abs within MESH_H_REL of
# its largest entry: each dp rank extracts and fits 4 of the 8 frames, and
# the card rounds a batch of 4 otherwise than one of 8 (the phase's line
# shows it in one process: the features of frames 0-3 and 4-7 against the
# same frames in a batch of 8, and match + RANSAC of pairs 0-3 and 4-7
# against the same pairs in a batch of 8; on the CPU both are bitwise,
# tests/test_torch_mesh.py). A sample point that moves by such an amount
# can cross a frame's edge and flip a pixel of the ring in or out, and its
# weights spread that over MESH_EDGE_BAND px (hole distance 34, blur 15):
# the canvas is held to test_multichip.py's bounds for JAX's sharded step,
# the mean over the canvas and the largest off those bands.
MESH_H_REL = 1e-6
MESH_CANVAS_MEAN, MESH_CANVAS_MAX = 0.5, 2.0
MESH_EDGE_BAND = 50
# On the (1, 4) mesh every rank extracts and fits the whole window, as one
# process does, and only the paint is sharded: the state and the whole
# canvas, frame edges included, bitwise the one-process step's
# (MESH_TP_CANVAS_TOL 0). The blend weights' blur (kernel E, csrc/blend.cu)
# sums each output in one fixed order, so a band's rows hold the whole
# canvas's bits wherever its halo lies inside the band (the phase's witness
# on blend_weights_smoothed alone reads 0).
MESH_TP_FIELDS = ("ok", "blended", "H_abs", "num_inliers", "num_matches", "H_old",
                  "hbuf", "kp", "desc", "kp_valid", "union_coarse")
MESH_TP_CANVAS_TOL = 0.0
# Training (tests/test_torch_mesh.py's bounds): the loss relative, BatchNorm's
# statistics, each weight within two Adam steps of lr (a gradient within
# rounding of 0 may take either sign), the share of values more than 1e-5
# apart.
MESH_LOSS_RTOL, MESH_STATS_TOL, MESH_PARAM_MAX, MESH_PARAM_SHARE = 1e-6, 1e-6, 2e-3 + 1e-6, 1e-3
# The seeded yolo11s's float32 logits on the card against the CPU, over the
# largest: its BatchNorm statistics are calibrated on 4 frames, and some
# channels' small variances scale the rounding up (on an H100, 700 W:
# 4.93e-5; the bundled checkpoints' 1.1e-6 is DET_BOUNDS's).
PT_LOGIT_TOL = 1e-4
BAND_CASES = ((0, 720), (8, 360), (311, 409), (668, 52), (717, 3), (1, 7))  # (row0, rows)


def _mesh_band_checks(name: str, ranks: list, hc: int, tp: int) -> None:
    """Each rank holds one band of the canvas and warps it with its halo."""
    for r in ranks:
        a, b = r["band"]
        (_, _), (lo, hi) = r["rows"]
        check(r["mesh"][1] == tp and r["canvas_band"][1] == b - a < hc and a - lo <= 48
              and hi - b <= 50,
              f"{name}: rank {r['rank']} of mesh {r['mesh']} holds {r['canvas_band']}, warps "
              f"rows [{lo}, {hi})")


def _mesh_times(ranks: list) -> str:
    return (f"step ms/rank (the last window) {[round(r['step_ms'][-1], 2) for r in ranks]}, "
            f"collectives ms/rank {[round(r['comm_ms'][-1], 2) for r in ranks]}, peak MiB/rank "
            f"{[_mib(r['peak_mib']) for r in ranks]}")


def _mesh_window_checks(name: str, ranks: list, want: dict, min_ok: int) -> str:
    got = ranks[0]
    check(np.array_equal(got["ok"], want["ok"]) and np.array_equal(got["blended"], want["blended"]),
          f"{name}: accepted frames {got['ok'].astype(int).tolist()} against one process's "
          f"{want['ok'].astype(int).tolist()}")
    h_err = float(np.abs(got["H_abs"] - want["H_abs"]).max())
    d = np.abs(got["canvas"] - want["canvas"])
    away = _off_frame_edges(want["H_abs"].reshape(-1, 3, 3), FRAME_H, FRAME_W, *d.shape[1:])
    c_mean, c_err, c_off = float(d.mean()), float(d.max()), float(d[:, away].max())
    check(h_err <= MESH_H_REL * max(1.0, float(np.abs(want["H_abs"]).max())),
          f"{name}: H_abs {h_err} off the one-process step")
    check(c_mean <= MESH_CANVAS_MEAN and c_off <= MESH_CANVAS_MAX,
          f"{name}: canvas {c_mean} mean, {c_off} largest off the frame edges ({c_err} on "
          f"them) grey levels off the one-process step")
    check(np.isfinite(got["canvas"]).all() and got["ok"].sum() >= min_ok,
          f"{name}: {int(got['ok'].sum())} frames accepted, fewer than {min_ok}")
    _mesh_band_checks(name, ranks, got["canvas"].shape[1], 2)
    return (f"{name}: ok {int(got['ok'].sum())}/{got['ok'].size}, H_abs {h_err:.3g}, canvas "
            f"{c_mean:.3g} mean, {c_off:.3g} largest off the frame edges ({away.mean():.3f} of "
            f"it; {c_err:.3g} on them), equal on {float((d == 0).mean()):.6f}, "
            + _mesh_times(ranks))


def _mesh_tp_checks(name: str, ranks: list, want: dict) -> str:
    got = ranks[0]
    d = np.abs(got["canvas"] - want["canvas"])
    check(all(np.array_equal(got[k], want[k]) for k in MESH_TP_FIELDS),
          f"{name}: not bitwise the one-process step in "
          f"{[k for k in MESH_TP_FIELDS if not np.array_equal(got[k], want[k])]}")
    check(float(d.max()) <= MESH_TP_CANVAS_TOL,
          f"{name}: canvas {float(d.max())} largest, {float(d.mean())} mean grey levels off the "
          f"one-process step, equal on {float((d == 0).mean())}")
    check(got["ok"].sum() >= 14, f"{name}: {int(got['ok'].sum())} frames accepted")
    _mesh_band_checks(name, ranks, got["canvas"].shape[1], MESH_RANKS)
    return (f"{name}: mesh (1, {MESH_RANKS}), bands {[r['band'] for r in ranks]}, ok "
            f"{int(got['ok'].sum())}/{got['ok'].size}, state bitwise, canvas "
            f"{float(d.max()):.3g} largest, {float(d.mean()):.3g} mean grey levels off (frame "
            f"edges included), equal on {float((d == 0).mean()):.6f}, " + _mesh_times(ranks))


def _blur_witness(torch, dev, hc: int, wc: int, tp: int) -> str:
    """blend_weights_smoothed on each tp band's rows [l, h) alone against the
    same rows of the whole canvas's, on random weights [8, hc, wc] on the
    card: the largest |d| of alpha and beta over the bands' own rows."""
    from rtvm_tpu_torch.ops import warp as warp_ops
    from rtvm_tpu_torch.parallel import mesh as PM

    g = torch.Generator().manual_seed(SEED)
    w_new, w_old = (torch.rand((8, hc, wc), generator=g).mul(40.0).to(dev) for _ in range(2))
    full = warp_ops.blend_weights_smoothed(w_new, w_old)
    gap = 0.0
    for a, b in PM.canvas_bands(hc, tp):
        (l, h), _ = PM.paint_rows((a, b), hc)
        part = warp_ops.blend_weights_smoothed(w_new[:, l:h], w_old[:, l:h])
        gap = max([gap] + [float((p[:, a - l : b - l] - f[:, a:b]).abs().max())
                           for p, f in zip(part, full)])
    return f"blend weights of {tp} bands alone against the whole canvas's: {gap:.3g}"


def _batch_witness(torch, case: dict, dev) -> str:
    """The (2, 2) mesh's dp split in one process on the card: the features of
    frames 0-3 and 4-7 of the case's first window against the same frames in
    a batch of 8, and match + RANSAC of pairs 0-3 and 4-7 against the same
    pairs in a batch of 8 (on the batch of 8's features)."""
    from rtvm_tpu_torch.mosaic import stitcher as S
    from rtvm_tpu_torch.ops import color
    from rtvm_tpu_torch.parallel import mesh as PM

    m, windows = PM._window_setup(case, dev)
    cfg, st, fr = m.config, m.state, windows[0]
    f8 = S._extract_features(color.bgr2gray(fr), cfg)
    f4 = [S._extract_features(color.bgr2gray(fr[i : i + 4]), cfg) for i in (0, 4)]
    f4 = [torch.cat([h[j] for h in f4]) for j in range(3)]
    feats_equal = all(torch.equal(x, y) for x, y in zip(f4, f8))
    kp_gap = float((f4[0] - f8[0]).abs().max())
    u = S.pair_uniforms(m.seed, int(st.frame_idx), 8, cfg, dev)
    r8, _ = S.match_and_fit(*f8, st.kp, st.desc, st.kp_valid, u, cfg)
    ra, _ = S.match_and_fit(*(x[:4] for x in f8), st.kp, st.desc, st.kp_valid, u[:4], cfg)
    rb, _ = S.match_and_fit(*(x[4:] for x in f8), *(x[3] for x in f8), u[4:], cfg)
    h4 = torch.cat([ra.H, rb.H])
    return (f"{case['detector']} in one process, 4 against 8: features bitwise {feats_equal} "
            f"(keypoints {kp_gap:.3g} px), H_rel {float((h4 - r8.H).abs().max()):.3g} (bitwise "
            f"{torch.equal(h4, r8.H)}), ok equal "
            f"{torch.equal(torch.cat([ra.ok, rb.ok]), r8.ok)}")


def _off_frame_edges(H_abs: np.ndarray, hf: int, wf: int, hc: int, wc: int) -> np.ndarray:
    """bool [hc, wc]: canvas pixels farther than MESH_EDGE_BAND from every
    edge of every frame's warped rectangle."""
    ys, xs = np.mgrid[0:hc, 0:wc]
    keep = np.ones((hc, wc), bool)
    band = MESH_EDGE_BAND
    for H in np.asarray(H_abs, np.float64):
        c = H @ np.array([[0, wf - 1, wf - 1, 0], [0, 0, hf - 1, hf - 1], [1, 1, 1, 1]], np.float64)
        x0, x1 = (c[0] / c[2]).min(), (c[0] / c[2]).max()
        y0, y1 = (c[1] / c[2]).min(), (c[1] / c[2]).max()
        in_x = (xs > x0 - band) & (xs < x1 + band)
        in_y = (ys > y0 - band) & (ys < y1 + band)
        near = ((np.abs(xs - x0) <= band) | (np.abs(xs - x1) <= band)) & in_y
        near |= ((np.abs(ys - y0) <= band) | (np.abs(ys - y1) <= band)) & in_x
        keep &= ~near
    return keep


def _mib(x) -> str:
    return "not measured" if x is None else f"{x:.1f}"


def _sum_launches(ranks: list) -> dict:
    return add_launches(*(r["launches"] for r in ranks))


def _train_gap(want: dict, got: dict) -> tuple:
    """(largest |d| of BatchNorm's statistics, of the other tensors, and the
    share of the others' values more than 1e-5 apart)."""
    stats = weights = 0.0
    off = total = 0
    for k, v in want.items():
        d = np.abs(got[k] - v)
        if k.endswith((".mean", ".var")):
            stats = max(stats, float(d.max()))
        else:
            weights = max(weights, float(d.max()))
            off, total = off + int((d > 1e-5).sum()), total + d.size
    return stats, weights, off / total


def phase_mesh(torch, dev, card: str) -> tuple:
    """parallel/mesh.py on the card: kernel A with a row origin against the
    full warp; then dryrun_multichip(4), every rank on the one card under
    gloo (the tiny ORB window, the dp YOLO step, dp detection, the 360x640
    ORB window), and in a second spawn two 360x640 SIFT windows on the
    (2, 2) mesh and two ORB windows on (1, 4), each held against the same
    step in one process on the card. Returns (the launches of the sharded
    windows summed over the ranks, the one-process run of the two ORB
    windows)."""
    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.models.yolo.postprocess import Detections, match_detections
    from rtvm_tpu_torch.ops.kernel_warp import inverse_maps, warp_batch, warp_plain
    from rtvm_tpu_torch.parallel import mesh as PM

    t0 = time.time()
    case = PM.production_case("orb")
    fr = torch.as_tensor(case["windows"][0]).to(dev).float().permute(0, 3, 1, 2).contiguous()
    H = torch.tensor([[[1.0, 0.01 * i, 64.0 - 2 * i], [-0.01 * i, 1.0, 300.0 - 2 * i],
                       [2e-5 * i, -1e-5 * i, 1.0]] for i in range(fr.shape[0])], device=dev)
    G = inverse_maps(H)
    full = warp_batch(fr, G, 720, 768)
    for row0, rows in BAND_CASES:
        band = warp_batch(fr, G, rows, 768, row0=row0)
        check(torch.equal(band, full[:, :, row0 : row0 + rows]),
              f"mesh: kernel A at row0={row0} differs from the full warp's rows")
        check(torch.equal(band, warp_plain(fr, G, rows, 768, row0)),
              f"mesh: kernel A at row0={row0} differs from warp_plain")

    out = PM.dryrun_multichip(MESH_RANKS, device=dev)
    check(out["backend"] == "gloo", f"mesh: backend {out['backend']} for 4 ranks on one card")
    more = {"production_sift": PM.production_case("sift", MESH_WINDOWS),
            "production_tp4": dict(PM.production_case("orb", MESH_WINDOWS), tp=MESH_RANKS)}
    res = PM.run_ranks(MESH_RANKS, [(PM.window_job, c) for c in more.values()], device=dev)
    ranks_of = dict(zip(more, res["jobs"]), window=out["window"], production=out["production"])
    cases = dict(out["cases"], **more)
    notes, counts = [], dict(NO_LAUNCHES)
    singles = {}
    for name in ("window", "production", "production_sift", "production_tp4"):
        ranks = ranks_of[name]
        kernels.reset_launches()
        singles[name] = PM.single_window_run(cases[name], device=dev)
        if name == "production_tp4":
            notes.append(_mesh_tp_checks(name, ranks, singles[name]))
        else:  # the tiny window's frames are noise (JAX's dry run): nothing to accept
            notes.append(_mesh_window_checks(name, ranks, singles[name],
                                             0 if name == "window" else 7))
        got = _sum_launches(ranks)
        n = MESH_RANKS * len(ranks[0]["step_ms"])  # one a rank a window
        want = window_launches(n, n if name.endswith("sift") else 0)
        check(got == want, f"mesh: {name}'s launches over the ranks {got}, expected {want}")
        counts = add_launches(counts, got)
    notes += ["witness: " + _batch_witness(torch, cases[k], dev)
              for k in ("production", "production_sift")]
    notes.append("witness: " + _blur_witness(torch, dev, 720, 768, MESH_RANKS))

    tr = PM.single_train_run(out["cases"]["train"], device=dev)
    got = out["train"][0]
    loss_rel = abs(got["loss"] - tr["loss"]) / abs(tr["loss"])
    stats, weights, share = _train_gap(tr["state_dict"], got["state_dict"])
    check(loss_rel <= MESH_LOSS_RTOL and stats <= MESH_STATS_TOL and weights <= MESH_PARAM_MAX
          and share <= MESH_PARAM_SHARE,
          f"mesh: dp training step off the one-process step: loss {loss_rel:.3g} relative, "
          f"statistics {stats:.3g}, weights {weights:.3g}, share {share:.3g}")
    notes.append(f"train: loss {got['loss']:.6f} ({loss_rel:.3g} rel), statistics {stats:.3g}, "
                 f"weights {weights:.3g} (share {share:.3g} > 1e-5), first and warm step ms/rank "
                 f"{[(round(r['ms'], 2), round(r['warm_ms'], 2)) for r in out['train']]}, "
                 f"warm collectives ms/rank {[round(r['warm_comm_ms'], 2) for r in out['train']]}, "
                 f"peak MiB/rank "
                 f"{[_mib(r['peak_mib']) for r in out['train']]}")

    dr = PM.single_detection_run(out["cases"]["detect"], device=dev)
    got = out["detect"][0]
    m = match_detections(Detections(*(torch.as_tensor(dr[k]) for k in Detections._fields)),
                         Detections(*(torch.as_tensor(got[k]) for k in Detections._fields)))
    _, share_min, gap_max = DET_BOUNDS["float32"]
    check(m["n_ref"] == 0 or (m["share"] >= share_min and m["max_score_gap"] <= gap_max),
          f"mesh: dp detection against one process: {m}")
    notes.append(f"detect: {m['n_ref']} detections, matched {m['share']:.4f}, score gap "
                 f"{m['max_score_gap']:.3g}, ms/rank {[round(r['ms'], 2) for r in out['detect']]}")
    phase("mesh", t0, f"kernel A at {len(BAND_CASES)} row origins bitwise the full warp's rows; "
          f"4 ranks ({out['backend']}), spawn to results {out['spawn_s']:.2f} s and "
          f"{res['spawn_s']:.2f} s, init s/rank {[round(x, 3) for x in out['init_s']]} and "
          f"{[round(x, 3) for x in res['init_s']]}; " + "; ".join(notes)
          + f"; launches over the ranks {counts}; on {card}")
    return counts, singles["production_tp4"]


def phase_mesh_nccl(torch, dev, card: str, want: dict) -> dict:
    """The two 360x640 ORB windows through the sharded step in one rank,
    whose backend is NCCL (one rank, one card): equal to `want`, the
    one-process step's result (mesh.single_window_run)."""
    from rtvm_tpu_torch.parallel import mesh as PM

    t0 = time.time()
    res = PM.run_ranks(1, [(PM.window_job, PM.production_case("orb", MESH_WINDOWS))], device=dev)
    check(res["backend"] == "nccl", f"mesh_nccl: backend {res['backend']}")
    got = res["jobs"][0][0]
    for k in ("ok", "H_abs", "canvas", "union_coarse", "kp", "desc", "H_old"):
        check(np.array_equal(got[k], want[k]), f"mesh_nccl: {k} differs from the one-process step")
    counts = _sum_launches([got])
    check(counts == window_launches(MESH_WINDOWS),
          f"mesh_nccl: launches {counts}")
    phase("mesh_nccl", t0, f"1 rank on NCCL, mesh {got['mesh']}: ok {int(got['ok'].sum())}/"
          f"{got['ok'].size}, H_abs and canvas bitwise the one-process step's; step ms (each "
          f"window) {[round(x, 2) for x in got['step_ms']]}, "
          f"collectives {got['comm_ms'][-1]:.2f} ms (host, the last window), "
          f"spawn to results {res['spawn_s']:.2f} s, "
          f"peak {_mib(got['peak_mib'])} MiB; launches {counts}; on {card}")
    return counts


def _conv_keys(p: str) -> list:
    return [f"{p}.conv.weight", f"{p}.bn.weight", f"{p}.bn.bias", f"{p}.bn.running_mean",
            f"{p}.bn.running_var", f"{p}.bn.num_batches_tracked"]


def ultralytics_keys(variant: str) -> list:
    """The state-dict keys of an ultralytics DetectionModel: yolov8n, or a
    YOLO11 scale of depth 0.50 (n, s: one block per C3k2, a nested C3k at
    layers 6, 8 and 22)."""
    def pair(p):
        return _conv_keys(f"{p}.cv1") + _conv_keys(f"{p}.cv2")

    if variant == "yolov8n":
        convs, head = (0, 1, 3, 5, 7, 16, 19), 22
        ks = sum((_conv_keys(f"model.{i}") for i in convs), [])
        for i, n in {2: 1, 4: 2, 6: 2, 8: 1, 12: 1, 15: 1, 18: 1, 21: 1}.items():  # C2f
            ks += pair(f"model.{i}") + sum((pair(f"model.{i}.m.{j}") for j in range(n)), [])
        for br in ("cv2", "cv3"):
            for s in range(3):
                ks += _conv_keys(f"model.22.{br}.{s}.0") + _conv_keys(f"model.22.{br}.{s}.1")
    else:
        convs, head = (0, 1, 3, 5, 7, 17, 20), 23
        ks = sum((_conv_keys(f"model.{i}") for i in convs), [])
        for i in (2, 4, 6, 8, 13, 16, 19, 22):  # C3k2
            ks += pair(f"model.{i}")
            if i in (6, 8, 22):
                ks += pair(f"model.{i}.m.0") + _conv_keys(f"model.{i}.m.0.cv3")
                ks += pair(f"model.{i}.m.0.m.0") + pair(f"model.{i}.m.0.m.1")
            else:
                ks += pair(f"model.{i}.m.0")
        ks += pair("model.10")  # C2PSA
        ks += sum((_conv_keys(f"model.10.m.0.attn.{a}") for a in ("qkv", "proj", "pe")), [])
        ks += _conv_keys("model.10.m.0.ffn.0") + _conv_keys("model.10.m.0.ffn.1")
        for s in range(3):
            ks += _conv_keys(f"model.23.cv2.{s}.0") + _conv_keys(f"model.23.cv2.{s}.1")
            for a in range(2):
                ks += _conv_keys(f"model.23.cv3.{s}.{a}.0") + _conv_keys(f"model.23.cv3.{s}.{a}.1")
    ks += pair("model.9")  # SPPF
    for br in ("cv2", "cv3"):
        ks += sum(([f"model.{head}.{br}.{s}.2.weight", f"model.{head}.{br}.{s}.2.bias"]
                   for s in range(3)), [])
    return ks + [f"model.{head}.dfl.conv.weight"]


def write_ultralytics_pt(torch, path: str, values: dict, variant: str, half: bool) -> None:
    """torch.save of nested plain nn.Modules whose state_dict has
    ultralytics' keys for `variant`, holding `values` (the port's
    state_dict), in half precision as ultralytics saves where `half`."""
    from torch import nn

    from rtvm_tpu_torch.models.yolo.convert import state_dict_key
    from rtvm_tpu_torch.models.yolo.weights import ult_key_to_flax

    root = nn.Module()
    for key in ultralytics_keys(variant):
        m = ult_key_to_flax(key, variant)
        if key.endswith("num_batches_tracked"):
            t = torch.zeros((), dtype=torch.int64)
        elif m is None:  # the fixed DFL convolution
            t = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1, 1)
        else:
            t = values[state_dict_key("/".join((m[0],) + m[1]))[0]].detach().cpu().clone()
        t = t.half() if half and t.is_floating_point() else t
        node = root
        for p in key.split(".")[:-1]:
            if p not in node._modules:
                node.add_module(p, nn.Module())
            node = node._modules[p]
        name = key.split(".")[-1]
        if name.startswith(("running_", "num_batches")):
            node.register_buffer(name, t)
        else:
            node.register_parameter(name, nn.Parameter(t, requires_grad=False))
    torch.save({"model": root}, path)


def _calibrated_yolo(torch, variant: str, frames4: np.ndarray) -> dict:
    """The state_dict of `variant` (80 classes) from PyTorch's seeded init
    with every BatchNorm's statistics those of its input on frames4 at 640
    (one forward pass in training mode) and the class biases lowered by 4:
    scores that vary as a trained model's do. With the init's statistics
    every anchor of a deep random net scores the same, and the NMS then
    breaks exact ties by one ulp of difference between two devices."""
    from rtvm_tpu_torch.models.yolo import postprocess as pp
    from rtvm_tpu_torch.models.yolo.model import build_yolo
    from rtvm_tpu_torch.models.yolo.modules import BatchNorm

    model = build_yolo(variant, 80, seed=SEED, device="cpu")

    def take_stats(bn, inp, _):
        x = inp[0].float()
        bn.mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_hook(take_stats) for m in model.modules()
             if isinstance(m, BatchNorm)]
    model.train()
    with torch.no_grad():
        model(pp.preprocess_frames(torch.as_tensor(frames4), DET_IMGSZ)[0])
    for h in hooks:
        h.remove()
    values = {k: v.clone() for k, v in model.state_dict().items()}
    for s in range(3):
        values[f"DetectHead_0.Conv_{2 * s + 1}.bias"] -= 4.0
    return values


def phase_weights_pt(torch, dev, tmp: str, frames4: np.ndarray, card: str) -> dict:
    """The ultralytics .pt route: weights/yolov8n_aerial.npz written as an
    ultralytics-layout .pt and converted back equals the .npz route's
    state_dict, with the same logits on the card; ObjectDetector("yolo11s")
    (no bundled checkpoint) from a seeded .pt on the card against its run on
    the CPU."""
    from rtvm_tpu_torch import kernels
    from rtvm_tpu_torch.detect.detector import ObjectDetector
    from rtvm_tpu_torch.models.yolo import weights as W
    from rtvm_tpu_torch.models.yolo.convert import flax_to_state_dict
    from rtvm_tpu_torch.models.yolo.model import build_yolo
    from rtvm_tpu_torch.models.yolo.postprocess import match_detections
    from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

    t0 = time.time()
    want = flax_to_state_dict(load_pytree_npz(DETECT_MODELS["yolov8n"][0]), "yolov8n")
    pt = os.path.join(tmp, "yolov8n_ultralytics.pt")
    write_ultralytics_pt(torch, pt, want, "yolov8n", half=False)
    kernels.reset_launches()
    model = build_yolo("yolov8n", num_classes=8, device="cpu")
    t = time.time()
    got = W.convert_to_state_dict(W.load_ultralytics_state_dict(pt), model, "yolov8n")
    conv_s = time.time() - t
    check(set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
          "weights_pt: the .pt route's yolov8n state_dict differs from the .npz route's")
    model.load_state_dict(got)
    model.to(dev)
    ref = _bundled_yolo(torch, dev)
    x = torch.as_tensor(frames4).to(dev).flip(-1).permute(0, 3, 1, 2).float()[:, :, :352] / 255.0
    with torch.inference_mode():
        a, b = model(x), ref(x)
    check(all(torch.equal(u, v) for u, v in zip(a[0] + a[1], b[0] + b[1])),
          "weights_pt: logits of the .pt route differ from the .npz route's on the card")

    values = _calibrated_yolo(torch, "yolo11s", frames4)
    pt11 = os.path.join(tmp, "yolo11s.pt")
    write_ultralytics_pt(torch, pt11, values, "yolo11s", half=True)
    card_det = ObjectDetector("yolo11s", weights_path=pt11, load_world=False, device=dev)
    cpu_det = ObjectDetector("yolo11s", weights_path=pt11, load_world=False, device="cpu")
    check(card_det.weights_loaded and card_det.weights_source == pt11,
          f"weights_pt: yolo11s loaded {card_det.weights_source}")
    (cb, cc), _ = cpu_det.head_logits(frames4, DET_IMGSZ, torch.float32)
    (gb, gc), _ = card_det.head_logits(frames4, DET_IMGSZ, torch.float32)
    rel = max(float((g.cpu() - c).abs().max()) / float(c.abs().max())
              for g, c in zip(gb + gc, cb + cc))
    m = match_detections(cpu_det._infer_fn(DET_IMGSZ, DET_CONF, DET_IOU, torch.float32)(frames4),
                         card_det._infer_fn(DET_IMGSZ, DET_CONF, DET_IOU, torch.float32)(frames4))
    _, share_min, gap_max = DET_BOUNDS["float32"]
    check(rel <= PT_LOGIT_TOL and m["share"] >= share_min and m["max_score_gap"] <= gap_max,
          f"weights_pt: yolo11s on the card against the CPU: logits {rel:.3g}, {m}")
    counts = launch_counts()
    check(counts == NO_LAUNCHES, f"weights_pt: launches {counts}")
    phase("weights_pt", t0, f"yolov8n .npz -> ultralytics .pt -> state_dict equal, converted in "
          f"{conv_s:.3f} s, logits bitwise on the card; yolo11s from a seeded half-precision .pt "
          f"on the card: logits {rel:.3g} of the CPU run's, {m['n_ref']} detections, matched "
          f"{m['share']:.4f}, score gap {m['max_score_gap']:.3g}; launches {counts}; on {card}")
    return counts


def _timed_build(build):
    t = time.time()
    return build(), time.time() - t


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    try:
        import rtvm_tpu_torch  # noqa: F401
        from rtvm_tpu_torch import kernels
        from rtvm_tpu_torch.navigate import native
    except ImportError as e:
        print(f"chip_smoke: the rtvm_tpu_torch package is not here: {e}", file=sys.stderr)
        return 3

    dev = torch.device("cuda")
    try:
        t0 = time.time()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        card = smi[0] if smi else "nvidia-smi gave nothing"
        say(card)
        phase("setup", t0, f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
                           f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} device(s)")

        t0 = time.time()
        with ThreadPoolExecutor(1) as pool:  # the host C++ (g++) while nvcc builds the kernels
            host = pool.submit(_timed_build, native.build)
            path = kernels.build()
            host_path, host_s = host.result()
        kernels.library()
        native.library()
        regs = kernels.ptxas_summary(kernels.build_log())
        phase("build", t0, f"{path.name}; " + ("; ".join(
            f"{k}: {v['registers']} registers, {v['smem']} B static smem, {v['stack']} B stack, "
            f"spills {v['spill_stores']}/{v['spill_loads']} B" for k, v in sorted(regs.items()))
            or "no ptxas report in the build log")
            + f"; host C++ {host_path.name} in {host_s:.2f} s alongside")

        frames, cam = make_clip(np.random.RandomState(SEED), 1 + N_WINDOWS * WINDOW, FRAME_H, FRAME_W)
        hc, wc = 2 * FRAME_H, int(1.2 * FRAME_W)
        phase_warp(torch, dev, frames, hc, wc)
        row_b = phase_patches(torch, dev, frames)
        row_c = phase_union(torch, dev, regs)
        # SIFT: one warp launch per window; one patch launch per window for
        # all its octaves, plus one for the first frame's features
        sift_counts, sift_auxs, sift_m, sift_fps = phase_window(
            torch, dev, frames, cam, card, "sift",
            window_launches(N_WINDOWS, N_WINDOWS + 1))
        row_a = warp_real(torch, dev, frames[1 : 1 + WINDOW], sift_auxs[0].H_abs, hc, wc)
        row_d = phase_weight(torch, dev, regs, sift_auxs[0].H_abs)
        row_e = phase_blend(torch, dev, regs)
        # ORB: one warp launch per window; its patches are uint8 cuts (no kernel)
        orb_counts = phase_window(torch, dev, frames, cam, card, "orb",
                                  window_launches(N_WINDOWS))[0]
        by_path = {"window": sift_counts, "window_orb": orb_counts}
        det = {}
        for model in DETECT_MODELS:
            det[model] = phase_detect(
                torch, dev, frames, card, model, (sift_counts, sift_auxs, sift_m, sift_fps))
            by_path[f"detect_{model}"] = det[model]["counts"]
        with tempfile.TemporaryDirectory() as tmp:
            clip = os.path.join(tmp, "clip.npy")
            np.save(clip, frames)
            by_path["pipeline"] = phase_pipeline(torch, dev, clip, tmp, card, sift_m,
                                                 det["yolo11n"])
            by_path["pipeline_fused"] = phase_pipeline_fused(torch, clip, card, det["yolo11n"])
            by_path["grow"] = phase_grow(torch, dev, tmp, card)
            by_path["navigate"] = phase_navigate(torch, dev, tmp, card)
            by_path.update(phase_surface(torch, dev, frames, sift_m, sift_auxs, tmp, card))
            by_path["images"] = phase_images(torch, dev, tmp, card)
            by_path["stream_1080p"], row_a_1080p = phase_stream_1080p(torch, dev, card)
            by_path["slam"] = phase_slam(torch, dev, tmp, card)
            by_path["terrain"] = phase_terrain(torch, dev, tmp, card)
            by_path["sift_854"] = phase_sift_854(torch, dev, card)
            by_path["depth3d_image"] = phase_depth3d_image(torch, dev, tmp, card)
            by_path["depth3d_video"] = phase_depth3d_video(torch, dev, tmp, card)
            by_path["depth3d_multiview"] = phase_depth3d_multiview(torch, dev, tmp, card)
            by_path["terrain_3d"] = phase_terrain_3d(torch, dev, tmp, card)
            by_path["view"], mesh_img = phase_view(torch, dev, tmp, card)
            by_path["stereo_demo"] = phase_stereo_demo(torch, dev, tmp, card)
            by_path["stereo_480p"] = phase_stereo_480p(torch, dev, card)
            by_path["menu"] = phase_menu(torch, dev, tmp, card, mesh_img)
            by_path["web"] = phase_web(torch, dev, tmp, card)
            by_path["train_step"] = phase_train_step(torch, dev, card)
            by_path["train_synth"] = phase_train_synth(torch, dev, tmp, card)
            by_path["eval_yolo"] = phase_eval_yolo(torch, dev, card)
            by_path["train_world"] = phase_train_world(torch, dev, tmp, card)
            by_path["train_depth"] = phase_train_depth(torch, dev, tmp, card)
            by_path["mesh"], mesh_orb = phase_mesh(torch, dev, card)
            by_path["mesh_nccl"] = phase_mesh_nccl(torch, dev, card, mesh_orb)
            by_path["weights_pt"] = phase_weights_pt(torch, dev, tmp, frames[1:][DET_FRAMES], card)
        row_a["at_1080p"] = row_a_1080p
        for row, key in ((row_a, "warp"), (row_b, "patches"), (row_c, "union"),
                         (row_d, "weight"), (row_e, "blend")):
            row["launches_by_path"] = {p: c.get(key, 0) for p, c in by_path.items()}
            row["launches"] = sum(row["launches_by_path"].values())
        rows = [row_a, row_b, row_c, row_d, row_e]
    except CheckFailed as e:
        say(f"FAIL: {e}")
        return 1
    say(json.dumps({"kernels": rows}))
    say(f"elapsed {time.time() - T_START:.2f} s")
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
