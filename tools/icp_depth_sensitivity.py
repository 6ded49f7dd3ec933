#!/usr/bin/env python3
"""How far ICP's transforms in the depth3d video pipeline move when every
depth map moves by a little noise, and how far they move under faults of
the depth route.

    python3 tools/icp_depth_sensitivity.py [--device cpu|cuda] [--noise 4e-6]
        [--frames 8]

Runs ``depth3d.pipeline.process_video_to_3d_model`` on the 360x640 drifting
clip of ``chip_smoke.py``'s ``depth3d_video`` phase (29 frames, frame step
4, the first `--frames` sampled): once as it is, then once with each change
below made to every normalised depth map (DepthNet runs once; its maps are
reused):
  - noise: uniform noise of +-noise (seeded), the size that separates two
    devices' DepthNet runs;
  - shift: the map moved one pixel to the right (an off-by-one column);
  - prev: the previous sampled frame's map (the first keeps its own);
  - scale: the map times 0.99.
Prints, for each change and each ICP call, the largest change of R and t,
and the largest over the calls. On a near-planar aerial scene the ICP
objective is flat along the ground, so noise of a few 1e-6 moves the
transforms by about 1e-3-1e-2; ``chip_smoke.py``'s ICP_PIPE_TOL lies between
that and what the faults give.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--noise", type=float, default=4e-6)
    ap.add_argument("--frames", type=int, default=8, help="sampled frames (ICP calls + 1)")
    args = ap.parse_args()

    import chip_smoke as cs
    from rtvm_tpu_torch.depth3d import estimator, pipeline

    frames = cs.make_clip(np.random.RandomState(cs.SEED + 11), 29, cs.FRAME_H, cs.FRAME_W,
                          cs.DEPTH_VIDEO_STEP)[0]
    changes = {
        "none": lambda d, prev, rng: d,
        "noise": lambda d, prev, rng: np.clip(d + rng.uniform(-args.noise, args.noise, d.shape),
                                              0, 1).astype(np.float32),
        "shift": lambda d, prev, rng: np.concatenate([d[:, :1], d[:, :-1]], axis=1),
        "prev": lambda d, prev, rng: d if prev is None else prev,
        "scale": lambda d, prev, rng: d * np.float32(0.99),
    }
    real_depth = estimator.MonocularDepthEstimator.estimate_depth
    real_icp = pipeline.register_clouds
    depths = {}  # DepthNet's maps by frame, computed in the first run
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.npy")
        np.save(clip, frames)
        for name, change in changes.items():
            rng = np.random.RandomState(1)
            seen, out = [], []

            def changed(self, img, _change=change):
                key = img.tobytes()
                if key not in depths:
                    depths[key] = real_depth(self, img)
                d = _change(depths[key], seen[-1] if seen else None, rng)
                seen.append(depths[key])
                return d

            def recording(*a, **k):
                r = real_icp(*a, **k)
                out.append((r.R.cpu().numpy(), r.t.cpu().numpy()))
                return r

            estimator.MonocularDepthEstimator.estimate_depth = changed
            pipeline.register_clouds = recording
            try:
                pipeline.process_video_to_3d_model(clip, os.path.join(tmp, "out"), frame_step=4,
                                                   max_frames=args.frames, device=args.device)
            finally:
                estimator.MonocularDepthEstimator.estimate_depth = real_depth
                pipeline.register_clouds = real_icp
            runs[name] = out
    for name in list(changes)[1:]:
        moves = [(float(np.abs(r0 - r1).max()), float(np.abs(t0 - t1).max()))
                 for (r0, t0), (r1, t1) in zip(runs["none"], runs[name])]
        for i, (dr, dt) in enumerate(moves):
            print(f"{name}: ICP call {i + 1}: R moved {dr:.3e}, t moved {dt:.3e}")
        print(f"{name}: {len(runs[name])} ICP calls; over the first {len(moves)} R moved up to "
              f"{max(m[0] for m in moves):.3e}, t up to {max(m[1] for m in moves):.3e} on "
              f"{args.device} (noise +-{args.noise:g})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
