#!/usr/bin/env python3
"""How often RANSAC's draws leave a distorted H_old, over many seeds, on the CPU.

    python3 tools/ransac_seed_sweep.py --package jax|torch [--seeds 100]

Writes tests/test_torch_pipeline.py's 9-frame 120x200 ORB clip (moving
(+2, +2) px a frame) as an mp4, then runs one package's run_mosaic on it
(window 4, no progress image) once per seed, with VideMosaic built with that
seed. The clip is a pure translation, so H_old's linear part should be the
identity: a run whose |H_old[:2, :2] - I| exceeds 0.02 is counted as
distorted. Imports only the package asked for. Prints one JSON line per
seed, then one with the count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DISTORTED = 0.02


def write_clip(path: str) -> None:
    rng = np.random.RandomState(5)
    h, w, n = 120, 200, 9
    base = cv2.GaussianBlur(rng.randint(0, 255, (h + 2 * n, w + 2 * n, 3), dtype=np.uint8),
                            (0, 0), 1.0)
    for _ in range(30):
        x, y = rng.randint(10, w), rng.randint(10, h)
        cv2.rectangle(base, (x, y), (x + 14, y + 10),
                      tuple(int(v) for v in rng.randint(0, 255, 3)), -1)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    for i in range(n):
        vw.write(np.ascontiguousarray(base[2 * i : 2 * i + h, 2 * i : 2 * i + w]))
    vw.release()


def runner(package: str):
    """run(path, seed) -> (stats, H_old) for one package."""
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from rtvm_tpu.config import MosaicConfig
        from rtvm_tpu.pipelines import mosaic_pipeline as pl

        kw = {}
    else:
        import torch

        torch.set_num_threads(2)
        from rtvm_tpu_torch.config import MosaicConfig
        from rtvm_tpu_torch.pipelines import mosaic_pipeline as pl

        kw = {"device": "cpu"}
    base = pl.VideMosaic

    def run(path, seed):
        class Seeded(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **{**k, "seed": seed})

        pl.VideMosaic = Seeded
        try:
            m, stats = pl.run_mosaic(path, config=MosaicConfig(window_size=4),
                                     detector_type="orb", show_intermediate=False, **kw)
        finally:
            pl.VideMosaic = base
        return stats, np.asarray(m.H_old, dtype=np.float64)

    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["jax", "torch"], required=True)
    ap.add_argument("--seeds", type=int, default=100)
    args = ap.parse_args()
    run = runner(args.package)
    distorted = []
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "clip.mp4")
        write_clip(path)
        for seed in range(args.seeds):
            stats, H = run(path, seed)
            lin = H[:2, :2] / H[2, 2]
            dev = float(np.abs(lin - np.eye(2)).max())
            if dev > DISTORTED:
                distorted.append(seed)
            print(json.dumps({"seed": seed, "accepted": stats["accepted"],
                              "frames": stats["frames"], "lin_dev": dev,
                              "scale": float(np.sqrt(abs(np.linalg.det(lin))))}), flush=True)
    print(json.dumps({"package": args.package, "seeds": args.seeds,
                      "distorted": len(distorted), "distorted_seeds": distorted}))


if __name__ == "__main__":
    main()
