"""The port's entry point, the counterpart of ``__graft_entry__.entry()``:
one ORB window step of the streaming mosaic stitcher at a small size
(K=128 keypoints, 128x256 frames, a window of 2).

    fn, args = entry()          # on cuda; entry(device="cpu") for the CPU
    state, aux = fn(*args)
"""

from __future__ import annotations

import numpy as np
import torch

from rtvm_tpu_torch.config import FeatureConfig, MosaicConfig
from rtvm_tpu_torch.mosaic import stitcher as S


def entry(device=None):
    """Returns (fn, example_args): fn(state, frames, seed, fweight, wtable)
    runs one window step and returns (state, WindowAux)."""
    h, w = 128, 256
    cfg = MosaicConfig(window_size=2, features=FeatureConfig(detector_type="orb", max_keypoints=128))
    rng = np.random.RandomState(0)
    first = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
    m = S.VideMosaic(first, detector_type="orb", config=cfg, device=device)
    step = S.make_window_step((h, w, 3), cfg)
    frames = torch.from_numpy(rng.randint(0, 255, (2, h, w, 3), dtype=np.uint8)).to(m.device)

    def fn(state, frames, seed, fweight, wtable):
        return step(state, frames, seed, fweight, wtable)

    return fn, (m.state, frames, m.seed, m._fweight, m._wtable)


if __name__ == "__main__":
    fn, args = entry()
    fn(*args)
    print("entry ok")
