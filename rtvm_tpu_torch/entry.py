"""The port's entry points, the counterparts of ``__graft_entry__``:

- ``entry()``: one ORB window step of the streaming mosaic stitcher at a
  small size (K=128 keypoints, 128x256 frames, a window of 2);
- ``dryrun_multichip(n)``: the multi-device dry run of
  ``parallel/mesh.py`` in n spawned ranks on a (dp, tp) mesh.

    fn, args = entry()          # on cuda; entry(device="cpu") for the CPU
    state, aux = fn(*args)

    python -m rtvm_tpu_torch.entry                       # entry() on the card
    python -m rtvm_tpu_torch.entry --multichip [N] [--device cpu]
"""

from __future__ import annotations

import sys

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


def dryrun_multichip(n_devices: int, device=None, production: bool = True) -> dict:
    """The multi-device dry run in n_devices ranks (on cuda unless `device`
    says otherwise): see ``parallel/mesh.py:dryrun_multichip``."""
    from rtvm_tpu_torch.parallel.mesh import dryrun_multichip as _impl

    return _impl(n_devices, device=device, production=production)


def _main(argv) -> None:
    if "--multichip" in argv:
        i = argv.index("--multichip")
        n = int(argv[i + 1]) if i + 1 < len(argv) and argv[i + 1].isdigit() else 8
        device = argv[argv.index("--device") + 1] if "--device" in argv else None
        dryrun_multichip(n, device=device)
        print("multichip dryrun ok")
    else:
        fn, args = entry()
        fn(*args)
        print("entry ok")


if __name__ == "__main__":
    _main(sys.argv[1:])
