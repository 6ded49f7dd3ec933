#!/usr/bin/env python3
"""chip_smoke.py's slice-11 phases alone, on one CUDA card.

    python3 tools/chip_mesh_phases.py

Runs `mesh` (kernel A with a row origin, then dryrun_multichip(4) with its
four ranks on the one card under gloo and the SIFT windows on (2, 2) and
the ORB windows on (1, 4), each case against the same step in one
process), `mesh_nccl` (one rank on NCCL) and `weights_pt` (the ultralytics
.pt route) and prints each phase's line; a phase whose check fails prints
FAIL and the next one runs. Needs a card and
weights/yolov8n_aerial.npz.
"""

import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("chip_mesh_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{card}; torch {torch.__version__}", flush=True)
    frames, _ = C.make_clip(np.random.RandomState(C.SEED), 1 + C.N_WINDOWS * C.WINDOW,
                            C.FRAME_H, C.FRAME_W)
    failed = 0
    orb = None
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("mesh", "mesh_nccl", "weights_pt"):
            try:
                if name == "mesh":
                    _, orb = C.phase_mesh(torch, dev, card)
                elif name == "mesh_nccl":
                    if orb is None:  # `mesh` failed before its one-process window
                        from rtvm_tpu_torch.parallel import mesh as PM

                        orb = PM.single_window_run(PM.production_case("orb", C.MESH_WINDOWS),
                                                   device=dev)
                    C.phase_mesh_nccl(torch, dev, card, orb)
                elif name == "weights_pt":
                    C.phase_weights_pt(torch, dev, tmp, frames[1:][C.DET_FRAMES], card)
            except C.CheckFailed as e:
                failed += 1
                print(f"FAIL {name}: {e}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":  # the mesh phases spawn ranks, which import this file
    sys.exit(main())
