#!/usr/bin/env python3
"""chip_smoke.py's five training phases alone, on one CUDA card.

    python3 tools/chip_train_phases.py

Runs `train_step`, `train_synth`, `eval_yolo`, `train_world` and
`train_depth` (see chip_smoke.py) in a temporary directory and prints each
phase's line; a phase whose check fails prints FAIL and the next one runs.
About two minutes of command time, against about five for the whole
script. Needs a card and the checkpoints that those phases load.
"""

import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("chip_train_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{card}; torch {torch.__version__}", flush=True)
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in (("train_step", lambda: C.phase_train_step(torch, dev, card)),
                          ("train_synth", lambda: C.phase_train_synth(torch, dev, tmp, card)),
                          ("eval_yolo", lambda: C.phase_eval_yolo(torch, dev, card)),
                          ("train_world", lambda: C.phase_train_world(torch, dev, tmp, card)),
                          ("train_depth", lambda: C.phase_train_depth(torch, dev, tmp, card))):
            try:
                run()
            except C.CheckFailed as e:
                failed += 1
                print(f"FAIL {name}: {e}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":  # train_depth spawns workers, which import this file
    sys.exit(main())
