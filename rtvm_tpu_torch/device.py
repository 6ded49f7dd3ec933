"""Device selection: ``cuda`` unless the caller asks for something else.

There is no quiet fallback to the CPU. A public entry point that is given no
device runs on the card, and raises when there is none.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is taken
    as given (``"cpu"`` runs the kernels' plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rtvm_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions"
            )
        return torch.device("cuda")
    return torch.device(device)
