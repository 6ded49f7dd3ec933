"""Device selection: ``cuda`` unless the caller asks for something else.

There is no quiet fallback to the CPU. A public entry point that is given no
device runs on the card, and raises when there is none. ``upload_frames`` is
the one copy of host frames to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from rtvm_tpu_torch.utils.timing import count, span


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


def upload_frames(frames, device: torch.device) -> torch.Tensor:
    """Frames as uint8 on `device`. Host frames are one copy, in the span
    ``upload`` with its count ``bytes``; a tensor already on that kind of
    device opens no span."""
    if isinstance(frames, torch.Tensor) and frames.device.type == device.type:
        return frames.to(device=device, dtype=torch.uint8)
    with span("upload"):
        if not isinstance(frames, torch.Tensor):
            frames = np.asarray(frames)
        out = torch.as_tensor(frames, dtype=torch.uint8).to(device)
        count("bytes", out.numel())
    return out
