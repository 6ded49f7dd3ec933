"""The yardstick: the chip's peaks, the least time of a kernel's work, and
the work itself counted from shapes.

``bound`` is a frozen copy of ``chip_smoke.py:bound`` (with its peaks); the
warp's and the patch cut's bytes are counted as ``PERF.md``'s kernel table
counts them (each input byte read once, each output byte written once). A
model's FLOPs are its reference's ``flops`` (``reference/yolo.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# NVIDIA H100 SXM5 data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # bf16 tensor cores, dense


def bound(nbytes: float, nops: float) -> Tuple[float, str]:
    """Frozen copy of ``chip_smoke.py:bound``: (least ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def warp_work(b: int, frame_hw: Tuple[int, int], rows: int, cols: int) -> Tuple[float, float]:
    """(bytes, operations) of kernel A warping b float32 BGR frames onto
    rows x cols canvas pixels: each frame and its 3x3 map read once, each
    warped pixel written once; 12 operations a pixel for the map and 12 a
    channel for the bilinear taps (``chip_smoke.py:stream_1080p``'s count)."""
    h, w = frame_hw
    nbytes = b * (3 * h * w * 4 + 36) + b * 3 * rows * cols * 4
    return float(nbytes), float(b * rows * cols * (12 + 3 * 12))


def patches_bytes(stack_shapes: Sequence[Tuple[int, int, int]], ys: Sequence[torch.Tensor],
                  xs: Sequence[torch.Tensor], patch: int = 32) -> float:
    """Bytes of one patch cut: every stack pixel that some patch covers,
    read once; the origins; every patch written once (``chip_smoke.py:
    phase_patches``'s count)."""
    read = written = 0
    for (b, r, w), y, x in zip(stack_shapes, ys, xs):
        dev = y.device
        touched = torch.zeros((b, r, w), dtype=torch.bool, device=dev)
        d = torch.arange(patch, device=dev)
        y0 = y.long().clamp(0, r - patch)[:, :, None, None] + d[:, None]
        x0 = x.long().clamp(0, w - patch)[:, :, None, None] + d
        touched[torch.arange(b, device=dev)[:, None, None, None], y0, x0] = True
        read += int(touched.sum()) * 4 + 2 * y.numel() * 4
        written += y.numel() * patch * patch * 4
    return float(read + written)
