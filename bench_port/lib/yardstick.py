"""The yardstick: the chip's peaks, the least time of a kernel's work, and
the work itself counted from shapes.

``bound`` is a frozen copy of ``chip_smoke.py:bound`` (with its peaks); the
warp's and the patch cut's bytes are counted as ``PERF.md``'s kernel table
counts them (each input byte read once, each output byte written once), and
``yolo_flops`` counts the model FLOPs of YOLOv8 (2 x the multiply-adds of
every convolution) from the architecture's shapes.
"""

from __future__ import annotations

import math
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


# ------------------------------------------------------------ model FLOPs


def _div8(x: float) -> int:
    return int(math.ceil(x / 8) * 8)


def yolo_flops(cfg: dict, hw: Tuple[int, int]) -> float:
    """Model FLOPs of one frame of YOLOv8 at the letterboxed input hw (rows,
    cols): 2 x the multiply-adds of every convolution, as Ultralytics counts
    its GFLOPs. cfg gives depth_multiple, width_multiple, max_channels, nc
    and reg_max."""
    wm, mc = cfg["width_multiple"], cfg["max_channels"]
    ch = lambda c: _div8(min(c, mc) * wm)  # noqa: E731
    rep = lambda n: max(round(n * cfg["depth_multiple"]), 1)  # noqa: E731
    macs = 0

    def conv(c_in, c_out, h, w, k=1, s=1):
        nonlocal macs
        ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
        macs += c_out * c_in * k * k * ho * wo
        return c_out, ho, wo

    def c2f(c_in, c_out, h, w, n):
        hid = c_out // 2
        conv(c_in, 2 * hid, h, w)
        for _ in range(n):
            conv(hid, hid, h, w, 3)
            conv(hid, hid, h, w, 3)
        return conv((2 + n) * hid, c_out, h, w)

    h, w = hw
    c, h, w = conv(3, ch(64), h, w, 3, 2)
    c, h, w = conv(c, ch(128), h, w, 3, 2)
    c, h, w = c2f(c, ch(128), h, w, rep(3))
    c, h, w = conv(c, ch(256), h, w, 3, 2)
    p3 = c2f(c, ch(256), h, w, rep(6))
    c, h, w = conv(p3[0], ch(512), p3[1], p3[2], 3, 2)
    p4 = c2f(c, ch(512), h, w, rep(6))
    c, h, w = conv(p4[0], ch(1024), p4[1], p4[2], 3, 2)
    c, h, w = c2f(c, ch(1024), h, w, rep(3))
    conv(c, c // 2, h, w)  # SPPF
    p5 = conv(4 * (c // 2), ch(1024), h, w)
    n4 = c2f(p5[0] + p4[0], ch(512), p4[1], p4[2], rep(3))
    n3 = c2f(n4[0] + p3[0], ch(256), p3[1], p3[2], rep(3))
    c, h, w = conv(n3[0], ch(256), n3[1], n3[2], 3, 2)
    m4 = c2f(c + n4[0], ch(512), h, w, rep(3))
    c, h, w = conv(m4[0], ch(512), m4[1], m4[2], 3, 2)
    m5 = c2f(c + p5[0], ch(1024), h, w, rep(3))
    feats = (n3, m4, m5)
    c2 = max(16, feats[0][0] // 4, cfg["reg_max"] * 4)
    c3 = max(feats[0][0], min(cfg["nc"], 100))
    for f, fh, fw in feats:
        conv(f, c2, fh, fw, 3)
        conv(c2, c2, fh, fw, 3)
        conv(c2, 4 * cfg["reg_max"], fh, fw)
        conv(f, c3, fh, fw, 3)
        conv(c3, c3, fh, fw, 3)
        conv(c3, cfg["nc"], fh, fw)
    return 2.0 * macs
