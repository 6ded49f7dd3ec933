"""Kernel A: the perspective warp that paints every frame.

Counterpart of the ``pl.pallas_call`` of ``rtvm_tpu/ops/pallas_warp.py`` (kernel
body ``_warp_kernel``). The CUDA kernel is ``csrc/warp.cu`` (a direct
inverse-map bilinear warp that skips the canvas tiles no sample point of the
frame reaches; see its header for the design and bound); ``warp_plain`` is the
same function as PyTorch indexing.
``warp_batch`` launches the kernel for a CUDA tensor, one launch for the whole
batch with G read from device memory, and takes the plain version only for a
CPU tensor. ``tile_is_empty`` is the kernel's tile-skip rule in Python.

Semantics: cv2.warpPerspective INTER_LINEAR with a zero border, as the Pallas
kernel and the XLA two-pass warp compute it: a tap outside the frame counts as
zero, so sample points up to one pixel outside the frame blend partially with
black. ``ops/warp.py:_warp_gather_cm`` differs from this only on that 1-px
ring: it masks strictly to sample points inside [0, wf-1] x [0, hf-1] and
clamps its taps, so it is zero (or a clamped value) where this is a partial
blend.
"""

from __future__ import annotations

import math

import torch

from rtvm_tpu_torch import kernels

_launch = kernels.Entry("warp", "rtvm_warp_bilinear", "pppiiiiiii")


def inverse_maps(H: torch.Tensor) -> torch.Tensor:
    """G = H^-1 for [..., 3, 3] float32 homographies (frame -> canvas)."""
    return torch.linalg.inv_ex(H)[0]


def warp_plain(frames: torch.Tensor, G: torch.Tensor, out_h: int, out_w: int,
               row0: int = 0) -> torch.Tensor:
    """frames [B, C, Hf, Wf] float32, G [B, 3, 3] canvas -> frame maps ->
    [B, C, out_h, out_w]: canvas rows row0 .. row0 + out_h - 1. The
    arithmetic is op for op the kernel's."""
    b, c, hf, wf = frames.shape
    dev = frames.device
    ys = torch.arange(row0, row0 + out_h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    g = G.reshape(b, 9, 1, 1)
    den = g[:, 6] * xs + g[:, 7] * ys + g[:, 8]
    den = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
    sx = (g[:, 0] * xs + g[:, 1] * ys + g[:, 2]) / den
    sy = (g[:, 3] * xs + g[:, 4] * ys + g[:, 5]) / den
    valid = (den > 0.0) & (sx > -1.0) & (sx < wf) & (sy > -1.0) & (sy < hf)
    sx = torch.where(valid, sx, torch.zeros_like(sx))
    sy = torch.where(valid, sy, torch.zeros_like(sy))
    fx0, fy0 = torch.floor(sx), torch.floor(sy)
    x0, y0 = fx0.to(torch.int64), fy0.to(torch.int64)
    fx, fy = sx - fx0, sy - fy0
    ax, ay = 1.0 - fx, 1.0 - fy
    flat = frames.reshape(b, c, hf * wf)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi <= hf - 1) & (xi >= 0) & (xi <= wf - 1)
        idx = (yi.clamp(0, hf - 1) * wf + xi.clamp(0, wf - 1)).reshape(b, 1, -1)
        v = torch.gather(flat, 2, idx.expand(b, c, idx.shape[-1])).reshape(b, c, out_h, out_w)
        return torch.where(inside[:, None], v, torch.zeros_like(v))

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    ax, ay, fx, fy = ax[:, None], ay[:, None], fx[:, None], fy[:, None]
    top = v00 * ax + v01 * fx
    bot = v10 * ax + v11 * fx
    out = top * ay + bot * fy
    return torch.where(valid[:, None], out, torch.zeros_like(out))


def _check(frames: torch.Tensor, G: torch.Tensor) -> None:
    if frames.dtype != torch.float32 or G.dtype != torch.float32:
        raise TypeError(f"warp_batch wants float32, got {frames.dtype} and {G.dtype}")
    if frames.dim() != 4 or G.shape != (frames.shape[0], 3, 3):
        raise ValueError(f"warp_batch wants frames [B,C,H,W] and G [B,3,3], got "
                         f"{tuple(frames.shape)} and {tuple(G.shape)}")
    if not frames.is_contiguous():
        raise ValueError("warp_batch wants a contiguous frame batch")
    if G.device != frames.device:
        raise ValueError(f"G is on {G.device}, frames on {frames.device}")


def warp_batch(frames: torch.Tensor, G: torch.Tensor, out_h: int, out_w: int,
               row0: int = 0) -> torch.Tensor:
    """Warp B frames [B, C, Hf, Wf] by their inverse maps G [B, 3, 3] onto
    [B, C, out_h, out_w], the canvas rows row0 .. row0 + out_h - 1 (a band of
    a taller canvas, bitwise the same rows of the full warp). CUDA tensors
    go through the kernel (one launch, G stays on the device); CPU tensors
    through warp_plain."""
    _check(frames, G)
    if row0 < 0 or row0 + out_h > 1 << 24:
        raise ValueError(f"warp_batch: row origin {row0} out of range")
    if frames.device.type == "cpu":
        return warp_plain(frames, G, out_h, out_w, row0)
    if frames.device.type != "cuda":
        raise ValueError(f"warp_batch: no kernel for device {frames.device}")
    b, c, hf, wf = frames.shape
    out = torch.empty((b, c, out_h, out_w), dtype=torch.float32, device=frames.device)
    if b == 0:
        return out
    g = G.reshape(b, 9).contiguous()
    _launch(frames.device, frames.data_ptr(), g.data_ptr(), out.data_ptr(), b, c, hf, wf, out_h,
            out_w, row0)
    return out


TILE_W, TILE_H = 128, 8  # the kernel's canvas tile (RTVM_TILE_W, RTVM_TILE_H)
_EPS32 = 2.0**-23  # twice float32's unit roundoff


def tile_is_empty(g, xa: int, ya: int, xb: int, yb: int, hf: int, wf: int) -> bool:
    """The kernel's tile-skip rule (csrc/warp.cu:tile_is_empty). g: the 9
    entries of one G, row-major. True when every canvas pixel of [xa, xb] x
    [ya, yb] (inclusive) samples outside (-1, wf) x (-1, hf) in warp_plain's
    float32 arithmetic: the denominator is clearly positive at the four
    corners (so on the whole tile, where it is affine), and the corners'
    convex hull, which holds every sample point of the tile, lies beyond one
    edge of the region by more than twice float32's rounding of a point."""
    g = [float(v) for v in g]
    corners = [(float(x), float(y)) for y in (ya, yb) for x in (xa, xb)]
    dd = [g[6] * x + g[7] * y + g[8] for x, y in corners]
    nx = [g[0] * x + g[1] * y + g[2] for x, y in corners]
    ny = [g[3] * x + g[4] * y + g[5] for x, y in corners]
    dmin = min(dd)
    mden = max(abs(g[6]) * x + abs(g[7]) * y + abs(g[8]) for x, y in corners)
    mx = max(abs(g[0]) * x + abs(g[1]) * y + abs(g[2]) for x, y in corners)
    my = max(abs(g[3]) * x + abs(g[4]) * y + abs(g[5]) for x, y in corners)
    if not (dmin > 1e-8) or not (3.0 * _EPS32 * mden <= 1e-3 * dmin):
        return False
    if not (mden < 1e30 and mx < 1e30 and my < 1e30):  # no float32 overflow on the tile
        return False
    rel = 3.0 * _EPS32 * mden / dmin + 4.0 * _EPS32
    tx, ty = 2.0 * mx / dmin * rel, 2.0 * my / dmin * rel
    if not (math.isfinite(tx) and math.isfinite(ty)):
        return False
    return (all(n <= (-1.0 - tx) * d for n, d in zip(nx, dd))
            or all(n >= (wf + tx) * d for n, d in zip(nx, dd))
            or all(n <= (-1.0 - ty) * d for n, d in zip(ny, dd))
            or all(n >= (hf + ty) * d for n, d in zip(ny, dd)))
