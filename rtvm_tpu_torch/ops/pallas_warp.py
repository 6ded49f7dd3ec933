"""Kernel A: the perspective warp that paints every frame.

Counterpart of ``rtvm_tpu/ops/pallas_warp.py:warp_two_pass_pallas``. The CUDA
kernel is ``csrc/warp.cu`` (a direct inverse-map bilinear warp; see its header
for the design and bound); ``warp_plain`` is the same function as PyTorch
indexing. ``warp_batch`` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor.

Semantics: cv2.warpPerspective INTER_LINEAR with a zero border, as the Pallas
kernel and the XLA two-pass warp compute it: a tap outside the frame counts as
zero, so sample points up to one pixel outside the frame blend partially with
black. ``ops/warp.py:_warp_gather_cm`` differs from this only on that 1-px
ring: it masks strictly to sample points inside [0, wf-1] x [0, hf-1] and
clamps its taps, so it is zero (or a clamped value) where this is a partial
blend.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rtvm_tpu_torch import kernels


def inverse_maps(H: torch.Tensor) -> torch.Tensor:
    """G = H^-1 for [..., 3, 3] float32 homographies (frame -> canvas)."""
    return torch.linalg.inv_ex(H)[0]


def warp_plain(frames: torch.Tensor, G: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """frames [B, C, Hf, Wf] float32, G [B, 3, 3] canvas -> frame maps ->
    [B, C, out_h, out_w]. The arithmetic is op for op the kernel's."""
    b, c, hf, wf = frames.shape
    dev = frames.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
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


def warp_batch(frames: torch.Tensor, G: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Warp B frames [B, C, Hf, Wf] by their inverse maps G [B, 3, 3] onto
    [B, C, out_h, out_w]. CUDA tensors go through the kernel (one launch per
    up to ``rtvm_warp_max_batch()`` frames); CPU tensors through warp_plain."""
    _check(frames, G)
    if frames.device.type == "cpu":
        return warp_plain(frames, G, out_h, out_w)
    if frames.device.type != "cuda":
        raise ValueError(f"warp_batch: no kernel for device {frames.device}")
    lib = kernels.library()
    b, c, hf, wf = frames.shape
    out = torch.empty((b, c, out_h, out_w), dtype=torch.float32, device=frames.device)
    if b == 0:
        return out
    # G travels by value in the launch's parameters: one small copy to the host.
    g_host = np.ascontiguousarray(G.detach().reshape(b, 9).cpu().numpy(), dtype=np.float32)
    stream = ctypes.c_void_p(torch.cuda.current_stream(frames.device).cuda_stream)
    step = lib.rtvm_warp_max_batch()
    plane_in, plane_out = c * hf * wf * 4, c * out_h * out_w * 4
    for s in range(0, b, step):
        n = min(step, b - s)
        code = lib.rtvm_warp_bilinear(
            ctypes.c_void_p(frames.data_ptr() + s * plane_in),
            ctypes.c_void_p(out.data_ptr() + s * plane_out),
            g_host[s : s + n].ctypes.data_as(ctypes.c_void_p),
            n, c, hf, wf, out_h, out_w, stream,
        )
        kernels.check(code, "rtvm_warp_bilinear")
        kernels.launches["warp"] += 1
    return out
