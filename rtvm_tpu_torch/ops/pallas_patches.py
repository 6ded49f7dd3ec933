"""Kernel B: SIFT descriptor patches cut from the stacked Gaussian levels.

Counterpart of ``rtvm_tpu/ops/pallas_patches.py:extract_patches_pallas``. The
CUDA kernel is ``csrc/patches.cu`` (one block per keypoint and frame, see its
header); ``extract_patches_plain`` is the same copy as advanced indexing. Both
are pure copies, so they agree byte for byte.
"""

from __future__ import annotations

import ctypes

import torch

from rtvm_tpu_torch import kernels

PATCH = 32  # the only patch side the kernel is compiled for


def extract_patches_plain(stack: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                          patch: int = PATCH) -> torch.Tensor:
    """stack [B, R, W], ys/xs [B, Q] int patch origins -> [B, Q, patch, patch].
    Origins are clamped to the image, dynamic_slice's rule."""
    b, r, w = stack.shape
    y0 = ys.to(torch.int64).clamp(0, r - patch)
    x0 = xs.to(torch.int64).clamp(0, w - patch)
    d = torch.arange(patch, device=stack.device)
    rows = y0[:, :, None, None] + d[None, None, :, None]  # [B, Q, P, 1]
    cols = x0[:, :, None, None] + d[None, None, None, :]  # [B, Q, 1, P]
    bi = torch.arange(b, device=stack.device)[:, None, None, None]
    return stack[bi, rows, cols]


def extract_patches(stack: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    patch: int = PATCH) -> torch.Tensor:
    """stack [B, R, W] float32 (levels stacked vertically), ys/xs [B, Q] int32
    patch origins -> [B, Q, patch, patch]. CUDA tensors go through the kernel
    (one launch for the whole batch); CPU tensors through the plain version."""
    if stack.dtype != torch.float32 or ys.dtype != torch.int32 or xs.dtype != torch.int32:
        raise TypeError(f"extract_patches wants float32 stack and int32 origins, got "
                        f"{stack.dtype}, {ys.dtype}, {xs.dtype}")
    if stack.dim() != 3 or ys.dim() != 2 or ys.shape != xs.shape or ys.shape[0] != stack.shape[0]:
        raise ValueError(f"extract_patches wants stack [B,R,W] and origins [B,Q], got "
                         f"{tuple(stack.shape)}, {tuple(ys.shape)}, {tuple(xs.shape)}")
    if stack.shape[1] < patch or stack.shape[2] < patch:
        raise ValueError(f"stack {tuple(stack.shape)} is smaller than one {patch}x{patch} patch")
    if not (ys.device == xs.device == stack.device):
        raise ValueError("stack and origins must be on one device")
    if stack.device.type == "cpu":
        return extract_patches_plain(stack, ys, xs, patch)
    if stack.device.type != "cuda":
        raise ValueError(f"extract_patches: no kernel for device {stack.device}")
    if patch != PATCH:
        raise ValueError(f"the CUDA kernel cuts {PATCH}x{PATCH} patches, not {patch}")
    if not (stack.is_contiguous() and ys.is_contiguous() and xs.is_contiguous()):
        raise ValueError("extract_patches wants contiguous tensors")
    b, r, w = stack.shape
    q = ys.shape[1]
    out = torch.empty((b, q, patch, patch), dtype=torch.float32, device=stack.device)
    if b == 0 or q == 0:
        return out
    lib = kernels.library()
    code = lib.rtvm_extract_patches(
        ctypes.c_void_p(stack.data_ptr()), ctypes.c_void_p(ys.data_ptr()),
        ctypes.c_void_p(xs.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        b, q, r, w, ctypes.c_void_p(torch.cuda.current_stream(stack.device).cuda_stream),
    )
    kernels.check(code, "rtvm_extract_patches")
    kernels.launches["patches"] += 1
    return out
