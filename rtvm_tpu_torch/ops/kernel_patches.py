"""Kernel B: SIFT descriptor patches cut from the stacked Gaussian levels.

Counterpart of ``rtvm_tpu/ops/pallas_patches.py:extract_patches_pallas``. The
CUDA kernel is ``csrc/patches.cu``: every octave of a batch in one launch, one
TMA load and one bulk store per patch (see its header).
``extract_patches_octaves_plain`` is the same copy as advanced indexing. Both
are pure copies, so they agree byte for byte.
"""

from __future__ import annotations

import array

import torch

from rtvm_tpu_torch import kernels

PATCH = 32  # the only patch side the kernel is compiled for
MAX_OCTAVES = 8  # RTVM_OCT_MAX in csrc/patches.cu

_launch = kernels.Entry("patches", "rtvm_extract_patches_octaves", "ipip",
                       {-1: "the CUDA driver has no cuTensorMapEncodeTiled",
                        -2: "cuTensorMapEncodeTiled refused a stack"})


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


def extract_patches_octaves_plain(stacks, ys, xs, patch: int = PATCH) -> torch.Tensor:
    """Lists over octaves of stack [B, R_o, W_o] and origins [B, Q_o] ->
    [B, sum Q_o, patch, patch], the octaves' patches side by side."""
    return torch.cat([extract_patches_plain(s, y, x, patch) for s, y, x in zip(stacks, ys, xs)],
                     dim=1)


def _check_inputs(stacks, ys, xs, patch: int) -> None:
    if not (len(stacks) == len(ys) == len(xs)) or not stacks:
        raise ValueError(f"extract_patches_octaves wants one stack and origins per octave, got "
                         f"{len(stacks)} stacks, {len(ys)} and {len(xs)} origins")
    dev = stacks[0].device
    b = stacks[0].shape[0] if stacks[0].dim() == 3 else None
    for o, (s, y, x) in enumerate(zip(stacks, ys, xs)):
        if s.dtype != torch.float32 or y.dtype != torch.int32 or x.dtype != torch.int32:
            raise TypeError(f"octave {o}: float32 stack and int32 origins wanted, got "
                            f"{s.dtype}, {y.dtype}, {x.dtype}")
        ss, yy = s.shape, y.shape
        if len(ss) != 3 or len(yy) != 2 or yy != x.shape or yy[0] != b or ss[0] != b:
            raise ValueError(f"octave {o}: stack [B,R,W] and origins [B,Q] with one B wanted, "
                             f"got {tuple(ss)}, {tuple(yy)}, {tuple(x.shape)}")
        if ss[1] < patch or ss[2] < patch:
            raise ValueError(f"octave {o}: stack {tuple(ss)} is smaller than one "
                             f"{patch}x{patch} patch")
        if y.device != dev or x.device != dev or s.device != dev:
            raise ValueError("stacks and origins must be on one device")


def tma_constraints(stacks, ys, xs, patch: int = PATCH) -> list:
    """Raise ValueError, with the reason, where the CUDA kernel cannot take
    these inputs: TMA wants a 16-byte aligned stack whose rows are contiguous
    and whose row and batch strides are multiples of 16 bytes. The width
    W_o may be any size when the row stride (the pitch) is a multiple of 4
    floats: the SIFT levels are laid out so (``features/sift.py:
    _octave_levels``). The launch takes at most MAX_OCTAVES octaves and
    32x32 patches; origins are contiguous. Reads only shapes, strides and
    addresses. Returns the 8 integers per octave that
    csrc/patches.cu:rtvm_extract_patches_octaves takes (stack address,
    batch stride, R, W, ys and xs addresses, Q, pitch)."""
    if patch != PATCH:
        raise ValueError(f"the CUDA kernel cuts {PATCH}x{PATCH} patches, not {patch}")
    if len(stacks) > MAX_OCTAVES:
        raise ValueError(f"the CUDA kernel takes at most {MAX_OCTAVES} octaves, got {len(stacks)}")
    args = []
    for o, (s, y, x) in enumerate(zip(stacks, ys, xs)):
        b, r, w = s.shape
        sb, sr, sw = s.stride()
        ptr = s.data_ptr()
        if sw != 1 or sr < w:
            raise ValueError(f"octave {o}: stack rows must be contiguous (strides {s.stride()})")
        if sr % 4:
            raise ValueError(f"octave {o}: TMA needs a row stride that is a multiple of 16 bytes; "
                             f"the row stride {sr} (width {w}) is not a multiple of 4: lay the "
                             f"rows out with a pitch, as features/sift.py:_octave_levels does")
        if b > 1 and sb % 4:
            raise ValueError(f"octave {o}: TMA needs a batch stride that is a multiple of 16 "
                             f"bytes, got {sb} floats")
        if ptr % 16:
            raise ValueError(f"octave {o}: TMA needs a 16-byte aligned stack")
        if max(b, r, w) >= 2**31:
            raise ValueError(f"octave {o}: stack {tuple(s.shape)} too large for one tensor map")
        if not (y.is_contiguous() and x.is_contiguous()):
            raise ValueError(f"octave {o}: origins must be contiguous")
        args += (ptr, sb if b > 1 else r * sr, r, w, y.data_ptr(), x.data_ptr(), y.shape[1], sr)
    return args


def extract_patches_octaves(stacks, ys, xs, patch: int = PATCH) -> torch.Tensor:
    """Lists over octaves of stack [B, R_o, W_o] float32 (levels stacked
    vertically) and ys/xs [B, Q_o] int32 patch origins -> [B, sum Q_o, patch,
    patch], octave by octave along axis 1. CUDA tensors go through the kernel
    (one launch for every octave and frame) or raise; CPU tensors through the
    plain version."""
    stacks, ys, xs = list(stacks), list(ys), list(xs)
    _check_inputs(stacks, ys, xs, patch)
    dev = stacks[0].device
    if dev.type == "cpu":
        return extract_patches_octaves_plain(stacks, ys, xs, patch)
    if dev.type != "cuda":
        raise ValueError(f"extract_patches_octaves: no kernel for device {dev}")
    args = tma_constraints(stacks, ys, xs, patch)
    b = stacks[0].shape[0]
    qs = args[6::8]
    out = torch.empty((b, sum(qs), patch, patch), dtype=torch.float32, device=dev)
    if b == 0 or sum(qs) == 0:
        return out
    packed = array.array("q", args)  # int64s; alive until the call returns
    _launch(dev, len(stacks), packed.buffer_info()[0], b, out.data_ptr())
    return out


def extract_patches(stack: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    patch: int = PATCH) -> torch.Tensor:
    """One octave: stack [B, R, W] float32, ys/xs [B, Q] int32 -> [B, Q,
    patch, patch]; ``extract_patches_octaves`` on a single octave."""
    return extract_patches_octaves([stack], [ys], [xs], patch)
