"""Blocked top-k over a score map (counterpart of ``topk2d_blocked`` in
``rtvm_tpu/ops/features/fast.py``; the rest of that module, FAST-9 for the ORB
path, belongs to a later slice).

The JAX version ranks with ``approx_max_k``, which is exact off the TPU; this
one is exact everywhere: a stable descending sort, so ties go to the lower
index as ``lax.top_k`` breaks them.
"""

from __future__ import annotations

import torch


def topk2d_blocked(score: torch.Tensor, k: int):
    """Top-k over [..., H, W] non-negative score maps -> (score, y, x, valid),
    each [..., k].

    The lane offset (x mod 8) is packed into the 3 low mantissa bits of the
    score's int32 bit pattern (order-preserving for non-negative floats), each
    8-wide block keeps its maximum, and the top k blocks are taken: at most one
    keypoint per 8-pixel row block, as in the JAX version."""
    *lead, h, w = score.shape
    wp = ((w + 7) // 8) * 8
    sp = torch.nn.functional.pad(score.to(torch.float32), (0, wp - w)).contiguous()
    enc = sp.view(torch.int32)
    lane = torch.arange(wp, device=score.device, dtype=torch.int32) % 8
    enc = (enc & ~7) | lane
    enc = torch.where(sp > 0.0, enc, torch.zeros_like(enc))
    blocks = enc.reshape(*lead, h, wp // 8, 8).amax(dim=-1).reshape(*lead, -1)
    top_enc, bidx = torch.sort(blocks, dim=-1, descending=True, stable=True)
    top_enc, bidx = top_enc[..., :k].contiguous(), bidx[..., :k]
    off = top_enc & 7
    top = (top_enc & ~7).view(torch.float32)
    ky = bidx // (wp // 8)
    kx = (bidx % (wp // 8)) * 8 + off
    return top, ky, kx, top_enc > 0
