"""DepthNet, the framework's own monocular depth network (counterpart of
``rtvm_tpu/models/depthnet.py``), as an ``nn.Module`` on NCHW tensors.

A compact encoder-decoder: five 3x3 conv blocks (conv, GroupNorm with
min(8, C) groups, SiLU) at strides 1, 2, 2, 2, 2, a middle block, a global
mean-pooled context added through a dense layer and SiLU, four decoder
blocks on bilinear upsampling concatenated with the skips (upsampled first,
as JAX concatenates), and a final 3x3 conv with a sigmoid: relative depth,
1 = near.

What it keeps of Flax to give Flax's numbers:
- ``nn.Conv``'s "SAME" padding, worked out per axis from the input size: at
  stride 2 an even size pads (0, 1) and an odd one (1, 1); at stride 1 (1, 1);
- GroupNorm's epsilon, 1e-6 (PyTorch's default is 1e-5);
- ``jax.image.resize(..., "bilinear")`` when upsampling, which is
  ``F.interpolate(mode="bilinear", align_corners=False)``;
- Flax's module names (``_Block_0`` .. ``_Block_9``, ``Conv_0``,
  ``GroupNorm_0``, ``Dense_0``), so that a checkpoint's leaf paths map to
  ``state_dict`` keys without a table (``flax_to_state_dict``).

Without a checkpoint the weights come from a seeded ``torch.Generator``;
they differ from Flax's initialisation.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from rtvm_tpu_torch.device import resolve_device

GN_EPS = 1e-6  # flax.linen.GroupNorm's epsilon


def same_padding(n: int, k: int, stride: int) -> tuple:
    """(low, high) padding of one axis of size n under Flax's "SAME" rule."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class _Block(nn.Module):
    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.Conv_0 = nn.Conv2d(cin, ch, 3, stride=stride)
        self.GroupNorm_0 = nn.GroupNorm(min(8, ch), ch, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = (same_padding(n, 3, self.stride) for n in x.shape[-2:])
        x = self.Conv_0(F.pad(x, (*pw, *ph)))
        return F.silu(self.GroupNorm_0(x))


class DepthNet(nn.Module):
    """x [B, 3, H, W] float RGB in 0..1 -> depth [B, 1, H, W] in (0, 1)."""

    def __init__(self, base: int = 32):
        super().__init__()
        b = base
        enc = [(3, b, 1), (b, 2 * b, 2), (2 * b, 4 * b, 2), (4 * b, 8 * b, 2), (8 * b, 8 * b, 2),
               (8 * b, 8 * b, 1)]  # five encoder blocks and the middle one
        dec = [(16 * b, 8 * b), (8 * b + 4 * b, 4 * b), (4 * b + 2 * b, 2 * b), (2 * b + b, b)]
        for i, (cin, ch, s) in enumerate(enc + [(ci, co, 1) for ci, co in dec]):
            setattr(self, f"_Block_{i}", _Block(cin, ch, s))
        self.Dense_0 = nn.Linear(8 * b, 8 * b)
        self.Conv_0 = nn.Conv2d(b, 1, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blk = [getattr(self, f"_Block_{i}") for i in range(10)]
        e1 = blk[0](x)
        e2 = blk[1](e1)
        e3 = blk[2](e2)
        e4 = blk[3](e3)
        e5 = blk[4](e4)  # /16: terrain height is low-frequency
        m = blk[5](e5)
        g = m.mean(dim=(2, 3))  # the global scene context
        m = m + F.silu(self.Dense_0(g))[:, :, None, None]

        def up(z, ref):
            return F.interpolate(z, size=ref.shape[-2:], mode="bilinear", align_corners=False)

        d4 = blk[6](torch.cat([up(m, e4), e4], 1))
        d3 = blk[7](torch.cat([up(d4, e3), e3], 1))
        d2 = blk[8](torch.cat([up(d3, e2), e2], 1))
        d1 = blk[9](torch.cat([up(d2, e1), e1], 1))
        return torch.sigmoid(self.Conv_0(F.pad(d1, (1, 1, 1, 1))))


def flax_to_state_dict(tree: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """DepthNet's state_dict from Flax variables, the flat ``{leaf path:
    array}`` of ``utils.checkpoint.load_pytree_npz``: ``params/`` is dropped,
    ``/`` becomes ``.``, a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW),
    a dense ``kernel`` (in, out) becomes ``weight`` (out, in) and
    GroupNorm's ``scale`` becomes ``weight``. Raises ValueError unless the
    names and shapes are exactly DepthNet's."""
    sd = {}
    for path, leaf in tree.items():
        parts = path.split("/")
        if parts[0] != "params":
            raise ValueError(f"{path!r}: not under params")
        a = np.asarray(leaf, dtype=np.float32)
        if parts[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        if parts[-1] in ("kernel", "scale"):
            parts[-1] = "weight"
        sd[".".join(parts[1:])] = torch.from_numpy(np.ascontiguousarray(a))
    with torch.device("meta"):
        want = DepthNet().state_dict()
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"DepthNet: checkpoint names differ from the model's: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    bad = [k for k in want if tuple(want[k].shape) != tuple(sd[k].shape)]
    if bad:
        raise ValueError(f"DepthNet: shapes differ at {bad[:5]}")
    return sd


def state_dict_to_flax(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``flax_to_state_dict``: {leaf path under ``params/``:
    float32 array} of DepthNet's state_dict, or of tensors shaped as its
    parameters (AdamW's moments). A 4-D ``weight`` becomes the HWIO conv
    ``kernel``, a 2-D one the ``(in, out)`` dense ``kernel``, a 1-D one
    GroupNorm's ``scale``."""
    out = {}
    for key, t in tensors.items():
        parts = key.split(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if parts[-1] == "weight":
            parts[-1] = "scale" if a.ndim == 1 else "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        out["/".join(["params"] + parts)] = np.array(a, order="C")
    return out


def build_depthnet(checkpoint: str | None = None, device=None, seed: int = 0) -> DepthNet:
    """DepthNet in eval mode on `device` (``resolve_device``: the card unless
    the caller asks for the CPU), from a checkpoint written by the JAX
    package (``weights/depthnet.npz``), or with weights drawn from a
    ``torch.Generator`` seeded with `seed`."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = DepthNet()
    if checkpoint is not None:
        from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

        model.load_state_dict(flax_to_state_dict(load_pytree_npz(checkpoint)))
    return model.to(device).eval()
