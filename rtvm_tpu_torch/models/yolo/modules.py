"""YOLOv8, YOLO11 and YOLOv8-Worldv2 building blocks as NCHW ``nn.Module``s
(counterpart of ``rtvm_tpu/models/yolo/modules.py``, which is NHWC Flax; the
Worldv2 blocks, Ultralytics' ``C2fAttn``, ``MaxSigmoidAttnBlock`` and
``WorldDetect(with_bn=True)``, have no JAX counterpart).

Every module names its children as Flax names them inside a compact
``__call__``: the class name and a count per class in creation order
(``ConvBnSiLU_0``, ``Bottleneck_1``, a convolution ``Conv_0`` and its
``BatchNorm_0``), and BatchNorm keeps Flax's parameter names (``scale``,
``bias``, ``mean``, ``var``). So a Flax checkpoint's leaf path is the port's
``state_dict`` key with ``/`` for ``.``, and ``convert.flax_to_state_dict``
needs no table of names. Unlike Flax, each module is told its input channels.

Convolutions are ``F.conv2d`` (cuDNN on the card) and the attention is two
``einsum``s and a softmax, as the JAX package leaves them to XLA: YOLO has no
TPU kernel of its own. The text-guided attention is plain torch operations
too, inside the span ``clip.attn``.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rtvm_tpu_torch.utils.timing import span

BN_EPS = 1e-3  # Flax's BatchNorm epsilon here, not PyTorch's 1e-5
BN_MOMENTUM = 0.97  # the running statistics' weight on their old value, Flax's convention

# The process group whose ranks' batches training-mode BatchNorm normalises
# as one batch (synced_batch_stats), or None: this process's batch alone.
_SYNC_GROUP = None


@contextlib.contextmanager
def synced_batch_stats(group):
    """Within the block, training-mode BatchNorm takes its statistics over
    the batches of every rank of `group` (the dp training step of
    ``parallel/mesh.py``): each layer sums its per-channel sum, sum of
    squares and count over the group with a differentiable all-reduce."""
    global _SYNC_GROUP
    prev, _SYNC_GROUP = _SYNC_GROUP, group
    try:
        yield
    finally:
        _SYNC_GROUP = prev


class FlaxScope(nn.Module):
    """A module whose children get Flax's automatic names."""

    def __init__(self):
        super().__init__()
        self._name_counts = {}

    def child(self, module: nn.Module, prefix: str = "") -> str:
        """Registers `module` as ``{prefix}_{n}`` (prefix: its class name) and
        returns the name."""
        prefix = prefix or type(module).__name__
        n = self._name_counts.get(prefix, 0)
        self._name_counts[prefix] = n + 1
        name = f"{prefix}_{n}"
        self.add_module(name, module)
        return name

    def run(self, names: Sequence[str], x):
        for name in names:
            x = getattr(self, name)(x)
        return x


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(momentum=0.97, epsilon=1e-3)``: running
    statistics in eval mode; in training mode (``self.training``) the batch's
    statistics over N, H and W, Flax's way, which ``F.batch_norm`` is not:
    the variance is the fast form max(0, E[x^2] - E[x]^2), and the running
    variance takes that biased variance, each running value kept at
    momentum 0.97 (``F.batch_norm``'s momentum weighs the new value and its
    running variance is the unbiased one). Under ``synced_batch_stats`` the
    statistics are those of every rank's batch together."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0, BN_EPS)
        xf = x.float()
        if _SYNC_GROUP is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        else:
            from rtvm_tpu_torch.parallel.collectives import all_reduce_sum

            c = xf.shape[1]
            count = xf.new_full((1,), float(xf.numel() // c))  # exact below 2**24
            sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                             count]), _SYNC_GROUP)
            mean = sums[:c] / sums[2 * c]
            var = torch.clamp(sums[c : 2 * c] / sums[2 * c] - mean * mean, min=0.0)
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class ConvBnSiLU(nn.Module):
    """Conv (padding kernel // 2, no bias) + BatchNorm + optional SiLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, groups=groups,
                                bias=False)
        self.BatchNorm_0 = BatchNorm(out_ch)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.silu(x) if self.act else x


class ConvBn(ConvBnSiLU):
    """Conv + BatchNorm without activation (YOLO11's attention convs); a class
    of its own because Flax names it ``ConvBn_n``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride, groups, act=False)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, shortcut: bool = True, expansion: float = 0.5,
                 kernels: Tuple[int, int] = (3, 3)):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.ConvBnSiLU_0 = ConvBnSiLU(in_ch, hidden, kernels[0])
        self.ConvBnSiLU_1 = ConvBnSiLU(hidden, out_ch, kernels[1])
        self.add = shortcut and in_ch == out_ch

    def forward(self, x):
        y = self.ConvBnSiLU_1(self.ConvBnSiLU_0(x))
        return x + y if self.add else y


class C2f(FlaxScope):
    """Cross-stage-partial block: split after 1x1, run n bottlenecks, concat all."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1, shortcut: bool = False,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.hidden = hidden
        self.ConvBnSiLU_0 = ConvBnSiLU(in_ch, 2 * hidden, 1)
        self.inner = [self.child(Bottleneck(hidden, hidden, shortcut, 1.0)) for _ in range(n)]
        self.ConvBnSiLU_1 = ConvBnSiLU((2 + n) * hidden, out_ch, 1)

    def forward(self, x):
        outs = list(torch.split(self.ConvBnSiLU_0(x), self.hidden, dim=1))
        for name in self.inner:
            outs.append(getattr(self, name)(outs[-1]))
        return self.ConvBnSiLU_1(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three chained 5x5 max-pools (padding
    acts as -inf, as Flax's), concat."""

    def __init__(self, in_ch: int, out_ch: int, pool: int = 5):
        super().__init__()
        hidden = in_ch // 2
        self.ConvBnSiLU_0 = ConvBnSiLU(in_ch, hidden, 1)
        self.ConvBnSiLU_1 = ConvBnSiLU(4 * hidden, out_ch, 1)
        self.pool = pool

    def forward(self, x):
        pools = [self.ConvBnSiLU_0(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], self.pool, 1, self.pool // 2))
        return self.ConvBnSiLU_1(torch.cat(pools, dim=1))


class C3k(FlaxScope):
    """CSP block with 3 convs and n 3x3 bottlenecks (YOLO11's inner block)."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 2, shortcut: bool = True,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.ConvBnSiLU_0 = ConvBnSiLU(in_ch, hidden, 1)
        self.ConvBnSiLU_1 = ConvBnSiLU(in_ch, hidden, 1)
        self.inner = [self.child(Bottleneck(hidden, hidden, shortcut, 1.0)) for _ in range(n)]
        self.ConvBnSiLU_2 = ConvBnSiLU(2 * hidden, out_ch, 1)

    def forward(self, x):
        a = self.run(self.inner, self.ConvBnSiLU_0(x))
        return self.ConvBnSiLU_2(torch.cat([a, self.ConvBnSiLU_1(x)], dim=1))


class C3k2(FlaxScope):
    """YOLO11's CSP block: C2f whose n inner modules are C3k blocks (c3k=True)
    or 0.5-expansion bottlenecks."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1, c3k: bool = False,
                 shortcut: bool = True, expansion: float = 0.5):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.hidden = hidden
        self.ConvBnSiLU_0 = ConvBnSiLU(in_ch, 2 * hidden, 1)
        self.inner = [self.child(C3k(hidden, hidden, 2, shortcut) if c3k
                                 else Bottleneck(hidden, hidden, shortcut, 0.5))
                      for _ in range(n)]
        self.ConvBnSiLU_1 = ConvBnSiLU((2 + n) * hidden, out_ch, 1)

    def forward(self, x):
        outs = list(torch.split(self.ConvBnSiLU_0(x), self.hidden, dim=1))
        for name in self.inner:
            outs.append(getattr(self, name)(outs[-1]))
        return self.ConvBnSiLU_1(torch.cat(outs, dim=1))


class SpatialAttention(nn.Module):
    """YOLO11 multi-head self-attention over the H*W cells, with a depthwise
    positional branch on v. The qkv conv's channels are head-major, each head
    holding [q (key_dim), k (key_dim), v (head_dim)], as the JAX module splits
    its NHWC channels."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.ConvBn_0 = ConvBn(dim, num_heads * (2 * self.key_dim + self.head_dim), 1)  # qkv
        self.ConvBn_1 = ConvBn(dim, dim, 3, groups=dim)  # positional encoding
        self.ConvBn_2 = ConvBn(dim, dim, 1)  # projection

    def forward(self, x):
        b, _, h, w = x.shape
        kd, hd = self.key_dim, self.head_dim
        qkv = self.ConvBn_0(x).reshape(b, self.num_heads, 2 * kd + hd, h * w)
        q, k, v = torch.split(qkv, [kd, kd, hd], dim=2)
        attn = torch.einsum("bhdn,bhdm->bhnm", q, k) * (kd ** -0.5)
        attn = torch.softmax(attn, dim=-1)
        o = torch.einsum("bhnm,bhdm->bhdn", attn, v).reshape(b, self.dim, h, w)
        pe = self.ConvBn_1(v.reshape(b, self.dim, h, w))
        return self.ConvBn_2(o + pe)


class PSABlock(nn.Module):
    """Position-sensitive attention block: residual attention + residual FFN."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.SpatialAttention_0 = SpatialAttention(dim, num_heads)
        self.ConvBnSiLU_0 = ConvBnSiLU(dim, 2 * dim, 1)
        self.ConvBn_0 = ConvBn(2 * dim, dim, 1)

    def forward(self, x):
        x = x + self.SpatialAttention_0(x)
        return x + self.ConvBn_0(self.ConvBnSiLU_0(x))


class C2PSA(FlaxScope):
    """YOLO11's CSP-wrapped stack of PSABlocks on the stride-32 map."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1, expansion: float = 0.5):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.hidden = hidden
        self.ConvBnSiLU_0 = ConvBnSiLU(in_ch, 2 * hidden, 1)
        self.inner = [self.child(PSABlock(hidden, max(1, hidden // 64))) for _ in range(n)]
        self.ConvBnSiLU_1 = ConvBnSiLU(2 * hidden, out_ch, 1)

    def forward(self, x):
        a, b = torch.split(self.ConvBnSiLU_0(x), self.hidden, dim=1)
        return self.ConvBnSiLU_1(torch.cat([a, self.run(self.inner, b)], dim=1))


class MaxSigmoidAttnBlock(nn.Module):
    """YOLO-World's text-guided attention (Ultralytics ``MaxSigmoidAttnBlock``
    with c1 = c2 = ec, which builds no ``ec`` convolution). The guide
    ``Dense_0`` (Linear guide_ch -> ch) of the text embeddings [K, guide_ch]
    is viewed as [K, heads, ch // heads]; per head m and pixel, the weight is
    sigmoid(max over k of x[m] . g[k, m] / sqrt(ch // heads) + bias[m]), and
    it gates head m's channels of ``ConvBn_0`` (3x3 conv + BatchNorm) of x.
    Plain torch operations inside the span ``clip.attn``, which has a range
    on the device."""

    def __init__(self, ch: int, heads: int, guide_ch: int = 512):
        super().__init__()
        self.heads, self.head_ch = heads, ch // heads
        self.Dense_0 = nn.Linear(guide_ch, ch)
        self.bias = nn.Parameter(torch.zeros(heads))
        self.ConvBn_0 = ConvBn(ch, ch, 3)

    def forward(self, x, text):
        b, c, h, w = x.shape
        with span("clip.attn", device_range=True):
            g = self.Dense_0(text).reshape(-1, self.heads, self.head_ch)
            aw = torch.einsum("bmjhw,kmj->bmhwk", x.reshape(b, self.heads, self.head_ch, h, w), g)
            aw = torch.sigmoid(aw.amax(-1) / self.head_ch ** 0.5 + self.bias[:, None, None])
            y = self.ConvBn_0(x).reshape(b, self.heads, self.head_ch, h, w) * aw[:, :, None]
            return y.reshape(b, c, h, w)


class C2fAttn(FlaxScope):
    """YOLO-World's C2f with one more branch: the text-guided attention of
    the last bottleneck's output, so the closing 1x1 takes (3 + n) * hidden
    channels. forward(x, text [K, guide_ch])."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1, heads: int = 1, guide_ch: int = 512,
                 shortcut: bool = False, expansion: float = 0.5):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.hidden = hidden
        self.ConvBnSiLU_0 = ConvBnSiLU(in_ch, 2 * hidden, 1)
        self.inner = [self.child(Bottleneck(hidden, hidden, shortcut, 1.0)) for _ in range(n)]
        self.MaxSigmoidAttnBlock_0 = MaxSigmoidAttnBlock(hidden, heads, guide_ch)
        self.ConvBnSiLU_1 = ConvBnSiLU((3 + n) * hidden, out_ch, 1)

    def forward(self, x, text):
        outs = list(torch.split(self.ConvBnSiLU_0(x), self.hidden, dim=1))
        for name in self.inner:
            outs.append(getattr(self, name)(outs[-1]))
        outs.append(self.MaxSigmoidAttnBlock_0(outs[-1], text))
        return self.ConvBnSiLU_1(torch.cat(outs, dim=1))


class DetectHead(FlaxScope):
    """Decoupled anchor-free head with DFL box regression (reg_max bins a side).

    dw_cls=True is YOLO11's depthwise-separable classification branch
    (DWConv3x3 + 1x1, twice) instead of v8's dense 3x3 pair. The widths follow
    the first feature map's channels, as in the JAX head. The class branch
    ends in ``cls_out`` channels (default: one a class)."""

    def __init__(self, in_chs: Sequence[int], num_classes: int, reg_max: int = 16,
                 dw_cls: bool = False, cls_out: int = 0):
        super().__init__()
        c2 = max(16, in_chs[0] // 4, reg_max * 4)
        c3 = max(in_chs[0], min(num_classes, 100))
        self.box: List[List[str]] = []
        self.cls: List[List[str]] = []
        for f in in_chs:
            box = [self.child(ConvBnSiLU(f, c2, 3)), self.child(ConvBnSiLU(c2, c2, 3)),
                   self.child(nn.Conv2d(c2, 4 * reg_max, 1), "Conv")]
            if dw_cls:
                cls = [self.child(ConvBnSiLU(f, f, 3, groups=f)), self.child(ConvBnSiLU(f, c3, 1)),
                       self.child(ConvBnSiLU(c3, c3, 3, groups=c3)),
                       self.child(ConvBnSiLU(c3, c3, 1))]
            else:
                cls = [self.child(ConvBnSiLU(f, c3, 3)), self.child(ConvBnSiLU(c3, c3, 3))]
            cls.append(self.child(nn.Conv2d(c3, cls_out or num_classes, 1), "Conv"))
            self.box.append(box)
            self.cls.append(cls)

    def forward(self, feats):
        box_outs = [self.run(names, f) for names, f in zip(self.box, feats)]
        cls_outs = [self.run(names, f) for names, f in zip(self.cls, feats)]
        return box_outs, cls_outs


class BNContrastiveHead(nn.Module):
    """YOLO-World's class logits with BatchNorm (Ultralytics
    ``BNContrastiveHead``): ``BatchNorm_0`` of the region embeddings [B, D,
    H, W], dotted with the L2-normalised text embeddings [K, D], times
    exp(``logit_scale``), plus ``bias`` (one number). The BatchNorm is the
    port's, with Flax's epsilon as every other here."""

    def __init__(self, dim: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(dim)
        self.bias = nn.Parameter(torch.tensor([-10.0]))
        self.logit_scale = nn.Parameter(torch.tensor(-1.0))

    def forward(self, x, text):
        t = F.normalize(text, dim=-1)
        return (torch.einsum("bchw,kc->bkhw", self.BatchNorm_0(x), t) * self.logit_scale.exp()
                + self.bias)


class WorldDetectHead(DetectHead):
    """YOLO-World's ``WorldDetect(nc, embed, with_bn=True)``: the DFL box
    branch of DetectHead, and a class branch that ends in `embed`-wide
    region embeddings, which each stride's ``BNContrastiveHead`` scores
    against the text embeddings. forward(feats, text [K, embed])."""

    def __init__(self, in_chs: Sequence[int], num_classes: int, embed: int = 512,
                 reg_max: int = 16):
        super().__init__(in_chs, num_classes, reg_max, cls_out=embed)
        self.contrast = [self.child(BNContrastiveHead(embed)) for _ in in_chs]

    def forward(self, feats, text):
        box_outs, emb_outs = super().forward(feats)
        return box_outs, [getattr(self, n)(e, text) for n, e in zip(self.contrast, emb_outs)]


def dfl_expectation(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """[B, 4*reg_max, ...] logits -> [B, 4, ...] expected ltrb distances (in
    stride units); channel c is side c // reg_max, bin c % reg_max."""
    b, rest = box_logits.shape[0], box_logits.shape[2:]
    p = torch.softmax(box_logits.reshape((b, 4, reg_max) + rest), dim=2)
    bins = torch.arange(reg_max, dtype=p.dtype, device=p.device)
    return torch.sum(p * bins.reshape((1, 1, reg_max) + (1,) * len(rest)), dim=2)
