"""RT-DETR with a ResNet-vd trunk (Zhao et al., "DETRs Beat YOLOs on
Real-time Object Detection", CVPR 2024, arXiv:2304.08069) as an NCHW
``nn.Module`` of plain torch operations; the JAX package has no
counterpart.

The graph is the authors' (``rtdetr_pytorch``), as ``transformers``'
``RTDetrForObjectDetection`` writes it at inference:
- trunk: the vd ResNet: a deep stem of three 3x3 convolutions and a 3x3
  max pool, bottlenecks with the stride on the 3x3, a 2x2 average pool
  then a 1x1 on a strided block's shortcut, frozen BatchNorm; its stages
  2-4 (strides 8, 16, 32) go on;
- hybrid encoder: each map projected to ``encoder_hidden_dim`` (1x1 +
  BatchNorm); one post-norm transformer layer (AIFI: GELU) over the
  stride-32 map's tokens with a 2-D sin-cos position embedding; the CCFM,
  a top-down FPN and a bottom-up PAN of CSPRepLayer / RepVGG blocks
  (Conv + BatchNorm + SiLU);
- query selection: the maps projected to ``d_model`` and flattened into
  one memory of A tokens; every anchor's class logits and box (a 3-layer
  MLP's offset from the anchor in logit space); the ``num_queries``
  anchors of the largest class logit; their memory rows are the queries,
  their boxes the first reference boxes;
- decoder: layers of query self-attention, multi-scale deformable
  cross-attention (``DeformableAttention``) and an FFN (ReLU), post-norm;
  each layer refines the box, sigmoid(MLP(h) + inverse_sigmoid(box)); the
  last layer's class head scores the queries. The training-time denoising
  queries do not exist at inference and are left out.

Module and parameter names are ``RTDetrForObjectDetection``'s, so a
``state_dict`` key here is a key of its ``state_dict`` (the top-level copies
of the tied heads, ``num_batches_tracked`` and the denoising embedding
aside), and a checkpoint's leaf path is that key with ``/`` for ``.``.

Precision: the model runs in the dtype it is cast to (bf16 on the fused
path). The anchors, the reference boxes, the sigmoid / inverse-sigmoid
chain (eps 1e-5, which bf16 cannot hold beside 1), the deformable
sampling's locations and the logits returned stay in float32; the sampling
reads the value map at those locations in float32 (a bf16 grid would place
a point up to 0.16 px off on a 160-column map). The anchors, their valid
mask and AIFI's position embedding depend on the input size only and are
built once a size on the device.

``forward(x)`` returns the heads the benchmark compares, per level l of
the A anchors ((h_l, w_l) the level's map), in float32:
- ``box[l]`` [B, 8, h_l, w_l]: channels 0-3 the encoder's box offsets
  (cx, cy, w, h logits before the anchor is added), 4-7 the last decoder
  layer's refined box logits at the cell each query was selected from, 0
  elsewhere;
- ``cls[l]`` [B, 2C + 1, h_l, w_l]: channels 0..C-1 the encoder's class
  logits, C..2C-1 the last layer's class logits at the selected cells (0
  elsewhere), 2C the selection map (1 at a selected cell, else 0).
A flat, fixed-size layout that does not depend on the order of the top-k;
a query one side selects and the other does not differs in its own cell
only; ``postprocess.select_detections`` reads nothing else.

Inside the model, the span ``clip.decoder`` (a device range) holds the
query selection and the decoder, ``clip.deform`` (nested in it) each
deformable cross-attention from the value projection to the output
projection, and ``count("anchors", A)`` the memory length the selection
scans.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.utils.timing import count, span

EPS = 1e-5  # BatchNorm's and LayerNorm's
INV_SIGMOID_EPS = 1e-5
TEMPERATURE = 10000.0  # AIFI's sin-cos position embedding
ANCHOR_GRID = 0.05  # an anchor's side at stride 8, doubling a level
ANCHOR_VALID = 1e-2  # an anchor is valid with every coordinate in (0.01, 0.99)


@dataclasses.dataclass(frozen=True)
class RTDetrSpec:
    """The widths and depths of one RT-DETR; the defaults are
    ``RTDetrConfig``'s (rtdetr_r50vd)."""

    depths: Tuple[int, ...] = (3, 4, 6, 3)
    embedding_size: int = 64
    hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 2048)
    encoder_hidden_dim: int = 256
    encoder_ffn_dim: int = 1024
    encoder_heads: int = 8
    d_model: int = 256
    decoder_ffn_dim: int = 1024
    decoder_layers: int = 6
    decoder_heads: int = 8
    n_points: int = 4
    num_queries: int = 300
    num_classes: int = 80
    feat_strides: Tuple[int, ...] = (8, 16, 32)

    @property
    def levels(self) -> int:
        return len(self.feat_strides)


# the published model: rtdetr_r101vd_6x_coco.yml against the r50vd defaults
# (its decoder_in_channels are the CCFM's widths, encoder_hidden_dim)
VARIANTS_RTDETR = {
    "rtdetr-r101vd": RTDetrSpec(depths=(3, 4, 23, 3), encoder_hidden_dim=384,
                                encoder_ffn_dim=2048),
}


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=INV_SIGMOID_EPS) / (1 - x).clamp(min=INV_SIGMOID_EPS))


def refine(delta: torch.Tensor, ref: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the box chain in float32: (logit, box) = (delta +
    inverse_sigmoid(ref), sigmoid(logit)), `delta` a box head's output in
    any dtype, `ref` the float32 boxes in 0..1."""
    logit = delta.float() + inverse_sigmoid(ref)
    return logit, torch.sigmoid(logit)


def generate_anchors(shapes: Sequence[Tuple[int, int]], device) -> Tuple[torch.Tensor,
                                                                         torch.Tensor]:
    """float32 anchors [1, A, 4] in logit space (cx, cy, w, h; the largest
    float32 where invalid) and their valid mask [1, A, 1], level by level,
    row-major: cell (x + 0.5, y + 0.5) / (w, h), side ANCHOR_GRID * 2^level."""
    out = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                                torch.arange(w, device=device, dtype=torch.float32),
                                indexing="ij")
        xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1)
        wh = torch.full_like(xy, ANCHOR_GRID * 2.0 ** lvl)
        out.append(torch.cat([xy, wh], -1).reshape(1, h * w, 4))
    a = torch.cat(out, 1)
    valid = ((a > ANCHOR_VALID) & (a < 1 - ANCHOR_VALID)).all(-1, keepdim=True)
    a = torch.log(a / (1 - a))
    return torch.where(valid, a, torch.full_like(a, torch.finfo(torch.float32).max)), valid


def sincos_position_embedding(h: int, w: int, dim: int, device) -> torch.Tensor:
    """AIFI's float32 2-D sin-cos embedding [1, h * w, dim], as the authors'
    ``build_2d_sincos_position_embedding(w, h)`` builds it: its meshgrid
    walks the columns first, so token k gets column k // h, row k % h."""
    gw, gh = torch.meshgrid(torch.arange(w, device=device, dtype=torch.float32),
                            torch.arange(h, device=device, dtype=torch.float32), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / TEMPERATURE ** (torch.arange(pos_dim, device=device,
                                               dtype=torch.float32) / pos_dim)
    ow, oh = gw.flatten()[:, None] * omega[None], gh.flatten()[:, None] * omega[None]
    return torch.cat([ow.sin(), ow.cos(), oh.sin(), oh.cos()], 1)[None]


# ------------------------------------------------------------------ modules


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics and affine (every BatchNorm here runs
    at inference); ``weight``, ``bias``, ``running_mean``, ``running_var``."""

    def __init__(self, ch: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(ch))
        self.register_buffer("bias", torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, EPS)


class ResNetConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, act: bool = True):
        super().__init__()
        self.convolution = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.normalization = FrozenBatchNorm2d(cout)
        self.act = act

    def forward(self, x):
        x = self.normalization(self.convolution(x))
        return F.relu(x) if self.act else x


class ResNetShortCut(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.convolution = nn.Conv2d(cin, cout, 1, stride, bias=False)
        self.normalization = FrozenBatchNorm2d(cout)

    def forward(self, x):
        return self.normalization(self.convolution(x))


class ResNetBottleNeck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1, plus the shortcut: a 2x2 average pool
    then a 1x1 where the block strides (vd), a 1x1 where only the width
    changes, the input itself otherwise; then ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        red = cout // 4
        if stride == 2:
            self.shortcut = nn.Sequential(nn.AvgPool2d(2, 2, 0, ceil_mode=True),
                                          ResNetShortCut(cin, cout, 1))
        elif cin != cout:
            self.shortcut = ResNetShortCut(cin, cout, 1)
        else:
            self.shortcut = nn.Identity()
        self.layer = nn.Sequential(ResNetConvLayer(cin, red, 1),
                                   ResNetConvLayer(red, red, 3, stride),
                                   ResNetConvLayer(red, cout, 1, act=False))

    def forward(self, x):
        return F.relu(self.layer(x) + self.shortcut(x))


class ResNetStage(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, depth: int):
        super().__init__()
        self.layers = nn.Sequential(ResNetBottleNeck(cin, cout, stride),
                                    *[ResNetBottleNeck(cout, cout) for _ in range(depth - 1)])

    def forward(self, x):
        return self.layers(x)


class ResNetEmbeddings(nn.Module):
    def __init__(self, emb: int):
        super().__init__()
        self.embedder = nn.Sequential(ResNetConvLayer(3, emb // 2, 3, 2),
                                      ResNetConvLayer(emb // 2, emb // 2, 3, 1),
                                      ResNetConvLayer(emb // 2, emb, 3, 1))
        self.pooler = nn.MaxPool2d(3, 2, 1)

    def forward(self, x):
        return self.pooler(self.embedder(x))


class ResNetEncoder(nn.Module):
    def __init__(self, spec: RTDetrSpec):
        super().__init__()
        ins = (spec.embedding_size,) + spec.hidden_sizes[:-1]
        self.stages = nn.ModuleList(
            ResNetStage(ci, co, 1 if i == 0 else 2, d)
            for i, (ci, co, d) in enumerate(zip(ins, spec.hidden_sizes, spec.depths)))


class ResNetBackbone(nn.Module):
    """The vd ResNet; returns stages 2-4's maps (strides 8, 16, 32)."""

    def __init__(self, spec: RTDetrSpec):
        super().__init__()
        self.embedder = ResNetEmbeddings(spec.embedding_size)
        self.encoder = ResNetEncoder(spec)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.embedder(x)
        out = []
        for i, stage in enumerate(self.encoder.stages):
            x = stage(x)
            if i >= 1:
                out.append(x)
        return out


class ConvEncoder(nn.Module):
    def __init__(self, spec: RTDetrSpec):
        super().__init__()
        self.model = ResNetBackbone(spec)


class ConvNormLayer(nn.Module):
    """Conv (no bias) + BatchNorm + optional SiLU: ``ConvBnSiLU``'s
    arithmetic under the authors' names."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, act: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)
        self.norm = FrozenBatchNorm2d(cout)
        self.act = act

    def forward(self, x):
        x = self.norm(self.conv(x))
        return F.silu(x) if self.act else x


class RepVggBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = ConvNormLayer(ch, ch, 3)
        self.conv2 = ConvNormLayer(ch, ch, 1)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


class CSPRepLayer(nn.Module):
    """At ``hidden_expansion`` 1.0, the published models', whose ``conv3`` is
    the identity."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = ConvNormLayer(2 * c, c, 1, act=True)
        self.conv2 = ConvNormLayer(2 * c, c, 1, act=True)
        self.bottlenecks = nn.Sequential(*[RepVggBlock(c) for _ in range(3)])

    def forward(self, x):
        return self.bottlenecks(self.conv1(x)) + self.conv2(x)


class MultiheadAttention(nn.Module):
    """Queries and keys from h + pos, values from h; softmax(q k^T / sqrt(d))."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, h, pos):
        b, n, d = h.shape
        split = lambda t: t.view(b, n, self.heads, d // self.heads).transpose(1, 2)  # noqa: E731
        qk = h + pos
        o = F.scaled_dot_product_attention(split(self.q_proj(qk)), split(self.k_proj(qk)),
                                           split(self.v_proj(h)))
        return self.out_proj(o.transpose(1, 2).reshape(b, n, d))


class EncoderLayer(nn.Module):
    """AIFI: post-norm self-attention and a GELU FFN."""

    def __init__(self, spec: RTDetrSpec):
        super().__init__()
        d = spec.encoder_hidden_dim
        self.self_attn = MultiheadAttention(d, spec.encoder_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=EPS)
        self.fc1 = nn.Linear(d, spec.encoder_ffn_dim)
        self.fc2 = nn.Linear(spec.encoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=EPS)

    def forward(self, h, pos):
        h = self.self_attn_layer_norm(h + self.self_attn(h, pos))
        return self.final_layer_norm(h + self.fc2(F.gelu(self.fc1(h))))


class Encoder(nn.Module):
    def __init__(self, spec: RTDetrSpec):
        super().__init__()
        self.layers = nn.ModuleList([EncoderLayer(spec)])

    def forward(self, h, pos):
        for layer in self.layers:
            h = layer(h, pos)
        return h


class HybridEncoder(nn.Module):
    """AIFI on the stride-32 map, then the CCFM's FPN and PAN."""

    def __init__(self, spec: RTDetrSpec):
        super().__init__()
        c, n = spec.encoder_hidden_dim, spec.levels - 1
        self.encoder = nn.ModuleList([Encoder(spec)])
        self.lateral_convs = nn.ModuleList(ConvNormLayer(c, c, 1, act=True) for _ in range(n))
        self.fpn_blocks = nn.ModuleList(CSPRepLayer(c) for _ in range(n))
        self.downsample_convs = nn.ModuleList(ConvNormLayer(c, c, 3, 2, act=True)
                                              for _ in range(n))
        self.pan_blocks = nn.ModuleList(CSPRepLayer(c) for _ in range(n))

    def forward(self, feats: List[torch.Tensor], pos: torch.Tensor) -> List[torch.Tensor]:
        feats = list(feats)
        s = feats[-1]
        b, c, h, w = s.shape
        t = self.encoder[0](s.flatten(2).transpose(1, 2), pos.to(s.dtype))
        feats[-1] = t.transpose(1, 2).reshape(b, c, h, w)
        inner = [feats[-1]]
        for i, (lat, blk) in enumerate(zip(self.lateral_convs, self.fpn_blocks)):
            top = lat(inner[-1])
            inner[-1] = top
            up = F.interpolate(top, scale_factor=2.0, mode="nearest")
            inner.append(blk(torch.cat([up, feats[len(feats) - 2 - i]], 1)))
        inner = inner[::-1]
        outs = [inner[0]]
        for i, (down, blk) in enumerate(zip(self.downsample_convs, self.pan_blocks)):
            outs.append(blk(torch.cat([down(outs[-1]), inner[i + 1]], 1)))
        return outs


class MLP(nn.Module):
    def __init__(self, cin: int, hidden: int, cout: int, layers: int):
        super().__init__()
        dims = [cin] + [hidden] * (layers - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [cout]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class DeformableAttention(nn.Module):
    """Multi-scale deformable attention (Deformable DETR) with box reference
    points: head m of query q reads, on each level l, the value map at
    ``n_points`` locations ref_xy + offset / n_points * ref_wh * 0.5
    (bilinear, zeros outside, ``align_corners=False``), weighted by a
    softmax over the head's levels x points. Inside the span
    ``clip.deform``."""

    def __init__(self, spec: RTDetrSpec):
        super().__init__()
        d, heads, lv, pts = spec.d_model, spec.decoder_heads, spec.levels, spec.n_points
        self.heads, self.levels, self.points = heads, lv, pts
        self.sampling_offsets = nn.Linear(d, heads * lv * pts * 2)
        self.attention_weights = nn.Linear(d, heads * lv * pts)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)

    def forward(self, q, ref, memory, shapes: Sequence[Tuple[int, int]]):
        """q [B, Q, d] (queries with their position), ref [B, Q, 4] float32
        boxes in 0..1, memory [B, A, d]."""
        with span("clip.deform", device_range=True):
            b, nq, d = q.shape
            m, lv, pts = self.heads, self.levels, self.points
            value = self.value_proj(memory)
            off = self.sampling_offsets(q).view(b, nq, m, lv, pts, 2).float()
            aw = F.softmax(self.attention_weights(q).view(b, nq, m, lv * pts), -1)
            r = ref[:, :, None, None, None]
            loc = r[..., :2] + off / pts * r[..., 2:] * 0.5
            grids = (2 * loc - 1).transpose(1, 2)  # [B, m, Q, L, P, 2]
            samples, a0 = [], 0
            for lvl, (h, w) in enumerate(shapes):
                v = value[:, a0 : a0 + h * w].unflatten(2, (m, d // m)).permute(0, 2, 3, 1)
                v = v.to(torch.float32, memory_format=torch.contiguous_format)
                samples.append(F.grid_sample(v.reshape(b * m, d // m, h, w),
                                             grids[:, :, :, lvl].flatten(0, 1), mode="bilinear",
                                             padding_mode="zeros", align_corners=False))
                a0 += h * w
            s = torch.stack(samples, -2).flatten(-2)  # [B*m, d/m, Q, L*P]
            o = (s * aw.transpose(1, 2).reshape(b * m, 1, nq, lv * pts).float()).sum(-1)
            return self.output_proj(o.view(b, d, nq).transpose(1, 2).to(q.dtype))


class DecoderLayer(nn.Module):
    def __init__(self, spec: RTDetrSpec):
        super().__init__()
        d = spec.d_model
        self.self_attn = MultiheadAttention(d, spec.decoder_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=EPS)
        self.encoder_attn = DeformableAttention(spec)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=EPS)
        self.fc1 = nn.Linear(d, spec.decoder_ffn_dim)
        self.fc2 = nn.Linear(spec.decoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=EPS)

    def forward(self, h, pos, ref, memory, shapes):
        h = self.self_attn_layer_norm(h + self.self_attn(h, pos))
        h = self.encoder_attn_layer_norm(h + self.encoder_attn(h + pos, ref, memory, shapes))
        return self.final_layer_norm(h + self.fc2(F.relu(self.fc1(h))))


class Decoder(nn.Module):
    def __init__(self, spec: RTDetrSpec):
        super().__init__()
        d, n = spec.d_model, spec.decoder_layers
        self.layers = nn.ModuleList(DecoderLayer(spec) for _ in range(n))
        self.query_pos_head = MLP(4, 2 * d, d, 2)
        self.class_embed = nn.ModuleList(nn.Linear(d, spec.num_classes) for _ in range(n))
        self.bbox_embed = nn.ModuleList(MLP(d, d, 4, 3) for _ in range(n))


class RTDetrModel(nn.Module):
    def __init__(self, spec: RTDetrSpec):
        super().__init__()
        d, c = spec.d_model, spec.encoder_hidden_dim
        self.backbone = ConvEncoder(spec)
        self.encoder_input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(ci, c, 1, bias=False), FrozenBatchNorm2d(c))
            for ci in spec.hidden_sizes[1:])
        self.encoder = HybridEncoder(spec)
        self.enc_output = nn.Sequential(nn.Linear(d, d), nn.LayerNorm(d, eps=EPS))
        self.enc_score_head = nn.Linear(d, spec.num_classes)
        self.enc_bbox_head = MLP(d, d, 4, 3)
        self.decoder_input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, d, 1, bias=False), FrozenBatchNorm2d(d))
            for _ in spec.feat_strides)
        self.decoder = Decoder(spec)


class RTDETR(nn.Module):
    """``model(x [B, 3, H, W] RGB in 0..1)`` -> (box, cls), the heads of the
    module docstring, one per level; H and W multiples of 32."""

    def __init__(self, spec: RTDetrSpec):
        super().__init__()
        self.spec = spec
        self.model = RTDetrModel(spec)
        self._size_state: Dict[tuple, tuple] = {}  # built once an input size, on its device

    def _state(self, shapes, device):
        key = (tuple(shapes), str(device))
        if key not in self._size_state:
            anchors, valid = generate_anchors(shapes, device)
            h, w = shapes[-1]
            pos = sincos_position_embedding(h, w, self.spec.encoder_hidden_dim, device)
            self._size_state[key] = (anchors, valid, pos)
        return self._size_state[key]

    def forward(self, x):
        m = self.model
        h, w = x.shape[-2:]
        shapes = [(h // s, w // s) for s in self.spec.feat_strides]
        anchors, valid, pos = self._state(shapes, x.device)
        feats = [p(f) for p, f in zip(m.encoder_input_proj, m.backbone.model(x))]
        feats = m.encoder(feats, pos)
        sources = [p(f) for p, f in zip(m.decoder_input_proj, feats)]
        with span("clip.decoder", device_range=True):
            return self._decode(sources, shapes, anchors[0], valid)

    def _decode(self, sources, shapes, anchors, valid):
        m, spec = self.model, self.spec
        b, dt = sources[0].shape[0], sources[0].dtype
        memory = torch.cat([s.flatten(2).transpose(1, 2) for s in sources], 1)  # [B, A, d]
        a, nq, nc = memory.shape[1], spec.num_queries, spec.num_classes
        count("anchors", a)
        out_mem = m.enc_output(memory * valid.to(dt))
        enc_cls = m.enc_score_head(out_mem)  # [B, A, C]
        enc_box = m.enc_bbox_head(out_mem)  # [B, A, 4]: offsets from the anchors' logits
        idx = torch.topk(enc_cls.amax(-1), nq, dim=1).indices  # [B, Q]
        gather = lambda t: t.gather(1, idx[..., None].expand(-1, -1, t.shape[-1]))  # noqa: E731
        ref = torch.sigmoid(gather(enc_box).float() + anchors[idx])  # float32 [B, Q, 4]
        h = gather(out_mem)
        dec = m.decoder
        for layer, box_head in zip(dec.layers, dec.bbox_embed):
            h = layer(h, dec.query_pos_head(ref.to(dt)), ref, memory, shapes)
            logit, ref = refine(box_head(h), ref)
        cls_q = dec.class_embed[-1](h).float()

        cls_all = memory.new_zeros((b, a, 2 * nc + 1), dtype=torch.float32)
        cls_all[..., :nc] = enc_cls
        cls_all[..., nc:].scatter_(1, idx[..., None].expand(-1, -1, nc + 1),
                                   torch.cat([cls_q, cls_q.new_ones((b, nq, 1))], -1))
        box_all = memory.new_zeros((b, a, 8), dtype=torch.float32)
        box_all[..., :4] = enc_box
        box_all[..., 4:].scatter_(1, idx[..., None].expand(-1, -1, 4), logit)
        box, cls, a0 = [], [], 0
        for lh, lw in shapes:
            box.append(box_all[:, a0 : a0 + lh * lw].transpose(1, 2).unflatten(2, (lh, lw)))
            cls.append(cls_all[:, a0 : a0 + lh * lw].transpose(1, 2).unflatten(2, (lh, lw)))
            a0 += lh * lw
        return box, cls


def build_rtdetr(variant: str = "rtdetr-r101vd", num_classes: int = 80, seed: int = 0,
                 device=None) -> RTDETR:
    """An RT-DETR of `variant` with `num_classes` classes, its weights
    PyTorch's default initialisation drawn from `seed`, in eval mode."""
    spec = dataclasses.replace(VARIANTS_RTDETR[variant], num_classes=num_classes)
    torch.manual_seed(seed)
    model = RTDETR(spec).eval()
    return model.to(resolve_device(device))


def is_rtdetr(variant: str) -> bool:
    return variant in VARIANTS_RTDETR


def state_dict_from_leaves(flat: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """{leaf path 'a/b/c': array} of a checkpoint -> the model's state_dict
    ({'a.b.c': tensor})."""
    return {k.replace("/", "."): torch.as_tensor(v) for k, v in flat.items()}

