"""RT-DETR, plain: the benchmark's reference for the NMS-free transformer
detector (Zhao et al., "DETRs Beat YOLOs on Real-time Object Detection",
CVPR 2024, arXiv:2304.08069) with a ResNet-vd trunk, as the authors'
``rtdetr_pytorch`` and ``transformers``' ``RTDetrForObjectDetection``
compute it at inference (no denoising queries).

The configuration's ``yolo`` block names the variant (``VARIANTS``: the
published widths where they differ from ``RTDetrConfig``'s defaults,
``DEFAULTS``) and ``nc``; a block may also give any width itself.
Parameters are named by ``RTDetrForObjectDetection``'s ``state_dict`` keys
(``params``); a checkpoint's leaf path is the key with ``/`` for ``.``,
read with ``reference/yolo.py``'s reader. Every BatchNorm is frozen (epsilon 1e-5);
LayerNorm's epsilon is 1e-5.

The heads, per level l (A anchors over the levels; the layout
``rtvm_tpu_torch/models/rtdetr/model.py`` returns, written here
independently): box [B, 8, h, w], the encoder's box offsets (logits before
the anchor) and the last decoder layer's refined box logits at each
selected cell; cls [B, 2C + 1, h, w], the encoder's class logits, the last
layer's class logits at the selected cells and the 0/1 selection map.
``detect`` makes its own query selection and NMS-free post-process.

Everything runs in float32 with TF32 off (the caller sets the flags). With
``fp8=True`` every convolution's and Linear's input and weight are rounded
to float8 (e4m3, one scale per tensor) first: the control. Imports nothing
of the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .yolo import _fp8, letterbox, read_npz

DEFAULTS = {"depths": [3, 4, 6, 3], "embedding_size": 64, "hidden_sizes": [256, 512, 1024, 2048],
            "encoder_hidden_dim": 256, "encoder_ffn_dim": 1024, "encoder_heads": 8,
            "d_model": 256, "decoder_in_channels": [256, 256, 256], "decoder_ffn_dim": 1024,
            "decoder_layers": 6, "decoder_heads": 8, "n_points": 4, "num_queries": 300,
            "feat_strides": [8, 16, 32]}
EPS = 1e-5  # BatchNorm's and LayerNorm's
INV_EPS = 1e-5  # inverse_sigmoid's
TEMPERATURE = 10000.0
BF16 = 2  # bytes
# draw: BatchNorm's scale on a residual branch's last BatchNorm and in the
# CCFM; the spreads of the heads (class logits, the encoder's and each
# decoder layer's box offsets) and of the deformable attention's sampling
# offsets and weight logits; the share of the encoder output Linear's bias;
# the queries a calibration frame keeps over conf
BRANCH_GAIN = 0.1
CCFM_GAIN = 0.25
HEAD_STD = 1.0
ENC_BOX_STD = 0.05
DEC_BOX_STD = 0.02
OFFSET_STD = 0.5
ATTN_STD = 1.0
ENC_BIAS_SHARE = 0.01
CANDIDATES = 16


# the published model's widths that differ from DEFAULTS (the authors'
# rtdetr_r101vd_6x_coco.yml against RTDetrConfig, which is rtdetr_r50vd)
VARIANTS = {"rtdetr-r101vd": {"depths": [3, 4, 23, 3], "encoder_hidden_dim": 384,
                              "encoder_ffn_dim": 2048, "decoder_in_channels": [384, 384, 384]}}


def spec(cfg: dict) -> dict:
    """The widths: ``DEFAULTS``, then the variant's, then any the block
    itself gives (a test's smaller model)."""
    s = dict(DEFAULTS, **VARIANTS.get(cfg["variant"], {}))
    s.update({k: cfg[k] for k in DEFAULTS if k in cfg})
    s["nc"] = cfg["nc"]
    return s


def shapes(cfg: dict, hw: Tuple[int, int]) -> List[Tuple[int, int]]:
    return [(hw[0] // st, hw[1] // st) for st in spec(cfg)["feat_strides"]]


# ------------------------------------------------------------- parameters


def params(cfg: dict) -> List[tuple]:
    """Every parameter in a fixed order: (key, shape, kind); kind is "conv"
    (a kernel, OIHW), "w" / "b" (a Linear's weight [out, in] and bias),
    "bn:<gain>" (a frozen BatchNorm's four tensors under the key's
    prefix), "ln" (a LayerNorm's weight and bias)."""
    s = spec(cfg)
    out: List[tuple] = []

    def conv(key, cin, cout, k):
        out.append((f"{key}.weight", (cout, cin, k, k), "conv"))

    def bn(prefix, ch, gain=1.0):
        out.append((prefix, (ch,), f"bn:{gain}"))

    def lin(key, cin, cout):
        out.append((f"{key}.weight", (cout, cin), "w"))
        out.append((f"{key}.bias", (cout,), "b"))

    def ln(key, ch):
        out.append((key, (ch,), "ln"))

    def mlp(key, cin, hid, cout, n):
        dims = [cin] + [hid] * (n - 1)
        for i, (a, b) in enumerate(zip(dims, dims[1:] + [cout])):
            lin(f"{key}.layers.{i}", a, b)

    bb = "model.backbone.model"
    emb = s["embedding_size"]
    for i, (ci, co) in enumerate([(3, emb // 2), (emb // 2, emb // 2), (emb // 2, emb)]):
        conv(f"{bb}.embedder.embedder.{i}.convolution", ci, co, 3)
        bn(f"{bb}.embedder.embedder.{i}.normalization", co)
    ins = [emb] + s["hidden_sizes"][:-1]
    for st, (ci, co, depth) in enumerate(zip(ins, s["hidden_sizes"], s["depths"])):
        for j in range(depth):
            p = f"{bb}.encoder.stages.{st}.layers.{j}"
            cin = ci if j == 0 else co
            if j == 0:
                sc = f"{p}.shortcut.1" if st > 0 else f"{p}.shortcut"
                conv(f"{sc}.convolution", cin, co, 1)
                bn(f"{sc}.normalization", co)
            red = co // 4
            for k, (a, b, kk) in enumerate([(cin, red, 1), (red, red, 3), (red, co, 1)]):
                conv(f"{p}.layer.{k}.convolution", a, b, kk)
                bn(f"{p}.layer.{k}.normalization", b, BRANCH_GAIN if k == 2 else 1.0)
    c, d, nc = s["encoder_hidden_dim"], s["d_model"], s["nc"]
    for i, ci in enumerate(s["hidden_sizes"][1:]):
        conv(f"model.encoder_input_proj.{i}.0", ci, c, 1)
        bn(f"model.encoder_input_proj.{i}.1", c)
    e = "model.encoder.encoder.0.layers.0"
    for n in ("k_proj", "v_proj", "q_proj", "out_proj"):
        lin(f"{e}.self_attn.{n}", c, c)
    ln(f"{e}.self_attn_layer_norm", c)
    lin(f"{e}.fc1", c, s["encoder_ffn_dim"])
    lin(f"{e}.fc2", s["encoder_ffn_dim"], c)
    ln(f"{e}.final_layer_norm", c)

    def cn(key, cin, cout, k):
        conv(f"{key}.conv", cin, cout, k)
        bn(f"{key}.norm", cout, CCFM_GAIN)

    def csp(key):
        cn(f"{key}.conv1", 2 * c, c, 1)
        cn(f"{key}.conv2", 2 * c, c, 1)
        for j in range(3):
            cn(f"{key}.bottlenecks.{j}.conv1", c, c, 3)
            cn(f"{key}.bottlenecks.{j}.conv2", c, c, 1)

    for i in range(2):
        cn(f"model.encoder.lateral_convs.{i}", c, c, 1)
        csp(f"model.encoder.fpn_blocks.{i}")
    for i in range(2):
        cn(f"model.encoder.downsample_convs.{i}", c, c, 3)
        csp(f"model.encoder.pan_blocks.{i}")
    lin("model.enc_output.0", d, d)
    ln("model.enc_output.1", d)
    lin("model.enc_score_head", d, nc)
    mlp("model.enc_bbox_head", d, d, 4, 3)
    for i, ci in enumerate(s["decoder_in_channels"]):
        conv(f"model.decoder_input_proj.{i}.0", ci, d, 1)
        bn(f"model.decoder_input_proj.{i}.1", d)
    m, lv, pts, ffn = s["decoder_heads"], 3, s["n_points"], s["decoder_ffn_dim"]
    for i in range(s["decoder_layers"]):
        p = f"model.decoder.layers.{i}"
        for n in ("k_proj", "v_proj", "q_proj", "out_proj"):
            lin(f"{p}.self_attn.{n}", d, d)
        ln(f"{p}.self_attn_layer_norm", d)
        lin(f"{p}.encoder_attn.sampling_offsets", d, m * lv * pts * 2)
        lin(f"{p}.encoder_attn.attention_weights", d, m * lv * pts)
        lin(f"{p}.encoder_attn.value_proj", d, d)
        lin(f"{p}.encoder_attn.output_proj", d, d)
        ln(f"{p}.encoder_attn_layer_norm", d)
        lin(f"{p}.fc1", d, ffn)
        lin(f"{p}.fc2", ffn, d)
        ln(f"{p}.final_layer_norm", d)
    mlp("model.decoder.query_pos_head", 4, 2 * d, d, 2)
    for i in range(s["decoder_layers"]):
        lin(f"model.decoder.class_embed.{i}", d, nc)
    for i in range(s["decoder_layers"]):
        mlp(f"model.decoder.bbox_embed.{i}", d, d, 4, 3)
    return out


# ------------------------------------------------------------------ weights


class Weights:
    """The checkpoint's tensors on a device, by ``state_dict`` key."""

    def __init__(self, flat: Dict[str, np.ndarray], device, fp8: bool = False):
        self.t = {k.replace("/", "."): torch.from_numpy(v).to(device) for k, v in flat.items()}
        self.fp8 = fp8

    def conv(self, x, key: str, stride: int = 1):
        k = self.t[f"{key}.weight"]
        if self.fp8:
            x, k = _fp8(x), _fp8(k)
        return F.conv2d(x, k, None, stride, k.shape[-1] // 2)

    def bn(self, y, p: str):
        mean, var = self.t[f"{p}.running_mean"], self.t[f"{p}.running_var"]
        w, b = self.t[f"{p}.weight"], self.t[f"{p}.bias"]
        y = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + EPS)
        return y * w[:, None, None] + b[:, None, None]

    def linear(self, x, key: str):
        w, b = self.t[f"{key}.weight"], self.t[f"{key}.bias"]
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return x @ w.T + b

    def ln(self, x, key: str):
        return F.layer_norm(x, x.shape[-1:], self.t[f"{key}.weight"], self.t[f"{key}.bias"], EPS)

    # what the draw sets on its pass (``_Calibrating``); here plain Linears
    def head(self, x, key: str, std: float):
        """A head whose output the draw spreads by `std`."""
        return self.linear(x, key)

    def offsets(self, x, key: str):
        return self.linear(x, key)

    def attn_logits(self, x, key: str):
        return self.linear(x, key)

    def selection(self, enc_cls, valid) -> None:
        """The draw's check of the encoder's class logits."""


def _mlp(w: Weights, x, key: str, n: int, std: float = None):
    for i in range(n):
        x = w.linear(x, f"{key}.layers.{i}") if i < n - 1 or std is None \
            else w.head(x, f"{key}.layers.{i}", std)
        if i < n - 1:
            x = F.relu(x)
    return x


def inverse_sigmoid(x):
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=INV_EPS) / (1 - x).clamp(min=INV_EPS))


def anchors(hw_levels: List[Tuple[int, int]], device):
    """(anchor logits [A, 4] with the largest float32 where invalid, valid
    [A]): cell centres, side 0.05 * 2^level, valid inside (0.01, 0.99)."""
    out = []
    for lvl, (h, wd) in enumerate(hw_levels):
        ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                                torch.arange(wd, device=device, dtype=torch.float32),
                                indexing="ij")
        a = torch.stack([(xs + 0.5) / wd, (ys + 0.5) / h, torch.full_like(xs, 0.05 * 2 ** lvl),
                         torch.full_like(xs, 0.05 * 2 ** lvl)], -1)
        out.append(a.reshape(-1, 4))
    a = torch.cat(out)
    valid = ((a > 0.01) & (a < 0.99)).all(-1)
    logit = torch.log(a / (1 - a))
    return torch.where(valid[:, None], logit, torch.finfo(torch.float32).max), valid


def pos_embed(h: int, wd: int, dim: int, device):
    """AIFI's sin-cos embedding [h * w, dim]; token k (row-major) takes the
    column k // h and the row k % h, as the authors' meshgrid lays it."""
    k = torch.arange(h * wd, device=device)
    col, row = (k // h).to(torch.float32), (k % h).to(torch.float32)
    pd = dim // 4
    omega = 1.0 / TEMPERATURE ** (torch.arange(pd, device=device, dtype=torch.float32) / pd)
    a, b = col[:, None] * omega, row[:, None] * omega
    return torch.cat([a.sin(), a.cos(), b.sin(), b.cos()], 1)


def _mha(w: Weights, h, pos, key: str, heads: int):
    b, n, d = h.shape
    q = w.linear(h + pos, f"{key}.q_proj").view(b, n, heads, -1).transpose(1, 2)
    k = w.linear(h + pos, f"{key}.k_proj").view(b, n, heads, -1).transpose(1, 2)
    v = w.linear(h, f"{key}.v_proj").view(b, n, heads, -1).transpose(1, 2)
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // heads), -1)
    return w.linear((a @ v).transpose(1, 2).reshape(b, n, d), f"{key}.out_proj")


# ------------------------------------------------------------ architecture


def _resnet(w: Weights, s: dict, x) -> List[torch.Tensor]:
    bb = "model.backbone.model"
    for i, st in enumerate((2, 1, 1)):
        p = f"{bb}.embedder.embedder.{i}"
        x = F.relu(w.bn(w.conv(x, f"{p}.convolution", st), f"{p}.normalization"))
    x = F.max_pool2d(x, 3, 2, 1)
    outs = []
    for stg, depth in enumerate(s["depths"]):
        for j in range(depth):
            p = f"{bb}.encoder.stages.{stg}.layers.{j}"
            stride = 2 if (j == 0 and stg > 0) else 1
            y = x
            for k in range(3):
                q = f"{p}.layer.{k}"
                y = w.bn(w.conv(y, f"{q}.convolution", stride if k == 1 else 1),
                         f"{q}.normalization")
                if k < 2:
                    y = F.relu(y)
            if j == 0 and stg > 0:
                sc = F.avg_pool2d(x, 2, 2, 0, ceil_mode=True)
                sc = w.bn(w.conv(sc, f"{p}.shortcut.1.convolution"),
                          f"{p}.shortcut.1.normalization")
            elif j == 0:
                sc = w.bn(w.conv(x, f"{p}.shortcut.convolution"), f"{p}.shortcut.normalization")
            else:
                sc = x
            x = F.relu(y + sc)
        if stg >= 1:
            outs.append(x)
    return outs


def _cn(w: Weights, x, key: str, stride: int = 1, act: bool = True):
    y = w.bn(w.conv(x, f"{key}.conv", stride), f"{key}.norm")
    return F.silu(y) if act else y


def _csp(w: Weights, x, key: str):
    a = _cn(w, x, f"{key}.conv1")
    for j in range(3):
        p = f"{key}.bottlenecks.{j}"
        a = F.silu(_cn(w, a, f"{p}.conv1", act=False) + _cn(w, a, f"{p}.conv2", act=False))
    return a + _cn(w, x, f"{key}.conv2")


def _encoder(w: Weights, s: dict, feats: List[torch.Tensor]) -> List[torch.Tensor]:
    p = [w.bn(w.conv(f, f"model.encoder_input_proj.{i}.0"), f"model.encoder_input_proj.{i}.1")
         for i, f in enumerate(feats)]
    b, c, h, wd = p[2].shape
    t = p[2].flatten(2).transpose(1, 2)
    e = "model.encoder.encoder.0.layers.0"
    t = w.ln(t + _mha(w, t, pos_embed(h, wd, c, t.device), f"{e}.self_attn", s["encoder_heads"]),
             f"{e}.self_attn_layer_norm")
    ff = w.linear(F.gelu(w.linear(t, f"{e}.fc1")), f"{e}.fc2")
    p[2] = w.ln(t + ff, f"{e}.final_layer_norm").transpose(1, 2).reshape(b, c, h, wd)
    top = _cn(w, p[2], "model.encoder.lateral_convs.0")  # FPN, stride 32 -> 16
    f4 = _csp(w, torch.cat([F.interpolate(top, scale_factor=2.0, mode="nearest"), p[1]], 1),
              "model.encoder.fpn_blocks.0")
    top4 = _cn(w, f4, "model.encoder.lateral_convs.1")  # 16 -> 8
    f3 = _csp(w, torch.cat([F.interpolate(top4, scale_factor=2.0, mode="nearest"), p[0]], 1),
              "model.encoder.fpn_blocks.1")
    o4 = _csp(w, torch.cat([_cn(w, f3, "model.encoder.downsample_convs.0", 2), top4], 1),
              "model.encoder.pan_blocks.0")  # PAN, 8 -> 16
    o5 = _csp(w, torch.cat([_cn(w, o4, "model.encoder.downsample_convs.1", 2), top], 1),
              "model.encoder.pan_blocks.1")  # 16 -> 32
    return [f3, o4, o5]


def _deform(w: Weights, s: dict, q, ref, memory, lv_shapes, key: str):
    """Multi-scale deformable attention, written per level with
    ``grid_sample`` (bilinear, zeros, ``align_corners=False``)."""
    b, nq, d = q.shape
    m, pts, lv = s["decoder_heads"], s["n_points"], len(lv_shapes)
    value = w.linear(memory, f"{key}.value_proj")
    off = w.offsets(q, f"{key}.sampling_offsets").view(b, nq, m, lv, pts, 2)
    aw = torch.softmax(w.attn_logits(q, f"{key}.attention_weights").view(b, nq, m, lv * pts), -1)
    loc = ref[:, :, None, None, None, :2] + off / pts * ref[:, :, None, None, None, 2:] * 0.5
    out = torch.zeros(b, m, d // m, nq, device=q.device)
    a0 = 0
    for lvl, (h, wd) in enumerate(lv_shapes):
        v = value[:, a0 : a0 + h * wd].reshape(b, h, wd, m, d // m).permute(0, 3, 4, 1, 2)
        g = 2 * loc[:, :, :, lvl] - 1  # [B, Q, m, P, 2]
        smp = F.grid_sample(v.reshape(b * m, d // m, h, wd), g.permute(0, 2, 1, 3, 4).reshape(
            b * m, nq, pts, 2), mode="bilinear", padding_mode="zeros", align_corners=False)
        wt = aw.view(b, nq, m, lv, pts)[:, :, :, lvl].permute(0, 2, 1, 3)  # [B, m, Q, P]
        out += (smp.view(b, m, d // m, nq, pts) * wt[:, :, None]).sum(-1)
        a0 += h * wd
    return w.linear(out.reshape(b, d, nq).transpose(1, 2), f"{key}.output_proj")


def forward(w: Weights, cfg: dict, x: torch.Tensor):
    """x [B, 3, H, W] RGB in 0..1 (H, W multiples of 32) -> the heads (box
    per level, cls per level) and, for ``detect``, the selection (indices
    [B, Q] into the A anchors, refined box logits [B, Q, 4], class logits
    [B, Q, C])."""
    s = spec(cfg)
    nc, nq, d = s["nc"], s["num_queries"], s["d_model"]
    lv_shapes = shapes(cfg, x.shape[-2:])
    feats = _encoder(w, s, _resnet(w, s, x))
    src = [w.bn(w.conv(f, f"model.decoder_input_proj.{i}.0"), f"model.decoder_input_proj.{i}.1")
           for i, f in enumerate(feats)]
    memory = torch.cat([t.flatten(2).transpose(1, 2) for t in src], 1)
    anc, valid = anchors(lv_shapes, x.device)
    out_mem = w.ln(w.linear(memory * valid[None, :, None], "model.enc_output.0"),
                   "model.enc_output.1")
    enc_cls = w.head(out_mem, "model.enc_score_head", HEAD_STD)
    enc_box = _mlp(w, out_mem, "model.enc_bbox_head", 3, ENC_BOX_STD)
    w.selection(enc_cls, valid)
    idx = enc_cls.max(-1).values.topk(nq, dim=1).indices
    pick = lambda t: torch.stack([t[i, idx[i]] for i in range(len(t))])  # noqa: E731
    ref = torch.sigmoid(pick(enc_box) + anc[idx])
    h = pick(out_mem)
    for i in range(s["decoder_layers"]):
        p = f"model.decoder.layers.{i}"
        pos = _mlp(w, ref, "model.decoder.query_pos_head", 2)
        h = w.ln(h + _mha(w, h, pos, f"{p}.self_attn", s["decoder_heads"]),
                 f"{p}.self_attn_layer_norm")
        h = w.ln(h + _deform(w, s, h + pos, ref, memory, lv_shapes, f"{p}.encoder_attn"),
                 f"{p}.encoder_attn_layer_norm")
        h = w.ln(h + w.linear(F.relu(w.linear(h, f"{p}.fc1")), f"{p}.fc2"),
                 f"{p}.final_layer_norm")
        logit = _mlp(w, h, f"model.decoder.bbox_embed.{i}", 3, DEC_BOX_STD) + inverse_sigmoid(ref)
        ref = torch.sigmoid(logit)
    cls_q = w.head(h, f"model.decoder.class_embed.{s['decoder_layers'] - 1}", HEAD_STD)

    return layout(enc_box, enc_cls, idx, logit, cls_q, lv_shapes), (idx, logit, cls_q)


def layout(enc_box, enc_cls, idx, logit, cls_q, lv_shapes):
    """The heads of the module docstring from the encoder's outputs over the
    A anchors ([B, A, 4], [B, A, C]) and the selected queries (anchor
    indices [B, Q], refined box logits [B, Q, 4], class logits [B, Q, C]):
    each query's outputs go to its anchor's cell, whatever their order."""
    b, a, nc = enc_cls.shape
    box_all = torch.zeros(b, a, 8, device=enc_cls.device)
    cls_all = torch.zeros(b, a, 2 * nc + 1, device=enc_cls.device)
    box_all[..., :4] = enc_box
    cls_all[..., :nc] = enc_cls
    for i in range(b):
        box_all[i, idx[i], 4:] = logit[i]
        cls_all[i, idx[i], nc : 2 * nc] = cls_q[i]
        cls_all[i, idx[i], 2 * nc] = 1.0
    box, cls, a0 = [], [], 0
    for h_, w_ in lv_shapes:
        box.append(box_all[:, a0 : a0 + h_ * w_].permute(0, 2, 1).reshape(b, 8, h_, w_))
        cls.append(cls_all[:, a0 : a0 + h_ * w_].permute(0, 2, 1).reshape(b, 2 * nc + 1, h_, w_))
        a0 += h_ * w_
    return box, cls


# ---------------------------------------------------------------- interface


def load(checkpoint_path: str, cfg: dict, device, fp8: bool = False) -> Weights:
    """The checkpoint's weights on `device`; with fp8, for the control."""
    return Weights(read_npz(checkpoint_path), device, fp8=fp8)


def heads(w: Weights, cfg: dict, frames_bgr: torch.Tensor, imgsz):
    """Frames [B, H, W, 3] BGR uint8 -> ((box, cls) per level, (scale, pad_y,
    pad_x)), through the reference's own letterbox."""
    x, scale, py, px = letterbox(frames_bgr, imgsz)
    with torch.no_grad():
        return forward(w, cfg, x)[0], (scale, py, px)


def detect(w: Weights, cfg: dict, frames_bgr: torch.Tensor, imgsz, conf: float, iou: float):
    """Frames [B, H, W, 3] BGR uint8 -> (per-frame detections in frame
    pixels, (box, cls)): one a selected query, its largest class's sigmoid
    over conf; ``iou`` plays no part (no NMS)."""
    th, tw = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    x, scale, py, px = letterbox(frames_bgr, imgsz)
    with torch.no_grad():
        heads_, (_, logit, cls_q) = forward(w, cfg, x)
    box = torch.sigmoid(logit).cpu().numpy().astype(np.float64)  # [B, Q, 4] cx cy w h
    prob = torch.sigmoid(cls_q).cpu().numpy()
    out = []
    for i in range(len(box)):
        dets = []
        for q in range(box.shape[1]):
            k = int(prob[i, q].argmax())
            if prob[i, q, k] > conf:
                cx, cy, bw, bh = box[i, q]
                xyxy = np.array([(cx - bw / 2) * tw - px, (cy - bh / 2) * th - py,
                                 (cx + bw / 2) * tw - px, (cy + bh / 2) * th - py]) / scale
                dets.append({"box": xyxy, "score": float(prob[i, q, k]), "cls": k})
        out.append(dets)
    return out, heads_


def _linear_flops(s: dict, a: int) -> Tuple[float, float, float]:
    """Multiply-adds of the selection (over a anchors) and of one decoder
    layer's parts: (selection, layer without value projection, value
    projection)."""
    d, nq, nc, m, pts = s["d_model"], s["num_queries"], s["nc"], s["decoder_heads"], s["n_points"]
    sel = a * (d * d + d * nc + 2 * d * d + 4 * d)
    layer = nq * (4 * 2 * d + 2 * d * d)  # the query position MLP
    layer += nq * 4 * d * d + 2 * nq * nq * d  # self-attention
    layer += nq * d * m * 3 * pts * 3 + nq * m * 3 * pts * (d // m) * 5 + nq * d * d  # deformable
    layer += 2 * nq * d * s["decoder_ffn_dim"] + nq * (2 * d * d + 4 * d)  # FFN, box head
    return sel, layer, a * d * d


def flops(cfg: dict, hw: Tuple[int, int]) -> float:
    """Model FLOPs of one frame at the letterboxed input hw (rows, cols): 2 x
    the multiply-adds of every convolution (at its output size), of AIFI
    (its four projections, q k^T and the weighted sum, its FFN), of the
    selection's Linears over every anchor, and of each decoder layer (the
    query position MLP, self-attention, the deformable attention's four
    Linears, its bilinear taps (4 a point and channel) and their weighting,
    the FFN, the box head), and of the last layer's class head."""
    s = spec(cfg)
    h, wd = hw
    macs = 0
    sizes = {}  # output rows, cols by the stride of each convolution's output
    for key, shape, kind in params(cfg):
        if kind != "conv":
            continue
        cout, cin, k, _ = shape
        st = _conv_stride(key, s)
        sizes[key] = st
        macs += cout * cin * k * k * (h // st) * (wd // st)
    c, n = s["encoder_hidden_dim"], (h // 32) * (wd // 32)
    macs += 4 * n * c * c + 2 * n * n * c + 2 * n * c * s["encoder_ffn_dim"]
    a = sum(x * y for x, y in shapes(cfg, hw))
    sel, layer, value = _linear_flops(s, a)
    macs += sel + s["decoder_layers"] * (layer + value) + s["num_queries"] * s["d_model"] * s["nc"]
    return 2.0 * macs


def _conv_stride(key: str, s: dict) -> int:
    """The stride (to the input) of a convolution's output, from its key."""
    if ".embedder.embedder." in key:
        return 2
    if ".stages." in key:
        stg = int(key.split(".stages.")[1].split(".")[0])
        st = 4 * 2 ** stg
        first = ".layers.0." in key
        if first and stg > 0 and (".layer.0." in key):
            return st // 2  # the 1x1 before the strided 3x3
        return st
    if "encoder_input_proj" in key or "decoder_input_proj" in key:
        return (8, 16, 32)[int(key.split("proj.")[1].split(".")[0])]
    if "lateral_convs" in key:
        return (32, 16)[int(key.split("lateral_convs.")[1].split(".")[0])]
    if "fpn_blocks" in key:
        return (16, 8)[int(key.split("fpn_blocks.")[1].split(".")[0])]
    if "downsample_convs" in key:
        return (16, 32)[int(key.split("downsample_convs.")[1].split(".")[0])]
    if "pan_blocks" in key:
        return (16, 32)[int(key.split("pan_blocks.")[1].split(".")[0])]
    raise KeyError(key)


def deform_work(cfg: dict, hw: Tuple[int, int], frames: int = 1) -> Tuple[float, float]:
    """(bytes, FLOPs) of the decoder's deformable cross-attention calls on
    `frames` frames at the letterboxed input hw. Bytes: the least each call
    must move in bf16, each input byte read once and each output byte
    written once: the memory (A x d), the value projection's input, read;
    the queries (Q x d) read; their sampling offsets and weights (Q x heads
    x levels x points x 3) once; the four Linears' weights and biases; the
    output (Q x d) written. The value map is not counted: sampling and
    weighting are linear, so sampling the memory and then projecting gives
    the same output without it. FLOPs: 2 x the multiply-adds of the four
    Linears, the bilinear taps and their weighting (``flops``' count of
    them), as the call computes them; at 768x1280 their time at the bf16
    peak is under the bytes' time at the HBM bandwidth."""
    s = spec(cfg)
    d, nq, m, pts = s["d_model"], s["num_queries"], s["decoder_heads"], s["n_points"]
    a = sum(x * y for x, y in shapes(cfg, hw))
    ow = nq * m * 3 * pts * 3
    per = frames * (a * d + nq * d + ow + nq * d)
    per += (d * d + d) + (d * m * 3 * pts * 3 + m * 3 * pts * 3) + (d * d + d)
    macs = frames * (a * d * d + nq * d * m * 3 * pts * 3 + nq * m * 3 * pts * (d // m) * 5
                     + nq * d * d)
    n = s["decoder_layers"]
    return float(n * per * BF16), 2.0 * n * macs


# ------------------------------------------------------------------- draw


class _Calibrating(Weights):
    """Weights that set, on the way through one float32 pass, what ``draw``
    says: each BatchNorm's statistics from its input, the heads' and the
    deformable attention's spreads, and the selection's check."""

    def bn(self, y, p: str):
        ms = y.square().mean((0, 2, 3))
        self.t[f"{p}.running_mean"] = y.mean((0, 2, 3))
        self.t[f"{p}.running_var"] = torch.maximum(ms, ms.median())
        return super().bn(y, p)

    def _spread(self, x, key: str, std: float, with_bias: bool):
        z = x @ self.t[f"{key}.weight"].T
        s = std / float(z.std())
        self.t[f"{key}.weight"] = self.t[f"{key}.weight"] * s
        if with_bias:
            self.t[f"{key}.bias"] = self.t[f"{key}.bias"] * s
        return self.linear(x, key)

    def head(self, x, key: str, std: float):
        return self._spread(x, key, std, True)

    def offsets(self, x, key: str):
        return self._spread(x, key, OFFSET_STD, False)

    def attn_logits(self, x, key: str):
        return self._spread(x, key, ATTN_STD, False)

    def selection(self, enc_cls, valid):
        """The invalid anchors (all one memory row: their logits tie) must
        rank under every frame's selected ones."""
        best = enc_cls.max(-1).values
        nq = spec(self.cfg)["num_queries"]
        low = float(best[:, valid].topk(nq, dim=1).values[:, -1].min())
        if (~valid).any() and float(best[:, ~valid].max()) >= low:
            raise RuntimeError("the invalid anchors' class logit reaches the selection")


def draw(cfg: dict, seed: int, frames_bgr: torch.Tensor, imgsz) -> Dict[str, np.ndarray]:
    """{leaf path: float32 array} of a checkpoint drawn from `seed` on the
    device of `frames_bgr`, named and shaped as the port's (``params``): a
    random model whose detections vary over the traffic as a trained one's
    do. As ``reference/yolo.py:draw``: every convolution's and Linear's
    weight, and every Linear's bias, is uniform in +-1/sqrt(fan_in)
    (PyTorch's default), one draw of a ``torch.Generator`` on that device
    carved in ``params`` order; LayerNorm is 1 and 0. Then one float32 pass
    over `frames_bgr` letterboxed to imgsz (``_Calibrating``) sets the rest:
    - every BatchNorm, the frozen trunk's too, takes its input's mean and
      mean square, floored at the layer's median channel's; scale 1 with
      shift 0, but BRANCH_GAIN on each bottleneck's last BatchNorm (a
      residual branch: at 0.25 the 23 blocks of stage 3 grew bf16's gap to
      float32 from 4% to 13% and the stride-32 map's to 19%, at 0.1 to 4%
      and 5%) and CCFM_GAIN in the CCFM, whose SiLU blocks then stay near
      their linear range (``reference/yolo.py:draw`` says why);
    - the encoder's class head and the last decoder layer's spread their
      logits by HEAD_STD, the encoder's box head its offsets by
      ENC_BOX_STD and each decoder layer's box head by DEC_BOX_STD (weight
      and bias scaled): boxes stay inside the image and near their anchors'
      sizes (the authors' init zeroes the box heads' last Linear, which
      would leave every refinement 0). The spreads are small because a box
      lives in logit space: at mid-image a centre moves 0.25 x 1280 px a
      unit of logit, so offsets spread by 0.25 and 0.1 carried bf16's
      rounding (some 4% of each offset) to several pixels, and 40% of the
      detections missed the check's IoU 0.9 (median IoU 0.91); at 0.05 and
      0.02 the median is 0.98 (PERF.md);
    - each deformable attention's sampling offsets spread by OFFSET_STD
      about the authors' fixed pattern (their bias: head m's points along
      the angle 2 pi m / heads, 1..n_points half-box quarters out) and its
      weight logits by ATTN_STD (the authors zero both weights: every
      point would sit still and weigh the same), so the points move with
      the query;
    - the encoder output Linear's bias is ENC_BIAS_SHARE of its draw: the
      invalid anchors' memory is 0, so their logits are those of that bias
      alone, one value tied over hundreds of anchors; a full bias would be
      a typical logit, in the selection on some frames, where its ties
      make the top-k's choice arbitrary (``_Calibrating.selection``
      raises if one still ranks there);
    - the last class head's bias is then lifted by logit(conf) minus the
      least, over the frames, of each frame's CANDIDATES-th largest query
      logit (plus 1e-4), so every frame keeps CANDIDATES queries or more
      over the configuration's ``conf``."""
    dev = frames_bgr.device
    s = spec(cfg)
    specs = params(cfg)
    drawn = [(key, shape, kind) for key, shape, kind in specs if kind in ("conv", "w", "b")]
    sizes = [int(np.prod(shape)) for _, shape, _ in drawn]
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=dev).mul_(2).sub_(1)
    t: Dict[str, torch.Tensor] = {}
    fan = {}
    at = 0
    for (key, shape, kind), n in zip(drawn, sizes):
        if kind == "b":
            fan_in = fan[key[: -len(".bias")]]
        else:
            fan_in = int(np.prod(shape[1:]))
            fan[key[: -len(".weight")]] = fan_in
        t[key] = u[at : at + n].reshape(shape) / math.sqrt(fan_in)
        at += n
    del u
    for key, shape, kind in specs:
        if kind.startswith("bn:"):
            t[f"{key}.weight"] = torch.full(shape, float(kind[3:]), device=dev)
            t[f"{key}.bias"] = torch.zeros(shape, device=dev)
        elif kind == "ln":
            t[f"{key}.weight"] = torch.ones(shape, device=dev)
            t[f"{key}.bias"] = torch.zeros(shape, device=dev)
    t["model.enc_output.0.bias"] *= ENC_BIAS_SHARE
    m, pts = s["decoder_heads"], s["n_points"]
    theta = torch.arange(m, dtype=torch.float32) * (2.0 * math.pi / m)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = (grid / grid.abs().max(-1, keepdim=True).values)[:, None, None].repeat(1, 3, pts, 1)
    grid = grid * torch.arange(1, pts + 1, dtype=torch.float32)[None, None, :, None]
    for i in range(s["decoder_layers"]):
        t[f"model.decoder.layers.{i}.encoder_attn.sampling_offsets.bias"] = grid.flatten().to(dev)
    w = _Calibrating({}, dev)
    w.t, w.cfg = t, cfg
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            _, (_, _, cls_q) = forward(w, cfg, letterbox(frames_bgr, imgsz)[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    kth = cls_q.max(-1).values.topk(CANDIDATES, dim=1).values[:, -1]
    conf = cfg["conf"]
    last = f"model.decoder.class_embed.{s['decoder_layers'] - 1}.bias"
    t[last] = t[last] + (math.log(conf / (1 - conf)) - float(kth.min()) + 1e-4)
    return {k.replace(".", "/"): v.cpu().numpy() for k, v in t.items()}
