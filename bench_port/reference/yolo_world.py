"""YOLOv8-Worldv2 detection, plain: the benchmark's reference for the
open-vocabulary detector (YOLO-World, Cheng et al., CVPR 2024), as
Ultralytics' ``yolov8-worldv2.yaml`` wires it.

The trunk is YOLOv8's (``reference/yolo.py``: Conv, C2f, SPPF; the channel
and depth rules of the configuration's ``depth_multiple``,
``width_multiple`` and ``max_channels``); each of the neck's four C2f is a
``C2fAttn``: C2f with one more branch, the text-guided attention of the
last bottleneck's output, so its closing 1x1 takes (3 + n) * c channels.
The attention (``MaxSigmoidAttnBlock`` with c1 = c2 = ec, which builds no
``ec`` convolution): g = Linear(512 -> c)(text) viewed as [K, heads, c /
heads]; per head m and pixel, aw = sigmoid(max over k of x[m] . g[k, m] /
sqrt(c / heads) + bias[m]); out = ConvBn3x3(x) * aw, head by head. The
heads are ``parse_model``'s: the yaml's (8, 4, 8, 16), capped at
max_channels // 64, times the width. The head is ``WorldDetect(nc, 512,
with_bn=True)``: YOLOv8's DFL box branch, and a class branch ConvBnSiLU 3x3,
ConvBnSiLU 3x3, Conv 1x1 to 512 into a ``BNContrastiveHead``: BatchNorm(e)
dotted with the L2-normalised text embeddings, times exp(logit_scale), plus
one bias. The text embeddings [K, 512] are the checkpoint's
``params/txt_feats``, as Ultralytics keeps them after ``set_classes``.

Module names are those of the port's checkpoint (``C2fAttn_n``,
``MaxSigmoidAttnBlock_0`` with ``Dense_0``, ``bias`` and ``ConvBn_0``,
``WorldDetectHead_0`` with ``BNContrastiveHead_n``); the reader, the
letterbox, the decode and the NMS are ``reference/yolo.py``'s. BatchNorm's
epsilon is 1e-3, the checkpoint format's, in the contrastive head too
(Ultralytics' BatchNorm2d there takes 1e-5).

Everything runs in float32 with TF32 off (the caller sets the flags). With
``fp8=True`` every convolution's, the Linear's and both einsums' operands
are rounded to float8 (e4m3, one scale per tensor) first: the control. Imports
nothing of the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import yolo as v8
from .yolo import (BN_EPS, BOX_SLOPE, BOX_STD, BRANCH_GAIN, CANDIDATES, HEAD_STD, _c2f, _div8,
                   _fp8, _sppf, _up, channels, decode, letterbox, nms, read_npz, repeats)

TEXT_DIM = 512  # CLIP ViT-B/32's text embeddings: WorldDetect's embed, C2fAttn's gc
ATTN_HEADS = (8, 4, 8, 16)  # the yaml's heads of the neck's C2fAttn (n4, n3, m4, m5)
ATTN_EC = (256, 128, 256, 512)  # and their embed channels
# draw: the BatchNorm scale (reference/yolo.py's is 0.25, which the gated
# neck turns chaotic on some frames) and the spread of each attention
# block's pre-sigmoid logit
BN_GAIN = 0.2
ATTN_STD = 1.0
BF16 = 2  # bytes


# ------------------------------------------------------------- architecture


def attn_heads(cfg: dict) -> List[int]:
    """Heads of the four C2fAttn blocks, as Ultralytics' ``parse_model``
    sets them; raises where a block's embed channels differ from its own
    (Ultralytics would add an ``ec`` convolution, which no scale of the
    yaml has)."""
    w, mc = cfg["width_multiple"], cfg["max_channels"]
    ch = channels(cfg)
    hidden = (ch[512] // 2, ch[256] // 2, ch[512] // 2, ch[1024] // 2)
    out = []
    for nh, ec, c in zip(ATTN_HEADS, ATTN_EC, hidden):
        if _div8(min(ec, mc // 2) * w) != c:
            raise ValueError(f"embed channels {_div8(min(ec, mc // 2) * w)} != {c}")
        out.append(int(max(round(min(nh, mc // 2 // 32)) * w, 1)))
    return out


class Weights(v8.Weights):
    """``reference/yolo.py``'s weights, with a Linear, a BatchNorm alone, an
    einsum (each in fp8 for the control) and the attention's logit."""

    def dense(self, x, path: str):
        k, b = self.t[f"params/{path}/kernel"], self.t[f"params/{path}/bias"]  # [in, out]
        if self.fp8:
            x, k = _fp8(x), _fp8(k)
        return x @ k + b

    def einsum(self, eq: str, a, b):
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return torch.einsum(eq, a, b)

    def bn(self, y, p: str):
        mean, var = self.t[f"batch_stats/{p}/mean"], self.t[f"batch_stats/{p}/var"]
        scale, shift = self.t[f"params/{p}/scale"], self.t[f"params/{p}/bias"]
        y = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS)
        return y * scale[:, None, None] + shift[:, None, None]

    def attn_logit(self, z, path: str):
        """z [B, heads, H, W], the largest scaled dot product, plus the bias."""
        return z + self.t[f"params/{path}/bias"][:, None, None]


def _attn(w: Weights, x, path: str, text, heads: int):
    b, c, h, wd = x.shape
    hc = c // heads
    g = w.dense(text, f"{path}/Dense_0").reshape(-1, heads, hc)
    z = w.einsum("bmjhw,kmj->bmhwk", x.reshape(b, heads, hc, h, wd), g).amax(-1) / math.sqrt(hc)
    aw = torch.sigmoid(w.attn_logit(z, path))
    y = w.cbs(x, f"{path}/ConvBn_0", act=False).reshape(b, heads, hc, h, wd) * aw[:, :, None]
    return y.reshape(b, c, h, wd)


def _c2f_attn(w: Weights, x, path: str, n: int, text, heads: int):
    y = w.cbs(x, f"{path}/ConvBnSiLU_0")
    outs = list(y.chunk(2, dim=1))
    for i in range(n):
        outs.append(w.cbs(w.cbs(outs[-1], f"{path}/Bottleneck_{i}/ConvBnSiLU_0"),
                          f"{path}/Bottleneck_{i}/ConvBnSiLU_1"))
    outs.append(_attn(w, outs[-1], f"{path}/MaxSigmoidAttnBlock_0", text, heads))
    return w.cbs(torch.cat(outs, 1), f"{path}/ConvBnSiLU_1")


def _contrast(w: Weights, e, text, path: str):
    t = text / text.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    s = w.einsum("bchw,kc->bkhw", w.bn(e, f"{path}/BatchNorm_0"), t)
    return s * torch.exp(w.t[f"params/{path}/logit_scale"]) + w.t[f"params/{path}/bias"]


def forward(w: Weights, cfg: dict,
            x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """x [B, 3, H, W] RGB in 0..1 -> (box logits, class logits), one NCHW
    tensor per stride, as ``yolov8-worldv2.yaml`` wires the layers."""
    d = lambda n: repeats(cfg, n)  # noqa: E731
    text = w.t["params/txt_feats"]
    nh = attn_heads(cfg)
    x = w.cbs(x, "ConvBnSiLU_0", 2)  # 0
    x = w.cbs(x, "ConvBnSiLU_1", 2)  # 1
    x = _c2f(w, x, "C2f_0", d(3), True)  # 2
    x = w.cbs(x, "ConvBnSiLU_2", 2)  # 3
    p3 = _c2f(w, x, "C2f_1", d(6), True)  # 4
    x = w.cbs(p3, "ConvBnSiLU_3", 2)  # 5
    p4 = _c2f(w, x, "C2f_2", d(6), True)  # 6
    x = w.cbs(p4, "ConvBnSiLU_4", 2)  # 7
    x = _c2f(w, x, "C2f_3", d(3), True)  # 8
    p5 = _sppf(w, x, "SPPF_0")  # 9
    n4 = _c2f_attn(w, torch.cat([_up(p5), p4], 1), "C2fAttn_0", d(3), text, nh[0])  # 10-12
    n3 = _c2f_attn(w, torch.cat([_up(n4), p3], 1), "C2fAttn_1", d(3), text, nh[1])  # 13-15
    m4 = _c2f_attn(w, torch.cat([w.cbs(n3, "ConvBnSiLU_5", 2), n4], 1), "C2fAttn_2", d(3), text,
                   nh[2])  # 16-18
    m5 = _c2f_attn(w, torch.cat([w.cbs(m4, "ConvBnSiLU_6", 2), p5], 1), "C2fAttn_3", d(3), text,
                   nh[3])  # 19-21
    box, cls = [], []
    h = "WorldDetectHead_0"
    for i, f in enumerate((n3, m4, m5)):  # 22: WorldDetect
        b = w.cbs(w.cbs(f, f"{h}/ConvBnSiLU_{4 * i}"), f"{h}/ConvBnSiLU_{4 * i + 1}")
        box.append(w.conv(b, f"{h}/Conv_{2 * i}", bias=True))
        e = w.cbs(w.cbs(f, f"{h}/ConvBnSiLU_{4 * i + 2}"), f"{h}/ConvBnSiLU_{4 * i + 3}")
        e = w.conv(e, f"{h}/Conv_{2 * i + 1}", bias=True)
        cls.append(_contrast(w, e, text, f"{h}/BNContrastiveHead_{i}"))
    return box, cls


def layers(cfg: dict, hw: Tuple[int, int] = (640, 640)) -> List[tuple]:
    """Every convolution of the model at the letterboxed input hw (rows,
    cols), in the order ``forward`` runs them: (module path, c_in, c_out,
    kernel side, rows out, cols out, with BatchNorm); as
    ``reference/yolo.py:layers``, with each attention block's ``ConvBn_0``
    (BatchNorm, no SiLU) and the class branch's last convolution to 512."""
    ch, d = channels(cfg), lambda n: repeats(cfg, n)  # noqa: E731
    out: List[tuple] = []

    def conv(path, c_in, c_out, h, w, k=1, s=1, bn=True):
        ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
        out.append((path, c_in, c_out, k, ho, wo, bn))
        return c_out, ho, wo

    def c2f(path, c_in, c_out, h, w, n, attn=False):
        hid = c_out // 2
        conv(f"{path}/ConvBnSiLU_0", c_in, 2 * hid, h, w)
        for i in range(n):
            conv(f"{path}/Bottleneck_{i}/ConvBnSiLU_0", hid, hid, h, w, 3)
            conv(f"{path}/Bottleneck_{i}/ConvBnSiLU_1", hid, hid, h, w, 3)
        if attn:
            conv(f"{path}/MaxSigmoidAttnBlock_0/ConvBn_0", hid, hid, h, w, 3)
        return conv(f"{path}/ConvBnSiLU_1", (2 + n + attn) * hid, c_out, h, w)

    h, w = hw
    c, h, w = conv("ConvBnSiLU_0", 3, ch[64], h, w, 3, 2)
    c, h, w = conv("ConvBnSiLU_1", c, ch[128], h, w, 3, 2)
    c, h, w = c2f("C2f_0", c, ch[128], h, w, d(3))
    c, h, w = conv("ConvBnSiLU_2", c, ch[256], h, w, 3, 2)
    p3 = c2f("C2f_1", c, ch[256], h, w, d(6))
    c, h, w = conv("ConvBnSiLU_3", p3[0], ch[512], p3[1], p3[2], 3, 2)
    p4 = c2f("C2f_2", c, ch[512], h, w, d(6))
    c, h, w = conv("ConvBnSiLU_4", p4[0], ch[1024], p4[1], p4[2], 3, 2)
    c, h, w = c2f("C2f_3", c, ch[1024], h, w, d(3))
    conv("SPPF_0/ConvBnSiLU_0", c, c // 2, h, w)
    p5 = conv("SPPF_0/ConvBnSiLU_1", 4 * (c // 2), ch[1024], h, w)
    n4 = c2f("C2fAttn_0", p5[0] + p4[0], ch[512], p4[1], p4[2], d(3), True)
    n3 = c2f("C2fAttn_1", n4[0] + p3[0], ch[256], p3[1], p3[2], d(3), True)
    c, h, w = conv("ConvBnSiLU_5", n3[0], ch[256], n3[1], n3[2], 3, 2)
    m4 = c2f("C2fAttn_2", c + n4[0], ch[512], h, w, d(3), True)
    c, h, w = conv("ConvBnSiLU_6", m4[0], ch[512], m4[1], m4[2], 3, 2)
    m5 = c2f("C2fAttn_3", c + p5[0], ch[1024], h, w, d(3), True)
    c2 = max(16, n3[0] // 4, cfg["reg_max"] * 4)
    c3 = max(n3[0], min(cfg["nc"], 100))
    for i, (f, fh, fw) in enumerate((n3, m4, m5)):
        p = "WorldDetectHead_0"
        conv(f"{p}/ConvBnSiLU_{4 * i}", f, c2, fh, fw, 3)
        conv(f"{p}/ConvBnSiLU_{4 * i + 1}", c2, c2, fh, fw, 3)
        conv(f"{p}/Conv_{2 * i}", c2, 4 * cfg["reg_max"], fh, fw, bn=False)
        conv(f"{p}/ConvBnSiLU_{4 * i + 2}", f, c3, fh, fw, 3)
        conv(f"{p}/ConvBnSiLU_{4 * i + 3}", c3, c3, fh, fw, 3)
        conv(f"{p}/Conv_{2 * i + 1}", c3, TEXT_DIM, fh, fw, bn=False)
    return out


def attn_blocks(cfg: dict, hw: Tuple[int, int]) -> List[tuple]:
    """The four attention blocks at the letterboxed input hw: (path,
    channels, heads, rows, cols)."""
    convs = {p: (co, ho, wo) for p, _, co, _, ho, wo, _ in layers(cfg, hw)}
    out = []
    for i, nh in enumerate(attn_heads(cfg)):
        p = f"C2fAttn_{i}/MaxSigmoidAttnBlock_0"
        c, ho, wo = convs[f"{p}/ConvBn_0"]
        out.append((p, c, nh, ho, wo))
    return out


# ---------------------------------------------------------------- interface


def load(checkpoint_path: str, cfg: dict, device, fp8: bool = False) -> Weights:
    """The checkpoint's weights on `device`; with fp8, for the control."""
    return Weights(read_npz(checkpoint_path), device, fp8=fp8)


def heads(w: Weights, cfg: dict, frames_bgr: torch.Tensor, imgsz):
    """Frames [B, H, W, 3] BGR uint8 -> ((box logits, class logits), (scale,
    pad_y, pad_x)), through the reference's own letterbox."""
    x, scale, py, px = letterbox(frames_bgr, imgsz)
    with torch.no_grad():
        return forward(w, cfg, x), (scale, py, px)


def detect(w: Weights, cfg: dict, frames_bgr: torch.Tensor, imgsz, conf: float, iou: float):
    """Frames [B, H, W, 3] BGR uint8 -> (per-frame detections in frame
    pixels, (box logits, class logits))."""
    (box, cls), (scale, py, px) = heads(w, cfg, frames_bgr, imgsz)
    with torch.no_grad():
        boxes, scores = decode(box, cls, cfg["reg_max"])
    boxes = boxes.cpu().numpy().astype(np.float64)
    boxes[..., 0::2] -= px
    boxes[..., 1::2] -= py
    boxes /= scale
    scores = scores.cpu().numpy()
    return [nms(boxes[i], scores[i], conf, iou) for i in range(len(boxes))], (box, cls)


def flops(cfg: dict, hw: Tuple[int, int]) -> float:
    """Model FLOPs of one frame at the letterboxed input hw (rows, cols): 2 x
    the multiply-adds of every convolution, of each attention block's
    Linear (K x 512 x c) and einsum (c x K a pixel), and of each stride's
    contrastive einsum (512 x K a pixel)."""
    k, specs = cfg["nc"], layers(cfg, hw)
    macs = sum(co * ci * kk * kk * ho * wo for _, ci, co, kk, ho, wo, _ in specs)
    macs += sum(k * TEXT_DIM * c + c * k * ho * wo for _, c, _, ho, wo in attn_blocks(cfg, hw))
    out_hw = {p: (ho, wo) for p, _, _, _, ho, wo, _ in specs}
    macs += sum(TEXT_DIM * k * ho * wo for ho, wo in
                (out_hw[f"WorldDetectHead_0/Conv_{2 * i + 1}"] for i in range(3)))
    return 2.0 * macs


def attn_work(cfg: dict, hw: Tuple[int, int], frames: int = 1) -> Tuple[float, float]:
    """(bytes, FLOPs) of the four attention blocks on `frames` frames at the
    letterboxed input hw in one call: each block's input and output moved
    once in bf16, and its weights once (the Linear, its bias, the heads'
    bias, ``ConvBn_0``'s 3x3 kernel and BatchNorm) with the text embeddings;
    2 x the multiply-adds of ``ConvBn_0`` (9 c^2 a pixel) and of the einsum
    (c x K a pixel)."""
    k = cfg["nc"]
    nbytes = nflops = 0.0
    for _, c, nh, ho, wo in attn_blocks(cfg, hw):
        nbytes += frames * 2 * c * ho * wo * BF16
        nbytes += (TEXT_DIM * c + c + nh + 9 * c * c + 4 * c + k * TEXT_DIM) * BF16
        nflops += frames * 2.0 * (9 * c * c + c * k) * ho * wo
    return nbytes, nflops


class _Calibrating(v8._Calibrating, Weights):
    """``reference/yolo.py``'s calibrating weights (every ConvBnSiLU's and
    ConvBn's BatchNorm from its input), with the contrastive heads'
    BatchNorm by the same rule, and each attention block's guide scaled and
    its bias set on the way through (``draw``)."""

    def bn(self, y, p: str):
        ms = y.square().mean((0, 2, 3))
        self.t[f"batch_stats/{p}/mean"] = y.mean((0, 2, 3))
        self.t[f"batch_stats/{p}/var"] = torch.maximum(ms, ms.median())
        return super().bn(y, p)

    def attn_logit(self, z, path: str):
        s = ATTN_STD / float((z - z.mean((0, 2, 3), keepdim=True)).std())
        self.t[f"params/{path}/Dense_0/kernel"] *= s
        self.t[f"params/{path}/Dense_0/bias"] *= s
        z = z * s
        self.t[f"params/{path}/bias"] = -z.mean((0, 2, 3))
        return super().attn_logit(z, path)


def draw(cfg: dict, seed: int, frames_bgr: torch.Tensor, imgsz) -> Dict[str, np.ndarray]:
    """{leaf path: float32 array} of a checkpoint drawn from `seed` on the
    device of `frames_bgr`, named and shaped as the port's: a random model
    whose logits vary over the traffic as a trained one's do.

    As ``reference/yolo.py:draw``: every convolution's and Linear's weight
    is uniform in +-1/sqrt(fan_in) (PyTorch's default, so Ultralytics'),
    the Linear's bias too, from one draw of a ``torch.Generator`` on that
    device carved in ``layers`` order and then the blocks' Linears; the text
    embeddings are N(0, 1) rows of the same generator, L2-normalised (in the
    place of CLIP's). Then one float32 pass over `frames_bgr` letterboxed to
    imgsz (``_Calibrating``) sets the rest:
    - every BatchNorm, the contrastive heads' too, takes its input's mean
      and mean square, floored at the layer's median channel's, with the
      scale BN_GAIN (BRANCH_GAIN x BN_GAIN at a bottleneck's last
      convolution), shift 0 (``reference/yolo.py:draw`` says why). BN_GAIN
      is 0.2, not YOLOv8's 0.25: the neck multiplies features by gates
      computed from them, and at 0.25 some frames of an orbit turn the net
      chaotic (bf16 and float32 head logits 12% apart on a frame of one
      seed in twelve, the gap growing tenfold through the four C2fAttn;
      at 0.2 under 0.7% on every frame of three seeds; PERF.md);
    - each attention block's Linear (weight and bias) is scaled so that
      its pre-sigmoid logit, centred head by head, spreads by ATTN_STD over
      the pass, and ``bias[m]`` centres head m's logit at 0 (Ultralytics
      inits the bias at 0; its Linear leaves the logit some 0.002 wide
      here, a gate of 0.5 everywhere through which the text would barely
      reach the features);
    - the box branch as YOLOv8's: its last convolution scaled to spread its
      logits by BOX_STD, its bias falling BOX_SLOPE a DFL bin from 1.0;
    - the class branch's last convolution (to 512) has bias 0 (its
      BatchNorm takes the mean); each stride's ``logit_scale`` (Ultralytics:
      -1) spreads its logits by HEAD_STD over the pass, and the one
      ``bias`` of all three contrastive heads (Ultralytics: -10) is
      logit(conf) minus the least, over the frames, of each frame's
      quantile of the anchors' best class logit that leaves CANDIDATES
      anchors at or above the configuration's ``conf``."""
    dev = frames_bgr.device
    specs = layers(cfg)
    blocks = attn_blocks(cfg, (64, 64))
    sizes = [k * k * ci * co for _, ci, co, k, _, _, _ in specs]
    sizes += [n for _, c, _, _, _ in blocks for n in (TEXT_DIM * c, c)]
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=dev).mul_(2).sub_(1)
    text = torch.randn(cfg["nc"], TEXT_DIM, generator=gen, device=dev)
    t: Dict[str, torch.Tensor] = {"params/txt_feats": text / text.norm(dim=-1, keepdim=True)}
    at = 0
    for path, ci, co, k, _, _, bn in specs:
        n = k * k * ci * co
        kernel = u[at : at + n].reshape(k, k, ci, co) / math.sqrt(ci * k * k)  # HWIO
        at += n
        if not bn:  # a head's last convolution; its bias is set below
            t[f"params/{path}/kernel"] = kernel
            t[f"params/{path}/bias"] = torch.zeros(co, device=dev)
            continue
        t[f"params/{path}/Conv_0/kernel"] = kernel
        gain = BN_GAIN * (BRANCH_GAIN if "Bottleneck" in path and path.endswith("_1") else 1.0)
        t[f"params/{path}/BatchNorm_0/scale"] = torch.full((co,), gain, device=dev)
        t[f"params/{path}/BatchNorm_0/bias"] = torch.zeros(co, device=dev)
    for path, c, nh, _, _ in blocks:
        t[f"params/{path}/Dense_0/kernel"] = u[at : at + TEXT_DIM * c].reshape(
            TEXT_DIM, c) / math.sqrt(TEXT_DIM)  # [in, out]
        t[f"params/{path}/Dense_0/bias"] = u[at + TEXT_DIM * c : at + TEXT_DIM * c + c] / math.sqrt(
            TEXT_DIM)
        at += TEXT_DIM * c + c
        t[f"params/{path}/bias"] = torch.zeros(nh, device=dev)
    del u
    h = "WorldDetectHead_0"
    for i in range(3):
        p = f"{h}/BNContrastiveHead_{i}"
        t[f"params/{p}/BatchNorm_0/scale"] = torch.full((TEXT_DIM,), BN_GAIN, device=dev)
        t[f"params/{p}/BatchNorm_0/bias"] = torch.zeros(TEXT_DIM, device=dev)
        t[f"params/{p}/logit_scale"] = torch.zeros((), device=dev)
        t[f"params/{p}/bias"] = torch.zeros(1, device=dev)
    w = _Calibrating({}, dev)
    w.t = t
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            box, cls = forward(w, cfg, letterbox(frames_bgr, imgsz)[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    best = []
    for i, (b, c) in enumerate(zip(box, cls)):
        t[f"params/{h}/Conv_{2 * i}/kernel"] *= BOX_STD / float(b.std())
        t[f"params/{h}/BNContrastiveHead_{i}/logit_scale"] = torch.tensor(
            math.log(HEAD_STD / float(c.std())), device=dev)
        best.append((c * (HEAD_STD / float(c.std()))).amax(1).flatten(1))
    best = torch.cat(best, 1)  # [frames, anchors]: each anchor's best class logit
    top = float(torch.quantile(best, 1.0 - CANDIDATES / best.shape[1], dim=1).min())
    conf = cfg["conf"]
    for i in range(3):
        bins = torch.arange(cfg["reg_max"], device=dev, dtype=torch.float32)
        t[f"params/{h}/Conv_{2 * i}/bias"] = (1.0 - BOX_SLOPE * bins).repeat(4)
        t[f"params/{h}/BNContrastiveHead_{i}/bias"] = torch.full(
            (1,), math.log(conf / (1 - conf)) - top, device=dev)
    return {k: v.cpu().numpy() for k, v in t.items()}
