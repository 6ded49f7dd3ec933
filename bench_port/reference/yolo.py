"""YOLOv8 detection, plain: the benchmark's reference for the per-frame
detection (letterbox, model, decode, NMS, un-letterbox).

The architecture is Ultralytics' ``yolov8.yaml`` (backbone of Conv and C2f
blocks, SPPF, the PAN neck, the decoupled DFL head over strides 8, 16 and
32), built from the configuration's ``depth_multiple``, ``width_multiple``,
``max_channels``, ``nc`` and ``reg_max``. The weights come from the bundled
Flax checkpoint (``.npz``), read here with a reader of its own: leaf
``leaf_i`` of the file is the i-th leaf of its ``__treedef__`` walked in
sorted-key order. Module names are the Flax ones of that checkpoint
(``ConvBnSiLU_n``, ``C2f_n``, ``Bottleneck_n``, ``SPPF_0``,
``DetectHead_0``), numbered per class in creation order. BatchNorm's epsilon
is Flax's 1e-3.

Everything runs in float32 with TF32 off (the caller sets the flags). With
``fp8=True`` every convolution's input and weight are rounded to float8
(e4m3, one scale per tensor) first: the control, computed one precision
below the configuration's bf16. Imports nothing of the port.
"""

from __future__ import annotations

import ast
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
PAD_VALUE = 0.447  # the letterbox's fill, in 0..1
MAX_DET = 300
# draw: the seeded model's BatchNorm scale, its bottleneck branches' share,
# its class and box heads' spreads of logits, its box bias's fall a DFL bin,
# and the candidates a frame that reach CALIB_CONF
BN_GAIN = 0.25
BRANCH_GAIN = 0.3
HEAD_STD = 1.0
BOX_STD = 0.25
BOX_SLOPE = 0.4
CANDIDATES = 16
CALIB_CONF = 0.25


# ------------------------------------------------------------------ weights


def _leaf_paths(node, prefix: str = "") -> List[str]:
    if isinstance(node, dict):
        return [p for k in sorted(node) for p in _leaf_paths(node[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """{leaf path: float32 array} of a Flax checkpoint written as an npz of
    ``leaf_i`` arrays and a ``__treedef__`` string such as
    ``PyTreeDef({'params': {'Conv_0': {'kernel': *}}})``."""
    with np.load(path) as data:
        text = bytes(data["__treedef__"]).decode()
        if not (text.startswith("PyTreeDef(") and text.endswith(")")):
            raise ValueError(f"{path}: not a tree of dicts: {text[:60]}")
        tree = ast.literal_eval(text[len("PyTreeDef("):-1].replace("*", "None"))
        paths = _leaf_paths(tree)
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != len(paths):
            raise ValueError(f"{path}: {n} leaves, the treedef names {len(paths)}")
        return {p: np.asarray(data[f"leaf_{i}"], np.float32) for i, p in enumerate(paths)}


# ------------------------------------------------------------- architecture


def _div8(x: float) -> int:
    return int(math.ceil(x / 8) * 8)


def channels(cfg: dict) -> Dict[str, int]:
    """Ultralytics' channel rule: make_divisible(min(c, max_channels) * width, 8)."""
    w, mc = cfg["width_multiple"], cfg["max_channels"]
    return {c: _div8(min(c, mc) * w) for c in (64, 128, 256, 512, 1024)}


def repeats(cfg: dict, n: int) -> int:
    return max(round(n * cfg["depth_multiple"]), 1)


class Weights:
    """The checkpoint's tensors on a device, looked up by module path."""

    def __init__(self, flat: Dict[str, np.ndarray], device, fp8: bool = False):
        self.t = {k: torch.from_numpy(v).to(device) for k, v in flat.items()}
        self.fp8 = fp8

    def conv(self, x, path: str, stride: int = 1, groups: int = 1, bias: bool = False):
        k = self.t[f"params/{path}/kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        b = self.t[f"params/{path}/bias"] if bias else None
        if self.fp8:
            x, k = _fp8(x), _fp8(k)
        return F.conv2d(x, k, b, stride, k.shape[-1] // 2, 1, groups)

    def cbs(self, x, path: str, stride: int = 1, act: bool = True):
        """Conv (no bias) + BatchNorm (eval) + SiLU."""
        y = self.conv(x, f"{path}/Conv_0", stride)
        p = f"{path}/BatchNorm_0"
        mean, var = self.t[f"batch_stats/{p}/mean"], self.t[f"batch_stats/{p}/var"]
        scale, shift = self.t[f"params/{p}/scale"], self.t[f"params/{p}/bias"]
        y = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS)
        y = y * scale[:, None, None] + shift[:, None, None]
        return y * torch.sigmoid(y) if act else y


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude at e4m3's largest finite value, 448), back in float32."""
    s = torch.clamp(x.abs().amax(), min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _c2f(w: Weights, x, path: str, n: int, shortcut: bool):
    y = w.cbs(x, f"{path}/ConvBnSiLU_0")
    a, b = y.chunk(2, dim=1)
    outs = [a, b]
    for i in range(n):
        h = w.cbs(w.cbs(outs[-1], f"{path}/Bottleneck_{i}/ConvBnSiLU_0"),
                  f"{path}/Bottleneck_{i}/ConvBnSiLU_1")
        outs.append(outs[-1] + h if shortcut else h)
    return w.cbs(torch.cat(outs, 1), f"{path}/ConvBnSiLU_1")


def _sppf(w: Weights, x, path: str):
    y = [w.cbs(x, f"{path}/ConvBnSiLU_0")]
    for _ in range(3):
        y.append(F.max_pool2d(y[-1], 5, 1, 2))
    return w.cbs(torch.cat(y, 1), f"{path}/ConvBnSiLU_1")


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def forward(w: Weights, cfg: dict, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """x [B, 3, H, W] RGB in 0..1 -> (box logits, class logits), one NCHW
    tensor per stride, as ``yolov8.yaml`` wires the layers."""
    d = lambda n: repeats(cfg, n)  # noqa: E731
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
    n4 = _c2f(w, torch.cat([_up(p5), p4], 1), "C2f_4", d(3), False)  # 10-12
    n3 = _c2f(w, torch.cat([_up(n4), p3], 1), "C2f_5", d(3), False)  # 13-15
    m4 = _c2f(w, torch.cat([w.cbs(n3, "ConvBnSiLU_5", 2), n4], 1), "C2f_6", d(3), False)  # 16-18
    m5 = _c2f(w, torch.cat([w.cbs(m4, "ConvBnSiLU_6", 2), p5], 1), "C2f_7", d(3), False)  # 19-21
    box, cls = [], []
    for i, f in enumerate((n3, m4, m5)):  # 22: Detect, six modules a level
        h = "DetectHead_0"
        b = w.cbs(w.cbs(f, f"{h}/ConvBnSiLU_{4 * i}"), f"{h}/ConvBnSiLU_{4 * i + 1}")
        box.append(w.conv(b, f"{h}/Conv_{2 * i}", bias=True))
        c = w.cbs(w.cbs(f, f"{h}/ConvBnSiLU_{4 * i + 2}"), f"{h}/ConvBnSiLU_{4 * i + 3}")
        cls.append(w.conv(c, f"{h}/Conv_{2 * i + 1}", bias=True))
    return box, cls


def layers(cfg: dict, hw: Tuple[int, int] = (640, 640)) -> List[tuple]:
    """Every convolution of the model at the letterboxed input hw (rows,
    cols), in the order ``forward`` runs them: (module path, c_in, c_out,
    kernel side, rows out, cols out, with BatchNorm). A module with
    BatchNorm is a ConvBnSiLU (``{path}/Conv_0`` without a bias,
    ``{path}/BatchNorm_0``); one without is a head's last convolution, with
    a bias."""
    ch, d = channels(cfg), lambda n: repeats(cfg, n)  # noqa: E731
    out: List[tuple] = []

    def conv(path, c_in, c_out, h, w, k=1, s=1, bn=True):
        ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
        out.append((path, c_in, c_out, k, ho, wo, bn))
        return c_out, ho, wo

    def c2f(path, c_in, c_out, h, w, n):
        hid = c_out // 2
        conv(f"{path}/ConvBnSiLU_0", c_in, 2 * hid, h, w)
        for i in range(n):
            conv(f"{path}/Bottleneck_{i}/ConvBnSiLU_0", hid, hid, h, w, 3)
            conv(f"{path}/Bottleneck_{i}/ConvBnSiLU_1", hid, hid, h, w, 3)
        return conv(f"{path}/ConvBnSiLU_1", (2 + n) * hid, c_out, h, w)

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
    n4 = c2f("C2f_4", p5[0] + p4[0], ch[512], p4[1], p4[2], d(3))
    n3 = c2f("C2f_5", n4[0] + p3[0], ch[256], p3[1], p3[2], d(3))
    c, h, w = conv("ConvBnSiLU_5", n3[0], ch[256], n3[1], n3[2], 3, 2)
    m4 = c2f("C2f_6", c + n4[0], ch[512], h, w, d(3))
    c, h, w = conv("ConvBnSiLU_6", m4[0], ch[512], m4[1], m4[2], 3, 2)
    m5 = c2f("C2f_7", c + p5[0], ch[1024], h, w, d(3))
    c2 = max(16, n3[0] // 4, cfg["reg_max"] * 4)
    c3 = max(n3[0], min(cfg["nc"], 100))
    for i, (f, fh, fw) in enumerate((n3, m4, m5)):
        p = "DetectHead_0"
        conv(f"{p}/ConvBnSiLU_{4 * i}", f, c2, fh, fw, 3)
        conv(f"{p}/ConvBnSiLU_{4 * i + 1}", c2, c2, fh, fw, 3)
        conv(f"{p}/Conv_{2 * i}", c2, 4 * cfg["reg_max"], fh, fw, bn=False)
        conv(f"{p}/ConvBnSiLU_{4 * i + 2}", f, c3, fh, fw, 3)
        conv(f"{p}/ConvBnSiLU_{4 * i + 3}", c3, c3, fh, fw, 3)
        conv(f"{p}/Conv_{2 * i + 1}", c3, cfg["nc"], fh, fw, bn=False)
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


def flops(cfg: dict, hw: Tuple[int, int]) -> float:
    """Model FLOPs of one frame at the letterboxed input hw (rows, cols): 2 x
    the multiply-adds of every convolution, as Ultralytics counts its
    GFLOPs."""
    return 2.0 * sum(co * ci * k * k * ho * wo for _, ci, co, k, ho, wo, _ in layers(cfg, hw))


class _Calibrating(Weights):
    """Weights whose every BatchNorm takes its statistics from its input on
    the way through, keeping them: the mean, and for the variance the mean
    square, at least the median channel's, so that no channel is scaled up
    beyond its own magnitude or the layer's typical one."""

    def cbs(self, x, path: str, stride: int = 1, act: bool = True):
        y = self.conv(x, f"{path}/Conv_0", stride)
        p = f"batch_stats/{path}/BatchNorm_0"
        ms = y.square().mean((0, 2, 3))
        self.t[f"{p}/mean"] = y.mean((0, 2, 3))
        self.t[f"{p}/var"] = torch.maximum(ms, ms.median())
        return super().cbs(x, path, stride, act)


def draw(cfg: dict, seed: int, frames_bgr: torch.Tensor, imgsz) -> Dict[str, np.ndarray]:
    """{leaf path: float32 array} of a checkpoint drawn from `seed` on the
    device of `frames_bgr`, named and shaped as the bundled ones: a random
    model whose logits vary over the traffic as a trained one's do.

    Every convolution's weight is uniform in +-1/sqrt(fan_in), PyTorch's
    default and so Ultralytics' initialisation: one draw from a
    ``torch.Generator`` on that device, carved into the kernels in the
    order ``layers`` lists them. Then, unlike a fresh model, one pass in
    float32 over `frames_bgr` (frames of the traffic) letterboxed to imgsz
    sets the rest (``_Calibrating``; PERF.md gives the readings):
    - each BatchNorm (epsilon 1e-3, shift 0) takes its input's mean and
      mean square as its statistics, the mean square at least the layer's
      median channel's, and the scale BN_GAIN (BRANCH_GAIN x BN_GAIN at the
      last convolution of a bottleneck). A channel all but silent on the
      pass would otherwise scale up, on frames that the pass did not see,
      bf16's rounding many times over (a head's logits 6% apart). With a fresh
      model's statistics (mean 0, variance 1) every activation vanishes by
      the third C2f and every logit equals its bias: all anchors tie and
      no comparison could fail. At scale 1 the random net is chaotic (bf16
      and float32 logits some 30% apart); at BN_GAIN each SiLU stays near
      its linear range, and the small bottleneck branches keep rounding
      from piling up with depth, so on most frames bf16 reads about as a
      trained checkpoint does (not on every stretch of an orbit: PERF.md);
    - each stride's last two convolutions are scaled so that their logits
      spread by HEAD_STD (classes) and BOX_STD (boxes) over the pass;
    - the box bias falls from ``Detect.bias_init``'s 1.0 by BOX_SLOPE a DFL
      bin, so that boxes are a few strides wide, as aerial objects are:
      with the flat 1.0 every box spans some 15 strides, and a box moved
      by 8 px still overlaps its place by more than the check's IoU 0.9.
      The box logits' spread is small beside that fall, so each side's
      bins stay one smooth slope: with a spread of 1.0 two far bins can
      tie, and bf16's rounding moves the box by strides;
    - the class bias, one number for every class and stride, is
      logit(CALIB_CONF) minus the least, over the frames, of each frame's
      quantile of the anchors' best class logit that leaves CANDIDATES
      anchors at or above CALIB_CONF: every frame of the pass keeps
      CANDIDATES or more (one quantile over all the frames put them in a
      few frames and left others none); a dense frame keeps some hundreds,
      up to the cap of MAX_DET.
      ``bias_init``'s prior log(5 / nc / (640 / stride)^2) would leave
      every score far under ``conf``."""
    dev = frames_bgr.device
    specs = layers(cfg)
    sizes = [k * k * ci * co for _, ci, co, k, _, _, _ in specs]
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=dev).mul_(2).sub_(1)
    t: Dict[str, torch.Tensor] = {}
    at = 0
    for (path, ci, co, k, _, _, bn), n in zip(specs, sizes):
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
    del u
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
        for j, out, std in ((2 * i, b, BOX_STD), (2 * i + 1, c, HEAD_STD)):
            t[f"params/DetectHead_0/Conv_{j}/kernel"] *= std / float(out.std())
        best.append((c * (HEAD_STD / float(c.std()))).amax(1).flatten(1))
    best = torch.cat(best, 1)  # [frames, anchors]: each anchor's best class logit
    # the least over the frames of each frame's quantile: every frame keeps
    # CANDIDATES anchors or more
    top = float(torch.quantile(best, 1.0 - CANDIDATES / best.shape[1], dim=1).min())
    for i in range(3):
        bins = torch.arange(cfg["reg_max"], device=dev, dtype=torch.float32)
        t[f"params/DetectHead_0/Conv_{2 * i}/bias"] = (1.0 - BOX_SLOPE * bins).repeat(4)
        t[f"params/DetectHead_0/Conv_{2 * i + 1}/bias"] = torch.full(
            (cfg["nc"],), math.log(CALIB_CONF / (1 - CALIB_CONF)) - top, device=dev)
    return {k: v.cpu().numpy() for k, v in t.items()}


# ------------------------------------------------------- letterbox, decode, NMS


def letterbox_geometry(h: int, w: int, imgsz) -> Tuple[float, int, int, int, int]:
    """(scale, new_h, new_w, pad_y, pad_x) of an aspect-preserving resize
    into imgsz (a side, or (rows, cols)), centred."""
    th, tw = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    scale = min(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return scale, nh, nw, (th - nh) // 2, (tw - nw) // 2


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of a triangle (bilinear) filter widened by the
    scale when shrinking, centres at half pixels, normalised: antialiased
    bilinear resampling along one axis."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    m = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        centre = (i + 0.5) * scale
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), n_in)
        j = np.arange(lo, hi)
        wts = np.maximum(0.0, 1.0 - np.abs((j + 0.5 - centre) / support))
        m[i, lo:hi] = wts / wts.sum()
    return m


def letterbox(frames_bgr: torch.Tensor, imgsz) -> Tuple[torch.Tensor, float, int, int]:
    """[B, H, W, 3] BGR uint8 -> ([B, 3, th, tw] RGB float32 in 0..1, scale,
    pad_y, pad_x)."""
    b, h, w, _ = frames_bgr.shape
    th, tw = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    scale, nh, nw, py, px = letterbox_geometry(h, w, imgsz)
    x = frames_bgr.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0
    if (nh, nw) != (h, w):
        dev = x.device
        my = torch.from_numpy(_resize_matrix(h, nh)).to(dev, torch.float32)
        mx = torch.from_numpy(_resize_matrix(w, nw)).to(dev, torch.float32)
        x = torch.einsum("yh,bchw,xw->bcyx", my, x, mx)
    out = torch.full((b, 3, th, tw), PAD_VALUE, dtype=torch.float32, device=x.device)
    out[:, :, py : py + nh, px : px + nw] = x
    return out, scale, py, px


def decode(box: List[torch.Tensor], cls: List[torch.Tensor], reg_max: int,
           strides=(8, 16, 32)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head outputs -> (boxes xyxy [B, N, 4] in letterboxed pixels, scores
    [B, N, C]); anchors at cell centres, stride by stride, row-major. A box
    side is the expectation of its reg_max-bin softmax."""
    all_b, all_s = [], []
    for bl, cl, s in zip(box, cls, strides):
        b, _, h, w = bl.shape
        p = torch.softmax(bl.reshape(b, 4, reg_max, h, w), dim=2)
        dist = (p * torch.arange(reg_max, dtype=p.dtype, device=p.device)[:, None, None]).sum(2)
        cy = torch.arange(h, dtype=torch.float32, device=bl.device)[:, None] + 0.5
        cx = torch.arange(w, dtype=torch.float32, device=bl.device)[None, :] + 0.5
        xyxy = torch.stack([cx - dist[:, 0], cy - dist[:, 1], cx + dist[:, 2], cy + dist[:, 3]],
                           -1) * s
        all_b.append(xyxy.reshape(b, h * w, 4))
        all_s.append(torch.sigmoid(cl).reshape(b, cl.shape[1], h * w).transpose(1, 2))
    return torch.cat(all_b, 1), torch.cat(all_s, 1)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of one box [4] against boxes [N, 4], xyxy."""
    iw = np.clip(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), 0, None)
    ih = np.clip(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), 0, None)
    inter = iw * ih
    area = lambda x: np.clip(x[..., 2] - x[..., 0], 0, None) * np.clip(x[..., 3] - x[..., 1], 0, None)  # noqa: E731
    return inter / np.maximum(area(a) + area(b) - inter, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, conf: float, iou: float) -> List[dict]:
    """Greedy class-aware NMS of one frame: each candidate's class is its
    best score's; candidates below `conf` drop; of the MAX_DET best (stable
    order), a candidate is kept unless a kept one of its class, ranked
    higher, overlaps it by more than `iou`. Returns the kept detections
    [{'box', 'score', 'cls'}] best first."""
    cls = scores.argmax(1)
    best = scores.max(1)
    best = np.where(best >= conf, best, 0.0)
    order = np.argsort(-best, kind="stable")[:MAX_DET]
    order = order[best[order] > 0.0]
    kept: List[int] = []
    for j in order:
        same = [k for k in kept if cls[k] == cls[j]]
        if same and np.any(_iou(boxes[j], boxes[same]) > iou):
            continue
        kept.append(j)
    return [{"box": boxes[k].astype(np.float64), "score": float(best[k]), "cls": int(cls[k])}
            for k in kept]


def detect(w: Weights, cfg: dict, frames_bgr: torch.Tensor, imgsz, conf: float, iou: float):
    """Frames [B, H, W, 3] BGR uint8 -> (per-frame detections in frame
    pixels, (box logits, class logits))."""
    x, scale, py, px = letterbox(frames_bgr, imgsz)
    with torch.no_grad():
        box, cls = forward(w, cfg, x)
        boxes, scores = decode(box, cls, cfg["reg_max"])
    boxes = boxes.cpu().numpy().astype(np.float64)
    boxes[..., 0::2] -= px
    boxes[..., 1::2] -= py
    boxes /= scale
    scores = scores.cpu().numpy()
    return [nms(boxes[i], scores[i], conf, iou) for i in range(len(boxes))], (box, cls)
