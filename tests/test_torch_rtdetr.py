"""RT-DETR in the port (``models/rtdetr/``: the model, the NMS-free
post-process, ``ObjectDetector``'s RT-DETR branch) against the benchmark's
plain reference ``bench_port/reference/rtdetr.py``, on weights drawn by the
reference's ``draw`` and written by ``bench_port/lib/weights.py``, as the
benchmark's seeded cell loads them; and the reference against
``transformers``' ``RTDetrForObjectDetection`` where that package is
installed. The JAX package has no RT-DETR. On the CPU at a small size:
depths [1, 1, 1, 1], widths 16-256, 2 decoder layers, 20 queries, 128x192."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.lib import traffic
from bench_port.lib import weights as seeded
from bench_port.reference import rtdetr as ref
from rtvm_tpu_torch.detect.detector import ObjectDetector
from rtvm_tpu_torch.models.rtdetr import model as rt
from rtvm_tpu_torch.models.rtdetr.postprocess import select_detections
from rtvm_tpu_torch.models.yolo import postprocess as pp
from rtvm_tpu_torch.utils.timing import StageTimer

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 2424
IMGSZ = (128, 192)
VARIANT = "rtdetr-test"
NC = 80
# the benchmark configuration's block at the test's size
YC = dict(json.loads((ROOT / "bench_port/configs/orb1080-rtdetr-r101vd.json").read_text())["yolo"],
          variant=VARIANT, depths=[1, 1, 1, 1], embedding_size=16, hidden_sizes=[32, 64, 128, 256],
          encoder_hidden_dim=48, encoder_ffn_dim=64, encoder_heads=4, d_model=32,
          decoder_in_channels=[48, 48, 48], decoder_ffn_dim=64, decoder_layers=2,
          decoder_heads=4, num_queries=20)
SPEC = rt.RTDetrSpec(depths=(1, 1, 1, 1), embedding_size=16, hidden_sizes=(32, 64, 128, 256),
                     encoder_hidden_dim=48, encoder_ffn_dim=64, encoder_heads=4, d_model=32,
                     decoder_ffn_dim=64, decoder_layers=2, decoder_heads=4, num_queries=20)
# bf16 against the float32 reference, largest relative RMS gap of a frame's
# encoder heads (class logits and box offsets): bf16 rounds every layer's
# output by up to 2^-9, and some 30 layers of this net, each re-normalised
# by its BatchNorm, carry it to 0.03-0.08 on three seeds; the reference in
# fp8 (e4m3's 2^-4) reads 0.37-0.59
BF16_HEAD_TOL = 0.2


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setitem(rt.VARIANTS_RTDETR, VARIANT, SPEC)


@pytest.fixture(scope="module")
def frames():
    mix = json.loads((ROOT / "bench_port/traffic/fused.json").read_text())
    orbit = traffic.make_orbit(SEED, (90, 160), dict(mix, window_size=16, period_windows=1))
    return torch.from_numpy(orbit["frames"])


@pytest.fixture(scope="module")
def ckpt(frames, tmp_path_factory):
    """The test size's checkpoint, drawn on 4 frames of the orbit and
    written as the benchmark writes it."""
    path = str(tmp_path_factory.mktemp("rtdetr") / f"{VARIANT}.npz")
    seeded.write_checkpoint(path, ref.draw(YC, SEED, frames[::4][:4], IMGSZ),
                            seeded.class_names(YC))
    return path


def detector(path: str) -> ObjectDetector:
    return ObjectDetector(model=VARIANT, weights_path=path, load_world=False, device="cpu")


def flat_heads(box, cls, i):
    return torch.cat([t[i].flatten() for t in list(box) + list(cls)])


def encoder_part(box, cls, i):
    return torch.cat([t[i, :4].flatten() for t in box] + [t[i, :NC].flatten() for t in cls])


def test_flops_are_the_counters(ckpt):
    """The reference's FLOP count, ``flops``, is torch's count of its own
    forward (every convolution, AIFI's and the decoder's matrix products,
    every Linear) plus the deformable attention's bilinear taps and their
    weighting (4 a point and channel, and 1), which the counter does not
    see: ``grid_sample`` and a weighted sum."""
    w = ref.load(ckpt, YC, "cpu")
    with FlopCounterMode(display=False) as counter:
        ref.forward(w, YC, torch.rand(1, 3, *IMGSZ))
    s = ref.spec(YC)
    taps = 2 * s["decoder_layers"] * s["num_queries"] * s["decoder_heads"] * len(
        s["feat_strides"]) * s["n_points"] * (s["d_model"] // s["decoder_heads"]) * 5
    assert counter.get_total_flops() + taps == ref.flops(YC, IMGSZ)


def test_the_checkpoint_has_exactly_the_models_keys(ckpt):
    """The drawn checkpoint loads with no key missing or left over; the
    reference's parameter list names the model's state_dict; the
    published R101 holds the paper's 76 M parameters."""
    det = detector(ckpt)
    assert det.weights_loaded and len(det.class_names) == NC
    keys = []
    for key, _, kind in ref.params(YC):
        if kind.startswith("bn"):
            keys += [f"{key}.{n}" for n in ("weight", "bias", "running_mean", "running_var")]
        elif kind == "ln":
            keys += [f"{key}.weight", f"{key}.bias"]
        else:
            keys.append(key)
    assert sorted(keys) == sorted(det.model.state_dict())
    full = rt.RTDETR(rt.VARIANTS_RTDETR["rtdetr-r101vd"])
    n = sum(p.numel() for p in full.state_dict().values())
    assert 76.0e6 < n < 77.0e6


def test_float32_port_is_the_reference(ckpt, frames):
    """The port in float32 against the reference: every head within 1e-5 of
    its largest value, the same selected cells, the same detections."""
    det = detector(ckpt)
    w = ref.load(ckpt, YC, "cpu")
    fr = frames[1:16:5]
    (box, cls), geo = det.head_logits(fr, IMGSZ, torch.float32)
    (rbox, rcls), rgeo = ref.heads(w, YC, fr, IMGSZ)
    assert geo == rgeo
    for i in range(len(fr)):
        a, b = flat_heads(box, cls, i), flat_heads(rbox, rcls, i)
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        sel = [torch.cat([c[i, 2 * NC].flatten() for c in cs]) for cs in (cls, rcls)]
        assert torch.equal(sel[0], sel[1]) and int(sel[0].sum()) == YC["num_queries"]
    got = det._infer_fn(IMGSZ, YC["conf"], YC["iou"], torch.float32)(fr)
    want, _ = ref.detect(w, YC, fr, IMGSZ, YC["conf"], YC["iou"])
    assert sum(len(d) for d in want) > 0
    for i, dets in enumerate(want):
        v = got.valid[i]
        assert int(v.sum()) == len(dets)
        gb = got.boxes[i][v].double().numpy()
        for d in dets:
            j = np.abs(gb - d["box"]).max(1).argmin()
            assert np.abs(gb[j] - d["box"]).max() < 1e-3
            assert int(got.classes[i][v][j]) == d["cls"]


def test_bf16_port_within_its_tolerance_and_fp8_outside(ckpt, frames):
    """The port in bf16 (the benchmark's precision) stays within
    BF16_HEAD_TOL of the float32 reference on every frame's encoder heads;
    the reference in fp8, the control one precision below, does not."""
    det = detector(ckpt)
    w, w8 = ref.load(ckpt, YC, "cpu"), ref.load(ckpt, YC, "cpu", fp8=True)
    fr = frames[2:16:4]
    (box, cls), _ = det.head_logits(fr, IMGSZ, torch.bfloat16)
    (rbox, rcls), _ = ref.heads(w, YC, fr, IMGSZ)
    (fbox, fcls), _ = ref.heads(w8, YC, fr, IMGSZ)
    def gap(b, c, i):
        want = encoder_part(rbox, rcls, i)
        return float((encoder_part(b, c, i) - want).norm() / want.norm())

    assert max(gap(box, cls, i) for i in range(len(fr))) < BF16_HEAD_TOL
    assert min(gap(fbox, fcls, i) for i in range(len(fr))) > BF16_HEAD_TOL
    assert all(t.dtype == torch.float32 for t in box + cls)


def test_the_box_chain_is_float32():
    """The refinement sigmoid(delta + inverse_sigmoid(box)) in float32 is
    the float64 chain to 1e-6 near the image's border, where bf16 (8 bits
    of mantissa, nothing between 0.996 and 1) moves a box by pixels at
    1280 columns and cannot hold inverse_sigmoid's 1 - 1e-5."""
    box = torch.tensor([[0.9995, 0.5, 0.05, 0.2], [0.995, 0.985, 0.1, 0.4],
                        [0.002, 0.9999, 0.03, 0.6]])
    delta = torch.tensor([[0.03, -0.02, 0.01, 0.05], [-0.01, 0.02, -0.04, 0.0],
                          [0.02, 0.01, 0.0, -0.03]]).bfloat16()
    logit, new = rt.refine(delta, box)
    b64 = box.double().clamp(1e-5, 1 - 1e-5)
    want = torch.sigmoid(delta.double() + torch.log(b64 / (1 - b64)))
    assert logit.dtype == new.dtype == torch.float32
    assert float((new.double() - want).abs().max()) < 1e-6
    l16 = delta + rt.inverse_sigmoid(box.bfloat16())
    moved_px = float((torch.sigmoid(l16).double() - want).abs().max()) * 1280
    assert moved_px > 1.0


def test_deformable_sampling_is_the_bilinear_loop():
    """``DeformableAttention`` against a NumPy loop over each (head, level,
    point)'s four bilinear taps (pixel centres at +0.5, zeros outside) and
    the softmax over the head's levels x points."""
    torch.manual_seed(0)
    spec = dataclasses.replace(SPEC, d_model=8, decoder_heads=2, n_points=2)
    attn = rt.DeformableAttention(spec).eval()
    with torch.no_grad():
        attn.sampling_offsets.weight.mul_(20)
    shapes = [(4, 6), (2, 3), (1, 2)]
    b, nq, d, m, lv, pts = 2, 5, 8, 2, 3, 2
    a = sum(h * w for h, w in shapes)
    q, memory = torch.randn(b, nq, d), torch.randn(b, a, d)
    ref_box = torch.cat([torch.rand(b, nq, 2), torch.rand(b, nq, 2) * 0.8 + 0.1], -1)
    with torch.no_grad():
        got = attn(q, ref_box, memory, shapes).numpy()
        value = attn.value_proj(memory).numpy()
        off = attn.sampling_offsets(q).view(b, nq, m, lv, pts, 2).numpy()
        logits = attn.attention_weights(q).view(b, nq, m, lv * pts).numpy()
    wts = np.exp(logits - logits.max(-1, keepdims=True))
    wts = (wts / wts.sum(-1, keepdims=True)).reshape(b, nq, m, lv, pts)
    rb = ref_box.numpy()
    out = np.zeros((b, nq, d))
    dh = d // m
    for i in range(b):
        for k in range(nq):
            for h in range(m):
                a0 = 0
                for lvl, (hh, ww) in enumerate(shapes):
                    vmap = value[i, a0 : a0 + hh * ww, h * dh : (h + 1) * dh].reshape(hh, ww, dh)
                    for p in range(pts):
                        loc = rb[i, k, :2] + off[i, k, h, lvl, p] / pts * rb[i, k, 2:] * 0.5
                        x, y = loc[0] * ww - 0.5, loc[1] * hh - 0.5
                        x0, y0 = int(np.floor(x)), int(np.floor(y))
                        acc = np.zeros(dh)
                        for yy, wy in ((y0, 1 - (y - y0)), (y0 + 1, y - y0)):
                            for xx, wx in ((x0, 1 - (x - x0)), (x0 + 1, x - x0)):
                                if 0 <= yy < hh and 0 <= xx < ww:
                                    acc += wy * wx * vmap[yy, xx]
                        out[i, k, h * dh : (h + 1) * dh] += wts[i, k, h, lvl, p] * acc
                    a0 += hh * ww
    wo, bo = attn.output_proj.weight.detach().numpy(), attn.output_proj.bias.detach().numpy()
    np.testing.assert_allclose(got, out @ wo.T + bo, rtol=1e-5, atol=1e-5)


def test_anchors_and_valid_mask():
    """``generate_anchors``: cell centres (x + 0.5) / w, (y + 0.5) / h,
    side 0.05 * 2^level, valid where every coordinate lies in (0.01, 0.99),
    as logits, the largest float32 where invalid; level by level,
    row-major."""
    shapes = [(96, 160), (48, 80), (24, 40)]  # the benchmark's 768x1280
    anchors, valid = rt.generate_anchors(shapes, "cpu")
    want, ok = [], []
    for lvl, (h, w) in enumerate(shapes):
        for y in range(h):
            for x in range(w):
                a = np.array([(x + 0.5) / w, (y + 0.5) / h, 0.05 * 2**lvl, 0.05 * 2**lvl])
                ok.append(bool(np.all((a > 0.01) & (a < 0.99))))
                want.append(np.log(a / (1 - a)))
    ok = np.array(ok)
    assert anchors.shape == (1, len(ok), 4) and anchors.dtype == torch.float32
    assert np.array_equal(valid[0, :, 0].numpy(), ok)
    # stride 8: columns 0, 1, 158, 159 and rows 0, 95; stride 16: columns 0, 79
    assert (~ok).sum() == 4 * 96 + 2 * 160 - 8 + 2 * 48
    np.testing.assert_allclose(anchors[0][ok].numpy(), np.array(want)[ok], rtol=1e-6, atol=1e-6)
    assert bool((anchors[0][~ok] == torch.finfo(torch.float32).max).all())


def test_the_nms_free_postprocess():
    """One detection a selected query: its largest class's sigmoid, kept
    where it exceeds conf (not at conf), its cx-cy-w-h box in the
    letterboxed input's pixels; the letterbox undone as ``_infer_fn`` does;
    the slots fixed at num_queries."""
    nc, q, shapes = 3, 3, [(2, 3), (1, 2)]
    box = [torch.zeros(1, 8, h, w) for h, w in shapes]
    cls = [torch.full((1, 2 * nc + 1, h, w), -9.0) for h, w in shapes]
    for c in cls:
        c[:, 2 * nc] = 0.0
    conf = 0.25
    picks = [(0, 0, 1, [0.0, 2.0, -1.0], [0.5, 0.5, 0.2, 0.4]),  # class 1, p 0.88
             (0, 1, 2, [np.log(conf / (1 - conf)), -5.0, -5.0], [0.1, 0.2, 0.1, 0.1]),  # p == conf
             (1, 0, 1, [-3.0, -2.0, 0.5], [0.9, 0.6, 0.1, 0.2])]  # class 2, p 0.62
    for lvl, y, x, logits, cxcywh in picks:
        cls[lvl][0, 2 * nc, y, x] = 1.0
        cls[lvl][0, nc : 2 * nc, y, x] = torch.tensor(logits)
        cxcywh = torch.tensor(cxcywh)
        box[lvl][0, 4:, y, x] = torch.log(cxcywh / (1 - cxcywh))
    cls[0][0, :nc] = 5.0  # the encoder's logits are not read
    det = select_detections(box, cls, q, (64, 96), conf)
    assert det.boxes.shape == (1, q, 4) and det.valid.shape == (1, q)
    assert int(det.valid.sum()) == 2
    kept = sorted(zip(det.classes[0][det.valid[0]].tolist(), det.scores[0][det.valid[0]].tolist(),
                      det.boxes[0][det.valid[0]].tolist()))
    assert [k[0] for k in kept] == [1, 2]
    assert kept[0][1] == pytest.approx(1 / (1 + np.exp(-2.0)), rel=1e-6)
    np.testing.assert_allclose(kept[0][2], [(0.5 - 0.1) * 96, (0.5 - 0.2) * 64,
                                            (0.5 + 0.1) * 96, (0.5 + 0.2) * 64], rtol=1e-5)
    np.testing.assert_allclose(kept[1][2], [(0.9 - 0.05) * 96, (0.6 - 0.1) * 64,
                                            (0.9 + 0.05) * 96, (0.6 + 0.1) * 64], rtol=1e-5)
    assert float(det.scores[0][~det.valid[0]].abs().max()) == 0.0
    scale, py, px = 0.5, 4, 8
    out = pp.unletterbox_boxes(det.boxes, scale, py, px)
    np.testing.assert_allclose(out[0, :, 0].numpy(), (det.boxes[0, :, 0].numpy() - px) / scale,
                               rtol=1e-6)


def test_infer_fn_takes_no_nms_and_yolo_keeps_its_own(ckpt, frames):
    """RT-DETR's ``_infer_fn`` enters ``detect.decode`` and never
    ``detect.nms`` nor its ``sweeps``; it counts ``anchors`` inside
    ``clip.decoder``, which holds one ``clip.deform`` a decoder layer. The
    YOLO branch is decode, NMS and un-letterbox as before, on the bundled
    YOLOv8n."""
    det = detector(ckpt)
    timer = StageTimer()
    with timer.active():
        out = det._infer_fn(IMGSZ, 0.25, 0.45)(frames[:2])
    names = [s[0] for s in timer.spans]
    assert "detect.decode" in names and "detect.nms" not in names
    assert "sweeps" not in timer.counters
    assert timer.counters["anchors"] == sum((IMGSZ[0] // s) * (IMGSZ[1] // s) for s in (8, 16, 32))
    assert names.count("clip.decoder") == 1 and names.count("clip.deform") == SPEC.decoder_layers
    assert out.boxes.shape == (2, SPEC.num_queries, 4)

    yolo = ObjectDetector(model="yolov8n", load_world=False, device="cpu")
    assert yolo.weights_loaded
    timer = StageTimer()
    with timer.active():
        got = yolo._infer_fn(64, 0.01, 0.45)(frames[:2])
    assert "detect.nms" in [s[0] for s in timer.spans] and timer.counters["sweeps"] >= 1
    (box_l, cls_l), (scale, py, px) = yolo.head_logits(frames[:2], 64)
    boxes, scores = pp.decode_predictions(box_l, cls_l, yolo.model.cfg.strides,
                                          yolo.model.cfg.reg_max)
    want = pp.nms_fixed(boxes, scores, 0.01, 0.45)
    want = want._replace(boxes=pp.unletterbox_boxes(want.boxes, scale, py, px))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_clip_and_mosaic_passes_run_it(ckpt, frames):
    """``process_clip(det_fn=_infer_fn(...))`` detects each window's frames
    as the detector does alone; ``run_mosaic``'s window loop and fused
    chunks detect every frame through it; ``detect_objects`` runs its
    full-image passes through it."""
    from rtvm_tpu_torch.config import MosaicConfig
    from rtvm_tpu_torch.mosaic.stitcher import VideMosaic
    from rtvm_tpu_torch.pipelines.mosaic_pipeline import run_mosaic

    det = detector(ckpt)
    fn = det._infer_fn(IMGSZ, 0.25, 0.45)
    clip = frames[1:9].numpy().reshape(2, 4, *frames.shape[1:])
    m = VideMosaic(frames[0].numpy(), detector_type="orb", config=MosaicConfig(window_size=4),
                   device="cpu")
    _, dets = m.process_clip(clip, det_fn=fn)
    alone = fn(frames[1:9])
    assert dets.boxes.shape == (2, 4, SPEC.num_queries, 4)
    assert torch.equal(dets.valid.reshape(8, -1), alone.valid)
    assert torch.allclose(dets.boxes.reshape(8, -1, 4), alone.boxes, atol=1e-3)
    found = det.detect_objects(frames[5].numpy())
    assert isinstance(found, list)
    runs = [run_mosaic(frames[:9].numpy(), config=MosaicConfig(window_size=4),
                       detector_type="orb", per_frame_detector=det, fused=fused,
                       device="cpu")[1] for fused in (False, True)]
    assert runs[0]["per_frame_detections"] >= 0
    assert runs[1]["det_scores_shape"][-1] == SPEC.num_queries


def test_the_reference_is_transformers_rtdetr(ckpt, frames):
    """The reference against ``transformers``' ``RTDetrForObjectDetection``
    of the same size on the same state_dict: the encoder's class logits and
    box logits (valid anchors), the selected queries' final boxes and class
    logits, in the top-k's order."""
    tr = pytest.importorskip("transformers")
    bc = tr.RTDetrResNetConfig(num_channels=3, embedding_size=16, hidden_sizes=[32, 64, 128, 256],
                               depths=[1, 1, 1, 1], layer_type="bottleneck", hidden_act="relu",
                               downsample_in_first_stage=False, downsample_in_bottleneck=False,
                               out_indices=[2, 3, 4])
    cfg = tr.RTDetrConfig(backbone_config=bc, encoder_in_channels=[64, 128, 256],
                          encoder_hidden_dim=48, encoder_ffn_dim=64, encoder_attention_heads=4,
                          d_model=32, decoder_in_channels=[48, 48, 48], decoder_ffn_dim=64,
                          decoder_layers=2, decoder_attention_heads=4, num_queries=20,
                          num_labels=NC)
    model = tr.RTDetrForObjectDetection(cfg).eval()
    w = ref.load(ckpt, YC, "cpu")
    missing, extra = model.load_state_dict(w.t, strict=False)
    assert extra == []
    assert all(k.endswith("num_batches_tracked") or k.startswith(("class_embed.", "bbox_embed."))
               or k == "model.denoising_class_embed.weight" for k in missing)
    x = ref.letterbox(frames[3:5], IMGSZ)[0]
    with torch.no_grad():
        out = model(pixel_values=x)
        (box, cls), (idx, logit, cls_q) = ref.forward(w, YC, x)
    enc_cls = torch.cat([c[:, :NC].flatten(2) for c in cls], 2).transpose(1, 2)
    enc_box = torch.cat([b[:, :4].flatten(2) for b in box], 2).transpose(1, 2)
    anchors, valid = ref.anchors(ref.shapes(YC, IMGSZ), "cpu")
    torch.testing.assert_close(enc_cls, out.enc_outputs_class, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close((enc_box + anchors)[:, valid],
                               out.enc_outputs_coord_logits[:, valid], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(torch.sigmoid(logit), out.pred_boxes, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cls_q, out.logits, rtol=1e-4, atol=1e-4)
