"""YOLOv8-Worldv2 in the port (``models/yolo/modules.py``: MaxSigmoidAttnBlock,
C2fAttn, BNContrastiveHead, WorldDetectHead; ``model.py``'s worldv2 variants)
against the benchmark's plain reference ``bench_port/reference/yolo_world.py``,
on weights drawn by the reference's ``draw`` and written by
``bench_port/lib/weights.py``, as the benchmark's seeded cell loads them. The
JAX package has no Worldv2. On the CPU at small sizes: the n scale at 64x96,
and x at 64x96 for its widths."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.lib import traffic
from bench_port.lib import weights as seeded
from bench_port.reference import yolo_world as ref
from rtvm_tpu_torch.detect.detector import ObjectDetector
from rtvm_tpu_torch.models.yolo.convert import flax_to_state_dict
from rtvm_tpu_torch.models.yolo.model import VARIANTS_WORLDV2, YOLOWorldV2, YoloConfig
from rtvm_tpu_torch.models.yolo.modules import MaxSigmoidAttnBlock
from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 2020
IMGSZ = (64, 96)
NC = 17
SCALES = {"n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024), "m": (0.67, 0.75, 768),
          "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512)}  # yolov8-worldv2.yaml


def config(scale: str) -> dict:
    """The benchmark configuration's yolo block at another scale of the yaml."""
    yc = json.loads((ROOT / "bench_port/configs/orb1080-yolov8x-worldv2.json").read_text())["yolo"]
    d, w, mc = SCALES[scale]
    return dict(yc, variant=f"yolov8{scale}-worldv2", depth_multiple=d, width_multiple=w,
                max_channels=mc)


@pytest.fixture(scope="module")
def frames():
    mix = json.loads((ROOT / "bench_port/traffic/fused.json").read_text())
    orbit = traffic.make_orbit(SEED, (90, 160), dict(mix, window_size=16, period_windows=1))
    return torch.from_numpy(orbit["frames"])


@pytest.fixture(scope="module")
def ckpt(frames, tmp_path_factory):
    """ckpt(scale): the path of that scale's checkpoint, drawn on 4 frames
    of the orbit and written as the benchmark writes it (once a scale)."""
    tmp, made = tmp_path_factory.mktemp("worldv2"), {}

    def get(scale: str) -> str:
        if scale not in made:
            yc = config(scale)
            made[scale] = str(tmp / f"yolov8{scale}-worldv2.npz")
            seeded.write_checkpoint(made[scale], ref.draw(yc, SEED, frames[::4][:4], IMGSZ),
                                    seeded.class_names(yc))
        return made[scale]

    return get


def detector(path: str, scale: str) -> ObjectDetector:
    return ObjectDetector(model=f"yolov8{scale}-worldv2", weights_path=path, load_world=False,
                          device="cpu")


def test_max_sigmoid_attention_is_the_equation():
    """(a) One block against aw = sigmoid(max_k sum_j x[m, j] g[k, m, j] /
    sqrt(32) + bias[m]), out = ConvBn3x3(x) * aw per head, written out."""
    torch.manual_seed(0)
    blk = MaxSigmoidAttnBlock(64, 2, 512).eval()
    with torch.no_grad():
        blk.bias.copy_(torch.randn(2))
        blk.ConvBn_0.BatchNorm_0.mean.copy_(torch.randn(64) * 0.1)
        blk.ConvBn_0.BatchNorm_0.var.copy_(torch.rand(64) + 0.5)
    x, text = torch.randn(2, 64, 5, 7), torch.randn(3, 512)
    with torch.no_grad():
        got = blk(x, text)
        g = text @ blk.Dense_0.weight.T + blk.Dense_0.bias  # [K, 64]
        proj = blk.ConvBn_0(x)
        want = torch.empty_like(proj)
        for m in range(2):
            ch = slice(32 * m, 32 * (m + 1))
            dots = torch.stack([(x[:, ch] * g[k, ch, None, None]).sum(1) for k in range(3)])
            aw = torch.sigmoid(dots.max(0).values / 32 ** 0.5 + blk.bias[m])
            want[:, ch] = proj[:, ch] * aw[:, None]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale", ["n", "x"])
def test_head_logits_match_the_reference(scale, frames, ckpt):
    """(b) ObjectDetector's head logits against the reference's heads: in
    float32 to a float32 tolerance (2e-5 of each output's largest logit:
    the same sums in other orders); in bf16 within a relative RMS of 0.02
    (bf16 keeps 8 bits, a relative rounding of 0.4% a step, which some 40
    layers pile up; the reference in fp8 reads 0.04-0.08 here)."""
    path = ckpt(scale)
    det, yc = detector(path, scale), config(scale)
    assert det.weights_loaded and det.class_names == yc["classes"]
    fr = frames[[1, 9]]
    (pb, pc), geo = det.head_logits(fr, IMGSZ, torch.float32)
    (rb, rc), rgeo = ref.heads(ref.load(path, yc, "cpu"), yc, fr, IMGSZ)
    assert geo == rgeo and [c.shape[1] for c in pc] == [NC] * 3
    for a, b in zip(pb + pc, rb + rc):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5 * float(b.abs().max()))
    (qb, qc), _ = det.head_logits(fr, IMGSZ, torch.bfloat16)
    r = torch.cat([t.flatten() for t in rb + rc])
    q = torch.cat([t.flatten() for t in qb + qc])
    assert float((q - r).norm() / r.norm()) < 0.02


def test_the_vocabulary_conditions_the_network(ckpt):
    """(c) Permuting the text rows permutes the class logits and leaves the
    boxes; changing one row moves the box logits, through the neck."""
    det = detector(ckpt("n"), "n")
    x = torch.rand(2, 3, *IMGSZ)
    model = det.model
    with torch.no_grad():
        box, cls = model(x)
        text = model.txt_feats.clone()
        perm = torch.randperm(NC, generator=torch.Generator().manual_seed(1))
        model.txt_feats.copy_(text[perm])
        box_p, cls_p = model(x)
        for a, b in zip(box, box_p):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        for a, b in zip(cls, cls_p):
            torch.testing.assert_close(a[:, perm], b, rtol=1e-5, atol=1e-5)
        moved = text.clone()
        moved[3] = torch.nn.functional.normalize(torch.randn(512), dim=0)
        model.txt_feats.copy_(moved)
        box_m, _ = model(x)
        model.txt_feats.copy_(text)
    assert all(float((a - b).abs().max()) > 1e-3 for a, b in zip(box, box_m))


@pytest.mark.parametrize("variant", sorted(VARIANTS_WORLDV2))
def test_a_drawn_checkpoint_loads_without_missing_or_extra_keys(variant, ckpt):
    """(d) Each scale's drawn checkpoint, written as the benchmark writes it,
    has exactly the model's keys and shapes."""
    sd = flax_to_state_dict(load_pytree_npz(ckpt(variant[len("yolov8")])), variant)
    with torch.device("meta"):
        model = YOLOWorldV2(YoloConfig(variant=variant, num_classes=NC))
    missing, extra = model.load_state_dict(sd, strict=False, assign=True)
    assert missing == [] and extra == []
    assert model.txt_feats.shape == (NC, 512)


def test_flops_are_the_counters(frames):
    """(e) The reference's FLOP count is torch's count of its own forward
    (every convolution, the guides' Linears and both einsums)."""
    yc = config("n")
    w = ref.Weights(ref.draw(yc, SEED, frames[:2], IMGSZ), "cpu")
    with FlopCounterMode(display=False) as counter:
        ref.forward(w, yc, torch.rand(1, 3, *IMGSZ))
    assert counter.get_total_flops() == ref.flops(yc, IMGSZ)
    yx = config("x")
    assert ref.flops(yx, (768, 1280)) == pytest.approx(652.96e9, rel=1e-4)


def test_the_gates_are_not_constant(frames):
    """(f) On the calibration frames, at least half of every block's
    attention weights lie in (0.1, 0.9)."""
    yc = config("n")
    calib = frames[::4][:4]
    flat = ref.draw(yc, SEED, calib, IMGSZ)
    gates = {}

    class Recording(ref.Weights):
        def attn_logit(self, z, path):
            out = super().attn_logit(z, path)
            gates[path] = torch.sigmoid(out)
            return out

    ref.heads(Recording(flat, "cpu"), yc, calib, IMGSZ)
    assert len(gates) == 4
    for path, aw in gates.items():
        assert float(((aw > 0.1) & (aw < 0.9)).float().mean()) >= 0.5, path


def test_the_attention_span_in_a_trace(ckpt):
    """(g) One ``clip.attn`` a MaxSigmoidAttnBlock: 4 in a profiler trace of
    one forward."""
    model = detector(ckpt("n"), "n").model
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(torch.rand(1, 3, *IMGSZ))
    assert sum(1 for e in prof.events() if e.name == "clip.attn") == 4

