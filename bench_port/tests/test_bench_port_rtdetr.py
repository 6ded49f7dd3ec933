"""The RT-DETR-R101 cell (``orb1080-rtdetr-r101vd.fused``): its configuration
and files, the reference's interface (``bench_port/reference/rtdetr.py``),
its FLOP count against the paper's, its draw's rule, the heads layout's
properties, the cell at a tiny size through ``run_cell`` on the CPU (the
planted faults and the fp8 control each move the number that catches
them), and, on the card, runs of the cell itself."""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import bench_port.run as bench_run
from bench_port.lib import check, entries, traffic
from bench_port.lib.faults import FAULTS
from bench_port.lib.harness import run_cell
from bench_port.reference import rtdetr

ROOT = Path(__file__).resolve().parents[2]
CELL = "orb1080-rtdetr-r101vd.fused"
CONFIG = "orb1080-rtdetr-r101vd"
SEED = 2**31 + 2424
PAPER_GFLOPS_640 = 259.0  # Zhao et al., Table 2, RT-DETR-R101


def spec():
    return bench_run.load_cell(CELL)


def small_block():
    """The configuration's block at a size the CPU runs in a second."""
    return dict(spec()["config"]["yolo"], depths=[1, 1, 1, 1], embedding_size=16,
                hidden_sizes=[32, 64, 128, 256], encoder_hidden_dim=48, encoder_ffn_dim=64,
                encoder_heads=4, d_model=32, decoder_in_channels=[48, 48, 48],
                decoder_ffn_dim=64, decoder_layers=2, decoder_heads=4, num_queries=20)


def frames(n=8, hw=(90, 160)):
    mix = json.loads((ROOT / "bench_port/traffic/fused.json").read_text())
    orbit = traffic.make_orbit(SEED, hw, dict(mix, window_size=16, period_windows=1))
    return torch.from_numpy(orbit["frames"][: n * 2 : 2])


def test_the_configuration_and_its_files():
    """The published R101 widths, 80 classes, nothing reduced, the seeded
    route, the YOLOv8l cell's stitch byte for byte, and the port's variant
    built at the same widths."""
    from rtvm_tpu_torch.models.rtdetr.model import VARIANTS_RTDETR

    s = spec()
    bench = s["bench"]
    conf = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert conf["reduced"] == [] and conf["source"].startswith("https://huggingface.co/PekingU/")
    cfg = s["config"]
    assert cfg["reduced"] == [] and cfg["assumed"]
    yc = cfg["yolo"]
    assert (yc["variant"], yc["reference"], yc["weights"], yc["nc"]) == \
        ("rtdetr-r101vd", "rtdetr", "seeded", 80)
    assert len(yc["classes"]) == 80 and yc["imgsz"] == [768, 1280] and yc["conf"] == 0.25
    port = VARIANTS_RTDETR[yc["variant"]]
    r = rtdetr.spec(yc)
    assert dict(r, nc=None) == dict(cfg["rtdetr"], nc=None)  # the file's published widths
    assert list(port.depths) == r["depths"] == [3, 4, 23, 3]
    assert (port.encoder_hidden_dim, port.encoder_ffn_dim, port.d_model, port.decoder_ffn_dim,
            port.decoder_layers, port.num_queries, port.n_points) == \
        (r["encoder_hidden_dim"], r["encoder_ffn_dim"], r["d_model"], r["decoder_ffn_dim"],
         r["decoder_layers"], r["num_queries"], r["n_points"]) == (384, 2048, 256, 1024, 6, 300, 4)
    assert r["decoder_in_channels"] == [port.encoder_hidden_dim] * 3
    l_cfg = bench_run.load_cell("orb1080-yolov8l.fused")["config"]
    assert cfg["stitch"] == l_cfg["stitch"]
    assert s["mix"] == bench_run.load_cell("orb1080-yolov8l.fused")["mix"]
    for m in ("decoder_device_ms_per_frame", "deform_roofline"):
        assert (ROOT / "bench_port/metrics" / f"{m}.py").exists()
        assert m in [x["name"] for x in bench_run.metrics_of(bench, CELL, "per_layer")]


def test_the_reference_interface():
    """load, heads, detect, flops, draw, deform_work; nothing of the port,
    of JAX or of transformers imported by the module."""
    for name in ("load", "heads", "detect", "flops", "draw", "deform_work"):
        assert callable(getattr(rtdetr, name))
    src = Path(rtdetr.__file__).read_text()
    for bad in ("rtvm_tpu", "jax", "transformers"):
        assert f"import {bad}" not in src and f"from {bad}" not in src
    yc = spec()["config"]["yolo"]
    nbytes, nflops = rtdetr.deform_work(yc, (768, 1280), 96)
    one = rtdetr.deform_work(yc, (768, 1280), 1)
    assert nflops == pytest.approx(96 * one[1])
    # per frame and layer: the value projection's input read once (20,160 x
    # 256 bf16, 10.3 MB; no value map) and the rest, about 11 MB
    assert 10.5e6 < one[0] / 6 < 12e6


def test_flops_at_640_are_the_papers():
    """2 x the multiply-adds at 640x640 within 1% of the paper's 259 GFLOPs
    (the paper's count of the same layers; the bilinear taps are 0.02%)."""
    yc = spec()["config"]["yolo"]
    assert rtdetr.flops(yc, (640, 640)) == pytest.approx(PAPER_GFLOPS_640 * 1e9, rel=0.01)
    assert rtdetr.flops(yc, (768, 1280)) == pytest.approx(619.46e9, rel=1e-4)


def test_the_draw_keeps_sixteen_queries_over_conf_on_every_frame():
    yc = small_block()
    calib = frames(8)
    imgsz = (128, 192)
    w = rtdetr.Weights(rtdetr.draw(yc, SEED, calib, imgsz), "cpu")
    with torch.no_grad():
        _, (_, _, cls_q) = rtdetr.forward(w, yc, rtdetr.letterbox(calib, imgsz)[0])
    over = (torch.sigmoid(cls_q).amax(-1) > yc["conf"]).sum(1)
    assert int(over.min()) >= rtdetr.CANDIDATES


def test_the_layout_ignores_the_top_k_order_and_a_swap_costs_its_cells():
    """(a) The heads do not depend on the order of the selected queries;
    (b) a query that one side selects and the other does not changes the
    two cells it concerns and nothing else."""
    torch.manual_seed(0)
    shapes = [(4, 6), (2, 3), (1, 2)]
    a, nc, q = 32, 3, 5
    enc_box, enc_cls = torch.randn(1, a, 4), torch.randn(1, a, nc)
    idx = torch.tensor([[3, 17, 8, 30, 25]])
    logit, cls_q = torch.randn(1, q, 4), torch.randn(1, q, nc)
    base = rtdetr.layout(enc_box, enc_cls, idx, logit, cls_q, shapes)
    perm = torch.tensor([4, 2, 0, 1, 3])
    again = rtdetr.layout(enc_box, enc_cls, idx[:, perm], logit[:, perm], cls_q[:, perm], shapes)
    flat = lambda h: torch.cat([t.flatten() for t in h[0] + h[1]])  # noqa: E731
    assert torch.equal(flat(base), flat(again))
    swapped = idx.clone()
    swapped[0, 1] = 11  # the other side selected anchor 11 in the place of 17
    other = rtdetr.layout(enc_box, enc_cls, swapped, logit, cls_q, shapes)
    cells = lambda h: torch.cat([torch.cat([b.flatten(2), c.flatten(2)], 1)  # noqa: E731
                                 for b, c in zip(*h)], 2)[0]  # [8 + 2C + 1, A]
    changed = (cells(base) != cells(other)).any(0).nonzero().flatten().tolist()
    assert changed == [11, 17]


def test_the_programs_postprocess_reads_the_references_heads():
    """(c) The port's NMS-free post-process on the reference's heads gives
    the reference's own detections (the fp8 control runs it so)."""
    from rtvm_tpu_torch.models.rtdetr.postprocess import select_detections
    from rtvm_tpu_torch.models.yolo.postprocess import unletterbox_boxes

    yc, imgsz = small_block(), (128, 192)
    fr = frames(8)
    w = rtdetr.Weights(rtdetr.draw(yc, SEED, fr, imgsz), "cpu")
    (box, cls), (scale, py, px) = rtdetr.heads(w, yc, fr[:3], imgsz)
    det = select_detections(box, cls, yc["num_queries"], imgsz, yc["conf"])
    boxes = unletterbox_boxes(det.boxes, scale, py, px)
    want, _ = rtdetr.detect(w, yc, fr[:3], imgsz, yc["conf"], yc["iou"])
    for i, ds in enumerate(want):
        got = sorted(boxes[i][det.valid[i]].tolist())
        assert len(got) == len(ds) > 0
        for g, d in zip(got, sorted(d["box"].tolist() for d in ds)):
            assert max(abs(x - y) for x, y in zip(g, d)) < 1e-3


def tiny_spec():
    s = copy.deepcopy(spec())
    s["config"]["stitch"]["frame_hw"] = [270, 480]
    s["config"]["yolo"]["imgsz"] = [192, 320]
    s["mix"]["chunk_windows"] = 1
    s["mix"].update(period_windows=2, capture_share=1.0)
    return s


def run(monkeypatch, **kw):
    torch.set_num_threads(2)
    monkeypatch.setattr(check, "DET_FRAMES", 2)
    return run_cell(tiny_spec(), SEED, 2.0, False, "cpu", time.perf_counter(),
                    bench_run.read_metric, bench_run.metrics_of, **kw)


@pytest.fixture(scope="module")
def sound():
    mp = pytest.MonkeyPatch()
    try:
        return run(mp)
    finally:
        mp.undo()


def test_the_cell_runs_at_a_tiny_size(sound):
    """The full-width R101 at 192x320: the stitch's checks hold, both sides
    detect. (Its detection numbers are not the cell's: at 1,260 anchors the
    300 queries weigh ten times what they do among 20,160.)"""
    c = sound["checks"]
    for n in ("h_step_p99_px", "flags_off", "outside_px", "canvas_gap"):
        assert c[n]["value"] <= c[n]["limit"], (n, c[n])
    assert sound["info"]["detections_ref"] > 0 and sound["info"]["detections_prog"] > 0


@pytest.mark.parametrize("fault, number", [("half_batch", "head_rms"),
                                           ("boxes_altered", "det_unmatched")])
def test_a_fault_moves_its_number(fault, number, sound, monkeypatch):
    FAULTS[fault](monkeypatch)
    monkeypatch.setattr(entries, "_capture_rule", lambda seed, call, share, n: n - 1)
    res = run(monkeypatch)
    assert res["correct"] is False
    assert res["checks"][number]["value"] > max(sound["checks"][number]["value"],
                                                res["checks"][number]["limit"])


def test_the_fp8_control_moves_head_rms(sound, monkeypatch):
    res = run(monkeypatch, control="fp8")
    assert res["checks"]["head_rms"]["value"] > 2 * sound["checks"]["head_rms"]["value"]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_on_the_card(trace, card):
    """One short run of the cell: correct, and traced, the two new
    per-layer metrics, the roofline share under 100%. The traced run is
    30 s: its profiler starts after 2 calls and keeps 3 after a warm-up
    one, at some 1.1-1.7 s a call of 96 frames."""
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", CELL, "--seed",
                          str(SEED), "--seconds", "30" if trace else "10", "--trace",
                          str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    if trace:
        m = res["metrics"]
        assert m["decoder_device_ms_per_frame"]["value"] > 0
        assert 0 < m["deform_roofline"]["value"] < 100
        assert m["detect_device_ms_per_frame"]["value"] > m["decoder_device_ms_per_frame"]["value"]
