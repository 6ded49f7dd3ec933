"""The check sees a broken timed path: the rest of a run (set-up, the
window, the check) on the CPU at a small size, without the look for a
card, with a fault planted under the entry. Each fault has to turn
``correct`` false through the number it breaks."""

import copy
import time
from pathlib import Path

import pytest
import torch

import bench_port.run as bench_run
from bench_port.lib import check, entries
from bench_port.lib.faults import FAULTS, Patch
from bench_port.lib.harness import run_cell

SEED = 2**31 + 4242


def tiny_spec(cell):
    spec = copy.deepcopy(bench_run.load_cell(cell))
    if spec["mix"]["entry"] == "fused":
        spec["config"]["stitch"]["frame_hw"] = [270, 480]
        spec["config"]["yolo"]["imgsz"] = [192, 320]
        spec["mix"]["chunk_windows"] = 1
    else:
        spec["config"]["stitch"]["frame_hw"] = [180, 320]
        spec["mix"]["warmup_windows"] = 1
    spec["mix"].update(period_windows=2, capture_share=1.0)
    return spec


def seeded_spec():
    """The fused cell at tiny_spec's size with weights drawn from the seed
    (80 classes, class_0 ...), its reference named."""
    spec = tiny_spec(FUSED)
    spec["config"]["yolo"].update(weights="seeded", nc=80, reference="yolo")
    return spec


def spec_of(cell):
    return seeded_spec() if cell == SEEDED else tiny_spec(cell)


def run(spec, monkeypatch, **kw):
    torch.set_num_threads(2)
    monkeypatch.setattr(check, "DET_FRAMES", 3)
    # a window of 2 s: the source stops at the first window boundary after it
    return run_cell(spec, SEED, 2.0, False, "cpu", time.perf_counter(), bench_run.read_metric,
                    bench_run.metrics_of, **kw)


LIVE, FUSED = "sift360-yolov8n.live", "orb1080-yolov8l.fused"
SEEDED = "seeded"  # seeded_spec(), no cell
CASES = [  # (fault, cell, the numbers it has to break)
    ("state_unchanged", LIVE, ("canvas_gap",)),
    ("half_batch", LIVE, ("head_rms", "det_unmatched")),
    ("boxes_altered", LIVE, ("det_unmatched",)),
    ("homography_altered", LIVE, ("h_step_p99_px",)),
    ("homography_altered", FUSED, ("h_step_p99_px",)),
    ("half_batch", SEEDED, ("head_rms",)),
    ("boxes_altered", SEEDED, ("det_unmatched",)),
]
ON_THE_CARD = [  # (fault, cell): read at the cell's own size on three seeds
    ("homography_altered", LIVE),
]


@pytest.mark.parametrize("fault, cell, numbers", CASES, ids=[f"{f}-{c}" for f, c, _ in CASES])
def test_a_fault_turns_correct_false(fault, cell, numbers, monkeypatch):
    FAULTS[fault](monkeypatch)
    if (fault, cell) == ("half_batch", SEEDED):
        # one detection call fits the window here: keep its last frame, in
        # the half of the batch that half_batch alters
        monkeypatch.setattr(entries, "_capture_rule", lambda seed, call, share, n: n - 1)
    res = run(spec_of(cell), monkeypatch)
    assert res["correct"] is False
    for n in numbers:
        c = res["checks"][n]
        assert c["value"] > c["limit"], (n, c)
    if cell == SEEDED:  # detections on both sides: the comparison had something to compare
        assert res["info"]["detections_ref"] > 0 and res["info"]["detections_prog"] > 0


def test_a_seeded_configuration_runs_correct(monkeypatch):
    """Weights drawn from the seed, written as a checkpoint, loaded by the
    port's ObjectDetector and read by the reference: correct under the
    fused cell's limits, with detections on both sides, and the checkpoint
    gone after the run."""
    import bench_port.lib.weights as seeded

    made = []
    orig = seeded.seeded_checkpoint

    def spy(*a, **kw):
        path, remove = orig(*a, **kw)
        made.append(path)
        return path, remove

    monkeypatch.setattr(seeded, "seeded_checkpoint", spy)
    res = run(seeded_spec(), monkeypatch)
    assert res["correct"] is True, res["checks"]
    assert res["info"]["detections_ref"] > 0 and res["info"]["detections_prog"] > 0
    assert len(made) == 1 and not Path(made[0]).exists()


@pytest.mark.card
@pytest.mark.parametrize("fault, cell", ON_THE_CARD, ids=[f"{f}-{c}" for f, c in ON_THE_CARD])
def test_a_fault_turns_correct_false_at_the_cells_size(fault, cell, card):
    spec = bench_run.load_cell(cell)
    numbers = next(n for f, c, n in CASES if (f, c) == (fault, cell))
    for seed in (3300000011, 3300000012, 3300000013):
        patch = Patch()
        FAULTS[fault](patch)
        try:
            res = run_cell(spec, seed, 5.0, False, "cuda", time.perf_counter(),
                           bench_run.read_metric, bench_run.metrics_of)
        finally:
            patch.undo()
        assert res["correct"] is False, (seed, res["checks"])
        assert any(res["checks"][n]["value"] > res["checks"][n]["limit"] for n in numbers)


def skip_a_file(monkeypatch):
    """The driver's export drops one frame's JPEG."""
    from rtvm_tpu_torch.pipelines import mosaic_pipeline

    orig = mosaic_pipeline.imwrite_jpg
    seen = []

    def write(path, img):
        if "warmup" not in path:
            seen.append(path)
        if len(seen) != 5 or "warmup" in path:
            orig(path, img)

    monkeypatch.setattr(mosaic_pipeline, "imwrite_jpg", write)


@pytest.mark.parametrize("fault", [None, "file_missing"])
def test_the_export_mix_and_its_files(fault, monkeypatch):
    """The window loop with the driver's Detections/ export (a mix with
    ``"export": true``; no cell takes it yet, PERF.md): its files are held
    to the frames with detections."""
    if fault:
        skip_a_file(monkeypatch)
    spec = tiny_spec(LIVE)
    spec["mix"]["export"] = True
    spec["cell"]["limits"].update(files_off=0, jpeg_bad=0)
    res = run(spec, monkeypatch)
    assert res["info"]["files"] > 0
    assert res["checks"]["jpeg_bad"]["value"] == 0
    assert res["checks"]["files_off"]["value"] == (1 if fault else 0)
