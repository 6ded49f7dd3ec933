"""The YOLOv8-Worldv2-X cell (``orb1080-yolov8x-worldv2.fused``) at the tiny
size of ``test_bench_port_faults.py:tiny_spec``, through ``run_cell`` on the
CPU: correct on three seeds under the cell's own limits; the planted faults
and the fp8 control each turn it false. And the attention's work, counted
by hand at one shape."""

import copy
import time

import pytest
import torch

import bench_port.run as bench_run
from bench_port.lib import check, entries
from bench_port.lib.faults import FAULTS
from bench_port.lib.harness import run_cell
from bench_port.reference import yolo_world

CELL = "orb1080-yolov8x-worldv2.fused"
SEED = 2**31 + 2020


def tiny_spec():
    spec = copy.deepcopy(bench_run.load_cell(CELL))
    spec["config"]["stitch"]["frame_hw"] = [270, 480]
    spec["config"]["yolo"]["imgsz"] = [192, 320]
    spec["mix"]["chunk_windows"] = 1
    spec["mix"].update(period_windows=2, capture_share=1.0)
    return spec


def run(monkeypatch, seed=SEED, **kw):
    torch.set_num_threads(2)
    monkeypatch.setattr(check, "DET_FRAMES", 3)
    return run_cell(tiny_spec(), seed, 2.0, False, "cpu", time.perf_counter(),
                    bench_run.read_metric, bench_run.metrics_of, **kw)


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_the_cell_runs_correct(seed, monkeypatch):
    res = run(monkeypatch, seed)
    assert res["correct"] is True, res["checks"]
    assert res["info"]["detections_ref"] > 0 and res["info"]["detections_prog"] > 0


@pytest.mark.parametrize("fault, numbers", [("half_batch", ("head_rms",)),
                                            ("boxes_altered", ("det_unmatched",))])
def test_a_fault_turns_correct_false(fault, numbers, monkeypatch):
    FAULTS[fault](monkeypatch)
    # one detection call fits the window here: keep its last frame, in the
    # half of the batch that half_batch alters
    monkeypatch.setattr(entries, "_capture_rule", lambda seed, call, share, n: n - 1)
    res = run(monkeypatch)
    assert res["correct"] is False
    for n in numbers:
        assert res["checks"][n]["value"] > res["checks"][n]["limit"], (n, res["checks"][n])


def test_the_fp8_control_turns_correct_false(monkeypatch):
    res = run(monkeypatch, control="fp8")
    assert res["correct"] is False
    assert res["checks"]["head_rms"]["value"] > res["checks"]["head_rms"]["limit"]


def test_attn_work_by_hand():
    """x at 64x96: the blocks at strides 16, 8, 16, 32 with 320, 160, 320,
    320 channels and 10, 5, 10, 10 heads."""
    yc = tiny_spec()["config"]["yolo"]
    blocks = [(320, 10, 4, 6), (160, 5, 8, 12), (320, 10, 4, 6), (320, 10, 2, 3)]
    assert [(c, nh, h, w) for _, c, nh, h, w in yolo_world.attn_blocks(yc, (64, 96))] == blocks
    k, frames = 17, 3
    nbytes = sum(frames * 2 * c * h * w * 2
                 + (512 * c + c + nh + 9 * c * c + 4 * c + k * 512) * 2
                 for c, nh, h, w in blocks)
    nflops = sum(frames * 2 * (9 * c * c * h * w + c * k * h * w) for c, _, h, w in blocks)
    assert yolo_world.attn_work(yc, (64, 96), frames) == (nbytes, nflops)
