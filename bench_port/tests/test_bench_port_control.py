"""The control has to come out as not correct: a whole run of the cell with
one precision below the configuration's in the program's place (the
reference YOLO in fp8 for the bf16 model; TF32 for the float32 stitch) is
checked as a benchmark run is and reads ``correct`` false. On the CPU at a
size a test can hold; on the card at each cell's own size (``-m card``)."""

import json
import time
from pathlib import Path

import pytest

import bench_port.run as bench_run
from bench_port.lib.harness import CONTROLS, run_cell
from bench_port.tests.test_bench_port_faults import LIVE, SEEDED, run, spec_of

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", [LIVE, SEEDED])
def test_fp8_control_fails_on_the_cpu(cell, monkeypatch):
    """The live cell's bundled YOLOv8n, and the fused cell with weights
    drawn from the seed: the fp8 reference stands in for the detector's
    head logits."""
    res = run(spec_of(cell), monkeypatch, control="fp8")
    assert res["correct"] is False
    assert res["checks"]["head_rms"]["value"] > res["checks"]["head_rms"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("control", CONTROLS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell, control, card):
    spec = bench_run.load_cell(cell)
    for seed in (3300000001, 3300000002, 3300000003):
        res = run_cell(spec, seed, 5.0, False, "cuda", time.perf_counter(),
                       bench_run.read_metric, bench_run.metrics_of, control=control)
        assert res["correct"] is False, (seed, res["checks"])
