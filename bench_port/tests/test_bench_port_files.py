"""BENCHMARK.json and the files it names: found by name, and within the
benchmark contract's rules for names, units and keys."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "bench_port"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["file"] for c in BENCH["configs"]]
YOLO_KEYS = {"variant", "depth_multiple", "width_multiple", "max_channels", "nc", "reg_max",
             "weights", "imgsz", "conf", "iou", "dtype"}
OPTIONAL = {"reference", "classes"}  # lib/harness.py
INTERFACE = ("load", "heads", "detect", "flops", "draw")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    wl = next(w for w in BENCH["workloads"] if w["name"] == cell)
    conf = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert (ROOT / conf["file"]).is_file() and conf["file"].startswith("bench_port/")
    c = json.loads((HERE / "cells" / f"{cell}.json").read_text())
    assert (c["config"], c["traffic"]) == (wl["config"], wl["traffic"])
    mix = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    assert mix["entry"] in ("window_loop", "fused")
    assert wl["chips"] == 1
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert any((HERE / "metrics" / f"{n}.py").is_file()
                       for n in (m["name"], m["name"].split(".")[0]))


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["source"].startswith("https://")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    all_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(all_names)) == len(all_names)


def test_metric_cells():
    """Each cell reports setup_s, another end-to-end metric and a per-layer
    one; a per-layer metric's cells all report the metric it moves; a cell
    with a kernel's roofline reports the step's mfu beside it, moving the
    same metric; each metric name has a reader file (its own, or that of
    its part before the first dot)."""
    by = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert by["window_ms_p95"]["workloads"] == ["sift360-yolov8n.live"]
    assert by["patches_roofline"]["workloads"] == ["sift360-yolov8n.live"]

    def cells_of(m):
        return m.get("workloads", CELLS)

    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in cells_of(m)]
        per = [m for m in BENCH["per_layer"] if cell in cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        assert all(m["moves"] in e2e for m in per)
        for r in per:
            if "_roofline" in r["name"]:
                assert any("mfu" in m["name"] and m["moves"] == r["moves"] for m in per)


@pytest.mark.parametrize("file", CONFIGS)
def test_a_configurations_model_keys(file):
    """The ``yolo`` block: the model's sizes, and the optional keys that
    name its reference and its weights (lib/harness.py)."""
    yc = json.loads((ROOT / file).read_text())["yolo"]
    assert YOLO_KEYS <= set(yc) and set(yc) <= YOLO_KEYS | OPTIONAL
    assert NAME.match(yc.get("reference", "yolo"))
    assert (HERE / "reference" / f"{yc.get('reference', 'yolo')}.py").is_file()
    if yc["weights"] == "seeded":
        assert len(yc.get("classes", range(yc["nc"]))) == yc["nc"]
    else:
        assert yc["weights"].endswith(".npz") and "classes" not in yc
        assert (ROOT / yc["weights"][: -len(".npz")]).with_suffix(".json").is_file()


@pytest.mark.parametrize("name", sorted({json.loads((ROOT / f).read_text())["yolo"]
                                         .get("reference", "yolo") for f in CONFIGS}))
def test_a_named_reference_has_the_interface(name):
    mod = importlib.import_module(f"bench_port.reference.{name}")
    assert all(callable(getattr(mod, f, None)) for f in INTERFACE)
