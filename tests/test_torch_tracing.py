"""The port's span recorder (rtvm_tpu_torch/utils/timing.py) on the CPU: its
clock against torch.profiler's, the Chrome trace's timestamps, the spans
and counters that the driver, the upload and the detection record, NMS's
sweep counter, the device-completion arithmetic, and that nothing is
recorded without an active timer."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtvm_tpu_torch.config import FeatureConfig, MosaicConfig
from rtvm_tpu_torch.models.yolo import postprocess as pp
from rtvm_tpu_torch.pipelines import mosaic_pipeline as TPL
from rtvm_tpu_torch.utils import timing
from rtvm_tpu_torch.utils.timing import StageTimer, count, span

CLOCK_TOL_NS = 1_000_000  # 1 ms


def _profiler_starts(prof, name):
    """Absolute (Unix ns) starts of the profiler's host events `name`."""
    base = prof.profiler.kineto_results.trace_start_ns()
    return [base + int(e.time_range.start * 1e3) for e in prof.events()
            if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]


@pytest.mark.parametrize("device_range", [False, True])
def test_a_span_starts_within_1ms_of_its_profiler_event(device_range):
    t = StageTimer()
    x = torch.randn(64, 64)
    with span("probe", device_range=device_range):  # the first entry loads the profiler's op
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof, t.active():
        for _ in range(3):
            with span("probe", device_range=device_range):
                x = x @ x / 64
    got = [t.unix_ns(r.t0) for r in t.records]
    want = _profiler_starts(prof, "probe")
    assert len(got) == len(want) == 3
    assert max(abs(a - b) for a, b in zip(got, want)) < CLOCK_TOL_NS


def test_the_chrome_trace_is_in_unix_microseconds_and_lays_over_the_profilers(tmp_path):
    t = StageTimer()
    lo = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.stage("window"):
            torch.randn(128, 128).sum()
    hi = time.time_ns()
    trace = json.loads(open(t.write_chrome_trace(str(tmp_path / "t.json"))).read())
    (ev,) = [e for e in trace["traceEvents"] if e["name"] == "window"]
    assert lo / 1e3 - 1 <= ev["ts"] <= hi / 1e3 + 1
    assert ev["args"] == {"index": 0, "parent": -1, "request": None}
    (want,) = _profiler_starts(prof, "window")
    assert abs(ev["ts"] * 1e3 - want) < CLOCK_TOL_NS


def test_a_profiler_that_starts_or_stops_inside_a_span_leaves_it_whole():
    """The benchmark starts its profiler inside the driver's detect stage
    and stops it on a schedule: the spans it cuts still close, and only
    those the profiler saw open and close are in its trace."""
    t = StageTimer()
    prof = profile(activities=[ProfilerActivity.CPU])
    with t.stage("cut_at_start"):
        prof.start()
        with span("inside"):
            torch.randn(8).sum()
    with t.stage("cut_at_stop"):
        prof.stop()
    assert [r.name for r in t.records] == ["cut_at_start", "inside", "cut_at_stop"]
    assert all(r.t1 is not None for r in t.records)
    assert _profiler_starts(prof, "inside") and not _profiler_starts(prof, "cut_at_start")


def test_without_an_active_timer_nothing_is_recorded():
    t = StageTimer()
    with span("a") as rec:
        count("bytes", 5)
    assert rec is None
    assert not t.records and not t.counters and timing._local.__dict__.get("timer") is None
    with t.active():
        with span("a") as rec:
            count("bytes", 5)
        count("loose")  # outside any span: the timer's counters only
    with span("b"):
        count("bytes", 7)
    assert [r.name for r in t.records] == ["a"] and rec.counts == {"bytes": 5}
    assert t.counters == {"bytes": 5, "loose": 1} and not t.totals


def test_spans_nest_and_carry_the_request():
    t = StageTimer()
    t.request = 3
    with t.stage("window") as w:
        with span("upload") as u:
            count("bytes", 10)
            count("bytes", 6)
        with span("window.features", device_range=True) as f:
            pass
    t.request = 4
    with t.stage("detect") as d:
        with span("detect.pass") as p:
            pass
    assert (w.parent, u.parent, f.parent, d.parent, p.parent) == (-1, w.index, w.index, -1,
                                                                  d.index)
    assert [r.request for r in t.records] == [3, 3, 3, 4, 4]
    assert u.counts == {"bytes": 16} and t.counters == {"bytes": 16}
    assert dict(t.counts) == {"window": 1, "detect": 1}
    assert [s[0] for s in t.spans] == ["window", "upload", "window.features", "detect",
                                       "detect.pass"]
    assert all(len(s) == 4 for s in t.spans)


def test_the_ring_keeps_the_newest_records():
    t = StageTimer(max_spans=4)
    with t.active():
        for i in range(10):
            with span(f"s{i}"):
                pass
    assert [r.name for r in t.records] == ["s6", "s7", "s8", "s9"]
    assert [r.index for r in t.records] == [6, 7, 8, 9]


class _FakeEvent:
    """A CUDA event on the host clock: record() reads it, elapsed_time is
    the difference in ms."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter_ns() + 2_000_000  # the device runs 2 ms behind

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def test_device_completion_is_the_reference_plus_the_event_time(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    t = StageTimer()
    t.device_reference(torch.device("cpu"))
    with t.stage("window") as rec:
        t.mark_done(rec)  # no reference on the CPU: not marked
    t.resolve_done()
    assert rec.done is None
    t.device_reference(torch.device("cuda"))
    _, t_ref = t._ref
    recs = []
    for _ in range(3):
        with t.stage("window") as rec:
            time.sleep(0.002)
            t.mark_done(rec)
        recs.append(rec)
    t.resolve_done()
    for r in recs:
        # the fake's event lags its record() call by 2 ms, as the reference's does
        assert r.t0 < r.done <= r.t1 + 1_000_000
        assert r.done > t_ref


def _chain(n, step=2.0, side=10.0):
    """n boxes in a row, each overlapping its neighbours at IoU 0.67 and
    the next but one at 0.43, with falling scores: greedy NMS at 0.45 keeps
    every other box, and the Jacobi sweep settles one box a sweep."""
    x0 = torch.arange(n, dtype=torch.float32) * step
    boxes = torch.stack([x0, torch.zeros(n), x0 + side, torch.full((n,), side)], -1)[None]
    scores = (0.9 - 0.01 * torch.arange(n, dtype=torch.float32))[None, :, None]
    return boxes, scores


def _sweeps(boxes, scores, iou_th):
    """nms_fixed's loop, counted: sweeps until the keep set stops changing."""
    iou = pp._iou_matrix(boxes[0]).numpy()
    k = iou.shape[0]
    sup = (iou > iou_th) & (np.arange(k)[:, None] < np.arange(k)[None, :])
    keep0 = scores[0, :, 0].numpy() >= 0.25
    keep, n = keep0, 0
    while n < k:
        nxt = keep0 & ~np.any(sup & keep[:, None], axis=0)
        n += 1
        if np.array_equal(nxt, keep):
            break
        keep = nxt
    return n, keep


@pytest.mark.parametrize("n", [1, 6, 13])
def test_nms_counts_one_sweep_per_host_read(n):
    boxes, scores = _chain(n)
    want, keep = _sweeps(boxes, scores, 0.45)
    assert want >= (n + 1) // 2  # the chain needs a sweep for each box it settles
    t = StageTimer()
    with t.active(), span("detect.nms") as rec:
        det = pp.nms_fixed(boxes, scores, 0.25, 0.45)
    assert rec.counts == {"sweeps": want} and t.counters["sweeps"] == want
    assert det.valid[0].numpy().tolist() == keep.tolist()
    assert keep.tolist() == [i % 2 == 0 for i in range(n)]


@pytest.fixture(scope="module")
def traced_run():
    """A tiny CPU run_mosaic (2 windows of 4 frames, 96x160) with the
    bundled YOLOv8n as the per-frame detector, its timer's records."""
    from rtvm_tpu_torch.detect.detector import ObjectDetector

    rng = np.random.RandomState(3)
    world = rng.randint(0, 255, (120, 220, 3)).astype(np.uint8)
    frames = np.stack([world[2 * i : 2 * i + 96, 3 * i : 3 * i + 160] for i in range(9)])
    det = ObjectDetector(model="yolov8n", load_world=False, device="cpu")
    cfg = MosaicConfig(window_size=4, features=FeatureConfig(detector_type="orb",
                                                             max_keypoints=128))
    timer = StageTimer()
    TPL.run_mosaic(frames, config=cfg, detector_type="orb", timer=timer, per_frame_detector=det,
                   device="cpu")
    return timer


PARENTS = {"init": None, "window": None, "detect": None, "upload": "window",
           "detect.pass": "detect", "detect.preprocess": "detect.pass",
           "detect.model": "detect.pass", "detect.decode": "detect.pass",
           "detect.nms": "detect.pass", "detect.read": "detect.pass",
           "detect.dicts": "detect.pass"}  # the window step's window.* spans: "window"


def test_run_mosaic_records_the_driver_the_upload_and_the_detection(traced_run):
    t = traced_run
    recs = list(t.records)
    by = {r.index: r for r in recs}
    names = [r.name for r in recs]
    assert names[0] == "init" and names.count("window") == 2 and names.count("detect") == 2
    for r in recs:
        assert r.t1 is not None and r.t1 >= r.t0 and r.done is None  # no card: no completion
        parent = by[r.parent].name if r.parent >= 0 else None
        assert r.name in PARENTS or r.name.startswith("window."), r.name
        want = "init" if (r.name, r.request) == ("upload", None) else PARENTS.get(r.name, "window")
        assert parent == want, (r.name, parent)
        if r.parent >= 0:  # a child lies inside its parent and shares its request
            assert by[r.parent].t0 <= r.t0 and r.t1 <= by[r.parent].t1
            assert r.request == by[r.parent].request
    for k in (0, 1):
        mine = {r.name for r in recs if r.request == k}
        assert mine == {"window", "upload", "window.features", "window.match_ransac",
                        "window.chain", "window.paint", "detect", "detect.pass",
                        "detect.preprocess", "detect.model", "detect.decode", "detect.nms",
                        "detect.read", "detect.dicts"}
    ups = [r for r in recs if r.name == "upload"]  # the first frame's (init), each window's
    assert [u.counts["bytes"] for u in ups] == [96 * 160 * 3] + [4 * 96 * 160 * 3] * 2
    reads = [r for r in recs if r.name == "detect.read"]
    assert all(r.counts["bytes"] == 4 * 300 * (16 + 4 + 4 + 1) for r in reads)
    nms = [r for r in recs if r.name == "detect.nms"]
    assert all(r.counts["sweeps"] >= 1 for r in nms)
    assert t.counters["sweeps"] == sum(r.counts["sweeps"] for r in nms)
    assert [s[0] for s in t.spans] == names


def test_run_mosaic_chrome_trace_keeps_parents_and_requests(traced_run, tmp_path):
    trace = json.loads(open(traced_run.write_chrome_trace(str(tmp_path / "t.json"))).read())
    events = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert len(events) == len(traced_run.records)
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts) and abs(ts[0] / 1e6 - time.time()) < 3600
    nms = [e for e in events if e["name"] == "detect.nms"]
    assert all(e["args"]["sweeps"] >= 1 and e["args"]["request"] in (0, 1) for e in nms)
