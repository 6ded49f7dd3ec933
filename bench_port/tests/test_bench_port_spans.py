"""The readers of the program's spans (lib/spans.py and the metrics
window_host_ms, window_done_ms, detect_host_ms, nms_sweeps, window_idle_ms
and detect_idle_ms): the gap attribution on a synthetic reduced trace, the
choice of the untraced windows on a synthetic recorder, None where there is
nothing to read, and the readers on a traced run of the live entry at a
small size on the CPU."""

import copy
import time
from types import SimpleNamespace

import pytest
import torch

import bench_port.run as bench_run
from bench_port.lib import check, spans
from bench_port.lib.harness import run_cell

NEW = ("window_host_ms", "window_done_ms", "detect_host_ms", "nms_sweeps", "window_idle_ms",
       "detect_idle_ms")


def _host(*events):
    return [(n, float(a), float(b)) for n, a, b in events]


# one traced window, in microseconds: the driver's stages with the program's
# spans inside, the benchmark's bench.detect around the detection pass, a
# host operation, and a stretch outside every span
RED = {
    "host": _host(
        ("window", 0, 400), ("upload", 0, 50), ("aten::copy_", 10, 45),
        ("window.features", 50, 200), ("window.paint", 200, 380),
        ("detect", 400, 900), ("bench.detect", 405, 895), ("detect.pass", 410, 890),
        ("detect.model", 410, 500), ("detect.nms", 500, 800), ("detect.read", 800, 850),
        ("ProfilerStep#3", 0, 1000),
    ),
    "gaps": [(20, 40), (100, 110), (380, 400), (550, 650), (860, 880), (895, 899),
             (950, 990)],
}


def test_each_gap_goes_to_the_innermost_program_span():
    got = spans.idle_by_span(RED)
    assert got == pytest.approx({
        "upload": 20e-6,  # inside an aten op inside the upload: the upload
        "window.features": 10e-6, "window": 20e-6,
        "detect.nms": 100e-6, "detect.pass": 20e-6,  # bench.detect looked through
        "detect": 4e-6,  # in bench.detect but out of detect.pass: the stage
        None: 40e-6,  # under no program span (the profiler's step is none)
    })


def test_idle_by_layer_per_traced_window():
    two = {"host": RED["host"] + _host(("window.features", 1000, 1100)), "gaps": RED["gaps"]}
    assert spans.idle_ms_per_window(two, spans.window_layer) == pytest.approx(50e-3 / 2)
    assert spans.idle_ms_per_window(two, spans.detect_layer) == pytest.approx(124e-3 / 2)


def test_a_trace_of_the_parent_reads_the_window_steps_spans_alone():
    """The parent program has no driver spans in the trace, only window.*
    and clip.detect: the detection's gaps under bench.detect stay
    unattributed, and nothing raises."""
    old = {"host": [h for h in RED["host"] if h[0].startswith(("window.", "bench.", "aten"))],
           "gaps": RED["gaps"]}
    got = spans.idle_by_span(old)
    assert set(got) == {"window.features", None}
    assert spans.idle_ms_per_window(old, spans.detect_layer) == 0.0


def _rec(name, request, t0_ms, dt_ms, done_ms=None, **counts):
    ns = 1_000_000
    return SimpleNamespace(name=name, request=request, t0=int(t0_ms * ns),
                           t1=int((t0_ms + dt_ms) * ns), counts=counts,
                           done=None if done_ms is None else int(done_ms * ns))


def _ctx(records, wait=3, red=None):
    return {"out": {"timer": SimpleNamespace(records=records)}, "mix": {"trace_wait": wait},
            "red": red or {"kernels": [], "ranges": [], "busy_s": 0.0, "window_s": 0.0,
                           "gaps": []}}


def read(name, ctx):
    return bench_run.read_metric(name, ctx)


def test_the_host_readers_take_the_windows_before_the_profiler():
    recs = []
    for k in range(6):  # windows 3-5 ran under the profiler: 10 times slower
        slow = 10 if k >= 3 else 1
        t = 100.0 * k
        recs += [_rec("window", k, t, 40 + k * slow, done_ms=t + 50 + k),
                 _rec("upload", k, t, 1.0, bytes=10),
                 _rec("detect.pass", k, t + 45, 15 * slow),
                 _rec("detect.nms", k, t + 50, 5, sweeps=k + 2)]
    recs.append(_rec("window", None, 900, 7))  # a tail window of no request
    ctx = _ctx(recs)
    assert read("window_host_ms.live", ctx) == pytest.approx(41.0)
    assert read("window_done_ms.live", ctx) == pytest.approx(51.0)
    assert read("detect_host_ms.live", ctx) == pytest.approx(15.0)
    assert read("nms_sweeps.live", ctx) == pytest.approx(3.0)


@pytest.mark.parametrize("ctx", [
    _ctx([]),  # an empty recorder
    _ctx([_rec("window", 5, 0, 40), _rec("detect.pass", 5, 40, 10)]),  # all under the profiler
    _ctx([_rec("window", 0, 0, 40)], wait=0),  # a profiler from the first window
    {"out": {"timer": None}, "mix": {"trace_wait": 3}, "red": {"gaps": []}},  # the fused entry
    {"out": {"timer": SimpleNamespace(spans=[])}, "mix": {"trace_wait": 3},
     "red": {"gaps": []}},  # the parent's timer: spans and no records
], ids=["empty", "traced-only", "no-wait", "no-timer", "no-records"])
def test_nothing_to_read_reads_none(ctx):
    for name in NEW:
        assert read(name, ctx) is None, name


def test_window_done_needs_the_cards_completion():
    ctx = _ctx([_rec("window", 0, 0, 40), _rec("window", 1, 100, 40)])
    assert read("window_done_ms.live", ctx) is None
    assert read("window_host_ms.live", ctx) == pytest.approx(40.0)


def test_the_live_entry_traced_on_the_cpu_reads_the_host_metrics(monkeypatch):
    """A traced run of the live cell at a small size: the recorder's readers
    find the windows before the profiler; the CPU has no completion events
    and no device trace, so the others read None."""
    spec = copy.deepcopy(bench_run.load_cell("sift360-yolov8n.live"))
    spec["config"]["stitch"]["frame_hw"] = [180, 320]
    spec["mix"].update(period_windows=2, capture_share=1.0, warmup_windows=1, trace_wait=2,
                       trace_active=1)
    torch.set_num_threads(2)
    monkeypatch.setattr(check, "DET_FRAMES", 2)
    res = run_cell(spec, 2**31 + 77, 1.0, True, "cpu", time.perf_counter(), bench_run.read_metric,
                   bench_run.metrics_of)
    m = res["metrics"]
    for name in ("window_host_ms.live", "detect_host_ms.live", "nms_sweeps.live"):
        assert m[name]["value"] > 0, name
    assert m["detect_host_ms.live"]["value"] < m["window_host_ms.live"]["value"] * 10
    assert m["nms_sweeps.live"]["unit"] == "sweeps/call"
    for name in ("window_done_ms.live", "window_idle_ms.live", "detect_idle_ms.live"):
        assert name not in m
