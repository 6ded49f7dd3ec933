"""detect_host_ms: host time (ms) of the detection pass (the span
``detect.pass`` around ``ObjectDetector._run_pass``: the model's enqueue,
the NMS sweeps, the reads and the host dicts), median over the windows
before the profiler started, from the program's span recorder."""

from bench_port.lib import spans


def read(ctx):
    return spans.median(spans.untraced(ctx, "detect.pass"), lambda r: (r.t1 - r.t0) / 1e6)
