"""nms_sweeps: the NMS's sweeps a detection call (each one read from the
card to the host), the counter ``sweeps`` of the span ``detect.nms``,
median over the windows before the profiler started."""

from bench_port.lib import spans


def read(ctx):
    return spans.median(spans.untraced(ctx, "detect.nms"), lambda r: r.counts.get("sweeps"))
