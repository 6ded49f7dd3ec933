"""window_host_ms: host time (ms) of the driver's ``window`` stage (the
upload and the window step's enqueue), median over the windows before the
profiler started, from the program's span recorder."""

from bench_port.lib import spans


def read(ctx):
    return spans.median(spans.untraced(ctx, "window"), lambda r: (r.t1 - r.t0) / 1e6)
