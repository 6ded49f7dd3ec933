"""window_done_ms: ms from the start of the driver's ``window`` stage to the
card's completion of that window (the CUDA event the driver records after
the step), median over the windows before the profiler started, from the
program's span recorder."""

from bench_port.lib import spans


def read(ctx):
    return spans.median(spans.untraced(ctx, "window"),
                        lambda r: (r.done - r.t0) / 1e6 if r.done is not None else None)
