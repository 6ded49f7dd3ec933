"""detect_device_ms_per_frame: device time (ms) of the kernels under the
detection's span, per frame detected in the trace: ``clip.detect`` (the
port's span in process_clip) or ``bench.detect`` (the benchmark's span
around the driver's calls into ``_run_pass``)."""


def read(ctx):
    red, tr = ctx["red"], ctx["trace"]
    per_call = ctx["out"]["frames_per_detect_call"]
    for span in ("clip.detect", "bench.detect"):
        n = tr.count_ranges(red, span)
        if n:
            ks = tr.kernels_in(red, (span,))
            return sum(b - a for _, a, b in ks) / 1e3 / (n * per_call)
    return None
