"""window_device_ms: device time (ms) of the kernels under the window
step's spans ``window.*``, per window step in the trace."""


def read(ctx):
    red, tr = ctx["red"], ctx["trace"]
    n = tr.count_ranges(red, "window.features")
    if not n:
        return None
    return sum(b - a for _, a, b in tr.kernels_in(red, ("window.",))) / 1e3 / n
