"""window_launches: CUDA kernels (and copies) under the window step's spans
``window.*``, per window step in the trace."""


def read(ctx):
    red, tr = ctx["red"], ctx["trace"]
    n = tr.count_ranges(red, "window.features")
    return len(tr.kernels_in(red, ("window.",))) / n if n else None
