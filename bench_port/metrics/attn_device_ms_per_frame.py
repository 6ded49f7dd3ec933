"""attn_device_ms_per_frame: device time (ms) of the kernels under the
port's span ``clip.attn`` (YOLOv8-Worldv2's text-guided attention, one a
``MaxSigmoidAttnBlock``, four a forward), per frame detected in the trace
(the ``clip.detect`` calls times their frames); nothing where the trace
has no ``clip.attn``."""


def read(ctx):
    red, tr = ctx["red"], ctx["trace"]
    n = tr.count_ranges(red, "clip.detect")
    ks = tr.kernels_in(red, ("clip.attn",))
    if not n or not ks:
        return None
    return sum(b - a for _, a, b in ks) / 1e3 / (n * ctx["out"]["frames_per_detect_call"])
