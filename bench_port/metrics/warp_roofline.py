"""warp_roofline: kernel A's share (%) of its roofline in the trace: the
least time of its calls' work (each frame read once, each warped canvas
pixel written once, at 3.35 TB/s; or the operations at 67 TFLOP/s) over
the device time of ``rtvm_warp_bilinear_kernel``. Every call of the cells
warps one window of frames onto the whole canvas."""

from bench_port.lib import yardstick

KERNEL = "rtvm_warp_bilinear_kernel"


def read(ctx):
    ks = [k for k in ctx["red"]["kernels"] if KERNEL in k[0]]
    if not ks:
        return None
    hc, wc = ctx["out"]["canvas_hw"]
    b = ctx["config"]["stitch"]["window_size"]
    least_ms = yardstick.bound(*yardstick.warp_work(b, ctx["frame_hw"], hc, wc))[0]
    device_ms = sum(e - a for _, a, e in ks) / 1e3
    return 100.0 * least_ms * len(ks) / device_ms
