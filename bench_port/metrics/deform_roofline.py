"""deform_roofline: the deformable cross-attention's share (%) of its
roofline in the trace: the least time of the traced ``clip.detect`` calls'
deformable work (the configuration's reference's ``deform_work`` for a
call's frames: its bytes at 3.35 TB/s or its FLOPs at the bf16 dense 989
TFLOP/s, whichever takes longer) over the device time of the kernels under
``clip.deform``; nothing where the trace has no ``clip.deform`` or the
reference no ``deform_work``."""

from bench_port.lib import yardstick


def read(ctx):
    red, tr = ctx["red"], ctx["trace"]
    work = getattr(ctx["reference"], "deform_work", None)
    n = tr.count_ranges(red, "clip.detect")
    ks = tr.kernels_in(red, ("clip.deform",))
    if work is None or not n or not ks:
        return None
    imgsz = ctx["config"]["yolo"]["imgsz"]
    hw = (imgsz, imgsz) if isinstance(imgsz, int) else tuple(imgsz)
    nbytes, nflops = work(ctx["config"]["yolo"], hw, ctx["out"]["frames_per_detect_call"])
    least_s = max(nbytes / yardstick.HBM_BYTES_PER_S, nflops / yardstick.BF16_FLOPS_PER_S)
    device_s = sum(b - a for _, a, b in ks) / 1e6
    return 100.0 * n * least_s / device_s
